// K5 (multi-row potential sweep, phi_rows.cu) and K6 (the exact force
// sweep and K5 fused, phi.cu): the potentials of the tracking engines.
// This header holds what they share; each source instantiates only its
// own kernels, so the two compile in parallel (phi.cu held both and set
// the library's build time: 84.6 s alone with the bf16 instances, K5 and
// K6 about half each).
//
// Replace the TPU kernels murb_tpu/ops/hybrid.py:_phi_kernel (pallas_call
// at hybrid.py:309; entries phi_rows_rect :274, phi_rows :330) and
// _hybrid_phi_kernel (pallas_call at :452; entry acc_phi_rows_hybrid :406).
//
//   K5: phi_r[i] = sum_j w_r[j] * rsqrt(|r_j - r_i|^2 + eps^2), R <= 8
//       weight rows (one masked G*m row per galaxy), for an i-set and a
//       j-set that may differ;
//   K6: the same R rows over one set of n bodies, plus the force
//       a_i = sum_j G m_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^{3/2}:
//       one distance chain and one rsqrt per pair feed both.
//
// The j == i term (1/eps per row) is included, as in the reference's tile
// sweep; callers subtract G m_i / eps (core/metrics.energy_from_phi).
//
// On the TPU the weight rows rode the matrix unit's padded dimension as
// bf16 splits (passes 1/2), and the force came out as a = P[0:3] - q P[3],
// which cancels in fp32.  Here both run K3's register-tiled sweep
// (tile.cuh, sweep_rows_kernel with R weight rows; K5 without the force):
// each row and the force are summed in fp32 per tile and the tile partials
// in fp32 again, so passes 1 and 2 both give the fp32-class contract (force
// as K4 passes 2, phi to ~1e-6 relative), and K6's force is K3's bits at
// the same block_j and j split.
//
// What bounds them on an H100: instruction issue and the MUFU rsqrt.  A
// pair of K6 issues 3 sub, 3 fma for d^2, 3 mul, 3 fma for the force and R
// fma, plus one MUFU.RSQ (about 15 slots at R = 2); K5 drops the 3 mul and
// 3 fma of the force (about 9 slots), close to the MUFU floor (16 a clock
// an SM: 1.60 ms at 81,920^2 and 1.98 GHz).  The first design (one target
// a thread, 128 sources a tile staged with synchronous loads and two
// barriers, the rows in R separate shared slices, rsqrtf with its denormal
// fix-up, no j split: 640 four-warp blocks at the merger) paid for every
// pair 1 + R shared loads and the fix-up.  This design:
//   - 4 targets a thread (sweep_rows: K3's tile_rows at every R, 2 at
//     block_i 64), so a staged source's loads cost 1/4 slot a pair;
//   - each source staged as {x, y, z, G*m} and one weight record of
//     weight_stride(R) floats (1, 2, 4 or 8), read as one float4 and one or
//     two vector loads, through double-buffered cp.async, one barrier a
//     tile;
//   - rsqrt.approx.ftz.f32 (d^2 + eps^2 is never denormal for eps > 0);
//   - the j split of K3 (ops/cuda.tile_split), with this kernel's own
//     resident blocks (murb_phi_resident, keyed by R): (S, C, ni) partials
//     (C = 3 + R for K6, R for K5) folded in slice order.  No atomics.
// Geometry: 256 targets a block (64 threads) and 256 sources a tile at
// every R (a 12 to 24 KB double buffer).  At 81,920^2 these kernels want
// more resident warps than K3's 128 x 512 gives them (9 one-warp blocks an
// SM at R = 2, the shared memory's limit): at tile_split's slices, K6 at
// R = 2 took 4.38 ms there and 3.93 ms at 256 x 256 (12 two-warp blocks),
// K5 2.82 and 2.52 ms (scripts/torch_kernel_ab.py; PERF.md).
// Registers: 48 to 128 at 256 x 256 (K6 79 at R = 2), no spills in any
// instance.
//
// bf16 state: murb_phi_rows_rect_bf16 and murb_acc_phi_rows_bf16 read the
// state's bf16 coordinates (and K6's G*m) as they are: the sweep stages
// each tile raw and converts it in shared memory (tile.cuh; K5 stages its
// three coordinate rows, no G*m), and the weight rows stay fp32, as
// murb_tpu's kernels take them (hybrid.py:297-298, :440).  At the same
// geometry and split each gives its fp32 instance's bits on the arrays
// upcast.  They are compiled at the default geometry only (256 x 256, R =
// 1..8: 16 kernels where the fp32 instances hold 16 block pairs of each,
// 256), the one the engines launch; any other pair is refused
// (cudaErrorInvalidValue, and first by ops/hybrid.py), so their build
// grows by a sixteenth, not twofold.
#pragma once

#include <type_traits>

#include "tile.cuh"

namespace murb {

// K5's and K6's default geometry (ops/cuda.PHI_BLOCK_I, PHI_BLOCK_J):
// targets a block and sources a tile.
constexpr int kPhiTargets = 256;
constexpr int kPhiSources = 256;

// Run launch(std::integral_constant<int, NR>) for nr in [1, kMaxPhiRows].
template <class F>
int with_rows(int nr, F&& launch) {
  using std::integral_constant;
  switch (nr) {
    case 1: return launch(integral_constant<int, 1>{});
    case 2: return launch(integral_constant<int, 2>{});
    case 3: return launch(integral_constant<int, 3>{});
    case 4: return launch(integral_constant<int, 4>{});
    case 5: return launch(integral_constant<int, 5>{});
    case 6: return launch(integral_constant<int, 6>{});
    case 7: return launch(integral_constant<int, 7>{});
    case 8: return launch(integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kForce, class TB>
int launch_phi_rows(const TB* qxi, const TB* qyi, const TB* qzi, int ni,
                    const TB* qxj, const TB* qyj, const TB* qzj,
                    const TB* gmj, const float* rows, int nr, int nj,
                    float soft2, int block_i, int block_j, int slices,
                    int tiles_per_slice, float* scratch, float* ax,
                    float* ay, float* az, float* phi, cudaStream_t stream) {
  const int bi = block_i ? block_i : kPhiTargets;
  const int bj = block_j ? block_j : kPhiSources;
  return with_rows(nr, [&](auto r) {
    constexpr int NR = decltype(r)::value;
    if constexpr (std::is_same_v<TB, float>) {
      return sweep_launch<NR, kForce>(
          qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, rows, nj, soft2, bi, bj,
          slices, tiles_per_slice, scratch, 0, ax, ay, az, phi, stream);
    } else {  // the bf16 instances: the default geometry only
      if (bi != kPhiTargets || bj != kPhiSources)
        return static_cast<int>(cudaErrorInvalidValue);
      return sweep_launch_at<kPhiTargets, kPhiSources, NR, kForce, false, TB>(
          qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, rows, nj, soft2, slices,
          tiles_per_slice, scratch, 0, ax, ay, az, phi, stream);
    }
  });
}

// Blocks of K6 (kForce) or K5 at (block_i, block_j) and nr rows that one
// SM of the current device holds at once, into *blocks.
template <bool kForce, class TB>
int phi_resident(int block_i, int block_j, int nr, int* blocks) {
  const int bi = block_i ? block_i : kPhiTargets;
  const int bj = block_j ? block_j : kPhiSources;
  return with_rows(nr, [&](auto r) {
    constexpr int NR = decltype(r)::value;
    if constexpr (std::is_same_v<TB, float>) {
      return sweep_resident<NR, kForce>(bi, bj, blocks);
    } else {
      if (bi != kPhiTargets || bj != kPhiSources)
        return static_cast<int>(cudaErrorInvalidValue);
      return sweep_resident_at<kPhiTargets, kPhiSources, NR, kForce, false,
                               TB>(blocks);
    }
  });
}

// K5's resident blocks (phi_rows.cu), which phi.cu's murb_phi_resident
// takes for force == 0, so that K5's kernels compile in phi_rows.cu only.
int phi_rows_resident(int block_i, int block_j, int nr, int* blocks);
int phi_rows_resident_bf16(int block_i, int block_j, int nr, int* blocks);

}  // namespace murb
