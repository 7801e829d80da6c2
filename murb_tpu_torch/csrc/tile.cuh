// The register-tiled exact sweep that K3 (tile.cu), K5 and K6 (phi.cuh)
// share, and K3's launch that K14 (ring.cu) reuses for its ring steps.
//
// sweep_rows_kernel<BI, BJ, NR, kForce>: BI targets a block, sweep_rows(BI,
// NR) of them a thread; BJ sources a tile; NR source-weight rows (0 for
// K3); kForce the force sum (K3, K6) or not (K5).  Each pair runs one
// distance chain and one rsqrt, which feed the force (3 mul, 3 fma) and
// every potential row (one fma each).  K3, K5 and K6 are compiled for
// every (BI, BJ) of {64, 128, 256, 512}^2, with BI / R threads as the
// launch bound and the tiles in static shared memory, as K3 was before
// the template was shared.  A run-time tile in dynamic shared memory
// (four instances a row count, not sixteen) was tried: ptxas, which then
// cannot see that the tiles hold an SM to 13 blocks, kept K3 at 128 x 512
// to 64 registers (91 with static tiles), and K3 lost 4 to 12%, K5 at
// R = 2 13% (PERF.md).
// Per target, each channel (force component or potential row) is summed
// in fp32 over a tile in source order, the tile partials are added in tile
// order, and j slices fold in slice order: K6's force is K3's bit for bit
// at the same (block_j, slices), and K5's rows K6's.
//
// kExt (K4's passes 3, hybrid.cu; NR = 0, the force): the extended tier.
// The pair weight takes one Newton step on the ftz rsqrt (the hardware's
// <= 2 ulp to about 1 ulp); each group of kExtRun = 4 sources, one step
// of the unrolled source loop, is summed in fp32 and folded into fp64
// running sums (3 F2F and 3 DADD a target a group); the j slices' fp64
// sums go to an fp64 scratch and fold in fp64, in slice order.  Longer
// fp32 runs lose the tier's contract on the galaxy (ext_run_sum in
// tests/test_torch_kernels.py: runs of 32 sources read 0.54 of the
// unsplit fp32 sum's error at 8192^2, runs of 4 0.43).  K3, K5 and K6
// (kExt false) do not take this path.
#pragma once

#include <cuda_runtime.h>

#include "sweep.cuh"

namespace murb {

constexpr int kMaxPhiRows = 8;  // source-weight rows a potential sweep takes
constexpr int kExtRun = 4;      // sources a run of the extended tier

// The running sums and j-slice scratch of a sweep: fp32, fp64 for kExt.
template <bool kExt>
using sweep_acc_t = std::conditional_t<kExt, double, float>;

// Targets a thread at block_i `bi`: 4, and 2 at block_i 64 so that a block
// keeps a whole warp (ops/cuda.tile_rows mirrors it).
__host__ __device__ constexpr int tile_rows(int bi) {
  return bi >= 128 ? 4 : 2;
}

// Targets a thread of a sweep with `nr` weight rows (ops/cuda.sweep_rows):
// K3's at every nr.  Each target holds 3 + nr sums and 3 + nr tile
// partials in registers; at nr = 8 and 4 targets that is 100 floats, and
// no instance spills (the build's -Xptxas -v report, CHANGES.md).
__host__ __device__ constexpr int sweep_rows(int bi, int /*nr*/) {
  return tile_rows(bi);
}

// Floats of a source's weight record in shared memory: nr rounded up to
// 1, 2, 4 or 8, so that it loads as one float, float2 or one or two
// float4 (the slots past nr are not staged, and load_weights drops them).
__host__ __device__ constexpr int weight_stride(int nr) {
  return nr <= 0 ? 0 : nr == 1 ? 1 : nr == 2 ? 2 : nr <= 4 ? 4 : 8;
}

// Shared-memory bytes of one staged source: the {x, y, z, G*m} float4 and
// the weight record (ops/cuda.staged_bytes).
__host__ __device__ constexpr int staged_bytes(int nr) {
  return 16 + 4 * weight_stride(nr);
}

// One source into a float4 slot: four 4-byte cp.async (x, y, z, G*m); a
// slot past nj is zero-filled (src-size 0), a zero-mass ghost.  Without
// the force the G*m slot is zero-filled and gmj is not read.
template <bool kForce>
__device__ __forceinline__ void stage_source_async(float4* slot,
                                                   const float* qxj,
                                                   const float* qyj,
                                                   const float* qzj,
                                                   const float* gmj, int j,
                                                   int nj) {
  const bool real = j < nj;
  const int k = real ? j : 0;
  float* s = &slot->x;
  cp_async4(s + 0, qxj + k, real);
  cp_async4(s + 1, qyj + k, real);
  cp_async4(s + 2, qzj + k, real);
  cp_async4(s + 3, kForce ? gmj + k : qxj + k, kForce && real);
}

// A staged source's NR weights from its record `w` (weight_stride(NR)
// floats, aligned to its size).
template <int NR>
__device__ __forceinline__ void load_weights(const float* w,
                                             float (&out)[NR > 0 ? NR : 1]) {
  constexpr int W = weight_stride(NR);
  if constexpr (W == 1) {
    out[0] = w[0];
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(w);
    out[0] = v.x;
    out[1] = v.y;
  } else if constexpr (W >= 4) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(w)[q];
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * q + c < NR) out[4 * q + c] = e[c];
    }
  }
}

// One staged tile of BJ sources (a multiple of 4) against R targets: per
// target and channel, fp32 tile partials in source order, R chains at
// once.
template <int BJ, int R, int NR, bool kForce>
__device__ __forceinline__ void tile_sum_rows(
    const float4* tile, const float* wts, const float (&xi)[R],
    const float (&yi)[R], const float (&zi)[R], float soft2, float (&tx)[R],
    float (&ty)[R], float (&tz)[R], float (&tp)[R][NR > 0 ? NR : 1]) {
  constexpr int W = weight_stride(NR);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    tx[r] = ty[r] = tz[r] = 0.f;
#pragma unroll
    for (int k = 0; k < NR; ++k) tp[r][k] = 0.f;
  }
  for (int t = 0; t < BJ; t += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 s = tile[t + u];
      float w[NR > 0 ? NR : 1];
      load_weights<NR>(wts + (t + u) * W, w);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = s.x - xi[r], dy = s.y - yi[r], dz = s.z - zi[r];
        const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft2)));
        const float inv = rsqrt_ftz(d2);
        if constexpr (kForce) {
          const float wf = s.w * (inv * inv * inv);
          tx[r] = fmaf(wf, dx, tx[r]);
          ty[r] = fmaf(wf, dy, ty[r]);
          tz[r] = fmaf(wf, dz, tz[r]);
        }
#pragma unroll
        for (int k = 0; k < NR; ++k) tp[r][k] = fmaf(w[k], inv, tp[r][k]);
      }
    }
  }
}

// The extended tier's tile: R targets against BJ staged sources, each
// group of kExtRun sources summed in fp32 (a refined rsqrt a pair) and
// added to the fp64 sums.
template <int BJ, int R>
__device__ __forceinline__ void tile_sum_ext(const float4* tile,
                                             const float (&xi)[R],
                                             const float (&yi)[R],
                                             const float (&zi)[R],
                                             float soft2, double (&sx)[R],
                                             double (&sy)[R],
                                             double (&sz)[R]) {
  static_assert(BJ % kExtRun == 0 && kExtRun == 4, "a run is one step");
  for (int t = 0; t < BJ; t += kExtRun) {
    float tx[R], ty[R], tz[R];
#pragma unroll
    for (int r = 0; r < R; ++r) tx[r] = ty[r] = tz[r] = 0.f;
#pragma unroll
    for (int u = 0; u < kExtRun; ++u) {
      const float4 s = tile[t + u];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = s.x - xi[r], dy = s.y - yi[r], dz = s.z - zi[r];
        const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft2)));
        float inv = rsqrt_ftz(d2);
        inv = inv * fmaf(-0.5f * d2 * inv, inv, 1.5f);
        const float wf = s.w * (inv * inv * inv);
        tx[r] = fmaf(wf, dx, tx[r]);
        ty[r] = fmaf(wf, dy, ty[r]);
        tz[r] = fmaf(wf, dz, tz[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sx[r] += static_cast<double>(tx[r]);
      sy[r] += static_cast<double>(ty[r]);
      sz[r] += static_cast<double>(tz[r]);
    }
  }
}

// TB: the body arrays' type, float or __nv_bfloat16 (the bf16 instances
// of K3, K4, K5 and K6).  A bf16 tile is staged raw, two sources a 4-byte
// cp.async, into the second half of `pos` (two buffers of x, y, z, G*m
// rows of BJ bf16 each: the fp32 instance's second tile buffer, so the
// same shared memory), and once it has landed the block converts it into
// pos[0, BJ), the one fp32 tile the sweep reads (a barrier more a tile;
// one-warp blocks at BI / R = 32 threads).  Without the force (K5) only
// the x, y and z rows are staged (there is no G*m array) and the tile's
// G*m slot is 0, as the fp32 instance's zero-filled one.  The weight rows
// stay fp32 in both instances (murb_tpu's kernels take them float32) and
// keep their own double buffer.  The next tile's copies stay in flight
// while this one is swept, as in the fp32 instance, and the sweep reads
// the same float4 tile: the same sums, bit for bit, as the fp32 instance
// on the arrays upcast.  The sources must start 4-byte aligned (the
// wrappers copy a view that does not).
// grid (ceil(ni / BI), S), BI / R threads, 2 * BJ * staged_bytes(NR)
// bytes of static shared memory.  Slice blockIdx.y sweeps tiles
// [y * tiles_per_slice, min((y + 1) * tiles_per_slice, ceil(nj / BJ))).
// Thread t owns targets blockIdx.x * BI + t + r * (BI / R), r < R.
// Channels: the force (ax, ay, az) when kForce, then the NR rows
// (phi[k * ni + i]).  With S == 1 they go to the outputs (the force added
// to ax, ay, az when accumulate != 0), else to scratch[(y * C + c) * ni +
// i], C channels (fp64 sums and scratch for kExt).  Tile k + 1 lands
// (cp.async) while tile k is swept, one barrier a tile.
template <int BI, int BJ, int NR, bool kForce, bool kExt = false,
          class TB = float>
__global__ void __launch_bounds__(BI / sweep_rows(BI, NR))
sweep_rows_kernel(const TB* __restrict__ qxi, const TB* __restrict__ qyi,
                  const TB* __restrict__ qzi, int ni,
                  const TB* __restrict__ qxj, const TB* __restrict__ qyj,
                  const TB* __restrict__ qzj, const TB* __restrict__ gmj,
                  const float* __restrict__ rows, int nj,
                  int tiles_per_slice, float soft2, int accumulate,
                  float* __restrict__ ax, float* __restrict__ ay,
                  float* __restrict__ az, float* __restrict__ phi,
                  sweep_acc_t<kExt>* __restrict__ scratch) {
  static_assert(!kExt || (NR == 0 && kForce), "the extended tier: force");
  constexpr bool kB16 = std::is_same_v<TB, __nv_bfloat16>;
  constexpr int R = sweep_rows(BI, NR);
  constexpr int T = BI / R;
  constexpr int NRa = NR > 0 ? NR : 1;
  constexpr int W = weight_stride(NR);
  constexpr int C = (kForce ? 3 : 0) + NR;
  __shared__ __align__(16) float4 pos[2 * BJ];               // [2][BJ]
  __shared__ __align__(16) float wts[W > 0 ? 2 * BJ * W : 1];  // [2][BJ][W]
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BI + tid;
  float xi[R], yi[R], zi[R], sp[R][NRa];
  sweep_acc_t<kExt> sx[R], sy[R], sz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T;
    const bool own = i < ni;
    xi[r] = own ? body_f32(qxi[i]) : 0.f;
    yi[r] = own ? body_f32(qyi[i]) : 0.f;
    zi[r] = own ? body_f32(qzi[i]) : 0.f;
    sx[r] = sy[r] = sz[r] = 0.f;
#pragma unroll
    for (int k = 0; k < NR; ++k) sp[r][k] = 0.f;
  }
  const int tiles = (nj + BJ - 1) / BJ;
  const int t0 = blockIdx.y * tiles_per_slice;
  const int t1 = min(t0 + tiles_per_slice, tiles);
  // bf16: row c (x, y, z, G*m) of raw buffer b, BJ values; the rows staged
  // (G*m only with the force)
  auto raw = [&](int b, int c) {
    return reinterpret_cast<__nv_bfloat16*>(pos + BJ) + (b * 4 + c) * BJ;
  };
  constexpr int kRawRows = kForce ? 4 : 3;
  auto stage = [&](int t, int b) {
    if constexpr (kB16) {
      const TB* rows4[4] = {qxj, qyj, qzj, gmj};
      for (int k = 2 * tid; k < BJ; k += 2 * T) {
        const int j = t * BJ + k;
        const int bytes = j >= nj ? 0 : (nj - j >= 2 ? 4 : 2);
#pragma unroll
        for (int c = 0; c < kRawRows; ++c)
          cp_async4_n(raw(b, c) + k, rows4[c] + (bytes ? j : 0), bytes);
      }
    } else {
      float4* p = pos + b * BJ;
      for (int k = tid; k < BJ; k += T)
        stage_source_async<kForce>(p + k, qxj, qyj, qzj, gmj, t * BJ + k,
                                   nj);
    }
    if constexpr (NR > 0) {
      float* w = wts + b * BJ * W;
      for (int k = tid; k < BJ; k += T) {
        const int j = t * BJ + k;
        const bool real = j < nj;
        const float* src = rows + (real ? j : 0);
#pragma unroll
        for (int q = 0; q < NR; ++q)
          cp_async4(w + k * W + q, src + static_cast<long long>(q) * nj,
                    real);
      }
    }
    cp_async_commit();
  };
  if (t0 < t1) stage(t0, 0);
  for (int t = t0; t < t1; ++t) {
    cp_async_wait_all();  // this thread's copies of tile t landed
    __syncthreads();      // everyone's did; the other buffer is free
    if (t + 1 < t1) stage(t + 1, (t + 1 - t0) & 1);
    const int b = (t - t0) & 1;
    const float4* tile = pos + b * BJ;
    if constexpr (kB16) {
      // tile t's raw rows landed; the barrier above also ended every read
      // of the fp32 tile, which now takes them
      for (int k = tid; k < BJ; k += T)
        pos[k] = make_float4(__bfloat162float(raw(b, 0)[k]),
                             __bfloat162float(raw(b, 1)[k]),
                             __bfloat162float(raw(b, 2)[k]),
                             kForce ? __bfloat162float(raw(b, 3)[k]) : 0.f);
      __syncthreads();
      tile = pos;
    }
    if constexpr (kExt) {
      tile_sum_ext<BJ, R>(tile, xi, yi, zi, soft2, sx, sy, sz);
    } else {
      float tx[R], ty[R], tz[R], tp[R][NRa];
      tile_sum_rows<BJ, R, NR, kForce>(tile, wts + b * BJ * W, xi, yi, zi,
                                       soft2, tx, ty, tz, tp);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (kForce) {
          sx[r] += tx[r];
          sy[r] += ty[r];
          sz[r] += tz[r];
        }
#pragma unroll
        for (int k = 0; k < NR; ++k) sp[r][k] += tp[r][k];
      }
    }
  }
  const long long n = ni;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T;
    if (i >= ni) continue;
    if (gridDim.y == 1) {
      if constexpr (kForce) {
        const float fx = static_cast<float>(sx[r]);
        const float fy = static_cast<float>(sy[r]);
        const float fz = static_cast<float>(sz[r]);
        ax[i] = accumulate ? ax[i] + fx : fx;
        ay[i] = accumulate ? ay[i] + fy : fy;
        az[i] = accumulate ? az[i] + fz : fz;
      }
#pragma unroll
      for (int k = 0; k < NR; ++k) phi[k * n + i] = sp[r][k];
    } else {
      sweep_acc_t<kExt>* out = scratch + blockIdx.y * C * n + i;
      if constexpr (kForce) {
        out[0] = sx[r];
        out[n] = sy[r];
        out[2 * n] = sz[r];
      }
#pragma unroll
      for (int k = 0; k < NR; ++k) out[((kForce ? 3 : 0) + k) * n] = sp[r][k];
    }
  }
}

// The slices' sums, folded in slice order, channel by channel, into the
// outputs of sweep_rows_kernel (the force added to ax, ay, az when
// accumulate != 0); in fp64 for kExt.
template <int NR, bool kForce, bool kExt = false>
__global__ void sweep_fold_kernel(const sweep_acc_t<kExt>* __restrict__ scratch,
                                  int slices, int ni, int accumulate,
                                  float* __restrict__ ax,
                                  float* __restrict__ ay,
                                  float* __restrict__ az,
                                  float* __restrict__ phi) {
  constexpr int C = (kForce ? 3 : 0) + NR;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ni) return;
  const long long n = ni;
  sweep_acc_t<kExt> s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.f;
  for (int y = 0; y < slices; ++y)
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] += scratch[(y * C + c) * n + i];
  if constexpr (kForce) {
    const float fx = static_cast<float>(s[0]);
    const float fy = static_cast<float>(s[1]);
    const float fz = static_cast<float>(s[2]);
    ax[i] = accumulate ? ax[i] + fx : fx;
    ay[i] = accumulate ? ay[i] + fy : fy;
    az[i] = accumulate ? az[i] + fz : fz;
  }
#pragma unroll
  for (int k = 0; k < NR; ++k) phi[k * n + i] = s[(kForce ? 3 : 0) + k];
}

inline bool sweep_block(int b) {
  return b == 64 || b == 128 || b == 256 || b == 512;
}

// The sweep at the compiled geometry (BI, BJ), BI targets a block and BJ
// sources a tile, in `slices` j slices of `tiles_per_slice` tiles
// (ops/cuda.tile_split; every slice holds a tile when nj > 0), with the
// fold when slices > 1 (scratch: (slices, C, ni), doubles for kExt).
// rows: (NR, nj) weights; phi: (NR, ni).  Returns the cudaError_t of the
// launches.
template <int BI, int BJ, int NR, bool kForce, bool kExt = false,
          class TB = float>
int sweep_launch_at(const TB* qxi, const TB* qyi, const TB* qzi, int ni,
                    const TB* qxj, const TB* qyj, const TB* qzj,
                    const TB* gmj, const float* rows, int nj, float soft2,
                    int slices, int tiles_per_slice,
                    sweep_acc_t<kExt>* scratch, int accumulate, float* ax,
                    float* ay, float* az, float* phi, cudaStream_t stream) {
  if (nj < 0 || slices < 1 || slices > 65535 || tiles_per_slice < 0 ||
      (slices > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ni <= 0) return 0;
  const long long tiles = (nj + BJ - 1) / BJ;
  if (static_cast<long long>(slices) * tiles_per_slice < tiles ||
      (slices > 1 &&
       static_cast<long long>(slices - 1) * tiles_per_slice >= tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ni + BI - 1) / BI, slices);
  sweep_rows_kernel<BI, BJ, NR, kForce, kExt, TB>
      <<<grid, BI / sweep_rows(BI, NR), 0, stream>>>(
          qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, rows, nj, tiles_per_slice,
          soft2, accumulate, ax, ay, az, phi, scratch);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || slices == 1) return err;
  sweep_fold_kernel<NR, kForce, kExt><<<(ni + 255) / 256, 256, 0, stream>>>(
      scratch, slices, ni, accumulate, ax, ay, az, phi);
  return static_cast<int>(cudaGetLastError());
}

// sweep_launch_at at (bi, bj), each of {64, 128, 256, 512}, picked at run
// time (with_blocks).
template <int NR, bool kForce, bool kExt = false, class TB = float>
int sweep_launch(const TB* qxi, const TB* qyi, const TB* qzi,
                 int ni, const TB* qxj, const TB* qyj, const TB* qzj,
                 const TB* gmj, const float* rows, int nj, float soft2,
                 int bi, int bj, int slices, int tiles_per_slice,
                 sweep_acc_t<kExt>* scratch, int accumulate, float* ax,
                 float* ay, float* az, float* phi, cudaStream_t stream) {
  if (!sweep_block(bi) || !sweep_block(bj))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_blocks(bi, bj, bi, bj, [&](auto bic, auto bjc) {
    constexpr int BI = decltype(bic)::value, BJ = decltype(bjc)::value;
    return sweep_launch_at<BI, BJ, NR, kForce, kExt, TB>(
        qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, rows, nj, soft2, slices,
        tiles_per_slice, scratch, accumulate, ax, ay, az, phi, stream);
  });
}

// Blocks of the sweep at the compiled geometry (BI, BJ) that one SM of the
// current device holds at once (registers, shared memory, threads), into
// *blocks.
template <int BI, int BJ, int NR, bool kForce, bool kExt = false,
          class TB = float>
int sweep_resident_at(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sweep_rows_kernel<BI, BJ, NR, kForce, kExt, TB>,
      BI / sweep_rows(BI, NR), 0));
}

// sweep_resident_at at (bi, bj), picked at run time.
template <int NR, bool kForce, bool kExt = false, class TB = float>
int sweep_resident(int bi, int bj, int* blocks) {
  return with_blocks(bi, bj, bi, bj, [&](auto bic, auto bjc) {
    constexpr int BI = decltype(bic)::value, BJ = decltype(bjc)::value;
    return sweep_resident_at<BI, BJ, NR, kForce, kExt, TB>(blocks);
  });
}

// K3's sweep of ni targets against nj sources on `stream` (csrc/tile.cu,
// murb_tile_rect's arguments): block_i, block_j 0 or a pair of {64, 128,
// 256, 512}; slices, tiles_per_slice the j split (ops/cuda.tile_split),
// scratch (slices, 3, ni) floats when slices > 1.  accumulate != 0 adds
// the sums to ax, ay, az instead of writing them.  Returns the
// cudaError_t of the launches.  The bf16 overload is K3's bf16 instance
// (murb_tile_rect_bf16's launch; 4-byte aligned sources).
int tile_rect_launch(const float* qxi, const float* qyi, const float* qzi,
                     int ni, const float* qxj, const float* qyj,
                     const float* qzj, const float* gmj, int nj, float soft2,
                     int block_i, int block_j, int slices,
                     int tiles_per_slice, float* scratch, int accumulate,
                     float* ax, float* ay, float* az, cudaStream_t stream);
int tile_rect_launch(const __nv_bfloat16* qxi, const __nv_bfloat16* qyi,
                     const __nv_bfloat16* qzi, int ni,
                     const __nv_bfloat16* qxj, const __nv_bfloat16* qyj,
                     const __nv_bfloat16* qzj, const __nv_bfloat16* gmj,
                     int nj, float soft2, int block_i, int block_j,
                     int slices, int tiles_per_slice, float* scratch,
                     int accumulate, float* ax, float* ay, float* az,
                     cudaStream_t stream);

}  // namespace murb
