// K3: exact fp32 rectangular softened all-pairs sweep.
//
// Replaces the TPU kernel murb_tpu/ops/tile_pallas.py:_tile_kernel
// (pallas_call at tile_pallas.py:106; entries acc_tile_rect :75 and
// acc_tile :127).  a_i = sum_j G m_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^{3/2}
// for an i-set and a j-set that may differ; zero-mass sources add 0.
//
// On the TPU the accumulator was carried across a sequential j grid axis
// in VMEM.  Here the sum stays in registers for a thread's whole j range.
//
// What bounds it on an H100: instruction issue.  A pair costs 12 fp32
// instructions (3 sub, 3 fma for d^2, 3 mul for G m inv^3, 3 fma into the
// sums) and one MUFU rsqrt, all through one issue slot a scheduler a clock.
// The first design (one target a thread, a two-level fp32 sum) also
// paid, for every pair, one shared-memory load of the staged source and the
// rsqrt's denormal fix-up around MUFU.RSQ (about 14 to 17 slots a pair:
// 25.88 ms at 200,192^2 against a 20-flop bound of 11.96 ms); and at
// 16384^2 and below it ran one 4-warp block an SM, too few warps to hide
// the fma chain (0.48 ms against 0.08).  This design:
//   - R targets a thread (tile_rows: 4, and 2 at block_i 64 so that a block
//     keeps a whole warp): each staged source feeds R independent pair
//     chains, so the shared load costs 1/R slot a pair and each thread has
//     R chains to interleave.  block_i keeps its meaning, targets a block
//     (block_i / R threads), so every compiled geometry stays valid;
//   - rsqrt.approx.ftz.f32: d^2 + eps^2 is never denormal for eps > 0, so
//     the fix-up is dead work (the result is the same bits);
//   - cp.async double-buffered tiles: tile k+1 lands while tile k is swept,
//     one barrier a tile;
//   - split-j: until its blocks fill the card's resident slots (blocks an
//     SM, from the occupancy calculator through murb_tile_resident, times
//     the SMs) ops/cuda.TILE_WAVES times over, the j tiles are cut into S
//     slices of whole tiles (grid.y; ops/cuda.tile_split).  At 16384^2
//     and 8000^2 the unsplit sweep is 128 or 63 blocks, under one an SM.
//     At the default 128x512 a block is one warp with 16 KB of shared
//     tiles, so an SM holds 13; at 200,192^2 the split still takes 3 to 4%
//     off, though the 1564 unsplit blocks fit in the 1716 slots at once.
//     It is not more warps an SM: 256x512 holds 26 and is slower at every
//     split.
//     Each slice writes its fp32 sum to a (S, 3, ni) scratch and a second
//     kernel folds the slices in slice order.  No atomics: the same bits
//     every run.
// Every target still folds fp32 tile partials in tile order (the two-level
// sum of the first design), so unsplit sums at 128 sources a tile equal the
// first design's bits.
//
// bf16 state: the bf16 instance (murb_tile_rect_bf16) stages each tile's
// bf16 sources raw, two a 4-byte cp.async (cp.async copies 4, 8 or 16
// bytes, never one 2-byte value), converts the landed tile into the fp32
// tile buffer, and runs the float instance's sweep on it (tile.cuh): at
// the same geometry and split its sums are the float instance's bits on
// the arrays upcast.  Half the bytes in, which the sweep never waited on.
// The first design loaded and converted each value synchronously
// (sweep.cuh's stage_body) and ran 6% slower at 16384^2, K4's passes 3
// 21% (PERF.md).
//
// The sweep is tile.cuh's sweep_rows_kernel with no weight rows; K5 and
// K6 (phi.cu) run the same template with theirs.  K14 (ring.cu) launches
// it for each ring step through tile_rect_launch (tile.cuh), adding to the
// step's running sums (accumulate).
#include "tile.cuh"

namespace murb {

// K3's default geometry (ops/cuda.TILE_BLOCK_I, TILE_BLOCK_J): targets a
// block and sources a tile.  Of 128x512, 256x512, 512x512 and 128x128 at
// their splits (scripts/torch_kernel_ab.py) the fastest at 16384^2 and
// 8000^2, and within 3% of 512x512 at 200,192^2
constexpr int kTileTargets = 128;
constexpr int kTileSources = 512;

template <class TB>
int tile_rect(const TB* qxi, const TB* qyi, const TB* qzi, int ni,
              const TB* qxj, const TB* qyj, const TB* qzj, const TB* gmj,
              int nj, float soft2, int block_i, int block_j, int slices,
              int tiles_per_slice, float* scratch, int accumulate, float* ax,
              float* ay, float* az, cudaStream_t stream) {
  return sweep_launch<0, true, false, TB>(
      qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nullptr, nj, soft2,
      block_i ? block_i : kTileTargets, block_j ? block_j : kTileSources,
      slices, tiles_per_slice, scratch, accumulate, ax, ay, az, nullptr,
      stream);
}

int tile_rect_launch(const float* qxi, const float* qyi, const float* qzi,
                     int ni, const float* qxj, const float* qyj,
                     const float* qzj, const float* gmj, int nj, float soft2,
                     int block_i, int block_j, int slices,
                     int tiles_per_slice, float* scratch, int accumulate,
                     float* ax, float* ay, float* az, cudaStream_t stream) {
  return tile_rect<float>(qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj, soft2,
                          block_i, block_j, slices, tiles_per_slice, scratch,
                          accumulate, ax, ay, az, stream);
}

}  // namespace murb

// block_i, block_j: 0 (kTileTargets targets a block, kTileSources sources a
// tile) or a pair of {64, 128, 256, 512}.
// slices, tiles_per_slice: the j split (ops/cuda.tile_split); slices > 1
// needs scratch, (slices, 3, ni) floats, and launches the fold after the
// sweep.  Every slice must hold a tile when nj > 0.
extern "C" int murb_tile_rect(const float* qxi, const float* qyi,
                              const float* qzi, int ni, const float* qxj,
                              const float* qyj, const float* qzj,
                              const float* gmj, int nj, float soft2,
                              int block_i, int block_j, int slices,
                              int tiles_per_slice, float* scratch, float* ax,
                              float* ay, float* az, cudaStream_t stream) {
  return murb::tile_rect_launch(qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj,
                                soft2, block_i, block_j, slices,
                                tiles_per_slice, scratch, 0, ax, ay, az,
                                stream);
}

// Blocks of K3's sweep at (block_i, block_j) that one SM of the current
// device holds at once (its registers, shared memory and threads), into
// *blocks: ops/cuda.tile_split counts the card's slots with it.
extern "C" int murb_tile_resident(int block_i, int block_j, int* blocks) {
  return murb::sweep_resident<0, true>(
      block_i ? block_i : murb::kTileTargets,
      block_j ? block_j : murb::kTileSources, blocks);
}

// The bf16 instance: murb_tile_rect's arguments with the seven body arrays
// bf16 (the outputs and scratch float).
extern "C" int murb_tile_rect_bf16(
    const __nv_bfloat16* qxi, const __nv_bfloat16* qyi,
    const __nv_bfloat16* qzi, int ni, const __nv_bfloat16* qxj,
    const __nv_bfloat16* qyj, const __nv_bfloat16* qzj,
    const __nv_bfloat16* gmj, int nj, float soft2, int block_i, int block_j,
    int slices, int tiles_per_slice, float* scratch, float* ax, float* ay,
    float* az, cudaStream_t stream) {
  return murb::tile_rect<__nv_bfloat16>(qxi, qyi, qzi, ni, qxj, qyj, qzj,
                                        gmj, nj, soft2, block_i, block_j,
                                        slices, tiles_per_slice, scratch, 0,
                                        ax, ay, az, stream);
}

// Blocks of the bf16 instance at (block_i, block_j) an SM holds at once:
// its j split counts the card's slots with it.
extern "C" int murb_tile_resident_bf16(int block_i, int block_j,
                                       int* blocks) {
  return murb::sweep_resident<0, true, false, __nv_bfloat16>(
      block_i ? block_i : murb::kTileTargets,
      block_j ? block_j : murb::kTileSources, blocks);
}
