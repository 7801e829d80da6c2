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
// K14 (ring.cu) launches this sweep for each ring step through
// tile_rect_launch (tile.cuh), adding to the step's running sums
// (accumulate).
#include "sweep.cuh"
#include "tile.cuh"

namespace murb {

// K3's default geometry (ops/cuda.TILE_BLOCK_I, TILE_BLOCK_J): targets a
// block and sources a tile.  Of 128x512, 256x512, 512x512 and 128x128 at
// their splits (scripts/torch_kernel_ab.py) the fastest at 16384^2 and
// 8000^2, and within 3% of 512x512 at 200,192^2
constexpr int kTileTargets = 128;
constexpr int kTileSources = 512;

// targets a thread at block_i BI: 4, and 2 at block_i 64 so that a block
// keeps a whole warp (ops/cuda.tile_rows mirrors it)
constexpr int tile_rows(int bi) { return bi >= 128 ? 4 : 2; }

// One source into a float4 slot: four 4-byte cp.async (x, y, z, G*m); a
// slot past nj is zero-filled (src-size 0), a zero-mass ghost.
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
  cp_async4(s + 3, gmj + k, real);
}

// One staged tile of BJ sources against R targets: per target, fp32 tile
// partials in source order (the first design's arithmetic, R chains at
// once).
template <int BJ, int R>
__device__ __forceinline__ void tile_sum_rows(const float4* tile,
                                              const float (&xi)[R],
                                              const float (&yi)[R],
                                              const float (&zi)[R],
                                              float soft2, float (&tx)[R],
                                              float (&ty)[R],
                                              float (&tz)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) tx[r] = ty[r] = tz[r] = 0.f;
#pragma unroll 4
  for (int t = 0; t < BJ; ++t) {
    const float4 s = tile[t];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dx = s.x - xi[r], dy = s.y - yi[r], dz = s.z - zi[r];
      const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft2)));
      const float inv = rsqrt_ftz(d2);
      const float w = s.w * (inv * inv * inv);
      tx[r] = fmaf(w, dx, tx[r]);
      ty[r] = fmaf(w, dy, ty[r]);
      tz[r] = fmaf(w, dz, tz[r]);
    }
  }
}

// grid (ceil(ni / BI), S), BI / R threads.  Slice blockIdx.y sweeps tiles
// [y * tiles_per_slice, min((y + 1) * tiles_per_slice, ceil(nj / BJ))).
// Thread t owns targets blockIdx.x * BI + t + r * (BI / R), r < R.  With
// S == 1 the sums go to ax/ay/az (added to them when accumulate != 0),
// else to scratch[(y * 3 + c) * ni + i].
template <int BI, int BJ, int R>
__global__ void __launch_bounds__(BI / R)
tile_rect_rows_kernel(const float* __restrict__ qxi,
                      const float* __restrict__ qyi,
                      const float* __restrict__ qzi, int ni,
                      const float* __restrict__ qxj,
                      const float* __restrict__ qyj,
                      const float* __restrict__ qzj,
                      const float* __restrict__ gmj, int nj,
                      int tiles_per_slice, float soft2, int accumulate,
                      float* __restrict__ ax, float* __restrict__ ay,
                      float* __restrict__ az, float* __restrict__ scratch) {
  constexpr int T = BI / R;
  __shared__ __align__(16) float4 tile[2][BJ];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BI + tid;
  float xi[R], yi[R], zi[R], sx[R], sy[R], sz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T;
    const bool own = i < ni;
    xi[r] = own ? qxi[i] : 0.f;
    yi[r] = own ? qyi[i] : 0.f;
    zi[r] = own ? qzi[i] : 0.f;
    sx[r] = sy[r] = sz[r] = 0.f;
  }
  const int tiles = (nj + BJ - 1) / BJ;
  const int t0 = blockIdx.y * tiles_per_slice;
  const int t1 = min(t0 + tiles_per_slice, tiles);
  auto stage = [&](int t, float4* buf) {
    for (int k = tid; k < BJ; k += T)
      stage_source_async(buf + k, qxj, qyj, qzj, gmj, t * BJ + k, nj);
    cp_async_commit();
  };
  if (t0 < t1) stage(t0, tile[0]);
  for (int t = t0; t < t1; ++t) {
    cp_async_wait_all();  // this thread's copies of tile t landed
    __syncthreads();      // everyone's did; the other buffer is free
    if (t + 1 < t1) stage(t + 1, tile[(t + 1 - t0) & 1]);
    float tx[R], ty[R], tz[R];
    tile_sum_rows<BJ, R>(tile[(t - t0) & 1], xi, yi, zi, soft2, tx, ty, tz);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sx[r] += tx[r];
      sy[r] += ty[r];
      sz[r] += tz[r];
    }
  }
  const long long n = ni;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T;
    if (i >= ni) continue;
    if (gridDim.y == 1) {
      ax[i] = accumulate ? ax[i] + sx[r] : sx[r];
      ay[i] = accumulate ? ay[i] + sy[r] : sy[r];
      az[i] = accumulate ? az[i] + sz[r] : sz[r];
    } else {
      float* out = scratch + blockIdx.y * 3 * n + i;
      out[0] = sx[r];
      out[n] = sy[r];
      out[2 * n] = sz[r];
    }
  }
}

// The slices' sums, folded in slice order: a_c[i] = sum_y scratch[y][c][i]
// (added to a_c[i] when accumulate != 0).
__global__ void tile_fold_kernel(const float* __restrict__ scratch,
                                 int slices, int ni, int accumulate,
                                 float* __restrict__ ax,
                                 float* __restrict__ ay,
                                 float* __restrict__ az) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ni) return;
  const long long n = ni;
  float s[3] = {0.f, 0.f, 0.f};
  for (int y = 0; y < slices; ++y)
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c] += scratch[(y * 3 + c) * n + i];
  ax[i] = accumulate ? ax[i] + s[0] : s[0];
  ay[i] = accumulate ? ay[i] + s[1] : s[1];
  az[i] = accumulate ? az[i] + s[2] : s[2];
}

int tile_rect_launch(const float* qxi, const float* qyi, const float* qzi,
                     int ni, const float* qxj, const float* qyj,
                     const float* qzj, const float* gmj, int nj, float soft2,
                     int block_i, int block_j, int slices,
                     int tiles_per_slice, float* scratch, int accumulate,
                     float* ax, float* ay, float* az, cudaStream_t stream) {
  if (ni <= 0) return 0;
  if (slices < 1 || slices > 65535 || tiles_per_slice < 0 ||
      (slices > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_blocks(
      block_i, block_j, kTileTargets, kTileSources, [&](auto bi, auto bj) {
        constexpr int BI = decltype(bi)::value, BJ = decltype(bj)::value;
        constexpr int R = tile_rows(BI);
        const long long tiles = (nj + BJ - 1) / BJ;
        if (static_cast<long long>(slices) * tiles_per_slice < tiles ||
            (slices > 1 &&
             static_cast<long long>(slices - 1) * tiles_per_slice >= tiles))
          return static_cast<int>(cudaErrorInvalidValue);
        const dim3 grid((ni + BI - 1) / BI, slices);
        tile_rect_rows_kernel<BI, BJ, R><<<grid, BI / R, 0, stream>>>(
            qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj, tiles_per_slice, soft2,
            accumulate, ax, ay, az, scratch);
        const int err = static_cast<int>(cudaGetLastError());
        if (err != 0 || slices == 1) return err;
        tile_fold_kernel<<<(ni + 255) / 256, 256, 0, stream>>>(
            scratch, slices, ni, accumulate, ax, ay, az);
        return static_cast<int>(cudaGetLastError());
      });
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
  return murb::with_blocks(
      block_i, block_j, murb::kTileTargets, murb::kTileSources,
      [&](auto bi, auto bj) {
        constexpr int BI = decltype(bi)::value, BJ = decltype(bj)::value;
        constexpr int R = murb::tile_rows(BI);
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, murb::tile_rect_rows_kernel<BI, BJ, R>, BI / R, 0));
      });
}
