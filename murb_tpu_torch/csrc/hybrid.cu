// K4: the exact all-pairs sweep with precision tiers (passes 1/2/3).
//
// Replaces the TPU kernel murb_tpu/ops/hybrid.py:_hybrid_kernel
// (pallas_call at hybrid.py:184; entries acc_hybrid_rect :145 and
// acc_hybrid :210).  The TPU kernel split the work between the vector
// unit (distances, rsqrt) and the matrix unit (the j-reduction as
// A_p @ W with bf16 Dekker splits, then a_i = P[0:3] - q_i * P[3]).  That
// algebra exists only to feed a systolic array and cancels badly in fp32,
// so it is not carried over: the sweep sums w_ij * (r_j - r_i) directly,
// with K3's tile staging (sweep.cuh).  What carries over is each tier's
// accuracy contract:
//
//   passes 2 -- fp32-class (<= ~3e-5 max relative force error): K3's own
//               fp32 kernel (tile.cu), launched through this entry.
//   passes 1 -- the TPU's fast bf16 tier.  It runs the passes-2 code here;
//               a faster tier is later work (ROADMAP.md Queue 2, K4).
//   passes 3 -- the extended tier (<= ~1e-6), this file's kernel: per-pair
//               weights with a Newton-refined rsqrt, and every pair term
//               accumulated in fp64, so no rounding error builds up across
//               the j sweep.
//
// What bounds it on an H100: the fp32 pair chain (see sweep.cuh) plus
// three fp64 fmas per pair on the half-rate fp64 pipe.
#include "sweep.cuh"

extern "C" int murb_tile_rect(const float* qxi, const float* qyi,
                              const float* qzi, int ni, const float* qxj,
                              const float* qyj, const float* qzj,
                              const float* gmj, int nj, float soft2,
                              int block_i, int block_j, int slices,
                              int tiles_per_slice, float* scratch, float* ax,
                              float* ay, float* az, cudaStream_t stream);

namespace murb {

template <int BI, int BJ>
__global__ void __launch_bounds__(BI)
hybrid_ext_rect_kernel(const float* __restrict__ qxi,
                       const float* __restrict__ qyi,
                       const float* __restrict__ qzi, int ni,
                       const float* __restrict__ qxj,
                       const float* __restrict__ qyj,
                       const float* __restrict__ qzj,
                       const float* __restrict__ gmj, int nj, float soft2,
                       float* __restrict__ ax, float* __restrict__ ay,
                       float* __restrict__ az) {
  __shared__ float4 tile[BJ];
  const int i = blockIdx.x * BI + threadIdx.x;
  const bool own = i < ni;
  const float xi = own ? qxi[i] : 0.f;
  const float yi = own ? qyi[i] : 0.f;
  const float zi = own ? qzi[i] : 0.f;
  double sx = 0.0, sy = 0.0, sz = 0.0;
  for (int j0 = 0; j0 < nj; j0 += BJ) {
    stage_sources<BI, BJ>(tile, qxj, qyj, qzj, gmj, j0, nj);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < BJ; ++t) {
      const float4 s = tile[t];
      const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
      const double w = pair_weight<true>(dx, dy, dz, s.w, soft2);
      sx = fma(w, static_cast<double>(dx), sx);
      sy = fma(w, static_cast<double>(dy), sy);
      sz = fma(w, static_cast<double>(dz), sz);
    }
    __syncthreads();
  }
  if (own) {
    ax[i] = static_cast<float>(sx);
    ay[i] = static_cast<float>(sy);
    az[i] = static_cast<float>(sz);
  }
}

}  // namespace murb

// block_i, block_j: 0 (kSweepThreads each) or a pair of {64, 128, 256, 512}.
// slices, tiles_per_slice, scratch: K3's j split (murb_tile_rect), for
// passes 1 and 2; passes 3 takes slices 1.
extern "C" int murb_hybrid_rect(const float* qxi, const float* qyi,
                                const float* qzi, int ni, const float* qxj,
                                const float* qyj, const float* qzj,
                                const float* gmj, int nj, float soft2,
                                int passes, int block_i, int block_j,
                                int slices, int tiles_per_slice,
                                float* scratch, float* ax, float* ay,
                                float* az, cudaStream_t stream) {
  if (passes < 1 || passes > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (passes < 3) {
    return murb_tile_rect(qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj, soft2,
                          block_i, block_j, slices, tiles_per_slice, scratch,
                          ax, ay, az, stream);
  }
  if (slices != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (ni <= 0) return 0;
  return murb::with_blocks(
      block_i, block_j, murb::kSweepThreads, murb::kSweepThreads,
      [&](auto bi, auto bj) {
        constexpr int BI = decltype(bi)::value, BJ = decltype(bj)::value;
        murb::hybrid_ext_rect_kernel<BI, BJ>
            <<<(ni + BI - 1) / BI, BI, 0, stream>>>(
                qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj, soft2, ax, ay, az);
        return static_cast<int>(cudaGetLastError());
      });
}
