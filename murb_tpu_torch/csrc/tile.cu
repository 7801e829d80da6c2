// K3: exact fp32 rectangular softened all-pairs sweep.
//
// Replaces the TPU kernel murb_tpu/ops/tile_pallas.py:_tile_kernel
// (pallas_call at tile_pallas.py:106; entries acc_tile_rect :75 and
// acc_tile :127).  a_i = sum_j G m_j (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^{3/2}
// for an i-set and a j-set that may differ; zero-mass sources add 0.
//
// On the TPU the accumulator was carried across a sequential j grid axis
// in VMEM.  Here one thread owns one i-body for the whole j sweep, so the
// sum never leaves registers; see sweep.cuh for the tile staging, the
// block geometries and what bounds the kernel.
#include "sweep.cuh"

namespace murb {

template <int BI, int BJ>
__global__ void __launch_bounds__(BI)
tile_rect_kernel(const float* __restrict__ qxi, const float* __restrict__ qyi,
                 const float* __restrict__ qzi, int ni,
                 const float* __restrict__ qxj, const float* __restrict__ qyj,
                 const float* __restrict__ qzj, const float* __restrict__ gmj,
                 int nj, float soft2, float* __restrict__ ax,
                 float* __restrict__ ay, float* __restrict__ az) {
  __shared__ float4 tile[BJ];
  const int i = blockIdx.x * BI + threadIdx.x;
  const bool own = i < ni;
  const float xi = own ? qxi[i] : 0.f;
  const float yi = own ? qyi[i] : 0.f;
  const float zi = own ? qzi[i] : 0.f;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j0 = 0; j0 < nj; j0 += BJ) {
    stage_sources<BI, BJ>(tile, qxj, qyj, qzj, gmj, j0, nj);
    __syncthreads();
    float tx, ty, tz;
    tile_sum_f32<BJ>(tile, xi, yi, zi, soft2, tx, ty, tz);
    sx += tx;
    sy += ty;
    sz += tz;
    __syncthreads();
  }
  if (own) {
    ax[i] = sx;
    ay[i] = sy;
    az[i] = sz;
  }
}

}  // namespace murb

// block_i, block_j: 0 (kSweepThreads each) or a pair of {64, 128, 256, 512}.
extern "C" int murb_tile_rect(const float* qxi, const float* qyi,
                              const float* qzi, int ni, const float* qxj,
                              const float* qyj, const float* qzj,
                              const float* gmj, int nj, float soft2,
                              int block_i, int block_j, float* ax, float* ay,
                              float* az, cudaStream_t stream) {
  if (ni <= 0) return 0;
  return murb::with_blocks(
      block_i, block_j, murb::kSweepThreads, murb::kSweepThreads,
      [&](auto bi, auto bj) {
        constexpr int BI = decltype(bi)::value, BJ = decltype(bj)::value;
        murb::tile_rect_kernel<BI, BJ><<<(ni + BI - 1) / BI, BI, 0, stream>>>(
            qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj, soft2, ax, ay, az);
        return static_cast<int>(cudaGetLastError());
      });
}
