// K5 (multi-row potential sweep) and K6 (the exact force sweep and K5
// fused): the potentials of the tracking engines.
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
// which cancels in fp32.  Here one thread owns one i-body for the whole j
// sweep, as in K3 (sweep.cuh): the block stages one tile of sources and
// their R weights through shared memory, every thread reads them as
// broadcasts, and the force sums w (r_j - r_i) directly.  Each row and the
// force are summed in fp32 per tile and the tile partials in fp32 again, so
// passes 1 and 2 both give the fp32-class contract (force as K4 passes 2,
// phi to ~1e-6 relative).  The R accumulators live in registers: R is a
// template parameter.
//
// What bounds it on an H100: the fp32 pipes.  Per pair K5 does 3 sub,
// 3 fma, one rsqrt (MUFU) and R fma; K6 adds 3 mul and 3 fma for the
// force.  Device memory traffic is O((R + 4) nj ni / kSweepThreads) floats
// and never binds.
#include "sweep.cuh"

namespace murb {

template <int R, bool kForce>
__global__ void __launch_bounds__(kSweepThreads)
phi_rows_kernel(const float* __restrict__ qxi, const float* __restrict__ qyi,
                const float* __restrict__ qzi, int ni,
                const float* __restrict__ qxj, const float* __restrict__ qyj,
                const float* __restrict__ qzj, const float* __restrict__ gmj,
                const float* __restrict__ rows, int nj, float soft2,
                float* __restrict__ ax, float* __restrict__ ay,
                float* __restrict__ az, float* __restrict__ phi) {
  __shared__ float4 tile[kSweepThreads];
  __shared__ float wtile[R][kSweepThreads];
  const int i = blockIdx.x * kSweepThreads + threadIdx.x;
  const bool own = i < ni;
  const float xi = own ? qxi[i] : 0.f;
  const float yi = own ? qyi[i] : 0.f;
  const float zi = own ? qzi[i] : 0.f;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  float sp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sp[r] = 0.f;

  for (int j0 = 0; j0 < nj; j0 += kSweepThreads) {
    stage_phi_sources<R, kForce>(tile, wtile, qxj, qyj, qzj, gmj, rows, j0,
                                 nj);
    __syncthreads();
    float tx = 0.f, ty = 0.f, tz = 0.f;
    float tp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) tp[r] = 0.f;
#pragma unroll 4
    for (int t = 0; t < kSweepThreads; ++t) {
      const float4 s = tile[t];
      const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
      const float inv = rsqrtf(fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz,
                                                              soft2))));
      if (kForce) {
        const float w = s.w * (inv * inv * inv);
        tx = fmaf(w, dx, tx);
        ty = fmaf(w, dy, ty);
        tz = fmaf(w, dz, tz);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) tp[r] = fmaf(wtile[r][t], inv, tp[r]);
    }
    if (kForce) {
      sx += tx;
      sy += ty;
      sz += tz;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) sp[r] += tp[r];
    __syncthreads();
  }
  if (own) {
    if (kForce) {
      ax[i] = sx;
      ay[i] = sy;
      az[i] = sz;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) phi[static_cast<long long>(r) * ni + i] = sp[r];
  }
}

template <bool kForce>
int launch_phi_rows(const float* qxi, const float* qyi, const float* qzi,
                    int ni, const float* qxj, const float* qyj,
                    const float* qzj, const float* gmj, const float* rows,
                    int nr, int nj, float soft2, float* ax, float* ay,
                    float* az, float* phi, cudaStream_t stream) {
  if (nr < 1 || nr > kMaxPhiRows || nj < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ni <= 0) return 0;
  const int blocks = (ni + kSweepThreads - 1) / kSweepThreads;
#define MURB_PHI_CASE(R)                                                  \
  case R:                                                                 \
    phi_rows_kernel<R, kForce><<<blocks, kSweepThreads, 0, stream>>>(     \
        qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, rows, nj, soft2, ax, ay,   \
        az, phi);                                                         \
    break;
  switch (nr) {
    MURB_PHI_CASE(1)
    MURB_PHI_CASE(2)
    MURB_PHI_CASE(3)
    MURB_PHI_CASE(4)
    MURB_PHI_CASE(5)
    MURB_PHI_CASE(6)
    MURB_PHI_CASE(7)
    MURB_PHI_CASE(8)
  }
#undef MURB_PHI_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace murb

// K5.  rows: (nr, nj) weights; phi: (nr, ni).
extern "C" int murb_phi_rows_rect(const float* qxi, const float* qyi,
                                  const float* qzi, int ni, const float* qxj,
                                  const float* qyj, const float* qzj, int nj,
                                  const float* rows, int nr, float soft2,
                                  float* phi, cudaStream_t stream) {
  return murb::launch_phi_rows<false>(qxi, qyi, qzi, ni, qxj, qyj, qzj,
                                      nullptr, rows, nr, nj, soft2, nullptr,
                                      nullptr, nullptr, phi, stream);
}

// K6.  gm: (n,) force weights; rows: (nr, n); phi: (nr, n).
extern "C" int murb_acc_phi_rows(const float* qx, const float* qy,
                                 const float* qz, const float* gm, int n,
                                 const float* rows, int nr, float soft2,
                                 float* ax, float* ay, float* az, float* phi,
                                 cudaStream_t stream) {
  return murb::launch_phi_rows<true>(qx, qy, qz, n, qx, qy, qz, gm, rows, nr,
                                     n, soft2, ax, ay, az, phi, stream);
}
