// K13: the norm-expansion all-pairs sweep (the tpu+mxu engine).
//
// Replaces the TPU kernel murb_tpu/ops/mxu.py:_mxu_kernel (pallas_call at
// mxu.py:159; entries acc_mxu_rect :96 and acc_mxu :193).  The wrapper
// (ops/mxu.py) centres the coordinates on the G*m-weighted mean and packs
// the operands as mxu.py:132-142 does:
//
//   A (8, nj): rows cqx_j, cqy_j, cqz_j, |cq_j|^2, 1, 0, 0, 0
//   B (8, ni): rows -2 cqx_i, -2 cqy_i, -2 cqz_i, 1, |cq_i|^2 + eps^2, 0, 0, 0
//
// and this kernel computes, for every target i,
//
//   S[j,i] = A[:,j] . B[:,i]      = |r_j - r_i|^2 + eps^2 (norm expansion)
//   W[j,i] = gm_j * rsqrt(S[j,i])^3
//   P[:,i] = sum_j A[:,j] W[j,i]  (rows 0-2: sum_j w cq_j; row 4: sum_j w)
//   a_i    = P[0:3,i] - cq_i * P[4,i]
//
// Self-pairs stay in the sum (w_ii * cq_i in P[0:3] cancels against
// cq_i * w_ii in the epilogue), as on the TPU.  Rows 5-7 of A and B are
// zero and rows 3/4 hold the expansion's constant 1s, so the kernel reads
// rows 0-3 of A and rows 0-2 and 4 of B and forms S as
// A0 B0 + A1 B1 + A2 B2 + (A3 + B4): three FMAs and one add per pair; W is
// one rsqrt and three multiplies; P three FMAs and one add.
//
// On the TPU, S and P were matrix-unit products (the precision tiers chose
// bf16 passes for P); here every tier computes in fp32 on the CUDA cores,
// which meets each tier's error bound.  The design is K3's (sweep.cuh):
// one thread owns one target for the whole j sweep and keeps B[:,i] and
// P[:,i] in registers; the block stages BJ sources at a time in shared
// memory as (cqx, cqy, cqz, |cq|^2) and gm, read by every thread as
// broadcasts.  Each tile's terms are summed into fp32 partials that are
// added to P in tile order (the TPU's per-block P added to its
// accumulator): a fixed order, so the kernel is deterministic.  Ragged
// edges are masked here: targets past ni store nothing, source slots past
// nj are staged as zero-mass sources at the centre (S = B4 > 0, w = 0).
//
// What bounds it on an H100: the fp32 pipes and the MUFU rsqrt (per pair
// 11 fp32 instructions and one rsqrt, the 20 flops of the reference's
// model); device memory traffic is O(ni + nj * ni / BI) floats.
#include "sweep.cuh"

namespace murb {

constexpr int kMxuBlockI = 128;  // K13's default targets per block
constexpr int kMxuBlockJ = 256;  // and sources per staged tile

template <int BI, int BJ>
__global__ void __launch_bounds__(BI)
mxu_rect_kernel(const float* __restrict__ a, const float* __restrict__ gmj,
                int nj, const float* __restrict__ b,
                const float* __restrict__ cqxi,
                const float* __restrict__ cqyi,
                const float* __restrict__ cqzi, int ni,
                float* __restrict__ ax, float* __restrict__ ay,
                float* __restrict__ az) {
  __shared__ float4 src[BJ];   // (cqx, cqy, cqz, |cq|^2) of each source
  __shared__ float gms[BJ];
  const long long sj = nj, si = ni;  // row strides of A and B
  const int i = blockIdx.x * BI + threadIdx.x;
  const bool own = i < ni;
  const float b0 = own ? b[i] : 0.f;
  const float b1 = own ? b[si + i] : 0.f;
  const float b2 = own ? b[2 * si + i] : 0.f;
  const float b4 = own ? b[4 * si + i] : 1.f;
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, p4 = 0.f;
  for (int j0 = 0; j0 < nj; j0 += BJ) {
    for (int t = threadIdx.x; t < BJ; t += BI) {
      const int j = j0 + t;
      const bool real = j < nj;
      src[t] = real ? make_float4(a[j], a[sj + j], a[2 * sj + j],
                                  a[3 * sj + j])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      gms[t] = real ? gmj[j] : 0.f;
    }
    __syncthreads();
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t4 = 0.f;
#pragma unroll 8
    for (int t = 0; t < BJ; ++t) {
      const float4 s = src[t];
      const float sji = fmaf(s.x, b0, fmaf(s.y, b1, fmaf(s.z, b2, s.w + b4)));
      const float inv = rsqrtf(sji);
      const float w = gms[t] * (inv * inv * inv);
      t0 = fmaf(s.x, w, t0);
      t1 = fmaf(s.y, w, t1);
      t2 = fmaf(s.z, w, t2);
      t4 += w;
    }
    p0 += t0;
    p1 += t1;
    p2 += t2;
    p4 += t4;
    __syncthreads();
  }
  if (own) {
    ax[i] = p0 - cqxi[i] * p4;
    ay[i] = p1 - cqyi[i] * p4;
    az[i] = p2 - cqzi[i] * p4;
  }
}

}  // namespace murb

// a: A (8, nj) row-major; gmj: (nj,); b: B (8, ni) row-major; cqxi..cqzi:
// the centred target coordinates (ni,).  block_i, block_j: 0 (kMxuBlockI,
// kMxuBlockJ) or a pair of {64, 128, 256, 512}.
extern "C" int murb_mxu_rect(const float* a, const float* gmj, int nj,
                             const float* b, const float* cqxi,
                             const float* cqyi, const float* cqzi, int ni,
                             int block_i, int block_j, float* ax, float* ay,
                             float* az, cudaStream_t stream) {
  if (ni <= 0) return 0;
  return murb::with_blocks(
      block_i, block_j, murb::kMxuBlockI, murb::kMxuBlockJ,
      [&](auto bi, auto bj) {
        constexpr int BI = decltype(bi)::value, BJ = decltype(bj)::value;
        murb::mxu_rect_kernel<BI, BJ><<<(ni + BI - 1) / BI, BI, 0, stream>>>(
            a, gmj, nj, b, cqxi, cqyi, cqzi, ni, ax, ay, az);
        return static_cast<int>(cudaGetLastError());
      });
}
