// Device code shared by the Chebyshev anterpolation kernels (proxy.cu: K1
// and K2, fmm.cu: K8 and K9): the node table and the per-body basis.
//
//     S_k(t) = 1/m + (2/m) sum_{j=1}^{m-1} T_j(t) T_j(t_k),
//     t_k = cos(pi (k + 1/2) / m),
//
// with T_j(t) from the three-term recurrence and the table of T_j(t_k)
// built by each block in fp64 (the table murb_tpu builds on the host,
// proxy_pallas.py:_tj_nodes).
#pragma once

#include <cuda_runtime.h>

namespace murb {

constexpr double kPi = 3.14159265358979323846;

// table[k * (m - 1) + (j - 1)] = T_j(t_k), j = 1..m-1, k = 0..m-1.  Every
// thread of the block must call it; the caller synchronises before use.
__device__ __forceinline__ void fill_node_table(float* table, int m) {
  const int count = m * (m - 1);
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    const int k = idx / (m - 1);
    const int j = idx % (m - 1) + 1;
    const double theta = kPi * (k + 0.5) / m;
    table[idx] = static_cast<float>(cos(theta * j));
  }
}

__device__ __forceinline__ float clip_unit(float t) {
  return fminf(fmaxf(t, -1.f), 1.f);
}

__device__ __forceinline__ float scaled(float q, float c, float h) {
  return clip_unit((q - c) / h);
}

// S_k(t) for the node whose table row is `row` (m - 1 entries).
__device__ __forceinline__ float basis_value(float t, const float* row,
                                             int m) {
  float tprev = 1.f, tcur = t, s = 0.f;
  for (int j = 1; j < m; ++j) {
    if (j > 1) {
      const float tnext = 2.f * t * tcur - tprev;
      tprev = tcur;
      tcur = tnext;
    }
    s = fmaf(tcur, row[j - 1], s);
  }
  return 1.f / m + (2.f / m) * s;
}

}  // namespace murb
