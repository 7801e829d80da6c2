// Device constants and helpers shared by the Chebyshev kernels (fmm.cu's
// K7 node coordinates; the anterpolation kernels K1, K2, K8, K9, K11 and
// K12).  The node table T_j(t_k), t_k = cos(pi (k + 1/2) / m), comes
// from the wrapper (ops/proxy_kernels.node_table, murb_tpu's
// proxy_pallas.py:_tj_nodes in float32); cell_runs.cuh's basis_span builds
// each body's bases from it.
#pragma once

#include <cuda_runtime.h>

namespace murb {

constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ float clip_unit(float t) {
  return fminf(fmaxf(t, -1.f), 1.f);
}

}  // namespace murb
