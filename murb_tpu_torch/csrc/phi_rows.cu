// K5: the multi-row potential sweep (phi.cuh).
#include "phi.cuh"

namespace murb {

int phi_rows_resident(int block_i, int block_j, int nr, int* blocks) {
  return phi_resident<false, float>(block_i, block_j, nr, blocks);
}

int phi_rows_resident_bf16(int block_i, int block_j, int nr, int* blocks) {
  return phi_resident<false, __nv_bfloat16>(block_i, block_j, nr, blocks);
}

}  // namespace murb

// K5.  rows: (nr, nj) weights; phi: (nr, ni).  block_i, block_j: 0 (the
// defaults, phi.cuh) or a pair of {64, 128, 256, 512}; slices,
// tiles_per_slice: the j split (ops/cuda.tile_split); slices > 1 needs
// scratch, (slices, nr, ni) floats.
extern "C" int murb_phi_rows_rect(const float* qxi, const float* qyi,
                                  const float* qzi, int ni, const float* qxj,
                                  const float* qyj, const float* qzj, int nj,
                                  const float* rows, int nr, float soft2,
                                  int block_i, int block_j, int slices,
                                  int tiles_per_slice, float* scratch,
                                  float* phi, cudaStream_t stream) {
  return murb::launch_phi_rows<false, float>(
      qxi, qyi, qzi, ni, qxj, qyj, qzj, nullptr, rows, nr, nj, soft2,
      block_i, block_j, slices, tiles_per_slice, scratch, nullptr, nullptr,
      nullptr, phi, stream);
}

// The bf16 instance: murb_phi_rows_rect's arguments with the coordinates
// bf16 and the weight rows, outputs and scratch float; block_i, block_j 0
// or 256 each.  The sources must start 4-byte aligned.
extern "C" int murb_phi_rows_rect_bf16(
    const __nv_bfloat16* qxi, const __nv_bfloat16* qyi,
    const __nv_bfloat16* qzi, int ni, const __nv_bfloat16* qxj,
    const __nv_bfloat16* qyj, const __nv_bfloat16* qzj, int nj,
    const float* rows, int nr, float soft2, int block_i, int block_j,
    int slices, int tiles_per_slice, float* scratch, float* phi,
    cudaStream_t stream) {
  return murb::launch_phi_rows<false, __nv_bfloat16>(
      qxi, qyi, qzi, ni, qxj, qyj, qzj, nullptr, rows, nr, nj, soft2,
      block_i, block_j, slices, tiles_per_slice, scratch, nullptr, nullptr,
      nullptr, phi, stream);
}
