// K6: the exact force sweep and K5's potential rows fused (phi.cuh).
#include "phi.cuh"

// K6.  gm: (n,) force weights; rows: (nr, n); phi: (nr, n); scratch
// (slices, 3 + nr, n) floats when slices > 1.
extern "C" int murb_acc_phi_rows(const float* qx, const float* qy,
                                 const float* qz, const float* gm, int n,
                                 const float* rows, int nr, float soft2,
                                 int block_i, int block_j, int slices,
                                 int tiles_per_slice, float* scratch,
                                 float* ax, float* ay, float* az, float* phi,
                                 cudaStream_t stream) {
  return murb::launch_phi_rows<true, float>(
      qx, qy, qz, n, qx, qy, qz, gm, rows, nr, n, soft2, block_i, block_j,
      slices, tiles_per_slice, scratch, ax, ay, az, phi, stream);
}

// Blocks of K6 (force != 0) or K5 at (block_i, block_j) and nr rows that
// one SM of the current device holds at once, into *blocks
// (ops/hybrid counts the card's slots with it for the j split).
extern "C" int murb_phi_resident(int block_i, int block_j, int nr,
                                 int force, int* blocks) {
  return force ? murb::phi_resident<true, float>(block_i, block_j, nr, blocks)
               : murb::phi_rows_resident(block_i, block_j, nr, blocks);
}

// The bf16 instance: murb_acc_phi_rows's arguments with the body arrays
// (coordinates, G*m) bf16 and the weight rows, outputs and scratch float;
// block_i, block_j 0 or 256 each.  The sources must start 4-byte aligned.
extern "C" int murb_acc_phi_rows_bf16(
    const __nv_bfloat16* qx, const __nv_bfloat16* qy,
    const __nv_bfloat16* qz, const __nv_bfloat16* gm, int n,
    const float* rows, int nr, float soft2, int block_i, int block_j,
    int slices, int tiles_per_slice, float* scratch, float* ax, float* ay,
    float* az, float* phi, cudaStream_t stream) {
  return murb::launch_phi_rows<true, __nv_bfloat16>(
      qx, qy, qz, n, qx, qy, qz, gm, rows, nr, n, soft2, block_i, block_j,
      slices, tiles_per_slice, scratch, ax, ay, az, phi, stream);
}

// Blocks of the bf16 instances an SM holds at once: their j split counts
// the card's slots with it.
extern "C" int murb_phi_resident_bf16(int block_i, int block_j, int nr,
                                      int force, int* blocks) {
  return force ? murb::phi_resident<true, __nv_bfloat16>(block_i, block_j,
                                                          nr, blocks)
               : murb::phi_rows_resident_bf16(block_i, block_j, nr, blocks);
}
