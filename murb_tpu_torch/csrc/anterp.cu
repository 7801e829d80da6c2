// K11 (windowed P2M) and K12 (windowed L2P): the anterpolation stages of
// the adaptive sparse hierarchy (murb_tpu_torch/ops/anterp_kernels.py).
//
// Replace the TPU kernels murb_tpu/ops/anterp_pallas.py:_p2m_win_kernel
// (pallas_call at :227, entry p2m_window_pallas :186) and _l2p_win_kernel
// (pallas_call at :315, entry l2p_window_pallas :272).
//
// The bodies arrive Morton-sorted (ops/sparse_fmm.solve_adaptive), each
// with its finest-level cell coordinates (cx, cy, cz), taken from the one
// computation that made the sort key, and its slot: the rank of its cell
// in the sorted list of occupied cells, `cap` for the dump (inactive
// bodies, capacity overflow).  Sorted order makes the slots non-decreasing,
// so each slot's bodies are one run [bounds[s], bounds[s + 1]) and the
// wrapper hands the kernels those bounds and a prefix of work items per
// slot.  The TPU kernels contracted (B, B) one-hot windows on the MXU in
// bf16 Dekker splits and carried a boundary row from one grid step to the
// next; here a work item is a run of one slot's bodies, so no one-hot and
// no carry exist, and everything is fp32 with fp32 fmas.
//
// K11 and K12 are the run kernels of cell_runs.cuh (those of K8 and K9)
// over the slots (SlotRuns: bodies in place, each with its own cell).  The
// dump slot `cap` has no bodies: its row of W reads 0, and the dump bodies
// keep K12's zeroed output.  At the main path (m = 6, 48 bodies a slot on
// average) a warp runs an item, four a block (cell_runs.cuh's warp tier):
// device memory (28 to 32 bytes a body, the fields once) and fp32 issue
// (216 fmas per body and field) are about even there.
#include <cuda_runtime.h>

#include "cell_runs.cuh"

// K11.  Sorted bodies q, gm and their cells (cx, cy, cz); box: [lo(3),
// cs(3)]; nslot = cap + 1 slots; bounds: nslot + 1 offsets of each slot's
// run; prefix: nslot + 1 offsets of each slot's work items of `chunk`
// bodies; nitems: the items (at least prefix[nslot]); table: the node
// table of order m; partial: nitems * m^3 floats of scratch, or null when
// no slot has two items (w zeroed by the caller); w: (nslot, m^3).
extern "C" int murb_p2m_window(const float* qx, const float* qy,
                               const float* qz, const float* gm,
                               const int* cx, const int* cy, const int* cz,
                               const float* box, int m, int nslot,
                               const long long* bounds,
                               const long long* prefix, int nitems,
                               int chunk, const float* table, float* partial,
                               float* w, cudaStream_t stream) {
  return murb::p2m_runs(qx, qy, qz, gm, murb::SlotRuns{cx, cy, cz}, box, m,
                        nslot, bounds, prefix, nitems, chunk, table,
                        partial, w, stream);
}

// K12.  fields: nf (1 to 4) device pointers (a host array) to (nslot, m^3)
// fields; out: (nf, n), zeroed by the caller (dump bodies are in no work
// item); prefix: work items of L2PGeom<MW>::kItem bodies.
extern "C" int murb_l2p_window(const float* qx, const float* qy,
                               const float* qz, const int* cx, const int* cy,
                               const int* cz, int n, const float* box, int m,
                               int nslot, const long long* bounds,
                               const long long* prefix, int nitems,
                               const float* table,
                               const float* const* fields, int nf, float* out,
                               cudaStream_t stream) {
  return murb::l2p_runs(qx, qy, qz, murb::SlotRuns{cx, cy, cz}, n, box, m,
                        nslot, bounds, prefix, nitems, table, fields, nf,
                        out, stream);
}

// The bf16 instances (a bf16 state's sorted bodies, each value converted
// to fp32 as it is loaded: cell_runs.cuh's TB of the P2M and Q of the L2P,
// as K8's and K9's): the fp32 instances' bits on the arrays upcast.
// murb_p2m_window's arguments with the four body arrays bf16.
extern "C" int murb_p2m_window_bf16(
    const __nv_bfloat16* qx, const __nv_bfloat16* qy,
    const __nv_bfloat16* qz, const __nv_bfloat16* gm, const int* cx,
    const int* cy, const int* cz, const float* box, int m, int nslot,
    const long long* bounds, const long long* prefix, int nitems, int chunk,
    const float* table, float* partial, float* w, cudaStream_t stream) {
  return murb::p2m_runs(qx, qy, qz, gm, murb::SlotRuns{cx, cy, cz}, box, m,
                        nslot, bounds, prefix, nitems, chunk, table,
                        partial, w, stream);
}

// murb_l2p_window's arguments with the three coordinate arrays bf16 (the
// fields and outputs float).
extern "C" int murb_l2p_window_bf16(
    const __nv_bfloat16* qx, const __nv_bfloat16* qy,
    const __nv_bfloat16* qz, const int* cx, const int* cy, const int* cz,
    int n, const float* box, int m, int nslot, const long long* bounds,
    const long long* prefix, int nitems, const float* table,
    const float* const* fields, int nf, float* out, cudaStream_t stream) {
  return murb::l2p_runs(qx, qy, qz, murb::SlotRuns{cx, cy, cz}, n, box, m,
                        nslot, bounds, prefix, nitems, table, fields, nf,
                        out, stream);
}
