// K4: the exact all-pairs sweep with precision tiers (passes 2 and 3).
//
// Replaces the TPU kernel murb_tpu/ops/hybrid.py:_hybrid_kernel
// (pallas_call at hybrid.py:184; entries acc_hybrid_rect :145 and
// acc_hybrid :210).  The TPU kernel split the work between the vector
// unit (distances, rsqrt) and the matrix unit (the j-reduction as
// A_p @ W with bf16 Dekker splits, then a_i = P[0:3] - q_i * P[3]).  That
// algebra exists only to feed a systolic array and cancels badly in fp32,
// so it is not carried over: the sweep sums w_ij * (r_j - r_i) directly.
// What carries over is each tier's accuracy contract:
//
//   passes 2 -- fp32-class (<= ~3e-5 max relative force error): K3's own
//               fp32 kernel (tile.cu), launched through this entry.
//   passes 1 -- the TPU's fast tier (W rounded once, one pass): a kernel of
//               its own, hybrid_fast.cu (murb_hybrid_fast), which this
//               entry refuses.
//   passes 3 -- the extended tier (<= ~1e-6): K3's register-tiled sweep
//               (tile.cuh, sweep_rows_kernel with kExt) with a
//               Newton-refined rsqrt, each run of 4 sources summed in fp32
//               and folded into fp64 sums, and K3's j split with fp64
//               slice partials folded in slice order.  This is the
//               reference tier's structure (murb_tpu/ops/hybrid.py: fp32
//               inside a j block, compensated across blocks), at a run
//               short enough for the contract (tile.cuh's note).
//
// What bounds passes 3 on an H100: fp32 issue.  A pair costs K3's 12 fp32
// instructions and one MUFU rsqrt, the Newton step's 4, and a quarter of a
// run's fold (3 F2F and 3 DADD a target a run of 4: 1.5 a pair); the F2F
// (16 a clock an SM) and DADD (64) pipes stay under the fp32 issue (128).
// The first design (one target a thread, synchronous staging, no j split,
// every pair term converted to fp64 and added with three DFMAs: 4 F2F a
// pair) ran 128 four-warp blocks at 16384^2 and sat on the F2F pipe.
//
// bf16 state: murb_hybrid_rect_bf16 runs the tiers' bf16 instances (K3's
// for passes 2, the kExt sweep's for passes 3; tile.cuh's TB), which
// stages bf16 tiles by cp.async and converts them to fp32 in shared
// memory: the fp32 instance's bits on the arrays upcast.
#include "tile.cuh"

extern "C" int murb_tile_rect(const float* qxi, const float* qyi,
                              const float* qzi, int ni, const float* qxj,
                              const float* qyj, const float* qzj,
                              const float* gmj, int nj, float soft2,
                              int block_i, int block_j, int slices,
                              int tiles_per_slice, float* scratch, float* ax,
                              float* ay, float* az, cudaStream_t stream);
extern "C" int murb_tile_rect_bf16(
    const __nv_bfloat16* qxi, const __nv_bfloat16* qyi,
    const __nv_bfloat16* qzi, int ni, const __nv_bfloat16* qxj,
    const __nv_bfloat16* qyj, const __nv_bfloat16* qzj,
    const __nv_bfloat16* gmj, int nj, float soft2, int block_i, int block_j,
    int slices, int tiles_per_slice, float* scratch, float* ax, float* ay,
    float* az, cudaStream_t stream);

namespace murb {

// Passes 3's default geometry (ops/hybrid.EXT_BLOCK_I, EXT_BLOCK_J): of
// six geometries at tile_split's slices (scripts/torch_kernel_ab.py
// --variants), 128x128 was the fastest at 16384^2 and within 0.1% of the
// fastest at 200,192^2, where K3's 128x512 (5 slices) took 9% longer.
constexpr int kExtTargets = 128;
constexpr int kExtSources = 128;

}  // namespace murb

// passes: 2 or 3.  block_i, block_j: 0 (the tier's default geometry: K3's
// for passes 2, kExtTargets x kExtSources for passes 3) or a pair of {64,
// 128, 256, 512}.  slices, tiles_per_slice, scratch: the j split
// (ops/cuda.tile_split; every slice holds a tile when nj > 0): for passes 2
// K3's (murb_tile_rect, scratch (slices, 3, ni) floats), for passes 3 with
// its own resident count (murb_hybrid_resident) and scratch (slices, 3, ni)
// doubles.
extern "C" int murb_hybrid_rect(const float* qxi, const float* qyi,
                                const float* qzi, int ni, const float* qxj,
                                const float* qyj, const float* qzj,
                                const float* gmj, int nj, float soft2,
                                int passes, int block_i, int block_j,
                                int slices, int tiles_per_slice,
                                void* scratch, float* ax, float* ay,
                                float* az, cudaStream_t stream) {
  if (passes < 2 || passes > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (passes == 2) {
    return murb_tile_rect(qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj, soft2,
                          block_i, block_j, slices, tiles_per_slice,
                          static_cast<float*>(scratch), ax, ay, az, stream);
  }
  return murb::sweep_launch<0, true, true>(
      qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nullptr, nj, soft2,
      block_i ? block_i : murb::kExtTargets,
      block_j ? block_j : murb::kExtSources, slices, tiles_per_slice,
      static_cast<double*>(scratch), 0, ax, ay, az, nullptr, stream);
}

// Blocks of passes 3's sweep at (block_i, block_j) that one SM of the
// current device holds at once, into *blocks: its j split counts the
// card's slots with it (ops/hybrid.ext_split_args).
extern "C" int murb_hybrid_resident(int block_i, int block_j, int* blocks) {
  return murb::sweep_resident<0, true, true>(
      block_i ? block_i : murb::kExtTargets,
      block_j ? block_j : murb::kExtSources, blocks);
}

// The bf16 instances (a bf16 state's arrays, each value converted to fp32
// as it is loaded, tile.cuh): murb_hybrid_rect's arguments with the seven
// body arrays bf16; passes 2 runs K3's bf16 instance, passes 3 the kExt
// sweep's.
extern "C" int murb_hybrid_rect_bf16(
    const __nv_bfloat16* qxi, const __nv_bfloat16* qyi,
    const __nv_bfloat16* qzi, int ni, const __nv_bfloat16* qxj,
    const __nv_bfloat16* qyj, const __nv_bfloat16* qzj,
    const __nv_bfloat16* gmj, int nj, float soft2, int passes, int block_i,
    int block_j, int slices, int tiles_per_slice, void* scratch, float* ax,
    float* ay, float* az, cudaStream_t stream) {
  if (passes < 2 || passes > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (passes == 2) {
    return murb_tile_rect_bf16(qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj,
                               soft2, block_i, block_j, slices,
                               tiles_per_slice, static_cast<float*>(scratch),
                               ax, ay, az, stream);
  }
  return murb::sweep_launch<0, true, true, __nv_bfloat16>(
      qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nullptr, nj, soft2,
      block_i ? block_i : murb::kExtTargets,
      block_j ? block_j : murb::kExtSources, slices, tiles_per_slice,
      static_cast<double*>(scratch), 0, ax, ay, az, nullptr, stream);
}

// Blocks of passes 3's bf16 instance an SM holds at once.
extern "C" int murb_hybrid_resident_bf16(int block_i, int block_j,
                                         int* blocks) {
  return murb::sweep_resident<0, true, true, __nv_bfloat16>(
      block_i ? block_i : murb::kExtTargets,
      block_j ? block_j : murb::kExtSources, blocks);
}
