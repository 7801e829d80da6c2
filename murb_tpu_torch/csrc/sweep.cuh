// Device code shared by the exact all-pairs sweeps (tile.cuh: K3, K5, K6
// and K4's passes 3) and by K7, K10 and K13 (fmm.cu, p2p.cu, mxu.cu): the
// rsqrt, cp.async and block-geometry helpers.  K3, K4's passes 3, K5 and
// K6 run the register-tiled sweep of tile.cuh (several targets a thread),
// which K14 (ring.cu) launches for its ring steps; K13 runs on the tensor
// cores (mxu.cu's note).
//
// The sweeps' design starts from the reference's own gpu+tile+full kernel
// (ref: src/murb/implem/SimulationNBodyCUDATileFullDevice.cu:53-153): the
// block stages the j-set through shared memory one tile of packed {x, y,
// z, G*m} sources at a time, and every thread reads each staged source as
// a broadcast.  The kernels mask their ragged edges themselves: targets
// past ni compute and store nothing, j >= nj slots are staged as zero-mass
// ghosts (they add exactly 0 because the softening keeps d^2 > 0), so no
// caller pads the sets.
//
// Block geometry: K3-K6 and K13 are compiled for every (BI, BJ) pair of
// {64, 128, 256, 512} (ops/cuda.SWEEP_BLOCKS) -- BI i-bodies per block,
// BJ j-sources per staged tile -- and take the pair at run time
// (with_blocks).
//
// What bounds it on an H100: the per-pair chain (3 sub, 3 fma, rsqrt,
// 3 mul, 3 fma ~ 20 flops with one MUFU op) on the fp32 pipes.  Device
// memory traffic is O(ni + nj * ni / BI) floats and never binds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace murb {

// Run launch(std::integral_constant<int, BI>, std::integral_constant<int,
// BJ>) for the compiled pair (block_i, block_j); 0 picks the default given.
// A pair outside that set launches nothing and returns
// cudaErrorInvalidValue (the wrappers refuse it first, ops/cuda.py).
template <int BI, class F>
int with_block_j(int block_j, F& launch) {
  using std::integral_constant;
  const std::integral_constant<int, BI> bi{};
  switch (block_j) {
    case 64: return launch(bi, integral_constant<int, 64>{});
    case 128: return launch(bi, integral_constant<int, 128>{});
    case 256: return launch(bi, integral_constant<int, 256>{});
    case 512: return launch(bi, integral_constant<int, 512>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class F>
int with_blocks(int block_i, int block_j, int default_i, int default_j,
                F&& launch) {
  const int bj = block_j ? block_j : default_j;
  switch (block_i ? block_i : default_i) {
    case 64: return with_block_j<64>(bj, launch);
    case 128: return with_block_j<128>(bj, launch);
    case 256: return with_block_j<256>(bj, launch);
    case 512: return with_block_j<512>(bj, launch);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------- Hopper helpers (K3's, K5's, K6's, K10's, K13's)
// 1/sqrt(x) on the MUFU with no denormal fix-up: for x = d^2 + eps^2 with
// eps > 0, never denormal, the same bits as rsqrtf.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Asynchronous copies global -> shared (sm_80+): `bytes` of src land at dst
// when `valid`, zeros otherwise (src-size 0: src is not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// The first `bytes` (0 to 4) of src to dst by one 4-byte cp.async, the
// rest of the 4 zero-filled (src is not read when bytes is 0): two bf16
// values a copy, or one where the second lies past the end.
__device__ __forceinline__ void cp_async4_n(void* dst, const void* src,
                                            int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// One body value into shared memory as fp32 (K1's bf16 instance takes the
// state's bf16 arrays; every other kernel float): a float by a 4-byte
// cp.async, zero-filled when !valid; a bf16 by a load converted to fp32
// (exact) and a store, 0 when !valid, since cp.async copies 4, 8 or 16
// bytes and never one 2-byte element.  Either way the value is the block's
// after cp_async_wait_all and a barrier, so the double buffers stay.
__device__ __forceinline__ void stage_body(float* dst, const float* src,
                                           bool valid) {
  cp_async4(dst, src, valid);
}

__device__ __forceinline__ void stage_body(float* dst,
                                           const __nv_bfloat16* src,
                                           bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}

// A body value read into a register as fp32 (exact for bf16).
__device__ __forceinline__ float body_f32(float v) { return v; }
__device__ __forceinline__ float body_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for every copy this thread issued; a __syncthreads after it makes
// the whole block's copies visible.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace murb
