// K10: the exact near field (P2P) of the adaptive sparse hierarchy over
// Morton-sorted 128-body bricks (murb_tpu_torch/ops/p2p_kernels.py).
//
// Replaces the TPU kernel murb_tpu/ops/p2p_pallas.py:_kernel / _body
// (pallas_call at :332, entry p2p_sweep_pallas_sorted :284).
//
// The sorted bodies are cut into B = n / 128 bricks.  Brick pair (t, s) is
// a candidate when the bricks' cell bounding boxes lie within Chebyshev
// distance 1 (the (B, B) adjacency, built by the wrapper); inside a pair
// each body pair counts only when the bodies' own finest-level cells do
// (max |dc| <= 1, integer cell coordinates from the computation that made
// the sort key), so a candidate costs time, never accuracy.  The pairs are
// the adjacency's nonzeros in row-major (target-major) order, and only the
// first `pmax` of them are swept: row t keeps the pairs of rank r < pmax -
// starts[t], starts being the exclusive running count of the rows (the
// capacity contract of ops/p2p_kernels.p2p_sweep_kernel_sorted; the true
// count is the caller's health signal).
//
// A block owns one target brick, a thread one target body.  The block walks
// its adjacency row 128 entries at a time, compacts the set entries into a
// list in order (warp ballots), and stages each listed source brick {x, y,
// z, gm} and its cells in shared memory; every thread reads each source as
// a broadcast and adds
//     a += gm_s (d.d + eps^2)^-3/2 d,   phi += gm_s (d.d + eps^2)^-1/2
// in list order, then writes its (nf,) result once: no atomics, the same
// bits every run.  The self pair lands at d = 0: zero force, gm/eps to phi.
// Inactive bodies carry gm 0 and the sentinel cell 2C + 9, so they pair with
// nothing that weighs.  Where the TPU kernel padded each target's run of
// pairs to a multiple of G, DMA'd source bricks by scalar-prefetched index
// and revisited the output block across grid steps, this kernel needs none:
// the block's own loop is the run.
//
// Bound: fp32 issue and the MUFU rsqrt.  The kernel issues about 20 flops
// for every one of the 128^2 body pairs of a swept brick pair, but the
// function needs only the pairs that pass the cell mask (chip_smoke.py
// counts them for the bound); the adjacency row is B bytes a block.
#include <cuda_runtime.h>

namespace murb {

constexpr int kBrick = 128;   // bodies per brick, threads per block

template <bool kPhi>
__global__ void __launch_bounds__(kBrick)
p2p_kernel(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ z, const float* __restrict__ gm,
           const int* __restrict__ cx, const int* __restrict__ cy,
           const int* __restrict__ cz, int nbrick,
           const unsigned char* __restrict__ adj,
           const long long* __restrict__ starts, long long pmax,
           float soft2, float* __restrict__ out) {
  __shared__ float4 src[kBrick];
  __shared__ int4 csrc[kBrick];
  __shared__ int list[kBrick];
  __shared__ int wcount[kBrick / 32];

  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i = static_cast<long long>(t) * kBrick + tid;
  const float xt = x[i], yt = y[i], zt = z[i];
  const int cxt = cx[i], cyt = cy[i], czt = cz[i];
  float ax = 0.f, ay = 0.f, az = 0.f, phi = 0.f;

  const unsigned char* row = adj + static_cast<long long>(t) * nbrick;
  const long long budget = pmax - starts[t];  // pairs of this row kept
  long long done = 0;
  for (int s0 = 0; s0 < nbrick && done < budget; s0 += kBrick) {
    // compact this tile's set entries into `list`, in order
    const bool set = s0 + tid < nbrick && row[s0 + tid] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, set);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kBrick / 32; ++w) {
      before += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (set) list[before + __popc(ballot & ((1u << lane) - 1u))] = s0 + tid;
    __syncthreads();
    const int take = static_cast<int>(
        min(static_cast<long long>(total), budget - done));
    for (int k = 0; k < take; ++k) {
      const long long j = static_cast<long long>(list[k]) * kBrick + tid;
      src[tid] = make_float4(x[j], y[j], z[j], gm[j]);
      csrc[tid] = make_int4(cx[j], cy[j], cz[j], 0);
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kBrick; ++jj) {
        const float4 s = src[jj];
        const int4 c = csrc[jj];
        const float dx = s.x - xt, dy = s.y - yt, dz = s.z - zt;
        const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft2)));
        const float inv = rsqrtf(r2);
        const bool near = max(abs(c.x - cxt), max(abs(c.y - cyt),
                                                  abs(c.z - czt))) <= 1;
        const float w0 = near ? s.w : 0.f;
        const float w = w0 * (inv * inv * inv);
        ax = fmaf(w, dx, ax);
        ay = fmaf(w, dy, ay);
        az = fmaf(w, dz, az);
        if (kPhi) phi = fmaf(w0, inv, phi);
      }
      __syncthreads();  // the staged brick is consumed
    }
    done += total;
  }
  const long long n = static_cast<long long>(nbrick) * kBrick;
  out[i] = ax;
  out[n + i] = ay;
  out[2 * n + i] = az;
  if (kPhi) out[3 * n + i] = phi;
}

}  // namespace murb

// K10.  Sorted bodies x, y, z, gm and their cells cx, cy, cz (n = nbrick *
// 128 each); adj: (nbrick, nbrick) bytes, nonzero for a candidate pair;
// starts: (nbrick,) pairs of the rows before each row; pmax: pairs kept;
// out: (nf, n) with nf = 4 when with_phi, else 3.
extern "C" int murb_p2p_sorted(const float* x, const float* y, const float* z,
                               const float* gm, const int* cx, const int* cy,
                               const int* cz, int nbrick,
                               const unsigned char* adj,
                               const long long* starts, long long pmax,
                               float soft2, int with_phi, float* out,
                               cudaStream_t stream) {
  if (nbrick < 1 || pmax < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (with_phi)
    murb::p2p_kernel<true><<<nbrick, murb::kBrick, 0, stream>>>(
        x, y, z, gm, cx, cy, cz, nbrick, adj, starts, pmax, soft2, out);
  else
    murb::p2p_kernel<false><<<nbrick, murb::kBrick, 0, stream>>>(
        x, y, z, gm, cx, cy, cz, nbrick, adj, starts, pmax, soft2, out);
  return static_cast<int>(cudaGetLastError());
}
