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
// A block owns one target brick, a warp one 32-body sub-brick of it, a
// thread one target body.  The block walks its adjacency row 1024 entries
// at a time, compacts the set entries into a list in order (a block scan),
// and stages each listed source brick -- {x, y, z, G m} and the cells as
// one 16-byte cp.async each a thread, double-buffered so that the next
// brick lands while this one is swept, one barrier a brick.  Every thread
// adds, for the sources of each listed brick in order, in fp32,
//     a += gm_s (d.d + eps^2)^-3/2 d,   phi += gm_s (d.d + eps^2)^-1/2
// folds the brick's sums into fp64 sums (the bricks in order), and writes
// its (nf,) result once: no atomics, the same bits every run.  The fold
// keeps the error of a long row at that of one brick's fp32 sum: a plan
// with coarser finest cells gives a target ~60k sources (the 1M
// two-cluster box at L = 6), over which one fp32 sum drifted to 3.1e-5 of
// max|a| against float64 where a brick's drifts to 3e-7; it costs four
// DADDs a brick a thread.
// The self pair lands at d = 0: zero force, gm/eps to phi.  Inactive
// bodies carry gm 0 and the sentinel cell 2C + 9, so they pair with
// nothing that weighs.  The blocks run in decreasing row length (`order`,
// from the wrapper), so the longest rows do not trail the launch.
//
// Bound: fp32 issue and the MUFU rsqrt over the body pairs the cell mask
// passes (chip_smoke.py counts them for the bound).  The first design swept
// all 128^2 body pairs of every candidate brick pair (0.489 of them masked
// out on the 1M two-cluster box) and paid, on every pair, a second shared
// load (the cells) and about 10 integer instructions for the mask, besides
// the rsqrt's denormal fix-up: 46.90 ms against a bound of 2.74.  This
// design classes each (32-target, 32-source) sub-tile pair by the
// sub-bricks' cell boxes (ops/p2p.subtile_class, the wrapper's boxes):
//   far       some axis has a gap > 1: every pair is masked, the warp skips
//             the sub-tile (a warp-uniform branch);
//   all-near  every pair passes: the chain runs with no cell load and no
//             mask;
//   mixed     the per-pair test, as before.
// A skipped pair would only have added w = 0 and the sources keep their
// order, so the sums are a sweep of every pair's bit for bit.  The rsqrt is
// rsqrt.approx.ftz (d^2 + eps^2 is never denormal for eps > 0).
//
// bf16 state (murb_p2p_sorted_bf16): the wrapper packs the bodies as
// {x, y, z, G m} bf16 rows of 8 bytes.  A source brick is staged raw, one
// 8-byte cp.async a thread, double-buffered as the fp32 rows are, and once
// it has landed each thread converts its row into the one fp32 brick the
// sweep reads (exact; a barrier more a brick), so the sums are the fp32
// instance's bit for bit on the rows upcast.  The cells stay int.
#include "sweep.cuh"

namespace murb {

constexpr int kBrick = 128;         // bodies per brick, threads per block
constexpr int kSub = 32;            // bodies per sub-brick: a warp
constexpr int kSubs = kBrick / kSub;
constexpr int kPass = 1024;         // adjacency entries a walk pass
constexpr int kPerThread = kPass / kBrick;

// One 32-source sub-tile against this thread's target; `masked` applies
// the per-pair cell test (a mixed sub-tile).
template <bool kPhi, bool masked>
__device__ __forceinline__ void sweep_sub(const float4* src, const int4* csrc,
                                          float4 me, int4 mc, float soft2,
                                          float& ax, float& ay, float& az,
                                          float& phi) {
#pragma unroll 8
  for (int jj = 0; jj < kSub; ++jj) {
    const float4 s = src[jj];
    const float dx = s.x - me.x, dy = s.y - me.y, dz = s.z - me.z;
    const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft2)));
    const float inv = rsqrt_ftz(r2);
    float w0 = s.w;
    if (masked) {
      const int4 c = csrc[jj];
      const bool near = static_cast<unsigned>(c.x - mc.x + 1) <= 2u &&
                        static_cast<unsigned>(c.y - mc.y + 1) <= 2u &&
                        static_cast<unsigned>(c.z - mc.z + 1) <= 2u;
      w0 = near ? s.w : 0.f;
    }
    const float w = w0 * (inv * inv * inv);
    ax = fmaf(w, dx, ax);
    ay = fmaf(w, dy, ay);
    az = fmaf(w, dz, az);
    if (kPhi) phi = fmaf(w0, inv, phi);
  }
}

// A body row {x, y, z, G m} as fp32: a float4 as it is, four bf16 (8
// bytes, little-endian pairs) converted exactly.
__device__ __forceinline__ float4 body_row(float4 v) { return v; }
__device__ __forceinline__ float4 body_row(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// Row: float4 (the fp32 instance) or uint2 (four bf16, the bf16 instance).
template <bool kPhi, class Row>
__global__ void __launch_bounds__(kBrick)
p2p_kernel(const Row* __restrict__ body, const int4* __restrict__ cell,
           const int4* __restrict__ box, const int* __restrict__ order,
           int nbrick, const unsigned char* __restrict__ adj,
           const long long* __restrict__ starts, long long pmax, float soft2,
           float* __restrict__ out) {
  constexpr bool kB16 = std::is_same_v<Row, uint2>;
  __shared__ __align__(16) float4 src[kB16 ? 1 : 2][kBrick];
  __shared__ __align__(16) uint2 raw[kB16 ? 2 : 1][kB16 ? kBrick : 1];
  __shared__ __align__(16) int4 csrc[2][kBrick];
  __shared__ __align__(16) int4 bsrc[2][2 * kSubs];
  __shared__ int list[kPass];
  __shared__ int wcount[kBrick / 32];

  const int t = order[blockIdx.x];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i = static_cast<long long>(t) * kBrick + tid;
  const float4 me = body_row(body[i]);
  const int4 mc = cell[i];
  // this warp's sub-brick box: box[2k] lo, box[2k + 1] hi
  const long long sub = static_cast<long long>(t) * kSubs + warp;
  const int4 tlo = box[2 * sub], thi = box[2 * sub + 1];
  float ax = 0.f, ay = 0.f, az = 0.f, phi = 0.f;   // this brick's sums
  double sx = 0.0, sy = 0.0, sz = 0.0, sphi = 0.0;  // the row's

  // stage source brick sb into buffer b: one body, one cell a thread,
  // threads 0-7 the four sub-brick boxes
  auto stage = [&](int sb, int b) {
    const long long j = static_cast<long long>(sb) * kBrick + tid;
    if constexpr (kB16)
      cp_async8(&raw[b][tid], body + j);
    else
      cp_async16(&src[b][tid], body + j);
    cp_async16(&csrc[b][tid], cell + j);
    if (tid < 2 * kSubs)
      cp_async16(&bsrc[b][tid],
                 box + static_cast<long long>(sb) * 2 * kSubs + tid);
    cp_async_commit();
  };

  const unsigned char* row = adj + static_cast<long long>(t) * nbrick;
  const long long budget = pmax - starts[t];  // pairs of this row kept
  long long done = 0;
  for (int s0 = 0; s0 < nbrick && done < budget; s0 += kPass) {
    // compact this pass's set entries into `list`, in column order
    const int c0 = s0 + tid * kPerThread;
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (c0 + k < nbrick && row[c0 + k] != 0) bits |= 1u << k;
    const int cnt = __popc(bits);
    int incl = cnt;  // inclusive warp scan
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) wcount[warp] = incl;
    __syncthreads();  // also: every thread is done with the last pass
    int before = incl - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < kBrick / 32; ++w) {
      before += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    for (; bits; bits &= bits - 1) list[before++] = c0 + __ffs(bits) - 1;
    __syncthreads();
    const int take = static_cast<int>(
        min(static_cast<long long>(total), budget - done));
    if (take > 0) stage(list[0], 0);
    for (int k = 0; k < take; ++k) {
      const int b = k & 1;
      cp_async_wait_all();  // this thread's copies of brick k landed
      __syncthreads();      // everyone's did; buffer b ^ 1 is free
      if (k + 1 < take) stage(list[k + 1], b ^ 1);
      const float4* brick = src[kB16 ? 0 : b];
      if constexpr (kB16) {
        // brick k's raw rows landed; the barrier above also ended every
        // read of the fp32 brick, which now takes them
        src[0][tid] = body_row(raw[b][tid]);
        __syncthreads();
      }
#pragma unroll 1
      for (int q = 0; q < kSubs; ++q) {
        const int4 slo = bsrc[b][2 * q], shi = bsrc[b][2 * q + 1];
        const bool far = slo.x > thi.x + 1 || tlo.x > shi.x + 1 ||
                         slo.y > thi.y + 1 || tlo.y > shi.y + 1 ||
                         slo.z > thi.z + 1 || tlo.z > shi.z + 1;
        if (far) continue;
        const bool all_near =
            max(shi.x - tlo.x, thi.x - slo.x) <= 1 &&
            max(shi.y - tlo.y, thi.y - slo.y) <= 1 &&
            max(shi.z - tlo.z, thi.z - slo.z) <= 1;
        const float4* s = brick + q * kSub;
        const int4* c = &csrc[b][q * kSub];
        if (all_near)
          sweep_sub<kPhi, false>(s, c, me, mc, soft2, ax, ay, az, phi);
        else
          sweep_sub<kPhi, true>(s, c, me, mc, soft2, ax, ay, az, phi);
      }
      sx += ax;
      sy += ay;
      sz += az;
      if (kPhi) sphi += phi;
      ax = ay = az = phi = 0.f;
    }
    done += total;
  }
  const long long n = static_cast<long long>(nbrick) * kBrick;
  out[i] = static_cast<float>(sx);
  out[n + i] = static_cast<float>(sy);
  out[2 * n + i] = static_cast<float>(sz);
  if (kPhi) out[3 * n + i] = static_cast<float>(sphi);
}

// K10's launch, the fp32 (Row float4) or the bf16 (uint2) instance.
template <class Row>
int p2p_launch(const void* body, const void* cell, const void* box,
               const int* order, int nbrick, const unsigned char* adj,
               const long long* starts, long long pmax, float soft2,
               int with_phi, float* out, cudaStream_t stream) {
  if (nbrick < 1 || pmax < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* b = static_cast<const Row*>(body);
  const auto* c = static_cast<const int4*>(cell);
  const auto* x = static_cast<const int4*>(box);
  if (with_phi)
    p2p_kernel<true, Row><<<nbrick, kBrick, 0, stream>>>(
        b, c, x, order, nbrick, adj, starts, pmax, soft2, out);
  else
    p2p_kernel<false, Row><<<nbrick, kBrick, 0, stream>>>(
        b, c, x, order, nbrick, adj, starts, pmax, soft2, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace murb

// K10.  body: (n, 4) {x, y, z, G m} and cell: (n, 4) {cx, cy, cz, 0} of the
// sorted bodies (n = nbrick * 128), 16-byte aligned; box: (n / 32, 2, 4)
// the cell bounding box {lo, hi} of every 32-body sub-brick; order:
// (nbrick,) a permutation of the target bricks, the launch order; adj:
// (nbrick, nbrick) bytes, nonzero for a candidate pair; starts: (nbrick,)
// pairs of the rows before each row; pmax: pairs kept; out: (nf, n) with
// nf = 4 when with_phi, else 3.
extern "C" int murb_p2p_sorted(const void* body, const void* cell,
                               const void* box, const int* order, int nbrick,
                               const unsigned char* adj,
                               const long long* starts, long long pmax,
                               float soft2, int with_phi, float* out,
                               cudaStream_t stream) {
  return murb::p2p_launch<float4>(body, cell, box, order, nbrick, adj,
                                  starts, pmax, soft2, with_phi, out, stream);
}

// The bf16 instance: body is (n, 4) bf16 {x, y, z, G m}, 8-byte aligned;
// every other argument murb_p2p_sorted's.
extern "C" int murb_p2p_sorted_bf16(const void* body, const void* cell,
                                    const void* box, const int* order,
                                    int nbrick, const unsigned char* adj,
                                    const long long* starts, long long pmax,
                                    float soft2, int with_phi, float* out,
                                    cudaStream_t stream) {
  return murb::p2p_launch<uint2>(body, cell, box, order, nbrick, adj, starts,
                                 pmax, soft2, with_phi, out, stream);
}
