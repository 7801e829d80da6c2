// The anterpolation kernels that read their bodies as runs of one cell:
// the grid P2M and L2P of the dense hierarchy (fmm.cu: K8, K9) and the
// windowed P2M and L2P of the adaptive one (anterp.cu: K11, K12).  Both
// pairs compute the same functions over a list of runs; they differ only
// in where a run's bodies live and how a body's cell is found, which a
// `Runs` accessor supplies:
//
//   CellRuns  run = a cell of the C^3 grid, bodies read through the
//             permutation that orders them by cell; every body of the run
//             lies in the run's cell (K8, K9);
//   SlotRuns  run = an occupied slot, bodies read in place (they arrive
//             Morton-sorted), each with its own finest-level cell
//             coordinates from the computation that made the sort key
//             (K11, K12).
//
// The run bounds (nrun + 1 offsets) and a prefix of work items per run come
// from the wrapper.  A body's cell comes from the accessor, never from a
// second floor here, so the sort and the bases cannot disagree.
//
// P2M: W[r, (u, v, w)] = sum_{j in r} gm_j Sx_j[u] Sy_j[v] Sz_j[w].  A work
// item is a run of at most kRunP2MChunk bodies of one run, and a block runs
// K1's scheme on it: a thread owns one (u, v) pair and the m outputs along
// w in registers, the bases of 64 bodies at a time sit in shared memory.
// Above m = 16 (m^2 > 256 pairs) the block makes one pass over its bodies
// per 256 (u, v) pairs.  Each item writes its own partial W; a second
// kernel adds a run's partials in item order.  No atomics, the same bits
// every run.  Work is N m^3 fmas.
//
// L2P: a_f[j] = sum_{uvw} Sx_j[u] Sy_j[v] Sz_j[w] F_f[r_j, (u, v, w)] for
// k <= kRunFields fields a launch.  A work item is up to kRunL2PThreads
// bodies of one run, one thread per body; the block stages one u-slice of
// the run's k fields in shared memory at a time (K2's scheme: 16 KB at
// m = 32) and every thread reads it as a broadcast.  Bodies in no work item
// keep the caller's output.  Work is N m^3 k fmas.
#pragma once

#include <cuda_runtime.h>

#include "cheb.cuh"

namespace murb {

constexpr int kRunMaxOrder = 32;
constexpr int kRunP2MChunk = 512;      // bodies per P2M work item
constexpr int kRunP2MTile = 64;        // bodies whose bases sit in shared
constexpr int kRunP2MMaxThreads = 256;
constexpr int kRunL2PThreads = 128;    // bodies per L2P work item
constexpr int kRunFields = 4;          // fields one L2P launch takes

// The run holding work item b: prefix[r] <= b < prefix[r + 1] (prefix has
// nrun + 1 entries, prefix[0] = 0, empty runs repeat a value).  -1 past the
// last item.
__device__ __forceinline__ int item_run(const long long* prefix, int nrun,
                                        long long b) {
  if (b >= prefix[nrun]) return -1;
  int lo = 0, hi = nrun;  // prefix[lo] <= b < prefix[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] <= b) lo = mid; else hi = mid;
  }
  return lo;
}

// In-cell Chebyshev coordinate of q in the cell with index `cell` along one
// dimension, clipped to [-1, 1] as the basis requires.
__device__ __forceinline__ float cell_t(float q, float lo, float cs,
                                        int cell) {
  return clip_unit(2.f * ((q - lo) / cs - static_cast<float>(cell)) - 1.f);
}

struct CellRuns {
  const long long* perm;
  int C;
  __device__ long long body(long long j) const { return perm[j]; }
  __device__ int3 cell(int run, long long) const {
    return make_int3(run / (C * C), (run / C) % C, run % C);
  }
};

struct SlotRuns {
  const int* cx;
  const int* cy;
  const int* cz;
  __device__ long long body(long long j) const { return j; }
  __device__ int3 cell(int, long long body) const {
    return make_int3(cx[body], cy[body], cz[body]);
  }
};

template <int MW, class Runs>
__global__ void __launch_bounds__(kRunP2MMaxThreads)
p2m_runs_partial_kernel(const float* __restrict__ qx,
                        const float* __restrict__ qy,
                        const float* __restrict__ qz,
                        const float* __restrict__ gm, Runs runs,
                        const float* __restrict__ box, int m, int nrun,
                        const long long* __restrict__ bounds,
                        const long long* __restrict__ prefix,
                        float* __restrict__ partial) {
  __shared__ float table[MW * (MW - 1)];
  __shared__ float gsx[kRunP2MTile * MW];
  __shared__ float sy[kRunP2MTile * MW];
  __shared__ __align__(16) float sz[kRunP2MTile * MW];

  const int run = item_run(prefix, nrun, blockIdx.x);
  if (run < 0) return;  // the whole block: no barrier is skipped
  fill_node_table(table, m);
  const float lox = box[0], loy = box[1], loz = box[2];
  const float csx = box[3], csy = box[4], csz = box[5];
  const long long j0 = bounds[run] +
      (blockIdx.x - prefix[run]) * static_cast<long long>(kRunP2MChunk);
  const long long j1 = min(j0 + kRunP2MChunk, bounds[run + 1]);
  const int p2 = m * m;
  float* out = partial + static_cast<long long>(blockIdx.x) * p2 * m;

  // one pass over the item per blockDim.x (u, v) pairs: one pass up to
  // m = 16, four at m = 32
  for (int uv0 = 0; uv0 < p2; uv0 += blockDim.x) {
    const int uv = uv0 + threadIdx.x;
    const bool active = uv < p2;
    const int u = active ? uv / m : 0;
    const int v = active ? uv % m : 0;
    float acc[MW];
#pragma unroll
    for (int w = 0; w < MW; ++w) acc[w] = 0.f;

    for (long long j = j0; j < j1; j += kRunP2MTile) {
      __syncthreads();  // the node table is ready; the last tile is consumed
      const int b = threadIdx.x;
      if (b < kRunP2MTile) {
        const bool real = j + b < j1;
        const long long body = real ? runs.body(j + b) : 0;
        const int3 ci = real ? runs.cell(run, body) : make_int3(0, 0, 0);
        const float g = real ? gm[body] : 0.f;
        const float tx = real ? cell_t(qx[body], lox, csx, ci.x) : 0.f;
        const float ty = real ? cell_t(qy[body], loy, csy, ci.y) : 0.f;
        const float tz = real ? cell_t(qz[body], loz, csz, ci.z) : 0.f;
        for (int k = 0; k < m; ++k) {
          const float* row = table + k * (m - 1);
          gsx[b * MW + k] = g * basis_value(tx, row, m);
          sy[b * MW + k] = basis_value(ty, row, m);
        }
#pragma unroll
        for (int k = 0; k < MW; ++k)
          sz[b * MW + k] = k < m ? basis_value(tz, table + k * (m - 1), m)
                                 : 0.f;
      }
      __syncthreads();
      if (active) {
        const int nb = static_cast<int>(min(static_cast<long long>(
            kRunP2MTile), j1 - j));
        for (int bb = 0; bb < nb; ++bb) {
          const float t = gsx[bb * MW + u] * sy[bb * MW + v];
          const float4* zr = reinterpret_cast<const float4*>(sz + bb * MW);
#pragma unroll
          for (int w4 = 0; w4 < MW / 4; ++w4) {
            const float4 z = zr[w4];
            acc[4 * w4 + 0] = fmaf(t, z.x, acc[4 * w4 + 0]);
            acc[4 * w4 + 1] = fmaf(t, z.y, acc[4 * w4 + 1]);
            acc[4 * w4 + 2] = fmaf(t, z.z, acc[4 * w4 + 2]);
            acc[4 * w4 + 3] = fmaf(t, z.w, acc[4 * w4 + 3]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int w = 0; w < MW; ++w)
        if (w < m) out[u * p2 + v * m + w] = acc[w];
    }
  }
}

// W[r, p] = sum of the partials of run r's work items, in item order; runs
// without bodies get 0.  Internal linkage: fmm.cu and anterp.cu each keep
// their own copy.
namespace {
__global__ void p2m_runs_reduce_kernel(const float* __restrict__ partial,
                                       const long long* __restrict__ prefix,
                                       int nrun, int p3,
                                       float* __restrict__ w) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(nrun) * p3) return;
  const int run = static_cast<int>(idx / p3);
  const int p = static_cast<int>(idx % p3);
  float s = 0.f;
  for (long long b = prefix[run]; b < prefix[run + 1]; ++b)
    s += partial[b * p3 + p];
  w[idx] = s;
}
}  // namespace

template <int MW, class Runs>
__global__ void __launch_bounds__(kRunL2PThreads)
l2p_runs_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                const float* __restrict__ qz, Runs runs,
                const float* __restrict__ box, int m, int nrun,
                const long long* __restrict__ bounds,
                const long long* __restrict__ prefix,
                const float* __restrict__ fields, int k, int n,
                float* __restrict__ out) {
  __shared__ float table[MW * (MW - 1)];
  __shared__ __align__(16) float slice[kRunFields * MW * MW];

  const int run = item_run(prefix, nrun, blockIdx.x);
  if (run < 0) return;  // the whole block
  fill_node_table(table, m);
  __syncthreads();
  const long long j = bounds[run] +
      (blockIdx.x - prefix[run]) * static_cast<long long>(kRunL2PThreads) +
      threadIdx.x;
  const bool own = j < bounds[run + 1];
  const long long body = own ? runs.body(j) : 0;
  const int3 ci = own ? runs.cell(run, body) : make_int3(0, 0, 0);
  const float tx = own ? cell_t(qx[body], box[0], box[3], ci.x) : 0.f;
  const float ty = own ? cell_t(qy[body], box[1], box[4], ci.y) : 0.f;
  const float tz = own ? cell_t(qz[body], box[2], box[5], ci.z) : 0.f;
  float sy[MW], sz[MW];
#pragma unroll
  for (int c = 0; c < MW; ++c) {
    sy[c] = c < m ? basis_value(ty, table + c * (m - 1), m) : 0.f;
    sz[c] = c < m ? basis_value(tz, table + c * (m - 1), m) : 0.f;
  }
  const int p2 = m * m;
  const long long p3 = static_cast<long long>(p2) * m;
  const float* fr = fields + static_cast<long long>(run) * p3;
  const long long fstride = static_cast<long long>(nrun) * p3;
  float acc[kRunFields] = {0.f, 0.f, 0.f, 0.f};

  for (int u = 0; u < m; ++u) {
    __syncthreads();  // the previous slice is consumed
    for (int idx = threadIdx.x; idx < kRunFields * MW * MW;
         idx += kRunL2PThreads) {
      const int f = idx / (MW * MW);
      const int r = idx % (MW * MW);
      const int v = r / MW, w = r % MW;
      slice[idx] = (f < k && v < m && w < m)
          ? fr[f * fstride + u * p2 + v * m + w]
          : 0.f;
    }
    __syncthreads();
    const float su = basis_value(tx, table + u * (m - 1), m);
#pragma unroll
    for (int f = 0; f < kRunFields; ++f) {
      if (f < k) {
        const float* ff = slice + f * MW * MW;
        float b = 0.f;
#pragma unroll
        for (int v = 0; v < MW; ++v) {
          const float4* row = reinterpret_cast<const float4*>(ff + v * MW);
          float t = 0.f;
#pragma unroll
          for (int w4 = 0; w4 < MW / 4; ++w4) {
            const float4 F = row[w4];
            t = fmaf(F.x, sz[4 * w4 + 0], t);
            t = fmaf(F.y, sz[4 * w4 + 1], t);
            t = fmaf(F.z, sz[4 * w4 + 2], t);
            t = fmaf(F.w, sz[4 * w4 + 3], t);
          }
          b = fmaf(sy[v], t, b);
        }
        acc[f] = fmaf(su, b, acc[f]);
      }
    }
  }
  if (own) {
#pragma unroll
    for (int f = 0; f < kRunFields; ++f)
      if (f < k) out[static_cast<long long>(f) * n + body] = acc[f];
  }
}

}  // namespace murb

// Runs the instantiation of CALL for the padded width of order m (a
// multiple of 4 up to kRunMaxOrder); returns cudaErrorInvalidValue from the
// enclosing function for any other m.
#define MURB_DISPATCH_MW(m, CALL)                       \
  switch ((m + 3) / 4 * 4) {                            \
    case 4: CALL(4); break;                             \
    case 8: CALL(8); break;                             \
    case 12: CALL(12); break;                           \
    case 16: CALL(16); break;                           \
    case 20: CALL(20); break;                           \
    case 24: CALL(24); break;                           \
    case 28: CALL(28); break;                           \
    case 32: CALL(32); break;                           \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

namespace murb {

// P2M over nrun runs: partial holds nitems * m^3 floats of scratch (nitems
// at least prefix[nrun]; blocks past it return), w is (nrun, m^3).
template <class Runs>
int p2m_runs(const float* qx, const float* qy, const float* qz,
             const float* gm, Runs runs, const float* box, int m, int nrun,
             const long long* bounds, const long long* prefix, int nitems,
             float* partial, float* w, cudaStream_t stream) {
  if (m < 2 || m > kRunMaxOrder || nrun < 1 || nitems < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // a thread per (u, v) pair, at most kRunP2MMaxThreads (the kernel loops
  // over the rest), at least one per body of a tile
  int threads = (m * m + 31) / 32 * 32;
  threads = threads > kRunP2MMaxThreads ? kRunP2MMaxThreads : threads;
  threads = threads < kRunP2MTile ? kRunP2MTile : threads;
#define MURB_P2M_RUNS(MW)                                                  \
  p2m_runs_partial_kernel<MW, Runs><<<nitems, threads, 0, stream>>>(       \
      qx, qy, qz, gm, runs, box, m, nrun, bounds, prefix, partial)
  MURB_DISPATCH_MW(m, MURB_P2M_RUNS)
#undef MURB_P2M_RUNS
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int p3 = m * m * m;
  const long long total = static_cast<long long>(nrun) * p3;
  p2m_runs_reduce_kernel<<<static_cast<int>((total + 255) / 256), 256, 0,
                           stream>>>(partial, prefix, nrun, p3, w);
  return static_cast<int>(cudaGetLastError());
}

// L2P of 1 to kRunFields fields (k, nrun, m^3) into out (k, n).
template <class Runs>
int l2p_runs(const float* qx, const float* qy, const float* qz, Runs runs,
             int n, const float* box, int m, int nrun,
             const long long* bounds, const long long* prefix, int nitems,
             const float* fields, int k, float* out, cudaStream_t stream) {
  if (m < 2 || m > kRunMaxOrder || nrun < 1 || nitems < 1 || k < 1 ||
      k > kRunFields)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
#define MURB_L2P_RUNS(MW)                                                  \
  l2p_runs_kernel<MW, Runs><<<nitems, kRunL2PThreads, 0, stream>>>(        \
      qx, qy, qz, runs, box, m, nrun, bounds, prefix, fields, k, n, out)
  MURB_DISPATCH_MW(m, MURB_L2P_RUNS)
#undef MURB_L2P_RUNS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace murb
