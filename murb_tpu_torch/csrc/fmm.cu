// K7 (the M2L level sweep), K8 (grid P2M) and K9 (grid L2P): the kernels of
// the multi-level Chebyshev hierarchy (murb_tpu_torch/ops/fmm.py).
//
// Replace the TPU kernels murb_tpu/ops/fmm_pallas.py:_m2l_kernel (pallas_call
// at :240, entry m2l_level_fused :169), _p2m_grid_kernel (:355, entry
// p2m_grid_fused :338) and _l2p_grid_kernel (:406, entry l2p_grid_fused
// :382).  Everything computes in fp32 with fp32 fmas: the node fields
// oscillate in sign and cancel heavily, so no TF32 and no bf16 splits.
//
// Cells.  The finest level is a C^3 grid over the box (lo = c - h, cell
// sizes cs = 2h / C per dimension, the box stays anisotropic).  A body's
// cell is clip(floor((q - lo) / cs), 0, C - 1) per dimension and its in-cell
// coordinate t = 2 ((q - lo) / cs - cell) - 1, so a body on the top face
// gets t = 1.  The wrapper (ops/fmm_kernels.cell_order) computes each
// body's cell id, orders the bodies by cell (a stable sort of the ids: glue,
// not the contraction) and hands the kernels the permutation, the cell
// bounds (C^3 + 1 offsets into it) and, per kernel, a prefix of work items
// per cell.  The kernels take each body's cell from that table, never from
// a second floor, so the sort and the bases cannot disagree.
//
// K8, P2M: W[c, (u, v, w)] = sum_{j in c} gm_j Sx_j[u] Sy_j[v] Sz_j[w].
// The TPU kernel factored the one-hot cell into an extended basis of width
// C m and did (C m)^3 MXU work per body; here each work item is a run of at
// most kGridP2MChunk bodies of one cell, and a block runs K1's scheme on it:
// a thread owns one (u, v) pair and the m outputs along w in registers, the
// bases of 64 bodies at a time sit in shared memory.  Each item writes its
// own partial W; a second kernel adds a cell's partials in item order.  No
// atomics, the same bits every run.  Work is N m^3 fmas (2e8 flop at the
// main path); memory traffic is O(N) plus the partials.
//
// K9, L2P: a_f[i] = sum_{uvw} Sx_i[u] Sy_i[v] Sz_i[w] F_f[c_i, (u, v, w)]
// for k <= 4 fields a launch (murb_l2p_grid runs groups of 4, 3 + G <= 11
// fields).  A work item is up to kGridL2PThreads bodies of one cell, one
// thread per body; the block stages one u-slice of that cell's k fields in
// shared memory at a time (K2's scheme) and every thread reads it as a
// broadcast.  Results go back through the permutation.  Work is N m^3 k
// fmas.
//
// K7, M2L: for a target cell c and a signed offset o of the subset, the
// source cell is c + o; it is skipped when it falls outside the grid and,
// for "expand" and "far", when the target-parity mask excludes it (|o_d| = 3
// needs an even target index for +3, an odd one for -3).  The contribution
//     f_i[c, u] += sum_v T_i(o)[u, v] w[c + o, v],
//     T_d = D_d (D.D + eps^2)^-3/2, T_phi = (D.D + eps^2)^-1/2,
//     D = 2 h_l o + p_v - p_u
// is an exact softened sweep between the m^3 target nodes and the m^3
// source nodes shifted by 2 h_l o, so a block runs the sweep kernels'
// scheme (sweep.cuh): one thread owns one target node u and its nf
// accumulators, the block stages {2 h_l o + p_v, w_v} through shared memory
// and every thread reads each staged source as a broadcast.  T is rebuilt
// for every (target cell, offset) pair: one rsqrt and about 12 flops per
// (u, v), about 3x the apply, in exchange for no (m^3, m^3) matrix in
// memory and no shifted weight copies.  Only the (target, source) pairs
// the subset admits are visited: at C = 4 the expand list admits 4,096 of
// the 21,952 pairs the TPU's dense grid multiplies.  A block owns a tile of
// target nodes of one cell and walks a contiguous share of the offsets;
// where C^3 m^3 threads cannot fill the card the offsets are split over
// `nsplit` blocks, each writes its own partial fields, and a second kernel
// adds the splits in order: no two blocks write the same output, no
// atomics.  Bound: fp32 issue and the MUFU rsqrt, 1.07e9 pairs at the main
// path (C = 4, m = 8).
#include <cuda_runtime.h>

#include "cheb.cuh"

namespace murb {

constexpr int kGridMaxOrder = 16;
constexpr int kGridMaxCells = 16;       // C, cells per dimension
constexpr int kGridP2MChunk = 512;      // bodies per K8 work item
constexpr int kGridP2MTile = 64;        // bodies whose bases sit in shared
constexpr int kGridP2MMaxThreads = 256;
constexpr int kGridL2PThreads = 128;    // bodies per K9 work item
constexpr int kGridFields = 4;          // fields one K9 launch takes
constexpr int kGridMaxTotalFields = 11;
constexpr int kM2LThreads = 128;        // target nodes per K7 block
constexpr int kM2LTile = 256;           // source nodes staged at a time
constexpr int kM2LMaxSplit = 64;

// The cell holding work item b: prefix[c] <= b < prefix[c + 1] (prefix has
// ncell + 1 entries, prefix[0] = 0, empty cells repeat a value).  -1 past
// the last item.
__device__ __forceinline__ int item_cell(const long long* prefix, int ncell,
                                         long long b) {
  if (b >= prefix[ncell]) return -1;
  int lo = 0, hi = ncell;  // prefix[lo] <= b < prefix[hi]
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

// ------------------------------------------------------------------ K8
template <int MW>
__global__ void __launch_bounds__(kGridP2MMaxThreads)
p2m_grid_partial_kernel(const float* __restrict__ qx,
                        const float* __restrict__ qy,
                        const float* __restrict__ qz,
                        const float* __restrict__ gm,
                        const long long* __restrict__ perm,
                        const float* __restrict__ box, int m, int C,
                        const long long* __restrict__ bounds,
                        const long long* __restrict__ prefix,
                        float* __restrict__ partial) {
  __shared__ float table[kGridMaxOrder * (kGridMaxOrder - 1)];
  __shared__ float gsx[kGridP2MTile * kGridMaxOrder];
  __shared__ float sy[kGridP2MTile * kGridMaxOrder];
  __shared__ __align__(16) float sz[kGridP2MTile * MW];

  const int ncell = C * C * C;
  const int cell = item_cell(prefix, ncell, blockIdx.x);
  if (cell < 0) return;  // the whole block: no barrier is skipped
  fill_node_table(table, m);
  const int ix = cell / (C * C), iy = (cell / C) % C, iz = cell % C;
  const float lox = box[0], loy = box[1], loz = box[2];
  const float csx = box[3], csy = box[4], csz = box[5];
  const long long j0 = bounds[cell] +
      (blockIdx.x - prefix[cell]) * static_cast<long long>(kGridP2MChunk);
  const long long j1 = min(j0 + kGridP2MChunk, bounds[cell + 1]);

  const int p2 = m * m;
  const int uv = threadIdx.x;
  const bool active = uv < p2;
  const int u = active ? uv / m : 0;
  const int v = active ? uv % m : 0;
  float acc[MW];
#pragma unroll
  for (int w = 0; w < MW; ++w) acc[w] = 0.f;

  for (long long j = j0; j < j1; j += kGridP2MTile) {
    __syncthreads();  // the node table is ready; the last tile is consumed
    const int b = threadIdx.x;
    if (b < kGridP2MTile) {
      const bool real = j + b < j1;
      const long long body = real ? perm[j + b] : 0;
      const float g = real ? gm[body] : 0.f;
      const float tx = real ? cell_t(qx[body], lox, csx, ix) : 0.f;
      const float ty = real ? cell_t(qy[body], loy, csy, iy) : 0.f;
      const float tz = real ? cell_t(qz[body], loz, csz, iz) : 0.f;
      for (int k = 0; k < m; ++k) {
        const float* row = table + k * (m - 1);
        gsx[b * kGridMaxOrder + k] = g * basis_value(tx, row, m);
        sy[b * kGridMaxOrder + k] = basis_value(ty, row, m);
      }
#pragma unroll
      for (int k = 0; k < MW; ++k)
        sz[b * MW + k] = k < m ? basis_value(tz, table + k * (m - 1), m)
                               : 0.f;
    }
    __syncthreads();
    if (active) {
      const int nb = static_cast<int>(min(static_cast<long long>(
          kGridP2MTile), j1 - j));
      for (int bb = 0; bb < nb; ++bb) {
        const float t = gsx[bb * kGridMaxOrder + u] *
                        sy[bb * kGridMaxOrder + v];
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
    float* out = partial + static_cast<long long>(blockIdx.x) * p2 * m;
#pragma unroll
    for (int w = 0; w < MW; ++w)
      if (w < m) out[u * p2 + v * m + w] = acc[w];
  }
}

// W[c, p] = sum of the partials of c's work items, in item order; cells
// without bodies get 0.
__global__ void p2m_grid_reduce_kernel(const float* __restrict__ partial,
                                       const long long* __restrict__ prefix,
                                       int ncell, int p3,
                                       float* __restrict__ w) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(ncell) * p3) return;
  const int cell = static_cast<int>(idx / p3);
  const int p = static_cast<int>(idx % p3);
  float s = 0.f;
  for (long long b = prefix[cell]; b < prefix[cell + 1]; ++b)
    s += partial[b * p3 + p];
  w[idx] = s;
}

// ------------------------------------------------------------------ K9
template <int MW>
__global__ void __launch_bounds__(kGridL2PThreads)
l2p_grid_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                const float* __restrict__ qz,
                const long long* __restrict__ perm,
                const float* __restrict__ box, int m, int C,
                const long long* __restrict__ bounds,
                const long long* __restrict__ prefix,
                const float* __restrict__ fields, int k, int n,
                float* __restrict__ out) {
  __shared__ float table[kGridMaxOrder * (kGridMaxOrder - 1)];
  __shared__ __align__(16) float slice[kGridFields * MW * MW];

  const int ncell = C * C * C;
  const int cell = item_cell(prefix, ncell, blockIdx.x);
  if (cell < 0) return;  // the whole block
  fill_node_table(table, m);
  __syncthreads();
  const int ix = cell / (C * C), iy = (cell / C) % C, iz = cell % C;
  const long long j = bounds[cell] +
      (blockIdx.x - prefix[cell]) * static_cast<long long>(kGridL2PThreads) +
      threadIdx.x;
  const bool own = j < bounds[cell + 1];
  const long long body = own ? perm[j] : 0;
  const float tx = own ? cell_t(qx[body], box[0], box[3], ix) : 0.f;
  const float ty = own ? cell_t(qy[body], box[1], box[4], iy) : 0.f;
  const float tz = own ? cell_t(qz[body], box[2], box[5], iz) : 0.f;
  float sy[MW], sz[MW];
#pragma unroll
  for (int c = 0; c < MW; ++c) {
    sy[c] = c < m ? basis_value(ty, table + c * (m - 1), m) : 0.f;
    sz[c] = c < m ? basis_value(tz, table + c * (m - 1), m) : 0.f;
  }
  const int p2 = m * m;
  const long long p3 = static_cast<long long>(p2) * m;
  const float* fc = fields + static_cast<long long>(cell) * p3;
  const long long fstride = static_cast<long long>(ncell) * p3;
  float acc[kGridFields] = {0.f, 0.f, 0.f, 0.f};

  for (int u = 0; u < m; ++u) {
    __syncthreads();  // the previous slice is consumed
    for (int idx = threadIdx.x; idx < kGridFields * MW * MW;
         idx += kGridL2PThreads) {
      const int f = idx / (MW * MW);
      const int r = idx % (MW * MW);
      const int v = r / MW, w = r % MW;
      slice[idx] = (f < k && v < m && w < m)
          ? fc[f * fstride + u * p2 + v * m + w]
          : 0.f;
    }
    __syncthreads();
    const float su = basis_value(tx, table + u * (m - 1), m);
#pragma unroll
    for (int f = 0; f < kGridFields; ++f) {
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
    for (int f = 0; f < kGridFields; ++f)
      if (f < k) out[static_cast<long long>(f) * n + body] = acc[f];
  }
}

// ------------------------------------------------------------------ K7
// Target-parity validity of one offset component (the expand list's
// |o_d| = 3 entries have near parents only from one parity of target).
__device__ __forceinline__ bool parity_ok(int o, int i) {
  return o == 3 ? (i & 1) == 0 : (o == -3 ? (i & 1) == 1 : true);
}

template <bool kPhi>
__global__ void __launch_bounds__(kM2LThreads)
m2l_kernel(const float* __restrict__ w, const float* __restrict__ hl,
           float soft2, int m, int C, int reach, int min_inf, int parity,
           int nsplit, float* __restrict__ out) {
  __shared__ float nodes[kGridMaxOrder];
  __shared__ float4 src[kM2LTile];

  const int m2 = m * m, m3 = m2 * m, ncell = C * C * C;
  const int utiles = (m3 + kM2LThreads - 1) / kM2LThreads;
  const int ut = blockIdx.x % utiles;
  const int cell = (blockIdx.x / utiles) % ncell;
  const int split = blockIdx.x / (utiles * ncell);
  if (threadIdx.x < m)
    nodes[threadIdx.x] =
        static_cast<float>(cos(kPi * (threadIdx.x + 0.5) / m));
  __syncthreads();

  const int ix = cell / (C * C), iy = (cell / C) % C, iz = cell % C;
  const float hx = hl[0], hy = hl[1], hz = hl[2];
  const int u = ut * kM2LThreads + threadIdx.x;
  const bool own = u < m3;
  const int uu = own ? u : 0;
  const float pux = hx * nodes[uu / m2];
  const float puy = hy * nodes[(uu / m) % m];
  const float puz = hz * nodes[uu % m];
  float ax = 0.f, ay = 0.f, az = 0.f, phi = 0.f;

  const int side = 2 * reach + 1;
  const int K = side * side * side;
  const int k0 = split * K / nsplit, k1 = (split + 1) * K / nsplit;
  for (int k = k0; k < k1; ++k) {  // every condition below is block-uniform
    const int ox = k / (side * side) - reach;
    const int oy = (k / side) % side - reach;
    const int oz = k % side - reach;
    if (max(abs(ox), max(abs(oy), abs(oz))) < min_inf) continue;
    const int sx = ix + ox, sy = iy + oy, sz = iz + oz;
    if (sx < 0 || sx >= C || sy < 0 || sy >= C || sz < 0 || sz >= C) continue;
    if (parity && !(parity_ok(ox, ix) && parity_ok(oy, iy) &&
                    parity_ok(oz, iz)))
      continue;
    const float* ws = w + static_cast<long long>((sx * C + sy) * C + sz) * m3;
    const float shx = 2.f * hx * static_cast<float>(ox);
    const float shy = 2.f * hy * static_cast<float>(oy);
    const float shz = 2.f * hz * static_cast<float>(oz);
    for (int v0 = 0; v0 < m3; v0 += kM2LTile) {
      const int nv = min(kM2LTile, m3 - v0);
      __syncthreads();  // the previous tile is consumed
      for (int idx = threadIdx.x; idx < nv; idx += kM2LThreads) {
        const int v = v0 + idx;
        src[idx] = make_float4(shx + hx * nodes[v / m2],
                               shy + hy * nodes[(v / m) % m],
                               shz + hz * nodes[v % m], ws[v]);
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < nv; ++jj) {
        const float4 s = src[jj];
        const float dx = s.x - pux, dy = s.y - puy, dz = s.z - puz;
        const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft2)));
        const float inv = rsqrtf(r2);
        if (kPhi) phi = fmaf(s.w, inv, phi);
        const float wi3 = s.w * (inv * inv * inv);
        ax = fmaf(wi3, dx, ax);
        ay = fmaf(wi3, dy, ay);
        az = fmaf(wi3, dz, az);
      }
    }
  }
  if (own) {
    const long long plane = static_cast<long long>(ncell) * m3;
    float* o = out + static_cast<long long>(split) * (kPhi ? 4 : 3) * plane +
               static_cast<long long>(cell) * m3 + u;
    o[0] = ax;
    o[plane] = ay;
    o[2 * plane] = az;
    if (kPhi) o[3 * plane] = phi;
  }
}

// out[i] = sum over s of partial[s * count + i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  int nsplit, long long count,
                                  float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += partial[sp * count + i];
  out[i] = s;
}

template <int MW>
void launch_p2m_grid(const float* qx, const float* qy, const float* qz,
                     const float* gm, const long long* perm, const float* box,
                     int m, int C, const long long* bounds,
                     const long long* prefix, int nitems, float* partial,
                     cudaStream_t stream) {
  int threads = (m * m + 31) / 32 * 32;
  threads = threads < kGridP2MTile ? kGridP2MTile : threads;
  p2m_grid_partial_kernel<MW><<<nitems, threads, 0, stream>>>(
      qx, qy, qz, gm, perm, box, m, C, bounds, prefix, partial);
}

template <int MW>
void launch_l2p_grid(const float* qx, const float* qy, const float* qz,
                     const long long* perm, const float* box, int m, int C,
                     const long long* bounds, const long long* prefix,
                     int nitems, const float* fields, int k, int n,
                     float* out, cudaStream_t stream) {
  l2p_grid_kernel<MW><<<nitems, kGridL2PThreads, 0, stream>>>(
      qx, qy, qz, perm, box, m, C, bounds, prefix, fields, k, n, out);
}

inline bool grid_ok(int m, int C) {
  return m >= 2 && m <= kGridMaxOrder && C >= 1 && C <= kGridMaxCells;
}

}  // namespace murb

#define MURB_DISPATCH_GRID_MW(m, CALL)                  \
  switch ((m + 3) / 4 * 4) {                            \
    case 4: CALL(4); break;                             \
    case 8: CALL(8); break;                             \
    case 12: CALL(12); break;                           \
    case 16: CALL(16); break;                           \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// K8.  box: [lo(3), cs(3)]; perm: the bodies ordered by cell; bounds: C^3 +
// 1 offsets into perm; prefix: C^3 + 1 offsets of each cell's work items of
// kGridP2MChunk bodies; nitems: the grid (at least prefix[C^3]; blocks past
// it return); partial: nitems * m^3 floats of scratch; w: (C^3, m^3).
extern "C" int murb_p2m_grid(const float* qx, const float* qy,
                             const float* qz, const float* gm,
                             const long long* perm, const float* box, int m,
                             int C, const long long* bounds,
                             const long long* prefix, int nitems,
                             float* partial, float* w, cudaStream_t stream) {
  if (!murb::grid_ok(m, C) || nitems < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define MURB_P2M_GRID(MW)                                                  \
  murb::launch_p2m_grid<MW>(qx, qy, qz, gm, perm, box, m, C, bounds, prefix, \
                            nitems, partial, stream)
  MURB_DISPATCH_GRID_MW(m, MURB_P2M_GRID)
#undef MURB_P2M_GRID
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ncell = C * C * C, p3 = m * m * m;
  const long long total = static_cast<long long>(ncell) * p3;
  murb::p2m_grid_reduce_kernel<<<static_cast<int>((total + 255) / 256), 256,
                                 0, stream>>>(partial, prefix, ncell, p3, w);
  return static_cast<int>(cudaGetLastError());
}

// K9.  fields: (k, C^3, m^3); out: (k, n) in the bodies' own order; prefix:
// work items of kGridL2PThreads bodies.  One launch per group of at most
// kGridFields fields.
extern "C" int murb_l2p_grid(const float* qx, const float* qy,
                             const float* qz, const long long* perm, int n,
                             const float* box, int m, int C,
                             const long long* bounds, const long long* prefix,
                             int nitems, const float* fields, int k,
                             float* out, cudaStream_t stream) {
  if (!murb::grid_ok(m, C) || k < 1 || k > murb::kGridMaxTotalFields ||
      nitems < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const long long plane = static_cast<long long>(C) * C * C * m * m * m;
  for (int f0 = 0; f0 < k; f0 += murb::kGridFields) {
    const int kg = k - f0 < murb::kGridFields ? k - f0 : murb::kGridFields;
    const float* fg = fields + f0 * plane;
    float* og = out + static_cast<long long>(f0) * n;
#define MURB_L2P_GRID(MW)                                                    \
  murb::launch_l2p_grid<MW>(qx, qy, qz, perm, box, m, C, bounds, prefix,     \
                            nitems, fg, kg, n, og, stream)
    MURB_DISPATCH_GRID_MW(m, MURB_L2P_GRID)
#undef MURB_L2P_GRID
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// K7.  w: (C^3, m^3) level expansions; hl: the level's cell half-widths (3,)
// in device memory; subset: 0 expand (|o| <= 3, parity), 1 near (|o| <= 1),
// 2 far (2 <= |o| <= 3, parity); nf: 3 (force) or 4 (force and potential);
// out: (nf, C^3, m^3); partial: nsplit * nf * C^3 * m^3 floats of scratch
// when nsplit > 1 (unused, may be null, when nsplit == 1).
extern "C" int murb_m2l_level(const float* w, const float* hl, float soft2,
                              int m, int C, int subset, int nf, int nsplit,
                              float* partial, float* out,
                              cudaStream_t stream) {
  if (!murb::grid_ok(m, C) || subset < 0 || subset > 2 ||
      (nf != 3 && nf != 4) || nsplit < 1 || nsplit > murb::kM2LMaxSplit ||
      (nsplit > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int reach = subset == 1 ? 1 : 3;
  const int min_inf = subset == 2 ? 2 : 0;
  const int parity = subset == 1 ? 0 : 1;
  const int m3 = m * m * m, ncell = C * C * C;
  const int utiles = (m3 + murb::kM2LThreads - 1) / murb::kM2LThreads;
  const int blocks = utiles * ncell * nsplit;
  float* dst = nsplit > 1 ? partial : out;
  if (nf == 4)
    murb::m2l_kernel<true><<<blocks, murb::kM2LThreads, 0, stream>>>(
        w, hl, soft2, m, C, reach, min_inf, parity, nsplit, dst);
  else
    murb::m2l_kernel<false><<<blocks, murb::kM2LThreads, 0, stream>>>(
        w, hl, soft2, m, C, reach, min_inf, parity, nsplit, dst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(nf) * ncell * m3;
  murb::sum_splits_kernel<<<static_cast<int>((count + 255) / 256), 256, 0,
                            stream>>>(partial, nsplit, count, out);
  return static_cast<int>(cudaGetLastError());
}
