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
// K8, P2M: W[c, (u, v, w)] = sum_{j in c} gm_j Sx_j[u] Sy_j[v] Sz_j[w],
// and K9, L2P: a_f[i] = sum_{uvw} Sx_i[u] Sy_i[v] Sz_i[w] F_f[c_i, (u, v, w)]
// for k <= 4 fields a launch (murb_l2p_grid runs groups of 4, 3 + G <= 11
// fields).  Both are the run kernels of cell_runs.cuh over the cells of the
// grid (CellRuns: bodies through the permutation, the run's cell for every
// body).  The TPU kernel factored the one-hot cell into an extended basis
// of width C m and did (C m)^3 MXU work per body; here a work item is a run
// of one cell's bodies.  Work is N m^3 fmas for K8 (2e8 flop at the main
// path), N m^3 k for K9; memory traffic is O(N) plus the partials.
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

#include "cell_runs.cuh"

namespace murb {

constexpr int kGridMaxOrder = kRunMaxOrder;
constexpr int kGridMaxCells = 16;       // C, cells per dimension
constexpr int kGridMaxTotalFields = 11;
constexpr int kM2LThreads = 128;        // target nodes per K7 block
constexpr int kM2LTile = 256;           // source nodes staged at a time
constexpr int kM2LMaxSplit = 64;

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

inline bool grid_ok(int m, int C) {
  return m >= 2 && m <= kGridMaxOrder && C >= 1 && C <= kGridMaxCells;
}

}  // namespace murb

// K8.  box: [lo(3), cs(3)]; perm: the bodies ordered by cell; bounds: C^3 +
// 1 offsets into perm; prefix: C^3 + 1 offsets of each cell's work items of
// kRunP2MChunk bodies; nitems: the grid (at least prefix[C^3]; blocks past
// it return); partial: nitems * m^3 floats of scratch; w: (C^3, m^3).
extern "C" int murb_p2m_grid(const float* qx, const float* qy,
                             const float* qz, const float* gm,
                             const long long* perm, const float* box, int m,
                             int C, const long long* bounds,
                             const long long* prefix, int nitems,
                             float* partial, float* w, cudaStream_t stream) {
  if (!murb::grid_ok(m, C)) return static_cast<int>(cudaErrorInvalidValue);
  return murb::p2m_runs(qx, qy, qz, gm, murb::CellRuns{perm, C}, box, m,
                        C * C * C, bounds, prefix, nitems, partial, w,
                        stream);
}

// K9.  fields: (k, C^3, m^3); out: (k, n) in the bodies' own order; prefix:
// work items of kRunL2PThreads bodies.  One launch per group of at most
// kRunFields fields.
extern "C" int murb_l2p_grid(const float* qx, const float* qy,
                             const float* qz, const long long* perm, int n,
                             const float* box, int m, int C,
                             const long long* bounds, const long long* prefix,
                             int nitems, const float* fields, int k,
                             float* out, cudaStream_t stream) {
  if (!murb::grid_ok(m, C) || k < 1 || k > murb::kGridMaxTotalFields)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ncell = C * C * C;
  const long long plane = static_cast<long long>(ncell) * m * m * m;
  for (int f0 = 0; f0 < k; f0 += murb::kRunFields) {
    const int kg = k - f0 < murb::kRunFields ? k - f0 : murb::kRunFields;
    const int err = murb::l2p_runs(
        qx, qy, qz, murb::CellRuns{perm, C}, n, box, m, ncell, bounds,
        prefix, nitems, fields + f0 * plane, kg,
        out + static_cast<long long>(f0) * n, stream);
    if (err != 0) return err;
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
