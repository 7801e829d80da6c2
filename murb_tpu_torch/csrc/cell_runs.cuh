// The anterpolation kernels that read their bodies as runs: the grid P2M
// and L2P of the dense hierarchy (fmm.cu: K8, K9), the windowed P2M and
// L2P of the adaptive one (anterp.cu: K11, K12) and the single-cell P2M of
// the proxy (proxy.cu: K1; its L2P, K2, is proxy.cu's own kernel, which
// takes basis_span and stage_table from here).
//
// Replace the TPU kernels murb_tpu/ops/fmm_pallas.py:_p2m_grid_kernel
// (K8, pallas_call :355) and _l2p_grid_kernel (K9, :406),
// murb_tpu/ops/anterp_pallas.py:_p2m_win_kernel (K11, :227) and
// _l2p_win_kernel (K12, :315), and murb_tpu/ops/proxy_pallas.py:_p2m_kernel
// (K1, :154).  They compute the same functions over a list of runs; they
// differ only in where a run's bodies live and how a body's Chebyshev
// coordinate t is found, which a `Runs` accessor supplies from the box the
// kernel reads:
//
//   CellRuns  run = a cell of the C^3 grid, bodies read through the
//             permutation that orders them by cell; every body of the run
//             lies in the run's cell (K8, K9); box [lo, cs], t = cell_t;
//   SlotRuns  run = an occupied slot, bodies read in place (they arrive
//             Morton-sorted), each with its own finest-level cell
//             coordinates from the computation that made the sort key
//             (K11, K12); box [lo, cs], t = cell_t;
//   OneRun    one run of all n bodies, read in place (K1); box [c, h],
//             t = clip((q - c) / h), murb_tpu's proxy coordinate.
//
// The wrapper hands the kernels the run bounds (nrun + 1 offsets), a prefix
// of work items per run and the node table T_j(t_k) of order m, built once
// per (m, device) in float64 on the host (ops/proxy_kernels.node_table): no
// block rebuilds it.  Each warp finds its item's run by a 32-way search of
// the prefix (warp_item_run).  A body's cell comes
// from the accessor, never from a second floor here, so the sort and the
// bases cannot disagree.  Everything is fp32 with fp32 fmas (the node fields
// cancel, fmm.cu's note), no atomics, every sum in a fixed order: the same
// bits on every run.
//
// P2M: W[r, (u, v, w)] = sum_{j in r} gm_j Sx_j[u] Sy_j[v] Sz_j[w], an
// (m^2 x nb) . (nb x m) product per run that reduces over its bodies.
// L2P: a_f[j] = sum_{uvw} Sx_j[u] Sy_j[v] Sz_j[w] F_f[r_j, (u, v, w)] for
// k <= kRunFields fields a launch.  Work is N m^3 fmas (P2M) and N m^3 k
// (L2P), plus 3 m^2 a body for the bases; bytes are O(N) and the fields
// once: the least time is the fp32 fma work at m >= 8 (67 TFLOP/s on the
// H100 SXM), device memory only at m = 6 on short runs.  At m = 18 and
// 32 both kernels reach 0.29 to 0.44 of it at the card's full clock,
// issuing about half their slots with 2 to 4 warps a scheduler; the
// stalls that hold them there are not measured.
//
// What the first design lost, and what this one does about it:
//   - each pass of a P2M block (one per 256 (u, v) pairs: four at m = 32)
//     rebuilt every body's bases, 64 of up to 256 threads computing them
//     each node's S_k by its own (m - 1)-step recurrence with one
//     shared-memory load a step, the rest waiting at the barrier.  Now a
//     body's 3m basis values
//     are computed once per work item, by all threads at once
//     (basis_span: T_j(t) once, then S_k for a span of nodes, the table
//     read 4 nodes a load), and one pass covers all m^3 outputs;
//   - P2M's product was not register-tiled (2 scalar loads and a multiply
//     a body for MW fmas).  Now a thread owns a TU x TV x TW tile of
//     (u, v, w) (P2MGeom: 2 x 4 x 8 at m = 32), so a body costs TU + TV +
//     TW loaded values and TU TV multiplies for TU TV TW fmas; the bodies
//     of the next tile arrive by cp.async while this one is summed;
//   - every 512-body P2M item wrote m^3 partials and a second launch added
//     them (0.27 GB at m = 32, N = 1M).  Now the wrapper sizes the items
//     from N and the card (ops/fmm_kernels.p2m_chunk: 1024 bodies at
//     N = 1M), a run of one item writes W itself, and the second launch
//     adds only runs of several items, in a fixed order: a thread an
//     output, or where runs hold kRunFoldSplit items or more on average
//     (K1's one run, K8's eight at C = 2) kRunFoldSplit lanes of items an
//     output; it is skipped when every run fits in one item;
//   - L2P fed 4 fmas per shared-memory load (one body a thread) and
//     re-read each run's k m^3 field values once per 128 bodies.  Now the
//     block tier computes H[b, (u, v)] = sum_w Sz[b, w] F[(u, v), w] as a
//     register-tiled product (8 bodies x 8 pairs a thread: 16 LDS.128 for
//     256 fmas, each loaded a step ahead), then a_b = sum Sx[b, u] Sy[b, v]
//     H[b, (u, v)] into per-warp partial sums in shared memory, folded
//     across the warps in a fixed order; an item is 256 bodies, and the
//     field chunks arrive by cp.async, double-buffered;
//   - every block ran a binary search for its run (15 dependent loads on
//     the 1M step's slots) and the node table's fp64 cos; short runs (48
//     bodies a slot on average) left most of a 128-thread L2P block idle.
//     Now a warp's lanes probe 32 points of the prefix at once (3 rounds
//     of one load on those slots), the table comes from the wrapper, and
//     at MW <= 8 a
//     warp runs an item (4 a block): P2M one body a lane a pass, L2P two
//     bodies a lane (64 an item) against the run's fields staged once.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

#include "cheb.cuh"
#include "sweep.cuh"

namespace murb {

constexpr int kRunMaxOrder = 32;
constexpr int kRunFields = 4;          // fields one L2P launch takes
constexpr int kRunWarpMaxMW = 8;       // MW <= 8: a warp runs an item
constexpr int kRunWarpItems = 4;       // warp items a block
constexpr int kRunP2MTile = 64;        // bodies a staged tile (block tier)
constexpr int kRunL2PLaneBodies = 2;   // L2P warp tier: 64 bodies an item
constexpr int kRunL2PThreadBodies = 8; // L2P block tier: 256 bodies an item

constexpr int kRunFoldThreads = 256;  // threads a fold block
constexpr int kRunFoldSplit = 32;     // item lanes an output of a split fold

// In-cell Chebyshev coordinate of q in the cell with index `cell` along one
// dimension, clipped to [-1, 1] as the basis requires.
__device__ __forceinline__ float cell_t(float q, float lo, float cs,
                                        int cell) {
  return clip_unit(2.f * ((q - lo) / cs - static_cast<float>(cell)) - 1.f);
}

// The run holding work item `item` (the same in every lane of the warp):
// the r < nrun with prefix[r] <= item < prefix[r + 1] (empty runs repeat a
// prefix value and hold none), -1 for item >= prefix[nrun].  The 32 lanes
// probe 32 points of the interval at once and a ballot keeps the part
// that holds the item: ceil(log32(nrun)) rounds of one load a lane (2 at
// 64 cells, 3 at the 1M step's 21,954 slots, where a binary search makes
// 6 and 15 dependent loads).  Every lane of the warp calls it.
__device__ __forceinline__ int warp_item_run(const long long* prefix,
                                             int nrun, long long item) {
  if (item >= prefix[nrun]) return -1;
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = nrun;  // prefix[lo] <= item < prefix[hi]
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + (lane + 1) * step;
    const bool below = probe < hi && prefix[probe] <= item;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    hi = min(hi, lo + (c + 1) * step);
    lo += c * step;
  }
  return lo;
}

// A run accessor gives the index of a run's j-th body (body), a body's
// cell (cell), stages a body's cell for P2M (stage_cell: cp.async into
// dst[0..2], or nothing where the run gives the cell) and reads it back
// (staged_cell), and maps a coordinate q along one dimension to the
// body's Chebyshev coordinate t from the box's two values b0, b1 of that
// dimension and the body's cell index (coord).
struct CellRuns {
  const long long* perm;
  int C;
  __device__ long long body(long long j) const { return perm[j]; }
  __device__ int3 cell(int run, long long) const {
    return make_int3(run / (C * C), (run / C) % C, run % C);
  }
  __device__ void stage_cell(int*, int, long long, bool) const {}
  __device__ int3 staged_cell(const int*, int run) const {
    return cell(run, 0);
  }
  __device__ float coord(float q, float lo, float cs, int cell) const {
    return cell_t(q, lo, cs, cell);
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
  __device__ void stage_cell(int* dst, int, long long body,
                             bool valid) const {
    cp_async4(dst, cx + body, valid);
    cp_async4(dst + 1, cy + body, valid);
    cp_async4(dst + 2, cz + body, valid);
  }
  __device__ int3 staged_cell(const int* src, int) const {
    return make_int3(src[0], src[1], src[2]);
  }
  __device__ float coord(float q, float lo, float cs, int cell) const {
    return cell_t(q, lo, cs, cell);
  }
};

// One run of all n bodies in place, in the box [c, h]: no cells, and t =
// clip((q - c) / h) (murb_tpu/ops/proxy_pallas.py:103-109), not the cell_t
// of a one-cell grid, which rounds differently.
struct OneRun {
  __device__ long long body(long long j) const { return j; }
  __device__ int3 cell(int, long long) const { return make_int3(0, 0, 0); }
  __device__ void stage_cell(int*, int, long long, bool) const {}
  __device__ int3 staged_cell(const int*, int) const {
    return make_int3(0, 0, 0);
  }
  __device__ float coord(float q, float c, float h, int) const {
    return clip_unit((q - c) / h);
  }
};

// The k <= kRunFields node fields of one L2P launch, each (nrun, m^3).
struct RunFields {
  const float* f[kRunFields];
  // f[i] for a run-time i without a local-memory copy of the array
  __device__ const float* at(int i) const {
    return i == 0 ? f[0] : i == 1 ? f[1] : i == 2 ? f[2] : f[3];
  }
};

// One body of a run as L2P reads it: its coordinates and cell (zeros for
// a slot past the run's end).
struct RunBody {
  float x, y, z;
  int3 c;
};

template <class Runs>
__device__ __forceinline__ RunBody run_body(const Runs& runs, int run,
                                            long long body, bool valid,
                                            const float* qx, const float* qy,
                                            const float* qz) {
  RunBody r{0.f, 0.f, 0.f, make_int3(0, 0, 0)};
  if (valid) {
    r.x = qx[body];
    r.y = qy[body];
    r.z = qz[body];
    r.c = runs.cell(run, body);
  }
  return r;
}

// The node table transposed into shared memory: tab[(j - 1) MW + k] =
// T_j(t_k) for j = 1..m-1 and k < MW (0 past m), from the wrapper's
// [k][j - 1] table.  Every thread of the block calls it; the caller
// synchronises before use.
template <int MW>
__device__ __forceinline__ void stage_table(float* tab,
                                            const float* node_table, int m,
                                            int tid, int nthreads) {
  for (int i = tid; i < (m - 1) * MW; i += nthreads) {
    const int j1 = i / MW, k = i % MW;
    tab[i] = k < m ? node_table[k * (m - 1) + j1] : 0.f;
  }
}

// S_k(t) * scale for the NK nodes k = k0 .. k0 + NK - 1 of order m (0 for
// k >= m) into v: T_j(t) by the recurrence T_j = 2 t T_{j-1} - T_{j-2},
// computed once for all NK nodes, s_k = fma(T_j(t), T_j(t_k), s_k) for j =
// 1..m-1 with the table (stage_table) read 4 nodes a load, then S_k =
// 1/m + (2/m) s_k.
template <int MW, int NK>
__device__ __forceinline__ void basis_span(float t, const float* tab, int m,
                                           int k0, float scale,
                                           float (&v)[NK]) {
  static_assert(NK % 4 == 0, "nodes are read 4 at a time");
  float s[NK];
#pragma unroll
  for (int q = 0; q < NK; ++q) s[q] = 0.f;
  float tprev = 1.f, tcur = t;
  for (int j = 1; j < m; ++j) {
    if (j > 1) {
      const float tnext = 2.f * t * tcur - tprev;
      tprev = tcur;
      tcur = tnext;
    }
    const float4* row = reinterpret_cast<const float4*>(
        tab + (j - 1) * MW + k0);
#pragma unroll
    for (int q4 = 0; q4 < NK / 4; ++q4) {
      const float4 r = row[q4];
      s[4 * q4 + 0] = fmaf(tcur, r.x, s[4 * q4 + 0]);
      s[4 * q4 + 1] = fmaf(tcur, r.y, s[4 * q4 + 1]);
      s[4 * q4 + 2] = fmaf(tcur, r.z, s[4 * q4 + 2]);
      s[4 * q4 + 3] = fmaf(tcur, r.w, s[4 * q4 + 3]);
    }
  }
  const float c0 = 1.f / m, c1 = 2.f / m;
#pragma unroll
  for (int q = 0; q < NK; ++q)
    v[q] = k0 + q < m ? scale * (c0 + c1 * s[q]) : 0.f;
}

// n consecutive floats of shared memory into registers, 16 or 8 bytes a
// load where n allows (p aligned to match).
template <int N>
__device__ __forceinline__ void lds_row(const float* p, float (&r)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      r[i] = q.x; r[i + 1] = q.y; r[i + 2] = q.z; r[i + 3] = q.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      r[i] = q.x; r[i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void sts_row(float* p, const float (&r)[N]) {
  static_assert(N % 4 == 0, "rows are stored 16 bytes at a time");
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
}

// ------------------------------------------------------------------ P2M
// Geometry of the P2M at padded order MW.  A thread owns a TU x TV x TW
// tile of the (u, v, w) outputs; kActive threads cover the MW^3 cube.  At
// MW <= 8 a warp runs an item (kGroups warp items a block) and stages 32
// bodies a pass, one a lane; above it a block runs an item and stages
// kRunP2MTile bodies a tile, their bases computed by 3 kTile kSplitK tasks.
template <int MW>
struct P2MGeom {
  static constexpr bool kWarp = MW <= kRunWarpMaxMW;
  static constexpr int TU = MW <= kRunWarpMaxMW ? 1 : 2;
  static constexpr int TV = MW <= 4 ? 1 : MW <= kRunWarpMaxMW ? 2 : 4;
  static constexpr int TW = MW <= 4 ? 2
                            : (MW == 8 || MW == 24 || MW == 32) ? 8 : 4;
  static constexpr int kActive = (MW / TU) * (MW / TV) * (MW / TW);
  static constexpr int kGroups = kWarp ? kRunWarpItems : 1;
  static constexpr int kThreads =
      kWarp ? 32 * kRunWarpItems : (kActive + 31) / 32 * 32;
  static constexpr int kTile = kWarp ? 32 : kRunP2MTile;
  static constexpr int kSplitK = MW == 32 ? 2 : 1;
  static_assert(!kWarp || kActive == 32, "a warp item: one tile a lane");
};

// P2M over one work item per group (a warp or the block): the item's
// bodies [j0, j1) of its run r (warp_item_run), j0 = bounds[r] + (item -
// prefix[r]) chunk.  A run of one item writes its row of W; an item of a
// run of several writes its partial (partial + item m^3), which
// p2m_runs_fold_kernel adds.  partial == nullptr: every run has at most one
// item (the wrapper zeroes W for the empty ones).  Stager s < kTile of a
// group owns body slot s of every tile: it copies the slot's coordinates
// (and cell) of the next tile by cp.async while the group computes this
// one, the body index (through the permutation) one tile further ahead.
template <int MW, class Runs>
__global__ void __launch_bounds__(P2MGeom<MW>::kThreads)
p2m_runs_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                const float* __restrict__ qz, const float* __restrict__ gm,
                Runs runs, const float* __restrict__ box, int m,
                const long long* __restrict__ bounds,
                const long long* __restrict__ prefix,
                int nrun, int nitems, int chunk,
                const float* __restrict__ node_table,
                float* __restrict__ partial, float* __restrict__ w) {
  using G = P2MGeom<MW>;
  constexpr int S = G::kTile;
  __shared__ __align__(16) float tab[(MW - 1) * MW];
  __shared__ __align__(16) float sa[G::kGroups][S * MW];  // gm Sx
  __shared__ __align__(16) float sy[G::kGroups][S * MW];
  __shared__ __align__(16) float sz[G::kGroups][S * MW];
  __shared__ float4 raw[G::kGroups][2][S];  // x, y, z, gm of a slot
  __shared__ int rawc[G::kGroups][2][S][3];  // its cell (SlotRuns)
  __shared__ float4 tq[G::kWarp ? 1 : S];  // block tier: t values and gm

  stage_table<MW>(tab, node_table, m, threadIdx.x, blockDim.x);
  __syncthreads();
  const int group = G::kWarp ? static_cast<int>(threadIdx.x >> 5) : 0;
  const int gt = G::kWarp ? static_cast<int>(threadIdx.x & 31)
                          : static_cast<int>(threadIdx.x);
  const int item = blockIdx.x * G::kGroups + group;
  const int run = item < nitems ? warp_item_run(prefix, nrun, item) : -1;
  if (run < 0) return;  // the whole group: no barrier of it is skipped

  // box: [lo, cs] (CellRuns, SlotRuns) or [c, h] (OneRun), as runs.coord
  // reads them
  const float bx0 = box[0], by0 = box[1], bz0 = box[2];
  const float bx1 = box[3], by1 = box[4], bz1 = box[5];
  const long long ib = prefix[run];
  const long long j0 = bounds[run] + (item - ib) * static_cast<long long>(
      chunk);
  const long long j1 = min(j0 + chunk, bounds[run + 1]);
  const long long p3 = static_cast<long long>(m) * m * m;
  float* dst = (partial == nullptr || prefix[run + 1] - ib == 1)
                   ? w + run * p3
                   : partial + item * p3;

  constexpr int NW = MW / G::TW, NV = MW / G::TV;
  const bool owner = gt < G::kActive;
  const int tt = owner ? gt : 0;
  const int wg = tt % NW, vg = (tt / NW) % NV, ug = tt / (NW * NV);
  float acc[G::TU][G::TV][G::TW];
#pragma unroll
  for (int a = 0; a < G::TU; ++a)
#pragma unroll
    for (int b = 0; b < G::TV; ++b)
#pragma unroll
      for (int c = 0; c < G::TW; ++c) acc[a][b][c] = 0.f;

  const bool stager = gt < S;
  float4(*rq)[S] = raw[group];
  int(*rc)[S][3] = rawc[group];
  // copy slot gt of the tile at j (index `body`) into buffer `buf`
  auto fetch = [&](int buf, long long body, bool valid) {
    float* d = reinterpret_cast<float*>(&rq[buf][gt]);
    cp_async4(d, qx + body, valid);
    cp_async4(d + 1, qy + body, valid);
    cp_async4(d + 2, qz + body, valid);
    cp_async4(d + 3, gm + body, valid);
    runs.stage_cell(rc[buf][gt], run, body, valid);
    cp_async_commit();
  };
  long long idx_next = 0;
  if (stager) {
    fetch(0, j0 + gt < j1 ? runs.body(j0 + gt) : 0, j0 + gt < j1);
    idx_next = j0 + S + gt < j1 ? runs.body(j0 + S + gt) : 0;
  }
  float* rowa = sa[group];
  float* rowy = sy[group];
  float* rowz = sz[group];
  int buf = 0;
  for (long long j = j0; j < j1; j += S, buf ^= 1) {
    if (stager) {
      cp_async_wait_all();  // this slot of the tile landed
      const bool valid = j + gt < j1;
      const float4 q = rq[buf][gt];
      const int3 ci = runs.staged_cell(rc[buf][gt], run);
      const float tx = valid ? runs.coord(q.x, bx0, bx1, ci.x) : 0.f;
      const float ty = valid ? runs.coord(q.y, by0, by1, ci.y) : 0.f;
      const float tz = valid ? runs.coord(q.z, bz0, bz1, ci.z) : 0.f;
      const float g = valid ? q.w : 0.f;
      const long long jn = j + S + gt;
      fetch(buf ^ 1, idx_next, jn < j1);
      idx_next = jn + S < j1 ? runs.body(jn + S) : 0;
      if constexpr (G::kWarp) {
        float v[MW];
        basis_span<MW, MW>(tx, tab, m, 0, g, v);
        sts_row(rowa + gt * MW, v);
        basis_span<MW, MW>(ty, tab, m, 0, 1.f, v);
        sts_row(rowy + gt * MW, v);
        basis_span<MW, MW>(tz, tab, m, 0, 1.f, v);
        sts_row(rowz + gt * MW, v);
      } else {
        tq[gt] = make_float4(tx, ty, tz, g);
      }
    }
    if constexpr (G::kWarp) {
      __syncwarp();
    } else {
      __syncthreads();  // tq staged; the last tile's bases consumed
      constexpr int NK = MW / G::kSplitK;
      for (int task = gt; task < 3 * S * G::kSplitK; task += G::kThreads) {
        const int part = task % G::kSplitK;
        const int b = (task / G::kSplitK) % S;
        const int d = task / (G::kSplitK * S);
        const float4 q = tq[b];
        float v[NK];
        basis_span<MW, NK>(d == 0 ? q.x : d == 1 ? q.y : q.z, tab, m,
                           part * NK, d == 0 ? q.w : 1.f, v);
        sts_row((d == 0 ? rowa : d == 1 ? rowy : rowz) + b * MW + part * NK,
                v);
      }
      __syncthreads();
    }
    const int nb = static_cast<int>(min(static_cast<long long>(S), j1 - j));
    if (owner) {
      for (int bb = 0; bb < nb; ++bb) {
        float ra[G::TU], ry[G::TV], rz[G::TW];
        lds_row(rowa + bb * MW + ug * G::TU, ra);
        lds_row(rowy + bb * MW + vg * G::TV, ry);
        lds_row(rowz + bb * MW + wg * G::TW, rz);
#pragma unroll
        for (int a = 0; a < G::TU; ++a)
#pragma unroll
          for (int b = 0; b < G::TV; ++b) {
            const float p = ra[a] * ry[b];
#pragma unroll
            for (int c = 0; c < G::TW; ++c)
              acc[a][b][c] = fmaf(p, rz[c], acc[a][b][c]);
          }
      }
    }
    if constexpr (G::kWarp) __syncwarp();  // the pass is consumed
  }
  if (owner) {
#pragma unroll
    for (int a = 0; a < G::TU; ++a)
#pragma unroll
      for (int b = 0; b < G::TV; ++b)
#pragma unroll
        for (int c = 0; c < G::TW; ++c) {
          const int u = ug * G::TU + a, v = vg * G::TV + b,
                    x = wg * G::TW + c;
          if (u < m && v < m && x < m) dst[(u * m + v) * m + x] = acc[a][b][c];
        }
  }
}

// W[r, p] = the sum of the partials of run r's items for the runs of
// several items; 0 for runs of none; runs of one item wrote their row
// themselves.  `split` lanes of items an output (1 or kRunFoldSplit,
// fold_split): block (r, y) takes the kRunFoldThreads / split outputs p of
// run r from y kRunFoldThreads / split on, lane l of an output sums items
// l, l + split, ... of the run in order, and the lanes' sums are added in
// lane order (at split 1: the items in order, a thread an output).  A
// block of a run of one item leaves at once.  Internal linkage: each
// entry's source keeps its own copy.
namespace {
__global__ void __launch_bounds__(kRunFoldThreads)
p2m_runs_fold_kernel(const float* __restrict__ partial,
                     const long long* __restrict__ prefix, int p3, int split,
                     float* __restrict__ w) {
  __shared__ float lanes[kRunFoldThreads];
  const int run = blockIdx.x;
  const long long b0 = prefix[run], b1 = prefix[run + 1];
  if (b1 - b0 == 1) return;  // the whole block
  const int per = kRunFoldThreads / split;
  const int o = threadIdx.x % per, lane = threadIdx.x / per;
  const int p = blockIdx.y * per + o;
  float s = 0.f;
  if (p < p3) {
#pragma unroll 4
    for (long long b = b0 + lane; b < b1; b += split)
      s += partial[b * p3 + p];
  }
  float* dst = w + static_cast<long long>(run) * p3 + p;
  if (split == 1) {
    if (p < p3) *dst = s;
    return;
  }
  lanes[threadIdx.x] = s;
  __syncthreads();
  if (lane == 0 && p < p3) {
    float t = 0.f;
    for (int l = 0; l < split; ++l) t += lanes[l * per + o];
    *dst = t;
  }
}
}  // namespace

// The fold's item lanes an output: kRunFoldSplit where the runs hold at
// least kRunFoldSplit items on average (nitems, an upper bound of the
// items, over nrun), else 1.  Both come from the shape alone, so every
// launch of a shape sums in one order.
inline int fold_split(int nitems, int nrun) {
  return static_cast<long long>(nitems) >=
                 static_cast<long long>(kRunFoldSplit) * nrun
             ? kRunFoldSplit
             : 1;
}

// ------------------------------------------------------------------ L2P
// Geometry of the L2P at padded order MW.  Warp tier (MW <= 8): a warp
// runs an item of 32 kTB bodies (interleaved, lane + 32 i), each lane its
// kTB bodies' bases in registers, the run's k fields staged once in the
// warp's shared memory (Fs[f][u][v][w], rows u, v < m).  Block tier: an
// item of 32 kTB = 256 bodies; the fields arrive kUC u-rows at a time (kUC
// MW (u, v) pairs of MW w's a field); of the chunk's kPG groups of 4 pairs
// (4 consecutive v of one u), warp w owns groups w and w + kWarps, and lane
// bg the bodies bg + 32 i: 8 bodies x 8 pairs a thread.  Basis rows sit
// kStride floats apart, an odd number of 16-byte quads, so 8 lanes reading
// 8 consecutive rows hit 8 different bank quads.
template <int MW>
struct L2PGeom {
  static constexpr bool kWarp = MW <= kRunWarpMaxMW;
  static constexpr int kTB = kWarp ? kRunL2PLaneBodies : kRunL2PThreadBodies;
  static constexpr int kItem = 32 * kTB;
  static constexpr int kUC = MW <= 16 ? 4 : 2;
  static constexpr int kPG = kUC * MW / 4;
  static constexpr int kWarps = kPG / 2;
  static constexpr int kThreads = kWarp ? 32 * kRunWarpItems : 32 * kWarps;
  static constexpr int kStride = (MW / 4) % 2 ? MW : MW + 4;
  static constexpr int kChunk = kRunFields * kUC * MW * MW;  // floats
  static constexpr int kBases = 3 * kItem * kStride;
  static constexpr int kSums = kWarps * kRunFields * kItem;
  // dynamic shared memory of the block tier: bases, each warp's partial
  // sums a body and field (the bodies' t values before them), two field
  // chunks, body indices, the node table
  static constexpr int kDynBytes =
      4 * (kBases + kSums + 2 * kChunk) + 8 * kItem + 4 * MW * (MW - 1);
  static_assert(kSums >= 4 * kItem, "the t values fit in the sums");
  static_assert(kWarp || kPG % 2 == 0, "two pair groups a warp");
};

template <int MW, class Runs>
__global__ void __launch_bounds__(L2PGeom<MW>::kThreads)
l2p_runs_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                const float* __restrict__ qz, Runs runs,
                const float* __restrict__ box, int m,
                const long long* __restrict__ bounds,
                const long long* __restrict__ prefix,
                int nrun, int nitems,
                const float* __restrict__ node_table, RunFields fields,
                int k, int n, float* __restrict__ out) {
  using G = L2PGeom<MW>;
  constexpr int TB = G::kTB;
  const float bx0 = box[0], by0 = box[1], bz0 = box[2];  // as in P2M
  const float bx1 = box[3], by1 = box[4], bz1 = box[5];
  const long long p3 = static_cast<long long>(m) * m * m;

  if constexpr (G::kWarp) {
    __shared__ __align__(16) float tab[(MW - 1) * MW];
    __shared__ __align__(16) float fs[kRunWarpItems][kRunFields * MW * MW * MW];
    stage_table<MW>(tab, node_table, m, threadIdx.x, blockDim.x);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int item = blockIdx.x * kRunWarpItems + warp;
    const int run = item < nitems ? warp_item_run(prefix, nrun, item) : -1;
    if (run < 0) return;  // the whole warp
    const long long j0 = bounds[run] +
        (item - prefix[run]) * static_cast<long long>(G::kItem);
    const long long j1 = min(j0 + G::kItem, bounds[run + 1]);

    // the lane's bodies first (their loads fly while the fields' copies
    // are issued), then the run's fields, once: Fs[f][u][v][w] for u, v <
    // m, zeros past m along w (rows past m are never read)
    long long body[TB];
    bool own[TB];
    RunBody rb[TB];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const long long j = j0 + 32 * i + lane;
      own[i] = j < j1;
      body[i] = own[i] ? runs.body(j) : 0;
      rb[i] = run_body(runs, run, body[i], own[i], qx, qy, qz);
    }
    float* F = fs[warp];
    for (int f = 0; f < k; ++f) {
      const float* src = fields.at(f) + run * p3;
      for (int u = 0; u < m; ++u)
        for (int vw = lane; vw < m * MW; vw += 32) {
          const int v = vw / MW, x = vw % MW;
          cp_async4(F + ((f * MW + u) * MW + v) * MW + x,
                    src + (x < m ? (u * m + v) * m + x : 0), x < m);
        }
    }
    cp_async_commit();

    float sx[TB][MW], sy[TB][MW], sz[TB][MW];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const RunBody& r = rb[i];
      basis_span<MW, MW>(own[i] ? runs.coord(r.x, bx0, bx1, r.c.x) : 0.f,
                         tab, m, 0, 1.f, sx[i]);
      basis_span<MW, MW>(own[i] ? runs.coord(r.y, by0, by1, r.c.y) : 0.f,
                         tab, m, 0, 1.f, sy[i]);
      basis_span<MW, MW>(own[i] ? runs.coord(r.z, bz0, bz1, r.c.z) : 0.f,
                         tab, m, 0, 1.f, sz[i]);
    }
    cp_async_wait_all();
    __syncwarp();

    float acc[kRunFields][TB];
#pragma unroll
    for (int f = 0; f < kRunFields; ++f)
#pragma unroll
      for (int i = 0; i < TB; ++i) acc[f][i] = 0.f;
#pragma unroll
    for (int u = 0; u < MW; ++u) {
      if (u < m) {
        float bu[kRunFields][TB];
#pragma unroll
        for (int f = 0; f < kRunFields; ++f)
#pragma unroll
          for (int i = 0; i < TB; ++i) bu[f][i] = 0.f;
#pragma unroll
        for (int v = 0; v < MW; ++v) {
          if (v < m) {
#pragma unroll
            for (int f = 0; f < kRunFields; ++f) {
              if (f < k) {
                const float4* row = reinterpret_cast<const float4*>(
                    F + ((f * MW + u) * MW + v) * MW);
                float t[TB];
#pragma unroll
                for (int i = 0; i < TB; ++i) t[i] = 0.f;
#pragma unroll
                for (int w4 = 0; w4 < MW / 4; ++w4) {
                  const float4 q = row[w4];
#pragma unroll
                  for (int i = 0; i < TB; ++i) {
                    t[i] = fmaf(q.x, sz[i][4 * w4 + 0], t[i]);
                    t[i] = fmaf(q.y, sz[i][4 * w4 + 1], t[i]);
                    t[i] = fmaf(q.z, sz[i][4 * w4 + 2], t[i]);
                    t[i] = fmaf(q.w, sz[i][4 * w4 + 3], t[i]);
                  }
                }
#pragma unroll
                for (int i = 0; i < TB; ++i)
                  bu[f][i] = fmaf(sy[i][v], t[i], bu[f][i]);
              }
            }
          }
        }
#pragma unroll
        for (int f = 0; f < kRunFields; ++f)
#pragma unroll
          for (int i = 0; i < TB; ++i)
            acc[f][i] = fmaf(sx[i][u], bu[f][i], acc[f][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < TB; ++i)
      if (own[i]) {
#pragma unroll
        for (int f = 0; f < kRunFields; ++f)
          if (f < k) out[static_cast<long long>(f) * n + body[i]] = acc[f][i];
      }
  } else {
    extern __shared__ __align__(16) float smem[];
    constexpr int SS = G::kStride, NB = G::kItem;
    float* bsx = smem;                     // Sx rows
    float* bsy = bsx + NB * SS;
    float* bsz = bsy + NB * SS;
    float* sums = smem + G::kBases;        // sums[warp][f][b]
    float4* tq = reinterpret_cast<float4*>(sums);  // until the bases exist
    float* fbuf = sums + G::kSums;         // two field chunks
    long long* bidx = reinterpret_cast<long long*>(fbuf + 2 * G::kChunk);
    float* tab = reinterpret_cast<float*>(bidx + NB);

    // every warp finds the block's run
    const int run = static_cast<int>(blockIdx.x) < nitems
                        ? warp_item_run(prefix, nrun, blockIdx.x) : -1;
    if (run < 0) return;  // the whole block
    const int tid = threadIdx.x;
    const long long j0 = bounds[run] +
        (blockIdx.x - prefix[run]) * static_cast<long long>(NB);
    const long long j1 = min(j0 + NB, bounds[run + 1]);
    const long long base = run * p3;
    // chunk c: rows u = c kUC + ul, Fc[f][ul][v][w], zeros past m
    auto issue = [&](int c, float* dstc) {
      for (int idx = tid; idx < k * G::kUC * MW * MW; idx += G::kThreads) {
        const int x = idx % MW, v = (idx / MW) % MW;
        const int u = c * G::kUC + (idx / (MW * MW)) % G::kUC;
        const int f = idx / (G::kUC * MW * MW);
        const bool valid = u < m && v < m && x < m;
        cp_async4(dstc + idx,
                  fields.at(f) + (valid ? base + (u * m + v) * m + x : 0),
                  valid);
      }
      cp_async_commit();
    };
    issue(0, fbuf);
    stage_table<MW>(tab, node_table, m, tid, G::kThreads);
    for (int b = tid; b < NB; b += G::kThreads) {
      const long long j = j0 + b;
      const bool valid = j < j1;
      const long long body = valid ? runs.body(j) : 0;
      const RunBody r = run_body(runs, run, body, valid, qx, qy, qz);
      bidx[b] = valid ? body : -1;
      tq[b] = make_float4(valid ? runs.coord(r.x, bx0, bx1, r.c.x) : 0.f,
                          valid ? runs.coord(r.y, by0, by1, r.c.y) : 0.f,
                          valid ? runs.coord(r.z, bz0, bz1, r.c.z) : 0.f,
                          0.f);
    }
    __syncthreads();
    for (int task = tid; task < 3 * NB; task += G::kThreads) {
      const int b = task % NB, d = task / NB;
      const float4 q = tq[b];
      float v[MW];
      basis_span<MW, MW>(d == 0 ? q.x : d == 1 ? q.y : q.z, tab, m, 0, 1.f,
                         v);
      sts_row(bsx + d * NB * SS + b * SS, v);
    }

    const int wp = tid >> 5, bg = tid & 31;
    int ul[2], v0[2];
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      const int pg = wp + gi * G::kWarps;
      ul[gi] = (4 * pg) / MW;
      v0[gi] = (4 * pg) % MW;
    }
    float* mine = sums + wp * kRunFields * NB + bg;  // [f * NB + 32 i]
    const int nchunk = (m + G::kUC - 1) / G::kUC;
    const int nw4 = (m + 3) / 4;
    for (int c = 0; c < nchunk; ++c) {
      cp_async_wait_all();
      __syncthreads();  // chunk c and the bases visible; chunk c - 1 consumed
      if (c == 0) {     // tq is consumed
#pragma unroll
        for (int f = 0; f < kRunFields; ++f)
#pragma unroll
          for (int i = 0; i < TB; ++i) mine[f * NB + 32 * i] = 0.f;
      }
      if (c + 1 < nchunk) issue(c + 1, fbuf + ((c + 1) & 1) * G::kChunk);
      const float* fc = fbuf + (c & 1) * G::kChunk;
#pragma unroll
      for (int f = 0; f < kRunFields; ++f) {
        if (f < k) {
          const float* fr0 = fc + ((f * G::kUC + ul[0]) * MW + v0[0]) * MW;
          const float* fr1 = fc + ((f * G::kUC + ul[1]) * MW + v0[1]) * MW;
          float h[TB][8];
#pragma unroll
          for (int i = 0; i < TB; ++i)
#pragma unroll
            for (int p = 0; p < 8; ++p) h[i][p] = 0.f;
          // each step: the 8 pairs' 4 w's and the 8 bodies' Sz, then the
          // fmas one component at a time, so that consecutive fmas feed
          // different sums
          for (int w4 = 0; w4 < nw4; ++w4) {
            float4 Fq[8], z[TB];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              Fq[p] = *reinterpret_cast<const float4*>(fr0 + p * MW + 4 * w4);
              Fq[4 + p] =
                  *reinterpret_cast<const float4*>(fr1 + p * MW + 4 * w4);
            }
#pragma unroll
            for (int i = 0; i < TB; ++i)
              z[i] = *reinterpret_cast<const float4*>(
                  bsz + (bg + 32 * i) * SS + 4 * w4);
#pragma unroll
            for (int i = 0; i < TB; ++i)
#pragma unroll
              for (int p = 0; p < 8; ++p) h[i][p] = fmaf(Fq[p].x, z[i].x,
                                                         h[i][p]);
#pragma unroll
            for (int i = 0; i < TB; ++i)
#pragma unroll
              for (int p = 0; p < 8; ++p) h[i][p] = fmaf(Fq[p].y, z[i].y,
                                                         h[i][p]);
#pragma unroll
            for (int i = 0; i < TB; ++i)
#pragma unroll
              for (int p = 0; p < 8; ++p) h[i][p] = fmaf(Fq[p].z, z[i].z,
                                                         h[i][p]);
#pragma unroll
            for (int i = 0; i < TB; ++i)
#pragma unroll
              for (int p = 0; p < 8; ++p) h[i][p] = fmaf(Fq[p].w, z[i].w,
                                                         h[i][p]);
          }
#pragma unroll
          for (int i = 0; i < TB; ++i) {
            const int b = bg + 32 * i;
            float a = mine[f * NB + 32 * i];
#pragma unroll
            for (int gi = 0; gi < 2; ++gi) {
              const int u = c * G::kUC + ul[gi];
              const float4 y = *reinterpret_cast<const float4*>(
                  bsy + b * SS + v0[gi]);
              const float4 x = *reinterpret_cast<const float4*>(
                  bsx + b * SS + (u & ~3));
              const int r = u & 3;
              const float xu = r == 0 ? x.x : r == 1 ? x.y : r == 2 ? x.z
                                                                  : x.w;
              float t = y.x * h[i][4 * gi];
              t = fmaf(y.y, h[i][4 * gi + 1], t);
              t = fmaf(y.z, h[i][4 * gi + 2], t);
              t = fmaf(y.w, h[i][4 * gi + 3], t);
              a = fmaf(xu, t, a);
            }
            mine[f * NB + 32 * i] = a;
          }
        }
      }
    }
    __syncthreads();  // every warp's sums written
    for (int t = tid; t < k * NB; t += G::kThreads) {
      const int f = t / NB, b = t % NB;
      float s = 0.f;
      for (int q = 0; q < G::kWarps; ++q)
        s += sums[(q * kRunFields + f) * NB + b];
      if (bidx[b] >= 0) out[static_cast<long long>(f) * n + bidx[b]] = s;
    }
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

// Lets the L2P block tier at MW take its dynamic shared memory (above the
// 48 KB default), once per device: a race between host threads only sets
// it twice.  Internal linkage: a template's static flag would otherwise be
// one symbol for every library of these sources loaded in a process (two
// builds compared in one process), and a flag set by one library's kernel
// would skip the other's.
namespace {
template <int MW, class Runs>
cudaError_t l2p_allow_smem() {
  constexpr int kDevices = 64;
  static std::atomic<bool> done[kDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kDevices && done[dev].load())) return e;
  e = cudaFuncSetAttribute(l2p_runs_kernel<MW, Runs>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L2PGeom<MW>::kDynBytes);
  if (e == cudaSuccess && dev < kDevices) done[dev].store(true);
  return e;
}
}  // namespace

// P2M over nrun runs into w (nrun, m^3), in nitems work items of `chunk`
// bodies (prefix: nrun + 1 offsets of each run's items); node_table: m (m
// - 1) floats of T_j(t_k); partial: nitems m^3 floats of scratch, or
// nullptr when every run has at most one item (w zeroed by the caller).
template <class Runs>
int p2m_runs(const float* qx, const float* qy, const float* qz,
             const float* gm, Runs runs, const float* box, int m, int nrun,
             const long long* bounds, const long long* prefix,
             int nitems, int chunk, const float* node_table, float* partial,
             float* w, cudaStream_t stream) {
  if (m < 2 || m > kRunMaxOrder || nrun < 1 || nitems < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define MURB_P2M_RUNS(MW)                                                  \
  {                                                                        \
    using G = P2MGeom<MW>;                                                 \
    p2m_runs_kernel<MW, Runs>                                              \
        <<<(nitems + G::kGroups - 1) / G::kGroups, G::kThreads, 0,         \
           stream>>>(qx, qy, qz, gm, runs, box, m, bounds, prefix, nrun,   \
                     nitems, chunk, node_table, partial, w);               \
  }
  MURB_DISPATCH_MW(m, MURB_P2M_RUNS)
#undef MURB_P2M_RUNS
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return static_cast<int>(err);
  const int p3 = m * m * m;
  const int split = fold_split(nitems, nrun);
  const int per = kRunFoldThreads / split;
  const dim3 grid(nrun, (p3 + per - 1) / per);
  p2m_runs_fold_kernel<<<grid, kRunFoldThreads, 0, stream>>>(
      partial, prefix, p3, split, w);
  return static_cast<int>(cudaGetLastError());
}

// L2P of 1 to kRunFields fields (each (nrun, m^3), their device pointers in
// the host array `fields`) into out (k, n), in nitems work items of
// L2PGeom<MW>::kItem bodies.
template <class Runs>
int l2p_runs(const float* qx, const float* qy, const float* qz, Runs runs,
             int n, const float* box, int m, int nrun,
             const long long* bounds, const long long* prefix, int nitems,
             const float* node_table, const float* const* fields, int k,
             float* out, cudaStream_t stream) {
  if (m < 2 || m > kRunMaxOrder || nrun < 1 || nitems < 1 || k < 1 ||
      k > kRunFields)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  RunFields f{};
  for (int i = 0; i < kRunFields; ++i) f.f[i] = fields[i < k ? i : 0];
#define MURB_L2P_RUNS(MW)                                                  \
  {                                                                        \
    using G = L2PGeom<MW>;                                                 \
    if constexpr (G::kWarp) {                                              \
      l2p_runs_kernel<MW, Runs>                                            \
          <<<(nitems + kRunWarpItems - 1) / kRunWarpItems, G::kThreads, 0, \
             stream>>>(qx, qy, qz, runs, box, m, bounds, prefix, nrun,     \
                       nitems, node_table, f, k, n, out);                  \
    } else {                                                               \
      const cudaError_t e = l2p_allow_smem<MW, Runs>();                    \
      if (e != cudaSuccess) return static_cast<int>(e);                    \
      l2p_runs_kernel<MW, Runs><<<nitems, G::kThreads, G::kDynBytes,       \
                                  stream>>>(qx, qy, qz, runs, box, m,      \
                                            bounds, prefix, nrun, nitems,  \
                                            node_table, f, k, n, out);     \
    }                                                                      \
  }
  MURB_DISPATCH_MW(m, MURB_L2P_RUNS)
#undef MURB_L2P_RUNS
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the run P2M (l2p false) or L2P kernel at order m that one
// SM holds at once (the CUDA occupancy calculator), and its threads a
// block.
template <class Runs>
int runs_resident(int m, bool l2p, int* blocks, int* threads) {
  if (m < 2 || m > kRunMaxOrder)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
#define MURB_RUNS_RESIDENT(MW)                                             \
  {                                                                        \
    using P = P2MGeom<MW>;                                                 \
    using L = L2PGeom<MW>;                                                 \
    if (!l2p) {                                                            \
      *threads = P::kThreads;                                              \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
          blocks, p2m_runs_kernel<MW, Runs>, P::kThreads, 0);              \
    } else {                                                               \
      *threads = L::kThreads;                                              \
      if constexpr (!L::kWarp) e = l2p_allow_smem<MW, Runs>();             \
      if (e == cudaSuccess)                                                \
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                 \
            blocks, l2p_runs_kernel<MW, Runs>, L::kThreads,                \
            L::kWarp ? 0 : L::kDynBytes);                                  \
    }                                                                      \
  }
  MURB_DISPATCH_MW(m, MURB_RUNS_RESIDENT)
#undef MURB_RUNS_RESIDENT
  return static_cast<int>(e);
}

}  // namespace murb
