// K7 (the M2L level sweep), K8 (grid P2M) and K9 (grid L2P): the kernels of
// the multi-level Chebyshev hierarchy (murb_tpu_torch/ops/fmm.py).
//
// Replace the TPU kernels murb_tpu/ops/fmm_pallas.py:_m2l_kernel (pallas_call
// at :240, entry m2l_level_fused :169), _p2m_grid_kernel (:355, entry
// p2m_grid_fused :338) and _l2p_grid_kernel (:406, entry l2p_grid_fused
// :382).  K8, K9 and K7's fp32 instance compute in fp32 with fp32 fmas;
// K7's lossy instance (murb_tpu's exact_dots=False, the m2l_dots tier
// "bf16x3") builds the same transfer entries in fp32 and applies them as
// 3xTF32 tensor-core products (below).  The node fields oscillate in sign
// and cancel heavily, so a single TF32 or bf16 pass is not enough for
// either tier.
//
// Cells.  The finest level is a C^3 grid over the box (lo = c - h, cell
// sizes cs = 2h / C per dimension, the box stays anisotropic).  A body's
// cell is clip(floor((q - lo) / cs), 0, C - 1) per dimension and its in-cell
// coordinate t = 2 ((q - lo) / cs - cell) - 1, so a body on the top face
// gets t = 1.  The wrapper (ops/fmm_kernels.cell_order) computes each
// body's cell id, orders the bodies by cell (a stable sort of the ids: glue,
// not the contraction) and hands the kernels the permutation, the cell
// bounds (C^3 + 1 offsets into it) and, per kernel, a prefix of work items
// per cell and the node table (cell_runs.cuh).  The kernels take each body's cell from that table, never from a second
// floor, so the sort and the bases cannot disagree.
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
// is, for each offset, one transfer matrix T(o) applied to the weights of
// every target cell the offset admits.  T depends on the offset and the
// level alone, so the kernel builds each entry T(o)[u, v] once for up to
// kM2LGroup admitted target cells and applies it to all of them: at the
// main path (m = 8, C = 4, expand) 444 builds of the 512^2 entries instead
// of one per (target cell, offset) pair, 4,096 (the first design, which
// spent most of its time rebuilding T).
//
// Work items.  The wrapper (ops/fmm_kernels.m2l_plan) lists, per tile of
// target cells (kM2LCellTile^3 cells; the whole grid up to C = 4), each
// offset's admitted target cells -- a box of per-dimension ranges, in-grid
// and under the parity rule, taken in order -- in items of at most
// kM2LGroup cells: {ox, oy, oz, the linear offset, the cell count, the
// target cell ids}.  It splits each tile's items into `nsplit` contiguous
// runs of about equal work, one block row each: {first item, end, split,
// the tile's cell box}.  The kernel reads the table and computes no
// admission itself.
//
// A block owns kM2LTargets target nodes u (grid.x) of one row's items
// (grid.y), kM2LSlices source-node slices of them: thread (s, u) owns node
// u and, for the item at hand, its cells' nf accumulators in registers
// (the item's cell count is a template argument, so no slot is wasted).
// For every source node v of its slice the thread builds T(o)[u, v] in
// registers (3 sub, 3 fma, one rsqrt.approx.ftz, 5 mul) and applies it to
// each cell's weight with nf fmas; the weights and the source nodes come
// from shared memory as broadcasts, kM2LChunk source nodes a chunk, staged
// (the weights by cp.async) into one buffer while the other is swept, one
// barrier a chunk.  When an item ends, the slices' sums are added in slice
// order through shared memory and slice 0 adds them to the block's fields:
// the output, or with nsplit > 1 the row's split of the scratch, which a
// second kernel adds in split order.  A block zeroes its tile's fields
// first; every element is written by one thread, in item order.  No
// atomics, the same bits every launch.
//
// Arithmetic: fp32 fmas throughout (the node fields cancel).  Bound: fp32
// issue, 2 nf flops per node pair of each admitted cell pair plus one
// build per (item, u, v); at the main path the apply is 6.4e9 flops.
//
// K7's lossy instance (m2l_mma_kernel): the same plan, staging, build and
// fields, the apply on the tensor cores.  For 16 target nodes u (M), 8
// source nodes v (K) and up to 8 cells of the item (N) one mma.sync
// m16n8k8 TF32 product adds D[u, cell] += sum_v T[u, v] W[cell, v]; each
// operand is split by tf32_split (tf32.cuh) into big + small, and three
// products T_big W_big + T_big W_small + T_small W_big sum in fp32: about
// 2^-21 of each term (the dropped T_small W_small and the remainders)
// where murb_tpu's bf16x3 carries 2^-16, so the tier's contract (its
// error against float64 no larger than murb_tpu's bf16x3 kernel's) holds
// with room.  An item of 9 to 16 cells takes two N tiles.  The port's K7
// builds each signed offset's T(o) itself (no mirror pairs), so no
// product reads a transpose.  A block owns kM2LTargets target nodes as
// kM2LMmaTiles M tiles by kM2LMmaSlices source slices, a warp one (tile,
// slice); each lane builds its A fragment's 4 entries T(o)[u, v] in
// registers (one rsqrt.approx.ftz each) and splits them, and reads its B
// fragment (the cells' weights, a padded stride so the 8 cells' rows fall
// on distinct banks) from the staged chunk.  The slices' sums go into the
// tile's fields in slice order, then out as the fp32 instance's.  Pad
// sources (kM2LFar, weight 0) and cells past the item's count (weight 0)
// add exact zeros: T of a pad is finite and its split too.  Bound: the
// build's fp32 work and its MUFU rsqrt, and 3 TF32 products of 2 nf flops
// per node pair at the tensor rate; mma.sync reaches about a quarter of
// that rate (mxu.cu), and an item's N tile of 8 cells runs whole for
// fewer, so at C = 2 (items of 1 to 8 cells) the tensor work is up to 8
// times the useful work.
#include <cuda_runtime.h>

#include "cell_runs.cuh"
#include "sweep.cuh"
#include "tf32.cuh"

namespace murb {

constexpr int kGridMaxOrder = kRunMaxOrder;
constexpr int kGridMaxCells = 16;       // C, cells per dimension
constexpr int kGridMaxTotalFields = 11;
constexpr int kM2LTargets = 128;        // target nodes u a K7 block
constexpr int kM2LSlices = 4;           // source-node slices a block
constexpr int kM2LThreads = kM2LTargets * kM2LSlices;
constexpr int kM2LSliceNodes = 64;      // source nodes of a slice a chunk
constexpr int kM2LChunk = kM2LSlices * kM2LSliceNodes;
constexpr int kM2LGroup = 16;           // target cells an item
constexpr int kM2LItemInts = 8 + 2 * kM2LGroup;  // M2L_ITEM_INTS
constexpr int kM2LRowInts = 12;         // ops/fmm_kernels.M2L_ROW_INTS
constexpr int kM2LMaxSplit = 64;
constexpr int kM2LMaxTileCells = 64;    // target cells of a cell tile
// a padded source node: far enough that its T is finite and tiny, and its
// weight is 0, so it adds exactly 0
constexpr float kM2LFar = 1e18f;
// K7's lossy instance: M tiles of 16 target nodes a block, source slices
// (a warp a (tile, slice)), a slice's nodes a chunk, and the row stride of
// a cell's staged weights (+4: the B fragment's 8 cells on distinct banks)
constexpr int kM2LMmaTiles = kM2LTargets / 16;
constexpr int kM2LMmaSlices = kM2LThreads / 32 / kM2LMmaTiles;
constexpr int kM2LMmaSliceNodes = kM2LChunk / kM2LMmaSlices;
constexpr int kM2LMmaStride = kM2LChunk + 4;
static_assert(kM2LMmaSlices * kM2LMmaTiles * 32 == kM2LThreads,
              "a warp a (tile, slice)");
static_assert(kM2LGroup <= 16, "an item fills at most two N tiles of 8");

// Dynamic shared memory of K7's nf-field kernel: its tile's fields.
constexpr int m2l_fields_bytes(int nf) {
  return nf * kM2LMaxTileCells * kM2LTargets * 4;
}

// ------------------------------------------------------------------ K7
// One chunk of source nodes: their coordinates (unshifted; the offset's
// shift goes into the target's) and the item's cells' weights.
struct M2LChunk {
  float x[kM2LChunk], y[kM2LChunk], z[kM2LChunk];
  float w[kM2LGroup][kM2LChunk];
};

struct M2LShared {
  M2LChunk chunk[2];
  float node[3][kGridMaxOrder];  // h_l,d cos(pi (i + 1/2) / m)
};

// The lossy instance's: the weights' rows at kM2LMmaStride.
struct M2LMmaChunk {
  float x[kM2LChunk], y[kM2LChunk], z[kM2LChunk];
  float w[kM2LGroup][kM2LMmaStride];
};

struct M2LMmaShared {
  M2LMmaChunk chunk[2];
  float node[3][kGridMaxOrder];
};

// Stage chunk c (source nodes [c kM2LChunk, (c + 1) kM2LChunk)) of item
// `it` into `st`: the weights of the item's cells by cp.async (zero past
// m^3), the coordinates computed (kM2LFar past m^3).  Every thread of the
// block calls it; it commits one cp.async group.  Chunk and Shared:
// M2LChunk and M2LShared, or the lossy instance's.
template <class Chunk, class Shared>
__device__ __forceinline__ void m2l_stage(Chunk& st, const Shared& sh,
                                          const int* __restrict__ item,
                                          const float* __restrict__ w, int m,
                                          int m3, int c) {
  const int v0 = c * kM2LChunk;
  const int tid = threadIdx.x;
  if (tid < kM2LChunk) {
    const int v = v0 + tid;
    const bool real = v < m3;
    const int vv = real ? v : 0;
    st.x[tid] = real ? sh.node[0][vv / (m * m)] : kM2LFar;
    st.y[tid] = real ? sh.node[1][(vv / m) % m] : kM2LFar;
    st.z[tid] = real ? sh.node[2][vv % m] : kM2LFar;
  }
  const int olin = item[3], ncell = item[4];
  for (int e = tid; e < ncell * kM2LChunk; e += kM2LThreads) {
    const int k = e / kM2LChunk, j = e % kM2LChunk, v = v0 + j;
    const bool real = v < m3;
    const long long src =
        static_cast<long long>(item[8 + k] + olin) * m3 + (real ? v : 0);
    cp_async4(&st.w[k][j], w + src, real);
  }
  cp_async_commit();
}

// Add a thread's sums of the item's cells k = K0, K0 + kM2LSlices, ... to
// the tile's fields (`local`: the cells' indices in the tile).
template <int K0, int MG, int NF>
__device__ __forceinline__ void m2l_add(const float (&acc)[MG][NF],
                                        float* fields, const int* local,
                                        int tcells, int ut) {
#pragma unroll
  for (int k = K0; k < MG; k += kM2LSlices) {
    float* o = fields + local[k] * kM2LTargets + ut;
#pragma unroll
    for (int f = 0; f < NF; ++f) o[f * tcells * kM2LTargets] += acc[k][f];
  }
}

// One item: MG target cells (its count), NF fields.  `buf` is the buffer
// that holds (or is receiving) the item's chunk 0; on return it holds the
// next item's chunk 0 when there is a next item (`next`, or null).  The
// item's sums go into `fields` (the tile's, in shared memory: [NF][tile
// cells][kM2LTargets]).
template <int MG, int NF>
__device__ __forceinline__ void m2l_item(
    M2LShared& sh, float* fields, int tcells, int& buf,
    const int* __restrict__ item, const int* __restrict__ next,
    const float* __restrict__ w, int m, int m3, float pux, float puy,
    float puz, float soft2) {
  const int s = threadIdx.x / kM2LTargets, ut = threadIdx.x % kM2LTargets;
  const int nch = (m3 + kM2LChunk - 1) / kM2LChunk;
  float acc[MG][NF];
#pragma unroll
  for (int k = 0; k < MG; ++k)
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[k][f] = 0.f;
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_all();  // this thread's copies of chunk c landed
    __syncthreads();      // everyone's did; the other buffer is free
    if (c + 1 < nch)
      m2l_stage(sh.chunk[buf ^ 1], sh, item, w, m, m3, c + 1);
    else if (next != nullptr)
      m2l_stage(sh.chunk[buf ^ 1], sh, next, w, m, m3, 0);
    const M2LChunk& st = sh.chunk[buf];
    // this slice's source nodes of the chunk, whole groups of 4 past m^3
    // (padded: they add 0) dropped
    const int j0 = s * kM2LSliceNodes;
    const int j1 = min(j0 + kM2LSliceNodes, (m3 - c * kM2LChunk + 3) & ~3);
#pragma unroll 1
    for (int j = j0; j < j1; j += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(&st.x[j]);
      const float4 y4 = *reinterpret_cast<const float4*>(&st.y[j]);
      const float4 z4 = *reinterpret_cast<const float4*>(&st.z[j]);
      const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
      const float ys[4] = {y4.x, y4.y, y4.z, y4.w};
      const float zs[4] = {z4.x, z4.y, z4.z, z4.w};
      float t[4][NF];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float dx = xs[q] - pux, dy = ys[q] - puy, dz = zs[q] - puz;
        const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft2)));
        const float inv = rsqrt_ftz(d2);
        const float inv3 = inv * inv * inv;
        t[q][0] = dx * inv3;
        t[q][1] = dy * inv3;
        t[q][2] = dz * inv3;
        if constexpr (NF == 4) t[q][3] = inv;
      }
#pragma unroll
      for (int k = 0; k < MG; ++k) {
        const float4 w4 = *reinterpret_cast<const float4*>(&st.w[k][j]);
        const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int f = 0; f < NF; ++f)
            acc[k][f] = fmaf(t[q][f], ws[q], acc[k][f]);
      }
    }
    buf ^= 1;
  }
  // The slices' sums into the tile's fields, in kM2LSlices turns: in turn
  // r slice s adds its cells k with k = s + r (mod kM2LSlices), so every
  // slice works in every turn, and cell k receives the slices k, k - 1,
  // ... (mod kM2LSlices) in that order, every launch.
  static_assert(kM2LSlices <= 4, "the turns below name 4 cell classes");
  const int* local = item + 8 + kM2LGroup;
  for (int r = 0; r < kM2LSlices; ++r) {
    if (r > 0) __syncthreads();  // turn r - 1's adds are stored
    switch ((s + r) % kM2LSlices) {
      case 0: m2l_add<0>(acc, fields, local, tcells, ut); break;
      case 1: m2l_add<1>(acc, fields, local, tcells, ut); break;
      case 2: m2l_add<2>(acc, fields, local, tcells, ut); break;
      default: m2l_add<3>(acc, fields, local, tcells, ut); break;
    }
  }
}

// A K7 block's start: the level's node table into `node`, its tile's
// fields zeroed, and a barrier.  Returns the tile's cell count.
template <int NF>
__device__ __forceinline__ int m2l_begin(float (&node)[3][kGridMaxOrder],
                                         float* fields, const int* row,
                                         const float* __restrict__ hl,
                                         int m) {
  const int nx = row[4] - row[3], ny = row[6] - row[5], nz = row[8] - row[7];
  const int tcells = nx * ny * nz;
  const int tid = threadIdx.x;
  if (tid < 3 * m) {
    const int d = tid / m, i = tid % m;
    node[d][i] = hl[d] * static_cast<float>(cos(kPi * (i + 0.5) / m));
  }
  for (int e = tid; e < NF * tcells * kM2LTargets; e += kM2LThreads)
    fields[e] = 0.f;
  __syncthreads();  // the node table and the zeros are stored
  return tcells;
}

// A K7 block's end: wait for the last copies and adds, then store the
// tile's fields of the block's target nodes into the output (nsplit > 1:
// the row's split of the scratch).
template <int NF>
__device__ __forceinline__ void m2l_end(const float* fields, const int* row,
                                        int C, int m3, int nsplit,
                                        float* __restrict__ out) {
  cp_async_wait_all();
  __syncthreads();  // the last item's turns are stored
  const long long cells = static_cast<long long>(C) * C * C;
  const int ny = row[6] - row[5], nz = row[8] - row[7];
  const int tcells = (row[4] - row[3]) * ny * nz;
  const int tid = threadIdx.x, ut = tid % kM2LTargets;
  const int u = blockIdx.x * kM2LTargets + ut;
  const bool own = u < m3;
  float* dst = out + (nsplit > 1 ? row[2] * NF * cells * m3 : 0);
  const long long plane = cells * m3;
  for (int e = tid / kM2LTargets; e < NF * tcells && own; e += kM2LSlices) {
    const int f = e / tcells, k = e % tcells;
    const int ix = row[3] + k / (ny * nz), iy = row[5] + (k / nz) % ny,
              iz = row[7] + k % nz;
    dst[f * plane + ((ix * C + iy) * C + iz) * static_cast<long long>(m3) +
        u] = fields[e * kM2LTargets + ut];
  }
}

// grid (ceil(m^3 / kM2LTargets), rows), kM2LThreads threads,
// m2l_fields_bytes(NF) bytes of dynamic shared memory.  Row y = rows[y *
// kM2LRowInts ...]: {first item, end, split, x0, x1, y0, y1, z0, z1}.  The
// block keeps the fields of its tile's cells for its target nodes in
// shared memory, runs its items, and stores the fields once (nsplit > 1:
// into dst = partial + split * NF C^3 m^3; else into the output).
template <int NF>
__global__ void __launch_bounds__(kM2LThreads, 1)
m2l_kernel(const float* __restrict__ w, const float* __restrict__ hl,
           float soft2, int m, int C, const int* __restrict__ items,
           const int* __restrict__ rows, int nsplit,
           float* __restrict__ out) {
  __shared__ __align__(16) M2LShared sh;
  extern __shared__ __align__(16) float fields[];  // [NF][tcells][targets]
  const int* row = rows + blockIdx.y * kM2LRowInts;
  const int first = row[0], end = row[1];
  const int m3 = m * m * m;
  const int tcells = m2l_begin<NF>(sh.node, fields, row, hl, m);
  const int tid = threadIdx.x;
  const int ut = tid % kM2LTargets;
  const int u = blockIdx.x * kM2LTargets + ut;
  const bool own = u < m3;
  const int uu = own ? u : 0;
  const float pux = sh.node[0][uu / (m * m)];
  const float puy = sh.node[1][(uu / m) % m];
  const float puz = sh.node[2][uu % m];
  int buf = 0;
  if (first < end)
    m2l_stage(sh.chunk[0], sh, items + first * kM2LItemInts, w, m, m3, 0);
  for (int it = first; it < end; ++it) {
    const int* item = items + it * kM2LItemInts;
    const int* next = it + 1 < end ? item + kM2LItemInts : nullptr;
    // the target node relative to the shift 2 h_l o of the item's offset
    const float sx = pux - 2.f * hl[0] * static_cast<float>(item[0]);
    const float sy = puy - 2.f * hl[1] * static_cast<float>(item[1]);
    const float sz = puz - 2.f * hl[2] * static_cast<float>(item[2]);
    switch (item[4]) {
#define MURB_M2L_CASE(G)                                                    \
  case G:                                                                   \
    if constexpr (G <= kM2LGroup)                                           \
      m2l_item<G, NF>(sh, fields, tcells, buf, item, next, w, m, m3, sx,    \
                      sy, sz, soft2);                                       \
    break;
      MURB_M2L_CASE(1) MURB_M2L_CASE(2) MURB_M2L_CASE(3) MURB_M2L_CASE(4)
      MURB_M2L_CASE(5) MURB_M2L_CASE(6) MURB_M2L_CASE(7) MURB_M2L_CASE(8)
      MURB_M2L_CASE(9) MURB_M2L_CASE(10) MURB_M2L_CASE(11)
      MURB_M2L_CASE(12) MURB_M2L_CASE(13) MURB_M2L_CASE(14)
      MURB_M2L_CASE(15) MURB_M2L_CASE(16)
#undef MURB_M2L_CASE
      default: break;  // the wrapper's plan holds 1..kM2LGroup cells
    }
  }
  m2l_end<NF>(fields, row, C, m3, nsplit, out);
}

// ------------------------------------------------- K7's lossy instance
// One item: its cells in NT N tiles of 8 (NT = 1 up to 8 cells, else 2),
// NF fields, 3xTF32 products (the note at the top).  `buf`, `next` and
// `fields` as in m2l_item; (px, py, pz)[h]: the lane's target node u0 + g
// + 8 h relative to the item's shift.
template <int NT, int NF>
__device__ __forceinline__ void m2l_mma_item(
    M2LMmaShared& sh, float* fields, int tcells, int& buf,
    const int* __restrict__ item, const int* __restrict__ next,
    const float* __restrict__ w, int m, int m3, const float (&px)[2],
    const float (&py)[2], const float (&pz)[2], float soft2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % kM2LMmaTiles, s = warp / kM2LMmaTiles;
  const int ncell = item[4];
  const int nch = (m3 + kM2LChunk - 1) / kM2LChunk;
  float acc[NT][NF][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][f][e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_all();  // this thread's copies of chunk c landed
    __syncthreads();      // everyone's did; the other buffer is free
    if (c + 1 < nch)
      m2l_stage(sh.chunk[buf ^ 1], sh, item, w, m, m3, c + 1);
    else if (next != nullptr)
      m2l_stage(sh.chunk[buf ^ 1], sh, next, w, m, m3, 0);
    const M2LMmaChunk& st = sh.chunk[buf];
    // this slice's source nodes of the chunk, whole groups of 8 past m^3
    // (padded: they add 0) dropped
    const int j0 = s * kM2LMmaSliceNodes;
    const int j1 =
        min(j0 + kM2LMmaSliceNodes, (m3 - c * kM2LChunk + 7) & ~7);
#pragma unroll 1
    for (int j = j0; j < j1; j += 8) {
      // A: T[u, v] at (row g + 8 (q & 1), col t + 4 (q >> 1)), split
      float tb[NF][4], ts[NF][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1, v = j + t + 4 * (q >> 1);
        const float dx = st.x[v] - px[h], dy = st.y[v] - py[h],
                    dz = st.z[v] - pz[h];
        const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft2)));
        const float inv = rsqrt_ftz(d2);
        const float inv3 = inv * inv * inv;
        tf32_split(dx * inv3, tb[0][q], ts[0][q]);
        tf32_split(dy * inv3, tb[1][q], ts[1][q]);
        tf32_split(dz * inv3, tb[2][q], ts[2][q]);
        if constexpr (NF == 4) tf32_split(inv, tb[3][q], ts[3][q]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // B: W[cell nt 8 + g, v] at (row t, col g) and (row t + 4, col g)
        const int k = nt * 8 + g;
        const bool real = k < ncell;
        float wb0, ws0, wb1, ws1;
        tf32_split(real ? st.w[k][j + t] : 0.f, wb0, ws0);
        tf32_split(real ? st.w[k][j + t + 4] : 0.f, wb1, ws1);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          mma_tf32(acc[nt][f], tb[f][0], tb[f][1], tb[f][2], tb[f][3], wb0,
                   wb1);
          mma_tf32(acc[nt][f], tb[f][0], tb[f][1], tb[f][2], tb[f][3], ws0,
                   ws1);
          mma_tf32(acc[nt][f], ts[f][0], ts[f][1], ts[f][2], ts[f][3], wb0,
                   wb1);
        }
      }
    }
    buf ^= 1;
  }
  // The slices' sums into the tile's fields, slice 0 first: a lane holds
  // D at (u0 + g + 8 (e >> 1), cell nt 8 + 2 t + (e & 1)).
  const int* local = item + 8 + kM2LGroup;
  float* base = fields + mt * 16 + g;
  for (int r = 0; r < kM2LMmaSlices; ++r) {
    if (r > 0) __syncthreads();  // slice r - 1's adds are stored
    if (s != r) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = nt * 8 + 2 * t + e;
        if (k >= ncell) continue;
        float* o = base + local[k] * kM2LTargets;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          o[f * tcells * kM2LTargets] += acc[nt][f][e];
          o[f * tcells * kM2LTargets + 8] += acc[nt][f][2 + e];
        }
      }
  }
}

// The lossy instance: m2l_kernel's grid, threads, rows, fields and output,
// the items' apply by m2l_mma_item.
template <int NF>
__global__ void __launch_bounds__(kM2LThreads, 1)
m2l_mma_kernel(const float* __restrict__ w, const float* __restrict__ hl,
               float soft2, int m, int C, const int* __restrict__ items,
               const int* __restrict__ rows, int nsplit,
               float* __restrict__ out) {
  __shared__ __align__(16) M2LMmaShared sh;
  extern __shared__ __align__(16) float fields[];  // [NF][tcells][targets]
  const int* row = rows + blockIdx.y * kM2LRowInts;
  const int first = row[0], end = row[1];
  const int m3 = m * m * m;
  const int tcells = m2l_begin<NF>(sh.node, fields, row, hl, m);
  const int g = (threadIdx.x & 31) >> 2;
  const int mt = (threadIdx.x >> 5) % kM2LMmaTiles;
  float pux[2], puy[2], puz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = blockIdx.x * kM2LTargets + mt * 16 + g + 8 * h;
    const int uu = u < m3 ? u : 0;  // past m^3: computed, never stored
    pux[h] = sh.node[0][uu / (m * m)];
    puy[h] = sh.node[1][(uu / m) % m];
    puz[h] = sh.node[2][uu % m];
  }
  int buf = 0;
  if (first < end)
    m2l_stage(sh.chunk[0], sh, items + first * kM2LItemInts, w, m, m3, 0);
  for (int it = first; it < end; ++it) {
    const int* item = items + it * kM2LItemInts;
    const int* next = it + 1 < end ? item + kM2LItemInts : nullptr;
    // the target nodes relative to the shift 2 h_l o of the item's offset
    float sx[2], sy[2], sz[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sx[h] = pux[h] - 2.f * hl[0] * static_cast<float>(item[0]);
      sy[h] = puy[h] - 2.f * hl[1] * static_cast<float>(item[1]);
      sz[h] = puz[h] - 2.f * hl[2] * static_cast<float>(item[2]);
    }
    if (item[4] <= 8)
      m2l_mma_item<1, NF>(sh, fields, tcells, buf, item, next, w, m, m3, sx,
                          sy, sz, soft2);
    else
      m2l_mma_item<2, NF>(sh, fields, tcells, buf, item, next, w, m, m3, sx,
                          sy, sz, soft2);
  }
  m2l_end<NF>(fields, row, C, m3, nsplit, out);
}

using M2LKernel = void (*)(const float*, const float*, float, int, int,
                           const int*, const int*, int, float*);

// K7's kernel for nf fields: the fp32 instance, or the lossy one.
inline M2LKernel m2l_pick(bool lossy, int nf) {
  if (lossy) return nf == 4 ? m2l_mma_kernel<4> : m2l_mma_kernel<3>;
  return nf == 4 ? m2l_kernel<4> : m2l_kernel<3>;
}

// Let a K7 kernel of nf fields take its fields' dynamic shared memory
// (above the 48 KB default) on the current device.
inline cudaError_t m2l_allow_fields(M2LKernel kernel, int nf) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              m2l_fields_bytes(nf));
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

// K7 (the fp32 instance, or the lossy one): the sweep, then with nsplit >
// 1 the splits' sum.  The C entries' arguments.
inline int m2l_level(bool lossy, const float* w, const float* hl,
                     float soft2, int m, int C, int nf, const int* items,
                     const int* rows, int nrows, int nsplit, float* partial,
                     float* out, cudaStream_t stream) {
  if (!grid_ok(m, C) || (nf != 3 && nf != 4) || nrows < 1 ||
      nrows > 65535 || nsplit < 1 || nsplit > kM2LMaxSplit ||
      (nsplit > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int m3 = m * m * m, ncell = C * C * C;
  const dim3 grid((m3 + kM2LTargets - 1) / kM2LTargets, nrows);
  const M2LKernel kernel = m2l_pick(lossy, nf);
  cudaError_t err = m2l_allow_fields(kernel, nf);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kM2LThreads, m2l_fields_bytes(nf), stream>>>(
      w, hl, soft2, m, C, items, rows, nsplit, nsplit > 1 ? partial : out);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(nf) * ncell * m3;
  sum_splits_kernel<<<static_cast<int>((count + 255) / 256), 256, 0,
                      stream>>>(partial, nsplit, count, out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a K7 kernel of nf fields one SM of the current device holds.
inline int m2l_resident(bool lossy, int nf, int* blocks) {
  if (nf != 3 && nf != 4) return static_cast<int>(cudaErrorInvalidValue);
  const M2LKernel kernel = m2l_pick(lossy, nf);
  cudaError_t err = m2l_allow_fields(kernel, nf);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kM2LThreads, m2l_fields_bytes(nf)));
}

}  // namespace murb

// K8.  box: [lo(3), cs(3)]; perm: the bodies ordered by cell; bounds: C^3 +
// 1 offsets into perm; prefix: C^3 + 1 offsets of each cell's work items of
// `chunk` bodies; nitems: the items (at least prefix[C^3]); table: the
// node table of order m; partial: nitems * m^3 floats of scratch, or null
// when no cell has two items (w zeroed by the caller); w: (C^3, m^3).
extern "C" int murb_p2m_grid(const float* qx, const float* qy,
                             const float* qz, const float* gm,
                             const long long* perm, const float* box, int m,
                             int C, const long long* bounds,
                             const long long* prefix, int nitems, int chunk,
                             const float* table, float* partial, float* w,
                             cudaStream_t stream) {
  if (!murb::grid_ok(m, C)) return static_cast<int>(cudaErrorInvalidValue);
  return murb::p2m_runs(qx, qy, qz, gm, murb::CellRuns{perm, C}, box, m,
                        C * C * C, bounds, prefix, nitems, chunk, table,
                        partial, w, stream);
}

// K9.  fields: k device pointers (a host array) to (C^3, m^3) fields; out:
// (k, n) in the bodies' own order; prefix: work items of L2PGeom<MW>::kItem
// bodies.  One launch per group of at most kRunFields fields.
extern "C" int murb_l2p_grid(const float* qx, const float* qy,
                             const float* qz, const long long* perm, int n,
                             const float* box, int m, int C,
                             const long long* bounds, const long long* prefix,
                             int nitems, const float* table,
                             const float* const* fields, int k, float* out,
                             cudaStream_t stream) {
  if (!murb::grid_ok(m, C) || k < 1 || k > murb::kGridMaxTotalFields)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ncell = C * C * C;
  for (int f0 = 0; f0 < k; f0 += murb::kRunFields) {
    const int kg = k - f0 < murb::kRunFields ? k - f0 : murb::kRunFields;
    const int err = murb::l2p_runs(
        qx, qy, qz, murb::CellRuns{perm, C}, n, box, m, ncell, bounds,
        prefix, nitems, table, fields + f0, kg,
        out + static_cast<long long>(f0) * n, stream);
    if (err != 0) return err;
  }
  return 0;
}

// K7.  w: (C^3, m^3) level expansions; hl: the level's cell half-widths (3,)
// in device memory; nf: 3 (force) or 4 (force and potential); items:
// (n, kM2LItemInts) and rows: (nrows, kM2LRowInts) int32 in device memory,
// the plan of ops/fmm_kernels.m2l_plan (nrows = cell tiles x nsplit); out:
// (nf, C^3, m^3); partial: nsplit * nf * C^3 * m^3 floats of scratch when
// nsplit > 1 (unused, may be null, when nsplit == 1).
extern "C" int murb_m2l_level(const float* w, const float* hl, float soft2,
                              int m, int C, int nf, const int* items,
                              const int* rows, int nrows, int nsplit,
                              float* partial, float* out,
                              cudaStream_t stream) {
  return murb::m2l_level(false, w, hl, soft2, m, C, nf, items, rows, nrows,
                         nsplit, partial, out, stream);
}

// K7's lossy instance (3xTF32 tensor-core products), the same arguments;
// its plan is made for its own resident blocks (murb_m2l_resident_lossy).
extern "C" int murb_m2l_level_lossy(const float* w, const float* hl,
                                    float soft2, int m, int C, int nf,
                                    const int* items, const int* rows,
                                    int nrows, int nsplit, float* partial,
                                    float* out, cudaStream_t stream) {
  return murb::m2l_level(true, w, hl, soft2, m, C, nf, items, rows, nrows,
                         nsplit, partial, out, stream);
}

// K8 (l2p 0) and K9 (l2p 1) at order m: the blocks one SM of the current
// device holds at once and the threads a block.
extern "C" int murb_runs_resident(int m, int l2p, int* blocks,
                                  int* threads) {
  return murb::runs_resident<murb::CellRuns>(m, l2p != 0, blocks, threads);
}

// Blocks of K7's nf-field kernel one SM of the current device holds at
// once, into *blocks (ops/fmm_kernels.m2l_slots sizes the split with it).
extern "C" int murb_m2l_resident(int nf, int* blocks) {
  return murb::m2l_resident(false, nf, blocks);
}

// The same for K7's lossy instance.
extern "C" int murb_m2l_resident_lossy(int nf, int* blocks) {
  return murb::m2l_resident(true, nf, blocks);
}
