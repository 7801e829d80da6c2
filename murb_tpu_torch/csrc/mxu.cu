// K13: the norm-expansion all-pairs sweep (the tpu+mxu engine) on the
// tensor cores.
//
// Replaces the TPU kernel murb_tpu/ops/mxu.py:_mxu_kernel (pallas_call at
// mxu.py:159; entries acc_mxu_rect :96 and acc_mxu :193).  murb_tpu centres
// the coordinates on the G*m-weighted mean (cq = q - c) and packs the
// operands as mxu.py:132-142 does, with jnp ops outside its kernel:
//
//   A (8, nj): rows cqx_j, cqy_j, cqz_j, |cq_j|^2, 1, 0, 0, 0
//   B (8, ni): rows -2 cqx_i, -2 cqy_i, -2 cqz_i, 1, |cq_i|^2 + eps^2, 0, 0, 0
//
// Here that build runs in the kernels, from the bodies as they are (float,
// or bf16 for a bf16 state: murb_mxu_rect_bf16): weighted_center_kernel
// (sweep.cuh) forms c in fp64 (c = sum G m r / max(sum G m, 1), murb_tpu's
// rule, rounded once to fp32) unless the caller gives c, mxu_pack_kernel
// forms A's columns and Q from the sources, and the sweep forms B's from
// the targets in registers.  Each value is formed as the plain version's
// torch ops form it (ops/mxu._operands: fp32, every operation rounded, no
// contraction), so for a bf16 state the kernel reads 2 bytes a value and
// forms no fp32 copy, and gives the fp32 instance's bits on the values
// upcast.  (The centre sets the sums' bits: an fp32 reduction in another
// order gives other bits at the same error.)
//
// This kernel computes, for every target i,
//
//   S[i,j] = A[:,j] . B[:,i]          = |r_j - r_i|^2 + eps^2
//   W[i,j] = rsqrt(S[i,j])^3
//   P[i,:] = sum_j W[i,j] Q[j,:]      Q[j,:] = G m_j (cq_j, 1)
//   a_i    = P[i,0:3] - cq_i * P[i,3]
//
// (murb_tpu's W = G m_j rsqrt(S)^3 against A; G m_j is folded into Q here,
// which saves a multiply a pair.)  Self-pairs stay in the sum and cancel in
// the epilogue, as on the TPU.
//
// S and P are TF32 tensor-core products, mma.sync.m16n8k8 (PTX ISA,
// "Matrix Fragments for mma.m16n8k8", .tf32): in a warp, lane = 4 g + t
// holds A's (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B's
// (row t, col g), (t + 4, g); C's (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
//
//   * S product, M = 16 targets, N = 8 sources, K = 8 rows, twice.  Every
//     value is split into big = tf32(x) and small = tf32(x - big) (round to
//     nearest, ties away), and the two products hold every term of the
//     expansion with both sides split:
//       sources [x_b, y_b, z_b, x_s, y_s, z_s, n_b, 1] and [... n_s, 1]
//       targets [bx_b, by_b, bz_b, bx_b, by_b, bz_b, 1, nB_b] and the same
//               of the small parts
//     (n = |cq_j|^2, nB = |cq_i|^2 + eps^2: the large terms whose rounding
//     close pairs cancel against).  The targets' fragments live in
//     registers for the whole sweep.
//   * P product, M = 16 targets, N = 8 columns, K = 8 sources: Q's columns
//     are G m (x, y, z, 1) big, then small, so one product gives
//     W (Q_b + Q_s); "high" adds W_s (Q_b + Q_s).  P's K runs over the
//     chunk's sources in the order 0, 2, 4, 6, 1, 3, 5, 7: lane (g, t)
//     then needs W at sources 2t and 2t + 1 of targets g and g + 8, which
//     are exactly S's accumulators in that lane, so W goes from the S
//     product's accumulator registers to the P product's operand registers
//     with no shuffle; the lane's B fragment is column g of sources 2t and
//     2t + 1, a contiguous pair.
//   * W = rsqrt.approx.ftz(S)^3 (S >= eps^2 > 0, never denormal), W_b =
//     tf32(W) by integer rounding (two integer ops, the same bits as
//     cvt.rna), W_s = W - W_b (exact) read by the tensor core as TF32,
//     which ignores its 13 low bits.  A pair costs one MUFU op, two FMUL,
//     two integer ops and, at "high", one FSUB.
//
// The sources are split once a call: mxu_pack_kernel writes each chunk of 8
// sources as the two fragments its lanes read (kChunkFloats floats: 32 float4
// (R_t, R1_{t+4}, R2_{t+4}, 0) for S, 32 float2 for P), padded with zero-mass
// sources at the centre to kPackSources (S = nB_i > 0, Q = 0). The main kernel
// stages BJ sources a tile into shared memory with cp.async, double-buffered,
// and reads one 16-byte and one 8-byte fragment a chunk, conflict-free.  A
// warp owns kMxuTiles m16 tiles (32 targets; BI targets a block are BI / 32
// warps), so each staged fragment feeds two independent chains.  (Two other
// arrangements of S, nB as the first product's accumulator with an m16n8k4 or
// a second m16n8k8 for the small parts, timed 2 to 5% slower in turns, but
// each from a build of its own, and two builds of one source differ by as
// much: the comparison is unresolved.)  P is summed into fp32 partials of
// kPartChunks chunks that are added to the running P in order: a fixed
// order, no atomics, the same bits every run.  Targets past ni compute on a
// zero row (nB = 1) and store nothing.  Where the grid is under the card's
// resident slots the j tiles are split into slices (grid.y;
// ops/cuda.tile_split with this kernel's resident blocks), each slice writes
// its four P columns to a (slices, 4, ni) scratch, and mxu_fold_kernel adds
// the slices in order and applies the epilogue once, so the epilogue's
// cancellation is that of one sum.
//
// What bounds it on an H100: the tensor pipe at mma.sync's rate.  At
// 200,192^2 "default" (three m16n8k8 products a 16 x 8 tile) takes three
// quarters of the time of "high" (four) at every geometry
// (scripts/torch_kernel_ab.py), so the products, not the MUFU, set the
// pace: an m16n8k8 TF32 product issues about once every 16 clocks on an SM
// sub-partition, a quarter of the dense TF32 peak that wgmma reaches.
// Next come the MUFU rsqrt (N^2 at 16 a clock an SM, 9.6 ms at 200,192^2
// and 1.98 GHz) and instruction issue (about 6 slots a pair).  Device
// memory traffic is O(ni + nj).
#include "sweep.cuh"
#include "tf32.cuh"

namespace murb {

constexpr int kMxuBlockI = 512;   // K13's default targets a block
constexpr int kMxuBlockJ = 512;   // and sources a staged tile
constexpr int kMxuTiles = 2;      // m16 target tiles a warp
constexpr int kChunkFloats = 192;  // one chunk of 8 packed sources
constexpr int kPackSources = 512;  // the packed sources' padding
// chunks a P partial sums before it joins the running P: 128 sources, so
// the fp32 partials stay as short at 512 sources a tile as at 128
constexpr int kPartChunks = 16;

// A body's centred coordinates q - c and their squared norm, each
// operation rounded on its own as the plain version's torch ops round it
// ((x^2 + y^2) + z^2, no contraction).
struct Centred {
  float x, y, z, n;
};

template <class TB>
__device__ __forceinline__ Centred centred(const TB* __restrict__ qx,
                                           const TB* __restrict__ qy,
                                           const TB* __restrict__ qz, int i,
                                           float cx, float cy, float cz) {
  const float x = __fsub_rn(body_f32(qx[i]), cx);
  const float y = __fsub_rn(body_f32(qy[i]), cy);
  const float z = __fsub_rn(body_f32(qz[i]), cz);
  return {x, y, z,
          __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                    __fmul_rn(z, z))};
}

// One thread a (chunk c, lane 4 g + t): the S fragment of source 8c + g
// (rows t and t + 4 of both products) and the P fragment of sources
// 8c + 2t and 8c + 2t + 1 (column g), formed from the bodies and the
// centre.  Sources past nj are zero-mass sources at the centre.
template <class TB>
__global__ void mxu_pack_kernel(const TB* __restrict__ qxj,
                                const TB* __restrict__ qyj,
                                const TB* __restrict__ qzj,
                                const TB* __restrict__ gmj, int nj,
                                const float* __restrict__ center, int chunks,
                                float* __restrict__ packed) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 32LL * chunks) return;
  const int c = static_cast<int>(idx >> 5), lane = idx & 31;
  const int g = lane >> 2, t = lane & 3;
  const float cx = center[0], cy = center[1], cz = center[2];
  const int j = 8 * c + g;
  Centred a = {0.f, 0.f, 0.f, 0.f};
  if (j < nj) a = centred(qxj, qyj, qzj, j, cx, cy, cz);
  float xb, xs, yb, ys, zb, zs, nb, ns;
  tf32_split(a.x, xb, xs);
  tf32_split(a.y, yb, ys);
  tf32_split(a.z, zb, zs);
  tf32_split(a.n, nb, ns);
  // rows: R[t] = x_b, y_b, z_b, x_s; R1[t + 4] = y_s, z_s, n_b, 1;
  // R2[t + 4] = y_s, z_s, n_s, 1
  const float r_t = t == 0 ? xb : t == 1 ? yb : t == 2 ? zb : xs;
  const float r1 = t == 0 ? ys : t == 1 ? zs : t == 2 ? nb : 1.f;
  const float r2 = t == 0 ? ys : t == 1 ? zs : t == 2 ? ns : 1.f;
  const int comp = g & 3;  // columns G m (x, y, z, 1), big then small
  const TB* qc = comp == 0 ? qxj : comp == 1 ? qyj : qzj;
  const float cc = comp == 0 ? cx : comp == 1 ? cy : cz;
  float q[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int jj = 8 * c + 2 * t + e;
    float v = 0.f;
    if (jj < nj) {
      const float gm = body_f32(gmj[jj]);
      v = comp == 3 ? gm : __fmul_rn(gm, __fsub_rn(body_f32(qc[jj]), cc));
    }
    float big, small;
    tf32_split(v, big, small);
    q[e] = g < 4 ? big : small;
  }
  float* chunk = packed + static_cast<long long>(c) * kChunkFloats;
  reinterpret_cast<float4*>(chunk)[lane] = make_float4(r_t, r1, r2, 0.f);
  reinterpret_cast<float2*>(chunk + 128)[lane] = make_float2(q[0], q[1]);
}

// grid (ceil(ni / BI), S), BI threads (BI / 32 warps of kMxuTiles m16 tiles),
// at most 64 registers a thread so that an SM holds 1024 threads at every BI.
// Slice blockIdx.y sweeps tiles [y * tiles_per_slice, min((y + 1) *
// tiles_per_slice, ceil(nj / BJ))).  NP: TF32 products on P (1 or 2).  With
// S == 1 the accelerations go to ax/ay/az, else P's columns (G m x, G m y,
// G m z, G m; the small half added) to scratch[(y * 4 + c) * ni + i].  The
// targets' B columns and cq come from their bodies (TB) and the centre.
template <int BI, int BJ, int NP, class TB>
__global__ void __launch_bounds__(BI, 1024 / BI)
mxu_mma_kernel(const float* __restrict__ packed, int nj,
               const TB* __restrict__ qxi, const TB* __restrict__ qyi,
               const TB* __restrict__ qzi, int ni,
               const float* __restrict__ center, float soft2,
               int tiles_per_slice, float* __restrict__ ax,
               float* __restrict__ ay, float* __restrict__ az,
               float* __restrict__ scratch) {
  constexpr int RT = kMxuTiles;
  constexpr int CH = BJ / 8;                     // chunks a tile
  constexpr int TILE = CH * kChunkFloats;        // floats a tile
  constexpr int PART = CH < kPartChunks ? CH : kPartChunks;
  extern __shared__ __align__(16) float smem[];  // two tiles
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int base = blockIdx.x * BI + (threadIdx.x >> 5) * 16 * RT;
  const long long si = ni;

  // the targets' S fragments: T1 (big) and T2 (small) rows t and t + 4 of
  // targets g and g + 8 of each m16 tile
  float a1[RT][4], a2[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = base + 16 * r + g + 8 * h;
      // B's column: -2 cq, |cq|^2 + eps^2; a target past ni a zero row
      // with nB = 1
      float bx = 0.f, by = 0.f, bz = 0.f, nb = 1.f;
      if (i < ni) {
        const Centred q =
            centred(qxi, qyi, qzi, i, center[0], center[1], center[2]);
        bx = __fmul_rn(-2.f, q.x);
        by = __fmul_rn(-2.f, q.y);
        bz = __fmul_rn(-2.f, q.z);
        nb = __fadd_rn(q.n, soft2);
      }
      float bxb, bxs, byb, bys, bzb, bzs, nbb, nbs;
      tf32_split(bx, bxb, bxs);
      tf32_split(by, byb, bys);
      tf32_split(bz, bzb, bzs);
      tf32_split(nb, nbb, nbs);
      // T[t] = bx, by, bz, bx; T[t + 4] = by, bz, 1, nB
      a1[r][h] = t == 0 ? bxb : t == 1 ? byb : t == 2 ? bzb : bxb;
      a2[r][h] = t == 0 ? bxs : t == 1 ? bys : t == 2 ? bzs : bxs;
      a1[r][2 + h] = t == 0 ? byb : t == 1 ? bzb : t == 2 ? 1.f : nbb;
      a2[r][2 + h] = t == 0 ? bys : t == 1 ? bzs : t == 2 ? 1.f : nbs;
    }
  }

  const int tiles = (nj + BJ - 1) / BJ;
  const int t0 = blockIdx.y * tiles_per_slice;
  const int t1 = min(t0 + tiles_per_slice, tiles);
  auto stage = [&](int tile, float* buf) {
    const float* src = packed + static_cast<long long>(tile) * TILE;
    for (int u = threadIdx.x; u < TILE / 4; u += BI)
      cp_async16(buf + 4 * u, src + 4 * u);
    cp_async_commit();
  };
  float tot[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[r][e] = 0.f;
  if (t0 < t1) stage(t0, smem);
  for (int tile = t0; tile < t1; ++tile) {
    cp_async_wait_all();  // this thread's copies of the tile landed
    __syncthreads();      // everyone's did; the other buffer is free
    if (tile + 1 < t1) stage(tile + 1, smem + ((tile + 1 - t0) & 1) * TILE);
    const float* buf = smem + ((tile - t0) & 1) * TILE;
    for (int c0 = 0; c0 < CH; c0 += PART) {
      float pt[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[r][e] = 0.f;
#pragma unroll 2
      for (int c = c0; c < c0 + PART; ++c) {
        const float4 sv =
            reinterpret_cast<const float4*>(buf + c * kChunkFloats)[lane];
        const float2 qv = reinterpret_cast<const float2*>(
            buf + c * kChunkFloats + 128)[lane];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float s[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(s, a1[r][0], a1[r][1], a1[r][2], a1[r][3], sv.x, sv.y);
          mma_tf32(s, a2[r][0], a2[r][1], a2[r][2], a2[r][3], sv.x, sv.z);
          // s: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1); P's A
          // fragment: (g, K t) = source 2t, (g + 8, t), (g, t + 4) = source
          // 2t + 1, (g + 8, t + 4)
          float wb[4], ws[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float inv = rsqrt_ftz(s[e]);
            const float w = __fmul_rn(__fmul_rn(inv, inv), inv);
            wb[e] = tf32_rna(w);
            ws[e] = __fsub_rn(w, wb[e]);
          }
          mma_tf32(pt[r], wb[0], wb[2], wb[1], wb[3], qv.x, qv.y);
          if (NP == 2)
            mma_tf32(pt[r], ws[0], ws[2], ws[1], ws[3], qv.x, qv.y);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[r][e] += pt[r][e];
    }
  }

  // epilogue: lane t holds P columns 2t, 2t + 1 of targets g, g + 8; the
  // small half (t = 2, 3) joins the big (t = 0, 1), then lane t = 0 (x, y)
  // takes the column G m from lane t = 1 (z, G m)
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float v[4], m[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = tot[r][e] + __shfl_xor_sync(0xffffffffu, tot[r][e], 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e] = __shfl_xor_sync(0xffffffffu, v[e], 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = base + 16 * r + g + 8 * h;
      if (i >= ni || t > 1) continue;
      if (gridDim.y > 1) {  // lane t = 0: columns 0, 1; t = 1: 2, 3
        float* out = scratch + (blockIdx.y * 4 + 2 * t) * si + i;
        out[0] = v[2 * h];
        out[si] = v[2 * h + 1];
      } else if (t == 0) {
        const float gm = m[2 * h + 1];
        ax[i] = v[2 * h] - __fsub_rn(body_f32(qxi[i]), center[0]) * gm;
        ay[i] = v[2 * h + 1] - __fsub_rn(body_f32(qyi[i]), center[1]) * gm;
      } else {
        az[i] = v[2 * h] -
                __fsub_rn(body_f32(qzi[i]), center[2]) * v[2 * h + 1];
      }
    }
  }
}

// The slices' P columns, added in slice order, and the epilogue:
// a_c[i] = sum_y P_c - cq_c[i] sum_y P_3.
template <class TB>
__global__ void mxu_fold_kernel(const float* __restrict__ scratch,
                                int slices, int ni,
                                const TB* __restrict__ qxi,
                                const TB* __restrict__ qyi,
                                const TB* __restrict__ qzi,
                                const float* __restrict__ center,
                                float* __restrict__ ax, float* __restrict__ ay,
                                float* __restrict__ az) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ni) return;
  const long long n = ni;
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  for (int y = 0; y < slices; ++y)
#pragma unroll
    for (int c = 0; c < 4; ++c) p[c] += scratch[(y * 4 + c) * n + i];
  ax[i] = p[0] - __fsub_rn(body_f32(qxi[i]), center[0]) * p[3];
  ay[i] = p[1] - __fsub_rn(body_f32(qyi[i]), center[1]) * p[3];
  az[i] = p[2] - __fsub_rn(body_f32(qzi[i]), center[2]) * p[3];
}

template <int BI, int BJ, int NP, class TB>
int mxu_prepare() {
  constexpr int bytes = 2 * (BJ / 8) * kChunkFloats * sizeof(float);
  return static_cast<int>(cudaFuncSetAttribute(
      mxu_mma_kernel<BI, BJ, NP, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int BI, int BJ, int NP, class TB>
int mxu_sweep(dim3 grid, const float* packed, int nj, const TB* qxi,
              const TB* qyi, const TB* qzi, int ni, const float* center,
              float soft2, int tiles_per_slice, float* ax, float* ay,
              float* az, float* scratch, cudaStream_t stream) {
  constexpr int bytes = 2 * (BJ / 8) * kChunkFloats * sizeof(float);
  const int err = mxu_prepare<BI, BJ, NP, TB>();
  if (err != 0) return err;
  mxu_mma_kernel<BI, BJ, NP, TB><<<grid, BI, bytes, stream>>>(
      packed, nj, qxi, qyi, qzi, ni, center, soft2, tiles_per_slice, ax, ay,
      az, scratch);
  return static_cast<int>(cudaGetLastError());
}

// K13 on bodies of type TB (murb_mxu_rect's arguments).
template <class TB>
int mxu_rect(const TB* qxi, const TB* qyi, const TB* qzi, int ni,
             const TB* qxj, const TB* qyj, const TB* qzj, const TB* gmj,
             int nj, float soft2, int find_center, float* center,
             int block_i, int block_j, int p_passes, int slices,
             int tiles_per_slice, float* packed, float* scratch, float* ax,
             float* ay, float* az, cudaStream_t stream) {
  if (ni <= 0) return 0;
  if ((p_passes != 1 && p_passes != 2) || slices < 1 || slices > 65535 ||
      tiles_per_slice < 0 || (slices > 1 && scratch == nullptr) ||
      center == nullptr || (nj > 0 && packed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (find_center) {
    weighted_center_kernel<TB, true><<<1, kCenterThreads, 0, stream>>>(
        qxj, qyj, qzj, gmj, nj, center);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const int chunks = (nj + kPackSources - 1) / kPackSources *
                     (kPackSources / 8);
  if (chunks > 0) {
    const long long threads = 32LL * chunks;
    mxu_pack_kernel<TB><<<static_cast<unsigned>((threads + 255) / 256), 256,
                          0, stream>>>(qxj, qyj, qzj, gmj, nj, center,
                                       chunks, packed);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return with_blocks(
      block_i, block_j, kMxuBlockI, kMxuBlockJ, [&](auto bi, auto bj) {
        constexpr int BI = decltype(bi)::value, BJ = decltype(bj)::value;
        const long long tiles = (nj + BJ - 1) / BJ;
        if (static_cast<long long>(slices) * tiles_per_slice < tiles ||
            (slices > 1 &&
             static_cast<long long>(slices - 1) * tiles_per_slice >= tiles))
          return static_cast<int>(cudaErrorInvalidValue);
        const dim3 grid((ni + BI - 1) / BI, slices);
        const int err =
            p_passes == 1
                ? mxu_sweep<BI, BJ, 1, TB>(grid, packed, nj, qxi, qyi, qzi,
                                           ni, center, soft2,
                                           tiles_per_slice, ax, ay, az,
                                           scratch, stream)
                : mxu_sweep<BI, BJ, 2, TB>(grid, packed, nj, qxi, qyi, qzi,
                                           ni, center, soft2,
                                           tiles_per_slice, ax, ay, az,
                                           scratch, stream);
        if (err != 0 || slices == 1) return err;
        mxu_fold_kernel<TB><<<(ni + 255) / 256, 256, 0, stream>>>(
            scratch, slices, ni, qxi, qyi, qzi, center, ax, ay, az);
        return static_cast<int>(cudaGetLastError());
      });
}

// Blocks of K13's sweep ("high") at (block_i, block_j) that one SM of the
// current device holds at once, into *blocks.
template <class TB>
int mxu_resident(int block_i, int block_j, int* blocks) {
  return with_blocks(
      block_i, block_j, kMxuBlockI, kMxuBlockJ, [&](auto bi, auto bj) {
        constexpr int BI = decltype(bi)::value, BJ = decltype(bj)::value;
        constexpr int bytes = 2 * (BJ / 8) * kChunkFloats * 4;
        const int err = mxu_prepare<BI, BJ, 2, TB>();
        if (err != 0) return err;
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, mxu_mma_kernel<BI, BJ, 2, TB>, BI, bytes));
      });
}

}  // namespace murb

// qxi..qzi: the targets (ni,); qxj..qzj, gmj: the sources and their G*m
// (nj,).  center: 3 floats on the device; find_center != 0 writes the
// sources' centre there first (c = sum G m r / max(sum G m, 1), in fp64),
// else it holds the centre to use (the caller's point, or 0 uncentred).
// block_i, block_j: 0 (kMxuBlockI, kMxuBlockJ) or a pair of {64, 128,
// 256, 512}.  p_passes: TF32 products on P, 1 ("default") or 2 ("high",
// "highest").  slices, tiles_per_slice: the j split (ops/cuda.tile_split);
// slices > 1 needs scratch, (slices, 4, ni) floats.  packed:
// ceil(nj / kPackSources) * kPackSources / 8 * kChunkFloats floats,
// written here before the sweep reads them.
extern "C" int murb_mxu_rect(const float* qxi, const float* qyi,
                             const float* qzi, int ni, const float* qxj,
                             const float* qyj, const float* qzj,
                             const float* gmj, int nj, float soft2,
                             int find_center, float* center, int block_i,
                             int block_j, int p_passes, int slices,
                             int tiles_per_slice, float* packed,
                             float* scratch, float* ax, float* ay, float* az,
                             cudaStream_t stream) {
  return murb::mxu_rect<float>(qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj,
                               soft2, find_center, center, block_i, block_j,
                               p_passes, slices, tiles_per_slice, packed,
                               scratch, ax, ay, az, stream);
}

// The bf16 instance: murb_mxu_rect's arguments with the seven body arrays
// bf16 (the centre, packed sources, scratch and outputs float).
extern "C" int murb_mxu_rect_bf16(
    const __nv_bfloat16* qxi, const __nv_bfloat16* qyi,
    const __nv_bfloat16* qzi, int ni, const __nv_bfloat16* qxj,
    const __nv_bfloat16* qyj, const __nv_bfloat16* qzj,
    const __nv_bfloat16* gmj, int nj, float soft2, int find_center,
    float* center, int block_i, int block_j, int p_passes, int slices,
    int tiles_per_slice, float* packed, float* scratch, float* ax, float* ay,
    float* az, cudaStream_t stream) {
  return murb::mxu_rect<__nv_bfloat16>(
      qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj, soft2, find_center, center,
      block_i, block_j, p_passes, slices, tiles_per_slice, packed, scratch,
      ax, ay, az, stream);
}

// Blocks of K13's sweep ("high") at (block_i, block_j) that one SM of the
// current device holds at once, into *blocks: the wrapper's j split counts
// the card's slots with it (its own for the bf16 instance).
extern "C" int murb_mxu_resident(int block_i, int block_j, int* blocks) {
  return murb::mxu_resident<float>(block_i, block_j, blocks);
}

extern "C" int murb_mxu_resident_bf16(int block_i, int block_j,
                                      int* blocks) {
  return murb::mxu_resident<__nv_bfloat16>(block_i, block_j, blocks);
}
