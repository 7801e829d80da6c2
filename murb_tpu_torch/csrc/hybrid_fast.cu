// K4's one-pass fast tier (passes 1, the tpu+hybrid+fast engine).
//
// Replaces the TPU kernel murb_tpu/ops/hybrid.py:_hybrid_kernel at
// passes == 1 (hybrid.py:105-106: W rounded to bf16 once, one MXU pass).
// What carries over is that tier's contract, not its bf16 Dekker splits:
// W rounded once, one pass of the j-reduction on the matrix unit, a max
// relative force error of at most 5.1e-3 on the N=4096 galaxy
// (tests/test_oracle.py:162-165) and the reference's trajectory
// tolerances.  The structure is the TPU kernel's own, moved to the H100's
// tensor cores:
//
//   CUDA cores:   dx = x_j - x_i, ... ; d2 = |d|^2 + eps^2 (fmas, exact
//                 fp32 as K3's chain); W = rsqrt.approx.ftz(d2)^3, rounded
//                 to TF32 (half a TF32 ulp added to the bits; the tensor
//                 core reads the 19 high bits, so the sum is rounded to
//                 nearest, ties away, as cvt.rna)
//   tensor cores: P[i, :] += W[i, j] Q[j, :], mma.sync m16n8k8 TF32, with
//                 Q's eight columns G m_j (x_j - c, y_j - c, z_j - c, 1)
//                 split into big = tf32(v) and small = tf32(v - big)
//   epilogue:     a_i = P[0:3] - (r_i - c) P[3]
//
// c is the sources' G*m-weighted mean (sweep.cuh's weighted_center_kernel,
// one block summing in fp64 in a fixed order: the same c every run).  The
// rounding of W scales a whole pair term in both P[0:3] and P[3], so the
// epilogue's cancellation does not amplify it: the tier's error is about
// 2^-11 a weight (murb_tpu's bf16 W: 2^-9).  Q's split keeps its columns
// to 2^-22, so the terms the epilogue cancels against carry fp32's
// accuracy (murb_tpu splits its A_p in two for the same reason,
// hybrid.py:84-91).  P sums in fp32 partials of kFastPart chunks (128
// sources) added to the running P in order: the tensor core's long
// accumulation chains truncate, and short partials keep that below the
// tier's W rounding.
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32): lane =
// 4 g + t holds A's (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// B's (row t, col g), (t + 4, g); C's (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).  A chunk's K runs over its 8 sources in the order 0, 2,
// 4, 6, 1, 3, 5, 7, so lane (g, t) computes W of targets g and g + 8 at
// sources 2t and 2t + 1, exactly its A fragment, with no shuffle, and its
// B fragment is column g of those two sources, one 8-byte load.  A warp
// owns kFastTiles m16 tiles (64 targets), so each staged chunk feeds 16
// pair weights a lane and 4 products.
//
// The sources are packed once a call (hybrid_fast_pack_kernel, kFastChunk
// floats a chunk of 8: eight {x, y, z, 0} float4 and 32 float2 B
// fragments), padded with zero-mass sources at c to kFastPackSources.  The
// sweep stages BJ sources a tile into dynamic shared memory with cp.async,
// double-buffered, one barrier a tile.  Where the target blocks do not
// fill the card the j tiles split into slices (ops/cuda.tile_split with
// this kernel's resident count), each slice writes its four P columns to a
// (slices, 4, ni) scratch, and hybrid_fast_fold_kernel adds them in slice
// order and applies the epilogue once: the same bits every run.
//
// What bounds it on an H100: instruction issue.  A pair costs 3 FADD, 3
// FFMA, 2 FMUL, one integer add and the MUFU rsqrt's slot, and a sixteenth
// of a chunk's 2 LDS.128, 1 LDS.64 and 4 HMMA a lane: about 10.4 issue
// slots where K3 spends about 12.25 (its three accumulate fmas and the G m
// multiply moved to the tensor cores, one m16n8k8 product for 128 pairs).
// Its issue floor is 12.5 ms at 200,192^2 and 1.98 GHz, above the MUFU's
// 9.58 ms (one rsqrt a pair, 16 a clock an SM).
//
// bf16 state: murb_hybrid_fast_bf16 reads the state's bf16 arrays; the
// pack kernel converts each source value to fp32 as it loads it (exact)
// and the sweep each target's, so on the arrays upcast it gives the fp32
// instance's bits.
#include "sweep.cuh"
#include "tf32.cuh"

namespace murb {

constexpr int kFastBlockI = 256;      // default targets a block
constexpr int kFastBlockJ = 256;      // and sources a staged tile
constexpr int kFastTiles = 4;         // m16 target tiles a warp
constexpr int kFastWarpTargets = 16 * kFastTiles;
constexpr int kFastChunk = 96;        // floats of a packed chunk of 8
constexpr int kFastPackSources = 512;  // the packed sources' padding
constexpr int kFastPart = 16;         // chunks a P partial sums

// One thread a (chunk c, lane 4 g + t): the B fragment of sources 8c + 2t
// and 8c + 2t + 1 (column g: G m (x - c, y - c, z - c, 1), big for g < 4,
// small for g >= 4), and, for lanes 0-7, source 8c + lane's position.
// Sources past nj are zero-mass sources at c.
template <class TB>
__global__ void hybrid_fast_pack_kernel(
    const TB* __restrict__ qxj, const TB* __restrict__ qyj,
    const TB* __restrict__ qzj, const TB* __restrict__ gmj, int nj,
    const float* __restrict__ center, int chunks,
    float* __restrict__ packed) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 32LL * chunks) return;
  const int c = static_cast<int>(idx >> 5), lane = idx & 31;
  const int g = lane >> 2, t = lane & 3;
  const float cx = center[0], cy = center[1], cz = center[2];
  float* chunk = packed + static_cast<long long>(c) * kFastChunk;
  if (lane < 8) {
    const int j = 8 * c + lane;
    const bool real = j < nj;
    reinterpret_cast<float4*>(chunk)[lane] = make_float4(
        real ? body_f32(qxj[j]) : cx, real ? body_f32(qyj[j]) : cy,
        real ? body_f32(qzj[j]) : cz, 0.f);
  }
  float q[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = 8 * c + 2 * t + e;
    float v = 0.f;
    if (j < nj) {
      const int comp = g & 3;
      const float gm = body_f32(gmj[j]);
      const float cq = comp == 0 ? __fsub_rn(body_f32(qxj[j]), cx)
                       : comp == 1 ? __fsub_rn(body_f32(qyj[j]), cy)
                                   : __fsub_rn(body_f32(qzj[j]), cz);
      v = comp == 3 ? gm : __fmul_rn(gm, cq);
    }
    float big, small;
    tf32_split(v, big, small);
    q[e] = g < 4 ? big : small;
  }
  reinterpret_cast<float2*>(chunk + 32)[lane] = make_float2(q[0], q[1]);
}

// W of one target against one staged source, TF32-rounded: the TF32
// value's bits (the 13 low bits the tensor core ignores included).
__device__ __forceinline__ float fast_weight(float4 s, float xi, float yi,
                                             float zi, float soft2) {
  const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
  const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, soft2)));
  const float inv = rsqrt_ftz(d2);
  const float w = __fmul_rn(__fmul_rn(inv, inv), inv);
  return __uint_as_float(__float_as_uint(w) + 0x1000u);
}

// grid (ceil(ni / BI), S), BI / 2 threads (BI / 64 warps of kFastTiles m16
// tiles).  Slice blockIdx.y sweeps tiles [y * tiles_per_slice, min((y + 1)
// * tiles_per_slice, ceil(nj / BJ))).  With S == 1 the accelerations go to
// ax/ay/az, else P's columns (G m (x - c), G m (y - c), G m (z - c), G m)
// to scratch[(y * 4 + k) * ni + i].
template <int BI, int BJ, class TB>
__global__ void __launch_bounds__(BI / 2)
hybrid_fast_kernel(const float* __restrict__ packed, int nj,
                   const TB* __restrict__ qxi, const TB* __restrict__ qyi,
                   const TB* __restrict__ qzi, int ni,
                   const float* __restrict__ center, float soft2,
                   int tiles_per_slice, float* __restrict__ ax,
                   float* __restrict__ ay, float* __restrict__ az,
                   float* __restrict__ scratch) {
  static_assert(BI % kFastWarpTargets == 0 && BJ % 8 == 0, "geometry");
  constexpr int RT = kFastTiles;
  constexpr int CH = BJ / 8;                   // chunks a tile
  constexpr int TILE = CH * kFastChunk;        // floats a tile
  constexpr int PART = CH < kFastPart ? CH : kFastPart;
  extern __shared__ __align__(16) float smem[];  // two tiles
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int base = blockIdx.x * BI + (threadIdx.x >> 5) * kFastWarpTargets;
  const long long si = ni;
  const float cx = center[0], cy = center[1], cz = center[2];

  // targets g and g + 8 of each m16 tile (targets past ni sit at c)
  float xi[RT][2], yi[RT][2], zi[RT][2];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = base + 16 * r + g + 8 * h;
      const bool own = i < ni;
      xi[r][h] = own ? body_f32(qxi[i]) : cx;
      yi[r][h] = own ? body_f32(qyi[i]) : cy;
      zi[r][h] = own ? body_f32(qzi[i]) : cz;
    }

  const int tiles = (nj + BJ - 1) / BJ;
  const int t0 = blockIdx.y * tiles_per_slice;
  const int t1 = min(t0 + tiles_per_slice, tiles);
  auto stage = [&](int tile, float* buf) {
    const float* src = packed + static_cast<long long>(tile) * TILE;
    for (int u = threadIdx.x; u < TILE / 4; u += BI / 2)
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
        const float* ch = buf + c * kFastChunk;
        const float4 s0 = reinterpret_cast<const float4*>(ch)[2 * t];
        const float4 s1 = reinterpret_cast<const float4*>(ch)[2 * t + 1];
        const float2 qv = reinterpret_cast<const float2*>(ch + 32)[lane];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          // A: (g, K t) = source 2t, (g + 8, t), (g, t + 4) = source
          // 2t + 1, (g + 8, t + 4)
          const float a0 = fast_weight(s0, xi[r][0], yi[r][0], zi[r][0],
                                       soft2);
          const float a1 = fast_weight(s0, xi[r][1], yi[r][1], zi[r][1],
                                       soft2);
          const float a2 = fast_weight(s1, xi[r][0], yi[r][0], zi[r][0],
                                       soft2);
          const float a3 = fast_weight(s1, xi[r][1], yi[r][1], zi[r][1],
                                       soft2);
          mma_tf32(pt[r], a0, a1, a2, a3, qv.x, qv.y);
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
        ax[i] = __fsub_rn(v[2 * h], __fmul_rn(__fsub_rn(xi[r][h], cx), gm));
        ay[i] = __fsub_rn(v[2 * h + 1],
                          __fmul_rn(__fsub_rn(yi[r][h], cy), gm));
      } else {
        az[i] = __fsub_rn(v[2 * h],
                          __fmul_rn(__fsub_rn(zi[r][h], cz), v[2 * h + 1]));
      }
    }
  }
}

// The slices' P columns, added in slice order, and the epilogue:
// a_k[i] = sum_y P_k - (r_k[i] - c_k) sum_y P_3.
template <class TB>
__global__ void hybrid_fast_fold_kernel(const float* __restrict__ scratch,
                                        int slices, int ni,
                                        const TB* __restrict__ qxi,
                                        const TB* __restrict__ qyi,
                                        const TB* __restrict__ qzi,
                                        const float* __restrict__ center,
                                        float* __restrict__ ax,
                                        float* __restrict__ ay,
                                        float* __restrict__ az) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ni) return;
  const long long n = ni;
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  for (int y = 0; y < slices; ++y)
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] += scratch[(y * 4 + k) * n + i];
  ax[i] = __fsub_rn(p[0], __fmul_rn(__fsub_rn(body_f32(qxi[i]), center[0]),
                                    p[3]));
  ay[i] = __fsub_rn(p[1], __fmul_rn(__fsub_rn(body_f32(qyi[i]), center[1]),
                                    p[3]));
  az[i] = __fsub_rn(p[2], __fmul_rn(__fsub_rn(body_f32(qzi[i]), center[2]),
                                    p[3]));
}

template <int BJ>
constexpr int fast_smem_bytes() {
  return 2 * (BJ / 8) * kFastChunk * static_cast<int>(sizeof(float));
}

template <int BI, int BJ, class TB>
int fast_prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      hybrid_fast_kernel<BI, BJ, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, fast_smem_bytes<BJ>()));
}

// The centre, the pack, the sweep at (block_i, block_j) in `slices` j
// slices of `tiles_per_slice` tiles, and the fold when slices > 1.
// packed: ceil(nj / kFastPackSources) * kFastPackSources / 8 * kFastChunk
// floats; scratch: (slices, 4, ni) floats when slices > 1; center: 3 floats
// of device scratch, written here.  Returns the cudaError_t of the
// launches.
template <class TB>
int hybrid_fast_launch(const TB* qxi, const TB* qyi, const TB* qzi, int ni,
                       const TB* qxj, const TB* qyj, const TB* qzj,
                       const TB* gmj, int nj, float* center,
                       float soft2, int block_i, int block_j, int slices,
                       int tiles_per_slice, float* packed, float* scratch,
                       float* ax, float* ay, float* az,
                       cudaStream_t stream) {
  if (nj < 0 || slices < 1 || slices > 65535 || tiles_per_slice < 0 ||
      (slices > 1 && scratch == nullptr) || center == nullptr ||
      (nj > 0 && packed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ni <= 0) return 0;
  weighted_center_kernel<TB, false><<<1, kCenterThreads, 0, stream>>>(
      qxj, qyj, qzj, gmj, nj, center);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int chunks = (nj + kFastPackSources - 1) / kFastPackSources *
                     (kFastPackSources / 8);
  if (chunks > 0) {
    const long long threads = 32LL * chunks;
    hybrid_fast_pack_kernel<TB>
        <<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
            qxj, qyj, qzj, gmj, nj, center, chunks, packed);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return with_blocks(
      block_i, block_j, kFastBlockI, kFastBlockJ, [&](auto bic, auto bjc) {
        constexpr int BI = decltype(bic)::value, BJ = decltype(bjc)::value;
        const long long tiles = (nj + BJ - 1) / BJ;
        if (static_cast<long long>(slices) * tiles_per_slice < tiles ||
            (slices > 1 &&
             static_cast<long long>(slices - 1) * tiles_per_slice >= tiles))
          return static_cast<int>(cudaErrorInvalidValue);
        int err = fast_prepare<BI, BJ, TB>();
        if (err != 0) return err;
        const dim3 grid((ni + BI - 1) / BI, slices);
        hybrid_fast_kernel<BI, BJ, TB>
            <<<grid, BI / 2, fast_smem_bytes<BJ>(), stream>>>(
                packed, nj, qxi, qyi, qzi, ni, center, soft2,
                tiles_per_slice, ax, ay, az, scratch);
        err = static_cast<int>(cudaGetLastError());
        if (err != 0 || slices == 1) return err;
        hybrid_fast_fold_kernel<TB><<<(ni + 255) / 256, 256, 0, stream>>>(
            scratch, slices, ni, qxi, qyi, qzi, center, ax, ay, az);
        return static_cast<int>(cudaGetLastError());
      });
}

template <class TB>
int hybrid_fast_resident(int block_i, int block_j, int* blocks) {
  return with_blocks(
      block_i, block_j, kFastBlockI, kFastBlockJ, [&](auto bic, auto bjc) {
        constexpr int BI = decltype(bic)::value, BJ = decltype(bjc)::value;
        const int err = fast_prepare<BI, BJ, TB>();
        if (err != 0) return err;
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, hybrid_fast_kernel<BI, BJ, TB>, BI / 2,
            fast_smem_bytes<BJ>()));
      });
}

}  // namespace murb

// K4 passes 1: ni targets (qxi, qyi, qzi) against nj sources (qxj, qyj,
// qzj, gmj) about the sources' centre, written to `center` (3 floats of
// device scratch).
// block_i, block_j: 0 (256 x 256) or a pair of {64, 128, 256, 512};
// slices, tiles_per_slice, scratch: the j split (ops/cuda.tile_split with
// murb_hybrid_fast_resident), scratch (slices, 4, ni) floats when slices >
// 1; packed: the packed sources (ops/hybrid.FAST_CHUNK_FLOATS floats a
// chunk of 8, nj padded to FAST_PACK_SOURCES).
extern "C" int murb_hybrid_fast(const float* qxi, const float* qyi,
                                const float* qzi, int ni, const float* qxj,
                                const float* qyj, const float* qzj,
                                const float* gmj, int nj, float* center,
                                float soft2,
                                int block_i, int block_j, int slices,
                                int tiles_per_slice, float* scratch,
                                float* packed, float* ax, float* ay,
                                float* az, cudaStream_t stream) {
  return murb::hybrid_fast_launch(qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj,
                                  center, soft2, block_i, block_j, slices,
                                  tiles_per_slice, packed, scratch, ax, ay,
                                  az, stream);
}

// The bf16 instance: murb_hybrid_fast's arguments with the seven body
// arrays bf16.
extern "C" int murb_hybrid_fast_bf16(
    const __nv_bfloat16* qxi, const __nv_bfloat16* qyi,
    const __nv_bfloat16* qzi, int ni, const __nv_bfloat16* qxj,
    const __nv_bfloat16* qyj, const __nv_bfloat16* qzj,
    const __nv_bfloat16* gmj, int nj, float* center, float soft2,
    int block_i, int block_j, int slices, int tiles_per_slice, float* scratch,
    float* packed, float* ax, float* ay, float* az, cudaStream_t stream) {
  return murb::hybrid_fast_launch(qxi, qyi, qzi, ni, qxj, qyj, qzj, gmj, nj,
                                  center, soft2, block_i, block_j, slices,
                                  tiles_per_slice, packed, scratch, ax, ay,
                                  az, stream);
}

// Blocks of the sweep at (block_i, block_j) one SM of the current device
// holds at once, into *blocks: the wrapper's j split counts the card's
// slots with it.
extern "C" int murb_hybrid_fast_resident(int block_i, int block_j,
                                         int* blocks) {
  return murb::hybrid_fast_resident<float>(block_i, block_j, blocks);
}

extern "C" int murb_hybrid_fast_resident_bf16(int block_i, int block_j,
                                              int* blocks) {
  return murb::hybrid_fast_resident<__nv_bfloat16>(block_i, block_j,
                                                   blocks);
}
