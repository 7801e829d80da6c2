// K1 (P2M) and K2 (L2P): the anterpolation stages of the single-cell
// Chebyshev proxy solver (murb_tpu_torch/ops/proxy_kernels.py).
//
// Replace the TPU kernels murb_tpu/ops/proxy_pallas.py:_p2m_kernel
// (pallas_call at :154, entry p2m_fused :137) and _l2p_kernel (pallas_call
// at :209, entries l2p_fused_multi :185 and l2p_fused :224).
//
//   P2M: W[(u, v, w)] = sum_j gm_j Sx_j[u] Sy_j[v] Sz_j[w],
//   L2P: a_f[j] = sum_u Sx_j[u] sum_v Sy_j[v] sum_w Sz_j[w] F_f[(u, v, w)],
//
// with S_k(t) the Chebyshev Lagrange basis of order m at t = clip((q - c)
// / h) in the box [c, h] (a (6,) device array), for 1 to kMaxTotalFields
// node fields: the force (3) and up to 8 potential rows of the tracked
// paths.  Both take the node table from the wrapper and build each body's
// bases once with cell_runs.cuh's basis_span.  Work is N m^3 fmas (P2M)
// and N m^3 k (L2P), plus 3 m^2 a body for the bases; no atomics, every sum
// in a fixed order: the same bits on every run.
//
// K1 is cell_runs.cuh's P2M over one run of all n bodies in place (OneRun):
// the wrapper hands it the run's bounds {0, n} and prefix of work items
// {0, nitems}, built once per (n, m, device) (ops/proxy_kernels.one_run).
// An item of `chunk` bodies (ops/fmm_kernels.p2m_chunk: 256 at N = 200k,
// m = 12) writes its m^3 partials and the fold adds them, kRunFoldSplit
// lanes of items an output; a run of one item writes W itself.
//
// K2 is its own kernel, not cell_runs.cuh's L2P over the one run: every
// body reads the same fields, so a thread keeps its TB bodies' Sy and Sz
// rows in registers and reads the fields as broadcasts (one LDS.128 for 4
// TB fmas), where the run kernels' H = Sz.F tiles read each body's Sz row
// from shared memory and their epilogue each body's Sx and Sy rows once per
// field and chunk.  Per body and field the sums run t_v = sum_w F[u, v, w]
// Sz[w] (w in order), b_u = sum_v Sy[v] t_v, a = sum_u Sx[u] b_u, each one
// fp32 fma a term: the order of the run kernels' warp tier.  A block of
// kOneThreads threads owns kOneThreads TB bodies (body i of thread t: i
// kOneThreads + t, so loads and stores coalesce); the fields arrive kUC
// u-rows at a time by cp.async, double-buffered, all k fields of the
// launch in one chunk; each body's Sx row waits in shared memory, read
// once a u.  One launch per group of at most kRunFields fields.
#include <atomic>

#include <cuda_runtime.h>

#include "cell_runs.cuh"

namespace murb {

constexpr int kMaxTotalFields = 11;  // fields murb_l2p takes (3 + 8)
constexpr int kOneThreads = 128;     // K2: threads a block
constexpr int kOneMaxTBMW = 20;      // K2 takes 2 bodies a thread up to here

// K2's geometry at padded order MW and TB bodies a thread (their Sy and Sz
// rows in registers; 2 where the blocks fill the card, else 1: the
// wrapper's l2p_bodies): bodies a block, u-rows a field chunk, and the
// dynamic shared memory: the node table, two chunks of kRunFields fields,
// the Sx rows.
template <int MW, int TB>
struct OneL2PGeom {
  static_assert(TB == 1 || (TB == 2 && MW <= kOneMaxTBMW), "bodies a thread");
  static constexpr int kTB = TB;
  // blocks an SM the registers must allow: at MW <= 12 and 2 bodies a
  // thread six (80 registers), so the galaxy's 782 blocks run in one wave
  // on 132 SMs
  static constexpr int kMinBlocks = MW <= 12 && TB == 2 ? 6 : 1;
  static constexpr int kItem = kOneThreads * kTB;
  static constexpr int kUC = MW <= 16 ? 4 : 2;
  static constexpr int kChunk = kRunFields * kUC * MW * MW;  // floats
  static constexpr int kTab = (MW - 1) * MW;
  static constexpr int kDynBytes = 4 * (kTab + 2 * kChunk + MW * kItem);
  static_assert(kTab % 4 == 0 && kChunk % 4 == 0, "16-byte aligned parts");
};

template <int MW, int TB>
__global__ void __launch_bounds__(kOneThreads, OneL2PGeom<MW, TB>::kMinBlocks)
l2p_one_run_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                   const float* __restrict__ qz, int n,
                   const float* __restrict__ box, int m,
                   const float* __restrict__ node_table, RunFields fields,
                   int k, float* __restrict__ out) {
  using G = OneL2PGeom<MW, TB>;
  constexpr int UC = G::kUC;
  extern __shared__ __align__(16) float smem[];
  float* tab = smem;                   // the node table, stage_table's
  float* fbuf = tab + G::kTab;         // two chunks: Fc[f][ul][v][w]
  float* sxs = fbuf + 2 * G::kChunk;   // Sx rows: sxs[u kItem + body]
  const int tid = threadIdx.x;
  const long long j0 = static_cast<long long>(blockIdx.x) * G::kItem;

  // chunk c: rows u = c UC + ul of the k fields, zeros past m along v and w
  // (with Sy, Sz 0 past m their terms add exact zeros)
  auto stage_chunk = [&](int c, float* dst) {
    for (int idx = tid; idx < k * UC * MW * MW; idx += kOneThreads) {
      const int x = idx % MW, v = (idx / MW) % MW;
      const int u = c * UC + (idx / (MW * MW)) % UC;
      const int f = idx / (UC * MW * MW);
      const bool valid = u < m && v < m && x < m;
      cp_async4(dst + idx,
                fields.at(f) + (valid ? (u * m + v) * m + x : 0), valid);
    }
    cp_async_commit();
  };
  stage_chunk(0, fbuf);
  stage_table<MW>(tab, node_table, m, tid, kOneThreads);
  __syncthreads();

  const OneRun run{};
  const float cx = box[0], cy = box[1], cz = box[2];
  const float hx = box[3], hy = box[4], hz = box[5];
  float sy[TB][MW], sz[TB][MW];
  bool own[TB];
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    const long long j = j0 + i * kOneThreads + tid;
    own[i] = j < n;
    const float tx = own[i] ? run.coord(qx[j], cx, hx, 0) : 0.f;
    const float ty = own[i] ? run.coord(qy[j], cy, hy, 0) : 0.f;
    const float tz = own[i] ? run.coord(qz[j], cz, hz, 0) : 0.f;
    float sx[MW];
    basis_span<MW, MW>(tx, tab, m, 0, 1.f, sx);
#pragma unroll
    for (int u = 0; u < MW; ++u)
      sxs[u * G::kItem + i * kOneThreads + tid] = sx[u];
    basis_span<MW, MW>(ty, tab, m, 0, 1.f, sy[i]);
    basis_span<MW, MW>(tz, tab, m, 0, 1.f, sz[i]);
  }

  float acc[kRunFields][TB];
#pragma unroll
  for (int f = 0; f < kRunFields; ++f)
#pragma unroll
    for (int i = 0; i < TB; ++i) acc[f][i] = 0.f;
  const int nchunk = (m + UC - 1) / UC;
  for (int c = 0; c < nchunk; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c and the Sx rows visible; chunk c - 1 consumed
    if (c + 1 < nchunk)
      stage_chunk(c + 1, fbuf + ((c + 1) & 1) * G::kChunk);
    const float* fc = fbuf + (c & 1) * G::kChunk;
#pragma unroll 1
    for (int ul = 0; ul < UC; ++ul) {
      const int u = c * UC + ul;
      if (u >= m) break;
      float sxu[TB];
#pragma unroll
      for (int i = 0; i < TB; ++i)
        sxu[i] = sxs[u * G::kItem + i * kOneThreads + tid];
#pragma unroll
      for (int f = 0; f < kRunFields; ++f) {
        if (f < k) {
          float bu[TB];
#pragma unroll
          for (int i = 0; i < TB; ++i) bu[i] = 0.f;
#pragma unroll
          for (int v = 0; v < MW; ++v) {
            const float4* row = reinterpret_cast<const float4*>(
                fc + ((f * UC + ul) * MW + v) * MW);
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
            for (int i = 0; i < TB; ++i) bu[i] = fmaf(sy[i][v], t[i], bu[i]);
          }
#pragma unroll
          for (int i = 0; i < TB; ++i)
            acc[f][i] = fmaf(sxu[i], bu[i], acc[f][i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    if (own[i]) {
      const long long j = j0 + i * kOneThreads + tid;
#pragma unroll
      for (int f = 0; f < kRunFields; ++f)
        if (f < k) out[static_cast<long long>(f) * n + j] = acc[f][i];
    }
  }
}

// Lets K2 at (MW, TB) take its dynamic shared memory, once per device (as
// cell_runs.cuh's l2p_allow_smem, with internal linkage for the same
// reason).
namespace {
template <int MW, int TB>
cudaError_t one_run_allow_smem() {
  constexpr int kDevices = 64;
  static std::atomic<bool> done[kDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kDevices && done[dev].load())) return e;
  e = cudaFuncSetAttribute(l2p_one_run_kernel<MW, TB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           OneL2PGeom<MW, TB>::kDynBytes);
  if (e == cudaSuccess && dev < kDevices) done[dev].store(true);
  return e;
}
}  // namespace

// K2's blocks an SM at (MW, TB) (the CUDA occupancy calculator).
template <int MW, int TB>
cudaError_t one_run_resident(int* blocks) {
  const cudaError_t e = one_run_allow_smem<MW, TB>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, l2p_one_run_kernel<MW, TB>, kOneThreads,
      OneL2PGeom<MW, TB>::kDynBytes);
}

// K2 at MW with TB bodies a thread on the current device.
template <int MW, int TB>
cudaError_t l2p_one_run(const float* qx, const float* qy, const float* qz,
                        int n, const float* box, int m, const float* table,
                        const RunFields& fields, int k, float* out,
                        cudaStream_t stream) {
  using G = OneL2PGeom<MW, TB>;
  const cudaError_t e = one_run_allow_smem<MW, TB>();
  if (e != cudaSuccess) return e;
  l2p_one_run_kernel<MW, TB>
      <<<static_cast<int>((n + G::kItem - 1) / G::kItem), kOneThreads,
         G::kDynBytes, stream>>>(qx, qy, qz, n, box, m, table, fields, k,
                                 out);
  return cudaGetLastError();
}

}  // namespace murb

// K1.  box: [c(3), h(3)]; bounds: {0, n}; prefix: {0, items of `chunk`
// bodies}; nitems: at least prefix[1]; table: the node table of order m;
// partial: nitems * m^3 floats of scratch, or null when n <= chunk; w:
// m^3 floats.
extern "C" int murb_p2m(const float* qx, const float* qy, const float* qz,
                        const float* gm, int n, const float* box, int m,
                        const long long* bounds, const long long* prefix,
                        int nitems, int chunk, const float* table,
                        float* partial, float* w, cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return murb::p2m_runs(qx, qy, qz, gm, murb::OneRun{}, box, m, 1, bounds,
                        prefix, nitems, chunk, table, partial, w, stream);
}

// K2.  box: [c(3), h(3)]; tb: bodies a thread (1, or 2 at m <=
// kOneMaxTBMW); table: the node table of order m; fields: k device
// pointers (a host array) to (m^3,) fields; out: (k, n).  One launch per
// group of at most kRunFields fields.
extern "C" int murb_l2p(const float* qx, const float* qy, const float* qz,
                        int n, const float* box, int m, int tb,
                        const float* table, const float* const* fields,
                        int k, float* out, cudaStream_t stream) {
  if (m < 2 || m > murb::kRunMaxOrder || k < 1 ||
      k > murb::kMaxTotalFields || tb < 1 || tb > 2 ||
      (tb == 2 && (m + 3) / 4 * 4 > murb::kOneMaxTBMW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  for (int f0 = 0; f0 < k; f0 += murb::kRunFields) {
    const int kg = k - f0 < murb::kRunFields ? k - f0 : murb::kRunFields;
    murb::RunFields f{};
    for (int i = 0; i < murb::kRunFields; ++i)
      f.f[i] = fields[f0 + (i < kg ? i : 0)];
    float* og = out + static_cast<long long>(f0) * n;
    cudaError_t err = cudaSuccess;
#define MURB_L2P_ONE(MW)                                                   \
  {                                                                        \
    constexpr int kTB2 = MW <= murb::kOneMaxTBMW ? 2 : 1;                  \
    err = tb == 2 ? murb::l2p_one_run<MW, kTB2>(qx, qy, qz, n, box, m,     \
                                                table, f, kg, og, stream)  \
                  : murb::l2p_one_run<MW, 1>(qx, qy, qz, n, box, m, table, \
                                             f, kg, og, stream);           \
  }
    MURB_DISPATCH_MW(m, MURB_L2P_ONE)
#undef MURB_L2P_ONE
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The blocks of K1 (l2p 0) or K2 (l2p 1, tb bodies a thread) at order m
// that one SM holds at once (the CUDA occupancy calculator), and its
// threads a block.
extern "C" int murb_proxy_resident(int m, int l2p, int tb, int* blocks,
                                   int* threads) {
  if (m < 2 || m > murb::kRunMaxOrder || tb < 1 || tb > 2 ||
      (tb == 2 && (m + 3) / 4 * 4 > murb::kOneMaxTBMW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
#define MURB_PROXY_RESIDENT(MW)                                            \
  {                                                                        \
    constexpr int kTB2 = MW <= murb::kOneMaxTBMW ? 2 : 1;                  \
    if (!l2p) {                                                            \
      *threads = murb::P2MGeom<MW>::kThreads;                              \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
          blocks, murb::p2m_runs_kernel<MW, murb::OneRun>, *threads, 0);   \
    } else {                                                               \
      *threads = murb::kOneThreads;                                        \
      e = tb == 2 ? murb::one_run_resident<MW, kTB2>(blocks)               \
                  : murb::one_run_resident<MW, 1>(blocks);                 \
    }                                                                      \
  }
  MURB_DISPATCH_MW(m, MURB_PROXY_RESIDENT)
#undef MURB_PROXY_RESIDENT
  return static_cast<int>(e);
}
