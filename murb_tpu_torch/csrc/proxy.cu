// K1 (P2M) and K2 (L2P): the anterpolation stages of the single-cell
// Chebyshev proxy solver, with the interpolation bases rebuilt on chip.
//
// Replace the TPU kernels murb_tpu/ops/proxy_pallas.py:_p2m_kernel
// (pallas_call at :154, entry p2m_fused :137) and _l2p_kernel (pallas_call
// at :209, entries l2p_fused_multi :185 and l2p_fused :224).
//
// Both kernels take body coordinates and the box (device memory: center
// c[3], half-widths h[3]), and rebuild each body's per-dimension bases
//     S_k(t) = 1/m + (2/m) sum_{j=1}^{m-1} T_j(t) T_j(t_k),
//     t = clip((q - c) / h, -1, 1),  t_k = cos(pi (k + 1/2) / m),
// with the three-term recurrence for T_j(t) and a table of T_j(t_k) that
// each block computes itself in fp64 (the table murb_tpu builds on the
// host, proxy_pallas.py:_tj_nodes).  So, as on the TPU, the only device
// memory traffic is the coordinates in and the result out: the (N, m^2)
// combined basis never exists in device memory.
//
// P2M: W[u, v m + w] = sum_j gm_j Sx_j[u] Sy_j[v] Sz_j[w].  The TPU kernel
// carried W across a sequential grid in VMEM.  Blocks on Hopper run in
// parallel and in no order, so each block sums a fixed, strided set of
// body tiles into its own partial W in a scratch buffer, and a second
// kernel adds the partials in block order: no atomics, the same bits on
// every run.  A thread owns one (u, v) pair and the m outputs along w in
// registers; per body it does one multiply and m fmas, reading the body's
// Sz row from shared memory as a broadcast.  Orders up to kMaxOrder = 32
// (P = m^3 = 32,768 outputs per block) loop over (u, v) chunks.
// Bound: fp32 fma issue (N m^3 fmas); device memory traffic is O(N) plus
// the partials (grid * m^3 floats), which stay in L2 at the main-path m.
//
// L2P: a_f[i] = sum_u Sx_i[u] sum_{v,w} F_f[u, v m + w] Sy_i[v] Sz_i[w]
// for k <= 4 node fields per launch.  One thread per body holds its Sy and
// Sz rows in registers; the node fields are staged through shared memory
// one u-slice (k * m^2 floats, zero-padded to MW x MW) at a time, so m = 32
// fits, and every thread reads the slice as a broadcast.  Work is
// N m^3 k fmas; traffic is q in and k N floats out.  The tracked paths
// interpolate 3 + G fields (force, then one potential per galaxy, G <= 8):
// murb_l2p launches the kernel once per group of at most 4 fields.  A group
// rebuilds each body's bases (about 3 m^2 fmas, 1/8 of a 4-field group's
// contraction at m = 12), but the kernel keeps its 4-field register and
// shared-memory footprint: 11 fields in one launch would stage 45 KB a
// u-slice at m = 32 and hold 11 accumulators where the m = 32 variant
// already spills.
#include <cuda_runtime.h>

#include "cheb.cuh"

namespace murb {

constexpr int kMaxOrder = 32;
constexpr int kP2MTile = 64;        // bodies whose bases sit in shared memory
constexpr int kP2MMaxThreads = 256;
constexpr int kL2PThreads = 128;
constexpr int kMaxFields = 4;        // node fields one L2P launch takes
constexpr int kMaxTotalFields = 11;  // fields murb_l2p takes (3 + 8)

// ------------------------------------------------------------------ P2M
// MW: m rounded up to a multiple of 4 (the register width along w).
template <int MW>
__global__ void __launch_bounds__(kP2MMaxThreads)
p2m_partial_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                   const float* __restrict__ qz, const float* __restrict__ gm,
                   int n, const float* __restrict__ box, int m,
                   float* __restrict__ partial) {
  __shared__ float table[kMaxOrder * (kMaxOrder - 1)];
  __shared__ float gsx[kP2MTile * kMaxOrder];
  __shared__ float sy[kP2MTile * kMaxOrder];
  __shared__ __align__(16) float sz[kP2MTile * MW];

  fill_node_table(table, m);
  const float cx = box[0], cy = box[1], cz = box[2];
  const float hx = box[3], hy = box[4], hz = box[5];
  const int p2 = m * m;
  const long long p3 = static_cast<long long>(p2) * m;
  const int ntiles = (n + kP2MTile - 1) / kP2MTile;
  float* out = partial + static_cast<long long>(blockIdx.x) * p3;

  for (int uv0 = 0; uv0 < p2; uv0 += blockDim.x) {
    const int uv = uv0 + threadIdx.x;
    const bool active = uv < p2;
    const int u = active ? uv / m : 0;
    const int v = active ? uv % m : 0;
    float acc[MW];
#pragma unroll
    for (int w = 0; w < MW; ++w) acc[w] = 0.f;

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      __syncthreads();  // the node table is ready; the last tile is consumed
      const int b = threadIdx.x;
      if (b < kP2MTile) {
        const int j = tile * kP2MTile + b;
        const bool real = j < n;
        const float g = real ? gm[j] : 0.f;
        const float tx = scaled(real ? qx[j] : cx, cx, hx);
        const float ty = scaled(real ? qy[j] : cy, cy, hy);
        const float tz = scaled(real ? qz[j] : cz, cz, hz);
        for (int k = 0; k < m; ++k) {
          const float* row = table + k * (m - 1);
          gsx[b * kMaxOrder + k] = g * basis_value(tx, row, m);
          sy[b * kMaxOrder + k] = basis_value(ty, row, m);
        }
#pragma unroll
        for (int k = 0; k < MW; ++k)
          sz[b * MW + k] = k < m ? basis_value(tz, table + k * (m - 1), m)
                                 : 0.f;
      }
      __syncthreads();
      if (active) {
        for (int bb = 0; bb < kP2MTile; ++bb) {
          const float t = gsx[bb * kMaxOrder + u] * sy[bb * kMaxOrder + v];
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
        if (w < m) out[static_cast<long long>(u) * p2 + v * m + w] = acc[w];
    }
  }
}

// W[p] = sum over blocks of partial[b][p], in block order.
__global__ void p2m_reduce_kernel(const float* __restrict__ partial,
                                  int nblocks, long long p3,
                                  float* __restrict__ w) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= p3) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[b * p3 + p];
  w[p] = s;
}

// ------------------------------------------------------------------ L2P
template <int MW>
__global__ void __launch_bounds__(kL2PThreads)
l2p_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
           const float* __restrict__ qz, int n,
           const float* __restrict__ box, int m,
           const float* __restrict__ fmat, int k, float* __restrict__ out) {
  __shared__ float table[kMaxOrder * (kMaxOrder - 1)];
  __shared__ __align__(16) float slice[kMaxFields * MW * MW];

  fill_node_table(table, m);
  __syncthreads();
  const float cx = box[0], cy = box[1], cz = box[2];
  const float hx = box[3], hy = box[4], hz = box[5];
  const int i = blockIdx.x * kL2PThreads + threadIdx.x;
  const bool own = i < n;
  const float tx = scaled(own ? qx[i] : cx, cx, hx);
  const float ty = scaled(own ? qy[i] : cy, cy, hy);
  const float tz = scaled(own ? qz[i] : cz, cz, hz);
  float sy[MW], sz[MW];
#pragma unroll
  for (int c = 0; c < MW; ++c) {
    sy[c] = c < m ? basis_value(ty, table + c * (m - 1), m) : 0.f;
    sz[c] = c < m ? basis_value(tz, table + c * (m - 1), m) : 0.f;
  }
  const int p2 = m * m;
  float acc[kMaxFields] = {0.f, 0.f, 0.f, 0.f};

  for (int u = 0; u < m; ++u) {
    __syncthreads();  // the previous slice is consumed
    for (int idx = threadIdx.x; idx < kMaxFields * MW * MW;
         idx += kL2PThreads) {
      const int f = idx / (MW * MW);
      const int r = idx % (MW * MW);
      const int v = r / MW, w = r % MW;
      slice[idx] = (f < k && v < m && w < m)
          ? fmat[static_cast<long long>(f * m + u) * p2 + v * m + w]
          : 0.f;
    }
    __syncthreads();
    const float su = basis_value(tx, table + u * (m - 1), m);
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {
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
    for (int f = 0; f < kMaxFields; ++f)
      if (f < k) out[static_cast<long long>(f) * n + i] = acc[f];
  }
}

template <int MW>
void launch_p2m(const float* qx, const float* qy, const float* qz,
                const float* gm, int n, const float* box, int m,
                float* partial, int nblocks, cudaStream_t stream) {
  int threads = (m * m + 31) / 32 * 32;
  threads = threads < kP2MTile ? kP2MTile : threads;
  threads = threads > kP2MMaxThreads ? kP2MMaxThreads : threads;
  p2m_partial_kernel<MW><<<nblocks, threads, 0, stream>>>(
      qx, qy, qz, gm, n, box, m, partial);
}

template <int MW>
void launch_l2p(const float* qx, const float* qy, const float* qz, int n,
                const float* box, int m, const float* fmat, int k,
                float* out, cudaStream_t stream) {
  const int blocks = (n + kL2PThreads - 1) / kL2PThreads;
  l2p_kernel<MW><<<blocks, kL2PThreads, 0, stream>>>(qx, qy, qz, n, box, m,
                                                     fmat, k, out);
}

}  // namespace murb

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

// partial: nblocks * m^3 floats of scratch; w: m^3 floats.
extern "C" int murb_p2m(const float* qx, const float* qy, const float* qz,
                        const float* gm, int n, const float* box, int m,
                        float* partial, int nblocks, float* w,
                        cudaStream_t stream) {
  if (m < 2 || m > murb::kMaxOrder || nblocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define MURB_P2M(MW) \
  murb::launch_p2m<MW>(qx, qy, qz, gm, n, box, m, partial, nblocks, stream)
  MURB_DISPATCH_MW(m, MURB_P2M)
#undef MURB_P2M
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long p3 = static_cast<long long>(m) * m * m;
  murb::p2m_reduce_kernel<<<static_cast<int>((p3 + 255) / 256), 256, 0,
                            stream>>>(partial, nblocks, p3, w);
  return static_cast<int>(cudaGetLastError());
}

// fmat: (k * m, m^2) node fields, row f * m + u; out: k * n floats.  One
// launch per group of at most kMaxFields fields.
extern "C" int murb_l2p(const float* qx, const float* qy, const float* qz,
                        int n, const float* box, int m, const float* fmat,
                        int k, float* out, cudaStream_t stream) {
  if (m < 2 || m > murb::kMaxOrder || k < 1 || k > murb::kMaxTotalFields)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const long long p3 = static_cast<long long>(m) * m * m;
  for (int f0 = 0; f0 < k; f0 += murb::kMaxFields) {
    const int kg = k - f0 < murb::kMaxFields ? k - f0 : murb::kMaxFields;
    const float* fg = fmat + f0 * p3;
    float* og = out + static_cast<long long>(f0) * n;
#define MURB_L2P(MW) \
  murb::launch_l2p<MW>(qx, qy, qz, n, box, m, fg, kg, og, stream)
    MURB_DISPATCH_MW(m, MURB_L2P)
#undef MURB_L2P
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
