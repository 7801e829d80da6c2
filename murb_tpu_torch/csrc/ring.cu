// K14: the pipelined D-step ring all-pairs of shard+ring.
//
// Replaces the TPU kernel murb_tpu/ops/ring_pallas.py:_ring_kernel
// (pallas_call at ring_pallas.py:184, entry acc_ring_pipelined :154).  On
// the TPU one Pallas call per shard fused the whole ring: at ring step k
// the shard's targets summed the exact softened force of j-block k, held
// in slot k % 2 of a (2, 4, n_l) VMEM buffer of {x, y, z, G*m}, while an
// RDMA sent the same slot to the right neighbour's other slot, and three
// semaphores (recv, capacity, send) ordered the protocol.
//
// On Hopper the communication leaves the kernel.  Each shard owns a (2, 4,
// n_l) device buffer (slot 0 packed with its own block by the caller) and
// two streams, one for compute and one for copies.  murb_ring_pipelined
// issues the whole D-step ring from the host:
//   * compute(s, k): ring_sweep_kernel over slot k % 2 of shard s, which
//     writes (k = 0) or adds to (k > 0) the shard's ax, ay, az;
//   * send(s, k), k < D - 1: one cudaMemcpyAsync (cudaMemcpyPeerAsync
//     across cards) of that slot, 16 n_l bytes, into slot (k + 1) % 2 of
//     the right neighbour.
// CUDA events stand in for the semaphores, with the same edges:
//   recv      compute(s, k) and send(s, k) wait for send(left, k - 1): the
//             block has arrived;
//   capacity  send(s, k) waits for compute(right, k - 1): the neighbour is
//             done reading the slot it overwrites;
//   send      send(s, k) also waits for send(right, k - 1), which read that
//             slot: a slot is not overwritten before its own send drained.
// D = 1 is pure compute, D = 2 has no capacity edge.  Every wait is issued
// after the record it waits on (the steps are issued in order), so no wait
// can pass an unrecorded event.  delay_ns > 0 puts a __nanosleep kernel
// before every copy and every compute, so that a missing edge shows up as a
// wrong sum instead of hiding behind lucky timing.
//
// What bounds it on an H100: the sweep is K3's (sweep.cuh: fp32 pair chain
// on the CUDA cores, 20 flops and one MUFU rsqrt a pair); D^2 launches of
// n_l^2 pairs do N^2 pairs in all.  A copy moves 16 n_l bytes and hides
// behind the next step's sweep.
#include <vector>

#include "sweep.cuh"

namespace murb {

template <int BI, int BJ>
__global__ void __launch_bounds__(BI)
ring_sweep_kernel(const float* __restrict__ qxi, const float* __restrict__ qyi,
                  const float* __restrict__ qzi, int n,
                  const float* __restrict__ slot, float soft2, int accumulate,
                  float* __restrict__ ax, float* __restrict__ ay,
                  float* __restrict__ az) {
  __shared__ float4 tile[BJ];
  const int i = blockIdx.x * BI + threadIdx.x;
  const bool own = i < n;
  const float xi = own ? qxi[i] : 0.f;
  const float yi = own ? qyi[i] : 0.f;
  const float zi = own ? qzi[i] : 0.f;
  const float* xj = slot;
  const float* yj = slot + n;
  const float* zj = slot + 2 * static_cast<long long>(n);
  const float* gj = slot + 3 * static_cast<long long>(n);
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j0 = 0; j0 < n; j0 += BJ) {
    stage_sources<BI, BJ>(tile, xj, yj, zj, gj, j0, n);
    __syncthreads();
    float tx, ty, tz;
    tile_sum_f32<BJ>(tile, xi, yi, zi, soft2, tx, ty, tz);
    sx += tx;
    sy += ty;
    sz += tz;
    __syncthreads();
  }
  if (own) {
    if (accumulate) {
      ax[i] += sx;
      ay[i] += sy;
      az[i] += sz;
    } else {
      ax[i] = sx;
      ay[i] = sy;
      az[i] = sz;
    }
  }
}

// Holds its stream for at least `ns` nanoseconds (the protocol check).
__global__ void ring_delay_kernel(unsigned long long ns) {
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    __nanosleep(500);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while (t - t0 < ns);
}

}  // namespace murb

#define MURB_RING_TRY(call)                  \
  do {                                       \
    const cudaError_t e_ = (call);           \
    if (e_ != cudaSuccess && err == 0)       \
      err = static_cast<int>(e_);            \
  } while (0)

// d shards of n bodies each.  Host arrays of d entries: qx/qy/qz (targets,
// float32 (n,)), bufs ((2, 4, n) float32, slot 0 packed by the caller on
// its origin stream), ax/ay/az (outputs, (n,)), devices, and the origin,
// compute and copy streams of each shard.  block_i, block_j: 0 (128 each)
// or a pair of {64, 128, 256, 512}.  The origin streams wait for the whole
// ring before this returns; nothing is synchronised on the host.
extern "C" int murb_ring_pipelined(
    int d, int n, float* const* qx, float* const* qy, float* const* qz,
    float* const* bufs, float* const* ax, float* const* ay, float* const* az,
    const int* devices, const cudaStream_t* origin,
    const cudaStream_t* compute, const cudaStream_t* copy, float soft2,
    int block_i, int block_j, long long delay_ns) {
  if (d <= 0 || n <= 0) return 0;
  int err = 0;
  int prev = 0;
  MURB_RING_TRY(cudaGetDevice(&prev));
  const long long slot = 4LL * n;  // floats a slot
  const size_t slot_bytes = sizeof(float) * static_cast<size_t>(slot);
  std::vector<cudaEvent_t> start(d), comp(d * d), sent(d * d), done(2 * d);
  for (int s = 0; s < d; ++s) {
    MURB_RING_TRY(cudaSetDevice(devices[s]));
    const unsigned flags = cudaEventDisableTiming;
    MURB_RING_TRY(cudaEventCreateWithFlags(&start[s], flags));
    MURB_RING_TRY(cudaEventCreateWithFlags(&done[2 * s], flags));
    MURB_RING_TRY(cudaEventCreateWithFlags(&done[2 * s + 1], flags));
    for (int k = 0; k < d; ++k) {
      MURB_RING_TRY(cudaEventCreateWithFlags(&comp[s * d + k], flags));
      MURB_RING_TRY(cudaEventCreateWithFlags(&sent[s * d + k], flags));
    }
    // the packed slot 0, the targets and the outputs come from the origin
    MURB_RING_TRY(cudaEventRecord(start[s], origin[s]));
    MURB_RING_TRY(cudaStreamWaitEvent(compute[s], start[s], 0));
    MURB_RING_TRY(cudaStreamWaitEvent(copy[s], start[s], 0));
  }
  auto delay = [&](cudaStream_t st) {
    if (delay_ns > 0) {
      murb::ring_delay_kernel<<<1, 32, 0, st>>>(
          static_cast<unsigned long long>(delay_ns));
      MURB_RING_TRY(cudaGetLastError());
    }
  };
  for (int k = 0; k < d && !err; ++k) {
    for (int s = 0; s < d; ++s) {  // compute(s, k)
      const int left = (s + d - 1) % d;
      MURB_RING_TRY(cudaSetDevice(devices[s]));
      if (k > 0)  // recv: block k has arrived
        MURB_RING_TRY(cudaStreamWaitEvent(compute[s],
                                          sent[left * d + k - 1], 0));
      delay(compute[s]);
      const float* src = bufs[s] + (k % 2) * slot;
      const int acc = k > 0;
      const int st = murb::with_blocks(
          block_i, block_j, murb::kSweepThreads, murb::kSweepThreads,
          [&](auto bi, auto bj) {
            constexpr int BI = decltype(bi)::value, BJ = decltype(bj)::value;
            murb::ring_sweep_kernel<BI, BJ>
                <<<(n + BI - 1) / BI, BI, 0, compute[s]>>>(
                    qx[s], qy[s], qz[s], n, src, soft2, acc, ax[s], ay[s],
                    az[s]);
            return static_cast<int>(cudaGetLastError());
          });
      if (st && err == 0) err = st;
      MURB_RING_TRY(cudaEventRecord(comp[s * d + k], compute[s]));
    }
    if (k == d - 1) break;
    for (int s = 0; s < d; ++s) {  // send(s, k)
      const int left = (s + d - 1) % d, right = (s + 1) % d;
      MURB_RING_TRY(cudaSetDevice(devices[s]));
      if (k > 0) {
        // recv: our slot k % 2 holds block k
        MURB_RING_TRY(cudaStreamWaitEvent(copy[s], sent[left * d + k - 1],
                                          0));
        // capacity: the right neighbour finished reading its slot
        // (k + 1) % 2, and its own send out of that slot drained
        MURB_RING_TRY(cudaStreamWaitEvent(copy[s], comp[right * d + k - 1],
                                          0));
        MURB_RING_TRY(cudaStreamWaitEvent(copy[s], sent[right * d + k - 1],
                                          0));
      }
      delay(copy[s]);
      float* dst = bufs[right] + ((k + 1) % 2) * slot;
      const float* src = bufs[s] + (k % 2) * slot;
      if (devices[right] == devices[s])
        MURB_RING_TRY(cudaMemcpyAsync(dst, src, slot_bytes,
                                      cudaMemcpyDeviceToDevice, copy[s]));
      else
        MURB_RING_TRY(cudaMemcpyPeerAsync(dst, devices[right], src,
                                          devices[s], slot_bytes, copy[s]));
      MURB_RING_TRY(cudaEventRecord(sent[s * d + k], copy[s]));
    }
  }
  for (int s = 0; s < d; ++s) {  // the origin waits for the whole ring
    MURB_RING_TRY(cudaSetDevice(devices[s]));
    MURB_RING_TRY(cudaEventRecord(done[2 * s], compute[s]));
    MURB_RING_TRY(cudaEventRecord(done[2 * s + 1], copy[s]));
    MURB_RING_TRY(cudaStreamWaitEvent(origin[s], done[2 * s], 0));
    MURB_RING_TRY(cudaStreamWaitEvent(origin[s], done[2 * s + 1], 0));
  }
  // destroying a recorded event is legal: it is released once complete
  for (auto* v : {&start, &comp, &sent, &done})
    for (cudaEvent_t e : *v)
      if (e) cudaEventDestroy(e);
  cudaSetDevice(prev);
  return err;
}
