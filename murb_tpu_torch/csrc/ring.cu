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
//   * compute(s, k): K3's register-tiled sweep (tile.cu, through
//     tile_rect_launch) of the shard's targets against slot k % 2 of shard
//     s, whose rows slot, slot + n, slot + 2n and slot + 3n are the
//     block's x, y, z and G*m; it writes (k = 0) or adds to (k > 0) the
//     shard's ax, ay, az.  Where K3 splits its j range, its fold runs on
//     the compute stream before comp(s, k) is recorded, so "done reading
//     the slot" still means the sweep and its fold;
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
// What bounds it on an H100: the sweep is K3's (tile.cu: 4 targets a
// thread, 512-source cp.async tiles, ftz rsqrt; instruction issue and the
// MUFU rsqrt, 20 flops a pair); D^2 launches of n_l^2 pairs do N^2 pairs
// in all.  Each sweep is a small shape (50,176^2 at D = 4 for the 200k
// galaxy), where K3's j split pays most: the wrapper counts the card's SMs
// divided by the shards that share the card (ops/ring.ring_split), since
// their compute streams sweep at once.  A shard's sweeps run in order on
// one stream, so one (slices, 3, n) scratch a shard serves all of them.
// A copy moves 16 n_l bytes and hides behind the next step's sweep.
//
// bf16 state: murb_ring_pipelined_bf16 keeps the two slots in bf16, (2, 4,
// ld) with each row ld values apart, so a copy moves half the bytes (8 ld),
// and sweeps each ring step with K3's bf16 instance (tile.cu), which
// stages two sources a 4-byte cp.async: every slot row must start 4-byte
// aligned, so ld is even (n rounded up to even by the wrapper,
// ops/ring.slot_stride; the column past an odd n is never swept).  The
// events, streams and edges are the fp32 ring's, and at D = 1 its sums are
// K3's bf16 instance's bits.
#include <vector>

#include "tile.cuh"

namespace murb {

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

namespace murb {

// The whole ring for body type TB (float, or __nv_bfloat16 for the bf16
// ring); ld: the values between two rows of a slot.
template <class TB>
int ring_pipelined(int d, int n, int ld, TB* const* qx, TB* const* qy,
                   TB* const* qz, TB* const* bufs, float* const* ax,
                   float* const* ay, float* const* az, float* const* scratch,
                   const int* devices, const cudaStream_t* origin,
                   const cudaStream_t* compute, const cudaStream_t* copy,
                   float soft2, int block_i, int block_j, int slices,
                   int tiles_per_slice, long long delay_ns) {
  if (d <= 0 || n <= 0) return 0;
  if (ld < n) return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  int prev = 0;
  MURB_RING_TRY(cudaGetDevice(&prev));
  const long long slot = 4LL * ld;  // values a slot
  const size_t slot_bytes = sizeof(TB) * static_cast<size_t>(slot);
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
      ring_delay_kernel<<<1, 32, 0, st>>>(
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
      const TB* src = bufs[s] + (k % 2) * slot;
      const int st = tile_rect_launch(
          qx[s], qy[s], qz[s], n, src, src + ld, src + 2LL * ld,
          src + 3LL * ld, n, soft2, block_i, block_j, slices, tiles_per_slice, scratch[s],
          k > 0, ax[s], ay[s], az[s], compute[s]);
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
      TB* dst = bufs[right] + ((k + 1) % 2) * slot;
      const TB* src = bufs[s] + (k % 2) * slot;
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

}  // namespace murb

// d shards of n bodies each.  Host arrays of d entries: qx/qy/qz (targets,
// float32 (n,)), bufs ((2, 4, n) float32, slot 0 packed by the caller on
// its origin stream), ax/ay/az (outputs, (n,)), scratch (K3's (slices, 3,
// n) floats, unused at one slice), devices, and the origin, compute and
// copy streams of each shard.  block_i, block_j: 0 (K3's default) or a
// pair of {64, 128, 256, 512}; slices, tiles_per_slice: K3's j split of
// every sweep.  The origin streams wait for the whole ring before this
// returns; nothing is synchronised on the host.
extern "C" int murb_ring_pipelined(
    int d, int n, float* const* qx, float* const* qy, float* const* qz,
    float* const* bufs, float* const* ax, float* const* ay, float* const* az,
    float* const* scratch, const int* devices, const cudaStream_t* origin,
    const cudaStream_t* compute, const cudaStream_t* copy, float soft2,
    int block_i, int block_j, int slices, int tiles_per_slice,
    long long delay_ns) {
  return murb::ring_pipelined<float>(
      d, n, n, qx, qy, qz, bufs, ax, ay, az, scratch, devices, origin,
      compute, copy, soft2, block_i, block_j, slices, tiles_per_slice,
      delay_ns);
}

// The bf16 ring: murb_ring_pipelined's arguments with ld (the values
// between two slot rows, even and at least n) after n, and qx/qy/qz and
// bufs ((2, 4, ld), the first n of each row the block) bf16; the
// outputs and scratch float, K3's bf16 instance's split.
extern "C" int murb_ring_pipelined_bf16(
    int d, int n, int ld, __nv_bfloat16* const* qx, __nv_bfloat16* const* qy,
    __nv_bfloat16* const* qz, __nv_bfloat16* const* bufs, float* const* ax,
    float* const* ay, float* const* az, float* const* scratch,
    const int* devices, const cudaStream_t* origin,
    const cudaStream_t* compute, const cudaStream_t* copy, float soft2,
    int block_i, int block_j, int slices, int tiles_per_slice,
    long long delay_ns) {
  if (ld % 2) return static_cast<int>(cudaErrorInvalidValue);
  return murb::ring_pipelined<__nv_bfloat16>(
      d, n, ld, qx, qy, qz, bufs, ax, ay, az, scratch, devices, origin,
      compute, copy, soft2, block_i, block_j, slices, tiles_per_slice,
      delay_ns);
}
