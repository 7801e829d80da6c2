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
#include <cuda.h>

#include <cstdio>
#include <cstring>
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

// ---------------------------------------------------------------------------
// K14 across processes: murb_ring_pipelined_ipc (fp32) and _ipc_bf16 for the
// processes of one host, murb_ring_pipelined_hosts and _hosts_bf16 for a
// ring whose processes stand on several hosts.
//
// On the TPU the ring's slot RDMA and its three semaphores address logical
// device ids, so one shard_map ring spans the processes of a multi-host
// slice.  Here a mesh of P processes x L local shards (D = P L, global
// shard p L + s) runs one ring, each process issuing only its own shards'
// work: the sweeps on their compute streams and the copies on their copy
// streams, K3's sweep as in the one-process ring.  Each local shard owns a
// region made once by murb_ring_ipc_alloc (cudaMalloc, so that one
// cudaIpcMemHandle_t describes it): three 32-bit flag words (recv,
// capacity, send) at its head, then its two slots (2, 4, ld) at kFlagBytes.
//
// The edges are the one-process ring's.  Inside a process they stay CUDA
// events.  A process boundary is one of two kinds (ops/ring.ring_edges).
//
// On one host (an IPC edge) the process maps two regions of its
// neighbours (cudaIpcOpenMemHandle): the right process's first shard's,
// into whose slot (k + 1) % 2 its last shard's copy writes, and the left
// process's last shard's.  The three edges that cross the boundary become
// flag words in the consumer's region, written by the producer's stream
// after the work they guard (cuStreamWriteValue32, whose default puts a
// memory barrier before the write: the copy's bytes land before the flag)
// and waited on by the consumer's stream before the work they allow
// (cuStreamWaitValue32, GEQ), both from the driver through
// cudaGetDriverEntryPoint:
//   recv      (murb_tpu's recv_sem) the left process's last shard writes
//             this process's first shard's recv flag after send(k); that
//             shard's compute(k + 1) and send(k + 1) wait for it;
//   capacity  (cap_sem) this process's first shard writes the left
//             process's last shard's capacity flag after compute(k); that
//             shard's send(k + 1) waits for it;
//   send      (send_sem) this process's first shard writes the same
//             shard's send flag after send(k), which read the slot that
//             send(k + 1) overwrites.
// Flag values are epochs that only grow, so nothing is ever reset: at call
// c (``base`` = c D, passed in) the write after step k is base + k + 1 and
// the wait before step k > 0 is base + k, above every value of an earlier
// call, so no call passes on a stale flag.  The slots persist across calls:
// at the start every local stream waits for every local origin, and at the
// end the last shard's origin also waits until the right process's last
// writes into this process have landed (capacity base + D, send base + D -
// 1); the left process's all land before the first shard's compute(D - 1).
// So after a call nothing moves into or out of this process's regions, and
// a region can be freed once its process has synchronised.
//
// Across hosts (a staged edge) no memory is shared: the boundary slot
// travels through pinned host memory and the network, as the reference's
// multi-node engine sends its host buffers over MPI
// (src/murb/implem/SimulationNBodyMultiNode.cpp:94-148).  Each end of a
// staged edge is a host region from murb_ring_stage_alloc (cudaHostAlloc,
// mapped): two 32-bit words, filled and emptied, at its head, then two
// buffers of one slot each at kStageHead, one a slot parity.  Between the
// two ends an agent thread of each process (ops/ring.py) sends and
// receives the buffers over a gloo group, one message a boundary a step.
// The receiver orders its own slot, so only the block crosses the wire:
//   sender    send(last, k) waits for its recv edge as ever, then for
//             buffer k % 2 to be free (emptied >= the value of the step
//             k - 2 that last used it, or at k < 2 the last value of the
//             end's previous call), copies slot k % 2 into it (device to
//             host) and writes filled = sbase + k + 1; the agent waits for
//             that, sends the buffer (tag sbase + k), and writes emptied =
//             sbase + k + 1;
//   receiver  the agent waits until its buffer k % 2 is drained (the same
//             rule on its own emptied word), receives block k + 1 into it
//             and writes filled = sbase + k + 1.  This process's inbound
//             stream waits for that flag and for compute(0, k - 1) and
//             send(0, k - 1), local events (the capacity and send edges
//             become orderings at the receiver), copies the buffer into
//             shard 0's slot (k + 1) % 2 (host to device), records
//             arrived(k), which shard 0's compute(k + 1) and send(k + 1)
//             wait for (its recv edge), and writes emptied = sbase + k + 1.
// sbase, the staged ends' epoch, grows by D every call of any ring across
// hosts of this process (the tags of the wire must not repeat), so the
// wait at k < 2 reads the end's own previous value (out_prev).  The device
// waits and writes the host words through their device pointers
// (cudaHostGetDevicePointer); murb_ring_stage_alloc proves once, on the
// card, that a stream can write and wait on such a word, and fails
// otherwise (no other transport is taken).  A staged end's buffers are
// reused only after the send or the host-to-device copy that read them has
// drained, and nothing of the peer writes into this process's regions, so
// a call ends, as on one host, when its streams are done.  A process may
// have an IPC edge on one side and a staged edge on the other (two hosts
// of two processes each).
//
// delay_ns keeps its meaning: a __nanosleep kernel before every copy
// (the inbound one too) and every compute.
//
// What bounds it: the one-process ring's sweeps (D L sweeps of n_l^2 pairs
// a process); a boundary copy is one cudaMemcpyAsync of 16 n_l bytes (8 ld
// in bf16) into the mapped slot, over NVLink between cards or within the
// card's memory when the processes share one; across hosts two copies
// over PCIe and one network message a step, which hide behind the next
// sweep while a step's sweeps take longer than the hop.  Processes that
// share a card without MPS run in time-sliced contexts, so their sweeps
// take turns rather than overlap, and a stream blocked on a flag waits for
// the producer's context to be scheduled.  A flag holds 32 bits: base + D
// and sbase + D must stay below 2^32 (checked).
// ---------------------------------------------------------------------------
namespace murb {

constexpr long long kFlagBytes = 256;  // the flags' head; slots start here
enum RingFlag { kRecvFlag = 0, kCapacityFlag = 1, kSendFlag = 2 };
constexpr long long kStageHead = 256;  // a staged end's head; buffers here
enum StageWord { kFilled = 0, kEmptied = 1, kProbe = 2 };
// a driver-API failure returns kDriverError + its CUresult
constexpr int kDriverError = 100000;

using StreamValue32 = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t,
                                   unsigned int);

struct StreamValueOps {
  StreamValue32 wait = nullptr, write = nullptr;
  int err = 0;
};

// cuStreamWaitValue32 and cuStreamWriteValue32 (CUDA 12's ABI), fetched
// once through the runtime, so that the library links no libcuda itself
const StreamValueOps& stream_value_ops() {
  static const StreamValueOps ops = [] {
    StreamValueOps o;
    const char* names[2] = {"cuStreamWaitValue32", "cuStreamWriteValue32"};
    StreamValue32* fns[2] = {&o.wait, &o.write};
    for (int i = 0; i < 2 && o.err == 0; ++i) {
      void* fn = nullptr;
      cudaDriverEntryPointQueryResult found =
          cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
      const cudaError_t e = cudaGetDriverEntryPointByVersion(
          names[i], &fn, 12000, cudaEnableDefault, &found);
#else
      const cudaError_t e =
          cudaGetDriverEntryPoint(names[i], &fn, cudaEnableDefault, &found);
#endif
      if (e != cudaSuccess)
        o.err = static_cast<int>(e);
      else if (found != cudaDriverEntryPointSuccess || fn == nullptr)
        o.err = static_cast<int>(cudaErrorNotSupported);
      else
        *fns[i] = reinterpret_cast<StreamValue32>(fn);
    }
    return o;
  }();
  return ops;
}

inline CUdeviceptr flag_word(char* region, RingFlag f) {
  return reinterpret_cast<CUdeviceptr>(region) +
         sizeof(cuuint32_t) * static_cast<int>(f);
}

inline CUdeviceptr stage_word(CUdeviceptr stage, StageWord w) {
  return stage + sizeof(cuuint32_t) * static_cast<int>(w);
}

template <class TB>
TB* region_slot(char* region, int slot, long long slot_values) {
  return reinterpret_cast<TB*>(region + kFlagBytes) + slot * slot_values;
}

template <class TB>
TB* stage_buffer(char* stage, int parity, long long slot_values) {
  return reinterpret_cast<TB*>(stage + kStageHead) + parity * slot_values;
}

// The ring of this process's l shards (global p l + s, first = p l) in a
// ring of d, body type TB; see the comment above.  Its left boundary is
// an IPC edge (left_last, the left process's last region, mapped) or a
// staged one (in_stage, this process's receiving end); its right
// boundary likewise (right_first, or out_stage).
template <class TB>
int ring_pipelined_procs(int l, int d, int first, int n, int ld,
                         TB* const* qx, TB* const* qy, TB* const* qz,
                         TB* const* gm, float* const* ax, float* const* ay,
                         float* const* az, float* const* scratch,
                         const int* devices, const cudaStream_t* origin,
                         const cudaStream_t* compute,
                         const cudaStream_t* copy, cudaStream_t inbound,
                         char* const* regions, char* left_last,
                         char* right_first, long long base, char* in_stage,
                         char* out_stage, long long sbase,
                         long long out_prev, float soft2, int block_i,
                         int block_j, int slices, int tiles_per_slice,
                         long long delay_ns) {
  const bool staged_in = in_stage != nullptr;
  const bool staged_out = out_stage != nullptr;
  if (l <= 0 || n <= 0 || ld < n || d < 2 * l || d % l || first % l ||
      first < 0 || first + l > d || base < 0 ||
      base + d > 0xffffffffLL || (left_last != nullptr) == staged_in ||
      (right_first != nullptr) == staged_out || sbase < 0 ||
      sbase + d > 0xffffffffLL || out_prev < 0 || out_prev > sbase)
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamValueOps& ops = stream_value_ops();
  if (ops.err) return ops.err;
  int err = 0;
  auto driver = [&](CUresult r) {
    if (r != CUDA_SUCCESS && err == 0) err = kDriverError + static_cast<int>(r);
  };
  auto wait_at = [&](cudaStream_t st, CUdeviceptr word, long long v) {
    driver(ops.wait(st, word, static_cast<cuuint32_t>(v),
                    CU_STREAM_WAIT_VALUE_GEQ));
  };
  auto write_at = [&](cudaStream_t st, CUdeviceptr word, long long v) {
    driver(ops.write(st, word, static_cast<cuuint32_t>(v),
                     CU_STREAM_WRITE_VALUE_DEFAULT));
  };
  auto wait_flag = [&](cudaStream_t st, char* region, RingFlag f,
                       long long v) { wait_at(st, flag_word(region, f), v); };
  auto write_flag = [&](cudaStream_t st, char* region, RingFlag f,
                        long long v) { write_at(st, flag_word(region, f), v); };
  int prev = 0;
  MURB_RING_TRY(cudaGetDevice(&prev));
  const long long slot = 4LL * ld;  // values a slot
  const size_t slot_bytes = sizeof(TB) * static_cast<size_t>(slot);
  const int last = l - 1;
  // the staged ends' words as the device addresses them
  CUdeviceptr in_words = 0, out_words = 0;
  for (int side = 0; side < 2; ++side) {
    char* stage = side ? out_stage : in_stage;
    if (!stage) continue;
    void* p = nullptr;
    MURB_RING_TRY(cudaSetDevice(devices[side ? last : 0]));
    MURB_RING_TRY(cudaHostGetDevicePointer(&p, stage, 0));
    (side ? out_words : in_words) = reinterpret_cast<CUdeviceptr>(p);
  }
  std::vector<cudaEvent_t> start(l), comp(l * d), sent(l * d), done(2 * l + 1);
  std::vector<cudaEvent_t> arrived(staged_in ? d : 0);
  TB* const* rows[4] = {qx, qy, qz, gm};
  const unsigned flags = cudaEventDisableTiming;
  for (int s = 0; s < l; ++s) {
    MURB_RING_TRY(cudaSetDevice(devices[s]));
    MURB_RING_TRY(cudaEventCreateWithFlags(&start[s], flags));
    MURB_RING_TRY(cudaEventCreateWithFlags(&done[2 * s], flags));
    MURB_RING_TRY(cudaEventCreateWithFlags(&done[2 * s + 1], flags));
    for (int k = 0; k < d; ++k) {
      MURB_RING_TRY(cudaEventCreateWithFlags(&comp[s * d + k], flags));
      MURB_RING_TRY(cudaEventCreateWithFlags(&sent[s * d + k], flags));
    }
    // slot 0: the shard's own block {x, y, z, G*m}, one row each
    TB* slot0 = region_slot<TB>(regions[s], 0, slot);
    for (int c = 0; c < 4; ++c)
      MURB_RING_TRY(cudaMemcpyAsync(slot0 + c * static_cast<long long>(ld),
                                    rows[c][s], sizeof(TB) * n,
                                    cudaMemcpyDeviceToDevice, origin[s]));
    MURB_RING_TRY(cudaEventRecord(start[s], origin[s]));
  }
  if (staged_in) {
    MURB_RING_TRY(cudaSetDevice(devices[0]));
    MURB_RING_TRY(cudaEventCreateWithFlags(&done[2 * l], flags));
    for (int k = 0; k < d; ++k)
      MURB_RING_TRY(cudaEventCreateWithFlags(&arrived[k], flags));
  }
  // the slots persist across calls: every local stream starts after every
  // local origin, which waited for the whole of the previous call
  for (int s = 0; s < l; ++s) {
    MURB_RING_TRY(cudaSetDevice(devices[s]));
    for (int t = 0; t < l; ++t) {
      MURB_RING_TRY(cudaStreamWaitEvent(compute[s], start[t], 0));
      MURB_RING_TRY(cudaStreamWaitEvent(copy[s], start[t], 0));
      if (s == 0 && staged_in)
        MURB_RING_TRY(cudaStreamWaitEvent(inbound, start[t], 0));
    }
  }
  auto delay = [&](cudaStream_t st) {
    if (delay_ns > 0) {
      ring_delay_kernel<<<1, 32, 0, st>>>(
          static_cast<unsigned long long>(delay_ns));
      MURB_RING_TRY(cudaGetLastError());
    }
  };
  // recv: block k (k > 0) is in shard s's slot k % 2
  auto recv_wait = [&](cudaStream_t st, int s, int k) {
    if (s > 0)
      MURB_RING_TRY(cudaStreamWaitEvent(st, sent[(s - 1) * d + k - 1], 0));
    else if (staged_in)
      MURB_RING_TRY(cudaStreamWaitEvent(st, arrived[k - 1], 0));
    else
      wait_flag(st, regions[0], kRecvFlag, base + k);
  };
  for (int k = 0; k < d && !err; ++k) {
    for (int s = 0; s < l; ++s) {  // compute(s, k)
      MURB_RING_TRY(cudaSetDevice(devices[s]));
      if (k > 0) recv_wait(compute[s], s, k);
      delay(compute[s]);
      const TB* src = region_slot<TB>(regions[s], k % 2, slot);
      const int st = tile_rect_launch(
          qx[s], qy[s], qz[s], n, src, src + ld, src + 2LL * ld,
          src + 3LL * ld, n, soft2, block_i, block_j, slices,
          tiles_per_slice, scratch[s], k > 0, ax[s], ay[s], az[s],
          compute[s]);
      if (st && err == 0) err = st;
      MURB_RING_TRY(cudaEventRecord(comp[s * d + k], compute[s]));
      if (s == 0 && !staged_in)  // capacity: the left may overwrite our slot
        write_flag(compute[0], left_last, kCapacityFlag, base + k + 1);
    }
    if (k == d - 1) break;
    if (staged_in) {  // block k + 1 from the left host into slot (k + 1) % 2
      MURB_RING_TRY(cudaSetDevice(devices[0]));
      wait_at(inbound, stage_word(in_words, kFilled), sbase + k + 1);
      if (k > 0) {
        // capacity and send, ordered here: shard 0 finished reading its
        // slot (k + 1) % 2, and its own send out of that slot drained
        MURB_RING_TRY(cudaStreamWaitEvent(inbound, comp[k - 1], 0));
        MURB_RING_TRY(cudaStreamWaitEvent(inbound, sent[k - 1], 0));
      }
      delay(inbound);
      MURB_RING_TRY(cudaMemcpyAsync(
          region_slot<TB>(regions[0], (k + 1) % 2, slot),
          stage_buffer<TB>(in_stage, k % 2, slot), slot_bytes,
          cudaMemcpyHostToDevice, inbound));
      MURB_RING_TRY(cudaEventRecord(arrived[k], inbound));
      write_at(inbound, stage_word(in_words, kEmptied), sbase + k + 1);
    }
    for (int s = 0; s < l; ++s) {  // send(s, k)
      MURB_RING_TRY(cudaSetDevice(devices[s]));
      if (k > 0) {
        recv_wait(copy[s], s, k);  // our slot k % 2 holds block k
        // capacity and send: the right neighbour finished reading its
        // slot (k + 1) % 2, and its own send out of that slot drained
        // (across hosts the receiver orders these itself)
        if (s < last) {
          MURB_RING_TRY(cudaStreamWaitEvent(copy[s],
                                            comp[(s + 1) * d + k - 1], 0));
          MURB_RING_TRY(cudaStreamWaitEvent(copy[s],
                                            sent[(s + 1) * d + k - 1], 0));
        } else if (!staged_out) {
          wait_flag(copy[s], regions[s], kCapacityFlag, base + k);
          wait_flag(copy[s], regions[s], kSendFlag, base + k);
        }
      }
      const bool to_host = s == last && staged_out;
      if (to_host) {  // buffer k % 2 is free: its last send has drained
        const long long v = k >= 2 ? sbase + k - 1 : out_prev;
        if (v > 0) wait_at(copy[s], stage_word(out_words, kEmptied), v);
      }
      delay(copy[s]);
      const TB* src = region_slot<TB>(regions[s], k % 2, slot);
      TB* dst = to_host ? stage_buffer<TB>(out_stage, k % 2, slot)
                        : region_slot<TB>(s < last ? regions[s + 1]
                                                   : right_first,
                                          (k + 1) % 2, slot);
      MURB_RING_TRY(cudaMemcpyAsync(dst, src, slot_bytes, cudaMemcpyDefault,
                                    copy[s]));
      MURB_RING_TRY(cudaEventRecord(sent[s * d + k], copy[s]));
      if (to_host)  // the agent may send buffer k % 2
        write_at(copy[s], stage_word(out_words, kFilled), sbase + k + 1);
      else if (s == last)  // recv: the block reached the right process
        write_flag(copy[s], right_first, kRecvFlag, base + k + 1);
      if (s == 0 && !staged_in)  // send: our slot k % 2 may be overwritten
        write_flag(copy[0], left_last, kSendFlag, base + k + 1);
    }
  }
  for (int s = 0; s < l; ++s) {  // the origin waits for the whole ring
    MURB_RING_TRY(cudaSetDevice(devices[s]));
    MURB_RING_TRY(cudaEventRecord(done[2 * s], compute[s]));
    MURB_RING_TRY(cudaEventRecord(done[2 * s + 1], copy[s]));
    MURB_RING_TRY(cudaStreamWaitEvent(origin[s], done[2 * s], 0));
    MURB_RING_TRY(cudaStreamWaitEvent(origin[s], done[2 * s + 1], 0));
    if (s == 0 && staged_in) {
      MURB_RING_TRY(cudaEventRecord(done[2 * l], inbound));
      MURB_RING_TRY(cudaStreamWaitEvent(origin[0], done[2 * l], 0));
    }
  }
  // and, on one host, for the right process's last writes into this
  // process's regions (not after a failure: those flags may never come)
  if (!err && !staged_out) {
    MURB_RING_TRY(cudaSetDevice(devices[last]));
    wait_flag(origin[last], regions[last], kCapacityFlag, base + d);
    wait_flag(origin[last], regions[last], kSendFlag, base + d - 1);
  }
  for (auto* v : {&start, &comp, &sent, &done, &arrived})
    for (cudaEvent_t e : *v)
      if (e) cudaEventDestroy(e);
  cudaSetDevice(prev);
  return err;
}

}  // namespace murb

// One shard's region on ``device``: kFlagBytes of flags (zeroed) and two
// slots of 4 rows of ``ld`` values of ``value_bytes`` bytes (zeroed), from
// cudaMalloc; its pointer in *region and its cudaIpcMemHandle_t (64 bytes)
// in ``handle``.  Synchronises the device.
extern "C" int murb_ring_ipc_alloc(int device, int ld, int value_bytes,
                                   void** region, void* handle) {
  if (ld <= 0 || value_bytes <= 0 || !region || !handle)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0, prev = 0;
  MURB_RING_TRY(cudaGetDevice(&prev));
  MURB_RING_TRY(cudaSetDevice(device));
  const size_t bytes = murb::kFlagBytes + 8ULL * ld * value_bytes;
  *region = nullptr;
  MURB_RING_TRY(cudaMalloc(region, bytes));
  if (!err) MURB_RING_TRY(cudaMemset(*region, 0, bytes));
  if (!err) MURB_RING_TRY(cudaDeviceSynchronize());
  if (!err)
    MURB_RING_TRY(cudaIpcGetMemHandle(
        static_cast<cudaIpcMemHandle_t*>(handle), *region));
  if (err && *region) {
    cudaFree(*region);
    *region = nullptr;
  }
  cudaSetDevice(prev);
  return err;
}

// Maps another process's region (its 64-byte handle) into this process on
// ``device``; the pointer in *region.
extern "C" int murb_ring_ipc_open(int device, const void* handle,
                                  void** region) {
  if (!handle || !region) return static_cast<int>(cudaErrorInvalidValue);
  int err = 0, prev = 0;
  MURB_RING_TRY(cudaGetDevice(&prev));
  MURB_RING_TRY(cudaSetDevice(device));
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  *region = nullptr;
  if (!err)
    MURB_RING_TRY(
        cudaIpcOpenMemHandle(region, h, cudaIpcMemLazyEnablePeerAccess));
  cudaSetDevice(prev);
  return err;
}

// Unmaps a region that murb_ring_ipc_open mapped (``opened`` 1) or frees
// one of this process's own (``opened`` 0), on ``device``.
extern "C" int murb_ring_ipc_release(int device, void* region, int opened) {
  int err = 0, prev = 0;
  MURB_RING_TRY(cudaGetDevice(&prev));
  MURB_RING_TRY(cudaSetDevice(device));
  MURB_RING_TRY(opened ? cudaIpcCloseMemHandle(region) : cudaFree(region));
  cudaSetDevice(prev);
  return err;
}

// The UUID of ``device`` as 32 hex digits, NUL-terminated in ``out`` of
// ``len`` (at least 33) bytes: which shards of the processes share a card,
// unique across hosts.
extern "C" int murb_ring_card_uuid(int device, char* out, int len) {
  if (!out || len < 33) return static_cast<int>(cudaErrorInvalidValue);
  cudaDeviceProp prop;
  const cudaError_t e = cudaGetDeviceProperties(&prop, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int i = 0; i < 16; ++i)
    snprintf(out + 2 * i, 3, "%02x",
             static_cast<unsigned char>(prop.uuid.bytes[i]));
  return 0;
}

// One staged end's host region: kStageHead bytes of words (zeroed), then
// two buffers of ``bytes`` bytes, from cudaHostAlloc (mapped, portable);
// its host pointer in *stage.  Proves on ``device`` that a stream writes
// and waits on a word of it through its device pointer (the staged edge's
// signals, cuStreamWriteValue32/cuStreamWaitValue32 on host memory) and
// fails if it cannot.
extern "C" int murb_ring_stage_alloc(int device, long long bytes,
                                     void** stage) {
  if (bytes <= 0 || !stage) return static_cast<int>(cudaErrorInvalidValue);
  int err = 0, prev = 0;
  MURB_RING_TRY(cudaGetDevice(&prev));
  MURB_RING_TRY(cudaSetDevice(device));
  const size_t total = murb::kStageHead + 2ULL * bytes;
  *stage = nullptr;
  MURB_RING_TRY(cudaHostAlloc(stage, total,
                              cudaHostAllocMapped | cudaHostAllocPortable));
  if (!err) memset(*stage, 0, total);
  const murb::StreamValueOps& ops = murb::stream_value_ops();
  if (!err && ops.err) err = ops.err;
  void* words = nullptr;
  if (!err) MURB_RING_TRY(cudaHostGetDevicePointer(&words, *stage, 0));
  cudaStream_t st = nullptr;
  if (!err) MURB_RING_TRY(cudaStreamCreateWithFlags(&st,
                                                    cudaStreamNonBlocking));
  if (!err) {
    const CUdeviceptr probe = murb::stage_word(
        reinterpret_cast<CUdeviceptr>(words), murb::kProbe);
    CUresult r = ops.write(st, probe, 1, CU_STREAM_WRITE_VALUE_DEFAULT);
    if (r == CUDA_SUCCESS) r = ops.wait(st, probe, 1, CU_STREAM_WAIT_VALUE_GEQ);
    if (r != CUDA_SUCCESS) err = murb::kDriverError + static_cast<int>(r);
  }
  if (st) {
    MURB_RING_TRY(cudaStreamSynchronize(st));
    cudaStreamDestroy(st);
  }
  volatile unsigned* head = static_cast<volatile unsigned*>(*stage);
  if (!err && head[murb::kProbe] != 1)
    err = static_cast<int>(cudaErrorNotSupported);
  if (err && *stage) {
    cudaFreeHost(*stage);
    *stage = nullptr;
  } else if (*stage) {
    head[murb::kProbe] = 0;
  }
  cudaSetDevice(prev);
  return err;
}

// Frees a staged end's region from murb_ring_stage_alloc.
extern "C" int murb_ring_stage_free(void* stage) {
  return static_cast<int>(cudaFreeHost(stage));
}

// This process's l shards of a d-shard ring across the processes of one
// host (first: the global index of local shard 0).  Host arrays of l
// entries: qx/qy/qz and gm (each shard's block, float32 (n,), G included:
// the targets and slot 0's contents), ax/ay/az, scratch, devices and the
// origin, compute and copy streams, as murb_ring_pipelined's; regions
// (this process's, from murb_ring_ipc_alloc with ld = n); left_last and
// right_first: the left process's last shard's region and the right
// process's first shard's, mapped by murb_ring_ipc_open; base: the call's
// epoch, its index times d.
extern "C" int murb_ring_pipelined_ipc(
    int l, int d, int first, int n, float* const* qx, float* const* qy,
    float* const* qz, float* const* gm, float* const* ax, float* const* ay,
    float* const* az, float* const* scratch, const int* devices,
    const cudaStream_t* origin, const cudaStream_t* compute,
    const cudaStream_t* copy, char* const* regions, char* left_last,
    char* right_first, long long base, float soft2, int block_i,
    int block_j, int slices, int tiles_per_slice, long long delay_ns) {
  return murb::ring_pipelined_procs<float>(
      l, d, first, n, n, qx, qy, qz, gm, ax, ay, az, scratch, devices,
      origin, compute, copy, nullptr, regions, left_last, right_first, base,
      nullptr, nullptr, 0, 0, soft2, block_i, block_j, slices,
      tiles_per_slice, delay_ns);
}

// The bf16 ring across processes: murb_ring_pipelined_ipc's arguments with
// ld (even, at least n, the same in every process) after n, the blocks
// bf16 and every region made with this ld and 2-byte values.
extern "C" int murb_ring_pipelined_ipc_bf16(
    int l, int d, int first, int n, int ld, __nv_bfloat16* const* qx,
    __nv_bfloat16* const* qy, __nv_bfloat16* const* qz,
    __nv_bfloat16* const* gm, float* const* ax, float* const* ay,
    float* const* az, float* const* scratch, const int* devices,
    const cudaStream_t* origin, const cudaStream_t* compute,
    const cudaStream_t* copy, char* const* regions, char* left_last,
    char* right_first, long long base, float soft2, int block_i,
    int block_j, int slices, int tiles_per_slice, long long delay_ns) {
  if (ld % 2) return static_cast<int>(cudaErrorInvalidValue);
  return murb::ring_pipelined_procs<__nv_bfloat16>(
      l, d, first, n, ld, qx, qy, qz, gm, ax, ay, az, scratch, devices,
      origin, compute, copy, nullptr, regions, left_last, right_first, base,
      nullptr, nullptr, 0, 0, soft2, block_i, block_j, slices,
      tiles_per_slice, delay_ns);
}

// This process's l shards of a d-shard ring whose processes stand on
// several hosts: murb_ring_pipelined_ipc's arguments, with after the copy
// streams the inbound stream (shard 0's host-to-device copies), and after
// base: in_stage and out_stage (this process's receiving and sending
// staged ends, from murb_ring_stage_alloc with bytes = 16 n; null where
// that boundary stays on one host, and then left_last or right_first is
// the mapped region; exactly one of each pair is given), sbase (the staged
// ends' epoch of this call) and out_prev (the sending end's last emptied
// value of its previous call, 0 for none).
extern "C" int murb_ring_pipelined_hosts(
    int l, int d, int first, int n, float* const* qx, float* const* qy,
    float* const* qz, float* const* gm, float* const* ax, float* const* ay,
    float* const* az, float* const* scratch, const int* devices,
    const cudaStream_t* origin, const cudaStream_t* compute,
    const cudaStream_t* copy, cudaStream_t inbound, char* const* regions,
    char* left_last, char* right_first, long long base, char* in_stage,
    char* out_stage, long long sbase, long long out_prev, float soft2,
    int block_i, int block_j, int slices, int tiles_per_slice,
    long long delay_ns) {
  return murb::ring_pipelined_procs<float>(
      l, d, first, n, n, qx, qy, qz, gm, ax, ay, az, scratch, devices,
      origin, compute, copy, inbound, regions, left_last, right_first, base,
      in_stage, out_stage, sbase, out_prev, soft2, block_i, block_j, slices,
      tiles_per_slice, delay_ns);
}

// The bf16 ring across hosts: murb_ring_pipelined_hosts's arguments with
// ld after n (even, at least n), the blocks bf16, every region made with
// this ld and 2-byte values and every staged end with bytes = 8 ld.
extern "C" int murb_ring_pipelined_hosts_bf16(
    int l, int d, int first, int n, int ld, __nv_bfloat16* const* qx,
    __nv_bfloat16* const* qy, __nv_bfloat16* const* qz,
    __nv_bfloat16* const* gm, float* const* ax, float* const* ay,
    float* const* az, float* const* scratch, const int* devices,
    const cudaStream_t* origin, const cudaStream_t* compute,
    const cudaStream_t* copy, cudaStream_t inbound, char* const* regions,
    char* left_last, char* right_first, long long base, char* in_stage,
    char* out_stage, long long sbase, long long out_prev, float soft2,
    int block_i, int block_j, int slices, int tiles_per_slice,
    long long delay_ns) {
  if (ld % 2) return static_cast<int>(cudaErrorInvalidValue);
  return murb::ring_pipelined_procs<__nv_bfloat16>(
      l, d, first, n, ld, qx, qy, qz, gm, ax, ay, az, scratch, devices,
      origin, compute, copy, inbound, regions, left_last, right_first, base,
      in_stage, out_stage, sbase, out_prev, soft2, block_i, block_j, slices,
      tiles_per_slice, delay_ns);
}
