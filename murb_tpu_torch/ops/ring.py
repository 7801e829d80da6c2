"""The pipelined ring of ``shard+ring``: kernel K14 and its plain version.

Port of ``murb_tpu/ops/ring_pallas.py``.  Every shard's targets sum the
exact softened force of every shard's block over D ring steps: at step k
shard s computes against the block that started on shard (s - k) mod D,
held in slot k % 2 of its two-slot buffer, while the same slot travels on
to the right neighbour's other slot.

``acc_ring_pipelined`` launches K14 (``csrc/ring.cu``: the event protocol
in one C entry, each ring step swept by K3's register-tiled kernel,
csrc/tile.cu) when every shard lies on a CUDA device, and runs
``acc_ring_pipelined_plain`` when every shard lies on the CPU; there is no
other path.  A bf16 state (every block and G*m bf16) launches the bf16
ring (``murb_ring_pipelined_bf16``, counted in
``acc_ring_pipelined.bf16_launches``): its two slots are bf16, half the
bytes a copy, and each step runs K3's bf16 instance.  The plain version
plays the same two-slot protocol on host-side lists, the sweep in the
inputs' dtype.

A mesh of several processes on one host (``maybe_init_distributed``)
runs one ring across them: each process launches K14's cross-process
instance (``murb_ring_pipelined_ipc`` and ``_bf16``, counted in
``acc_ring_pipelined.ipc_launches`` and ``ipc_bf16_launches``) for its own
shards, its slots and flag words in regions that ``_ipc_ring`` makes once
and maps into the neighbour processes over CUDA IPC (the edges that cross
a process: ``ring_edges``; the flags' epochs: ``flag_epoch``).  Several
processes may share one card, as the protocol check does: each runs

    MURB_COORDINATOR=localhost:PORT MURB_NUM_PROCESSES=2 MURB_PROCESS_ID=i

and calls ``maybe_init_distributed("cuda", backend="gloo")`` (NCCL puts
no two ranks on one card), then ``create_engine("shard+ring", state,
devices=["cuda:0"] * L)``.  The plain version plays the protocol across
CPU processes (gloo), the boundary slot through ``Mesh.ppermute``.  A mesh
whose processes run on several hosts raises (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import atexit
import ctypes
import dataclasses

import torch

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import Accel, bf16_plain, not_yet_ported, \
    notify_fp32_compute
from murb_tpu_torch.ops.tile import acc_tile_rect_plain

TAG = "shard+ring (pipelined)"


def _check_mesh(mesh, qs, gms) -> None:
    if not len(qs) == len(gms) == mesh.local_size:
        raise ValueError(f"{TAG}: {len(qs)} position and {len(gms)} mass "
                         f"blocks for {mesh.local_size} shards")
    if mesh.distributed and not mesh.single_host:
        raise not_yet_ported("the pipelined ring across hosts "
                             "(ring_impl='pipelined' on a mesh whose "
                             f"processes run on {sorted(set(mesh.hosts))}; "
                             "ring_impl='ppermute' runs there)", "Queue 1")


def ring_edges(process_count: int, local_size: int) -> list:
    """Every edge of K14's protocol on a mesh of ``process_count`` processes
    of ``local_size`` shards, as ``(edge, producer, consumer, crosses)``
    in global shard indices: consumer g's ``recv`` comes from its left
    neighbour, its ``capacity`` and ``send`` from its right (csrc/ring.cu).
    ``crosses``: the two lie in different processes, so the edge is a flag
    word in the consumer's region rather than a CUDA event."""
    d = process_count * local_size
    out = []
    for g in range(d):
        for edge, producer in (("recv", (g - 1) % d),
                               ("capacity", (g + 1) % d),
                               ("send", (g + 1) % d)):
            out.append((edge, producer, g,
                        producer // local_size != g // local_size))
    return out


def flag_epoch(call: int, d: int) -> int:
    """The epoch of a ring's call ``call`` (0, 1, ...) of ``d`` shards,
    ``call * d``: csrc/ring.cu writes a flag with epoch + k + 1 after step
    k and waits for epoch + k before step k > 0, so every value of a call
    is above every value of the calls before it and nothing is reset."""
    base = call * d
    if base + d >= 2 ** 32:     # a flag word holds 32 bits
        raise RuntimeError(f"{TAG}: call {call} of a {d}-shard ring "
                           f"overflows its 32-bit flags")
    return base


@bf16_plain
def acc_ring_pipelined_plain(mesh, qs, gms, soft, *, log=None) -> list:
    """K14's plain version: D ring steps over two slots a shard, on lists.

    ``qs``: one (qx, qy, qz) block a local shard, ``gms`` one G*m block a
    local shard (G included), each on its shard's device.  Returns one
    Accel a local shard.  Every send of a step goes through
    ``mesh.ppermute``, so on a mesh of processes the last shard's slot
    enters the next process's first shard.  ``log``, when a list, receives
    (k, s, slot, origin shard of the block), both shards global, for every
    compute of this process, in the order the protocol runs them."""
    _check_mesh(mesh, qs, gms)
    l, d = mesh.local_size, mesh.size
    slots = [[torch.stack([*q, g]), None] for q, g in zip(qs, gms)]
    origins = [[torch.tensor([mesh.axis_index(s)], device=dv), None]
               for s, dv in enumerate(mesh.devices)]
    acc = [None] * l
    for k in range(d):
        for s in range(l):
            a = acc_tile_rect_plain(*qs[s], *slots[s][k % 2], soft)
            acc[s] = a if k == 0 else Accel(*(x + y for x, y in
                                             zip(acc[s], a)))
            if log is not None:
                log.append((k, mesh.axis_index(s), k % 2,
                            int(origins[s][k % 2])))
        if k < d - 1:
            # every send of step k lands in the other slot of the right
            # neighbour, which nothing reads at step k
            for pairs in [slots] + ([origins] if log is not None else []):
                moved = mesh.ppermute([p[k % 2] for p in pairs])
                for p, m in zip(pairs, moved):
                    p[(k + 1) % 2] = m
    return acc


def slot_stride(n: int) -> int:
    """The values between two rows of a bf16 ring slot: ``n`` rounded up
    to even, so that every row starts 4-byte aligned, as K3's bf16
    instance reads its sources (two a 4-byte copy; csrc/ring.cu)."""
    return n + (n & 1)


def ring_split(n: int, sm_count: int, resident: int, sharing: int,
               block_i: int = 0, block_j: int = 0) -> tuple[int, int]:
    """K3's j split of each of K14's n x n ring sweeps,
    ``(slices, tiles_per_slice)`` (ops/cuda.tile_split): the ``sharing``
    shards of one card sweep at once on their own compute streams, so
    each counts the card's SMs divided among them (at least one)."""
    return cuda.tile_split(n, n, max(1, sm_count // max(1, sharing)),
                           resident, block_i, block_j)


_STREAMS: dict = {}


def _side_streams(dev: torch.device, s: int):
    """Shard ``s``'s (compute, copy) streams on ``dev``, made once."""
    key = (dev.index, s)
    if key not in _STREAMS:
        _STREAMS[key] = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    return _STREAMS[key]


@dataclasses.dataclass
class IpcRing:
    """This process's part of one ring across processes, made once a mesh
    layout, shard length and dtype (``_ipc_ring``): its regions (one a
    local shard, from ``murb_ring_ipc_alloc``: flag words, then two
    slots), the two neighbour regions mapped here (the left process's last
    shard's, the right process's first shard's), the shards of every
    process on each local card (K3's j split counts them all), and the
    calls made so far (the flags' epoch)."""

    regions: list
    left: int
    right: int
    sharing: dict
    calls: int = 0


#: sizeof(cudaIpcMemHandle_t)
IPC_HANDLE_BYTES = 64

_IPC: dict = {}
_HELD: list = []     # (device, pointer, mapped) of every region, freed at exit


def _release_ipc() -> None:
    """At exit: once this process's cards are idle, unmap the neighbours'
    regions and free its own.  After a call nothing moves into or out of a
    region (csrc/ring.cu), so no neighbour writes into a freed one."""
    if not _HELD:
        return
    for dev in {d for d, _, _ in _HELD}:
        torch.cuda.synchronize(dev)
    lib = cuda.library()
    for dev, ptr, mapped in reversed(_HELD):
        lib.murb_ring_ipc_release(dev, ptr, int(mapped))  # exit: no raise
    _HELD.clear()
    _IPC.clear()


def _ipc_ring(mesh, n: int, ld: int, b16: bool) -> IpcRing:
    """The cross-process ring's regions for ``mesh`` (every process calls
    this together: one ``Mesh.all_gather_object``).  Each local shard's
    region is made with ``cudaMalloc`` and exported; the processes
    exchange their handles, shard counts, slot strides and cards (PCI bus
    ids); this process maps only the regions it writes into, the
    consumers' of the edges that cross out of it (``ring_edges``).  A
    failed allocation, exchange or mapping raises."""
    l, pi, pc = mesh.local_size, mesh.process_index, mesh.process_count
    ids = [dv.index for dv in mesh.devices]
    key = (pi, pc, tuple(ids), n, ld, b16)
    if key in _IPC:
        return _IPC[key]
    if not _HELD:
        atexit.register(_release_ipc)
    handles, regions, cards = [], [], []
    for i in ids:
        ptr, h = ctypes.c_void_p(), ctypes.create_string_buffer(
            IPC_HANDLE_BYTES)
        cuda.launch("murb_ring_ipc_alloc", i, ld, 2 if b16 else 4,
                    ctypes.byref(ptr), h)
        _HELD.append((i, ptr.value, False))
        bus = ctypes.create_string_buffer(32)
        cuda.launch("murb_ring_ipc_bus_id", i, bus, len(bus))
        regions.append(ptr.value)
        handles.append(h.raw)
        cards.append(bus.value.decode())
    every = mesh.all_gather_object({"shards": l, "n": n, "ld": ld,
                                    "bf16": b16, "handles": handles,
                                    "cards": cards})
    layouts = {(e["shards"], e["n"], e["ld"], e["bf16"]) for e in every}
    if len(layouts) != 1:
        raise ValueError(f"{TAG}: the processes' rings differ in (shards, "
                         f"n, slot stride, bf16): {sorted(layouts)}")
    mapped = {}
    for _, producer, consumer, crosses in ring_edges(pc, l):
        where = divmod(consumer, l)      # (process, local shard)
        if crosses and producer // l == pi and where not in mapped:
            ptr, dev = ctypes.c_void_p(), ids[producer % l]
            handle = ctypes.create_string_buffer(
                every[where[0]]["handles"][where[1]], IPC_HANDLE_BYTES)
            cuda.launch("murb_ring_ipc_open", dev, handle, ctypes.byref(ptr))
            _HELD.append((dev, ptr.value, True))
            mapped[where] = ptr.value
    all_cards = [c for e in every for c in e["cards"]]
    ring = IpcRing(regions, mapped[((pi - 1) % pc, l - 1)],
                   mapped[((pi + 1) % pc, 0)],
                   {i: all_cards.count(c) for i, c in zip(ids, cards)})
    _IPC[key] = ring
    return ring


def ring_sums(mesh, qs, gms, soft, *, block_i: int = 0, block_j: int = 0,
              delay_ns: int = 0) -> list:
    """K14 on CUDA shards: one (3, n) float32 tensor of sums a local shard
    (``acc_ring_pipelined``'s outputs before they take the inputs' dtype).

    fp32 inside (float64 inputs are cast here); a bf16 state runs the bf16
    ring on its arrays as they are, its slots (2, 4, ``slot_stride(n)``)
    bf16.  On one process one C call issues the D^2 sweeps (K3's kernel,
    split by ``ring_split`` at its instance's resident count; each shard's
    (slices, 3, n) scratch is allocated here) and D(D - 1) slot copies on
    each shard's compute and copy streams; on a mesh of processes of this
    host each process's call issues its L shards' L D sweeps and copies
    (``murb_ring_pipelined_ipc``), its slots in ``_ipc_ring``'s regions,
    and ``ring_split`` counts every process's shards on the card.  Each
    shard's current stream waits for the whole ring.
    ``block_i``/``block_j`` pick the sweep's compiled geometry (K3's);
    ``delay_ns`` > 0 sleeps before every copy and compute (the protocol
    check of chip_smoke.py)."""
    _check_mesh(mesh, qs, gms)
    cuda.check_blocks(TAG, block_i, block_j)
    if not mesh.all_cuda:
        raise ValueError(f"{TAG}: shards on {mesh.devices} (all cpu or all "
                         "cuda)")
    cuda.refuse_grad(TAG, soft)
    if not float(soft) > 0.0:
        raise ValueError(f"{TAG}: the sweep needs a positive softening")
    l, n = mesh.local_size, qs[0][0].shape[0]
    b16 = all(cuda.all_bf16(*q, g) for q, g in zip(qs, gms))
    sfx = "_bf16" if b16 else ""
    ld = slot_stride(n) if b16 else n
    ipc = _ipc_ring(mesh, n, ld, b16) if mesh.distributed else None
    # one split for every sweep, from the card that the most shards share
    dev0 = max(mesh.devices, key=mesh.devices.count)
    slices, per = ring_split(n, cuda.sm_count(dev0),
                             cuda.resident("murb_tile_resident" + sfx, dev0,
                                           block_i, block_j),
                             ipc.sharing[dev0.index] if ipc
                             else mesh.devices.count(dev0), block_i, block_j)
    tgts, bufs, outs, scratch = [], [], [], []
    for dev, q, g in zip(mesh.devices, qs, gms):
        x, y, z, gg = cuda.kernel_inputs(TAG, dev, n, *q, g,
                                         notify=notify_fp32_compute,
                                         bf16=b16)
        with torch.cuda.device(dev):
            if ipc is None:
                buf = torch.empty((2, 4, ld), dtype=x.dtype, device=dev)
                for c, v in enumerate((x, y, z, gg)):
                    buf[0, c, :n] = v
                buf[:, :, n:] = 0   # the even stride's column, never swept
                bufs.append(buf)
            outs.append(torch.empty((3, n), dtype=torch.float32, device=dev))
            scratch.append(torch.empty((slices, 3, n) if slices > 1 else 0,
                                       dtype=torch.float32, device=dev))
        tgts.append((x, y, z, gg))
    ptrs = lambda ts: (ctypes.c_void_p * l)(*(t.data_ptr() for t in ts))
    # slot 0 packed here on one process; the C entry packs its region's
    # from G*m across processes
    arrays = [ptrs(t[c] for t in tgts) for c in range(3)]
    arrays += [ptrs(bufs) if ipc is None else ptrs(t[3] for t in tgts)]
    arrays += [ptrs(o[c] for o in outs) for c in range(3)] + [ptrs(scratch)]
    ids = (ctypes.c_int * l)(*(dv.index for dv in mesh.devices))
    side = [_side_streams(dv, s) for s, dv in enumerate(mesh.devices)]
    streams = [(ctypes.c_void_p * l)(*v) for v in (
        [torch.cuda.current_stream(dv).cuda_stream for dv in mesh.devices],
        [c.cuda_stream for c, _ in side], [p.cuda_stream for _, p in side])]
    head = (l, n, *((ld,) if b16 else ()),
            *(ctypes.addressof(a) for a in arrays), ctypes.addressof(ids),
            *(ctypes.addressof(s) for s in streams))
    tail = (ctypes.c_float(float(soft) ** 2), block_i, block_j, slices, per,
            int(delay_ns))
    fn = acc_ring_pipelined     # its counts: this process's sweeps
    if ipc is None:
        cuda.launch("murb_ring_pipelined" + sfx, *head, *tail)
        if b16:
            fn.bf16_launches += l * l
        else:
            fn.launches += l * l
        return outs
    d = mesh.size
    regions = (ctypes.c_void_p * l)(*ipc.regions)
    epoch = flag_epoch(ipc.calls, d)
    ipc.calls += 1
    cuda.launch("murb_ring_pipelined_ipc" + sfx, l, d, mesh.axis_index(0),
                *head[1:], ctypes.addressof(regions), ipc.left, ipc.right,
                epoch, *tail)
    if b16:
        fn.ipc_bf16_launches += l * d
    else:
        fn.ipc_launches += l * d
    return outs


def acc_ring_pipelined(mesh, qs, gms, soft, *, block_i: int = 0,
                       block_j: int = 0, delay_ns: int = 0) -> list:
    """Per-shard accelerations through the D-step ring: one Accel a local
    shard.

    CPU shards run the plain version; CUDA shards launch K14
    (``ring_sums``, whose float32 sums are cast to the inputs' dtype)."""
    _check_mesh(mesh, qs, gms)
    cuda.check_blocks(TAG, block_i, block_j)
    if all(dv.type == "cpu" for dv in mesh.devices):
        return acc_ring_pipelined_plain(mesh, qs, gms, soft)
    dtype = qs[0][0].dtype
    return [Accel(*(o.to(dtype) for o in out))
            for out in ring_sums(mesh, qs, gms, soft, block_i=block_i,
                                 block_j=block_j, delay_ns=delay_ns)]


acc_ring_pipelined.launches = 0
acc_ring_pipelined.bf16_launches = 0
acc_ring_pipelined.ipc_launches = 0
acc_ring_pipelined.ipc_bf16_launches = 0
