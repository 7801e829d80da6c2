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

A mesh of several processes (``maybe_init_distributed``) runs one ring
across them: each process launches a cross-process instance of K14 for
its own shards.  ``ring_edges`` classifies every edge of the protocol: a
CUDA event inside a process, a flag word over CUDA IPC between processes
of one host, or a staged edge between processes on different hosts (the
mesh's host exchange, ``Mesh.hosts``, decides).  On one host
(``murb_ring_pipelined_ipc`` and ``_bf16``, counted in
``acc_ring_pipelined.ipc_launches`` and ``ipc_bf16_launches``) each
shard's slots and flag words lie in a region that ``_ipc_ring`` makes once
and maps into the neighbour processes (the flags' epochs:
``flag_epoch``).  A mesh whose processes stand on several hosts launches
``murb_ring_pipelined_hosts`` and ``_bf16`` (counted in ``hosts_launches``
and ``hosts_bf16_launches``): a boundary that crosses hosts travels
through pinned host memory (``StagedEnd``: two buffers a boundary, one a
slot parity, and two flag words), and this process's two agent threads
(``_Agents``) send and receive it on ``parallel/mesh.side_group``, a gloo
group beside the main one, tagged by the call's epoch and the step; a
boundary inside a host keeps its IPC edge.  Processes of one machine may
be placed on separate hosts (``make_mesh(host=...)``) and then run exactly
that code, the network being loopback; several hosts need nothing beyond
``MURB_COORDINATOR`` naming the first.  Several processes may share one
card, as the protocol check does: each runs

    MURB_COORDINATOR=localhost:PORT MURB_NUM_PROCESSES=2 MURB_PROCESS_ID=i

and calls ``maybe_init_distributed("cuda", backend="gloo")`` (NCCL puts
no two ranks on one card), then ``create_engine("shard+ring", state,
devices=["cuda:0"] * L)``; ``parallel/mesh.destroy_distributed`` stops the
agents before the groups.  The plain version plays the protocol across
CPU processes (gloo): on one host the boundary slot through
``Mesh.ppermute``, across hosts every process boundary through staged ends
and the same agents.
"""
from __future__ import annotations

import atexit
import ctypes
import dataclasses
import queue
import threading
import time

import torch
import torch.distributed as dist

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import Accel, bf16_plain, notify_fp32_compute
from murb_tpu_torch.ops.tile import acc_tile_rect_plain
from murb_tpu_torch.parallel import mesh as mesh_mod

TAG = "shard+ring (pipelined)"


def _check_mesh(mesh, qs, gms) -> None:
    if not len(qs) == len(gms) == mesh.local_size:
        raise ValueError(f"{TAG}: {len(qs)} position and {len(gms)} mass "
                         f"blocks for {mesh.local_size} shards")


def ring_edges(process_count: int, local_size: int, hosts=None) -> list:
    """Every edge of K14's protocol on a mesh of ``process_count`` processes
    of ``local_size`` shards, as ``(edge, producer, consumer, kind)`` in
    global shard indices: consumer g's ``recv`` comes from its left
    neighbour, its ``capacity`` and ``send`` from its right (csrc/ring.cu).
    ``kind``: "event" inside a process (a CUDA event), "ipc" between two
    processes of one host (a flag word in the consumer's region), "staged"
    between processes on different hosts (``hosts``: each process's host,
    all one host when None): the block travels through host memory, and
    the receiver orders the capacity and send edges on its own card."""
    d = process_count * local_size
    out = []
    for g in range(d):
        for edge, producer in (("recv", (g - 1) % d),
                               ("capacity", (g + 1) % d),
                               ("send", (g + 1) % d)):
            a, b = producer // local_size, g // local_size
            kind = ("event" if a == b else
                    "staged" if hosts is not None and hosts[a] != hosts[b]
                    else "ipc")
            out.append((edge, producer, g, kind))
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


def stage_wait(base: int, k: int, prev: int) -> int:
    """The emptied value that a staged end's filler waits for before it
    fills buffer k % 2 at step k of a call of epoch ``base``: that of step
    k - 2, which last used the buffer (base + k - 1), or at steps 0 and 1
    the last value of the end's previous call, ``prev`` (0: none, no
    wait).  The sending card (csrc/ring.cu) and the receiving agent use
    this rule; the plain version too."""
    return base + k - 1 if k >= 2 else prev


#: a staged end's head (its flag words) before its two buffers
STAGE_HEAD = 256
#: the flag words: the value base + k + 1 once buffer k % 2 was filled at
#: step k, and once it was emptied
FILLED, EMPTIED = 0, 1
#: what a failed transport writes into the words the card waits on
RELEASED = 0xFFFFFFFF
POLL_S = 2e-5


class StagedEnd:
    """This process's end of a process boundary of the ring that crosses
    hosts: a host region of two 32-bit flag words (``FILLED``,
    ``EMPTIED``) and two buffers of ``nbytes``, one a slot parity.  An
    "out" end (this process's last shard to process ``peer``) is filled by
    this process (the card's copy stream, or the plain version) and
    emptied by the sending agent; an "in" end (from ``peer`` to the first
    shard) is filled by the receiving agent and emptied by this process.
    ``device``: a card index for pinned memory from
    ``murb_ring_stage_alloc`` (the card waits and writes the words), None
    for plain host memory (the plain version).  ``last``: the last value of
    the end's latest call."""

    def __init__(self, side: str, peer: int, nbytes: int, device=None):
        self.side, self.peer, self.nbytes = side, peer, nbytes
        self.device, self.last = device, 0
        total = STAGE_HEAD + 2 * nbytes
        if device is None:
            self._mem = ctypes.create_string_buffer(total)
            self.addr = ctypes.addressof(self._mem)
        else:
            ptr = ctypes.c_void_p()
            cuda.launch("murb_ring_stage_alloc", device, nbytes,
                        ctypes.byref(ptr))
            self.addr = ptr.value
        self.flags = (ctypes.c_uint32 * 2).from_address(self.addr)
        raw = (ctypes.c_char * (2 * nbytes)).from_address(
            self.addr + STAGE_HEAD)
        self.buffers = torch.frombuffer(raw, dtype=torch.uint8).view(
            2, nbytes)

    def wait(self, word: int, value: int, agents) -> None:
        """Until flag ``word`` holds at least ``value`` (host polling); a
        failed agent or the side group's timeout raises."""
        deadline = time.monotonic() + mesh_mod.SIDE_TIMEOUT_S
        while self.flags[word] < value:
            if agents.error is not None:
                raise RuntimeError(f"{TAG}: the staged edge failed") \
                    from agents.error
            if time.monotonic() > deadline:
                raise TimeoutError(f"{TAG}: a staged {self.side} end (peer "
                                   f"{self.peer}) waited for flag {word} >= "
                                   f"{value}, holds {self.flags[word]}")
            time.sleep(POLL_S)

    def fill(self, k: int, base: int, prev: int, block: torch.Tensor,
             agents) -> None:
        """The plain version's send(k) into an out end: ``block``'s bytes
        into buffer k % 2 once it is free."""
        self.wait(EMPTIED, stage_wait(base, k, prev), agents)
        self.buffers[k % 2].copy_(block.contiguous().view(torch.uint8)
                                  .reshape(-1))
        self.flags[FILLED] = base + k + 1

    def drain(self, k: int, base: int, like: torch.Tensor,
              agents) -> torch.Tensor:
        """The plain version's arrival of step k from an in end: buffer
        k % 2 as a tensor like ``like`` (shape, dtype, device), once
        received; the buffer is then free for the agent."""
        self.wait(FILLED, base + k + 1, agents)
        out = torch.empty_like(like)
        out.view(torch.uint8).reshape(-1).copy_(self.buffers[k % 2])
        self.flags[EMPTIED] = base + k + 1
        return out


class _Agents:
    """This process's two agent threads of the rings across hosts: one
    sends the out ends' buffers, one receives into the in ends', each
    running its calls' jobs in the order they were given, on the side
    group (``parallel/mesh.side_group``: never the main group, whose
    collectives the main thread runs meanwhile).  ``epoch`` hands out the
    calls' epochs, which only grow: the wire's tags (epoch + step) never
    repeat.  A failure is kept in ``error`` (raised by the next call), and
    the failed end's words the card waits on are released, so that no
    stream waits forever."""

    def __init__(self):
        self.group = mesh_mod.side_group()
        self.base = 0
        self.error = None
        self.moved = {"out": 0, "in": 0}     # messages sent and received
        self.queues = {"out": queue.Queue(), "in": queue.Queue()}
        self.threads = [threading.Thread(target=self._serve, args=(q,),
                                         name=f"murb-ring-{side}",
                                         daemon=True)
                        for side, q in self.queues.items()]
        for t in self.threads:
            t.start()

    def check(self) -> None:
        if self.error is not None:
            raise RuntimeError(f"{TAG}: a staged edge failed in an earlier "
                               f"call") from self.error

    def epoch(self, d: int) -> int:
        """The next call's epoch (every process asks once a call of a ring
        across hosts, in the same order, so all agree)."""
        self.check()
        base = self.base
        if base + d >= 2 ** 31:   # gloo's tags and the 32-bit flags
            raise RuntimeError(f"{TAG}: the staged edges' epochs overflow")
        self.base += d
        return base

    def submit(self, end: StagedEnd, base: int, d: int,
               delay_ns: int = 0) -> None:
        """The D - 1 sends or receives of one call on ``end``
        (``delay_ns``: a sleep before each send, the protocol check)."""
        prev, end.last = end.last, base + d - 1
        self.queues[end.side].put((end, base, d, prev, delay_ns))

    def _serve(self, q) -> None:
        while True:
            job = q.get()
            try:
                if job is None:
                    return
                if self.error is None:
                    self._move(*job)
                else:
                    self._release(job[0])
            except BaseException as e:  # noqa: BLE001 -- kept, raised later
                self.error = self.error or e
                self._release(job[0])
            finally:
                q.task_done()

    def _move(self, end: StagedEnd, base: int, d: int, prev: int,
              delay_ns: int) -> None:
        for k in range(d - 1):
            buf, tag = end.buffers[k % 2], base + k
            if end.side == "out":
                end.wait(FILLED, base + k + 1, self)
                if delay_ns > 0:
                    time.sleep(delay_ns * 1e-9)
                dist.send(buf, end.peer, group=self.group, tag=tag)
                end.flags[EMPTIED] = base + k + 1
                self.moved["out"] += 1
            else:
                end.wait(EMPTIED, stage_wait(base, k, prev), self)
                dist.recv(buf, end.peer, group=self.group, tag=tag)
                end.flags[FILLED] = base + k + 1
                self.moved["in"] += 1

    @staticmethod
    def _release(end: StagedEnd) -> None:
        end.flags[EMPTIED if end.side == "out" else FILLED] = RELEASED

    def drain(self) -> None:
        """Until every job given so far has run (its last send returned)."""
        for q in self.queues.values():
            q.join()

    def close(self) -> None:
        """Once every job ran: stop both threads."""
        self.drain()
        for q in self.queues.values():
            q.put(None)
        for t in self.threads:
            t.join()


_AGENTS: list = []      # this process's agents, once started
_ENDS: dict = {}        # (side, peer, nbytes, device) -> StagedEnd


def _agents() -> _Agents:
    if not _AGENTS:
        _register_release()
        _AGENTS.append(_Agents())
    return _AGENTS[0]


def _stage_end(side: str, peer: int, nbytes: int, device=None) -> StagedEnd:
    key = (side, peer, nbytes, device)
    if key not in _ENDS:
        _ENDS[key] = StagedEnd(side, peer, nbytes, device)
    return _ENDS[key]


def close_agents() -> None:
    """Stop the agents once their jobs ran, then free the staged ends (the
    pinned ones once their cards are idle): the next ring across hosts
    starts anew, on the side group of its time."""
    if _AGENTS:
        _AGENTS.pop().close()
    pinned = [e for e in _ENDS.values() if e.device is not None]
    for dev in {e.device for e in pinned}:
        torch.cuda.synchronize(dev)
    for e in pinned:
        cuda.library().murb_ring_stage_free(e.addr)  # no raise at teardown
    _ENDS.clear()


def _shift(mesh, blocks, link, k: int) -> list:
    """Every block to its right neighbour at step k (``Mesh.ppermute``); on
    a mesh across hosts (``link``) the process boundary through the staged
    ends."""
    if link is None:
        return mesh.ppermute(blocks)
    out, inn, base, out_prev, agents = link
    out.fill(k, base, out_prev, blocks[-1], agents)
    moved = [inn.drain(k, base, blocks[0], agents)] + list(blocks[:-1])
    return [b.to(dv, non_blocking=True)
            for b, dv in zip(moved, mesh.devices)]


@bf16_plain
def acc_ring_pipelined_plain(mesh, qs, gms, soft, *, log=None,
                             host_delay_ns: int = 0) -> list:
    """K14's plain version: D ring steps over two slots a shard, on lists.

    ``qs``: one (qx, qy, qz) block a local shard, ``gms`` one G*m block a
    local shard (G included), each on its shard's device.  Returns one
    Accel a local shard.  Every send of a step goes through
    ``mesh.ppermute``, so on a mesh of processes the last shard's slot
    enters the next process's first shard; on a mesh whose processes
    stand on several hosts every process boundary goes through staged
    ends and the agents instead (``host_delay_ns``: the sending agent's
    sleep before each send).  ``log``, when a list, receives (k, s, slot,
    origin shard of the block), both shards global, for every compute of
    this process, in the order the protocol runs them: the origin travels
    with the block as a fifth row."""
    _check_mesh(mesh, qs, gms)
    l, d = mesh.local_size, mesh.size
    rows = [[*q, g] for q, g in zip(qs, gms)]
    if log is not None:
        rows = [r + [torch.full_like(r[3], float(mesh.axis_index(s)))]
                for s, r in enumerate(rows)]
    slots = [[torch.stack(r), None] for r in rows]
    link = None
    if mesh.distributed and not mesh.single_host:
        agents = _agents()
        pi, pc = mesh.process_index, mesh.process_count
        nbytes = slots[0][0].numel() * slots[0][0].element_size()
        out = _stage_end("out", (pi + 1) % pc, nbytes)
        inn = _stage_end("in", (pi - 1) % pc, nbytes)
        base, out_prev = agents.epoch(d), out.last
        agents.submit(out, base, d, host_delay_ns)
        agents.submit(inn, base, d)
        link = (out, inn, base, out_prev, agents)
    acc = [None] * l
    for k in range(d):
        for s in range(l):
            block = slots[s][k % 2]
            a = acc_tile_rect_plain(*qs[s], *block[:4], soft)
            acc[s] = a if k == 0 else Accel(*(x + y for x, y in
                                             zip(acc[s], a)))
            if log is not None:
                log.append((k, mesh.axis_index(s), k % 2,
                            int(block[4, 0])))
        if k < d - 1:
            # every send of step k lands in the other slot of the right
            # neighbour, which nothing reads at step k
            moved = _shift(mesh, [p[k % 2] for p in slots], link, k)
            for p, m in zip(slots, moved):
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


def _inbound_stream(dev: torch.device):
    """The first shard's inbound stream on ``dev`` (the staged block's
    host-to-device copies), made once."""
    key = (dev.index, "inbound")
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(dev)
    return _STREAMS[key]


@dataclasses.dataclass
class IpcRing:
    """This process's part of one ring across processes, made once a mesh
    layout, shard length and dtype (``_ipc_ring``): its regions (one a
    local shard, from ``murb_ring_ipc_alloc``: flag words, then two
    slots), the two neighbour regions mapped here (the left process's last
    shard's, the right process's first shard's; 0 where that boundary
    crosses hosts), the shards of every process on each local card (K3's
    j split counts them all), whether the mesh's processes stand on
    several hosts, and the calls made so far (the flags' epoch)."""

    regions: list
    left: int
    right: int
    sharing: dict
    hosts: bool = False
    calls: int = 0


#: sizeof(cudaIpcMemHandle_t)
IPC_HANDLE_BYTES = 64

_IPC: dict = {}
_HELD: list = []     # (device, pointer, mapped) of every region, freed at exit
_RELEASE: list = []  # the exit hook, once registered


def _register_release() -> None:
    if not _RELEASE:
        atexit.register(_release)
        _RELEASE.append(_release)


def _release() -> None:
    """At exit: the agents stop and the staged ends go (``close_agents``);
    once this process's cards are idle, the neighbours' regions are
    unmapped and its own freed.  After a call nothing moves into or out of
    a region (csrc/ring.cu), so no neighbour writes into a freed one."""
    close_agents()
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
    this together: the host exchange and one ``Mesh.all_gather_object``).
    Each local shard's region is made with ``cudaMalloc`` and exported;
    the processes exchange their handles, shard counts, slot strides and
    cards (UUIDs, unique across hosts); this process maps only the regions
    it writes into over IPC, the consumers' of the "ipc" edges that leave
    it (``ring_edges``).  A failed allocation, exchange or mapping
    raises."""
    l, pi, pc = mesh.local_size, mesh.process_index, mesh.process_count
    ids = [dv.index for dv in mesh.devices]
    hosts = tuple(mesh.hosts)
    key = (pi, pc, tuple(ids), n, ld, b16, hosts)
    if key in _IPC:
        return _IPC[key]
    _register_release()
    handles, regions, cards = [], [], []
    for i in ids:
        ptr, h = ctypes.c_void_p(), ctypes.create_string_buffer(
            IPC_HANDLE_BYTES)
        cuda.launch("murb_ring_ipc_alloc", i, ld, 2 if b16 else 4,
                    ctypes.byref(ptr), h)
        _HELD.append((i, ptr.value, False))
        uuid = ctypes.create_string_buffer(33)
        cuda.launch("murb_ring_card_uuid", i, uuid, len(uuid))
        regions.append(ptr.value)
        handles.append(h.raw)
        cards.append(uuid.value.decode())
    every = mesh.all_gather_object({"shards": l, "n": n, "ld": ld,
                                    "bf16": b16, "handles": handles,
                                    "cards": cards})
    layouts = {(e["shards"], e["n"], e["ld"], e["bf16"]) for e in every}
    if len(layouts) != 1:
        raise ValueError(f"{TAG}: the processes' rings differ in (shards, "
                         f"n, slot stride, bf16): {sorted(layouts)}")
    mapped = {}
    for _, producer, consumer, kind in ring_edges(pc, l, hosts):
        where = divmod(consumer, l)      # (process, local shard)
        if kind == "ipc" and producer // l == pi and where not in mapped:
            ptr, dev = ctypes.c_void_p(), ids[producer % l]
            handle = ctypes.create_string_buffer(
                every[where[0]]["handles"][where[1]], IPC_HANDLE_BYTES)
            cuda.launch("murb_ring_ipc_open", dev, handle, ctypes.byref(ptr))
            _HELD.append((dev, ptr.value, True))
            mapped[where] = ptr.value
    all_cards = [c for e in every for c in e["cards"]]
    ring = IpcRing(regions, mapped.get(((pi - 1) % pc, l - 1), 0),
                   mapped.get(((pi + 1) % pc, 0), 0),
                   {i: all_cards.count(c) for i, c in zip(ids, cards)},
                   hosts=len(set(hosts)) > 1)
    _IPC[key] = ring
    return ring


def ring_sums(mesh, qs, gms, soft, *, block_i: int = 0, block_j: int = 0,
              delay_ns: int = 0, host_delay_ns: int = 0) -> list:
    """K14 on CUDA shards: one (3, n) float32 tensor of sums a local shard
    (``acc_ring_pipelined``'s outputs before they take the inputs' dtype).

    fp32 inside (float64 inputs are cast here); a bf16 state runs the bf16
    ring on its arrays as they are, its slots (2, 4, ``slot_stride(n)``)
    bf16.  On one process one C call issues the D^2 sweeps (K3's kernel,
    split by ``ring_split`` at its instance's resident count; each shard's
    (slices, 3, n) scratch is allocated here) and D(D - 1) slot copies on
    each shard's compute and copy streams; on a mesh of processes each
    process's call issues its L shards' L D sweeps and copies, its slots in
    ``_ipc_ring``'s regions, and ``ring_split`` counts every process's
    shards on the card: on one host ``murb_ring_pipelined_ipc``, across
    hosts ``murb_ring_pipelined_hosts``, whose staged boundaries
    (``StagedEnd``, pinned) the agents then carry.  Each shard's current
    stream waits for the whole ring.  ``block_i``/``block_j`` pick the
    sweep's compiled geometry (K3's); ``delay_ns`` > 0 sleeps before every
    copy and compute, ``host_delay_ns`` > 0 in the sending agent before
    every send (the protocol check of chip_smoke.py)."""
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
    if not ipc.hosts:
        cuda.launch("murb_ring_pipelined_ipc" + sfx, l, d,
                    mesh.axis_index(0), *head[1:],
                    ctypes.addressof(regions), ipc.left, ipc.right, epoch,
                    *tail)
        if b16:
            fn.ipc_bf16_launches += l * d
        else:
            fn.ipc_launches += l * d
        return outs
    # across hosts: this process's staged ends, where a boundary crosses
    agents = _agents()
    pi, pc = mesh.process_index, mesh.process_count
    nbytes = 4 * ld * (2 if b16 else 4)
    inn = None if ipc.left else _stage_end(
        "in", (pi - 1) % pc, nbytes, mesh.devices[0].index)
    out = None if ipc.right else _stage_end(
        "out", (pi + 1) % pc, nbytes, mesh.devices[-1].index)
    sbase = agents.epoch(d)
    cuda.launch("murb_ring_pipelined_hosts" + sfx, l, d, mesh.axis_index(0),
                *head[1:],
                _inbound_stream(mesh.devices[0]).cuda_stream,
                ctypes.addressof(regions), ipc.left, ipc.right, epoch,
                inn.addr if inn else None, out.addr if out else None, sbase,
                out.last if out else 0, *tail)
    if out:
        agents.submit(out, sbase, d, host_delay_ns)
    if inn:
        agents.submit(inn, sbase, d)
    if b16:
        fn.hosts_bf16_launches += l * d
    else:
        fn.hosts_launches += l * d
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
acc_ring_pipelined.hosts_launches = 0
acc_ring_pipelined.hosts_bf16_launches = 0
