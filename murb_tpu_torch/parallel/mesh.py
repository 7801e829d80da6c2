"""A 1-D device mesh for the sharded engines, and its collectives.

Port of ``murb_tpu/parallel/mesh.py``.  murb_tpu drives every local device
from one controller through ``jax.shard_map``.  Here a ``Mesh`` is an
ordered list of ``torch.device``s, one per shard; a sharded state is one
block per shard, each on its own device; a step runs its per-shard work
shard by shard, and the collectives of ``shard_map`` (``all_gather``,
``psum``, ``pmin``, ``pmax``, ``ppermute``, ``axis_index``) are ``Mesh``
methods over the list of per-shard tensors.  So the step bodies keep
murb_tpu's lines, and they run the same way on the CPU (``shards=D`` makes
D virtual CPU shards, the counterpart of the forced host devices), on one
card and on several.

Across processes (``maybe_init_distributed``) the global mesh is processes
x local shards, in process order: a collective first combines the local
list, then calls ``torch.distributed`` (gloo for CPU shards, NCCL for CUDA
shards, or gloo for CUDA shards when asked, as processes that share one
card need), and hands the result back to every local shard.  The host
exchange (``Mesh.all_gather_object``, ``Mesh.hosts``) tells the pipelined
ring (ops/ring.py) which of its process boundaries stay on one host (CUDA
IPC) and which cross hosts (staged through host memory and sent on
``side_group``, a gloo group beside the main one).  A process's host is
``host_name()`` unless ``make_mesh(host=...)`` names it: processes of one
machine placed on separate hosts run exactly the code of a multi-host run.
``destroy_distributed`` stops the ring's agent threads, then the groups.
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from murb_tpu_torch.core.state import FIELDS, BodyState

SHARD_AXIS = "sh"


def _world() -> tuple[int, int]:
    """(process index, process count) of the distributed runtime, (0, 1)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """The shards this process drives, in global order: local shard k has
    axis index ``process_index * local_size + k``."""

    def __init__(self, devices, *, process_index: int = 0,
                 process_count: int = 1, host: str | None = None):
        self.devices = [torch.device(d) for d in devices]
        self.devices = [torch.device("cuda", torch.cuda.current_device())
                        if d.type == "cuda" and d.index is None else d
                        for d in self.devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.host = host
        self._hosts = None

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards of the global mesh (the ``D`` of the step bodies)."""
        return self.local_size * self.process_count

    @property
    def distributed(self) -> bool:
        return self.process_count > 1

    @property
    def all_cuda(self) -> bool:
        return all(d.type == "cuda" for d in self.devices)

    def axis_index(self, k: int) -> int:
        """Global index of local shard ``k`` (``lax.axis_index``)."""
        return self.process_index * self.local_size + k

    # ------------------------------------------------------ host exchange
    def all_gather_object(self, obj) -> list:
        """Every process's ``obj`` (picklable), in process order: one
        ``torch.distributed.all_gather_object``, which gloo and NCCL both
        run; ``[obj]`` on one process."""
        if not self.distributed:
            return [obj]
        out = [None] * self.process_count
        dist.all_gather_object(out, obj)
        return out

    @property
    def hosts(self) -> list[str]:
        """Each process's host (``host``, else ``host_name()``), in process
        order, exchanged once a mesh (every process must ask, as for any
        collective)."""
        if self._hosts is None:
            self._hosts = self.all_gather_object(self.host or host_name())
        return self._hosts

    @property
    def single_host(self) -> bool:
        """Whether every process of the mesh runs on this host."""
        return len(set(self.hosts)) == 1

    # ---------------------------------------------------------- collectives
    def _scatter(self, t: torch.Tensor) -> list[torch.Tensor]:
        """One copy of ``t`` on every local shard's device."""
        return [t.to(d, non_blocking=True) for d in self.devices]

    def all_gather(self, blocks) -> list[torch.Tensor]:
        """The blocks of every shard concatenated along dim 0 in axis order
        (``all_gather(..., tiled=True)``), on every shard."""
        home = self.devices[0]
        full = torch.cat([b.to(home, non_blocking=True) for b in blocks])
        if self.distributed:
            parts = [torch.empty_like(full) for _ in range(self.process_count)]
            dist.all_gather(parts, full.contiguous())
            full = torch.cat(parts)
        return self._scatter(full)

    def _reduce(self, blocks, combine, op) -> list[torch.Tensor]:
        home = self.devices[0]
        out = blocks[0].to(home, non_blocking=True)
        for b in blocks[1:]:
            out = combine(out, b.to(home, non_blocking=True))
        if self.distributed:
            out = out.contiguous().clone()
            dist.all_reduce(out, op=op)
        return self._scatter(out)

    def psum(self, blocks) -> list[torch.Tensor]:
        return self._reduce(blocks, torch.add, dist.ReduceOp.SUM)

    def pmin(self, blocks) -> list[torch.Tensor]:
        return self._reduce(blocks, torch.minimum, dist.ReduceOp.MIN)

    def pmax(self, blocks) -> list[torch.Tensor]:
        return self._reduce(blocks, torch.maximum, dist.ReduceOp.MAX)

    def ppermute(self, blocks) -> list[torch.Tensor]:
        """Every shard's block to its right neighbour, the last to the first
        (``ppermute`` with perm ``[(k, (k + 1) % D)]``)."""
        incoming = blocks[-1]
        if self.distributed:
            # the block leaving this process's last shard enters the next
            # process's first shard
            last = blocks[-1].to(self.devices[0]).contiguous()
            parts = [torch.empty_like(last) for _ in range(self.process_count)]
            dist.all_gather(parts, last)
            incoming = parts[(self.process_index - 1) % self.process_count]
        moved = [incoming] + list(blocks[:-1])
        return [b.to(d, non_blocking=True)
                for b, d in zip(moved, self.devices)]


def host_name() -> str:
    """This process's host, as the mesh's host exchange reports it."""
    return socket.gethostname()


def make_mesh(shards: int = 0, *, device="cuda", devices=None,
              host: str | None = None) -> Mesh:
    """A 1-D mesh of ``shards`` shards over the global mesh (0 = all local
    devices in every process).

    ``devices`` (an explicit list, one entry per local shard) may put
    several shards on one card: the API's way to check a multi-shard mode
    on one card.  Without it, CUDA shards (the default) take the first
    local cards, one each, and may not outnumber them
    (murb_tpu/parallel/mesh.py:21-22); with no card at all this raises
    before building anything.  CPU shards (``device="cpu"``) are virtual,
    any number of them on the CPU.  ``host`` names this process's host in
    the mesh's host exchange (default ``host_name()``)."""
    pi, pc = _world()
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if shards and shards != len(devices) * pc:
            raise ValueError(f"requested {shards} shards but the device list "
                             f"gives {len(devices) * pc}")
        return Mesh(devices, process_index=pi, process_count=pc, host=host)
    device = torch.device(device)
    avail = torch.cuda.device_count() if device.type == "cuda" else None
    if avail == 0:
        raise RuntimeError("make_mesh: CUDA shards asked for but no CUDA "
                           "device is available (pass device='cpu' for "
                           "virtual CPU shards)")
    total = shards or pc * (avail if avail is not None else 1)
    if total % pc:
        raise ValueError(f"requested {total} shards over {pc} processes")
    local = total // pc
    if avail is not None and local > avail:
        raise ValueError(f"requested {total} shards but only "
                         f"{avail * pc} devices")
    if device.type == "cuda":
        return Mesh([torch.device("cuda", k) for k in range(local)],
                    process_index=pi, process_count=pc, host=host)
    return Mesh([device] * local, process_index=pi, process_count=pc,
                host=host)


def shard_state(state: BodyState, mesh: Mesh) -> list[BodyState]:
    """Block-split the global state over the mesh: this process's blocks,
    each on its shard's device (a block's n is its length, with no padding
    of its own).  The padded length must divide by the mesh's size."""
    if state.npad % mesh.size:
        raise ValueError(f"npad {state.npad} is not a multiple of "
                         f"{mesh.size} shards")
    b = state.npad // mesh.size
    rows = [slice(mesh.axis_index(k) * b, (mesh.axis_index(k) + 1) * b)
            for k in range(mesh.local_size)]
    return [BodyState(**{k: getattr(state, k)[r].to(d) for k in FIELDS},
                      n=b, padding=0) for r, d in zip(rows, mesh.devices)]


def replicate_state(state: BodyState, mesh: Mesh) -> list[BodyState]:
    """One full copy of the state on every shard's device."""
    return [state.to(d) for d in mesh.devices]


def gather_state(blocks, mesh: Mesh, n: int, padding: int) -> BodyState:
    """The global state from its blocks, on the first shard's device (an
    observation point: every process gets the whole state)."""
    return BodyState(**{k: mesh.all_gather([getattr(b, k) for b in blocks])[0]
                        for k in FIELDS}, n=n, padding=padding)


def maybe_init_distributed(device="cuda", backend: str | None = None) -> bool:
    """Multi-process bring-up: initialise ``torch.distributed`` when the
    environment names a coordinator (the variables murb_tpu reads):
    ``MURB_COORDINATOR`` (host:port), ``MURB_NUM_PROCESSES`` and
    ``MURB_PROCESS_ID``.  gloo for CPU shards (``device="cpu"``), NCCL for
    CUDA shards (the default); ``backend="gloo"`` with CUDA shards lets
    several processes share one card (NCCL refuses two ranks on one
    device); CUDA with no card raises and starts nothing.  Returns True if
    the runtime is up."""
    coord = os.environ.get("MURB_COORDINATOR")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("maybe_init_distributed: CUDA shards asked for but "
                           "no CUDA device is available (pass device='cpu' "
                           "for gloo on CPU shards)")
    rank = int(os.environ.get("MURB_PROCESS_ID", "0"))
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    # use_libuv=0: with the TCP store's libuv backend a process now and
    # then aborted at exit ("terminate called without an active
    # exception") after destroy_process_group, under load
    dist.init_process_group(
        backend or ("nccl" if cuda else "gloo"),
        init_method=f"tcp://{coord}?use_libuv=0",
        world_size=int(os.environ.get("MURB_NUM_PROCESSES", "1")), rank=rank)
    return True


#: the side group's timeout: a staged edge's send or receive that waits
#: longer fails (ops/ring.py's agents)
SIDE_TIMEOUT_S = 300.0

_SIDE = []                  # the side group, once made


def side_group():
    """A gloo group of every process beside the main group, made once, by
    every process together (its first call is a collective of the main
    group).  The pipelined ring's staged edges send and receive on it from
    agent threads (ops/ring.py) while the main thread runs the main
    group's collectives; gloo runs point to point whatever the main
    backend (NCCL for CUDA shards)."""
    if not _SIDE:
        timeout = datetime.timedelta(seconds=SIDE_TIMEOUT_S)
        _SIDE.append(dist.new_group(backend="gloo", timeout=timeout))
    return _SIDE[0]


def destroy_distributed() -> None:
    """Tear down what ``maybe_init_distributed`` brought up: first the
    pipelined ring's agent threads finish their sends and receives and
    stop (``ops/ring.close_agents``), then the side group and the main
    group go."""
    from murb_tpu_torch.ops.ring import close_agents

    close_agents()
    _SIDE.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
