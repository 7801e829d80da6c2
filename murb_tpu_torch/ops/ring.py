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
other path.  The plain version plays the same two-slot protocol on
host-side lists, the sweep in the inputs' dtype.  A ring that spans
processes is not ported (ROADMAP.md Queue 1, item 1).
"""
from __future__ import annotations

import ctypes

import torch

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import Accel, bf16_plain, not_yet_ported, \
    notify_fp32_compute
from murb_tpu_torch.ops.tile import acc_tile_rect_plain

TAG = "shard+ring (pipelined)"


def _check_mesh(mesh, qs, gms) -> None:
    if mesh.distributed:
        raise not_yet_ported("the pipelined ring across processes "
                             "(ring_impl='pipelined' with more than one "
                             "process; ring_impl='ppermute' runs there)",
                             "Queue 1")
    if not len(qs) == len(gms) == mesh.local_size:
        raise ValueError(f"{TAG}: {len(qs)} position and {len(gms)} mass "
                         f"blocks for {mesh.local_size} shards")


@bf16_plain
def acc_ring_pipelined_plain(mesh, qs, gms, soft, *, log=None) -> list:
    """K14's plain version: D ring steps over two slots a shard, on lists.

    ``qs``: one (qx, qy, qz) block a shard, ``gms`` one G*m block a shard
    (G included), each on its shard's device.  Returns one Accel a shard.
    ``log``, when a list, receives (k, s, slot, origin shard of the block)
    for every compute, in the order the protocol runs them."""
    _check_mesh(mesh, qs, gms)
    d = mesh.local_size
    slots = [[(torch.stack([*q, g]), s), None] for s, (q, g)
             in enumerate(zip(qs, gms))]
    acc = [None] * d
    for k in range(d):
        for s in range(d):
            block, origin = slots[s][k % 2]
            a = acc_tile_rect_plain(*qs[s], *block, soft)
            acc[s] = a if k == 0 else Accel(*(x + y for x, y in
                                             zip(acc[s], a)))
            if log is not None:
                log.append((k, s, k % 2, origin))
        if k < d - 1:
            # every send of step k lands in the other slot of the right
            # neighbour, which nothing reads at step k
            sends = [slots[s][k % 2] for s in range(d)]
            for s, (block, origin) in enumerate(sends):
                right = (s + 1) % d
                slots[right][(k + 1) % 2] = (
                    block.to(mesh.devices[right]), origin)
    return acc


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


def acc_ring_pipelined(mesh, qs, gms, soft, *, block_i: int = 0,
                       block_j: int = 0, delay_ns: int = 0) -> list:
    """Per-shard accelerations through the D-step ring.

    CPU shards run the plain version; CUDA shards launch K14 (fp32 inside;
    float64 inputs are cast here and the outputs cast back): one C call
    issues the D^2 sweeps (K3's kernel, split by ``ring_split``; each
    shard's (slices, 3, n) scratch is allocated here) and D(D - 1) slot
    copies on each shard's compute and copy streams, and each shard's
    current stream waits for the whole ring.  ``block_i``/``block_j`` pick
    the sweep's compiled geometry (K3's); ``delay_ns`` > 0 sleeps before
    every copy and compute (the protocol check of chip_smoke.py)."""
    _check_mesh(mesh, qs, gms)
    cuda.check_blocks(TAG, block_i, block_j)
    if all(dv.type == "cpu" for dv in mesh.devices):
        return acc_ring_pipelined_plain(mesh, qs, gms, soft)
    if not mesh.all_cuda:
        raise ValueError(f"{TAG}: shards on {mesh.devices} (all cpu or all "
                         "cuda)")
    cuda.refuse_grad(TAG, soft)
    if not float(soft) > 0.0:
        raise ValueError(f"{TAG}: the sweep needs a positive softening")
    d, n = mesh.local_size, qs[0][0].shape[0]
    dtype = qs[0][0].dtype
    # one split for every sweep, from the card that the most shards share
    dev0 = max(mesh.devices, key=mesh.devices.count)
    slices, per = ring_split(n, cuda.sm_count(dev0),
                             cuda.resident("murb_tile_resident", dev0, block_i,
                                           block_j),
                             mesh.devices.count(dev0), block_i, block_j)
    tgts, bufs, outs, scratch = [], [], [], []
    for dev, q, g in zip(mesh.devices, qs, gms):
        x, y, z, gg = cuda.kernel_inputs(TAG, dev, n, *q, g,
                                         notify=notify_fp32_compute)
        with torch.cuda.device(dev):
            buf = torch.empty((2, 4, n), dtype=torch.float32, device=dev)
            buf[0] = torch.stack([x, y, z, gg])
            outs.append(torch.empty((3, n), dtype=torch.float32, device=dev))
            scratch.append(torch.empty((slices, 3, n) if slices > 1 else 0,
                                       dtype=torch.float32, device=dev))
        tgts.append((x, y, z))
        bufs.append(buf)
    ptrs = lambda ts: (ctypes.c_void_p * d)(*(t.data_ptr() for t in ts))
    arrays = [ptrs(t[c] for t in tgts) for c in range(3)]
    arrays += [ptrs(bufs)] + [ptrs(o[c] for o in outs) for c in range(3)]
    arrays += [ptrs(scratch)]
    ids = (ctypes.c_int * d)(*(dv.index for dv in mesh.devices))
    side = [_side_streams(dv, s) for s, dv in enumerate(mesh.devices)]
    streams = [(ctypes.c_void_p * d)(*v) for v in (
        [torch.cuda.current_stream(dv).cuda_stream for dv in mesh.devices],
        [c.cuda_stream for c, _ in side], [p.cuda_stream for _, p in side])]
    cuda.launch("murb_ring_pipelined", d, n,
                *(ctypes.addressof(a) for a in arrays), ctypes.addressof(ids),
                *(ctypes.addressof(s) for s in streams),
                ctypes.c_float(float(soft) ** 2), block_i, block_j, slices,
                per, int(delay_ns))
    acc_ring_pipelined.launches += d * d
    return [Accel(*(o.to(dtype) for o in out)) for out in outs]


acc_ring_pipelined.launches = 0
