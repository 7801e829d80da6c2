"""Grid and level-sweep stages of the multi-level hierarchy: kernels K7
(M2L level sweep), K8 (grid P2M) and K9 (grid L2P) and their plain versions.

Port of ``murb_tpu/ops/fmm_pallas.py`` together with the stages it fuses,
``p2m_grid``, ``m2l_level`` and ``l2p_grid`` of ``murb_tpu/ops/fmm.py``.
The plain versions are those jnp stages written in PyTorch: the cell
segment sum of P2M as ``index_add_``, the own-cell gather of L2P, and the
level sweep over the canonical offset pairs with its mirror identity and
parity masks.  The CUDA kernels (``csrc/fmm.cu``) compute the same
functions in fp32.  K7 has two instances, one per dot tier of murb_tpu's
``m2l_level_fused(exact_dots=...)``: ``dots="fp32"`` (exact_dots=True)
and the lossy ``dots="bf16x3"`` (exact_dots=False), whose apply runs as
three TF32 tensor-core products of split operands (``ops/mxu.
split3_matmul``'s arithmetic, which its plain version computes): the
tier's accuracy contract, not murb_tpu's bf16 mechanism.

``p2m_grid_fused``, ``m2l_level_fused`` and ``l2p_grid_fused`` run the
plain version on CPU tensors and launch the kernel on CUDA tensors, and
count each launch.  For K8 and K9 the wrapper orders the bodies by cell
(``cell_order``: the cell ids, a stable sort, the cell bounds), so the
kernels read each cell's bodies as one run; callers that run both stages
on one box pass one ``CellOrder`` to both.  The box stays on the device.
For K7 the wrapper hands the kernel its plan (``m2l_plan``, host numpy,
copied to the device once a shape): each offset's admitted target cells
in items of up to ``M2L_GROUP``, whose transfer entries the kernel builds
once, and their split over the card (each instance's own resident
blocks).  ``m2l_level_fused.launches`` counts the fp32 instance's
launches, ``m2l_level_fused.lossy_launches`` the lossy one's.  A bf16
state launches K8's and K9's bf16 instances (``murb_p2m_grid_bf16``,
``murb_l2p_grid_bf16``), which read the bodies as they are and compute in
fp32, counted in ``bf16_launches``; K7 takes the float32 weights.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import (bf16_plain, notify_fp32_compute,
                                       weights_dtype)
from murb_tpu_torch.ops.mxu import split3_matmul
from murb_tpu_torch.ops.proxy_kernels import _basis, _entry, node_table

#: largest order and cells per dimension the kernels take (csrc/fmm.cu,
#: csrc/cell_runs.cuh)
MAX_ORDER = 32
MAX_CELLS = 16
#: node fields one grid L2P call takes: force (3) plus up to 8 potentials
MAX_FIELDS = 11
_L2P_GROUP = 4       # fields one K9 launch takes (kRunFields)
#: the run kernels' geometry (csrc/cell_runs.cuh): the largest padded order
#: at which a warp runs an item, the bodies a P2M block stages a tile above
#: it (a warp stages 32), the L2P's bodies an item (a warp's, a block's),
#: the most bodies a P2M item takes, and the P2M items a card's SM should
#: get (warp items; block items above RUN_WARP_MAX_MW)
RUN_WARP_MAX_MW = 8        # kRunWarpMaxMW
RUN_P2M_TILE = 64          # kRunP2MTile
RUN_L2P_WARP_ITEM = 64     # 32 kRunL2PLaneBodies
RUN_L2P_BLOCK_ITEM = 256   # 32 kRunL2PThreadBodies
RUN_P2M_MAX_CHUNK = 1024
RUN_P2M_ITEMS_AN_SM = (8, 4)
#: the P2M fold's item lanes an output where the runs hold that many items
#: on average (kRunFoldSplit; else 1)
RUN_FOLD_SPLIT = 32
#: K7's geometry (csrc/fmm.cu): target nodes a block, target cells an
#: item, cells per dimension of a cell tile, the most offset splits
M2L_TARGETS = 128    # kM2LTargets
M2L_GROUP = 16       # kM2LGroup
M2L_CELL_TILE = 4
M2L_MAX_SPLIT = 64   # kM2LMaxSplit
#: int32 fields of an item and of a block row of the plan (kM2LItemInts,
#: kM2LRowInts)
M2L_ITEM_INTS = 8 + 2 * M2L_GROUP
M2L_ROW_INTS = 12
#: the offset subsets: (reach, least |o|_inf, parity rule)
_M2L_SUBSETS = {"expand": (3, 0, True), "near": (1, 0, False),
            "far": (3, 2, True)}
#: K7's instances: the dot tier -> its C entries (sweep, resident blocks)
M2L_DOTS = {"fp32": ("murb_m2l_level", "murb_m2l_resident"),
            "bf16x3": ("murb_m2l_level_lossy", "murb_m2l_resident_lossy")}
_PLAIN_CHUNK = 8192  # bodies per step of the plain P2M / L2P
#: entries of the transfer matrix T the plain M2L builds at a time: all of
#: it up to m = 20, row blocks above (8.6 GB a whole matrix at m = 32 in
#: float64)
_PLAIN_M2L_ENTRIES = 1 << 26
_TAG = "tpu+proxy/fmm (grid kernels)"


def _check_grid(m: int, C: int) -> None:
    if not 2 <= m <= MAX_ORDER:
        raise ValueError(f"{_TAG}: order m={m} outside the kernels' range "
                         f"[2, {MAX_ORDER}]")
    if not 1 <= C <= MAX_CELLS:
        raise ValueError(f"{_TAG}: C={C} cells per dimension outside the "
                         f"kernels' range [1, {MAX_CELLS}]")


# ------------------------------------------------------------ plain P2M/L2P
def _cell_coords(q, lo, cs, C: int):
    """(cell index (int64), in-cell Chebyshev coordinate t): cell =
    clip(floor((q - lo) / cs), 0, C - 1), t = 2 ((q - lo) / cs - cell) - 1
    (murb_tpu/ops/fmm.py:_cell_coords)."""
    u = (q - lo) / cs
    cx = torch.floor(u).clamp(0.0, C - 1.0)
    return cx.long(), 2.0 * (u - cx) - 1.0


def cell_box(c, h, C: int):
    """(lo (3,), cs (3,)): a C^3 grid's corner and cell size over the box
    (c, h), in float32 at least (a bf16 box upcast first, exactly: the bf16
    rule of the chains outside the kernels, ops/common.bf16_chain), as the
    run kernels (K8, K9, K11, K12) read it."""
    ct = torch.promote_types(c.dtype, torch.float32)
    c, h = c.to(ct), h.to(ct)
    return c - h, 2.0 * h / C


def _grid_bases(qx, qy, qz, c, h, m: int, C: int):
    """(cell id, Sx, Sy, Sz) of each body on the C^3 grid over the box."""
    lo = c - h
    cs = 2.0 * h / C
    cx, tx = _cell_coords(qx, lo[0], cs[0], C)
    cy, ty = _cell_coords(qy, lo[1], cs[1], C)
    cz, tz = _cell_coords(qz, lo[2], cs[2], C)
    return (cx * C + cy) * C + cz, _basis(tx, m), _basis(ty, m), _basis(tz, m)


@bf16_plain(round_outputs=False)
def p2m_grid_plain(qx, qy, qz, gm_eff, c, h, *, m: int,
                   C: int) -> torch.Tensor:
    """W (C^3, m^3): per-cell source expansions, each body into its own
    cell (the segment sum as ``index_add_``), in the inputs' dtype."""
    n = qx.shape[0]
    w = torch.zeros((C ** 3, m ** 3), dtype=qx.dtype, device=qx.device)
    for s in range(0, n, _PLAIN_CHUNK):
        e = s + _PLAIN_CHUNK
        cid, sx, sy, sz = _grid_bases(qx[s:e], qy[s:e], qz[s:e], c, h, m, C)
        svw = (sy[:, :, None] * sz[:, None, :]).reshape(-1, m * m)
        outer = ((gm_eff[s:e, None] * sx)[:, :, None]
                 * svw[:, None, :]).reshape(-1, m ** 3)
        w.index_add_(0, cid, outer)
    return w


@bf16_plain
def l2p_grid_plain(qx, qy, qz, c, h, fields, *, m: int, C: int) -> tuple:
    """Interpolate (C^3, m^3) node fields back to the bodies, each body
    from its own cell -> tuple of (n,), in the inputs' dtype."""
    n = qx.shape[0]
    outs = [[] for _ in fields]
    for s in range(0, n, _PLAIN_CHUNK):
        e = s + _PLAIN_CHUNK
        cid, sx, sy, sz = _grid_bases(qx[s:e], qy[s:e], qz[s:e], c, h, m, C)
        b = cid.shape[0]
        for out, f in zip(outs, fields):
            fg = f[cid].reshape(b, m, m * m)              # own-cell gather
            t1 = torch.einsum("bu,bup->bp", sx, fg).reshape(b, m, m)
            t2 = torch.einsum("bv,bvw->bw", sy, t1)
            out.append((sz * t2).sum(1))
    return tuple(torch.cat(o) for o in outs)


# ----------------------------------------------------------- plain M2L
def _node_vectors(hl, m: int, dtype, device):
    """Flat (m^3,) node coordinates of one cell, x-major, scaled by the
    level's half-widths ``hl`` (3,)."""
    k = torch.arange(m, dtype=torch.float64, device=device)
    t = torch.cos(math.pi * (k + 0.5) / m).to(dtype)
    m2 = m * m
    return (hl[0] * t.repeat_interleave(m2),
            hl[1] * t.repeat_interleave(m).repeat(m),
            hl[2] * t.repeat(m2))


def _parity_mask(o, even, C: int) -> torch.Tensor:
    """(C^3, 1) target-parity validity of offset o: |o_d| = 3 needs near
    parents, +3 iff the target index is even, -3 iff odd."""
    def mk(od):
        if od == 3:
            return even
        if od == -3:
            return ~even
        return torch.ones_like(even)

    return (mk(o[0])[:, None, None] & mk(o[1])[None, :, None]
            & mk(o[2])[None, None, :]).reshape(C ** 3, 1)


def _check_dots(dots: str) -> None:
    if dots not in M2L_DOTS:
        raise ValueError(f"unknown K7 dot tier {dots!r} "
                         f"({', '.join(M2L_DOTS)})")


def m2l_level_plain(w, hl, soft, *, m: int, C: int, subset: str = "expand",
                    with_phi: bool = False, dots: str = "fp32") -> tuple:
    """Node fields (fx, fy, fz[, phi]), each (C^3, m^3), from the level's
    expansions ``w`` (murb_tpu/ops/fmm.py:m2l_level): for each canonical
    offset pair one transfer build T(o), applied to the +o-shifted weights
    and, by the mirror identity T(-o) = -T(o)^T (+T^T for phi), to the
    -o-shifted ones.  Out-of-grid offsets read zero-padded weights.
    ``dots="bf16x3"`` applies T by ``split3_matmul`` (K7's lossy
    instance's arithmetic) for float32 input; float64 runs unrounded."""
    from murb_tpu_torch.ops.fmm import _SUBSETS, _offsets_paired

    _check_dots(dots)
    if w.dtype == torch.bfloat16:  # K7 upcasts and casts the fields back
        return tuple(f.to(w.dtype) for f in m2l_level_plain(
            w.float(), hl, soft, m=m, C=C, subset=subset,
            with_phi=with_phi, dots=dots))
    if hl.dtype == torch.bfloat16:  # exact; the kernel reads hl in fp32
        hl = hl.float()
    dtype, dev = w.dtype, w.device
    mm = (split3_matmul if dots == "bf16x3" and dtype == torch.float32
          else torch.matmul)
    m3 = m ** 3
    soft2 = torch.tensor(soft, dtype=dtype) ** 2
    wpad = F.pad(w.reshape(C, C, C, m3), (0, 0, 3, 3, 3, 3, 3, 3))
    even = (torch.arange(C, device=dev) % 2) == 0
    offsets, neg_valid = _offsets_paired(*_SUBSETS[subset])
    pxv, pyv, pzv = _node_vectors(hl, m, dtype, dev)

    def shifted(o):
        ws = wpad[3 + o[0]:3 + o[0] + C, 3 + o[1]:3 + o[1] + C,
                  3 + o[2]:3 + o[2] + C].reshape(C ** 3, m3)
        if subset != "near":
            ws = torch.where(_parity_mask(o, even, C), ws, 0.0)
        return ws

    fields = [torch.zeros((C ** 3, m3), dtype=dtype, device=dev)
              for _ in range(4 if with_phi else 3)]
    rows = max(1, _PLAIN_M2L_ENTRIES // m3)  # target nodes of T a step
    for o, nv in zip(offsets.tolist(), neg_valid.tolist()):
        if max(map(abs, o)) >= C:
            continue  # both shifts read only zero padding: adds exactly 0
        wp = shifted(o)
        wn = shifted([-x for x in o]) * nv
        for u0 in range(0, m3, rows):
            u = slice(u0, u0 + rows)
            # D[u, v] = p_v - p_u = 2 hl o + (pv[v] - pv[u]), per dimension
            dx = 2.0 * hl[0] * o[0] + (pxv[None, :] - pxv[u, None])
            dy = 2.0 * hl[1] * o[1] + (pyv[None, :] - pyv[u, None])
            dz = 2.0 * hl[2] * o[2] + (pzv[None, :] - pzv[u, None])
            inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + soft2)
            inv3 = inv * inv * inv
            ts = [dx * inv3, dy * inv3, dz * inv3] + ([inv] if with_phi
                                                      else [])
            for i, t in enumerate(ts):
                sign = 1.0 if i == 3 else -1.0
                fields[i][:, u] += mm(wp, t.T)
                fields[i] += sign * mm(wn[:, u], t)
    return tuple(fields)


# ------------------------------------------------------------ cell order
class CellOrder(NamedTuple):
    """The bodies of one box ordered by their cell on the C^3 grid, as the
    K8 and K9 kernels read them (device tensors)."""

    box: torch.Tensor      # (6,) float32: lo (3), cell sizes (3)
    perm: torch.Tensor     # (n,) int64: body indices, cell by cell
    bounds: torch.Tensor   # (C^3 + 1,) int64: cell c is
    C: int                 #   perm[bounds[c]:bounds[c + 1]]


def cell_order(qx, qy, qz, c, h, C: int) -> CellOrder:
    """Each body's cell id from the float32 box [lo, cs] the kernels read,
    a stable sort of the ids and the cell bounds: glue around K8 and K9,
    all on the device, no host sync (the bounds come from a search of the
    sorted ids; ``torch.bincount`` would read the largest id back to the
    host)."""
    box = torch.cat(cell_box(c, h, C)).to(torch.float32)
    q = torch.stack([qx, qy, qz]).to(torch.float32)
    cell = torch.floor((q - box[:3, None]) / box[3:, None]).clamp_(0, C - 1)
    cell = cell.long()
    cid = (cell[0] * C + cell[1]) * C + cell[2]
    ids, perm = torch.sort(cid, stable=True)
    bounds = torch.searchsorted(
        ids, torch.arange(C ** 3 + 1, device=ids.device))
    return CellOrder(box, perm, bounds, C)


# ------------------------------------------------- the run kernels' glue
class RunItems(NamedTuple):
    """The work items of a run kernel (K8, K9, K11, K12) over runs with
    bounds ``bounds``: run r's items are prefix[r] .. prefix[r + 1] - 1,
    each of at most ``chunk`` bodies, ``nitems`` at least prefix[-1] (the
    kernels find each item's run in the prefix themselves)."""

    bounds: torch.Tensor
    prefix: torch.Tensor
    nitems: int
    chunk: int


def padded_order(m: int) -> int:
    """m rounded up to a multiple of 4: the width the kernels compile for
    (MURB_DISPATCH_MW)."""
    return (m + 3) // 4 * 4


def run_items(bounds: torch.Tensor, n: int, chunk: int) -> RunItems:
    """The work items of at most ``chunk`` bodies over runs with ``bounds``
    (nrun + 1 offsets into n bodies): sum_r ceil(n_r / chunk) <= n /
    chunk + nrun, so the item count needs no host sync."""
    per = (bounds.diff() + chunk - 1) // chunk
    prefix = F.pad(per.cumsum(0), (1, 0))
    return RunItems(bounds, prefix, n // chunk + bounds.shape[0], chunk)


def p2m_tile(m: int) -> int:
    """Bodies a P2M work item stages a tile at order m: 32 (a warp item,
    padded order up to RUN_WARP_MAX_MW), else RUN_P2M_TILE (a block
    item)."""
    return 32 if padded_order(m) <= RUN_WARP_MAX_MW else RUN_P2M_TILE


def p2m_chunk(n: int, m: int, sms: int) -> int:
    """Bodies a P2M work item of n bodies at order m on a card of ``sms``
    SMs: the tile (``p2m_tile``) doubled while the items would still give
    each SM its RUN_P2M_ITEMS_AN_SM, up to RUN_P2M_MAX_CHUNK (at N = 1M
    and m > 8, 1024 bodies: the partials' round trip stays under a tenth
    of the product)."""
    chunk = p2m_tile(m)
    want = RUN_P2M_ITEMS_AN_SM[0 if chunk == 32 else 1] * sms
    while chunk < RUN_P2M_MAX_CHUNK and 2 * chunk * want <= n:
        chunk *= 2
    return chunk


def check_p2m_chunk(chunk: int, m: int) -> None:
    """Raise ValueError unless ``chunk`` is a P2M work item the run kernels
    take at order m: a multiple of ``p2m_tile(m)`` from the tile to
    RUN_P2M_MAX_CHUNK (callers pass 0 for ``p2m_chunk``'s pick unchecked)."""
    tile = p2m_tile(m)
    if chunk % tile or not tile <= chunk <= RUN_P2M_MAX_CHUNK:
        raise ValueError(f"{_TAG}: a P2M item of {chunk} bodies at m={m}; "
                         f"the run kernels take multiples of {tile} from "
                         f"{tile} to {RUN_P2M_MAX_CHUNK}")


def fold_split(nitems: int, nrun: int) -> int:
    """The P2M fold's item lanes an output (csrc/cell_runs.cuh fold_split):
    RUN_FOLD_SPLIT where ``nitems`` (the items' upper bound) is at least
    RUN_FOLD_SPLIT a run, else 1 (a thread an output, the items in
    order)."""
    return RUN_FOLD_SPLIT if nitems >= RUN_FOLD_SPLIT * nrun else 1


def l2p_item(m: int) -> int:
    """Bodies an L2P work item at order m (a warp's or a block's)."""
    return (RUN_L2P_WARP_ITEM if padded_order(m) <= RUN_WARP_MAX_MW
            else RUN_L2P_BLOCK_ITEM)


def p2m_outputs(items: RunItems, n: int, nrun: int, m: int, dev):
    """(W (nrun, m^3), partial scratch or None) of a P2M run kernel over n
    bodies: when a run may have several items (chunk < n) their partials
    go through scratch and the kernel's second launch adds them; else
    every run has at most one item, which writes its row of W, and W is
    zeroed for the runs of none."""
    fold = items.chunk < n
    w = (torch.empty if fold else torch.zeros)((nrun, m ** 3),
                                               dtype=torch.float32,
                                               device=dev)
    partial = (torch.empty(items.nitems * m ** 3, dtype=torch.float32,
                           device=dev) if fold else None)
    return w, partial


def _order_for(order, x, y, z, c, h, C: int) -> CellOrder:
    if order is None:
        return cell_order(x, y, z, c, h, C)
    if order.C != C or order.perm.shape[0] != x.shape[0]:
        raise ValueError(f"{_TAG}: cell order for C={order.C}, "
                         f"n={order.perm.shape[0]}; expected C={C}, "
                         f"n={x.shape[0]}")
    return order


# ----------------------------------------------------------- K8 wrapper
def p2m_grid_items(order: CellOrder, m: int, chunk: int = 0) -> RunItems:
    """K8's work items over ``order``'s cells, of ``chunk`` bodies (0:
    ``p2m_chunk``'s pick for the card)."""
    n = order.perm.shape[0]
    return run_items(order.bounds, n, chunk or p2m_chunk(
        n, m, cuda.sm_count(order.perm.device)))


def p2m_grid_launch(x, y, z, g, order: CellOrder, items: RunItems,
                    m: int) -> torch.Tensor:
    """K8 alone on float32 inputs (its bf16 instance on bf16 ones), their
    cell order and work items -> W (C^3, m^3) float32."""
    dev, C = x.device, order.C
    w, partial = p2m_outputs(items, x.shape[0], C ** 3, m, dev)
    with torch.cuda.device(dev):
        cuda.launch(_entry("murb_p2m_grid", x), x.data_ptr(), y.data_ptr(),
                    z.data_ptr(), g.data_ptr(), order.perm.data_ptr(),
                    order.box.data_ptr(), m, C, items.bounds.data_ptr(),
                    items.prefix.data_ptr(), items.nitems, items.chunk,
                    node_table(m, dev).data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    w.data_ptr(), cuda.stream(dev))
    return w


def p2m_grid_fused(qx, qy, qz, gm_eff, c, h, *, m: int, C: int,
                   order: CellOrder | None = None,
                   chunk: int = 0) -> torch.Tensor:
    """W (C^3, m^3) = grid P2M.  CPU tensors run ``p2m_grid_plain``; CUDA
    tensors launch K8 (fp32 inside; float64 inputs are cast here, W cast
    back; bf16 inputs take the bf16 instance, counted in ``bf16_launches``,
    W float32) in work items of ``chunk`` bodies (0: ``p2m_chunk``'s pick;
    else ``check_p2m_chunk``'s range, on either device; the plain version
    has no items)."""
    _check_grid(m, C)
    if chunk:
        check_p2m_chunk(chunk, m)
    if qx.device.type == "cpu":
        return p2m_grid_plain(qx, qy, qz, gm_eff, c, h, m=m, C=C)
    cuda.require_cuda(_TAG, qx)
    cuda.refuse_grad(_TAG, c, h)
    dtype, dev, n = qx.dtype, qx.device, qx.shape[0]
    b16 = cuda.all_bf16(qx, qy, qz, gm_eff)
    x, y, z, g = cuda.kernel_inputs(_TAG, dev, n, qx, qy, qz, gm_eff,
                                    notify=notify_fp32_compute, bf16=b16)
    order = _order_for(order, x, y, z, c, h, C)
    w = p2m_grid_launch(x, y, z, g, order, p2m_grid_items(order, m, chunk),
                        m)
    if b16:
        p2m_grid_fused.bf16_launches += 1
    else:
        p2m_grid_fused.launches += 1
    return w.to(weights_dtype(dtype))


p2m_grid_fused.launches = 0
p2m_grid_fused.bf16_launches = 0


# ----------------------------------------------------------- K9 wrapper
def l2p_grid_items(order: CellOrder, m: int) -> RunItems:
    """K9's work items over ``order``'s cells."""
    return run_items(order.bounds, order.perm.shape[0], l2p_item(m))


def l2p_grid_launch(x, y, z, order: CellOrder, items: RunItems, m: int,
                    fields) -> torch.Tensor:
    """K9 alone on float32 inputs (its bf16 instance on bf16 ones), their
    cell order and work items and 1 to 11 float32 contiguous (C^3, m^3)
    fields -> (k, n) float32, one launch per group of at most 4 fields."""
    dev, n, k = x.device, x.shape[0], len(fields)
    out = torch.empty((k, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cuda.launch(_entry("murb_l2p_grid", x), x.data_ptr(), y.data_ptr(),
                    z.data_ptr(), order.perm.data_ptr(), n,
                    order.box.data_ptr(), m, order.C,
                    items.bounds.data_ptr(), items.prefix.data_ptr(),
                    items.nitems, node_table(m, dev).data_ptr(),
                    cuda.field_pointers(fields), k, out.data_ptr(),
                    cuda.stream(dev))
    return out


def l2p_grid_fused(qx, qy, qz, c, h, fields, *, m: int, C: int,
                   order: CellOrder | None = None) -> tuple:
    """Interpolate 1 to 11 (C^3, m^3) node fields to the bodies -> tuple of
    (n,).  CPU tensors run ``l2p_grid_plain``; CUDA tensors launch K9 once
    per group of at most 4 fields, and count each launch (a bf16 state's,
    its bf16 instance's, in ``bf16_launches``)."""
    _check_grid(m, C)
    k = len(fields)
    if not 1 <= k <= MAX_FIELDS:
        raise ValueError(f"{_TAG}: grid L2P takes 1 to {MAX_FIELDS} node "
                         f"fields, got {k}")
    for f in fields:
        if tuple(f.shape) != (C ** 3, m ** 3):
            raise ValueError(f"{_TAG}: node field of shape "
                             f"{tuple(f.shape)}, expected {(C ** 3, m ** 3)}")
    if qx.device.type == "cpu":
        return l2p_grid_plain(qx, qy, qz, c, h, fields, m=m, C=C)
    cuda.require_cuda(_TAG, qx)
    cuda.refuse_grad(_TAG, c, h, *fields)
    dtype, dev, n = qx.dtype, qx.device, qx.shape[0]
    b16 = cuda.all_bf16(qx, qy, qz)
    x, y, z = cuda.kernel_inputs(_TAG, dev, n, qx, qy, qz,
                                 notify=notify_fp32_compute, bf16=b16)
    order = _order_for(order, x, y, z, c, h, C)
    flds = [f.to(torch.float32).contiguous() for f in fields]
    out = l2p_grid_launch(x, y, z, order, l2p_grid_items(order, m), m, flds)
    if b16:
        l2p_grid_fused.bf16_launches += -(-k // _L2P_GROUP)
    else:
        l2p_grid_fused.launches += -(-k // _L2P_GROUP)
    return tuple(o.to(dtype) for o in out)


l2p_grid_fused.launches = 0
l2p_grid_fused.bf16_launches = 0


# ----------------------------------------------------------- K7 wrapper
def m2l_axis(o: int, C: int, parity: bool) -> range:
    """Target indices along one dimension that offset component ``o``
    admits: the source index i + o inside [0, C) and, under the parity
    rule, an even i for o = +3 and an odd i for o = -3 (``_parity_mask``)."""
    lo, hi = max(0, -o), min(C, C - o)
    if parity and abs(o) == 3:
        lo += (lo - (0 if o == 3 else 1)) % 2
        return range(lo, hi, 2)
    return range(lo, hi)


class M2LPlan(NamedTuple):
    """K7's work for one (m, C, subset) on a card with ``slots`` resident
    blocks (SMs times the blocks an SM holds at once): the items
    (offset, up to ``M2L_GROUP`` admitted target cells) of each cell tile in
    offset order, and the block rows that split each tile's items into
    ``nsplit`` runs of about equal work (csrc/fmm.cu reads both)."""

    items: np.ndarray    # (n, M2L_ITEM_INTS) int32: ox, oy, oz, linear
    #                      offset, cells, 3 x 0, M2L_GROUP target cell
    #                      ids, M2L_GROUP indices in the tile (0 past)
    rows: np.ndarray     # (tiles * nsplit, M2L_ROW_INTS) int32: first
    #                      item, end, split, x0, x1, y0, y1, z0, z1, 3 x 0
    nsplit: int
    utiles: int          # blocks along the target nodes (grid.x)
    cell_pairs: int      # (target cell, offset) pairs the subset admits

    def scratch(self, m: int, C: int, nf: int) -> int:
        """Floats of the split partials (0 with one split)."""
        return self.nsplit * nf * C ** 3 * m ** 3 if self.nsplit > 1 else 0

    def builds(self, m: int) -> int:
        """Transfer entries T(o)[u, v] one launch builds: one per item and
        node pair."""
        return len(self.items) * m ** 6


def _item_work(cells: int) -> int:
    """An item's cost per node pair, in fp32 issue slots (about): the
    build (13 with the staged loads) and 3.25 a cell (3 fmas and a
    quarter of a broadcast load), times 4."""
    return 52 + 13 * cells


def check_m2l_tile(tile: int) -> None:
    """Raise ValueError unless ``tile`` target cells an item is one K7
    runs: 1 to its compiled kM2LGroup (callers pass 0 for the full group
    unchecked)."""
    if not 1 <= tile <= M2L_GROUP:
        raise ValueError(f"{_TAG}: K7 items of {tile} target cells; the "
                         f"kernel takes 1 to {M2L_GROUP}")


def m2l_plan(m: int, C: int, subset: str, slots: int,
             tile: int = 0) -> M2LPlan:
    """K7's plan (host numpy, cached): cell tiles of ``M2L_CELL_TILE``^3
    cells (the whole grid up to C = 4); per tile, for each offset of the
    subset in order (ox, oy, oz from -reach), the admitted target cells
    -- the box of ``m2l_axis`` ranges, clipped to the tile, x-major -- in
    items of at most ``tile`` (0: ``M2L_GROUP``, the kernel's kM2LGroup;
    each item keeps the compiled row width, M2L_ITEM_INTS, and the kernel
    runs its cell count); as many splits as keep the blocks within the
    card's ``slots`` (one wave; at most ``M2L_MAX_SPLIT``), each tile's
    items cut where the running work crosses a split's share."""
    if tile:
        check_m2l_tile(tile)
    return _m2l_plan(m, C, subset, slots, M2L_GROUP, tile or M2L_GROUP)


@functools.lru_cache(maxsize=None)
def _m2l_plan(m: int, C: int, subset: str, slots: int, group: int,
              tile: int = 0) -> M2LPlan:
    """``m2l_plan`` in rows of ``group`` cells and items of at most
    ``tile`` of them (0: ``group``): a ``group`` other than ``M2L_GROUP``
    serves only a kernel compiled with that kM2LGroup (the A/B script's
    variants of csrc/fmm.cu)."""
    _check_grid(m, C)
    tile = tile or group
    if subset not in _M2L_SUBSETS:
        raise ValueError(f"unknown offset subset {subset!r} "
                         f"({', '.join(_M2L_SUBSETS)})")
    reach, min_inf, parity = _M2L_SUBSETS[subset]
    T = min(C, M2L_CELL_TILE)
    tiles = [(x, y, z) for x in range(0, C, T) for y in range(0, C, T)
             for z in range(0, C, T)]
    utiles = -(-m ** 3 // M2L_TARGETS)
    nsplit = max(1, min(M2L_MAX_SPLIT, slots // (utiles * len(tiles))))
    items, rows, pairs = [], [], 0
    span = range(-reach, reach + 1)
    for t0 in tiles:
        box = [(b, min(b + T, C)) for b in t0]
        first = len(items)
        for o in itertools.product(span, span, span):
            if max(map(abs, o)) < min_inf:
                continue
            ax = [[i for i in m2l_axis(od, C, parity) if lo <= i < hi]
                  for od, (lo, hi) in zip(o, box)]
            cells = [(ix, iy, iz) for ix in ax[0] for iy in ax[1]
                     for iz in ax[2]]
            pairs += len(cells)
            olin = (o[0] * C + o[1]) * C + o[2]
            ext = [hi - lo for lo, hi in box]
            for g in range(0, len(cells), tile):
                grp = cells[g:g + tile]
                pad = [0] * (group - len(grp))
                items.append(
                    [*o, olin, len(grp), 0, 0, 0]
                    + [(ix * C + iy) * C + iz for ix, iy, iz in grp] + pad
                    + [((ix - box[0][0]) * ext[1] + iy - box[1][0]) * ext[2]
                       + iz - box[2][0] for ix, iy, iz in grp] + pad)
        work = np.cumsum([0] + [_item_work(it[4]) for it in items[first:]])
        # item i goes to the split its work's start falls in
        split = np.minimum(work[:-1] * nsplit // max(int(work[-1]), 1),
                           nsplit - 1)
        for sp in range(nsplit):
            lo = first + int(np.searchsorted(split, sp, "left"))
            hi = first + int(np.searchsorted(split, sp, "right"))
            rows.append([lo, hi, sp, *(v for b in box for v in b), 0, 0, 0])
    return M2LPlan(np.asarray(items, np.int32).reshape(-1, 8 + 2 * group),
                   np.asarray(rows, np.int32), nsplit, utiles, pairs)


@functools.lru_cache(maxsize=None)
def m2l_slots(device: torch.device, nf: int, dots: str = "fp32") -> int:
    """K7's blocks the card holds at once: its SMs times the blocks of the
    nf-field kernel of the tier's instance an SM holds (the occupancy
    calculator, ``murb_m2l_resident`` or ``murb_m2l_resident_lossy``)."""
    entry = M2L_DOTS[dots][1]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        cuda.launch(entry, nf, ctypes.byref(blocks))
    if blocks.value < 1:
        raise RuntimeError(f"{entry} nf={nf}: no block fits an SM")
    return cuda.sm_count(device) * blocks.value


@functools.lru_cache(maxsize=None)
def _plan_on(m: int, C: int, subset: str, nf: int, device: torch.device,
             dots: str = "fp32", tile: int = 0):
    """The plan for ``device``'s resident blocks of the tier's instance in
    items of at most ``tile`` cells and its tables on the device (copied
    once per shape and tile)."""
    plan = m2l_plan(m, C, subset, m2l_slots(device, nf, dots), tile)
    return plan, (torch.from_numpy(plan.items).to(device),
                  torch.from_numpy(plan.rows).to(device))


def m2l_level_fused(w, hl, soft, *, m: int, C: int, subset: str = "expand",
                    with_phi: bool = False, dots: str = "fp32",
                    tile: int = 0) -> tuple:
    """Node fields (fx, fy, fz[, phi]), each (C^3, m^3), of one level sweep
    at the dot tier ``dots`` ("fp32", or the lossy "bf16x3": murb_tpu's
    ``exact_dots=dots != "bf16x3"``).  CPU tensors run ``m2l_level_plain``;
    CUDA tensors launch the tier's K7 instance on the plan ``m2l_plan`` in
    items of at most ``tile`` target cells (0: ``M2L_GROUP``; else
    ``check_m2l_tile``'s range, on either device; the plain version has no
    items) (fp32 inside, fields cast back to ``w``'s dtype)."""
    _check_grid(m, C)
    _check_dots(dots)
    if tile:
        check_m2l_tile(tile)
    if subset not in _M2L_SUBSETS:
        raise ValueError(f"unknown offset subset {subset!r} "
                         f"({', '.join(_M2L_SUBSETS)})")
    if tuple(w.shape) != (C ** 3, m ** 3):
        raise ValueError(f"{_TAG}: expansions of shape {tuple(w.shape)}, "
                         f"expected {(C ** 3, m ** 3)}")
    if w.device.type == "cpu":
        return m2l_level_plain(w, hl, soft, m=m, C=C, subset=subset,
                               with_phi=with_phi, dots=dots)
    cuda.require_cuda(_TAG, w)
    cuda.refuse_grad(_TAG, w, hl, soft)
    dev = w.device
    if w.dtype != torch.float32:  # float64 down, bf16 up (exact)
        notify_fp32_compute(_TAG, w.dtype)
    w32 = w.to(torch.float32).contiguous()
    hl32 = hl.to(device=dev, dtype=torch.float32).contiguous()
    nf = 4 if with_phi else 3
    plan, (items, rows) = _plan_on(m, C, subset, nf, dev, dots, tile)
    out = torch.empty((nf, C ** 3, m ** 3), dtype=torch.float32, device=dev)
    nscratch = plan.scratch(m, C, nf)
    partial = (torch.empty(nscratch, dtype=torch.float32, device=dev)
               if nscratch else None)
    soft2 = float(np.float32(soft) * np.float32(soft))
    with torch.cuda.device(dev):
        cuda.launch(M2L_DOTS[dots][0], w32.data_ptr(), hl32.data_ptr(),
                    soft2, m, C, nf, items.data_ptr(), rows.data_ptr(),
                    rows.shape[0], plan.nsplit,
                    None if partial is None else partial.data_ptr(),
                    out.data_ptr(), cuda.stream(dev))
    if dots == "fp32":
        m2l_level_fused.launches += 1
    else:
        m2l_level_fused.lossy_launches += 1
    return tuple(f.to(w.dtype) for f in out)


m2l_level_fused.launches = 0
m2l_level_fused.lossy_launches = 0
