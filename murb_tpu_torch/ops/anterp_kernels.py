"""Kernels K11 (windowed P2M) and K12 (windowed L2P) of the adaptive
hierarchy, and their plain versions.

Port of ``murb_tpu/ops/anterp_pallas.py`` together with the jnp forms it
replaces, ``p2m_window`` and ``l2p_window`` of
``murb_tpu/ops/sparse_fmm.py``.  The bodies arrive Morton-sorted with
their finest-level cell coordinates ``ci`` (from the computation that made
the sort key, ops/p2p.sorted_cells) and their ``slots``: the rank of their
cell in the sorted occupied list, ``cap`` for the dump (inactive bodies,
capacity overflow).  Sorted order makes the slots non-decreasing.

  P2M   W (cap + 1, m^3): each body's expansion into its slot's row;
  L2P   per-body values of nf slot fields (cap + 1, m^3), each body from
        its own slot's row.

The plain versions are a segment sum by slot (``index_add_``) and a row
gather by slot -- the contracts of the jnp window forms without their TPU
windowing.  Row ``cap`` takes the dump bodies in the plain P2M and is 0
from K11; no consumer reads it, and K12 gives dump bodies 0 (the plain
L2P reads the caller's zero dump row).  ``window_block`` and the
MURB_ANTERP_PALLAS switch exist only for the TPU and are not ported.

``p2m_window`` and ``l2p_window`` run the plain version on CPU tensors and
launch the kernel on CUDA tensors (fp32 inside, results cast back), and
count each launch.  A bf16 state launches the kernels' bf16 instances
(``murb_p2m_window_bf16``, ``murb_l2p_window_bf16``: the bodies read as
they are and converted to fp32 as loaded), counted in ``bf16_launches``.
The kernels read each slot's bodies as one run from the slot bounds and
work items that ``slot_items`` makes on the device (``window_items``: the
run kernels' items, shared with K8 and K9).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import (bf16_plain, notify_fp32_compute,
                                       weights_dtype)
from murb_tpu_torch.ops.fmm_kernels import (RunItems, cell_box, l2p_item,
                                            node_table, p2m_chunk,
                                            p2m_outputs)
from murb_tpu_torch.ops.p2p import _cell_ixyz
from murb_tpu_torch.ops.proxy_kernels import _basis, _entry

MAX_ORDER = 32       # kRunMaxOrder (csrc/cell_runs.cuh)
_PLAIN_CHUNK = 8192  # bodies per step of the plain versions
_TAG = "tpu+proxy/adaptive (window kernels)"


def _check(m: int, nf: int = 1) -> None:
    if not 2 <= m <= MAX_ORDER:
        raise ValueError(f"{_TAG}: order m={m} outside the kernels' range "
                         f"[2, {MAX_ORDER}]")
    if not 1 <= nf <= 4:
        raise ValueError(f"{_TAG}: windowed L2P takes 1 to 4 fields, got {nf}")


def _bases(xs, ys, zs, ci, c, h, m: int, C: int):
    """Sx, Sy, Sz (b, m) of each body in its own finest cell ``ci``."""
    lo = c - h
    cs = 2.0 * h / C
    return tuple(_basis(2.0 * ((q - lo[d]) / cs[d] - ci[d].to(q.dtype)) - 1.0,
                        m)
                 for d, q in enumerate((xs, ys, zs)))


# ---------------------------------------------------------- plain versions
@bf16_plain(round_outputs=False)
def p2m_window_plain(xs, ys, zs, gs, c, h, slots, cap: int, *, m: int,
                     C: int, ci) -> torch.Tensor:
    """K11's plain version: (cap + 1, m^3) slot expansions as a segment sum
    by slot, in the inputs' dtype."""
    n = xs.shape[0]
    w = torch.zeros((cap + 1, m ** 3), dtype=xs.dtype, device=xs.device)
    for s in range(0, n, _PLAIN_CHUNK):
        e = s + _PLAIN_CHUNK
        sx, sy, sz = _bases(xs[s:e], ys[s:e], zs[s:e],
                            tuple(v[s:e] for v in ci), c, h, m, C)
        svw = (sy[:, :, None] * sz[:, None, :]).reshape(-1, m * m)
        outer = ((gs[s:e, None] * sx)[:, :, None]
                 * svw[:, None, :]).reshape(-1, m ** 3)
        w.index_add_(0, slots[s:e].long(), outer)
    return w


@bf16_plain
def l2p_window_plain(xs, ys, zs, c, h, slots, fields, *, m: int, C: int,
                     ci) -> tuple:
    """K12's plain version: per-body values of the (cap + 1, m^3) slot
    fields, each body reading its own slot's row (a gather) -> tuple of
    (n,), in the inputs' dtype."""
    n = xs.shape[0]
    outs = [[] for _ in fields]
    for s in range(0, n, _PLAIN_CHUNK):
        e = s + _PLAIN_CHUNK
        sx, sy, sz = _bases(xs[s:e], ys[s:e], zs[s:e],
                            tuple(v[s:e] for v in ci), c, h, m, C)
        sl = slots[s:e].long()
        b = sl.shape[0]
        for out, f in zip(outs, fields):
            fg = f[sl].reshape(b, m, m * m)
            t1 = torch.einsum("bu,bup->bp", sx, fg).reshape(b, m, m)
            t2 = torch.einsum("bv,bvw->bw", sy, t1)
            out.append((sz * t2).sum(1))
    return tuple(torch.cat(o) for o in outs)


# ------------------------------------------------------------------ glue
def slot_items(slots: torch.Tensor, cap: int, chunk: int):
    """(bounds (cap + 2,), prefix (cap + 2,), nitems) of non-decreasing
    slots: slot s holds bodies [bounds[s], bounds[s + 1]), the dump slot
    ``cap`` none; prefix counts each slot's work items of at most ``chunk``
    bodies, and nitems covers them with no host sync (sum_s ceil(n_s /
    chunk) <= n / chunk + cap + 1)."""
    first = torch.searchsorted(
        slots, torch.arange(cap + 1, dtype=slots.dtype, device=slots.device))
    bounds = torch.cat([first, first[-1:]])
    per = (bounds.diff() + chunk - 1) // chunk
    return (bounds, F.pad(per.cumsum(0), (1, 0)),
            slots.shape[0] // chunk + cap + 2)


def window_items(slots: torch.Tensor, cap: int, chunk: int) -> RunItems:
    """The run kernels' work items over the slots (``slot_items``)."""
    return RunItems(*slot_items(slots, cap, chunk), chunk)


def _kernel_args(xs, ys, zs, slots, c, h, ci, C: int, bf16: bool = False):
    dev, n = xs.device, xs.shape[0]
    cuda.refuse_grad(_TAG, c, h)
    x, y, z = cuda.kernel_inputs(_TAG, dev, n, xs, ys, zs,
                                 notify=notify_fp32_compute, bf16=bf16)
    cells = cuda.int_inputs(_TAG, dev, n, *ci)
    (sl,) = cuda.int_inputs(_TAG, dev, n, slots)
    box = torch.cat(cell_box(c, h, C)).to(torch.float32).contiguous()
    return (x, y, z), cells, sl, box


# ----------------------------------------------------------- K11 wrapper
def p2m_window_launch(x, y, z, g, cells, box, items: RunItems,
                      m: int) -> torch.Tensor:
    """K11 alone on float32 sorted bodies (its bf16 instance on bf16 ones),
    their int32 cells, the box and the slots' work items -> W (cap + 1,
    m^3) float32 (the dump row 0)."""
    dev, nslot = x.device, items.bounds.shape[0] - 1
    w, partial = p2m_outputs(items, x.shape[0], nslot, m, dev)
    with torch.cuda.device(dev):
        cuda.launch(_entry("murb_p2m_window", x), x.data_ptr(), y.data_ptr(),
                    z.data_ptr(), g.data_ptr(),
                    *(v.data_ptr() for v in cells), box.data_ptr(), m,
                    nslot, items.bounds.data_ptr(), items.prefix.data_ptr(),
                    items.nitems, items.chunk, node_table(m, dev).data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    w.data_ptr(), cuda.stream(dev))
    return w


def p2m_window(xs, ys, zs, gs, c, h, slots, cap: int, *, m: int, C: int,
               ci=None) -> torch.Tensor:
    """(cap + 1, m^3) slot expansions of Morton-sorted bodies (the contract
    of murb_tpu's ``sparse_fmm.p2m_window``; rows [0, cap) are the
    result).  ``ci`` defaults to the bodies' own cells (ops/p2p._cell_ixyz).
    CPU tensors run ``p2m_window_plain``; CUDA tensors launch K11."""
    _check(m)
    if ci is None:
        ci = _cell_ixyz(xs, ys, zs, c, h, C)
    if xs.device.type == "cpu":
        return p2m_window_plain(xs, ys, zs, gs, c, h, slots, cap, m=m, C=C,
                                ci=ci)
    cuda.require_cuda(_TAG, xs)
    dev, dtype, n = xs.device, xs.dtype, xs.shape[0]
    b16 = cuda.all_bf16(xs, ys, zs, gs)
    (x, y, z), cells, sl, box = _kernel_args(xs, ys, zs, slots, c, h, ci, C,
                                             b16)
    (g,) = cuda.kernel_inputs(_TAG, dev, n, gs, notify=notify_fp32_compute,
                              bf16=b16)
    items = window_items(sl, cap, p2m_chunk(n, m, cuda.sm_count(dev)))
    w = p2m_window_launch(x, y, z, g, cells, box, items, m)
    if b16:
        p2m_window.bf16_launches += 1
    else:
        p2m_window.launches += 1
    return w.to(weights_dtype(dtype))


p2m_window.launches = 0
p2m_window.bf16_launches = 0


# ----------------------------------------------------------- K12 wrapper
def l2p_window_launch(x, y, z, cells, box, items: RunItems, m: int,
                      fields) -> torch.Tensor:
    """K12 alone on float32 sorted bodies (its bf16 instance on bf16 ones),
    their int32 cells, the box, the slots' work items and 1 to 4 float32
    contiguous (cap + 1, m^3) fields -> (nf, n) float32, the dump bodies
    0."""
    dev, n, nf = x.device, x.shape[0], len(fields)
    out = torch.zeros((nf, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cuda.launch(_entry("murb_l2p_window", x), x.data_ptr(), y.data_ptr(),
                    z.data_ptr(), *(v.data_ptr() for v in cells), n,
                    box.data_ptr(), m, items.bounds.shape[0] - 1,
                    items.bounds.data_ptr(), items.prefix.data_ptr(),
                    items.nitems, node_table(m, dev).data_ptr(),
                    cuda.field_pointers(fields), nf, out.data_ptr(),
                    cuda.stream(dev))
    return out


def l2p_window(xs, ys, zs, c, h, slots, fields, *, m: int, C: int,
               ci=None) -> tuple:
    """Per-body values of 1 to 4 (cap + 1, m^3) slot fields (the contract
    of murb_tpu's ``sparse_fmm.l2p_window``, dump row zero) -> tuple of
    (n,).  CPU tensors run ``l2p_window_plain``; CUDA tensors launch K12
    once."""
    nf = len(fields)
    _check(m, nf)
    rows = fields[0].shape[0]
    for f in fields:
        if tuple(f.shape) != (rows, m ** 3):
            raise ValueError(f"{_TAG}: slot field of shape {tuple(f.shape)},"
                             f" expected {(rows, m ** 3)}")
    if ci is None:
        ci = _cell_ixyz(xs, ys, zs, c, h, C)
    if xs.device.type == "cpu":
        return l2p_window_plain(xs, ys, zs, c, h, slots, fields, m=m, C=C,
                                ci=ci)
    cuda.require_cuda(_TAG, xs)
    cuda.refuse_grad(_TAG, *fields)
    dtype = xs.dtype
    b16 = cuda.all_bf16(xs, ys, zs)
    (x, y, z), cells, sl, box = _kernel_args(xs, ys, zs, slots, c, h, ci, C,
                                             b16)
    flds = [f.to(torch.float32).contiguous() for f in fields]
    out = l2p_window_launch(x, y, z, cells, box,
                            window_items(sl, rows - 1, l2p_item(m)), m, flds)
    if b16:
        l2p_window.bf16_launches += 1
    else:
        l2p_window.launches += 1
    return tuple(o.to(dtype) for o in out)


l2p_window.launches = 0
l2p_window.bf16_launches = 0
