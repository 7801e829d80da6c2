"""Kernel K10: the block-sparse exact near field of the adaptive hierarchy.

Port of ``murb_tpu/ops/p2p_pallas.py``.  The TPU kernel walked a
target-major pair list padded per target to multiples of G pairs (the
scalar-prefetch grid needed equal steps), so its capacity was the
run-padded ``size_pmax_runs``.  K10 (``csrc/p2p.cu``) has one block per
target brick that walks its own adjacency row, so the pair list is a CSR
over the rows of the (B, B) adjacency -- the running count of the rows,
made on the device with no host sync -- and the capacity is ``size_pmax``'s
on every device: the first ``pmax`` candidates in row-major order are
swept, as by the plain sweep (ops/p2p.p2p_sweep_plain_sorted).
``size_pmax_runs`` and ``build_pair_runs`` have no counterpart.  The
wrapper also hands K10 the bodies packed as {x, y, z, G m} and {cx, cy, cz,
0} rows, the cell box of every 32-body sub-brick (the warp's sub-tile
classes, ops/p2p.subtile_class) and the target bricks in decreasing row
length (the launch order), all made on the device with no host sync.

``p2p_sweep_kernel_sorted`` runs the plain sweep on CPU tensors and
launches K10 on CUDA tensors (fp32 inside, each source brick's sums
folded into fp64 sums; float64 inputs are cast here and the result cast
back), and counts each launch.  A bf16 state (the
four body arrays bf16) launches K10's bf16 instance
(``murb_p2p_sorted_bf16``) on bf16 {x, y, z, G m} rows, counted in
``bf16_launches``: it converts each staged row to fp32, so its sums are
the fp32 instance's on the rows upcast.  ``p2p_sweep`` sorts
unsorted bodies for it and unsorts the result (the near field of
ops/fmm.acc_fmm's ``near="p2p"``); ``acc_p2p`` is the standalone entry
the tests call.
"""
from __future__ import annotations

import torch

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import Accel, notify_fp32_compute
from murb_tpu_torch.ops.p2p import (DEFAULT_CHUNK, DEFAULT_K, SUB_K,
                                    _adjacency, _brick_boxes,
                                    p2p_sweep_plain_sorted, sorted_cells)
from murb_tpu_torch.ops.proxy_kernels import _entry

_TAG = "tpu+proxy/adaptive (P2P kernel)"


def pair_rows(adj: torch.Tensor):
    """(counts (B,) int64: candidates of each row, starts (B,): candidates
    of the rows before each row, n_pairs): the CSR of the row-major
    candidate list, on the adjacency's device."""
    counts = adj.sum(1)
    return counts, counts.cumsum(0) - counts, counts.sum()


def launch_order(counts: torch.Tensor) -> torch.Tensor:
    """K10's launch order: the target bricks by decreasing row length (ties
    in brick order), int32, so that the longest rows start first."""
    return torch.argsort(counts, descending=True, stable=True).to(
        torch.int32)


def subbrick_boxes(cells) -> torch.Tensor:
    """(n / 32, 2, 4) int32: the cell box {lo, hi} of every 32-body
    sub-brick of the sorted cells, padded to 16-byte rows for K10."""
    lo, hi = _brick_boxes(cells, SUB_K)
    box = torch.zeros((lo.shape[0], 2, 4), dtype=torch.int32,
                      device=lo.device)
    box[:, 0, :3] = lo
    box[:, 1, :3] = hi
    return box


def p2p_sorted_launch(x, y, z, g, cells, soft2: float, *, pmax: int,
                      with_phi: bool = False):
    """K10 alone on float32 sorted bodies (its bf16 instance on bf16 ones)
    and their int32 cells -> ((nf, n) float32 sums in sorted order,
    n_pairs); the adjacency, the pair rows, the launch order and the
    packed rows made here on the device."""
    dev, n = x.device, x.shape[0]
    B = n // DEFAULT_K
    adj = _adjacency(*_brick_boxes(cells, DEFAULT_K)).contiguous()
    counts, starts, n_pairs = pair_rows(adj)
    order = launch_order(counts)
    body = torch.stack((x, y, z, g), 1)
    cell = torch.stack((*cells, torch.zeros_like(cells[0])), 1)
    box = subbrick_boxes(cells)
    out = torch.empty((4 if with_phi else 3, n), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        cuda.launch(_entry("murb_p2p_sorted", x), body.data_ptr(), cell.data_ptr(), box.data_ptr(),
                    order.data_ptr(), B, adj.data_ptr(), starts.data_ptr(),
                    int(pmax), soft2, int(with_phi), out.data_ptr(),
                    cuda.stream(dev))
    return out, n_pairs


def p2p_sweep_kernel_sorted(xs, ys, zs, gs, ci, soft, *, pmax: int,
                            chunk: int = DEFAULT_CHUNK,
                            with_phi: bool = False):
    """The sweep on Morton-sorted bodies (the shared sort of
    ops/sparse_fmm.solve_adaptive; murb_tpu/ops/p2p.py:p2p_sweep_sorted):
    ``ci`` = per-body int32 cell coordinates, sentinel rows for inactive
    bodies.  Returns (nf-tuple of (B, 128) partials in sorted order,
    n_pairs).  CPU tensors run the plain sweep (in ``chunk``-pair steps);
    CUDA tensors launch K10 once."""
    if xs.device.type == "cpu":
        return p2p_sweep_plain_sorted(xs, ys, zs, gs, ci, soft, pmax=pmax,
                                      chunk=chunk, with_phi=with_phi)
    cuda.require_cuda(_TAG, xs)
    cuda.refuse_grad(_TAG, soft)
    dtype, dev, n = xs.dtype, xs.device, xs.shape[0]
    if n % DEFAULT_K:
        raise ValueError(f"{_TAG}: n={n} is not a multiple of {DEFAULT_K}")
    b16 = cuda.all_bf16(xs, ys, zs, gs)
    x, y, z, g = cuda.kernel_inputs(_TAG, dev, n, xs, ys, zs, gs,
                                    notify=notify_fp32_compute, bf16=b16)
    cells = cuda.int_inputs(_TAG, dev, n, *ci)
    B = n // DEFAULT_K
    soft2 = float(torch.tensor(soft, dtype=torch.float32) ** 2)
    out, n_pairs = p2p_sorted_launch(x, y, z, g, cells, soft2, pmax=pmax,
                                     with_phi=with_phi)
    if b16:
        p2p_sweep_kernel_sorted.bf16_launches += 1
    else:
        p2p_sweep_kernel_sorted.launches += 1
    return tuple(o.reshape(B, DEFAULT_K).to(dtype) for o in out), n_pairs


p2p_sweep_kernel_sorted.launches = 0
p2p_sweep_kernel_sorted.bf16_launches = 0


def p2p_sweep(qx, qy, qz, gm_src, c, h, soft, *, C: int, pmax: int,
              chunk: int = DEFAULT_CHUNK, with_phi: bool = False):
    """Exact near-field (27-neighbourhood) accelerations on the C^3 grid
    (murb_tpu/ops/p2p.py:p2p_sweep).

    ``gm_src``: source G*m with inactive rows zeroed (they drop out as
    targets too).  Returns ``(acc (n, 3), phi (n,) or None, n_pairs)`` in
    the original body order; ``n_pairs`` is the true candidate count, and
    pairs past ``pmax`` were dropped."""
    n = qx.shape[0]
    key, ci = sorted_cells(qx, qy, qz, gm_src > 0, c, h, C)
    _, perm = torch.sort(key, stable=True)
    xs, ys, zs, gs = (v[perm] for v in (qx, qy, qz, gm_src))
    parts, n_pairs = p2p_sweep_kernel_sorted(
        xs, ys, zs, gs, tuple(v[perm] for v in ci), soft, pmax=pmax,
        chunk=chunk, with_phi=with_phi)

    def unsort(a):
        out = torch.empty(n, dtype=qx.dtype, device=qx.device)
        out[perm] = a.reshape(n)
        return out

    acc = torch.stack([unsort(p) for p in parts[:3]], 1)
    phi = unsort(parts[3]) if with_phi else None
    return acc, phi, n_pairs


def acc_p2p(qx, qy, qz, gm_src, c, h, soft, *, C: int, pmax: int,
            with_phi: bool = False):
    """Standalone near field in the original body order (murb_tpu's
    ``acc_p2p_pallas``): (Accel, phi or None, n_pairs)."""
    acc, phi, n_pairs = p2p_sweep(qx, qy, qz, gm_src, c, h, soft, C=C,
                                  pmax=pmax, with_phi=with_phi)
    return Accel(acc[:, 0], acc[:, 1], acc[:, 2]), phi, n_pairs
