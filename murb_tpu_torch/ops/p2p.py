"""The adaptive near field (P2P): exact 27-neighbourhood interactions.

Port of ``murb_tpu/ops/p2p.py``.  The hierarchy of ops/fmm.py interpolates
the finest level's near list too, which needs finest cells no wider than
the softening.  This stage handles the finest 27-cell neighbourhood
exactly instead, so the far shells converge at the |o|_inf >= 2
separation ratio whatever the softening, and depth follows occupancy:

  sort    bodies get a Morton key from their finest-level cell coordinates
          and are sorted (inactive rows last, under a sentinel key);
  brick   the sorted array is cut into bricks of K = 128 bodies, each
          spanning a contiguous Morton range with a tight cell bounding
          box;
  pairs   brick pair (t, s) is a candidate when their boxes lie within
          Chebyshev distance 1; the first ``pmax`` candidates of the (B, B)
          adjacency in row-major order are swept, and each body pair
          counts only when the bodies' own cells do (max |dc| <= 1);
  sweep   softened exact forces (and the potential, self term gm/eps
          included) per swept pair, summed per target.

This module holds the ids, the brick geometry, K10's plain version (the
chunked sweep below) and the host-side sizing (``estimate_brick_pairs``,
``size_pmax``, murb_tpu's, in numpy).  The sweeps an engine calls,
``p2p_sweep`` and ``p2p_sweep_kernel_sorted``, are in ops/p2p_kernels.py:
they run the plain sweep on CPU tensors and K10 on CUDA tensors, sweep the
same pairs and return the true candidate count, so an engine can see the
capacity overflow and re-plan.
"""
from __future__ import annotations

import numpy as np
import torch

from murb_tpu_torch.ops.common import bf16_plain
from murb_tpu_torch.ops.fmm_kernels import _cell_coords

#: bodies per brick (the K10 block); divides every padded N (256)
DEFAULT_K = 128

#: pair chunk of the plain sweep: (chunk, K, K) intermediates
DEFAULT_CHUNK = 128

#: sentinel cell coordinate of inactive rows (ghosts, heavy-split bodies):
#: 2C + 9, far from every real cell, so no body pair with them is near
_SENTINEL_SHIFT = 9


def _interleave3(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Spread the low ``bits`` bits of v (int32) 3 apart: b -> 3b."""
    out = torch.zeros_like(v)
    for b in range(bits):
        out = out | (((v >> b) & 1) << (3 * b))
    return out


def morton_key(cx, cy, cz, C: int) -> torch.Tensor:
    """Morton (Z-order) key of integer cell coordinates on a C^3 grid,
    x << 2 | y << 1 | z per bit; int32 up to C = 1024."""
    bits = max(int(C - 1).bit_length(), 1)
    return ((_interleave3(cx, bits) << 2) | (_interleave3(cy, bits) << 1)
            | _interleave3(cz, bits))


def _cell_ixyz(qx, qy, qz, c, h, C: int):
    """int32 finest-level cell coordinates, exactly the grid P2M's
    assignment (ops/fmm_kernels._cell_coords): the near/far split holds
    only if the P2P stage and the field grid agree on every body's cell."""
    lo = c - h
    cs = 2.0 * h / C
    return tuple(_cell_coords(q, lo[d], cs[d], C)[0].to(torch.int32)
                 for d, q in enumerate((qx, qy, qz)))


def _brick_boxes(ci_s, K: int):
    """Per-brick cell bounding boxes from SORTED per-body cell coordinates:
    ((B, 3) lo, (B, 3) hi)."""
    B = ci_s[0].shape[0] // K
    lo = torch.stack([c.reshape(B, K).amin(1) for c in ci_s], 1)
    hi = torch.stack([c.reshape(B, K).amax(1) for c in ci_s], 1)
    return lo, hi


#: bodies per sub-brick: K10's warp (csrc/p2p.cu kSub)
SUB_K = 32

#: K10's classes of a (32-target, 32-source) sub-tile pair (csrc/p2p.cu)
FAR, MIXED, ALL_NEAR = 0, 1, 2


def subtile_class(lo_t, hi_t, lo_s, hi_s) -> torch.Tensor:
    """K10's class of target and source sub-bricks with cell boxes
    ``lo``/``hi`` (..., 3), broadcast: FAR when some axis has a gap > 1 (no
    body pair passes the cell mask), ALL_NEAR when every body pair does
    (max |dc| <= 1 over both boxes), MIXED otherwise.  int8."""
    far = ((lo_s > hi_t + 1) | (lo_t > hi_s + 1)).any(-1)
    near = (torch.maximum(hi_s - lo_t, hi_t - lo_s) <= 1).all(-1)
    out = torch.full(far.shape, MIXED, dtype=torch.int8, device=far.device)
    out[near] = ALL_NEAR
    out[far] = FAR
    return out


def _adjacency(lo, hi) -> torch.Tensor:
    """(B, B) bool: brick bounding boxes within Chebyshev distance 1."""
    out = None
    for d in range(3):
        ab = ((lo[None, :, d] <= hi[:, d, None] + 1)
              & (lo[:, d, None] <= hi[None, :, d] + 1))
        out = ab if out is None else out & ab
    return out


def sorted_cells(qx, qy, qz, active, c, h, C: int):
    """(Morton key with _BIG for inactive rows, the cell coordinates with
    the sentinel for inactive rows): the one cell computation that both the
    sort and every sparse stage read."""
    cx, cy, cz = _cell_ixyz(qx, qy, qz, c, h, C)
    big = torch.iinfo(torch.int32).max
    key = torch.where(active, morton_key(cx, cy, cz, C), big)
    sent = 2 * C + _SENTINEL_SHIFT
    ci = tuple(torch.where(active, v, sent) for v in (cx, cy, cz))
    return key, ci


@bf16_plain
def p2p_sweep_plain_sorted(xs, ys, zs, gs, ci, soft, *, pmax: int,
                           K: int = DEFAULT_K, chunk: int = DEFAULT_CHUNK,
                           with_phi: bool = False):
    """K10's plain version (murb_tpu/ops/p2p.py:p2p_sweep_sorted): the
    first ``pmax`` candidate pairs in row-major order, swept ``chunk``
    pairs at a time as (chunk, K, K) broadcasts, each chunk's partial sums
    added per target brick with ``index_add_``."""
    n = xs.shape[0]
    if n % K:
        raise ValueError(f"n={n} is not a multiple of the brick size {K}")
    B = n // K
    dtype, dev = xs.dtype, xs.device
    adj = _adjacency(*_brick_boxes(ci, K))
    n_pairs = adj.sum()
    flat = torch.nonzero(adj.reshape(-1)).reshape(-1)[:pmax]
    tb, sb = flat // B, flat % B
    soft2 = torch.tensor(soft, dtype=dtype) ** 2
    xr, yr, zr, gr = (v.reshape(B, K) for v in (xs, ys, zs, gs))
    cr = tuple(v.reshape(B, K) for v in ci)
    nf = 4 if with_phi else 3
    acc = torch.zeros((nf, B, K), dtype=dtype, device=dev)
    for p0 in range(0, flat.shape[0], chunk):
        t, s = tb[p0:p0 + chunk], sb[p0:p0 + chunk]
        # targets along axis 1, sources along axis 2
        dx = xr[s][:, None, :] - xr[t][:, :, None]
        dy = yr[s][:, None, :] - yr[t][:, :, None]
        dz = zr[s][:, None, :] - zr[t][:, :, None]
        near = None
        for c in cr:
            nd = (c[s][:, None, :] - c[t][:, :, None]).abs() <= 1
            near = nd if near is None else near & nd
        inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + soft2)
        w0 = torch.where(near, gr[s][:, None, :], 0.0)
        w = w0 * (inv * inv * inv)
        parts = [(w * dx).sum(2), (w * dy).sum(2), (w * dz).sum(2)]
        if with_phi:
            parts.append((w0 * inv).sum(2))
        for f, p in enumerate(parts):
            acc[f].index_add_(0, t, p)
    return tuple(acc), n_pairs


# ------------------------------------------------------ host-side sizing
def _morton_np(cx, cy, cz, C: int) -> np.ndarray:
    bits = max(int(C - 1).bit_length(), 1)
    out = np.zeros_like(cx, dtype=np.int64)
    for b in range(bits):
        out |= ((cx >> b) & 1).astype(np.int64) << (3 * b + 2)
        out |= ((cy >> b) & 1).astype(np.int64) << (3 * b + 1)
        out |= ((cz >> b) & 1).astype(np.int64) << (3 * b)
    return out


def estimate_brick_pairs(q: np.ndarray, npad: int, levels: int,
                         K: int = DEFAULT_K) -> int:
    """Host replica of the device candidate count at depth ``levels``
    (murb_tpu/ops/p2p.py:estimate_brick_pairs): ``q`` (n_active, 3) are
    the active bodies' positions; the npad - n_active inactive rows sort
    last under the sentinel, as on the device.  float32 arithmetic
    mirrors the device's box and cell mapping."""
    C = 2 ** levels
    q = np.asarray(q, np.float32)
    lo = q.min(0)
    hi = q.max(0)
    ctr = (np.float32(0.5) * (lo + hi)).astype(np.float32)
    h = np.maximum(np.float32(0.5) * (hi - lo), np.float32(1.0))
    h = np.full(3, h.max(), np.float32)
    cs = (np.float32(2.0) * h / np.float32(C)).astype(np.float32)
    u = (q - (ctr - h)) / cs
    ci = np.clip(np.floor(u), 0, C - 1).astype(np.int64)
    order = np.argsort(_morton_np(ci[:, 0], ci[:, 1], ci[:, 2], C),
                       kind="stable")
    ci = ci[order]
    sent = 2 * C + _SENTINEL_SHIFT
    pad = np.full((npad - len(q), 3), sent, dtype=np.int64)
    ci = np.concatenate([ci, pad], 0)
    B = npad // K
    cb = ci.reshape(B, K, 3)
    blo, bhi = cb.min(1), cb.max(1)
    a = blo[None, :, :] <= bhi[:, None, :] + 1
    b = blo[:, None, :] <= bhi[None, :, :] + 1
    return int(np.sum(np.all(a & b, axis=-1)))


def size_pmax(n_pairs: int, margin: float = 2.0,
              chunk: int = DEFAULT_CHUNK) -> int:
    """Static pair capacity from an estimated count: margined for the
    distribution evolving, rounded up to the plain sweep's chunk."""
    want = max(int(n_pairs * margin), chunk)
    return (want + chunk - 1) // chunk * chunk


def p2p_cost_model(n_pairs: int, n: int, m: int, levels: int,
                   K: int = DEFAULT_K) -> float:
    """MAC-equivalent cost of a p2p-mode hierarchy step in the currency of
    ops/fmm.best_depth (murb_tpu/ops/p2p.py:p2p_cost_model, its TPU rates
    kept): far field plus ~26 slots a body pair at ~5 MAC equivalents."""
    far = 8 * n * m**3 + 686 * 8**levels * m**6
    sweep = n_pairs * K * K * 26 * 5
    return far + sweep
