"""The adaptive (occupied-cell) hierarchy: sparse levels plus the exact P2P
near field.

Port of ``murb_tpu/ops/sparse_fmm.py``.  The dense hierarchy (ops/fmm.py)
stores every cell of a uniform grid, so its depth stops near L = 4.  This
solver keeps the dense grid for levels 2..Ld and below it stores only the
occupied cells, down to a finest level L whose 27-cell neighbourhoods the
P2P stage (ops/p2p.py) sums exactly:

  sort       one stable Morton sort of the bodies per solve, shared by
             every stage: the occupied lists come from first-occurrence
             flags, the anterpolation reads each cell's bodies as a run,
             and the P2P bricks are cut on the same order.  Cell ids are
             Morton codes (parent = >> 3, octant = & 7).
  occupancy  each sparse level keeps a sorted list of occupied cells in a
             capacity the host planner sized (``plan_adaptive``); the
             engines re-check it as the bodies move.
  upward     P2M into finest-level slots (kernel K11), sparse M2M (8
             per-octant (m^3, m^3) products), and the coarsest sparse level
             scattered into the dense grid at Ld.
  M2L        per sparse level, the far offsets (2 <= |o|_inf <= 3, parity
             masked as in the dense sweeps), each applied to the occupied
             source of every occupied target with ``torch.bmm``.
  downward   the dense field at Ld (ops/fmm.fmm_field_grid with the finest
             subset "far"), L2L into the sparse children, each level's
             M2L, and L2P from the finest slots (kernel K12).
  near       the exact P2P sweep (kernel K10).

Everything runs on the state's device.  The planner and the capacity
checks run between steps; their counts (``level_stats``,
``estimate_brick_pairs``) run where the positions they are given lie,
the engines' on the state's device, and end in one read each.  A solve
does wait on the device: each host table it copies to the card
(``torch.as_tensor`` of a numpy array onto a CUDA device: the sparse M2L's
offsets and parity codes in ``_neighbor_slots``, its signs and each batch
of offsets; the M2M and L2L matrix of each ops/fmm.m2m and l2l call in
the dense base) is a pageable copy that PyTorch ends with a stream
synchronise.  So a step waits once
for each ``_neighbor_slots`` table and each sign table of every sparse
level, once for each batch of offsets, and once for each M2M and L2L
matrix; how many that is follows the plan's levels.  The sparse M2L
keeps murb_tpu's opt-in tiers (``m2l_sparse_level``): the dot tiers
``m2l_dots`` "bf16x3" (every product as three TF32 products of split
operands, ``ops/mxu.split3_matmul``) and "mixed" (the |o|_inf = 2 shell at
fp32, the outer shells lossy), the shared-basis compression (``m2l_rank``
> 0, ``m2l_basis``), the fused multi-offset form (MURB_M2L_FUSED) and the
offsets a batch (MURB_M2L_SCAN_CHUNK); ``solve_adaptive`` reads the two
variables once (``m2l_schedule``) and passes them down.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from murb_tpu_torch.ops.anterp_kernels import l2p_window, p2m_window
from murb_tpu_torch.ops.common import Accel
from murb_tpu_torch.ops.fmm import (_SUBSETS, _basis_np, _cheb_nodes_np,
                                    _offsets_paired, check_m2l_dots,
                                    fmm_field_grid)
from murb_tpu_torch.ops.mxu import split3_matmul, tf32_matmul
from murb_tpu_torch.ops.fmm_kernels import _node_vectors
from murb_tpu_torch.ops.p2p import (DEFAULT_CHUNK as P2P_CHUNK, DEFAULT_K,
                                    estimate_brick_pairs, morton_key,
                                    plan_cells, size_pmax, sorted_cells)
from murb_tpu_torch.ops.p2p_kernels import p2p_sweep_kernel_sorted
from murb_tpu_torch.utils import trace

#: p2p_impl names: the port's own, and murb_tpu's mapped onto them
_IMPLS = {"plain": "plain", "kernel": "kernel", "jnp": "plain",
          "pallas": "kernel"}


class SparsePlan(NamedTuple):
    """Static geometry of an adaptive solve (murb_tpu's SparsePlan, field
    for field).  ``cell_caps``: one occupied-cell capacity per sparse level
    (dense_levels + 1 .. levels); ``p2p_pmax``: the near field's pair
    capacity (``size_pmax``'s on every device).  ``p2p_impl`` names the
    sweep the plan was made for, "plain" (CPU) or "kernel" (K10): the
    tensors' device picks the sweep that runs.  ``m2l_rank`` -1 resolves to
    0 (no compression)."""

    m: int
    dense_levels: int
    levels: int
    cell_caps: tuple
    p2p_pmax: int
    p2p_chunk: int = P2P_CHUNK
    p2p_impl: str = "plain"
    m2l_rank: int = -1

    @classmethod
    def from_fields(cls, **fields) -> "SparsePlan":
        """A plan from murb_tpu's fields (``jax_plan._asdict()``):
        ``p2p_impl`` "jnp" becomes "plain" and "pallas" "kernel"."""
        fields["p2p_impl"] = _IMPLS[fields.get("p2p_impl", "plain")]
        fields["cell_caps"] = tuple(int(c) for c in fields["cell_caps"])
        return cls(**fields)


# ------------------------------------------------------------ id helpers
# Sparse-level cell ids are Morton codes (ops/p2p.morton_key: x << 2 |
# y << 1 | z per bit), so code & 7 is the octant index of _octant_transfer
# and sorting bodies by finest code makes their slots non-decreasing.  Only
# the hand-off to the dense grid (row-major (C^3, m^3)) converts.
def _pack(cx, cy, cz, C: int):
    """Row-major cell id: the dense grid's convention (ops/fmm)."""
    return (cx * C + cy) * C + cz


def _munpack(code, C: int):
    """(cx, cy, cz) from a Morton code on a C^3 grid."""
    bits = max(int(C - 1).bit_length(), 1)
    cx, cy, cz = (torch.zeros_like(code) for _ in range(3))
    for b in range(bits):
        cx = cx | (((code >> (3 * b + 2)) & 1) << b)
        cy = cy | (((code >> (3 * b + 1)) & 1) << b)
        cz = cz | (((code >> (3 * b)) & 1) << b)
    return cx, cy, cz


#: sentinel cell id of inactive rows and padding slots: sorts last, never
#: a real id (real ids < C^3 <= 2^30)
_BIG = int(np.iinfo(np.int32).max)


def _octant_transfer(m: int) -> np.ndarray:
    """T (8, m^3, m^3) float32: the Kronecker-factored M2M matrix per octant
    s = (sx, sy, sz), W_parent += W_child @ T[s]; L2L is the transpose."""
    t = _cheb_nodes_np(m)
    Ms = [_basis_np((2 * s - 1) * 0.5 + 0.5 * t, m) for s in (0, 1)]
    out = np.zeros((8, m ** 3, m ** 3), np.float32)
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                k = np.kron(np.kron(Ms[sx], Ms[sy]), Ms[sz])
                out[(sx * 2 + sy) * 2 + sz] = k.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _octant_tensor(m: int, dtype, device) -> torch.Tensor:
    """_octant_transfer(m) on ``device`` (read only), built once: every
    level of every solve applies it."""
    return torch.from_numpy(_octant_transfer(m)).to(device=device,
                                                    dtype=dtype)


def _far_offsets() -> tuple[np.ndarray, np.ndarray]:
    """((NO, 3) int32 offsets, (NO, 3) int8 parity codes): both signs of
    the parity-masked far list (2 <= |o|_inf <= 3)."""
    canon, neg = _offsets_paired(*_SUBSETS["far"])
    offs = np.concatenate([canon, -canon[neg > 0]]).astype(np.int32)
    return offs, _parity_codes(offs)


# -------------------------------------------------------- occupied cells
def _occupied_and_slots(key_s, cap: int):
    """From sorted ids (_BIG last): ``(cells (cap,), slots (n,))``, int32.
    ``cells`` are the sorted unique ids (pad = _BIG); ``slots`` each row's
    rank among them, with _BIG rows and capacity overflow on the dump slot
    ``cap``.  First-occurrence flags and their running count; the list is
    scattered into a (cap + 1,) buffer whose last row takes the dump, so
    there is no host sync."""
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    first &= key_s != _BIG
    slot = torch.cumsum(first, 0, dtype=torch.int32) - 1
    slot = torch.where((key_s == _BIG) | (slot >= cap), cap, slot)
    cells = torch.full((cap + 1,), _BIG, dtype=key_s.dtype,
                       device=key_s.device)
    cells[torch.where(first, slot, cap).long()] = key_s
    return cells[:cap], slot


def _slot_table(cells, C: int):
    """(C^3 + 1,) dense code -> slot table, -1 = unoccupied; index C^3 is
    the clamp target of sentinel queries and stays -1."""
    cap = cells.shape[0]
    table = torch.full((C ** 3 + 2,), -1, dtype=torch.int32,
                       device=cells.device)
    table[torch.where(cells != _BIG, cells, C ** 3 + 1).long()] = \
        torch.arange(cap, dtype=torch.int32, device=cells.device)
    return table[:C ** 3 + 1]


#: levels with at most this many cells look slots up in a dense table, the
#: deeper ones by binary search (murb_tpu's gate; 64 MB of int32)
_TABLE_MAX = 1 << 24


def _slot(cells, cids, C: int | None = None):
    """Slot of each cid in the sorted occupied list; misses (_BIG
    sentinels, capacity overflow) land on the dump slot len(cells)."""
    cap = cells.shape[0]
    if C is not None and C ** 3 <= _TABLE_MAX:
        sp = _slot_table(cells, C)[cids.clamp(0, C ** 3).long()]
        return torch.where(sp < 0, cap, sp).to(torch.int32)
    pos = torch.searchsorted(cells, cids).clamp(0, cap - 1)
    return torch.where(cells[pos] == cids, pos, cap).to(torch.int32)


# ------------------------------------------------------------- M2M / L2L
def _octant_apply(x, oct_idx, m: int, transpose: bool):
    """out[i] = x[i] @ T[oct[i]] (or T^T): 8 masked (N, m^3) @ (m^3, m^3)
    products."""
    T = _octant_tensor(m, x.dtype, x.device)
    out = torch.zeros_like(x)
    for s in range(8):
        xs = torch.where((oct_idx == s)[:, None], x, 0.0)
        out += xs @ (T[s].T if transpose else T[s])
    return out


def m2m_sparse(w_child, child_cells, parent_cells, *, m: int, C_child: int):
    """Child slot expansions -> parent slot expansions (segment sum; a
    _BIG child maps to the parent dump slot)."""
    pid = torch.where(child_cells == _BIG, _BIG, child_cells >> 3)
    up = _octant_apply(w_child[:-1], child_cells & 7, m, transpose=False)
    cap_p = parent_cells.shape[0]
    out = torch.zeros((cap_p + 1, up.shape[1]), dtype=up.dtype,
                      device=up.device)
    return out.index_add_(0, _slot(parent_cells, pid, C_child // 2).long(),
                          up)


def _with_dump_row(x):
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def l2l_sparse(f_parent, parent_cells, child_cells, *, m: int,
               C_child: int):
    """Parent slot fields -> child slot fields (the M2M transpose); the
    dump row stays zero."""
    pid = torch.where(child_cells == _BIG, _BIG, child_cells >> 3)
    fp = f_parent[_slot(parent_cells, pid, C_child // 2).long()]
    return _with_dump_row(_octant_apply(fp, child_cells & 7, m,
                                        transpose=True))


def l2l_from_dense(f_dense, child_cells, *, m: int, C_child: int):
    """Dense-grid parent fields (C_parent^3, m^3) -> sparse child slots."""
    px, py, pz = _munpack(child_cells >> 3, C_child // 2)
    pid = _pack(px, py, pz, C_child // 2).clamp(0, f_dense.shape[0] - 1)
    fp = torch.where((child_cells == _BIG)[:, None], 0.0,
                     f_dense[pid.long()])
    return _with_dump_row(_octant_apply(fp, child_cells & 7, m,
                                        transpose=True))


def densify(w_sparse, cells, C: int):
    """Sparse slot expansions (Morton ids) -> the dense row-major (C^3,
    m^3) grid."""
    cx, cy, cz = _munpack(cells.clamp(max=C ** 3 - 1), C)
    cid = _pack(cx, cy, cz, C).clamp(0, C ** 3 - 1)
    w = torch.where((cells == _BIG)[:, None], 0.0, w_sparse[:-1])
    out = torch.zeros((C ** 3, w.shape[1]), dtype=w.dtype, device=w.device)
    return out.index_add_(0, cid.long(), w)


# ---------------------------------------------------------------- M2L
def _parity_codes(offs: np.ndarray) -> np.ndarray:
    """Per-dimension parity code of the expand telescoping: 0 any, 1 target
    coordinate even (o_d = +3), 2 odd (o_d = -3)."""
    par = np.zeros_like(offs, np.int8)
    par[offs == 3] = 1
    par[offs == -3] = 2
    return par


def _canon_far() -> np.ndarray:
    """(K, 3) canonical far offsets, one per {+o, -o} pair."""
    canon, neg = _offsets_paired(*_SUBSETS["far"])
    assert (neg > 0).all()
    return canon.astype(np.int32)


def _neighbor_slots(cells, C: int, offs: np.ndarray, par: np.ndarray):
    """((NO, cap) source slots, (NO, cap) found mask): for every listed
    offset, each occupied target's occupied source, parity masks applied."""
    cap = cells.shape[0]
    dev = cells.device
    cx, cy, cz = _munpack(cells.clamp(max=C ** 3 - 1), C)
    co = torch.stack([cx, cy, cz], 1)                       # (cap, 3)
    offs_t = torch.as_tensor(offs, dtype=co.dtype, device=dev)
    par_t = torch.as_tensor(par.astype(np.int64), device=dev)[:, None, :]
    nco = co[None] + offs_t[:, None, :]                     # (NO, cap, 3)
    ok = ((nco >= 0) & (nco < C)).all(-1) & (cells != _BIG)[None]
    parity = (co % 2)[None]
    pok = torch.where(par_t == 0, True,
                      torch.where(par_t == 1, parity == 0, parity == 1))
    ok &= pok.all(-1)
    ncc = nco.clamp(0, C - 1)
    sid = morton_key(ncc[..., 0], ncc[..., 1], ncc[..., 2], C)
    if C ** 3 <= _TABLE_MAX:
        spos = _slot_table(cells, C)[torch.where(ok, sid, 0).long()]
        spos = torch.where(spos < 0, cap, spos).to(torch.int32)
    else:
        spos = _slot(cells, torch.where(ok, sid, _BIG))
    return spos, ok & (spos < cap)


@functools.lru_cache(maxsize=None)
def _m2l_basis_cached(m: int, rank: int, device: torch.device):
    t = torch.as_tensor(_cheb_nodes_np(m), dtype=torch.float64, device=device)
    m2 = m * m
    pv = (t.repeat_interleave(m2), t.repeat_interleave(m).repeat(m),
          t.repeat(m2))
    dP = torch.stack([v[None, :] - v[:, None] for v in pv])  # (3, m3, m3)
    canon = torch.as_tensor(_canon_far(), dtype=torch.float64,
                            device=device)
    m3 = m ** 3
    gram = torch.zeros((m3, m3), dtype=torch.float64, device=device)
    step = max(1, _BASIS_ENTRIES // (4 * m3 * m3))
    for soh in (0.0, 0.3, 1.0):
        for k0 in range(0, len(canon), step):
            D = 2.0 * canon[k0:k0 + step, :, None, None] + dP[None]
            inv = torch.rsqrt((D * D).sum(1) + soh * soh)
            ts = torch.cat([D * (inv ** 3)[:, None], inv[:, None]], 1)
            a = ts.reshape(-1, m3)
            gram += a.T @ a
            b = ts.transpose(2, 3).reshape(-1, m3)
            gram += b.T @ b
    vec = torch.linalg.eigh(gram)[1]
    return vec.flip(1)[:, :rank].contiguous()


def m2l_basis(m: int, rank: int, device) -> torch.Tensor:
    """(m^3, rank) float64 orthonormal shared basis of the far transfer
    family (murb_tpu/ops/sparse_fmm.py:_m2l_basis): the top eigenvectors
    of the Gram sum_k (T_k^T T_k + T_k T_k^T) over every canonical far
    offset, the four component kernels (force x/y/z, potential) and
    soft/hl in {0, 0.3, 1}, at unit half-width (hl scales out of the
    operators).  T T^T closes the family under the mirror transpose, so
    one basis serves both signs of T ~ Q (Q^T T Q) Q^T.  Computed in
    float64 on ``device`` (murb_tpu: numpy, the Gram's products in fp32)
    and cached per (m, rank, device): at m = 12 the Gram is about 4e13
    flops.  Eigenvector signs may differ from numpy's; the compressed
    sweep does not depend on them."""
    return _m2l_basis_cached(int(m), int(rank), torch.device(device))


#: float64 entries of one batch of the basis Gram's transfer stack (128
#: MiB): all 158 canonical offsets at once up to m = 5
_BASIS_ENTRIES = 1 << 24

#: murb_tpu's recommended explicit compression ranks (sparse_fmm.py:558):
#: the 1e-5 singular-value crossings of the far transfer family, rounded
#: up to 128-lane multiples
_M2L_RANKS = {8: 384, 10: 640, 12: 896}


def default_m2l_rank(m: int) -> int:
    """Compression off at every order (murb_tpu's default: its truncation
    residuals accumulate to ~1e-4-class force error at flagship scale);
    an explicit ``m2l_rank`` > 0 is the opt-in tier."""
    return 0


def _resolve_rank(plan: SparsePlan, cap: int) -> int:
    """Effective compression rank of one level (murb_tpu's rule): -1 is the
    m-dependent default, and a level below the cap crossover runs
    uncompressed."""
    rank = plan.m2l_rank
    if rank < 0:
        rank = default_m2l_rank(plan.m)
    return rank if cap >= 2 * rank else 0


#: bytes of gathered weights, products and transfer matrices one batch of
#: offsets may hold: the finest 1M-body level takes a few offsets a batch,
#: coarse levels all 158 at once
_M2L_BATCH_BYTES = 512 << 20

#: gathered-operand bytes of one step of the fused form (murb_tpu's
#: _M2L_STEP_BYTES): its offsets a step
_M2L_STEP_BYTES = 128 << 20

def m2l_schedule() -> dict:
    """The sparse M2L's opt-in schedule from the environment, read once at
    a public entry (``solve_adaptive``, the sharded step) and passed down:
    ``scan_chunk`` from MURB_M2L_SCAN_CHUNK (offsets a batch; 0, unset or
    not a positive integer: the byte budget) and ``fused`` from
    MURB_M2L_FUSED ("1" on, anything else off).  The fused form is off by
    default: murb_tpu's cap rule admits no level (its _M2L_FUSED_CAP is 0,
    the form measured slower at every granularity, sparse_fmm.py:590-600)."""
    try:
        chunk = max(0, int(os.environ.get("MURB_M2L_SCAN_CHUNK", "") or 0))
    except ValueError:
        chunk = 0
    return {"scan_chunk": chunk,
            "fused": os.environ.get("MURB_M2L_FUSED", "") == "1"}


class _Products:
    """The sparse M2L's matrix products at a dot tier: plain products, or
    under ``lossy`` (float32 only; float64 runs unrounded)
    ``split3_matmul``'s, inside ``tf32_matmul`` on a card."""

    def __init__(self, lossy: bool, x: torch.Tensor):
        self.lossy = lossy and x.dtype == torch.float32
        self.tf32 = self.lossy and x.device.type == "cuda"

    def __call__(self, a, b):
        if not self.lossy:
            return a @ b
        if not self.tf32:
            return split3_matmul(a, b)
        with tf32_matmul():
            return split3_matmul(a, b)

    def sum2(self, a1, b1, a2, b2):
        """a1 @ b1 + a2 @ b2, batched: fp32 one ``bmm`` and one
        ``baddbmm``; lossy ``split3_matmul``'s six TF32 products
        accumulated in place (no sum of materialized products)."""
        if not self.lossy:
            return torch.baddbmm(torch.bmm(a1, b1), a2, b2)
        out = a1.new_zeros(a1.shape[0], a1.shape[1], b1.shape[2])
        with tf32_matmul() if self.tf32 else contextlib.nullcontext():
            split3_matmul(a1, b1, out=out)
            return split3_matmul(a2, b2, out=out)


def _transfers(o, pv, hl, soft2, nf: int):
    """(b, nf, m^3, m^3) transfer matrices of the offsets ``o`` (b, 3):
    T_d = D_d (D.D + eps^2)^-3/2, T_phi = (D.D + eps^2)^-1/2, D[k, u, v] =
    p_v - p_u + 2 hl o_k."""
    D = [2.0 * hl[d] * o[:, d, None, None]
         + (pv[d][None, :] - pv[d][:, None])[None] for d in range(3)]
    inv = torch.rsqrt(D[0] * D[0] + D[1] * D[1] + D[2] * D[2] + soft2)
    inv3 = inv * inv * inv
    return torch.stack([d * inv3 for d in D] + ([inv] if nf == 4 else []),
                       1)


def m2l_sparse_level(w, cells, hl, soft, *, m: int, C: int,
                     with_phi: bool, m2l_dots: str = "fp32",
                     rank: int = 0, scan_chunk: int = 0,
                     fused: bool = False) -> tuple:
    """Far sweep at one sparse level: nf fields (cap, m^3) of the occupied
    targets from the expansions ``w`` (cap + 1, m^3) of their occupied far
    sources (murb_tpu/ops/sparse_fmm.py:m2l_sparse_level).  Each canonical
    offset o builds its transfer matrices once and applies them to the
    sources at +o and, by the mirror identity T_d(-o) = -T_d(o)^T
    (T_phi(-o) = +T_phi(o)^T), at -o.  The forms, as murb_tpu dispatches
    them: ``rank`` (0 < rank < m^3) the shared-basis compression
    (``_m2l_sparse_level_rank``); else the fused multi-offset contraction
    when ``fused`` (off by default, ``m2l_schedule``); else the batched
    sweep, ``scan_chunk`` offsets a batch (0: the byte budget).
    ``m2l_dots``: "fp32"; "bf16x3" every product lossy (three TF32
    products of split operands, the card's TF32 scope restoring the
    float32 matmul precision however it exits); "mixed" the |o|_inf = 2
    shell at fp32 and the outer shells lossy in the batched sweep, every
    product fp32 in the rank and fused forms (murb_tpu's
    ``m2l_dots == "bf16x3"`` rule there)."""
    check_m2l_dots(m2l_dots)
    rank = rank if 0 < rank < m ** 3 else 0
    kw = dict(m=m, C=C, with_phi=with_phi)
    with trace.span("sparse_m2l", level=C.bit_length() - 1):
        if rank:
            return _m2l_sparse_level_rank(w, cells, hl, soft, rank=rank,
                                          lossy=m2l_dots == "bf16x3", **kw)
        if fused:
            return _m2l_sparse_level_fused(w, cells, hl, soft,
                                           lossy=m2l_dots == "bf16x3", **kw)
        canon = _canon_far()
        if m2l_dots == "mixed":
            shell = np.abs(canon).max(1)
            crit = _m2l_sparse_level_scan(w, cells, hl, soft,
                                          canon[shell <= 2], lossy=False,
                                          scan_chunk=scan_chunk, **kw)
            outer = _m2l_sparse_level_scan(w, cells, hl, soft,
                                           canon[shell >= 3], lossy=True,
                                           scan_chunk=scan_chunk, **kw)
            return tuple(a + b for a, b in zip(crit, outer))
        return _m2l_sparse_level_scan(w, cells, hl, soft, canon,
                                      lossy=m2l_dots == "bf16x3",
                                      scan_chunk=scan_chunk, **kw)


def _sources(w, spos, fnd):
    """The gathered source rows (..., cap, k): zero where no source."""
    cap = spos.shape[-1]
    return torch.where(fnd[..., None], w[spos.clamp(max=cap).long()], 0.0)


def _m2l_sparse_level_scan(w, cells, hl, soft, canon: np.ndarray, *,
                           m: int, C: int, with_phi: bool, lossy: bool,
                           scan_chunk: int = 0) -> tuple:
    """The batched sweep over the canonical offsets ``canon`` (murb_tpu's
    per-offset scan): ``scan_chunk`` offsets a batch, else as many as
    _M2L_BATCH_BYTES holds; one batched product a sign, every field in its
    columns, the batch's sum added to the fields.  No offsets: zero
    fields (murb_tpu divides by the count there)."""
    dtype, dev = w.dtype, w.device
    cap = cells.shape[0]
    m3 = m ** 3
    nf = 4 if with_phi else 3
    acc = torch.zeros((cap, nf * m3), dtype=dtype, device=dev)
    if len(canon):
        spos_p, fnd_p = _neighbor_slots(cells, C, canon,
                                        _parity_codes(canon))
        spos_n, fnd_n = _neighbor_slots(cells, C, -canon,
                                        _parity_codes(-canon))
        pv = _node_vectors(hl, m, dtype, dev)
        soft2 = torch.tensor(soft, dtype=dtype) ** 2
        signs = torch.tensor([-1.0, -1.0, -1.0, 1.0][:nf], dtype=dtype,
                             device=dev)
        per = w.element_size() * (cap * (2 + 2 * nf) * m3 + 10 * m3 * m3)
        batch = scan_chunk or max(1, _M2L_BATCH_BYTES // per)
        mm = _Products(lossy, w)
        for k0 in range(0, len(canon), batch):
            o = torch.as_tensor(canon[k0:k0 + batch], dtype=dtype,
                                device=dev)
            T = _transfers(o, pv, hl, soft2, nf)         # (b, nf, m3, m3)
            b = T.shape[0]
            t_pos = T.transpose(2, 3).permute(0, 2, 1, 3).reshape(
                b, m3, nf * m3)
            t_neg = (T * signs[None, :, None, None]).permute(0, 2, 1, 3) \
                .reshape(b, m3, nf * m3)
            sl = slice(k0, k0 + b)
            part = mm.sum2(_sources(w, spos_p[sl], fnd_p[sl]), t_pos,
                           _sources(w, spos_n[sl], fnd_n[sl]), t_neg)
            acc += part.sum(0)
    return tuple(acc[:, i * m3:(i + 1) * m3] for i in range(nf))


def _m2l_sparse_level_fused(w, cells, hl, soft, *, m: int, C: int,
                            with_phi: bool, lossy: bool) -> tuple:
    """The fused multi-offset form (murb_tpu's _m2l_sparse_level_fused): NC
    offsets a step contract jointly over (offset, 2 m^3), the signs along
    the contraction ([wp | wn] against [-T(-o); -T(+o)], the potential's
    column block +), the fields along the output columns; NC from
    _M2L_STEP_BYTES."""
    dtype, dev = w.dtype, w.device
    cap = cells.shape[0]
    m3 = m ** 3
    nf = 4 if with_phi else 3
    canon = _canon_far()
    nc = max(1, min(len(canon), _M2L_STEP_BYTES // max(cap * 2 * m3 * 4,
                                                        1)))
    spos_p, fnd_p = _neighbor_slots(cells, C, canon, _parity_codes(canon))
    spos_n, fnd_n = _neighbor_slots(cells, C, -canon, _parity_codes(-canon))
    pv = _node_vectors(hl, m, dtype, dev)
    soft2 = torch.tensor(soft, dtype=dtype) ** 2
    sg = torch.tensor([-1.0, -1.0, -1.0, 1.0][:nf], dtype=dtype, device=dev)
    mm = _Products(lossy, w)
    acc = torch.zeros((cap, nf * m3), dtype=dtype, device=dev)
    for k0 in range(0, len(canon), nc):
        o = torch.as_tensor(canon[k0:k0 + nc], dtype=dtype, device=dev)
        b = o.shape[0]

        def block(T):  # (b, nf, m3, m3) -> (b, m3, nf m3), signed columns
            return (T * sg[None, :, None, None]).permute(0, 2, 1, 3) \
                .reshape(b, m3, nf * m3)

        M = torch.cat([block(_transfers(-o, pv, hl, soft2, nf)),
                       block(_transfers(o, pv, hl, soft2, nf))], 1)
        sl = slice(k0, k0 + b)
        wcat = torch.cat([_sources(w, spos_p[sl], fnd_p[sl]),
                          _sources(w, spos_n[sl], fnd_n[sl])], -1)
        # contract over (offset, 2 m^3) in one product
        acc += mm(wcat.permute(1, 0, 2).reshape(cap, b * 2 * m3),
                  M.reshape(b * 2 * m3, nf * m3))
    return tuple(acc[:, i * m3:(i + 1) * m3] for i in range(nf))


def _m2l_sparse_level_rank(w, cells, hl, soft, *, m: int, C: int,
                           with_phi: bool, lossy: bool, rank: int) -> tuple:
    """The shared-basis compressed sweep (murb_tpu's
    _m2l_sparse_level_rank): the sources projected once, w Q (cap + 1, r);
    each offset's transfers projected to Q^T T Q (r, r), shared by both
    signs and every target; the sweep in r-space; the fields back-projected
    by Q^T once.  Offsets in batches under _M2L_BATCH_BYTES."""
    dtype, dev = w.dtype, w.device
    cap = cells.shape[0]
    m3 = m ** 3
    nf = 4 if with_phi else 3
    canon = _canon_far()
    spos_p, fnd_p = _neighbor_slots(cells, C, canon, _parity_codes(canon))
    spos_n, fnd_n = _neighbor_slots(cells, C, -canon, _parity_codes(-canon))
    pv = _node_vectors(hl, m, dtype, dev)
    soft2 = torch.tensor(soft, dtype=dtype) ** 2
    sg = torch.tensor([-1.0, -1.0, -1.0, 1.0][:nf], dtype=dtype, device=dev)
    mm = _Products(lossy, w)
    q = m2l_basis(m, rank, dev).to(dtype)                     # (m3, r)
    wg = mm(w, q)                                             # (cap + 1, r)
    per = w.element_size() * (cap * 4 * rank + (3 + 2 * nf) * m3 * m3)
    batch = max(1, _M2L_BATCH_BYTES // per)
    acc = torch.zeros((cap, nf * rank), dtype=dtype, device=dev)
    for k0 in range(0, len(canon), batch):
        o = torch.as_tensor(canon[k0:k0 + batch], dtype=dtype, device=dev)
        T = _transfers(o, pv, hl, soft2, nf)                  # (b, nf, ...)
        b = T.shape[0]
        cr = mm(q.T, mm(T, q))                                # (b, nf, r, r)
        c_pos = cr.transpose(2, 3).permute(0, 2, 1, 3).reshape(
            b, rank, nf * rank)
        c_neg = (cr * sg[None, :, None, None]).permute(0, 2, 1, 3) \
            .reshape(b, rank, nf * rank)
        sl = slice(k0, k0 + b)
        part = mm.sum2(_sources(wg, spos_p[sl], fnd_p[sl]), c_pos,
                       _sources(wg, spos_n[sl], fnd_n[sl]), c_neg)
        acc += part.sum(0)
    return tuple(mm(acc[:, i * rank:(i + 1) * rank], q.T)
                 for i in range(nf))


# ----------------------------------------------------------- full solver
def hierarchy_fields(w_fin, cells_fin, c, h, soft, plan: SparsePlan,
                     with_phi: bool, m2l_dots: str = "fp32",
                     scan_chunk: int = 0, fused: bool = False):
    """Finest-level slot fields from the finest occupied expansions: the
    parent occupied chain, M2M upward, the dense base, L2L and M2L downward
    (every M2L at the tier ``m2l_dots``; ``scan_chunk`` and ``fused`` the
    sparse M2L's schedule, ``m2l_schedule``).  Returns (nf fields (cap + 1,
    m^3) with a zero dump row, diagnostics)."""
    m = plan.m
    Ld, L = plan.dense_levels, plan.levels
    with trace.span("adaptive.upward"):
        cells = {L: cells_fin}
        for l in range(L - 1, Ld, -1):
            ids = torch.where(cells[l + 1] == _BIG, _BIG, cells[l + 1] >> 3)
            cells[l], _ = _occupied_and_slots(ids,
                                              plan.cell_caps[l - Ld - 1])
        diag = {"n_cells": tuple((cells[l] != _BIG).sum()
                                 for l in range(Ld + 1, L + 1))}

        w = {L: w_fin}
        for l in range(L - 1, Ld, -1):
            w[l] = m2m_sparse(w[l + 1], cells[l + 1], cells[l], m=m,
                              C_child=2 ** (l + 1))
        code = cells[Ld + 1]
        up = _octant_apply(w[Ld + 1][:-1], code & 7, m, transpose=False)
        is_pad = code == _BIG
        px, py, pz = _munpack(code.clamp(max=8 ** (Ld + 1) - 1) >> 3,
                              2 ** Ld)
        pid = torch.where(is_pad, 0, _pack(px, py, pz, 2 ** Ld))
        up = torch.where(is_pad[:, None], 0.0, up)
        w_dense = torch.zeros((8 ** Ld, m ** 3), dtype=up.dtype,
                              device=up.device).index_add_(0, pid.long(), up)

    with trace.span("adaptive.dense"):
        f_dense = fmm_field_grid(w_dense, h, soft, m=m, levels=Ld,
                                 with_phi=with_phi, finest_subset="far",
                                 m2l_dots=m2l_dots)
    f = None
    for l in range(Ld + 1, L + 1):
        C = 2 ** l
        cap = plan.cell_caps[l - Ld - 1]
        with trace.span("adaptive.l2l", level=l):
            if f is None:
                f = tuple(l2l_from_dense(fd, cells[l], m=m, C_child=C)
                          for fd in f_dense)
            else:
                f = tuple(l2l_sparse(fi, cells[l - 1], cells[l], m=m,
                                     C_child=C) for fi in f)
        contrib = m2l_sparse_level(w[l], cells[l], h / C, soft, m=m, C=C,
                                   with_phi=with_phi, m2l_dots=m2l_dots,
                                   rank=_resolve_rank(plan, cap),
                                   scan_chunk=scan_chunk, fused=fused)
        # L2L gave (cap + 1, m^3), M2L (cap, m^3): keep the zero dump row
        # (the next L2L and the final L2P read it for missing slots)
        f = tuple(_with_dump_row(fi[:cap] + ci) for fi, ci in zip(f, contrib))
    return f, diag


def adaptive_field(xs, ys, zs, gs, key_s, c, h, soft, plan: SparsePlan,
                   with_phi: bool, m2l_dots: str = "fp32", ci=None,
                   **schedule):
    """Far fields of every Morton-sorted body (``key_s``: the sorted finest
    codes, _BIG for inactive rows; ``ci``: the bodies' int32 cells) via the
    dense levels 2..Ld and the sparse levels Ld+1..L, the finest near
    neighbourhood excluded (``schedule``: ``hierarchy_fields``'s
    ``scan_chunk`` and ``fused``).  Returns (per-body field tuple in sorted
    order, diagnostics)."""
    m, Cfin, cap = plan.m, 2 ** plan.levels, plan.cell_caps[-1]
    with trace.span("adaptive.p2m"):
        cells_fin, slots = _occupied_and_slots(key_s, cap)
        w_fin = p2m_window(xs, ys, zs, gs, c, h, slots, cap, m=m, C=Cfin,
                           ci=ci)
    f, diag = hierarchy_fields(w_fin, cells_fin, c, h, soft, plan, with_phi,
                               m2l_dots, **schedule)
    with trace.span("adaptive.l2p"):
        vals = l2p_window(xs, ys, zs, c, h, slots, f, m=m, C=Cfin, ci=ci)
    return vals, diag


def solve_adaptive(qx, qy, qz, gm, soft, plan: SparsePlan, *, heavy_k: int,
                   heavy_factor: float, with_phi: bool,
                   m2l_dots: str = "fp32"):
    """(acc (n, 3), phi or None): the adaptive counterpart of
    ops/fmm._fmm_solve -- cubic box, heavy split, sparse far field, exact
    P2P near field, exact heavy corrections.  The sparse M2L's schedule
    comes from the environment here (``m2l_schedule``)."""
    from murb_tpu_torch.ops.fmm import _heavy_setup
    from murb_tpu_torch.ops.naive import acc_rect
    from murb_tpu_torch.ops.proxy import (heavy_source_acc,
                                          heavy_source_phi_rows,
                                          heavy_target_phi_rows)

    n = qx.shape[0]
    with trace.span("adaptive.sort"):
        c, h, hq, heavy_gm, is_heavy, top_idx, gm_eff = _heavy_setup(
            qx, qy, qz, gm, heavy_k, heavy_factor)
        h = h.max().expand(3)       # cubic cells: see ops/fmm._fmm_solve

        # one stable Morton sort shared by every sparse stage, one unsort
        key, ci = sorted_cells(qx, qy, qz, gm_eff > 0, c, h,
                               2 ** plan.levels)
        key_s, perm = torch.sort(key, stable=True)
        xs, ys, zs, gs = (v[perm] for v in (qx, qy, qz, gm_eff))
        ci = tuple(v[perm] for v in ci)
    vals, _ = adaptive_field(xs, ys, zs, gs, key_s, c, h, soft, plan,
                             with_phi, m2l_dots, ci=ci, **m2l_schedule())
    with trace.span("adaptive.near"):
        near, _ = p2p_sweep_kernel_sorted(xs, ys, zs, gs, ci, soft,
                                          pmax=plan.p2p_pmax,
                                          chunk=plan.p2p_chunk,
                                          with_phi=with_phi)

    def unsort(a):
        out = torch.empty(n, dtype=qx.dtype, device=qx.device)
        out[perm] = a
        return out

    with trace.span("adaptive.combine"):
        tot = [unsort(v + p.reshape(n)) for v, p in zip(vals, near)]
        acc = torch.stack(tot[:3], 1) + heavy_source_acc(qx, qy, qz, hq,
                                                         heavy_gm, soft)
        ht = torch.stack(list(acc_rect(hq[0], hq[1], hq[2], qx, qy, qz, gm,
                                       soft)), dim=1)
        acc[top_idx] = torch.where(is_heavy[:, None], ht, acc[top_idx])
        phi = None
        if with_phi:
            phi = tot[3] + heavy_source_phi_rows(qx, qy, qz, hq,
                                                 heavy_gm[None, :], soft)[0]
            phi_h = heavy_target_phi_rows(qx, qy, qz, gm[None, :], hq,
                                          soft)[0]
            phi[top_idx] = torch.where(is_heavy, phi_h, phi[top_idx])
    return acc, phi


#: murb_tpu's heavy split for the adaptive solver (sparse_fmm.py:1139)
HEAVY_K, HEAVY_FACTOR = 1, 64.0


def acc_adaptive(qx, qy, qz, gm, soft, plan: SparsePlan, *,
                 heavy_k: int = HEAVY_K, heavy_factor: float = HEAVY_FACTOR,
                 m2l_dots: str = "fp32") -> Accel:
    """All-pairs softened gravity via the adaptive hierarchy (``plan`` from
    ``plan_adaptive``; murb_tpu/ops/sparse_fmm.py:acc_adaptive)."""
    acc, _ = solve_adaptive(qx, qy, qz, gm, soft, plan, heavy_k=heavy_k,
                            heavy_factor=heavy_factor, with_phi=False,
                            m2l_dots=m2l_dots)
    return Accel(acc[:, 0], acc[:, 1], acc[:, 2])


def force_and_potential_adaptive(qx, qy, qz, gm, soft, plan: SparsePlan, *,
                                 heavy_k: int = HEAVY_K,
                                 heavy_factor: float = HEAVY_FACTOR,
                                 m2l_dots: str = "fp32"):
    """(Accel, phi) in one adaptive pass: the tracking engines' entry.  phi
    includes the self term G m_i / eps, as the exact sweeps do."""
    acc, phi = solve_adaptive(qx, qy, qz, gm, soft, plan, heavy_k=heavy_k,
                              heavy_factor=heavy_factor, with_phi=True,
                              m2l_dots=m2l_dots)
    return Accel(acc[:, 0], acc[:, 1], acc[:, 2]), phi


# --------------------------------------------------------------- planner
def level_stats(q, dense_levels: int, levels: int) -> list[int]:
    """Occupied-cell counts per sparse level of the distribution ``q``
    (n_active, 3): what the solve's occupied lists hold
    (murb_tpu/ops/sparse_fmm.py:level_stats).  Computed on ``q``'s device
    (numpy on the CPU) from ``plan_cells``' finest cells and read back
    once: a level's cells are the finest Morton keys shifted right by 3
    a level, counted as the distinct values of one sorted array."""
    ci = plan_cells(q, levels)
    key = torch.sort(morton_key(ci[:, 0], ci[:, 1], ci[:, 2],
                                2 ** levels)).values
    counts = []
    for l in range(dense_levels + 1, levels + 1):
        k = key >> 3 * (levels - l)
        counts.append(1 + (k[1:] != k[:-1]).sum())
    return torch.stack(counts).tolist() if counts else []


def _impl(device) -> str:
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def plan_adaptive(q, npad: int, m: int, dense_levels: int,
                  levels: int, *, cell_margin: float = 1.3,
                  p2p_margin: float = 1.5, p2p_impl: str | None = None,
                  m2l_rank: int = -1, device="cuda") -> SparsePlan:
    """A SparsePlan for the distribution ``q`` (n_active, 3; numpy, or a
    tensor on the device its counts are to run on) at the given geometry,
    with margined capacities.  ``p2p_impl`` defaults to the sweep
    of ``device``: K10 ("kernel") on a card, "plain" on the CPU; the pair
    capacity is ``size_pmax``'s for both."""
    stats = level_stats(q, dense_levels, levels)
    n_pairs = estimate_brick_pairs(q, npad, levels)
    trace.count("plan.brick_pairs", n_pairs)
    return SparsePlan(
        m=m, dense_levels=dense_levels, levels=levels,
        cell_caps=tuple(int(nc * cell_margin) + 9 for nc in stats),
        p2p_pmax=size_pmax(n_pairs, margin=p2p_margin),
        p2p_impl=_IMPLS[p2p_impl or _impl(device)], m2l_rank=m2l_rank)


def p2p_capacity_needed(n_pairs: int) -> int:
    """The pair capacity the current distribution needs (the health-check
    counterpart of plan_adaptive's sizing, margin 1).  murb_tpu's also takes
    npad and the plan, for the TPU kernel's run padding, which K10 does not
    need."""
    return size_pmax(n_pairs, margin=1.0)


class PlannerRates(NamedTuple):
    """The constants of the adaptive and exact cost models
    (``_cost_from_stats``, ``exact_cost_ms``) for one device type."""
    mac_per_ms: float            # M2L multiply-adds (sparse and dense)
    gather_bytes_per_ms: float   # the sparse M2L's source gathers
    p2p_slots_per_ms: float      # the near sweep the device's plans run
    anterp_us_per_body: float    # the P2M and L2P windows (K11, K12)
    misc_ms_per_level: float     # sorts, uniques, chains: a sparse level
    misc_ms: float               # and once a solve
    factor: float                # the step over the stage sum
    exact_slots_per_ms: float    # the exact sweep, 14 slots a pair


#: The cost models' constants by the device type of the state.  "cpu" is
#: murb_tpu's, measured on a TPU v5e (murb_tpu/ops/sparse_fmm.py:1229-1240,
#: the misc terms and the end-to-end factor :1268-1274), kept so that a CPU
#: state plans and adopts what murb_tpu does; they are not times of the
#: port.  Its P2P rate is murb_tpu's jnp sweep's, the one murb_tpu uses
#: off the TPU (the plain sweep, which a CPU plan runs).  "cuda" is the
#: H100's (NVIDIA H100 80GB HBM3, 700.00 W), fitted by
#: scripts/torch_adaptive_stage_probe.py on the two-cluster box at 131,072,
#: 262,144, 524,288 and 1,048,576 bodies (PERF.md "Planner rates"; the
#: measurements in docs/planner_rates/h100_stage_raw.json, which ``--from``
#: fits again):
#:   mac_per_ms, gather_bytes_per_ms: the sparse M2L a level (orders 4, 6
#:     and 8, every level) at 1.56e10 MAC/ms and 7.56e7 B/ms plus 8.24 ms a
#:     call, as the MACs and bytes the model counts at the planning order
#:     8 cost at the validated order 6 (times (8/6)^6 and (8/6)^3);
#:   p2p_slots_per_ms: K10's sweep, the median over the four N;
#:   anterp_us_per_body: K11 + K12 with their glue, the median;
#:   misc_ms_per_level, misc_ms, factor: least squares over the 18 engine
#:     steps at the validated order (the plans and their neighbours);
#:   exact_slots_per_ms: the exact step (K4 passes 2 on K3's kernel), 14
#:     slots a pair, the median over the four N.
PLANNER_RATES = {
    "cpu": PlannerRates(mac_per_ms=2.2e10, gather_bytes_per_ms=150e9 / 1e3,
                        p2p_slots_per_ms=1.2e9, anterp_us_per_body=0.38,
                        misc_ms_per_level=0.5, misc_ms=2.0, factor=2.0,
                        exact_slots_per_ms=3.9e9),
    "cuda": PlannerRates(mac_per_ms=87405745163.3471,
                         gather_bytes_per_ms=179135312.097812,
                         p2p_slots_per_ms=40166084853.96363,
                         anterp_us_per_body=0.0022878519606213863,
                         misc_ms_per_level=12.268574321266613,
                         misc_ms=14.922682950046912,
                         factor=0.9075862120289167,
                         exact_slots_per_ms=28478994427.459156),
}


def planner_rates(device) -> PlannerRates:
    """PLANNER_RATES of ``device``'s type; raises for a type with none."""
    kind = torch.device(device).type
    if kind not in PLANNER_RATES:
        raise ValueError(f"no planner rates for device type {kind!r} "
                         f"(known: {sorted(PLANNER_RATES)})")
    return PLANNER_RATES[kind]


def cost_with_rates(rates: PlannerRates, stats, n_bricks, npad, m,
                    dense_levels, levels, nf: int = 3,
                    m2l_rank: int = -1) -> float:
    """murb_tpu's adaptive step model (sparse_fmm.py:1248-1274) in ms at
    ``rates``: the M2L (the sparse levels of ``stats`` occupied cells and
    the dense base) at its MAC and gather rates, the P2P sweep's 26 slots a
    brick pair, the anterpolation a body, the misc terms, all times the
    end-to-end factor."""
    NO = len(_far_offsets()[0])
    rank = default_m2l_rank(m) if m2l_rank < 0 else m2l_rank
    m3 = m ** 3
    m2l = 0.0
    for nc in stats:
        rows = NO * nc
        cap = int(nc * 1.3) + 9              # plan_adaptive's cap sizing
        r = rank if (rank and cap >= 2 * rank) else 0
        if r:
            per_field = rows * r * r + NO * (m3 * m3 * r + m3 * r * r)
        else:
            per_field = rows * m3 * m3
        m2l += per_field * nf / rates.mac_per_ms
        m2l += rows * (r or m3) * 4 / rates.gather_bytes_per_ms
    m2l += 686 * 8 ** dense_levels * m ** 6 * nf / rates.mac_per_ms
    p2p = n_bricks * DEFAULT_K ** 2 * 26 / rates.p2p_slots_per_ms
    anterp = npad * rates.anterp_us_per_body / 1e3
    misc = rates.misc_ms_per_level * (levels - dense_levels) + rates.misc_ms
    return rates.factor * (m2l + p2p + anterp + misc)


def _cost_from_stats(stats, n_bricks, npad, m, dense_levels, levels,
                     nf: int = 3, m2l_rank: int = -1,
                     device="cuda") -> float:
    return cost_with_rates(planner_rates(device), stats, n_bricks, npad, m,
                           dense_levels, levels, nf, m2l_rank)


def plan_cost_ms(q, npad: int, m: int, dense_levels: int,
                 levels: int, nf: int = 3, m2l_rank: int = -1,
                 device="cuda") -> float:
    """Estimated adaptive step cost in ms at ``device``'s rates
    (planner_rates)."""
    return _cost_from_stats(level_stats(q, dense_levels, levels),
                            estimate_brick_pairs(q, npad, levels),
                            npad, m, dense_levels, levels, nf, m2l_rank,
                            device)


def exact_cost_ms(npad: int, device="cuda") -> float:
    """The exact sweep's cost model in ms: 14 slots a body pair at
    ``device``'s rate (planner_rates)."""
    return 14.0 * npad * npad / planner_rates(device).exact_slots_per_ms


#: error prefactor of the adaptive far shell, err ~ C rho^-m with rho =
#: 2 + sqrt(5) (murb_tpu measured C ~ 0.6-0.75; 1.0 is the safe pick)
ADAPTIVE_ERR_PREFACTOR = 1.0


def adaptive_order(tol: float = 1e-4) -> int:
    """Initial Chebyshev order of the adaptive solver: scale-free, set by
    the |o|_inf >= 2 far shell, rounded up to even (the ladder's rungs)."""
    rho = 2.0 + math.sqrt(5.0)
    m = math.ceil(math.log(ADAPTIVE_ERR_PREFACTOR / max(tol, 1e-12))
                  / math.log(rho))
    return max(4, m + (m % 2))


def best_adaptive_plan(q, npad: int, m: int,
                       max_levels: int = 9, m2l_rank: int = -1,
                       device="cuda") -> tuple[SparsePlan, float]:
    """(plan, est_ms): the cheapest (dense_levels, levels) for the current
    distribution ``q`` (as plan_adaptive's) under the cost model, the
    per-level counts and pair estimates shared across candidates."""
    per_level = level_stats(q, 2, max_levels)
    nc_at = {l: per_level[l - 3] for l in range(3, max_levels + 1)}
    bricks_at = {L: estimate_brick_pairs(q, npad, L)
                 for L in range(3, max_levels + 1)}
    best = None
    for Ld in (2, 3):
        for L in range(Ld + 1, max_levels + 1):
            stats = [nc_at[l] for l in range(Ld + 1, L + 1)]
            cost = _cost_from_stats(stats, bricks_at[L], npad, m, Ld, L,
                                    m2l_rank=m2l_rank, device=device)
            if best is None or cost < best[0]:
                best = (cost, Ld, L)
    cost, Ld, L = best
    return plan_adaptive(q, npad, m, Ld, L, m2l_rank=m2l_rank,
                         device=device), cost
