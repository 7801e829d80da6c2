"""Multi-level Chebyshev hierarchy (bbFMM): O(N m^3 + cells m^6).

Port of ``murb_tpu/ops/fmm.py`` (the interpolated-near-field mode).  An
L-level uniform hierarchy of cells, 2^L per dimension at the finest level,
where every stage stays a dense regular-grid contraction:

  P2M   bodies -> finest-level cell expansions (C^3, m^3)       (kernel K8)
  M2M   child -> parent expansions, three per-dimension einsums with the
        scale-invariant (2, m, m) transfer matrices (``torch.einsum``, as
        the JAX package left it to XLA)
  M2L   per level: the node force fields (and potential) of every cell from
        its offset neighborhood, expand(near(l - 1)) minus near(l), the
        finest level's near list included                     (kernel K7)
  L2L   parent -> child field interpolation (``torch.einsum``)
  L2P   each body reads its own cell's fields                 (kernel K9)

Heavy bodies are excluded and corrected exactly, as in ops/proxy.py.  The
host helpers (offset lists, transfer matrices, the depth-cost policy)
match murb_tpu's exactly; the depth-cost policy takes its level overhead
from the state's device type (murb_tpu's on the CPU, so a CPU state picks
murb_tpu's (m, levels); the H100's measured rate on a card).

``near="p2p"`` leaves the finest level's 27-cell neighbourhood out of the
sweeps (one "far" sweep there) and sums it exactly with the P2P stage of
ops/p2p.py (kernel K10) in a cubic box.  ``m2l_dots`` picks the level
sweeps' tier as murb_tpu's does: "fp32" everywhere, "bf16x3" (K7's lossy
instance, 3xTF32 products, everywhere) or "mixed" (an expand sweep as its
near part at fp32 plus its far part lossy; every other sweep fp32).  The
TPU autotuner knobs ``block`` and ``m2l_tile`` have no counterpart.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from murb_tpu_torch.ops.common import Accel
from murb_tpu_torch.ops.fmm_kernels import (cell_order, l2p_grid_fused,
                                            m2l_level_fused, p2m_grid_fused)
from murb_tpu_torch.ops.naive import acc_rect
from murb_tpu_torch.ops.p2p import DEFAULT_CHUNK as P2P_CHUNK
from murb_tpu_torch.ops.p2p_kernels import p2p_sweep
from murb_tpu_torch.ops.proxy import (HEAVY_FACTOR, HEAVY_K, _heavy_setup,
                                      check_fast_geometry, heavy_source_acc,
                                      heavy_source_phi_rows,
                                      heavy_target_phi_rows, required_order)


# --------------------------------------------------------- host operators
def _cheb_nodes_np(m: int) -> np.ndarray:
    return np.cos(np.pi * (np.arange(m) + 0.5) / m)


def _basis_np(t: np.ndarray, m: int) -> np.ndarray:
    """Lagrange-on-Chebyshev basis S (len(t), m) in float64 (host)."""
    t = np.clip(np.asarray(t, np.float64), -1.0, 1.0)
    theta_nodes = np.pi * (np.arange(m) + 0.5) / m
    j = np.arange(1, m)
    tj_nodes = np.cos(np.outer(j, theta_nodes))           # (m-1, m)
    tj_t = np.cos(np.outer(np.arccos(t), j))              # (T, m-1)
    return 1.0 / m + (2.0 / m) * tj_t @ tj_nodes          # (T, m)


@functools.lru_cache(maxsize=None)
def _m2m_matrix(m: int) -> np.ndarray:
    """M (2, m, m) float32: M[s, v, u] = parent basis S_u at child node v of
    child side s (child cells occupy the parent's [-1, 0] / [0, 1] halves);
    identical at every level."""
    t = _cheb_nodes_np(m)
    return np.stack([_basis_np((2 * s - 1) * 0.5 + 0.5 * t, m)
                     for s in (0, 1)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _offsets_paired(reach: int,
                    min_inf: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Canonical offsets of the shell min_inf <= |o|_inf <= reach, one per
    {+o, -o} pair -> (offsets (K, 3) int32, neg_valid (K,) float32, 0 for
    the o = 0 entry, which has no mirror)."""
    r = np.arange(-reach, reach + 1)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    canon, neg = [], []
    for o in offs:
        if np.abs(o).max() < min_inf:
            continue
        first = next((x for x in o if x != 0), 0)
        if first < 0:
            continue  # its mirror is canonical
        canon.append(o)
        neg.append(0.0 if first == 0 else 1.0)
    return (np.asarray(canon, np.int32), np.asarray(neg, np.float32))


#: the offset subsets of a level sweep: ``expand`` is expand(near(l - 1)),
#: ``near`` (|o|_inf <= 1) the part handled one level deeper, ``far`` their
#: difference (expand = near + far, pairwise exact)
_SUBSETS = {"expand": (3, 0), "near": (1, 0), "far": (3, 2)}


# ------------------------------------------------------------- M2M / L2L
def m2m(w, *, m: int, C: int):
    """Child expansions (C^3, m^3) -> parent expansions ((C/2)^3, m^3)."""
    M = torch.as_tensor(_m2m_matrix(m)).to(w.device, w.dtype)   # (2, m, m)
    P = C // 2
    g = w.reshape(P, 2, C, C, m, m, m)
    g = torch.einsum("xsyzuvw,sue->xyzevw", g, M)
    g = g.reshape(P, P, 2, C, m, m, m)
    g = torch.einsum("xytzevw,tvf->xyzefw", g, M)
    g = g.reshape(P, P, P, 2, m, m, m)
    g = torch.einsum("xyzrefw,rwg->xyzefg", g, M)
    return g.reshape(P ** 3, m ** 3)


def l2l(f, *, m: int, C: int):
    """Parent field (C^3, m^3) -> child field ((2C)^3, m^3), the transpose
    of M2M."""
    M = torch.as_tensor(_m2m_matrix(m)).to(f.device, f.dtype)
    g = f.reshape(C, C, C, m, m, m)
    g = torch.einsum("xyzefg,rwg->xyzefrw", g, M)
    g = torch.einsum("xyzefrw,tvf->xyzetvrw", g, M)
    g = torch.einsum("xyzetvrw,sue->xsytzruvw", g, M)
    return g.reshape((2 * C) ** 3, m ** 3)


# --------------------------------------------------------- downward pass
def level_sweep(w, hl, soft, *, m: int, C: int, subset: str,
                with_phi: bool, m2l_dots: str = "fp32",
                m2l_tile: int = 0) -> tuple:
    """One level sweep at the tier ``m2l_dots`` (murb_tpu/ops/fmm.py:
    fused_sweep): under "mixed" an expand sweep runs as its near part at
    fp32 plus its far part lossy (expand = near + far, pairwise); every
    sweep is lossy under "bf16x3" and fp32 otherwise.  One K7 launch a
    part on CUDA tensors, in items of at most ``m2l_tile`` target cells
    (0: K7's own)."""
    kw = dict(m=m, C=C, with_phi=with_phi, tile=m2l_tile)
    if m2l_dots == "mixed" and subset == "expand":
        near = m2l_level_fused(w, hl, soft, subset="near", dots="fp32", **kw)
        far = m2l_level_fused(w, hl, soft, subset="far", dots="bf16x3", **kw)
        return tuple(a + b for a, b in zip(near, far))
    return m2l_level_fused(w, hl, soft, subset=subset,
                           dots="bf16x3" if m2l_dots == "bf16x3" else "fp32",
                           **kw)


def fmm_field_grid(w_finest, h, soft, *, m: int, levels: int,
                   with_phi: bool = False, finest_subset: str = "expand",
                   m2l_dots: str = "fp32", m2l_tile: int = 0) -> tuple:
    """Finest-level node fields (fx, fy, fz[, phi]) via the full hierarchy:
    coarser expansions by M2M, at each level from l0 = min(2, L) an expand
    sweep, minus a near sweep at every level but the finest, fields carried
    down by L2L (murb_tpu/ops/fmm.py:fmm_field_grid).  ``finest_subset``
    "far" replaces the finest level's expand sweep by one far sweep (far =
    expand minus near, pairwise), leaving the finest near neighbourhood to
    an exact P2P stage.  Each sweep is ``level_sweep`` at ``m2l_dots`` and
    ``m2l_tile``.  murb_tpu's ``fused=`` (whether its sweeps take the
    Pallas kernel) has no counterpart: a CUDA tensor always takes K7."""
    if finest_subset not in ("expand", "far"):
        raise ValueError(f"unknown finest subset {finest_subset!r} "
                         "(expand, far)")
    check_m2l_dots(m2l_dots)
    l0 = min(2, levels)  # level 1's expand and near lists coincide (C = 2)
    ws = {levels: w_finest}
    for l in range(levels - 1, l0 - 1, -1):
        ws[l] = m2m(ws[l + 1], m=m, C=2 ** (l + 1))

    f = None
    for l in range(l0, levels + 1):
        C = 2 ** l
        hl = h / C
        if f is not None:
            f = tuple(l2l(fd, m=m, C=C // 2) for fd in f)
        kw = dict(m=m, C=C, with_phi=with_phi, m2l_dots=m2l_dots,
                  m2l_tile=m2l_tile)
        subset = finest_subset if l == levels else "expand"
        contrib = level_sweep(ws[l], hl, soft, subset=subset, **kw)
        f = contrib if f is None else tuple(a + b for a, b in zip(f, contrib))
        if l < levels:
            near = level_sweep(ws[l], hl, soft, subset="near", **kw)
            f = tuple(a - b for a, b in zip(f, near))
    return f


# ------------------------------------------------------------ policies
def required_levels(halfwidth: float, soft: float, *, a_target: float = 1.0,
                    max_levels: int = 4) -> int:
    """Hierarchy depth so the finest cells satisfy eps/h_L >= a_target."""
    if halfwidth <= soft * a_target:
        return 1
    return min(int(math.ceil(math.log2(halfwidth * a_target / soft))),
               max_levels)


#: The depth-cost model's fixed cost of one more level, in MAC
#: equivalents, by the device type of the state.  "cpu" is murb_tpu's
#: constant, calibrated on a TPU v5e (murb_tpu/ops/fmm.py:460-491: about
#: 1.75 ms at its ~2e10 MAC/ms M2L rate), kept so that a CPU state picks
#: murb_tpu's (m, levels); it is not a time of the port.  "cuda" is the
#: H100's (NVIDIA H100 80GB HBM3, 700.00 W): 2.474 ms a level times the
#: step's 2.437e10 MAC/ms, both fitted by scripts/torch_m2l_tier_probe.py
#: over tpu+proxy's step at 13 (m, levels) on the 200k random box (PERF.md
#: "Planner rates"; the measurements in
#: docs/planner_rates/h100_depth_raw.json, which ``--from`` fits again).
LEVEL_OVERHEAD = {"cpu": 3.5e10, "cuda": 60279289029.630226}


def level_overhead(device) -> float:
    """LEVEL_OVERHEAD of ``device``'s type; raises for a type with none."""
    kind = torch.device(device).type
    if kind not in LEVEL_OVERHEAD:
        raise ValueError(f"no depth-cost rates for device type {kind!r} "
                         f"(known: {sorted(LEVEL_OVERHEAD)})")
    return LEVEL_OVERHEAD[kind]


def depth_candidates(n: int, halfwidth: float, soft: float,
                     tol: float = 1e-4,
                     device="cuda") -> list[tuple[float, int, int]]:
    """(est, m, levels) of each depth the depth-cost model weighs, from
    required_levels to 4: P2M/L2P work 8 n m^3, the expand sweeps
    686 8^L m^6, and ``device``'s LEVEL_OVERHEAD per level past the
    minimum."""
    overhead = level_overhead(device)
    lmin = required_levels(halfwidth, soft)
    out = []
    for levels in range(lmin, max(lmin, 4) + 1):
        m = fmm_order(halfwidth, soft, levels, tol)
        out.append((8 * n * m ** 3 + 686 * 8 ** levels * m ** 6
                    + overhead * (levels - lmin), m, levels))
    return out


def best_depth(n: int, halfwidth: float, soft: float, tol: float = 1e-4,
               device="cuda") -> tuple[int, int]:
    """(m, levels) of the cheapest depth_candidates (the first on a tie)."""
    _, m, levels = min(depth_candidates(n, halfwidth, soft, tol, device),
                       key=lambda c: c[0])
    return m, levels


#: Error prefactor of the hierarchical solver with 3x safety, measured by
#: the JAX package (murb_tpu/ops/fmm.py:492-506); the port keeps it so the
#: validation ladder takes the same rungs.
FMM_ERR_PREFACTOR = 0.3


def fmm_order(halfwidth: float, soft: float, levels: int,
              tol: float = 1e-4) -> int:
    """Chebyshev order for the hierarchical solver: the finest-level
    same-cell interpolation bound with the measured prefactor."""
    return required_order(halfwidth / 2 ** levels, soft,
                          tol / FMM_ERR_PREFACTOR, margin=0)


# ------------------------------------------------------------- top level
#: the M2L dot tiers (murb_tpu/models/engines.py:_check_m2l_dots)
M2L_TIERS = ("fp32", "mixed", "bf16x3")


def check_m2l_dots(tier: str) -> str:
    """The M2L sweeps' dot tier: "fp32", "mixed" or "bf16x3"; anything else
    raises ValueError."""
    if tier not in M2L_TIERS:
        raise ValueError(f"unknown m2l_dots tier: {tier!r}")
    return tier


def _check_modes(m2l_dots: str, near: str, p2p_pmax: int = 0) -> None:
    check_m2l_dots(m2l_dots)
    if near not in ("interp", "p2p"):
        raise ValueError(f"unknown near mode: {near!r} (interp, p2p)")
    if near == "p2p" and p2p_pmax <= 0:
        raise ValueError("near='p2p' requires a sized p2p_pmax "
                         "(ops/p2p.size_pmax from the distribution)")


def _fmm_solve(qx, qy, qz, gm, soft, *, m: int, levels: int, heavy_k: int,
               heavy_factor: float, m2l_dots: str, with_phi: bool,
               block: int = 0, m2l_tile: int = 0, near: str = "interp",
               p2p_pmax: int = 0, p2p_chunk: int = 0):
    """The hierarchy pass behind acc_fmm / force_and_potential_fmm: box,
    heavy split, P2M (K8 in items of ``block`` bodies), level sweeps (K7
    in items of ``m2l_tile`` cells), L2P, the P2P stage when
    ``near="p2p"`` (capacity ``p2p_pmax``), and the exact heavy-body
    corrections -> (acc (n, 3), phi (n,) or None)."""
    _check_modes(m2l_dots, near, p2p_pmax)
    check_fast_geometry(m, levels, 1, block, m2l_tile)
    C = 2 ** levels
    c, h, hq, heavy_gm, is_heavy, top_idx, gm_eff = _heavy_setup(
        qx, qy, qz, gm, heavy_k, heavy_factor)
    if near == "p2p":
        # cubic cells: the far shells' |o| >= 2 separation holds per
        # dimension only when the cells are cubes (murb_tpu/ops/fmm.py:543)
        h = h.max().expand(3)
    order = (cell_order(qx, qy, qz, c, h, C) if qx.device.type == "cuda"
             else None)
    w = p2m_grid_fused(qx, qy, qz, gm_eff, c, h, m=m, C=C, order=order,
                       chunk=block)
    fields = fmm_field_grid(w, h, soft, m=m, levels=levels,
                            with_phi=with_phi,
                            finest_subset="far" if near == "p2p" else
                            "expand", m2l_dots=m2l_dots, m2l_tile=m2l_tile)
    out = l2p_grid_fused(qx, qy, qz, c, h, fields, m=m, C=C, order=order)
    acc = torch.stack(out[:3], dim=1)
    phi_near = None
    if near == "p2p":
        acc_near, phi_near, _ = p2p_sweep(
            qx, qy, qz, gm_eff, c, h, soft, C=C, pmax=p2p_pmax,
            chunk=p2p_chunk or P2P_CHUNK, with_phi=with_phi)
        acc = acc + acc_near
    acc = acc + heavy_source_acc(qx, qy, qz, hq, heavy_gm, soft)
    ht = torch.stack(list(acc_rect(hq[0], hq[1], hq[2], qx, qy, qz, gm,
                                   soft)), dim=1)
    acc[top_idx] = torch.where(is_heavy[:, None], ht, acc[top_idx])

    phi = None
    if with_phi:
        phi = out[3] + heavy_source_phi_rows(qx, qy, qz, hq,
                                             heavy_gm[None, :], soft)[0]
        if phi_near is not None:
            phi = phi + phi_near
        phi_h = heavy_target_phi_rows(qx, qy, qz, gm[None, :], hq, soft)[0]
        phi[top_idx] = torch.where(is_heavy, phi_h, phi[top_idx])
    return acc, phi


def acc_fmm(qx, qy, qz, gm, soft, *, m: int = 12, levels: int = 2,
            heavy_k: int = HEAVY_K, heavy_factor: float = HEAVY_FACTOR,
            m2l_dots: str = "fp32", block: int = 0, m2l_tile: int = 0,
            near: str = "interp", p2p_pmax: int = 0,
            p2p_chunk: int = 0) -> Accel:
    """All-pairs softened-gravity accelerations via the L-level hierarchy
    (ref: murb_tpu/ops/fmm.py:acc_fmm).  Heavy bodies are excluded from the
    far field and corrected exactly, as sources and as targets.
    ``near="p2p"`` sums the finest near neighbourhood exactly (ops/p2p.py,
    capacity ``p2p_pmax``).  ``m2l_dots``: the level sweeps' tier
    (``level_sweep``).  ``block`` and ``m2l_tile``: the stage geometry
    (``ops/proxy.check_fast_geometry``; 0 the kernels' own picks; the
    plain stages have none)."""
    acc, _ = _fmm_solve(qx, qy, qz, gm, soft, m=m, levels=levels,
                        heavy_k=heavy_k, heavy_factor=heavy_factor,
                        m2l_dots=m2l_dots, with_phi=False, block=block,
                        m2l_tile=m2l_tile, near=near, p2p_pmax=p2p_pmax,
                        p2p_chunk=p2p_chunk)
    return Accel(acc[:, 0], acc[:, 1], acc[:, 2])


def force_and_potential_fmm(qx, qy, qz, gm, soft, *, m: int = 12,
                            levels: int = 2, heavy_k: int = HEAVY_K,
                            heavy_factor: float = HEAVY_FACTOR,
                            m2l_dots: str = "fp32", block: int = 0,
                            m2l_tile: int = 0, near: str = "interp",
                            p2p_pmax: int = 0, p2p_chunk: int = 0):
    """(Accel, phi (n,)): forces and the potential in one hierarchy pass,
    the potential riding the level sweeps as a fourth node field (K7 with
    nf = 4, K9 with 4 fields).  phi includes the (interpolated) self term,
    as the reference's tile sweep does (callers subtract G m_i / eps, ref:
    SimulationNBodyCUDAPropertyTracking.cu:296-302).  ``block`` and
    ``m2l_tile``: as ``acc_fmm``'s."""
    acc, phi = _fmm_solve(qx, qy, qz, gm, soft, m=m, levels=levels,
                          heavy_k=heavy_k, heavy_factor=heavy_factor,
                          m2l_dots=m2l_dots, with_phi=True, block=block,
                          m2l_tile=m2l_tile, near=near, p2p_pmax=p2p_pmax,
                          p2p_chunk=p2p_chunk)
    return Accel(acc[:, 0], acc[:, 1], acc[:, 2]), phi


# --------------------------------------------- per-galaxy potential pass
def m2l_phi_multi(wst, hl, soft, *, m: int, C: int,
                  subset: str = "expand") -> torch.Tensor:
    """(G, C^3, m^3) node potential fields of G weight channels in one
    offset loop: each offset's (m^3, m^3) transfer build is shared by every
    channel, each application is one matmul (murb_tpu/ops/fmm.py:
    m2l_phi_multi, jnp there, ``torch.matmul`` here)."""
    from murb_tpu_torch.ops.fmm_kernels import _node_vectors, _parity_mask

    dtype, dev = wst.dtype, wst.device
    ngal = wst.shape[0]
    m3 = m ** 3
    soft2 = torch.tensor(soft, dtype=dtype) ** 2
    wpad = torch.nn.functional.pad(wst.reshape(ngal, C, C, C, m3),
                                   (0, 0, 3, 3, 3, 3, 3, 3))
    even = (torch.arange(C, device=dev) % 2) == 0
    offsets, neg_valid = _offsets_paired(*_SUBSETS[subset])
    pxv, pyv, pzv = _node_vectors(hl, m, dtype, dev)

    def shifted(o):
        ws = wpad[:, 3 + o[0]:3 + o[0] + C, 3 + o[1]:3 + o[1] + C,
                  3 + o[2]:3 + o[2] + C].reshape(ngal, C ** 3, m3)
        if subset != "near":
            ws = torch.where(_parity_mask(o, even, C)[None], ws, 0.0)
        return ws

    f = torch.zeros((ngal, C ** 3, m3), dtype=dtype, device=dev)
    for o, nv in zip(offsets.tolist(), neg_valid.tolist()):
        if max(map(abs, o)) >= C:
            continue  # both shifts read only zero padding: adds exactly 0
        dx = 2.0 * hl[0] * o[0] + (pxv[None, :] - pxv[:, None])
        dy = 2.0 * hl[1] * o[1] + (pyv[None, :] - pyv[:, None])
        dz = 2.0 * hl[2] * o[2] + (pzv[None, :] - pzv[:, None])
        t = torch.rsqrt(dx * dx + dy * dy + dz * dz + soft2)
        # T_phi(-o) = +T_phi(o)^T: the mirror rides the same build
        f += shifted(o) @ t.T + (shifted([-x for x in o]) * nv) @ t
    return f


def phi_grid_pergal(w_stack, h, soft, *, m: int, levels: int):
    """Finest-level node potential fields (G, C^3, m^3) of G weight channels
    via the full hierarchy: the potential-only, multi-channel twin of
    fmm_field_grid."""
    l0 = min(2, levels)
    ws = {levels: w_stack}
    for l in range(levels - 1, l0 - 1, -1):
        ws[l] = torch.stack([m2m(wg, m=m, C=2 ** (l + 1))
                             for wg in ws[l + 1]])
    f = None
    for l in range(l0, levels + 1):
        C = 2 ** l
        hl = h / C
        if f is not None:
            f = torch.stack([l2l(fg, m=m, C=C // 2) for fg in f])
        contrib = m2l_phi_multi(ws[l], hl, soft, m=m, C=C, subset="expand")
        f = contrib if f is None else f + contrib
        if l < levels:
            f = f - m2l_phi_multi(ws[l], hl, soft, m=m, C=C, subset="near")
    return f


def force_and_potential_fmm_pergal(qx, qy, qz, gm, masks, soft, *,
                                   m: int = 12, levels: int = 2,
                                   heavy_k: int = HEAVY_K,
                                   heavy_factor: float = HEAVY_FACTOR,
                                   m2l_dots: str = "fp32", block: int = 0,
                                   m2l_tile: int = 0):
    """(Accel, phi (G, n)): forces plus one potential per galaxy in one
    hierarchy pass (murb_tpu/ops/fmm.py:force_and_potential_fmm_pergal).
    ``masks`` (G, n): 0/1 galaxy membership rows.  Forces run the ordinary
    hierarchy on the full weights; each galaxy's potential is a masked
    weight channel through K8 -> M2M -> m2l_phi_multi -> L2L, and one grid
    L2P (K9) interpolates the 3 + G fields.  Heavy bodies are corrected per
    galaxy with shared distance builds.  ``m2l_dots`` sets the force
    sweeps' tier; the potential channels run fp32, as murb_tpu's.
    ``block`` and ``m2l_tile``: as ``acc_fmm``'s (the potential channels'
    sweeps are plain torch, with no items)."""
    _check_modes(m2l_dots, "interp")
    check_fast_geometry(m, levels, 1, block, m2l_tile)
    C = 2 ** levels
    c, h, hq, heavy_gm, is_heavy, top_idx, gm_eff = _heavy_setup(
        qx, qy, qz, gm, heavy_k, heavy_factor)
    order = (cell_order(qx, qy, qz, c, h, C) if qx.device.type == "cuda"
             else None)

    def p2m_one(g):
        return p2m_grid_fused(qx, qy, qz, g, c, h, m=m, C=C, order=order,
                              chunk=block)

    w = p2m_one(gm_eff)
    wg = torch.stack([p2m_one(gm_eff * mk) for mk in masks])
    fields = fmm_field_grid(w, h, soft, m=m, levels=levels,
                            m2l_dots=m2l_dots, m2l_tile=m2l_tile)
    phi_fields = phi_grid_pergal(wg, h, soft, m=m, levels=levels)
    out = l2p_grid_fused(qx, qy, qz, c, h, tuple(fields) + tuple(phi_fields),
                         m=m, C=C, order=order)
    acc = torch.stack(out[:3], dim=1) + heavy_source_acc(qx, qy, qz, hq,
                                                         heavy_gm, soft)
    hrows = masks[:, top_idx] * heavy_gm[None, :]              # (G, k)
    phi = torch.stack(out[3:]) + heavy_source_phi_rows(qx, qy, qz, hq, hrows,
                                                       soft)
    ht = torch.stack(list(acc_rect(hq[0], hq[1], hq[2], qx, qy, qz, gm,
                                   soft)), dim=1)
    acc[top_idx] = torch.where(is_heavy[:, None], ht, acc[top_idx])
    phi_h = heavy_target_phi_rows(qx, qy, qz, masks * gm[None, :], hq, soft)
    phi[:, top_idx] = torch.where(is_heavy[None, :], phi_h, phi[:, top_idx])
    return Accel(acc[:, 0], acc[:, 1], acc[:, 2]), phi
