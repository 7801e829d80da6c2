"""Chebyshev proxy (single-level black-box FMM) accelerations: O(N*m^3).

Port of ``murb_tpu/ops/proxy.py`` (the single-cell force path).  The
Plummer-softened kernel has no singularity -- its smoothness scale is the
softening eps -- so one global Chebyshev expansion with m nodes per
dimension replaces the O(N^2) sum:

  P2M:  W_uvw = sum_j gm_j Sx_j,u Sy_j,v Sz_j,w        (kernel K1)
  M2L:  F = exact all-pairs sweep over the m^3 nodes   (plain below 8000
                                                        nodes, K3 above)
  L2P:  a_i = sum_uvw S_i,uvw F_uvw                     (kernel K2)

Bodies heavier than ``HEAVY_FACTOR`` times the mean mass (a top-``HEAVY_K``
selection: the galaxy's central body) are left out of the expansion and
summed exactly, as sources and as targets.

The tracking engines take the potential phi_i = sum_j Gm_j rsqrt(d^2 +
eps^2) (self term included) from the same pass: one P2M per weight set,
one node sweep for the force and the potential fields, and one L2P of 3 + R
fields (``force_and_potential_proxy``, and ``..._pergal`` with one masked
weight set per galaxy).

``cells=2`` splits the box into its 2x2x2 octants: the octant grid is the
C=2 cell grid of the hierarchy, so one grid P2M (K8) builds the eight
per-octant expansions, one exact sweep joins their nodes, and one grid L2P
(K9) reads each body's own octant.

Every stage stays on the device: the box center and half-widths are device
tensors the kernels read, and no step calls ``.item()``.
"""
from __future__ import annotations

import math

import torch

from murb_tpu_torch.core.state import in_dtype
from murb_tpu_torch.ops.common import Accel, bf16_chain
from murb_tpu_torch.ops.fmm_kernels import l2p_grid_fused, p2m_grid_fused
from murb_tpu_torch.ops.naive import acc_rect, soft_squared
from murb_tpu_torch.ops.proxy_kernels import (bases, l2p, l2p_fused,
                                              l2p_fused_multi, p2m,
                                              p2m_fused)
from murb_tpu_torch.ops.tile import acc_tile_rect, acc_tile_rect_plain

# Bodies heavier than this multiple of the mean mass are excluded from the
# proxy and summed exactly (the near-field list); at most HEAVY_K of them,
# the heaviest (murb_tpu's defaults).
HEAVY_FACTOR = 100.0
HEAVY_K = 1

#: node count from which the node sweep runs the K3 kernel instead of the
#: plain P^2 broadcast (murb_tpu/ops/proxy.py:175-191)
NODE_SWEEP_KERNEL_MIN = 8000


def required_order(halfwidth: float, soft: float, tol: float = 1e-4,
                   margin: int = 2) -> int:
    """Chebyshev order per dimension for a target interpolation error."""
    a = max(soft / max(halfwidth, 1e-30), 1e-6)
    rho = a + math.sqrt(1.0 + a * a)
    return max(int(math.ceil(-math.log(tol) / math.log(rho))) + margin, 4)


def half_extent(unpadded: dict) -> float:
    """Largest per-dimension half-extent of the massive bodies, from a
    host-side ``BodyState.unpadded()`` dict."""
    sel = unpadded["m"] > 0
    if not sel.any():
        return 1.0
    return max(
        (unpadded[k][sel].max() - unpadded[k][sel].min()) / 2.0
        for k in ("qx", "qy", "qz")
    )


def _cheb_nodes(m: int, dtype, device) -> torch.Tensor:
    """First-kind nodes cos(pi (k + 1/2) / m) in (-1, 1), made on device."""
    k = torch.arange(m, dtype=torch.float64, device=device)
    return torch.cos(math.pi * (k + 0.5) / m).to(dtype)


# ---------------------------------------------------------------- stages
def bounding_box(qx, qy, qz, gm_pos):
    """(center (3,), per-dimension half-widths (3,)) over massive bodies,
    as device tensors."""
    # murb_tpu's 3.4e38 in the state dtype: inf in bf16 (a Python float
    # past bf16's range would not convert on the card)
    big = in_dtype(3.4e38, qx.dtype)
    lo = torch.stack([torch.where(gm_pos, q, big).min() for q in (qx, qy, qz)])
    hi = torch.stack([torch.where(gm_pos, q, -big).max()
                      for q in (qx, qy, qz)])
    c = 0.5 * (lo + hi)
    h = (0.5 * (hi - lo)).clamp(min=1.0)
    return c, h


def proxy_nodes(c, h, m: int, dtype):
    """Flat (m^3,) coordinates of the proxy nodes, x-major, in ``dtype``
    (bf16: c + h t formed in float32 and rounded once, ``bf16_chain``'s
    rule)."""
    ct = torch.promote_types(dtype, torch.float32)
    t = _cheb_nodes(m, ct, c.device)
    c, h = c.to(ct), h.to(ct)
    px = (c[0] + h[0] * t).to(dtype)[:, None, None].expand(m, m, m)
    py = (c[1] + h[1] * t).to(dtype)[None, :, None].expand(m, m, m)
    pz = (c[2] + h[2] * t).to(dtype)[None, None, :].expand(m, m, m)
    return px.reshape(-1), py.reshape(-1), pz.reshape(-1)


def node_sweep(px, py, pz, w, soft, *, fused: bool = True) -> Accel:
    """Exact all-pairs accelerations over proxy nodes with weights ``w``:
    the plain broadcast below 8000 nodes, the exact fp32 sweep K3 at 8000
    or more (Chebyshev weights oscillate with heavy cancellation, so this
    sweep stays exact fp32, murb_tpu/ops/proxy.py:180-184), or with
    ``fused=False`` K3's plain version, j-chunked, on any device."""
    if px.shape[0] < NODE_SWEEP_KERNEL_MIN:
        return acc_rect(px, py, pz, px, py, pz, w, soft)
    sweep = acc_tile_rect if fused else acc_tile_rect_plain
    return sweep(px, py, pz, px, py, pz, w, soft)


def m2l(c, h, w, soft, m: int, dtype, *, fused: bool = True) -> Accel:
    """Exact sweep over the m^3 proxy nodes."""
    px, py, pz = proxy_nodes(c, h, m, dtype)
    return node_sweep(px, py, pz, w, soft, fused=fused)


def heavy_split(qx, qy, qz, gm, k: int, heavy_factor: float, mean_gm):
    """Top-k heavy-source selection.

    Returns (heavy positions (k,) x3, heavy gm (k,), slot mask (k,),
    top indices (k,), gm with the heavy bodies zeroed)."""
    top_gm, top_idx = torch.topk(gm, k)
    is_heavy = top_gm > heavy_factor * mean_gm
    heavy_gm = torch.where(is_heavy, top_gm, torch.zeros_like(top_gm))
    heavy_mask = torch.zeros_like(gm).index_add(0, top_idx,
                                                is_heavy.to(gm.dtype))
    return ((qx[top_idx], qy[top_idx], qz[top_idx]), heavy_gm, is_heavy,
            top_idx, gm * (1.0 - heavy_mask))


def heavy_source_acc(qx, qy, qz, hq, heavy_gm, soft) -> torch.Tensor:
    """Exact N x k sweep: force contribution of the heavy sources, (n, 3)."""
    a = acc_rect(qx, qy, qz, hq[0], hq[1], hq[2], heavy_gm, soft)
    return torch.stack(list(a), dim=1)


def acc_proxy(qx, qy, qz, gm, soft, *, m: int = 16, cells: int = 1,
              fused: bool = True, heavy_k: int = HEAVY_K) -> Accel:
    """All-pairs softened-gravity accelerations via the Chebyshev proxy
    (ref: murb_tpu/ops/proxy.py:acc_proxy): one global expansion
    (``cells=1``) or one per octant (``cells=2``).

    ``fused=False`` (``cells=1`` only) runs the plain stages on any device,
    ``bases`` -> ``p2m`` -> the node sweep's plain version -> ``l2p``, and
    launches no kernel: the differentiable path of murb_tpu_torch.diff, as
    murb_tpu's ``fused=False`` pins its jnp stages.  ``heavy_k``: how many
    of the heaviest bodies may leave the expansion (at least 1)."""
    if cells not in (1, 2):
        raise ValueError("cells must be 1 or 2")
    if cells == 2 and not fused:
        raise ValueError("acc_proxy: cells=2 has no plain (fused=False) "
                         "path in murb_tpu_torch yet (ROADMAP.md, "
                         "Divergences kept on purpose)")
    gm_pos = gm > 0
    c, h = bounding_box(qx, qy, qz, gm_pos)

    mean_gm = gm.sum() / gm_pos.sum().clamp(min=1)
    hq, heavy_gm, is_heavy, top_idx, gm_eff = heavy_split(
        qx, qy, qz, gm, max(min(heavy_k, qx.shape[0]), 1), HEAVY_FACTOR,
        mean_gm)

    if cells == 2:
        acc = _two_level(qx, qy, qz, gm_eff, c, h, soft, m)
    elif not fused:
        sx, syz = bases(qx, qy, qz, c, h, m)
        f = m2l(c, h, p2m(sx, syz, gm_eff, m), soft, m, qx.dtype,
                fused=False)
        acc = torch.stack(l2p(sx, syz, (f.ax, f.ay, f.az), m), dim=1)
    else:
        w = p2m_fused(qx, qy, qz, gm_eff, c, h, m=m)
        f = m2l(c, h, w, soft, m, qx.dtype)
        acc = l2p_fused(qx, qy, qz, c, h, f.ax, f.ay, f.az, m=m)
    acc = acc + heavy_source_acc(qx, qy, qz, hq, heavy_gm, soft)

    # heavy targets: replace their force with the exact k x N sweep
    ht = torch.stack(list(acc_rect(hq[0], hq[1], hq[2], qx, qy, qz, gm,
                                   soft)), dim=1)
    acc[top_idx] = torch.where(is_heavy[:, None], ht, acc[top_idx])
    return Accel(acc[:, 0], acc[:, 1], acc[:, 2])


def _two_level(qx, qy, qz, gm_eff, c, h, soft, m: int) -> torch.Tensor:
    """Octant decomposition (murb_tpu/ops/proxy.py:_two_level, its fused
    branch): the eight octant expansions from one grid P2M at C=2 (cell id
    (cx*2 + cy)*2 + cz, the x-major octant order), one exact sweep over the
    concatenated octant nodes, one grid L2P -> acc (n, 3)."""
    half = 0.5 * h
    p = m ** 3
    w = p2m_grid_fused(qx, qy, qz, gm_eff, c, h, m=m, C=2)     # (8, m^3)
    nodes = [proxy_nodes(c + torch.tensor([ox, oy, oz], dtype=c.dtype,
                                          device=c.device) * half,
                         half, m, qx.dtype)
             for ox in (-1, 1) for oy in (-1, 1) for oz in (-1, 1)]
    f = node_sweep(*(torch.cat(v) for v in zip(*nodes)), w.reshape(8 * p),
                   soft)
    out = l2p_grid_fused(qx, qy, qz, c, h,
                         tuple(a.reshape(8, p) for a in f), m=m, C=2)
    return torch.stack(out, dim=1)


def validation_ladder(soft, m2l_dots: str = "fp32", heavy_k: int = HEAVY_K):
    """``make_acc_fn(m, levels, cells) -> acc(qx, qy, qz, gm)`` for
    ops/validate.validate_config: the single-level proxy, or the hierarchy
    (``acc_fmm`` at the M2L tier ``m2l_dots``, kernels K7-K9) on a rung
    with levels > 0, as ``tpu+proxy`` and ``--kernel proxy`` / ``fmm``
    validate them, with ``heavy_k`` of the heaviest bodies summed exactly."""
    def make_acc(m, levels, cells):
        if levels:
            from murb_tpu_torch.ops.fmm import acc_fmm

            return lambda qx, qy, qz, g: acc_fmm(qx, qy, qz, g, soft, m=m,
                                                 levels=levels,
                                                 heavy_k=heavy_k,
                                                 m2l_dots=m2l_dots)
        return lambda qx, qy, qz, g: acc_proxy(qx, qy, qz, g, soft, m=m,
                                               cells=cells, heavy_k=heavy_k)

    return make_acc


# --------------------------------------------------- force and potential
def _inv_dist(qxi, qyi, qzi, qxj, qyj, qzj, soft) -> torch.Tensor:
    """rsqrt(|r_j - r_i|^2 + eps^2), (ni, nj) broadcast."""
    dx = qxj[None, :] - qxi[:, None]
    dy = qyj[None, :] - qyi[:, None]
    dz = qzj[None, :] - qzi[:, None]
    return torch.rsqrt(dx * dx + dy * dy + dz * dz
                       + soft_squared(soft, qxi.dtype))


@bf16_chain
def force_and_potential_node_sweep_rows(px, py, pz, w, w_rows, soft):
    """(Accel, phi_rows (R, P)) over the proxy nodes in one broadcast pass:
    the force field of the weights ``w`` and R potential fields of
    ``w_rows`` (R, P) share the distances and the rsqrt.  Callers keep P
    below NODE_SWEEP_KERNEL_MIN."""
    dx = px[None, :] - px[:, None]
    dy = py[None, :] - py[:, None]
    dz = pz[None, :] - pz[:, None]
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + float(soft) ** 2)
    wi3 = w[None, :] * (inv * inv * inv)
    f = Accel((wi3 * dx).sum(1), (wi3 * dy).sum(1), (wi3 * dz).sum(1))
    return f, w_rows @ inv.T


@bf16_chain
def potential_node_sweep(px, py, pz, w, soft) -> torch.Tensor:
    """phi_u = sum_v w_v rsqrt(|p_u - p_v|^2 + eps^2) over the proxy nodes,
    i-chunked (O(2048 P) memory) for grids of NODE_SWEEP_KERNEL_MIN nodes
    or more."""
    return torch.cat([
        (w[None, :] * _inv_dist(px[s:s + 2048], py[s:s + 2048],
                                pz[s:s + 2048], px, py, pz, soft)).sum(1)
        for s in range(0, px.shape[0], 2048)])


@bf16_chain
def heavy_source_phi_rows(qx, qy, qz, hq, heavy_gm_rows, soft):
    """Exact N x k sweep: (R, n) potentials of the heavy sources under R
    rows of heavy masses ``heavy_gm_rows`` (R, k), one distance build."""
    return heavy_gm_rows @ _inv_dist(qx, qy, qz, *hq, soft).T


@bf16_chain
def heavy_target_phi_rows(qx, qy, qz, gm_rows, hq, soft):
    """Exact k x N sweep: (R, k) potentials at the heavy bodies under R
    rows of source masses ``gm_rows`` (R, n)."""
    return gm_rows @ _inv_dist(*hq, qx, qy, qz, soft).T


def _force_and_potential(qx, qy, qz, gm, soft, m: int, masks):
    """One proxy pass for the force of ``gm`` and R potential rows: the
    total (``masks`` None) or one per mask row (``masks`` (G, n)).  Box,
    heavy split and bases are shared; each weight set costs one P2M, and
    the L2P interpolates 3 + R fields in one call."""
    gm_pos = gm > 0
    c, h = bounding_box(qx, qy, qz, gm_pos)
    mean_gm = gm.sum() / gm_pos.sum().clamp(min=1)
    hq, heavy_gm, is_heavy, top_idx, gm_eff = heavy_split(
        qx, qy, qz, gm, min(HEAVY_K, qx.shape[0]), HEAVY_FACTOR, mean_gm)

    w = p2m_fused(qx, qy, qz, gm_eff, c, h, m=m)
    if masks is None:
        wg = w[None, :]
    else:
        wg = torch.stack([p2m_fused(qx, qy, qz, gm_eff * mk, c, h, m=m)
                          for mk in masks])
    px, py, pz = proxy_nodes(c, h, m, qx.dtype)
    if px.shape[0] < NODE_SWEEP_KERNEL_MIN:
        f, phi_nodes = force_and_potential_node_sweep_rows(px, py, pz, w,
                                                           wg, soft)
    else:
        f = node_sweep(px, py, pz, w, soft)
        phi_nodes = [potential_node_sweep(px, py, pz, wr, soft)
                     for wr in wg]
    out = l2p_fused_multi(qx, qy, qz, c, h,
                          (f.ax, f.ay, f.az, *phi_nodes), m=m)
    acc = torch.stack(out[:3], dim=1) + heavy_source_acc(qx, qy, qz, hq,
                                                         heavy_gm, soft)
    hrows = heavy_gm[None, :] if masks is None else \
        masks[:, top_idx] * heavy_gm[None, :]
    phi = torch.stack(out[3:]) + heavy_source_phi_rows(qx, qy, qz, hq,
                                                       hrows, soft)

    # heavy targets exactly
    ht = torch.stack(list(acc_rect(hq[0], hq[1], hq[2], qx, qy, qz, gm,
                                   soft)), dim=1)
    acc[top_idx] = torch.where(is_heavy[:, None], ht, acc[top_idx])
    src = gm[None, :] if masks is None else masks * gm[None, :]
    phi_h = heavy_target_phi_rows(qx, qy, qz, src, hq, soft)
    phi[:, top_idx] = torch.where(is_heavy[None, :], phi_h, phi[:, top_idx])
    return Accel(acc[:, 0], acc[:, 1], acc[:, 2]), phi


def force_and_potential_proxy(qx, qy, qz, gm, soft, *, m: int = 16):
    """(Accel, phi (n,)): forces and the potential sweep in one proxy pass,
    both at the same positions (the reference's metrics-before-update
    order, ref: SimulationNBodyCUDAPropertyTracking.cu:121-133).  K1 runs
    once and K2 interpolates 4 fields."""
    acc, phi = _force_and_potential(qx, qy, qz, gm, soft, m, None)
    return acc, phi[0]


def force_and_potential_proxy_pergal(qx, qy, qz, gm, masks, soft, *,
                                     m: int = 16):
    """(Accel, phi (G, n)): forces plus one potential per galaxy in one
    proxy pass.  ``masks`` (G, n) are 0/1 membership rows; the far field is
    linear in the source masses, so each galaxy adds one P2M of its masked
    weights, one node potential field and one L2P field (3 + G <= 11)."""
    return _force_and_potential(qx, qy, qz, gm, soft, m, masks)


def potential_proxy(qx, qy, qz, gm, soft, *, m: int = 16) -> torch.Tensor:
    """phi_i = sum_j Gm_j rsqrt(|r_ij|^2 + eps^2) via the proxy, self term
    included (the metrics' ``method="proxy"``).  The fused pass's potential:
    the force fields it also interpolates cost three L2P fields."""
    return force_and_potential_proxy(qx, qy, qz, gm, soft, m=m)[1]
