"""shard+adaptive: the adaptive sparse hierarchy over the mesh.

Port of ``murb_tpu/parallel/shard_adaptive.py``.  Bodies are sorted by
their finest-level Morton key at build and block-split over the mesh, so
each shard owns a contiguous key range (``bounds``) at a box frozen into
the plan; leaving that box is a health event that triggers a re-plan.

  * Far field, communication independent of N: every shard builds its
    local occupied-cell list and windowed P2M expansions (K11); one
    ``all_gather`` of the lists gives every shard the same global list;
    one ``psum`` of the finest (cap + 1, m^3) tensor merges the
    multipoles; the rest of the hierarchy (``hierarchy_fields``: M2M, the
    dense base with K7, M2L, L2L) runs on every device of the mesh (once a
    device: its inputs are the same on every shard); L2P (K12) is
    local.
  * Near field, communication scaled by the surface: each shard exports
    the bodies whose cell's 27-neighbourhood leaves its range, and the
    strays whose own cell left it; one ``all_gather`` builds a halo pool;
    each shard Morton-sorts its residents with the pool and runs the exact
    P2P sweep (K10).  Stray targets get exact rows: every shard sums
    [global strays] x [its residents] masked to cell adjacency, and one
    ``psum`` completes them.

``plan_shard_adaptive`` is murb_tpu's numpy planner, copied, so the plan
and the permutation equal murb_tpu's; its pair capacity is ``size_pmax``'s
(K10 walks the candidate list as the plain sweep does, ops/p2p_kernels.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from murb_tpu_torch import G
from murb_tpu_torch.core.integrators import euler_update
from murb_tpu_torch.ops.anterp_kernels import l2p_window, p2m_window
from murb_tpu_torch.ops.common import Accel, bf16_chain
from murb_tpu_torch.ops.naive import acc_rect
from murb_tpu_torch.ops.p2p import (DEFAULT_K, _SENTINEL_SHIFT, _cell_ixyz,
                                    _morton_np, morton_key, size_pmax)
from murb_tpu_torch.ops.p2p_kernels import p2p_sweep_kernel_sorted
from murb_tpu_torch.ops.proxy import heavy_source_acc, heavy_split
from murb_tpu_torch.ops.sparse_fmm import (_BIG, SparsePlan,
                                           _occupied_and_slots, _slot,
                                           hierarchy_fields, m2l_schedule)

_OFFS27 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]

#: stray rows a pass of the exact stray-row sweep takes (bounds its
#: (rows, n_local) intermediates)
_STRAY_ROWS = 64


class ShardAdaptivePlan(NamedTuple):
    """Geometry and capacities of one sharded adaptive solve (murb_tpu's,
    field for field).  ``base.cell_caps`` are global per-level capacities;
    ``base.p2p_pmax`` is unused (``concat_pmax`` sizes each shard's
    sweep)."""

    base: SparsePlan
    #: frozen isotropic box (centre, half-width)
    c: tuple
    h: float
    #: (D + 1,) Morton-key bounds; shard d owns [bounds[d], bounds[d + 1])
    bounds: tuple
    #: finest occupied-cell capacity of one shard's local list
    local_cap: int
    #: halo-export rows a shard (boundary + strays), 256-aligned
    export_cap: int
    #: stray rows a shard (the exact-row set)
    stray_cap: int
    #: brick-pair capacity of a shard's [residents ++ pool] sweep
    concat_pmax: int


# --------------------------------------------------------------- planner
def _cells_np(q: np.ndarray, c: np.ndarray, h: float, C: int):
    """Host replica of the device cell mapping at the frozen box, in
    float32 as the device computes it."""
    q = np.asarray(q, np.float32)
    lo = (c - h).astype(np.float32)
    cs = np.float32(2.0 * h / C)
    u = (q - lo) / cs
    return np.clip(np.floor(u), 0, C - 1).astype(np.int64)


def _count_pairs_np(ci_act: np.ndarray, nconc: int, C: int,
                    K: int = DEFAULT_K) -> int:
    """Brick pairs of one shard's concat sweep: active cells Morton-sorted,
    inactive rows as trailing sentinel bricks."""
    order = np.argsort(
        _morton_np(ci_act[:, 0], ci_act[:, 1], ci_act[:, 2], C),
        kind="stable")
    ci = ci_act[order]
    sent = 2 * C + _SENTINEL_SHIFT
    pad = np.full((nconc - len(ci), 3), sent, dtype=np.int64)
    ci = np.concatenate([ci, pad], 0)
    B = nconc // K
    cb = ci.reshape(B, K, 3)
    blo, bhi = cb.min(1), cb.max(1)
    a = blo[None, :, :] <= bhi[:, None, :] + 1
    b = blo[:, None, :] <= bhi[None, :, :] + 1
    return int(np.sum(np.all(a & b, axis=-1)))


def _boundary_mask_np(ci: np.ndarray, lo_k: int, hi_k: int,
                      C: int) -> np.ndarray:
    """Bodies whose cell's 27-neighbourhood (in-grid part) leaves [lo_k,
    hi_k): the host replica of the device export rule."""
    out = np.zeros(len(ci), bool)
    for o in _OFFS27:
        nc = ci + np.asarray(o)[None, :]
        valid = np.all((nc >= 0) & (nc < C), axis=1)
        nk = _morton_np(nc[:, 0].clip(0, C - 1), nc[:, 1].clip(0, C - 1),
                        nc[:, 2].clip(0, C - 1), C)
        out |= valid & ((nk < lo_k) | (nk >= hi_k))
    return out


def _align(x: int, a: int) -> int:
    return max(-(-int(x) // a) * a, a)


def plan_shard_adaptive(q: np.ndarray, npad: int, shards: int, m: int,
                        dense_levels: int = 0, levels: int = 0, *,
                        active: np.ndarray | None = None,
                        box_margin: float = 1.25, cell_margin: float = 1.3,
                        halo_margin: float = 1.5, p2p_margin: float = 1.5,
                        m2l_rank: int = -1, device="cuda"):
    """(plan, perm): capacities and ranges from the current distribution,
    and the (npad,) Morton permutation the engine applies to its bodies
    so that residence matches the ranges (murb_tpu's planner; ``device``
    picks the P2P sweep the plan names and the cost rates, as
    ``best_adaptive_plan`` does).

    ``q``: (n, 3) positions of the first n padded rows; ``active`` masks
    the rows with mass (default all).  ``npad`` must be a multiple of 256 *
    shards.  Counting groups bodies by block residence (sorted position //
    nloc), which is what each shard holds."""
    from murb_tpu_torch.ops.sparse_fmm import _impl, best_adaptive_plan

    assert npad % (256 * shards) == 0, (npad, shards)
    q = np.asarray(q, np.float32)
    n = len(q)
    if active is None:
        active = np.ones(n, bool)
    active = np.asarray(active, bool)
    q_act = q[active]
    if not (dense_levels and levels):
        picked, _ = best_adaptive_plan(q_act, npad, m, m2l_rank=m2l_rank,
                                       device=device)
        dense_levels, levels = picked.dense_levels, picked.levels
    C = 2 ** levels

    lo, hi = q_act.min(0), q_act.max(0)
    c = (np.float32(0.5) * (lo + hi)).astype(np.float32)
    h = float(max(np.float32(0.5) * (hi - lo).max(), np.float32(1.0))
              * np.float32(box_margin))

    ci_all = _cells_np(q, c, h, C)
    key = _morton_np(ci_all[:, 0], ci_all[:, 1], ci_all[:, 2], C)
    key[~active] = np.int64(_BIG)

    # Morton sort of the padded index space, ghosts and inactive rows last;
    # stable, so equal keys keep input order
    key_pad = np.full(npad, np.int64(_BIG))
    key_pad[:n] = key
    perm = np.argsort(key_pad, kind="stable")
    key_sorted = key_pad[perm]

    # cell-aligned equal-count split: each boundary moves past the cut
    # cell, so at most that cell's tail rows are strays at t=0
    nloc = npad // shards
    bounds = [0]
    for d in range(1, shards):
        i = d * nloc
        while i < npad and key_sorted[i] == key_sorted[i - 1]:
            i += 1
        k = int(key_sorted[min(i, npad - 1)])
        bounds.append(max(k, bounds[-1]) if i < npad else int(_BIG))
    bounds.append(int(_BIG))

    pos = np.empty(npad, np.int64)
    pos[perm] = np.arange(npad)
    blk = (pos[:n] // nloc)[active]
    key_act = key[active]
    ci = ci_all[active]
    owner = np.searchsorted(np.asarray(bounds[1:-1]), key_act, side="right")

    loc_cells = max((len(np.unique(key_act[blk == d]))
                     for d in range(shards)), default=1)
    local_cap = int(loc_cells * cell_margin) + 9

    caps = []
    kk = key_act.copy()
    for _ in range(levels, dense_levels, -1):
        caps.append(int(len(np.unique(kk)) * cell_margin) + 9)
        kk = kk >> 3
    cell_caps = tuple(reversed(caps))

    stray0 = [int(np.sum((blk == d) & (owner != d))) for d in range(shards)]
    exp_masks, exp_counts = [], []
    for d in range(shards):
        sel = blk == d
        if not sel.any():
            exp_masks.append(np.zeros(0, bool))
            exp_counts.append(0)
            continue
        b = (_boundary_mask_np(ci[sel], bounds[d], bounds[d + 1], C)
             | (owner[sel] != d))
        exp_masks.append(b)
        exp_counts.append(int(b.sum()))
    export_cap = _align(int(max(exp_counts) * halo_margin) + 32, 256)
    stray_cap = _align(max(64, 2 * max(stray0) + max(64, n // 2000)), 64)

    worst = 0
    nconc = _align(nloc + shards * export_cap, 256)
    for d in range(shards):
        parts = [ci[blk == d]]
        parts += [ci[blk == e][exp_masks[e]]
                  for e in range(shards) if e != d]
        worst = max(worst, _count_pairs_np(np.concatenate(parts, 0), nconc,
                                           C))
    concat_pmax = size_pmax(worst, margin=p2p_margin)

    base = SparsePlan(m=m, dense_levels=dense_levels, levels=levels,
                      cell_caps=cell_caps, p2p_pmax=concat_pmax,
                      p2p_impl=_impl(device), m2l_rank=m2l_rank)
    plan = ShardAdaptivePlan(base=base, c=tuple(float(x) for x in c), h=h,
                             bounds=tuple(bounds), local_cap=local_cap,
                             export_cap=export_cap, stray_cap=stray_cap,
                             concat_pmax=concat_pmax)
    return plan, perm


# ------------------------------------------------------------ device step
def _compact(flag, arrays, cap: int, fill_value):
    """The rows where ``flag`` holds, gathered into (cap,) buffers (rows past
    the count get ``fill_value``, past the capacity are dropped).  Returns
    (bufs, idx (cap,) with 0 on unused rows, valid (cap,)).  No host sync:
    each flagged row's rank places it."""
    n = flag.shape[0]
    rank = torch.cumsum(flag, 0) - 1
    tgt = torch.where(flag & (rank < cap), rank, cap)
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=flag.device)
    idx[tgt] = torch.arange(n, device=flag.device)
    valid = torch.arange(cap, device=flag.device) < flag.sum()
    idx = torch.where(valid, idx[:cap], 0)
    bufs = tuple(torch.where(valid, a[idx], fv)
                 for a, fv in zip(arrays, fill_value))
    return bufs, idx, valid


def _box(plan: ShardAdaptivePlan, dtype, device):
    c = torch.tensor(plan.c, dtype=dtype, device=device)
    return c, torch.full((3,), plan.h, dtype=dtype, device=device)


def _ranges(plan, me: int) -> tuple[int, int]:
    return plan.bounds[me], plan.bounds[me + 1]


def _export_flags(cx, cy, cz, key, active, lo_k, hi_k, C):
    """(stray, export): active rows whose own key left [lo_k, hi_k), and
    those plus the rows whose cell's 27-neighbourhood (in-grid part) leaves
    it."""
    stray = active & ((key < lo_k) | (key >= hi_k))
    out_any = torch.zeros_like(stray)
    for dx, dy, dz in _OFFS27:
        nx, ny, nz = cx + dx, cy + dy, cz + dz
        valid = ((nx >= 0) & (nx < C) & (ny >= 0) & (ny < C)
                 & (nz >= 0) & (nz < C))
        nk = morton_key(nx.clamp(0, C - 1), ny.clamp(0, C - 1),
                        nz.clamp(0, C - 1), C)
        out_any |= valid & ((nk < lo_k) | (nk >= hi_k))
    return stray, active & (out_any | stray)


@bf16_chain
def _stray_rows(sg, cs, q, ci, active, gm_eff, soft):
    """(R, 3) exact near rows of the stray targets ``sg`` (3 x (R,), cells
    ``cs``) from this shard's residents within cell distance 1, in passes
    of _STRAY_ROWS rows."""
    soft2 = torch.tensor(soft, dtype=q[0].dtype) ** 2
    out = []
    for r0 in range(0, sg[0].shape[0], _STRAY_ROWS):
        sl = slice(r0, r0 + _STRAY_ROWS)
        adj = active[None, :]
        for s, c in zip(cs, ci):
            adj = adj & ((s[sl][:, None] - c[None, :]).abs() <= 1)
        d = [qq[None, :] - s[sl][:, None] for qq, s in zip(q, sg)]
        inv = torch.rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + soft2)
        w = torch.where(adj, gm_eff[None, :], 0.0) * (inv * inv * inv)
        out.append(torch.stack([(w * dd).sum(1) for dd in d], 1))
    return torch.cat(out)


def make_local_step(plan: ShardAdaptivePlan, soft, dt, mesh, *,
                    heavy_k: int = 1, heavy_factor: float = 64.0,
                    m2l_dots: str = "fp32", integrate: bool = True):
    """The step over the mesh's blocks (murb_tpu's per-shard step body, each
    stage run for every shard, the collectives between): the adaptive far
    field with psum'd multipoles, the halo-pool P2P, the stray rows, the
    heavy corrections, the local Euler update.  Returns (blocks', accels);
    with ``integrate=False`` the blocks come back unchanged.  The sparse
    M2L's schedule (MURB_M2L_SCAN_CHUNK, MURB_M2L_FUSED) is read here, once
    (ops/sparse_fmm.m2l_schedule)."""
    base = plan.base
    m = base.m
    m3 = m ** 3
    Cfin = 2 ** base.levels
    capG, capL = base.cell_caps[-1], plan.local_cap
    Hcap, Scap = plan.export_cap, plan.stray_cap
    sent_i = 2 * Cfin + _SENTINEL_SHIFT
    kh = max(heavy_k, 1)
    schedule = m2l_schedule()

    def step(blocks):
        D = mesh.size
        dtype = blocks[0].dtype
        sh = []
        for k, b in enumerate(blocks):
            c, h = _box(plan, dtype, b.device)
            gm_l = b.m * torch.tensor(G, dtype=dtype).item()
            sh.append(dict(me=mesh.axis_index(k), c=c, h=h, gm=gm_l,
                           q=(b.qx, b.qy, b.qz), nloc=b.qx.shape[0]))

        # a heavy split consistent over the mesh (the proxy/fmm pattern)
        s_gm = mesh.psum([s["gm"].sum() for s in sh])
        s_cnt = mesh.psum([(s["gm"] > 0).sum().to(dtype) for s in sh])
        for s, a, n_ in zip(sh, s_gm, s_cnt):
            s["split"] = heavy_split(*s["q"], s["gm"], kh, heavy_factor,
                                     a / n_.clamp(min=1.0))
            s["gm_eff"] = s["split"][4]
        hq_g = [mesh.all_gather([s["split"][0][c] for s in sh])
                for c in range(3)]
        hgm_g = mesh.all_gather([s["split"][1] for s in sh])

        # ---- local Morton sort at the frozen box; far field
        for s in sh:
            s["ci"] = _cell_ixyz(*s["q"], s["c"], s["h"], Cfin)
            s["active"] = s["gm_eff"] > 0
            s["key"] = torch.where(s["active"], morton_key(*s["ci"], Cfin),
                                   _BIG)
            s["key_s"], s["perm"] = torch.sort(s["key"], stable=True)
            s["sorted"] = tuple(v[s["perm"]] for v in (*s["q"], s["gm_eff"]))
            s["cells_loc"], s["slots"] = _occupied_and_slots(s["key_s"], capL)
        flat = mesh.all_gather([s["cells_loc"] for s in sh])
        w_parts = []
        for s, fl in zip(sh, flat):
            s["cells_glob"], _ = _occupied_and_slots(torch.sort(fl).values,
                                                     capG)
            s["gslot"] = _slot(s["cells_glob"], s["cells_loc"], Cfin)
            xs, ys, zs, gs = s["sorted"]
            w_loc = p2m_window(xs, ys, zs, gs, s["c"], s["h"], s["slots"],
                               capL, m=m, C=Cfin)
            w_parts.append(torch.zeros((capG + 1, m3), dtype=w_loc.dtype,
                                       device=xs.device).index_add_(
                0, s["gslot"].long(), w_loc[:capL]))
        w_glob = mesh.psum(w_parts)
        fields = {}       # the redundant sweep, once a device
        for s, wg in zip(sh, w_glob):
            if wg.device not in fields:
                fields[wg.device] = hierarchy_fields(
                    wg, s["cells_glob"], s["c"], s["h"], soft, base,
                    with_phi=False, m2l_dots=m2l_dots, **schedule)[0]
            f = fields[wg.device]
            zrow = torch.zeros((1, m3), dtype=f[0].dtype, device=wg.device)
            f_loc = tuple(torch.cat([fi[s["gslot"].clamp(max=capG).long()],
                                     zrow]) for fi in f)
            xs, ys, zs, _ = s["sorted"]
            vals = l2p_window(xs, ys, zs, s["c"], s["h"], s["slots"], f_loc,
                              m=m, C=Cfin)
            s["far"] = []
            for v in vals:
                out = torch.zeros(s["nloc"], dtype=dtype, device=v.device)
                out[s["perm"]] = v
                s["far"].append(out)

        # ---- near field: the halo pool
        for s in sh:
            lo_k, hi_k = _ranges(plan, s["me"])
            s["stray"], export = _export_flags(*s["ci"], s["key"],
                                               s["active"], lo_k, hi_k, Cfin)
            zero = torch.zeros((), dtype=dtype, device=s["c"].device)
            (ex_x, ex_y, ex_z, ex_g), _, _ = _compact(
                export, (*s["q"], s["gm_eff"]), Hcap,
                (s["c"][0], s["c"][1], s["c"][2], zero))
            s["export"] = torch.stack([ex_x, ex_y, ex_z, ex_g],
                                      1).reshape(1, Hcap, 4)
        pools = mesh.all_gather([s["export"] for s in sh])   # (D, Hcap, 4)
        for s, pool in zip(sh, pools):
            dev = pool.device
            not_me = (torch.arange(D, device=dev) != s["me"])[:, None]
            pool_g = torch.where(not_me, pool[:, :, 3], 0.0).reshape(-1)
            qc = [torch.cat([s["q"][c], pool[:, :, c].reshape(-1)])
                  for c in range(3)]
            gmc = torch.cat([s["gm_eff"], pool_g])
            nconc = qc[0].shape[0]
            cc = _cell_ixyz(*qc, s["c"], s["h"], Cfin)
            activec = gmc > 0
            keyc = torch.where(activec, morton_key(*cc, Cfin), _BIG)
            _, permc = torch.sort(keyc, stable=True)
            cic = tuple(torch.where(activec, v, sent_i)[permc] for v in cc)
            xc, yc, zc, gc = (v[permc] for v in (*qc, gmc))
            parts, _ = p2p_sweep_kernel_sorted(
                xc, yc, zc, gc, cic, soft, pmax=plan.concat_pmax,
                chunk=base.p2p_chunk, with_phi=False)
            s["near"] = []
            for p in parts:
                out = torch.zeros(nconc, dtype=dtype, device=dev)
                out[permc] = p.reshape(nconc)
                s["near"].append(out[:s["nloc"]])

        # ---- stray targets: exact psum'd rows (their interior-range
        # sources are not in the pool)
        for s in sh:
            st, s["st_idx"], s["st_valid"] = _compact(
                s["stray"], s["q"], Scap, tuple(s["c"][c] for c in range(3)))
            s["st_pack"] = torch.stack(st, 1)
        packs = mesh.all_gather([s["st_pack"] for s in sh])   # (D*Scap, 3)
        srow_parts = []
        for s, pk in zip(sh, packs):
            sg = (pk[:, 0], pk[:, 1], pk[:, 2])
            scs = _cell_ixyz(*sg, s["c"], s["h"], Cfin)
            srow_parts.append(_stray_rows(sg, scs, s["q"], s["ci"],
                                          s["active"], s["gm_eff"], soft))
        srows = mesh.psum(srow_parts)
        for s, sr in zip(sh, srows):
            mine = sr[s["me"] * Scap:(s["me"] + 1) * Scap]
            # only the valid rows are written: unused rows point at row 0
            tgt = torch.where(s["st_valid"], s["st_idx"], s["nloc"])
            for c in range(3):
                ext = torch.cat([s["near"][c], s["near"][c][:1]])
                ext[tgt] = mine[:, c]
                s["near"][c] = ext[:s["nloc"]]

        # ---- combine, heavy corrections
        ht = mesh.psum([torch.stack(list(acc_rect(
            hq_g[0][k], hq_g[1][k], hq_g[2][k], *s["q"], s["gm"], soft)), 1)
            for k, s in enumerate(sh)])
        accs = []
        for k, s in enumerate(sh):
            acc = torch.stack([s["far"][c] + s["near"][c] for c in range(3)],
                              1)
            acc = acc + heavy_source_acc(
                *s["q"], (hq_g[0][k], hq_g[1][k], hq_g[2][k]), hgm_g[k], soft)
            mine = ht[k][s["me"] * kh:(s["me"] + 1) * kh]
            _, _, is_heavy, top_idx, _ = s["split"]
            acc[top_idx] = torch.where(is_heavy[:, None], mine, acc[top_idx])
            accs.append(Accel(acc[:, 0], acc[:, 1], acc[:, 2]))
        if not integrate:
            return blocks, accs
        return [euler_update(b, a, dt) for b, a in zip(blocks, accs)], accs

    return step


def health_counts(plan: ShardAdaptivePlan, mesh, blocks) -> tuple:
    """Capacity counters over the mesh, as host ints: (strays, exports,
    local occupied cells, global occupied cells, out-of-box bodies), each
    the largest over the shards (murb_tpu's make_health_fn)."""
    C = 2 ** plan.base.levels
    per, cells = [], []
    for k, b in enumerate(blocks):
        c, h = _box(plan, b.dtype, b.device)
        gm = b.m * torch.tensor(G, dtype=b.dtype).item()
        active = gm > 0
        ci = _cell_ixyz(b.qx, b.qy, b.qz, c, h, C)
        key = torch.where(active, morton_key(*ci, C), _BIG)
        lo_k, hi_k = _ranges(plan, mesh.axis_index(k))
        stray, export = _export_flags(*ci, key, active, lo_k, hi_k, C)
        lo_b, hi_b = c - h, c + h
        out_box = active & ((b.qx < lo_b[0]) | (b.qx > hi_b[0])
                            | (b.qy < lo_b[1]) | (b.qy > hi_b[1])
                            | (b.qz < lo_b[2]) | (b.qz > hi_b[2]))
        key_s = torch.sort(key).values
        first = torch.ones_like(key_s, dtype=torch.bool)
        first[1:] = key_s[1:] != key_s[:-1]
        n_loc = (first & (key_s != _BIG)).sum()
        cells.append(_occupied_and_slots(key_s, plan.local_cap)[0])
        per.append(torch.stack([stray.sum(), export.sum(), n_loc,
                                out_box.sum()]).to(torch.int64))
    flat = torch.sort(mesh.all_gather(cells)[0]).values
    firstg = torch.ones_like(flat, dtype=torch.bool)
    firstg[1:] = flat[1:] != flat[:-1]
    n_glob = int((firstg & (flat != _BIG)).sum())
    mx = [int(v) for v in mesh.pmax(per)[0]]
    return mx[0], mx[1], mx[2], n_glob, mx[3]


def health_check(plan: ShardAdaptivePlan, counts: tuple) -> dict:
    """The plan's health from ``health_counts``: ok while every planned
    capacity still covers the distribution and no body left the box."""
    n_stray, n_export, n_loc, n_glob, n_outbox = (int(x) for x in counts)
    ok = (n_stray <= plan.stray_cap
          and n_export <= plan.export_cap
          and n_loc <= plan.local_cap
          and n_glob <= plan.base.cell_caps[-1]
          and n_outbox == 0)
    return {
        "using_adaptive": True,
        "ok": ok,
        "strays": n_stray, "stray_cap": plan.stray_cap,
        "exports": n_export, "export_cap": plan.export_cap,
        "local_cells": n_loc, "local_cap": plan.local_cap,
        "global_cells": n_glob, "global_cap": plan.base.cell_caps[-1],
        "out_of_box": n_outbox,
        "m": plan.base.m,
        "levels": plan.base.levels,
    }
