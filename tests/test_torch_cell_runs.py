"""The run kernels' design (csrc/cell_runs.cuh: K8, K9, K11, K12) emulated
on the CPU, and the glue their wrappers hand them.

The kernels run only on the card.  Here an fp32 emulation repeats their
order of sums (each fp32 fma as one rounding of the exact product and sum)
and is held to float64:

  - the bases: T_j(t) once by the recurrence, S_k = 1/m + (2/m) sum_j
    T_j(t) T_j(t_k) against the wrapper's node table (``basis_span``);
  - P2M: work items of ``p2m_chunk`` bodies of one run (``run_items``),
    each summing its bodies in order into every (u, v, w) (a thread's
    tile: p = gm Sx[u] * Sy[v], acc = fma(p, Sz[w], acc)); a run of one
    item keeps its sum, a run of several adds its items' partials (the
    fold launch: in item order, or where runs hold 32 items or more on
    average in 32 lanes of items, each in order, then the lanes in order;
    ``fold_split``), a run of none reads 0;
  - L2P at MW <= 8 (a warp an item): per body t = sum_w F Sz, b = sum_v
    Sy t, a = sum_u Sx b; above it (a block an item) H[(u, v)] = sum_w Sz
    F, each group of 4 pairs' t = sum of 4 Sy H in order, a warp's partial
    a over the chunks of kUC u-rows (its two groups of each chunk in turn),
    and the warps' partials folded in order.

Contracts (chip_smoke.py's, against float64): K8 and K11 1e-5 of max|W|,
K9 and K12 1e-4 of max|a|, at m 6, 8, 18 and 32 and C 2 and 4, with empty
cells, a run of one body, runs of several items and the dump slot.  Two
readings each:

  - the order of sums: the emulation against float64 sums of the same
    fp32 bases, within the limit (P2M up to 1.5e-6 of max|W|, on a run of
    2047 bodies in one item);
  - the whole: against float64, within the limit, or where the fp32
    bases alone miss it (cells of uniform bodies at m >= 18: the plain
    fp32 version reads 1.2e-5 at m = 18, C = 4 and 4.0e-5 at m = 32,
    C = 4), within the plain fp32 version's error plus a tenth of the
    limit.

The grid case's expansions are also held to murb_tpu's jnp ``p2m_grid``
and its interpolation to ``l2p_grid`` (float32) the same way.

The glue: each warp's 32-way search of the prefix (``warp_item_run``)
finds the run a binary search finds (the first design's ``item_run``),
``run_items`` covers every run's bodies, and the glue issues no operation
that reads a device value back to the host.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from murb_tpu.ops import fmm as jf
from murb_tpu.ops.proxy_pallas import _tj_nodes
from murb_tpu_torch.ops import anterp_kernels as ak
from murb_tpu_torch.ops import fmm_kernels as fk
from murb_tpu_torch.ops.p2p import _cell_ixyz

torch.set_num_threads(2)
CSRC = Path(fk.__file__).resolve().parents[1] / "csrc" / "cell_runs.cuh"
CPU = torch.device("cpu")


# ------------------------------------------------------------ emulation
def fma(a, b, c):
    """fp32 fma: the exact product plus c, rounded once to fp32 (the
    product of two floats is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def bases(t, m: int, scale=None):
    """(nb, MW) fp32 S_k(t) * scale, 0 past m: basis_span's arithmetic."""
    mw = fk.padded_order(m)
    tab = fk.node_table(m, CPU).reshape(m, m - 1)
    T = [None, t]
    tprev, tcur = torch.ones_like(t), t
    for _ in range(2, m):
        tnext = fma(2.0 * t, tcur, -tprev)
        tprev, tcur = tcur, tnext
        T.append(tcur)
    out = torch.zeros((t.shape[0], mw), dtype=torch.float32)
    c0 = torch.tensor(1.0 / m, dtype=torch.float32)
    c1 = torch.tensor(2.0 / m, dtype=torch.float32)
    for k in range(m):
        s = torch.zeros_like(t)
        for j in range(1, m):
            s = fma(T[j], tab[k, j - 1].expand_as(t), s)
        v = fma(c1.expand_as(s), s, c0.expand_as(s))
        out[:, k] = v if scale is None else scale * v
    return out


def emulate_p2m(tx, ty, tz, g, bounds, items: fk.RunItems, m: int):
    """W (nrun, m^3) fp32 in the kernels' order; the bodies in run order."""
    mw = fk.padded_order(m)
    A, Y, Z = bases(tx, m, g), bases(ty, m), bases(tz, m)
    nrun = bounds.shape[0] - 1
    split = fk.fold_split(items.nitems, nrun)
    w = torch.zeros((nrun, m, m, m), dtype=torch.float32)
    for r in range(nrun):
        i0, i1 = int(items.prefix[r]), int(items.prefix[r + 1])
        parts = []
        for it in range(i0, i1):
            j0 = int(bounds[r]) + (it - i0) * items.chunk
            j1 = min(j0 + items.chunk, int(bounds[r + 1]))
            acc = torch.zeros((mw, mw, mw), dtype=torch.float32)
            for j in range(j0, j1):
                p = A[j][:, None] * Y[j][None, :]
                acc = fma(p[:, :, None].expand_as(acc),
                          Z[j][None, None, :].expand_as(acc), acc)
            parts.append(acc[:m, :m, :m])
        if len(parts) == 1:
            w[r] = parts[0]
        elif parts:                     # a run of none reads 0
            w[r] = fold(parts, split)
    return w.reshape(nrun, m ** 3)


def fold(parts, split: int):
    """The fold launch's sum of a run's item partials: lane l adds items l,
    l + split, ... in order, then the lanes' sums in lane order."""
    total = torch.zeros_like(parts[0])
    for lane in range(split):
        s = torch.zeros_like(total)
        for part in parts[lane::split]:
            s = s + part
        total = total + s
    return total


def emulate_l2p(tx, ty, tz, runs_of, fields, m: int, block: int = 256):
    """(k, nb) fp32 in the kernels' order: each body against its run's
    fields (``runs_of``: a run a body, -1 for none), ``block`` bodies at a
    time."""
    outs = [emulate_l2p_block(tx[s:s + block], ty[s:s + block],
                              tz[s:s + block], runs_of[s:s + block], fields,
                              m) for s in range(0, tx.shape[0], block)]
    return torch.cat(outs, 1)


def emulate_l2p_block(tx, ty, tz, runs_of, fields, m: int):
    mw = fk.padded_order(m)
    Sx, Sy, Sz = bases(tx, m), bases(ty, m), bases(tz, m)
    keep = runs_of >= 0
    outs = []
    for f in fields:
        Fb = torch.zeros((tx.shape[0], mw, mw, mw), dtype=torch.float32)
        Fb[:, :m, :m, :m] = f[runs_of.clamp(min=0)].reshape(-1, m, m, m)
        if mw <= fk.RUN_WARP_MAX_MW:
            acc = torch.zeros(tx.shape[0], dtype=torch.float32)
            for u in range(m):
                bu = torch.zeros_like(acc)
                for v in range(m):
                    t = torch.zeros_like(acc)
                    for x in range(m):
                        t = fma(Fb[:, u, v, x], Sz[:, x], t)
                    bu = fma(Sy[:, v], t, bu)
                acc = fma(Sx[:, u], bu, acc)
        else:
            uc = 4 if mw <= 16 else 2
            H = torch.zeros(Fb.shape[:3], dtype=torch.float32)
            for x in range(m):
                H = fma(Fb[..., x], Sz[:, None, None, x].expand_as(H), H)
            # each pair group's t: 4 consecutive v of one u, summed in order
            Hq = H.reshape(-1, mw, mw // 4, 4)
            Yq = Sy.reshape(-1, 1, mw // 4, 4).expand_as(Hq)
            t = Yq[..., 0] * Hq[..., 0]
            for p in range(1, 4):
                t = fma(Yq[..., p], Hq[..., p], t)
            # warp w owns pair groups w and w + nwarp of every chunk
            nwarp = uc * mw // 8
            wp = torch.arange(nwarp)
            a = torch.zeros((tx.shape[0], nwarp), dtype=torch.float32)
            for c in range(-(-m // uc)):
                for pg in (wp, wp + nwarp):
                    u = c * uc + (4 * pg) // mw
                    a = fma(Sx[:, u], t[:, u, ((4 * pg) % mw) // 4], a)
            acc = torch.zeros(tx.shape[0], dtype=torch.float32)
            for q in range(nwarp):
                acc = acc + a[:, q]
        outs.append(torch.where(keep, acc, torch.zeros_like(acc)))
    return torch.stack(outs)


def p2m_sums64(tx, ty, tz, g, runs_of, nrun: int, m: int):
    """(nrun, m^3): the emulation's fp32 bases summed in float64."""
    A, Y, Z = (b[:, :m].double() for b in (bases(tx, m, g), bases(ty, m),
                                          bases(tz, m)))
    w = torch.zeros((nrun, m ** 3), dtype=torch.float64)
    keep = runs_of >= 0
    outer = torch.einsum("bu,bv,bw->buvw", A, Y, Z).reshape(-1, m ** 3)
    return w.index_add_(0, runs_of[keep], outer[keep])


def l2p_sums64(tx, ty, tz, runs_of, fields, m: int):
    """(k, nb): the emulation's fp32 bases and the fields in float64."""
    S = [b[:, :m].double() for b in (bases(tx, m), bases(ty, m),
                                     bases(tz, m))]
    keep = (runs_of >= 0).double()
    return torch.stack([
        torch.einsum("bu,bv,bw,buvw->b", *S, f.double()[runs_of.clamp(
            min=0)].reshape(-1, m, m, m)) * keep for f in fields])


def within(got, ref, fp32, limit: float) -> None:
    """``got`` within ``limit`` of float64 ``ref``, or within the plain fp32
    version's error plus a tenth of the limit where that misses it."""
    allowed = max(limit, rel(fp32, ref) + 0.1 * limit)
    assert rel(got, ref) <= allowed, (rel(got, ref), allowed)


def cell_t(q, lo, cs, cell):
    return (2.0 * ((q - lo) / cs - cell.float()) - 1.0).clamp(-1.0, 1.0)


def rel(got, ref) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


# ---------------------------------------------------------------- cases
def grid_case(m: int, C: int, n: int = 2048, seed: int = 0):
    """Bodies in the upper octant of the box [-1, 1]^3 plus one alone in
    cell (0, 0, 0): empty cells, a run of one body and long runs."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 0.999, (n, 3)).astype(np.float32)
    q[0] = -0.9
    g = rng.uniform(0.5, 1.5, n).astype(np.float32)
    c = np.zeros(3, np.float32)
    h = np.ones(3, np.float32)
    fields = [rng.standard_normal((C ** 3, m ** 3)).astype(np.float32)
              for _ in range(4)]
    return q, g, c, h, fields


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("m", [6, 8, 18, 32])
def test_grid_p2m_emulation_within_float64_contract(m, C):
    """K8's order of sums against float64 (1e-5 of max|W|) and murb_tpu's
    p2m_grid; items of 64 bodies (cells of several items, of one, of none)
    and, with a chunk past n, one item a cell and no fold."""
    q, g, c, h, _ = grid_case(m, C)
    qt = [torch.from_numpy(q[:, d].copy()) for d in range(3)]
    gt = torch.from_numpy(g)
    ct, ht = torch.from_numpy(c), torch.from_numpy(h)
    order = fk.cell_order(*qt, ct, ht, C)
    counts = order.bounds.diff()
    assert int((counts == 0).sum()) > 0 and int((counts == 1).sum()) == 1
    perm, lo, cs = order.perm, order.box[:3], order.box[3:]
    cell = fk._cell_coords(torch.stack(qt), lo[:, None], cs[:, None],
                           C)[0][:, perm]
    tx, ty, tz = (cell_t(qt[d][perm], lo[d], cs[d], cell[d])
                  for d in range(3))
    ref = fk.p2m_grid_plain(*(v.double() for v in qt), gt.double(),
                            ct.double(), ht.double(), m=m, C=C)
    plain = fk.p2m_grid_plain(*qt, gt, ct, ht, m=m, C=C)
    jref = torch.from_numpy(np.array(jf.p2m_grid(
        *(jnp.asarray(q[:, d]) for d in range(3)), jnp.asarray(g),
        jnp.asarray(c), jnp.asarray(h), m=m, C=C)))
    cid = (cell[0] * C + cell[1]) * C + cell[2]
    sums = p2m_sums64(tx, ty, tz, gt[perm], cid, C ** 3, m)
    for chunk in (64, 4096):
        items = fk.run_items(order.bounds, q.shape[0], chunk)
        assert int(items.prefix[-1]) <= items.nitems
        if chunk == 64:
            assert int(items.prefix.diff().max()) > 1
        w = emulate_p2m(tx, ty, tz, gt[perm], order.bounds, items, m)
        assert rel(w, sums) <= 1e-5, f"chunk {chunk}: {rel(w, sums):.3e}"
        within(w, ref, plain, 1e-5)
        assert rel(w, jref.double()) <= max(1e-5, rel(jref, ref) + 1e-6)
        assert float(w[counts == 0].abs().max()) == 0.0


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("m", [6, 8, 18, 32])
def test_grid_l2p_emulation_within_float64_contract(m, C):
    """K9's order of sums (the warp form at m <= 8, the two-stage product
    above) against float64 (1e-4 of max|a|) and murb_tpu's l2p_grid."""
    q, _, c, h, fields = grid_case(m, C, seed=1)
    qt = [torch.from_numpy(q[:, d].copy()) for d in range(3)]
    ct, ht = torch.from_numpy(c), torch.from_numpy(h)
    order = fk.cell_order(*qt, ct, ht, C)
    perm, lo, cs = order.perm, order.box[:3], order.box[3:]
    cell = fk._cell_coords(torch.stack(qt), lo[:, None], cs[:, None], C)[0]
    cid = (cell[0] * C + cell[1]) * C + cell[2]
    tx, ty, tz = (cell_t(qt[d], lo[d], cs[d], cell[d]) for d in range(3))
    ft = [torch.from_numpy(f) for f in fields]
    got = emulate_l2p(tx, ty, tz, cid, ft, m)
    ref = fk.l2p_grid_plain(*(v.double() for v in qt), ct.double(),
                            ht.double(), [f.double() for f in ft], m=m, C=C)
    plain = fk.l2p_grid_plain(*qt, ct, ht, ft, m=m, C=C)
    jref = jf.l2p_grid(*(jnp.asarray(q[:, d]) for d in range(3)),
                       jnp.asarray(c), jnp.asarray(h),
                       tuple(jnp.asarray(f) for f in fields), m=m, C=C)
    sums = l2p_sums64(tx, ty, tz, cid, ft, m)
    for k in range(4):
        assert rel(got[k], sums[k]) <= 1e-4, f"field {k}"
        within(got[k], ref[k], plain[k], 1e-4)
        jk = torch.from_numpy(np.array(jref[k]))
        assert rel(got[k], jk.double()) <= max(1e-4, rel(jk, ref[k]) + 1e-5)
    items = fk.run_items(order.bounds, q.shape[0], fk.l2p_item(m))
    assert int(items.prefix[-1]) <= items.nitems


def window_case(m: int, C: int, n: int = 2048, seed: int = 2):
    """Morton-sorted clustered bodies with their finest cells and slots; the
    last n/16 bodies in the dump slot cap (murb_tpu's window cases)."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.normal(0.3, 0.04, (n // 2, 3)),
                        rng.uniform(-1, 1, (n - n // 2, 3))]).clip(-0.999,
                                                                  0.999)
    c, h = torch.zeros(3, dtype=torch.float64), torch.ones(3,
                                                           dtype=torch.float64)
    qt = [torch.from_numpy(q[:, d].copy()) for d in range(3)]
    ci = _cell_ixyz(*qt, c, h, C)
    cid = (ci[0] * C + ci[1]) * C + ci[2]
    o = torch.argsort(cid, stable=True)
    qt = [v[o].float() for v in qt]
    ci = tuple(v[o] for v in ci)
    uniq, slots = torch.unique(cid[o], return_inverse=True)
    cap = int(uniq.numel()) + 2
    slots[-n // 16:] = cap
    g = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    return qt, g, c.float(), h.float(), slots, cap, ci


@pytest.mark.parametrize("m,C", [(6, 4), (8, 2), (18, 2), (32, 2)])
def test_window_emulation_within_float64_contract(m, C):
    """K11 and K12 over the slots: bodies in place with their own cells,
    the dump slot in no item (row cap of W 0, dump bodies 0), a slot of
    several P2M items; K11 held to K8's 1e-5 (its chip limit is 1e-4), K12
    to 1e-4."""
    qt, g, c, h, slots, cap, ci = window_case(m, C)
    n = qt[0].shape[0]
    items = ak.window_items(slots, cap, 64)
    assert int(items.bounds[-1]) == int(items.bounds[-2])   # the dump
    assert int(items.prefix.diff().max()) > 1
    lo, cs = c - h, 2.0 * h / C
    tx, ty, tz = (cell_t(qt[d], lo[d], cs[d], ci[d]) for d in range(3))
    w = emulate_p2m(tx, ty, tz, g, items.bounds, items, m)
    ref = ak.p2m_window_plain(*(v.double() for v in qt), g.double(),
                              c.double(), h.double(), slots, cap, m=m, C=C,
                              ci=ci)
    plain = ak.p2m_window_plain(*qt, g, c, h, slots, cap, m=m, C=C, ci=ci)
    runs_of = torch.where(slots < cap, slots, -1)
    sums = p2m_sums64(tx, ty, tz, g, runs_of, cap + 1, m)
    assert rel(w[:cap], sums[:cap]) <= 1e-5
    within(w[:cap], ref[:cap], plain[:cap], 1e-5)
    assert float(w[cap].abs().max()) == 0.0
    rng = np.random.default_rng(3)
    fields = [torch.from_numpy(rng.standard_normal(
        (cap + 1, m ** 3)).astype(np.float32)) for _ in range(3)]
    for f in fields:
        f[cap] = 0.0
    got = emulate_l2p(tx, ty, tz, runs_of, fields, m)
    ref = ak.l2p_window_plain(*(v.double() for v in qt), c.double(),
                              h.double(), slots, [f.double() for f in fields],
                              m=m, C=C, ci=ci)
    plain = ak.l2p_window_plain(*qt, c, h, slots, fields, m=m, C=C, ci=ci)
    sums = l2p_sums64(tx, ty, tz, runs_of, fields, m)
    for k in range(3):
        assert rel(got[k], sums[k]) <= 1e-4
        within(got[k], ref[k], plain[k], 1e-4)
    assert float(got[:, -n // 16:].abs().max()) == 0.0


# ----------------------------------------------------------------- glue
def item_run(prefix, nrun: int, b: int) -> int:
    """The binary search each block of the first design ran for its run."""
    if b >= prefix[nrun]:
        return -1
    lo, hi = 0, nrun
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if prefix[mid] <= b:
            lo = mid
        else:
            hi = mid
    return lo


def warp_item_run(prefix, nrun: int, b: int) -> int:
    """The kernels' warp_item_run: 32 lanes probe 32 points of the
    interval, a ballot counts the probes at or below b."""
    if b >= prefix[nrun]:
        return -1
    lo, hi = 0, nrun
    while hi - lo > 1:
        step = (hi - lo + 31) // 32
        c = sum(lo + (lane + 1) * step < hi
                and prefix[lo + (lane + 1) * step] <= b
                for lane in range(32))
        hi = min(hi, lo + (c + 1) * step)
        lo += c * step
    return lo


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_item_runs_match_the_binary_search(seed):
    rng = np.random.default_rng(seed)
    # 1500 runs: three rounds of the warp's search
    counts = rng.integers(0, 5, 1500) * (rng.random(1500) < 0.6)
    counts[0] = counts[-1] = 0                     # empty at both ends
    bounds = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))
    n = int(bounds[-1])
    for chunk in (1, 2, 64):
        items = fk.run_items(bounds, n, chunk)
        prefix = items.prefix.tolist()
        assert items.nitems >= prefix[-1]
        want = [item_run(prefix, len(counts), b) for b in range(items.nitems)]
        got = [warp_item_run(prefix, len(counts), b)
               for b in range(items.nitems)]
        assert got == want
        # every run's items cover its bodies exactly
        for r in range(len(counts)):
            got = int(items.prefix[r + 1] - items.prefix[r])
            assert got == -(-int(counts[r]) // chunk)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


#: aten operations that read a device value back to the host
_SYNCS = ("aten._local_scalar_dense", "aten.item", "aten.nonzero",
          "aten.is_nonzero", "aten.equal", "aten.unique")


def test_glue_reads_nothing_back():
    """run_items, window_items and the cell order issue no operation that
    copies a device value to the host (on the card each would wait for the
    stream)."""
    qt, g, c, h, slots, cap, ci = window_case(8, 4)
    with _Ops() as rec:
        order = fk.cell_order(*qt, c, h, 4)
        fk.run_items(order.bounds, qt[0].shape[0], 64)
        fk.run_items(order.bounds, qt[0].shape[0], fk.l2p_item(18))
        ak.window_items(slots, cap, 128)
    assert rec.ops and not [op for op in rec.ops
                            if op.startswith(_SYNCS)], rec.ops


def test_node_table_is_murb_tpus_in_float32():
    for m in (2, 6, 18, 32):
        t = fk.node_table(m, CPU)
        assert t.dtype == torch.float32 and t.shape == (m * (m - 1),)
        np.testing.assert_array_equal(
            t.numpy(), _tj_nodes(m).astype(np.float32).ravel())
    assert fk.node_table(6, CPU) is fk.node_table(6, CPU)     # cached


def test_chunks_follow_the_card_and_the_order():
    # N = 1M at m > 8 on 132 SMs: 1024 bodies (the partials under a tenth)
    assert fk.p2m_chunk(1_048_576, 32, 132) == 1024
    assert fk.p2m_chunk(1_048_576, 18, 132) == 1024
    assert fk.p2m_chunk(1_048_576, 6, 132) == 512
    assert fk.p2m_chunk(200_192, 8, 132) == 128
    assert fk.p2m_chunk(200_192, 12, 132) == 256
    assert fk.p2m_chunk(100, 8, 132) == 32 and fk.p2m_chunk(100, 12, 132) == 64
    assert [fk.l2p_item(m) for m in (2, 6, 8, 9, 18, 32)] == [64] * 3 + [256] * 3
    assert [fk.padded_order(m) for m in (2, 4, 5, 18, 32)] == [4, 4, 8, 20, 32]


def test_python_geometry_mirrors_the_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRunWarpMaxMW") == fk.RUN_WARP_MAX_MW
    assert const("kRunP2MTile") == fk.RUN_P2M_TILE
    assert 32 * const("kRunL2PLaneBodies") == fk.RUN_L2P_WARP_ITEM
    assert 32 * const("kRunL2PThreadBodies") == fk.RUN_L2P_BLOCK_ITEM
    assert const("kRunFields") == fk._L2P_GROUP
    # warp_item_run's probes, as the test emulates them
    assert "const int step = (hi - lo + 31) / 32;" in src
    assert "const int probe = lo + (lane + 1) * step;" in src
