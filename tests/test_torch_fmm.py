"""The port's multi-level hierarchy (ops/fmm.py, ops/fmm_kernels.py) and
the octant proxy against murb_tpu's.

On the CPU murb_tpu's fused Pallas stages are ineligible
(``fmm_fused_block`` and ``m2l_fused_tile`` return None off the TPU), so
its ``acc_fmm`` runs the jnp stages ``p2m_grid``, ``m2l_level`` and
``l2p_grid``: the reference the port's plain versions, which the kernel
wrappers run on CPU tensors, are held to.  Inputs come from
``murb_tpu.core.init`` and reach both packages as numpy arrays.

Tolerances: the host helpers exactly; the components in float64 within
1e-10 of the largest magnitude (the same algebra, another summation
order); ``acc_fmm`` in float32 within 1e-5 net-relative of murb_tpu's
(the measured gaps are 5e-7 to 2e-6) and, separately, against the naive
oracle under tests/test_fmm.py's caps; the potential within 1e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu.ops import fmm as jf
from murb_tpu.ops import proxy as jp
from murb_tpu.ops.naive import acc_naive
from murb_tpu_torch.ops import fmm as tf
from murb_tpu_torch.ops import fmm_kernels as tk
from murb_tpu_torch.ops import proxy as tp

torch.set_num_threads(2)
SOFT = 2.0e8


def force_stat(got, ref) -> float:
    """ops/validate's statistic: max per-body vector error over
    max(|a_ref|, 1e-6 max |a_ref|)."""
    g = np.stack([np.asarray(v, np.float64) for v in got], 1)
    r = np.stack([np.asarray(v, np.float64) for v in ref], 1)
    rn = np.linalg.norm(r, axis=1)
    floor = np.maximum(rn, rn.max() * 1e-6)
    return float((np.linalg.norm(g - r, axis=1) / floor).max())


def close64(got, ref, msg):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))
    assert err <= 1e-10, f"{msg}: {err:.3e} of max|ref| (tol 1e-10)"


def state(scheme, n, seed, dtype=jnp.float32):
    """(JAX arrays qx, qy, qz, gm; torch tensors of the same values)."""
    s = jinit.SCHEMES[scheme](n, seed).astype(dtype)
    gm = jnp.asarray(G, s.qx.dtype) * s.m
    j = (s.qx, s.qy, s.qz, gm)
    return j, tuple(torch.from_numpy(np.array(v)) for v in j)


@pytest.fixture(scope="module")
def random64():
    """A random-scheme state in float64 with its bounding box, both
    packages."""
    j, t = state("random", 1024, 11, jnp.float64)
    jc, jh = jp.bounding_box(*j[:3], j[3] > 0)
    return j, t, (jc, jh), tuple(torch.from_numpy(np.array(v))
                                for v in (jc, jh))


def weights(m, C, seed):
    return np.random.default_rng(seed).standard_normal(
        (C ** 3, m ** 3)) * 1e28


# ------------------------------------------------------------ host helpers
@pytest.mark.parametrize("subset", ["expand", "near", "far"])
def test_offsets_paired_match_jax(subset):
    assert tf._SUBSETS == jf._SUBSETS
    for a, b in zip(tf._offsets_paired(*tf._SUBSETS[subset]),
                    jf._offsets_paired(*jf._SUBSETS[subset])):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("m", [4, 6, 8, 12])
def test_m2m_matrix_and_basis_match_jax(m):
    np.testing.assert_array_equal(tf._m2m_matrix(m), jf._m2m_matrix(m))
    t = np.linspace(-1.2, 1.2, 37)
    np.testing.assert_array_equal(tf._basis_np(t, m), jf._basis_np(t, m))


@pytest.mark.parametrize("half", [1.0e8, 2.5e8, 6.65e8, 1.33e9, 3e9, 1e10,
                                  1e11])
def test_best_depth_and_levels_match_jax(half):
    """On a CPU state the depth model is murb_tpu's (its TPU overhead); on
    a card the same candidates, each level past the minimum priced at the
    card's overhead instead."""
    assert tf.LEVEL_OVERHEAD["cpu"] == 3.5e10
    assert tf.required_levels(half, SOFT) == jf.required_levels(half, SOFT)
    lmin = tf.required_levels(half, SOFT)
    extra = tf.LEVEL_OVERHEAD["cuda"] - tf.LEVEL_OVERHEAD["cpu"]
    for n in (1024, 200_192, 1_000_000, 16_777_216):
        for tol in (1e-3, 1e-4, 1e-5):
            assert tf.best_depth(n, half, SOFT, tol, device="cpu") == \
                jf.best_depth(n, half, SOFT, tol), (n, tol)
            cpu = tf.depth_candidates(n, half, SOFT, tol, device="cpu")
            card = tf.depth_candidates(n, half, SOFT, tol, device="cuda")
            assert [c[1:] for c in card] == [c[1:] for c in cpu]
            for (e, _, lv), (e0, _, _) in zip(card, cpu):
                assert e == pytest.approx(e0 + extra * (lv - lmin),
                                          rel=1e-12)
            assert tf.best_depth(n, half, SOFT, tol, device="cuda") == \
                min(card, key=lambda c: c[0])[1:], (n, tol)


# ------------------------------------------------- components in float64
@pytest.mark.parametrize("m,C", [(4, 2), (4, 8), (6, 4), (6, 8)])
def test_p2m_and_l2p_grid_match_jax(random64, m, C):
    j, t, (jc, jh), (tc, th) = random64
    close64(tk.p2m_grid_plain(*t, tc, th, m=m, C=C).numpy(),
            jf.p2m_grid(*j, jc, jh, m=m, C=C), f"p2m_grid m={m} C={C}")
    # the wrapper runs the plain version on CPU tensors
    torch.testing.assert_close(
        tk.p2m_grid_fused(*t, tc, th, m=m, C=C),
        tk.p2m_grid_plain(*t, tc, th, m=m, C=C), rtol=0, atol=0)
    fields = tuple(weights(m, C, s) for s in range(4))
    got = tk.l2p_grid_fused(*t[:3], tc, th,
                            tuple(torch.from_numpy(f) for f in fields),
                            m=m, C=C)
    ref = jf.l2p_grid(*j[:3], jc, jh, tuple(jnp.asarray(f) for f in fields),
                      m=m, C=C)
    for g, r in zip(got, ref):
        close64(g.numpy(), r, f"l2p_grid m={m} C={C}")


@pytest.mark.parametrize("m,C", [(4, 2), (4, 8), (6, 4)])
def test_m2m_and_l2l_match_jax(m, C):
    w = weights(m, C, 3)
    close64(tf.m2m(torch.from_numpy(w), m=m, C=C).numpy(),
            jf.m2m(jnp.asarray(w), m=m, C=C), f"m2m m={m} C={C}")
    f = weights(m, C // 2, 4)
    close64(tf.l2l(torch.from_numpy(f), m=m, C=C // 2).numpy(),
            jf.l2l(jnp.asarray(f), m=m, C=C // 2), f"l2l m={m} C={C // 2}")


@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("subset", ["expand", "near", "far"])
@pytest.mark.parametrize("m,C", [(4, 2), (4, 8), (6, 4)])
def test_m2l_level_matches_jax(random64, m, C, subset, with_phi):
    _, _, (_, jh), (_, th) = random64
    w = weights(m, C, 5)
    got = tk.m2l_level_fused(torch.from_numpy(w), th / C, SOFT, m=m, C=C,
                             subset=subset, with_phi=with_phi)
    ref = jf.m2l_level(jnp.asarray(w), jh / C, SOFT, m=m, C=C,
                       subset=subset, with_phi=with_phi)
    assert len(got) == len(ref) == (4 if with_phi else 3)
    for i, (g, r) in enumerate(zip(got, ref)):
        close64(g.numpy(), r, f"m2l {subset} m={m} C={C} field {i}")


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_m2l_level_plain_row_blocks_match_jax(random64, monkeypatch, rows):
    """The plain M2L builds T a block of target rows at a time above m=20
    (8.6 GB a whole float64 matrix at m=32): blocks of 1, 7 (ragged) and
    64 rows at m=4 give murb_tpu's fields."""
    _, _, (_, jh), (_, th) = random64
    m, C = 4, 4
    monkeypatch.setattr(tk, "_PLAIN_M2L_ENTRIES", rows * m ** 3)
    w = weights(m, C, 9)
    got = tk.m2l_level_plain(torch.from_numpy(w), th / C, SOFT, m=m, C=C,
                             with_phi=True)
    ref = jf.m2l_level(jnp.asarray(w), jh / C, SOFT, m=m, C=C,
                       with_phi=True)
    for i, (g, r) in enumerate(zip(got, ref)):
        close64(g.numpy(), r, f"m2l rows={rows} field {i}")


# ------------------------------------------------------------- K7's plan
#: the shapes chip_smoke.py launches K7 at: (m, C, subset)
K7_SHAPES = [(8, 4, "expand"), (6, 8, "expand"), (6, 8, "near"),
             (6, 4, "far"), (18, 2, "expand"), (32, 2, "expand")]


def plan_cells(plan):
    """{offset: sorted target cells} of a plan's items."""
    out = {}
    for it in plan.items:
        out.setdefault(tuple(int(v) for v in it[:3]), []).extend(
            int(v) for v in it[8:8 + it[4]])
    return {o: sorted(c) for o, c in out.items()}


@pytest.mark.parametrize("m,C,subset", K7_SHAPES)
def test_m2l_plan_admits_the_plain_versions_pairs(m, C, subset):
    """Each offset's target cells in K7's items are those the plain
    version's masks admit (the source cell in the grid; ``_parity_mask``
    for expand and far), each once; the pair count is chip_smoke's
    ``m2l_work`` (4,096 at m=8, C=4, expand)."""
    from chip_smoke import m2l_work
    from murb_tpu_torch.ops.fmm import _SUBSETS, _offsets_paired

    plan = tk.m2l_plan(m, C, subset, 132)
    cells = plan_cells(plan)
    even = (torch.arange(C) % 2) == 0
    idx = torch.arange(C)
    canon = _offsets_paired(*_SUBSETS[subset])[0].tolist()
    offsets = {tuple(o) for o in canon} | {tuple(-x for x in o)
                                           for o in canon}
    n_pairs = 0
    for o in sorted(offsets):
        ok = [((idx + d) >= 0) & ((idx + d) < C) for d in o]
        grid = (ok[0][:, None, None] & ok[1][None, :, None]
                & ok[2][None, None, :]).reshape(-1)
        if subset != "near":
            grid &= tk._parity_mask(o, even, C)[:, 0]
        want = torch.nonzero(grid).flatten().tolist()
        assert cells.get(tuple(o), []) == want, f"offset {o}"
        n_pairs += len(want)
    assert set(cells) <= offsets
    assert plan.cell_pairs == n_pairs == m2l_work(m, C, subset, 3)[0]
    if (m, C, subset) == (8, 4, "expand"):
        assert n_pairs == 4096


@pytest.mark.parametrize("slots", [132, 264])
@pytest.mark.parametrize("m,C,subset", K7_SHAPES + [(4, 16, "near"),
                                                    (3, 5, "far")])
def test_m2l_plan_tables(m, C, subset, slots):
    """The tables csrc/fmm.cu reads: items of 1 to 16 cells (zeros past),
    their linear offset and in-grid sources; per cell tile (4^3 cells, the
    grid up to C = 4) ``nsplit`` rows whose item runs cover the tile's
    items once, in order, with about equal work; the blocks within the
    card's slots; the scratch one set of fields a split."""
    plan = tk.m2l_plan(m, C, subset, slots)
    it = plan.items
    assert it.dtype == np.int32 and it.shape[1] == tk.M2L_ITEM_INTS
    assert plan.rows.dtype == np.int32
    assert plan.rows.shape[1] == tk.M2L_ROW_INTS
    ncell = it[:, 4]
    assert ((ncell >= 1) & (ncell <= tk.M2L_GROUP)).all()
    G = tk.M2L_GROUP
    assert tk.M2L_ITEM_INTS == 8 + 2 * G
    for row in it:
        o, n = row[:3], row[4]
        assert row[3] == (o[0] * C + o[1]) * C + o[2]
        assert (row[5:8] == 0).all()
        assert (row[8 + n:8 + G] == 0).all() and (row[8 + G + n:] == 0).all()
        t = row[8:8 + n]
        t3 = np.stack([t // (C * C), (t // C) % C, t % C], 1) + o
        assert ((t3 >= 0) & (t3 < C)).all()          # sources in the grid
    T = min(C, tk.M2L_CELL_TILE)
    ntiles = (-(-C // T)) ** 3
    assert plan.utiles == -(-m ** 3 // tk.M2L_TARGETS)
    assert plan.rows.shape[0] == ntiles * plan.nsplit
    assert 1 <= plan.nsplit <= tk.M2L_MAX_SPLIT
    assert plan.nsplit == 1 or plan.utiles * plan.rows.shape[0] <= slots
    end = 0
    for k in range(ntiles):
        rows = plan.rows[k * plan.nsplit:(k + 1) * plan.nsplit]
        assert (rows[:, 2] == np.arange(plan.nsplit)).all()
        assert rows[0, 0] == end and (rows[1:, 0] == rows[:-1, 1]).all()
        box = rows[0, 3:9]
        assert (rows[:, 3:9] == box).all() and (rows[:, 9:] == 0).all()
        ext = box[1::2] - box[0::2]
        for r in rows:
            for row in it[r[0]:r[1]]:
                t = row[8:8 + row[4]]
                t3 = np.stack([t // (C * C), (t // C) % C, t % C], 1)
                assert ((t3 >= box[0::2]) & (t3 < box[1::2])).all()
                # the index in the tile's fields, x-major over its box
                loc = t3 - box[0::2]
                assert (row[8 + G:8 + G + row[4]]
                        == (loc[:, 0] * ext[1] + loc[:, 1]) * ext[2]
                        + loc[:, 2]).all()
        work = [sum(tk._item_work(n) for n in it[r[0]:r[1], 4]) for r in rows]
        assert max(work) <= sum(work) / plan.nsplit + tk._item_work(
            tk.M2L_GROUP)
        end = rows[-1, 1]
    assert end == len(it)
    for nf in (3, 4):
        want = plan.nsplit * nf * C ** 3 * m ** 3 if plan.nsplit > 1 else 0
        assert plan.scratch(m, C, nf) == want
    assert plan.builds(m) == len(it) * m ** 6


def test_m2l_plan_shares_each_transfer_build():
    """At the main path (m=8, C=4, expand) an item shares one build of
    T(o) among up to 16 target cells: 444 builds of the 512^2 entries
    for the 4,096 cell pairs; nsplit fills a card of 132 one-block SMs."""
    plan = tk.m2l_plan(8, 4, "expand", 132)
    assert len(plan.items) == 444 and plan.cell_pairs == 4096
    assert plan.nsplit == 33 and plan.utiles == 4
    assert plan.builds(8) == 444 * 512 ** 2


@pytest.mark.parametrize("group", [8, 12])
def test_m2l_plan_group_sets_the_items_width(group):
    """A plan for a kernel compiled with another kM2LGroup (the A/B
    script's variants): items 8 + 2 group ints wide, at most ``group``
    cells each, and the default plan's cells for every offset."""
    base = tk.m2l_plan(8, 4, "expand", 132)
    plan = tk._m2l_plan(8, 4, "expand", 132, group)
    assert plan.items.shape[1] == 8 + 2 * group
    assert (plan.items[:, 4] <= group).all()
    assert len(plan.items) > len(base.items)
    assert plan_cells(plan) == plan_cells(base)
    assert plan.cell_pairs == base.cell_pairs == 4096


def emulate_plan(w, hl, soft, m, C, subset, with_phi, slots):
    """K7's arithmetic on its plan, in float64 numpy: per row (tile,
    split) and item, T(o)[u, v] from D = p_v - (p_u - 2 hl o), applied to
    the item's cells' source weights into the row's split; the splits
    added in order."""
    plan = tk.m2l_plan(m, C, subset, slots)
    k = np.arange(m)
    node = np.cos(np.pi * (k + 0.5) / m)
    m2 = m * m
    p = [hl[d] * node[[(u // m2, (u // m) % m, u % m)[d]
                       for u in range(m ** 3)]] for d in range(3)]
    nf = 4 if with_phi else 3
    part = np.zeros((plan.nsplit, nf, C ** 3, m ** 3))
    soft2 = soft * soft
    for row in plan.rows:
        for it in plan.items[row[0]:row[1]]:
            o, olin, n = it[:3], it[3], it[4]
            d = [p[i][None, :] - (p[i][:, None] - 2.0 * hl[i] * o[i])
                 for i in range(3)]
            inv = 1.0 / np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2 + soft2)
            ts = [d[i] * inv ** 3 for i in range(3)] + ([inv] if with_phi
                                                        else [])
            t = it[8:8 + n]
            for f, tf in enumerate(ts):
                part[row[2], f][t] += w[t + olin] @ tf.T
    return part.sum(0)


@pytest.mark.parametrize("slots", [8, 132])
@pytest.mark.parametrize("m,C,subset", [(4, 4, "expand"), (3, 8, "near"),
                                        (3, 8, "far"), (2, 5, "expand")])
def test_m2l_plan_computes_murb_tpus_sweep(random64, m, C, subset, slots):
    """Running K7's plan (its items and splits, in float64) gives
    murb_tpu's level sweep: the tables name every admitted pair once, with
    the shift's sign, cell tiles (C=8, 5) and splits included."""
    _, _, (_, jh), _ = random64
    hl = np.asarray(jh) / C
    w = weights(m, C, 13)
    got = emulate_plan(w, hl, SOFT, m, C, subset, True, slots)
    ref = jf.m2l_level(jnp.asarray(w), jnp.asarray(hl), SOFT, m=m, C=C,
                       subset=subset, with_phi=True)
    for i, r in enumerate(ref):
        close64(got[i], r, f"K7 plan {subset} m={m} C={C} field {i}")


@pytest.mark.parametrize("levels,m", [(1, 4), (2, 4), (3, 4), (3, 6)])
def test_fmm_field_grid_matches_jax(random64, levels, m):
    _, _, (_, jh), (_, th) = random64
    w = weights(m, 2 ** levels, 7)
    got = tf.fmm_field_grid(torch.from_numpy(w), th, SOFT, m=m,
                            levels=levels, with_phi=True)
    ref = jf.fmm_field_grid(jnp.asarray(w), jh, SOFT, m=m, levels=levels,
                            with_phi=True)
    for i, (g, r) in enumerate(zip(got, ref)):
        close64(g.numpy(), r, f"fmm_field_grid L={levels} m={m} field {i}")


# ------------------------------------------------------- solvers in fp32
@pytest.mark.parametrize("scheme,n,seed,levels,m,cap", [
    ("random", 1024, 3, 2, 8, 1e-3),
    ("random", 1024, 3, 3, 6, 1e-3),
    ("galaxy", 1024, 5, 1, 12, 1e-4),
    ("random", 1025, 1, 2, 8, 1e-3),    # the padding tail
])
def test_acc_fmm_matches_jax_and_oracle(scheme, n, seed, levels, m, cap):
    """Against murb_tpu's acc_fmm within 1e-5 (same algorithm, fp32 sums
    in another order), and against the naive oracle under the caps of
    tests/test_fmm.py (1e-4 for the galaxy, 1e-3 for m <= 8 on the
    random box, :57-77)."""
    j, t = state(scheme, n, seed)
    got = tf.acc_fmm(*t, SOFT, m=m, levels=levels)
    ref = jf.acc_fmm(*j, SOFT, m=m, levels=levels)
    err = force_stat([v.numpy() for v in got], ref)
    assert err <= 1e-5, f"port vs JAX acc_fmm: {err:.3e} (tol 1e-5)"
    sel = np.asarray(j[3]) > 0
    oracle = acc_naive(*j, SOFT)
    err_o = force_stat([v.numpy()[sel] for v in got],
                       [np.asarray(v)[sel] for v in oracle])
    assert err_o < cap, f"acc_fmm vs the naive oracle: {err_o:.3e}"


def test_acc_fmm_above_order_16_matches_jax():
    """The grid kernels take every order the engine configures (m <= 32,
    proxy_kernels.MAX_ORDER): at m = 18, the validation ladder's rung
    after 16, the port's acc_fmm agrees with murb_tpu's.  levels=1 (C = 2)
    keeps the (m^3)^2 = 3.4e7-entry transfer builds to a few offsets."""
    j, t = state("random", 512, 3)
    got = tf.acc_fmm(*t, SOFT, m=18, levels=1)
    ref = jf.acc_fmm(*j, SOFT, m=18, levels=1)
    err = force_stat([v.numpy() for v in got], ref)
    assert err <= 1e-5, f"port vs JAX acc_fmm m=18: {err:.3e} (tol 1e-5)"
    assert tk.MAX_ORDER == 32


@pytest.mark.parametrize("levels,m", [(2, 8), (3, 6)])
def test_force_and_potential_fmm_matches_jax(levels, m):
    j, t = state("random", 1024, 3)
    acc, phi = tf.force_and_potential_fmm(*t, SOFT, m=m, levels=levels)
    jacc, jphi = jf.force_and_potential_fmm(*j, SOFT, m=m, levels=levels)
    assert force_stat([v.numpy() for v in acc], jacc) <= 1e-5
    jphi = np.asarray(jphi, np.float64)
    rel = np.abs(phi.numpy() - jphi) / np.abs(jphi)
    assert rel.max() <= 1e-5, f"phi: {rel.max():.3e} (tol 1e-5)"
    # the forces of the fused pass are acc_fmm's
    for a, b in zip(acc, tf.acc_fmm(*t, SOFT, m=m, levels=levels)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_force_and_potential_fmm_pergal_matches_jax():
    j, t = state("random", 1024, 9)
    n = t[0].shape[0]
    masks = np.zeros((2, n), np.float32)
    masks[0, : n // 3] = 1.0
    masks[1, n // 3:] = 1.0
    acc, phi = tf.force_and_potential_fmm_pergal(
        *t, torch.from_numpy(masks), SOFT, m=6, levels=2)
    jacc, jphi = jf.force_and_potential_fmm_pergal(
        *j, jnp.asarray(masks), SOFT, m=6, levels=2)
    assert force_stat([v.numpy() for v in acc], jacc) <= 1e-5
    jphi = np.asarray(jphi, np.float64)
    assert phi.shape == jphi.shape == (2, n)
    rel = np.abs(phi.numpy() - jphi) / np.abs(jphi).max(axis=1,
                                                        keepdims=True)
    assert rel.max() <= 1e-5, f"per-galaxy phi: {rel.max():.3e} (tol 1e-5)"


@pytest.mark.parametrize("m", [8, 10])
def test_acc_proxy_cells2_matches_jax(m):
    """The octant mode: the port runs grid P2M/L2P at C=2 (K8/K9), murb_tpu
    on the CPU its per-octant loop; both are the same expansion up to fp32
    rounding.  m=10 puts the 8000-node sweep on K3's wrapper."""
    j, t = state("random", 2048, 2)
    got = tp.acc_proxy(*t, SOFT, m=m, cells=2)
    ref = jp.acc_proxy(*j, SOFT, m=m, cells=2)
    err = force_stat([v.numpy() for v in got], ref)
    assert err <= 1e-4, f"port vs JAX acc_proxy cells=2: {err:.3e}"


# ------------------------------------------------------ argument checks
def test_wrappers_check_their_arguments():
    _, t = state("random", 256, 1)
    c, h = tp.bounding_box(*t[:3], t[3] > 0)
    for m, C in ((33, 4), (1, 4), (8, 17), (8, 0)):
        with pytest.raises(ValueError, match="range"):
            tk.p2m_grid_fused(*t, c, h, m=m, C=C)
        with pytest.raises(ValueError, match="range"):
            tk.m2l_level_fused(torch.zeros(max(C, 1) ** 3, m ** 3), h, SOFT,
                               m=m, C=C)
    f = torch.zeros(64, 512)
    for k in (0, 12):
        with pytest.raises(ValueError, match="node fields"):
            tk.l2p_grid_fused(*t[:3], c, h, (f,) * k, m=8, C=4)
    with pytest.raises(ValueError, match="shape"):
        tk.l2p_grid_fused(*t[:3], c, h, (torch.zeros(8, 512),), m=8, C=4)
    with pytest.raises(ValueError, match="shape"):
        tk.m2l_level_fused(torch.zeros(8, 512), h, SOFT, m=8, C=4)
    with pytest.raises(ValueError, match="subset"):
        tk.m2l_level_fused(f, h, SOFT, m=8, C=4, subset="all")


def test_unknown_modes_raise():
    """Values murb_tpu does not know either (the lossy tiers, which raise
    "not yet ported", are in
    tests/test_torch_proxy.py:test_wide_box_raises_not_yet_ported)."""
    _, t = state("random", 256, 1)
    with pytest.raises(ValueError, match="m2l_dots"):
        tf.acc_fmm(*t, SOFT, m=4, levels=2, m2l_dots="fp16")
    with pytest.raises(ValueError, match="near mode"):
        tf.acc_fmm(*t, SOFT, m=4, levels=2, near="exact")
    with pytest.raises(ValueError, match="cells"):
        tp.acc_proxy(*t, SOFT, m=8, cells=3)


def test_cell_order_groups_each_cell():
    """The glue K8 and K9 read: a stable sort by cell id with the cell
    bounds, computed from the float32 box the kernels use."""
    _, t = state("random", 1000, 4)
    c, h = tp.bounding_box(*t[:3], t[3] > 0)
    order = tk.cell_order(*t[:3], c, h, 4)
    lo, cs = order.box[:3].double(), order.box[3:].double()
    q = torch.stack(t[:3]).double()
    cell = torch.floor((q - lo[:, None]) / cs[:, None]).clamp(0, 3).long()
    cid = ((cell[0] * 4 + cell[1]) * 4 + cell[2])
    n = t[0].shape[0]                                    # 1024, padded
    assert int(order.bounds[0]) == 0 and int(order.bounds[-1]) == n
    assert bool((order.bounds.diff() >= 0).all())
    for k in range(64):
        run = order.perm[order.bounds[k]:order.bounds[k + 1]]
        assert bool((cid[run] == k).all())
        assert bool((run[1:] > run[:-1]).all())          # stable
    items = tk.run_items(order.bounds, n, 128)
    assert int(items.prefix[-1]) <= items.nitems
    assert tk.m2l_plan(8, 4, "expand", 132).nsplit == 33
    assert tk.m2l_plan(16, 16, "expand", 132).nsplit == 1
