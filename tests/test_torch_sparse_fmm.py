"""The port's adaptive sparse hierarchy (ops/sparse_fmm.py,
ops/anterp_kernels.py) against murb_tpu's (ops/sparse_fmm.py,
ops/anterp_pallas.py).

The same numpy bodies reach both packages (tests/test_sparse_fmm.py's
distributions).  On the CPU the port's K11/K12 wrappers run their plain
versions; murb_tpu's references are its jnp window forms and its Pallas
kernels in interpret mode.  murb_tpu's solves compile once per plan, so
each is made once in a module fixture.

Tolerances: the id, occupancy and neighbour-slot helpers, the host
operators and the planner exactly (plans field for field, through
``SparsePlan.from_fields``); the components in float64 within 1e-10 of the
largest magnitude (the same algebra, another summation order); the window
forms within 1e-5 of the largest magnitude on rows [0, cap) (fp32); the
solve within 1e-5 net-relative of murb_tpu's (max per-body vector error
over max(|a|, 1e-6 max|a|)) and within 1e-4 of the naive oracle
(tests/test_sparse_fmm.py's contract), the potential within 1e-5 of
murb_tpu's and 2e-4 of the exact one.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murb_tpu.ops import anterp_pallas as jap
from murb_tpu.ops import p2p as jp
from murb_tpu.ops import sparse_fmm as js
from murb_tpu.ops.naive import acc_naive
from murb_tpu_torch.core.init import make_bodies
from murb_tpu_torch.core.state import BodyState
from murb_tpu_torch.models.engines import _active_positions
from murb_tpu_torch.ops import anterp_kernels as tak
from murb_tpu_torch.ops import p2p as tp
from murb_tpu_torch.ops import sparse_fmm as ts
from murb_tpu_torch.ops.p2p import _cell_ixyz

torch.set_num_threads(2)
SOFT = 0.01


def clusters(n=4000, npad=4096, seed=0, heavy=False):
    """(JAX arrays, torch tensors, active positions) of two tight clusters
    in a wide box, zero-mass ghosts to npad."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([
        rng.normal(0, 1.0, (n // 2, 3)) + [-50.0, 0.0, 0.0],
        rng.normal(0, 1.0, (n - n // 2, 3)) + [50.0, 10.0, -5.0],
    ]).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    if heavy:
        m[0] = 5e5
    qp = np.zeros((npad, 3), np.float32)
    qp[:n] = q
    gm = np.zeros(npad, np.float32)
    gm[:n] = m
    arrays = [qp[:, 0], qp[:, 1], qp[:, 2], gm]
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(a.copy()) for a in arrays), q)


def force_stat(got, ref, gm) -> float:
    g = np.stack([np.asarray(v, np.float64) for v in got], 1)
    r = np.stack([np.asarray(v, np.float64) for v in ref], 1)
    sel = np.asarray(gm) > 0
    rn = np.linalg.norm(r, axis=1)
    floor = np.maximum(rn, rn[sel].max() * 1e-6)
    return float((np.linalg.norm(g - r, axis=1) / floor)[sel].max())


def close(got, ref, tol, msg):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))
    assert err <= tol, f"{msg}: {err:.3e} of max|ref| (tol {tol:g})"


def port_plan(jplan):
    return ts.SparsePlan.from_fields(**jplan._asdict())


def sorted_ids(seed, n, C, frac_ghost=16):
    """Sorted Morton ids with _BIG padding, as both packages' solves make
    them."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, C // 2, (3, n)).astype(np.int32) * 2
    key = np.array(js.morton_key(*(jnp.asarray(v) for v in c), C))
    key[-n // frac_ghost:] = js._BIG
    return np.sort(key).astype(np.int32)


# ------------------------------------------------- ids and occupied cells
@pytest.mark.parametrize("C", [2, 16, 64])
def test_id_helpers_match_jax(C):
    rng = np.random.default_rng(C)
    c = rng.integers(0, C, (3, 300)).astype(np.int32)
    code = np.array(js.morton_key(*(jnp.asarray(v) for v in c), C))
    for a, b in zip(ts._munpack(torch.from_numpy(code), C),
                    js._munpack(jnp.asarray(code), C)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        ts._pack(*(torch.from_numpy(v) for v in c), C).numpy(),
        np.asarray(js._pack(*(jnp.asarray(v) for v in c), C)))
    assert ts._BIG == int(js._BIG) and ts._TABLE_MAX == js._TABLE_MAX


@pytest.mark.parametrize("cap_mode", ["roomy", "overflow"])
def test_occupancy_and_slots_match_jax(cap_mode):
    C = 16
    key = sorted_ids(1, 2048, C)
    n_occ = len(np.unique(key[key != js._BIG]))
    cap = n_occ + 7 if cap_mode == "roomy" else n_occ // 2
    jcells, jslots = js._occupied_and_slots(jnp.asarray(key), cap)
    tcells, tslots = ts._occupied_and_slots(torch.from_numpy(key), cap)
    np.testing.assert_array_equal(tcells.numpy(), np.asarray(jcells))
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(
        ts._slot_table(tcells, C).numpy(),
        np.asarray(js._slot_table(jcells, C)))
    rng = np.random.default_rng(2)
    cids = np.concatenate([key[:200], rng.integers(0, C ** 3, 200),
                           [js._BIG]]).astype(np.int32)
    for c_arg in (C, None):        # the table and the binary search
        np.testing.assert_array_equal(
            ts._slot(tcells, torch.from_numpy(cids), c_arg).numpy(),
            np.asarray(js._slot(jcells, jnp.asarray(cids), c_arg)))


@pytest.mark.parametrize("C", [8, 32])
def test_neighbor_slots_and_offsets_match_jax(C):
    key = sorted_ids(3, 1024, C, frac_ghost=8)
    cap = len(np.unique(key[key != js._BIG])) + 5
    jcells, _ = js._occupied_and_slots(jnp.asarray(key), cap)
    tcells, _ = ts._occupied_and_slots(torch.from_numpy(key), cap)
    canon = ts._canon_far()
    np.testing.assert_array_equal(canon, js._canon_far())
    for a, b in zip(ts._far_offsets(), js._far_offsets()):
        np.testing.assert_array_equal(a, b)
    for offs in (canon, -canon):
        par = ts._parity_codes(offs)
        np.testing.assert_array_equal(par, js._parity_codes(offs))
        for a, b in zip(ts._neighbor_slots(tcells, C, offs, par),
                        js._neighbor_slots(jcells, C, offs, par)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------- components in float64
@pytest.fixture(scope="module")
def chain():
    """Two levels of occupied cells (C = 16 children of C = 8 parents) and
    random float64 expansions, both packages."""
    key = sorted_ids(4, 2048, 16)
    child_cap = len(np.unique(key[key != js._BIG])) + 3
    jcc, _ = js._occupied_and_slots(jnp.asarray(key), child_cap)
    pid = np.where(np.asarray(jcc) == js._BIG, js._BIG,
                   np.asarray(jcc) >> 3).astype(np.int32)
    parent_cap = len(np.unique(pid[pid != js._BIG])) + 2
    jpc, _ = js._occupied_and_slots(jnp.asarray(pid), parent_cap)
    return (jcc, jpc), tuple(torch.from_numpy(np.array(c))
                             for c in (jcc, jpc))


@pytest.mark.parametrize("m", [3, 4, 6])
def test_octant_transfer_and_chain_match_jax(chain, m):
    (jcc, jpc), (tcc, tpc) = chain
    np.testing.assert_array_equal(ts._octant_transfer(m),
                                  js._octant_transfer(m))
    rng = np.random.default_rng(m)
    m3 = m ** 3
    w = rng.standard_normal((len(tcc) + 1, m3))
    close(ts.m2m_sparse(torch.from_numpy(w), tcc, tpc, m=m,
                        C_child=16).numpy(),
          js.m2m_sparse(jnp.asarray(w), jcc, jpc, m=m, C_child=16), 1e-10,
          f"m2m_sparse m={m}")
    f = rng.standard_normal((len(tpc) + 1, m3))
    f[-1] = 0.0
    close(ts.l2l_sparse(torch.from_numpy(f), tpc, tcc, m=m,
                        C_child=16).numpy(),
          js.l2l_sparse(jnp.asarray(f), jpc, jcc, m=m, C_child=16), 1e-10,
          f"l2l_sparse m={m}")
    fd = rng.standard_normal((8 ** 3, m3))
    close(ts.l2l_from_dense(torch.from_numpy(fd), tcc, m=m,
                            C_child=16).numpy(),
          js.l2l_from_dense(jnp.asarray(fd), jcc, m=m, C_child=16), 1e-10,
          f"l2l_from_dense m={m}")
    close(ts.densify(torch.from_numpy(w), tcc, 16).numpy(),
          js.densify(jnp.asarray(w), jcc, 16), 1e-10, f"densify m={m}")


@pytest.mark.parametrize("with_phi", [False, True])
@pytest.mark.parametrize("m,C", [(4, 16), (6, 8)])
def test_m2l_sparse_level_matches_jax(chain, m, C, with_phi):
    (jcc, jpc), (tcc, tpc) = chain
    jc, tc = (jcc, tcc) if C == 16 else (jpc, tpc)
    w = np.random.default_rng(C).standard_normal((len(tc) + 1, m ** 3))
    hl = np.array([3.0, 2.5, 4.0]) / C
    got = ts.m2l_sparse_level(torch.from_numpy(w), tc, torch.from_numpy(hl),
                              0.05, m=m, C=C, with_phi=with_phi)
    ref = js.m2l_sparse_level(jnp.asarray(w), jc, jnp.asarray(hl), 0.05,
                              m=m, C=C, with_phi=with_phi)
    assert len(got) == len(ref) == (4 if with_phi else 3)
    for i, (g, r) in enumerate(zip(got, ref)):
        close(g.numpy(), r, 1e-10, f"m2l_sparse_level m={m} C={C} field {i}")


def test_m2l_tiers_run(chain, monkeypatch):
    """Every opt-in form of the sparse M2L runs at a level of the chain
    (float32): the lossy tiers, the offsets a batch and the fused form
    within 1e-5 of max|f| of the default sweep, the compression (rank 32
    of 64) finite; the environment is read by ``m2l_schedule`` at the
    public entry, never by the level sweep; the rank rules are
    murb_tpu's (tests/test_torch_m2l_tiers.py holds each form to
    murb_tpu's)."""
    _, (tcc, _) = chain
    rng = np.random.default_rng(16)
    w = torch.from_numpy(rng.standard_normal((len(tcc) + 1, 64))
                         .astype(np.float32))
    hl = torch.tensor([3.0, 2.5, 4.0]) / 16
    kw = dict(m=4, C=16, with_phi=True)
    ref = ts.m2l_sparse_level(w, tcc, hl, 0.05, **kw)
    for extra in ({"m2l_dots": "bf16x3"}, {"m2l_dots": "mixed"},
                  {"scan_chunk": 5}, {"fused": True},
                  {"fused": True, "m2l_dots": "bf16x3"}):
        got = ts.m2l_sparse_level(w, tcc, hl, 0.05, **kw, **extra)
        for g, r in zip(got, ref):
            assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    comp = ts.m2l_sparse_level(w, tcc, hl, 0.05, rank=32, **kw)
    assert all(bool(torch.isfinite(f).all()) and f.shape == r.shape
               for f, r in zip(comp, ref))
    monkeypatch.setenv("MURB_M2L_SCAN_CHUNK", "x")
    monkeypatch.setenv("MURB_M2L_FUSED", "1")
    assert ts.m2l_schedule() == {"scan_chunk": 0, "fused": True}
    again = ts.m2l_sparse_level(w, tcc, hl, 0.05, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, ref))
    plan = ts.SparsePlan(m=8, dense_levels=2, levels=4, cell_caps=(64,),
                         p2p_pmax=128)
    assert ts.default_m2l_rank(8) == 0 and ts._resolve_rank(plan, 4096) == 0
    assert ts._resolve_rank(plan._replace(m2l_rank=384), 500) == 0
    assert ts._resolve_rank(plan._replace(m2l_rank=384), 4096) == 384


# ------------------------------------------------- K11 / K12 plain versions
def window_case(seed, n, C, cap):
    """Morton-sorted bodies with ghosts, their cells and slots (murb_tpu's
    tests/test_sparse_fmm.py:_sorted_window_case), both packages."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    g = rng.uniform(0.5, 2.0, n).astype(np.float32)
    g[-n // 16:] = 0.0
    c, h = jnp.zeros(3, jnp.float32), jnp.ones(3, jnp.float32)
    jq = [jnp.asarray(q[:, i]) for i in range(3)]
    cx, cy, cz = js._body_cells(*jq, c, h, C)
    key = jnp.where(jnp.asarray(g) > 0, js.morton_key(cx, cy, cz, C), js._BIG)
    perm = np.asarray(jnp.argsort(key))
    _, slots = js._occupied_and_slots(key[perm], cap)
    arrays = [q[perm, 0], q[perm, 1], q[perm, 2], g[perm]]
    t = tuple(torch.from_numpy(a.copy()) for a in arrays)
    tc, th = torch.zeros(3), torch.ones(3)
    return ((tuple(jnp.asarray(a) for a in arrays), c, h, slots),
            (t, tc, th, torch.from_numpy(np.array(slots)),
             _cell_ixyz(*t[:3], tc, th, C)))


@pytest.mark.parametrize("n,m,C,cap,B", [
    (512, 4, 8, 64, 256),       # capacity overflow
    (2048, 6, 16, 300, 256),
    (2048, 6, 16, 300, 512),
])
def test_p2m_window_plain_matches_jax(n, m, C, cap, B):
    """K11's plain version against murb_tpu's jnp window scan and its
    Pallas kernel in interpret mode, rows [0, cap)."""
    (jx, c, h, slots), (tx, tc, th, tslots, ci) = window_case(n, n, C, cap)
    got = tak.p2m_window(*tx, tc, th, tslots, cap, m=m, C=C, ci=ci)
    assert got.shape == (cap + 1, m ** 3)
    ref = js.p2m_window(*jx, c, h, slots, cap, m=m, C=C, chunk=B)
    close(got[:cap].numpy(), ref[:cap], 1e-5, "p2m_window vs jnp")
    ref = jap.p2m_window_pallas(*jx, c, h, slots, cap=cap, m=m, C=C, B=B,
                                interpret=True)
    close(got[:cap].numpy(), ref[:cap], 1e-5, "p2m_window vs Pallas")
    torch.testing.assert_close(   # ci defaults to the bodies' own cells
        tak.p2m_window(*tx, tc, th, tslots, cap, m=m, C=C), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("nf", [3, 4])
def test_l2p_window_plain_matches_jax(nf):
    n, m, C, cap, B = 2048, 6, 16, 300, 256
    (jx, c, h, slots), (tx, tc, th, tslots, ci) = window_case(7, n, C, cap)
    rng = np.random.default_rng(8)
    fields = [rng.normal(size=(cap + 1, m ** 3)).astype(np.float32)
              for _ in range(nf)]
    for f in fields:
        f[cap] = 0.0
    got = tak.l2p_window(*tx[:3], tc, th, tslots,
                         tuple(torch.from_numpy(f) for f in fields), m=m,
                         C=C, ci=ci)
    jf = tuple(jnp.asarray(f) for f in fields)
    for ref in (js.l2p_window(*jx[:3], c, h, slots, jf, m=m, C=C, chunk=B),
                jap.l2p_window_pallas(*jx[:3], c, h, slots, jf, cap=cap,
                                      m=m, C=C, B=B, interpret=True)):
        for k in range(nf):
            close(got[k].numpy(), ref[k], 1e-5, f"l2p_window field {k}")


def test_window_wrappers_check_their_arguments():
    _, (tx, tc, th, tslots, ci) = window_case(1, 512, 8, 64)
    f = torch.zeros(65, 64)
    with pytest.raises(ValueError, match="range"):
        tak.p2m_window(*tx, tc, th, tslots, 64, m=33, C=8)
    with pytest.raises(ValueError, match="fields"):
        tak.l2p_window(*tx[:3], tc, th, tslots, (f,) * 5, m=4, C=8)
    with pytest.raises(ValueError, match="shape"):
        tak.l2p_window(*tx[:3], tc, th, tslots, (f, torch.zeros(64, 64)),
                       m=4, C=8)
    bounds, prefix, nitems = tak.slot_items(tslots, 64, 128)
    assert int(bounds[-1]) == int(bounds[-2])      # the dump has no items
    assert int(prefix[-1]) <= nitems


# ------------------------------------------------------------ the solve
CASES = {"ld2_l4": (2, 4), "ld3_l5": (3, 5), "ld2_l6": (2, 6)}


@pytest.fixture(scope="module")
def jax_solves():
    """murb_tpu's acc_adaptive per (Ld, L), its fused force and potential
    and its heavy split, on the same bodies the port gets."""
    j, t, q = clusters()
    out = {}
    for name, (Ld, L) in CASES.items():
        plan = js.plan_adaptive(q, 4096, 6, Ld, L)
        out[name] = (plan, js.acc_adaptive(*j, SOFT, plan))
    j2, t2, q2 = clusters(2000, 2048)
    plan = js.plan_adaptive(q2, 2048, 6, 2, 5)
    out["phi"] = (plan, js.force_and_potential_adaptive(*j2, SOFT, plan))
    j3, t3, q3 = clusters(2000, 2048, heavy=True)
    plan = js.plan_adaptive(q3, 2048, 6, 2, 5)
    out["heavy"] = (plan, js.acc_adaptive(*j3, SOFT, plan, heavy_k=1))
    return out, {"main": (j, t, q), "phi": (j2, t2, q2),
                 "heavy": (j3, t3, q3)}


@pytest.mark.parametrize("case", list(CASES))
def test_acc_adaptive_matches_jax_and_oracle(jax_solves, case):
    out, states = jax_solves
    j, t, q = states["main"]
    jplan, ref = out[case]
    plan = ts.plan_adaptive(q, 4096, 6, *CASES[case], device="cpu")
    assert plan == port_plan(jplan)
    got = [v.numpy() for v in ts.acc_adaptive(*t, SOFT, plan)]
    assert force_stat(got, ref, j[3]) <= 1e-5
    assert force_stat(got, acc_naive(*j, SOFT), j[3]) <= 1e-4


def test_force_and_potential_adaptive_matches_jax(jax_solves):
    out, states = jax_solves
    j, t, _ = states["phi"]
    jplan, (jacc, jphi) = out["phi"]
    acc, phi = ts.force_and_potential_adaptive(*t, SOFT, port_plan(jplan))
    assert force_stat([v.numpy() for v in acc], jacc, j[3]) <= 1e-5
    sel = np.asarray(j[3]) > 0
    np.testing.assert_allclose(phi.numpy()[sel], np.asarray(jphi)[sel],
                               rtol=1e-5)
    qp = np.stack([np.asarray(v) for v in j[:3]], 1).astype(np.float64)
    gm = np.asarray(j[3], np.float64)
    d2 = ((qp[None] - qp[:, None]) ** 2).sum(-1) + SOFT ** 2
    ref_phi = (gm[None, :] / np.sqrt(d2)).sum(1)     # with the self term
    np.testing.assert_allclose(phi.numpy()[sel], ref_phi[sel], rtol=2e-4)
    # the forces of the fused pass are acc_adaptive's
    for a, b in zip(acc, ts.acc_adaptive(*t, SOFT, port_plan(jplan))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_acc_adaptive_heavy_split_matches_jax(jax_solves):
    out, states = jax_solves
    j, t, _ = states["heavy"]
    jplan, ref = out["heavy"]
    got = [v.numpy() for v in ts.acc_adaptive(*t, SOFT, port_plan(jplan),
                                              heavy_k=1)]
    assert force_stat(got, ref, j[3]) <= 1e-5
    assert force_stat(got, acc_naive(*j, SOFT), j[3]) <= 1e-4


# ------------------------------------------------------------- planner
@pytest.mark.parametrize("Ld,L", [(2, 3), (2, 5), (3, 6), (2, 9)])
def test_planner_matches_jax(Ld, L):
    _, _, q = clusters(2000, 2048, seed=5)
    assert ts.level_stats(q, Ld, L) == js.level_stats(q, Ld, L)
    jplan = js.plan_adaptive(q, 2048, 6, Ld, L)
    tplan = ts.plan_adaptive(q, 2048, 6, Ld, L, device="cpu")
    assert tplan == port_plan(jplan)
    assert tplan.p2p_impl == "plain" and jplan.p2p_impl == "jnp"
    for field in ("m", "dense_levels", "levels", "cell_caps", "p2p_pmax",
                  "p2p_chunk", "m2l_rank"):
        assert getattr(tplan, field) == getattr(jplan, field), field
    assert ts.plan_cost_ms(q, 2048, 6, Ld, L, device="cpu") == \
        js.plan_cost_ms(q, 2048, 6, Ld, L)
    assert ts.p2p_capacity_needed(1000) == \
        js.p2p_capacity_needed(1000, 2048, jplan)


def test_best_plan_order_and_costs_match_jax():
    _, _, q = clusters()
    jplan, jcost = js.best_adaptive_plan(q, 4096, 6)
    tplan, tcost = ts.best_adaptive_plan(q, 4096, 6, device="cpu")
    assert tplan == port_plan(jplan) and tcost == jcost
    for tol in (1e-3, 1e-4, 1e-5, 1e-7):
        assert ts.adaptive_order(tol) == js.adaptive_order(tol)
    for npad in (2048, 82_176, 1_048_576):
        assert ts.exact_cost_ms(npad, "cpu") == js.exact_cost_ms(npad)
        assert ts.exact_cost_ms(npad, "cuda") == 14.0 * npad * npad \
            / ts.PLANNER_RATES["cuda"].exact_slots_per_ms
    stats = js.level_stats(q, 2, 6)
    assert ts._cost_from_stats(stats, 1000, 4096, 8, 2, 6, 4, 384,
                               device="cpu") == \
        js._cost_from_stats(stats, 1000, 4096, 8, 2, 6, 4, 384)
    # on a card the plan names K10 and the model takes the card's rates
    # (K10's sweep among them, faster than the CPU table's plain sweep):
    # the cheapest geometry at those rates
    cplan, ccost = ts.best_adaptive_plan(q, 4096, 6, device="cuda")
    assert cplan.p2p_impl == "kernel"
    assert ts.PLANNER_RATES["cuda"].p2p_slots_per_ms > \
        ts.PLANNER_RATES["cpu"].p2p_slots_per_ms
    assert ccost == pytest.approx(ts.plan_cost_ms(
        q, 4096, 6, cplan.dense_levels, cplan.levels, device="cuda"),
        rel=1e-12)
    assert ccost == pytest.approx(min(
        ts.plan_cost_ms(q, 4096, 6, ld, lv, device="cuda")
        for ld in (2, 3) for lv in range(ld + 1, 10)), rel=1e-12)
    assert ts.SparsePlan.from_fields(
        **jplan._replace(p2p_impl="pallas")._asdict()).p2p_impl == "kernel"


# ---------------------------------------------------- the planner's counts
COUNT_KINDS = ("two_clusters", "uniform", "galaxy", "one_cell", "faces",
               "padded")


@functools.cache
def count_bodies(kind: str):
    """(the active positions as the engines pass them, a float32 tensor
    (n_active, 3); the same as numpy; npad) of a distribution whose counts
    must be murb_tpu's exactly."""
    rng = np.random.default_rng(11)
    if kind == "galaxy":
        state = make_bodies(4000, "galaxy", device="cpu")
    elif kind == "padded":
        # 1,000 massive bodies among 1,500, padded to 4,096 rows: the
        # massless ones sit among the massive, inside the box
        q = clusters(1500, 2048, seed=3)[2]
        m = np.where(np.arange(1500) % 3 == 1, 0.0, 1e10)
        v = np.zeros(1500)
        state = BodyState.from_arrays(m, v + 1, *q.T, v, v, v,
                                      pad_multiple=4096, device="cpu")
    else:
        if kind == "two_clusters":
            q = clusters()[2]
        elif kind == "uniform":
            q = rng.uniform(-100, 100, (4000, 3))
        elif kind == "one_cell":     # one point: a box of side 2, one cell
            q = np.tile([3.5, -2.0, 7.25], (4000, 1))
        else:
            # on a lattice of step 1/8 in the box [0, 64]^3, which its
            # corners fix: every body on a face of its cell at C <= 512,
            # and those at 64 clipped into the last cell
            q = rng.integers(0, 513, (4000, 3)) * 0.125
            q[:2] = [[0.0] * 3, [64.0] * 3]
        v = np.zeros(4000)
        state = BodyState.from_arrays(np.ones(4000), v + 1, *q.T, v, v, v,
                                      device="cpu")
    u = state.unpadded()
    sel = u["m"] > 0
    q = np.stack([u["qx"][sel], u["qy"][sel], u["qz"][sel]], 1)
    return _active_positions(state), q.astype(np.float32), state.npad


@pytest.mark.parametrize("levels", range(3, 10))
@pytest.mark.parametrize("kind", COUNT_KINDS)
def test_counts_on_a_tensor_match_jax(kind, levels, monkeypatch):
    """The occupied cells per sparse level and the candidate brick pairs,
    counted in torch from the engines' tensor, are murb_tpu's numpy counts:
    with the default adjacency chunk, with chunks of three rows of the
    (B, B) adjacency, and from numpy input."""
    qt, q, npad = count_bodies(kind)
    assert torch.equal(qt, torch.from_numpy(q))
    want = jp.estimate_brick_pairs(q, npad, levels)
    assert tp.estimate_brick_pairs(qt, npad, levels) == want
    assert tp.estimate_brick_pairs(q, npad, levels) == want
    monkeypatch.setattr(tp, "ADJ_CHUNK", 3 * npad // tp.DEFAULT_K)
    assert tp.estimate_brick_pairs(qt, npad, levels) == want
    stats = js.level_stats(q, 2, levels)
    assert ts.level_stats(qt, 2, levels) == stats
    assert ts.level_stats(q, 2, levels) == stats
    if kind == "one_cell":
        assert stats == [1] * (levels - 2)


@pytest.mark.parametrize("rates", ["cpu", "cuda"])
def test_planner_on_a_tensor_matches_numpy(rates):
    """best_adaptive_plan and plan_adaptive on the engines' tensor give the
    plan and cost they give on numpy (murb_tpu's at the CPU's rates)."""
    qt, q, npad = count_bodies("two_clusters")
    plan, cost = ts.best_adaptive_plan(qt, npad, 6, device=rates)
    assert (plan, cost) == ts.best_adaptive_plan(q, npad, 6, device=rates)
    if rates == "cpu":
        jplan, jcost = js.best_adaptive_plan(q, npad, 6)
        assert (plan, cost) == (port_plan(jplan), jcost)
    assert ts.plan_adaptive(qt, npad, 6, plan.dense_levels, plan.levels,
                            device=rates) == plan

