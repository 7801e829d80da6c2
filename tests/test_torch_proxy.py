"""The port's Chebyshev proxy and order validation against murb_tpu's.

One JAX state per case is carried into the port with
``BodyState.from_numpy``; both packages run their own proxy on it.  The
statistic between them is ``measured_force_error``'s (max per-body vector
error over max(|a|, 1e-6 max|a|)), held to 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu.models import create_engine as jcreate
from murb_tpu.ops import proxy as jp
from murb_tpu.ops import validate as jv
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine as tcreate
from murb_tpu_torch.ops import fmm as tfmm
from murb_tpu_torch.ops import naive as tn
from murb_tpu_torch.ops import proxy as tp
from murb_tpu_torch.ops import validate as tv

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def force_stat(got, ref) -> float:
    """ops/validate's statistic between two (ax, ay, az) triples."""
    g = np.stack([np.asarray(v, np.float64) for v in got], 1)
    r = np.stack([np.asarray(v, np.float64) for v in ref], 1)
    rn = np.linalg.norm(r, axis=1)
    floor = np.maximum(rn, rn.max() * 1e-6)
    return float((np.linalg.norm(g - r, axis=1) / floor).max())


@pytest.fixture(scope="module")
def galaxy2048():
    js = jinit.init_galaxy(2048, 123)
    jgm = jnp.asarray(G, js.qx.dtype) * js.m
    ts = carry(js)
    tgm = torch.from_numpy(np.array(jgm))
    return js, jgm, ts, tgm


@pytest.mark.parametrize("m", [12, 16])
def test_acc_proxy_matches_jax(galaxy2048, m):
    js, jgm, ts, tgm = galaxy2048
    ref = jp.acc_proxy(js.qx, js.qy, js.qz, jgm, SOFT, m=m)
    got = tp.acc_proxy(ts.qx, ts.qy, ts.qz, tgm, SOFT, m=m)
    err = force_stat([v.numpy() for v in got], ref)
    assert err <= 1e-4, f"port vs JAX acc_proxy m={m}: {err:.2e} (tol 1e-4)"


def test_heavy_body_force_is_exact(galaxy2048):
    js, jgm, ts, tgm = galaxy2048
    got = tp.acc_proxy(ts.qx, ts.qy, ts.qz, tgm, SOFT, m=12)
    ref = tn.acc_naive(ts.qx, ts.qy, ts.qz, tgm, SOFT)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g[0]), float(r[0]), rtol=1e-4,
                                   err_msg="heavy body 0 (rtol 1e-4)")


def test_stages_match_jax(galaxy2048):
    js, jgm, ts, tgm = galaxy2048
    jc, jh = jp.bounding_box(js.qx, js.qy, js.qz, jgm > 0)
    tc, th = tp.bounding_box(ts.qx, ts.qy, ts.qz, tgm > 0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    mean = float(jnp.sum(jgm) / jnp.sum(jgm > 0))
    jhs = jp.heavy_split(js.qx, js.qy, js.qz, jgm, 1, 100.0, mean)
    ths = tp.heavy_split(ts.qx, ts.qy, ts.qz, tgm, 1, 100.0,
                         torch.tensor(mean))
    assert int(ths[3][0]) == int(jhs[3][0]) == 0
    assert bool(ths[2][0]) and bool(jhs[2][0])
    np.testing.assert_array_equal(ths[4].numpy(), np.asarray(jhs[4]))
    for m in (4, 9, 12):
        jn = jp.proxy_nodes(jc, jh, m, jnp.float32)
        tnodes = tp.proxy_nodes(tc, th, m, torch.float32)
        for a, b in zip(tnodes, jn):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_node_sweep_routes_large_grids_to_k3(monkeypatch):
    """At NODE_SWEEP_KERNEL_MIN nodes or more the node sweep is K3's
    wrapper (murb_tpu/ops/proxy.py:175-191); below it the broadcast."""
    calls = []
    real = tp.acc_tile_rect

    def spy(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(tp, "acc_tile_rect", spy)
    g = torch.Generator().manual_seed(0)
    p = [torch.randn(600, generator=g) * 1e8 for _ in range(3)]
    w = torch.rand(600, generator=g) * 1e10
    small = tp.node_sweep(*p, w, SOFT)
    assert calls == []
    monkeypatch.setattr(tp, "NODE_SWEEP_KERNEL_MIN", 500)
    big = tp.node_sweep(*p, w, SOFT)
    assert calls == [600]
    for a, b in zip(big, small):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-30)


def test_measured_error_of_exact_sweep_is_small(galaxy2048):
    js, jgm, ts, tgm = galaxy2048
    err = tv.measured_force_error(
        ts.qx, ts.qy, ts.qz, tgm, SOFT,
        lambda a, b, c, g: tn.acc_naive(a, b, c, g, SOFT))
    assert err < 1e-5
    jerr = jv.measured_force_error(
        js.qx, js.qy, js.qz, jgm, SOFT,
        lambda a, b, c, g: jp.acc_proxy(a, b, c, g, SOFT, m=12))
    terr = tv.measured_force_error(
        ts.qx, ts.qy, ts.qz, tgm, SOFT,
        lambda a, b, c, g: tp.acc_proxy(a, b, c, g, SOFT, m=12))
    assert abs(terr - jerr) <= 0.1 * jerr + 1e-6, (terr, jerr)


def test_validate_config_picks_what_jax_picks(galaxy2048):
    js, jgm, ts, tgm = galaxy2048
    half = jp.half_extent(js.unpadded())
    assert tp.half_extent(ts.unpadded()) == half
    jpick = jv.validate_config(
        js.qx, js.qy, js.qz, jgm, SOFT, 1e-4, 16, 0, 1, half,
        lambda m, lv, c: (lambda a, b, cc, g: jp.acc_proxy(
            a, b, cc, g, SOFT, m=m, cells=c)))
    tpick = tv.validate_config(
        ts.qx, ts.qy, ts.qz, tgm, SOFT, 1e-4, 16, 0, 1, half,
        lambda m, lv, c: (lambda a, b, cc, g: tp.acc_proxy(
            a, b, cc, g, SOFT, m=m, cells=c)))
    assert tpick[:3] == jpick[:3], (tpick, jpick)
    assert tpick[3] <= 1e-4


@pytest.mark.parametrize("n,seed", [(2048, 123), (2049, 4)])
def test_auto_policy_picks_what_jax_picks(n, seed):
    js = jinit.init_galaxy(n, seed)
    je = jcreate("tpu+proxy", js, soft=SOFT, dt=DT)
    te = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT)
    assert (te.m, te.levels, te.cells, te.using_proxy) == \
        (je.m, je.levels, je.cells, je.using_proxy)
    assert te.validated_err <= te.tol and je.validated_err <= je.tol
    assert te.validated_half == pytest.approx(je.validated_half, rel=0.05)
    health = te.proxy_health()
    assert health["ok"] and health["m"] == te.m
    assert te.maybe_adapt() is False


def test_wide_box_runs_the_lossy_tiers_and_p2p():
    """The random box takes the multi-level hierarchy: its lossy M2L tiers
    run (within 1e-5 of murb_tpu's acc_fmm at the tier, which its CPU
    computes in fp32; the port's lossy arithmetic adds about 1e-7), and so
    does the exact P2P near field: within 1e-5 of murb_tpu's
    ``near="p2p"`` on the same state and capacity (fp32 sums in another
    order)."""
    from murb_tpu.ops import fmm as jfmm
    from murb_tpu.ops.p2p import estimate_brick_pairs, size_pmax

    js = jinit.init_random(2048, 1)
    ts = carry(js)
    jgm = jnp.asarray(G, js.qx.dtype) * js.m
    for tier in ("bf16x3", "mixed"):
        ref = jfmm.acc_fmm(js.qx, js.qy, js.qz, jgm, SOFT, m=8, levels=2,
                           m2l_dots=tier)
        got = tfmm.acc_fmm(ts.qx, ts.qy, ts.qz,
                           torch.from_numpy(np.array(jgm)), SOFT, m=8,
                           levels=2, m2l_dots=tier)
        err = force_stat([v.numpy() for v in got], ref)
        assert err <= 1e-5, f"port vs JAX acc_fmm {tier}: {err:.2e}"
    u = js.unpadded()
    q = np.stack([u["qx"], u["qy"], u["qz"]], 1)
    pmax = size_pmax(estimate_brick_pairs(q, js.npad, 2))
    ref = jfmm.acc_fmm(js.qx, js.qy, js.qz, jgm, SOFT, m=8, levels=2,
                       near="p2p", p2p_pmax=pmax)
    got = tfmm.acc_fmm(ts.qx, ts.qy, ts.qz, torch.from_numpy(np.array(jgm)),
                       SOFT, m=8, levels=2, near="p2p", p2p_pmax=pmax)
    err = force_stat([v.numpy() for v in got], ref)
    assert err <= 1e-5, f"port vs JAX acc_fmm near=p2p: {err:.2e}"
    e = tcreate("tpu+proxy", ts, soft=SOFT, dt=DT, m=8, cells=2)
    assert (e.m, e.levels, e.cells, e.using_proxy) == (8, 0, 2, True)
    e.run(1)
    e.assert_finite()


def test_ladder_into_hierarchy_raises_not_yet_ported(monkeypatch, capsys):
    """A miss at m=20 escalates to the hierarchy, whose rungs the port now
    runs (acc_fmm): with every rung missing tol the engine keeps the best
    config tried, as murb_tpu does, and warns."""
    js = jinit.init_galaxy(512, 3)
    e = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT, m=20)
    je = jcreate("tpu+proxy", js, soft=SOFT, dt=DT, m=20)

    def falling(mod):
        errs = iter(np.linspace(1e-2, 2e-3, 6))
        monkeypatch.setattr(mod, "measured_force_error",
                            lambda *a, **k: float(next(errs)))

    falling(tv)
    e._validate_order(6e8)
    falling(jv)
    je._validate_order(6e8)
    assert (e.m, e.levels, e.cells) == (je.m, je.levels, je.cells)
    assert e.levels >= 2 and e.validated_err == pytest.approx(2e-3)
    assert "WARNING" in capsys.readouterr().out


@pytest.mark.parametrize("half", [1.5e8, 3e8, 6.65e8, 2e9])
def test_order_helpers_match_jax(half):
    from murb_tpu.ops import fmm as jfmm

    for tol in (1e-3, 1e-4, 1e-6):
        for margin in (0, 2):
            assert tp.required_order(half, SOFT, tol, margin) == \
                jp.required_order(half, SOFT, tol, margin)
        assert tfmm.required_levels(half, SOFT) == \
            jfmm.required_levels(half, SOFT)
        for lv in (1, 2, 3):
            assert tfmm.fmm_order(half, SOFT, lv, tol) == \
                jfmm.fmm_order(half, SOFT, lv, tol)
    assert tfmm.FMM_ERR_PREFACTOR == jfmm.FMM_ERR_PREFACTOR


@pytest.mark.parametrize("cfg", [(16, 0, 1), (20, 0, 1), (8, 0, 2),
                                 (10, 2, 1), (12, 2, 1), (12, 4, 1),
                                 (6, 3, 1)])
def test_ladder_rungs_match_jax(cfg):
    m, lv, c = cfg
    for half in (2e8, 6e8, 3e9):
        assert tv.escalate_config(m, lv, c, half, SOFT, 1e-4) == \
            jv.escalate_config(m, lv, c, half, SOFT, 1e-4)
        for err in (1e-12, 1e-6, 1e-4, 1e-3):
            assert tv.certified_half(m, lv, half, err, SOFT, 1e-4) == \
                jv.certified_half(m, lv, half, err, SOFT, 1e-4)
    assert tv.descend_config(m, lv, c) == jv.descend_config(m, lv, c)


def test_validate_config_warns_and_keeps_best(capsys):
    errs = {8: 3e-3, 12: 2e-3}

    def fake(qx, qy, qz, gm, soft, cfg, sample=512):
        return errs.get(cfg[0], 1.0)

    real = tv.measured_force_error
    tv.measured_force_error = fake
    try:
        pick = tv.validate_config(None, None, None, None, SOFT, 1e-12, 8, 0,
                                  1, 2e8, lambda m, lv, c: (m, lv, c),
                                  max_trials=2)
    finally:
        tv.measured_force_error = real
    assert pick == (12, 0, 1, 2e-3)
    assert "WARNING" in capsys.readouterr().out
