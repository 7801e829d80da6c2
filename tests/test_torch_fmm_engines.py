"""The port's hierarchy engines against murb_tpu's: the ``tpu+proxy`` auto
policy on the random box, explicit ``levels=``, the validation ladder's
hierarchy rung, the tracked ``fused_fmm`` engines and the CLI.

One state per case is built with ``murb_tpu.core.init`` and carried into
the port as numpy arrays.  murb_tpu runs its jnp stages on the CPU (its
fused Pallas stages exist only on the TPU).  Tolerances: the same picks
exactly; positions WithinRel 1e-3 with an rms floor of 1e-6 (the random
scheme's tolerance, tests/test_fmm.py:428-441); tracked histories within
1e-5 relative (murb_tpu's own tracked tests use 1e-5).
"""
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu.core import init as jinit
from murb_tpu.models import create_engine as jcreate
from murb_tpu.ops import fmm as jfmm
from murb_tpu.ops.naive import acc_naive as jnaive
from murb_tpu.ops.proxy import half_extent as jhalf
from murb_tpu_torch import cli
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine as tcreate
from murb_tpu_torch.ops import fmm as tfmm
from murb_tpu_torch.ops import fmm_kernels as tk
from murb_tpu_torch.ops.common import Accel
from murb_tpu_torch.ops.naive import acc_naive as tnaive
from murb_tpu_torch.ops.proxy import half_extent

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0
SERIES = ("energies", "ang_momentums", "density_centers")


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


@pytest.fixture(scope="module")
def random200k():
    return jinit.init_random(200_000, 1)


def same_history(t, j, rtol, msg):
    for k in SERIES:
        ref = getattr(j, k)
        np.testing.assert_allclose(getattr(t, k), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max(),
                                   err_msg=f"{msg} {k} (rtol {rtol})")


# ---------------------------------------------------------- the auto policy
def test_auto_policy_picks_the_hierarchy_on_the_200k_random_box(random200k):
    """validate=False: the static policy pick (a validated pick would run a
    full 200k solve on the CPU).  murb_tpu picks (m=8, L=2) there."""
    je = jcreate("tpu+proxy", random200k, soft=SOFT, dt=DT, validate=False)
    te = tcreate("tpu+proxy", carry(random200k), soft=SOFT, dt=DT,
                 validate=False)
    assert (te.m, te.levels, te.cells, te.using_proxy) == \
        (je.m, je.levels, je.cells, je.using_proxy) == (8, 2, 1, True)
    assert te.validated_err is None


def test_depth_cost_tradeoff_holds(random200k):
    """tests/test_fmm.py:test_proxy_engine_depth_cost_tradeoff in the port:
    the tie keeps the shallow grid, a box twice as wide deepens past
    required_levels with a lower order."""
    te = tcreate("tpu+proxy", carry(random200k), soft=SOFT, dt=DT,
                 validate=False)
    je = jcreate("tpu+proxy", random200k, soft=SOFT, dt=DT, validate=False)
    half = half_extent(te.bodies.unpadded())
    assert half == jhalf(random200k.unpadded())
    assert te.levels == tfmm.required_levels(half, SOFT)
    wide = 2.0 * half
    lmin = tfmm.required_levels(wide, SOFT)
    m_w, l_w = te._best_depth(wide)
    assert (m_w, l_w) == je._best_depth(wide)
    assert l_w > lmin
    assert m_w == tfmm.fmm_order(wide, SOFT, l_w) < \
        tfmm.fmm_order(wide, SOFT, lmin)


@pytest.mark.parametrize("scheme,n,seed", [("random", 2048, 1),
                                           ("galaxy", 2048, 5)])
def test_small_boxes_match_jax(scheme, n, seed):
    """Random N=2048: the cost model rejects the hierarchy (exact sweep);
    galaxy N=2048: one global expansion, validated."""
    js = jinit.SCHEMES[scheme](n, seed)
    je = jcreate("tpu+proxy", js, soft=SOFT, dt=DT)
    te = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT)
    assert (te.m, te.levels, te.cells, te.using_proxy) == \
        (je.m, je.levels, je.cells, je.using_proxy)
    if scheme == "random":
        assert not te.using_proxy
    else:
        assert te.levels == 0 and te.cells == 1 and te.using_proxy


# --------------------------------------------------- the hierarchy rung
def _scaled_exact(naive, errs):
    """An acc_fmm stand-in whose error is errs[(m, levels)]: the exact
    forces scaled by 1 + err, so the measured error is err."""
    def fake(qx, qy, qz, gm, soft, *, m, levels, **kw):
        a = naive(qx, qy, qz, gm, soft)
        e = errs[(m, levels)]
        return type(a)(*(v * (1.0 + e) for v in a))

    return fake


@pytest.mark.parametrize("start,errs,pick", [
    # a miss escalates by 2 orders to m=12, then one level deeper
    ((8, 2), {(8, 2): 3e-4, (10, 2): 2e-4, (12, 2): 1.5e-4,
              (None, 3): 5e-5}, None),
    # a first pass descends while the error holds, floor m=6
    ((10, 2), {(10, 2): 1e-5, (8, 2): 2e-5, (6, 2): 5e-4}, (8, 2)),
])
def test_validation_ladder_hierarchy_rung_matches_jax(monkeypatch, start,
                                                      errs, pick):
    js = jinit.init_random(1024, 6)
    te = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT, m=start[0],
                 levels=start[1])
    je = jcreate("tpu+proxy", js, soft=SOFT, dt=DT, m=start[0],
                 levels=start[1])
    half = half_extent(te.bodies.unpadded())
    m3 = max(tfmm.fmm_order(half, SOFT, 3), 6)    # escalate_config's rung
    errs = {(m3 if m is None else m, lv): e for (m, lv), e in errs.items()}
    monkeypatch.setattr(tfmm, "acc_fmm", _scaled_exact(tnaive, errs))
    monkeypatch.setattr(jfmm, "acc_fmm", _scaled_exact(jnaive, errs))
    te._validate_order(half)
    je._validate_order(half)
    assert (te.m, te.levels) == (je.m, je.levels) == (pick or (m3, 3))
    # the stand-ins scale each package's own fp32 exact sweep: their
    # measured errors differ by that sweep's rounding (about 1e-6)
    assert te.validated_err == pytest.approx(je.validated_err, rel=0.05)
    assert te.validated_half == pytest.approx(je.validated_half, rel=0.05)


# ------------------------------------------------ explicit hierarchy runs
def test_explicit_levels_trajectory_matches_jax():
    js = jinit.init_random(1024, 1)
    je = jcreate("tpu+proxy", js, soft=SOFT, dt=DT, m=8, levels=2)
    te = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT, m=8, levels=2)
    assert (te.m, te.levels, te.using_proxy) == (8, 2, True)
    for i in range(3):
        je.compute_one_iteration()
        te.compute_one_iteration()
        a, b = je.bodies.unpadded(), te.bodies.unpadded()
        for c in ("qx", "qy", "qz"):
            assert_within_rel(b[c], a[c], 1e-3, f"fmm iter {i} {c}",
                              rms_floor=1e-6)


def test_proxy_health_reports_fmm_mode():
    js = jinit.init_random(1024, 1)
    te = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT, m=12, levels=2)
    je = jcreate("tpu+proxy", js, soft=SOFT, dt=DT, m=12, levels=2)
    h = te.proxy_health()
    assert h == je.proxy_health()
    assert h["levels"] == 2 and h["using_proxy"] and h["ok"]
    assert h["required_m_now"] == tfmm.fmm_order(
        half_extent(te.bodies.unpadded()), SOFT, 2)


def test_acc_fn_counts_no_launch_on_the_cpu():
    """On CPU tensors the wrappers run their plain versions and count
    nothing: the counts are launches of the kernels."""
    js = jinit.init_random(1024, 1)
    te = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT, m=6, levels=3)
    for fn in (tk.p2m_grid_fused, tk.m2l_level_fused, tk.l2p_grid_fused):
        fn.launches = 0
    te.run(1)
    assert (tk.p2m_grid_fused.launches, tk.m2l_level_fused.launches,
            tk.l2p_grid_fused.launches) == (0, 0, 0)
    assert isinstance(te.accelerations, Accel)


# --------------------------------------------------------- tracked engines
@pytest.mark.parametrize("tag", ["tpu+tracking", "tpu+leapfrog+tracking"])
def test_tracked_fused_fmm_matches_jax(tag):
    js = jinit.init_random(1024, 2)
    kw = dict(soft=SOFT, dt=DT, num_iterations=4, fused_fmm=(8, 2))
    je = jcreate(tag, js, **kw)
    te = tcreate(tag, carry(js), **kw)
    je.run(4)
    te.run(4)
    same_history(te.history, je.history, 1e-5, tag)
    assert te.proxy_health() == je.proxy_health()
    assert te.proxy_health()["levels"] == 2


def test_multi_galaxy_fused_fmm_matches_jax():
    js = jinit.init_random(1024, 8)
    npad, n = js.npad, js.n
    masks = [np.zeros(npad, np.float32), np.zeros(npad, np.float32)]
    masks[0][: n // 2] = 1.0
    masks[1][n // 2: n] = 1.0
    kw = dict(soft=SOFT, dt=DT, num_iterations=3, masks=masks,
              fused_fmm=(6, 2))
    je = jcreate("tpu+tracking+multi", js, **kw)
    te = tcreate("tpu+tracking+multi", carry(js), **kw)
    je.run(3)
    te.run(3)
    for g, (ht, hj) in enumerate(zip(te.history.galaxies,
                                     je.history.galaxies)):
        same_history(ht, hj, 1e-5, f"galaxy {g}")


# --------------------------------------------------------------------- CLI
@pytest.mark.parametrize("argv", [
    ["--im", "tpu+proxy"],
    ["--im", "tpu+proxy", "--m2l-dots", "fp32"],
    ["--im", "tpu+tracking", "--kernel", "fmm"],
    ["--im", "tpu+kdk", "--kernel", "fmm"],
])
def test_cli_random_scheme_runs(argv, capsys):
    res = cli.run(["-n", "2048", "-i", "3", "-s", "random", "--nv",
                   "--device", "cpu", *argv])
    assert res.rc == 0
    res.engine.assert_finite()
    out = capsys.readouterr().out
    assert "Entire simulation took" in out
    if "tpu+tracking" in argv:
        assert res.engine._fused_fmm[1] >= 1
        assert res.engine.proxy_health()["ok"]


def test_cli_proxy_kernel_escalates_to_fmm(capsys):
    """``--kernel proxy`` on the random box needs m > 32: murb_tpu's CLI
    hands over to the hierarchy (cli.py:90-106), validated, and fuses it
    into the tracked step."""
    res = cli.run(["-n", "1024", "-i", "2", "-s", "random", "--nv",
                   "--device", "cpu", "--im", "tpu+leapfrog+tracking",
                   "--kernel", "proxy"])
    assert res.rc == 0
    assert "using the multi-level fmm kernel" in capsys.readouterr().out
    m, levels = res.engine._fused_fmm
    assert levels >= 2 and res.engine._fused_proxy_m == 0
    assert res.engine._validated_half is not None


@pytest.mark.parametrize("tier", ["bf16x3", "mixed"])
def test_cli_lossy_m2l_tiers_run(tier, capsys):
    """``--m2l-dots`` reaches the engine: the tier the hierarchy would
    run (at N=512 the cost model keeps the exact sweep)."""
    res = cli.run(["-n", "512", "-i", "1", "-s", "random", "--nv",
                   "--device", "cpu", "--im", "tpu+proxy", "--m2l-dots",
                   tier])
    assert res.rc == 0
    res.engine.assert_finite()
    assert res.engine.m2l_dots == tier
    assert "Entire simulation took" in capsys.readouterr().out


def test_profile_step_takes_a_scheme(monkeypatch, capsys):
    from murb_tpu_torch.utils import profile_step

    assert profile_step.main(["--scheme", "random", "bogus"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_step.main(["--scheme", "random", "tpu+proxy"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        profile_step.main(["--scheme", "plummer"])
