"""The port's adaptive engines and CLI paths against murb_tpu's.

``ProxyEngine`` with the adaptive near field, the auto policy around it,
its capacity health, the tracked engines' fused adaptive step and the
CLI's ``--kernel adaptive``, ``--near adaptive`` and ``--kernel fmm``
hand-over, on the CPU.  The clustered state is tests/test_sparse_fmm.py's
``_cluster_bodies`` (two tight clusters, masses ~1e10 so that G m is of
order 1 and a few dt = 1e-3 steps move the bodies), built by murb_tpu and
carried into the port as numpy arrays.

Tolerances: the plans and orders exactly (through
``SparsePlan.from_fields``); final positions WithinRel 1e-4 with an rms
floor of 1e-4, as tests/test_torch_tracking.py holds them; tracked
histories within rtol 1e-5 (the proxy paths' tolerance there), |L| within
1e-4 (see RTOL).
"""
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu.core.state import BodyState as JState
from murb_tpu.models import create_engine as jcreate
from murb_tpu_torch import cli
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine as tcreate
from murb_tpu_torch.ops.sparse_fmm import SparsePlan

torch.set_num_threads(2)
SOFT, DT = 0.01, 1e-3
SERIES = ("energies", "ang_momentums", "density_centers")
#: |L| of this state cancels: its terms are about 30 times |L|, so the two
#: packages' 1e-6-class force differences read 3e-5 in it
RTOL = {"energies": 1e-5, "ang_momentums": 1e-4, "density_centers": 1e-5}


def cluster_bodies(n=2000, seed=7):
    rng = np.random.default_rng(seed)
    q = np.concatenate([
        rng.normal(0, 1.0, (n // 2, 3)) + [-50.0, 0.0, 0.0],
        rng.normal(0, 1.0, (n - n // 2, 3)) + [50.0, 10.0, -5.0],
    ]).astype(np.float32)
    v = rng.normal(0, 1e-3, (n, 3)).astype(np.float32)
    m = (rng.uniform(0.5, 2.0, n) * 1e10).astype(np.float32)
    return JState.from_arrays(m, np.ones(n, np.float32), q[:, 0], q[:, 1],
                              q[:, 2], v[:, 0], v[:, 1], v[:, 2])


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def same_positions(t, j, msg):
    a, b = t.bodies.unpadded(), j.bodies.unpadded()
    for k in ("qx", "qy", "qz"):
        assert_within_rel(a[k], b[k], 1e-4, f"{msg} {k}", rms_floor=1e-4)


@pytest.fixture(scope="module")
def adaptive_pair():
    """murb_tpu's and the port's ``tpu+proxy --near adaptive`` engines on the
    same state, validated, each after 3 steps."""
    js = cluster_bodies()
    j = jcreate("tpu+proxy", js, soft=SOFT, dt=DT, near="adaptive")
    t = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT, near="adaptive")
    plans = (j._plan, t._plan)
    for e in (j, t):
        e.run(3)
    return j, t, plans


def test_proxy_engine_adaptive_matches_jax(adaptive_pair):
    """The same plan and validated order, and the same trajectory."""
    j, t, (jplan, tplan) = adaptive_pair
    assert t.near_mode == j.near_mode == "adaptive" and t.using_proxy
    assert tplan == SparsePlan.from_fields(**jplan._asdict())
    assert (t.m, t.levels, t.cells) == (j.m, j.levels, j.cells)
    assert t.validated_err <= 1e-4 and t.validated_half is None
    assert abs(t.validated_err - j.validated_err) <= 1e-5
    same_positions(t, j, "tpu+proxy near=adaptive")
    t.assert_finite()


def test_proxy_engine_adaptive_health_contract(adaptive_pair):
    j, t, _ = adaptive_pair
    h = t.proxy_health()
    assert h["near"] == "adaptive" and h["ok"]
    assert h["required_m_now"] == t.m          # scale-free accuracy
    assert len(h["n_cells_now"]) == len(h["cell_caps"])
    assert h == j.proxy_health()
    # a plan whose capacities the distribution outgrew is not ok; a healthy
    # one is never re-planned
    plan = t._plan
    t._plan = plan._replace(cell_caps=(1,) * len(plan.cell_caps))
    assert not t.proxy_health()["ok"]
    t._plan = plan
    assert t.maybe_adapt() is False and t._plan is plan


def test_proxy_engine_auto_declines_adaptive_at_small_n():
    """near='auto' leaves the exact kernel only where the cost model says
    the adaptive solver wins; at 2k bodies it does not, as in murb_tpu
    (test_proxy_engine_auto_declines_adaptive_at_small_n)."""
    js = cluster_bodies()
    j = jcreate("tpu+proxy", js, soft=SOFT, dt=DT, near="auto")
    t = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT, near="auto")
    assert t.near_mode == j.near_mode == "interp"
    assert not t.using_proxy and not j.using_proxy
    e = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT, near="interp")
    assert e.near_mode == "interp" and e._plan is None
    with pytest.raises(ValueError, match="near mode"):
        tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT, near="p2p")


def test_proxy_engine_explicit_geometry():
    """m and levels given: the plan takes them (Ld = min(3, L - 1)) with no
    validation, in both packages."""
    js = cluster_bodies(1000, 3)
    j = jcreate("tpu+proxy", js, soft=SOFT, dt=DT, m=6, levels=5,
                near="adaptive")
    t = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT, m=6, levels=5,
                near="adaptive")
    assert t._plan == SparsePlan.from_fields(**j._plan._asdict())
    assert t._plan.dense_levels == 3 and t.validated_err is None


@pytest.mark.parametrize("tag", ["tpu+tracking", "tpu+leapfrog+tracking"])
def test_tracked_fused_adaptive_matches_jax(tag):
    from murb_tpu.ops.sparse_fmm import plan_adaptive

    js = cluster_bodies(1000, 5)
    u = js.unpadded()
    q = np.stack([u["qx"], u["qy"], u["qz"]], 1)
    plan = plan_adaptive(q, js.npad, 6, 2, 5)
    j = jcreate(tag, js, soft=SOFT, dt=DT, num_iterations=3,
                fused_adaptive=plan)
    t = tcreate(tag, carry(js), soft=SOFT, dt=DT, num_iterations=3,
                fused_adaptive=SparsePlan.from_fields(**plan._asdict()))
    for e in (j, t):
        e.run(3)
    for k in SERIES:
        np.testing.assert_allclose(getattr(t.history, k),
                                   getattr(j.history, k), rtol=RTOL[k],
                                   err_msg=f"{tag} {k}")
    same_positions(t, j, tag)
    assert t.proxy_health() == j.proxy_health()


def test_multi_galaxy_engine_refuses_fused_adaptive():
    s = carry(cluster_bodies(500, 1))
    masks = [np.ones(s.n, np.float32)]
    plan = SparsePlan(m=6, dense_levels=2, levels=4, cell_caps=(64, 64),
                      p2p_pmax=1024)
    with pytest.raises(ValueError, match="ADAPTIVE solver stays rejected"):
        tcreate("tpu+tracking+multi", s, soft=SOFT, dt=DT, num_iterations=2,
                masks=masks, fused_adaptive=plan)


# ----------------------------------------------------------------- CLI
# -s random with a softening 200 times below the default: the proxy would
# need m > 32 and the hierarchy m > 16, so --kernel proxy / fmm hand over;
# --tol 1e-3 starts the adaptive ladder at m = 6, which keeps the CPU quick
WIDE = ["-n", "1024", "-i", "2", "-s", "random", "--soft", "1e6", "--tol",
        "1e-3", "--nv", "--device", "cpu"]


@pytest.mark.parametrize("kernel", ["fmm", "adaptive"])
def test_cli_kernel_adaptive_fuses_the_tracked_step(kernel, capsys):
    res = cli.run([*WIDE, "--im", "tpu+tracking", "--kernel", kernel])
    assert res.rc == 0
    out = capsys.readouterr().out
    assert ("using the adaptive sparse kernel" in out) == (kernel == "fmm")
    plan = res.engine._fused_adaptive
    assert plan is not None and plan.p2p_impl == "plain"
    assert res.engine.proxy_health()["ok"]
    assert np.isfinite(res.engine.history.energies).all()
    res.engine.assert_finite()


def test_cli_kernel_adaptive_wraps_the_kdk_engine():
    from murb_tpu_torch.ops import make_acc_fn

    res = cli.run([*WIDE, "--im", "tpu+kdk", "--kernel", "adaptive"])
    assert res.rc == 0
    res.engine.assert_finite()
    assert res.engine._acc.keywords["plan"].levels >= 3
    with pytest.raises(ValueError, match="SparsePlan"):
        make_acc_fn("adaptive")


def test_cli_near_adaptive_runs_the_adaptive_solver(capsys):
    res = cli.run([*WIDE, "--im", "tpu+proxy", "--near", "adaptive"])
    assert res.rc == 0
    e = res.engine
    assert e.near_mode == "adaptive" and e.validated_err <= 1e-3
    assert "adaptive m=" in capsys.readouterr().out
    e.assert_finite()
    res = cli.run([*WIDE, "--im", "tpu+proxy", "--near", "interp"])
    assert res.rc == 0 and res.engine.near_mode == "interp"
