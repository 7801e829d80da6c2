"""The port's engines against murb_tpu's, step by step on one state.

The reference's differential cases (tests/test_engines_differential.py):
N = 2048 and 2049, WithinRel 1e-3 on positions for the random scheme and
1e-1 for the chaotic galaxy scheme against the naive oracle.  The port's
proxy is also held to murb_tpu's proxy on the same state (1e-4, same m).
"""
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu.core import init as jinit
from murb_tpu.models import create_engine as jcreate
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine as tcreate
from murb_tpu_torch.ops.hybrid import acc_hybrid

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def run_pair(ref, tgt, n_ite, eps, msg):
    for i in range(n_ite + 1):
        if i > 0:
            ref.compute_one_iteration()
            tgt.compute_one_iteration()
        a, b = ref.bodies.unpadded(), tgt.bodies.unpadded()
        e = eps if i > 0 else 0.0
        for c in ("qx", "qy", "qz"):
            assert_within_rel(b[c], a[c], e,
                              f"{msg} iter {i} {c} (WithinRel {e})")


@pytest.mark.parametrize("n,n_ite", [(2048, 4), (2049, 3)])
def test_proxy_matches_jax_proxy_and_naive(n, n_ite):
    js = jinit.init_galaxy(n, 123)
    jp = jcreate("tpu+proxy", js, soft=SOFT, dt=DT)
    tp = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT)
    assert tp.using_proxy and tp.m == jp.m
    run_pair(jp, tp, n_ite, 1e-4, f"proxy vs JAX proxy n={n}")
    jn = jcreate("cpu+naive", js, soft=SOFT, dt=DT)
    tp2 = tcreate("fmm", carry(js), soft=SOFT, dt=DT)
    run_pair(jn, tp2, n_ite, 1e-1, f"proxy vs JAX naive n={n}")


CASES = [(2048, 1, "random", 1e-3), (2049, 3, "random", 1e-3),
         (2049, 3, "galaxy", 1e-1)]


@pytest.mark.parametrize("tag", ["tpu+hybrid", "gpu+tile+full",
                                 "tpu+hybrid+fast", "tpu+hybrid+x3",
                                 "tpu+tile", "gpu+tile", "xla+chunked"])
@pytest.mark.parametrize("n,n_ite,scheme,eps", CASES)
def test_exact_engines_match_jax_naive(tag, n, n_ite, scheme, eps):
    js = jinit.SCHEMES[scheme](n, 123)
    ref = jcreate("cpu+naive", js, soft=SOFT, dt=DT)
    tgt = tcreate(tag, carry(js), soft=SOFT, dt=DT)
    run_pair(ref, tgt, n_ite, eps, f"{tag} {scheme} n={n}")


def test_naive_engine_matches_jax_naive_closely():
    js = jinit.init_random(2049, 5)
    run_pair(jcreate("cpu+naive", js, soft=SOFT, dt=DT),
             tcreate("cpu+naive", carry(js), soft=SOFT, dt=DT), 3, 1e-5,
             "naive vs JAX naive")


def test_fp64_state_is_honest():
    import jax.numpy as jnp

    js = jinit.init_random(2048, 7).astype(jnp.float64)
    t = tcreate("tpu+hybrid", carry(js), soft=SOFT, dt=DT)
    assert t.passes == 3 and t.bodies.dtype == torch.float64
    run_pair(jcreate("cpu+naive", js, soft=SOFT, dt=DT),
             tcreate("cpu+naive", carry(js), soft=SOFT, dt=DT), 2, 1e-12,
             "fp64 naive vs JAX fp64 naive")


def test_exact_fallback_when_cost_model_rejects_the_proxy():
    """Small N: the node work would dominate, so the engine takes the
    fp32-class K4 sweep (murb_tpu/models/engines.py:767-772).  Both
    packages try the adaptive planner before that fallback, and on this
    state both decline it."""
    js = jinit.init_galaxy(256, 3)
    j = jcreate("tpu+proxy", js, soft=SOFT, dt=DT)
    assert not j.using_proxy and j.near_mode == "interp"
    t = tcreate("tpu+proxy", carry(js), soft=SOFT, dt=DT)
    assert not t.using_proxy and t.validated_err is None
    assert t.near_mode == "interp" and t._plan is None
    assert t.proxy_health()["ok"]
    st = t.bodies
    gm = t._gm(st)
    got = t._acc_fn(st.qx, st.qy, st.qz, gm)
    ref = acc_hybrid(st.qx, st.qy, st.qz, gm, SOFT, passes=2)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    run_pair(jcreate("cpu+naive", js, soft=SOFT, dt=DT), t, 3, 1e-3,
             "exact fallback vs JAX naive")


def test_engine_basics():
    s = carry(jinit.init_random(256, 1))
    e = tcreate("cpu+nop", s, soft=SOFT, dt=DT)
    before = e.bodies.to_numpy()
    e.compute_one_iteration()
    e.run(3)
    np.testing.assert_array_equal(before["qx"], e.bodies.qx.numpy())
    from murb_tpu_torch.models.engines import NaiveEngine

    with pytest.raises(TypeError, match="unknown engine option"):
        NaiveEngine(s, soft=SOFT, dt=DT, nonsense=1)
    e = tcreate("cpu+naive", s, soft=SOFT, dt=DT)
    with pytest.raises(RuntimeError):
        e.accelerations
    e.run(2)
    assert e.accelerations.ax.shape == (256,)
    e.assert_finite()
    e.block_until_ready()
    # the engine owns a copy: the caller's state is untouched
    np.testing.assert_array_equal(s.qx.numpy(), before["qx"])
    e.bodies.qx[0] = float("nan")
    with pytest.raises(FloatingPointError, match="qx"):
        e.assert_finite()
    assert e.flops_per_ite == 20 * 256 * 256


def test_registry_matches_jax_for_the_slice():
    from murb_tpu.models import available_implementations as javail
    from murb_tpu_torch.models import available_implementations as tavail
    from murb_tpu_torch.models import resolve_tag, validate_tag

    j, t = javail(), tavail()
    for tag, aliases in t.items():
        assert set(aliases) == set(j[tag]), tag
    for tag in set(j) - set(t):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            validate_tag(tag)
    with pytest.raises(ValueError, match="does not exist"):
        validate_tag("no+such")
    assert resolve_tag("barnes-hut") == "tpu+proxy"
