"""The port's integrators and the engines built on them against murb_tpu's.

The phase functions take the same state and accelerations in both
packages, so their outputs agree to float32 rounding (tolerance 1e-6).
The engines step one carried state with their own sweeps (murb_tpu's
chunked XLA sweep, the port's chunked plain sweep on the CPU): positions
and velocities after several steps are held to WithinRel 1e-4 (rms floor
1e-4), an order below the reference's 1e-3 for the random scheme.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu.core import init as jinit
from murb_tpu.core import integrators as ji
from murb_tpu.models import create_engine as jcreate
from murb_tpu.ops.common import Accel as JAccel
from murb_tpu.ops.naive import acc_naive as jnaive
from murb_tpu_torch.core import integrators as ti
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine as tcreate
from murb_tpu_torch.ops.common import Accel
from murb_tpu_torch.ops.naive import acc_naive as tnaive

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0
STATE = ("qx", "qy", "qz", "vx", "vy", "vz")


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def same_state(t, j, eps, msg):
    for k in STATE:
        assert_within_rel(np.asarray(getattr(t, k)), np.asarray(getattr(j, k)),
                          eps, f"{msg} {k}", rms_floor=eps)


def test_leapfrog_phases_match_murb_tpu():
    js = jinit.init_galaxy(1024, 3)
    ts = carry(js)
    rng = np.random.default_rng(0)
    a = [rng.normal(size=js.npad).astype(np.float32) for _ in range(3)]
    ja, ta = JAccel(*map(jnp.asarray, a)), Accel(*map(torch.from_numpy, a))
    jst, jaux = ji.leapfrog_first(js, ji.LeapfrogAux.zeros_like(js), ja, DT)
    tst, taux = ti.leapfrog_first(ts, ti.LeapfrogAux.zeros_like(ts), ta, DT)
    same_state(tst, js, 0.0, "first keeps the visible state")
    for phase in (ti.leapfrog_middle, ti.leapfrog_middle):
        jst, jaux = getattr(ji, phase.__name__)(jst, jaux, ja, DT)
        tst, taux = phase(tst, taux, ta, DT)
        same_state(tst, jst, 1e-6, phase.__name__)
        for jv, tv in zip(jaux, taux):
            assert_within_rel(tv.numpy(), np.asarray(jv), 1e-6,
                              f"{phase.__name__} aux")
    jst, jaux = ji.leapfrog_last(jst, jaux)
    tst, taux = ti.leapfrog_last(tst, taux)
    same_state(tst, jst, 1e-6, "last")


@pytest.mark.parametrize("step", ["kdk_step", "yoshida4_step"])
def test_kdk_and_yoshida4_steps_match_murb_tpu(step):
    js = jinit.init_random(1024, 4)
    ts = carry(js)
    jgm = jnp.asarray(np.float32(6.67384e-11)) * js.m
    tgm = ts.m * float(np.float32(6.67384e-11))
    for _ in range(3):
        js = getattr(ji, step)(
            js, lambda x, y, z: jnaive(x, y, z, jgm, SOFT), DT)
        ts = getattr(ti, step)(
            ts, lambda x, y, z: tnaive(x, y, z, tgm, SOFT), DT)
    same_state(ts, js, 1e-5, step)


@pytest.mark.parametrize("tag", ["tpu+kdk", "tpu+yoshida4", "tpu+leapfrog",
                                 "gpu+leapfrog"])
@pytest.mark.parametrize("scheme,n", [("random", 2048), ("galaxy", 2049)])
def test_integrator_engines_match_murb_tpu(tag, scheme, n):
    js = jinit.SCHEMES[scheme](n, 4)
    kw = {"num_iterations": 5} if "leapfrog" in tag else {}
    je = jcreate(tag, js, soft=SOFT, dt=DT, **kw)
    te = tcreate(tag, carry(js), soft=SOFT, dt=DT, **kw)
    je.run(2)
    te.run(2)
    for _ in range(3):                 # then stepwise, through the last phase
        je.compute_one_iteration()
        te.compute_one_iteration()
    same_state(te.bodies, je.bodies, 1e-4, f"{tag} {scheme} n={n}")


def test_leapfrog_conserves_energy_better_than_euler():
    """The phase-split leapfrog's energy drift over 20 steps of the galaxy
    stays below explicit Euler's (murb_tpu tests/test_integrators.py:61)."""
    from murb_tpu_torch.core.metrics import total_energy

    s = carry(jinit.init_galaxy(512, 2))
    e0 = float(total_energy(s, SOFT))
    drift = {}
    for tag, kw in (("cpu+naive", {}), ("tpu+leapfrog",
                                        {"num_iterations": 21})):
        e = tcreate(tag, s, soft=SOFT, dt=DT * 10, **kw)
        e.run(20)
        drift[tag] = abs(float(total_energy(e.bodies, SOFT)) / e0 - 1.0)
    assert drift["tpu+leapfrog"] < drift["cpu+naive"], drift


def test_engines_wire_their_acc_fn_and_need_the_iteration_count():
    s = carry(jinit.init_random(256, 1))
    calls = []

    def spy(qx, qy, qz, gm, soft):
        calls.append(qx.shape[0])
        return tnaive(qx, qy, qz, gm, soft)

    for tag, per_step in (("tpu+kdk", 2), ("tpu+yoshida4", 3)):
        calls.clear()
        tcreate(tag, s, soft=SOFT, dt=DT, acc_fn=spy).run(2)
        assert calls == [256] * 2 * per_step, tag
    with pytest.raises(TypeError, match="num_iterations"):
        tcreate("tpu+leapfrog", s, soft=SOFT, dt=DT)
