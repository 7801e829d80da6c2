"""The comparison passes the program as it is and fails it broken: the run
skips the look for a card and drives the rest of a run on the CPU at 2048
bodies, once sound, once for each fault a cell can have, and once as the
control (the program's own bf16 state).  One card, so no exchange between
chips to leave out."""
import dataclasses

import pytest

from conftest import cpu_run

#: the cells, the adaptive one with its solver forced at this size
CELLS = {
    "galaxy200k.exact": None,
    "clusters1m.adaptive": {"engine": {"near": "adaptive",
                                       "adapt_every": 64}},
}


def _unchanged(engine):
    """A step that returns its state unchanged."""
    real = engine._step
    engine._step = lambda st: (st, real(st)[1])


def _half_batch(engine):
    """Half of the bodies left out of the force, the rest counted double
    (the mean taken over the rest)."""
    real = engine._acc_fn

    def acc(qx, qy, qz, gm):
        g = gm.clone()
        g[1::2] = 0
        return real(qx, qy, qz, 2 * g)

    engine._acc_fn = acc


def _altered(engine):
    """One body's answer altered where the step produces it: its x moved
    by a relative 1e-4 in every new state."""
    real = engine._step
    k = engine.bodies.n // 3

    def step(st):
        new, acc = real(st)
        qx = new.qx.clone()
        qx[k] = qx[k] * (1 + 1e-4)
        return dataclasses.replace(new, qx=qx), acc

    engine._step = step


def _bad_tile(engine):
    """One 128-row tile's accelerations off by a relative 1e-3 where they
    are produced, and the step's update made with them."""
    real = engine._acc_fn

    def acc(qx, qy, qz, gm):
        out = real(qx, qy, qz, gm)
        for a in out:
            a[640:768] *= 1 + 1e-3
        return out

    engine._acc_fn = acc


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res, _ = cpu_run(cell, overrides=CELLS[cell])
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered,
                                   _bad_tile],
                         ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(cell, fault):
    res, _ = cpu_run(cell, overrides=CELLS[cell], hook=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_not_correct(cell):
    over = dict(CELLS[cell] or {}, precision="bfloat16")
    res, _ = cpu_run(cell, overrides=over)
    assert not res["correct"], res["checks"]
    assert res["checks"]["update_ulp"]["value"] > 1000


def test_a_frame_that_raises_fails_the_run():
    def boom(engine):
        real, calls = engine._step, []

        def step(st):
            calls.append(1)
            if len(calls) > 12:
                raise FloatingPointError("planted")
            return real(st)

        engine._step = step

    res, _ = cpu_run("galaxy200k.exact", hook=boom, seconds=5.0)
    assert not res["correct"] and res["failed"] == 1


def test_a_non_finite_frame_fails_the_run():
    def nan(engine):
        real = engine._step

        def step(st):
            new, acc = real(st)
            qy = new.qy.clone()
            qy[5] = float("nan")
            return dataclasses.replace(new, qy=qy), acc

        engine._step = step

    res, _ = cpu_run("galaxy200k.exact", hook=nan)
    assert not res["correct"] and res["failed"] == res["attempted"] > 0
