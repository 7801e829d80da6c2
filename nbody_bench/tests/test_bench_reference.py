"""The float64 reference: against a loop written out, and against the port's
``--device cpu`` path at 2048 bodies for each cell's tag."""
import numpy as np
import pytest
import torch

from nbody_bench import check, harness
from nbody_bench.references import softened_euler as ref

from conftest import N_CPU


def _loop_acc(q, m, G, soft):
    a = np.zeros_like(q)
    for i in range(len(q)):
        for j in range(len(q)):
            d = q[j] - q[i]
            a[i] += G * m[j] * d / (d @ d + soft * soft) ** 1.5
    return a


def test_accelerations_are_the_sum_written_out():
    rng = np.random.default_rng(3)
    q, m = rng.normal(size=(48, 3)), rng.uniform(1, 2, 48)
    got = ref.accelerations(np.arange(7), q, m, 0.5, 0.1)
    np.testing.assert_allclose(got, _loop_acc(q, m, 0.5, 0.1)[:7],
                               rtol=1e-13, atol=1e-15)


def test_euler_is_the_references_update():
    q, v, a = np.ones((2, 3)), np.full((2, 3), 2.0), np.full((2, 3), 4.0)
    q1, v1 = ref.euler(q, v, a, 0.5)
    assert np.all(q1 == 1 + (2 + 4 * 0.25) * 0.5) and np.all(v1 == 4.0)


def test_blocks_do_not_change_the_sum(monkeypatch):
    rng = np.random.default_rng(4)
    q, m = rng.normal(size=(300, 3)), rng.uniform(1, 2, 300)
    idx = np.arange(300)
    whole = ref.accelerations(idx, q, m, 1.0, 0.2)
    monkeypatch.setattr(ref, "_PAIRS_A_BLOCK", 300 * 7)
    np.testing.assert_allclose(ref.accelerations(idx, q, m, 1.0, 0.2), whole,
                               rtol=1e-14)


def _cpu_step(cell, engine, seed=17):
    """The port's first CPU step of ``cell`` at N_CPU bodies from the
    benchmark's inputs: one sample as the comparison takes it, and the
    masses."""
    spec = harness.Spec(cell)
    inputs = harness.make_inputs(spec, seed, N_CPU)
    cfg = dict(spec.cell, **({"engine": engine} if engine else {}))
    eng = harness.build_engine(spec, inputs, N_CPU, torch.device("cpu"), cfg)
    if engine:
        assert eng.near_mode == "adaptive"
    eng.compute_one_iteration()
    r = lambda k: harness.rounded(inputs[k], "float32")
    col = lambda t: t[:N_CPU].double().numpy()
    b = eng.bodies
    return spec, {
        "q0": np.stack([r(k) for k in ("qx", "qy", "qz")], 1),
        "v0": np.stack([r(k) for k in ("vx", "vy", "vz")], 1),
        "a": np.stack([col(t) for t in eng.accelerations], 1),
        "q1": np.stack([col(b.qx), col(b.qy), col(b.qz)], 1),
        "v1": np.stack([col(b.vx), col(b.vy), col(b.vz)], 1)}, r("m")


@pytest.mark.parametrize("cell,engine", [
    ("galaxy200k.exact", None),
    ("clusters1m.adaptive", None),
    ("clusters1m.adaptive", {"near": "adaptive", "adapt_every": 64}),
])
def test_the_ports_cpu_step_within_the_cells_limits(cell, engine):
    """The forces of 512 bodies drawn from the seed (body 0 among them) and
    every body's update."""
    spec, s, mass = _cpu_step(cell, engine)
    rng = np.random.default_rng([17, 0xB0D1E5])
    idx = np.sort(np.concatenate(
        [[0], rng.choice(np.arange(1, N_CPU), 511, replace=False)]))
    cfg = spec.config
    a_ref = ref.accelerations(idx, s["q0"], mass, cfg["G"], cfg["soft"])
    q_ref, v_ref = ref.euler(s["q0"], s["v0"], s["a"], cfg["dt"])
    values = {"force_err": check.force_err(s["a"][idx], a_ref),
              "update_ulp": max(check.update_ulp(s["q0"], q_ref, s["q1"]),
                                check.update_ulp(s["v0"], v_ref, s["v1"]))}
    for k, lim in spec.cell["limits"].items():
        assert values[k] <= lim, (k, values[k])
    assert values["update_ulp"] <= 2.0


@pytest.mark.parametrize("cell", ["galaxy200k.exact", "clusters1m.adaptive"])
def test_every_body_of_the_cpu_step_within_the_cells_limits(cell):
    """The comparison of a run over every body of the cell's tag at N_CPU
    (the auto policy picks the exact sweep at this size)."""
    spec, s, mass = _cpu_step(cell, None)
    values = check.compare([s], mass, spec.config, ref, 1, 17, "cpu")
    for k, lim in spec.cell["limits"].items():
        assert values[k] <= lim, (k, values[k])


@pytest.mark.parametrize("n,stratum", [(2048, 1), (2048, 64), (1000, 128)])
def test_each_step_looks_at_every_stratum(n, stratum):
    a = check.body_sample(n, stratum, 2**31 + 11, 0)
    b = check.body_sample(n, stratum, 2**31 + 11, 1)
    assert a.dtype.kind == "i" and 0 <= a.min() and a.max() < n
    assert np.array_equal(a // stratum, np.arange(-(-n // stratum)))
    if stratum == 1:
        assert np.array_equal(a, b)
    else:
        assert not np.array_equal(a, b)
        assert np.array_equal(a, check.body_sample(n, stratum, 2**31 + 11,
                                                   0))
