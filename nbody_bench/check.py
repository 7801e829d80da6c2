"""The comparison that decides ``correct``.

A run keeps, for a sample of its steps drawn from the seed, the state before
the step, the accelerations the step computed and the state after it, whose
positions are the frame the host read back.  The first step of a run starts
from the benchmark's own inputs; the others from the program's state, since
a chaotic system cannot be followed over hundreds of steps by a reference of
its own.  Two numbers are compared, each with the limit the cell states:

``force_err``
    the largest net-relative error of the step's accelerations against the
    float64 reference: |a - a_ref| over max(|a_ref|, 1e-6 max|a_ref|), the
    statistic of the solvers' ``tol``.  It covers every body where the
    cell's ``stratum`` is 1; otherwise one body drawn at random from each
    run of ``stratum`` consecutive bodies, drawn anew for every step from
    the seed, so every tile of the program's rows is looked at in each step;
``update_ulp``
    the largest gap of the state after the step (every body's positions as
    read back and velocities) from the float64 Euler update of the state
    before it with the step's accelerations, in units of 2^-23 times the
    largest magnitude of the component's old value, new value and change:
    the rounding of an fp32 update reads about 1.
"""
from __future__ import annotations

import numpy as np

#: 2^-23: one fp32 ulp at the bottom of a binade
FP32_UNIT = 2.0 ** -23
#: the net-relative floor of the force statistic (a share of max|a_ref|)
FORCE_FLOOR = 1e-6


def body_sample(n: int, stratum: int, seed: int, step: int) -> np.ndarray:
    """The bodies of the ``step``-th checked step: every body at ``stratum``
    1, else one drawn from each ``stratum`` consecutive bodies, from the
    seed and the step."""
    if stratum <= 1:
        return np.arange(n)
    rng = np.random.default_rng([seed, 0xB0D1E5, step])
    starts = np.arange(0, n, stratum)
    sizes = np.minimum(stratum, n - starts)
    return starts + (rng.random(len(starts)) * sizes).astype(np.int64)


def _worst(r: np.ndarray) -> float:
    """The largest value, or inf where any is not finite."""
    return float(r.max()) if np.isfinite(r).all() else float("inf")


def force_err(a: np.ndarray, a_ref: np.ndarray) -> float:
    rn = np.linalg.norm(a_ref, axis=1)
    floor = np.maximum(rn, max(float(rn.max()), 1e-300) * FORCE_FLOOR)
    return _worst(np.linalg.norm(a - a_ref, axis=1) / floor)


def update_ulp(old: np.ndarray, ref: np.ndarray, got: np.ndarray) -> float:
    unit = FP32_UNIT * np.maximum(np.maximum(np.abs(old), np.abs(ref)),
                                  np.abs(ref - old))
    unit = np.maximum(unit, np.finfo(np.float32).tiny)
    return _worst(np.abs(got - ref) / unit)


def compare(samples: list[dict], mass: np.ndarray, config: dict,
            reference, stratum: int, seed: int, device) -> dict:
    """{"force_err": value, "update_ulp": value} over ``samples``, each a
    dict of (n, 3) float64 arrays ``q0``, ``v0`` (before the step), ``a``
    (the step's accelerations), ``q1`` (read back), ``v1``."""
    n = mass.shape[0]
    f_err = u_err = 0.0
    for step, s in enumerate(samples):
        idx = body_sample(n, stratum, seed, step)
        a_ref = reference.accelerations(idx, s["q0"], mass, config["G"],
                                        config["soft"], device)
        f_err = max(f_err, force_err(s["a"][idx], a_ref))
        q_ref, v_ref = reference.euler(s["q0"], s["v0"], s["a"],
                                       config["dt"])
        u_err = max(u_err, update_ulp(s["q0"], q_ref, s["q1"]),
                    update_ulp(s["v0"], v_ref, s["v1"]))
    return {"force_err": f_err, "update_ulp": u_err}
