"""Floating-point error diagnosis: the CADNA analogue.

Port of ``murb_tpu/numerics.py``.  The reference scaffolds CADNA
(stochastic arithmetic) but never got it working (ref:
src/murb/implem/SimulationNBodyNaiveCadna.cpp:11-21, 81-87).  This module
applies the same estimator at the trajectory level, two ways:

  * ``significant_digits_vs_reference`` -- run the engine on a float32
    state and compare with a float64 run of the same system: per-quantity
    significant decimal digits, the number CADNA would report.  The port's
    CUDA kernels compute in fp32 even for a float64 state, so the float64
    reference always runs ``xla+chunked`` (the plain float64 sweep, on the
    state's device: the H100 computes float64 natively); the float32 run
    may use any tag, ``tpu+mxu`` included.
  * ``stochastic_ensemble_digits`` -- CESTAC-style: run K replicas whose
    initial state is perturbed by one ulp with random sign (drawn from a
    ``torch.Generator`` seeded with ``seed``), and estimate the digits from
    the ensemble's spread: the simulation's sensitivity to rounding, which
    for a chaotic N-body system is the quantity that matters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from murb_tpu_torch.core.state import BodyState
from murb_tpu_torch.models import create_engine

_QUANTITIES = ("qx", "qy", "qz", "vx", "vy", "vz")


def _digits(mean: np.ndarray, spread: np.ndarray) -> np.ndarray:
    """log10 |mean / spread|, 15 where the spread is 0, clipped to
    [0, 15]."""
    with np.errstate(divide="ignore", invalid="ignore"):
        digits = np.log10(np.abs(mean) / np.where(spread == 0, np.nan,
                                                  spread))
    digits = np.where(spread == 0, 15.0, digits)
    digits = np.where(np.isfinite(digits), digits, 0.0)
    return np.clip(digits, 0.0, 15.0)


def significant_digits(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Common significant decimal digits between two estimates (CADNA's
    C_r formula: log10 |mean / spread|, clipped to [0, 15])."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return _digits(0.5 * (a + b), np.abs(a - b))


def _run(tag: str, bodies: BodyState, iters: int, soft, dt, **kw):
    eng = create_engine(tag, bodies, soft=soft, dt=dt, num_iterations=iters,
                        **kw)
    eng.run(iters)
    return eng.bodies.unpadded()


def significant_digits_vs_reference(
        bodies: BodyState, iters: int, *, tag: str = "xla+chunked",
        soft: float = 2.0e8, dt: float = 3600.0) -> dict[str, np.ndarray]:
    """float32 run of ``tag`` against a float64 ``xla+chunked`` run of the
    same state: significant digits per coordinate."""
    lo = _run(tag, bodies.astype(torch.float32), iters, soft, dt)
    hi = _run("xla+chunked", bodies.astype(torch.float64), iters, soft, dt)
    return {k: significant_digits(lo[k], hi[k]) for k in _QUANTITIES}


def _ulp_perturb(state: BodyState, gen: torch.Generator) -> BodyState:
    """Move each position and velocity by one ulp, up or down at random
    (the signs drawn on the host from ``gen``)."""
    fields = {}
    for name in _QUANTITIES:
        a = getattr(state, name)
        up = (torch.rand(a.shape, generator=gen) < 0.5).to(a.device)
        inf = torch.tensor(float("inf"), dtype=a.dtype, device=a.device)
        fields[name] = torch.where(up, torch.nextafter(a, inf),
                                   torch.nextafter(a, -inf))
    return dataclasses.replace(state, **fields)


def stochastic_ensemble_digits(
        bodies: BodyState, iters: int, *, replicas: int = 3,
        tag: str = "xla+chunked", soft: float = 2.0e8, dt: float = 3600.0,
        seed: int = 0) -> dict[str, np.ndarray]:
    """CESTAC-style ensemble digit estimate: replica 0 runs ``bodies`` as
    it is, each other replica a one-ulp perturbation of it."""
    if replicas < 2:
        raise ValueError(f"replicas must be >= 2, got {replicas}")
    gen = torch.Generator().manual_seed(seed)
    runs = [_run(tag, bodies if r == 0 else _ulp_perturb(bodies, gen), iters,
                 soft, dt)
            for r in range(replicas)]
    out = {}
    for k in _QUANTITIES:
        stack = np.stack([np.asarray(r[k], np.float64) for r in runs])
        out[k] = _digits(stack.mean(axis=0),
                         stack.std(axis=0) * np.sqrt(len(runs) - 1))
    return out


def report(digits: dict[str, np.ndarray]) -> str:
    """A table of min, 5th percentile, median and mean digits per
    quantity."""
    lines = ["quantity  min   p5    median  mean"]
    for k, d in digits.items():
        lines.append(f"{k:8s} {d.min():5.1f} {np.percentile(d, 5):5.1f} "
                     f"{np.median(d):6.1f} {d.mean():6.1f}")
    return "\n".join(lines)
