"""Measured-order selection: hold the fast solver to its accuracy contract
by measurement.

Port of ``murb_tpu/ops/validate.py``, unchanged in logic.  The static
Chebyshev order bound assumes an error prefactor that depends on the mass
distribution, so the engine measures its pick against an exact strided
sample sweep, escalates until the tolerance is met, and -- when the first
pick already met it -- descends while cheaper orders still do.

The exact reference sweep runs in float64 on every device (the H100 has
native fp64): a same-precision reference would share the solver's fp32
rounding and under-report its error.
"""
from __future__ import annotations

import numpy as np
import torch

from murb_tpu_torch.ops.naive import acc_rect_jchunked

__all__ = ["measured_force_error", "escalate_config", "descend_config",
           "validate_config", "certified_half"]

#: error statistic floor: per-body relative error with tiny-force bodies
#: floored at 1e-6 of the system's max force norm.
FLOOR_FRAC = 1e-6

#: j-chunk of the float64 reference sweep: 512 sample rows x 65,536
#: sources x 8 bytes = 256 MiB per temporary.
REFERENCE_CHUNK = 65_536

_MAX_HIER_M = 12
_MAX_LEVELS = 4
_MAX_TRIALS = 6


def measured_force_error(qx, qy, qz, gm, soft, acc_fn,
                         sample: int = 512) -> float:
    """Max net-relative force error of ``acc_fn`` on a strided sample.

    ``acc_fn(qx, qy, qz, gm) -> Accel`` is the configured fast solver; the
    reference is one exact float64 rectangular sweep over ``sample``
    strided rows (row 0 included: the schemes' heavy central body).  Rows
    of zero-mass ghosts are excluded from the statistic."""
    n = int(qx.shape[0])
    k = min(int(sample), n)
    idx_np = np.linspace(0, n - 1, k).astype(np.int64)
    idx = torch.from_numpy(idx_np).to(qx.device)

    a = acc_fn(qx, qy, qz, gm)
    ax, ay, az = (v[idx].double().cpu().numpy() for v in a)

    rq = tuple(v.double() for v in (qx, qy, qz, gm))
    r = acc_rect_jchunked(rq[0][idx], rq[1][idx], rq[2][idx], *rq, soft,
                          chunk=REFERENCE_CHUNK)
    rx, ry, rz = (v.cpu().numpy() for v in r)
    rn = np.sqrt(rx * rx + ry * ry + rz * rz)
    sel = gm[idx].cpu().numpy() > 0
    if not np.any(sel):
        return 0.0
    floor = np.maximum(rn, max(float(rn[sel].max()), 1e-300) * FLOOR_FRAC)
    err = np.sqrt((ax - rx) ** 2 + (ay - ry) ** 2 + (az - rz) ** 2) / floor
    return float(err[sel].max())


def escalate_config(m: int, levels: int, cells: int, half: float,
                    soft: float, tol: float) -> tuple[int, int, int]:
    """One escalation step: the next (m, levels, cells) to try when the
    measured error missed ``tol`` (single cell by 4 orders up to m=20, then
    the hierarchy; the hierarchy by 2 orders to m=12, then one level
    deeper)."""
    from murb_tpu_torch.ops.fmm import fmm_order, required_levels

    if levels == 0:
        if m + 4 <= 20:
            return m + 4, 0, cells
        lv = max(required_levels(half, soft), 2)
        return fmm_order(half, soft, lv, tol), lv, 1
    if m + 2 <= _MAX_HIER_M:
        return m + 2, levels, 1
    lv = min(levels + 1, _MAX_LEVELS)
    if lv == levels:                       # depth exhausted: keep growing m
        return m + 2, levels, 1
    return max(fmm_order(half, soft, lv, tol), 6), lv, 1


#: descent floors: single-cell m=8, hierarchy m=6
_MIN_CELL_M = 8
_MIN_HIER_M = 6


def descend_config(m: int, levels: int,
                   cells: int) -> tuple[int, int, int] | None:
    """One descent step: the next cheaper (m, levels, cells), or None at
    the floor (the rungs of escalate_config, downward, at fixed depth)."""
    if levels == 0:
        return (m - 4, 0, cells) if m - 4 >= _MIN_CELL_M else None
    return (m - 2, levels, 1) if m - 2 >= _MIN_HIER_M else None


#: extrapolation trust region for certified_half
_CERT_GROWTH_CAP = 3.0


def certified_half(m: int, levels: int, half: float, err: float,
                   soft: float, tol: float,
                   cap: float = _CERT_GROWTH_CAP) -> float:
    """Largest box half-extent a measured config stays inside ``tol`` for:
    the err ~ C * rho^-m law with C pinned by the measurement, inverted for
    the box, capped at ``cap * half``."""
    import math

    h_eff = max(half, 1e-30) / 2 ** levels
    a_now = max(soft / h_eff, 1e-6)
    rho_now = a_now + math.sqrt(1.0 + a_now * a_now)
    target_rho = rho_now * (max(err, 1e-30) / tol) ** (1.0 / max(m, 1))
    if target_rho <= 1.0 + 1e-9:
        return cap * half
    a_t = (target_rho - 1.0 / target_rho) / 2.0
    return min((soft / a_t) * 2 ** levels, cap * half)


def validate_config(qx, qy, qz, gm, soft, tol, m: int, levels: int,
                    cells: int, half: float, make_acc_fn,
                    sample: int = 512, max_trials: int = _MAX_TRIALS,
                    descend: bool = True, warn=print):
    """Escalate (m, levels, cells) until the measured error meets ``tol``
    -- then, if the initial pick already met it, descend while cheaper
    configs still do.  ``make_acc_fn(m, levels, cells) -> acc_fn``.
    Returns ``(m, levels, cells, measured_err)``: the cheapest config
    meeting tol, or (with a warning) the best one tried."""
    best = None
    for trial in range(max_trials):
        err = measured_force_error(qx, qy, qz, gm, soft,
                                   make_acc_fn(m, levels, cells),
                                   sample=sample)
        if best is None or err < best[3]:
            best = (m, levels, cells, err)
        if err <= tol:
            if descend and trial == 0:
                for _ in range(max_trials):
                    down = descend_config(m, levels, cells)
                    if down is None:
                        break
                    derr = measured_force_error(
                        qx, qy, qz, gm, soft, make_acc_fn(*down),
                        sample=sample)
                    if derr > tol:
                        break
                    (m, levels, cells), err = down, derr
            return m, levels, cells, err
        m, levels, cells = escalate_config(m, levels, cells, half, soft,
                                           tol)
    warn(f"WARNING: fast-solver validation missed tol={tol:.1e} after "
         f"{max_trials} escalations; keeping the best config "
         f"m={best[0]} levels={best[1]} cells={best[2]} "
         f"(measured err {best[3]:.1e})")
    return best
