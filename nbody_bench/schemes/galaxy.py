"""The reference's galaxy scheme (MUrB ``Bodies.cpp:158-214`` ``initGalaxy``).

A frozen copy of ``murb_tpu_torch/core/init.init_galaxy``: a CPU
``torch.Generator`` seeded with the run's seed draws every value in float64,
in the same order, so the same seed gives the port's arrays bit for bit.  The
zero-mass ghosts that pad the count to a multiple of 256 are drawn after the
bodies, as the port draws them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_CENTRAL_MASS = 2.0e24           # ref: Bodies.cpp:171
_MAX_MASS = 5.0e20               # ref: Bodies.cpp:181
_RADIUS_PER_MASS = 2.5e-15       # ref: Bodies.cpp:182
_DIST_MIN = 1.0e8                # ref: Bodies.cpp:186
_DIST_SPAN = 1.0e8
_OMEGA = 4.0e-6                  # ref: Bodies.cpp:192-193
_BOX = torch.tensor([5.0e8 * 1.33, 5.0e8, 5.0e8], dtype=torch.float64)
_BOX_SHIFT = torch.tensor([0.0, 0.0, -10.0e8], dtype=torch.float64)
_BOX_VEL = 1.0e2                 # ref: Bodies.cpp:236-238


def _uniform(gen, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=gen, dtype=torch.float64) * (hi - lo) \
        + lo


def generate(n: int, seed: int, pad_multiple: int = 256) -> dict:
    """{"m", "r", "qx", ..., "vz": (n,) float64, "ghost_q", "ghost_v":
    (padding, 3) float64} of the galaxy: body 0 the heavy central mass at
    rest at the origin, the others on a spinning shell."""
    gen = torch.Generator().manual_seed(seed)
    m = _uniform(gen, (n,)) * _MAX_MASS
    r = m * _RADIUS_PER_MASS
    h_angle = _uniform(gen, (n,)) * (2.0 * math.pi)
    v_angle = _uniform(gen, (n,)) * (2.0 * math.pi)
    dist = _uniform(gen, (n,)) * _DIST_SPAN + _DIST_MIN
    qx = torch.cos(v_angle) * torch.sin(h_angle) * dist
    qy = torch.sin(v_angle) * dist
    qz = torch.cos(v_angle) * torch.cos(h_angle) * dist
    vx = qy * _OMEGA
    vy = -qx * _OMEGA
    vz = torch.zeros_like(qx)
    m[0] = _CENTRAL_MASS
    for a in (r, qx, qy, qz, vx, vy, vz):
        a[0] = 0.0
    padding = -n % pad_multiple
    gq = _uniform(gen, (max(padding, 1), 3), -1.0, 1.0) * _BOX + _BOX_SHIFT
    gv = _uniform(gen, (max(padding, 1), 3), -_BOX_VEL, _BOX_VEL)
    out = {k: a.numpy() for k, a in
           zip(("m", "r", "qx", "qy", "qz", "vx", "vy", "vz"),
               (m, r, qx, qy, qz, vx, vy, vz))}
    out["ghost_q"] = np.ascontiguousarray(gq.numpy()[:padding])
    out["ghost_v"] = np.ascontiguousarray(gv.numpy()[:padding])
    return out
