"""Initial-condition schemes: galaxy and random.

Port of ``murb_tpu/core/init.py`` (ref: src/common/core/Bodies.cpp:158-214
``initGalaxy``, 217-257 ``initRandomly``).  Bit equality across random
number generators is meaningless, so the port keeps the reference's
*distributions* and is deterministic by seed: a ``torch.Generator`` seeded
from ``seed`` samples on the CPU in float64, the state is cast to ``dtype``
and moved to ``device`` once.  The two-galaxy file loader is not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from murb_tpu_torch.core.state import PAD_MULTIPLE, BodyState, round_up

DEFAULT_SEED = 123  # any fixed value; reference uses srand(randInit=0) by default

# Scale constants, identical to murb_tpu/core/init.py:26-38.
_GALAXY_CENTRAL_MASS = 2.0e24          # ref: Bodies.cpp:171
_GALAXY_MAX_MASS = 5.0e20              # ref: Bodies.cpp:181
_GALAXY_RADIUS_PER_MASS = 2.5e-15      # ref: Bodies.cpp:182
_GALAXY_DIST_MIN = 1.0e8               # ref: Bodies.cpp:186
_GALAXY_DIST_SPAN = 1.0e8
_GALAXY_OMEGA = 4.0e-6                 # ref: Bodies.cpp:192-193
_RANDOM_MAX_MASS = 5.0e21              # ref: Bodies.cpp:228
_RANDOM_RADIUS_PER_MASS = 0.5e-14      # ref: Bodies.cpp:230
_BOX_X = 5.0e8 * 1.33                  # ref: Bodies.cpp:232
_BOX_Y = 5.0e8
_BOX_Z = 5.0e8
_BOX_Z_OFFSET = -10.0e8                # ref: Bodies.cpp:234
_BOX_VEL = 1.0e2                       # ref: Bodies.cpp:236-238

_BOX = torch.tensor([_BOX_X, _BOX_Y, _BOX_Z], dtype=torch.float64)
_BOX_SHIFT = torch.tensor([0.0, 0.0, _BOX_Z_OFFSET], dtype=torch.float64)


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return u * (hi - lo) + lo


def _ghosts(gen: torch.Generator, padding: int):
    """Random box positions and small velocities for the zero-mass ghosts
    (visual parity with ref: Bodies.cpp:200-213; physically inert)."""
    q = _uniform(gen, (max(padding, 1), 3), -1.0, 1.0) * _BOX + _BOX_SHIFT
    v = _uniform(gen, (max(padding, 1), 3), -_BOX_VEL, _BOX_VEL)
    return q.numpy(), v.numpy()


def init_galaxy(n: int, seed: int = DEFAULT_SEED, *,
                dtype: torch.dtype = torch.float32,
                pad_multiple: int = PAD_MULTIPLE,
                device: torch.device | str = "cpu") -> BodyState:
    """Spinning disc around one heavy central body (ref: Bodies.cpp:158-214)."""
    gen = torch.Generator().manual_seed(seed)
    m = _uniform(gen, (n,)) * _GALAXY_MAX_MASS
    r = m * _GALAXY_RADIUS_PER_MASS
    h_angle = _uniform(gen, (n,)) * (2.0 * math.pi)
    v_angle = _uniform(gen, (n,)) * (2.0 * math.pi)
    dist = _uniform(gen, (n,)) * _GALAXY_DIST_SPAN + _GALAXY_DIST_MIN

    qx = torch.cos(v_angle) * torch.sin(h_angle) * dist
    qy = torch.sin(v_angle) * dist
    qz = torch.cos(v_angle) * torch.cos(h_angle) * dist
    vx = qy * _GALAXY_OMEGA
    vy = -qx * _GALAXY_OMEGA
    vz = torch.zeros_like(qx)

    # Body 0 is the heavy central mass at rest at the origin
    # (ref: Bodies.cpp:170-178).
    m[0] = _GALAXY_CENTRAL_MASS
    for a in (r, qx, qy, qz, vx, vy, vz):
        a[0] = 0.0

    gq, gv = _ghosts(gen, round_up(n, pad_multiple) - n)
    return BodyState.from_arrays(
        *(a.numpy() for a in (m, r, qx, qy, qz, vx, vy, vz)),
        n=n, pad_multiple=pad_multiple, dtype=dtype, device=device,
        ghost_positions=gq, ghost_velocities=gv)


def init_random(n: int, seed: int = DEFAULT_SEED, *,
                dtype: torch.dtype = torch.float32,
                pad_multiple: int = PAD_MULTIPLE,
                device: torch.device | str = "cpu") -> BodyState:
    """Uniform box of bodies with small random velocities
    (ref: Bodies.cpp:217-257)."""
    gen = torch.Generator().manual_seed(seed)
    m = _uniform(gen, (n,)) * _RANDOM_MAX_MASS
    r = m * _RANDOM_RADIUS_PER_MASS
    q = _uniform(gen, (n, 3), -1.0, 1.0) * _BOX + _BOX_SHIFT
    v = _uniform(gen, (n, 3), -_BOX_VEL, _BOX_VEL)

    gq, gv = _ghosts(gen, round_up(n, pad_multiple) - n)
    q, v = q.numpy(), v.numpy()
    return BodyState.from_arrays(
        m.numpy(), r.numpy(), q[:, 0], q[:, 1], q[:, 2],
        v[:, 0], v[:, 1], v[:, 2],
        n=n, pad_multiple=pad_multiple, dtype=dtype, device=device,
        ghost_positions=gq, ghost_velocities=gv)


SCHEMES = {
    "galaxy": init_galaxy,
    "random": init_random,
}


def make_bodies(n: int, scheme: str = "galaxy", seed: int = DEFAULT_SEED, *,
                dtype: torch.dtype = torch.float32,
                pad_multiple: int = PAD_MULTIPLE,
                device: torch.device | str = "cpu") -> BodyState:
    """Factory mirroring ``Bodies<T>::Bodies(n, scheme)``
    (ref: Bodies.cpp:13-25).  The reference's third scheme, the two-galaxy
    file, is not ported yet."""
    if scheme not in SCHEMES:
        raise NotImplementedError(
            f"scheme {scheme!r} (the two-galaxy file loader) is not yet "
            "ported to murb_tpu_torch (ROADMAP.md Queue 1 item 5)")
    return SCHEMES[scheme](n, seed, dtype=dtype, pad_multiple=pad_multiple,
                           device=device)
