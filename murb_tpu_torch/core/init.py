"""Initial-condition schemes: galaxy, random and the two-galaxy file.

Port of ``murb_tpu/core/init.py`` (ref: src/common/core/Bodies.cpp:158-214
``initGalaxy``, 217-257 ``initRandomly``, 82-153 ``initMilkyWayAndromeda``).
Bit equality across random number generators is meaningless, so the port
keeps the reference's *distributions* and is deterministic by seed: a
``torch.Generator`` seeded from ``seed`` samples on the CPU in float64, the
state is cast to ``dtype`` and moved to ``device`` once.  The two-galaxy
file is parsed with numpy (the JAX package's C++ ``.tab`` parser is host
code not ported yet).  Every builder puts the state on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from murb_tpu_torch.core.state import (PAD_MULTIPLE, BodyState, check_device,
                                       round_up)

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
                device: torch.device | str = "cuda") -> BodyState:
    """Spinning disc around one heavy central body (ref: Bodies.cpp:158-214)."""
    device = check_device(device)
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
                device: torch.device | str = "cuda") -> BodyState:
    """Uniform box of bodies with small random velocities
    (ref: Bodies.cpp:217-257)."""
    device = check_device(device)
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


# Milky Way / Andromeda component sizes (ref: Bodies.cpp:111-113).
_MW_DISK = 16384
_MW_BULGE = 8192
_MW_HALO = 16384


def _is_milky_way(idx: np.ndarray) -> np.ndarray:
    """Index ranges belonging to the Milky Way (ref: Bodies.cpp:125-128)."""
    d, b, h = _MW_DISK, _MW_BULGE, _MW_HALO
    return ((idx < d)
            | ((idx >= 2 * d) & (idx < 2 * d + b))
            | ((idx >= 2 * (d + b)) & (idx < 2 * (d + b) + h)))


def init_milkyway_andromeda(path: str = "milkyway_andromeda.tab", *,
                            dtype: torch.dtype = torch.float32,
                            pad_multiple: int = PAD_MULTIPLE,
                            seed: int = DEFAULT_SEED,
                            device: torch.device | str = "cuda") -> BodyState:
    """Two-galaxy merger initial conditions from a whitespace ``.tab`` file.

    Row format: ``m qx qy qz vx vy vz`` in simulation units; Milky Way rows
    are rescaled by (mass 4.5e10 Msun, R_d 4.0 kpc, V_c 220 km/s) and
    Andromeda rows by (9.4e10, 6.0, 260) exactly as the reference
    (ref: src/common/core/Bodies.cpp:115-148).  Display radius is 1e5
    (ref: Bodies.cpp:148).  ``scripts/make_two_galaxy_tab.py`` writes such
    a file."""
    device = check_device(device)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"two-galaxy initial conditions file not found: {path!r} "
            "(the reference hardcodes 'milkyway_andromeda.tab'; "
            "pass --scheme-file to point at the data file)")
    from murb_tpu_torch.native import parse_tab

    data = parse_tab(path, cols=7)  # the native parser, numpy without it
    if data.shape[1] != 7:
        raise ValueError(f"expected 7 columns (m qx qy qz vx vy vz), got "
                         f"{data.shape[1]}")
    n = data.shape[0]
    mw = _is_milky_way(np.arange(n))
    m = data[:, 0] * np.where(mw, 4.5e10, 9.4e10)
    q = data[:, 1:4] * np.where(mw, 4.0, 6.0)[:, None]
    v = data[:, 4:7] * np.where(mw, 220.0, 260.0)[:, None]
    r = np.full(n, 1.0e5)

    gq, gv = _ghosts(torch.Generator().manual_seed(seed),
                     round_up(n, pad_multiple) - n)
    return BodyState.from_arrays(
        m, r, q[:, 0], q[:, 1], q[:, 2], v[:, 0], v[:, 1], v[:, 2],
        n=n, pad_multiple=pad_multiple, dtype=dtype, device=device,
        ghost_positions=gq, ghost_velocities=gv)


def milkyway_andromeda_masks(npad: int, n: int) -> list[np.ndarray]:
    """Per-galaxy 0/1 masks over the padded body array for the two-galaxy
    scheme (Milky Way ranges per ref: Bodies.cpp:125-128; everything else
    in [0, n) is Andromeda; ghosts belong to neither)."""
    idx = np.arange(npad)
    valid = idx < n
    mw = _is_milky_way(idx)
    return [(mw & valid).astype(np.float32),
            (~mw & valid).astype(np.float32)]


SCHEMES = {
    "galaxy": init_galaxy,
    "random": init_random,
}


def make_bodies(n: int, scheme: str = "galaxy", seed: int = DEFAULT_SEED, *,
                dtype: torch.dtype = torch.float32,
                pad_multiple: int = PAD_MULTIPLE,
                scheme_file: str | None = None,
                device: torch.device | str = "cuda") -> BodyState:
    """Factory mirroring ``Bodies<T>::Bodies(n, scheme)``
    (ref: Bodies.cpp:13-25): any scheme other than galaxy/random falls
    through to the two-galaxy file."""
    device = check_device(device)
    if scheme in SCHEMES:
        return SCHEMES[scheme](n, seed, dtype=dtype,
                               pad_multiple=pad_multiple, device=device)
    return init_milkyway_andromeda(scheme_file or "milkyway_andromeda.tab",
                                   dtype=dtype, pad_multiple=pad_multiple,
                                   seed=seed, device=device)
