"""Time integration: explicit Euler.

Port of ``murb_tpu/core/integrators.euler_update`` (ref:
src/common/core/Bodies.cpp:259-278, 18 flops/body):

    q += (v + a*dt/2) * dt ;  v += a*dt

The leapfrog, KDK and Yoshida integrators are not ported yet.
"""
from __future__ import annotations

import dataclasses

from murb_tpu_torch.core.state import BodyState
from murb_tpu_torch.ops.common import Accel


def euler_update(state: BodyState, acc: Accel, dt: float) -> BodyState:
    """Explicit Euler update of positions then velocities (ref:
    Bodies.cpp:259-278).  Returns a new state; the input is not modified."""
    ax_dt = acc.ax * dt
    ay_dt = acc.ay * dt
    az_dt = acc.az * dt
    return dataclasses.replace(
        state,
        qx=state.qx + (state.vx + ax_dt * 0.5) * dt,
        qy=state.qy + (state.vy + ay_dt * 0.5) * dt,
        qz=state.qz + (state.vz + az_dt * 0.5) * dt,
        vx=state.vx + ax_dt,
        vy=state.vy + ay_dt,
        vz=state.vz + az_dt,
    )
