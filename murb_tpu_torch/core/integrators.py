"""Time integrators: explicit Euler, phase-split leapfrog, KDK, Yoshida4.

Port of ``murb_tpu/core/integrators.py``.  Euler is the reference's
one-step scheme (ref: src/common/core/Bodies.cpp:259-278, 18 flops/body):

    q += (v + a*dt/2) * dt ;  v += a*dt

Leapfrog is the reference's device 3-phase split (one force evaluation per
iteration, carry = (x_n, v_{n-1/2}); ref: src/common/core/CUDABodies.cu:
172-212, kernels at 216-324):

    first  (n=0):      v_{1/2}   = v_0 + a(x_0)*dt/2 ; x_1 = x_0 + v_{1/2}*dt
    middle (0<n<last): v_n       = v_{n-1/2} + a(x_n)*dt/2      (observable)
                       v_{n+1/2} = v_n       + a(x_n)*dt/2
                       x_{n+1}   = x_n + v_{n+1/2}*dt
    last:              v_last ~= v_{last-1/2} ; x_last from buffer

Every update returns new tensors; the inputs are not modified.  A time step
is a Python float: PyTorch multiplies a tensor by it in the tensor's dtype,
as ``murb_tpu`` casts ``dt`` to the state dtype.  It may also be a 0-dim
tensor, through which autograd reaches dt (murb_tpu_torch.diff).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from murb_tpu_torch.core.state import BodyState, in_dtype
from murb_tpu_torch.ops.common import Accel
from murb_tpu_torch.utils import trace


# --------------------------------------------------------------------- Euler
def euler_update(state: BodyState, acc: Accel, dt: float) -> BodyState:
    """Explicit Euler update of positions then velocities (ref:
    Bodies.cpp:259-278)."""
    dt = in_dtype(dt, state.dtype)  # murb_tpu rounds dt to the state dtype
    with trace.span("update"):
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


# ------------------------------------------------------------------ Leapfrog
class LeapfrogAux(NamedTuple):
    """The leapfrog's carried scratch: v_{n+1/2} and x_{n+1} (the
    reference's ``devIntermVelocities`` / ``devNextPositions``, ref:
    CUDABodies.hpp:24-65)."""

    vhx: torch.Tensor
    vhy: torch.Tensor
    vhz: torch.Tensor
    nqx: torch.Tensor
    nqy: torch.Tensor
    nqz: torch.Tensor

    @classmethod
    def zeros_like(cls, state: BodyState) -> "LeapfrogAux":
        return cls(*(torch.zeros_like(state.qx) for _ in range(6)))


def leapfrog_positions(state: BodyState, aux: LeapfrogAux, iteration: int):
    """The positions a phase evaluates the force at: x_0 at the first
    iteration, the x_n buffer after it (ref:
    SimulationNBodyCUDALeapfrog.cu:335-346)."""
    if iteration == 0:
        return state.qx, state.qy, state.qz
    return aux.nqx, aux.nqy, aux.nqz


def leapfrog_first(state: BodyState, aux: LeapfrogAux, acc: Accel,
                   dt: float):
    """Phase 0 (ref kernel devLeapfrogFirst, CUDABodies.cu:216-244): the
    visible state stays (x_0, v_0); the buffers receive v_{1/2} and x_1."""
    half_dt = in_dtype(dt, state.dtype) * 0.5
    vhx = state.vx + acc.ax * half_dt
    vhy = state.vy + acc.ay * half_dt
    vhz = state.vz + acc.az * half_dt
    return state, LeapfrogAux(vhx, vhy, vhz, state.qx + vhx * dt,
                              state.qy + vhy * dt, state.qz + vhz * dt)


def leapfrog_middle(state: BodyState, aux: LeapfrogAux, acc: Accel,
                    dt: float):
    """Phase n (ref kernel devLeapfrogMiddle, CUDABodies.cu:247-299): the
    visible state becomes (x_n, v_n); the buffers advance to v_{n+1/2} and
    x_{n+1}.  ``acc`` must be evaluated at x_n = aux.nq*."""
    half_dt = in_dtype(dt, state.dtype) * 0.5
    vx_n = aux.vhx + acc.ax * half_dt
    vy_n = aux.vhy + acc.ay * half_dt
    vz_n = aux.vhz + acc.az * half_dt
    vhx = vx_n + acc.ax * half_dt
    vhy = vy_n + acc.ay * half_dt
    vhz = vz_n + acc.az * half_dt
    new_state = dataclasses.replace(state, qx=aux.nqx, qy=aux.nqy,
                                    qz=aux.nqz, vx=vx_n, vy=vy_n, vz=vz_n)
    return new_state, LeapfrogAux(vhx, vhy, vhz, aux.nqx + vhx * dt,
                                  aux.nqy + vhy * dt, aux.nqz + vhz * dt)


def leapfrog_last(state: BodyState, aux: LeapfrogAux):
    """Final phase (ref kernel devLeapfrogLast, CUDABodies.cu:302-324):
    v_last ~= v_{last-1/2}, x_last from the position buffer."""
    new_state = dataclasses.replace(state, qx=aux.nqx, qy=aux.nqy,
                                    qz=aux.nqz, vx=aux.vhx, vy=aux.vhy,
                                    vz=aux.vhz)
    return new_state, aux


def yoshida4_step(state: BodyState, acc_fn, dt: float) -> BodyState:
    """4th-order symplectic integrator (Yoshida 1990 triple-jump): the
    drift-kick chain c1 D, d1 K, c2 D, d2 K, c3 D, d3 K, c4 D with

        w1 = 1 / (2 - 2^(1/3)),  w0 = -2^(1/3) * w1
        c1 = c4 = w1/2,  c2 = c3 = (w0 + w1)/2,  d1 = d3 = w1,  d2 = w0

    Three force evaluations per step for an O(dt^4) energy error.  Each
    coefficient times dt is formed in the state dtype, as ``murb_tpu``
    forms it."""
    cbrt2 = 2.0 ** (1.0 / 3.0)
    w1 = 1.0 / (2.0 - cbrt2)
    w0 = -cbrt2 * w1
    cs = (w1 / 2.0, (w0 + w1) / 2.0, (w0 + w1) / 2.0, w1 / 2.0)
    ds = (w1, w0, w1)
    dtb = in_dtype(dt, state.dtype)
    if isinstance(dtb, torch.Tensor):
        coef = lambda k: torch.tensor(k, dtype=state.dtype,
                                      device=dtb.device) * dtb
    else:
        coef = lambda k: float(torch.tensor(k, dtype=state.dtype)
                               * torch.tensor(dtb, dtype=state.dtype))

    qx, qy, qz = state.qx, state.qy, state.qz
    vx, vy, vz = state.vx, state.vy, state.vz
    for k in range(4):
        c = coef(cs[k])
        qx, qy, qz = qx + vx * c, qy + vy * c, qz + vz * c
        if k < 3:
            a = acc_fn(qx, qy, qz)
            d = coef(ds[k])
            vx, vy, vz = vx + a.ax * d, vy + a.ay * d, vz + a.az * d
    return dataclasses.replace(state, qx=qx, qy=qy, qz=qz,
                               vx=vx, vy=vy, vz=vz)


def kdk_step(state: BodyState, acc_fn, dt: float) -> BodyState:
    """Textbook kick-drift-kick leapfrog (two force evaluations per step),
    the numerically clean symplectic option (tag ``tpu+kdk``)."""
    half_dt = in_dtype(dt, state.dtype) * 0.5
    a0 = acc_fn(state.qx, state.qy, state.qz)
    vhx = state.vx + a0.ax * half_dt
    vhy = state.vy + a0.ay * half_dt
    vhz = state.vz + a0.az * half_dt
    qx = state.qx + vhx * dt
    qy = state.qy + vhy * dt
    qz = state.qz + vhz * dt
    a1 = acc_fn(qx, qy, qz)
    return dataclasses.replace(
        state, qx=qx, qy=qy, qz=qz,
        vx=vhx + a1.ax * half_dt,
        vy=vhy + a1.ay * half_dt,
        vz=vhz + a1.az * half_dt,
    )
