"""Differentiable simulation: gradients through trajectories, vmap ensembles.

Port of ``murb_tpu/diff.py``.  Every step is a function of a ``BodyState``
that builds new tensors (no buffer is updated in place), so whole
trajectories compose with PyTorch's transforms:

  * ``torch.autograd.grad`` through ``rollout`` gives the adjoint of the
    simulation: d(loss on the final state)/d(initial positions / velocities
    / masses / dt / softening) in one backward pass.  ``remat=True`` wraps
    each step in ``torch.utils.checkpoint`` (non-reentrant), so the
    backward pass recomputes a step's forces instead of keeping every
    step's activations: memory O(N) per step kept, not O(N * steps) of
    pair intermediates.
  * ``torch.func.vmap`` over a ``stack_states`` batch runs an ensemble of
    universes as one batched computation.

Gradients flow through the plain PyTorch force paths (``acc_naive``,
``acc_chunked``, the Chebyshev proxy's plain stages through
``acc_proxy(fused=False)``), on the state's device.  The CUDA kernels
define no backward, as murb_tpu's Pallas kernels define no VJP; a
grad-requiring input to a kernel wrapper raises (ops/cuda.refuse_grad).
The proxy path is polynomial algebra and differentiable, and its force
error (~1e-5) carries to the gradient, so ``proxy`` is the choice at large
N; ``chunked`` is the exact O(N^2) adjoint.

Typical use::

    from murb_tpu_torch.diff import rollout, target_loss

    v0 = state0.vx.clone().requires_grad_()
    final = rollout(dataclasses.replace(state0, vx=v0), steps=100,
                    dt=3600.0, soft=2e8)
    (g,) = torch.autograd.grad(target_loss(final, target_positions), v0)

``torch.func.grad`` and ``vjp`` refuse a checkpointed step (saved tensor
hooks), and vmap cannot trace one, so a gradient under vmap takes
``remat=False``; ``ensemble`` vmaps the forward rollout, which checkpoints
nothing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from murb_tpu_torch import G
from murb_tpu_torch.core.integrators import (euler_update, kdk_step,
                                             yoshida4_step)
from murb_tpu_torch.core.state import FIELDS, BodyState, in_dtype
from murb_tpu_torch.ops.common import Accel

INTEGRATORS = ("euler", "kdk", "yoshida4")


def _acc_method(method: str, soft, **kw) -> Callable:
    if method == "naive":
        from murb_tpu_torch.ops.naive import acc_naive

        return lambda qx, qy, qz, gm: acc_naive(qx, qy, qz, gm, soft)
    if method == "chunked":
        from murb_tpu_torch.ops.naive import acc_chunked

        chunk = kw.pop("chunk", 1024)
        return lambda qx, qy, qz, gm: acc_chunked(qx, qy, qz, gm, soft,
                                                  chunk=chunk)
    if method == "proxy":
        from murb_tpu_torch.ops.proxy import acc_proxy

        m = kw.pop("m", 12)
        # fused=False runs the plain stages (differentiable); the kernels
        # K1-K3 have no backward
        return lambda qx, qy, qz, gm: acc_proxy(qx, qy, qz, gm, soft, m=m,
                                                fused=False)
    raise ValueError(
        f"unknown differentiable method {method!r}: expected naive | "
        f"chunked | proxy (the CUDA kernels define no backward)")


def _with(state: BodyState, fields) -> BodyState:
    return dataclasses.replace(state, **dict(zip(FIELDS, fields)))


def _fields(state: BodyState) -> tuple:
    return tuple(getattr(state, k) for k in FIELDS)


def rollout(state: BodyState, *, steps: int, dt, soft,
            method: str = "chunked", remat: bool = True,
            chunk: int = 1024, m: int = 12,
            integrator: str = "euler") -> BodyState:
    """Integrate ``steps`` iterations; differentiable end to end.

    ``dt`` and ``soft`` are Python floats or 0-dim tensors (a gradient
    reaches a tensor that requires one).  ``integrator``: euler (reference
    scheme) | kdk (symplectic 2nd order) | yoshida4 (symplectic 4th order,
    the right adjoint for long horizons).  ``remat=True`` checkpoints each
    step when a gradient can flow: the backward pass recomputes its forces
    instead of storing them."""
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    acc = _acc_method(method, soft, chunk=chunk, m=m)

    def step(*fields):
        st = _with(state, fields)
        gm = st.m * in_dtype(G, st.dtype)
        acc_at = lambda x, y, z: acc(x, y, z, gm)
        if integrator == "euler":
            nxt = euler_update(st, acc_at(st.qx, st.qy, st.qz), dt)
        elif integrator == "kdk":
            nxt = kdk_step(st, acc_at, dt)
        else:
            nxt = yoshida4_step(st, acc_at, dt)
        return _fields(nxt)

    fields = _fields(state)
    # A checkpoint only saves memory for a backward pass: with autograd off
    # or nothing that requires grad there is none, and vmap cannot trace a
    # checkpoint (torch 2.11: "_NoopSaveInputs does not have vmap support")
    remat = remat and torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in (*fields, dt, soft))
    for _ in range(steps):
        fields = (checkpoint(step, *fields, use_reentrant=False) if remat
                  else step(*fields))
    return _with(state, fields)


def trajectory(state: BodyState, *, steps: int, dt, soft,
               method: str = "chunked", save_every: int = 1,
               chunk: int = 1024, m: int = 12):
    """(final_state, stacked (steps // save_every, npad, 3) positions).

    The frames stay on the state's device (no per-step device-to-host
    copy)."""
    if steps % save_every:
        raise ValueError(f"steps={steps} is not a multiple of "
                         f"save_every={save_every}")
    acc = _acc_method(method, soft, chunk=chunk, m=m)
    st, frames = state, []
    for k in range(steps):
        gm = st.m * in_dtype(G, st.dtype)
        st = euler_update(st, acc(st.qx, st.qy, st.qz, gm), dt)
        if (k + 1) % save_every == 0:
            frames.append(torch.stack([st.qx, st.qy, st.qz], dim=-1))
    qs = (torch.stack(frames) if frames else
          state.qx.new_zeros((0, state.npad, 3)))
    return st, qs


def target_loss(state: BodyState, target_positions) -> torch.Tensor:
    """Mean squared distance of the real (non-ghost) bodies to
    ``target_positions`` (n, 3): ghosts are masked out, not just
    zero-mass, so padding never leaks into gradients."""
    q = torch.stack([state.qx, state.qy, state.qz], dim=-1)
    tgt = torch.as_tensor(target_positions, dtype=q.dtype, device=q.device)
    npad = state.npad
    mask = (torch.arange(npad, device=q.device) < state.n).to(q.dtype)
    tgt_pad = F.pad(tgt, (0, 0, 0, npad - tgt.shape[0]))
    return torch.sum(mask[:, None] * (q - tgt_pad) ** 2) / state.n


def stack_states(states: list[BodyState]) -> BodyState:
    """Stack same-shape BodyStates into one batched state (each tensor
    (B, npad)) for ``ensemble``."""
    if len({(s.n, s.npad) for s in states}) != 1:
        raise ValueError("shapes must match")
    return _with(states[0], (torch.stack(t) for t in
                             zip(*(_fields(s) for s in states))))


def ensemble(fn: Callable, **fn_kwargs) -> Callable:
    """``torch.func.vmap`` of a rollout-like function over a
    ``stack_states`` batch (BodyState is a pytree node, core/state.py):
    one batched computation instead of B sequential runs."""
    return torch.func.vmap(functools.partial(fn, **fn_kwargs))


def fit_initial_velocities(state0: BodyState, target_positions, *,
                           steps: int, dt, soft, iters: int = 50,
                           lr: float | None = None, method: str = "chunked",
                           verbose: bool = False):
    """Gradient-descend the initial velocities so the final positions hit
    ``target_positions``: the canonical adjoint-method demo (a boundary
    value problem solved through the simulator).  Returns (fitted state,
    losses).

    The default learning rate is scale-aware: positions ~ 1e12 m and
    steps*dt ~ 1e5..1e6 s give dL/dv ~ q * T / n; lr normalizes by T^2."""
    T = float(steps) * float(dt)
    lr = lr if lr is not None else 0.5 / T ** 2 * state0.n

    def value_and_grad(vs):
        vs = vs.detach().requires_grad_()
        st = dataclasses.replace(state0, vx=vs[0], vy=vs[1], vz=vs[2])
        loss = target_loss(rollout(st, steps=steps, dt=dt, soft=soft,
                                   method=method), target_positions)
        (g,) = torch.autograd.grad(loss, vs)
        return float(loss.detach()), g

    vs = torch.stack([state0.vx, state0.vy, state0.vz]).detach()
    best_loss, best_g = value_and_grad(vs)
    best = vs
    losses = [best_loss]
    for k in range(iters):
        if verbose:
            print(f"  iter {k:3d}  loss {best_loss:.6e}")
        cand = best - lr * best_g
        loss, g = value_and_grad(cand)
        # `<=` rejects NaN too (NaN comparisons are False): a diverged step
        # backtracks instead of poisoning `best`
        if loss <= best_loss:
            best, best_loss, best_g = cand, loss, g
        else:
            lr *= 0.5
        losses.append(best_loss)
    fitted = dataclasses.replace(state0, vx=best[0], vy=best[1], vz=best[2])
    return fitted, losses


__all__ = ["rollout", "trajectory", "target_loss", "stack_states",
           "ensemble", "fit_initial_velocities", "Accel"]
