"""Engine base classes: the ``SimulationNBodyInterface`` of the port.

Port of ``murb_tpu/models/base.py``.  The reference's abstract engine owns
the body state, G, dt, softening and a FLOPs model, and exposes
``computeOneIteration()`` (ref:
src/common/core/SimulationNBodyInterface.hpp:16-88).  Here an engine holds
a ``BodyState`` on one device and advances it with an acceleration
function plus explicit Euler.

``run(n)`` is a plain Python loop of steps; the kernels launch
asynchronously on the current stream, so the loop only waits on the
device at ``block_until_ready``.  (Capturing the step in a CUDA graph is
later work.)
"""
from __future__ import annotations

import torch

from murb_tpu_torch import DEFAULT_DT, DEFAULT_SOFTENING, G
from murb_tpu_torch.core.integrators import euler_update
from murb_tpu_torch.core.state import BodyState
from murb_tpu_torch.ops.common import Accel, flops_per_iteration
from murb_tpu_torch.utils import trace


class SimulationEngine:
    """Common interface; concrete engines provide ``_step``."""

    tag: str = "base"

    def __init__(self, bodies: BodyState, soft: float | None = None,
                 dt: float | None = None, **kwargs):
        if kwargs:
            # Fail loudly on misspelled engine options rather than silently
            # running with defaults.
            raise TypeError(f"unknown engine option(s): {sorted(kwargs)} "
                            f"for {type(self).__name__}")
        # Private copy: the caller's state is never aliased by the engine
        # (differential tests feed one initial state to two engines).
        self._state = bodies.clone()
        self.soft = float(DEFAULT_SOFTENING if soft is None else soft)
        self._dt = float(DEFAULT_DT if dt is None else dt)
        self.G = G
        self.flops_per_ite = flops_per_iteration(bodies.n)
        self._last_acc: Accel | None = None
        self._iteration = 0

    # ----------------------------------------------------------- properties
    @property
    def bodies(self) -> BodyState:
        return self._state

    @property
    def dt(self) -> float:
        return self._dt

    def set_dt(self, dt: float) -> None:
        """A new time step from the next iteration on (the viewer's PgUp
        and PgDn, murb_tpu/models/base.py:73)."""
        self._dt = float(dt)

    @property
    def allocated_bytes(self) -> int:
        return self._state.allocated_bytes

    @property
    def accelerations(self) -> Accel:
        """Accelerations from the last iteration (the analogue of
        ``getAccSoA()``)."""
        if self._last_acc is None:
            raise RuntimeError("no iteration computed yet")
        return self._last_acc

    # ------------------------------------------------------------- stepping
    def _step(self, state: BodyState) -> tuple[BodyState, Accel | None]:
        """``state -> (state, acc)``.  Subclasses override."""
        raise NotImplementedError

    def compute_one_iteration(self) -> None:
        with trace.span("step", iteration=self._iteration):
            self._state, self._last_acc = self._step(self._state)
        self._iteration += 1

    def run(self, n_iterations: int) -> None:
        """Advance ``n_iterations`` steps."""
        for _ in range(n_iterations):
            self.compute_one_iteration()

    def block_until_ready(self) -> None:
        if self._state.device.type == "cuda":
            torch.cuda.synchronize(self._state.device)

    def assert_finite(self) -> None:
        """Fail-fast NaN/Inf guard (the analogue of the reference's
        per-frame CUDA_CHECK abort, ref: src/murb/main.cpp:356-368).
        Waits on the device; call between frames."""
        bad = [k for k in ("qx", "qy", "qz", "vx", "vy", "vz")
               if not bool(torch.isfinite(getattr(self._state, k)).all())]
        if bad:
            raise FloatingPointError(
                f"non-finite state after iteration {self._iteration}: "
                f"{', '.join(bad)} (dt too large or softening too small?)")

    # ------------------------------------------------------------- plumbing
    def _gm(self, state: BodyState) -> torch.Tensor:
        """G*m_j, with G rounded to the state dtype first (the reference's
        ``devGM``, ref: SimulationNBodyCUDATileFullDevice.cu:41-45)."""
        g = torch.tensor(self.G, dtype=state.dtype).item()
        return state.m * g


class EulerAccelEngine(SimulationEngine):
    """An engine defined by an acceleration function + explicit Euler."""

    def _acc_fn(self, qx, qy, qz, gm) -> Accel:
        raise NotImplementedError

    def _step(self, state: BodyState):
        with trace.span("force"):
            acc = self._acc_fn(state.qx, state.qy, state.qz, self._gm(state))
        return euler_update(state, acc, self._dt), acc
