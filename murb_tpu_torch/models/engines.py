"""Concrete engines: the port's ``--im`` registry entries.

Port of the exact and single-cell proxy engines of
``murb_tpu/models/engines.py`` (ref registry: src/murb/main.cpp:205-270):

  cpu+naive           -> NaiveEngine      (plain broadcast oracle)
  cpu+nop             -> NopEngine        (harness-overhead baseline)
  cpu+optim/simd/omp  -> ChunkedEngine    (i-chunked plain sweep)
  gpu+tile            -> PallasTileEngine (kernel K3, ops/tile.py)
  gpu+tile+full...    -> HybridEngine     (kernel K4, ops/hybrid.py)
  fmm / barnes-hut    -> ProxyEngine      (kernels K1-K3, ops/proxy.py)

The tracking, integrator and distributed engines are not ported yet.
"""
from __future__ import annotations

import torch

from murb_tpu_torch.models.base import EulerAccelEngine, SimulationEngine
from murb_tpu_torch.ops.common import Accel
from murb_tpu_torch.ops.naive import acc_chunked, acc_naive
from murb_tpu_torch.ops.proxy_kernels import MAX_ORDER

# murb_tpu's engine defaults (murb_tpu/models/engines.py:357-363), fixed
# here until a caller needs another value.
BOX_MARGIN = 1.5    # box growth the static order pick pads for
COST_SLACK = 30.0   # how much costlier than the exact sweep the proxy may be


def not_yet_ported(what: str, item: str) -> NotImplementedError:
    """The error every branch of the JAX package that the port does not
    carry yet raises (never a silent substitute)."""
    return NotImplementedError(
        f"{what} is not yet ported to murb_tpu_torch (ROADMAP.md {item})")


class NopEngine(SimulationEngine):
    """Empty engine -- measures harness overhead
    (ref: src/murb/implem/SimulationNBodyNop.cpp:34-36)."""

    tag = "nop"

    def _step(self, state):
        zeros = torch.zeros_like(state.qx)
        return state, Accel(zeros, zeros, zeros)

    def run(self, n_iterations: int) -> None:
        self._iteration += n_iterations


class NaiveEngine(EulerAccelEngine):
    """Full-broadcast oracle (ref: SimulationNBodyNaive.cpp:34-53)."""

    tag = "xla+naive"

    def _acc_fn(self, qx, qy, qz, gm):
        return acc_naive(qx, qy, qz, gm, self.soft)


class ChunkedEngine(EulerAccelEngine):
    """i-chunked plain sweep (the reference's cpu+optim / cpu+simd /
    cpu+omp family)."""

    tag = "xla+chunked"

    def _acc_fn(self, qx, qy, qz, gm):
        return acc_chunked(qx, qy, qz, gm, self.soft)


class PallasTileEngine(EulerAccelEngine):
    """Exact fp32 sweep engine on kernel K3 (``tpu+tile`` / ``gpu+tile``).
    The JAX engine's block autotuner is TPU-only and not ported."""

    tag = "tpu+tile"

    def _acc_fn(self, qx, qy, qz, gm):
        from murb_tpu_torch.ops.tile import acc_tile

        return acc_tile(qx, qy, qz, gm, self.soft)


class HybridEngine(EulerAccelEngine):
    """Tiered exact sweep engine on kernel K4 (``tpu+hybrid``, the
    reference's gpu+tile+full).  fp64 state defaults to the extended tier
    (passes=3), fp32 state to passes=2."""

    tag = "tpu+hybrid"

    def __init__(self, bodies, soft=None, dt=None, *,
                 passes: int | None = None, **kw):
        if passes is None:
            passes = 3 if bodies.dtype == torch.float64 else 2
        if passes not in (1, 2, 3):
            raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
        self.passes = passes
        super().__init__(bodies, soft, dt, **kw)

    def _acc_fn(self, qx, qy, qz, gm):
        from murb_tpu_torch.ops.hybrid import acc_hybrid

        return acc_hybrid(qx, qy, qz, gm, self.soft, passes=self.passes)


class ProxyEngine(EulerAccelEngine):
    """Chebyshev-proxy fast solver, single-cell policy (see ops/proxy.py).

    Auto policy from the initial bounding box and force tolerance
    (murb_tpu/models/engines.py:406-444): one global expansion while the
    box admits m <= 20, picked by the calibrated bound and then validated
    (escalated or descended) by measurement; the exact K4 sweep when the
    cost model finds the proxy far costlier than the direct sum (small N)
    -- check ``engine.using_proxy``.  Boxes that need the multi-level
    hierarchy and ``cells=2`` raise "not yet ported".  The JAX engine's
    adaptive-solver consideration on a rejected proxy is skipped: that
    planner is not ported, and its cost model rests on TPU-measured rates.
    """

    tag = "tpu+proxy"

    def __init__(self, bodies, soft=None, dt=None, *, m: int = 0,
                 cells: int = 0, levels: int = 0, tol: float = 1e-4,
                 adapt_every: int = 0, **kw):
        super().__init__(bodies, soft, dt, **kw)
        self.tol = tol
        self.adapt_every = int(adapt_every)
        self.validated_err: float | None = None
        self.validated_half: float | None = None
        self._auto = m == 0 and levels == 0
        if self._auto:
            self._configure()
        else:
            if levels:
                raise not_yet_ported("tpu+proxy levels > 0 (the multi-level "
                                     "hierarchy, kernels K7-K9)",
                                     "Queue 1 item 7")
            if cells not in (0, 1):
                raise not_yet_ported(f"tpu+proxy cells={cells} (the octant "
                                     "grid, kernels K8/K9)", "Queue 1 item 7")
            self.m, self.levels, self.cells = int(m), 0, 1
            self.using_proxy = self.m <= MAX_ORDER

    def _configure(self) -> None:
        """Derive (m, levels, cells, using_proxy) from the CURRENT box --
        the auto policy, shared by construction and mid-run adaptation."""
        from murb_tpu_torch.ops.proxy import half_extent, required_order

        round4 = lambda x: (x + 3) // 4 * 4
        half = half_extent(self._state.unpadded())
        # margin=0: the BOX_MARGIN factor already pads for growth
        # (rationale in murb_tpu/models/engines.py:_configure)
        m1 = round4(required_order(half * BOX_MARGIN, self.soft,
                                   self.tol, margin=0))
        if m1 > 20:
            raise not_yet_ported(
                f"tpu+proxy on this box (needs m={m1} > 20: the multi-level "
                "hierarchy, kernels K7-K9)", "Queue 1 item 7")
        self.m, self.levels, self.cells = int(m1), 0, 1
        self._apply_cost_model()
        if self.using_proxy:
            self._validate_order(half)

    def _apply_cost_model(self) -> None:
        # The proxy must not be drastically costlier than the exact sweep
        # (at small N the node work dominates); rough op counts with a
        # generous slack (murb_tpu/models/engines.py:575-592).
        self.using_proxy = self.m <= MAX_ORDER
        if self.using_proxy:
            n = self._state.npad
            p_tot = self.cells ** 3 * self.m ** 3
            est = self.cells ** 3 * 8 * n * self.m ** 3 + 14 * p_tot ** 2
            if est > COST_SLACK * 14 * n * n:
                self.using_proxy = False

    def _validate_order(self, half: float) -> None:
        """Measured-order selection (ops/validate): measure the configured
        solver against an exact strided sample and escalate (or descend)
        until the tol contract is met."""
        from murb_tpu_torch.ops.proxy import acc_proxy
        from murb_tpu_torch.ops.validate import certified_half, validate_config

        st = self._state
        gm = self._gm(st)

        def make_acc(m, levels, cells):
            if levels:
                raise not_yet_ported(
                    f"the validation ladder's hierarchy rung (m={m}, "
                    f"levels={levels}; kernels K7-K9)", "Queue 1 item 7")

            def acc(qx, qy, qz, g):
                return acc_proxy(qx, qy, qz, g, self.soft, m=m,
                                 cells=cells)

            return acc

        m, levels, cells, err = validate_config(
            st.qx, st.qy, st.qz, gm, self.soft, self.tol,
            self.m, self.levels, self.cells, half, make_acc)
        self.validated_err = err
        self.validated_half = certified_half(m, levels, float(half), err,
                                             self.soft, self.tol)
        if (m, levels, cells) != (self.m, self.levels, self.cells):
            self.m, self.levels, self.cells = int(m), int(levels), int(cells)
            self._apply_cost_model()

    def maybe_adapt(self) -> bool:
        """Mid-run order adaptation: when the system expanded past the
        validated order's certified box (``proxy_health`` not ok),
        re-derive the config from the current box.  Returns True if the
        engine was reconfigured.  Waits on the device; call between
        frames."""
        if not self._auto or self.proxy_health()["ok"]:
            return False
        old = (self.m, self.levels, self.cells, self.using_proxy)
        self._configure()
        return (self.m, self.levels, self.cells, self.using_proxy) != old

    def compute_one_iteration(self) -> None:
        if (self.adapt_every and self._iteration
                and self._iteration % self.adapt_every == 0):
            self.maybe_adapt()
        super().compute_one_iteration()

    def _acc_fn(self, qx, qy, qz, gm):
        """The configured solver (murb_tpu's ``_acc_solver``)."""
        if not self.using_proxy:
            # exact fallback: the fp32-class K4 tier
            from murb_tpu_torch.ops.hybrid import acc_hybrid

            return acc_hybrid(qx, qy, qz, gm, self.soft, passes=2)
        from murb_tpu_torch.ops.proxy import acc_proxy

        return acc_proxy(qx, qy, qz, gm, self.soft, m=self.m,
                         cells=self.cells)

    def proxy_health(self) -> dict:
        """Is the order still adequate for the CURRENT box?  Reports the
        order the box would need now (waits on the device)."""
        from murb_tpu_torch.ops.proxy import half_extent, required_order

        half = half_extent(self._state.unpadded())
        needed = required_order(half / self.cells, self.soft)
        if self.validated_half is not None:
            # measured contract (ops/validate.certified_half)
            ok = half <= self.validated_half
        else:
            ok = needed <= self.m
        return {
            "using_proxy": self.using_proxy,
            "m": self.m,
            "cells": self.cells,
            "levels": self.levels,
            "required_m_now": needed,
            "ok": (not self.using_proxy) or ok,
        }
