"""Concrete engines: the port's ``--im`` registry entries.

Port of ``murb_tpu/models/engines.py`` but its distributed engines (ref
registry: src/murb/main.cpp:205-270):

  cpu+naive           -> NaiveEngine      (plain broadcast oracle)
  cpu+nop             -> NopEngine        (harness-overhead baseline)
  cpu+optim/simd/omp  -> ChunkedEngine    (i-chunked plain sweep)
  gpu+tile            -> PallasTileEngine (kernel K3, ops/tile.py)
  gpu+tile+full...    -> HybridEngine     (kernel K4, ops/hybrid.py)
  tpu+mxu             -> MXUEngine        (kernel K13, ops/mxu.py)
  fmm / barnes-hut    -> ProxyEngine      (K1-K3, K7-K9, K10-K12;
                                           ops/proxy.py, ops/fmm.py,
                                           ops/sparse_fmm.py)
  tpu+kdk, +yoshida4  -> KDKEngine, Yoshida4Engine
  gpu+leapfrog        -> LeapfrogEngine
  gpu+tracking        -> TrackingEngine
  gpu+leapfrog+tracking -> LeapfrogTrackingEngine
  gpu+tracking+multi  -> MultiGalaxyTrackingEngine

The tracked engines record (energy, |L|, density center) every iteration
in float64.  ``run(n)`` keeps each step's metrics on the device and copies
the whole series to the host once; ``compute_one_iteration`` records its
row at once, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from murb_tpu_torch.core import metrics as metrics_mod
from murb_tpu_torch.core.history import (MultiGalaxySimulationHistory,
                                         SimulationHistory)
from murb_tpu_torch.core.integrators import (LeapfrogAux, euler_update,
                                             kdk_step, leapfrog_first,
                                             leapfrog_last, leapfrog_middle,
                                             yoshida4_step)
from murb_tpu_torch.models.base import EulerAccelEngine, SimulationEngine
from murb_tpu_torch.ops import acc_auto as _default_exact_acc
from murb_tpu_torch.ops.common import Accel
from murb_tpu_torch.ops.naive import acc_chunked, acc_naive
from murb_tpu_torch.ops.proxy_kernels import MAX_ORDER

#: the validation ladders' step of a lossy M2L tier that misses tol
_STRONGER = {"bf16x3": "mixed", "mixed": "fp32"}


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
    cpu+omp family), ``chunk`` targets at a time."""

    tag = "xla+chunked"

    def __init__(self, bodies, soft=None, dt=None, *, chunk: int = 1024,
                 **kw):
        super().__init__(bodies, soft, dt, **kw)
        self.chunk = min(int(chunk), bodies.npad)

    def _acc_fn(self, qx, qy, qz, gm):
        return acc_chunked(qx, qy, qz, gm, self.soft, chunk=self.chunk)


class PallasTileEngine(EulerAccelEngine):
    """Exact fp32 sweep engine on kernel K3 (``tpu+tile`` / ``gpu+tile``).

    Block geometry (murb_tpu/models/engines.py:219-291): explicit
    ``block_i``/``block_j`` win; otherwise a persisted autotune result for
    this (kernel, npad, device) is used when one exists, and
    ``autotune=True`` (or MURB_AUTOTUNE=1) runs the first-use sweep
    (utils/autotune.py), whose result stays in ``tuned``; with none of
    these the kernel's default geometry (0, 0)."""

    tag = "tpu+tile"
    #: the sweep's design in its autotune key: K3's register-tiled, split-j
    #: kernel (csrc/tile.cu) has other best blocks than its first design, so
    #: a pick cached for that one is not read for this one
    design = "@k3rows"

    def __init__(self, bodies, soft=None, dt=None, *, block_i: int = 0,
                 block_j: int = 0, autotune: bool | None = None, **kw):
        super().__init__(bodies, soft, dt, **kw)
        from murb_tpu_torch.ops.cuda import check_blocks

        check_blocks(self.tag, block_i, block_j)
        self.block_i, self.block_j = int(block_i), int(block_j)
        self.tuned: dict | None = None
        if not (block_i or block_j):
            self._resolve_blocks(autotune)

    @property
    def _tune_tag(self) -> str:
        return f"{self.tag}{self.design}"

    def _resolve_blocks(self, autotune: bool | None) -> None:
        from murb_tpu_torch.ops.cuda import check_blocks
        from murb_tpu_torch.utils import autotune as at

        if autotune is None:
            autotune = at.enabled()
        tuned = at.lookup(self._tune_tag, self._state.npad,
                          device=self._state.device)
        if tuned is not None:
            try:   # a cached pair the sweeps are not compiled for is skipped
                check_blocks(self._tune_tag, int(tuned.get("block_i", 0)),
                             int(tuned.get("block_j", 0)))
            except ValueError:
                tuned = None
        if tuned is None and autotune:
            tuned = self._run_autotune()
        if tuned:
            self.tuned = tuned
            self.block_i = int(tuned.get("block_i", 0))
            self.block_j = int(tuned.get("block_j", 0))

    def _run_autotune(self) -> dict:
        """Time every candidate geometry over a few Euler steps of a copy
        of the state (utils/autotune.tune) and keep the fastest."""
        from murb_tpu_torch.utils import autotune as at

        def make_run(params):
            bi, bj = params["block_i"], params["block_j"]

            def run(st, n):
                for _ in range(n):
                    acc = self._acc_blocks(st.qx, st.qy, st.qz, self._gm(st),
                                           bi, bj)
                    st = euler_update(st, acc, self._dt)
                return st

            return run

        return at.tune(self._tune_tag, self._state.npad, make_run,
                       self._state, device=self._state.device)

    def _acc_blocks(self, qx, qy, qz, gm, bi, bj):
        from murb_tpu_torch.ops.tile import acc_tile

        return acc_tile(qx, qy, qz, gm, self.soft, block_i=bi, block_j=bj)

    def _acc_fn(self, qx, qy, qz, gm):
        return self._acc_blocks(qx, qy, qz, gm, self.block_i, self.block_j)


class HybridEngine(PallasTileEngine):
    """Tiered exact sweep engine on kernel K4 (``tpu+hybrid``, the
    reference's gpu+tile+full).  fp64 state defaults to the extended tier
    (passes=3), fp32 state to passes=2; each tier tunes its blocks
    separately."""

    tag = "tpu+hybrid"

    def __init__(self, bodies, soft=None, dt=None, *,
                 passes: int | None = None, **kw):
        if passes is None:
            passes = 3 if bodies.dtype == torch.float64 else 2
        if passes not in (1, 2, 3):
            raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
        self.passes = passes  # _resolve_blocks may time the kernel
        super().__init__(bodies, soft, dt, **kw)

    @property
    def _tune_tag(self) -> str:
        # passes 1/2 launch K3's kernel; passes 3 is K4's own
        design = self.design if self.passes < 3 else ""
        return f"{self.tag}/p{self.passes}{design}"

    def _acc_blocks(self, qx, qy, qz, gm, bi, bj):
        from murb_tpu_torch.ops.hybrid import acc_hybrid

        return acc_hybrid(qx, qy, qz, gm, self.soft, passes=self.passes,
                          block_i=bi, block_j=bj)


class MXUEngine(PallasTileEngine):
    """Norm-expansion all-pairs engine on kernel K13 (``tpu+mxu``), the
    large-N flagship of murb_tpu's exact ladder and the analogue of the
    reference's gpu+tile+full200k.  ``precision``: murb_tpu's tiers, met
    in TF32 on the tensor cores by K13 (ops/mxu.py)."""

    tag = "tpu+mxu"
    #: K13's tensor-core design (csrc/mxu.cu) has other best blocks than
    #: its first, fp32 design, so a pick cached for that one is not read
    design = "@k13mma"

    def __init__(self, bodies, soft=None, dt=None, *,
                 precision: str = "high", **kw):
        from murb_tpu_torch.ops.mxu import check_precisions

        check_precisions(precision)
        self.precision = precision  # _resolve_blocks may time the kernel
        super().__init__(bodies, soft, dt, **kw)

    def _acc_blocks(self, qx, qy, qz, gm, bi, bj):
        from murb_tpu_torch.ops.mxu import acc_mxu

        return acc_mxu(qx, qy, qz, gm, self.soft, block_i=bi, block_j=bj,
                       precision=self.precision)


class ProxyEngine(EulerAccelEngine):
    """Chebyshev-proxy fast solver family (see ops/proxy.py, ops/fmm.py,
    ops/sparse_fmm.py).

    Auto policy from the initial bounding box and force tolerance
    (murb_tpu/models/engines.py:406-444): one global expansion while the
    box admits m <= 20; the L-level hierarchy (kernels K7-K9) for wider
    boxes, its depth from ops/fmm.best_depth; when the cost model rejects
    every dense configuration (a clustered box whose softening lies far
    below the feasible finest cells), the adaptive sparse hierarchy with
    the exact P2P near field (K10-K12) if its planner finds it cheaper than
    the exact sweep, else the exact K4 sweep -- check ``engine.using_proxy``
    and ``engine.near_mode``.  The pick is then validated (escalated or
    descended) by measurement unless ``validate=False``.  ``near``:
    "auto", "interp" (never the adaptive solver) or "adaptive" (always).
    ``cells=2`` runs the octant mode, ``levels=L`` the hierarchy
    explicitly.  ``m2l_dots``: the M2L sweeps' tier ("fp32", "mixed",
    "bf16x3"; ops/fmm.level_sweep, ops/sparse_fmm.m2l_sparse_level); the
    validation ladders step a lossy tier that misses ``tol`` toward fp32.
    """

    tag = "tpu+proxy"

    def __init__(self, bodies, soft=None, dt=None, *, m: int = 0,
                 cells: int = 0, levels: int = 0, tol: float = 1e-4,
                 max_m: int = MAX_ORDER, heavy_k: int = 1,
                 box_margin: float = 1.5, cost_slack: float = 30.0,
                 adapt_every: int = 0, validate: bool = True,
                 near: str = "auto", m2l_dots: str = "fp32", **kw):
        from murb_tpu_torch.ops.fmm import check_m2l_dots

        super().__init__(bodies, soft, dt, **kw)
        self.tol = tol
        # murb_tpu's options (murb_tpu/models/engines.py:357-376): the
        # highest single-cell order, the heavy bodies summed exactly, the
        # box growth the static order pick pads for, and how much costlier
        # than the exact sweep the fast solver may be
        self.max_m = int(max_m)
        self.heavy_k = int(heavy_k)
        self.box_margin = float(box_margin)
        self.cost_slack = float(cost_slack)
        self.adapt_every = int(adapt_every)
        self.validate = bool(validate)
        self.validated_err: float | None = None
        self.validated_half: float | None = None
        if near not in ("auto", "interp", "adaptive"):
            raise ValueError(f"unknown near mode: {near!r} "
                             "(auto | interp | adaptive)")
        self.near = near
        self.near_mode = "interp"   # resolved: "interp" | "adaptive"
        self._plan = None           # SparsePlan when near_mode == "adaptive"
        self.m2l_dots = check_m2l_dots(m2l_dots)
        self._auto = m == 0 and levels == 0
        if self._auto:
            self._configure()
        else:
            if m and levels == 0 and cells == 0:
                cells = 1
            self.m, self.levels, self.cells = int(m), int(levels), \
                int(cells or 1)
            self.using_proxy = self.m <= self.max_m
            if near == "adaptive":
                self._configure_adaptive(force=True)

    def _configure(self) -> None:
        """Derive (m, levels, cells, using_proxy, near_mode) from the
        CURRENT box -- the auto policy, shared by construction and mid-run
        adaptation."""
        from murb_tpu_torch.ops.proxy import half_extent, required_order

        round4 = lambda x: (x + 3) // 4 * 4
        half = half_extent(self._state.unpadded())
        # margin=0: the box_margin factor already pads for growth
        # (rationale in murb_tpu/models/engines.py:_configure)
        m1 = round4(required_order(half * self.box_margin, self.soft,
                                   self.tol, margin=0))
        self.near_mode, self._plan = "interp", None
        # wider boxes go to the hierarchy, whose finest cells restore
        # eps/h ~ 1 at any scale
        m, levels = (m1, 0) if m1 <= 20 else self._best_depth(half)
        self.m, self.levels, self.cells = int(m), int(levels), 1
        self._apply_cost_model()
        if self.near == "adaptive" or (self.near == "auto"
                                       and not self.using_proxy):
            # every dense configuration was rejected: try the adaptive
            # sparse hierarchy before the exact fallback
            self._configure_adaptive(force=self.near == "adaptive")
        if self.using_proxy and self.validate:
            if self.near_mode == "adaptive":
                self._validate_adaptive()
            else:
                self._validate_order(half)

    def _active_q(self) -> np.ndarray:
        """(n_active, 3) float32 positions of the massive bodies (host): the
        input of the adaptive planner and its health replica."""
        u = self._state.unpadded()
        sel = u["m"] > 0
        return np.stack([u["qx"][sel], u["qy"][sel], u["qz"][sel]],
                        1).astype(np.float32)

    def _configure_adaptive(self, force: bool = False) -> None:
        """Plan the adaptive sparse hierarchy for the current distribution
        (ops/sparse_fmm) and adopt it when its cost model beats the exact
        kernel's, or always when ``near="adaptive"`` forces it.  The cost
        models keep murb_tpu's TPU rates (ROADMAP.md: an H100 calibration is
        open), so the port declines and adopts where murb_tpu does."""
        from murb_tpu_torch.ops.sparse_fmm import (adaptive_order,
                                                   best_adaptive_plan,
                                                   exact_cost_ms,
                                                   plan_adaptive)

        q = self._active_q()
        npad, dev = self._state.npad, self._state.device
        explicit = not self._auto
        m0 = self.m if (explicit and self.m) else adaptive_order(self.tol)
        if explicit and self.levels:
            plan = plan_adaptive(q, npad, m0, min(3, self.levels - 1),
                                 self.levels, device=dev)
            est_ms = 0.0
        else:
            plan, est_ms = best_adaptive_plan(q, npad, m0, device=dev)
        if not force and est_ms >= min(1.0, self.cost_slack / 30.0) \
                * exact_cost_ms(npad):
            return  # the exact fallback stays the honest pick
        self._plan = plan
        self.near_mode = "adaptive"
        self.m, self.levels, self.cells = plan.m, plan.levels, 1
        self.using_proxy = True

    def _plan_at(self, m: int, rank: int | None = None):
        """The current plan at order ``m`` (its geometry and capacities do
        not depend on m), optionally with another M2L compression rank."""
        plan = self._plan._replace(m=int(m))
        return plan if rank is None else plan._replace(m2l_rank=rank)

    def _validate_adaptive(self) -> None:
        """Measured-order selection for the adaptive solver
        (murb_tpu/models/engines.py:498-573): its accuracy is scale-free, so
        the ladder moves m only -- by 2 up to 12 while the error misses tol,
        else down to 4 while it still meets it.  On a first-rung miss it
        first drops the M2L compression (when that helps), then steps a
        lossy dot tier toward fp32 (bf16x3 -> mixed -> fp32) until tol is
        met or fp32 is reached -- where murb_tpu stops at the first step
        that does not improve and so can skip fp32 -- and only then
        escalates m."""
        from murb_tpu_torch.ops.sparse_fmm import (acc_adaptive,
                                                   default_m2l_rank)
        from murb_tpu_torch.ops.validate import measured_force_error

        st = self._state
        gm = self._gm(st)

        def err_at(m, rank=None):
            plan, tier = self._plan_at(m, rank), self.m2l_dots
            return measured_force_error(
                st.qx, st.qy, st.qz, gm, self.soft,
                lambda qx, qy, qz, g: acc_adaptive(qx, qy, qz, g, self.soft,
                                                   plan, heavy_k=self.heavy_k,
                                                   m2l_dots=tier))

        m = self.m
        err = err_at(m)
        if err <= self.tol:
            while m - 2 >= 4:
                derr = err_at(m - 2)
                if derr > self.tol:
                    break
                m, err = m - 2, derr
        else:
            rank = self._plan.m2l_rank
            if (default_m2l_rank(m) if rank < 0 else rank) > 0:
                err0 = err_at(m, rank=0)
                if err0 < err:
                    self._plan, err = self._plan._replace(m2l_rank=0), err0
            # step a lossy tier through to fp32 (murb_tpu stops at the
            # first step that does not improve and can skip fp32)
            while err > self.tol and self.m2l_dots in _STRONGER:
                old, self.m2l_dots = self.m2l_dots, _STRONGER[self.m2l_dots]
                errt = err_at(m)
                print(f"adaptive validation: m2l_dots={old} floors at "
                      f"{err:.1e} > tol; dropping to {self.m2l_dots} "
                      f"({errt:.1e})")
                err = errt
            while err > self.tol and m + 2 <= 12:
                m += 2
                err = err_at(m)
            if err > self.tol:
                print(f"WARNING: adaptive-solver validation missed "
                      f"tol={self.tol:.1e} at m={m} (measured err "
                      f"{err:.1e}); keeping m={m}")
        self.m = int(m)
        self._plan = self._plan_at(m)
        self.validated_err = err
        # scale-free accuracy: box growth never invalidates the order;
        # proxy_health watches the capacities instead
        self.validated_half = None

    def _best_depth(self, half: float) -> tuple[int, int]:
        """(m, levels) from the shared depth-cost policy (ops/fmm.best_depth,
        calibrated on a TPU; ROADMAP.md)."""
        from murb_tpu_torch.ops.fmm import best_depth

        return best_depth(self._state.npad, half, self.soft, self.tol)

    def _apply_cost_model(self) -> None:
        # The fast solver must not be drastically costlier than the exact
        # sweep (at small N the node work dominates); rough op counts with
        # a generous slack (murb_tpu/models/engines.py:575-592).
        self.using_proxy = self.m <= self.max_m
        if self.using_proxy:
            n = self._state.npad
            if self.levels:
                est = 8 * n * self.m ** 3 + 686 * 8 ** self.levels \
                    * self.m ** 6
            else:
                p_tot = self.cells ** 3 * self.m ** 3
                est = self.cells ** 3 * 8 * n * self.m ** 3 + 14 * p_tot ** 2
            if est > self.cost_slack * 14 * n * n:
                self.using_proxy = False

    def _validate_order(self, half: float) -> None:
        """Measured-order selection (ops/validate): measure the configured
        solver against an exact strided sample and escalate (or descend)
        until the tol contract is met; the ladder's hierarchy rungs run
        acc_fmm at the engine's M2L tier.  When the ladder ends above tol
        under a lossy tier and measured a hierarchy rung, the tier steps
        toward fp32 (bf16x3 -> mixed -> fp32) and the ladder runs again
        from the engine's pick, until tol is met or fp32 is reached
        (murb_tpu/models/engines.py:620-645, which skips the drop when the
        ladder's best config is a levels = 0 rung, and stops at a step that
        does not improve)."""
        from murb_tpu_torch.ops.proxy import validation_ladder
        from murb_tpu_torch.ops.validate import certified_half, validate_config

        st = self._state
        rungs = set()        # the levels of the rungs the ladders measured

        def ladder(tier):
            make = validation_ladder(self.soft, m2l_dots=tier,
                                     heavy_k=self.heavy_k)

            def make_acc(m, levels, cells):
                rungs.add(levels)
                return make(m, levels, cells)

            return validate_config(
                st.qx, st.qy, st.qz, self._gm(st), self.soft, self.tol,
                self.m, self.levels, self.cells, half, make_acc)

        m, levels, cells, err = ladder(self.m2l_dots)
        while (err > self.tol and self.m2l_dots in _STRONGER
               and any(rungs)):
            old, self.m2l_dots = self.m2l_dots, _STRONGER[self.m2l_dots]
            m, levels, cells, err2 = ladder(self.m2l_dots)
            print(f"hierarchy validation: m2l_dots={old} floors at "
                  f"{err:.1e} > tol; dropping to {self.m2l_dots} "
                  f"({err2:.1e})")
            err = err2
        self.validated_err = err
        self.validated_half = certified_half(m, levels, float(half), err,
                                             self.soft, self.tol)
        if (m, levels, cells) != (self.m, self.levels, self.cells):
            self.m, self.levels, self.cells = int(m), int(levels), int(cells)
            self._apply_cost_model()

    def maybe_adapt(self) -> bool:
        """Mid-run adaptation: when ``proxy_health`` is not ok (the box
        outgrew the validated order, or the distribution the adaptive
        plan's capacities), re-derive the configuration from the current
        state.  Returns True if the engine was reconfigured.  Waits on the
        device; call between frames."""
        if not self._auto or self.proxy_health()["ok"]:
            return False
        old = (self.m, self.levels, self.cells, self.using_proxy,
               self.near_mode, self._plan)
        self._configure()
        return (self.m, self.levels, self.cells, self.using_proxy,
                self.near_mode, self._plan) != old

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
        if self.near_mode == "adaptive":
            from murb_tpu_torch.ops.sparse_fmm import acc_adaptive

            return acc_adaptive(qx, qy, qz, gm, self.soft, self._plan,
                                heavy_k=self.heavy_k,
                                m2l_dots=self.m2l_dots)
        if self.levels:
            from murb_tpu_torch.ops.fmm import acc_fmm

            return acc_fmm(qx, qy, qz, gm, self.soft, m=self.m,
                           levels=self.levels, heavy_k=self.heavy_k,
                           m2l_dots=self.m2l_dots)
        from murb_tpu_torch.ops.proxy import acc_proxy

        return acc_proxy(qx, qy, qz, gm, self.soft, m=self.m,
                         cells=self.cells, heavy_k=self.heavy_k)

    def proxy_health(self) -> dict:
        """Is the configuration still adequate for the CURRENT state?  The
        order the box would need now, or, in adaptive mode (scale-free
        accuracy), whether the distribution still fits the plan's
        occupied-cell and pair capacities.  Waits on the device."""
        if self.near_mode == "adaptive":
            return _adaptive_health(self._active_q(), self._state.npad,
                                    self._plan)
        from murb_tpu_torch.ops.fmm import fmm_order
        from murb_tpu_torch.ops.proxy import half_extent, required_order

        half = half_extent(self._state.unpadded())
        if self.levels:
            needed = fmm_order(half, self.soft, self.levels)
        else:
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


def _adaptive_health(q: np.ndarray, npad: int, plan) -> dict:
    """Capacity health of an adaptive plan on the massive bodies ``q``
    (host replicas of the device's occupied lists and pair count), the
    contract of murb_tpu's adaptive proxy_health."""
    from murb_tpu_torch.ops.p2p import estimate_brick_pairs
    from murb_tpu_torch.ops.sparse_fmm import level_stats, p2p_capacity_needed

    stats = level_stats(q, plan.dense_levels, plan.levels)
    npairs = estimate_brick_pairs(q, npad, plan.levels)
    return {
        "using_proxy": True,
        "m": plan.m,
        "cells": 1,
        "levels": plan.levels,
        "near": "adaptive",
        "required_m_now": plan.m,   # scale-free
        "n_cells_now": tuple(stats),
        "cell_caps": plan.cell_caps,
        "p2p_pairs_now": npairs,
        "p2p_pmax": plan.p2p_pmax,
        "ok": (all(nc <= cap for nc, cap in zip(stats, plan.cell_caps))
               and p2p_capacity_needed(npairs) <= plan.p2p_pmax),
    }


# ------------------------------------------------- integrators and tracking
def _resolve_metric_dtype(metric_dtype) -> torch.dtype:
    """float64 unless the caller asks otherwise: the reference computes its
    metrics in double (ref: main.cpp:247-248), and the card and the CPU
    both have native fp64 (murb_tpu falls back to fp32 without x64)."""
    return torch.float64 if metric_dtype is None else metric_dtype


def _fused_force_phi(qx, qy, qz, gm, soft, fused_proxy_m, fused_fmm,
                     fused_adaptive=None, m2l_dots: str = "fp32"):
    """(Accel, phi) from one far-field pass: the adaptive hierarchy when
    ``fused_adaptive`` (a SparsePlan) is set, the L-level hierarchy when
    ``fused_fmm`` = (m, levels) is, both at the M2L tier ``m2l_dots``, else
    the single-level proxy."""
    if fused_adaptive is not None:
        from murb_tpu_torch.ops.sparse_fmm import force_and_potential_adaptive

        return force_and_potential_adaptive(qx, qy, qz, gm, soft,
                                            fused_adaptive,
                                            m2l_dots=m2l_dots)
    if fused_fmm:
        from murb_tpu_torch.ops.fmm import force_and_potential_fmm

        return force_and_potential_fmm(qx, qy, qz, gm, soft, m=fused_fmm[0],
                                       levels=fused_fmm[1],
                                       m2l_dots=m2l_dots)
    from murb_tpu_torch.ops.proxy import force_and_potential_proxy

    return force_and_potential_proxy(qx, qy, qz, gm, soft, m=fused_proxy_m)


def _phi_metrics(state, phi, soft, out_dtype):
    """(energy, |L|, density center) with the potential already in hand:
    what the fused force+potential pass buys, no second sweep."""
    return (metrics_mod.energy_from_phi(state, phi, soft, out_dtype),
            metrics_mod.angular_momentum(state, out_dtype),
            metrics_mod.density_center(state, out_dtype))


def _fused_proxy_health(state, soft, fused_proxy_m, fused_fmm,
                        validated_half=None,
                        fused_adaptive=None) -> dict | None:
    """Validity of a tracking engine's fused far-field pass (the contract
    of ProxyEngine.proxy_health); None when the engine runs none.
    ``validated_half``: the box half-extent a measured order is certified
    for (ops/validate.certified_half), instead of the static bound."""
    if fused_adaptive is not None:
        u = state.unpadded()
        sel = u["m"] > 0
        q = np.stack([u["qx"][sel], u["qy"][sel], u["qz"][sel]],
                     1).astype(np.float32)
        return _adaptive_health(q, state.npad, fused_adaptive)
    if not (fused_proxy_m or fused_fmm):
        return None
    from murb_tpu_torch.ops.fmm import fmm_order
    from murb_tpu_torch.ops.proxy import half_extent, required_order

    half = half_extent(state.unpadded())
    if fused_fmm:
        m, levels = fused_fmm
        needed = fmm_order(half, soft, levels)
    else:
        m, levels = fused_proxy_m, 0
        needed = required_order(half, soft)
    ok = (half <= validated_half if validated_half is not None
          else needed <= m)
    return {"using_proxy": True, "m": m, "cells": 1, "levels": levels,
            "required_m_now": needed, "ok": ok}


def _pack(mets) -> torch.Tensor:
    """(energy, |L|, density center) as one (..., 5) device tensor, so a
    step's row (or a galaxy stack of them) leaves the device in one copy."""
    e, l, dc = mets
    return torch.cat([e[..., None], l[..., None], dc], -1)


class KDKEngine(SimulationEngine):
    """Textbook kick-drift-kick symplectic integrator over any kernel."""

    tag = "tpu+kdk"
    _integrator = staticmethod(kdk_step)

    def __init__(self, bodies, soft=None, dt=None, *, acc_fn=None, **kw):
        super().__init__(bodies, soft, dt, **kw)
        self._acc = acc_fn  # (qx, qy, qz, gm, soft) -> Accel

    def _acc_fn(self, qx, qy, qz, gm):
        return (self._acc or _default_exact_acc)(qx, qy, qz, gm, self.soft)

    def _step(self, state):
        gm = self._gm(state)
        return type(self)._integrator(
            state, lambda x, y, z: self._acc_fn(x, y, z, gm), self._dt), None


class Yoshida4Engine(KDKEngine):
    """4th-order symplectic integrator (Yoshida triple-jump): three force
    evaluations per step for an O(dt^4) energy error."""

    tag = "tpu+yoshida4"
    _integrator = staticmethod(yoshida4_step)


class LeapfrogEngine(SimulationEngine):
    """Phase-split leapfrog: one force evaluation per iteration, the phase
    (first / middle / last) picked by the iteration counter as the
    reference dispatches it (ref: src/common/core/CUDABodies.cu:327-351).
    Needs the total iteration count up front (ref ctor:
    SimulationNBodyCUDALeapfrog.hpp:27-30)."""

    tag = "tpu+leapfrog"

    def __init__(self, bodies, soft=None, dt=None, *, num_iterations: int,
                 acc_fn=None, **kw):
        super().__init__(bodies, soft, dt, **kw)
        self.num_iterations = int(num_iterations)
        self._acc = acc_fn
        self._aux = LeapfrogAux.zeros_like(self._state)

    def _acc_fn(self, qx, qy, qz, gm):
        return (self._acc or _default_exact_acc)(qx, qy, qz, gm, self.soft)

    def _phase(self):
        """(force positions, finish(acc) -> (state, aux)) of this
        iteration's phase: x_0 first, the x_n buffer afterwards (ref:
        SimulationNBodyCUDALeapfrog.cu:335-346)."""
        st, aux, dt = self._state, self._aux, self._dt
        if self._iteration == 0:
            return ((st.qx, st.qy, st.qz),
                    lambda acc: leapfrog_first(st, aux, acc, dt))
        if self._iteration < self.num_iterations - 1:
            return ((aux.nqx, aux.nqy, aux.nqz),
                    lambda acc: leapfrog_middle(st, aux, acc, dt))
        return (aux.nqx, aux.nqy, aux.nqz), lambda acc: leapfrog_last(st, aux)

    def compute_one_iteration(self) -> None:
        q, finish = self._phase()
        acc = self._acc_fn(*q, self._gm(self._state))
        self._state, self._aux = finish(acc)
        self._last_acc = acc
        self._iteration += 1


_TRACKING_OPTIONS = ("metric_dtype", "metrics_method", "metrics_proxy_m",
                     "fused_proxy_m", "fused_fmm", "fused_adaptive",
                     "m2l_dots", "validated_half")


class _Tracked:
    """What the tracked engines share: the history, the metrics options,
    and a run loop whose metric rows stay on the device until one copy at
    its end.  A subclass provides ``_advance() -> metrics`` (one step)."""

    def _setup_tracking(self, num_iterations: int, history, *,
                        metric_dtype=None, metrics_method: str = "exact",
                        metrics_proxy_m: int = 16, fused_proxy_m: int = 0,
                        fused_fmm: tuple = (), fused_adaptive=None,
                        m2l_dots: str = "fp32",
                        validated_half: float | None = None) -> None:
        from murb_tpu_torch.ops.fmm import check_m2l_dots

        if sum(map(bool, (fused_proxy_m, fused_fmm,
                          fused_adaptive is not None))) > 1:
            raise ValueError("fused_proxy_m / fused_fmm / fused_adaptive "
                             "are exclusive")
        if metrics_method not in ("exact", "proxy"):
            raise ValueError(f"unknown metrics method {metrics_method!r} "
                             "(exact, proxy)")
        self.history = history or SimulationHistory(num_iterations)
        if self.history.num_iterations < num_iterations:
            self.history.set_num_iterations(num_iterations)
        self._metric_dtype = _resolve_metric_dtype(metric_dtype)
        self._metrics_method = metrics_method
        self._metrics_proxy_m = metrics_proxy_m
        self._fused_proxy_m = fused_proxy_m
        self._fused_fmm = tuple(fused_fmm)  # (m, levels) or ()
        self._fused_adaptive = fused_adaptive  # SparsePlan or None
        self._m2l_dots = check_m2l_dots(m2l_dots)  # the fused pass's tier
        self._validated_half = validated_half

    @property
    def _fused(self) -> bool:
        """Whether the step takes force and potential from one far-field
        pass (``_fused_force_phi``)."""
        return bool(self._fused_proxy_m or self._fused_fmm
                    or self._fused_adaptive is not None)

    def _metrics(self, state):
        return metrics_mod.all_metrics(
            state, self.soft, out_dtype=self._metric_dtype,
            method=self._metrics_method, proxy_m=self._metrics_proxy_m)

    def proxy_health(self) -> dict | None:
        """Validity of the fused far-field pass (ProxyEngine.proxy_health's
        contract); None when the engine runs none."""
        return _fused_proxy_health(self._state, self.soft,
                                   self._fused_proxy_m, self._fused_fmm,
                                   self._validated_half,
                                   self._fused_adaptive)

    def _record(self, i0: int, rows: np.ndarray) -> None:
        """History rows i0, i0 + 1, ... from packed metrics (k, 5), or
        (k, G, 5) with one series per galaxy."""
        if rows.ndim == 2:
            self.history.set_rows(i0, rows[:, 0], rows[:, 1], rows[:, 2:])
            return
        for g, gal in enumerate(self.history.galaxies):
            gal.set_rows(i0, rows[:, g, 0], rows[:, g, 1], rows[:, g, 2:])

    def run(self, n_iterations: int) -> None:
        """Advance ``n_iterations`` steps; the rows that fit the history
        reach the host in one copy after the last step."""
        i0 = self._iteration
        keep = min(n_iterations, self.history.num_iterations - i0)
        rows = []
        for k in range(n_iterations):
            mets = self._advance()
            self._iteration += 1
            if k < keep:
                rows.append(_pack(mets))
        if rows:
            self._record(i0, torch.stack(rows).cpu().numpy())

    def compute_one_iteration(self) -> None:
        self.run(1)


class TrackingEngine(_Tracked, EulerAccelEngine):
    """Euler engine that records (energy, |L|, density center) every
    iteration, at the pre-update state (acceleration -> metrics -> update,
    ref: SimulationNBodyCUDAPropertyTracking.cu:121-133).

    The step takes one of three paths: the fused far-field pass (force and
    potential from one pass: the proxy with ``fused_proxy_m``, K1 and K2,
    the hierarchy with ``fused_fmm`` = (m, levels), K7-K9, or the adaptive
    hierarchy with ``fused_adaptive`` (a SparsePlan), K7 and K10-K12), the
    fused
    exact sweep (``_use_fused_exact``: K6), or the force kernel ``acc_fn``
    plus the metrics' own potential sweep."""

    tag = "tpu+tracking"

    def __init__(self, bodies, soft=None, dt=None, *, num_iterations: int,
                 history: SimulationHistory | None = None, acc_fn=None,
                 fused_exact: bool | None = None, **kw):
        tracking = {k: kw.pop(k) for k in _TRACKING_OPTIONS if k in kw}
        super().__init__(bodies, soft, dt, **kw)
        self._acc = acc_fn
        self._fused_exact = fused_exact
        self._setup_tracking(num_iterations, history, **tracking)

    def _use_fused_exact(self) -> bool:
        """Whether the exact tracked step runs K6 (force and potential from
        one all-pairs sweep) instead of a force kernel plus a separate
        potential sweep: by default on CUDA tensors, when no fused proxy,
        no custom ``acc_fn`` and no proxy metrics are configured (murb_tpu:
        on the TPU).  ``fused_exact`` forces it either way."""
        if (self._acc is not None or self._metrics_method != "exact"
                or self._fused):
            return False
        if self._fused_exact is not None:
            return self._fused_exact
        return self._state.device.type == "cuda"

    def _acc_fn(self, qx, qy, qz, gm):
        return (self._acc or _default_exact_acc)(qx, qy, qz, gm, self.soft)

    def _step_with_metrics(self, state):
        """(new_state, acc, metrics), the metrics at the pre-update state."""
        gm = self._gm(state)
        if self._fused:
            acc, phi = _fused_force_phi(state.qx, state.qy, state.qz, gm,
                                        self.soft, self._fused_proxy_m,
                                        self._fused_fmm, self._fused_adaptive,
                                        self._m2l_dots)
            mets = _phi_metrics(state, phi, self.soft, self._metric_dtype)
        elif self._use_fused_exact():
            from murb_tpu_torch.ops.hybrid import acc_phi_rows_hybrid

            acc, phir = acc_phi_rows_hybrid(state.qx, state.qy, state.qz, gm,
                                            gm[None, :], self.soft)
            mets = _phi_metrics(state, phir[0], self.soft,
                                self._metric_dtype)
        else:
            acc = self._acc_fn(state.qx, state.qy, state.qz, gm)
            mets = self._metrics(state)
        return euler_update(state, acc, self._dt), acc, mets

    def _advance(self):
        self._state, self._last_acc, mets = self._step_with_metrics(
            self._state)
        return mets


class LeapfrogTrackingEngine(_Tracked, LeapfrogEngine):
    """Phase-split leapfrog with the conserved quantities recorded every
    phase -- the capability the reference ships disabled (ref:
    SimulationNBodyCUDALeapfrog.cu:140-143).  Metrics are taken at the
    visible state each phase produces: for middle phases the synchronized
    (x_n, v_n).  With ``fused_proxy_m`` the potential comes from the force
    pass: the force positions are the new visible positions in every
    phase, so phi there is phi at the metrics state."""

    tag = "tpu+leapfrog+tracking"

    def __init__(self, bodies, soft=None, dt=None, *, num_iterations: int,
                 history: SimulationHistory | None = None, acc_fn=None,
                 **kw):
        tracking = {k: kw.pop(k) for k in _TRACKING_OPTIONS if k in kw}
        super().__init__(bodies, soft, dt, num_iterations=num_iterations,
                         acc_fn=acc_fn, **kw)
        self._setup_tracking(num_iterations, history, **tracking)

    def _advance(self):
        q, finish = self._phase()
        gm = self._gm(self._state)
        if self._fused:
            acc, phi = _fused_force_phi(*q, gm, self.soft,
                                        self._fused_proxy_m, self._fused_fmm,
                                        self._fused_adaptive, self._m2l_dots)
            self._state, self._aux = finish(acc)
            mets = _phi_metrics(self._state, phi, self.soft,
                                self._metric_dtype)
        else:
            acc = self._acc_fn(*q, gm)
            self._state, self._aux = finish(acc)
            mets = self._metrics(self._state)
        self._last_acc = acc
        return mets


class MultiGalaxyTrackingEngine(TrackingEngine):
    """Tracking engine with one (energy, |L|, density center) series per
    galaxy.  The reference sums per-galaxy histories into the global series
    (``MultiGalaxySimulationHistory::updateGlobalProperties``, ref:
    SimulationHistory.cpp:153-184); each galaxy's metrics are masked
    metrics of the same step.

    ``masks``: one (<= npad,) 0/1 array or tensor per galaxy, zero-extended
    to the state's npad (ghosts belong to no galaxy).  Up to 8 galaxies
    share one potential sweep: K5 after the ``acc_fn`` force, or K6 for
    both on the fused exact path."""

    tag = "tpu+tracking+multi"

    def __init__(self, bodies, soft=None, dt=None, *, num_iterations: int,
                 masks, **kw):
        if kw.get("fused_adaptive") is not None:
            # murb_tpu/models/engines.py:1413-1425
            raise ValueError(
                "per-galaxy fused metrics support the single-level proxy "
                "(fused_proxy_m), the L-level hierarchy (fused_fmm: masked "
                "weight channels through P2M/M2M/M2L/L2L, "
                "ops/fmm.force_and_potential_fmm_pergal) and the exact "
                "kernel; the ADAPTIVE solver stays rejected -- its "
                "occupied-cell slot tables and P2P brick packs would need "
                "a per-galaxy channel through every windowed/sparse stage "
                "and the near kernel for a workload (1M+ clustered "
                "multi-galaxy tracking) that metrics_method='proxy' "
                "already serves with fast masked metrics")
        history = MultiGalaxySimulationHistory(num_iterations,
                                               num_galaxies=len(masks))
        super().__init__(bodies, soft, dt, num_iterations=num_iterations,
                         history=history, **kw)
        st = self._state
        rows = []
        for mk in masks:
            mk = torch.as_tensor(mk, dtype=st.dtype, device=st.device)
            if mk.shape[0] > st.npad:
                raise ValueError(f"mask of {mk.shape[0]} bodies for a state "
                                 f"of {st.npad}")
            rows.append(torch.nn.functional.pad(mk, (0, st.npad - len(mk))))
        self.masks = torch.stack(rows)                     # (G, npad)

    def _metrics(self, state):
        if self._metrics_method == "exact" and len(self.masks) <= 8:
            from murb_tpu_torch.ops.hybrid import phi_rows

            phi = phi_rows(state.qx, state.qy, state.qz,
                           self.masks * self._gm(state)[None, :], self.soft)
            return self._metrics_from_phi_rows(state, phi)
        per_gal = [metrics_mod.all_metrics(
            state, self.soft, out_dtype=self._metric_dtype, mask=mk,
            method=self._metrics_method, proxy_m=self._metrics_proxy_m)
            for mk in self.masks]
        return tuple(torch.stack([g[i] for g in per_gal]) for i in range(3))

    def _metrics_from_phi_rows(self, state, phi):
        """Per-galaxy metric stacks from per-galaxy potential rows ``phi``
        (G, n) already in hand."""
        per_gal = [_phi_metrics(metrics_mod.masked(state, mk), phi[g],
                                self.soft, self._metric_dtype)
                   for g, mk in enumerate(self.masks)]
        return tuple(torch.stack([g[i] for g in per_gal]) for i in range(3))

    def _step_with_metrics(self, state):
        """Force and every galaxy's potential from one pass: the per-galaxy
        proxy with ``fused_proxy_m``, the per-galaxy hierarchy with
        ``fused_fmm``, else K6 on the fused exact path."""
        gm = self._gm(state)
        if self._fused_proxy_m:
            from murb_tpu_torch.ops.proxy import \
                force_and_potential_proxy_pergal

            acc, phi = force_and_potential_proxy_pergal(
                state.qx, state.qy, state.qz, gm, self.masks, self.soft,
                m=self._fused_proxy_m)
        elif self._fused_fmm:
            from murb_tpu_torch.ops.fmm import force_and_potential_fmm_pergal

            acc, phi = force_and_potential_fmm_pergal(
                state.qx, state.qy, state.qz, gm, self.masks, self.soft,
                m=self._fused_fmm[0], levels=self._fused_fmm[1],
                m2l_dots=self._m2l_dots)
        elif self._use_fused_exact() and len(self.masks) <= 8:
            from murb_tpu_torch.ops.hybrid import acc_phi_rows_hybrid

            acc, phi = acc_phi_rows_hybrid(state.qx, state.qy, state.qz, gm,
                                           self.masks * gm[None, :],
                                           self.soft)
        else:
            acc = self._acc_fn(state.qx, state.qy, state.qz, gm)
            return euler_update(state, acc, self._dt), acc, \
                self._metrics(state)
        return (euler_update(state, acc, self._dt), acc,
                self._metrics_from_phi_rows(state, phi))

    def finalize_history(self):
        """Fold the per-galaxy series into the global series (sum)."""
        self.history.update_global_properties()
        return self.history
