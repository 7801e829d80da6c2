"""Distributed engines over a 1-D device mesh (``parallel/mesh.py``).

Port of ``murb_tpu/parallel/shard_engine.py`` (the reference's MPI engine,
ref: src/murb/implem/SimulationNBodyMultiNode.cpp, and its heterogeneous
split, ref: src/murb/implem/SimulationNBodyHetero.cu).  A step is
murb_tpu's per-shard step body written over the mesh's list of shards:
each line runs for every shard in turn, and the collectives of
``shard_map`` are ``Mesh`` methods over the lists.  Modes:

  * ``allgather`` -- each shard all-gathers the global (positions, G*m),
    sweeps its own rows against them, and integrates only its own block.
  * ``ring`` -- memory O(N/D) a shard: the j-block rotates around the
    mesh.  ``ring_impl="ppermute"`` alternates a rectangular sweep and a
    ``ppermute``; ``"pipelined"`` runs the whole D-step ring through
    kernel K14 (``ops/ring.py``), each slot copy hidden behind the next
    step's sweep, within one process, across the processes of one host
    (K14's cross-process instance: slot copies and flag words over CUDA
    IPC; several processes may share one card, each with a gloo group and
    an explicit device list, ``ops/ring.py``) or across hosts (its
    cross-host instance: the boundary slot staged through pinned host
    memory and sent on a gloo side group).  ``"auto"``
    (``auto_ring_impl``) takes the pipelined ring when every shard is a
    CUDA device, on one host or many.
  * ``proxy`` / ``fmm`` -- the far field by one global Chebyshev expansion
    (K1/K2) or the L-level hierarchy (K8, K7, K9): local P2M, one ``psum``
    of the expansions (independent of N), the node sweeps redundantly on
    every device of the mesh (once a device: shards that share one see the
    same expansions), local L2P; heavy bodies exact through a gathered D*k
    list and a ``psum`` of their rows.  ``proxy`` promotes to ``fmm`` and
    ``fmm`` to ``adaptive`` when the box demands it.
  * ``adaptive`` -- the occupied-cell hierarchy over Morton-contiguous
    shards (``parallel/shard_adaptive.py``: K11, K12, K7, K10).
  * ``uneven`` -- the hetero engine's fraction knob: shard 0 sweeps
    ``gpu_fraction`` of the rows, the others share the rest, against a
    replicated state; the rows are ``psum``-merged.

The exact rectangular sweep of allgather, ring (ppermute) and uneven is
``kernel``: "hybrid" on CUDA shards (K4's wrapper at passes 2, which
launches K3's kernel), the plain ``acc_rect`` ("jnp") on CPU shards, or
"tile" / "mxu".
"""
from __future__ import annotations

import dataclasses
import os
from functools import partial

import numpy as np
import torch

from murb_tpu_torch import DEFAULT_SOFTENING, G
from murb_tpu_torch.core.integrators import euler_update
from murb_tpu_torch.core.state import FIELDS, BodyState, in_dtype
from murb_tpu_torch.models.base import SimulationEngine
from murb_tpu_torch.ops.common import Accel
from murb_tpu_torch.ops.naive import acc_rect
from murb_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                          replicate_state, shard_state)


def _default_kernel(mesh) -> str:
    """K4's wrapper (passes 2) on CUDA shards, the plain broadcast on CPU
    shards."""
    return "hybrid" if mesh.all_cuda else "jnp"


def auto_ring_impl(mesh) -> str:
    """``ring_impl="auto"``: K14's pipelined ring on an all-CUDA mesh, one
    process, the processes of one host or processes on several hosts
    (murb_tpu's TPU default, murb_tpu/parallel/shard_engine.py:254-258),
    the ppermute ring on CPU shards.  No host exchange is made here: the
    ring makes it at its first call."""
    return "pipelined" if mesh.all_cuda else "ppermute"


def _rect_kernel(name: str, block_i: int, block_j: int):
    if name == "jnp":
        return acc_rect
    if name == "tile":
        from murb_tpu_torch.ops.tile import acc_tile_rect

        return partial(acc_tile_rect, block_i=block_i, block_j=block_j)
    if name == "hybrid":
        from murb_tpu_torch.ops.hybrid import acc_hybrid_rect

        # passes=2: the accuracy default, as the single-device engines
        return partial(acc_hybrid_rect, block_i=block_i, block_j=block_j,
                       passes=2)
    if name == "mxu":
        from murb_tpu_torch.ops.mxu import acc_mxu_rect

        return partial(acc_mxu_rect, block_i=block_i, block_j=block_j)
    raise ValueError(f"unknown rect kernel {name!r}")


def _gm(state) -> torch.Tensor:
    """G*m with G rounded to the state dtype (models/base._gm)."""
    return state.m * torch.tensor(G, dtype=state.dtype).item()


def _permuted(state: BodyState, perm) -> BodyState:
    idx = torch.as_tensor(np.asarray(perm), device=state.device)
    return dataclasses.replace(state, **{k: getattr(state, k)[idx]
                                         for k in FIELDS})


class ShardedEngine(SimulationEngine):
    """Data-parallel engine over a 1-D mesh (see the module docstring).

    ``devices``: an explicit device list, one entry per local shard (it may
    repeat a card); by default ``shards`` CUDA cards (0 = all) for a CUDA
    state, ``shards`` virtual CPU shards (0 = one) for a CPU state.
    ``host``: this process's host in the mesh (``make_mesh``)."""

    tag = "shard"

    def __init__(self, bodies: BodyState, soft=None, dt=None, *,
                 mode: str = "ring", shards: int = 0,
                 gpu_fraction: float | None = None, min_n: int | None = None,
                 kernel: str = "auto", block_i: int = 0, block_j: int = 0,
                 ring_impl: str = "auto", m: int = 0, levels: int = 0,
                 m2l_dots: str = "fp32", validate: bool = True,
                 adapt_every: int = 0, devices=None,
                 host: str | None = None, **kw):
        from murb_tpu_torch.ops.fmm import check_m2l_dots

        kwargs = {}
        if soft is not None:
            kwargs["soft"] = soft
        if dt is not None:
            kwargs["dt"] = dt
        # the hetero engine's knobs, re-read per construction
        # (ref: SimulationNBodyHetero.cu:16-26, 217-227)
        if gpu_fraction is None and os.environ.get("MURB_HETERO_GPU_FRACTION"):
            gpu_fraction = float(os.environ["MURB_HETERO_GPU_FRACTION"])
        if gpu_fraction is not None and not 0.0 < gpu_fraction <= 1.0:
            # a fraction outside (0, 1] leaves rows owned by no shard
            raise ValueError(
                f"gpu_fraction must be in (0, 1], got {gpu_fraction}")
        if min_n is None:
            min_n = int(os.environ.get("MURB_HETERO_MIN_N", "0") or 0)
        if min_n and bodies.n < min_n:
            shards = 1     # the hetero engine's small-N fallback (.cu:229-257)

        self.m2l_dots = check_m2l_dots(m2l_dots)
        self.validated_err: float | None = None
        self.validated_half: float | None = None
        self.adaptive_plan = None
        self._inv_perm = None
        soft_val = kwargs.get("soft", DEFAULT_SOFTENING)
        if mode in ("proxy", "fmm"):
            mode = self._pick_far(bodies, mode, soft_val, m, levels, validate)

        self.mesh = make_mesh(shards, device=bodies.device, devices=devices,
                              host=host)
        self.n_shards = self.mesh.size
        self.mode = mode
        self.adapt_every = int(adapt_every)
        self._auto = not (m or levels)   # fixed configs are never churned
        self.gpu_fraction = gpu_fraction
        self.kernel_name = (_default_kernel(self.mesh) if kernel == "auto"
                            else kernel)
        self.block_i, self.block_j = int(block_i), int(block_j)
        self.tuned = None                 # the sweeps' blocks are given
        if ring_impl == "auto":
            ring_impl = auto_ring_impl(self.mesh)
        if ring_impl not in ("pipelined", "ppermute"):
            raise ValueError(f"unknown ring_impl {ring_impl!r}")
        self.ring_impl = ring_impl

        # every shard holds a 256-aligned block
        bodies = bodies.repad(256 * self.n_shards)
        if mode == "adaptive":
            bodies = self._plan_adaptive(bodies, soft_val, m, levels,
                                         validate, kw.pop("m2l_rank", None))

        super().__init__(bodies, **kwargs, **kw)
        self.tag = f"shard+{mode}"
        self._n, self._padding = bodies.n, bodies.padding
        self._local = None
        self._last_acc_blocks = None
        if mode == "uneven":
            self._state = replicate_state(self._state, self.mesh)
        else:
            self._state = shard_state(self._state, self.mesh)

    # ---------------------------------------------------------- set-up
    def _pick_far(self, bodies, mode, soft_val, m, levels, validate) -> str:
        """The proxy/fmm geometry from the initial box (the single-device
        ProxyEngine's ladder): one expansion while m <= 24, the hierarchy
        beyond, the adaptive mode when the hierarchy would need m > 16;
        then the measured-order validation (ops/validate)."""
        from murb_tpu_torch.ops.fmm import (best_depth, fmm_order,
                                            required_levels)
        from murb_tpu_torch.ops.proxy import (half_extent, required_order,
                                              validation_ladder)

        half = half_extent(bodies.unpadded())
        if mode == "proxy":
            # margin=0: the 1.5x box factor already pads for growth
            m_auto = required_order(half * 1.5, soft_val, 1e-4, margin=0)
            m_auto = (m_auto + 3) // 4 * 4
            if m_auto > 24:
                mode = "fmm"
            else:
                self.proxy_m = m if m else m_auto
                self.proxy_heavy_k = 1
        if mode == "fmm":
            if m and levels:
                self.fmm_m, self.fmm_levels = int(m), int(levels)
            else:
                lv_req = required_levels(half, soft_val)
                if fmm_order(half, soft_val, lv_req, 1e-4) > 16:
                    mode = "adaptive"
                else:
                    self.fmm_m, self.fmm_levels = best_depth(
                        bodies.npad, half, soft_val, device=bodies.device)
            if mode == "fmm":
                self.proxy_heavy_k = 1
        if mode != "adaptive" and validate and not m:
            from murb_tpu_torch.ops.validate import (certified_half,
                                                     validate_config)

            init_m = self.fmm_m if mode == "fmm" else self.proxy_m
            init_lv = self.fmm_levels if mode == "fmm" else 0
            mv, lvv, _, err = validate_config(
                bodies.qx, bodies.qy, bodies.qz, _gm(bodies), soft_val, 1e-4,
                init_m, init_lv, 1, half,
                validation_ladder(soft_val, self.m2l_dots))
            self.validated_err = err
            self.validated_half = certified_half(
                int(mv), int(lvv), float(half), err, soft_val, 1e-4)
            if lvv:
                mode = "fmm"
                self.fmm_m, self.fmm_levels = int(mv), int(lvv)
            else:
                self.proxy_m = int(mv)
        return mode

    def _plan_adaptive(self, bodies, soft_val, m, levels, validate,
                       m2l_rank) -> BodyState:
        """Plan the Morton-sharded adaptive solve from the initial
        distribution, validate its order with the single-device ladder
        (escalate m by 2 to 12) at the engine's M2L tier (murb_tpu at
        fp32), and return the bodies in Morton residence order; ``bodies``
        (the property) undoes the permutation."""
        from murb_tpu_torch.ops.sparse_fmm import (acc_adaptive,
                                                   adaptive_order,
                                                   best_adaptive_plan,
                                                   default_m2l_rank)
        from murb_tpu_torch.ops.validate import measured_force_error
        from murb_tpu_torch.parallel.shard_adaptive import \
            plan_shard_adaptive

        u = bodies.unpadded()
        act = u["m"] > 0
        qh = np.stack([u["qx"], u["qy"], u["qz"]], 1).astype(np.float32)
        m_pick = int(m) if m else adaptive_order(1e-4)
        ld_pick, l_pick = (2, int(levels)) if levels else (0, 0)
        rank_pick = -1
        if validate and not m:
            plan1, _ = best_adaptive_plan(qh[act], bodies.npad, m_pick,
                                          device=bodies.device)
            gmv = _gm(bodies)
            tried_rank0 = False
            while True:
                merr = measured_force_error(
                    bodies.qx, bodies.qy, bodies.qz, gmv, soft_val,
                    lambda a, b, c, g: acc_adaptive(a, b, c, g, soft_val,
                                                    plan1,
                                                    m2l_dots=self.m2l_dots))
                if merr <= 1e-4:
                    break
                # drop the M2L compression before escalating m
                eff = plan1.m2l_rank
                if eff < 0:
                    eff = default_m2l_rank(plan1.m)
                if eff > 0 and not tried_rank0:
                    tried_rank0 = True
                    plan1 = plan1._replace(m2l_rank=0)
                    continue
                if plan1.m + 2 > 12:
                    break
                plan1 = plan1._replace(m=plan1.m + 2)
            self.validated_err = float(merr)
            m_pick = plan1.m
            ld_pick, l_pick = plan1.dense_levels, plan1.levels
            rank_pick = plan1.m2l_rank
        self.adaptive_plan, perm = plan_shard_adaptive(
            qh, bodies.npad, self.n_shards, m_pick, ld_pick, l_pick,
            active=act, device=bodies.device,
            m2l_rank=rank_pick if m2l_rank is None else m2l_rank)
        self._set_perm(perm)
        self.proxy_heavy_k = 1
        return _permuted(bodies, perm)

    def _set_perm(self, perm) -> None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        self._inv_perm = inv

    # ------------------------------------------------------ observation
    @property
    def bodies(self) -> BodyState:
        """The global state in the caller's body order (shard+adaptive
        permutes it into Morton residence at build).  Gathers every shard:
        an observation point, never the hot path."""
        if self.mode == "uneven":
            return self._state[0]
        state = gather_state(self._state, self.mesh, self._n, self._padding)
        if self._inv_perm is not None:
            state = _permuted(state, self._inv_perm)
        return state

    @property
    def blocks(self) -> list:
        """This process's blocks, one per local shard (in residence order
        for shard+adaptive, full replicas for shard+uneven)."""
        return self._state

    def save_sharded(self, path: str) -> None:
        """Write the blocks, the layout and the run's metadata as a sharded
        checkpoint (core/checkpoint.save_state_sharded)."""
        from murb_tpu_torch.core.checkpoint import save_state_sharded

        save_state_sharded(path, self._state, self.mesh, n=self._n,
                           padding=self._padding, iteration=self._iteration,
                           dt=self._dt, soft=self.soft)

    def load_sharded(self, path: str) -> dict:
        """Take the blocks and the iteration counter of a ``save_sharded``
        checkpoint of an engine of this configuration; returns its
        metadata."""
        from murb_tpu_torch.core.checkpoint import load_state_sharded

        blocks, meta = load_state_sharded(path, self.mesh)
        if ((meta["n"], meta["padding"], blocks[0].npad)
                != (self._n, self._padding, self._state[0].npad)):
            raise ValueError(f"checkpoint {path!r} has another layout: "
                             f"{meta}, blocks of {blocks[0].npad}")
        self._state, self._last_acc_blocks = blocks, None
        self._iteration = meta["iteration"]
        return meta

    @property
    def allocated_bytes(self) -> int:
        """The state's bytes, once: the shards' blocks, or in uneven mode,
        whose every shard keeps the whole state, one replica (murb_tpu's
        banner figure, its global state's)."""
        if self.mode == "uneven":
            return self._state[0].allocated_bytes
        return sum(b.allocated_bytes for b in self._state)

    @property
    def accelerations(self) -> Accel:
        """The last step's accelerations, global (in residence order for
        shard+adaptive, as murb_tpu's)."""
        if self._last_acc_blocks is None:
            raise RuntimeError("no iteration computed yet")
        if self.mode == "uneven":
            return self._last_acc_blocks[0]
        return Accel(*(self.mesh.all_gather([a[c] for a in
                                             self._last_acc_blocks])[0]
                       for c in range(3)))

    @property
    def m(self) -> int:
        """The far field's order (0 for the exact modes)."""
        if self.mode == "adaptive":
            return self.adaptive_plan.base.m
        return {"proxy": getattr(self, "proxy_m", 0),
                "fmm": getattr(self, "fmm_m", 0)}.get(self.mode, 0)

    @property
    def levels(self) -> int:
        if self.mode == "adaptive":
            return self.adaptive_plan.base.levels
        return self.fmm_levels if self.mode == "fmm" else 0

    @property
    def near_mode(self) -> str:
        return "adaptive" if self.mode == "adaptive" else "interp"

    def block_until_ready(self) -> None:
        for dev in {d for d in self.mesh.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def assert_finite(self) -> None:
        bad = sorted({k for b in self._state
                      for k in ("qx", "qy", "qz", "vx", "vy", "vz")
                      if not bool(torch.isfinite(getattr(b, k)).all())})
        if bad:
            raise FloatingPointError(
                f"non-finite state after iteration {self._iteration}: "
                f"{', '.join(bad)} (dt too large or softening too small?)")

    def proxy_health(self) -> dict | None:
        """Validity of the far-field modes (ProxyEngine.proxy_health's
        contract, with the measured certification when the build validated
        the pick; shard+adaptive: its capacities); None for the exact
        modes."""
        if self.mode == "adaptive":
            from murb_tpu_torch.parallel.shard_adaptive import (
                health_check, health_counts)

            out = health_check(self.adaptive_plan, health_counts(
                self.adaptive_plan, self.mesh, self._state))
            if self.validated_err is not None:
                out["validated_err"] = self.validated_err
            return out
        if self.mode not in ("proxy", "fmm"):
            return None
        from murb_tpu_torch.ops.fmm import fmm_order
        from murb_tpu_torch.ops.proxy import half_extent, required_order

        half = half_extent(self.bodies.unpadded())
        if self.mode == "fmm":
            m, levels = self.fmm_m, self.fmm_levels
            needed = fmm_order(half, self.soft, levels)
        else:
            m, levels = self.proxy_m, 0
            needed = required_order(half, self.soft)
        ok = (half <= self.validated_half if self.validated_half is not None
              else needed <= m)
        return {"using_proxy": True, "m": m, "cells": 1, "levels": levels,
                "required_m_now": needed, "ok": ok}

    # ------------------------------------------------------ mid-run re-plan
    def maybe_adapt(self) -> bool:
        """Rebuild the far field's configuration when ``proxy_health`` is
        not ok (the system drifted out of the frozen box, overflowed a
        capacity, or outgrew the order); explicit (m, levels) configs are
        never churned.  Waits on the device; call between frames.  Returns
        True if the engine was reconfigured."""
        if not self._auto:
            return False
        health = self.proxy_health()
        if health is None or health.get("ok", True):
            return False
        if self.mode == "adaptive":
            self._replan_adaptive()
            return True
        return self._reconfigure_far()

    def _replan_adaptive(self) -> None:
        """plan_shard_adaptive at the CURRENT distribution (new frozen box,
        ranges and capacities; the order m kept: adaptive accuracy is
        scale-free), the bodies re-permuted into the new residence."""
        from murb_tpu_torch.parallel.shard_adaptive import \
            plan_shard_adaptive

        state = self.bodies                  # identity-order view
        u = state.unpadded()
        act = u["m"] > 0
        qh = np.stack([u["qx"], u["qy"], u["qz"]], 1).astype(np.float32)
        base = self.adaptive_plan.base
        self.adaptive_plan, perm = plan_shard_adaptive(
            qh, state.npad, self.n_shards, base.m, active=act,
            m2l_rank=base.m2l_rank, device=state.device)
        self._set_perm(perm)
        self._state = shard_state(_permuted(state, perm), self.mesh)
        self._local = None

    def _reconfigure_far(self) -> bool:
        """Re-derive the proxy/fmm pick at the grown box (the build's
        static rungs; the measured certification applied to the old box,
        so it is cleared); proxy -> fmm -> adaptive as at build."""
        from murb_tpu_torch.ops.fmm import (best_depth, fmm_order,
                                            required_levels)
        from murb_tpu_torch.ops.proxy import half_extent, required_order

        old = (self.mode, getattr(self, "proxy_m", None),
               getattr(self, "fmm_m", None), getattr(self, "fmm_levels", None))
        half = half_extent(self.bodies.unpadded())
        mode = self.mode
        if mode == "proxy":
            m_auto = required_order(half * 1.5, self.soft, 1e-4, margin=0)
            m_auto = (m_auto + 3) // 4 * 4
            if m_auto > 24:
                mode = "fmm"
            else:
                self.proxy_m = m_auto
        if mode == "fmm":
            lv_req = required_levels(half, self.soft)
            if fmm_order(half, self.soft, lv_req, 1e-4) > 16:
                return self._promote_to_adaptive()
            self.fmm_m, self.fmm_levels = best_depth(
                self._n + self._padding, half, self.soft,
                device=self.mesh.devices[0])
        if (mode, getattr(self, "proxy_m", None), getattr(self, "fmm_m", None),
                getattr(self, "fmm_levels", None)) == old:
            return False
        self.mode = mode
        self.tag = f"shard+{mode}"
        self.validated_err = self.validated_half = None
        self._local = None
        return True

    def _promote_to_adaptive(self) -> bool:
        """proxy/fmm -> adaptive mid-run: the box outgrew every dense
        configuration; plan the sharded adaptive solve from the current
        state."""
        from murb_tpu_torch.ops.sparse_fmm import SparsePlan, adaptive_order
        from murb_tpu_torch.parallel.shard_adaptive import ShardAdaptivePlan

        self.mode, self.tag = "adaptive", "shard+adaptive"
        self.proxy_heavy_k = 1
        self.validated_err = self.validated_half = None
        # a placeholder, so _replan_adaptive can read base.m and the rank
        self.adaptive_plan = ShardAdaptivePlan(
            base=SparsePlan(m=adaptive_order(1e-4), dense_levels=2,
                            levels=3, cell_caps=(1,), p2p_pmax=1),
            c=(0.0, 0.0, 0.0), h=1.0, bounds=(0,), local_cap=1,
            export_cap=256, stray_cap=64, concat_pmax=32)
        self._replan_adaptive()
        return True

    # ------------------------------------------------------------ stepping
    def compute_one_iteration(self) -> None:
        if (self.adapt_every and self._iteration
                and self._iteration % self.adapt_every == 0):
            self.maybe_adapt()
        self._state, self._last_acc_blocks = self._step_fn()(self._state)
        self._iteration += 1

    def run(self, n_iterations: int) -> None:
        """Advance ``n_iterations`` steps; with ``adapt_every`` the loop is
        cut into segments so the re-plan checks land every ``adapt_every``
        iterations."""
        if n_iterations <= 0:
            return
        if self.adapt_every:
            done = 0
            while done < n_iterations:
                until = self.adapt_every - self._iteration % self.adapt_every
                k = min(until, n_iterations - done)
                self._run_segment(k)
                done += k
                if done < n_iterations:
                    self.maybe_adapt()
            return
        self._run_segment(n_iterations)

    def _run_segment(self, n_iterations: int) -> None:
        step = self._step_fn()
        for _ in range(n_iterations):
            self._state, acc = step(self._state)
        self._last_acc_blocks = acc
        self._iteration += n_iterations

    def set_dt(self, dt: float) -> None:
        super().set_dt(dt)
        self._local = None   # the local step holds dt

    def _step_fn(self):
        if self._local is None:
            self._local = self._local_step_fn()
        return self._local

    def _local_step_fn(self):
        if self.mode == "allgather":
            return self._allgather_local_step()
        if self.mode == "ring":
            if self.ring_impl == "pipelined":
                return self._ring_pipelined_local_step()
            return self._ring_local_step()
        if self.mode == "uneven":
            return self._uneven_local_step()
        if self.mode == "proxy":
            return self._far_local_step(self._proxy_far_solver())
        if self.mode == "fmm":
            return self._far_local_step(self._fmm_far_solver())
        if self.mode == "adaptive":
            from murb_tpu_torch.parallel.shard_adaptive import make_local_step

            return make_local_step(self.adaptive_plan, self.soft, self._dt,
                                   self.mesh, heavy_k=self.proxy_heavy_k,
                                   m2l_dots=self.m2l_dots)
        raise ValueError(f"unknown shard mode {self.mode!r}")

    def _local_rect(self):
        kern = _rect_kernel(self.kernel_name, self.block_i, self.block_j)
        soft = self.soft
        return lambda qi3, qj3, gmj: kern(*qi3, *qj3, gmj, soft)

    # ------------------------------------------------------- mode: gather
    def _allgather_local_step(self):
        rect, dt, mesh = self._local_rect(), self._dt, self.mesh

        def step(blocks):
            gm_l = [_gm(b) for b in blocks]
            qj = [mesh.all_gather([getattr(b, c) for b in blocks])
                  for c in ("qx", "qy", "qz")]
            gmj = mesh.all_gather(gm_l)
            acc = [rect((b.qx, b.qy, b.qz), (qj[0][k], qj[1][k], qj[2][k]),
                        gmj[k]) for k, b in enumerate(blocks)]
            return [euler_update(b, a, dt) for b, a in zip(blocks, acc)], acc

        return step

    # --------------------------------------------------------- mode: ring
    def _ring_local_step(self):
        rect, dt, mesh = self._local_rect(), self._dt, self.mesh
        d = self.n_shards

        def step(blocks):
            j = [[b.qx for b in blocks], [b.qy for b in blocks],
                 [b.qz for b in blocks], [_gm(b) for b in blocks]]
            acc = [Accel(*(torch.zeros_like(b.qx),) * 3) for b in blocks]
            for r in range(d):
                a = [rect((b.qx, b.qy, b.qz), (j[0][k], j[1][k], j[2][k]),
                          j[3][k]) for k, b in enumerate(blocks)]
                acc = [Accel(*(x + y for x, y in zip(p, q)))
                       for p, q in zip(acc, a)]
                if r < d - 1:
                    j = [mesh.ppermute(v) for v in j]
            return [euler_update(b, a, dt) for b, a in zip(blocks, acc)], acc

        return step

    def _ring_pipelined_local_step(self):
        """K14 (ops/ring.py): one call a step runs the whole ring."""
        from murb_tpu_torch.ops.ring import acc_ring_pipelined

        dt, soft, mesh = self._dt, self.soft, self.mesh
        bi, bj = self.block_i, self.block_j

        def step(blocks):
            acc = acc_ring_pipelined(
                mesh, [(b.qx, b.qy, b.qz) for b in blocks],
                [_gm(b) for b in blocks], soft, block_i=bi, block_j=bj)
            return [euler_update(b, a, dt) for b, a in zip(blocks, acc)], acc

        return step

    # --------------------------------------------------- modes: proxy/fmm
    def _proxy_far_solver(self):
        """One global Chebyshev expansion: local P2M (K1), one psum of the
        m^3 coefficients, the node sweep on every shard, local L2P (K2)."""
        from murb_tpu_torch.ops.proxy import m2l
        from murb_tpu_torch.ops.proxy_kernels import l2p_fused, p2m_fused

        m, soft, mesh = self.proxy_m, self.soft, self.mesh

        def solve(blocks, gm_effs, cs, hs):
            w = mesh.psum([p2m_fused(b.qx, b.qy, b.qz, g, c, h, m=m)
                           for b, g, c, h in zip(blocks, gm_effs, cs, hs)])
            out, fs = [], {}
            for b, wk, c, h in zip(blocks, w, cs, hs):
                if wk.device not in fs:   # the redundant sweep, once a device
                    fs[wk.device] = m2l(c, h, wk, soft, m, b.dtype)
                f = fs[wk.device]
                out.append(l2p_fused(b.qx, b.qy, b.qz, c, h, f.ax, f.ay,
                                     f.az, m=m))
            return out

        return solve

    def _fmm_far_solver(self):
        """The L-level hierarchy: local grid P2M (K8), one psum of the
        (C^3, m^3) expansions, the level sweeps (K7) on every shard, local
        grid L2P (K9)."""
        from murb_tpu_torch.ops.fmm import fmm_field_grid
        from murb_tpu_torch.ops.fmm_kernels import (cell_order,
                                                    l2p_grid_fused,
                                                    p2m_grid_fused)

        m, levels, soft, mesh = self.fmm_m, self.fmm_levels, self.soft, \
            self.mesh
        m2l_dots = self.m2l_dots
        C = 2 ** levels

        def solve(blocks, gm_effs, cs, hs):
            orders = [cell_order(b.qx, b.qy, b.qz, c, h, C)
                      if b.qx.device.type == "cuda" else None
                      for b, c, h in zip(blocks, cs, hs)]
            w = mesh.psum([p2m_grid_fused(b.qx, b.qy, b.qz, g, c, h, m=m, C=C,
                                          order=o)
                           for b, g, c, h, o in zip(blocks, gm_effs, cs, hs,
                                                    orders)])
            out, fs = [], {}
            for b, wk, c, h, o in zip(blocks, w, cs, hs, orders):
                if wk.device not in fs:   # the redundant sweeps, once a device
                    fs[wk.device] = fmm_field_grid(wk, h, soft, m=m,
                                                   levels=levels,
                                                   m2l_dots=m2l_dots)
                fields = fs[wk.device]
                out.append(torch.stack(l2p_grid_fused(
                    b.qx, b.qy, b.qz, c, h, fields, m=m, C=C, order=o), 1))
            return out

        return solve

    def _far_local_step(self, far_solver):
        """The proxy/fmm skeleton: global box (pmin/pmax), a heavy split
        consistent over the mesh, the far solve, then the heavy bodies
        exactly (as sources through the gathered D*k list, as targets
        through a psum of local partial rows)."""
        from murb_tpu_torch.ops.proxy import (HEAVY_FACTOR, heavy_source_acc,
                                              heavy_split)

        dt, soft, mesh = self._dt, self.soft, self.mesh
        kh = self.proxy_heavy_k

        def step(blocks):
            dtype = blocks[0].dtype
            gm_l = [_gm(b) for b in blocks]
            gm_pos = [g > 0 for g in gm_l]
            big = in_dtype(3.4e38, dtype)  # inf in bf16, as murb_tpu's
            lo = mesh.pmin([torch.stack([torch.where(p, q, big).min()
                                         for q in (b.qx, b.qy, b.qz)])
                            for b, p in zip(blocks, gm_pos)])
            hi = mesh.pmax([torch.stack([torch.where(p, q, -big).max()
                                         for q in (b.qx, b.qy, b.qz)])
                            for b, p in zip(blocks, gm_pos)])
            cs = [0.5 * (a + b) for a, b in zip(lo, hi)]
            hs = [(0.5 * (b - a)).clamp(min=1.0) for a, b in zip(lo, hi)]

            # global mean mass -> the same heavy threshold on every shard
            s_gm = mesh.psum([g.sum() for g in gm_l])
            s_cnt = mesh.psum([p.sum().to(dtype) for p in gm_pos])
            mean_gm = [s / c.clamp(min=1.0) for s, c in zip(s_gm, s_cnt)]
            split = [heavy_split(b.qx, b.qy, b.qz, g, kh, HEAVY_FACTOR, mg)
                     for b, g, mg in zip(blocks, gm_l, mean_gm)]
            hq_g = [mesh.all_gather([sp[0][c] for sp in split])
                    for c in range(3)]
            hgm_g = mesh.all_gather([sp[1] for sp in split])

            acc = far_solver(blocks, [sp[4] for sp in split], cs, hs)
            out = []
            ht = mesh.psum([torch.stack(list(acc_rect(
                hq_g[0][k], hq_g[1][k], hq_g[2][k], b.qx, b.qy, b.qz,
                gm_l[k], soft)), 1) for k, b in enumerate(blocks)])
            for k, b in enumerate(blocks):
                hq = (hq_g[0][k], hq_g[1][k], hq_g[2][k])
                a = acc[k] + heavy_source_acc(b.qx, b.qy, b.qz, hq,
                                              hgm_g[k], soft)
                me = mesh.axis_index(k)
                mine = ht[k][me * kh:(me + 1) * kh]
                _, _, is_heavy, top_idx, _ = split[k]
                a[top_idx] = torch.where(is_heavy[:, None], mine, a[top_idx])
                out.append(Accel(a[:, 0], a[:, 1], a[:, 2]))
            return [euler_update(b, a, dt) for b, a in zip(blocks, out)], out

        return step

    # ------------------------------------------------------- mode: uneven
    def _uneven_local_step(self):
        """Capability parity with the hetero fraction knob, not a scaling
        mode: every shard sweeps ``cmax`` rows (the largest share, 256-
        aligned) against the replicated state and masks the rows it does
        not own before the psum."""
        rect, dt, mesh = self._local_rect(), self._dt, self.mesh
        d = self.n_shards
        npad = self._n + self._padding
        # shard 0 owns gpu_fraction (default 0.60, as
        # MURB_HETERO_GPU_FRACTION), the others share the rest
        f = 1.0 if d == 1 else (
            0.60 if self.gpu_fraction is None else float(self.gpu_fraction))
        counts = [int(round(f * npad))] if d > 1 else [npad]
        if d > 1:
            rest = npad - counts[0]
            for k in range(d - 1):
                counts.append(rest // (d - 1) + (1 if k < rest % (d - 1)
                                                 else 0))
        starts = [sum(counts[:k]) for k in range(d)]
        cmax = min(npad, ((max(counts) + 255) // 256) * 256)

        def step(states):
            parts = [[], [], []]
            for k, st in enumerate(states):
                me = mesh.axis_index(k)
                start, count = starts[me], counts[me]
                sstart = min(start, npad - cmax)
                sl = slice(sstart, sstart + cmax)
                a = rect((st.qx[sl], st.qy[sl], st.qz[sl]),
                         (st.qx, st.qy, st.qz), _gm(st))
                ridx = torch.arange(sstart, sstart + cmax, device=st.device)
                mask = ((ridx >= start) & (ridx < start + count)).to(st.dtype)
                for c in range(3):
                    full = torch.zeros(npad, dtype=st.dtype, device=st.device)
                    full[sl] = a[c] * mask
                    parts[c].append(full)
            summed = [mesh.psum(p) for p in parts]
            acc = [Accel(summed[0][k], summed[1][k], summed[2][k])
                   for k in range(len(states))]
            return [euler_update(st, a, dt) for st, a in zip(states, acc)], \
                acc

        return step
