"""Command-line entry point: the port's ``murb`` binary (ref: src/murb/main.cpp:309-407).

Port of ``murb_tpu/cli.py``: the configuration banner (with the validated
proxy order and its measured error, or the exact sweep's block geometry),
the frame loop with the verbose status line (``--ite-chunk`` iterations a
frame), the ``--scan`` timing window, the final "Entire simulation took ..." summary with the
reference's FLOPs model (20*N^2/iteration) and GFlop/s convention (1024^3
divisor), and for the tracked engines the ``--kernel`` wiring (with the
proxy -> fmm escalation and the validated (m, levels)) and the ``--csv``
metrics export.  ``--kernel adaptive`` (and ``--kernel fmm`` on a box whose
hierarchy would need m > 16) runs the adaptive sparse hierarchy with its
plan validated to ``--tol``; ``--near`` picks ``tpu+proxy``'s near-field
mode.  ``--block-i/--block-j/--autotune`` set the exact sweeps' geometry
(K3, K4, K13), ``--autotune`` also ``tpu+proxy``'s stage geometry on a
card, ``--chunk`` the chunked sweep's.  A long run checkpoints
(``--save-state``, ``--save-every``), resumes (``--load-state``: the
checkpoint's dt and softening hold unless given again, and the iteration
counter carries on), records positions (``--dump-traj``: frame 0 and
every ``--dump-every``-th; a ``--scan`` run is cut into segments at the
record and checkpoint points) and can stop on a non-finite state
(``--check-finite``).  ``--shards`` and ``--gpu-fraction`` set the
``shard+...`` engines' mesh and row split; with ``MURB_COORDINATOR``,
``MURB_NUM_PROCESSES`` and ``MURB_PROCESS_ID`` set, the run joins a
``torch.distributed`` group first (parallel/mesh.maybe_init_distributed).
The frame loop feeds a viewer (``--visu-out`` PNG frames, ``--visu-live``
the browser viewer, whose keys pause the run, double or halve dt and end
it), and ``--profile DIR`` runs the whole run under ``torch.profiler``
with the program's spans on (utils/trace), writes a Chrome trace into DIR
and prints the device time, each span's host and device time, the engine
build's spans (plan, validation, geometry, library) with the plan's attrs,
and each health check.

``--device cuda`` (the default) puts the state and every kernel on the
first CUDA device and exits with status 1 when there is none: the port
never carries on on the CPU.  ``--device cpu`` runs the kernels' plain
PyTorch versions.  ``--precision bf16`` keeps the state in bf16 (half
the memory a body takes); the kernels read it and compute in fp32, and
so does every pairwise chain outside them, rounding once.

Usage:  python -m murb_tpu_torch -n 200000 -i 100 --im tpu+mxu --nv --gf --scan
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch
import torch.distributed as dist

from murb_tpu_torch.core.init import make_bodies
from murb_tpu_torch.core.state import host_array
from murb_tpu_torch.models import (
    available_implementations,
    create_engine,
    resolve_tag,
    validate_tag,
)
from murb_tpu_torch.utils import trace
from murb_tpu_torch.utils.args import MurbConfig, parse_args
from murb_tpu_torch.utils.perf import Perf
from murb_tpu_torch.utils.strdate import str_date
from murb_tpu_torch.visu import create_visu

_DTYPES = {"fp32": torch.float32, "fp64": torch.float64,
           "bf16": torch.bfloat16}


@dataclasses.dataclass
class CliRun:
    """What one CLI run produced: the exit code, the engine (None when the
    run stopped before building one) and the timed window's figures."""

    rc: int
    engine: object | None = None
    elapsed_ms: float = 0.0
    fps: float = 0.0
    gflops: float = 0.0


#: engines that take the CLI's ``--kernel`` as their acceleration function
_WRAPPERS = ("tpu+tracking", "tpu+tracking+multi", "tpu+leapfrog",
             "tpu+leapfrog+tracking", "tpu+kdk")
#: of those, the ones whose step fuses the proxy's force and potential
_FUSIBLE = ("tpu+tracking", "tpu+leapfrog+tracking")


def _validated_far_field(cfg: MurbConfig, bodies):
    """``--kernel proxy`` / ``fmm`` / ``adaptive``: the configuration the
    box needs, held to ``--tol`` by measurement as ``tpu+proxy`` is
    (ops/validate), as murb_tpu's CLI does (cli.py:87-207).  The proxy
    takes the order of the 1.5x-grown box rounded up to a multiple of 4,
    and hands over to the hierarchy when that exceeds 32; the hierarchy
    takes the depth ``required_levels`` gives and ``fmm_order``'s order, and
    hands over to the adaptive solver when that exceeds 16.  The hierarchy
    rungs and the adaptive solver are measured at ``--m2l-dots``'s tier,
    the tier the tracked step runs.  Returns (kernel, m, levels, certified
    half-extent, SparsePlan or None)."""
    from murb_tpu_torch import G
    from murb_tpu_torch.ops.fmm import fmm_order, required_levels
    from murb_tpu_torch.ops.proxy import (half_extent, required_order,
                                          validation_ladder)
    from murb_tpu_torch.ops.validate import certified_half, validate_config

    kernel, levels = cfg.kernel, 0
    half = half_extent(bodies.unpadded())
    if kernel == "proxy":
        m = (required_order(half * 1.5, cfg.softening, cfg.tol, margin=0)
             + 3) // 4 * 4
        if m > 32:
            print(f"NOTE: box too large for the single-level proxy (needs "
                  f"m={m} > 32); using the multi-level fmm kernel.")
            kernel = "fmm"
    if kernel == "fmm":
        levels = required_levels(half, cfg.softening)
        m = fmm_order(half, cfg.softening, levels, cfg.tol)
        if m > 16:
            print(f"NOTE: box/softening ratio too large for the dense "
                  f"hierarchy (needs m={m}); using the adaptive sparse "
                  f"kernel (exact P2P near field).")
            kernel = "adaptive"
    if kernel == "adaptive":
        plan = _validated_adaptive_plan(cfg, bodies)
        return "adaptive", plan.m, plan.levels, None, plan

    gm = bodies.m * torch.tensor(G, dtype=bodies.dtype).item()
    m, levels, _, err = validate_config(
        bodies.qx, bodies.qy, bodies.qz, gm, cfg.softening, cfg.tol, m,
        levels, 1, half, validation_ladder(cfg.softening, cfg.m2l_dots))
    return ("fmm" if levels else "proxy", m, levels,
            certified_half(m, levels, float(half), err, cfg.softening,
                           cfg.tol), None)


def _validated_adaptive_plan(cfg: MurbConfig, bodies):
    """The adaptive plan of the initial distribution, its order escalated
    by 2 (to 12 at most) until the measured error meets ``--tol``, after
    dropping the M2L compression on a miss (murb_tpu/cli.py:123-172; at
    the default rank 0 it has nothing to drop).  The error is measured at
    ``--m2l-dots``'s tier, the one the step runs (murb_tpu measures it at
    fp32)."""
    import numpy as np

    from murb_tpu_torch import G
    from murb_tpu_torch.ops.sparse_fmm import (acc_adaptive, adaptive_order,
                                               best_adaptive_plan,
                                               default_m2l_rank)
    from murb_tpu_torch.ops.validate import measured_force_error

    u = bodies.unpadded()
    sel = u["m"] > 0
    q = np.stack([u["qx"][sel], u["qy"][sel], u["qz"][sel]],
                 1).astype(np.float32)
    plan, _ = best_adaptive_plan(q, bodies.npad, adaptive_order(cfg.tol),
                                 device=bodies.device)
    gm = bodies.m * torch.tensor(G, dtype=bodies.dtype).item()
    tried_rank0 = False
    while True:
        err = measured_force_error(
            bodies.qx, bodies.qy, bodies.qz, gm, cfg.softening,
            lambda a, b, c, g: acc_adaptive(a, b, c, g, cfg.softening, plan,
                                            m2l_dots=cfg.m2l_dots))
        if err <= cfg.tol:
            break
        rank = plan.m2l_rank
        if (default_m2l_rank(plan.m) if rank < 0 else rank) > 0 \
                and not tried_rank0:
            tried_rank0 = True
            plan = plan._replace(m2l_rank=0)
            continue
        if plan.m + 2 > 12:
            break
        plan = plan._replace(m=plan.m + 2)
    if err > cfg.tol:
        print(f"WARNING: adaptive kernel validation missed tol={cfg.tol:.1e} "
              f"(measured {err:.1e} at m={plan.m}); keeping it.")
    return plan


def build_engine(cfg: MurbConfig, device: torch.device):
    """(engine, start iteration) for ``cfg`` on ``device`` (raises
    ValueError for unknown tags and NotImplementedError for what is not
    yet ported).  The start iteration is the checkpoint's when resuming
    from ``--load-state``, so a later ``--save-state`` carries the
    cumulative count."""
    canonical = validate_tag(cfg.impl_tag)  # fail fast, before device work
    from murb_tpu_torch.ops.fmm import check_m2l_dots

    check_m2l_dots(cfg.m2l_dots)  # fail fast, before device work
    start_iteration = 0
    if cfg.load_state:
        from murb_tpu_torch.core.checkpoint import load_state

        bodies, meta = load_state(cfg.load_state, device=device)
        start_iteration = int(meta["iteration"])
        # a run saved with other physics must not silently continue with
        # the defaults; an explicit flag still wins
        if not cfg.dt_explicit:
            cfg.dt = float(meta["dt"])
        if not cfg.soft_explicit:
            cfg.softening = float(meta["soft"])
        print(f"Resumed state from {cfg.load_state} (iteration "
              f"{start_iteration}, n={bodies.n}, dt={cfg.dt:g}, "
              f"soft={cfg.softening:g})")
    else:
        bodies = make_bodies(cfg.n_bodies, cfg.scheme, cfg.seed,
                             dtype=_DTYPES[cfg.precision],
                             scheme_file=cfg.scheme_file, device=device)
    extra = {}
    if canonical == "tpu+tracking+multi":
        from murb_tpu_torch.core.init import milkyway_andromeda_masks

        extra["masks"] = milkyway_andromeda_masks(bodies.npad, bodies.n)
    if canonical in _WRAPPERS:
        from murb_tpu_torch.ops import make_acc_fn

        kernel, m, levels, plan = cfg.kernel, 0, 0, None
        if kernel in ("proxy", "fmm", "adaptive"):
            kernel, m, levels, cert_half, plan = _validated_far_field(
                cfg, bodies)
        if canonical in _FUSIBLE and plan is not None:
            extra["fused_adaptive"] = plan  # the fused sparse + P2P step
        elif canonical in _FUSIBLE and m:
            # one far-field pass per step for the force and the potential
            if levels:
                extra["fused_fmm"] = (m, levels)
            else:
                extra["fused_proxy_m"] = m
            extra["validated_half"] = cert_half
        else:
            extra["acc_fn"] = make_acc_fn(
                kernel, block_i=cfg.block_i, block_j=cfg.block_j,
                chunk=cfg.chunk, m=m or 16, levels=levels or 2, plan=plan)
    # Mid-run order adaptation every 64 iterations of the frame loop, off
    # under --scan (the post-run warning covers it); an explicit
    # --adapt-every, 0 included, wins.
    adapt_every = cfg.adapt_every
    if adapt_every is None:
        adapt_every = 0 if cfg.scan else 64
    engine = create_engine(
        cfg.impl_tag, bodies, soft=cfg.softening, dt=cfg.dt, tol=cfg.tol,
        near=cfg.near, adapt_every=adapt_every, chunk=cfg.chunk,
        block_i=cfg.block_i, block_j=cfg.block_j,
        autotune=True if cfg.autotune else None,
        shards=cfg.shards, gpu_fraction=cfg.gpu_fraction,
        m2l_dots=cfg.m2l_dots, num_iterations=cfg.n_iterations, **extra)
    return engine, start_iteration


def print_banner(cfg: MurbConfig, engine, device: torch.device) -> None:
    # ref: main.cpp:323-334
    mbytes = engine.allocated_bytes / 1024.0 / 1024.0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print("n-body simulation configuration:")
    print("--------------------------------")
    print(f"  -> bodies scheme     (-s    ): {cfg.scheme}")
    print(f"  -> implementation    (--im  ): {cfg.impl_tag} "
          f"[{resolve_tag(cfg.impl_tag)}]")
    print(f"  -> nb. of bodies     (-n    ): {engine.bodies.n}")
    print(f"  -> nb. of iterations (-i    ): {cfg.n_iterations}")
    print(f"  -> verbose mode      (-v    ): "
          f"{'enable' if cfg.verbose else 'disable'}")
    print(f"  -> precision                 : {cfg.precision}")
    print(f"  -> mem. allocated            : {mbytes:g} MB")
    print(f"  -> device                    : {device} ({name})")
    print(f"  -> time step         (--dt  ): {cfg.dt:g} sec")
    print(f"  -> softening factor  (--soft): {cfg.softening:g}")
    err = getattr(engine, "validated_err", None)
    if err is not None:
        if getattr(engine, "near_mode", "interp") == "adaptive":
            mode = (f"adaptive m={engine.m} L={engine.levels} (sparse + "
                    "exact near field)")
        elif engine.levels:
            mode = f"fmm m={engine.m} L={engine.levels}"
        else:
            mode = f"proxy m={engine.m}"
        print(f"  -> validated order           : {mode} "
              f"(measured err {err:.1e} vs tol {cfg.tol:g})")
    elif getattr(engine, "using_proxy", True) is False:
        print("  -> validated order           : exact fallback (the cost "
              "model rejected the proxy at this N)")
    if hasattr(engine, "block_i"):
        label, values = "sweep blocks (i x j)      ", (engine.block_i,
                                                        engine.block_j)
        text = f"{engine.block_i} x {engine.block_j}"
    elif getattr(engine, "using_proxy", False) and hasattr(
            engine, "m2l_tile") and engine.near_mode != "adaptive":
        label, values = "stage geometry            ", (engine.block,
                                                        engine.m2l_tile)
        text = f"block {engine.block}, m2l_tile {engine.m2l_tile}"
    else:
        return
    tuned = engine.tuned
    how = (f"tuned, {tuned['ms_per_step']:g} ms/step" if tuned
           else "given" if any(values) else "kernel default")
    print(f"  -> {label}: {text} ({how})")


def _write_profile(prof, out_dir: str, device: torch.device) -> None:
    """Stop the ``--profile`` profiler and its tracer, write its Chrome
    trace into ``out_dir``, print the device time: the sum of the device rows
    only (kernels, copies, memsets), never the host operators' rows, which
    count the same kernels again (utils/profile_step.device_rows), and the
    program's spans (utils/trace.profile_rows)."""
    from murb_tpu_torch.utils.profile_step import device_rows

    prof.stop()
    trace.disable()
    kept = trace.drain()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    print(f"Profiler trace written to {out_dir}")
    rows = device_rows(prof) if device.type == "cuda" else []
    dev_us = sum(e.self_device_time_total for e in rows)
    if dev_us > 0:
        print(f"Profiled device time: {dev_us / 1e3:.3f} ms in "
              f"{sum(e.count for e in rows)} device events on "
              f"{torch.cuda.get_device_name(device)}")
    else:
        print(f"Profiled device time: not measured (no device events on "
              f"{device})")
    for name, calls, host_ms, dev_ms in trace.profile_rows(prof):
        dev_txt = (f"{dev_ms:11.3f} ms" if device.type == "cuda"
                   else "not measured")
        print(f"  span {name:<18} {calls:7d}x  host {host_ms:11.3f} ms  "
              f"device {dev_txt}")
    _print_records("Health checks and builds in the run", kept,
                   lambda name: name == "adapt" or name.startswith("build."))


def _print_records(title: str, kept: dict, keep=lambda name: True) -> None:
    """Print the tracer's records (``trace.drain()``'s) whose name ``keep``
    accepts, each with its host time on the tracer's own clock and its
    attrs, indented under the printed span it ran in, then the counters:
    under ``--profile``, the engine build (the planner's plan, the
    validation's error, the library's load) and the run's health checks
    and builds (a rebuild, the library's load on a first step)."""
    inner, lines = {}, []      # id -> the indent of what runs inside it
    for rec in kept["spans"]:
        depth = inner.get(rec["parent"], 0)
        shown = keep(rec["name"])
        inner[rec["id"]] = depth + shown
        if not shown:
            continue
        ms = ("open" if rec["end_ns"] is None else
              f"{(rec['end_ns'] - rec['start_ns']) / 1e6:11.3f} ms")
        attrs = " ".join(f"{k}={v}" for k, v in rec["attrs"].items())
        lines.append(f"  {'  ' * depth}{rec['name']:<18} {ms}"
                     + (f"  {attrs}" if attrs else ""))
    lines += [f"  count {k} = {v}" for k, v in kept["counts"].items()]
    if lines:
        print(f"{title} (host clock):")
        print("\n".join(lines))


def run(argv=None) -> CliRun:
    """The whole CLI: parse, build, simulate, report.  ``main`` returns
    its exit code."""
    cfg = parse_args(argv)
    if cfg.list_impls:
        for tag, aliases in sorted(available_implementations().items()):
            alias_str = f"  (aliases: {', '.join(aliases)})" if aliases else ""
            print(f"  {tag}{alias_str}")
        return CliRun(0)
    if cfg.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (torch "
              f"{torch.__version__}, CUDA build {torch.version.cuda}); "
              "murb_tpu_torch does not fall back to the CPU -- pass "
              "--device cpu to run the plain PyTorch versions.",
              file=sys.stderr)
        return CliRun(1)
    device = torch.device(cfg.device)
    from murb_tpu_torch.parallel.mesh import maybe_init_distributed

    if maybe_init_distributed(device):
        print(f"distributed runtime up: process {dist.get_rank()}/"
              f"{dist.get_world_size()}")

    if cfg.save_every > 0 and not cfg.save_state:
        print("--save-every requires --save-state", file=sys.stderr)
        return CliRun(1)
    if cfg.profile:
        trace.enable()   # the build's spans, printed once it is built
    try:
        engine, start_iteration = build_engine(cfg, device)
    except (ValueError, NotImplementedError, FileNotFoundError) as e:
        # ref: main.cpp:265-268 -- clean exit on unknown implementation
        print(e)
        return CliRun(1)
    finally:
        if cfg.profile:
            trace.disable()
    if cfg.profile:
        _print_records("Engine build", trace.drain())
    print_banner(cfg, engine, device)
    visu = create_visu(cfg)
    print("Simulation started...")

    traj = ckpt = None
    if cfg.dump_traj:
        from murb_tpu_torch.io import TrajectoryWriter

        traj = TrajectoryWriter(cfg.dump_traj, engine.bodies.n)
    if cfg.save_every > 0:
        from murb_tpu_torch.core.checkpoint import AsyncCheckpointWriter

        ckpt = AsyncCheckpointWriter(cfg.save_state)
    every = max(cfg.dump_every, 1)

    def record(i_ite: int) -> None:
        """Frame ``i_ite`` of the trajectory, at --dump-every points: only
        the positions leave the device."""
        if traj is not None and i_ite % every == 0:
            b = engine.bodies
            traj.append(i_ite, *(host_array(getattr(b, k)[:b.n])
                                 for k in ("qx", "qy", "qz")))

    def checkpoint(i_ite: int) -> None:
        """The asynchronous checkpoint at --save-every points."""
        if ckpt is not None and i_ite > 0 and i_ite % cfg.save_every == 0:
            ckpt.save(engine.bodies, iteration=start_iteration + i_ite,
                      dt=engine.dt, soft=engine.soft)

    def to_next_stop(i_ite: int) -> int:
        """Iterations from ``i_ite`` to the next record or checkpoint."""
        steps = [every - i_ite % every] if traj is not None else []
        if ckpt is not None:
            steps.append(cfg.save_every - i_ite % cfg.save_every)
        return min(steps, default=cfg.n_iterations - i_ite)

    record(0)  # frame 0: the initial conditions
    prof = None
    if cfg.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        prof.start()
        trace.enable()   # the program's spans, in the trace as murb.<span>
    perf_ite, perf_total = Perf(), Perf()
    physic_time = 0.0
    n_done = n_run = 0
    if cfg.scan and cfg.n_iterations > 0:
        # Time the run as one window after one warm-up step (which builds
        # the kernels on first use); with a single requested iteration
        # that iteration itself is timed.  The window runs in segments
        # that end at each record and checkpoint point.
        warm = 1 if cfg.n_iterations > 1 else 0
        if warm:
            engine.run(warm)
            engine.block_until_ready()
        perf_total.start()
        if warm:
            record(warm)
            checkpoint(warm)
        current = warm
        while current < cfg.n_iterations:
            stop = min(cfg.n_iterations, current + to_next_stop(current))
            engine.run(stop - current)
            current = stop
            record(current)
            checkpoint(current)
        engine.block_until_ready()
        perf_total.stop()
        n_done = cfg.n_iterations - warm   # the timed iterations (for FPS)
        n_run = cfg.n_iterations
        physic_time = cfg.n_iterations * engine.dt
        if cfg.check_finite:
            engine.assert_finite()
    elif not cfg.scan:
        i_ite = 0
        while i_ite < cfg.n_iterations:
            if visu.window_should_close():
                break
            visu.dt = engine.dt
            visu.refresh_display(engine.bodies, time_s=physic_time)
            # Viewer key events -- the interface the reference declares but
            # never polls (ref: src/common/ogl/SpheresVisu.hpp:4-15): space
            # pauses the loop, PgUp/PgDn double/halve dt.
            if visu.pressed_space_bar():
                visu.paused = True
                visu.refresh_display(engine.bodies, time_s=physic_time)
                while not (visu.pressed_space_bar()
                           or visu.window_should_close()):
                    time.sleep(0.05)
                visu.paused = False
                visu.refresh_display(engine.bodies, time_s=physic_time)
            if visu.pressed_page_up():
                engine.set_dt(engine.dt * 2.0)
            if visu.pressed_page_down():
                engine.set_dt(engine.dt / 2.0)
            # land on every record and checkpoint point
            k = min(max(cfg.ite_chunk, 1), cfg.n_iterations - i_ite,
                    to_next_stop(i_ite))
            perf_ite.start()
            if k == 1:
                engine.compute_one_iteration()
            else:
                engine.run(k)
            engine.block_until_ready()   # analogue of cudaDeviceSynchronize
            perf_ite.stop()
            perf_total += perf_ite
            i_ite += k
            physic_time += engine.dt * k
            n_done = n_run = i_ite
            record(i_ite)
            checkpoint(i_ite)
            if cfg.check_finite:
                engine.assert_finite()
            if cfg.verbose:
                gflops = ""
                if cfg.show_gflops:
                    gflops = (f", {perf_total.get_gflops(engine.flops_per_ite * i_ite):6.1f}"
                              " Gflop/s")
                print(f"Iteration n°{i_ite:4d} "
                      f"({perf_total.get_fps(i_ite):6.1f} FPS{gflops}), "
                      f"physic time: {str_date(physic_time)}",
                      end="\r", flush=(i_ite % 5 == 0))
        if cfg.verbose:
            print()
    if prof is not None:
        _write_profile(prof, cfg.profile, device)
    if hasattr(visu, "close"):
        visu.close()

    if traj is not None:
        dropped = traj.close()
        msg = f" ({dropped} frames dropped)" if dropped else ""
        print(f"Trajectory written to {cfg.dump_traj}{msg}")
    print("Simulation ended.")
    print()
    result = CliRun(0, engine, perf_total.get_elapsed_time(),
                    perf_total.get_fps(n_done),
                    perf_total.get_gflops(engine.flops_per_ite * n_done))
    gflops = f", {result.gflops:6.1f} Gflop/s" if cfg.show_gflops else ""
    print(f"Entire simulation took {result.elapsed_ms:g} ms "
          f"({result.fps:g} FPS{gflops})")

    health = engine.proxy_health() if hasattr(engine, "proxy_health") \
        else None
    if health is not None and not health["ok"]:
        if health.get("using_adaptive"):
            print(f"WARNING: the distribution outgrew the sharded adaptive "
                  f"plan (strays {health['strays']}/{health['stray_cap']}, "
                  f"exports {health['exports']}/{health['export_cap']}, "
                  f"cells {health['global_cells']}/{health['global_cap']}, "
                  f"out of box {health['out_of_box']}); rerun with "
                  f"--adapt-every to re-plan mid-run.")
        elif health.get("near") == "adaptive":
            print(f"WARNING: the distribution outgrew the adaptive "
                  f"solver's capacities (occupied cells "
                  f"{health['n_cells_now']} vs caps {health['cell_caps']}; "
                  f"p2p pairs {health['p2p_pairs_now']} vs cap "
                  f"{health['p2p_pmax']}); some near pairs were dropped in "
                  f"late iterations -- rerun with --adapt-every to re-plan "
                  f"mid-run, or --im tpu+hybrid for exact forces.")
        else:
            print(f"WARNING: system expanded beyond the proxy design margin "
                  f"(order m={health['m']}, now requires "
                  f"m={health['required_m_now']}); forces in late "
                  f"iterations are less accurate -- rerun with --im "
                  f"tpu+hybrid for exact forces, or resume from a "
                  f"checkpoint with a fresh engine.")

    if cfg.csv and hasattr(engine, "history"):
        if hasattr(engine, "finalize_history"):
            engine.finalize_history()
        engine.history.save_metrics_to_csv(cfg.csv)
        print(f"Metrics written to {cfg.csv}")

    if cfg.save_state:
        from murb_tpu_torch.core.checkpoint import save_state

        if ckpt is not None:
            ckpt.flush()  # never race the final synchronous write
        save_state(cfg.save_state, engine.bodies,
                   iteration=start_iteration + n_run, dt=engine.dt,
                   soft=engine.soft)
        extra = ""
        if ckpt is not None:
            extra = (f" ({ckpt.written} periodic"
                     + (f", {ckpt.skipped} skipped while busy"
                        if ckpt.skipped else "") + ")")
        print(f"State checkpoint written to {cfg.save_state}{extra}")
    return result


def main(argv=None) -> int:
    """The CLI's exit code.  A process group the run joined is torn down
    before the process exits, the ring's agent threads first
    (``destroy_distributed``): a live gloo group's threads can abort the
    interpreter's exit ("terminate called without an active
    exception")."""
    try:
        return run(argv).rc
    finally:
        if dist.is_available() and dist.is_initialized():
            from murb_tpu_torch.parallel.mesh import destroy_distributed

            destroy_distributed()


if __name__ == "__main__":
    sys.exit(main())
