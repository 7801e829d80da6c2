#!/usr/bin/env python3
"""Smoke test of murb_tpu_torch on one CUDA card: the quickest proof that
the port builds, agrees with its plain versions and runs its main path.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. environment: torch, CUDA, the card, nvidia-smi's name and power limit,
     whether nvcc and triton are present;
  2. build: compile the CUDA kernels from murb_tpu_torch/csrc;
  3. kernel parity: each kernel against its plain PyTorch version (run in
     float64) at main-path shapes, with the max error and both times (K1
     at m 12 and 20 and K2 at k 3, 4, 5 and 11 at m=12 and k=3 at m=20 on
     the 200k galaxy, each launched twice for the same bits and timed
     through the wrapper and alone, its launches in a CUDA graph; K3
     at 16384^2, 5000x16384 and 8000^2, the m=20 node sweep's shape, each
     launched twice for the same bits; K4's passes 3 held to 4e-7 and to
     at most half the error of the fp32 sum with no j split, launched
     twice for the same bits, beside its bound; K4's passes 1 (its own
     kernel, csrc/hybrid_fast.cu) against its plain version (1e-3 a body,
     rms 2e-5) and float64 (5.1e-3), twice for the same bits, in turns
     with K3; K5 and K6 on the merger,
     81,920^2, at R = 2, 1 and 8 weight rows, each launched twice for the
     same bits, K6's force bit for bit K3's and K5's rows bit for bit K6's
     at K6's geometry and j split);
  4. the main path: ``tpu+proxy`` on the N=200,000 galaxy through the CLI
     (``murb_tpu_torch.cli.run``, whose exit code ``cli.main`` returns),
     plus a small CPU-vs-card trajectory check;
  5. K3 on the path: one ``acc_proxy`` at m=20 (8000 nodes) on that state;
  6. K4 on the path: ``--im tpu+hybrid+fast`` (passes 1, its own kernel,
     and no K3 launch), ``--im tpu+hybrid`` (passes 2, which runs K3's
     kernel) and ``--im tpu+hybrid+x3`` (passes 3, K4's own kernel) at
     N=30,000 through the CLI;
  7. the tracked paths at full width: ``tpu+tracking`` and
     ``tpu+leapfrog+tracking --kernel proxy`` on the N=200,000 galaxy
     through the CLI (the fused proxy: K1 and K2; the energy of row 0 held
     to an exact K6 energy of the same state), and the Milky Way-Andromeda
     merger (81,920 bodies, made by scripts/make_two_galaxy_tab.py) with
     ``tpu+tracking+multi`` through the CLI (K4 force, K5 metrics) and
     through ``create_engine`` with no ``acc_fn`` (K6), beside the
     untracked exact engine on the same state; then, at N=2048, each
     tracked and integrator engine on the card against the CPU plain path;
  8. the multi-level hierarchy on the N=200,000 random box: K7 (nf 3 and
     4), K8 and K9 (k 3 and 4) against their plain versions in float64 at
     the main-path shape (m=8, C=4) and a deeper one (m=6, C=8, with the
     near sweep), each launched twice for the same bits, K7 with the
     transfer entries it builds a launch, K8 and K9 timed through the
     wrapper and alone (prebuilt cell order and work items, launches in a
     CUDA graph) beside the share of their bound; ``tpu+proxy -s random`` through the CLI
     (the auto policy picks the hierarchy and validates it);
     ``tpu+tracking --kernel fmm``
     through the CLI (the fused hierarchy, row 0's energy held to an exact
     K6 energy); one ``acc_proxy(cells=2)`` on the 200k galaxy (K8/K9 at
     C=2); and an N=2048 card-against-CPU check of ``levels=2, m=8``;
  9. the adaptive sparse hierarchy: ``tpu+proxy`` on murb_tpu's bench box
     ``adaptive_two_clusters_1m`` (N=1,048,576, two Gaussian clusters, soft
     0.02, dt 1e-6) through ``create_engine`` with the auto policy, which
     must take the adaptive solver and validate it, beside the exact
     ``tpu+hybrid`` on the same state; K10 (nf 3 and 4, and under a pair
     capacity below the candidate count; launched twice for the same
     bits; its sub-tile class shares and row lengths printed), K11 and K12
     (nf 3 and 4) against their plain versions in float64 on that state's
     own sorted bodies, slots and fields, each launched twice for the same
     bits and timed through the wrapper and alone; the dense hierarchy with K10 as its near field
     (``acc_fmm(near="p2p")``); the merger through the CLI with ``--near
     adaptive`` and with ``tpu+tracking --kernel adaptive`` (row 0's energy
     held to an exact K6 energy); an N=4096 card-against-CPU check of the
     adaptive step; the dense far sweep (K7 at the plan's m and C = 2^Ld,
     nf 3 and 4, twice for the same bits); and the repair (K7-K9 at m=18
     and m=32 on a prebuilt cell order, each twice for the same bits, K8
     and K9 through the wrapper and alone beside their bounds);
 10. the exact large-N path: K13 (TF32 tensor-core products) against
     float64 (a 4096-row strided sample of the N=200,000 galaxy against all
     of it, held to the direct sweep of the whole galaxy, and the 16384^2
     galaxy, to its plain version in float64) at every block pair
     it is compiled for, and at "high" and "default" against float64 and
     against its plain version at the same tier, each launched twice for
     the same bits ("highest" must give "high"'s bits; at "default" the
     worst body's gap shown to be one-TF32-ulp flips of W, the rms gap over
     all bodies bounded, and a truncating control read to fail it); the
     study of one TF32 product on S that decides S's tier mapping;
     ``tpu+mxu`` on the N=200,000 galaxy through the CLI (its force error
     after 10 steps held to 5e-4; its 200,192^2 launch held to its plain
     version and to the float64 sweep of the whole galaxy) and
     ``tpu+tracking --kernel mxu`` (row 0's energy held to the exact K6
     energy); ``--autotune`` for tpu+mxu
     at 200k and tpu+hybrid at 16384 and 200k under a temporary cache,
     each candidate's time printed and a second run reading the winner
     without a sweep; ``--save-state`` after 10 steps and ``--load-state``
     for 10 more against 20 straight (bit for bit); ``--dump-traj
     --dump-every 5`` read back;
 11. the distributed modes, with shards on this one card (an explicit device
     list: the protocol is checked, not a link): K14 (whose ring steps are K3's
     sweeps) against its plain version in float64 on the 200k galaxy at D = 1
     to 4 shards, with and without a sleep before every copy and compute, at D
     = 1 bit for bit K3's output, and K3 and K4's tiers at 200,192^2 against
     the same float64 sweep (passes 3 within 4e-7 and half the unsplit
     fp32 error, twice for the same bits, beside its bound), and passes 1
     within 5.1e-3 (the whole galaxy and its 512-row sample) in turns
     with K3; ``--im
     shard+ring --shards 1`` through the CLI
     (its force error after 10 steps held to 5e-4); ``shard+ring`` on 4 shards
     against ``tpu+tile`` (accelerations, positions after 10 steps, FPS) and
     its sharded checkpoint round trip (bit for bit); ``shard+allgather`` and
     ``shard+uneven`` (0.6) on 4 shards against ``tpu+hybrid``; ``shard+proxy``
     on the galaxy (K1/K2) and on the random box (promoted to the hierarchy at
     phase 8's (m, L): K7-K9); ``shard+adaptive`` on the 1M two-cluster box (1
     shard) and the merger (2 shards): K10-K12, health ok; and K14 across
     processes (its cross-process instance, CUDA IPC and flag words): 2, 3
     and 4 worker processes of this script (``--ring-worker``) on cuda:0, a
     gloo group, at P x L = 2x1, 2x2, 3x1 and 4x1 on the 200k galaxy, fp32
     and bf16, 3 calls each with no delay and with a 5 us delay in one
     process, then in another, every shard's sums bit for bit the
     one-process K14 at D = P L and within WithinRel 1e-5 (rms floor 5e-6)
     of float64, then ``shard+ring`` for 3 steps (bit for bit the
     one-process engine), the time a call beside the one-process time
     (time-sliced contexts on one card, not a link), the plain version
     across processes at 2x2; and K14 across hosts (its cross-host
     instance: the boundary slot staged through pinned host memory and
     sent by agent threads on a gloo side group, loopback TCP standing for
     the network): 2 and 4 worker processes placed on 2 and 4 hosts at 2
     hosts x 1 x 1, 2 hosts x 1 x 2, 2 hosts x 2 x 1 (IPC inside a host,
     staged between) and 4 hosts x 1 x 1, fp32 and bf16, 3 calls each with
     no delay, with 5 us in process 0, then in the last, and with 1 ms
     before every send of the last process's agent, every shard bit for bit
     the one-process K14 at D = P L, WithinRel 1e-5 of float64, 3
     ``shard+ring`` steps (auto) bit for bit with the cross-host instance's
     launches counted, the time a call beside the IPC ring's at the same P
     x L (at 2 hosts x 1 x 2 in turns with it, on the same processes), the
     plain version across 2 hosts at 2 shards a process; a worker that
     fails or outlives its limit fails the run;
 12. the differentiable rollouts (murb_tpu_torch.diff), which launch no
     kernel (every count stays 0 across the phase): the exact adjoint
     (chunked, 16,384 random bodies, float64, 5 Euler steps, remat) against
     central differences at 3 bodies (rel 1e-5) and in fp32 against float64
     (WithinRel 1e-3); loss, gradients w.r.t. vx, m, qx, dt and soft and
     the final state of the card against the CPU (N=2048, float64, chunked
     and proxy, 1e-9); the proxy adjoint (m=12) on the 200k galaxy (finite,
     nonzero on the bodies, 0 on the ghosts) and against the chunked one at
     16,384 (WithinRel 1e-2, rms floor 1e-3); a vmapped ensemble of 3
     against its members (1e-6); KDK and Yoshida4 gradients;
     fit_initial_velocities (below 0.05 of its first loss) and
     scripts/torch_fit_ic.py's defaults; a grad-requiring input refused by
     K1's and K3's wrappers; the ms of a forward + backward step and the
     peak memory of the exact fp32 adjoint and the 200k proxy adjoint;
 13. the viewer and the profiler through the CLI, each run a process of its
     own: ``tpu+proxy -n 200000 --visu-live 0`` (frames served, one decoded,
     space pauses, close ends it with exit 0) and ``-i 20 --nv --profile
     DIR`` (the Chrome trace parses and holds K1's and K2's kernels; the
     device time printed);
 14. the lossy M2L tiers: K7's lossy instance (K7b, 3xTF32 tensor-core
     products) against float64 and against its plain lossy version, at nf
     3 and 4, every subset at m=8, C=4 on the random box and m=32, C=2 on
     the 1M box (5e-6 and 1e-4 of max|f|, which two broken-arithmetic
     controls must exceed), and far and expand at the 1M step's dense
     base (the plan's m=6 and C = 2^Ld, whose 216 nodes run the pad
     slots), each launched twice for the same bits and timed in turns with
     the fp32 instance beside its bound;
     the sparse M2L's forms (each tier, the scan chunk, the fused form)
     against float64 with the TF32 flags unchanged; ``tpu+proxy -s random
     --m2l-dots bf16x3`` and ``mixed`` at N=200,000 through the CLI
     (validated error, picked tier, FPS); and on phase 9's 1M state and
     plan ``acc_adaptive`` at fp32, bf16x3, mixed, m2l_rank=128 and the
     fused bf16x3 form, each within TOL: the error on the 512-row sample,
     ms a call and its sparse M2L's ms;
 15. the bf16 state (``--precision bf16``): the bf16 instances of K3 and
     K4 (passes 1, 2, 3) at 200,192^2, of K1 and K2 (m=12, k=3) and of K8
     and K9 (m=4, C=4, k=3) on the 200k galaxy, each bit for bit its fp32
     instance on the arrays upcast at the same geometry and split; at
     16384^2 K3's and K4's own sums at the split its wrapper takes (its
     own resident count), which are the wrapper's outputs before rounding
     and the fp32 instance's bits at that split; each against its plain
     version (bf16 out: WithinRel 1e-2, rms floor 1e-4) and float64 (the
     fp32 instance's contracts), timed in turns with the fp32 instance
     beside its bound; ``tpu+proxy
     --precision bf16`` at N=200,000 through the CLI (the configuration the
     ladder keeps, its error, the warning, FPS, memory half the fp32
     run's), ``tpu+tile``, ``tpu+hybrid``, ``+fast`` and ``+x3`` at
     200,192 bodies in bf16; and the card's power (nvidia-smi) through
     scripts/torch_measure_energy.py around 1000 steps of the 200k proxy
     run at fp32 and at bf16 (mean W and J a step of the frame loop); the
     1M two-cluster box in bf16 (its plan, validated error, the bf16
     instances of K10-K12 launched, ms a step in turns with fp32), those
     three bit for bit their fp32 instances on its sorted bodies, against
     float64 and in turns with fp32, and the merger's tracked energy in
     bf16 (row 0 within 1e-3 of float64; the CLI's K5-bf16); the bf16
     instances of K5 and K6 (the merger, 81,920^2, R = 1, 2, 8), K13
     (200,192^2, "high" and "default") and K14 (the 200k galaxy at D = 1
     and 4 shards, and 2 shards of 16,383 bodies), each bit for bit its
     fp32 instance on the arrays upcast at its wrapper's split (K14 at
     D = 1 also K3's bf16 instance), against its plain version and
     float64 at the fp32 instance's limits, timed in turns alone and
     through the wrapper, with its registers and spills; the merger
     through ``create_engine`` (K6-bf16), ``shard+ring`` on 4 shards of
     the card (K14-bf16) and ``tpu+mxu --precision bf16`` through the CLI
     (K13-bf16);
 16. the planners' decisions at the card's rates: on the two-cluster box
     at N = 131,072, 262,144 and 524,288 (and phase 9's 1M engine) and on
     the merger, the auto policy's pick and its two estimates beside the
     measured step of the adaptive and the exact branch (the pick must be
     the faster wherever they differ by more than 15%); the exact model
     within 1.5x of the step at the three N, the adaptive model within
     1.5x at 1M; on the 200k random box the step at each (m, levels)
     ``best_depth`` weighs, its pick within 10% of the fastest;
 17. ``tpu+proxy``'s stage geometry (``block``, ``m2l_tile``): each
     candidate of ``ProxyEngine._fast_candidates`` for K1 and K2 on the
     200k galaxy at m=12 and for K8 and K7 on the 200k random box at (m,
     L) = (8, 2) against the plain version in float64 (phase 3's and
     phase 8's tolerances), today's geometry given explicitly for the
     bits of 0, ``--autotune`` through the CLI under a temporary cache
     (every candidate timed, the pick stored under the engine's key) and a
     second run that reads the pick with no sweep, and the pick against
     today's in turns with its measured force error held to 1e-4.
Each piece of the path (the CLI run of phase 4, the ``acc_proxy`` of phase
5, each CLI run of phase 6, each run of phases 7 to 11) starts from zeroed
launch counts, which are read right after it: K1 and K2 from phase 4, K3
from phase 5, K4 from phase 6, K5 and K6 from phase 7, K7 to K9 from the
``tpu+proxy -s random`` run of phase 8, K10 to K12 from the two-cluster
run of phase 9, K13 from the ``tpu+mxu`` run of phase 10, K14 from the
4-shard ``shard+ring`` run of phase 11, K7b (K7's lossy instance) from the
``--m2l-dots bf16x3`` run of phase 14, the bf16 instances of K1, K2, K8
and K9 from phase 15's ``tpu+proxy --precision bf16`` run (the ladder's
rungs launch all four; the rung it keeps, its pair every step), K3's from its
``tpu+tile`` run and K4's from each ``tpu+hybrid`` run (each must launch
in each), K4's passes 1 from phase 6's ``tpu+hybrid+fast`` run (and its
bf16 instance from phase 15's), K10-K12's bf16 instances from phase 15's
1M bf16 run, K5's from its bf16 merger CLI run, K6's, K14's and K13's
from its bf16 merger through ``create_engine``, 4-shard ``shard+ring``
and ``tpu+mxu`` runs (each with no launch of the fp32 instance), K14's
cross-process instances from the workers' 3-step ``shard+ring`` runs at
2x2 and its cross-host instances from those at 2 hosts x 1 x 2 (every
process's count, zeroed just before the run).  Every kernel
must have launched in its piece.  The line before the last is the kernels' JSON
record (with each kernel's bound: the larger of its bytes over 3.35 TB/s
and its operations over the 67 TFLOP/s fp32 peak of an H100 SXM; K5's and
K6's also no less than their MUFU rsqrt floor, one a pair at 16 a clock
an SM; K13's the largest of its MUFU rsqrt floor, its TF32 products at
495 TFLOP/s and its fp32 work; K7b's the largest of its build's fp32 work
and MUFU rsqrt and its three TF32 products); the last line is the result
object.

Needs a CUDA device and the rest of the repository beside this file; it
exits non-zero without printing a result otherwise.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 123
SOFT = 2.0e8
DT = 3600.0
TOL = 1e-4
ROOT = os.path.dirname(os.path.abspath(__file__))
#: rms floor of phase 12's fp32-against-float64 adjoint check
RMS_FLOOR_32 = 1e-3
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, fp32 FLOP/s
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes moved once over the
    memory rate, or operations over the fp32 rate, whichever is larger."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def m2l_work(m: int, C: int, subset: str, nf: int) -> tuple[int, float]:
    """(cell pairs, useful flops) of one M2L level sweep: 2 nf flops per
    node pair of each (target, source) cell pair the subset admits, plus
    one transfer build (12 ops per node pair) per offset some pair uses.
    Counted here from the rules (in-grid source, the parity of |o_d| = 3),
    independently of the kernel's plan."""
    reach, min_inf = {"expand": (3, 0), "near": (1, 0),
                      "far": (3, 2)}[subset]
    par = lambda o, i: i % 2 == 0 if o == 3 else (
        i % 2 == 1 if o == -3 else True)
    pairs = used = 0
    for o in itertools.product(range(-reach, reach + 1), repeat=3):
        if max(map(abs, o)) < min_inf:
            continue
        n_o = sum(
            all(0 <= i + d < C for i, d in zip(cell, o))
            and (subset == "near" or all(par(d, i)
                                         for d, i in zip(o, cell)))
            for cell in itertools.product(range(C), repeat=3))
        pairs += n_o
        used += n_o > 0
    return pairs, (2 * nf * pairs + 12 * used) * m ** 6


def ext_bound_ms(ni: int, nj: int, sms: int, clk: float) -> dict:
    """The floors (ms) of K4's passes 3 over ni x nj pairs, each work at
    its own rate: fp32, 20 flops a pair (K3's model; the kernel's Newton
    step on the rsqrt is its design's choice, not counted) at 67 TFLOP/s;
    one MUFU rsqrt a pair and 3
    F2F (fp32 to fp64) a target a run of 4 sources at 16 a clock an SM; 3
    DADD a target a run at 64 a clock an SM (H100: the CUDA programming
    guide's throughput table), at ``clk`` Hz on ``sms`` SMs."""
    pairs = float(ni) * nj
    per_clock = sms * clk
    return {"fp32": 20 * pairs / PEAK_FP32 * 1e3,
            "mufu": pairs / (16 * per_clock) * 1e3,
            "f2f": 0.75 * pairs / (16 * per_clock) * 1e3,
            "dadd": 0.75 * pairs / (64 * per_clock) * 1e3}


#: issue slots a pair of K4's passes 1 (csrc/hybrid_fast.cu): 3 FADD, 3
#: FFMA, 2 FMUL, 1 IADD and the MUFU rsqrt's own slot, and a sixteenth of a
#: chunk's 2 LDS.128, 1 LDS.64 and 4 HMMA a lane (16 pairs a lane a chunk)
FAST_ISSUE = 10 + 7 / 16


def fast_bound_ms(ni: int, nj: int, sms: int, clk: float) -> dict:
    """The floors (ms) of K4's passes 1 over ni x nj pairs at its own
    instruction count: one MUFU rsqrt a pair at 16 a clock an SM, and
    FAST_ISSUE issue slots a pair at one warp instruction a clock a
    sub-partition (128 thread instructions a clock an SM), at ``clk`` Hz
    on ``sms`` SMs."""
    pairs = float(ni) * nj
    per_clock = sms * clk
    return {"mufu": pairs / (16 * per_clock) * 1e3,
            "issue": FAST_ISSUE * pairs / (128 * per_clock) * 1e3}


def body_errs(got, ref) -> tuple[float, float]:
    """(max, rms) over bodies of |a - a_ref| / max(|a_ref|, 1e-6 max
    |a_ref|): the ops/validate statistic and its rms."""
    import torch

    g = torch.stack([v.double() for v in got], 1)
    r = torch.stack([v.double() for v in ref], 1)
    rn = r.norm(dim=1)
    e = (g - r).norm(dim=1) / torch.clamp(rn, min=1e-6 * float(rn.max()))
    return float(e.max()), float(e.pow(2).mean().sqrt())


def in_turns(time_ms, fn32, fn16, **kw) -> tuple[float, float]:
    """The fp32 and the bf16 instance timed by ``time_ms`` in turns (32,
    16, 16, 32): the medians of each."""
    a, b, c, d = (time_ms(f, **kw) for f in (fn32, fn16, fn16, fn32))
    return statistics.median((a, d)), statistics.median((b, c))


def timed(engine, n_steps):
    """(engine, steps per second of ``run`` after one warm-up step)."""
    engine.run(1)
    engine.block_until_ready()
    t0 = time.perf_counter()
    engine.run(n_steps - 1)
    engine.block_until_ready()
    return engine, (n_steps - 1) / (time.perf_counter() - t0)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def phase12(dev, smi, drive, within_rel, n_exact=16_384, n_full=200_000,
            n_cmp=2048, fit_script=True):
    """The differentiable rollouts (murb_tpu_torch.diff) on ``dev``: the
    exact adjoint, the card against the CPU, the full-width proxy adjoint,
    the ensemble, the other integrators and the fit.  No kernel may launch:
    ``drive`` returns the launch counts of the whole phase.  Sizes are
    arguments so that the phase can be rehearsed small on the CPU."""
    import dataclasses

    import torch

    from murb_tpu_torch.core.init import init_galaxy, init_random
    from murb_tpu_torch.diff import (ensemble, fit_initial_velocities,
                                     rollout, stack_states, target_loss)

    def target_of(s):
        return (torch.stack([s.qx, s.qy, s.qz], 1)[: s.n] * 1.001).detach()

    def loss_of(s, target, steps, **kw):
        return target_loss(rollout(s, steps=steps, dt=DT, soft=SOFT, **kw),
                           target)

    def grads(s, steps, comps=("vx",), dt=DT, soft=SOFT, **kw):
        """(loss, {name: gradient}) of the 1.001-scaled target's loss, for
        the fields in ``comps`` and, as tensors, ``dt`` and ``soft``."""
        target = target_of(s)
        leaves = {k: getattr(s, k).clone().requires_grad_() for k in comps
                  if k not in ("dt", "soft")}
        phys = {k: torch.tensor(v, dtype=torch.float64,
                                requires_grad=True)
                for k, v in (("dt", dt), ("soft", soft)) if k in comps}
        st = dataclasses.replace(s, **leaves)
        loss = target_loss(rollout(st, steps=steps, dt=phys.get("dt", dt),
                                   soft=phys.get("soft", soft), **kw),
                           target)
        names = [*leaves, *phys]
        g = torch.autograd.grad(loss, [*leaves.values(), *phys.values()])
        return loss.detach(), dict(zip(names, g))

    def rel(a, b) -> float:
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))

    def step_cost(fn, steps):
        """(ms a forward + backward step, peak bytes) of ``fn``'s second
        call (the first warms the allocator); the peak is counted above
        the tensors already live (earlier phases' states)."""
        fn()
        if dev.type != "cuda":
            return float("nan"), 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / steps,
                torch.cuda.max_memory_allocated(dev) - live)

    def run():
        # (a) the exact adjoint, float64, against central differences
        s64 = init_random(n_exact, SEED, device=dev).astype(torch.float64)
        t64 = target_of(s64)
        _, g = grads(s64, 5)
        g64 = g["vx"]
        worst_fd = 0.0
        with torch.no_grad():
            for i in (0, 7, 31):
                h = max(abs(float(s64.vx[i])), 1e3) * 1e-4
                vp, vm = s64.vx.clone(), s64.vx.clone()
                vp[i] += h
                vm[i] -= h
                fd = (float(loss_of(dataclasses.replace(s64, vx=vp), t64, 5))
                      - float(loss_of(dataclasses.replace(s64, vx=vm), t64,
                                      5))) / (2 * h)
                r = abs(fd - float(g64[i])) / abs(float(g64[i]))
                worst_fd = max(worst_fd, r)
                check(r <= 1e-5, f"exact adjoint vs central differences at "
                                 f"body {i}: rel {r:.3e} > 1e-5")
        s32 = s64.astype(torch.float32)
        _, g = grads(s32, 5)
        # an rms floor for the components near zero, where the fp32
        # gradient cancels (tests/test_diff.py's convention for gradients)
        share32 = within_rel([g["vx"][: s32.n]], [g64[: s64.n]], 1e-3,
                             RMS_FLOOR_32)
        check(share32 <= 1.0, f"fp32 adjoint vs float64: {share32:.3f}x of "
                              f"WithinRel 1e-3 (rms floor {RMS_FLOOR_32})")
        ms_a, peak_a = step_cost(lambda: grads(s32, 5), 5)
        print(f"[12 exact] chunked, {n_exact} random bodies, 5 Euler steps, "
              f"remat: d loss/d vx against central differences (float64) "
              f"worst rel {worst_fd:.3e} (limit 1e-5); fp32 against float64 "
              f"at {share32:.4g} of WithinRel 1e-3 (rms floor "
              f"{RMS_FLOOR_32}); fp32 forward + backward "
              f"{ms_a:.3f} ms a step, peak {peak_a / 2**30:.3f} GiB above the "
              f"live tensors on {smi}")
        del s64, s32, g64, g

        # (b) the card against the CPU, float64
        small = init_random(n_cmp, SEED, device="cpu").astype(torch.float64)
        comps = ("vx", "m", "qx", "dt", "soft")
        worst_b = {}
        for method in ("chunked", "proxy"):
            res = [grads(small.to(d), 3, comps, method=method)
                   for d in ("cpu", dev)]
            fin = [rollout(small.to(d), steps=3, dt=DT, soft=SOFT,
                           method=method) for d in ("cpu", dev)]
            errs = [rel(res[1][0], res[0][0])]
            errs += [rel(res[1][1][k], res[0][1][k]) for k in comps]
            errs += [rel(getattr(fin[1], k), getattr(fin[0], k))
                     for k in ("qx", "vy")]
            worst_b[method] = max(errs)
            check(worst_b[method] <= 1e-9, f"{method} card vs CPU (float64, "
                                           f"N={n_cmp}): {errs}")
        print(f"[12 card vs cpu] N={n_cmp} float64, 3 steps: loss, "
              f"gradients w.r.t. vx, m, qx, dt, soft and the final state, "
              f"worst rel {worst_b} (limit 1e-9)")

        # (c) full width: the proxy adjoint on the galaxy
        gal = init_galaxy(n_full, SEED, device=dev)
        comps_v = ("vx", "vy", "vz")
        _, g = grads(gal, 5, comps_v, method="proxy", m=12)
        for k in comps_v:
            check(bool(torch.isfinite(g[k]).all()), f"proxy grad {k} finite")
            check(float(g[k][: gal.n].abs().max()) > 0, f"proxy grad {k} 0")
            if gal.padding:
                check(float(g[k][gal.n:].abs().max()) == 0.0,
                      f"proxy grad {k} on ghosts")
        ms_c, peak_c = step_cost(
            lambda: grads(gal, 5, comps_v, method="proxy", m=12), 5)
        del gal, g
        g16 = init_galaxy(n_exact, SEED, device=dev)
        g_px = grads(g16, 3, method="proxy", m=12)[1]["vx"][: g16.n]
        g_ch = grads(g16, 3)[1]["vx"][: g16.n]
        share_c = within_rel([g_px], [g_ch], 1e-2, 1e-3)
        check(share_c <= 1.0, f"proxy vs chunked gradient: {share_c:.3f}x "
                              "of WithinRel 1e-2 (rms floor 1e-3)")
        print(f"[12 full width] proxy m=12, {n_full} galaxy bodies fp32, 5 "
              f"Euler steps, remat: d loss/d v finite, nonzero on the bodies, "
              f"0 on the ghosts; forward + backward {ms_c:.3f} ms a step, "
              f"peak {peak_c / 2**30:.3f} GiB above the live tensors on "
              f"{smi}; at {n_exact} the proxy "
              f"gradient at {share_c:.4g} of WithinRel 1e-2 (rms floor 1e-3) "
              f"of the chunked one")
        del g16, g_px, g_ch

        # (d) the ensemble
        members = [init_random(n_exact, k, device=dev) for k in (1, 2, 3)]
        batch = ensemble(rollout, steps=4, dt=DT, soft=SOFT,
                         method="chunked")(stack_states(members))
        share_d = max(within_rel([batch.qx[k]], [rollout(
            mb, steps=4, dt=DT, soft=SOFT, method="chunked").qx], 1e-6, 0.0)
            for k, mb in enumerate(members))
        check(share_d <= 1.0, f"ensemble vs members: {share_d:.3f}x of 1e-6")
        print(f"[12 ensemble] 3 x {n_exact} fp32, 4 steps, vmapped: members' "
              f"qx at {share_d:.4g} of WithinRel 1e-6")
        del members, batch

        # (e) the other integrators and the fit
        s = init_random(n_exact, SEED, device=dev)
        for integ in ("kdk", "yoshida4"):
            g = grads(s, 3, integrator=integ)[1]["vx"]
            check(bool(torch.isfinite(g).all())
                  and float(g[: s.n].abs().max()) > 0,
                  f"{integ} gradient finite and nonzero")
        f0 = init_random(32, 5, device=dev).astype(torch.float64)
        tgt = rollout(dataclasses.replace(f0, vx=f0.vx * 1.2, vy=f0.vy * 0.8),
                      steps=8, dt=DT, soft=SOFT)
        tgt = torch.stack([tgt.qx, tgt.qy, tgt.qz], 1)[: f0.n].detach()
        _, losses = fit_initial_velocities(f0, tgt, steps=8, dt=DT,
                                           soft=SOFT, iters=25)
        check(losses[-1] < 0.05 * losses[0], f"fit: {losses[0]:.3e} -> "
                                             f"{losses[-1]:.3e}")
        print(f"[12 integrators, fit] kdk and yoshida4 gradients at "
              f"{n_exact} finite and nonzero; fit_initial_velocities (N=32, "
              f"8 steps, 25 iterations) loss ratio "
              f"{losses[-1] / losses[0]:.3e} (limit 0.05)")

    _, counts = drive(run)
    check(all(c == 0 for c in counts.values()),
          f"a kernel launched on the differentiable path: {counts}")

    if fit_script:
        p = subprocess.run([sys.executable, os.path.join(
            ROOT, "scripts", "torch_fit_ic.py")], capture_output=True,
            text=True, cwd=ROOT, timeout=600)
        lines = p.stdout.strip().splitlines()
        check(p.returncode == 0 and lines and lines[-1].startswith(
            "loss ratio"), f"torch_fit_ic.py rc {p.returncode}: "
                           f"{p.stdout[-500:]}{p.stderr[-1500:]}")
        ratio = float(lines[-1].split()[-1])
        check(ratio < 0.05, f"torch_fit_ic.py loss ratio {ratio}")
        print(f"[12 fit script] scripts/torch_fit_ic.py (defaults: 256 "
              f"bodies, 20 steps, 40 iterations, chunked) on the card: "
              f"{lines[-2]}; loss ratio {ratio:.3e}")

    # the guard: a grad-requiring input to a kernel wrapper raises
    from murb_tpu_torch.ops.proxy import bounding_box
    from murb_tpu_torch.ops.proxy_kernels import p2m_fused
    from murb_tpu_torch.ops.tile import acc_tile_rect

    s = init_random(4096, SEED, device=dev)
    c, h = bounding_box(s.qx, s.qy, s.qz, s.m > 0)
    qx = s.qx.clone().requires_grad_()
    for name, call in (
            ("p2m_fused (K1)", lambda: p2m_fused(qx, s.qy, s.qz, s.m, c, h,
                                                 m=12)),
            ("acc_tile_rect (K3)", lambda: acc_tile_rect(
                qx, s.qy, s.qz, s.qx, s.qy, s.qz, s.m, SOFT))):
        try:
            call()
        except RuntimeError as e:
            check("no backward" in str(e), f"{name}: {e}")
        else:
            check(False, f"{name} took a grad-requiring input")
    print(f"[12 guard] p2m_fused and acc_tile_rect on the card refuse a "
          f"grad-requiring input; launches across the phase {counts}")


def phase13(smi, n=200_000, device="cuda"):
    """The viewer and the profiler through the CLI on the card, each in a
    process of its own: ``--visu-live 0`` (frames, a decoded frame, pause
    and close) and ``--profile DIR`` (the trace, K1's and K2's kernels in
    it, the device time)."""
    import re
    import urllib.request

    from murb_tpu_torch.visu.live import decode_header

    max_pts = 100_000
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               MURB_VISU_MAX_POINTS=str(max_pts))
    proc = subprocess.Popen(
        [sys.executable, "-m", "murb_tpu_torch", "--im", "tpu+proxy", "-n",
         str(n), "-i", "100000", "--visu-live", "0", "--device", device],
        cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port, deadline = None, time.time() + 300
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            hit = re.search(r"http://127\.0\.0\.1:(\d+)", line)
            port = int(hit.group(1)) if hit else None
        check(port is not None, "viewer URL never printed:\n"
                                + "".join(lines[-30:]))
        url = f"http://127.0.0.1:{port}"

        def get(path):
            with urllib.request.urlopen(url + path, timeout=60) as r:
                return r.read()

        def info():
            return json.loads(get("/info"))

        def key(k):
            urllib.request.urlopen(urllib.request.Request(
                url + "/key", data=json.dumps({"key": k}).encode(),
                method="POST"), timeout=60).read()

        deadline = time.time() + 300
        while info()["frame"] < 2 and time.time() < deadline:
            time.sleep(0.1)
        frames = info()["frame"]
        check(frames >= 2, f"viewer frames {frames}")
        head = decode_header(get("/frame?since=-1"))
        check(head["n"] == min(n, max_pts),
              f"frame of {head['n']} bodies, expected {min(n, max_pts)}")
        key("space")
        time.sleep(1.0)
        f0 = info()
        time.sleep(1.0)
        f1 = info()
        check(f0["paused"] and f1["frame"] == f0["frame"],
              f"pause: {f0} then {f1}")
        key("close")
        rest, _ = proc.communicate(timeout=300)
        lines.append(rest)
        check(proc.returncode == 0 and "Simulation ended." in rest,
              f"viewer run rc {proc.returncode}: {rest[-1500:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    print(f"[13 viewer] tpu+proxy N={n} --visu-live 0 through the CLI: "
          f"{frames} frames served, /frame decoded ({head['n']} bodies, "
          f"stride {head['stride']}, MURB_VISU_MAX_POINTS={max_pts}), space "
          f"paused at frame {f0['frame']}, close ended it (exit 0)")

    out_dir = os.path.join(ROOT, "build", "chip_smoke_profile")
    shutil.rmtree(out_dir, ignore_errors=True)
    p = subprocess.run(
        [sys.executable, "-m", "murb_tpu_torch", "--im", "tpu+proxy", "-n",
         str(n), "-i", "20", "--nv", "--profile", out_dir, "--device",
         device], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    check(p.returncode == 0 and f"Profiler trace written to {out_dir}"
          in p.stdout, f"--profile rc {p.returncode}: {p.stdout[-1500:]}"
                       f"{p.stderr[-1500:]}")
    with open(os.path.join(out_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    k1 = sum("p2m_runs_kernel" in k and "OneRun" in k for k in kernels)
    k2 = sum("l2p_one_run_kernel" in k for k in kernels)
    check(k1 > 0 and k2 > 0, f"trace kernels: K1 {k1}, K2 {k2} of "
                             f"{len(kernels)}")
    hit = re.search(r"Profiled device time: ([0-9.]+) ms", p.stdout)
    check(hit is not None, f"no device time printed: {p.stdout[-800:]}")
    print(f"[13 profile] tpu+proxy N={n} -i 20 --profile: trace of "
          f"{len(events)} events, {len(kernels)} kernel events (K1 {k1}, K2 "
          f"{k2}); device time {hit.group(1)} ms over the 20 steps on {smi}")


def phase14(dev, smi, drive, time_ms, st9, soft9, plan, pick8,
            n_main=200_000):
    """The lossy M2L tiers on the card.  K7's lossy instance (K7b, the
    m2l_dots tier "bf16x3": the fp32 build of T, the apply as 3xTF32
    tensor-core products) against its plain version in float64 (unrounded,
    the reference) and, at m=8, C=4, in fp32 (the plain lossy arithmetic,
    ops/mxu.split3_matmul), each subset and field count at the random
    box's shape, at the 1M step's dense base (phase 9's plan, m=6 at C =
    2^Ld: far, the shape the step gives K7b, and expand; m^3 = 216 fills
    no whole 256-node chunk, so the pad slots run) and at the ladder's top
    order on the 1M box (m=32, C=2: near is expand there and far admits
    no cell).  Limits
    against the largest magnitude of each field, against float64 and
    against the plain lossy version alike, set from the readings: 5e-6 at
    m <= 8, 1e-4 at m=32; two controls (the plain sweep with one TF32
    pass, and with split3 less its small x big product) must read above
    the limit at m=8 and m=32.  The same bits twice; its time and the
    fp32 instance's in turns (fp32, lossy, lossy, fp32).  K7b's bound: the larger of the build's fp32 work (12 ops a
    node pair of each used offset) and its MUFU rsqrt (one each, 16 a
    clock an SM) and three TF32 products of 2 nf flops a node pair of
    each cell pair at 495 TFLOP/s.  Then the sparse M2L's forms against
    float64 on random expansions (the TF32 flags unchanged after each),
    ``--m2l-dots bf16x3`` and ``mixed`` through the CLI on the random
    box, and the 1M step (phase 9's state ``st9`` and ``plan``, no engine
    build) under each tier, m2l_rank=128 and the fused form, each within
    TOL on the 512-row sample.  ``drive`` and ``time_ms`` are main's;
    ``pick8`` is phase 8's (m, levels).  Returns (K7b's kernels record,
    its launches in the bf16x3 CLI run)."""
    import numpy as np
    import torch

    from murb_tpu_torch import G, cli
    from murb_tpu_torch.core.init import init_random
    from murb_tpu_torch.ops import cuda
    from murb_tpu_torch.ops import fmm_kernels as fk
    from murb_tpu_torch.ops import sparse_fmm as sf
    from murb_tpu_torch.ops.mxu import tf32_round, tf32_split
    from murb_tpu_torch.ops.fmm import _heavy_setup
    from murb_tpu_torch.ops.proxy import bounding_box, heavy_split
    from murb_tpu_torch.ops.validate import measured_force_error

    sms = cuda.sm_count(dev)
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    q9 = (st9.qx, st9.qy, st9.qz)
    g9 = st9.m * torch.tensor(G, dtype=torch.float32).item()
    c9, h9, *_rest, ge9 = _heavy_setup(*q9, g9, 1, sf.HEAVY_FACTOR)
    h9 = h9.max().expand(3)       # the adaptive solve's cubic box

    def rel_max(got, ref) -> float:
        return max(float((g.double() - r).abs().max() / r.abs().max())
                   for g, r in zip(got, ref))

    def plain_with(product, w, hl, soft, **kw):
        """The plain lossy sweep with ``product`` in place of
        split3_matmul: the controls that show a limit's power."""
        saved = fk.split3_matmul
        fk.split3_matmul = product
        try:
            return fk.m2l_level_plain(w, hl, soft, dots="bf16x3", **kw)
        finally:
            fk.split3_matmul = saved

    def one_pass(a, b):       # a single TF32 product
        return tf32_round(a) @ tf32_round(b)

    def lost_term(a, b):      # split3_matmul less its small x big product
        (ab, _), (bb, bs) = tf32_split(a), tf32_split(b)
        return ab @ bb + ab @ bs

    def k7b_case(m, C, w, hl, soft, reps, tol,
                 subsets=("expand", "near", "far"), controls=False,
                 time_plain=False):
        rows = {}
        for subset in subsets:
            refs = None
            for nf in (3, 4):
                kw = dict(m=m, C=C, subset=subset, with_phi=nf == 4)
                label = f"14 K7b m2l m={m} C={C} {subset} nf={nf}"
                fb = fk.m2l_level_fused(w, hl, soft, dots="bf16x3", **kw)
                check(all(torch.equal(a, b) for a, b in zip(
                    fb, fk.m2l_level_fused(w, hl, soft, dots="bf16x3",
                                           **kw))),
                      f"{label}: two launches differ")
                pairs, flops = m2l_work(m, C, subset, nf)
                if pairs == 0:
                    check(all(not x.any() for x in fb),
                          f"{label}: no cell pair, nonzero fields")
                    print(f"[{label}] no cell pair: zero fields, the same "
                          f"bits twice")
                    continue
                if refs is None:  # the nf = 4 sweeps hold nf = 3's fields
                    kw4 = dict(kw, with_phi=True)
                    refs = (fk.m2l_level_plain(w.double(), hl.double(), soft,
                                               **kw4),
                            fk.m2l_level_plain(w, hl, soft, dots="bf16x3",
                                               **kw4))
                f64, fpl = refs[0][:nf], [x.double() for x in refs[1][:nf]]
                err, errp = rel_max(fb, f64), rel_max(fb, fpl)
                check(err <= tol, f"{label}: {err:.3e} of max|f| against "
                                  f"float64 (tol {tol:g})")
                check(errp <= tol, f"{label}: {errp:.3e} of max|f| against "
                                   f"the plain lossy version (tol {tol:g})")
                err32 = rel_max(fk.m2l_level_fused(w, hl, soft, **kw), f64)
                msg, plain_ms = "", None
                if controls and nf == 3 and subset == "expand":
                    e1 = rel_max(plain_with(one_pass, w, hl, soft, **kw),
                                 f64)
                    e2 = rel_max(plain_with(lost_term, w, hl, soft, **kw),
                                 f64)
                    check(min(e1, e2) > tol,
                          f"{label}: the limit {tol:g} passes a control "
                          f"({e1:.3e}, {e2:.3e})")
                    msg = (f"; controls (above the limit): one TF32 pass "
                           f"{e1:.3e}, split3 less small x big {e2:.3e}")
                if time_plain:
                    plain_ms = time_ms(lambda: fk.m2l_level_plain(
                        w, hl, soft, dots="bf16x3", **kw), reps=1, runs=3)
                    msg += f"; plain lossy {plain_ms:.4f} ms"
                t32 = [time_ms(lambda: fk.m2l_level_fused(w, hl, soft,
                                                          **kw),
                               reps=reps, runs=3)]
                tb = [time_ms(lambda: fk.m2l_level_fused(
                    w, hl, soft, dots="bf16x3", **kw), reps=reps, runs=3)
                    for _ in range(2)]
                t32.append(time_ms(lambda: fk.m2l_level_fused(
                    w, hl, soft, **kw), reps=reps, runs=3))
                used = (flops / m ** 6 - 2 * nf * pairs) / 12
                floors = {"fp32": 12 * used * m ** 6 / PEAK_FP32 * 1e3,
                          "mufu": used * m ** 6 / (16 * sms * clk) * 1e3,
                          "tensor": 6 * nf * pairs * m ** 6 / 495e12 * 1e3,
                          "bytes": bound(4 * (1 + nf) * C ** 3 * m ** 3,
                                         0)[0]}
                b_ms = max(floors.values())
                plan_b = fk._plan_on(m, C, subset, nf, dev, "bf16x3")[0]
                print(f"[{label}] max|df|/max|f| {err:.3e} against float64, "
                      f"{errp:.3e} against the plain lossy fp32 (tol "
                      f"{tol:g}; the fp32 instance {err32:.3e}){msg}; the "
                      f"same bits twice; {len(plan_b.items)} items, "
                      f"{plan_b.nsplit} splits; lossy {tb[0]:.4f}, "
                      f"{tb[1]:.4f} ms, fp32 {t32[0]:.4f}, {t32[1]:.4f} ms "
                      f"in turns; bound {b_ms:.4f} ms (fp32 build "
                      f"{floors['fp32']:.4f}, MUFU {floors['mufu']:.4f}, "
                      f"3 TF32 products {floors['tensor']:.4f}), "
                      f"{b_ms / min(tb):.3f} of it, on {smi}")
                rows[(subset, nf)] = (err * max(float(x.abs().max())
                                                for x in f64),
                                      min(tb), plain_ms, b_ms)
            del refs
        return rows

    # K7b's limits against float64 and its plain lossy version, of max|f|,
    # set between the sound kernel's readings and two controls (the plain
    # sweep with one TF32 pass, and with split3 less its small x big
    # product), which must read above them: at m <= 8 5e-6 (K7b 2.9e-6 at
    # most; the controls 9.2e-6 and 1.8e-5 at m=8, where the fp32
    # instance's 3e-5 would pass both); at m = 32, where every target sums
    # 262,144 source nodes, 1e-4 (K7b 3.4e-5; the controls 2.8e-4, 4.6e-4)
    t14 = time.perf_counter()
    sr14 = init_random(n_main, SEED, device=dev)
    g14 = sr14.m * torch.tensor(G, dtype=torch.float32).item()
    c14, h14 = bounding_box(sr14.qx, sr14.qy, sr14.qz, g14 > 0)
    ge14 = heavy_split(sr14.qx, sr14.qy, sr14.qz, g14, 1, 100.0,
                       g14.sum() / (g14 > 0).sum())[4]
    w14 = fk.p2m_grid_fused(sr14.qx, sr14.qy, sr14.qz, ge14, c14, h14, m=8,
                            C=4)
    err7b, ms7b, plain7b, b7b = k7b_case(
        8, 4, w14, h14 / 4, SOFT, 10, 5e-6, controls=True,
        time_plain=True)[("expand", 3)]
    del sr14, w14
    # the 1M step's dense base (phase 9's plan: m=6, m^3 = 216 nodes, a
    # partial 256-node chunk and pad slots, at C = 2^Ld): its far sweep,
    # and expand at the same order
    m6, C6 = plan.m, 2 ** plan.dense_levels
    w6 = fk.p2m_grid_fused(*q9, ge9, c9, h9, m=m6, C=C6)
    k7b_case(m6, C6, w6, h9 / C6, soft9, 10, 5e-6,
             subsets=("expand", "far"))
    del w6
    order14 = fk.cell_order(*q9, c9, h9, 2)
    w32 = fk.p2m_grid_fused(*q9, ge9, c9, h9, m=32, C=2, order=order14)
    k7b_case(32, 2, w32, h9 / 2, soft9, 1, 1e-4, controls=True)
    del w32, order14
    torch.cuda.empty_cache()
    t14k = time.perf_counter() - t14

    # the sparse M2L's forms on the card against float64 (random expansions
    # of 2,000 random cells of a C=16 level at m=6): TF32 runs only here,
    # so this is where the lossy products' accumulation shows.  Limits from
    # the readings: 2e-6 of max|f| (4.5e-7 to 7.7e-7), and 5e-5 for the
    # fused lossy form, whose TF32 GEMMs sum K = 2 m^3 a step's offsets
    # (2.0e-5; its fp32 form 7.5e-7)
    rng = np.random.default_rng(SEED)
    codes = np.unique(rng.integers(0, 16 ** 3, 2000))
    cells_s = torch.full((len(codes) + 9,), sf._BIG, dtype=torch.int64)
    cells_s[:len(codes)] = torch.from_numpy(codes)
    cells_s = cells_s.to(dev)
    w_s = torch.from_numpy(rng.standard_normal(
        (len(cells_s) + 1, 6 ** 3)).astype(np.float32)).to(dev)
    hl_s = torch.tensor([0.2, 0.15, 0.25], device=dev)
    kw_s = dict(m=6, C=16, with_phi=True)
    ref_s = sf.m2l_sparse_level(w_s.double(), cells_s, hl_s.double(), 0.05,
                                **kw_s)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    for form in ({}, {"m2l_dots": "bf16x3"}, {"m2l_dots": "mixed"},
                 {"scan_chunk": 5}, {"fused": True},
                 {"fused": True, "m2l_dots": "bf16x3"}):
        got = sf.m2l_sparse_level(w_s, cells_s, hl_s, 0.05, **kw_s, **form)
        e_s = rel_max(got, ref_s)
        tol_s = 5e-5 if form == {"fused": True, "m2l_dots": "bf16x3"} \
            else 2e-6
        check(e_s <= tol_s, f"sparse M2L {form}: {e_s:.3e} of max|f| "
                            f"against float64 (tol {tol_s:g})")
        ms_s = time_ms(lambda: sf.m2l_sparse_level(
            w_s, cells_s, hl_s, 0.05, **kw_s, **form), reps=1, runs=3)
        check((torch.backends.cuda.matmul.allow_tf32,
               torch.get_float32_matmul_precision()) == flags,
              f"sparse M2L {form}: the TF32 flags changed")
        print(f"[14 sparse M2L {form or 'fp32'}] m=6 C=16 cap "
              f"{len(cells_s)}: max|df|/max|f| {e_s:.3e} against float64 "
              f"(tol {tol_s:g}); "
              f"{ms_s:.3f} ms; TF32 flags unchanged, on {smi}")
    del w_s, ref_s

    # the tiers through the CLI on the random box: the ladder validates
    # the tier, stepping it toward fp32 only on a miss (as murb_tpu does)
    k7b_launches = 0
    for tier in ("bf16x3", "mixed"):
        res14, counts = drive(lambda: cli.run([
            "-n", str(n_main), "-i", "50", "--im", "tpu+proxy", "-s",
            "random", "--nv", "--gf", "--scan", "--device", "cuda",
            "--m2l-dots", tier]))
        check(res14.rc == 0, f"cli --m2l-dots {tier} exit code {res14.rc}")
        e14 = res14.engine
        e14.assert_finite()
        check(e14.using_proxy and e14.levels >= 2,
              f"--m2l-dots {tier}: m={e14.m} levels={e14.levels}")
        check(e14.validated_err is not None and e14.validated_err <= TOL,
              f"--m2l-dots {tier}: validated error {e14.validated_err}")
        check(counts["K7b"] > 0, f"--m2l-dots {tier}: K7b launched no time")
        if tier == "bf16x3":
            k7b_launches = counts["K7b"]
        print(f"[14 cli] tpu+proxy -s random N={n_main} --m2l-dots {tier}: "
              f"(m, L)=({e14.m}, {e14.levels}) (fp32's {pick8}), tier "
              f"picked {e14.m2l_dots}, validated_err "
              f"{e14.validated_err:.3e}; {res14.fps:.2f} FPS over 49 steps "
              f"on {smi}; launches {counts}")
        del e14, res14

    # the 1M step under each tier on phase 9's state and plan (no engine
    # build): the max error on the 512-row strided sample against float64
    # and the ms of an acc_adaptive call, and of its sparse M2L (CUDA
    # events around every m2l_sparse_level call of the call)
    spans = []
    real_level = sf.m2l_sparse_level

    def timed_level(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_level(*a, **k)
        ev[1].record()
        spans.append(ev)
        return out

    tiers14 = {"fp32": (plan, "fp32", "0"), "bf16x3": (plan, "bf16x3", "0"),
               "mixed": (plan, "mixed", "0"),
               "m2l_rank=128": (plan._replace(m2l_rank=128), "fp32", "0"),
               "bf16x3 MURB_M2L_FUSED=1": (plan, "bf16x3", "1")}
    env_fused = os.environ.get("MURB_M2L_FUSED")
    for label, (p14, dots, fused) in tiers14.items():
        def acc14(a, b, cc, g):
            os.environ["MURB_M2L_FUSED"] = fused
            try:
                return sf.acc_adaptive(a, b, cc, g, soft9, p14,
                                       m2l_dots=dots)
            finally:
                if env_fused is None:
                    os.environ.pop("MURB_M2L_FUSED")
                else:
                    os.environ["MURB_M2L_FUSED"] = env_fused

        t1 = time.perf_counter()
        err14 = measured_force_error(*q9, g9, soft9, acc14)
        t_first = time.perf_counter() - t1
        call_ms = time_ms(lambda: acc14(*q9, g9), reps=2, runs=3)
        sf.m2l_sparse_level = timed_level
        try:
            spans.clear()
            acc14(*q9, g9)
            torch.cuda.synchronize()
            m2l_ms = sum(a.elapsed_time(b) for a, b in spans)
        finally:
            sf.m2l_sparse_level = real_level
        check(err14 <= TOL, f"1M {label}: error {err14:.3e} (tol {TOL:g})")
        ranks = [sf._resolve_rank(p14, cap) for cap in p14.cell_caps]
        print(f"[14 1M {label}] acc_adaptive m={p14.m} L={p14.levels} "
              f"(ranks by level {ranks}): max error on the 512-row sample "
              f"{err14:.3e}; {call_ms:.3f} ms a call, its sparse M2L "
              f"{m2l_ms:.3f} ms over {len(spans)} levels (first call and "
              f"its check {t_first:.1f} s) on {smi}")
    print(f"[14 time] K7b checks {t14k:.1f} s, the phase "
          f"{time.perf_counter() - t14:.1f} s")
    record = {"max_abs_err": err7b, "ms": ms7b, "plain_ms": plain7b,
              "bound_ms": b7b, "bound_by": "operations", "library_ms": None}
    return record, k7b_launches


def phase15(dev, smi, drive, time_ms, within_rel, norm_rel, keep, n_main,
            fp32_bytes):
    """15. the bf16 state: each bf16 instance (K1, K2, K3, K4's passes 1, 2
    and 3, K8, K9) bit for bit its fp32 instance on the arrays upcast (K3
    and K4 at 16384^2 also at the split of their own resident count, as
    their wrappers launch them), held to its
    plain version and to float64, and timed in turns with the fp32
    instance; ``tpu+proxy --precision bf16`` on the 200k galaxy and
    ``tpu+tile`` / ``tpu+hybrid`` (+fast, +x3) at 200,192 bodies through
    the CLI, each launching its bf16 instance; and the card's power
    through scripts/torch_measure_energy.py around the 200k proxy run at
    fp32 and at bf16.  Records each bf16 instance through ``keep`` and
    returns their launch counts on the main path."""
    import contextlib
    import io

    import torch

    from murb_tpu_torch import G, cli
    from murb_tpu_torch.core.init import init_galaxy, init_random
    from murb_tpu_torch.core.state import in_dtype
    from murb_tpu_torch.ops import cuda
    from murb_tpu_torch.ops import fmm_kernels as fk
    from murb_tpu_torch.ops import proxy_kernels as tk
    from murb_tpu_torch.ops.hybrid import (acc_hybrid_rect,
                                           acc_hybrid_rect_plain,
                                           ext_split_args, fast_packed,
                                           fast_split_args)
    from murb_tpu_torch.ops.proxy import bounding_box, heavy_split
    from murb_tpu_torch.ops.tile import (acc_tile_rect, acc_tile_rect_plain,
                                         split_args)
    from murb_tpu_torch.utils.profile_step import graph_ms

    bf16 = torch.bfloat16
    t_phase = time.perf_counter()
    launches = {}

    turns = functools.partial(in_turns, time_ms)

    # ---- K3 and K4: the same bits as the fp32 instance at 200,192^2 (the
    # main path's tpu+tile and tpu+hybrid), the j split of the fp32
    # instance given to both
    st = init_galaxy(n_main, SEED, dtype=bf16, device=dev)
    q16 = (st.qx, st.qy, st.qz, st.m * in_dtype(G, bf16))
    q32 = tuple(v.float() for v in q16)

    def sweep(entry, q, split, *passes):
        n = q[0].shape[0]
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        cuda.launch(entry, *(v.data_ptr() for v in q[:3]), n,
                    *(v.data_ptr() for v in q), n, ctypes.c_float(SOFT ** 2),
                    *passes, 0, 0, *split, *(o.data_ptr() for o in out),
                    cuda.stream(dev))
        return out

    def fast_sweep(entry, q, split):
        """K4's passes 1 through its C entry (no launch counted), which
        forms the sources' centre itself."""
        n = q[0].shape[0]
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        center = torch.empty(3, dtype=torch.float32, device=dev)
        packed = fast_packed(n, dev)
        cuda.launch(entry, *(v.data_ptr() for v in q[:3]), n,
                    *(v.data_ptr() for v in q), n, center.data_ptr(),
                    ctypes.c_float(SOFT ** 2), 0, 0, *split,
                    packed.data_ptr(), *(o.data_ptr() for o in out),
                    cuda.stream(dev))
        return out

    n = st.npad
    split, _sc = split_args(n, n, 0, 0, dev)
    esplit, _esc = ext_split_args(n, n, 0, 0, dev)
    fsplit, _fsc = fast_split_args(n, n, 0, 0, dev)
    same = {"K3": torch.equal(sweep("murb_tile_rect", q32, split),
                              sweep("murb_tile_rect_bf16", q16, split)),
            "K4 p1": torch.equal(fast_sweep("murb_hybrid_fast", q32, fsplit),
                                 fast_sweep("murb_hybrid_fast_bf16", q16,
                                            fsplit))}
    for p in (2, 3):
        sp = esplit if p == 3 else split
        same[f"K4 p{p}"] = torch.equal(
            sweep("murb_hybrid_rect", q32, sp, p),
            sweep("murb_hybrid_rect_bf16", q16, sp, p))
    check(all(same.values()), f"bf16 instances vs fp32 at {n}^2: {same}")
    k3_32, k3_16 = turns(lambda: acc_tile_rect(*q32[:3], *q32, SOFT),
                         lambda: acc_tile_rect(*q16[:3], *q16, SOFT),
                         reps=3, runs=3)
    res = {e: cuda.resident(e, dev) for e in (
        "murb_tile_resident", "murb_tile_resident_bf16",
        "murb_hybrid_resident", "murb_hybrid_resident_bf16")}
    print(f"[15 bits] {n}^2: K3 (j split {split[:2]}) and K4 passes 1 "
          f"(split {fsplit[:2]}), 2 (K3's split), 3 (split {esplit[:2]}): "
          f"the bf16 instances give "
          f"the fp32 instances' bits on the arrays upcast; resident blocks "
          f"an SM {res}; K3 in turns through the wrapper: bf16 "
          f"{k3_16:.4f} ms, fp32 {k3_32:.4f} ms on {smi}")
    del _sc, _esc, _fsc

    # ---- at the rows' shape, 16384^2: against the plain version (bf16 out
    # on both sides: WithinRel 1e-2, rms floor 1e-4) and float64 (the fp32
    # instance's contracts: K3 WithinRel 5e-6, K4 p1 5.1e-3, p2 3e-5, p3
    # 4e-7)
    sr = init_random(16_300, SEED, dtype=bf16, device=dev)
    j16 = (sr.qx, sr.qy, sr.qz, sr.m * in_dtype(G, bf16))
    j32 = tuple(v.float() for v in j16)
    j64 = tuple(v.double() for v in j16)
    ns = sr.npad
    ref64 = acc_tile_rect_plain(*j64[:3], *j64, SOFT)
    sms = cuda.sm_count(dev)
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    # the j split each wrapper takes: its own instance's resident count
    # (the bf16 instances hold other register counts, so their splits may
    # differ from the fp32 ones')
    def splits(tier, sfx):
        if tier == "p1":
            return fast_split_args(ns, ns, 0, 0, dev,
                                   "murb_hybrid_fast_resident" + sfx)
        if tier != "p3":
            return split_args(ns, ns, 0, 0, dev, "murb_tile_resident" + sfx)
        return ext_split_args(ns, ns, 0, 0, dev,
                              "murb_hybrid_resident" + sfx)

    def raw_sweep(tier, entry, q, sp, extra):
        """A tier's own fp32 sums through its C entry at split ``sp``."""
        if tier == "p1":
            return fast_sweep(entry, q, sp)
        return sweep(entry, q, sp, *extra)

    # each instance alone (its launches in a CUDA graph: no output rounding
    # to bf16, no wrapper) at its own split, in turns
    sq16, sq32 = tuple(v.contiguous() for v in j16), j32
    alone = {}
    for tier, entry, extra in (("K3", "murb_tile_rect", ()),
                               ("p3", "murb_hybrid_rect", (3,))):
        sp = {sfx: splits(tier, sfx) for sfx in ("", "_bf16")}
        alone[tier] = [graph_ms(lambda: sweep(entry + sfx, q, sp[sfx][0],
                                              *extra))
                       for sfx, q in (("", sq32), ("_bf16", sq16),
                                      ("_bf16", sq16), ("", sq32))]
        del sp
    for tier, contract in (("K3", None), ("p1", 5.1e-3), ("p2", 3e-5),
                           ("p3", 4e-7)):
        if tier == "K3":
            entry, extra = "murb_tile_rect", ()
            run16 = lambda: acc_tile_rect(*j16[:3], *j16, SOFT)
            run32 = lambda: acc_tile_rect(*j32[:3], *j32, SOFT)
            plain = lambda: acc_tile_rect_plain(*j16[:3], *j16, SOFT)
        else:
            p = int(tier[1])
            entry, extra = ("murb_hybrid_fast", ()) if p == 1 else (
                "murb_hybrid_rect", (p,))
            run16 = lambda: acc_hybrid_rect(*j16[:3], *j16, SOFT, passes=p)
            run32 = lambda: acc_hybrid_rect(*j32[:3], *j32, SOFT, passes=p)
            plain = lambda: acc_hybrid_rect_plain(*j16[:3], *j16, SOFT,
                                                  passes=p)
        got = run16()
        check(got.ax.dtype == bf16, f"bf16 {tier}: outputs {got.ax.dtype}")
        # the bf16 instance's own fp32 sums at the split its wrapper takes:
        # the wrapper's outputs are these rounded, and the fp32 instance
        # gives the same bits at that split on the arrays upcast
        sp16, sc16 = splits(tier, "_bf16")
        raw = raw_sweep(tier, entry + "_bf16", sq16, sp16, extra)
        check(all(torch.equal(g, r.to(bf16)) for g, r in zip(got, raw)),
              f"bf16 {tier}: the wrapper's outputs are not the bf16 "
              f"instance's sums at split {sp16[:2]} rounded")
        check(torch.equal(raw, raw_sweep(tier, entry, sq32, sp16, extra)),
              f"bf16 {tier}: not the fp32 instance's bits at split "
              f"{sp16[:2]}")
        del sc16
        wp = within_rel(got, plain(), 1e-2, 1e-4)
        check(wp <= 1.0, f"bf16 {tier} vs its plain version: {wp:.2f}x of "
                         f"WithinRel 1e-2 (rms floor 1e-4)")
        err = max(float((g.double() - r).abs().max())
                  for g, r in zip(raw, ref64))
        if contract is None:
            w64 = within_rel(raw, ref64, 5e-6, 5e-6)
            check(w64 <= 1.0, f"bf16 K3 vs float64: {w64:.2f}x of 5e-6")
            held = f"WithinRel 5e-6 at {w64:.3f}"
        else:
            rel = norm_rel(raw, ref64)
            check(rel <= contract, f"bf16 K4 {tier} vs float64: {rel:.3e} "
                                   f"> {contract:g}")
            held = f"max rel {rel:.3e} (contract {contract:g})"
        ms32, ms16 = turns(run32, run16)
        plain_ms = time_ms(plain, reps=3)
        # bf16 in: 2 bytes a value (targets 3, sources 4), fp32 out
        nbytes, flops = 6 * ns + 8 * ns + 12 * ns, 20 * ns * ns
        floors = (ext_bound_ms(ns, ns, sms, clk) if tier == "p3" else
                  fast_bound_ms(ns, ns, sms, clk) if tier == "p1" else None)
        line = (f"[15 bf16 {tier} {ns}^2] the bf16 instance's fp32 sums at "
                f"its split {sp16[:2]}: the fp32 instance's bits there, the "
                f"wrapper's outputs rounded; vs plain at {wp:.3f} of "
                f"WithinRel 1e-2; vs float64 {held}, max|da| {err:.3e}; in "
                f"turns: bf16 {ms16:.4f} ms, fp32 {ms32:.4f} ms; plain "
                f"{plain_ms:.4f} ms")
        if tier in ("K3", "p3"):
            line += ("; alone (each at its own split) fp32, bf16, bf16, "
                     "fp32: " + ", ".join(f"{a:.4f}" for a in alone[tier]))
        if tier != "p2":
            key = {"K3": "K3-bf16", "p1": "K4-p1-bf16", "p3": "K4-bf16"}[tier]
            b_ms = keep(key, err, ms16, plain_ms, nbytes, flops,
                        None if floors is None else max(
                            v for k, v in floors.items() if k != "fp32"))
            line += f"; bound {b_ms:.4f} ms"
        print(line)

    # ---- K1 and K2 on the 200k bf16 galaxy at m=12 (K2: k=3)
    gm = q16[3]
    c, h = bounding_box(st.qx, st.qy, st.qz, gm > 0)
    mean_gm = gm.sum() / (gm > 0).sum()
    gm_eff = heavy_split(st.qx, st.qy, st.qz, gm, 1, 100.0, mean_gm)[4]
    box = torch.cat([c.reshape(3), h.reshape(3)]).float()
    b16 = (st.qx, st.qy, st.qz, gm_eff)
    b32 = tuple(v.float() for v in b16)
    b64 = tuple(v.double() for v in b16)
    m = 12
    w16 = tk.p2m_launch(*b16, box, m)
    check(torch.equal(w16, tk.p2m_launch(*b32, box, m)),
          "bf16 K1: not the fp32 instance's bits")
    w = tk.p2m_fused(*b16, c, h, m=m)
    check(w.dtype == torch.float32 and torch.equal(w, w16),
          f"bf16 K1 wrapper: {w.dtype}")
    w64 = tk.p2m_plain(*b64, c.double(), h.double(), m=m)
    err_w = float((w.double() - w64).abs().max())
    scale_w = float(w64.abs().max())
    check(bool(torch.allclose(w.double(), w64, rtol=1e-4,
                              atol=1e-6 * scale_w)),
          f"bf16 K1 vs float64: max|dW| {err_w:.3e}")
    wp = float((w - tk.p2m_plain(*b16, c, h, m=m)).abs().max()) / scale_w
    check(wp <= 1e-4, f"bf16 K1 vs its plain version: {wp:.3e} of max|W|")
    ms32, ms16 = turns(lambda: tk.p2m_fused(*b32, c, h, m=m),
                       lambda: tk.p2m_fused(*b16, c, h, m=m))
    alone = [graph_ms(lambda: tk.p2m_launch(*b, box, m))
             for b in (b32, b16, b16, b32)]
    plain_ms = time_ms(lambda: tk.p2m_plain(*b16, c, h, m=m))
    b_ms = keep("K1-bf16", err_w, ms16, plain_ms, 8 * n_main + 4 * m ** 3,
                n_main * (2 * m ** 3 + 6 * m ** 2))
    print(f"[15 bf16 K1 m={m} N={n_main}] the fp32 instance's bits; "
          f"W float32; vs float64 max|dW| {err_w:.3e} (rtol 1e-4 + 1e-6 "
          f"max|W|), vs plain {wp:.3e} of max|W|; in turns: bf16 {ms16:.4f}"
          f" ms, fp32 {ms32:.4f} ms through the wrapper, alone (a CUDA "
          f"graph) fp32, bf16, bf16, fp32: "
          f"{', '.join(f'{a:.4f}' for a in alone)}; plain {plain_ms:.4f} "
          f"ms; bound {b_ms:.4f} ms")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fields = tuple(torch.randn(m ** 3, generator=gen, device=dev)
                   for _ in range(3))
    o16 = tk.l2p_launch(st.qx, st.qy, st.qz, box, m, fields)
    check(torch.equal(o16, tk.l2p_launch(*b32[:3], box, m, fields)),
          "bf16 K2: not the fp32 instance's bits")
    got = tk.l2p_fused_multi(st.qx, st.qy, st.qz, c, h, fields, m=m)
    check(got[0].dtype == bf16, f"bf16 K2 wrapper: {got[0].dtype}")
    ref = tk.l2p_plain(*b64[:3], c.double(), h.double(),
                       tuple(f.double() for f in fields), m=m)
    err_a = max(float((a.double() - r).abs().max())
                for a, r in zip(o16, ref))
    w64 = within_rel(list(o16), ref, 1e-4, 1e-5)
    check(w64 <= 1.0, f"bf16 K2 vs float64: {w64:.2f}x of WithinRel 1e-4")
    wp = within_rel(got, tk.l2p_plain(st.qx, st.qy, st.qz, c, h, fields,
                                      m=m), 1e-2, 1e-4)
    check(wp <= 1.0, f"bf16 K2 vs its plain version: {wp:.2f}x")
    ms32, ms16 = turns(
        lambda: tk.l2p_fused_multi(*b32[:3], c, h, fields, m=m),
        lambda: tk.l2p_fused_multi(st.qx, st.qy, st.qz, c, h, fields, m=m))
    alone = [graph_ms(lambda: tk.l2p_launch(*b[:3], box, m, fields))
             for b in (b32, b16, b16, b32)]
    plain_ms = time_ms(lambda: tk.l2p_plain(st.qx, st.qy, st.qz, c, h,
                                            fields, m=m))
    # K2's model (phase 3) with the coordinates in at 2 bytes a value
    b_ms = keep("K2-bf16", err_a, ms16, plain_ms,
                6 * n_main + 4 * 3 * (m ** 3 + n_main),
                n_main * (2 * 3 * m ** 3 + 6 * m ** 2))
    print(f"[15 bf16 K2 m={m} k=3 N={n_main}] the fp32 instance's bits; "
          f"vs float64 at {w64:.3f} of WithinRel 1e-4 (max|da| {err_a:.3e}),"
          f" vs plain at {wp:.3f} of WithinRel 1e-2; in turns: bf16 "
          f"{ms16:.4f} ms, fp32 {ms32:.4f} ms through the wrapper, alone "
          f"fp32, bf16, bf16, fp32: {', '.join(f'{a:.4f}' for a in alone)};"
          f" plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms")

    # ---- K8 and K9 on the 200k bf16 galaxy at the hierarchy's finest level
    # of the main path's (m, levels) = (4, 2): C = 4; the box in float32 on
    # both sides, so the cells are the same
    m8, C = 4, 4
    c32, h32 = c.float(), h.float()
    order = fk.cell_order(*b32[:3], c32, h32, C)
    items8 = fk.p2m_grid_items(order, m8)
    w16 = fk.p2m_grid_launch(*b16, order, items8, m8)
    check(torch.equal(w16, fk.p2m_grid_launch(*b32, order, items8, m8)),
          "bf16 K8: not the fp32 instance's bits")
    w = fk.p2m_grid_fused(*b16, c32, h32, m=m8, C=C, order=order)
    check(w.dtype == torch.float32 and torch.equal(w, w16),
          f"bf16 K8 wrapper: {w.dtype}")
    w64 = fk.p2m_grid_plain(*b64, c.double(), h.double(), m=m8, C=C)
    err8 = float((w.double() - w64).abs().max())
    rel8 = err8 / float(w64.abs().max())
    check(rel8 <= 1e-5, f"bf16 K8 vs float64: {rel8:.3e} of max|W|")
    wp = float((w - fk.p2m_grid_plain(*b16, c32, h32, m=m8, C=C)).abs()
               .max()) / float(w64.abs().max())
    check(wp <= 1e-5, f"bf16 K8 vs its plain version: {wp:.3e} of max|W|")
    ms32, ms16 = turns(
        lambda: fk.p2m_grid_fused(*b32, c32, h32, m=m8, C=C, order=order),
        lambda: fk.p2m_grid_fused(*b16, c32, h32, m=m8, C=C, order=order))
    alone = [graph_ms(lambda: fk.p2m_grid_launch(*b, order, items8, m8))
             for b in (b32, b16, b16, b32)]
    plain_ms = time_ms(lambda: fk.p2m_grid_plain(*b16, c32, h32, m=m8, C=C),
                       reps=3)
    # phase 8's model with q and gm in at 2 bytes a value
    b_ms = keep("K8-bf16", err8, ms16, plain_ms,
                16 * n_main + 4 * C ** 3 * m8 ** 3,
                n_main * (2 * m8 ** 3 + 6 * m8 ** 2))
    print(f"[15 bf16 K8 m={m8} C={C} N={n_main}] the fp32 instance's bits; "
          f"W float32; vs float64 {rel8:.3e} of max|W| (tol 1e-5), vs "
          f"plain {wp:.3e}; in turns: bf16 {ms16:.4f} ms, fp32 {ms32:.4f} "
          f"ms through the wrapper (prebuilt order), alone fp32, bf16, "
          f"bf16, fp32: {', '.join(f'{a:.4f}' for a in alone)}; plain "
          f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms")
    fields8 = tuple(torch.randn((C ** 3, m8 ** 3), generator=gen, device=dev)
                    for _ in range(3))
    items9 = fk.l2p_grid_items(order, m8)
    o16 = fk.l2p_grid_launch(*b16[:3], order, items9, m8, fields8)
    check(torch.equal(o16, fk.l2p_grid_launch(*b32[:3], order, items9, m8,
                                              fields8)),
          "bf16 K9: not the fp32 instance's bits")
    got = fk.l2p_grid_fused(*b16[:3], c32, h32, fields8, m=m8, C=C,
                            order=order)
    check(got[0].dtype == bf16 and all(
        torch.equal(g, o.to(bf16)) for g, o in zip(got, o16)),
        f"bf16 K9 wrapper: {got[0].dtype}")
    ref = fk.l2p_grid_plain(*b64[:3], c.double(), h.double(),
                            tuple(f.double() for f in fields8), m=m8, C=C)
    err9 = max(float((a.double() - r).abs().max()) for a, r in zip(o16, ref))
    rel9 = err9 / max(float(r.abs().max()) for r in ref)
    check(rel9 <= 1e-4, f"bf16 K9 vs float64: {rel9:.3e} of max|a|")
    wp = within_rel(got, fk.l2p_grid_plain(*b16[:3], c32, h32, fields8,
                                           m=m8, C=C), 1e-2, 1e-3)
    check(wp <= 1.0, f"bf16 K9 vs its plain version: {wp:.2f}x")
    ms32, ms16 = turns(
        lambda: fk.l2p_grid_fused(*b32[:3], c32, h32, fields8, m=m8, C=C,
                                  order=order),
        lambda: fk.l2p_grid_fused(*b16[:3], c32, h32, fields8, m=m8, C=C,
                                  order=order))
    alone = [graph_ms(lambda: fk.l2p_grid_launch(*b[:3], order, items9, m8,
                                                 fields8))
             for b in (b32, b16, b16, b32)]
    plain_ms = time_ms(lambda: fk.l2p_grid_plain(*b16[:3], c32, h32,
                                                 fields8, m=m8, C=C), reps=3)
    b_ms = keep("K9-bf16", err9, ms16, plain_ms,
                14 * n_main + 4 * 3 * (n_main + C ** 3 * m8 ** 3),
                n_main * (2 * 3 * m8 ** 3 + 6 * m8 ** 2))
    print(f"[15 bf16 K9 m={m8} C={C} k=3 N={n_main}] the fp32 instance's "
          f"bits; vs float64 {rel9:.3e} of max|a| (tol 1e-4), vs plain at "
          f"{wp:.3f} of WithinRel 1e-2 (rms floor 1e-3); in turns: bf16 "
          f"{ms16:.4f} ms, fp32 {ms32:.4f} ms through the wrapper, alone "
          f"fp32, bf16, bf16, fp32: {', '.join(f'{a:.4f}' for a in alone)};"
          f" plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms")
    del st, q16, q32, sr, j16, j32, j64, ref64, b16, b32, b64, w64, ref
    torch.cuda.empty_cache()

    # ---- the main path through the CLI, launch counts read after each run
    def cli_run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = cli.run(argv)
        out = buf.getvalue()
        check(res.rc == 0, f"cli {argv}: exit code {res.rc}\n{out[-2000:]}")
        res.engine.assert_finite()
        return res, out

    (res, out), counts = drive(lambda: cli_run([
        "-n", str(n_main), "-i", "100", "--im", "tpu+proxy", "--precision",
        "bf16", "--nv", "--gf", "--scan", "--device", "cuda"]))
    e = res.engine
    check(e.bodies.dtype == bf16, f"tpu+proxy bf16 state {e.bodies.dtype}")
    check(2 * e.allocated_bytes == fp32_bytes,
          f"bf16 bytes {e.allocated_bytes} vs fp32 {fp32_bytes}")
    # the ladder tries single-level and hierarchy rungs (no rung meets the
    # tolerance in bf16), so each of the four launches; the rung it keeps
    # launches its pair every step
    for k in ("K1-bf16", "K2-bf16", "K8-bf16", "K9-bf16"):
        check(counts[k] > 0, f"{k} launched no time: {counts}")
        launches[k] = counts[k]
    step_pair = ("K8-bf16", "K9-bf16") if e.levels else ("K1-bf16",
                                                         "K2-bf16")
    check(all(counts[k] >= 99 for k in step_pair),
          f"the kept rung ({e.m}, {e.levels}, {e.cells}) did not launch "
          f"{step_pair} every step: {counts}")
    for line in out.splitlines():
        if line.startswith(("WARNING", "  -> mem.", "  -> validated")):
            print(f"[15 main] {line.strip()}")
    print(f"[15 main] tpu+proxy --precision bf16 N={n_main} galaxy: (m, "
          f"levels, cells) = ({e.m}, {e.levels}, {e.cells}), validated err "
          f"{e.validated_err:.3e}; {res.fps:.2f} FPS ({res.elapsed_ms:.2f} "
          f"ms for 99 steps); {e.allocated_bytes} bytes, half the fp32 "
          f"run's {fp32_bytes}; launches {counts} on {smi}")
    for tag, key in (("tpu+tile", "K3-bf16"), ("tpu+hybrid", "K4-bf16"),
                     ("tpu+hybrid+fast", "K4-p1-bf16"),
                     ("tpu+hybrid+x3", "K4-bf16")):
        (res, _), counts = drive(lambda: cli_run([
            "-n", "200192", "-i", "4", "--im", tag, "--precision", "bf16",
            "--nv", "--gf", "--scan", "--device", "cuda"]))
        check(counts[key] > 0, f"{key} launched no time under {tag}: "
                               f"{counts}")
        launches[key] = launches.get(key, 0) + counts[key]
        print(f"[15 {tag}] --precision bf16 N=200192 (passes "
              f"{getattr(res.engine, 'passes', '-')}): {res.fps:.3f} FPS "
              f"over 3 steps after one; launches {counts}")

    # ---- the card's power around the 200k proxy run, fp32 and bf16
    for prec in ("fp32", "bf16"):
        csv = os.path.join(ROOT, "build", f"power_{prec}.csv")
        os.makedirs(os.path.dirname(csv), exist_ok=True)
        p = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts",
                                          "torch_measure_energy.py"),
             "--source", "nvsmi", "--interval", "0.1", "--out", csv, "--",
             "-n", str(n_main), "-i", "1000", "--im", "tpu+proxy",
             "--precision", prec, "--nv", "--scan"],
            capture_output=True, text=True, cwd=ROOT, timeout=300)
        check(p.returncode == 0, f"energy {prec}: rc {p.returncode}\n"
                                 f"{p.stderr[-2000:]}")
        loop = [l for l in p.stdout.splitlines() if l.startswith("loop all")]
        check(len(loop) == 1, f"energy {prec}: no loop window\n{p.stdout}")
        order = [l.strip() for l in p.stdout.splitlines()
                 if l.startswith("  -> validated") or
                 l.startswith("Entire")]
        print(f"[15 energy {prec}] tpu+proxy N={n_main} -i 1000 --scan: "
              f"{loop[0]}; {'; '.join(order)}; on {smi}")
    print(f"[15 time] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase15_adaptive(dev, smi, drive, time_ms, keep, rel_max,
                     near_body_pairs, e9, st9, soft9, dt9, tab):
    """15 (continued). The 1M two-cluster box (phase 9's, bench.py:442-460)
    in bf16 through ``create_engine`` (auto policy; no rung meets 1e-4 in
    bf16, so the adaptive ladder keeps its best order with a warning): the
    plan it adopts and its validated error, the bf16 instances of K10, K11
    and K12 launched on its path and the fp32 ones not, and ms a step in
    turns with phase 9's fp32 engine; on that state's own sorted bodies and
    plan, each of the three bit for bit its fp32 instance on the arrays
    upcast, held to phase 9's contracts (K10 3e-5 of the largest magnitude
    against float64; K11 and K12 1e-4 against their plain versions on the
    same fp32 values, their distance from float64 printed) and timed in
    turns with the fp32
    instance beside its bound; and the merger (81,920 bodies,
    bench.py:515-547) through the CLI with ``tpu+tracking+multi
    --precision bf16``: energy row 0 within 1e-3 of the float64 energy of
    the same bf16 state (tests/test_torch_bf16_cli.py's rule).  Records the
    three kernels through ``keep`` and returns their launch counts."""
    import contextlib
    import io

    import numpy as np
    import torch

    from murb_tpu_torch import cli
    from murb_tpu_torch.core import metrics as tm
    from murb_tpu_torch.core.init import (init_milkyway_andromeda,
                                          milkyway_andromeda_masks)
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.ops import anterp_kernels as ak
    from murb_tpu_torch.ops import cuda
    from murb_tpu_torch.ops import fmm_kernels as fk
    from murb_tpu_torch.ops import p2p as pp
    from murb_tpu_torch.ops import p2p_kernels as pk
    from murb_tpu_torch.ops import sparse_fmm as sf
    from murb_tpu_torch.ops.fmm import _heavy_setup
    from murb_tpu_torch.utils.profile_step import graph_ms

    bf16 = torch.bfloat16
    t_phase = time.perf_counter()
    launches = {}

    turns = functools.partial(in_turns, time_ms)

    # ---- the 1M box in bf16: plan, validation, 2 steps (the order the
    # ladder keeps sets the step's cost: every rung misses 1e-4 in bf16)
    st16 = st9.astype(bf16)

    def build_and_run():
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            e = create_engine("tpu+proxy", st16, soft=soft9, dt=dt9)
        t_build = time.perf_counter() - t1
        e.run(2)
        e.block_until_ready()
        return e, t_build, buf.getvalue()

    (e16, t_build, said), counts = drive(build_and_run)
    e16.assert_finite()
    check(e16.bodies.dtype == bf16 and e16.near_mode == "adaptive"
          and e16.using_proxy,
          f"the bf16 two-cluster box took near_mode={e16.near_mode} "
          f"using_proxy={e16.using_proxy}, state {e16.bodies.dtype}")
    for k in ("K10", "K11", "K12"):
        check(counts[f"{k}-bf16"] > 0 and counts[k] == 0,
              f"{k}: the bf16 run did not launch its bf16 instance alone: "
              f"{counts}")
        launches[f"{k}-bf16"] = counts[f"{k}-bf16"]
    plan = e16._plan

    def step_ms(e, n=1):
        e.block_until_ready()
        t1 = time.perf_counter()
        e.run(n)
        e.block_until_ready()
        return (time.perf_counter() - t1) / n * 1e3

    t_steps = [step_ms(e) for e in (e9, e16, e16, e9)]
    for line in said.splitlines():
        if line.startswith(("WARNING", "adaptive")):
            print(f"[15 adaptive] {line.strip()}")
    print(f"[15 adaptive] tpu+proxy --precision bf16 N={st16.n} two "
          f"clusters (engine with plan and validation in {t_build:.1f} s): "
          f"near_mode={e16.near_mode} m={plan.m} dense levels="
          f"{plan.dense_levels} levels={plan.levels} cell caps "
          f"{plan.cell_caps} pmax {plan.p2p_pmax}, validated_err "
          f"{e16.validated_err:.3e} (fp32: m={e9._plan.m}, "
          f"{e9.validated_err:.3e}); {st16.allocated_bytes} bytes against "
          f"{st9.allocated_bytes}; ms a step in turns fp32, bf16, bf16, "
          f"fp32: " + ", ".join(f"{t:.2f}" for t in t_steps)
          + f"; launches {counts} on {smi}")

    # ---- K10, K11 and K12 on the bf16 state's own sorted bodies, cells
    # and plan (the cells and the kernels' box from the bf16 box upcast,
    # ops/fmm_kernels.cell_box)
    q16 = (st16.qx, st16.qy, st16.qz)
    c, h, *_rest, ge = _heavy_setup(*q16, e16._gm(st16), 1, sf.HEAVY_FACTOR)
    h = h.max().expand(3)
    C = 2 ** plan.levels
    key, ci = pp.sorted_cells(*q16, ge > 0, c, h, C)
    key, perm = torch.sort(key, stable=True)
    b16 = tuple(v[perm] for v in (*q16, ge))
    b32 = tuple(v.float() for v in b16)
    b64 = tuple(v.double() for v in b16)
    ci = tuple(v[perm] for v in ci)
    cells32 = [v.to(torch.int32).contiguous() for v in ci]
    c32, h32 = c.float(), h.float()
    box = torch.cat(fk.cell_box(c, h, C)).to(torch.float32)
    n, B, m = st16.npad, st16.npad // pp.DEFAULT_K, plan.m
    sms = cuda.sm_count(dev)

    # K10 (nf 3): the raw fp32 sums of both instances
    soft2 = float(torch.tensor(soft9, dtype=torch.float32) ** 2)
    pmax = plan.p2p_pmax
    o16, np16 = pk.p2p_sorted_launch(*b16, cells32, soft2, pmax=pmax)
    o32, _ = pk.p2p_sorted_launch(*b32, cells32, soft2, pmax=pmax)
    check(torch.equal(o16, o32), "bf16 K10: not the fp32 instance's bits")
    ref, _ = pp.p2p_sweep_plain_sorted(*b64, ci, soft9, pmax=pmax,
                                       chunk=1024)
    ref = [r.reshape(-1) for r in ref]
    err10 = rel_max(list(o16), ref)
    check(err10 <= 3e-5, f"bf16 K10: {err10:.3e} of max|a| against float64")
    ms32, ms16 = turns(
        lambda: pk.p2p_sweep_kernel_sorted(*b32, ci, soft9, pmax=pmax),
        lambda: pk.p2p_sweep_kernel_sorted(*b16, ci, soft9, pmax=pmax),
        reps=3, runs=3)
    plain_ms = time_ms(lambda: pp.p2p_sweep_plain_sorted(
        *b16, ci, soft9, pmax=pmax, chunk=1024), reps=1, runs=1)
    near, _swept, _cls = near_body_pairs(ci, pmax, C)
    # phase 9's model with the body rows in at 8 bytes
    nbytes, flops = 20 * n + B * B + 8 * B + 12 * n, 20 * near
    b_ms = keep("K10-bf16", err10 * max(float(r.abs().max()) for r in ref),
                ms16, plain_ms, nbytes, flops)
    print(f"[15 bf16 K10 N={n} B={B}] {int(np16)} brick pairs (pmax "
          f"{pmax}), {near} body pairs pass the mask; the fp32 instance's "
          f"bits; vs float64 {err10:.3e} of max|a| (tol 3e-5); in turns "
          f"through the wrapper: bf16 {ms16:.4f} ms, fp32 {ms32:.4f} ms; "
          f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms")
    del o16, o32, ref

    # K11: W of the finest slots
    cap = plan.cell_caps[-1]
    _, slots = sf._occupied_and_slots(key, cap)
    sl32 = slots.to(torch.int32)
    items = ak.window_items(sl32, cap, fk.p2m_chunk(n, m, sms))
    w16 = ak.p2m_window_launch(*b16, cells32, box, items, m)
    check(torch.equal(w16, ak.p2m_window_launch(*b32, cells32, box, items,
                                                m)),
          "bf16 K11: not the fp32 instance's bits")
    w64 = ak.p2m_window_plain(*b64, c.double(), h.double(), slots, cap, m=m,
                              C=C, ci=ci)
    err11 = rel_max([w16[:cap]], [w64[:cap]])
    # against float64 the in-cell coordinates' fp32 rounding (phase 9's
    # note) grows with the order: at m=12 it passes phase 9's 1e-4, so the
    # contract is held against the plain version on the same fp32 values
    pl11 = rel_max([w16[:cap]], [ak.p2m_window_plain(
        *b32, c32, h32, slots, cap, m=m, C=C, ci=ci)[:cap]])
    check(pl11 <= 1e-4, f"bf16 K11 m={m}: {pl11:.3e} of max|W| against its "
                        f"plain version")
    wrap = lambda b: ak.p2m_window(*b, c32, h32, slots, cap, m=m, C=C,
                                   ci=ci)
    ms32, ms16 = turns(lambda: wrap(b32), lambda: wrap(b16))
    alone = [graph_ms(lambda: ak.p2m_window_launch(*b, cells32, box, items,
                                                   m))
             for b in (b32, b16, b16, b32)]
    plain_ms = time_ms(lambda: ak.p2m_window_plain(
        *b16, c32, h32, slots, cap, m=m, C=C, ci=ci), reps=1, runs=3)
    # phase 9's model with the four body values in at 2 bytes each
    nbytes = 24 * n + 4 * (cap + 1) * m ** 3
    flops = n * (2 * m ** 3 + 6 * m ** 2)
    b_ms = keep("K11-bf16", err11 * float(w64.abs().max()), ms16, plain_ms,
                nbytes, flops)
    print(f"[15 bf16 K11 N={n} m={m} C={C} cap={cap}] the fp32 instance's "
          f"bits; vs its plain version in fp32 {pl11:.3e} of max|W| (tol "
          f"1e-4), vs float64 {err11:.3e}; in turns: "
          f"bf16 {ms16:.4f} ms, fp32 {ms32:.4f} ms through the wrapper, "
          f"alone fp32, bf16, bf16, fp32: "
          f"{', '.join(f'{a:.4f}' for a in alone)}; plain {plain_ms:.4f} "
          f"ms; bound {b_ms:.4f} ms")

    # K12: three seeded fields of the finest slots (the dump row 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32 = [torch.randn((cap + 1, m ** 3), generator=gen, device=dev)
           for _ in range(3)]
    for f in f32:
        f[cap] = 0.0
    items12 = ak.window_items(sl32, cap, fk.l2p_item(m))
    o16 = ak.l2p_window_launch(*b16[:3], cells32, box, items12, m, f32)
    check(torch.equal(o16, ak.l2p_window_launch(*b32[:3], cells32, box,
                                                items12, m, f32)),
          "bf16 K12: not the fp32 instance's bits")
    a64 = ak.l2p_window_plain(*b64[:3], c.double(), h.double(), slots,
                              tuple(f.double() for f in f32), m=m, C=C,
                              ci=ci)
    err12 = rel_max(list(o16), a64)
    pl12 = rel_max(list(o16), ak.l2p_window_plain(
        *b32[:3], c32, h32, slots, f32, m=m, C=C, ci=ci))
    check(pl12 <= 1e-4, f"bf16 K12 m={m}: {pl12:.3e} of max|a| against its "
                        f"plain version")
    wrap = lambda b: ak.l2p_window(*b[:3], c32, h32, slots, f32, m=m, C=C,
                                   ci=ci)
    ms32, ms16 = turns(lambda: wrap(b32), lambda: wrap(b16))
    alone = [graph_ms(lambda: ak.l2p_window_launch(*b[:3], cells32, box,
                                                   items12, m, f32))
             for b in (b32, b16, b16, b32)]
    plain_ms = time_ms(lambda: ak.l2p_window_plain(
        *b16[:3], c32, h32, slots, f32, m=m, C=C, ci=ci), reps=1, runs=3)
    nbytes = 18 * n + 4 * 3 * ((cap + 1) * m ** 3 + n)
    flops = n * (2 * 3 * m ** 3 + 6 * m ** 2)
    b_ms = keep("K12-bf16", err12 * max(float(a.abs().max()) for a in a64),
                ms16, plain_ms, nbytes, flops)
    print(f"[15 bf16 K12 N={n} m={m} nf=3] the fp32 instance's bits; vs "
          f"its plain version in fp32 {pl12:.3e} of max|a| (tol 1e-4), vs "
          f"float64 {err12:.3e}; in turns: bf16 "
          f"{ms16:.4f} ms, fp32 {ms32:.4f} ms through the wrapper, alone "
          f"fp32, bf16, bf16, fp32: {', '.join(f'{a:.4f}' for a in alone)};"
          f" plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms")
    del e16, st16, b16, b32, b64, w16, w64, o16, a64, f32
    torch.cuda.empty_cache()

    # ---- the merger in bf16 through the CLI (K4 force, K5 metrics): row
    # 0's energy against the float64 energy of the same bf16 state, each
    # galaxy's own energy summed, the softening unrounded (K5 takes it so)
    mg16 = init_milkyway_andromeda(tab, dtype=bf16, device=dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res, counts = drive(lambda: cli.run([
            "-n", str(mg16.n), "-i", "10", "--im", "tpu+tracking+multi",
            "-s", "milkyway_andromeda", "--scheme-file", tab, "--precision",
            "bf16", "--nv", "--gf", "--device", "cuda"]))
    check(res.rc == 0, f"cli tpu+tracking+multi bf16 exit code {res.rc}\n"
                       f"{buf.getvalue()[-2000:]}")
    res.engine.assert_finite()
    check(res.engine.bodies.dtype == bf16, "the merger's state is not bf16")
    check(counts["K5-bf16"] > 0 and counts["K5"] == 0,
          f"the bf16 merger (CLI) did not launch K5-bf16 alone: {counts}")
    launches["K5-bf16"] = counts["K5-bf16"]
    hist = res.engine.finalize_history()   # the galaxies' series summed
    exact = 0.0
    for mask in milkyway_andromeda_masks(mg16.npad, mg16.n):
        sg = tm.masked(mg16, torch.as_tensor(mask, device=dev))
        q64 = [v.double() for v in (sg.qx, sg.qy, sg.qz, sg.m)]
        pe = tm.potential_energy_per_body(*q64, tm._gm(sg).double(), SOFT)
        ke = tm.kinetic_energy_per_body(sg.m, sg.vx, sg.vy, sg.vz)
        exact += float((0.5 * pe + 0.5 * ke).sum())
    e0 = float(hist.energies[0])
    rel = abs(e0 / exact - 1.0)
    check(bool(np.isfinite(hist.energies).all()) and rel <= 1e-3,
          f"bf16 merger energy row 0 {e0:.9e} vs float64 {exact:.9e}: rel "
          f"{rel:.3e} > 1e-3")
    print(f"[15 merger] tpu+tracking+multi --precision bf16 N={mg16.n} "
          f"through the CLI: energy row 0 {e0:.9e} vs float64 "
          f"{exact:.9e} (rel {rel:.3e}, tol 1e-3); {res.fps:.2f} FPS; "
          f"launches {counts} on {smi}")
    print(f"[15 time] phase 15's adaptive and merger runs took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def ptxas_report(pattern: str) -> dict:
    """{key: (registers, spill store bytes)} of the library's kernels
    whose mangled names match ``pattern`` (its groups form the key), from
    the build's compiler report (ops/cuda.build_kernels keeps it beside
    the library)."""
    from murb_tpu_torch.ops import cuda

    log = cuda.library_path().with_suffix(".log").read_text().splitlines()
    out = {}
    for i, line in enumerate(log):
        m = re.search(pattern, line)
        if not m or "Compiling entry function" not in line:
            continue
        near = " ".join(log[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", near)
        spill = re.search(r"(\d+) bytes spill stores", near)
        out[m.groups()] = (int(regs.group(1)) if regs else None,
                           int(spill.group(1)) if spill else None)
    return out


def phase15_sweeps(dev, smi, drive, time_ms, keep, within_rel, norm_rel,
                   tab, n_main):
    """15 (continued). The bf16 instances of K5 and K6 (the merger,
    81,920^2, R = 1, 2, 8), K14 (the 200k galaxy at D = 1 and 4 shards on
    the card, and an odd shard length) and K13 (200,192^2 at "high" and
    "default"): each bit for bit its fp32 instance on the arrays upcast at
    the split its wrapper launches (K14 at D = 1 also K3's bf16 instance),
    the wrapper's outputs its sums (rounded where the wrapper rounds),
    held to its plain version and to float64 at the fp32 instance's
    limits, and timed in turns with the fp32 instance alone (its C entry,
    prebuilt inputs) and through the wrapper; the registers and spills of
    each instance; then the paths: the merger through ``create_engine``
    (K6), ``shard+ring`` on 4 shards of the card and ``tpu+mxu
    --precision bf16`` through the CLI, each launching the bf16 instance
    and no fp32 one.  Records the four instances through ``keep`` and
    returns their launch counts (K5's from phase15_adaptive's merger CLI
    run)."""
    import numpy as np
    import torch

    from murb_tpu_torch import G, cli
    from murb_tpu_torch.core import metrics as tm
    from murb_tpu_torch.core.init import (init_galaxy,
                                          init_milkyway_andromeda,
                                          milkyway_andromeda_masks)
    from murb_tpu_torch.core.state import in_dtype
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.ops import cuda
    from murb_tpu_torch.ops import mxu as mxu_ops
    from murb_tpu_torch.ops import ring as ring_ops
    from murb_tpu_torch.ops.hybrid import (acc_phi_rows_hybrid,
                                           acc_phi_rows_plain, phi_rows_rect,
                                           phi_rows_rect_plain,
                                           phi_split_args)
    from murb_tpu_torch.ops.tile import acc_tile_rect, acc_tile_rect_plain
    from murb_tpu_torch.parallel.mesh import make_mesh, shard_state
    from murb_tpu_torch.utils.profile_step import graph_ms

    bf16 = torch.bfloat16
    t_phase = time.perf_counter()
    launches = {}
    turns = functools.partial(in_turns, time_ms)
    soft2 = ctypes.c_float(SOFT ** 2)
    sms = cuda.sm_count(dev)
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    regs = ptxas_report(r"sweep_rows_kernelILi256ELi256ELi([0-8])ELb([01])"
                        r"ELb0E(f|13__nv_bfloat16)E")
    regs13 = ptxas_report(r"mxu_mma_kernelILi512ELi512ELi([12])E"
                          r"(f|13__nv_bfloat16)E")
    kind = {"f": "fp32", "13__nv_bfloat16": "bf16"}

    # ---- K5 and K6 on the bf16 merger at R = 2, 1, 8 (phase 3's rows)
    mg = init_milkyway_andromeda(tab, dtype=bf16, device=dev)
    nm = mg.npad
    q16 = (mg.qx, mg.qy, mg.qz, mg.m * in_dtype(G, bf16))
    q32 = tuple(v.float() for v in q16)
    q64 = tuple(v.double() for v in q16)
    idx = torch.linspace(0, nm - 1, 4096, device=dev).long()
    qs64 = tuple(v[idx] for v in q64[:3])
    ref_acc = acc_tile_rect_plain(*qs64, *q64, SOFT)
    masks = [torch.as_tensor(mk, device=dev, dtype=bf16)
             for mk in milkyway_andromeda_masks(nm, mg.n)]
    mufu_ms = float(nm) * nm / (16 * sms * clk) * 1e3

    def merger_rows(nr):
        """phase 3's rows in bf16, as the engines form them (masks * G*m)."""
        if nr == 1:
            return q16[3][None, :].contiguous()
        out = [masks[0] * q16[3], masks[1] * q16[3]]
        if nr > 2:
            g8 = torch.Generator(device=dev).manual_seed(SEED)
            out.append(q16[3])
            out += [(torch.rand(nm, generator=g8, device=dev) < 0.5).to(bf16)
                    * q16[3] for _ in range(nr - 3)]
        return torch.stack(out[:nr]).contiguous()

    def phi_runner(force, b16, rows32, split):
        """K6 (force) or K5 through its C entry at ``split`` (no launch
        counted): a function returning its (3 + R or R, nm) fp32 sums."""
        q = q16 if b16 else q32
        nr = rows32.shape[0]
        out = torch.empty(((3 if force else 0) + nr, nm), dtype=torch.float32,
                          device=dev)
        sfx = "_bf16" if b16 else ""

        def run():
            if force:
                cuda.launch("murb_acc_phi_rows" + sfx,
                            *(v.data_ptr() for v in q), nm, rows32.data_ptr(),
                            nr, soft2, *split, out[0].data_ptr(),
                            out[1].data_ptr(), out[2].data_ptr(),
                            out[3:].data_ptr(), cuda.stream(dev))
            else:
                cuda.launch("murb_phi_rows_rect" + sfx,
                            *(v.data_ptr() for v in q[:3]), nm,
                            *(v.data_ptr() for v in q[:3]), nm,
                            rows32.data_ptr(), nr, soft2, *split,
                            out.data_ptr(), cuda.stream(dev))
            return out
        return run

    for r in (2, 1, 8):
        rows16 = merger_rows(r)
        rows32 = rows16.float()
        ref_phi = phi_rows_rect_plain(*qs64, *q64[:3], rows16.double(), SOFT)
        line = {}
        for force, key in ((False, "K5"), (True, "K6")):
            sp16, sc16 = phi_split_args(nm, nm, r, force, 0, 0, dev, True)
            sp32, sc32 = phi_split_args(nm, nm, r, force, 0, 0, dev)
            raw = phi_runner(force, True, rows32, sp16)().clone()
            check(torch.equal(raw, phi_runner(force, False, rows32, sp16)()),
                  f"{key}-bf16 R={r}: not the fp32 instance's bits at split "
                  f"{sp16[:4]}")
            phi_raw = raw[3:] if force else raw
            d = phi_raw[:, idx].double() - ref_phi
            prel = float((d.abs() / ref_phi.abs()).max())
            check(prel <= 1e-5, f"{key}-bf16 R={r}: max relative phi error "
                                f"{prel:.3e} > 1e-5 against float64")
            err = float(d.abs().max())
            if force:
                frel = norm_rel([a[idx] for a in raw[:3]], ref_acc)
                check(frel <= 3e-5, f"K6-bf16 R={r}: max relative force "
                                    f"error {frel:.3e} > 3e-5")
                err = max(float((a[idx].double() - b).abs().max())
                          for a, b in zip(raw[:3], ref_acc))
                acc, phi = acc_phi_rows_hybrid(*q16, rows16, SOFT)
                got = (*acc, *phi)
                check(all(g.dtype == bf16 for g in got) and all(
                    torch.equal(g, v.to(bf16)) for g, v in zip(got, raw)),
                    f"K6-bf16 R={r}: the wrapper's outputs are not its sums "
                    f"rounded")
                # K5's bf16 rows at K6's geometry and split (K6's scratch
                # holds K5's): K6's
                k5 = phi_runner(False, True, rows32, sp16)()
                check(torch.equal(k5, raw[3:]),
                      f"K5-bf16 R={r}: not K6-bf16's rows at its split")
                wrap = lambda q, rw: acc_phi_rows_hybrid(*q, rw, SOFT)
                plain = lambda: acc_phi_rows_plain(*q16, rows16, SOFT)
            else:
                got = phi_rows_rect(*q16[:3], *q16[:3], rows16, SOFT)
                check(got.dtype == torch.float32 and torch.equal(got, raw),
                      f"K5-bf16 R={r}: the wrapper's outputs are not its "
                      f"sums")
                wrap = lambda q, rw: phi_rows_rect(*q[:3], *q[:3], rw, SOFT)
                plain = lambda: phi_rows_rect_plain(*q16[:3], *q16[:3],
                                                    rows16, SOFT)
            pv = plain()
            pv = (*pv[0], *pv[1]) if force else pv
            if force:   # bf16 out on both sides (phase 15's rule)
                wp = within_rel(got, pv, 1e-2, 1e-4)
                check(wp <= 1.0, f"K6-bf16 R={r} vs its plain version: "
                                 f"{wp:.2f}x of WithinRel 1e-2")
            else:       # K5's rows float32 on both sides
                wp = float(((got - pv).abs() / pv.abs()).max())
                check(wp <= 1e-5, f"K5-bf16 R={r} vs its plain version: "
                                  f"{wp:.3e} > 1e-5")
            alone = [graph_ms(phi_runner(force, b, rows32, sp))
                     for b, sp in ((False, sp32), (True, sp16), (True, sp16),
                                   (False, sp32))]
            ms32, ms16 = turns(lambda: wrap(q32, rows32),
                               lambda: wrap(q16, rows16), reps=5)
            rg = {kind[t]: regs.get((str(r), str(int(force)), t))
                  for t in kind}
            line[key] = (sp16, prel, wp, alone, ms32, ms16, rg)
            if r == 2:
                plain_ms = time_ms(plain, reps=1, runs=1)
                nbytes = ((20 if force else 12) + 8 * r) * nm
                flops = ((20 if force else 10) + 2 * r) * nm * nm
                b_ms = keep(f"{key}-bf16", err, ms16, plain_ms, nbytes, flops,
                            mufu_ms)
                line[key] += (f"; plain {plain_ms:.4f} ms; bound "
                              f"{b_ms:.4f} ms",)
            del sc16, sc32
        for key, (sp, prel, wp, alone, ms32, ms16, rg, *rest) in line.items():
            print(f"[15 bf16 {key} {nm}^2 R={r}] {sp[0]}x{sp[1]} in {sp[2]} "
                  f"slices (its own resident count): the fp32 instance's bits "
                  f"there, the wrapper's outputs; vs float64 phi {prel:.3e} "
                  f"(1e-5)" + (", force within 3e-5" if key == "K6" else "")
                  + f"; vs plain {wp:.3e}; alone (a CUDA graph, each at its "
                  f"split) fp32, bf16, bf16, fp32: "
                  + ", ".join(f"{a:.4f}" for a in alone)
                  + f" ms; through the wrapper in turns bf16 {ms16:.4f} ms, "
                  f"fp32 {ms32:.4f} ms; registers, spill bytes {rg}"
                  + "".join(rest) + f" on {smi}")
    del ref_acc, ref_phi

    # ---- K13 on the bf16 200k galaxy; its float64 sweep on 4096 strided
    # rows, which K14 below shares (its ghosts add nothing)
    sg = init_galaxy(n_main, SEED, dtype=bf16, device=dev)
    g16 = (sg.qx, sg.qy, sg.qz, sg.m * in_dtype(G, bf16))
    g32 = tuple(v.float() for v in g16)
    g64 = tuple(v.double() for v in g16)
    n13 = sg.npad
    idx13 = torch.linspace(0, sg.n - 1, 4096, device=dev).long()
    ref13 = acc_tile_rect_plain(*(v[idx13] for v in g64[:3]), *g64, SOFT)
    bi, bj = mxu_ops.MXU_BLOCK_I, mxu_ops.MXU_BLOCK_J

    def k13_split(sfx):
        return cuda.tile_split(n13, n13, sms, cuda.resident(
            "murb_mxu_resident" + sfx, dev, bi, bj), bi, bj)

    def k13_runner(b16, passes, split):
        """K13 through its C entry at ``split`` (no launch counted), the
        centre found by the kernel: a function returning (sums, centre)."""
        q = g16 if b16 else g32
        center = torch.empty(3, dtype=torch.float32, device=dev)
        packed = torch.empty(-(-n13 // mxu_ops.PACK_SOURCES)
                             * mxu_ops.PACK_SOURCES // 8
                             * mxu_ops.CHUNK_FLOATS, device=dev)
        scratch = (torch.empty((split[0], 4, n13), device=dev)
                   if split[0] > 1 else None)
        out = torch.empty((3, n13), dtype=torch.float32, device=dev)

        def run():
            cuda.launch("murb_mxu_rect" + ("_bf16" if b16 else ""),
                        *(v.data_ptr() for v in q[:3]), n13,
                        *(v.data_ptr() for v in q), n13, soft2, 1,
                        center.data_ptr(), bi, bj, passes, *split,
                        packed.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        *(o.data_ptr() for o in out), cuda.stream(dev))
            return out, center
        return run

    sp16, sp32 = k13_split("_bf16"), k13_split("")
    for prec, eps in (("high", 5e-4), ("default", 1e-3)):
        passes = mxu_ops.tier_passes(prec)[1]
        raw, c16 = (t.clone() for t in k13_runner(True, passes, sp16)())
        o32, c32 = k13_runner(False, passes, sp16)()
        check(torch.equal(raw, o32) and torch.equal(c16, c32),
              f"K13-bf16 {prec}: not the fp32 instance's bits (sums and "
              f"centre) at split {sp16}")
        got = mxu_ops.acc_mxu_rect(*g16[:3], *g16, SOFT, precision=prec)
        check(all(g.dtype == bf16 and torch.equal(g, v.to(bf16))
                  for g, v in zip(got, raw)),
              f"K13-bf16 {prec}: the wrapper's outputs are not its sums "
              f"rounded")
        plain = mxu_ops.acc_mxu_rect_plain(*g32[:3], *g32, SOFT,
                                           precision=prec)
        w64 = within_rel([v[idx13] for v in raw], ref13, eps, eps)
        check(w64 <= 1.0, f"K13-bf16 {prec}: WithinRel {eps:g} against "
                          f"float64 exceeded by {w64:.2f}x")
        if prec == "high":
            wpl = within_rel(raw, plain, 1e-5, 1e-5)
            check(wpl <= 1.0, f"K13-bf16 high: WithinRel 1e-5 against its "
                              f"plain version exceeded by {wpl:.2f}x")
            held = f"vs plain WithinRel 1e-5 at {wpl:.4f}"
        else:
            wpl = within_rel(raw, plain, 1e-3, 1e-3)
            dd = sum(float((a.double() - b.double()).pow(2).sum())
                     for a, b in zip(raw, plain))
            rms = (dd / sum(float(b.double().pow(2).sum())
                            for b in plain)) ** 0.5
            check(wpl <= 1.0 and rms <= 2e-5,
                  f"K13-bf16 default vs its plain version: WithinRel 1e-3 "
                  f"at {wpl:.2f}x, rms {rms:.3e} (tol 2e-5)")
            held = (f"vs plain WithinRel 1e-3 at {wpl:.4f}, rms "
                    f"{rms:.3e} (2e-5)")
        alone = [graph_ms(lambda: k13_runner(b, passes, sp)()[0], reps=5)
                 for b, sp in ((False, sp32), (True, sp16), (True, sp16),
                               (False, sp32))]
        ms32, ms16 = turns(
            lambda: mxu_ops.acc_mxu_rect(*g32[:3], *g32, SOFT,
                                         precision=prec),
            lambda: mxu_ops.acc_mxu_rect(*g16[:3], *g16, SOFT,
                                         precision=prec), reps=3, runs=3)
        err = max(float((a[idx13].double() - b).abs().max())
                  for a, b in zip(raw, ref13))
        note = ""
        if prec == "high":
            plain_ms = time_ms(lambda: mxu_ops.acc_mxu_rect_plain(
                *g32[:3], *g32, SOFT), reps=1, runs=1)
            pairs = float(n13) * n13
            floors = {"mufu": pairs / (16 * sms * clk) * 1e3,
                      "tensor": 64 * pairs / 495e12 * 1e3,
                      "fp32": 3 * pairs / PEAK_FP32 * 1e3}
            # bf16 in: 2 bytes a body value (3 target, 4 source), fp32 out
            b_ms = keep("K13-bf16", err, ms16, plain_ms, 26 * n13,
                        3 * pairs, max(floors.values()))
            note = f"; plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms"
        rg = {f"{kind[t]} NP={p}": regs13.get((p, t)) for p in ("1", "2")
              for t in kind}
        print(f"[15 bf16 K13 {n13}^2 {prec}] {sp16[0]} slices (its own "
              f"resident count; fp32's {sp32[0]}): the fp32 instance's bits "
              f"and centre there, the wrapper's outputs rounded; {held}; vs "
              f"float64 (4096 rows) WithinRel {eps:g} at {w64:.4f}, max|da| "
              f"{err:.3e}; alone (a CUDA graph, each at its split) fp32, "
              f"bf16, bf16, fp32: " + ", ".join(f"{a:.4f}" for a in alone)
              + f" ms; through the wrapper in turns bf16 {ms16:.4f} ms, fp32 "
              f"{ms32:.4f} ms{note}; registers, spill bytes {rg} on {smi}")
    del plain, o32

    # ---- K14: the bf16 ring at D = 1 and 4 on the card, and an odd shard
    # length (its slot rows an even stride apart)
    def ring_runner(b16, qs, gs, split, delay=0):
        """K14 through its C entry at ``split`` (no launch counted), its
        buffers made once: a function that packs slot 0 and runs the ring,
        returning the (3, D n) fp32 sums."""
        d, n = len(qs), qs[0][0].shape[0]
        ld = ring_ops.slot_stride(n) if b16 else n
        bufs = [torch.zeros((2, 4, ld), dtype=q[0].dtype, device=dev)
                for q in qs]
        outs = [torch.empty((3, n), device=dev) for _ in qs]
        scr = [torch.empty((split[0], 3, n) if split[0] > 1 else 0,
                           device=dev) for _ in qs]
        ptrs = lambda ts: (ctypes.c_void_p * d)(*(t.data_ptr() for t in ts))
        arrays = [ptrs(q[c] for q in qs) for c in range(3)] + [ptrs(bufs)]
        arrays += [ptrs(o[c] for o in outs) for c in range(3)] + [ptrs(scr)]
        ids = (ctypes.c_int * d)(*([dev.index or 0] * d))
        side = [ring_ops._side_streams(dev, s) for s in range(d)]

        def run():
            for buf, q, g in zip(bufs, qs, gs):
                for c, v in enumerate((*q, g)):
                    buf[0, c, :n] = v
            streams = [(ctypes.c_void_p * d)(*v) for v in (
                [torch.cuda.current_stream(dev).cuda_stream] * d,
                [c.cuda_stream for c, _ in side],
                [p.cuda_stream for _, p in side])]
            cuda.launch("murb_ring_pipelined" + ("_bf16" if b16 else ""),
                        d, n, *((ld,) if b16 else ()),
                        *(ctypes.addressof(a) for a in arrays),
                        ctypes.addressof(ids),
                        *(ctypes.addressof(s) for s in streams), soft2, 0, 0,
                        *split, delay)
            return torch.stack([torch.cat([o[c] for o in outs])
                                for c in range(3)])
        return run

    def k3_bf16(q, g, split):
        """K3's bf16 instance through its C entry at ``split``."""
        n = q[0].shape[0]
        out = torch.empty((3, n), device=dev)
        scr = torch.empty((split[0], 3, n), device=dev)
        cuda.launch("murb_tile_rect_bf16", *(v.data_ptr() for v in q), n,
                    *(v.data_ptr() for v in q), g.data_ptr(), n, soft2, 0, 0,
                    *split, scr.data_ptr() if split[0] > 1 else None,
                    *(o.data_ptr() for o in out), cuda.stream(dev))
        return out

    res14 = cuda.resident("murb_tile_resident_bf16", dev)
    res14_32 = cuda.resident("murb_tile_resident", dev)
    for d in (1, 4):
        sd = sg.repad(256 * d)
        mesh_d = make_mesh(devices=[dev] * d)
        blocks = shard_state(sd, mesh_d)
        qs = [(b.qx, b.qy, b.qz) for b in blocks]
        gs = [b.m * in_dtype(G, bf16) for b in blocks]
        qs32 = [tuple(v.float() for v in q) for q in qs]
        gs32 = [g.float() for g in gs]
        nl = sd.npad // d
        sp16 = ring_ops.ring_split(nl, sms, res14, d)
        sp32 = ring_ops.ring_split(nl, sms, res14_32, d)
        raw = ring_runner(True, qs, gs, sp16)().clone()
        check(torch.equal(raw, ring_runner(False, qs32, gs32, sp16)()),
              f"K14-bf16 D={d}: not the fp32 instance's bits at split {sp16}")
        check(torch.equal(raw, ring_runner(True, qs, gs, sp16, 5000)()),
              f"K14-bf16 D={d}: a 5 us delay before every copy and compute "
              f"changed the sums")
        if d == 1:
            check(torch.equal(raw, k3_bf16(qs[0], gs[0], sp16)),
                  "K14-bf16 D=1: not K3's bf16 instance's bits")
        got = ring_ops.acc_ring_pipelined(mesh_d, qs, gs, SOFT)
        gcat = [torch.cat([a[c] for a in got]) for c in range(3)]
        check(all(g.dtype == bf16 and torch.equal(g, v.to(bf16))
                  for g, v in zip(gcat, raw)),
              f"K14-bf16 D={d}: the wrapper's outputs are not its sums "
              f"rounded")
        w64 = within_rel([v[idx13] for v in raw], ref13, 1e-5, 5e-6)
        check(w64 <= 1.0, f"K14-bf16 D={d}: WithinRel 1e-5 (rms floor 5e-6)"
                          f" against float64 exceeded by {w64:.2f}x")
        err = max(float((a[idx13].double() - b).abs().max())
                  for a, b in zip(raw, ref13))
        alone = [time_ms(ring_runner(b, q, g, sp), reps=3, runs=3)
                 for b, q, g, sp in ((False, qs32, gs32, sp32),
                                     (True, qs, gs, sp16),
                                     (True, qs, gs, sp16),
                                     (False, qs32, gs32, sp32))]
        ms32, ms16 = turns(
            lambda: ring_ops.acc_ring_pipelined(mesh_d, qs32, gs32, SOFT),
            lambda: ring_ops.acc_ring_pipelined(mesh_d, qs, gs, SOFT),
            reps=3, runs=3)
        note = ""
        if d == 4:
            pv = ring_ops.acc_ring_pipelined_plain(mesh_d, qs, gs, SOFT)
            wp = within_rel(gcat, [torch.cat([a[c] for a in pv])
                                   for c in range(3)], 1e-2, 1e-4)
            check(wp <= 1.0, f"K14-bf16 D=4 vs its plain version: {wp:.2f}x "
                             f"of WithinRel 1e-2")
            plain_ms = time_ms(lambda: ring_ops.acc_ring_pipelined_plain(
                mesh_d, qs, gs, SOFT), reps=1, runs=1)
            nd = sd.npad
            b_ms = keep("K14-bf16", err, ms16, plain_ms, 20 * nd,
                        20 * nd * nd)
            note = (f"; vs plain at {wp:.4f} of WithinRel 1e-2; plain "
                    f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms")
            del pv
        print(f"[15 bf16 K14 N={sd.npad} D={d}] {sp16[0]} j slices a sweep "
              f"(its own resident count {res14}; fp32's {res14_32}): the "
              f"fp32 instance's bits there" + (", and K3's bf16 instance's"
                                               if d == 1 else "")
              + f", the same with a 5 us protocol delay, the wrapper's "
              f"outputs rounded; vs float64 (4096 rows) WithinRel 1e-5 at "
              f"{w64:.4f}, max|da| {err:.3e}; slot copies of "
              f"{8 * ring_ops.slot_stride(nl)} bytes (fp32 {16 * nl}); alone "
              f"(the C entry, slot 0 repacked) fp32, bf16, bf16, fp32: "
              + ", ".join(f"{a:.4f}" for a in alone)
              + f" ms; through the wrapper in turns bf16 {ms16:.4f} ms, fp32 "
              f"{ms32:.4f} ms{note} on {smi}")
        del blocks, qs, gs, qs32, gs32, raw, got, gcat
    # an odd shard length: two shards of 16,383 bodies (slot rows 16,384
    # apart) against the fp32 ring at the same split
    odd = [tuple(v[k * 16_383:(k + 1) * 16_383].contiguous()
                 for v in g16) for k in range(2)]
    sp = ring_ops.ring_split(16_383, sms, res14, 2)
    a16 = ring_runner(True, [o[:3] for o in odd], [o[3] for o in odd], sp)()
    a32 = ring_runner(False, [tuple(v.float() for v in o[:3]) for o in odd],
                      [o[3].float() for o in odd], sp)()
    check(torch.equal(a16, a32), "K14-bf16 D=2, 16,383 bodies a shard: not "
                                 "the fp32 instance's bits")
    print(f"[15 bf16 K14 odd] D=2, 16,383 bodies a shard (slot stride "
          f"{ring_ops.slot_stride(16_383)}): the fp32 instance's bits")
    del odd, a16, a32, ref13
    torch.cuda.empty_cache()

    # ---- the paths: K6 (the merger through create_engine), K14
    # (shard+ring, 4 shards of the card), K13 (tpu+mxu through the CLI)
    (e6, fps6), counts = drive(lambda: timed(create_engine(
        "tpu+tracking+multi", mg, soft=SOFT, dt=DT, num_iterations=20,
        masks=milkyway_andromeda_masks(nm, mg.n)), 20))
    e6.assert_finite()
    check(counts["K6-bf16"] > 0 and counts["K6"] == 0,
          f"the bf16 merger (create_engine) did not launch K6-bf16 alone: "
          f"{counts}")
    launches["K6-bf16"] = counts["K6-bf16"]
    exact = 0.0
    for mask in milkyway_andromeda_masks(nm, mg.n):
        sgm = tm.masked(mg, torch.as_tensor(mask, device=dev))
        qq = [v.double() for v in (sgm.qx, sgm.qy, sgm.qz, sgm.m)]
        pe = tm.potential_energy_per_body(*qq, tm._gm(sgm).double(), SOFT)
        ke = tm.kinetic_energy_per_body(sgm.m, sgm.vx, sgm.vy, sgm.vz)
        exact += float((0.5 * pe + 0.5 * ke).sum())
    e0 = float(e6.finalize_history().energies[0])
    rel6 = abs(e0 / exact - 1.0)
    # K6's rows come back in the state's dtype (murb_tpu's K6 too), and the
    # energy subtracts each body's self term from its bf16 row
    # (tests/test_torch_bf16_sweeps.py: 2e-2, murb_tpu's class)
    check(bool(np.isfinite(e0)) and rel6 <= 2e-2,
          f"bf16 merger (K6) energy row 0 {e0:.9e} vs float64 {exact:.9e}: "
          f"rel {rel6:.3e} > 2e-2")
    print(f"[15 merger K6] create_engine tpu+tracking+multi bf16 N={mg.n}: "
          f"{fps6:.2f} FPS over 19 steps after one; energy row 0 rel "
          f"{rel6:.3e} of float64 (2e-2; K6's rows are bf16); launches "
          f"{counts} on {smi}")
    (e14, fps14), counts = drive(lambda: timed(create_engine(
        "shard+ring", sg, soft=SOFT, dt=DT, devices=[dev] * 4), 10))
    e14.assert_finite()
    check(e14.ring_impl == "pipelined" and e14.bodies.dtype == bf16,
          f"shard+ring bf16 took {e14.ring_impl}, {e14.bodies.dtype}")
    check(counts["K14-bf16"] > 0 and counts["K14"] == 0,
          f"shard+ring bf16 on 4 shards did not launch K14-bf16 alone: "
          f"{counts}")
    launches["K14-bf16"] = counts["K14-bf16"]
    print(f"[15 shard+ring] create_engine shard+ring bf16 devices=[cuda:0]*4 "
          f"N={n_main}: {fps14:.3f} FPS over 9 steps after one; launches "
          f"{counts}")
    del e6, e14
    res13, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "10", "--im", "tpu+mxu", "--precision",
        "bf16", "--nv", "--gf", "--scan", "--device", "cuda"]))
    check(res13.rc == 0, f"cli tpu+mxu bf16 exit code {res13.rc}")
    res13.engine.assert_finite()
    check(res13.engine.bodies.dtype == bf16, "tpu+mxu: the state is not bf16")
    check(counts["K13-bf16"] > 0 and counts["K13"] == 0,
          f"tpu+mxu --precision bf16 did not launch K13-bf16 alone: {counts}")
    launches["K13-bf16"] = counts["K13-bf16"]
    print(f"[15 tpu+mxu] --precision bf16 N={n_main} through the CLI: "
          f"{res13.fps:.3f} FPS over 9 steps; launches {counts} on {smi}")
    print(f"[15 time] phase 15's K5, K6, K13 and K14 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


#: phase 16's clustered sizes below phase 9's 1M box
PLAN_NS = (131_072, 262_144, 524_288)
#: where two branches differ by more than this ratio, the auto policy must
#: pick the faster; a prediction must lie within MODEL_RATIO of its
#: measurement either way; best_depth's pick within DEPTH_SLACK of the
#: fastest candidate
PICK_GAP, MODEL_RATIO, DEPTH_SLACK = 1.15, 1.5, 1.10


def phase16(dev, smi, st9, est9, ms9, ms_exact9, tab, pick8,
            n_main=200_000):
    """16. The planners' decisions on the card.  On the two-cluster box
    (``utils/profile_step.two_clusters``, seed 42, soft 0.02, dt 1e-6) at
    PLAN_NS and, from phase 9 (``st9``, the auto policy's estimates
    ``est9`` and the measured ms a step ``ms9`` and ``ms_exact9``), at
    1,048,576, and on the merger (``tab``, soft 2e8, dt 3600): the auto
    engine's pick (``create_engine("tpu+proxy")``), its estimates at the
    card's rates (``cost_estimates``), and the wall ms a step of the
    adaptive branch (the pick, or ``near="adaptive"`` forced) and of the
    exact one (the pick's fallback, or ``tpu+hybrid``: the same K4
    passes 2); where the two differ by more than PICK_GAP the pick must
    be the faster.  The exact model within MODEL_RATIO of the measured
    step at PLAN_NS, and the adaptive model (the estimate the policy
    compares, priced at the planning order) at 1M.  On the 200k random
    box, the step at each (m, levels) ``ops/fmm.best_depth`` weighs,
    timed in three turns (forward, backward, forward; the least of the
    three, since host time only adds to a step): its pick within
    DEPTH_SLACK of the fastest.  ``pick8`` is phase 8's
    engine's (m, levels) after its validation.  Launches no kernel check
    of its own: every kernel it runs was held in phases 3, 8 and 9."""
    import torch

    from murb_tpu_torch.core.init import init_milkyway_andromeda, make_bodies
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.ops import fmm
    from murb_tpu_torch.ops.proxy import half_extent
    from murb_tpu_torch.ops.sparse_fmm import exact_cost_ms
    from murb_tpu_torch.utils.profile_step import (TWO_CLUSTERS_DT,
                                                   TWO_CLUSTERS_SOFT,
                                                   step_ms, two_clusters)

    t_phase = time.perf_counter()
    rows = []

    def decide(label, st, soft, dt, steps):
        t0 = time.perf_counter()
        eng = create_engine("tpu+proxy", st, soft=soft, dt=dt)
        t_build = time.perf_counter() - t0
        adopted = eng.using_proxy and eng.near_mode == "adaptive"
        check(adopted or not eng.using_proxy,
              f"{label}: the auto policy took the dense hierarchy "
              f"(m={eng.m}, levels={eng.levels}), neither branch")
        est = dict(eng.cost_estimates)
        if adopted:
            ms_a = step_ms(eng, steps)
            other = create_engine("tpu+hybrid", st, soft=soft, dt=dt)
            ms_x = step_ms(other, steps)
            plan = eng._plan
        else:
            ms_x = step_ms(eng, steps)
            other = create_engine("tpu+proxy", st, soft=soft, dt=dt,
                                  near="adaptive")
            ms_a = step_ms(other, steps)
            plan = other._plan
        del eng, other
        torch.cuda.empty_cache()
        return {"label": label, "npad": st.npad, "adopted": adopted,
                "est": est, "ms_adaptive": ms_a, "ms_exact": ms_x,
                "plan": (plan.m, plan.dense_levels, plan.levels),
                "build_s": t_build}

    for n in PLAN_NS:
        rows.append(decide(f"two clusters N={n}", two_clusters(n, device=dev),
                           TWO_CLUSTERS_SOFT, TWO_CLUSTERS_DT, 3))
    rows.append({"label": f"two clusters N={st9.n} (phase 9)",
                 "npad": st9.npad, "adopted": True, "est": est9,
                 "ms_adaptive": ms9, "ms_exact": ms_exact9, "plan": None,
                 "build_s": 0.0})
    mg = init_milkyway_andromeda(tab, device=dev)
    rows.append(decide(f"merger N={mg.n}", mg, SOFT, DT, 5))
    del mg
    for r in rows:
        fast = "adaptive" if r["ms_adaptive"] < r["ms_exact"] else "exact"
        gap = max(r["ms_adaptive"], r["ms_exact"]) / min(
            r["ms_adaptive"], r["ms_exact"])
        pick = "adaptive" if r["adopted"] else "exact"
        print(f"[16 pick] {r['label']}: predicted adaptive "
              f"{r['est']['adaptive_ms']:.3f} ms, exact "
              f"{r['est']['exact_ms']:.3f}; measured adaptive "
              f"{r['ms_adaptive']:.3f} ms (plan m, Ld, L {r['plan']}), exact "
              f"{r['ms_exact']:.3f}; picks {pick}, faster {fast} by "
              f"{gap:.2f}x (engine built in {r['build_s']:.1f} s)")
        check(gap <= PICK_GAP or pick == fast,
              f"{r['label']}: the auto policy picked {pick}, but {fast} is "
              f"{gap:.2f}x faster")
    # the models against the measurements
    for r in rows[:len(PLAN_NS)]:
        ratio = r["est"]["exact_ms"] / r["ms_exact"]
        print(f"[16 model] exact N={r['npad']}: predicted "
              f"{r['est']['exact_ms']:.3f} ms, measured {r['ms_exact']:.3f}"
              f" ({ratio:.2f}x)")
        check(1 / MODEL_RATIO <= ratio <= MODEL_RATIO,
              f"exact model at N={r['npad']} {ratio:.2f}x the step")
        check(r["est"]["exact_ms"] == exact_cost_ms(r["npad"], dev),
              "the engine's exact estimate is not the card's model")
    ratio = est9["adaptive_ms"] / ms9
    print(f"[16 model] adaptive N={st9.n}: predicted "
          f"{est9['adaptive_ms']:.3f} ms, measured {ms9:.3f} ({ratio:.2f}x)")
    check(1 / MODEL_RATIO <= ratio <= MODEL_RATIO,
          f"adaptive model at N={st9.n} {ratio:.2f}x the step")

    # the depth model on the random box
    r16 = make_bodies(n_main, "random", SEED, device=dev)
    half = float(half_extent(r16.unpadded()))
    cands = fmm.depth_candidates(r16.npad, half, SOFT, TOL, device=dev)
    pick = fmm.best_depth(r16.npad, half, SOFT, TOL, device=dev)
    engines = {(m, lv): create_engine("tpu+proxy", r16, soft=SOFT, dt=DT,
                                      m=m, levels=lv, validate=False)
               for _, m, lv in cands}
    walls = {k: [] for k in engines}
    for order in (list(engines), list(engines)[::-1], list(engines)):
        for k in order:
            walls[k].append(step_ms(engines[k], 30))
    # host time only adds to a step: the least of the three turns
    ms = {k: min(v) for k, v in walls.items()}
    best = min(ms, key=ms.get)
    for est, m, lv in cands:
        print(f"[16 depth] random N={n_main} m={m} L={lv}: est {est:.4g} "
              f"MAC-eq, {ms[(m, lv)]:.4f} ms a step (runs "
              f"{', '.join(f'{w:.4f}' for w in walls[(m, lv)])})")
    print(f"[16 depth] best_depth picks {pick} ({ms[pick]:.4f} ms), the "
          f"fastest is {best} ({ms[best]:.4f} ms); phase 8's engine kept "
          f"{pick8} after validation")
    check(ms[pick] <= DEPTH_SLACK * ms[best],
          f"best_depth's pick {pick} at {ms[pick]:.4f} ms, the fastest "
          f"{best} at {ms[best]:.4f}")
    del engines, r16
    torch.cuda.empty_cache()
    print(f"[16 time] phase 16 took {time.perf_counter() - t_phase:.1f} s "
          f"on {smi}")


def phase17(dev, smi, time_ms, n_main, tmp):
    """17. The fast solver's stage geometry (``ProxyEngine``'s ``block``,
    ``m2l_tile`` and ``autotune``; murb_tpu/models/engines.py:663-743).
    On the 200k galaxy at m=12 and on the 200k random box at (m, L) = (8,
    2), for each candidate of the engine's ``_fast_candidates``: K1 and K2
    (galaxy), K8 and K7 (box) against their plain versions in float64 at
    phase 3's and phase 8's tolerances, each timed through its wrapper;
    today's pick given explicitly (K1's ``p2m_chunk``, K2's block by
    ``l2p_bodies``, K7's 16 cells an item) gives the bits of the pick 0;
    K9's item is compiled (64 or 256 bodies by order), so every candidate
    runs K9 at it.  Then, under a temporary MURB_TUNE_CACHE, ``tpu+proxy
    --autotune`` through the CLI sweeps and stores the pick under the
    engine's key; a second run reads it with no sweep; the pick and
    today's geometry are timed in turns on that engine (steps a second
    and the solver alone by CUDA events), and the pick's measured force
    error is held to 1e-4 beside the engine's ``validated_err``."""
    import torch

    from murb_tpu_torch import cli
    from murb_tpu_torch.core.init import init_galaxy, init_random
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.ops import cuda
    from murb_tpu_torch.ops import fmm_kernels as fk
    from murb_tpu_torch.ops import proxy_kernels as tk
    from murb_tpu_torch.ops.proxy import HEAVY_FACTOR, _heavy_setup
    from murb_tpu_torch.ops.validate import measured_force_error
    from murb_tpu_torch.utils import autotune as at

    t_phase = time.perf_counter()
    sms = cuda.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def close(got, ref, rtol, atol_rel, label):
        """max|d| (and max|ref|) of ``got`` against float64 ``ref`` within
        rtol + atol_rel * max|ref| (phase 3's allclose)."""
        g = torch.stack([v.double() for v in got])
        r = torch.stack([v for v in ref])
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        check(bool(torch.allclose(g, r, rtol=rtol, atol=atol_rel * scale)),
              f"{label}: max|d| {err:.3e} vs rtol {rtol:g} + {atol_rel:g} "
              f"max|ref| ({atol_rel * scale:.3e})")
        return err, scale

    def rel_max(got, ref):
        return max(float((g.double() - r).abs().max() / r.abs().max())
                   for g, r in zip(got, ref))

    def autotuned(args, label):
        """``tpu+proxy --autotune`` then the same run without it, through
        the CLI: (the first run's engine, the second's, candidates timed)."""
        calls = []
        measure = at.measure_steps
        at.measure_steps = lambda *a, **k: calls.append(1) or measure(*a, **k)
        try:
            argv = ["-n", str(n_main), "-i", "3", "--im", "tpu+proxy",
                    *args, "--nv", "--scan", "--device", dev.type]
            r1 = cli.run(argv + ["--autotune"])
            swept = len(calls)
            r2 = cli.run(argv)
        finally:
            at.measure_steps = measure
        check(r1.rc == 0 and r2.rc == 0, f"{label}: --autotune exit codes "
                                         f"{r1.rc}, {r2.rc}")
        e1, e2 = r1.engine, r2.engine
        t1 = e1.tuned
        check(t1 is not None and "sweep" in t1
              and swept == len(e1._fast_candidates()),
              f"{label}: --autotune swept {swept} candidates, tuned {t1}")
        check(len(calls) == swept and e2.tuned is not None
              and "sweep" not in e2.tuned
              and (e2.block, e2.m2l_tile) == (e1.block, e1.m2l_tile),
              f"{label}: the second run did not read the pick")
        with open(os.environ["MURB_TUNE_CACHE"]) as f:
            stored = json.load(f)[at._key(e1._fast_tune_tag, e1.bodies.npad,
                                          dev)]
        check((stored["block"], stored["m2l_tile"]) == (e1.block,
                                                        e1.m2l_tile),
              f"{label}: stored {stored}")
        return e1, e2, swept

    def pick_in_turns(e, label):
        """The pick against today's geometry (0, 0) on engine ``e``, in
        turns (today, pick, pick, today): steps a second over 50 steps and
        the solver alone by CUDA events; the pick's force error."""
        pick = (e.block, e.m2l_tile)
        st = e.bodies
        q, g = (st.qx, st.qy, st.qz), e._gm(st)
        fps, solver = [], []
        for geo in ((0, 0), pick, pick, (0, 0)):
            e.block, e.m2l_tile = geo
            fps.append(timed(e, 50)[1])
            solver.append(time_ms(lambda: e._acc_solver(*q, g, *geo)))
        e.block, e.m2l_tile = pick
        err = measured_force_error(
            *q, g, SOFT, lambda a, b, c, gg: e._acc_solver(a, b, c, gg, *pick))
        check(e.validated_err is not None and e.validated_err <= TOL
              and err <= TOL,
              f"{label}: validated_err {e.validated_err}, the pick's error "
              f"{err:.3e} (tol {TOL})")
        e.assert_finite()
        print(f"[17 {label} pick] (block, m2l_tile) = {pick}: in turns "
              f"(today, pick, pick, today) {', '.join(f'{v:.2f}' for v in fps)}"
              f" FPS; the solver alone {', '.join(f'{v:.4f}' for v in solver)}"
              f" ms; validated_err {e.validated_err:.3e}, the pick's error "
              f"{err:.3e} (tol {TOL}); on {smi}")
        return fps, solver

    os.environ["MURB_TUNE_CACHE"] = os.path.join(tmp, "fast_tune.json")
    try:
        # ---- the galaxy at m=12: K1 and K2 at each candidate's block
        st = init_galaxy(n_main, SEED, device=dev)
        gm = gm_of(st)
        q = (st.qx, st.qy, st.qz)
        q64 = tuple(v.double() for v in q)
        c, h, *_rest, ge = _heavy_setup(*q, gm, 1, HEAVY_FACTOR)
        n, m = st.qx.shape[0], 12
        cands = create_engine("tpu+proxy", st, soft=SOFT, dt=DT, m=m,
                              autotune=False)._fast_candidates()
        w64 = tk.p2m_plain(*q64, ge.double(), c.double(), h.double(), m=m)
        fields = tuple(torch.randn(m ** 3, generator=gen, device=dev)
                       for _ in range(3))
        a64 = tk.l2p_plain(*q64, c.double(), h.double(),
                           tuple(f.double() for f in fields), m=m)
        chunk0 = fk.p2m_chunk(n, m, sms)
        block0 = tk.ONE_L2P_THREADS * tk.l2p_bodies(n, m, sms)
        check(torch.equal(tk.p2m_fused(*q, ge, c, h, m=m),
                          tk.p2m_fused(*q, ge, c, h, m=m, chunk=chunk0))
              and all(torch.equal(x, y) for x, y in zip(
                  tk.l2p_fused_multi(*q, c, h, fields, m=m),
                  tk.l2p_fused_multi(*q, c, h, fields, m=m, block=block0))),
              f"K1/K2: today's geometry given ({chunk0}, {block0}) is not "
              f"the bits of 0")
        for p in cands:
            b = p["block"]
            kb = tk.l2p_block_for(b, m)
            w = tk.p2m_fused(*q, ge, c, h, m=m, chunk=b)
            a = tk.l2p_fused_multi(*q, c, h, fields, m=m, block=kb)
            err_w, _ = close([w], [w64], 1e-4, 1e-6, f"K1 block={b}")
            err_a, _ = close(a, a64, 1e-4, 1e-5, f"K2 block={b}")
            ms1 = time_ms(lambda: tk.p2m_fused(*q, ge, c, h, m=m, chunk=b))
            ms2 = time_ms(lambda: tk.l2p_fused_multi(*q, c, h, fields, m=m,
                                                     block=kb))
            run = tk.one_run(n, m, dev, chunk=b)
            print(f"[17 K1/K2 m={m} N={n} block={b}] K1 {run.nitems} items "
                  f"of {run.chunk} bodies, max|dW| {err_w:.3e} (rtol 1e-4 + "
                  f"1e-6 max|W|), {ms1:.4f} ms; K2 blocks of "
                  f"{kb or block0} bodies, max|da| {err_a:.3e} (rtol 1e-4 + "
                  f"1e-5 max|a|), {ms2:.4f} ms (through the wrappers)")
        del w64, a64
        e1, e2, swept = autotuned([], "galaxy")
        print(f"[17 galaxy autotune] tpu+proxy N={n_main} m={e1.m}: "
              f"{swept} candidates, ms/step "
              + json.dumps({f"{p['block']},{p['m2l_tile']}": v
                            for p, v in e1.tuned["sweep"]})
              + f"; pick ({e1.block}, {e1.m2l_tile}) "
              f"{e1.tuned['ms_per_step']:.4f} ms/step, read back with no "
              f"sweep under key {e1._fast_tune_tag!r}")
        pick_in_turns(e2, "galaxy")
        del st, e1, e2

        # ---- the random box at (8, 2): K8 at each block, K7 at each tile
        sr = init_random(n_main, SEED, device=dev)
        q = (sr.qx, sr.qy, sr.qz)
        q64 = tuple(v.double() for v in q)
        g8 = gm_of(sr)
        c, h, *_rest, ge = _heavy_setup(*q, g8, 1, HEAVY_FACTOR)
        e8 = create_engine("tpu+proxy", sr, soft=SOFT, dt=DT,
                           autotune=False)
        check((e8.m, e8.levels) == (8, 2),
              f"random box took (m, L) = ({e8.m}, {e8.levels}), not (8, 2)")
        m, C = 8, 4
        cands = e8._fast_candidates()
        n = sr.qx.shape[0]
        order = fk.cell_order(*q, c, h, C)
        w64 = fk.p2m_grid_plain(*q64, ge.double(), c.double(), h.double(),
                                m=m, C=C)
        check(torch.equal(fk.p2m_grid_fused(*q, ge, c, h, m=m, C=C,
                                            order=order),
                          fk.p2m_grid_fused(*q, ge, c, h, m=m, C=C,
                                            order=order,
                                            chunk=fk.p2m_chunk(n, m, sms))),
              "K8: today's chunk given is not the bits of 0")
        hl = h / C
        f64 = fk.m2l_level_plain(w64, hl.double(), SOFT, m=m, C=C)
        for p in cands:
            b, tile = p["block"], p["m2l_tile"]
            if tile == 0:
                w = fk.p2m_grid_fused(*q, ge, c, h, m=m, C=C, order=order,
                                      chunk=b)
                err = rel_max([w], [w64])
                check(err <= 1e-5, f"K8 block={b}: {err:.3e} of max|W|")
                ms = time_ms(lambda: fk.p2m_grid_fused(
                    *q, ge, c, h, m=m, C=C, order=order, chunk=b))
                items = fk.p2m_grid_items(order, m, b)
                print(f"[17 K8 m={m} C={C} N={n} block={b}] items of "
                      f"{items.chunk} bodies, max|dW|/max|W| {err:.3e} (tol "
                      f"1e-5), {ms:.4f} ms through the wrapper")
            if b == 0:
                f = fk.m2l_level_fused(w64.float(), hl, SOFT, m=m, C=C,
                                       tile=tile)
                err = rel_max(f, f64)
                check(err <= 3e-5, f"K7 m2l_tile={tile}: {err:.3e}")
                ms = time_ms(lambda: fk.m2l_level_fused(
                    w64.float(), hl, SOFT, m=m, C=C, tile=tile))
                plan = fk._plan_on(m, C, "expand", 3, dev, "fp32", tile)[0]
                print(f"[17 K7 m={m} C={C} expand m2l_tile={tile}] "
                      f"{len(plan.items)} items, {plan.nsplit} splits; "
                      f"max|df|/max|f| {err:.3e} (tol 3e-5), {ms:.4f} ms")
        full = fk.m2l_level_fused(w64.float(), hl, SOFT, m=m, C=C,
                                  tile=fk.M2L_GROUP)
        check(all(torch.equal(x, y) for x, y in zip(
            full, fk.m2l_level_fused(w64.float(), hl, SOFT, m=m, C=C))),
            f"K7: m2l_tile={fk.M2L_GROUP} is not the bits of 0")
        k9 = fk.l2p_grid_fused(*q, c, h, tuple(x.float() for x in f64),
                               m=m, C=C, order=order)
        err9 = rel_max(k9, fk.l2p_grid_plain(*q64, c.double(), h.double(),
                                             f64, m=m, C=C))
        check(err9 <= 1e-4, f"K9: {err9:.3e} of max|a|")
        print(f"[17 K7/K9] m2l_tile={fk.M2L_GROUP} gives the bits of 0; K9 "
              f"runs its compiled item of {fk.l2p_item(m)} bodies for every "
              f"candidate: max|da|/max|a| {err9:.3e} (tol 1e-4)")
        del w64, f64, full, k9, e8
        e1, e2, swept = autotuned(["-s", "random"], "random")
        print(f"[17 random autotune] tpu+proxy -s random N={n_main} "
              f"(m, L) = ({e1.m}, {e1.levels}): {swept} candidates, ms/step "
              + json.dumps({f"{p['block']},{p['m2l_tile']}": v
                            for p, v in e1.tuned["sweep"]})
              + f"; pick ({e1.block}, {e1.m2l_tile}) "
              f"{e1.tuned['ms_per_step']:.4f} ms/step, read back with no "
              f"sweep under key {e1._fast_tune_tag!r}")
        pick_in_turns(e2, "random")
    finally:
        del os.environ["MURB_TUNE_CACHE"]
    torch.cuda.empty_cache()
    print(f"[17 time] phase 17 took {time.perf_counter() - t_phase:.1f} s")


def within_rel(got, ref, eps: float, rms_floor: float, rms=None) -> float:
    """Catch2 WithinRel with an rms floor (tests/conftest.py); returns the
    largest ratio of |a - b| to its allowance (<= 1 passes).  ``rms``: each
    component's rms to floor with, where ``ref`` holds only some rows of
    the array whose rms sets the floor."""
    import torch

    worst = 0.0
    for c, (g, r) in enumerate(zip(got, ref)):
        g, r = g.double(), r.double()
        r_rms = float(r.pow(2).mean().sqrt()) if rms is None else rms[c]
        allow = (eps * torch.maximum(g.abs(), r.abs())
                 + rms_floor * r_rms + 1e-300)
        worst = max(worst, float(((g - r).abs() / allow).max()))
    return worst


def gm_of(state):
    """G*m of a state in its dtype, G rounded to it (the engines' _gm)."""
    import torch

    from murb_tpu_torch import G

    return state.m * torch.tensor(G, dtype=state.dtype).item()


def event_ms(fn, reps: int = 10, runs: int = 5) -> float:
    """Median over ``runs`` of the mean CUDA-event time of ``reps`` calls
    of ``fn``, after one warm-up call (``utils/profile_step.event_ms`` at
    this script's counts)."""
    from murb_tpu_torch.utils import profile_step

    return profile_step.event_ms(fn, reps, runs)


#: phase 11's rings across processes: (processes, their hosts, local shards
#: of each run); hosts None: every process on this machine's own host (CUDA
#: IPC between them), else one placed host a process (make_mesh(host=...)):
#: processes on different hosts exchange their boundary slot through
#: pinned host memory and a gloo side group, loopback TCP standing for the
#: network between hosts.  One group of worker processes runs every layout
#: of its process count, in this order
RING_LAYOUTS = ((2, None, (1, 2)), (3, None, (1,)), (4, None, (1,)),
                (2, ("h0", "h1"), (1, 2)), (4, ("h0", "h0", "h1", "h1"), (1,)),
                (4, ("h0", "h1", "h2", "h3"), (1,)))
#: the layouts whose engine run, timing and plain version go to the kernels
#: line: processes of one host (K14-ipc), processes on two hosts
#: (K14-hosts)
RING_MAIN = (2, None, 2)
RING_HOSTS_MAIN = (2, ("h0", "h1"), 2)
RING_DELAY_NS = 5000
#: the sleep before every send of one agent (a ring across hosts)
RING_HOST_DELAY_NS = 1_000_000
RING_FIELDS = ("qx", "qy", "qz", "vx", "vy", "vz")


def ring_layout_name(nproc: int, hosts, l: int) -> str:
    """``2x2`` for 2 processes of one host, 2 shards each; ``2 hosts x 2 x
    1`` for 4 processes on 2 hosts, 1 shard each."""
    if hosts is None:
        return f"{nproc}x{l}"
    return f"{len(set(hosts))} hosts x {nproc // len(set(hosts))} x {l}"


def ring_worker(rank: int, nproc: int, port: str, work: str) -> int:
    """One process of phase 11's ring across processes
    (``chip_smoke.py --ring-worker RANK NPROC PORT DIR``): a gloo group of
    ``nproc`` processes on cuda:0 (an explicit device list), and for each
    of its layouts (on this machine's host, or this process placed on its
    host of the layout) and for fp32 and bf16 on the 200k galaxy: K14's
    cross-process instance (one host) or cross-host instance 3 times in a
    row with no delay, with a 5 us delay in process 0 only, then in the
    last process only, and across hosts with a 1 ms
    sleep before every send of the last process's agent, every call's sums
    bit for bit the one-process K14's at D = P L (``DIR/ref_*``), the last
    within WithinRel 1e-5 (rms floor 5e-6) of the float64 sweep; the time a
    call; ``shard+ring`` for 3 steps through ``create_engine`` (auto must
    take the pipelined ring), its launches counted and its blocks bit for
    bit the one-process engine's; at RING_MAIN and RING_HOSTS_MAIN the
    plain version across processes once, and at RING_HOSTS_MAIN the time
    a call in turns with the IPC ring of the same processes and blocks
    placed on one host.  Prints one ``RING_RESULT`` JSON line; any
    failure raises (a non-zero exit)."""
    os.environ.update(MURB_COORDINATOR=f"localhost:{port}",
                      MURB_NUM_PROCESSES=str(nproc),
                      MURB_PROCESS_ID=str(rank))
    import torch

    sys.path.insert(0, ROOT)
    from murb_tpu_torch.core.init import init_galaxy
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.ops import ring as ring_ops
    from murb_tpu_torch.parallel.mesh import (destroy_distributed, make_mesh,
                                              maybe_init_distributed,
                                              shard_state)

    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    check(maybe_init_distributed("cuda", backend="gloo"),
          "ring worker: the coordinator's variables were not read")
    dev = torch.device("cuda", 0)
    fn = ring_ops.acc_ring_pipelined
    counters = ("launches", "bf16_launches", "ipc_launches",
                "ipc_bf16_launches", "hosts_launches", "hosts_bf16_launches")
    out = []
    for (_, hosts, ls) in [x for x in RING_LAYOUTS if x[0] == nproc]:
        host = hosts[rank] if hosts else None
        # (device delay in process, host delay in process) of each group of
        # calls
        delays = [(None, None), (0, None), (nproc - 1, None)]
        if hosts:
            delays.append((None, nproc - 1))
        for l in ls:
            d = nproc * l
            lay = ring_layout_name(nproc, hosts, l)
            for prec, dtype in (("fp32", torch.float32),
                                ("bf16", torch.bfloat16)):
                tag = f"K14 across processes {lay} {prec} rank {rank}"
                ref = torch.load(os.path.join(work, f"ref_{d}_{prec}.pt"),
                                 map_location=dev)
                st = init_galaxy(spec["n"], SEED, dtype=dtype, device=dev)
                mesh = make_mesh(devices=[dev] * l, host=host)
                check(mesh.size == d and mesh.single_host == (hosts is None)
                      and (hosts is None or tuple(mesh.hosts) == hosts),
                      f"{tag}: a mesh of {mesh.size} shards on {mesh.hosts}")
                sd = st.repad(256 * d)
                blocks = shard_state(sd, mesh)
                qs = [(b.qx, b.qy, b.qz) for b in blocks]
                gs = [gm_of(b) for b in blocks]
                first, nl = mesh.axis_index(0), sd.npad // d
                for dev_at, host_at in delays:
                    delay = RING_DELAY_NS if rank == dev_at else 0
                    h_delay = RING_HOST_DELAY_NS if rank == host_at else 0
                    for call in range(3):
                        got = ring_ops.ring_sums(mesh, qs, gs, SOFT,
                                                 delay_ns=delay,
                                                 host_delay_ns=h_delay)
                        torch.cuda.synchronize()
                        for s, g in enumerate(got):
                            check(torch.equal(g, ref["sums"][first + s]),
                                  f"{tag}: shard {first + s}, call {call} "
                                  f"with the device delay in process "
                                  f"{dev_at}, the host delay in process "
                                  f"{host_at}: not the one-process K14's "
                                  f"bits at D={d}")
                r64 = torch.load(os.path.join(work, f"ref64_{prec}.pt"),
                                 map_location=dev)[:, :sd.npad]
                rms = [float(v.pow(2).mean().sqrt()) for v in r64]
                mine = r64[:, first * nl:(first + l) * nl]
                sums = torch.cat(got, dim=1)
                w64 = within_rel(sums, mine, 1e-5, 5e-6, rms)
                check(w64 <= 1.0, f"{tag}: WithinRel 1e-5 (rms floor 5e-6) "
                                  f"against float64 exceeded by {w64:.2f}x")
                err = float((sums.double() - mine).abs().max())
                ms = event_ms(lambda: ring_ops.ring_sums(mesh, qs, gs, SOFT),
                              reps=3, runs=3)
                eng = create_engine("shard+ring", st, soft=SOFT, dt=DT,
                                    devices=[dev] * l, host=host)
                check(eng.ring_impl == "pipelined" and eng.n_shards == d,
                      f"{tag}: shard+ring took {eng.ring_impl} on "
                      f"{eng.n_shards} shards")
                for a in counters:
                    setattr(fn, a, 0)
                eng.run(3)
                torch.cuda.synchronize()
                counts = {a: getattr(fn, a) for a in counters}
                mine_count = ("hosts" if hosts else "ipc") + (
                    "_bf16_launches" if prec == "bf16" else "_launches")
                check(counts[mine_count] == 3 * l * d
                      and sum(counts.values()) == counts[mine_count],
                      f"{tag}: 3 engine steps launched {counts}")
                for s, b in enumerate(eng.blocks):
                    for c, k in enumerate(RING_FIELDS):
                        check(torch.equal(getattr(b, k),
                                          ref["engine"][first + s][c]),
                              f"{tag}: shard {first + s}'s {k} after 3 "
                              f"steps is not the one-process engine's")
                res = {"p": nproc, "hosts": hosts, "l": l, "prec": prec,
                       "rank": rank, "w64": w64, "err": err, "ms": ms,
                       "launches": counts[mine_count], "npad": sd.npad}
                if (nproc, hosts, l) in (RING_MAIN, RING_HOSTS_MAIN):
                    # the plain version across processes: the boundary
                    # slot through Mesh.ppermute (one host) or the staged
                    # ends and agents (across hosts), gloo, the sweeps in
                    # torch ops
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pv = ring_ops.acc_ring_pipelined_plain(mesh, qs, gs,
                                                           SOFT)
                    torch.cuda.synchronize()
                    res["plain_ms"] = (time.perf_counter() - t0) * 1e3
                    pv = torch.cat([torch.stack(list(a)) for a in pv], dim=1)
                    if prec == "fp32":
                        res["plain_w"] = within_rel(pv, mine, 1e-5, 5e-6,
                                                    rms)
                    else:   # bf16 out: phase 15's contract on the kernel
                        res["plain_w"] = within_rel(
                            sums.to(torch.bfloat16), pv, 1e-2, 1e-4)
                    check(res["plain_w"] <= 1.0,
                          f"{tag}: the plain version across processes at "
                          f"{res['plain_w']:.2f}x of its allowance")
                if hosts and (nproc, hosts, l) == RING_HOSTS_MAIN:
                    # the same processes, blocks and card on one host (the
                    # IPC ring) and on their hosts (staged), in turns
                    near = make_mesh(devices=[dev] * l)
                    check(near.single_host, f"{tag}: {near.hosts}")
                    res["turns"] = [event_ms(
                        lambda: ring_ops.ring_sums(m, qs, gs, SOFT), reps=3,
                        runs=3) for m in (near, mesh, mesh, near)]
                out.append(res)
                del eng, blocks, qs, gs, got, sums, ref, r64
                torch.cuda.empty_cache()
    print("RING_RESULT " + json.dumps(out), flush=True)
    destroy_distributed()
    return 0


def phase11_processes(dev, smi, ref11, time_ms, keep, n_main, tmp):
    """Phase 11's ring across processes on this one card: time-sliced
    contexts of 2 to 4 processes, not a link; the protocol is checked.

    Writes the one-process references into ``tmp`` (K14's sums at D = 2,
    3, 4 on one process, fp32 and bf16, and the one-process engine's blocks
    after 3 steps; the float64 sweeps: phase 10's ``ref11`` and the bf16
    galaxy's), then runs ``ring_worker`` in 2, 3 and 4 processes, each
    group every layout of its size (RING_LAYOUTS: on this host, and placed
    on 2 and 4 hosts) with a hard time limit; a worker that fails or runs
    out fails the phase, and the others are killed.  Returns the
    launches of the cross-process instances in the engine runs at
    RING_MAIN and of the cross-host instances at RING_HOSTS_MAIN, every
    process's."""
    import torch

    from murb_tpu_torch.core.init import init_galaxy
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.ops import ring as ring_ops
    from murb_tpu_torch.ops.tile import acc_tile_rect_plain
    from murb_tpu_torch.parallel.mesh import make_mesh, shard_state

    t_phase = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True).stdout.strip()
    print(f"[11 processes] compute mode {mode!r} (Default lets several "
          f"processes share the card)")
    work = os.path.join(tmp, "ring_processes")
    os.makedirs(work, exist_ok=True)
    bf16 = torch.bfloat16
    ds = sorted({p * l for p, _, ls in RING_LAYOUTS for l in ls})
    sb = init_galaxy(n_main, SEED, dtype=bf16, device=dev)
    sb = max((sb.repad(256 * d) for d in ds), key=lambda s: s.npad)
    check(ref11[0].shape[0] >= sb.npad, f"the float64 sweep has "
          f"{ref11[0].shape[0]} rows, the layouts pad to {sb.npad}")
    q = [v.double() for v in (sb.qx, sb.qy, sb.qz, gm_of(sb))]
    parts = [acc_tile_rect_plain(*(v[i:i + 8192] for v in q[:3]), *q, SOFT)
             for i in range(0, sb.npad, 8192)]
    for prec, r in (("fp32", ref11), ("bf16", [
            torch.cat([p[c] for p in parts]) for c in range(3)])):
        torch.save(torch.stack(list(r)).cpu(),
                   os.path.join(work, f"ref64_{prec}.pt"))
    del sb, q, parts
    one = {}
    for d in ds:
        for prec, dtype in (("fp32", torch.float32), ("bf16", bf16)):
            st = init_galaxy(n_main, SEED, dtype=dtype, device=dev)
            mesh = make_mesh(devices=[dev] * d)
            blocks = shard_state(st.repad(256 * d), mesh)
            qs = [(b.qx, b.qy, b.qz) for b in blocks]
            gs = [gm_of(b) for b in blocks]
            sums = ring_ops.ring_sums(mesh, qs, gs, SOFT)
            one[d, prec] = time_ms(
                lambda: ring_ops.ring_sums(mesh, qs, gs, SOFT), reps=3,
                runs=3)
            eng = create_engine("shard+ring", st, soft=SOFT, dt=DT,
                                devices=[dev] * d)
            eng.run(3)
            torch.save({"sums": torch.stack(sums).cpu(),
                        "engine": torch.stack([torch.stack(
                            [getattr(b, k) for k in RING_FIELDS])
                            for b in eng.blocks]).cpu()},
                       os.path.join(work, f"ref_{d}_{prec}.pt"))
            del eng, blocks, qs, gs, sums
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump({"n": n_main}, f)
    t_ref = time.perf_counter() - t_phase
    env = {k: v for k, v in os.environ.items() if not k.startswith("MURB_")}
    results, groups = [], {}
    for nproc, hosts, ls in RING_LAYOUTS:
        groups.setdefault(nproc, []).extend(
            ring_layout_name(nproc, hosts, l) for l in ls)
    for nproc, lays in groups.items():
        with socket.socket() as so:
            so.bind(("localhost", 0))
            port = so.getsockname()[1]
        logs = [os.path.join(work, f"worker_{nproc}_{r}.log")
                for r in range(nproc)]
        procs = []
        t1 = time.perf_counter()
        try:
            for r, log in enumerate(logs):
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__),
                         "--ring-worker", str(r), str(nproc), str(port),
                         work], stdout=f, stderr=subprocess.STDOUT, env=env,
                        cwd=ROOT))
            # a hard limit for the group; one failure stops the others
            deadline = time.monotonic() + 60 + 60 * len(lays)
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(
                        p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for log in logs:
            with open(log) as f:
                texts.append(f.read())
        check(all(p.returncode == 0 for p in procs),
              f"ring workers of {nproc} processes (killed at the time limit "
              f"or after another failed):\n" + "\n".join(
                  f"-- worker {r} exit {p.returncode}:\n{t[-2000:]}"
                  for r, (p, t) in enumerate(zip(procs, texts))))
        for r, text in enumerate(texts):
            line = [x for x in text.splitlines()
                    if x.startswith("RING_RESULT ")]
            check(len(line) == 1, f"ring worker {r} of {nproc}: no result")
            for res in json.loads(line[0].split(" ", 1)[1]):
                res["hosts"] = tuple(res["hosts"]) if res["hosts"] else None
                results.append(res)
        print(f"[11 processes] {nproc} processes on cuda:0, layouts "
              f"{'; '.join(lays)}: {time.perf_counter() - t1:.1f} s with "
              f"start-up")
    launches, by = {}, {}
    for nproc, hosts, ls in RING_LAYOUTS:
        for l in ls:
            d = nproc * l
            lay = ring_layout_name(nproc, hosts, l)
            for prec in ("fp32", "bf16"):
                rs = [r for r in results if (r["p"], r["hosts"], r["l"],
                                             r["prec"]) == (nproc, hosts, l,
                                                            prec)]
                check(sorted(r["rank"] for r in rs) == list(range(nproc)),
                      f"K14 across processes {lay} {prec}: results of "
                      f"ranks {[r['rank'] for r in rs]}")
                nd = rs[0]["npad"]
                err = max(r["err"] for r in rs)
                ms = max(r["ms"] for r in rs)
                by[nproc, hosts, l, prec] = ms
                n_launch = sum(r["launches"] for r in rs)
                split = ring_ops.ring_split(
                    nd // d, torch.cuda.get_device_properties(
                        dev).multi_processor_count,
                    ring_ops.cuda.resident(
                        "murb_tile_resident"
                        + ("_bf16" if prec == "bf16" else ""), dev), d)
                note = ""
                if (nproc, hosts, l) in (RING_MAIN, RING_HOSTS_MAIN):
                    plain = max(r["plain_ms"] for r in rs)
                    name = ("K14-hosts" if hosts else "K14-ipc") + (
                        "-bf16" if prec == "bf16" else "")
                    b_ms = keep(name, err, ms, plain,
                                (20 if prec == "bf16" else 28) * nd,
                                20 * nd * nd)
                    launches[name] = n_launch
                    note = (f"; plain across processes {plain:.4f} ms at "
                            f"{max(r['plain_w'] for r in rs):.4f} of its "
                            f"allowance; bound {b_ms:.4f} ms")
                if "turns" in rs[0]:
                    turns = [max(r["turns"][i] for r in rs) for i in range(4)]
                    note += ("; in turns with the IPC ring of the same "
                             "processes on one host (IPC, staged, staged, "
                             "IPC; the slowest process) " + ", ".join(
                                 f"{t:.4f}" for t in turns) + " ms")
                if hosts:
                    staged = len([1 for i in range(nproc)
                                  if hosts[i] != hosts[(i + 1) % nproc]])
                    nb = (d - 1) * 4 * (2 * ring_ops.slot_stride(nd // d)
                                        if prec == "bf16" else 4 * nd // d)
                    ipc_ms = by.get((nproc, None, l, prec))
                    note += (f"; {staged} staged boundaries, {nb} bytes "
                             f"staged a boundary a call ((D-1) x one slot); "
                             f"one host's IPC ring at the same P x L "
                             + (f"{ipc_ms:.4f} ms" if ipc_ms else
                                "not run") + " (this run)")
                    delays = (f"{RING_DELAY_NS} ns in process 0, then in "
                              f"process {nproc - 1} only, and "
                              f"{RING_HOST_DELAY_NS} ns before every send "
                              f"of process {nproc - 1}'s agent")
                else:
                    delays = (f"{RING_DELAY_NS} ns in process 0, then in "
                              f"process {nproc - 1} only")
                print(f"[11 K14 across processes {lay} {prec}] N={nd}, "
                      f"D={d}, {split[0]} j slices a sweep: every shard's "
                      f"sums bit for bit the one-process K14's at D={d}, 3 "
                      f"calls each with no delay and with {delays}; "
                      f"against float64 WithinRel 1e-5 (rms floor 5e-6) at "
                      f"{max(r['w64'] for r in rs):.4f}, max|da| {err:.3e};"
                      f" 3 shard+ring steps bit for bit the one-process "
                      f"engine's, {n_launch} launches (all processes); time "
                      f"a call " + ", ".join(
                          f"{r['ms']:.4f}" for r in sorted(
                              rs, key=lambda r: r['rank']))
                      + f" ms (by process) against one process at D={d} "
                      f"{one[d, prec]:.4f} ms: time-sliced contexts on one "
                      f"card, not a link{note} on {smi}")
    print(f"[11 processes] references {t_ref:.1f} s, the phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from murb_tpu_torch import G
    from murb_tpu_torch import cli
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.core.init import (init_galaxy,
                                          init_milkyway_andromeda,
                                          init_random,
                                          milkyway_andromeda_masks)
    from murb_tpu_torch.core.metrics import energy_from_phi
    from murb_tpu_torch.ops import cuda
    from murb_tpu_torch.ops import fmm_kernels as fk
    from murb_tpu_torch.ops.anterp_kernels import l2p_window, p2m_window
    from murb_tpu_torch.ops.hybrid import (acc_hybrid_fast_plain,
                                           acc_hybrid_rect,
                                           acc_hybrid_rect_plain,
                                           acc_phi_rows_hybrid,
                                           acc_phi_rows_plain,
                                           ext_split_args, fast_split_args,
                                           phi_rows,
                                           phi_rows_rect,
                                           phi_rows_rect_plain,
                                           phi_split_args)
    from murb_tpu_torch.ops.proxy import acc_proxy, bounding_box, heavy_split
    from murb_tpu_torch.ops.p2p_kernels import p2p_sweep_kernel_sorted
    from murb_tpu_torch.ops import proxy_kernels as tk
    from murb_tpu_torch.ops.proxy_kernels import (l2p_fused_multi, l2p_plain,
                                                  p2m_fused, p2m_plain)
    from murb_tpu_torch.ops.tile import acc_tile_rect, acc_tile_rect_plain
    from murb_tpu_torch.ops.validate import measured_force_error
    from murb_tpu_torch.utils.profile_step import graph_ms

    # The plain versions' matrix products run in full fp32, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(dev)

    # ---------------------------------------------------- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if os.path.exists(
            "/usr/local/cuda/bin/nvcc") else "absent")
    print(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name!r} count {torch.cuda.device_count()} nvcc {nvcc} "
          f"triton {triton_v}")
    print(smi)

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib_path = cuda.build_kernels()
    cuda.library()
    print(f"[2 build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line or "Used" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                print(f"[2 ptxas] {line.strip()}")

    time_ms = event_ms

    def norm_rel(got, ref) -> float:
        """Max per-body force error over max(|a_ref|, 1e-6 max |a_ref|)
        (the ops/validate statistic)."""
        g = torch.stack([v.double() for v in got], 1)
        r = torch.stack([v.double() for v in ref], 1)
        rn = r.norm(dim=1)
        floor = torch.clamp(rn, min=1e-6 * float(rn.max()))
        return float(((g - r).norm(dim=1) / floor).max())

    record = {}

    def keep(k, err, ms, plain_ms, nbytes, flops, bound_ms=None):
        b_ms, b_by = bound(nbytes, flops)
        if bound_ms is not None:    # K5, K6, K13: their MUFU floor and more
            b_ms, b_by = max(b_ms, bound_ms), "operations"
        # no single PyTorch call computes any of these kernels' functions
        record[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        return b_ms

    # ------------------------------------------------- 3. kernel parity
    n_main = 200_000
    st = init_galaxy(n_main, SEED, device=dev)
    gm = st.m * torch.tensor(G, dtype=torch.float32).item()
    c, h = bounding_box(st.qx, st.qy, st.qz, gm > 0)
    mean_gm = gm.sum() / (gm > 0).sum()
    gm_eff = heavy_split(st.qx, st.qy, st.qz, gm, 1, 100.0, mean_gm)[4]
    q64 = [v.double() for v in (st.qx, st.qy, st.qz)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # K1 and K2 alone: float32 inputs and the (6,) box as the wrappers
    # hand them, the run's items and node table built (cached) beforehand
    box = torch.cat([c.reshape(3), h.reshape(3)]).float()
    for m in (12, 20):
        w = p2m_fused(st.qx, st.qy, st.qz, gm_eff, c, h, m=m)
        w64 = p2m_plain(*q64, gm_eff.double(), c.double(), h.double(), m=m)
        err_w = float((w.double() - w64).abs().max())
        scale_w = float(w64.abs().max())
        check(bool(torch.allclose(w.double(), w64, rtol=1e-4,
                                  atol=1e-6 * scale_w)),
              f"K1 m={m}: max|dW| {err_w:.3e} vs rtol 1e-4, atol "
              f"1e-6*max|W| ({1e-6 * scale_w:.3e})")
        check(torch.equal(w, p2m_fused(st.qx, st.qy, st.qz, gm_eff, c, h,
                                       m=m)), f"K1 m={m}: two launches differ")
        ms = time_ms(lambda: p2m_fused(st.qx, st.qy, st.qz, gm_eff, c, h,
                                       m=m))
        alone = graph_ms(lambda: tk.p2m_launch(st.qx, st.qy, st.qz, gm_eff,
                                               box, m))
        plain_ms = time_ms(lambda: p2m_plain(st.qx, st.qy, st.qz, gm_eff, c,
                                             h, m=m))
        # per body: the contraction (2 m^3) and three bases (~6 m^2)
        nbytes, flops = 16 * n_main + 4 * m ** 3, \
            n_main * (2 * m ** 3 + 6 * m ** 2)
        b_ms = bound(nbytes, flops)[0]
        run = tk.one_run(n_main, m, dev)
        print(f"[3 K1 p2m m={m} N={n_main}] max|dW| {err_w:.3e} "
              f"(max|W| {scale_w:.3e}, tol rtol 1e-4 + 1e-6*max|W|); the "
              f"same bits twice; {run.nitems} items of {run.chunk} bodies; "
              f"kernel {ms:.4f} ms through the wrapper, alone {alone:.4f} "
              f"({b_ms / alone:.3f} of the bound {b_ms:.4f}), plain "
              f"{plain_ms:.4f} ms")
        if m == 12:
            keep("K1", err_w, ms, plain_ms, nbytes, flops)

        # k=3: the force; 4: force + potential (tpu+tracking); 5: force + 2
        # galaxy potentials; 11: force + 8 (the most; groups of at most 4
        # fields a launch)
        for k in ((3, 4, 5, 11) if m == 12 else (3,)):
            fields = tuple(torch.randn(m ** 3, generator=gen, device=dev)
                           for _ in range(k))
            a = torch.stack(l2p_fused_multi(st.qx, st.qy, st.qz, c, h,
                                            fields, m=m))
            a64 = torch.stack(l2p_plain(*q64, c.double(), h.double(),
                                        tuple(f.double() for f in fields),
                                        m=m))
            err_a = float((a.double() - a64).abs().max())
            scale_a = float(a64.abs().max())
            check(bool(torch.allclose(a.double(), a64, rtol=1e-4,
                                      atol=1e-5 * scale_a)),
                  f"K2 m={m} k={k}: max|da| {err_a:.3e} vs rtol 1e-4, atol "
                  f"1e-5*max|a| ({1e-5 * scale_a:.3e})")
            check(torch.equal(a, torch.stack(l2p_fused_multi(
                st.qx, st.qy, st.qz, c, h, fields, m=m))),
                f"K2 m={m} k={k}: two launches differ")
            ms = time_ms(lambda: l2p_fused_multi(st.qx, st.qy, st.qz, c, h,
                                                 fields, m=m))
            alone = graph_ms(lambda: tk.l2p_launch(st.qx, st.qy, st.qz, box,
                                                   m, fields))
            plain_ms = time_ms(lambda: l2p_plain(st.qx, st.qy, st.qz, c, h,
                                                 fields, m=m))
            nbytes = 12 * n_main + 4 * k * (m ** 3 + n_main)
            flops = n_main * (2 * k * m ** 3 + 6 * m ** 2)
            b_ms = bound(nbytes, flops)[0]
            print(f"[3 K2 l2p m={m} N={n_main} k={k}] max|da| {err_a:.3e} "
                  f"(max|a| {scale_a:.3e}, tol rtol 1e-4 + 1e-5*max|a|); "
                  f"the same bits twice; {-(-k // 4)} launches; kernel "
                  f"{ms:.4f} ms through the wrapper, alone {alone:.4f} "
                  f"({b_ms / alone:.3f} of the bound {b_ms:.4f}), plain "
                  f"{plain_ms:.4f} ms")
            if (m, k) == (12, 3):
                keep("K2", err_a, ms, plain_ms, nbytes, flops)

    sr = init_random(16_300, SEED, device=dev)      # npad 16384, 84 ghosts
    gr = sr.m * torch.tensor(G, dtype=torch.float32).item()
    jset = (sr.qx, sr.qy, sr.qz, gr)
    j64 = tuple(v.double() for v in jset)
    # K3 at the default geometry; 8000^2 is the shape of the m=20 node
    # sweep (phase 5).  Until its blocks fill the card's resident slots
    # four times K3 splits its j range (ops/cuda.tile_split); two launches
    # must give the same bits.
    sms = cuda.sm_count(dev)
    resident = cuda.resident("murb_tile_resident", dev)
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    print(f"[3 K3 geometry] {cuda.TILE_BLOCK_I}x{cuda.TILE_BLOCK_J}: "
          f"{resident} resident blocks an SM (occupancy), {sms} SMs")
    for label, ni, nj in (("square 16384x16384", sr.npad, sr.npad),
                          ("rect 5000x16384", 5000, sr.npad),
                          ("square 8000x8000", 8000, 8000)):
        iset = (sr.qx[:ni], sr.qy[:ni], sr.qz[:ni])
        js = tuple(v[:nj] for v in jset)
        got = acc_tile_rect(*iset, *js, SOFT)
        again = acc_tile_rect(*iset, *js, SOFT)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K3 {label}: two launches differ")
        ref = acc_tile_rect_plain(*(v.double() for v in iset),
                                  *(v[:nj] for v in j64), SOFT)
        worst = within_rel(got, ref, 5e-6, 5e-6)
        err = max(float((g.double() - r).abs().max())
                  for g, r in zip(got, ref))
        check(worst <= 1.0, f"K3 {label}: WithinRel 5e-6 (rms floor 5e-6) "
                            f"exceeded by {worst:.2f}x")
        ms = time_ms(lambda: acc_tile_rect(*iset, *js, SOFT))
        plain_ms = time_ms(lambda: acc_tile_rect_plain(*iset, *js, SOFT),
                           reps=3)
        b_ms = bound(24 * ni + 16 * nj, 20 * ni * nj)[0]
        print(f"[3 K3 tile {label}] "
              f"{cuda.tile_split(ni, nj, sms, resident)[0]} "
              f"j slices; max|da| {err:.3e} WithinRel 5e-6 (rms floor "
              f"5e-6) at {worst:.3f} of the allowance; the same bits twice; "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
              f"{b_ms:.4f} ms")
        if ni == sr.npad:
            # 20 flops a pair: the reference's model
            keep("K3", err, ms, plain_ms, 40 * ni, 20 * ni * ni)

    def acc_hybrid_split(n):
        """Passes 3's j slices at n x n (its own resident count)."""
        return ext_split_args(n, n, 0, 0, dev)[0][0]

    def k4_whole(q, g):
        """K4 passes 2 in one j slice at 128x128: the fp32 sum with no
        split, the first design's bits.  Through the C entry, so it counts
        no launch."""
        n = q[0].shape[0]
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        cuda.launch("murb_hybrid_rect", *(v.data_ptr() for v in q), n,
                    *(v.data_ptr() for v in q), g.data_ptr(), n,
                    ctypes.c_float(SOFT ** 2), 2, 128, 128, 1, -(-n // 128),
                    None, *(o.data_ptr() for o in out), cuda.stream(dev))
        return list(out)

    # passes 2 runs K3's fp32 kernel (passes 1, its own kernel, below);
    # passes 3 runs K3's sweep in its
    # extended tier (runs of 4 sources in fp32 folded into fp64, fp64 j
    # slices).  On this input the fp32 tier reads under 1e-6, and how far
    # under moves with K3's j split, which can take it below passes 3's
    # limit.  So the tiers are told apart against the fp32 sum with no
    # split: passes 3 must read at most half of its error (a passes-3
    # launch that ran the fp32 code fails that).  Passes 3 launches twice
    # for the same bits.  Its bound counts its own work (ext_bound_ms).
    ref = acc_tile_rect_plain(*j64[:3], *j64, SOFT)
    rels, sums = {}, {}
    for passes, contract in ((2, 3e-5), (3, 4e-7)):
        got = sums[passes] = acc_hybrid_rect(*jset[:3], *jset, SOFT,
                                             passes=passes)
        rel = rels[passes] = norm_rel(got, ref)
        err = max(float((g.double() - r).abs().max())
                  for g, r in zip(got, ref))
        check(rel <= contract, f"K4 passes={passes}: max relative force "
                               f"error {rel:.3e} > {contract:g}")
        ms = time_ms(lambda: acc_hybrid_rect(*jset[:3], *jset, SOFT,
                                             passes=passes))
        plain_ms = time_ms(lambda: acc_hybrid_rect_plain(
            *jset[:3], *jset, SOFT, passes=passes), reps=3)
        note = ""
        if passes == 3:
            again = acc_hybrid_rect(*jset[:3], *jset, SOFT, passes=3)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  "K4 passes=3: two launches differ")
            floors = ext_bound_ms(sr.npad, sr.npad, sms, clk)
            b4 = keep("K4", err, ms, plain_ms, 40 * sr.npad,
                      20 * sr.npad ** 2,
                      max(floors["mufu"], floors["f2f"], floors["dadd"]))
            note = (f" bound {b4:.4f} ms (" + ", ".join(
                f"{k} {v:.4f}" for k, v in floors.items())
                + f" at {clk / 1e6:.0f} MHz), in "
                f"{acc_hybrid_split(sr.npad)} j slices; the same bits "
                f"twice; on {smi}")
        print(f"[3 K4 hybrid passes={passes} N=16384] max rel force err "
              f"{rel:.3e} (contract {contract:g}) max|da| {err:.3e}; "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{note}")
    rel_whole = norm_rel(k4_whole([v.contiguous() for v in jset[:3]],
                                  jset[3].contiguous()), ref)
    check(rels[3] <= 0.5 * rel_whole,
          f"K4 passes=3 error {rels[3]:.3e} is not at most half of the "
          f"unsplit fp32 sum's {rel_whole:.3e}")
    print(f"[3 K4 tiers N=16384] passes 2 unsplit (128x128, one slice) "
          f"{rel_whole:.3e}, in K3's split "
          f"{cuda.tile_split(sr.npad, sr.npad, sms, resident)[0]} slices "
          f"{rels[2]:.3e}; passes 3 {rels[3]:.3e}, at most half the "
          f"unsplit reading")

    # K4 passes 1, its own kernel (csrc/hybrid_fast.cu), at 16384^2:
    # against its plain version on the card, the same TF32 arithmetic
    # (where the card's rsqrt and torch's differ in the last bit, a W next
    # to a rounding tie takes the other TF32 neighbour: each body within
    # one TF32 ulp, 1e-3, and the rms over the bodies within 2e-5, as
    # K13's "default"); against float64 within the tier's 5.1e-3
    # (tests/test_oracle.py:162-165); twice for the same bits; in turns
    # with K3 (K3, p1, p1, K3).  Bound: the larger of its MUFU floor and
    # its issue floor at its own instruction count (fast_bound_ms).
    ns = sr.npad
    fast = lambda: acc_hybrid_rect(*jset[:3], *jset, SOFT, passes=1)
    k3f = lambda: acc_tile_rect(*jset[:3], *jset, SOFT)
    got = fast()
    check(all(torch.equal(a, b) for a, b in zip(got, fast())),
          "K4 passes=1: two launches differ")
    worst_p, rms_p = body_errs(got, acc_hybrid_fast_plain(*jset[:3], *jset,
                                                          SOFT))
    check(worst_p <= 1e-3 and rms_p <= 2e-5,
          f"K4 passes=1 vs its plain version: max {worst_p:.3e} (tol "
          f"1e-3), rms {rms_p:.3e} (tol 2e-5)")
    rel_p1 = norm_rel(got, ref)
    check(rel_p1 <= 5.1e-3, f"K4 passes=1: max relative force error "
                            f"{rel_p1:.3e} > 5.1e-3")
    err_p1 = max(float((g.double() - r).abs().max())
                 for g, r in zip(got, ref))
    t_k3a, t_p1a, t_p1b, t_k3b = (time_ms(f) for f in (k3f, fast, fast, k3f))
    ms_p1 = statistics.median((t_p1a, t_p1b))
    plain_p1 = time_ms(lambda: acc_hybrid_fast_plain(*jset[:3], *jset,
                                                     SOFT), reps=3)
    floors = fast_bound_ms(ns, ns, sms, clk)
    b_p1 = keep("K4-p1", err_p1, ms_p1, plain_p1, 40 * ns, 20 * ns * ns,
                max(floors.values()))
    print(f"[3 K4 hybrid passes=1 N={ns}] its own kernel (resident "
          f"{cuda.resident('murb_hybrid_fast_resident', dev)} blocks an SM "
          f"at 256x256, j split {fast_split_args(ns, ns, 0, 0, dev)[0][:2]}"
          f"): vs its plain version max {worst_p:.3e} (tol 1e-3) rms "
          f"{rms_p:.3e} (tol 2e-5); max rel force err {rel_p1:.3e} (contract"
          f" 5.1e-3; passes 2 {rels[2]:.3e}) max|da| {err_p1:.3e}; the same "
          f"bits twice; in turns K3, p1, p1, K3: {t_k3a:.4f}, {t_p1a:.4f}, "
          f"{t_p1b:.4f}, {t_k3b:.4f} ms; plain {plain_p1:.4f} ms; bound "
          f"{b_p1:.4f} ms (" + ", ".join(f"{k} {v:.4f}"
                                         for k, v in floors.items())
          + f" at {clk / 1e6:.0f} MHz) on {smi}")
    del st, sr, w64, a64, ref, sums

    # K5 and K6 at the merger's shape, 81,920^2: R = 2 (the merger's two
    # galaxy rows; the kernels' record), R = 1 (the total G*m row of the
    # exact tpu+tracking) and R = 8 (the largest instance: the galaxies,
    # the total and 5 seeded random masks).  The float64 reference takes
    # 4096 strided i-rows against every source (as ops/validate samples);
    # the plain versions are timed at the full shape.  Contracts: phi
    # within 1e-5 relative per element, the force within K4 passes 2's
    # 3e-5.  Both run K3's register-tiled sweep with R weight rows
    # (csrc/tile.cuh), so at K6's geometry and j split K6's force must be
    # K3's bits (K3's C entry) and K5's rows K6's (K5's C entry at K6's
    # split; its wrapper may split otherwise).  Each kernel launches twice
    # for the same bits.  Bound: the larger of the fp32 operations (K5 10 +
    # 2R flops a pair, K6 20 + 2R) and the MUFU floor (one rsqrt a pair at
    # 16 a clock an SM, the card's SMs at clocks.max.sm).
    tmpdir = tempfile.TemporaryDirectory()      # removed at exit
    tab = os.path.join(tmpdir.name, "milkyway_andromeda.tab")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                 "make_two_galaxy_tab.py"),
                    tab], check=True, capture_output=True, timeout=300)
    mg = init_milkyway_andromeda(tab, device=dev)
    print(f"[3 merger] {mg.n} bodies from scripts/make_two_galaxy_tab.py in "
          f"{time.perf_counter() - t0:.1f} s")
    masks = milkyway_andromeda_masks(mg.npad, mg.n)
    gmg = mg.m * torch.tensor(G, dtype=torch.float32).item()
    mask_t = [torch.as_tensor(mk, device=dev) for mk in masks]
    qm = (mg.qx, mg.qy, mg.qz)
    nm = mg.npad
    idx = torch.linspace(0, nm - 1, 4096, device=dev).long()
    qm64 = tuple(v.double() for v in qm)
    qs64 = tuple(v[idx] for v in qm64)
    ref_acc = acc_tile_rect_plain(*qs64, *qm64, gmg.double(), SOFT)
    mufu_ms = float(nm) * nm / (16 * sms * clk) * 1e3

    def merger_rows(nr):
        if nr == 1:
            return gmg[None, :].contiguous()
        out = [mask_t[0] * gmg, mask_t[1] * gmg]
        if nr > 2:
            g8 = torch.Generator(device=dev).manual_seed(SEED)
            out.append(gmg)
            out += [(torch.rand(nm, generator=g8, device=dev) < 0.5).float()
                    * gmg for _ in range(nr - 3)]
        return torch.stack(out[:nr]).contiguous()

    def phi_c_entry(rows_r, split):
        """K5 through its C entry at ``split`` (counts no launch)."""
        out = torch.empty((rows_r.shape[0], nm), dtype=torch.float32,
                          device=dev)
        cuda.launch("murb_phi_rows_rect", *(v.data_ptr() for v in qm), nm,
                    *(v.data_ptr() for v in qm), nm, rows_r.data_ptr(),
                    rows_r.shape[0], ctypes.c_float(SOFT ** 2), *split,
                    out.data_ptr(), cuda.stream(dev))
        return out

    def k3_c_entry(bi, bj, slices, per):
        """K3 through its C entry at K6's geometry and split."""
        out = torch.empty((3, nm), dtype=torch.float32, device=dev)
        scr = torch.empty((slices, 3, nm), dtype=torch.float32, device=dev)
        cuda.launch("murb_tile_rect", *(v.data_ptr() for v in qm), nm,
                    *(v.data_ptr() for v in qm), gmg.data_ptr(), nm,
                    ctypes.c_float(SOFT ** 2), bi, bj, slices, per,
                    scr.data_ptr() if slices > 1 else None,
                    *(o.data_ptr() for o in out), cuda.stream(dev))
        return out

    for r in (2, 1, 8):
        rows = merger_rows(r)
        ref_phi = phi_rows_rect_plain(*qs64, *qm64, rows.double(), SOFT)

        def phi_err(phi):
            d = phi[:, idx].double() - ref_phi
            return float(d.abs().max()), float((d.abs() / ref_phi.abs())
                                               .max())

        phi = phi_rows(*qm, rows, SOFT)
        check(torch.equal(phi, phi_rows(*qm, rows, SOFT)),
              f"K5 R={r}: two launches differ")
        err5, rel5 = phi_err(phi)
        check(rel5 <= 1e-5, f"K5 R={r}: max relative phi error {rel5:.3e} "
                            f"> 1e-5")
        acc6, phi6 = acc_phi_rows_hybrid(*qm, gmg, rows, SOFT)
        acc6b, phi6b = acc_phi_rows_hybrid(*qm, gmg, rows, SOFT)
        check(all(torch.equal(a, b) for a, b in zip((*acc6, phi6),
                                                     (*acc6b, phi6b))),
              f"K6 R={r}: two launches differ")
        rel6 = norm_rel([a[idx] for a in acc6], ref_acc)
        err6, prel6 = phi_err(phi6)
        check(rel6 <= 3e-5, f"K6 R={r}: max relative force error {rel6:.3e} "
                            f"> 3e-5")
        check(prel6 <= 1e-5, f"K6 R={r}: max relative phi error {prel6:.3e} "
                             f"> 1e-5")
        erra6 = max(float((a[idx].double() - b).abs().max())
                    for a, b in zip(acc6, ref_acc))
        (bi6, bj6, sl6, per6, _), scr6 = phi_split_args(nm, nm, r, True, 0,
                                                        0, dev)
        a3 = k3_c_entry(bi6, bj6, sl6, per6)
        check(all(torch.equal(a, b) for a, b in zip(acc6, a3)),
              f"K6 R={r}: the force is not K3's bit for bit at {bi6}x{bj6} "
              f"in {sl6} slices")
        scr5 = torch.empty((sl6, r, nm), dtype=torch.float32, device=dev)
        phi5 = phi_c_entry(rows, (bi6, bj6, sl6, per6,
                                  scr5.data_ptr() if sl6 > 1 else None))
        check(torch.equal(phi5, phi6),
              f"K5 R={r}: phi is not K6's bit for bit at K6's geometry "
              f"and split")
        split5 = phi_split_args(nm, nm, r, False, 0, 0, dev)[0]
        ms5 = time_ms(lambda: phi_rows(*qm, rows, SOFT), reps=5)
        ms6 = time_ms(lambda: acc_phi_rows_hybrid(*qm, gmg, rows, SOFT),
                      reps=5)
        plain5 = time_ms(lambda: phi_rows_rect_plain(*qm, *qm, rows, SOFT),
                         reps=1, runs=3 if r == 2 else 1)
        plain6 = time_ms(lambda: acc_phi_rows_plain(*qm, gmg, rows, SOFT),
                         reps=1, runs=3 if r == 2 else 1)
        bytes5, flops5 = (24 + 8 * r) * nm, (10 + 2 * r) * nm * nm
        bytes6, flops6 = (28 + 8 * r) * nm, (20 + 2 * r) * nm * nm
        if r == 2:
            b5 = keep("K5", err5, ms5, plain5, bytes5, flops5, mufu_ms)
            b6 = keep("K6", erra6, ms6, plain6, bytes6, flops6, mufu_ms)
        else:
            b5 = max(bound(bytes5, flops5)[0], mufu_ms)
            b6 = max(bound(bytes6, flops6)[0], mufu_ms)
        print(f"[3 K5 phi_rows {nm}x{nm} R={r}] {split5[0]}x{split5[1]} in "
              f"{split5[2]} slices; max rel phi err {rel5:.3e} (contract "
              f"1e-5) max|dphi| {err5:.3e}; the same bits twice; at K6's "
              f"geometry and split K6's bits; kernel {ms5:.4f} ms plain "
              f"{plain5:.4f} ms bound {b5:.4f} ms (MUFU {mufu_ms:.4f} at "
              f"{clk / 1e6:.0f} MHz, fp32 {flops5 / PEAK_FP32 * 1e3:.4f})")
        print(f"[3 K6 acc_phi_rows {nm}x{nm} R={r}] {bi6}x{bj6} in {sl6} "
              f"slices; max rel force err {rel6:.3e} (contract 3e-5) max|da| "
              f"{erra6:.3e}; max rel phi err {prel6:.3e} (contract 1e-5) "
              f"max|dphi| {err6:.3e}; the same bits twice; force K3's bit "
              f"for bit; kernel {ms6:.4f} ms plain {plain6:.4f} ms bound "
              f"{b6:.4f} ms (fp32 {flops6 / PEAK_FP32 * 1e3:.4f}, MUFU "
              f"{mufu_ms:.4f})")
        del ref_phi, acc6, phi6, acc6b, phi6b, phi, phi5, a3, scr5, scr6
    del ref_acc
    torch.cuda.empty_cache()

    # ------------------------------------------------- 4. the main path
    wrappers = {"K1": p2m_fused, "K2": l2p_fused_multi, "K3": acc_tile_rect,
                "K4": acc_hybrid_rect, "K5": phi_rows_rect,
                "K6": acc_phi_rows_hybrid, "K7": fk.m2l_level_fused,
                "K8": fk.p2m_grid_fused, "K9": fk.l2p_grid_fused,
                "K10": p2p_sweep_kernel_sorted, "K11": p2m_window,
                "K12": l2p_window}

    def drive(run):
        """Zero every launch count, run one piece of the path, and return
        its result with the counts it left: each wrapper's ``launches``
        (K13 and K14 join ``wrappers`` in their phases), K7b's, K7's
        lossy instance, which counts on K7's wrapper, K4's passes 1
        (its own kernel, counted apart on K4's wrapper) and the bf16
        instances'."""
        counters = {k: (fn, "launches") for k, fn in wrappers.items()}
        counters["K7b"] = (fk.m2l_level_fused, "lossy_launches")
        counters["K4-p1"] = (acc_hybrid_rect, "fast_launches")
        counters["K4-p1-bf16"] = (acc_hybrid_rect, "fast_bf16_launches")
        for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K8", "K9", "K10",
                  "K11", "K12", "K13", "K14"):           # bf16 (phase 15)
            if k in wrappers:
                counters[f"{k}-bf16"] = (wrappers[k], "bf16_launches")
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        out = run()
        return out, {k: getattr(fn, attr)
                     for k, (fn, attr) in counters.items()}

    res, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "100", "--im", "tpu+proxy", "--nv", "--gf",
        "--scan", "--device", "cuda"]))
    check(res.rc == 0, f"cli exit code {res.rc}")
    eng = res.engine
    eng.assert_finite()
    fp32_bytes = eng.allocated_bytes
    launches = {k: counts[k] for k in ("K1", "K2")}
    check(eng.using_proxy, "tpu+proxy fell back to the exact sweep")
    check(eng.validated_err is not None and eng.validated_err <= TOL,
          f"validated error {eng.validated_err} > {TOL}")
    fin = eng.bodies
    gm_fin = eng._gm(fin)
    err_end = measured_force_error(
        fin.qx, fin.qy, fin.qz, gm_fin, SOFT,
        lambda a, b, cc, g: acc_proxy(a, b, cc, g, SOFT, m=eng.m))
    print(f"[4 main] tpu+proxy N={n_main} galaxy: m={eng.m} "
          f"cells={eng.cells} validated_err {eng.validated_err:.3e} "
          f"(err after 100 steps {err_end:.3e}, reported, not a contract); "
          f"{res.fps:.2f} FPS "
          f"{res.gflops:.1f} ref-GFlop/s ({res.elapsed_ms:.2f} ms for 99 "
          f"steps) on {smi}; launches {counts}")

    # small input: the card's trajectory agrees with the CPU plain path
    small = init_galaxy(2048, SEED, device="cpu")
    runs = []
    for d in ("cpu", dev):
        e = create_engine("tpu+proxy", small.to(d), soft=SOFT, dt=3600.0)
        e.run(3)
        runs.append((e.m, e.bodies.unpadded()))
    check(runs[0][0] == runs[1][0], f"m differs: cpu {runs[0][0]} "
                                    f"card {runs[1][0]}")
    worst = max(float(np.max(np.abs(runs[1][1][k] - runs[0][1][k])
                             / np.maximum(np.abs(runs[0][1][k]), 1e-30)))
                for k in ("qx", "qy", "qz"))
    check(worst <= 1e-4, f"card vs cpu positions differ by {worst:.3e}")
    print(f"[4 small] N=2048 galaxy, 3 steps: card vs CPU plain path "
          f"positions max rel diff {worst:.3e} (tol 1e-4), m={runs[0][0]}")

    # ------------------------------------------- 5. K3 inside acc_proxy
    err20, counts = drive(lambda: measured_force_error(
        fin.qx, fin.qy, fin.qz, gm_fin, SOFT,
        lambda a, b, cc, g: acc_proxy(a, b, cc, g, SOFT, m=20)))
    launches["K3"] = counts["K3"]
    check(err20 <= TOL, f"acc_proxy m=20 force error {err20:.3e} > {TOL}")
    print(f"[5 K3 path] acc_proxy m=20 (8000 nodes) force error {err20:.3e}; "
          f"launches {counts}")

    # ------------------------------------------- 6. K4 through the CLI
    # tpu+hybrid+fast takes passes 1, its own kernel, and must launch no K3
    # sweep (K3's wrapper or K4's passes 2/3 entry); fp32 state takes
    # passes 2 (K3's kernel, launched by K4's wrapper); tpu+hybrid+x3
    # takes passes 3, K4's own kernel, whose count is kept.
    for tag in ("tpu+hybrid+fast", "tpu+hybrid", "tpu+hybrid+x3"):
        res6, counts = drive(lambda: cli.run([
            "-n", "30000", "-i", "10", "--im", tag, "--nv", "--gf",
            "--device", "cuda"]))
        check(res6.rc == 0, f"cli {tag} exit code {res6.rc}")
        res6.engine.assert_finite()
        if tag == "tpu+hybrid+fast":
            check(counts["K4-p1"] > 0 and counts["K3"] == 0
                  and counts["K4"] == 0,
                  f"tpu+hybrid+fast did not run passes 1's kernel alone: "
                  f"{counts}")
            launches["K4-p1"] = counts["K4-p1"]
        else:
            check(counts["K4"] > 0, f"K4 launched no time under {tag}")
        print(f"[6 K4 path] {tag} N=30000 (passes {res6.engine.passes}): "
              f"{res6.fps:.2f} FPS {res6.gflops:.1f} ref-GFlop/s on {smi}; "
              f"launches {counts}")
    launches["K4"] = counts["K4"]

    # ------------------------------------- 7. the tracked paths, full width
    # The energy of row 0 (the initial state) is held to the exact energy of
    # the same state from one K6 sweep (R = 1, the total G*m row) at rtol
    # 1e-3, the tolerance murb_tpu holds proxy energies to
    # (tests/test_multigalaxy.py:160-173).
    st0 = init_galaxy(n_main, SEED, device=dev)
    gm0 = st0.m * torch.tensor(G, dtype=torch.float32).item()
    e_exact = float(energy_from_phi(
        st0, acc_phi_rows_hybrid(st0.qx, st0.qy, st0.qz, gm0, gm0[None, :],
                                 SOFT)[1][0], SOFT))
    del st0, gm0

    def rows_finite(hist, n_rows, csv):
        check(hist.num_iterations == n_rows and all(
            bool(np.isfinite(getattr(hist, k)).all())
            for k in ("energies", "ang_momentums", "density_centers")),
            f"{n_rows} finite history rows")
        with open(csv) as f:
            lines = f.read().splitlines()
        check(len(lines) == n_rows + 1, f"{csv}: {len(lines) - 1} rows, "
                                        f"expected {n_rows}")

    fps = {"tpu+proxy": res.fps}
    for tag in ("tpu+tracking", "tpu+leapfrog+tracking"):
        csv = os.path.join(tmpdir.name, f"{tag}.csv")
        res7, counts = drive(lambda: cli.run([
            "-n", str(n_main), "-i", "100", "--im", tag, "--kernel", "proxy",
            "--nv", "--gf", "--scan", "--csv", csv, "--device", "cuda"]))
        check(res7.rc == 0, f"cli {tag} exit code {res7.rc}")
        eng7 = res7.engine
        eng7.assert_finite()
        check(eng7._fused_proxy_m > 0, f"{tag} did not take the fused proxy")
        check(counts["K1"] > 0 and counts["K2"] > 0,
              f"K1/K2 launched no time under {tag}: {counts}")
        rows_finite(eng7.history, 100, csv)
        e0 = float(eng7.history.energies[0])
        rel = abs(e0 / e_exact - 1.0)
        check(rel <= 1e-3, f"{tag} energy row 0 {e0:.6e} vs exact "
                           f"{e_exact:.6e}: rel {rel:.3e} > 1e-3")
        fps[tag] = res7.fps
        print(f"[7 tracked] {tag} --kernel proxy N={n_main}: m="
              f"{eng7._fused_proxy_m}, energy row 0 {e0:.9e} vs exact K6 "
              f"{e_exact:.9e} (rel {rel:.3e}, tol 1e-3); {res7.fps:.2f} FPS "
              f"vs tpu+proxy {res.fps:.2f} FPS in this run; launches {counts}")

    def galaxies_sum(hist, label):
        for k in ("energies", "ang_momentums", "density_centers"):
            total = sum(getattr(g, k) for g in hist.galaxies)
            check(bool(np.allclose(getattr(hist, k), total, rtol=1e-12,
                                   atol=0)),
                  f"{label}: global {k} is not the sum of the galaxies'")

    # the merger through the CLI: default --kernel (K4 force), K5 metrics
    csv = os.path.join(tmpdir.name, "merger.csv")
    res7, counts = drive(lambda: cli.run([
        "-n", str(mg.n), "-i", "50", "--im", "tpu+tracking+multi", "-s",
        "milkyway_andromeda", "--scheme-file", tab, "--nv", "--gf", "--scan",
        "--csv", csv, "--device", "cuda"]))
    check(res7.rc == 0, f"cli tpu+tracking+multi exit code {res7.rc}")
    res7.engine.assert_finite()
    launches["K5"] = counts["K5"]
    check(counts["K4"] > 0, f"K4 launched no time on the merger: {counts}")
    hist_cli = res7.engine.history
    rows_finite(hist_cli, 50, csv)
    galaxies_sum(hist_cli, "merger (CLI)")
    fps["merger tracked (K4 + K5)"] = res7.fps
    print(f"[7 merger] tpu+tracking+multi N={mg.n} through the CLI: "
          f"{res7.fps:.2f} FPS; launches {counts}")

    (eng7, fps_k6), counts = drive(lambda: timed(create_engine(
        "tpu+tracking+multi", mg, soft=SOFT, dt=DT, num_iterations=50,
        masks=masks), 50))
    launches["K6"] = counts["K6"]
    eng7.assert_finite()
    check(eng7._use_fused_exact(), "the merger engine did not fuse")
    hist = eng7.finalize_history()
    galaxies_sum(hist, "merger (create_engine)")
    check(all(bool(np.isfinite(getattr(hist, k)).all())
              for k in ("energies", "ang_momentums", "density_centers")),
          "finite merger history")
    d_e = float(np.max(np.abs(hist.energies / hist_cli.energies - 1.0)))
    check(d_e <= 1e-4, f"merger energies: K6 path vs K4+K5 path differ by "
                       f"{d_e:.3e} > 1e-4")
    (_, fps_exact), _ = drive(lambda: timed(create_engine(
        "tpu+hybrid", mg, soft=SOFT, dt=DT), 50))
    fps["merger tracked (K6)"] = fps_k6
    fps["merger untracked (tpu+hybrid)"] = fps_exact
    print(f"[7 merger] create_engine tpu+tracking+multi (no acc_fn, K6) "
          f"{fps_k6:.2f} FPS, untracked tpu+hybrid (passes 2) "
          f"{fps_exact:.2f} FPS: tracked/untracked {fps_k6 / fps_exact:.3f} "
          f"(K4+K5 through the CLI: {fps['merger tracked (K4 + K5)'] / fps_exact:.3f}); "
          f"energies of the two tracked paths differ by {d_e:.3e} (tol "
          f"1e-4); launches {counts}")
    print(f"[7 fps] {json.dumps(fps)} on {smi}")

    # small input: the card's tracked and integrator engines agree with the
    # CPU plain path (on the card tpu+tracking takes K6, on the CPU the
    # chunked force and the metrics' own sweep; the others run K4)
    for tag in ("tpu+tracking", "tpu+leapfrog+tracking", "tpu+leapfrog",
                "tpu+kdk", "tpu+yoshida4"):
        runs = []
        for d in ("cpu", dev):
            e = create_engine(tag, small.to(d), soft=SOFT, dt=DT,
                              num_iterations=5)
            e.run(5)
            runs.append(e)
        pos = max(float(np.max(np.abs(runs[1].bodies.unpadded()[k]
                                      - runs[0].bodies.unpadded()[k])
                               / np.maximum(np.abs(
                                   runs[0].bodies.unpadded()[k]), 1e-30)))
                  for k in ("qx", "qy", "qz"))
        hist = 0.0
        if hasattr(runs[0], "history"):
            ref = runs[0].history.energies
            hist = float(np.max(np.abs(runs[1].history.energies / ref - 1)))
        check(pos <= 1e-4 and hist <= 1e-5,
              f"{tag}: card vs cpu positions {pos:.3e} (tol 1e-4), energies "
              f"{hist:.3e} (tol 1e-5)")
        print(f"[7 small] {tag} N=2048 galaxy, 5 steps: card vs CPU plain "
              f"path positions max rel diff {pos:.3e} (tol 1e-4), energies "
              f"{hist:.3e} (tol 1e-5)")

    # ------------------------------ 8. the multi-level hierarchy, random
    # K7-K9 against their plain versions in float64 on the N=200,000 random
    # box (the main path's bodies), K7 and K9 on the real expansions and
    # fields.  Contracts, against the largest magnitude of each output:
    # K8 1e-5 and K7 3e-5 (fp32 sums of up to 3,128 bodies and 87,808
    # node pairs), K9 1e-4 (K2's, the basis recurrence in fp32).
    from murb_tpu_torch.ops.fmm import acc_fmm

    def rel_max(got, ref) -> float:
        return max(float((g.double() - r).abs().max() / r.abs().max())
                   for g, r in zip(got, ref))

    def k7_launches(label, w, hl, soft, m, C, subset, nf, f, err, tol,
                    reps=10):
        """K7's second launch (the same bits as ``f``), its time and its
        plain version's, its bound (``m2l_work``: the pairs' flops and one
        build per used offset; W in, the fields out) and the transfer
        entries it builds a launch against the first design's (one build
        per cell pair): (ms, plain ms, bound ms)."""
        again = fk.m2l_level_fused(w, hl, soft, m=m, C=C, subset=subset,
                                   with_phi=nf == 4)
        check(all(torch.equal(a, b) for a, b in zip(f, again)),
              f"K7 {label}: two launches differ")
        ms = time_ms(lambda: fk.m2l_level_fused(
            w, hl, soft, m=m, C=C, subset=subset, with_phi=nf == 4),
            reps=reps, runs=5 if reps > 2 else 3)
        plain_ms = time_ms(lambda: fk.m2l_level_plain(
            w, hl, soft, m=m, C=C, subset=subset, with_phi=nf == 4),
            reps=2 if m < 18 else 1, runs=3 if m < 18 else 1)
        pairs, flops = m2l_work(m, C, subset, nf)
        nbytes = 4 * (1 + nf) * C ** 3 * m ** 3
        b_ms, b_by = bound(nbytes, flops)
        plan = fk._plan_on(m, C, subset, nf, dev)[0]
        print(f"[{label}] max|df|/max|f| {err:.3e} (tol {tol:g}); the same "
              f"bits twice; {pairs} cell pairs in {len(plan.items)} items, "
              f"{plan.nsplit} offset splits; transfer entries built a "
              f"launch {plan.builds(m):.4g} (one a cell pair: "
              f"{pairs * m ** 6:.4g}); kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.3f} of it, on {smi}")
        return ms, plain_ms, b_ms

    sr8 = init_random(n_main, SEED, device=dev)
    g8 = sr8.m * torch.tensor(G, dtype=torch.float32).item()
    c8, h8 = bounding_box(sr8.qx, sr8.qy, sr8.qz, g8 > 0)
    ge8 = heavy_split(sr8.qx, sr8.qy, sr8.qz, g8, 1, 100.0,
                      g8.sum() / (g8 > 0).sum())[4]
    q8 = (sr8.qx, sr8.qy, sr8.qz)
    q8_64 = tuple(v.double() for v in q8)
    n8 = sr8.npad
    for m, C, subsets in ((8, 4, ("expand",)), (6, 8, ("expand", "near"))):
        shape = f"m={m} C={C} N={n8}"
        order = fk.cell_order(*q8, c8, h8, C)
        glue_ms = time_ms(lambda: fk.cell_order(*q8, c8, h8, C))
        w = fk.p2m_grid_fused(*q8, ge8, c8, h8, m=m, C=C, order=order)
        w64 = fk.p2m_grid_plain(*q8_64, ge8.double(), c8.double(),
                                h8.double(), m=m, C=C)
        err = rel_max([w], [w64])
        check(err <= 1e-5, f"K8 {shape}: max|dW| {err:.3e} of max|W|")
        check(torch.equal(w, fk.p2m_grid_fused(*q8, ge8, c8, h8, m=m, C=C,
                                               order=order)),
              f"K8 {shape}: two launches differ")
        ms = time_ms(lambda: fk.p2m_grid_fused(*q8, ge8, c8, h8, m=m, C=C,
                                               order=order))
        items = fk.p2m_grid_items(order, m)
        alone = graph_ms(lambda: fk.p2m_grid_launch(*q8, ge8, order, items,
                                                    m))
        plain_ms = time_ms(lambda: fk.p2m_grid_plain(*q8, ge8, c8, h8, m=m,
                                                     C=C), reps=3)
        # q, gm and the permutation in, W out; the contraction and bases
        nbytes, flops = 24 * n8 + 4 * C ** 3 * m ** 3, \
            n8 * (2 * m ** 3 + 6 * m ** 2)
        b_ms = bound(nbytes, flops)[0]
        print(f"[8 K8 p2m_grid {shape}] max|dW|/max|W| {err:.3e} (tol "
              f"1e-5); the same bits twice; {items.chunk} bodies an item; "
              f"kernel {ms:.4f} ms through the wrapper (prebuilt order), "
              f"alone (prebuilt items, a CUDA graph) {alone:.4f}, plain "
              f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_ms / alone:.3f} "
              f"of it alone); cell order (ids, sort, bounds) "
              f"{glue_ms:.4f} ms")
        if (m, C) == (8, 4):
            keep("K8", err * float(w64.abs().max()), ms, plain_ms, nbytes,
                 flops)

        hl = h8 / C
        fields64 = None
        for subset in subsets:
            for nf in (3, 4):
                f = fk.m2l_level_fused(w64.float(), hl, SOFT, m=m, C=C,
                                       subset=subset, with_phi=nf == 4)
                f64 = fk.m2l_level_plain(w64, hl.double(), SOFT, m=m, C=C,
                                         subset=subset, with_phi=nf == 4)
                err = rel_max(f, f64)
                check(err <= 3e-5, f"K7 {shape} {subset} nf={nf}: "
                                   f"{err:.3e} of max|f|")
                ms, plain_ms, b_ms = k7_launches(
                    f"8 K7 m2l {shape} {subset} nf={nf}", w64.float(), hl,
                    SOFT, m, C, subset, nf, f, err, 3e-5)
                if (m, C, subset, nf) == (8, 4, "expand", 3):
                    keep("K7", err * max(float(x.abs().max()) for x in f64),
                         ms, plain_ms, 4 * (1 + nf) * C ** 3 * m ** 3,
                         m2l_work(m, C, subset, nf)[1])
                if subset == "expand" and nf == 4:
                    fields64 = f64
        for k in (3, 4):
            flds = tuple(x.float() for x in fields64[:k])
            a = fk.l2p_grid_fused(*q8, c8, h8, flds, m=m, C=C, order=order)
            a64 = fk.l2p_grid_plain(*q8_64, c8.double(), h8.double(),
                                    fields64[:k], m=m, C=C)
            err = rel_max(a, a64)
            check(err <= 1e-4, f"K9 {shape} k={k}: {err:.3e} of max|a|")
            check(all(torch.equal(x, y) for x, y in zip(a, fk.l2p_grid_fused(
                *q8, c8, h8, flds, m=m, C=C, order=order))),
                f"K9 {shape} k={k}: two launches differ")
            ms = time_ms(lambda: fk.l2p_grid_fused(*q8, c8, h8, flds, m=m,
                                                   C=C, order=order))
            items = fk.l2p_grid_items(order, m)
            alone = graph_ms(lambda: fk.l2p_grid_launch(*q8, order, items,
                                                        m, flds))
            plain_ms = time_ms(lambda: fk.l2p_grid_plain(*q8, c8, h8, flds,
                                                         m=m, C=C), reps=3)
            # q and the permutation in, k fields in, k values a body out
            nbytes = 20 * n8 + 4 * k * (n8 + C ** 3 * m ** 3)
            flops = n8 * (2 * k * m ** 3 + 6 * m ** 2)
            b_ms = bound(nbytes, flops)[0]
            print(f"[8 K9 l2p_grid {shape} k={k}] max|da|/max|a| {err:.3e} "
                  f"(tol 1e-4); the same bits twice; kernel {ms:.4f} ms "
                  f"through the wrapper, alone {alone:.4f}, plain "
                  f"{plain_ms:.4f} ms bound {b_ms:.4f} ms "
                  f"({b_ms / alone:.3f} of it alone)")
            if (m, C, k) == (8, 4, 3):
                keep("K9", err * max(float(x.abs().max()) for x in a64), ms,
                     plain_ms, nbytes, flops)
    del w64, fields64, a64, f64
    torch.cuda.empty_cache()

    # the main path of the random box through the CLI: the auto policy
    # takes the hierarchy and validates it
    res8, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "100", "--im", "tpu+proxy", "-s", "random",
        "--nv", "--gf", "--scan", "--device", "cuda"]))
    check(res8.rc == 0, f"cli tpu+proxy -s random exit code {res8.rc}")
    e8 = res8.engine
    e8.assert_finite()
    check(e8.using_proxy and e8.levels >= 2,
          f"tpu+proxy -s random took m={e8.m} levels={e8.levels} "
          f"using_proxy={e8.using_proxy}, not the hierarchy")
    check(e8.validated_err is not None and e8.validated_err <= TOL,
          f"random box validated error {e8.validated_err} > {TOL}")
    for k in ("K7", "K8", "K9"):
        launches[k] = counts[k]
        check(counts[k] > 0, f"{k} launched no time on the random box")
    pick8 = (e8.m, e8.levels)     # shard+fmm must pick the same (phase 11)
    f8 = e8.bodies
    err_end = measured_force_error(
        f8.qx, f8.qy, f8.qz, e8._gm(f8), SOFT,
        lambda a, b, cc, g: acc_fmm(a, b, cc, g, SOFT, m=e8.m,
                                    levels=e8.levels))
    print(f"[8 main] tpu+proxy N={n_main} random: m={e8.m} "
          f"levels={e8.levels} validated_err {e8.validated_err:.3e} (err "
          f"after 100 steps {err_end:.3e}, reported, not a contract); "
          f"{res8.fps:.2f} FPS {res8.gflops:.1f} ref-GFlop/s "
          f"({res8.elapsed_ms:.2f} ms for 99 steps) on {smi}; launches "
          f"{counts}")

    # the fused tracked hierarchy: row 0's energy against one exact K6
    # sweep of the same state (rtol 1e-3, as in phase 7)
    e_exact8 = float(energy_from_phi(
        sr8, acc_phi_rows_hybrid(*q8, g8, g8[None, :], SOFT)[1][0], SOFT))
    csv = os.path.join(tmpdir.name, "random_tracking.csv")
    res8t, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "20", "--im", "tpu+tracking", "--kernel",
        "fmm", "-s", "random", "--nv", "--gf", "--scan", "--csv", csv,
        "--device", "cuda"]))
    check(res8t.rc == 0, f"cli tpu+tracking --kernel fmm exit {res8t.rc}")
    et = res8t.engine
    et.assert_finite()
    check(len(et._fused_fmm) == 2, "tpu+tracking did not fuse the hierarchy")
    check(all(counts[k] > 0 for k in ("K7", "K8", "K9")),
          f"K7-K9 launched no time under the tracked hierarchy: {counts}")
    rows_finite(et.history, 20, csv)
    e0 = float(et.history.energies[0])
    rel = abs(e0 / e_exact8 - 1.0)
    check(rel <= 1e-3, f"tracked fmm energy row 0 {e0:.6e} vs exact "
                       f"{e_exact8:.6e}: rel {rel:.3e} > 1e-3")
    print(f"[8 tracked] tpu+tracking --kernel fmm N={n_main} random: "
          f"(m, levels)={et._fused_fmm}, energy row 0 {e0:.9e} vs exact K6 "
          f"{e_exact8:.9e} (rel {rel:.3e}, tol 1e-3); {res8t.fps:.2f} FPS "
          f"vs tpu+proxy {res8.fps:.2f} FPS in this run; launches {counts}")
    del sr8, g8, ge8, q8, q8_64

    # the octant proxy: K8/K9 at C=2 on the 200k galaxy (the 13,824-node
    # sweep runs K3)
    err_c2, counts = drive(lambda: measured_force_error(
        fin.qx, fin.qy, fin.qz, gm_fin, SOFT,
        lambda a, b, cc, g: acc_proxy(a, b, cc, g, SOFT, m=12, cells=2)))
    check(counts["K8"] > 0 and counts["K9"] > 0,
          f"acc_proxy cells=2 launched no K8/K9: {counts}")
    check(err_c2 <= TOL, f"acc_proxy cells=2 force error {err_c2:.3e}")
    print(f"[8 cells=2] acc_proxy m=12 cells=2 on the galaxy after phase 4: "
          f"force error {err_c2:.3e} (tol {TOL}); launches {counts}")

    # small input: the hierarchy on the card agrees with the CPU plain path
    small_r = init_random(2048, SEED, device="cpu")
    runs = [create_engine("tpu+proxy", small_r.to(d), soft=SOFT, dt=DT,
                          m=8, levels=2) for d in ("cpu", dev)]
    for e in runs:
        e.run(3)
    worst = max(float(np.max(np.abs(runs[1].bodies.unpadded()[k]
                                    - runs[0].bodies.unpadded()[k])
                             / np.maximum(np.abs(
                                 runs[0].bodies.unpadded()[k]), 1e-30)))
                for k in ("qx", "qy", "qz"))
    check(worst <= 1e-4, f"levels=2 m=8: card vs cpu positions {worst:.3e}")
    print(f"[8 small] tpu+proxy levels=2 m=8 N=2048 random, 3 steps: card "
          f"vs CPU plain path positions max rel diff {worst:.3e} (tol 1e-4)")

    # ---------------------------- 9. the adaptive hierarchy, two clusters
    # murb_tpu's bench row adaptive_two_clusters_1m (bench.py:442-460):
    # N = 1,048,576 in two Gaussian clusters, soft 0.02, dt 1e-6, through
    # create_engine with the auto policy, which must take the adaptive
    # branch.  The kernel parity below runs on that state's own sorted
    # bodies, slots and fields under the plan the engine picked.
    from murb_tpu_torch.ops import anterp_kernels as ak
    from murb_tpu_torch.ops import p2p as pp
    from murb_tpu_torch.ops import p2p_kernels as pk
    from murb_tpu_torch.ops import sparse_fmm as sf
    from murb_tpu_torch.ops.fmm import _heavy_setup
    from murb_tpu_torch.utils.profile_step import (TWO_CLUSTERS_DT,
                                                   TWO_CLUSTERS_SOFT,
                                                   two_clusters)

    soft9, dt9 = TWO_CLUSTERS_SOFT, TWO_CLUSTERS_DT
    t0 = time.perf_counter()
    st9 = two_clusters(device=dev)
    t_state = time.perf_counter() - t0

    def build_and_run(n_steps):
        t1 = time.perf_counter()
        engine = create_engine("tpu+proxy", st9, soft=soft9, dt=dt9)
        return (time.perf_counter() - t1,) + timed(engine, n_steps)

    (t_build, e9, fps9), counts = drive(lambda: build_and_run(4))
    e9.assert_finite()
    check(e9.near_mode == "adaptive" and e9.using_proxy,
          f"the two-cluster box took near_mode={e9.near_mode} "
          f"using_proxy={e9.using_proxy}, not the adaptive solver")
    check(e9.validated_err is not None and e9.validated_err <= TOL,
          f"adaptive validated error {e9.validated_err} > {TOL}")
    for k in ("K10", "K11", "K12"):
        launches[k] = counts[k]
        check(counts[k] > 0, f"{k} launched no time on the adaptive path")
    plan = e9._plan
    est9 = dict(e9.cost_estimates)      # the policy's estimates (phase 16)
    health9 = e9.proxy_health()
    (_, fps_exact9), counts_x = drive(lambda: timed(create_engine(
        "tpu+hybrid", st9, soft=soft9, dt=dt9), 3))
    print(f"[9 main] tpu+proxy N={st9.n} two clusters (state in "
          f"{t_state:.1f} s, engine with plan and validation in "
          f"{t_build:.1f} s): near_mode={e9.near_mode} m={plan.m} dense "
          f"levels={plan.dense_levels} levels={plan.levels} cell caps "
          f"{plan.cell_caps} (occupied {health9['n_cells_now']}) pmax "
          f"{plan.p2p_pmax} n_pairs {health9['p2p_pairs_now']} (host "
          f"estimate), validated_err {e9.validated_err:.3e}; {fps9:.4f} FPS "
          f"over 3 steps after one; exact tpu+hybrid {fps_exact9:.4f} FPS "
          f"over 2 steps after one (launches {counts_x}); adaptive/exact "
          f"{fps9 / fps_exact9:.2f} on {smi}; launches {counts}")
    fps["two clusters adaptive"] = fps9
    fps["two clusters exact (tpu+hybrid)"] = fps_exact9

    # the solve's own preamble: box, heavy split, cubic box, one sort
    g9 = e9._gm(st9)
    q9 = (st9.qx, st9.qy, st9.qz)
    c9, h9, *_rest, ge9 = _heavy_setup(*q9, g9, 1, sf.HEAVY_FACTOR)
    h9 = h9.max().expand(3)
    C9 = 2 ** plan.levels
    key9, ci9 = pp.sorted_cells(*q9, ge9 > 0, c9, h9, C9)
    key9, perm9 = torch.sort(key9, stable=True)
    xs9, ys9, zs9, gs9 = (v[perm9] for v in (*q9, ge9))
    ci9 = tuple(v[perm9] for v in ci9)
    x64 = tuple(v.double() for v in (xs9, ys9, zs9, gs9))
    cap9 = plan.cell_caps[-1]
    cells9, slots9 = sf._occupied_and_slots(key9, cap9)
    n9, B9 = st9.npad, st9.npad // pp.DEFAULT_K
    # Contracts, against the largest magnitude of each output: K10 3e-5,
    # the exact fp32 sweeps' (K4, K6); K11 and K12 1e-4, K9's.  At C=128 a
    # body's in-cell coordinate comes from (q - lo) / cs near 100 in fp32
    # (ulp 8e-6), which the float64 plain version on the same fp32 inputs
    # does not round.
    def near_body_pairs(ci, pmax, C, chunk=2048):
        """The body pairs K10's function needs: those of the first
        ``pmax`` candidate brick pairs (row-major, as K10 keeps them) whose
        cells pass the mask max|dc| <= 1, both bodies real (no sentinel).
        Counted on the device from the sort's own cells.  Also K10's
        sub-tile classes of those brick pairs (ops/p2p.subtile_class: far,
        mixed, all-near), counted in (32 x 32)-body sub-tile pairs."""
        K, S = pp.DEFAULT_K, pp.SUB_K
        cells = torch.stack([v.to(torch.int16) for v in ci]).reshape(3, -1,
                                                                     K)
        B = cells.shape[1]
        real = cells[0] < C
        adj = pp._adjacency(*pp._brick_boxes(ci, K))
        flat = torch.nonzero(adj.reshape(-1)).reshape(-1)[:pmax]
        tb, sb = flat // B, flat % B
        lo, hi = (v.reshape(B, K // S, 3) for v in pp._brick_boxes(ci, S))
        total = torch.zeros((), dtype=torch.int64, device=flat.device)
        classes = torch.zeros(3, dtype=torch.int64, device=flat.device)
        for p0 in range(0, flat.numel(), chunk):
            t, s = tb[p0:p0 + chunk], sb[p0:p0 + chunk]
            near = ((cells[:, t, :, None] - cells[:, s, None, :]).abs()
                    <= 1).all(0)
            near &= real[t][:, :, None] & real[s][:, None, :]
            total += near.sum()
            cls = pp.subtile_class(lo[t][:, :, None], hi[t][:, :, None],
                                   lo[s][:, None], hi[s][:, None])
            classes += torch.bincount(cls.reshape(-1).long(), minlength=3)
        return int(total), flat.numel() * K * K, classes.tolist()

    # K10 (nf 3 and 4); the plain version sweeps 1024 pairs a step here.
    # The bound counts the body pairs that pass the cell mask, the work the
    # function needs; K10 computes every body pair of a swept brick pair.
    t0 = time.perf_counter()
    near9, swept_bodies9, cls9 = near_body_pairs(ci9, plan.p2p_pmax, C9)
    t_count = time.perf_counter() - t0
    rows9 = pk.pair_rows(pp._adjacency(*pp._brick_boxes(
        ci9, pp.DEFAULT_K)))[0].double()
    share = [c / sum(cls9) for c in cls9]
    print(f"[9 K10 sub-tiles] (32 x 32)-body sub-tile pairs of the swept "
          f"brick pairs, by class: far {share[pp.FAR]:.4f}, all-near "
          f"{share[pp.ALL_NEAR]:.4f}, mixed {share[pp.MIXED]:.4f} "
          f"({sum(cls9)} sub-tile pairs; the kernel sweeps "
          f"{(1 - share[pp.FAR]) * swept_bodies9:.6e} body pairs, "
          f"{near9} pass the mask); candidate bricks a row: mean "
          f"{float(rows9.mean()):.2f}, p99 "
          f"{float(torch.quantile(rows9, 0.99)):.1f}, max "
          f"{int(rows9.max())} over {B9} rows")
    for nf in (3, 4):
        kw = dict(pmax=plan.p2p_pmax, with_phi=nf == 4)
        got, npairs = pk.p2p_sweep_kernel_sorted(xs9, ys9, zs9, gs9, ci9,
                                                 soft9, **kw)
        again, _ = pk.p2p_sweep_kernel_sorted(xs9, ys9, zs9, gs9, ci9,
                                              soft9, **kw)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K10 nf={nf}: two launches differ")
        ref, npairs64 = pp.p2p_sweep_plain_sorted(*x64, ci9, soft9,
                                                  chunk=1024, **kw)
        err = rel_max(got, ref)
        check(int(npairs) == int(npairs64), f"K10 n_pairs {int(npairs)} vs "
                                            f"plain {int(npairs64)}")
        check(err <= 3e-5, f"K10 nf={nf}: {err:.3e} of max|a|")
        ms = time_ms(lambda: pk.p2p_sweep_kernel_sorted(
            xs9, ys9, zs9, gs9, ci9, soft9, **kw), reps=5)
        plain_ms = time_ms(lambda: pp.p2p_sweep_plain_sorted(
            xs9, ys9, zs9, gs9, ci9, soft9, chunk=1024, **kw), reps=1,
            runs=3)
        swept = min(int(npairs), plan.p2p_pmax)
        nbytes = 28 * n9 + B9 * B9 + 8 * B9 + 4 * nf * n9
        flops = near9 * (20 if nf == 3 else 22)
        b_ms = bound(nbytes, flops)[0]
        print(f"[9 K10 p2p N={n9} B={B9} nf={nf}] {int(npairs)} brick "
              f"pairs ({swept} swept, pmax {plan.p2p_pmax}); {near9} body "
              f"pairs pass the cell mask of {swept_bodies9} swept (masked "
              f"out {1 - near9 / swept_bodies9:.4f}; counted in "
              f"{t_count:.2f} s); max|da|/max|a| {err:.3e} (tol 3e-5); "
              f"the same bits twice; kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {b_ms:.4f} ms")
        if nf == 3:
            keep("K10", err * max(float(x.abs().max()) for x in ref), ms,
                 plain_ms, nbytes, flops)
        full4 = got
    # K10 under a capacity below the candidate count: the first pmax pairs
    # in row-major order are swept, the rest dropped, the true count kept
    pmax_t = max(int(npairs) // 2 // pp.DEFAULT_CHUNK * pp.DEFAULT_CHUNK,
                 pp.DEFAULT_CHUNK)
    got, np_t = pk.p2p_sweep_kernel_sorted(xs9, ys9, zs9, gs9, ci9, soft9,
                                           pmax=pmax_t, with_phi=True)
    ref, np_t64 = pp.p2p_sweep_plain_sorted(*x64, ci9, soft9, chunk=1024,
                                            pmax=pmax_t, with_phi=True)
    err = rel_max(got, ref)
    dropped = max(float((a - b).abs().max()) for a, b in zip(full4, got))
    check(int(np_t) == int(np_t64) == int(npairs),
          f"K10 pmax={pmax_t}: n_pairs {int(np_t)} vs plain {int(np_t64)} "
          f"vs {int(npairs)}")
    check(err <= 3e-5, f"K10 pmax={pmax_t} nf=4: {err:.3e} of max|a|")
    check(dropped > 0.0, f"K10 pmax={pmax_t} dropped no pair")
    print(f"[9 K10 p2p N={n9} nf=4 pmax={pmax_t} < n_pairs {int(np_t)}] "
          f"max|da|/max|a| {err:.3e} (tol 3e-5) against the plain version "
          f"under the same pmax; max change from the full sweep "
          f"{dropped:.3e}")
    del got, ref, full4
    # K11 and K12 on the finest slots; K12 reads the solve's real fields
    m9 = plan.m
    w9 = ak.p2m_window(xs9, ys9, zs9, gs9, c9, h9, slots9, cap9, m=m9, C=C9,
                       ci=ci9)
    w64 = ak.p2m_window_plain(*x64, c9.double(), h9.double(), slots9, cap9,
                              m=m9, C=C9, ci=ci9)
    err = rel_max([w9[:cap9]], [w64[:cap9]])
    check(err <= 1e-4, f"K11 m={m9}: {err:.3e} of max|W|")
    check(torch.equal(w9, ak.p2m_window(xs9, ys9, zs9, gs9, c9, h9, slots9,
                                        cap9, m=m9, C=C9, ci=ci9)),
          f"K11 m={m9}: two launches differ")
    ms = time_ms(lambda: ak.p2m_window(xs9, ys9, zs9, gs9, c9, h9, slots9,
                                       cap9, m=m9, C=C9, ci=ci9))
    # the kernel alone: the sorted bodies' int32 cells, the box and the
    # slots' work items built once
    cells32 = [v.to(torch.int32).contiguous() for v in ci9]
    box9 = torch.cat([c9 - h9, 2.0 * h9 / C9]).to(torch.float32)
    sl32 = slots9.to(torch.int32)
    items = ak.window_items(sl32, cap9, fk.p2m_chunk(n9, m9,
                                                     cuda.sm_count(dev)))
    alone = graph_ms(lambda: ak.p2m_window_launch(
        xs9, ys9, zs9, gs9, cells32, box9, items, m9))
    plain_ms = time_ms(lambda: ak.p2m_window_plain(
        xs9, ys9, zs9, gs9, c9, h9, slots9, cap9, m=m9, C=C9, ci=ci9),
        reps=3)
    nbytes = 32 * n9 + 4 * (cap9 + 1) * m9 ** 3
    flops = n9 * (2 * m9 ** 3 + 6 * m9 ** 2)
    b_ms = keep("K11", err * float(w64.abs().max()), ms, plain_ms, nbytes,
                flops)
    print(f"[9 K11 p2m_window N={n9} m={m9} C={C9} cap={cap9}] "
          f"max|dW|/max|W| {err:.3e} (tol 1e-4); the same bits twice; "
          f"{items.chunk} bodies an item; kernel {ms:.4f} ms through the "
          f"wrapper, alone (a CUDA graph) {alone:.4f}, plain "
          f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_ms / alone:.3f} of it "
          f"alone)")
    fields9, _ = sf.hierarchy_fields(w9, cells9, c9, h9, soft9, plan,
                                     with_phi=True)
    for nf in (3, 4):
        flds = fields9[:nf]
        a = ak.l2p_window(xs9, ys9, zs9, c9, h9, slots9, flds, m=m9, C=C9,
                          ci=ci9)
        a64 = ak.l2p_window_plain(*x64[:3], c9.double(), h9.double(),
                                  slots9, tuple(f.double() for f in flds),
                                  m=m9, C=C9, ci=ci9)
        err = rel_max(a, a64)
        check(err <= 1e-4, f"K12 nf={nf}: {err:.3e} of max|a|")
        check(all(torch.equal(x, y) for x, y in zip(a, ak.l2p_window(
            xs9, ys9, zs9, c9, h9, slots9, flds, m=m9, C=C9, ci=ci9))),
            f"K12 nf={nf}: two launches differ")
        ms = time_ms(lambda: ak.l2p_window(xs9, ys9, zs9, c9, h9, slots9,
                                           flds, m=m9, C=C9, ci=ci9))
        items = ak.window_items(sl32, cap9, fk.l2p_item(m9))
        f32 = [f.float().contiguous() for f in flds]
        alone = graph_ms(lambda: ak.l2p_window_launch(
            xs9, ys9, zs9, cells32, box9, items, m9, f32))
        plain_ms = time_ms(lambda: ak.l2p_window_plain(
            xs9, ys9, zs9, c9, h9, slots9, flds, m=m9, C=C9, ci=ci9), reps=3)
        nbytes = 28 * n9 + 4 * nf * ((cap9 + 1) * m9 ** 3 + n9)
        flops = n9 * (2 * nf * m9 ** 3 + 6 * m9 ** 2)
        b_ms = bound(nbytes, flops)[0]
        print(f"[9 K12 l2p_window N={n9} m={m9} nf={nf}] max|da|/max|a| "
              f"{err:.3e} (tol 1e-4); the same bits twice; kernel {ms:.4f} "
              f"ms through the wrapper, alone (a CUDA graph) {alone:.4f}, "
              f"plain {plain_ms:.4f} ms bound {b_ms:.4f} ms "
              f"({b_ms / alone:.3f} of it alone)")
        if nf == 3:
            keep("K12", err * max(float(x.abs().max()) for x in a64), ms,
                 plain_ms, nbytes, flops)

    del w64, a64, x64, fields9
    torch.cuda.empty_cache()

    # the dense hierarchy with K10 as its near field: acc_fmm(near="p2p")
    # on a 65,536-body two-cluster box, L=4, m=6, held to the 1e-4 contract
    s65 = two_clusters(65_536, device=dev)
    g65 = s65.m * torch.tensor(G, dtype=torch.float32).item()
    u65 = s65.unpadded()
    qh65 = np.stack([u65[k] for k in ("qx", "qy", "qz")], 1)
    pmax65 = pp.size_pmax(pp.estimate_brick_pairs(qh65, s65.npad, 4))
    err65, counts = drive(lambda: measured_force_error(
        s65.qx, s65.qy, s65.qz, g65, soft9,
        lambda a, b, cc, g: acc_fmm(a, b, cc, g, soft9, m=6, levels=4,
                                    near="p2p", p2p_pmax=pmax65)))
    check(counts["K10"] > 0, f"acc_fmm near=p2p launched no K10: {counts}")
    check(err65 <= TOL, f"acc_fmm near=p2p force error {err65:.3e} > {TOL}")
    print(f"[9 fmm p2p] acc_fmm m=6 L=4 near=p2p N=65536 two clusters: "
          f"force error {err65:.3e} (tol {TOL}), pmax {pmax65}; launches "
          f"{counts}")

    # the merger through the CLI: tpu+proxy --near adaptive, and the fused
    # adaptive tracked step (K10 and K12 with phi), row 0's energy held to
    # an exact K6 energy of the same state (rtol 1e-3, as in phase 7)
    res9, counts = drive(lambda: cli.run([
        "-n", str(mg.n), "-i", "20", "--im", "tpu+proxy", "--near",
        "adaptive", "-s", "milkyway_andromeda", "--scheme-file", tab,
        "--nv", "--gf", "--scan", "--device", "cuda"]))
    check(res9.rc == 0, f"cli tpu+proxy --near adaptive exit {res9.rc}")
    res9.engine.assert_finite()
    check(res9.engine.near_mode == "adaptive", "merger --near adaptive did "
                                               "not take the adaptive solver")
    check(all(counts[k] > 0 for k in ("K10", "K11", "K12")),
          f"K10-K12 launched no time on the merger: {counts}")
    pm = res9.engine._plan
    print(f"[9 merger] tpu+proxy --near adaptive N={mg.n}: m={pm.m} dense "
          f"levels={pm.dense_levels} levels={pm.levels} caps {pm.cell_caps} "
          f"pmax {pm.p2p_pmax}, validated_err "
          f"{res9.engine.validated_err:.3e}; {res9.fps:.2f} FPS over 19 "
          f"steps; launches {counts}")
    fps["merger tpu+proxy --near adaptive"] = res9.fps
    e_exact_mg = float(energy_from_phi(
        mg, acc_phi_rows_hybrid(*qm, gmg, gmg[None, :], SOFT)[1][0], SOFT))
    csv = os.path.join(tmpdir.name, "merger_adaptive.csv")
    res9t, counts = drive(lambda: cli.run([
        "-n", str(mg.n), "-i", "20", "--im", "tpu+tracking", "--kernel",
        "adaptive", "-s", "milkyway_andromeda", "--scheme-file", tab, "--nv",
        "--gf", "--scan", "--csv", csv, "--device", "cuda"]))
    check(res9t.rc == 0, f"cli tpu+tracking --kernel adaptive {res9t.rc}")
    et9 = res9t.engine
    et9.assert_finite()
    check(et9._fused_adaptive is not None, "tpu+tracking --kernel adaptive "
                                           "did not fuse")
    check(counts["K10"] > 0 and counts["K12"] > 0,
          f"K10/K12 launched no time under the tracked adaptive step: "
          f"{counts}")
    rows_finite(et9.history, 20, csv)
    e0 = float(et9.history.energies[0])
    rel = abs(e0 / e_exact_mg - 1.0)
    check(rel <= 1e-3, f"tracked adaptive energy row 0 {e0:.6e} vs exact "
                       f"{e_exact_mg:.6e}: rel {rel:.3e} > 1e-3")
    print(f"[9 tracked] tpu+tracking --kernel adaptive N={mg.n} merger: "
          f"m={et9._fused_adaptive.m} L={et9._fused_adaptive.levels}, energy "
          f"row 0 {e0:.9e} vs exact K6 {e_exact_mg:.9e} (rel {rel:.3e}, tol "
          f"1e-3); {res9t.fps:.2f} FPS; launches {counts}")
    fps["merger tpu+tracking --kernel adaptive"] = res9t.fps
    print(f"[9 fps] {json.dumps(fps)} on {smi}")

    # small input: 3 adaptive steps on the card against the CPU plain path
    # (the same explicit geometry, m=6 L=5, on both devices); dt 0.05 moves
    # the bodies by about 1e-3 of their coordinates
    small_c = two_clusters(4096, device="cpu")
    runs = [create_engine("tpu+proxy", small_c.to(d), soft=soft9, dt=0.05,
                          m=6, levels=5, near="adaptive")
            for d in ("cpu", dev)]
    for e in runs:
        e.run(3)
    pos = [e.bodies.unpadded() for e in runs]
    q0 = small_c.unpadded()
    worst = max(float(np.max(np.abs(pos[1][k] - pos[0][k])
                             / np.maximum(np.abs(pos[0][k]), 1e-30)))
                for k in ("qx", "qy", "qz"))
    moved = max(float(np.max(np.abs(pos[0][k] - q0[k])
                             / np.maximum(np.abs(q0[k]), 1e-30)))
                for k in ("qx", "qy", "qz"))
    check(worst <= 1e-4, f"adaptive: card vs cpu positions {worst:.3e}")
    print(f"[9 small] tpu+proxy near=adaptive m=6 L=5 N=4096 two clusters, "
          f"3 steps of dt 0.05 (bodies moved up to {moved:.3e} of their "
          f"coordinates): card vs CPU plain path positions max rel diff "
          f"{worst:.3e} (tol 1e-4)")

    # the adaptive step's dense far sweep: K7 at the plan's order and
    # dense base (C = 2^Ld) on this box's own expansions, nf 3 (tpu+proxy)
    # and 4 (the tracked step), against its plain version in float64
    # (3e-5 of max|f|), launched twice for the same bits
    mf, Cf = plan.m, 2 ** plan.dense_levels
    wf = fk.p2m_grid_fused(*q9, ge9, c9, h9, m=mf, C=Cf)
    for nf in (3, 4):
        f = fk.m2l_level_fused(wf, h9 / Cf, soft9, m=mf, C=Cf, subset="far",
                               with_phi=nf == 4)
        f64 = fk.m2l_level_plain(wf.double(), h9.double() / Cf, soft9, m=mf,
                                 C=Cf, subset="far", with_phi=nf == 4)
        e7 = rel_max(f, f64)
        check(e7 <= 3e-5, f"K7 far m={mf} C={Cf} nf={nf}: {e7:.3e} of "
                          f"max|f| (3e-5)")
        k7_launches(f"9 K7 far sweep m={mf} C={Cf} N={n9} nf={nf}", wf,
                    h9 / Cf, soft9, mf, Cf, "far", nf, f, e7, 3e-5)
    del wf, f, f64

    # the repair: K7-K9 at m=18 (the rung after 16) and m=32 (the ladder's
    # top order) on the two-cluster box, C=2.  K7's fp32 sums run over 8
    # cells x m^3 source nodes a target (46,656 at m=18, 262,144 at m=32),
    # so its contract is K9's 1e-4, not the m=8 sweep's 3e-5; it launches
    # twice for the same bits.  The plain M2L builds its (m^3, m^3)
    # transfer matrices in row blocks at m=32.  K8's and K9's bounds as in
    # phase 8 (bytes once; the contraction and the bases).
    C = 2
    order9 = fk.cell_order(*q9, c9, h9, C)
    for m in (18, 32):
        shape = f"m={m} C={C} N={n9}"
        w = fk.p2m_grid_fused(*q9, ge9, c9, h9, m=m, C=C, order=order9)
        w64 = fk.p2m_grid_plain(*(v.double() for v in (*q9, ge9)),
                                c9.double(), h9.double(), m=m, C=C)
        e8 = rel_max([w], [w64])
        del w64
        check(torch.equal(w, fk.p2m_grid_fused(*q9, ge9, c9, h9, m=m, C=C,
                                               order=order9)),
              f"K8 {shape}: two launches differ")
        t0 = time.perf_counter()
        f = fk.m2l_level_fused(w, h9 / C, soft9, m=m, C=C, with_phi=True)
        f64 = fk.m2l_level_plain(w.double(), h9.double() / C, soft9, m=m,
                                 C=C, with_phi=True)
        e7 = rel_max(f, f64)
        t_plain7 = time.perf_counter() - t0
        del f64
        a = fk.l2p_grid_fused(*q9, c9, h9, f, m=m, C=C, order=order9)
        a64 = fk.l2p_grid_plain(*(v.double() for v in q9), c9.double(),
                                h9.double(), tuple(x.double() for x in f),
                                m=m, C=C)
        e9k = rel_max(a, a64)
        del a64
        check(all(torch.equal(x, y) for x, y in zip(a, fk.l2p_grid_fused(
            *q9, c9, h9, f, m=m, C=C, order=order9))),
            f"K9 {shape}: two launches differ")
        check(e8 <= 1e-5 and e7 <= 1e-4 and e9k <= 1e-4,
              f"{shape}: K8 {e8:.3e} (1e-5) K7 {e7:.3e} (1e-4) K9 "
              f"{e9k:.3e} (1e-4)")
        ms7 = k7_launches(f"9 repair K7 {shape} expand nf=4", w, h9 / C,
                          soft9, m, C, "expand", 4, f, e7, 1e-4,
                          reps=3 if m < 32 else 1)[0]
        items8 = fk.p2m_grid_items(order9, m)
        items9 = fk.l2p_grid_items(order9, m)
        f32 = [x.contiguous() for x in f]
        ms = [time_ms(fn, reps=3) for fn in (
            lambda: fk.p2m_grid_fused(*q9, ge9, c9, h9, m=m, C=C,
                                      order=order9),
            lambda: fk.l2p_grid_fused(*q9, c9, h9, f, m=m, C=C,
                                      order=order9))]
        alone8 = graph_ms(lambda: fk.p2m_grid_launch(*q9, ge9, order9,
                                                     items8, m), reps=3)
        alone9 = graph_ms(lambda: fk.l2p_grid_launch(*q9, order9, items9, m,
                                                     f32), reps=3)
        b8 = bound(24 * n9 + 4 * C ** 3 * m ** 3,
                   n9 * (2 * m ** 3 + 6 * m ** 2))
        b9 = bound(20 * n9 + 16 * (n9 + C ** 3 * m ** 3),
                   n9 * (8 * m ** 3 + 6 * m ** 2))
        print(f"[9 repair {shape}] K8 {e8:.3e} of max|W| (tol 1e-5), K7 "
              f"expand nf=4 {e7:.3e} of max|f| (tol 1e-4), K9 k=4 "
              f"{e9k:.3e} of max|a| (tol 1e-4); K8 and K9 the same bits "
              f"twice; kernel ms (prebuilt cell order) K8 {ms[0]:.4f}, "
              f"alone (a CUDA graph) {alone8:.4f} ({items8.chunk} bodies an "
              f"item; bound {b8[0]:.4f} ms, {b8[1]}, {b8[0] / alone8:.3f} "
              f"of it) K7 {ms7:.4f} K9 {ms[1]:.4f}, alone {alone9:.4f} "
              f"(bound {b9[0]:.4f} ms, {b9[1]}, {b9[0] / alone9:.3f} of it) "
              f"on {smi}; the K7 check with its plain version took "
              f"{t_plain7:.1f} s")
        del w, f, a
        torch.cuda.empty_cache()

    # ------------------------------- 10. the exact large-N path, K13
    # murb_tpu's exact-ladder row (bench.py:373-377): tpu+mxu on the
    # N=200,000 galaxy, nothing cut.  Two shapes: a 4096-row strided
    # i-sample against all 200k sources (the rect entry; the centre comes
    # from the j-set, as in the square run) and the 16384^2 galaxy.  K13
    # runs S and P on the tensor cores in TF32 (ops/mxu.py); its plain
    # version computes the same TF32 arithmetic with torch ops.
    #   - "high" (the engines' tier) at every block pair the kernel is
    #     compiled for, "default" at the default pair; "highest" is
    #     "high"'s code (two products on P) and must give its bits;
    #   - against float64 (the direct sweep of the whole galaxy for the
    #     sample, the plain version run in float64 for 16384^2): WithinRel
    #     5e-4 with an rms floor of 5e-4 (tests/test_oracle.py:99-100) at
    #     "high", 1e-3 (rms floor 1e-3) at "default", the bound
    #     tests/test_torch_mxu.py states for its one TF32 pass on P;
    #   - against its plain version at the same tier, on the card: the
    #     same TF32 products, summed in another order (and the card's
    #     rsqrt).  "high": WithinRel 1e-5 (rms floor 1e-5).  "default"
    #     rounds W to TF32, so where the two S differ in the last bit and W
    #     sits at a TF32 tie, the two take neighbouring TF32 values of W
    #     and the body moves by one TF32 ulp (2^-11 to 2^-10) of that
    #     pair's term.  The worst body's gap, where it passes the summation
    #     noise (WithinRel 1e-5), must be such flips: its 16 strongest pairs
    #     are launched alone in both, and the pairs whose results differ by
    #     one TF32 ulp must account for the gap.  Each body is held to that
    #     one ulp (WithinRel 1e-3, rms floor 1e-3), and the rms of the
    #     difference over all bodies to 2e-5 of the force's rms, which the
    #     control, the plain version with W truncated to TF32 instead of
    #     rounded (a bias of about 2^-12), is read to fail;
    #   - launched twice at each tier for the same bits.
    from murb_tpu_torch.ops import mxu as mxu_ops
    from murb_tpu_torch.ops.mxu import acc_mxu_rect, acc_mxu_rect_plain
    from murb_tpu_torch.utils import autotune as at

    wrappers["K13"] = acc_mxu_rect
    g_of = lambda s: s.m * torch.tensor(G, dtype=torch.float32).item()
    # the float64 direct sweep of the whole 200k galaxy, padded for D = 4
    # (phase 11): ghost rows have no mass, so each padding compares its own
    # rows.  The reference of K13's main-path launch, its sample, and of K3
    # and K14 in phase 11.
    s11 = init_galaxy(n_main, SEED, device=dev).repad(256 * 4)
    q11 = [v.double() for v in (s11.qx, s11.qy, s11.qz, g_of(s11))]
    ref_parts = [acc_tile_rect_plain(*(v[i:i + 8192] for v in q11[:3]),
                                     *q11, SOFT)
                 for i in range(0, s11.npad, 8192)]
    ref11 = [torch.cat([p[c] for p in ref_parts]) for c in range(3)]
    del s11, q11, ref_parts
    s10 = init_galaxy(n_main, SEED, device=dev)
    q10 = (s10.qx, s10.qy, s10.qz, g_of(s10))
    idx10 = torch.linspace(0, s10.npad - 1, 4096, device=dev).long()
    s16 = init_galaxy(16_384, SEED, device=dev)
    q16 = (s16.qx, s16.qy, s16.qz, g_of(s16))
    q16_64 = tuple(v.double() for v in q16)
    cases10 = {
        "rect 4096x200k": (tuple(v[idx10] for v in q10[:3]), q10,
                           [r[idx10] for r in ref11]),
        "square 16384^2": (q16[:3], q16,
                           acc_mxu_rect_plain(*q16_64[:3], *q16_64, SOFT)),
    }

    def rms_rel(got, ref) -> float:
        """The rms of got - ref over all bodies and components, over that
        of ref."""
        d = sum(float((g.double() - r.double()).pow(2).sum())
                for g, r in zip(got, ref))
        return (d / sum(float(r.double().pow(2).sum()) for r in ref)) ** 0.5

    def w_flips(iset, jset, got, plain):
        """The body where K13 at "default" and its plain version differ
        most against WithinRel 1e-5 (rms floor 1e-5): (its share of that
        allowance, its gap in the worst component, the gap its W flips
        explain, the flips).  A flip is one of its 16 strongest pairs
        (float64 pair forces) whose single-pair results, kernel and plain,
        differ by one TF32 ulp of W: (source, ratio - 1)."""
        best = (0.0, 0, 0)
        for c, (g, p) in enumerate(zip(got, plain)):
            g, p = g.double(), p.double()
            ratio = (g - p).abs() / (1e-5 * torch.maximum(g.abs(), p.abs())
                                     + 1e-5 * float(p.pow(2).mean().sqrt()))
            if float(ratio.max()) > best[0]:
                best = (float(ratio.max()), c, int(ratio.argmax()))
        share, c, i = best
        x64 = [v.double() for v in jset]
        d = [x64[k] - float(iset[k][i]) for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + SOFT * SOFT
        strongest = (x64[3] * r2.rsqrt() ** 3 * d[c].abs()).argsort(
            descending=True)[:16].tolist()
        cp = mxu_ops._centered_with_point(*jset)[3]
        flips, explained = [], 0.0
        for j in strongest:
            k, p1 = (f(*(v[i:i + 1] for v in iset),
                       *(v[j:j + 1] for v in jset), SOFT,
                       precision="default", center_point=cp)
                     for f in (acc_mxu_rect, acc_mxu_rect_plain))
            big = max(range(3), key=lambda e: abs(float(p1[e][0])))
            ratio = float(k[big][0]) / float(p1[big][0]) - 1.0
            if abs(ratio) > 2.0 ** -12:
                flips.append((j, ratio))
                explained += float(k[c][0]) - float(p1[c][0])
        return share, float(got[c][i]) - float(plain[c][i]), explained, flips

    worst13, max_rel13 = 0.0, 0.0
    for label, (iset, jset, ref) in cases10.items():
        scale = max(float(r.abs().max()) for r in ref)
        for prec, eps in (("high", 5e-4), ("default", 1e-3)):
            got = acc_mxu_rect(*iset, *jset, SOFT, precision=prec)
            again = acc_mxu_rect(*iset, *jset, SOFT, precision=prec)
            plain = acc_mxu_rect_plain(*iset, *jset, SOFT, precision=prec)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K13 {label} {prec}: two launches differ")
            w64 = within_rel(got, ref, eps, eps)
            rel = max(float((g.double() - r).abs().max())
                      for g, r in zip(got, ref)) / scale
            check(w64 <= 1.0, f"K13 {label} {prec}: WithinRel {eps:g} (rms "
                              f"floor {eps:g}) against float64 exceeded by "
                              f"{w64:.2f}x")
            line = (f"[10 K13 tier {label} {prec}] max|da|/max|a| {rel:.3e} "
                    f"against float64 (WithinRel {eps:g} at {w64:.4f} of "
                    f"the allowance); the same bits twice; ")
            if prec == "high":
                wpl = within_rel(got, plain, 1e-5, 1e-5)
                check(wpl <= 1.0, f"K13 {label} high: WithinRel 1e-5 "
                                  f"against its plain version exceeded by "
                                  f"{wpl:.2f}x")
                top = acc_mxu_rect(*iset, *jset, SOFT, precision="highest")
                check(all(torch.equal(a, b) for a, b in zip(got, top)),
                      f"K13 {label}: 'highest' differs from 'high'")
                print(line + f"against its plain version WithinRel 1e-5 at "
                             f"{wpl:.4f}; 'highest' the same bits")
                continue
            wpl = within_rel(got, plain, 1e-3, 1e-3)
            rms_k = rms_rel(got, plain)
            rms_c = rms_rel(mxu_ops._acc_plain(
                *iset, *jset, SOFT, 2, 1, w_round=mxu_ops.tf32_trunc), plain)
            share, gap, explained, flips = w_flips(iset, jset, got, plain)
            check(wpl <= 1.0, f"K13 {label} default: WithinRel 1e-3 against "
                              f"its plain version exceeded by {wpl:.2f}x")
            check(rms_k <= 2e-5, f"K13 {label} default: rms gap to its "
                                 f"plain version {rms_k:.3e} > 2e-5")
            check(rms_c > 2e-5, f"K13 {label} default: the truncating "
                                f"control reads {rms_c:.3e}, within 2e-5")
            check(share <= 1.0 or (
                flips and all(2.0 ** -11 * 0.99 <= abs(r) <= 2.0 ** -10 * 1.01
                              for _, r in flips)
                and abs(explained - gap) <= 0.1 * abs(gap)),
                f"K13 {label} default: the worst body's gap {gap:.3e} "
                f"({share:.2f}x WithinRel 1e-5) is not one-ulp W flips: "
                f"{flips} explain {explained:.3e}")
            print(line + f"against its plain version WithinRel 1e-3 at "
                         f"{wpl:.4f}, rms {rms_k:.3e} of the force's (tol "
                         f"2e-5; the truncating control {rms_c:.3e}); the "
                         f"worst body at {share:.2f}x WithinRel 1e-5, gap "
                         f"{gap:.4e}, of which its W flips (source, ratio "
                         f"- 1: {flips}) give {explained:.4e}")
        for bi, bj in itertools.product(cuda.SWEEP_BLOCKS, repeat=2):
            got = acc_mxu_rect(*iset, *jset, SOFT, block_i=bi, block_j=bj)
            torch.cuda.synchronize()
            w = within_rel(got, ref, 5e-4, 5e-4)
            err = max(float((g.double() - r).abs().max())
                      for g, r in zip(got, ref))
            rel = norm_rel(got, ref)
            check(w <= 1.0, f"K13 {label} blocks {bi}x{bj}: WithinRel 5e-4 "
                            f"(rms floor 5e-4) exceeded by {w:.2f}x")
            ms = time_ms(lambda: acc_mxu_rect(*iset, *jset, SOFT, block_i=bi,
                                              block_j=bj), reps=3, runs=3)
            print(f"[10 K13 {label} blocks {bi}x{bj}] max|da|/max|a| "
                  f"{err / scale:.3e}, per-body rel {rel:.3e}, WithinRel "
                  f"5e-4 at {w:.3f} of the allowance; kernel {ms:.4f} ms")
            worst13 = max(worst13, w)
            max_rel13 = max(max_rel13, err / scale)
    plain13 = {label: time_ms(lambda: acc_mxu_rect_plain(*iset, *jset, SOFT),
                              reps=1, runs=3)
               for label, (iset, jset, _) in cases10.items()}
    print(f"[10 K13] worst WithinRel share {worst13:.3f}, worst "
          f"max|da|/max|a| {max_rel13:.3e} over {len(cases10)} shapes x "
          f"{len(cuda.SWEEP_BLOCKS) ** 2} block pairs; plain (fp32, TF32 "
          f"arithmetic) {json.dumps(plain13)} ms")
    # S's tier mapping: one TF32 product on S (the plain version without
    # the targets' small parts) on the 200k galaxy's sample and the 16384^2
    # random box; S takes one product at s_precision "default" only if both
    # stay within WithinRel 5e-4 (rms floor 5e-4) against float64
    r16 = init_random(16_384, SEED, device=dev)
    qr16 = (r16.qx, r16.qy, r16.qz,
            r16.m * torch.tensor(G, dtype=torch.float32).item())
    qr16_64 = tuple(v.double() for v in qr16)
    study = {}
    for label, (iset, jset, ref) in (
            ("galaxy rect 4096x200k", cases10["rect 4096x200k"]),
            ("random 16384^2", (qr16[:3], qr16,
                                acc_mxu_rect_plain(*qr16_64[:3], *qr16_64,
                                                   SOFT)))):
        one = mxu_ops._acc_plain(*iset, *jset, SOFT, 1, 2)
        study[label] = within_rel(one, ref, 5e-4, 5e-4)
    one_ok = all(v <= 1.0 for v in study.values())
    check(mxu_ops.tier_passes("high", "default")[0] == (1 if one_ok else 2),
          f"S's mapping at s_precision 'default' disagrees with the study "
          f"{study}")
    print(f"[10 K13 S study] one TF32 product on S against float64, share "
          f"of WithinRel 5e-4: {json.dumps(study)}; s_precision 'default' "
          f"takes {mxu_ops.tier_passes('high', 'default')[0]} products")
    del cases10, q16_64, r16, qr16, qr16_64
    torch.cuda.empty_cache()

    # the main path through the CLI, from zeroed counts; the step's last
    # acceleration held to a float64 direct sweep on 512 strided rows
    res10, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "10", "--im", "tpu+mxu", "--nv", "--gf",
        "--scan", "--device", "cuda"]))
    check(res10.rc == 0, f"cli tpu+mxu exit code {res10.rc}")
    e10 = res10.engine
    e10.assert_finite()
    launches["K13"] = counts["K13"]
    check(counts["K13"] > 0, f"K13 launched no time on tpu+mxu: {counts}")
    f10 = e10.bodies
    err10 = measured_force_error(
        f10.qx, f10.qy, f10.qz, e10._gm(f10), SOFT,
        lambda a, b, cc, g: e10._acc_fn(a, b, cc, g))
    check(err10 <= 5e-4, f"tpu+mxu force error {err10:.3e} > 5e-4")
    bi0, bj0 = e10.block_i, e10.block_j
    # the main path's launch (its blocks, "high") on the initial 200k
    # galaxy against its plain version at the same tier (WithinRel 1e-5,
    # rms floor 1e-5) and against the float64 direct sweep of the whole
    # galaxy (the tier's WithinRel 5e-4, rms floor 5e-4; the share of K3's
    # contract, 1e-5 with an rms floor of 5e-6, printed beside)
    n10 = s10.npad
    got13 = acc_mxu_rect(*q10[:3], *q10, SOFT, block_i=bi0, block_j=bj0)
    plain13_main = acc_mxu_rect_plain(*q10[:3], *q10, SOFT)
    ref13 = [r[:n10] for r in ref11]
    wpl13 = within_rel(got13, plain13_main, 1e-5, 1e-5)
    w64_13 = within_rel(got13, ref13, 5e-4, 5e-4)
    w64_13k3 = within_rel(got13, ref13, 1e-5, 5e-6)
    abs13 = max(float((g.double() - r).abs().max())
                for g, r in zip(got13, ref13))
    check(wpl13 <= 1.0, f"K13 {n10}^2 (the main path's launch): WithinRel "
                        f"1e-5 against its plain version exceeded by "
                        f"{wpl13:.2f}x")
    check(w64_13 <= 1.0, f"K13 {n10}^2 (the main path's launch): WithinRel "
                         f"5e-4 against float64 exceeded by {w64_13:.2f}x")
    print(f"[10 K13 main launch {n10}x{n10} blocks {bi0}x{bj0} high] "
          f"against its plain version WithinRel 1e-5 (rms floor 1e-5) at "
          f"{wpl13:.4f}; against the float64 sweep of the whole galaxy "
          f"WithinRel 5e-4 at {w64_13:.4f} (1e-5 with rms floor 5e-6 at "
          f"{w64_13k3:.4f}), max|da| {abs13:.3e}, max|da|/max|a| "
          f"{abs13 / max(float(r.abs().max()) for r in ref13):.3e}")
    del got13, plain13_main, ref13
    ms13 = time_ms(lambda: acc_mxu_rect(*q10[:3], *q10, SOFT, block_i=bi0,
                                        block_j=bj0), reps=5, runs=3)
    ms13d = time_ms(lambda: acc_mxu_rect(*q10[:3], *q10, SOFT, block_i=bi0,
                                         block_j=bj0, precision="default"),
                    reps=5, runs=3)
    plain_ms13 = time_ms(lambda: acc_mxu_rect_plain(*q10[:3], *q10, SOFT),
                         reps=1, runs=3)
    # K13's floor is the larger of: one MUFU rsqrt a pair at 16 a clock an
    # SM (the card's SMs at clocks.max.sm), its TF32 products at the 495
    # TFLOP/s dense peak ("high": two m16n8k8 for S and two for P a 16 x 8
    # tile, 64 flops a pair; "default" 48), and the fp32 work left (3 flops
    # a pair) at 67 TFLOP/s.  Bytes: the bodies (3 values a target, 4 a
    # source) in and the force out, each once (K13 builds its operands
    # itself).  The 20-flop model of K3 is printed beside it.
    pairs = float(n10) * n10
    floors = {"mufu": pairs / (16 * sms * clk) * 1e3,
              "tensor": 64 * pairs / 495e12 * 1e3,
              "fp32": 3 * pairs / PEAK_FP32 * 1e3}
    b13 = keep("K13", abs13, ms13, plain_ms13, 40 * n10, 3 * pairs,
               max(floors.values()))
    b13_20 = bound(40 * n10, 20 * pairs)[0]
    fps["tpu+mxu 200k"] = res10.fps
    print(f"[10 main] tpu+mxu N={n_main} galaxy through the CLI: blocks "
          f"{bi0}x{bj0} (kernel default), {res10.fps:.3f} FPS "
          f"{res10.gflops:.1f} ref-GFlop/s ({res10.elapsed_ms:.2f} ms for 9 "
          f"steps); force error after 10 steps {err10:.3e} (tol 5e-4); K13 "
          f"at {n10}^2 {ms13:.4f} ms (\"default\" {ms13d:.4f} ms), plain "
          f"{plain_ms13:.4f} ms, bound {b13:.4f} ms (floors, ms: "
          f"{json.dumps(floors)} at {clk / 1e6:.0f} MHz; the 20-flop model "
          f"{b13_20:.4f}) on {smi}; launches {counts}")

    # the wrapper engines on K13: tpu+tracking --kernel mxu, row 0's energy
    # against the exact K6 energy of the same state (phase 7)
    csv = os.path.join(tmpdir.name, "mxu_tracking.csv")
    res10t, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "3", "--im", "tpu+tracking", "--kernel",
        "mxu", "--nv", "--scan", "--csv", csv, "--device", "cuda"]))
    check(res10t.rc == 0, f"cli tpu+tracking --kernel mxu exit {res10t.rc}")
    res10t.engine.assert_finite()
    check(counts["K13"] > 0, f"K13 launched no time under --kernel mxu: "
                             f"{counts}")
    rows_finite(res10t.engine.history, 3, csv)
    e0 = float(res10t.engine.history.energies[0])
    rel = abs(e0 / e_exact - 1.0)
    check(rel <= 1e-5, f"tracked mxu energy row 0 {e0:.6e} vs exact "
                       f"{e_exact:.6e}: rel {rel:.3e} > 1e-5")
    print(f"[10 tracked] tpu+tracking --kernel mxu N={n_main}: energy row 0 "
          f"{e0:.9e} vs exact K6 {e_exact:.9e} (rel {rel:.3e}, tol 1e-5); "
          f"{res10t.fps:.3f} FPS; launches {counts}")

    # --autotune through the CLI under a temporary cache: each candidate's
    # time, then a second run that reads the winner without sweeping
    os.environ["MURB_TUNE_CACHE"] = os.path.join(tmpdir.name, "tune.json")
    sweep_calls = []
    measure = at.measure_steps

    def counted(*a, **k):
        sweep_calls.append(1)
        return measure(*a, **k)

    at.measure_steps = counted
    tuned = {}
    try:
        for tag, n in (("tpu+mxu", n_main), ("tpu+hybrid", 16_384),
                       ("tpu+hybrid", n_main)):
            argv = ["-n", str(n), "-i", "3", "--im", tag, "--nv", "--scan",
                    "--device", "cuda"]
            del sweep_calls[:]
            r1 = cli.run(argv + ["--autotune"])
            n_swept = len(sweep_calls)
            r2 = cli.run(argv)
            check(r1.rc == 0 and r2.rc == 0, f"--autotune {tag} n={n}")
            t1 = r1.engine.tuned
            check(t1 is not None and "sweep" in t1 and n_swept > 0,
                  f"--autotune {tag} n={n} did not sweep")
            check(len(sweep_calls) == n_swept and "sweep" not in
                  r2.engine.tuned and (r2.engine.block_i, r2.engine.block_j)
                  == (r1.engine.block_i, r1.engine.block_j),
                  f"{tag} n={n}: the second run did not read the winner")
            cands = {f"{p['block_i']}x{p['block_j']}": ms
                     for p, ms in t1["sweep"]}
            tuned[f"{tag} n={n}"] = cands
            print(f"[10 autotune] {tag} N={n} ({n_swept} candidates): "
                  f"winner {r1.engine.block_i}x{r1.engine.block_j} "
                  f"{t1['ms_per_step']:.4f} ms/step; second run read "
                  f"{r2.engine.block_i}x{r2.engine.block_j} with no sweep; "
                  f"ms/step by blocks {json.dumps(cands)} on {smi}")
    finally:
        at.measure_steps = measure
        del os.environ["MURB_TUNE_CACHE"]

    # checkpoint and resume: 10 steps, save, load, 10 more, against 20
    # straight (K13 sums in a fixed order, so the two must agree bit for
    # bit)
    ck = os.path.join(tmpdir.name, "mxu.npz")
    base = ["-n", str(n_main), "--im", "tpu+mxu", "--nv", "--scan",
            "--device", "cuda"]
    ra = cli.run(base + ["-i", "10", "--save-state", ck])
    rb = cli.run(base + ["-i", "10", "--load-state", ck])
    rc_ = cli.run(base + ["-i", "20"])
    check(ra.rc == rb.rc == rc_.rc == 0, "checkpoint runs")
    pb, pc = rb.engine.bodies.to_numpy(), rc_.engine.bodies.to_numpy()
    diff = max(float(np.max(np.abs(pb[k].astype(np.float64) - pc[k])))
               for k in ("qx", "qy", "qz", "vx", "vy", "vz"))
    check(diff == 0.0, f"resumed run differs from the straight run by "
                       f"{diff:.3e}")
    print(f"[10 checkpoint] tpu+mxu N={n_main}: 10 steps, save, load, 10 "
          f"more against 20 straight: max |difference| {diff:g} (bit "
          f"for bit)")

    # trajectory dump: frames 0, 5, 10, the last one the final state
    tr = os.path.join(tmpdir.name, "mxu.traj")
    rd = cli.run(base + ["-i", "10", "--dump-traj", tr, "--dump-every", "5"])
    check(rd.rc == 0, "cli --dump-traj")
    from murb_tpu_torch.io import read_trajectory

    fidx, fpos = read_trajectory(tr)
    fin10 = rd.engine.bodies.unpadded()
    check(fidx.tolist() == [0, 5, 10] and fpos.shape == (3, n_main, 3),
          f"trajectory frames {fidx.tolist()} shape {fpos.shape}")
    check(all(np.array_equal(fpos[2][:, c], fin10[k])
              for c, k in enumerate(("qx", "qy", "qz"))),
          "the last frame is not the final state")
    check(np.array_equal(fpos[0][:, 0], s10.unpadded()["qx"]),
          "frame 0 is not the initial state")
    print(f"[10 dump] tpu+mxu --dump-traj --dump-every 5: frames "
          f"{fidx.tolist()}, {fpos.shape}, frame 10 equals the final state")
    print(f"[10 fps] {json.dumps(fps)} on {smi}")
    del s10, q10, s16, q16, e10, f10
    torch.cuda.empty_cache()

    # ----------------------------- 11. the distributed modes, K14
    # Shards on one card (an explicit device list): the protocol is
    # checked, not a link.  K14 against its plain version in float64 on the
    # 200k galaxy at D = 1 to 4 (D = 3 the smallest with the capacity
    # handshake), each with and without a 5 us sleep before every copy and
    # compute; contract WithinRel 1e-5 (tests/test_ring_pallas.py:67-69)
    # with the rms floor 5e-6 of K3's 16384^2 check (sums over 200k
    # sources in fp32).  The reference is phase 10's float64 sweep of the
    # whole state (ref11): ghost rows (zero mass) change no real row, so
    # each D's padding compares its own rows.
    from murb_tpu_torch.ops.ring import (acc_ring_pipelined,
                                         acc_ring_pipelined_plain, ring_split)
    from murb_tpu_torch.parallel.mesh import make_mesh, shard_state

    wrappers["K14"] = acc_ring_pipelined

    # K3 at 200,192^2 (the galaxy, in K3's j split) against the same
    # float64 sweep, at the contract of these 200k sums: WithinRel 1e-5,
    # rms floor 5e-6; two launches must give the same bits
    s3 = init_galaxy(n_main, SEED, device=dev)
    q3, n3 = (s3.qx, s3.qy, s3.qz, g_of(s3)), s3.npad
    got = acc_tile_rect(*q3[:3], *q3, SOFT)
    again = acc_tile_rect(*q3[:3], *q3, SOFT)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K3 {n3}^2: two launches differ")
    ref3 = [r[:n3] for r in ref11]
    w3 = within_rel(got, ref3, 1e-5, 5e-6)
    err3 = max(float((g.double() - r).abs().max())
               for g, r in zip(got, ref3))
    check(w3 <= 1.0, f"K3 {n3}^2: WithinRel 1e-5 (rms floor 5e-6) "
                     f"exceeded by {w3:.2f}x")
    ms3 = time_ms(lambda: acc_tile_rect(*q3[:3], *q3, SOFT), reps=5,
                  runs=3)
    print(f"[11 K3 tile {n3}x{n3}] galaxy, "
          f"{cuda.tile_split(n3, n3, sms, resident)[0]} j slice(s): max|da| "
          f"{err3:.3e}, WithinRel 1e-5 (rms floor 5e-6) against the "
          f"float64 sweep at {w3:.4f} of the allowance; the same bits "
          f"twice; kernel {ms3:.4f} ms bound "
          f"{bound(40 * n3, 20 * n3 * n3)[0]:.4f} ms on {smi}")
    # the K4 tiers at this size against the same sweep: passes 2 in K3's
    # split and unsplit, and passes 3, which must read at most half of the
    # unsplit fp32 sum's error and within its 4e-7 (as at 16384^2),
    # launched twice for the same bits, with its time and bound
    p3 = acc_hybrid_rect(*q3[:3], *q3, SOFT, passes=3)
    check(all(torch.equal(a, b) for a, b in zip(
        p3, acc_hybrid_rect(*q3[:3], *q3, SOFT, passes=3))),
        f"K4 passes=3 at {n3}^2: two launches differ")
    tiers = {"passes 2 split": norm_rel(got, ref3),
             "passes 2 unsplit": norm_rel(k4_whole(
                 [v.contiguous() for v in q3[:3]], q3[3].contiguous()), ref3),
             "passes 3": norm_rel(p3, ref3)}
    check(tiers["passes 3"] <= 0.5 * tiers["passes 2 unsplit"]
          and tiers["passes 3"] <= 4e-7,
          f"K4 passes=3 error {tiers['passes 3']:.3e} at {n3}^2 is not "
          f"within 4e-7 and at most half of the unsplit fp32 sum's "
          f"{tiers['passes 2 unsplit']:.3e}")
    ms_p3 = time_ms(lambda: acc_hybrid_rect(*q3[:3], *q3, SOFT, passes=3),
                    reps=3, runs=3)
    floors = ext_bound_ms(n3, n3, sms, clk)
    b_p3 = max(bound(40 * n3, 0)[0], *floors.values())
    print(f"[11 K4 tiers {n3}x{n3}] max relative force error against the "
          f"float64 sweep: " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in tiers.items())
          + f"; passes 3 within 4e-7 and at most half the unsplit reading, "
          f"the same bits twice, in {acc_hybrid_split(n3)} j slices: "
          f"kernel {ms_p3:.4f} ms bound {b_p3:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in floors.items())
          + f") on {smi}")
    del p3
    # K4 passes 1 at this size: against the same float64 sweep within the
    # tier's 5.1e-3, over the whole galaxy and its 512-row strided sample
    # (ops/validate's), twice for the same bits, and in turns with K3 (K3,
    # p1, p1, K3)
    f11 = lambda: acc_hybrid_rect(*q3[:3], *q3, SOFT, passes=1)
    k3f = lambda: acc_tile_rect(*q3[:3], *q3, SOFT)
    p1 = f11()
    check(all(torch.equal(a, b) for a, b in zip(p1, f11())),
          f"K4 passes=1 at {n3}^2: two launches differ")
    idx512 = torch.linspace(0, s3.n - 1, 512, device=dev).long()
    rel_all = norm_rel(p1, ref3)
    rel_512 = norm_rel([v[idx512] for v in p1], [r[idx512] for r in ref3])
    check(max(rel_all, rel_512) <= 5.1e-3,
          f"K4 passes=1 at {n3}^2: max relative force error {rel_all:.3e} "
          f"(512-row sample {rel_512:.3e}) > 5.1e-3")
    t11 = [time_ms(f, reps=3, runs=3) for f in (k3f, f11, f11, k3f)]
    floors = fast_bound_ms(n3, n3, sms, clk)
    print(f"[11 K4 passes=1 {n3}x{n3}] galaxy, j split "
          f"{fast_split_args(n3, n3, 0, 0, dev)[0][:2]}: max relative force "
          f"error against the float64 sweep {rel_all:.3e}, on the 512-row "
          f"sample {rel_512:.3e} (contract 5.1e-3); the same bits twice; in "
          f"turns K3, p1, p1, K3: " + ", ".join(f"{t:.4f}" for t in t11)
          + " ms; bound " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in floors.items())
          + f" ms on {smi}")
    del p1
    del s3, q3, got, again, ref3
    k14 = {}
    for d in (1, 2, 3, 4):
        sd = init_galaxy(n_main, SEED, device=dev).repad(256 * d)
        mesh_d = make_mesh(devices=[dev] * d)
        blocks = shard_state(sd, mesh_d)
        qs = [(b.qx, b.qy, b.qz) for b in blocks]
        gs = [g_of(b) for b in blocks]
        nd = sd.npad
        for delay in (0, 5000):
            acc = acc_ring_pipelined(mesh_d, qs, gs, SOFT, delay_ns=delay)
            torch.cuda.synchronize()
            if d == 1:
                # one ring step is one K3 sweep at K3's own geometry and
                # split: the same bits
                k3 = acc_tile_rect(*qs[0], *qs[0], gs[0], SOFT)
                check(all(torch.equal(a, b) for a, b in zip(acc[0], k3)),
                      f"K14 D=1 delay={delay} ns differs from K3 at the "
                      f"same geometry and split")
            got = [torch.cat([a[c] for a in acc]) for c in range(3)]
            ref_d = [r[:nd] for r in ref11]
            w = within_rel(got, ref_d, 1e-5, 5e-6)
            err = max(float((g.double() - r).abs().max())
                      for g, r in zip(got, ref_d))
            check(w <= 1.0, f"K14 D={d} delay={delay} ns: WithinRel 1e-5 "
                            f"(rms floor 5e-6) exceeded by {w:.2f}x")
            ms = time_ms(lambda: acc_ring_pipelined(mesh_d, qs, gs, SOFT,
                                                    delay_ns=delay),
                         reps=5, runs=3)
            # the plain version: the same protocol with torch ops, fp32
            plain = "" if delay else "{:.4f} ms".format(time_ms(
                lambda: acc_ring_pipelined_plain(mesh_d, qs, gs, SOFT),
                reps=1, runs=1))
            b_ms, _ = bound(28 * nd, 20 * nd * nd)
            split = ring_split(nd // d, sms, resident, d)
            print(f"[11 K14 ring N={nd} D={d} delay={delay} ns] max|da| "
                  f"{err:.3e}, WithinRel 1e-5 (rms floor 5e-6) at {w:.4f} "
                  f"of the allowance" + (", bit for bit K3's sweep" if d == 1
                                         else "")
                  + f"; kernel {ms:.4f} ms ({d * d} K3 sweeps in "
                  f"{split[0]} j slices each, {d * (d - 1)} slot copies of "
                  f"{16 * nd // d} bytes) bound {b_ms:.4f} ms"
                  + (f" plain {plain}" if plain else ""))
            if delay == 0:
                k14[d] = (err, ms, float(plain.split()[0]))
        if d == 4:
            keep("K14", *k14[4], 28 * nd, 20 * nd * nd)
    del blocks, qs, gs, acc, got
    torch.cuda.empty_cache()
    # K14 across 2 to 4 processes on this card (CUDA IPC, flag words)
    launches.update(phase11_processes(dev, smi, ref11, time_ms, keep,
                                      n_main, tmpdir.name))
    del ref11
    torch.cuda.empty_cache()

    # the main path through the CLI: --shards 1 is the mesh this card has,
    # K14 at D = 1 (pure compute); the force error after 10 steps held to
    # 5e-4 as tpu+mxu's
    res11, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "10", "--im", "shard+ring", "--shards", "1",
        "--nv", "--gf", "--scan", "--device", "cuda"]))
    check(res11.rc == 0, f"cli shard+ring exit code {res11.rc}")
    e11 = res11.engine
    e11.assert_finite()
    check(e11.ring_impl == "pipelined" and e11.n_shards == 1,
          f"shard+ring took {e11.ring_impl} on {e11.n_shards} shards")
    check(counts["K14"] > 0, f"K14 launched no time on shard+ring: {counts}")
    f11 = e11.bodies
    err11 = measured_force_error(
        f11.qx, f11.qy, f11.qz, g_of(f11), SOFT,
        lambda a, b, cc, g: acc_ring_pipelined(e11.mesh, [(a, b, cc)], [g],
                                               SOFT)[0])
    check(err11 <= 5e-4, f"shard+ring force error {err11:.3e} > 5e-4")
    fps["shard+ring --shards 1"] = res11.fps
    print(f"[11 main] shard+ring --shards 1 N={n_main} galaxy through the "
          f"CLI: {res11.fps:.3f} FPS {res11.gflops:.1f} ref-GFlop/s "
          f"({res11.elapsed_ms:.2f} ms for 9 steps); force error after 10 "
          f"steps {err11:.3e} (tol 5e-4) on {smi}; launches {counts}")

    # 4 shards on cuda:0 against the single-device exact sweep (tpu+tile,
    # K3): one step's accelerations, the positions after 10 steps at
    # tests/test_parallel.py:33-34's 1e-3 (rms floor 1e-6)
    s4 = init_galaxy(n_main, SEED, device=dev)
    quad = [dev] * 4
    (e4, fps4), counts = drive(lambda: timed(create_engine(
        "shard+ring", s4, soft=SOFT, dt=DT, devices=quad), 10))
    launches["K14"] = counts["K14"]
    check(counts["K14"] > 0, f"K14 launched no time on 4 shards: {counts}")
    e4.assert_finite()
    (et4, fps_t4), counts_t = drive(lambda: timed(create_engine(
        "tpu+tile", s4, soft=SOFT, dt=DT), 10))
    p4, pt4 = e4.bodies.unpadded(), et4.bodies.unpadded()
    for c in ("qx", "qy", "qz"):
        wpos = within_rel([torch.from_numpy(p4[c])],
                          [torch.from_numpy(pt4[c])], 1e-3, 1e-6)
        check(wpos <= 1.0, f"shard+ring 4 shards vs tpu+tile {c} after 10 "
                           f"steps: WithinRel 1e-3 exceeded by {wpos:.2f}x")
    a1 = create_engine("shard+ring", s4, soft=SOFT, dt=DT, devices=quad)
    t1 = create_engine("tpu+tile", s4, soft=SOFT, dt=DT)
    a1.compute_one_iteration()
    t1.compute_one_iteration()
    acc_a = [a[:s4.npad] for a in a1.accelerations]
    acc_t = list(t1.accelerations)
    wacc = within_rel(acc_a, acc_t, 1e-5, 1e-7)
    check(wacc <= 1.0, f"shard+ring 4 shards vs tpu+tile: one step's "
                       f"accelerations exceed WithinRel 1e-5 (rms floor "
                       f"1e-7) by {wacc:.2f}x")
    print(f"[11 ring 4 shards] create_engine shard+ring devices=[cuda:0]*4 "
          f"N={n_main}: {fps4:.3f} FPS over 9 steps after one, tpu+tile "
          f"{fps_t4:.3f} FPS (K3 launches {counts_t['K3']}); one step's "
          f"accelerations against tpu+tile at {wacc:.4f} of WithinRel 1e-5 "
          f"(rms floor 1e-7); positions after 10 steps within 1e-3; "
          f"launches {counts}")
    fps["shard+ring 4 shards"] = fps4
    fps["tpu+tile"] = fps_t4

    # the sharded checkpoint: a 4-shard state on the card, bit for bit
    ck11 = os.path.join(tmpdir.name, "ring4")
    e4.save_sharded(ck11)
    e4b = create_engine("shard+ring", s4, soft=SOFT, dt=DT, devices=quad)
    meta11 = e4b.load_sharded(ck11)
    same = all(torch.equal(getattr(x, k), getattr(y, k))
               for x, y in zip(e4.blocks, e4b.blocks)
               for k in ("m", "r", "qx", "qy", "qz", "vx", "vy", "vz"))
    check(same and meta11["iteration"] == 10,
          f"sharded checkpoint round trip: same={same} meta={meta11}")
    print(f"[11 checkpoint] save_sharded -> load_sharded of 4 shards on the "
          f"card: bit for bit, iteration {meta11['iteration']}")
    del e4, e4b, et4, a1, t1
    torch.cuda.empty_cache()

    # shard+allgather and shard+uneven (0.6) on 4 shards of the card against
    # the single-device exact engine (tpu+hybrid, passes 2): 3 steps each,
    # positions at 1e-3 (rms floor 1e-6); both run K4's wrapper
    (eh, _), _ = drive(lambda: timed(create_engine(
        "tpu+hybrid", s4, soft=SOFT, dt=DT), 3))
    ph = eh.bodies.unpadded()
    for tag, kw in (("shard+allgather", {}),
                    ("shard+uneven", {"gpu_fraction": 0.6})):
        (es, fps_s), counts = drive(lambda: timed(create_engine(
            tag, s4, soft=SOFT, dt=DT, devices=quad, **kw), 3))
        es.assert_finite()
        check(counts["K4"] > 0, f"K4 launched no time under {tag}: {counts}")
        ps = es.bodies.unpadded()
        worst = max(within_rel([torch.from_numpy(ps[c])],
                               [torch.from_numpy(ph[c])], 1e-3, 1e-6)
                    for c in ("qx", "qy", "qz"))
        check(worst <= 1.0, f"{tag} vs tpu+hybrid: {worst:.2f}x of 1e-3")
        fps[f"{tag} 4 shards"] = fps_s
        print(f"[11 {tag}] 4 shards on the card {kw}: {fps_s:.3f} FPS over "
              f"2 steps after one; positions after 3 steps at {worst:.4f} "
              f"of WithinRel 1e-3 against tpu+hybrid; launches {counts}")
    del eh, es
    torch.cuda.empty_cache()

    # shard+proxy on the 200k galaxy (4 shards): one expansion, K1/K2
    (ep, fps_p), counts = drive(lambda: timed(create_engine(
        "shard+proxy", s4, soft=SOFT, dt=DT, devices=quad), 20))
    ep.assert_finite()
    check(ep.mode == "proxy", f"shard+proxy took mode {ep.mode}")
    check(ep.validated_err is not None and ep.validated_err <= TOL,
          f"shard+proxy validated error {ep.validated_err}")
    check(counts["K1"] > 0 and counts["K2"] > 0,
          f"K1/K2 launched no time under shard+proxy: {counts}")
    fps["shard+proxy 4 shards"] = fps_p
    print(f"[11 shard+proxy] 4 shards, N={n_main} galaxy: m={ep.m}, "
          f"validated_err {ep.validated_err:.3e}; {fps_p:.3f} FPS over 19 "
          f"steps after one; launches {counts}")
    del ep

    # shard+fmm: shard+proxy promoted on the 200k random box, the (m, L)
    # of the single-device policy (phase 8's pick)
    r11 = init_random(n_main, SEED, device=dev)
    (ef, fps_f), counts = drive(lambda: timed(create_engine(
        "shard+proxy", r11, soft=SOFT, dt=DT, devices=quad), 20))
    ef.assert_finite()
    check(ef.mode == "fmm" and (ef.m, ef.levels) == pick8,
          f"shard+proxy -s random took {ef.mode} ({ef.m}, {ef.levels}), "
          f"tpu+proxy {pick8}")
    check(all(counts[k] > 0 for k in ("K7", "K8", "K9")),
          f"K7-K9 launched no time under shard+fmm: {counts}")
    check(ef.validated_err is not None and ef.validated_err <= TOL,
          f"shard+fmm validated error {ef.validated_err}")
    fps["shard+fmm 4 shards"] = fps_f
    print(f"[11 shard+fmm] 4 shards, N={n_main} random: (m, L)=({ef.m}, "
          f"{ef.levels}) as tpu+proxy, validated_err {ef.validated_err:.3e};"
          f" {fps_f:.3f} FPS over 19 steps after one; launches {counts}")
    del ef, r11

    # shard+adaptive: the 1M two-cluster box of phase 9 on 1 shard, and the
    # merger on 2 shards of the card
    for label, state, kw, soft_a, dt_a, steps in (
            ("1M two clusters, 1 shard", st9, {"shards": 1}, soft9, dt9, 4),
            (f"merger N={mg.n}, 2 shards", mg, {"devices": [dev] * 2}, SOFT,
             DT, 10)):
        t1 = time.perf_counter()
        (ea, fps_a), counts = drive(lambda: timed(create_engine(
            "shard+adaptive", state, soft=soft_a, dt=dt_a, **kw), steps))
        t_a = time.perf_counter() - t1
        ea.assert_finite()
        ha = ea.proxy_health()
        check(ha["ok"], f"shard+adaptive {label}: health {ha}")
        check(all(counts[k] > 0 for k in ("K10", "K11", "K12")),
              f"K10-K12 launched no time under shard+adaptive {label}: "
              f"{counts}")
        check(ea.validated_err is not None and ea.validated_err <= TOL,
              f"shard+adaptive validated error {ea.validated_err}")
        fps[f"shard+adaptive {label}"] = fps_a
        print(f"[11 shard+adaptive] {label}: m={ea.m} L={ea.levels}, "
              f"validated_err {ea.validated_err:.3e}, health {ha}; "
              f"{fps_a:.4f} FPS over {steps - 1} steps after one (build and "
              f"steps {t_a:.1f} s); launches {counts}")
        del ea
        torch.cuda.empty_cache()
    print(f"[11 fps] {json.dumps(fps)} on {smi}")
    torch.cuda.empty_cache()

    # ------------------------------- 12. the differentiable rollouts
    phase12(dev, smi, drive, within_rel)
    torch.cuda.empty_cache()

    # -------------------- 13. the viewer and the profiler through the CLI
    phase13(smi)

    # ---------------------------------------- 14. the lossy M2L tiers
    record["K7b"], launches["K7b"] = phase14(dev, smi, drive, time_ms, st9,
                                             soft9, plan, pick8)
    torch.cuda.empty_cache()

    # ------------------------------------------------- 15. the bf16 state
    launches.update(phase15(dev, smi, drive, time_ms, within_rel, norm_rel,
                            keep, n_main, fp32_bytes))
    launches.update(phase15_adaptive(dev, smi, drive, time_ms, keep,
                                     rel_max, near_body_pairs, e9, st9,
                                     soft9, dt9, tab))
    launches.update(phase15_sweeps(dev, smi, drive, time_ms, keep,
                                   within_rel, norm_rel, tab, n_main))
    torch.cuda.empty_cache()

    # ------------------------------ 16. the planners' decisions on the card
    phase16(dev, smi, st9, est9, 1e3 / fps9, 1e3 / fps_exact9, tab, pick8,
            n_main)

    # ----------------------- 17. the fast solver's stage geometry, autotune
    phase17(dev, smi, time_ms, n_main, tmpdir.name)

    for k, count in launches.items():
        check(count > 0, f"{k} launched no time on its piece of the path")
    meta = {
        "K1": ("p2m", "murb_tpu_torch/csrc/cell_runs.cuh",
               "murb_tpu/ops/proxy_pallas.py:112"),
        "K2": ("l2p", "murb_tpu_torch/csrc/proxy.cu",
               "murb_tpu/ops/proxy_pallas.py:170"),
        "K3": ("tile_rect", "murb_tpu_torch/csrc/tile.cu",
               "murb_tpu/ops/tile_pallas.py:39"),
        "K4": ("sweep_rows_ext", "murb_tpu_torch/csrc/hybrid.cu",
               "murb_tpu/ops/hybrid.py:63"),
        "K5": ("phi_rows", "murb_tpu_torch/csrc/phi_rows.cu",
               "murb_tpu/ops/hybrid.py:219"),
        "K6": ("acc_phi_rows", "murb_tpu_torch/csrc/phi.cu",
               "murb_tpu/ops/hybrid.py:338"),
        "K7": ("m2l_level", "murb_tpu_torch/csrc/fmm.cu",
               "murb_tpu/ops/fmm_pallas.py:85"),
        "K7b": ("m2l_level_lossy_3xtf32", "murb_tpu_torch/csrc/fmm.cu",
                "murb_tpu/ops/fmm_pallas.py:85"),
        "K8": ("p2m_grid", "murb_tpu_torch/csrc/cell_runs.cuh",
               "murb_tpu/ops/fmm_pallas.py:315"),
        "K9": ("l2p_grid", "murb_tpu_torch/csrc/cell_runs.cuh",
               "murb_tpu/ops/fmm_pallas.py:371"),
        "K10": ("p2p_sorted", "murb_tpu_torch/csrc/p2p.cu",
                "murb_tpu/ops/p2p_pallas.py:56"),
        "K11": ("p2m_window", "murb_tpu_torch/csrc/cell_runs.cuh",
                "murb_tpu/ops/anterp_pallas.py:139"),
        "K12": ("l2p_window", "murb_tpu_torch/csrc/cell_runs.cuh",
                "murb_tpu/ops/anterp_pallas.py:244"),
        "K13": ("mxu_rect", "murb_tpu_torch/csrc/mxu.cu",
                "murb_tpu/ops/mxu.py:49"),
        "K14": ("ring_pipelined", "murb_tpu_torch/csrc/ring.cu",
                "murb_tpu/ops/ring_pallas.py:50"),
        # the bf16 instances (phase 15): the same TPU kernels, which took
        # bf16 refs and upcast them in their bodies
        "K1-bf16": ("p2m_bf16", "murb_tpu_torch/csrc/cell_runs.cuh",
                    "murb_tpu/ops/proxy_pallas.py:112"),
        "K2-bf16": ("l2p_bf16", "murb_tpu_torch/csrc/proxy.cu",
                    "murb_tpu/ops/proxy_pallas.py:170"),
        "K3-bf16": ("tile_rect_bf16", "murb_tpu_torch/csrc/tile.cu",
                    "murb_tpu/ops/tile_pallas.py:39"),
        "K4-bf16": ("sweep_rows_ext_bf16", "murb_tpu_torch/csrc/hybrid.cu",
                    "murb_tpu/ops/hybrid.py:63"),
        "K4-p1": ("hybrid_fast", "murb_tpu_torch/csrc/hybrid_fast.cu",
                  "murb_tpu/ops/hybrid.py:63"),
        "K4-p1-bf16": ("hybrid_fast_bf16",
                       "murb_tpu_torch/csrc/hybrid_fast.cu",
                       "murb_tpu/ops/hybrid.py:63"),
        "K8-bf16": ("p2m_grid_bf16", "murb_tpu_torch/csrc/cell_runs.cuh",
                    "murb_tpu/ops/fmm_pallas.py:315"),
        "K9-bf16": ("l2p_grid_bf16", "murb_tpu_torch/csrc/cell_runs.cuh",
                    "murb_tpu/ops/fmm_pallas.py:371"),
        "K10-bf16": ("p2p_sorted_bf16", "murb_tpu_torch/csrc/p2p.cu",
                     "murb_tpu/ops/p2p_pallas.py:56"),
        "K11-bf16": ("p2m_window_bf16", "murb_tpu_torch/csrc/cell_runs.cuh",
                     "murb_tpu/ops/anterp_pallas.py:139"),
        "K12-bf16": ("l2p_window_bf16", "murb_tpu_torch/csrc/cell_runs.cuh",
                     "murb_tpu/ops/anterp_pallas.py:244"),
        "K5-bf16": ("phi_rows_bf16", "murb_tpu_torch/csrc/phi_rows.cu",
                    "murb_tpu/ops/hybrid.py:219"),
        "K6-bf16": ("acc_phi_rows_bf16", "murb_tpu_torch/csrc/phi.cu",
                    "murb_tpu/ops/hybrid.py:338"),
        "K13-bf16": ("mxu_rect_bf16", "murb_tpu_torch/csrc/mxu.cu",
                     "murb_tpu/ops/mxu.py:49"),
        "K14-bf16": ("ring_pipelined_bf16", "murb_tpu_torch/csrc/ring.cu",
                     "murb_tpu/ops/ring_pallas.py:50"),
        # K14 across the processes of one host (phase 11): the same TPU
        # kernel, whose RDMA and semaphores addressed devices of any process
        "K14-ipc": ("ring_pipelined_ipc", "murb_tpu_torch/csrc/ring.cu",
                    "murb_tpu/ops/ring_pallas.py:50"),
        "K14-ipc-bf16": ("ring_pipelined_ipc_bf16",
                         "murb_tpu_torch/csrc/ring.cu",
                         "murb_tpu/ops/ring_pallas.py:50"),
        # K14 across hosts (phase 11): its boundary slot staged through
        # pinned host memory, as the TPU kernel's RDMA crossed hosts
        "K14-hosts": ("ring_pipelined_hosts", "murb_tpu_torch/csrc/ring.cu",
                      "murb_tpu/ops/ring_pallas.py:50"),
        "K14-hosts-bf16": ("ring_pipelined_hosts_bf16",
                           "murb_tpu_torch/csrc/ring.cu",
                           "murb_tpu/ops/ring_pallas.py:50"),
    }
    kernels = [{"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[k], **record[k]}
               for k, (kname, source, replaces) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ring-worker"]:
        sys.exit(ring_worker(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4], sys.argv[5]))
    sys.exit(main())
