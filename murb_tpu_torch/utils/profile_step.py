"""Where the time of a ``tpu+proxy`` or tracked step goes on a CUDA card.

    python -m murb_tpu_torch.utils.profile_step [--scheme S] [--near M]
                                                [--shards D] [--m2l-dots T]
                                                [--m2l-rank R] [TAG ...]

TAG is ``tpu+proxy`` (the default), ``tpu+tracking``,
``tpu+leapfrog+tracking``, ``tpu+mxu`` or ``tpu+tile`` (the exact
norm-expansion sweep K13 or the exact fp32 sweep K3, in the block geometry
a tuned entry or the kernel gives) or one of the
distributed modes ``shard+ring``, ``shard+allgather``, ``shard+proxy`` and
``shard+adaptive``, built through ``create_engine`` with D shards (default
1) on the one card (``devices=[cuda:0] * D``); S is
``galaxy`` (the default), ``random``,
``milkyway_andromeda`` or ``two_clusters``; M is the ``--near`` mode of
``tpu+proxy`` (``auto`` by default).  For the first three schemes, builds
the bodies (N=200,000, seed 123; the merger's 81,920 from
scripts/make_two_galaxy_tab.py) and the engine the way ``python -m
murb_tpu_torch -n N -s S --near M --im TAG --kernel proxy --scan`` does
(validated order, the fused force and potential pass for the tracked
tags, no mid-run adaptation; on the random box the hierarchy, kernels
K7-K9; with ``--near adaptive`` the adaptive hierarchy, K10-K12).
``two_clusters`` is the N=1,048,576 two-cluster box of murb_tpu's bench
row ``adaptive_two_clusters_1m`` (``two_clusters``), built through
``create_engine("tpu+proxy", ..., soft=0.02, dt=1e-6)`` with the auto
policy, as that row drives it.  T is the hierarchies' M2L tier
(``--m2l-dots``: fp32, mixed, bf16x3; the engine validates at it and may
step it toward fp32); R >= 0 replaces the adaptive plan's compression rank
after the engine's validation (``m2l_rank``; -1, the default, keeps the
plan's).  It then runs warm-up steps, and:

  1. times WINDOWS unprofiled windows of WINDOW_STEPS steps on the host
     clock, each ending in ``torch.cuda.synchronize``;
  2. profiles STEPS steps with ``torch.profiler`` and sums the device
     events: kernels, copies and memsets, the rows whose device type is
     CUDA.  This is the profiler table's "Self CUDA time total".  Host
     operator rows are left out, because their device time is the same
     kernels counted again.

It prints the device time and the device events per step, the busy share
(device time per step over the median unprofiled window's time per step),
the device time of the kernels launched inside the sparse M2L
(``ops/sparse_fmm.m2l_sparse_level``, the program's ``sparse_m2l`` span:
the tracer, ``utils/trace``, is on while profiling) where the step runs
it, and the device events that take the most time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from murb_tpu_torch.cli import build_engine
from murb_tpu_torch.utils import trace
from murb_tpu_torch.utils.args import parse_args

N, SEED = 200_000, 123
WARMUP, WINDOWS, WINDOW_STEPS = 5, 3, 200
STEPS = 50      # profiled steps
TOP = 12        # device events listed
TAGS = ("tpu+proxy", "tpu+tracking", "tpu+leapfrog+tracking", "tpu+mxu",
        "tpu+tile", "shard+ring", "shard+allgather", "shard+proxy",
        "shard+adaptive")
SCHEMES = ("galaxy", "random", "milkyway_andromeda", "two_clusters")
#: (warm-up steps, steps per window, profiled steps) of the slower steps,
#: by scheme or tag
SHORT = {"milkyway_andromeda": (2, 20, 10), "two_clusters": (1, 5, 3),
         "tpu+mxu": (2, 20, 10), "tpu+tile": (2, 20, 10),
         "shard+ring": (2, 20, 10),
         "shard+allgather": (2, 20, 10)}
#: murb_tpu's bench row adaptive_two_clusters_1m (bench.py:442-460)
TWO_CLUSTERS_N, TWO_CLUSTERS_SOFT, TWO_CLUSTERS_DT = 1_048_576, 0.02, 1e-6


def two_clusters(n: int = TWO_CLUSTERS_N, seed: int = 42, *,
                 device="cuda"):
    """murb_tpu's bench state ``two_clusters`` (bench.py:72-90), built with
    numpy: two Gaussian clusters (sigma 5 at x = -75 and at (75, 20, -10))
    of n/2 bodies, masses U(0.5, 2) 1e10, at rest."""
    import numpy as np

    from murb_tpu_torch.core.state import BodyState

    rng = np.random.default_rng(seed)
    q = np.concatenate([
        rng.normal(0, 5.0, (n // 2, 3)) + [-75.0, 0.0, 0.0],
        rng.normal(0, 5.0, (n - n // 2, 3)) + [75.0, 20.0, -10.0],
    ]).astype(np.float32)
    m = (rng.uniform(0.5, 2.0, n) * 1e10).astype(np.float32)
    v = np.zeros((n, 3), np.float32)
    return BodyState.from_arrays(m, np.ones(n, np.float32), q[:, 0],
                                 q[:, 1], q[:, 2], v[:, 0], v[:, 1],
                                 v[:, 2], device=device)


def graph_ms(fn, reps: int = 20, runs: int = 5) -> float:
    """Device time (ms) of one call of ``fn``: ``reps`` calls captured in
    one CUDA graph (after one call outside it, for caches and kernel
    attributes), replayed ``runs`` times between CUDA events, the median
    per call.  Unlike events around calls from the host, no host time
    sits between the launches.  ``fn`` must launch only on the current
    stream and read nothing back to the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(out)


def event_ms(fn, reps: int = 3, runs: int = 3) -> float:
    """Time (ms) of one call of ``fn`` as a caller pays it: CUDA events
    around ``reps`` calls from the host (host gaps between the launches
    included), after one warm-up call; the median of ``runs``."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def device_ms(fn, reps: int = 3) -> float | None:
    """Device time (ms) of one call of ``fn``: the device rows of
    ``torch.profiler`` (``device_rows``) over ``reps`` calls, after one
    warm-up call; None (not measured) where the profiler recorded no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in device_rows(prof))
    return us / 1e3 / reps if us > 0 else None


def step_ms(engine, steps: int, windows: int = 3) -> float:
    """Wall time (ms) of one engine step: the median over ``windows`` of
    ``engine.run(steps)`` on the host clock, each ending in a synchronise,
    after one warm-up step."""
    engine.run(1)
    engine.block_until_ready()
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        engine.run(steps)
        engine.block_until_ready()
        out.append((time.perf_counter() - t0) * 1e3 / steps)
    return statistics.median(out)


def fit_relative(rows, ys, names) -> dict:
    """Least squares of ``ys`` on the columns of ``rows`` with relative
    residuals (each row divided by its y), for the calibration probes'
    fits; a column whose coefficient comes out <= 0 is dropped and the
    rest fitted again.  Returns {name: coefficient}, 0.0 for a dropped
    column."""
    import numpy as np

    a = np.asarray(rows, float)
    y = np.asarray(ys, float)
    keep = list(range(a.shape[1]))
    while True:
        coef = np.linalg.lstsq(a[:, keep] / y[:, None], np.ones(len(y)),
                               rcond=None)[0]
        if (coef > 0).all() or len(keep) == 1:
            break
        keep = [k for k, v in zip(keep, coef) if v > 0]
    out = dict.fromkeys(names, 0.0)
    for k, v in zip(keep, coef):
        out[names[k]] = float(v)
    return out


def device_rows(prof) -> list:
    """The profiler's per-name rows of device events (no host operators,
    no user annotations)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def main(argv=()) -> int:
    p = argparse.ArgumentParser(prog="profile_step")
    p.add_argument("--scheme", choices=SCHEMES, default="galaxy")
    p.add_argument("--near", choices=("auto", "interp", "adaptive"),
                   default="auto")
    p.add_argument("--shards", type=int, default=1,
                   help="shards of the shard+... tags, all on cuda:0")
    p.add_argument("--m2l-dots", choices=("fp32", "mixed", "bf16x3"),
                   default="fp32", help="the hierarchies' M2L tier")
    p.add_argument("--m2l-rank", type=int, default=-1,
                   help="the adaptive plan's compression rank after "
                        "validation (-1: the plan's)")
    p.add_argument("tags", nargs="*", metavar="TAG")
    args = p.parse_args(list(argv))
    unknown = [t for t in args.tags if t not in TAGS]
    if unknown:
        print(f"profile_step: {unknown} not in {TAGS}", file=sys.stderr)
        return 2
    if args.scheme == "two_clusters" and set(args.tags) - {
            "tpu+proxy", "shard+adaptive"}:
        print("profile_step: two_clusters runs tpu+proxy and shard+adaptive "
              "only", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 1
    for tag in args.tags or TAGS[:1]:
        rc = profile_tag(tag, args.scheme, args.near, args.shards,
                         args.m2l_dots, args.m2l_rank)
        if rc:
            return rc
    return 0


def _engine(tag: str, scheme: str, near: str, total: int, dev, tmp: str,
            shards: int = 1, m2l_dots: str = "fp32"):
    """(engine, N) the way the CLI (or, for two_clusters, the bench row)
    builds it; the shard+... tags through ``create_engine`` with ``shards``
    shards on ``dev``."""
    from murb_tpu_torch.models import create_engine

    if scheme == "two_clusters":
        kw = ({"devices": [dev] * shards} if tag.startswith("shard+")
              else {"near": near})
        return create_engine(tag, two_clusters(device=dev),
                             soft=TWO_CLUSTERS_SOFT, dt=TWO_CLUSTERS_DT,
                             m2l_dots=m2l_dots, **kw), TWO_CLUSTERS_N
    if tag.startswith("shard+"):
        from murb_tpu_torch.core.init import make_bodies

        return create_engine(tag, make_bodies(N, scheme, SEED, device=dev),
                             devices=[dev] * shards, m2l_dots=m2l_dots), N
    n, extra = N, []
    if scheme == "milkyway_andromeda":
        import os
        import subprocess

        tab = os.path.join(tmp, "milkyway_andromeda.tab")
        script = os.path.join(os.path.dirname(__file__), "..", "..",
                              "scripts", "make_two_galaxy_tab.py")
        subprocess.run([sys.executable, script, tab], check=True,
                       capture_output=True)
        n, extra = 81_920, ["--scheme-file", tab]
    cfg = parse_args(["-n", str(n), "-i", str(total), "--im", tag, "-s",
                      scheme, "--kernel", "proxy", "--seed", str(SEED),
                      "--near", near, "--m2l-dots", m2l_dots, "--scan",
                      *extra])
    return build_engine(cfg, dev)[0], n


def profile_tag(tag: str, scheme: str = "galaxy", near: str = "auto",
                shards: int = 1, m2l_dots: str = "fp32",
                m2l_rank: int = -1) -> int:
    import tempfile

    dev = torch.device("cuda", 0)
    warmup, window_steps, steps = SHORT.get(
        scheme, SHORT.get(tag, (WARMUP, WINDOW_STEPS, STEPS)))
    # every step of the run records its metrics row (tracked tags)
    total = warmup + WINDOWS * window_steps + steps + 1
    with tempfile.TemporaryDirectory() as tmp:
        eng, n = _engine(tag, scheme, near, total, dev, tmp, shards,
                         m2l_dots)
    if m2l_rank >= 0 and getattr(eng, "_plan", None) is not None:
        eng._plan = eng._plan._replace(m2l_rank=m2l_rank)
    card = torch.cuda.get_device_name(dev)
    where = f" on {shards} shards" if tag.startswith("shard+") else ""
    health = None if tag in ("tpu+mxu", "tpu+tile") else eng.proxy_health()
    if health is None:   # an exact sweep
        print(f"{tag} N={n} {scheme}{where}: blocks {eng.block_i} x "
              f"{eng.block_j} (0: the kernel's default) on {card}")
    else:
        if not health.get("using_proxy", True):
            print(f"profile_step: {tag} took the exact sweep at N={n}; "
                  "nothing to profile", file=sys.stderr)
            return 1
        print(f"{tag} N={n} {scheme}{where} near="
              f"{health.get('near', getattr(eng, 'near_mode', 'interp'))}: "
              f"m={health['m']} levels={health['levels']} "
              f"cells={health.get('cells', 1)} m2l_dots "
              f"{getattr(eng, 'm2l_dots', m2l_dots)}"
              f"{'' if m2l_rank < 0 else f' m2l_rank {m2l_rank}'} on "
              f"{card}")
    eng.run(warmup)
    eng.block_until_ready()

    window_ms = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        eng.run(window_steps)
        eng.block_until_ready()
        window_ms.append((time.perf_counter() - t0) * 1e3 / window_steps)
    step_ms = statistics.median(window_ms)
    print("unprofiled windows: " + ", ".join(f"{w:.4f}" for w in window_ms)
          + f" ms/step ({window_steps} steps each; median "
          f"{step_ms:.4f} ms, {1e3 / step_ms:.2f} steps/s)")

    from torch.profiler import ProfilerActivity, profile

    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run(steps)
            eng.block_until_ready()
    finally:
        trace.disable()
        trace.drain()
    rows = device_rows(prof)
    dev_us = sum(e.self_device_time_total for e in rows)
    events = sum(e.count for e in rows)
    if dev_us <= 0:
        print("profile_step: the profiler recorded no device time; device "
              "time not measured", file=sys.stderr)
        return 1
    dev_ms = dev_us / 1e3 / steps
    print(f"profiled {steps} steps: device time {dev_us / 1e3:.3f} ms "
          f"= {dev_ms:.4f} ms/step in {events / steps:.1f} device "
          f"events/step; busy share {dev_ms / step_ms:.3f} of the "
          f"unprofiled step")
    m2l = [r for r in trace.profile_rows(prof) if r[0] == "sparse_m2l"]
    if m2l:
        _, calls, _, m2l_ms = m2l[0]
        print(f"sparse M2L: {m2l_ms / steps:.4f} ms/step of device time "
              f"({calls / steps:.1f} calls/step)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / steps:9.2f} us/step "
              f"{e.count / steps:6.1f}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
