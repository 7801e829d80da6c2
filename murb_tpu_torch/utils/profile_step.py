"""Where the time of a ``tpu+proxy`` or tracked step goes on a CUDA card.

    python -m murb_tpu_torch.utils.profile_step [--scheme S] [TAG ...]

TAG is ``tpu+proxy`` (the default), ``tpu+tracking`` or
``tpu+leapfrog+tracking``; S is ``galaxy`` (the default) or ``random``.
For each tag, builds the N=200,000 bodies of the scheme (seed 123) and the
engine the way ``python -m murb_tpu_torch -n 200000 -s S --im TAG --kernel
proxy --scan`` does (validated order, the fused force and potential pass
for the tracked tags, no mid-run adaptation; on the random box the
hierarchy, kernels K7-K9), runs warm-up steps, and then:

  1. times WINDOWS unprofiled windows of WINDOW_STEPS steps on the host
     clock, each ending in ``torch.cuda.synchronize``;
  2. profiles STEPS steps with ``torch.profiler`` and sums the device
     events: kernels, copies and memsets, the rows whose device type is
     CUDA.  This is the profiler table's "Self CUDA time total".  Host
     operator rows are left out, because their device time is the same
     kernels counted again.

It prints the device time and the device events per step, the busy share
(device time per step over the median unprofiled window's time per step)
and the device events that take the most time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from murb_tpu_torch.cli import build_engine
from murb_tpu_torch.utils.args import parse_args

N, SEED = 200_000, 123
WARMUP, WINDOWS, WINDOW_STEPS = 5, 3, 200
STEPS = 50      # profiled steps
TOP = 12        # device events listed
TAGS = ("tpu+proxy", "tpu+tracking", "tpu+leapfrog+tracking")


def device_rows(prof) -> list:
    """The profiler's per-name rows of device events (no host operators,
    no user annotations)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def main(argv=()) -> int:
    p = argparse.ArgumentParser(prog="profile_step")
    p.add_argument("--scheme", choices=("galaxy", "random"),
                   default="galaxy")
    p.add_argument("tags", nargs="*", metavar="TAG")
    args = p.parse_args(list(argv))
    unknown = [t for t in args.tags if t not in TAGS]
    if unknown:
        print(f"profile_step: {unknown} not in {TAGS}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 1
    for tag in args.tags or TAGS[:1]:
        rc = profile_tag(tag, args.scheme)
        if rc:
            return rc
    return 0


def profile_tag(tag: str, scheme: str = "galaxy") -> int:
    dev = torch.device("cuda", 0)
    # every step of the run records its metrics row (tracked tags)
    total = WARMUP + WINDOWS * WINDOW_STEPS + STEPS + 1
    cfg = parse_args(["-n", str(N), "-i", str(total), "--im", tag, "-s",
                      scheme, "--kernel", "proxy", "--seed", str(SEED),
                      "--scan"])
    eng = build_engine(cfg, dev)
    health = eng.proxy_health()
    if not health["using_proxy"]:
        print(f"profile_step: {tag} took the exact sweep at N={N}; nothing "
              "to profile", file=sys.stderr)
        return 1
    print(f"{tag} N={N} {scheme}: m={health['m']} "
          f"levels={health['levels']} cells={health['cells']} on "
          f"{torch.cuda.get_device_name(dev)}")
    eng.run(WARMUP)
    eng.block_until_ready()

    window_ms = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        eng.run(WINDOW_STEPS)
        eng.block_until_ready()
        window_ms.append((time.perf_counter() - t0) * 1e3 / WINDOW_STEPS)
    step_ms = statistics.median(window_ms)
    print("unprofiled windows: " + ", ".join(f"{w:.4f}" for w in window_ms)
          + f" ms/step ({WINDOW_STEPS} steps each; median "
          f"{step_ms:.4f} ms, {1e3 / step_ms:.2f} steps/s)")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(STEPS)
        eng.block_until_ready()
    rows = device_rows(prof)
    dev_us = sum(e.self_device_time_total for e in rows)
    events = sum(e.count for e in rows)
    if dev_us <= 0:
        print("profile_step: the profiler recorded no device time; device "
              "time not measured", file=sys.stderr)
        return 1
    dev_ms = dev_us / 1e3 / STEPS
    print(f"profiled {STEPS} steps: device time {dev_us / 1e3:.3f} ms "
          f"= {dev_ms:.4f} ms/step in {events / STEPS:.1f} device "
          f"events/step; busy share {dev_ms / step_ms:.3f} of the "
          f"unprofiled step")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / STEPS:9.2f} us/step "
              f"{e.count / STEPS:6.1f}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
