#!/usr/bin/env python
"""Sample power while ``python -m murb_tpu_torch`` runs, then report it.

The port's counterpart of scripts/measure_energy.py: a sampler thread in
this process, the workload the port's CLI as a subprocess, and the report
scripts/energy_report.py (unchanged) over the CSV written here
(``timestamp_s,channel,watts``).

Power sources, tried in this order under ``--source auto``:

  nvsmi    the card's own power draw, one channel a device (gpu0, gpu1,
           ...), from ``nvidia-smi --query-gpu=power.draw --format=csv,
           noheader,nounits``.  On a host with a CUDA card (torch sees one)
           a failing nvidia-smi is an error, never a quiet switch to the
           bound below.
  rapl     Linux powercap RAPL counters (host CPU and DRAM energy).
  hwmon    /sys/class/hwmon power sensors.
  tdp      an upper bound, not a measurement: --tdp-watts a device times
           torch.cuda.device_count() (at least 1), as a flat line.

Two windows are reported: the whole subprocess (start-up, the kernels'
build, the validation ladder and the steps) and the frame loop alone,
from the CLI's "Simulation started..." line to its "Simulation ended."
line, each stamped as this process reads it.  For the loop the script
also prints mean W and J a step (mean W x window / steps) at full
precision, per channel and summed over the cards.

Usage:
  python scripts/torch_measure_energy.py -- -n 200000 -i 1000 \\
      --im tpu+proxy --nv --scan
  python scripts/torch_measure_energy.py --source nvsmi --interval 0.1 -- \\
      -n 200000 -i 1000 --im tpu+proxy --precision bf16 --nv --scan

The CLI arguments follow ``--`` verbatim.  MURB_ENERGY_CMD replaces the
workload launcher (``python -m murb_tpu_torch``), as in measure_energy.py.
"""
from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import threading
import time

SCRIPT_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(SCRIPT_DIR)
sys.path.insert(0, SCRIPT_DIR)

from measure_energy import HwmonSampler, RaplSampler, TdpSampler  # noqa: E402

LOOP_START = "Simulation started"
LOOP_END = "Simulation ended"


class NvsmiSampler:
    """The cards' power draw through nvidia-smi, one channel a device."""

    name = "nvsmi"
    QUERY = ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits"]

    def __init__(self):
        if not self.sample():
            raise OSError("nvidia-smi reported no device")

    def sample(self):
        try:
            out = subprocess.run(self.QUERY, capture_output=True, text=True,
                                 timeout=10)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise OSError(f"nvidia-smi failed: {e}") from e
        if out.returncode != 0:
            raise OSError(f"nvidia-smi exited {out.returncode}: "
                          f"{out.stderr.strip() or out.stdout.strip()}")
        rows = []
        for i, line in enumerate(l for l in out.stdout.splitlines()
                                 if l.strip()):
            try:
                rows.append((f"gpu{i}", float(line)))
            except ValueError as e:
                raise OSError(f"nvidia-smi power.draw of device {i}: "
                              f"{line.strip()!r}") from e
        return rows


def card_present() -> bool:
    """Whether torch sees a CUDA card on this host."""
    try:
        import torch
    except ImportError:
        return False
    return torch.cuda.is_available()


def device_count() -> int:
    """CUDA devices for the tdp bound (at least 1)."""
    try:
        import torch
    except ImportError:
        return 1
    return max(torch.cuda.device_count(), 1)


def pick_sampler(source: str, tdp_watts: float):
    if source == "nvsmi":
        return NvsmiSampler()
    if source == "rapl":
        return RaplSampler()
    if source == "hwmon":
        return HwmonSampler()
    if source == "tdp":
        return TdpSampler(tdp_watts, device_count())
    try:
        return NvsmiSampler()
    except OSError as e:
        if card_present():
            raise SystemExit(f"--source auto: a CUDA card is present but "
                             f"nvidia-smi cannot read its power ({e})")
        print(f"# source nvsmi unavailable: {e}")
    for cls in (RaplSampler, HwmonSampler):
        try:
            return cls()
        except OSError as e:
            print(f"# source {cls.name} unavailable: {e}")
    return TdpSampler(tdp_watts, device_count())


def loop_report(rows, t0: float, t1: float, steps: int) -> list[str]:
    """Mean W and J a step over [t0, t1] per channel (the samples inside
    the window, trapezoids; mean W x window / steps), and summed."""
    import numpy as np

    from energy_report import integrate

    lines, total = [], 0.0
    for ch in sorted({r[1] for r in rows}):
        pts = sorted((t, w) for t, c, w in rows if c == ch)
        ts = np.array([p[0] for p in pts])
        ws = np.array([p[1] for p in pts])
        _, mean_w = integrate(ts, ws, t0, t1)
        if mean_w <= 0:
            lines.append(f"loop {ch}: fewer than 2 samples in the window")
            continue
        mean_w = float(mean_w)
        total += mean_w
        lines.append(f"loop {ch}: mean W {mean_w!r}, J/step "
                     f"{mean_w * (t1 - t0) / steps!r}")
    if total > 0:
        lines.append(f"loop all: window {t1 - t0!r} s, {steps} steps, mean "
                     f"W {total!r}, J/step {total * (t1 - t0) / steps!r}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", choices=("auto", "nvsmi", "rapl", "hwmon",
                                         "tdp"), default="auto")
    ap.add_argument("--tdp-watts", type=float, default=700.0,
                    help="a device's bound for the tdp source (default 700, "
                         "the H100 SXM's maximum limit)")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="sampling period in seconds")
    ap.add_argument("--out", default="power.csv")
    ap.add_argument("cli_args", nargs=argparse.REMAINDER,
                    help="murb_tpu_torch CLI arguments after --")
    args = ap.parse_args()
    cli_args = [a for a in args.cli_args if a != "--"]
    if not cli_args:
        ap.error("pass the murb_tpu_torch CLI arguments after --")

    sampler = pick_sampler(args.source, args.tdp_watts)
    print(f"# power source: {sampler.name} -> {args.out}", flush=True)

    stop = threading.Event()
    rows: list[tuple[float, str, float]] = []

    def run_sampler():
        sampler.sample()  # prime cumulative counters
        while not stop.wait(args.interval):
            now = time.time()
            for ch, w in sampler.sample():
                rows.append((now, ch, w))

    th = threading.Thread(target=run_sampler, daemon=True)
    th.start()
    cmd = os.environ.get("MURB_ENERGY_CMD")
    argv = ([*shlex.split(cmd), *cli_args] if cmd
            else [sys.executable, "-m", "murb_tpu_torch", *cli_args])
    marks = {}
    t0 = time.time()
    # unbuffered, so that each line is stamped when the CLI prints it
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    with subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, text=True,
                          env=env) as proc:
        for line in proc.stdout:
            now = time.time()
            for key in (LOOP_START, LOOP_END):
                if line.startswith(key):
                    marks.setdefault(key, now)
            sys.stdout.write(line)
    t1 = time.time()
    stop.set()
    th.join(timeout=5)

    with open(args.out, "w") as f:
        f.write("timestamp_s,channel,watts\n")
        for t, ch, w in rows:
            f.write(f"{t:.3f},{ch},{w:.3f}\n")

    steps = 0
    for flag, val in zip(cli_args, cli_args[1:]):
        if flag == "-i":
            steps = int(val)
    if not steps:
        print(f"# no -i flag found; the report is skipped (integrate "
              f"{args.out} yourself)")
    elif len(rows) < 2:
        print(f"# fewer than 2 samples collected; see {args.out}")
    else:
        windows = [("run", t0, t1)]
        if LOOP_START in marks and LOOP_END in marks:
            windows.append(("loop", marks[LOOP_START], marks[LOOP_END]))
        for label, a, b in windows:
            rep = subprocess.run(
                [sys.executable, os.path.join(SCRIPT_DIR, "energy_report.py"),
                 args.out, "--t0", str(a), "--t1", str(b),
                 "--frames", str(steps)],
                capture_output=True, text=True)
            print(f"# {label} window")
            sys.stdout.write(rep.stdout)
        if len(windows) > 1:
            for line in loop_report(rows, *windows[1][1:], steps):
                print(line)
    if sampler.name == "tdp":
        print("# NOTE: the tdp source is an UPPER BOUND, not a measurement.")
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
