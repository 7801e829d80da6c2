"""The benchmark's command line: one run of one cell on this machine's card.

It runs only on an NVIDIA card (exit 2 and no result without one, or with
fewer cards than the cell asks for), keeps every cache in the checkout's
``build/`` directory, and refuses to print a result (exit 3) if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``murb_tpu`` was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_start() -> float:
    """``time.perf_counter()`` at the start of this process (its start time
    in /proc, to a clock tick), or now where /proc cannot say."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


T_START = _process_start()
#: top-level module names a run may not load
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "murb_tpu"})


def foreign_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (the loaded modules'
    by default), each compared whole: ``murb_tpu_torch`` is not
    ``murb_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def pin_environment(root) -> None:
    """Run the program as the cells state it: none of its ``MURB_*``
    switches (autotuning, its tune cache, the M2L schedule), and the caches
    of the toolchains at fixed paths in the checkout."""
    for k in [k for k in os.environ if k.startswith("MURB_")]:
        del os.environ[k]
    cache = os.path.join(root, "build", "nbody_bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m nbody_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed is a whole number")

    from nbody_bench import harness

    pin_environment(harness.ROOT)
    import torch

    spec = harness.Spec(args.workload)
    if not torch.cuda.is_available():
        print("nbody_bench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec.chips:
        print(f"nbody_bench: {spec.name} needs {spec.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, view = harness.run_cell(spec, args.seed, args.seconds,
                                    bool(args.trace), "cuda:0", T_START)
    bad = foreign_modules()
    if bad:
        print(f"nbody_bench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    print(harness.summary(result, view), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
