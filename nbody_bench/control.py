"""The controls of a cell's comparison, run on the card at the cell's size.

    python -m nbody_bench.control --workload <cell> --seeds 1,2,3
        [--variants none,bf16_state,tf32] [--seconds 3]

Each variant is an entry of the cell's ``controls`` (``none``: the cell as
it stands): the program with its own lower-precision path switched on, which
the comparison has to find not correct.  All runs share one process, so the
library is loaded once; each prints one JSON line with its checks.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from nbody_bench import harness, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m nbody_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="none,bf16_state,tf32")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    run.pin_environment(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec(args.workload)
    for variant in args.variants.split(","):
        over = {} if variant == "none" else spec.cell["controls"][variant]
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            try:
                res, view = harness.run_cell(spec, seed, args.seconds, False,
                                             "cuda:0", t, overrides=over)
            except Exception as e:   # a control that crashes has failed
                print(json.dumps({"variant": variant, "seed": seed,
                                  "error": repr(e)[:500]}), flush=True)
                continue
            print(json.dumps({
                "variant": variant, "seed": seed, "correct": res["correct"],
                "frames": res["attempted"], "failed": res["failed"],
                "setup_s": view.setup_s, "checks": res["checks"]}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
