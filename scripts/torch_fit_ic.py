"""Adjoint-method demo on murb_tpu_torch: fit initial velocities through the
simulator.

Generates a random cloud, perturbs its velocities to produce a *realizable*
target final configuration, then gradient-descends the original velocities
through the differentiable rollout (murb_tpu_torch.diff) until the final
positions hit the target -- a boundary-value problem solved with
d(loss)/d(IC) from one backward pass per iteration.  Runs on the card
unless ``--device cpu`` is given.

    python scripts/torch_fit_ic.py [N] [steps] [iters] [method] [--device cpu]

method: chunked (exact adjoint, default) | proxy (fast-solver adjoint).
The last line prints the loss ratio, first over last.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from murb_tpu_torch.core.init import init_random  # noqa: E402
from murb_tpu_torch.diff import fit_initial_velocities, rollout  # noqa: E402

DT, SOFT = 3600.0, 2.0e8


def positions(state) -> torch.Tensor:
    return torch.stack([state.qx, state.qy, state.qz], 1)[: state.n]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_fit_ic")
    p.add_argument("n", type=int, nargs="?", default=256)
    p.add_argument("steps", type=int, nargs="?", default=20)
    p.add_argument("iters", type=int, nargs="?", default=40)
    p.add_argument("method", nargs="?", default="chunked",
                   choices=("chunked", "proxy"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)

    s0 = init_random(a.n, 7, device=a.device)
    s_tgt = dataclasses.replace(s0, vx=s0.vx * 1.3, vy=s0.vy * 0.7)
    target = positions(rollout(s_tgt, steps=a.steps, dt=DT, soft=SOFT,
                               method=a.method))

    print(f"fitting v0 of {a.n} bodies over {a.steps} steps ({a.method} "
          f"adjoint) on {s0.device}")
    fitted, losses = fit_initial_velocities(
        s0, target, steps=a.steps, dt=DT, soft=SOFT, iters=a.iters,
        method=a.method, verbose=True)
    with torch.no_grad():
        final = rollout(fitted, steps=a.steps, dt=DT, soft=SOFT,
                        method=a.method)
        rms = float((positions(final) - target).pow(2).mean().sqrt())
    print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e} "
          f"({losses[0] / max(losses[-1], 1e-300):.0f}x); final rms "
          f"miss {rms:.3e} m")
    print(f"loss ratio {losses[-1] / losses[0]:.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
