"""The dense hierarchy's step at each depth on a CUDA card, the level
overhead of the depth-cost model fitted from it, and the M2L tiers: the
port's counterpart of scripts/m2l_tier_probe.py, which set murb_tpu's
LEVEL_OVERHEAD on a TPU.

    python scripts/torch_m2l_tier_probe.py [--n N] [--raw FILE]
    python scripts/torch_m2l_tier_probe.py --from FILE

On the random box of murb_tpu's bench row (``make_bodies(N, "random",
123)``, N = 200,000 by default, soft 2e8, dt 3600; bench.py:411-424):

  1. ``tpu+proxy``'s step at each (m, levels) that ``ops/fmm.best_depth``
     weighs (``depth_candidates``: levels from required_levels to 4, each
     at fmm_order's m) and at a grid of m 4, 6, 8, 10 by levels 2, 3, 4,
     each through ``create_engine`` at that (m, levels) with the
     validation off: the wall time a step (``step_ms``, windows ending in
     a synchronise; the points run forward, then backward, and the two
     medians' mean is kept) and the device time a step (the device rows
     of ``torch.profiler``, ``device_ms``);
  2. the fit wall = a W + b (L - lmin) + c by least squares (relative
     residuals), W = 8 n m^3 + 686 8^L m^6 the model's MAC equivalents:
     the step's MAC rate 1 / a, the ms of one more level b, and
     ``LEVEL_OVERHEAD`` = b / a, the level's cost in the model's currency;
  3. at best_depth's pick, each M2L tier (fp32, mixed, bf16x3): the ms of
     one ``acc_fmm`` (CUDA events) and the max and p99 per-body force
     error of a 4096-row strided sample against a float64 sweep, as
     murb_tpu's probe prints them.

Prints one JSON line with the fit and the card's name and power limit
(nvidia-smi); ``--raw FILE`` writes every measurement as JSON, and
``--from FILE`` fits such a file again without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

SOFT, DT, SEED, TOL = 2.0e8, 3600.0, 123, 1e-4
GRID_M, GRID_L = (4, 6, 8, 10), (2, 3, 4)
SAMPLE = 4096
TIERS = ("fp32", "mixed", "bf16x3")
WINDOW_MS = 300.0   # the wall time a timing window aims at


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()


def model_macs(n: int, m: int, levels: int) -> float:
    """best_depth's MAC equivalents of (m, levels) at n bodies."""
    return float(8 * n * m ** 3 + 686 * 8 ** levels * m ** 6)


def time_depth(st, m: int, levels: int) -> tuple[float, float]:
    """(wall ms, device ms) of one tpu+proxy step at (m, levels)."""
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.utils.profile_step import device_ms, step_ms

    eng = create_engine("tpu+proxy", st, soft=SOFT, dt=DT, m=m,
                        levels=levels, validate=False)
    eng.run(1)
    eng.block_until_ready()
    t0 = time.perf_counter()
    eng.run(1)
    eng.block_until_ready()
    one = (time.perf_counter() - t0) * 1e3
    steps = max(3, min(50, int(WINDOW_MS / max(one, 1e-3))))
    return step_ms(eng, steps, windows=3), device_ms(lambda: eng.run(1))


def measure(n: int, dev) -> dict:
    import torch

    from murb_tpu_torch import G
    from murb_tpu_torch.core.init import make_bodies
    from murb_tpu_torch.ops import fmm
    from murb_tpu_torch.ops.naive import acc_rect
    from murb_tpu_torch.ops.proxy import half_extent
    from murb_tpu_torch.utils.profile_step import event_ms

    st = make_bodies(n, "random", SEED, device=dev)
    npad = st.npad
    half = float(half_extent(st.unpadded()))
    lmin = fmm.required_levels(half, SOFT)
    cands = fmm.depth_candidates(npad, half, SOFT, TOL, device=dev)
    murb = fmm.depth_candidates(npad, half, SOFT, TOL, device="cpu")
    points = sorted({(m, lv) for _, m, lv in cands}
                    | {(m, lv) for m in GRID_M for lv in GRID_L
                       if lv >= lmin})
    print(f"N={n} npad={npad} half={half:.6g} lmin={lmin}; best_depth "
          f"weighs {[(m, lv) for _, m, lv in cands]}", flush=True)
    walls = {p: [] for p in points}
    devs = {p: [] for p in points}
    for order in (points, points[::-1]):
        for m, lv in order:
            w, d = time_depth(st, m, lv)
            walls[(m, lv)].append(w)
            devs[(m, lv)].append(d)
            print(f"  m={m} L={lv}: {w:.4f} ms a step, device {d:.4f}",
                  flush=True)
            torch.cuda.empty_cache()
    rows = [{"m": m, "L": lv, "W": model_macs(npad, m, lv),
             "wall_ms": statistics.mean(walls[(m, lv)]),
             "walls": walls[(m, lv)],
             "device_ms": statistics.mean(devs[(m, lv)])}
            for m, lv in points]

    # the tiers at the pick, against float64 on a strided sample
    m, lv = fmm.best_depth(npad, half, SOFT, TOL, device=dev)
    gm = st.m * torch.tensor(G, dtype=st.dtype).item()
    idx = torch.arange(0, st.n, max(1, st.n // SAMPLE), device=dev)[:SAMPLE]
    q64 = [v.double() for v in (st.qx, st.qy, st.qz)]
    ref = torch.stack(acc_rect(*(v[idx] for v in q64), *q64, gm.double(),
                               SOFT), 1)
    rn = ref.norm(dim=1)
    floor = torch.clamp(rn, min=1e-6 * float(rn.max()))
    tiers = {}
    for tier in TIERS:
        def run(tier=tier):
            return fmm.acc_fmm(st.qx, st.qy, st.qz, gm, SOFT, m=m, levels=lv,
                               m2l_dots=tier)
        a = run()
        got = torch.stack([a.ax, a.ay, a.az], 1)[idx].double()
        err = ((got - ref).norm(dim=1) / floor).cpu()
        tiers[tier] = {"ms": event_ms(run, reps=5, runs=3),
                       "err_max": float(err.max()),
                       "err_p99": float(err.quantile(0.99))}
        print(f"  {tier:8s} {tiers[tier]['ms']:8.4f} ms   force err max "
              f"{tiers[tier]['err_max']:.2e} p99 {tiers[tier]['err_p99']:.2e}"
              f" (m={m}, L={lv})", flush=True)
    return {"n": n, "npad": npad, "half": half, "lmin": lmin,
            "candidates": [[m_, l_] for _, m_, l_ in cands],
            "murb_tpu_pick": list(fmm.best_depth(npad, half, SOFT, TOL,
                                                 device="cpu")),
            "murb_tpu_est": [e for e, _, _ in murb],
            "rows": rows, "pick": [m, lv], "tiers": tiers}


def fit(raw: dict) -> dict:
    """The step's MAC rate, the ms of one more level and LEVEL_OVERHEAD
    (see the module's docstring), and each candidate's measured and
    predicted wall ms."""
    from murb_tpu_torch.utils.profile_step import fit_relative

    lmin = raw["lmin"]
    rows = raw["rows"]
    co = fit_relative([(r["W"], r["L"] - lmin, 1.0) for r in rows],
                      [r["wall_ms"] for r in rows], ("mac", "level", "const"))
    if co["mac"] <= 0:
        raise RuntimeError(f"the wall time does not grow with the MACs: {co}")
    overhead = co["level"] / co["mac"]
    by = {(r["m"], r["L"]): r for r in rows}
    cands = []
    for m, lv in raw["candidates"]:
        r = by[(m, lv)]
        cands.append({"m": m, "L": lv, "wall_ms": r["wall_ms"],
                      "device_ms": r["device_ms"],
                      "est": r["W"] + overhead * (lv - lmin),
                      "predicted_ms": co["mac"] * r["W"]
                      + co["level"] * (lv - lmin) + co["const"]})
    return {"mac_per_ms": 1.0 / co["mac"], "level_ms": co["level"],
            "const_ms": co["const"], "level_overhead": overhead,
            "candidates": cands}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_m2l_tier_probe")
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--raw", help="write every measurement here (JSON)")
    p.add_argument("--from", dest="src",
                   help="fit the measurements of this file (no card)")
    args = p.parse_args(argv)
    if args.src:
        with open(args.src) as f:
            doc = json.load(f)
        raw, smi = doc["raw"], doc["card"]
    else:
        import torch

        if not torch.cuda.is_available():
            print("torch_m2l_tier_probe: no CUDA device available",
                  file=sys.stderr)
            return 1
        from murb_tpu_torch.ops import cuda

        cuda.build_kernels()
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = smi_line()
        print(smi, flush=True)
        raw = measure(args.n, torch.device("cuda", 0))
        if args.raw:
            with open(args.raw, "w") as f:
                json.dump({"card": smi, "raw": raw}, f)
    res = fit(raw)
    for c in res["candidates"]:
        print(f"  candidate m={c['m']} L={c['L']}: {c['wall_ms']:.4f} ms a "
              f"step (device {c['device_ms']:.4f}), predicted "
              f"{c['predicted_ms']:.4f}, est {c['est']:.4g}")
    print(smi)
    print(json.dumps({"card": smi, "pick": raw["pick"],
                      "murb_tpu_pick": raw["murb_tpu_pick"],
                      **{k: v for k, v in res.items() if k != "candidates"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
