"""The adaptive solve's stages and steps on a CUDA card, and the cost
models' constants fitted from them: the port's counterpart of
scripts/adaptive_stage_probe.py (stage times) and scripts/adaptive_probe.py
(engine steps), which set murb_tpu's rates on a TPU.

    python scripts/torch_adaptive_stage_probe.py [--n N ...] [--raw FILE]
    python scripts/torch_adaptive_stage_probe.py --from FILE

For each N (default 131,072, 262,144, 524,288 and 1,048,576) on the
two-cluster box of murb_tpu's bench row ``adaptive_two_clusters_1m``
(``utils/profile_step.two_clusters``, seed 42, soft 0.02, dt 1e-6):

  1. the engine the auto policy builds (``create_engine("tpu+proxy")``;
     forced to the adaptive solver where the policy declines it): the
     planning order m0 (``adaptive_order``), the validated order mv, the
     plan's (Ld, L) and the policy's two estimates at the current rates;
  2. each stage of the solve at the plan, timed by CUDA events around the
     calls as the step makes them (host gaps included; ``event_ms``) and
     by the device rows of ``torch.profiler`` (``device_ms``): the
     preamble (box, heavy split, Morton sort, gathers), the occupied
     chain, the anterpolation (K11 and K12 with their glue), the dense
     base (K7's far sweep at Ld), the sparse M2L at every level at the
     orders 4, mv and m0, the hierarchy (chains, M2M, L2L, dense base and
     every M2L level), K10's sweep (and K10 alone in a CUDA graph,
     ``graph_ms``) and the whole solve;
  3. the engine step (``step_ms``: wall clock, windows ending in a
     synchronise) at the plan, at its neighbours (L - 1, L + 1, the other
     Ld) at mv, and at the plan at m0 (the order the CLI's and the sharded
     solvers' planners run, which escalate and never step down);
  4. the exact step (``tpu+hybrid``: K4 passes 2, K3's kernel).

It then fits the constants of ``ops/sparse_fmm.PlannerRates`` and prints
them as one JSON line, beside the card's name and power limit
(nvidia-smi); ``--raw FILE`` writes every measurement as JSON, and
``--from FILE`` fits such a file again without a card.  The fit:

  - the sparse M2L a level, t = MACs / R + bytes / G + c, by least squares
    over every level, N and order (relative residuals), MACs = NO nc m^6
    nf and bytes = NO nc m^3 4 as the model counts them (nc from
    ``level_stats``);
  - the engine plans at m0 and the policy compares the cost at m0 with
    the exact sweep's, but the auto engine's validation steps the order
    down to mv before the first step.  ``mac_per_ms`` and
    ``gather_bytes_per_ms`` are R (m0/mv)^6 and G (m0/mv)^3: the model's
    MACs and bytes at m0 priced as the M2L the step runs at mv, the
    validated order at the largest N (where the M2L weighs most; a
    shallow plan may validate lower);
  - ``p2p_slots_per_ms``: the median over N of the model's slots (26 a
    128 x 128 brick pair of ``estimate_brick_pairs``) over K10's sweep;
  - ``anterp_us_per_body``: the median of (K11 + K12 with glue) / npad;
  - ``factor``, ``misc_ms_per_level`` and ``misc_ms``: step = factor (S
    + misc_ms_per_level (L - Ld) + misc_ms) by least squares (relative
    residuals) over every engine step measured at mv, S the model's
    stage sum (the terms above, priced at m0, as the policy prices a
    geometry); the stages' own per-level share, (chain + the hierarchy
    less its M2L levels and dense base) / (L - Ld) + c, and the solve's
    events are printed beside it;
  - ``exact_slots_per_ms``: the median of 14 npad^2 over the exact step.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

NS = (131_072, 262_144, 524_288, 1_048_576)
ORDERS_EXTRA = (4,)          # M2L orders timed beside mv and m0


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()


def m2l_counts(nc: int, m: int, nf: int = 3) -> tuple[float, float]:
    """(MACs, gather bytes) of one sparse M2L level of ``nc`` occupied
    cells, as ``cost_with_rates`` counts them at rank 0."""
    from murb_tpu_torch.ops.sparse_fmm import _far_offsets

    rows = len(_far_offsets()[0]) * nc
    return float(rows * m ** 6 * nf), float(rows * m ** 3 * 4)


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.3f}"


def measure_n(n: int, dev, steps: int) -> dict:
    """Every measurement of one N (see the module's docstring)."""
    import torch

    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.ops import p2p as pp
    from murb_tpu_torch.ops import p2p_kernels as pk
    from murb_tpu_torch.ops import sparse_fmm as sf
    from murb_tpu_torch.ops.anterp_kernels import l2p_window, p2m_window
    from murb_tpu_torch.ops.fmm import _heavy_setup, fmm_field_grid
    from murb_tpu_torch.utils.profile_step import (TWO_CLUSTERS_DT,
                                                   TWO_CLUSTERS_SOFT,
                                                   device_ms, event_ms,
                                                   graph_ms, step_ms,
                                                   two_clusters)

    soft, dt = TWO_CLUSTERS_SOFT, TWO_CLUSTERS_DT
    st = two_clusters(n, device=dev)
    npad = st.npad
    m0 = sf.adaptive_order(1e-4)
    t0 = time.perf_counter()
    eng = create_engine("tpu+proxy", st, soft=soft, dt=dt)
    auto = {"near_mode": eng.near_mode, "using_proxy": eng.using_proxy,
            "estimates": eng.cost_estimates,
            "build_s": time.perf_counter() - t0}
    if eng.near_mode != "adaptive":
        t0 = time.perf_counter()
        eng = create_engine("tpu+proxy", st, soft=soft, dt=dt,
                            near="adaptive")
        auto["forced_build_s"] = time.perf_counter() - t0
    plan = eng._plan
    mv, Ld, L = plan.m, plan.dense_levels, plan.levels
    q = eng._active_q()
    out = {"n": n, "npad": npad, "m0": m0, "mv": mv, "Ld": Ld, "L": L,
           "caps": list(plan.cell_caps), "pmax": plan.p2p_pmax,
           "validated_err": eng.validated_err, "auto": auto,
           "stats": sf.level_stats(q, Ld, L),
           "bricks": sf.estimate_brick_pairs(q, npad, L)}
    print(f"[N={n}] auto policy: {auto}; runs m={mv} (planned at m0={m0}) "
          f"Ld={Ld} L={L} caps {plan.cell_caps} bricks {out['bricks']}",
          flush=True)

    # ---- the solve's stages at the plan (solve_adaptive's order)
    g = eng._gm(st)
    q3 = (st.qx, st.qy, st.qz)
    C = 2 ** L

    def preamble():
        c, h, *_r, ge = _heavy_setup(*q3, g, 1, sf.HEAVY_FACTOR)
        h = h.max().expand(3)
        key, ci = pp.sorted_cells(*q3, ge > 0, c, h, C)
        key_s, perm = torch.sort(key, stable=True)
        return (c, h, key_s) + tuple(v[perm] for v in (*q3, ge)) + (
            tuple(v[perm] for v in ci),)

    c, h, key_s, xs, ys, zs, gs, ci = preamble()
    caps = plan.cell_caps

    def chain():
        cells = {}
        cells[L], slots = sf._occupied_and_slots(key_s, caps[-1])
        for lv in range(L - 1, Ld, -1):
            ids = torch.where(cells[lv + 1] == sf._BIG, sf._BIG,
                              cells[lv + 1] >> 3)
            cells[lv], _ = sf._occupied_and_slots(ids, caps[lv - Ld - 1])
        return cells, slots

    cells, slots = chain()

    def anterp():
        w = p2m_window(xs, ys, zs, gs, c, h, slots, caps[-1], m=mv, C=C,
                       ci=ci)
        return l2p_window(xs, ys, zs, c, h, slots, (w, w, w), m=mv, C=C,
                          ci=ci)

    w_fin = p2m_window(xs, ys, zs, gs, c, h, slots, caps[-1], m=mv, C=C,
                       ci=ci)
    stages = {}

    def stage(name, fn):
        stages[name] = {"event_ms": event_ms(fn),
                        "device_ms": device_ms(fn)}

    stage("preamble", preamble)
    stage("chain", chain)
    stage("anterp", anterp)
    stage("hierarchy", lambda: sf.hierarchy_fields(
        w_fin, cells[L], c, h, soft, plan, with_phi=False))
    stage("dense", lambda: fmm_field_grid(
        torch.zeros((8 ** Ld, mv ** 3), device=dev), h, soft, m=mv,
        levels=Ld, with_phi=False, finest_subset="far"))
    stage("p2p", lambda: pk.p2p_sweep_kernel_sorted(
        xs, ys, zs, gs, ci, soft, pmax=plan.p2p_pmax))
    stage("solve", lambda: sf.acc_adaptive(*q3, g, soft, plan))
    soft2 = float(torch.tensor(soft, dtype=torch.float32) ** 2)
    cells32 = tuple(v.to(torch.int32).contiguous() for v in ci)
    stages["p2p"]["alone_ms"] = graph_ms(lambda: pk.p2p_sorted_launch(
        xs, ys, zs, gs, cells32, soft2, pmax=plan.p2p_pmax), reps=3,
        runs=3)
    out["stages"] = stages

    # ---- the sparse M2L a level at each order (random expansions: the
    # time does not depend on their values)
    gen = torch.Generator(device=dev).manual_seed(0)
    m2l = []
    for m in sorted({*ORDERS_EXTRA, mv, m0}):
        for lv in range(Ld + 1, L + 1):
            w = torch.randn((caps[lv - Ld - 1] + 1, m ** 3), device=dev,
                            generator=gen)
            fn = (lambda w, lv, m: lambda: sf.m2l_sparse_level(
                w, cells[lv], h / 2 ** lv, soft, m=m, C=2 ** lv,
                with_phi=False))(w, lv, m)
            m2l.append({"m": m, "level": lv,
                        "nc": out["stats"][lv - Ld - 1],
                        "event_ms": event_ms(fn, reps=2, runs=3),
                        "device_ms": device_ms(fn, reps=2)})
            del w
    out["m2l"] = m2l
    for r in m2l:
        print(f"  M2L m={r['m']} level {r['level']} ({r['nc']} cells): "
              f"{r['event_ms']:.3f} ms, device {_ms(r['device_ms'])}")
    for k, v in stages.items():
        print(f"  {k}: " + ", ".join(f"{a} {_ms(b)}" for a, b in v.items()))
    del w_fin, cells, slots, xs, ys, zs, gs, ci, cells32
    torch.cuda.empty_cache()

    # ---- the engine step at the plan, its neighbours, and at m0
    steps_out = []
    cases = [(mv, Ld, L)] + [(mv, ld, lv) for ld in (2, 3)
                             for lv in (L - 1, L, L + 1)
                             if (ld, lv) != (Ld, L) and ld < lv <= 9] + [
        (m0, Ld, L)]
    for m, ld, lv in cases:
        if (m, ld, lv) == (mv, Ld, L):
            p = plan
        else:
            p = sf.plan_adaptive(q, npad, m, ld, lv, device=dev)
        eng._plan, eng.m, eng.levels = p, m, lv
        ms = step_ms(eng, steps, windows=3)
        stats = sf.level_stats(q, ld, lv)
        bricks = sf.estimate_brick_pairs(q, npad, lv)
        # the policy's price of this geometry (at m0), at the current
        # "cuda" rates and at murb_tpu's
        est = {k: sf._cost_from_stats(stats, bricks, npad, m0, ld, lv,
                                      device=k) for k in ("cuda", "cpu")}
        steps_out.append({"m": m, "Ld": ld, "L": lv, "step_ms": ms,
                          "stats": stats, "bricks": bricks,
                          "est_cuda_ms": est["cuda"],
                          "est_cpu_ms": est["cpu"]})
        print(f"  step m={m} Ld={ld} L={lv}: {ms:.3f} ms (priced at "
              f"m0 {est['cuda']:.1f} ms, murb_tpu's rates "
              f"{est['cpu']:.1f})", flush=True)
        torch.cuda.empty_cache()
    out["steps"] = steps_out
    eng._plan = plan
    del eng
    torch.cuda.empty_cache()

    # ---- the exact step (the policy's other branch)
    ex = create_engine("tpu+hybrid", st, soft=soft, dt=dt)
    out["exact_step_ms"] = step_ms(ex, 2 if n > 600_000 else 5, windows=3)
    print(f"  exact tpu+hybrid step {out['exact_step_ms']:.3f} ms",
          flush=True)
    del ex, st
    torch.cuda.empty_cache()
    return out


def fit(raw: list[dict]) -> dict:
    """The PlannerRates fields (see the module's docstring) from the
    measurements of ``measure_n``, and the fit's residuals."""
    from murb_tpu_torch.ops.sparse_fmm import (DEFAULT_K, PlannerRates,
                                               cost_with_rates)
    from murb_tpu_torch.utils.profile_step import fit_relative

    rows, ys = [], []
    for r in raw:
        for x in r["m2l"]:
            macs, nbytes = m2l_counts(x["nc"], x["m"])
            rows.append((macs, nbytes, 1.0))
            ys.append(x["event_ms"])
    co = fit_relative(rows, ys, ("mac", "gather", "const"))
    mac_phys = 1.0 / co["mac"] if co["mac"] else math.inf
    gather_phys = 1.0 / co["gather"] if co["gather"] else math.inf
    c_level = co["const"]
    # the orders of the largest N, where the M2L weighs most (the
    # validation may keep a lower order at a shallow plan)
    top = max(raw, key=lambda r: r["n"])
    m0, mv = top["m0"], top["mv"]
    mac = mac_phys * (m0 / mv) ** 6
    gather = gather_phys * (m0 / mv) ** 3
    p2p = statistics.median(
        r["bricks"] * DEFAULT_K ** 2 * 26 / r["stages"]["p2p"]["event_ms"]
        for r in raw)
    anterp = statistics.median(
        1e3 * r["stages"]["anterp"]["event_ms"] / r["npad"] for r in raw)

    def m2l_measured(r):
        return sum(x["event_ms"] for x in r["m2l"] if x["m"] == r["mv"])

    # diagnostic: a sparse level's chain, M2M and L2L from the stages
    per_level_stages = statistics.median(
        (r["stages"]["chain"]["event_ms"] + r["stages"]["hierarchy"]
         ["event_ms"] - m2l_measured(r) - r["stages"]["dense"]["event_ms"])
        / (r["L"] - r["Ld"]) + c_level for r in raw)

    def model(r, rates, s):
        """The model at ``rates`` for the geometry of step ``s``, priced
        at the planning order, as the policy prices it."""
        return cost_with_rates(rates, s["stats"], s["bricks"], r["npad"],
                               r["m0"], s["Ld"], s["L"])

    stages = PlannerRates(mac, gather, p2p, anterp, 0.0, 0.0, 1.0, 1.0)
    at_mv = [(r, s) for r in raw for s in r["steps"] if s["m"] == r["mv"]]
    co = fit_relative([(model(r, stages, s), s["L"] - s["Ld"], 1.0)
                       for r, s in at_mv], [s["step_ms"] for r, s in at_mv],
                      ("stages", "level", "once"))
    if co["stages"] <= 0:
        raise RuntimeError(f"the steps do not grow with the stages: {co}")
    factor = co["stages"]
    exact = statistics.median(14.0 * r["npad"] ** 2 / r["exact_step_ms"]
                              for r in raw)
    rates = stages._replace(misc_ms_per_level=co["level"] / factor,
                            misc_ms=co["once"] / factor, factor=factor,
                            exact_slots_per_ms=exact)
    # the model at the fitted rates against every measured step
    checks = []
    for r in raw:
        for s in r["steps"]:
            # the policy prices every plan at m0; the step at m0 itself
            # runs the order it was priced at
            pred = model(r, rates, s)
            checks.append({"n": r["n"], "m": s["m"], "Ld": s["Ld"],
                           "L": s["L"], "measured_ms": s["step_ms"],
                           "predicted_ms": pred})
        checks.append({"n": r["n"], "exact": True,
                       "measured_ms": r["exact_step_ms"],
                       "predicted_ms": 14.0 * r["npad"] ** 2 / exact})
    return {"rates": rates._asdict(),
            "m2l_fit": {"mac_per_ms_at_m": mac_phys,
                        "gather_bytes_per_ms_at_m": gather_phys,
                        "ms_a_level": c_level, "m0": m0, "mv": mv,
                        "misc_ms_per_level_from_stages": per_level_stages},
            "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_adaptive_stage_probe")
    p.add_argument("--n", type=int, nargs="+", default=list(NS))
    p.add_argument("--steps", type=int, default=3,
                   help="engine steps a timing window")
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
            print("torch_adaptive_stage_probe: no CUDA device available",
                  file=sys.stderr)
            return 1
        from murb_tpu_torch.ops import cuda

        cuda.build_kernels()
        smi = smi_line()
        print(smi, flush=True)
        raw = [measure_n(n, torch.device("cuda", 0), args.steps)
               for n in args.n]
        if args.raw:
            with open(args.raw, "w") as f:
                json.dump({"card": smi, "raw": raw}, f)
    res = fit(raw)
    for c in res["checks"]:
        what = ("exact" if c.get("exact") else
                f"m={c['m']} Ld={c['Ld']} L={c['L']}")
        print(f"  N={c['n']} {what}: measured {c['measured_ms']:.3f} ms, "
              f"predicted {c['predicted_ms']:.3f} "
              f"({c['predicted_ms'] / c['measured_ms']:.2f}x)")
    print(smi)
    print(json.dumps({"card": smi, "rates": res["rates"],
                      "m2l_fit": res["m2l_fit"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
