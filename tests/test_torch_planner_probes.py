"""The calibration probes' fits (scripts/torch_adaptive_stage_probe.py,
scripts/torch_m2l_tier_probe.py) on synthetic measurements made from
known constants: each fit must give the constants back; and on the H100
measurements kept in docs/planner_rates, the planners' "cuda" tables.
No card: the fits are numpy on the measurements a card run writes
(``--raw``)."""
import importlib.util
import os

import numpy as np
import pytest

from murb_tpu_torch.ops import sparse_fmm as ts
from murb_tpu_torch.utils.profile_step import fit_relative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("coef", [(2.0, 0.5, 3.0), (1e-3, 7.0, 0.25)])
def test_fit_relative_recovers_its_coefficients(coef):
    rng = np.random.default_rng(1)
    rows = rng.uniform(0.1, 10.0, (12, 3))
    ys = rows @ np.asarray(coef)
    got = fit_relative(rows, ys, ("a", "b", "c"))
    assert [got[k] for k in "abc"] == pytest.approx(coef, rel=1e-9)


def test_fit_relative_drops_a_column_that_fits_negative():
    rng = np.random.default_rng(2)
    rows = np.column_stack([rng.uniform(1, 10, 20), rng.uniform(1, 10, 20),
                            np.ones(20)])
    ys = 3.0 * rows[:, 0] + 5.0            # no share of the second column
    ys[::2] -= 0.4 * rows[::2, 1]          # ... and a negative pull from it
    got = fit_relative(rows, ys, ("a", "b", "c"))
    assert got["b"] == 0.0 and got["a"] > 0 and got["c"] > 0


TRUE = ts.PlannerRates(mac_per_ms=3.0e10, gather_bytes_per_ms=2.0e8,
                       p2p_slots_per_ms=2.5e10, anterp_us_per_body=0.004,
                       misc_ms_per_level=12.0, misc_ms=3.0, factor=0.9,
                       exact_slots_per_ms=2.8e10)
M0, MV, C_LEVEL = 8, 6, 6.5


def synthetic_stage_raw():
    """Measurements of the stage probe as a card would give them if the
    card followed the model at TRUE: the M2L a level at the physical
    rates (TRUE's at the validated order), K10, the windows, the steps at
    mv and the exact step."""
    probe = script("torch_adaptive_stage_probe")
    phys_mac = TRUE.mac_per_ms / (M0 / MV) ** 6
    phys_gather = TRUE.gather_bytes_per_ms / (M0 / MV) ** 3
    raw = []
    for n, ld, lv, stats in ((131_072, 2, 6, [29, 100, 461, 2216]),
                             (524_288, 2, 7, [29, 110, 534, 2795, 14517])):
        bricks = n // 3
        m2l = []
        for m in (4, MV, M0):
            for i, nc in enumerate(stats):
                macs, nbytes = probe.m2l_counts(nc, m)
                m2l.append({"m": m, "level": ld + 1 + i, "nc": nc,
                            "event_ms": macs / phys_mac
                            + nbytes / phys_gather + C_LEVEL})
        steps = []
        for sld, slv in ((ld, lv), (ld, lv - 1), (3, lv), (ld, lv + 1)):
            sst = stats[:slv - ld] if slv <= lv else stats + [4 * stats[-1]]
            sst = sst[sld - ld:]
            sb = bricks * 2 ** (lv - slv)
            steps.append({"m": MV, "Ld": sld, "L": slv, "stats": sst,
                          "bricks": sb,
                          "step_ms": ts.cost_with_rates(TRUE, sst, sb, n, M0,
                                                        sld, slv)})
        # the order the CLI runs, not part of the fit
        steps.append({"m": M0, "Ld": ld, "L": lv, "stats": stats,
                      "bricks": bricks, "step_ms": 1e4})
        ev = lambda ms: {"event_ms": ms, "device_ms": ms / 2}
        raw.append({
            "n": n, "npad": n, "m0": M0, "mv": MV, "Ld": ld, "L": lv,
            "stats": stats, "bricks": bricks, "m2l": m2l, "steps": steps,
            "stages": {"p2p": ev(bricks * 128 ** 2 * 26
                                 / TRUE.p2p_slots_per_ms),
                       "anterp": ev(n * TRUE.anterp_us_per_body / 1e3),
                       "chain": ev(2.0), "hierarchy": ev(300.0),
                       "dense": ev(0.2), "preamble": ev(2.0),
                       "solve": ev(200.0)},
            "exact_step_ms": 14.0 * n * n / TRUE.exact_slots_per_ms})
    return probe, raw


def test_stage_fit_gives_the_rates_back():
    probe, raw = synthetic_stage_raw()
    res = probe.fit(raw)
    got = res["rates"]
    for field in ts.PlannerRates._fields:
        assert got[field] == pytest.approx(getattr(TRUE, field),
                                           rel=1e-6), field
    assert res["m2l_fit"]["ms_a_level"] == pytest.approx(C_LEVEL, rel=1e-6)
    for c in res["checks"]:
        if c.get("exact") or c["m"] == MV:
            assert c["predicted_ms"] == pytest.approx(c["measured_ms"],
                                                      rel=1e-6)


def test_stage_fit_refits_a_raw_file(tmp_path, capsys):
    import json

    probe, raw = synthetic_stage_raw()
    src = tmp_path / "raw.json"
    src.write_text(json.dumps({"card": "synthetic card, 700.00 W",
                               "raw": raw}))
    assert probe.main(["--from", str(src)]) == 0
    last = capsys.readouterr().out.strip().splitlines()
    assert last[-2] == "synthetic card, 700.00 W"
    line = json.loads(last[-1])
    assert line["rates"]["factor"] == pytest.approx(TRUE.factor, rel=1e-6)


@pytest.mark.parametrize("a,b,c", [(4e-11, 2.5, 3.0), (1e-10, 0.5, 1.0)])
def test_depth_fit_gives_the_overhead_back(a, b, c):
    probe = script("torch_m2l_tier_probe")
    n, lmin = 200_192, 2
    rows = []
    for m in (4, 6, 8, 10):
        for lv in (2, 3, 4):
            w = probe.model_macs(n, m, lv)
            rows.append({"m": m, "L": lv, "W": w, "device_ms": 1.0,
                         "wall_ms": a * w + b * (lv - lmin) + c})
    res = probe.fit({"lmin": lmin, "rows": rows,
                     "candidates": [[8, 2], [6, 3], [4, 4]]})
    assert res["mac_per_ms"] == pytest.approx(1 / a, rel=1e-6)
    assert res["level_ms"] == pytest.approx(b, rel=1e-6)
    assert res["level_overhead"] == pytest.approx(b / a, rel=1e-6)
    for cand in res["candidates"]:
        assert cand["predicted_ms"] == pytest.approx(cand["wall_ms"],
                                                     rel=1e-6)


def test_the_cards_tables_are_the_probes_fits_of_the_h100_runs():
    """PLANNER_RATES["cuda"] and LEVEL_OVERHEAD["cuda"] are what the two
    probes fit from the H100 measurements kept in docs/planner_rates."""
    import json

    from murb_tpu_torch.ops import fmm as tf

    def raw(name):
        with open(os.path.join(ROOT, "docs", "planner_rates", name)) as f:
            doc = json.load(f)
        assert doc["card"].startswith("NVIDIA H100")
        return doc["raw"]

    # to the last digits a least-squares solve may move between BLAS builds
    got = script("torch_adaptive_stage_probe").fit(
        raw("h100_stage_raw.json"))["rates"]
    for field, want in ts.PLANNER_RATES["cuda"]._asdict().items():
        assert got[field] == pytest.approx(want, rel=1e-9), field
    depth = script("torch_m2l_tier_probe").fit(raw("h100_depth_raw.json"))
    assert depth["level_overhead"] == pytest.approx(
        tf.LEVEL_OVERHEAD["cuda"], rel=1e-9)


@pytest.mark.parametrize("name", ["torch_adaptive_stage_probe",
                                  "torch_m2l_tier_probe"])
def test_probes_refuse_to_measure_without_a_card(name, capsys):
    """A measurement needs the card: without one each probe exits 1 and
    prints no fit (it does not fall back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would measure it")
    assert script(name).main([]) == 1
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and captured.out == ""
