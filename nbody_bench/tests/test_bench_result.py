"""The command's output: its last line is the result object with the keys
a runner reads, the checks last, and the numbers compared beside their
limits as the last lines on standard error.  The look for a card is faked
here and the run made on the CPU; without a card it prints no result."""
import json

import pytest
import torch

from nbody_bench import harness, run

from conftest import N_CPU, cpu_overrides, cpu_run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _main(monkeypatch, capsys, cell, trace):
    real = harness.run_cell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda spec, seed, s, t, dev,
                        t0: real(spec, seed, 0.3, t, "cpu", t0, n=N_CPU,
                                 overrides=cpu_overrides(spec)))
    rc = run.main(["--workload", cell, "--seed", "2147483901",
                   "--seconds", "0.3", "--trace", str(trace)])
    out, err = capsys.readouterr()
    return rc, out.strip().splitlines(), err.strip().splitlines()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["galaxy200k.exact", "clusters1m.adaptive"])
def test_last_line_schema(monkeypatch, capsys, cell, trace):
    rc, out, err = _main(monkeypatch, capsys, cell, trace)
    assert rc == 0
    res = json.loads(out[-1])
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    spec = harness.Spec(cell)
    want = {m["name"]: m["unit"]
            for m in (spec.per_layer if trace else spec.end_to_end)}
    for name, m in res["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    if not trace:
        assert set(res["metrics"]) == set(want)   # every end-to-end metric
    else:
        spans = {m for m in want if m.split(".")[0] in ("dispatch_ms",
                                                         "readback_ms")}
        assert len(spans) == 2 and spans <= set(res["metrics"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    checks = res["checks"]
    assert set(checks) == set(spec.cell["limits"])
    tail = err[-len(checks):]
    for line, (k, c) in zip(tail, checks.items()):
        assert line.startswith(f"check {k} ") and f"limit {c['limit']!r}" \
            in line


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "galaxy200k.exact", "--seed", "1",
                   "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out.strip() == ""


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "galaxy200k.exact", "--seed", "1",
                   "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out.strip() == ""


def test_a_cell_not_in_the_benchmark_is_refused():
    with pytest.raises(KeyError, match="not a cell"):
        harness.Spec("galaxy200k.nowhere")


def test_a_jax_module_loaded_means_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run, "foreign_modules", lambda: ["jax"])
    rc, out, err = _main(monkeypatch, capsys, "galaxy200k.exact", 0)
    assert rc == 3 and out == [] and "jax" in err[-1]


def test_the_same_seed_gives_the_same_inputs_and_sample():
    spec = harness.Spec("galaxy200k.exact")
    a = harness.make_inputs(spec, 2**31 + 3, 256)
    b = harness.make_inputs(spec, 2**31 + 3, 256)
    assert all((a[k] == b[k]).all() for k in harness.FIELDS)


@pytest.mark.parametrize("traced", [False, True])
def test_a_window_ends_on_whole_periods(traced):
    res, view = cpu_run("galaxy200k.exact", traced=traced, seconds=0.05,
                        overrides={"period_frames": 7, "span_frames": 9})
    assert res["correct"] and len(view.frame_s) == view.frames > 0
    if traced:    # 9 span frames, rounded up to two periods
        assert view.frames == 14
    else:
        assert view.frames % 7 == 0
