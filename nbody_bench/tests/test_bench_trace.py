"""The trace's reduction and the metric readers, on a synthetic trace whose
answers are known and on a small profile recorded on an H100 (the galaxy
cell's path at 16,384 bodies, 20 profiled frames:
``data/trace_small.json``)."""
import json
from pathlib import Path

import pytest

from nbody_bench import harness, trace

DATA = Path(__file__).parent / "data"


def _synthetic():
    # two frames of 100 us; kernels on two streams overlap in frame 0
    return {"frames": 2,
            "spans": [["frame", 0.0, 100.0], ["dispatch", 0.0, 30.0],
                      ["readback", 60.0, 100.0], ["frame", 100.0, 200.0],
                      ["dispatch", 100.0, 130.0], ["readback", 160.0, 200.0]],
            "device": [["void p2p_kernel<float>(Row const*)", 10.0, 50.0,
                        "kernel"],
                       ["sweep_rows_kernel", 20.0, 40.0, "kernel"],
                       ["Memcpy DtoH (Device -> Pageable)", 70.0, 80.0,
                        "copy"],
                       ["void p2p_kernel<float>(Row const*)", 110.0, 150.0,
                        "kernel"],
                       ["Memset (Device)", 150.0, 155.0, "memset"],
                       ["outside", 250.0, 260.0, "kernel"]],
            "host": [["aten::copy_", 60.0, 99.0], ["cudaMemcpyAsync", 61.0,
                                                   98.0],
                     ["aten::mul", 0.0, 9.0]]}


def _run(d, n=1000, frames=2, window_s=250e-6):
    spec = harness.Spec("clusters1m.adaptive")
    view = harness.RunView(spec, n)
    view.trace = trace.TraceView(d)
    view.frames, view.window_s = frames, window_s
    view.spans["dispatch"] = [1e-3, 3e-3]
    view.spans["readback"] = [2e-3, 4e-3]
    return view


def _read(name, view):
    return harness.Spec("clusters1m.adaptive").module("metrics",
                                                      name).read(view)


def test_union_counts_overlap_once():
    t = trace.TraceView(_synthetic())
    assert (t.t0, t.t1) == (0.0, 200.0)
    assert t.busy() == [(10.0, 50.0), (70.0, 80.0), (110.0, 155.0)]
    assert t.busy_us() == 95.0 and t.busy_us(("kernel",)) == 80.0
    assert t.launches() == 3          # the kernel outside the window is out


def test_readers_on_the_synthetic_trace():
    view = _run(_synthetic())
    assert _read("launches_per_step", view) == 1.5
    assert _read("near_field_ms", view) == pytest.approx(0.04)
    assert _read("dispatch_ms", view) == pytest.approx(2.0)
    assert _read("readback_ms", view) == pytest.approx(3.0)
    # 95 us busy in the 200 us of the profiled frames
    assert _read("device_idle_share", view) == pytest.approx(52.5)
    roof = _read("exact_sweep_roofline", view)
    assert roof == pytest.approx(100 * 20 * 1e6 / 67e12 * 1e3 / 0.04)


def test_idle_gaps_are_named_by_span_and_host_op():
    gaps = dict(trace.TraceView(_synthetic()).idle_gaps())
    assert gaps["readback: cudaMemcpyAsync"] == pytest.approx(30.0)
    assert gaps["dispatch: aten::mul"] == pytest.approx(10.0)
    b = trace.TraceView(_synthetic()).breakdown()
    assert b["device_ops"][0] == ["p2p_kernel<float>", pytest.approx(40e-6)]
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(105e-6 / 2)


def test_a_reader_with_nothing_to_read_returns_nothing():
    d = _synthetic()
    d["device"] = [x for x in d["device"] if "p2p" not in x[0]]
    view = _run(d)
    assert _read("near_field_ms", view) is None
    view.trace = None
    for name in ("launches_per_step", "device_idle_share",
                 "exact_sweep_roofline", "near_field_ms"):
        assert _read(name, view) is None


@pytest.mark.skipif(not (DATA / "trace_small.json").exists(),
                    reason="no recorded profile")
def test_readers_on_a_recorded_profile():
    d = json.loads((DATA / "trace_small.json").read_text())
    t = trace.TraceView(d)
    view = _run(d, n=16384, frames=t.frames,
                window_s=t.window_us * 1e-6)
    assert t.frames == 20 and t.device
    assert _read("launches_per_step", view) == 21.0
    roof = _read("exact_sweep_roofline", view)
    assert 10.0 < roof < 100.0
    assert 0.0 <= _read("device_idle_share", view) < 100.0
    assert _read("near_field_ms", view) is None
    b = t.breakdown()
    assert "sweep_rows_kernel" in b["device_ops"][0][0]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
