"""``syncs_per_step`` on a synthetic trace whose answer is known and on the
small profile recorded on an H100 (``data/trace_small.json``, the galaxy
cell's path at 16,384 bodies, whose step waits on nothing)."""
import json
from pathlib import Path

import pytest

from nbody_bench import harness, trace

DATA = Path(__file__).parent / "data"


def _view(d, frames):
    spec = harness.Spec("clusters1m.adaptive")
    view = harness.RunView(spec, 1000)
    view.trace = trace.TraceView(d)
    view.frames = frames
    return view


def _read(view):
    return harness.Spec("clusters1m.adaptive").module(
        "metrics", "syncs_per_step").read(view)


def _synthetic():
    # two frames of 100 us; the step's waits lie in the dispatch spans, the
    # frame's own synchronise and the read-back's copy after them
    return {"frames": 2,
            "spans": [["frame", 0.0, 100.0], ["dispatch", 0.0, 50.0],
                      ["sync", 50.0, 60.0], ["readback", 60.0, 100.0],
                      ["frame", 100.0, 200.0], ["dispatch", 100.0, 150.0],
                      ["sync", 150.0, 160.0], ["readback", 160.0, 200.0]],
            "device": [["sweep_rows_kernel", 10.0, 45.0, "kernel"],
                       ["sweep_rows_kernel", 110.0, 145.0, "kernel"]],
            "host": [["cudaMemcpyAsync", 5.0, 6.0],
                     ["cudaStreamSynchronize", 6.0, 9.0],
                     ["cudaLaunchKernel", 9.0, 10.0],
                     ["cudaEventSynchronize", 20.0, 21.0],
                     ["cudaMemcpy", 120.0, 125.0],
                     ["cudaDeviceSynchronize", 149.0, 152.0],
                     ["cudaStreamWaitEvent", 130.0, 131.0],
                     ["cudaDeviceSynchronize", 50.5, 58.0],
                     ["cudaMemcpyAsync", 61.0, 98.0],
                     ["cudaStreamSynchronize", 98.0, 99.0],
                     ["cudaDeviceSynchronize", 150.5, 158.0]]}


@pytest.mark.parametrize("frames, want", [(2, 2.0), (4, 1.0)])
def test_waits_inside_the_dispatch_spans_count(frames, want):
    # inside: StreamSynchronize at 6, EventSynchronize at 20, Memcpy at 120,
    # DeviceSynchronize starting at 149; async copies, launches, a stream's
    # wait on an event and everything from 150 on in sync or readback do not
    d = _synthetic()
    d["frames"] = frames
    assert _read(_view(d, frames)) == pytest.approx(want)


def test_nothing_to_read_returns_nothing():
    d = _synthetic()
    view = _view(d, 2)
    view.trace = None
    assert _read(view) is None
    d["spans"] = [x for x in d["spans"] if x[0] != "dispatch"]
    assert _read(_view(d, 2)) is None
    d = _synthetic()
    d["device"] = []
    d["spans"] = [x for x in d["spans"] if x[0] in ("frame", "dispatch")]
    assert _read(_view(d, 2)) is None


@pytest.mark.skipif(not (DATA / "trace_small.json").exists(),
                    reason="no recorded profile")
def test_the_recorded_galaxy_step_waits_on_nothing():
    d = json.loads((DATA / "trace_small.json").read_text())
    t = trace.TraceView(d)
    # its waits are the frames' synchronise and the read-backs' copies
    host = {x[0] for x in t.host}
    assert {"cudaStreamSynchronize", "cudaDeviceSynchronize"} <= host
    assert _read(_view(d, t.frames)) == 0.0
