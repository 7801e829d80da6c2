"""The port's tracer (utils/trace.py) and the spans the program opens, on
the CPU.

  * off (the default): ``span`` is the shared null context, keeps nothing
    and reads no clock; on and off give the same states bit for bit;
  * on: the records (ids, parents, attrs), ``count``, ``drain``; the span
    tree of an adaptive step and of an adaptive solve with two sparse
    levels; the health check once at ``adapt_every``; the engine build's
    ``build.*`` spans with the plan's attrs; the exact wrapper's
    ``exact.prepare`` and ``exact.sweep`` around its launch (its CUDA path
    on meta tensors, the launch recorded, not run);
  * under a CPU-only ``torch.profiler``, the spans as ``murb.`` ranges and
    ``profile_rows``; the CLI's ``--profile``, which prints the records of
    the engine build and of each health check.
"""
import contextlib
import ctypes
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from murb_tpu_torch.core.init import make_bodies
from murb_tpu_torch.core.state import FIELDS
from murb_tpu_torch.models import create_engine
from murb_tpu_torch.models.engines import _active_positions
from murb_tpu_torch.ops import cuda, hybrid
from murb_tpu_torch.ops.p2p import estimate_brick_pairs
from murb_tpu_torch.ops.sparse_fmm import acc_adaptive, plan_adaptive
from murb_tpu_torch.utils import trace

torch.set_num_threads(2)
N = 2048
#: the random box at a softening that clusters it for the solvers (the
#: CLI's ``--soft 1e6``): the adaptive plan (Ld, L) = (2, 3), m = 6
ADAPTIVE = dict(soft=1e6, near="adaptive")
STAGES = ["adaptive.sort", "adaptive.p2m", "adaptive.upward",
          "adaptive.dense"]
TAIL = ["adaptive.l2p", "adaptive.near", "adaptive.combine"]


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture(scope="module")
def state():
    return make_bodies(N, "random", device="cpu")


@pytest.fixture(scope="module")
def built(state):
    """An auto-policy adaptive engine (``adapt_every`` 2) built with the
    tracer on, and the build's records."""
    trace.enable()
    try:
        eng = create_engine("tpu+proxy", state, adapt_every=2, **ADAPTIVE)
    finally:
        trace.disable()
    return eng, trace.drain()


def _names(records):
    return [r["name"] for r in records]


def _children(records, rec):
    return [r for r in records if r["parent"] == rec["id"]]


# ----------------------------------------------------------------- the tracer
@pytest.mark.parametrize("name, attrs", [
    ("step", {"iteration": 3}), ("adaptive.sort", {}),
    ("build.plan", {"m": 6, "levels": 3})])
def test_off_is_the_shared_null_context(monkeypatch, name, attrs):
    reads = []
    monkeypatch.setattr(trace.time, "perf_counter_ns",
                        lambda: reads.append(1) or 0)
    sp = trace.span(name, **attrs)
    assert sp is trace.NULL
    with sp as inner:
        inner.set(k=1)
        trace.count(name)
    assert reads == [] and not trace.enabled()
    assert trace.drain() == {"spans": [], "counts": {}}


def test_records_nest_and_take_attrs():
    trace.enable()
    with trace.span("outer", a=1) as outer:
        with trace.span("inner"):
            trace.count("c")
            trace.count("c", 4)
        with pytest.raises(ValueError):
            with trace.span("failed"):
                raise ValueError("closes its span")
    outer.set(b=2)      # also after the span ended
    got = trace.drain()
    o, i, f = got["spans"]
    assert _names(got["spans"]) == ["outer", "inner", "failed"]
    assert o["parent"] is None and i["parent"] == f["parent"] == o["id"]
    assert o["attrs"] == {"a": 1, "b": 2}
    assert all(r["start_ns"] <= r["end_ns"] for r in (o, i, f))
    assert o["start_ns"] <= i["start_ns"] and i["end_ns"] <= o["end_ns"]
    assert got["counts"] == {"c": 5}


def test_drain_empties_the_records():
    trace.enable()
    with trace.span("a"):
        pass
    trace.count("k")
    first = trace.drain()
    assert len(first["spans"]) == 1 and first["counts"] == {"k": 1}
    assert trace.drain() == {"spans": [], "counts": {}}
    trace.disable()     # off keeps what was kept until the drain
    assert not trace.enabled()


# ------------------------------------------------------------ the program
@pytest.mark.parametrize("tag, opts", [
    ("tpu+hybrid", {}),
    ("tpu+proxy", dict(m=6, levels=3, **ADAPTIVE))])
def test_on_and_off_give_the_same_bits(state, tag, opts):
    runs = []
    for on in (False, True):
        eng = create_engine(tag, state, **opts)
        if on:
            trace.enable()
        eng.run(3)
        trace.disable()
        runs.append(eng.bodies)
    assert trace.drain()["spans"]
    for k in FIELDS:
        assert torch.equal(getattr(runs[0], k), getattr(runs[1], k)), k


def test_build_records_the_plan(built, state):
    eng, rec = built
    spans = rec["spans"]
    tops = [r for r in spans if r["parent"] is None]
    assert _names(tops) == ["build.plan", "build.validate"]
    plan = tops[0]["attrs"]
    assert (plan["dense_levels"], plan["levels"]) == (
        eng._plan.dense_levels, eng._plan.levels)
    assert plan["cell_caps"] == eng._plan.cell_caps
    assert plan["p2p_pmax"] == eng._plan.p2p_pmax
    assert plan["near_mode"] == "adaptive" and plan["using_proxy"]
    assert plan["adaptive_ms"] == eng.cost_estimates["adaptive_ms"]
    assert plan["exact_ms"] == eng.cost_estimates["exact_ms"]
    assert plan["counts_device"] == "cpu"
    assert tops[1]["attrs"]["m"] == eng.m == eng._plan.m
    assert tops[1]["attrs"]["err"] == eng.validated_err
    # the validation's solves nest under it
    assert set(_names(_children(spans, tops[1]))) >= set(STAGES + TAIL)
    q = _active_positions(eng.bodies)
    assert rec["counts"] == {"plan.brick_pairs": estimate_brick_pairs(
        q, state.npad, eng._plan.levels)}


def test_exact_build_records_its_geometry(state):
    trace.enable()
    create_engine("tpu+hybrid", state)
    assert _names(trace.drain()["spans"]) == ["build.geometry"]


def test_adaptive_step_tree_and_one_health_check(built):
    eng, _ = built
    trace.enable()
    eng.run(2)
    health = eng.proxy_health()     # what the check at iteration 2 reads
    eng.run(1)
    spans = trace.drain()["spans"]
    steps = [r for r in spans if r["parent"] is None]
    assert [s["attrs"] for s in steps] == [{"iteration": i}
                                          for i in range(3)]
    for s in steps:
        top = _children(spans, s)
        adapt = ["adapt"] if s["attrs"]["iteration"] == 2 else []
        assert _names(top) == adapt + ["force", "update"]
        (force,) = [r for r in top if r["name"] == "force"]
        assert _names(_children(spans, force)) == STAGES + [
            "adaptive.l2l", "sparse_m2l"] + TAIL
    (adapt,) = [r for r in spans if r["name"] == "adapt"]
    assert adapt["attrs"] == {"ok": True, "reconfigured": False,
                              "counts_device": "cpu",
                              "n_cells_now": health["n_cells_now"],
                              "p2p_pairs_now": health["p2p_pairs_now"]}


def test_two_sparse_levels_each_in_its_span(state):
    q = torch.stack([state.qx, state.qy, state.qz], 1)[:state.n].numpy()
    plan = plan_adaptive(q, state.npad, 4, 2, 4, device="cpu")
    gm = state.m * 6.67e-11
    trace.enable()
    acc_adaptive(state.qx, state.qy, state.qz, gm, 1e6, plan)
    spans = trace.drain()["spans"]
    assert _names(spans) == STAGES + [
        "adaptive.l2l", "sparse_m2l", "adaptive.l2l", "sparse_m2l"] + TAIL
    assert [r["attrs"] for r in spans if r["name"] == "sparse_m2l"] == [
        {"level": 3}, {"level": 4}]
    assert all(r["parent"] is None for r in spans)


@pytest.fixture
def fake_card(monkeypatch):
    """The exact wrapper's CUDA path on meta tensors: each launch recorded
    with the span open around it."""
    launches = []
    open_at_launch = lambda: trace._open[-1]["name"] if trace._open else None
    monkeypatch.setattr(cuda, "require_cuda", lambda tag, t: None)
    monkeypatch.setattr(cuda, "launch", lambda name, *a: launches.append(
        (name, a, open_at_launch())))
    monkeypatch.setattr(cuda, "resident", lambda *a: 4)
    monkeypatch.setattr(cuda, "sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda, "stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for k in ("launches", "fast_launches"):
        monkeypatch.setattr(hybrid.acc_hybrid_rect, k, 0)
    return launches


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_exact_wrapper_spans_its_launch(fake_card, passes):
    q = torch.zeros(4096, device="meta")
    trace.enable()
    hybrid.acc_hybrid_rect(q, q, q, q, q, q, q, 2e8, passes=passes)
    spans = trace.drain()["spans"]
    assert _names(spans) == ["exact.prepare", "exact.sweep"]
    (name, args, where), = fake_card
    assert where == "exact.sweep"
    assert name == hybrid.hybrid_entry(passes, False)[0]
    kinds = cuda._SIGNATURES[name]
    assert len(args) == len(kinds)
    for a, kind in zip(args, kinds):
        if kind is ctypes.c_float:
            assert isinstance(a, ctypes.c_float)
            assert a.value == ctypes.c_float(2e8 ** 2).value
        elif kind is ctypes.c_int:
            assert isinstance(a, int)
        else:
            assert a is None or isinstance(a, int)
    if passes > 1:
        assert args[10] == passes


@pytest.mark.parametrize("on", [False, True])
def test_profiler_sees_the_spans(state, on):
    eng = create_engine("tpu+hybrid", state)
    if on:
        trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(2)
    trace.disable()
    ranges = {e.name for e in prof.events()
              if e.name.startswith(trace.PREFIX)}
    rows = {r[0]: r[1:] for r in trace.profile_rows(prof)}
    if not on:
        assert ranges == set() and rows == {}
        return
    assert ranges == {"murb.step", "murb.force", "murb.update"}
    assert {k: v[0] for k, v in rows.items()} == {
        "step": 2, "force": 2, "update": 2}
    assert rows["step"][1] >= rows["force"][1] > 0
    assert all(v[2] == 0 for v in rows.values())   # no device activity


def test_profile_rows_charge_kernels_by_their_launch():
    """A kernel counts to the span its launch lies in, also when it runs
    after the span ended; kernels overlapping on two streams count once;
    the device side of a range and a kernel launched outside count for
    none.  Times in the profiler's us."""
    from torch.autograd import DeviceType

    def ev(name, s, e, cid=0, dev=DeviceType.CPU, ann=False):
        return types.SimpleNamespace(
            name=name, id=cid, device_type=dev, is_user_annotation=ann,
            time_range=types.SimpleNamespace(start=s, end=e))

    cuda_ev = lambda name, s, e, cid, ann=False: ev(name, s, e, cid,
                                                     DeviceType.CUDA, ann)
    prof = types.SimpleNamespace(events=lambda: [
        ev("murb.step", 0, 100, cid=1), ev("murb.sweep", 10, 20, cid=2),
        ev("cudaLaunchKernel", 12, 13, cid=901),      # in sweep
        ev("cudaLaunchKernel", 14, 15, cid=902),      # in sweep
        ev("cudaLaunchKernel", 30, 31, cid=903),      # in step only
        ev("cudaLaunchKernel", 150, 151, cid=904),    # outside both
        cuda_ev("k1", 40, 80, 901),     # runs after sweep ended
        cuda_ev("k2", 60, 90, 902),     # overlaps k1 (another stream)
        cuda_ev("k3", 90, 95, 903),
        cuda_ev("k4", 160, 170, 904),
        cuda_ev("murb.sweep", 40, 90, 2, ann=True),
    ])
    rows = {r[0]: r[1:] for r in trace.profile_rows(prof)}
    assert rows == {"step": (1, 0.1, 0.055), "sweep": (1, 0.01, 0.05)}


def test_cli_profile_prints_the_build_and_the_health_checks(tmp_path,
                                                           capsys):
    """``--profile`` turns the tracer on before the engine is built and
    prints the build's spans with the plan's attrs and the counter, then
    each health check of the run; the tracer is off afterwards."""
    from murb_tpu_torch import cli

    res = cli.run(["-n", str(N), "-i", "3", "--im", "tpu+proxy", "--near",
                   "adaptive", "-s", "random", "--soft", "1e6",
                   "--adapt-every", "2", "--nv", "--device", "cpu",
                   "--profile", str(tmp_path / "trace")])
    assert res.rc == 0 and not trace.enabled()
    out = capsys.readouterr().out
    build, run = out.split("Simulation started...")
    assert build.startswith("Engine build (host clock):\n  build.plan ")
    plan = res.engine._plan
    assert (f"near_mode=adaptive dense_levels={plan.dense_levels} "
            f"cell_caps={plan.cell_caps} p2p_pmax={plan.p2p_pmax}") in build
    assert f"err={res.engine.validated_err}" in build
    assert "\n    sparse_m2l " in build        # the validation's solve
    assert "count plan.brick_pairs = " in build
    checks = run.split("Health checks and builds in the run (host "
                       "clock):\n")[1]
    assert checks.count("adapt ") == 1
    assert "ok=True reconfigured=False counts_device=cpu n_cells_now=(" \
        in checks
    assert "  span sparse_m2l " in run
