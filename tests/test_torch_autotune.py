"""The port's block autotuner (utils/autotune.py) and its engine wiring:
murb_tpu's tests/test_autotune.py cases that apply to the port's exact
sweeps (K3, K4, K13), on the CPU (where the sweep times the plain
versions: only the wiring is under test here; chip_smoke.py phase 10
times the kernels)."""
import json
import re

import numpy as np
import pytest
import torch

from murb_tpu.core import init as jinit
from murb_tpu.models import create_engine as jcreate
from murb_tpu_torch import cli
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine
from murb_tpu_torch.ops import cuda
from murb_tpu_torch.utils import autotune as at

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0
CPU = {"device": "cpu"}


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("MURB_TUNE_CACHE", path)
    monkeypatch.delenv("MURB_AUTOTUNE", raising=False)
    return path


def test_store_lookup_roundtrip(tune_cache):
    assert at.lookup("k", 1024, **CPU) is None
    at.store("k", 1024, {"block_i": 512, "block_j": 256}, 1.25, **CPU)
    got = at.lookup("k", 1024, **CPU)
    assert got["block_i"] == 512 and got["ms_per_step"] == 1.25
    # keys are per (kernel, npad, device)
    assert at.lookup("k", 2048, **CPU) is None
    assert at.lookup("other", 1024, **CPU) is None


def test_keys_carry_the_device_name(tune_cache, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    at.store("k", 1024, {"block_i": 64, "block_j": 64}, 2.0, device="cuda")
    assert at.lookup("k", 1024, **CPU) is None
    assert at.lookup("k", 1024, device="cuda")["block_i"] == 64
    assert at._key("k", 1024, "cuda") == \
        "torch/k/n1024/NVIDIA H100 80GB HBM3"
    assert at._key("k", 1024, "cpu") == "torch/k/n1024/cpu"


@pytest.mark.parametrize("im,key", [
    ("tpu+tile", "torch/tpu+tile@k3rows/n512/cpu"),
    ("tpu+hybrid+fast", "torch/tpu+hybrid/p1@k4fast/n512/cpu"),
    ("tpu+hybrid", "torch/tpu+hybrid/p2@k3rows/n512/cpu"),
    ("tpu+hybrid+x3", "torch/tpu+hybrid/p3/n512/cpu"),
    ("tpu+mxu", "torch/tpu+mxu@k13mma/n512/cpu")])
def test_keys_of_k3_carry_its_design(tune_cache, im, key):
    """The engines that launch K3, and K13's, tag the kernel's redesign in
    their key, so a pick cached for the first design is not read; the
    others keep their keys."""
    bodies = carry(jinit.init_galaxy(500, 3))
    e = create_engine(im, bodies, soft=SOFT, dt=DT)
    assert at._key(e._tune_tag, bodies.npad, "cpu") == key
    old = re.sub(r"@\w+", "", key)
    with open(at._cache_path(), "w") as f:
        json.dump({old: {"block_i": 512, "block_j": 512}}, f)
    again = create_engine(im, bodies, soft=SOFT, dt=DT)
    assert (again.tuned is None) == ("@" in key)


def test_cache_path_defaults_to_the_build_directory(monkeypatch):
    monkeypatch.delenv("MURB_TUNE_CACHE", raising=False)
    assert at._cache_path() == str(cuda.BUILD_DIR / "autotune.json")
    monkeypatch.setenv("MURB_AUTOTUNE", "1")
    assert at.enabled()
    monkeypatch.setenv("MURB_AUTOTUNE", "0")
    assert not at.enabled()


def test_tune_picks_fastest_and_caches(tune_cache, monkeypatch):
    calls = []
    times = {(128, 128): 5.0, (256, 128): 1.0, (256, 256): 3.0}

    def fake_measure(run_fn, state0, **kw):
        calls.append(run_fn)
        return times[run_fn]

    monkeypatch.setattr(at, "measure_steps", fake_measure)
    cands = [{"block_i": bi, "block_j": bj} for bi, bj in times]
    best = at.tune("fake", 512, lambda p: (p["block_i"], p["block_j"]),
                   None, candidates=cands, **CPU)
    assert best["block_i"] == 256 and best["block_j"] == 128
    assert [ms for _, ms in best["sweep"]] == [5.0, 1.0, 3.0]
    assert len(calls) == 3
    # second call: served from the cache, no measurement, no sweep
    again = at.tune("fake", 512, lambda p: 1 / 0, None, candidates=cands,
                    **CPU)
    assert again["block_i"] == 256 and "sweep" not in again
    assert len(calls) == 3


def test_tune_skips_infeasible_candidates(tune_cache, monkeypatch, capsys):
    def fake_measure(run_fn, state0, **kw):
        if run_fn == "bad":
            raise ValueError("block_i=96 is not supported")
        return 2.0

    monkeypatch.setattr(at, "measure_steps", fake_measure)
    best = at.tune("fk", 256, lambda p: p["tag"], None,
                   candidates=[{"tag": "bad"}, {"tag": "ok"}], **CPU)
    assert best["tag"] == "ok"
    assert best["sweep"] == [({"tag": "bad"}, None), ({"tag": "ok"}, 2.0)]
    assert "skipped {'tag': 'bad'}" in capsys.readouterr().err


def test_block_candidates_are_the_compiled_blocks():
    """The kernels mask ragged edges, so a candidate need not divide npad:
    every compiled pair no larger than npad is one."""
    cands = at.block_candidates("tpu+tile", 6144)
    assert len(cands) == len(cuda.SWEEP_BLOCKS) ** 2
    for c in cands:
        assert c["block_i"] in cuda.SWEEP_BLOCKS
        assert c["block_j"] in cuda.SWEEP_BLOCKS
    small = at.block_candidates("tpu+mxu", 256)
    assert {c["block_i"] for c in small} == {64, 128, 256}
    assert at.block_candidates("tpu+tile", 32) == [{"block_i": 0,
                                                     "block_j": 0}]


@pytest.mark.parametrize("tag", ["tpu+tile", "tpu+mxu"])
def test_engine_uses_cached_blocks(tune_cache, tag):
    """An engine with unspecified blocks picks up a persisted tune result
    even with autotuning off; explicit blocks always win."""
    bodies = carry(jinit.init_galaxy(500, 3))
    key = create_engine(tag, bodies, soft=SOFT, dt=DT, block_i=64,
                        block_j=64)._tune_tag
    at.store(key, bodies.npad, {"block_i": 256, "block_j": 512}, 0.5, **CPU)
    e = create_engine(tag, bodies, soft=SOFT, dt=DT)
    assert (e.block_i, e.block_j) == (256, 512)
    assert e.tuned["ms_per_step"] == 0.5
    e2 = create_engine(tag, bodies, soft=SOFT, dt=DT, block_i=128,
                       block_j=64)
    assert (e2.block_i, e2.block_j) == (128, 64) and e2.tuned is None
    with pytest.raises(ValueError, match="block_j=100 is not supported"):
        create_engine(tag, bodies, soft=SOFT, dt=DT, block_j=100)


@pytest.mark.parametrize("tag", ["tpu+tile", "tpu+mxu"])
def test_engine_autotune_sweep_runs(tune_cache, tag):
    """autotune=True times every candidate (the plain versions on the CPU)
    and persists a choice; the trajectory stays right (one step against
    murb_tpu's naive engine, WithinRel-class rtol 1e-5 for K3's plain
    version, 5e-4 for the norm expansion)."""
    js = jinit.init_galaxy(512, 3)
    e = create_engine(tag, carry(js), soft=SOFT, dt=DT, autotune=True)
    assert at.lookup(e._tune_tag, js.npad, **CPU) is not None
    assert e.block_i > 0 and e.block_j > 0
    assert len(e.tuned["sweep"]) == 16      # npad 512: every pair fits
    ref = jcreate("cpu+naive", js, soft=SOFT, dt=DT)
    e.compute_one_iteration()
    ref.compute_one_iteration()
    a, b = ref.bodies.unpadded(), e.bodies.unpadded()
    np.testing.assert_allclose(b["qx"], a["qx"],
                               rtol=1e-5 if tag == "tpu+tile" else 5e-4)


def test_cache_written_by_murb_tpu_is_not_read(tune_cache):
    """murb_tpu keys ``tpu+mxu/n2048/cpu`` in the same ``$MURB_TUNE_CACHE``
    with block sizes the port's sweeps are not compiled for: a port engine
    must step past such an entry, and its own entry lands under its own
    key."""
    import json

    with open(tune_cache, "w") as f:
        json.dump({"tpu+mxu/n2048/cpu": {"block_i": 1024, "block_j": 512,
                                          "ms_per_step": 1.0}}, f)
    js = jinit.init_galaxy(2000, 3)
    assert js.npad == 2048
    e = create_engine("tpu+mxu", carry(js), soft=SOFT, dt=DT)
    assert (e.block_i, e.block_j) == (0, 0) and e.tuned is None
    e.compute_one_iteration()
    e.assert_finite()
    at.store(e._tune_tag, 2048, {"block_i": 64, "block_j": 128}, 0.5, **CPU)
    with open(tune_cache) as f:
        db = json.load(f)
    assert db["tpu+mxu/n2048/cpu"]["block_i"] == 1024
    assert db["torch/tpu+mxu@k13mma/n2048/cpu"]["block_i"] == 64
    assert create_engine("tpu+mxu", carry(js), soft=SOFT,
                         dt=DT).block_i == 64
    # a port entry the sweeps are not compiled for is skipped too
    at.store(e._tune_tag, 2048, {"block_i": 96, "block_j": 128}, 0.5, **CPU)
    assert create_engine("tpu+mxu", carry(js), soft=SOFT,
                         dt=DT).block_i == 0


def test_k13_pick_of_its_first_design_is_not_read(tune_cache):
    """A K13 block pair cached under the first design's key (``tpu+mxu``,
    before the tensor-core redesign) is not read: the engine keeps the
    kernel default, and its own pick lands under ``tpu+mxu@k13mma``."""
    bodies = carry(jinit.init_galaxy(500, 3))
    at.store("tpu+mxu", bodies.npad, {"block_i": 512, "block_j": 512}, 0.5,
             **CPU)
    e = create_engine("tpu+mxu", bodies, soft=SOFT, dt=DT)
    assert e._tune_tag == "tpu+mxu@k13mma"
    assert (e.block_i, e.block_j) == (0, 0) and e.tuned is None
    at.store(e._tune_tag, bodies.npad, {"block_i": 128, "block_j": 64}, 0.4,
             **CPU)
    again = create_engine("tpu+mxu", bodies, soft=SOFT, dt=DT)
    assert (again.block_i, again.block_j) == (128, 64)


def test_hybrid_pass_counts_tune_separately(tune_cache):
    bodies = carry(jinit.init_galaxy(500, 3))
    e1 = create_engine("tpu+hybrid", bodies, soft=SOFT, dt=DT)
    e2 = create_engine("tpu+hybrid+fast", bodies, soft=SOFT, dt=DT)
    assert e1._tune_tag == "tpu+hybrid/p2@k3rows" and \
        e2._tune_tag == "tpu+hybrid/p1@k4fast"
    at.store(e2._tune_tag, bodies.npad, {"block_i": 64, "block_j": 64},
             0.1, **CPU)
    e3 = create_engine("tpu+hybrid+fast", bodies, soft=SOFT, dt=DT)
    e4 = create_engine("tpu+hybrid", bodies, soft=SOFT, dt=DT)
    assert (e3.block_i, e4.block_i) == (64, 0)


def test_cli_autotune_then_reads_the_cache(tune_cache, capsys):
    argv = ["-n", "300", "-i", "1", "--im", "tpu+hybrid", "--nv",
            "--device", "cpu"]
    r1 = cli.run(argv + ["--autotune"])
    assert r1.rc == 0 and "sweep" in r1.engine.tuned
    assert "(tuned, " in capsys.readouterr().out
    r2 = cli.run(argv)
    assert r2.rc == 0 and "sweep" not in r2.engine.tuned
    assert (r2.engine.block_i, r2.engine.block_j) == (r1.engine.block_i,
                                                       r1.engine.block_j)
