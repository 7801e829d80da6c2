"""The port's sharded engines (murb_tpu_torch/parallel/shard_engine.py)
against murb_tpu's ``ShardedEngine`` of the same mode and shard count on the
forced CPU mesh: the same numpy state from ``murb_tpu.core.init`` goes to
both, and each check takes the tolerance of the matching murb_tpu test
(tests/test_parallel.py).  Also the sharded checkpoint and the CLI flags
``--shards`` and ``--gpu-fraction``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murb_tpu.core.init import SCHEMES
from murb_tpu.models import create_engine as jcreate
from murb_tpu_torch import cli
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import NOT_YET_PORTED, create_engine
from murb_tpu_torch.parallel.shard_engine import ShardedEngine

from conftest import assert_within_rel

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def _pair(tag, js, d, **kw):
    return (jcreate(tag, js, soft=SOFT, dt=DT, shards=d, **kw),
            create_engine(tag, carry(js), soft=SOFT, dt=DT, shards=d, **kw))


def _acc_close(a, b, eps, rms_floor, msg):
    ja, ta = a.accelerations, b.accelerations
    for c in ("ax", "ay", "az"):
        assert_within_rel(getattr(ta, c).numpy(), np.asarray(getattr(ja, c)),
                          eps, f"{msg} {c}", rms_floor=rms_floor)


def _pos_close(a, b, eps, rms_floor, msg):
    da, db = a.bodies.unpadded(), b.bodies.unpadded()
    for c in ("qx", "qy", "qz"):
        assert_within_rel(db[c], da[c], eps, f"{msg} {c}",
                          rms_floor=rms_floor)


@pytest.mark.parametrize("tag,n,d,kw", [
    ("shard+allgather", 1000, 8, {}),
    ("shard+ring", 1000, 8, {}),
    ("shard+uneven", 700, 4, {"gpu_fraction": 0.25}),
    ("shard+uneven", 700, 4, {"gpu_fraction": 0.60}),
])
def test_exact_modes_match_murb_tpu(tag, n, d, kw):
    """First step's accelerations at WithinRel 1e-5 (rms 1e-7), positions
    after 3 steps at murb_tpu's 1e-3 (rms floor 1e-6,
    tests/test_parallel.py:33-39)."""
    a, b = _pair(tag, SCHEMES["galaxy"](n, 123), d, **kw)
    assert (a.mode, a.n_shards) == (b.mode, b.n_shards)
    a.compute_one_iteration()
    b.compute_one_iteration()
    _acc_close(a, b, 1e-5, 1e-7, f"{tag} {kw} step 1")
    for _ in range(2):
        a.compute_one_iteration()
        b.compute_one_iteration()
    _pos_close(a, b, 1e-3, 1e-6, f"{tag} {kw} step 3")


def test_blocks_lie_on_their_shards():
    b = create_engine("shard+ring", carry(SCHEMES["random"](512, 1)),
                      shards=4)
    assert len(b.blocks) == 4 and {x.npad for x in b.blocks} == {256}
    assert b.bodies.npad == 1024 and b.bodies.n == 512


def test_proxy_matches_murb_tpu():
    """shard+proxy picks and validates what murb_tpu's does (the same m, the
    measured error within 10 %) and lands on its trajectory at 1e-4."""
    a, b = _pair("shard+proxy", SCHEMES["galaxy"](1024, 7), 8)
    assert a.mode == b.mode == "proxy" and a.proxy_m == b.proxy_m
    assert b.validated_err == pytest.approx(a.validated_err, rel=0.1)
    for _ in range(3):
        a.compute_one_iteration()
        b.compute_one_iteration()
    _pos_close(a, b, 1e-4, 0.0, "shard proxy")
    h = b.proxy_health()
    assert h["ok"] and h["m"] == b.m == a.proxy_m


def test_proxy_heavy_body_off_shard_zero():
    """The heavy body's exact correction wherever it lives: the central
    mass swapped into the last populated block (murb_tpu's test, 2e-3)."""
    js = SCHEMES["galaxy"](1024, 3)
    j = js.n - 100
    fields = {}
    for k in FIELDS:
        v = getattr(js, k)
        fields[k] = v.at[0].set(v[j]).at[j].set(v[0])
    js = dataclasses.replace(js, **fields)
    a, b = _pair("shard+proxy", js, 8)
    assert b.mode == "proxy"
    for _ in range(2):
        a.compute_one_iteration()
        b.compute_one_iteration()
    _pos_close(a, b, 2e-3, 0.0, "heavy swap")


def test_wide_box_promotes_to_fmm():
    """The random box is too wide for one expansion: both packages promote
    shard+proxy to shard+fmm with the same (m, levels)."""
    a, b = _pair("shard+proxy", SCHEMES["random"](1000, 1), 4)
    assert a.mode == b.mode == "fmm" and b.tag == "shard+fmm"
    assert (a.fmm_m, a.fmm_levels) == (b.fmm_m, b.fmm_levels)
    assert (b.m, b.levels) == (b.fmm_m, b.fmm_levels)


def test_fmm_step_matches_murb_tpu():
    """The sharded hierarchy at a fixed geometry (m=6, L=2): the first
    step's accelerations against murb_tpu's shard+fmm at 1e-4 (the
    single-device equality tolerance of tests/test_parallel.py:139)."""
    a, b = _pair("shard+fmm", SCHEMES["random"](2048, 11), 8, m=6, levels=2)
    assert a.mode == b.mode == "fmm" and (b.fmm_m, b.fmm_levels) == (6, 2)
    a.compute_one_iteration()
    b.compute_one_iteration()
    _acc_close(a, b, 1e-4, 1e-6, "shard fmm")


@pytest.mark.slow
def test_fmm_heavy_body_off_shard_zero():
    """murb_tpu's slow test_shard_fmm_heavy_on_nonzero_shard: the 4x wide
    galaxy forces fmm, the central mass moved off shard 0 (2e-3)."""
    js = SCHEMES["galaxy"](1024, 3)
    js = dataclasses.replace(js, qx=js.qx * 4.0, qy=js.qy * 4.0,
                             qz=js.qz * 4.0)
    j = js.n - 100
    js = dataclasses.replace(js, **{k: getattr(js, k).at[0].set(
        getattr(js, k)[j]).at[j].set(getattr(js, k)[0]) for k in FIELDS})
    a, b = _pair("shard+proxy", js, 8, m=10, levels=2)
    assert b.mode == "fmm"
    for _ in range(2):
        a.compute_one_iteration()
        b.compute_one_iteration()
    _pos_close(a, b, 2e-3, 1e-6, "fmm heavy swap")


@pytest.mark.parametrize("frac", [-0.1, 0.0, 1.5])
def test_uneven_rejects_bad_fraction(frac):
    st = carry(SCHEMES["galaxy"](700, 123))
    with pytest.raises(ValueError, match="gpu_fraction"):
        create_engine("hetero", st, soft=SOFT, dt=DT, shards=4,
                      gpu_fraction=frac)


@pytest.mark.parametrize("alias,mode", [("mpi", "allgather"),
                                        ("hetero", "uneven")])
def test_aliases(alias, mode):
    """murb_tpu's test_mpi_alias / hetero: the alias builds the mode and
    matches murb_tpu's engine (1e-3 after 2 steps)."""
    a, b = _pair(alias, SCHEMES["galaxy"](600, 123), 4)
    assert b.mode == mode and b.tag == f"shard+{mode}"
    for _ in range(2):
        a.compute_one_iteration()
        b.compute_one_iteration()
    _pos_close(a, b, 1e-3, 1e-6, alias)


def test_run_equals_stepwise():
    st = carry(SCHEMES["random"](800, 3))
    a = create_engine("shard+ring", st, soft=SOFT, dt=DT, shards=4)
    b = create_engine("shard+ring", st, soft=SOFT, dt=DT, shards=4)
    for _ in range(4):
        a.compute_one_iteration()
    b.run(4)
    assert b._iteration == 4
    assert torch.equal(a.bodies.qx, b.bodies.qx)


def test_every_murb_tpu_tag_is_registered():
    from murb_tpu.models import available_implementations as javail
    from murb_tpu_torch.models import available_implementations as tavail

    assert NOT_YET_PORTED == ()
    assert {t: set(a) for t, a in tavail().items()} == \
        {t: set(a) for t, a in javail().items()}


@pytest.mark.parametrize("tag", ["shard+ring", "shard+uneven",
                                 "shard+proxy"])
def test_sharded_checkpoint_round_trip(tag, tmp_path):
    """save_sharded after 2 steps, load into a fresh engine, 2 more steps:
    bit for bit the 4 straight steps (one process, no process group)."""
    st = carry(SCHEMES["galaxy"](1000, 5))
    kw = dict(soft=SOFT, dt=DT, shards=4)
    a = create_engine(tag, st, **kw)
    a.run(2)
    a.save_sharded(str(tmp_path / "ck"))
    b = create_engine(tag, st, **kw)
    meta = b.load_sharded(str(tmp_path / "ck"))
    assert meta["iteration"] == 2 and meta["dt"] == DT
    assert meta["soft"] == SOFT and meta["n"] == 1000
    for x, y in zip(a.blocks, b.blocks):
        for k in FIELDS:
            assert torch.equal(getattr(x, k), getattr(y, k))
    a.run(2)
    b.run(2)
    assert b._iteration == 4
    assert torch.equal(a.bodies.qx, b.bodies.qx)
    wrong = create_engine(tag, st, soft=SOFT, dt=DT, shards=2)
    with pytest.raises(ValueError, match="shards"):
        wrong.load_sharded(str(tmp_path / "ck"))


@pytest.mark.parametrize("argv,mode,shards", [
    (["--im", "shard+ring", "--shards", "2"], "ring", 2),
    (["--im", "mpi", "--shards", "4"], "allgather", 4),
    (["--im", "hetero", "--shards", "3", "--gpu-fraction", "0.5"],
     "uneven", 3),
    (["--im", "shard+proxy", "--shards", "2"], "proxy", 2),
])
def test_cli_shard_flags(argv, mode, shards, capsys):
    res = cli.run(["-n", "2048", "-i", "2", "--nv", "--device", "cpu",
                   *argv])
    assert res.rc == 0, capsys.readouterr()
    e = res.engine
    assert isinstance(e, ShardedEngine) and e.mode == mode
    assert e.n_shards == shards and e._iteration == 2
    e.assert_finite()
    if mode == "uneven":
        assert e.gpu_fraction == 0.5
    assert "Entire simulation took" in capsys.readouterr().out


def test_cli_rejects_a_bad_fraction(capsys):
    rc = cli.main(["-n", "700", "-i", "1", "--nv", "--device", "cpu", "--im",
                   "hetero", "--shards", "2", "--gpu-fraction", "1.5"])
    assert rc == 1 and "gpu_fraction" in capsys.readouterr().out
