"""The port's checkpoint and resume (core/checkpoint.py, the CLI's
--save-state / --save-every / --load-state), murb_tpu's
tests/test_checkpoint.py cases, and checkpoints carried across the two
packages: a file either package writes loads in the other bit for bit."""
import re

import numpy as np
import pytest
import torch

from murb_tpu.core import checkpoint as jck
from murb_tpu.core import init as jinit
from murb_tpu_torch import cli
from murb_tpu_torch.core import checkpoint as tck
from murb_tpu_torch.core.init import init_galaxy, init_random
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0


def test_roundtrip(tmp_path):
    s = init_galaxy(300, 5, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    tck.save_state(path, s, iteration=7, dt=1800.0, soft=1e8,
                   extra={"note": np.array([1, 2, 3])})
    s2, meta = tck.load_state(path, device="cpu")
    assert (s2.n, s2.padding, s2.dtype) == (s.n, s.padding, s.dtype)
    for k in FIELDS:
        torch.testing.assert_close(getattr(s2, k), getattr(s, k), rtol=0,
                                   atol=0)
    assert meta["iteration"] == 7
    assert meta["dt"] == 1800.0 and meta["soft"] == 1e8
    np.testing.assert_array_equal(meta["note"], [1, 2, 3])


def test_load_state_defaults_to_the_card(tmp_path, monkeypatch):
    path = str(tmp_path / "ckpt.npz")
    tck.save_state(path, init_random(100, 1, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        tck.load_state(path)


def test_future_version_rejected(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    tck.save_state(path, init_random(100, 1, device="cpu"))
    data = dict(np.load(path))
    data["__version__"] = np.int64(99)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="format version"):
        tck.load_state(path, device="cpu")


def test_resume_continues_trajectory(tmp_path):
    """run(4) == run(2) + checkpoint + resume + run(2), bit for bit."""
    bodies = init_random(512, 9, device="cpu")
    a = create_engine("xla+chunked", bodies, soft=SOFT, dt=DT)
    a.run(4)
    b = create_engine("xla+chunked", bodies, soft=SOFT, dt=DT)
    b.run(2)
    path = str(tmp_path / "mid.npz")
    tck.save_state(path, b.bodies, iteration=2, dt=DT, soft=SOFT)
    restored, meta = tck.load_state(path, device="cpu")
    c = create_engine("xla+chunked", restored, soft=meta["soft"],
                      dt=meta["dt"])
    c.run(2)
    for k in FIELDS:
        torch.testing.assert_close(getattr(c.bodies, k),
                                   getattr(a.bodies, k), rtol=0, atol=0)


@pytest.mark.parametrize("writer", ["murb_tpu", "murb_tpu_torch"])
def test_checkpoints_load_across_packages(writer, tmp_path):
    """One state, written by one package, read by the other: the eight
    padded arrays bit for bit, n, padding and the metadata alike."""
    js = jinit.init_galaxy(300, 5)
    path = str(tmp_path / f"{writer}.npz")
    if writer == "murb_tpu":
        jck.save_state(path, js, iteration=11, dt=900.0, soft=3e8)
        got, meta = tck.load_state(path, device="cpu")
        arrays = {k: getattr(got, k).numpy() for k in FIELDS}
    else:
        ts = BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                   for k in FIELDS}, js.n, js.padding, "cpu")
        tck.save_state(path, ts, iteration=11, dt=900.0, soft=3e8)
        got, meta = jck.load_state(path)
        arrays = {k: np.asarray(getattr(got, k)) for k in FIELDS}
    assert (got.n, got.padding) == (js.n, js.padding)
    assert (meta["iteration"], meta["dt"], meta["soft"]) == (11, 900.0, 3e8)
    for k in FIELDS:
        ref = np.asarray(getattr(js, k))
        assert arrays[k].dtype == ref.dtype
        np.testing.assert_array_equal(arrays[k], ref, err_msg=k)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            [*FIELDS, "__version__", "n", "padding", "iteration", "dt",
             "soft"])


def test_cli_save_and_load(tmp_path, capsys):
    path = str(tmp_path / "cli.npz")
    assert cli.main(["-n", "300", "-i", "2", "--im", "cpu+optim", "--nv",
                     "--device", "cpu", "--save-state", path]) == 0
    rc = cli.main(["-n", "300", "-i", "1", "--im", "cpu+optim", "--nv",
                   "--device", "cpu", "--load-state", path])
    out = capsys.readouterr().out
    assert rc == 0 and "Resumed state from" in out


def test_cli_resume_carries_physics_and_iteration(tmp_path, capsys):
    """--load-state takes dt and the softening from the checkpoint unless
    given again, and a later --save-state carries the cumulative
    iteration count."""
    base = ["-n", "300", "--im", "cpu+optim", "--nv", "--device", "cpu"]
    p1 = str(tmp_path / "c1.npz")
    assert cli.main([*base, "-i", "2", "--dt", "1800", "--soft", "1e8",
                     "--save-state", p1]) == 0
    capsys.readouterr()
    p2 = str(tmp_path / "c2.npz")
    assert cli.main([*base, "-i", "3", "--load-state", p1, "--save-state",
                     p2]) == 0
    out = capsys.readouterr().out
    assert "dt=1800" in out and "soft=1e+08" in out
    _, meta = tck.load_state(p2, device="cpu")
    assert meta["iteration"] == 5            # 2 saved + 3 run
    assert meta["dt"] == 1800.0 and meta["soft"] == 1e8
    # an explicit flag still wins over the checkpoint's value
    assert cli.main([*base, "-i", "1", "--load-state", p1, "--dt",
                     "900"]) == 0
    out = capsys.readouterr().out
    assert "dt=900" in out and "soft=1e+08" in out


def test_cli_resume_matches_the_straight_run(tmp_path):
    """tpu+mxu: 3 steps, save, load, 3 more against 6 straight, bit for
    bit (the same steps on the same state), and the resumed file of the
    port loads in murb_tpu at the cumulative iteration."""
    base = ["-n", "600", "--im", "tpu+mxu", "--nv", "--device", "cpu",
            "--scan"]
    p = str(tmp_path / "half.npz")
    assert cli.run([*base, "-i", "3", "--save-state", p]).rc == 0
    resumed = cli.run([*base, "-i", "3", "--load-state", p, "--save-state",
                       str(tmp_path / "end.npz")])
    straight = cli.run([*base, "-i", "6"])
    for k in FIELDS:
        torch.testing.assert_close(getattr(resumed.engine.bodies, k),
                                   getattr(straight.engine.bodies, k),
                                   rtol=0, atol=0)
    js, meta = jck.load_state(str(tmp_path / "end.npz"))
    assert meta["iteration"] == 6
    np.testing.assert_array_equal(np.asarray(js.qx)[:600],
                                  straight.engine.bodies.unpadded()["qx"])


def test_async_checkpoint_writer(tmp_path):
    """Write-behind periodic checkpointing: the file resumes exactly, the
    write is atomic (no .tmp left), and a busy writer skips."""
    s = init_random(256, 3, device="cpu")
    path = str(tmp_path / "run.npz")
    w = tck.AsyncCheckpointWriter(path)
    assert w.save(s, iteration=7, dt=1800.0, soft=1e8)
    w.flush()
    assert w.written == 1 and not (tmp_path / "run.npz.tmp").exists()
    restored, meta = tck.load_state(path, device="cpu")
    assert meta["iteration"] == 7 and meta["dt"] == 1800.0
    torch.testing.assert_close(restored.qx, s.qx, rtol=0, atol=0)
    w._thread = type("Busy", (), {"is_alive": lambda self: True})()
    assert not w.save(s, iteration=8, dt=1800.0, soft=1e8)
    assert w.skipped == 1


def test_cli_save_every_periodic(tmp_path, capsys):
    """--save-every K writes a resumable checkpoint mid-run and the final
    synchronous save still lands; --save-every without --save-state is
    refused."""
    path = str(tmp_path / "p.npz")
    assert cli.main(["-n", "300", "-i", "6", "--im", "cpu+optim", "--nv",
                     "--device", "cpu", "--save-state", path,
                     "--save-every", "2"]) == 0
    done = re.search(r"\((\d+) periodic(?:, (\d+) skipped while busy)?\)",
                     capsys.readouterr().out)
    assert int(done[1]) + int(done[2] or 0) == 3     # at 2, 4 and 6
    _, meta = tck.load_state(path, device="cpu")
    assert meta["iteration"] == 6  # the final save wins
    assert cli.main(["-n", "300", "-i", "2", "--im", "cpu+optim", "--nv",
                     "--device", "cpu", "--save-every", "2"]) == 1
    assert "--save-every requires --save-state" in capsys.readouterr().err
