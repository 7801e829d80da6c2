"""The port's copies of the scripts that import murb_tpu
(tests/test_scripts.py's cases): energy collection, with the card's power
read through a stand-in ``nvidia-smi`` first on PATH and the workload
stubbed; trajectory playback through the live viewer; rendering."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env=None, **kw):
    env = dict(os.environ if env is None else env)
    env.setdefault("MPLBACKEND", "Agg")
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300, **kw)


def _fake_smi(tmp_path, body: str):
    """A stand-in nvidia-smi that prints ``body`` (one line a device)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    smi = bin_dir / "nvidia-smi"
    smi.write_text("#!/bin/sh\n" + body)
    smi.chmod(0o755)
    return str(bin_dir)


def _workload(seconds: float) -> str:
    """A stubbed workload: prints the CLI's frame-loop lines around a
    sleep."""
    code = ("import time; print('Simulation started...', flush=True); "
            f"time.sleep({seconds}); print('Simulation ended.', flush=True)")
    return f'{sys.executable} -c "{code}"'


def test_energy_collection_reads_nvidia_smi(tmp_path):
    """Under --source auto the card's power comes from nvidia-smi, one
    channel a device, in the CSV schema energy_report.py reads; the run
    and the frame-loop windows are reported, J a step at full precision."""
    out = tmp_path / "power.csv"
    env = dict(os.environ, MURB_ENERGY_CMD=_workload(1.2),
               PATH=_fake_smi(tmp_path, 'echo "250.5"\necho "100.25"\n')
               + os.pathsep + os.environ["PATH"])
    r = _run(["scripts/torch_measure_energy.py", "--interval", "0.1",
              "--out", str(out), "--", "-n", "64", "-i", "10"], env=env)
    assert r.returncode == 0, r.stderr
    assert "power source: nvsmi" in r.stdout
    lines = out.read_text().strip().splitlines()
    assert lines[0] == "timestamp_s,channel,watts"
    rows = [l.split(",") for l in lines[1:]]
    assert {ch for _, ch, _ in rows} == {"gpu0", "gpu1"}
    assert {float(w) for _, ch, w in rows if ch == "gpu0"} == {250.5}
    assert "# run window" in r.stdout and "# loop window" in r.stdout
    assert "J/frame" in r.stdout and "10 frames" in r.stdout
    loop = [l for l in r.stdout.splitlines() if l.startswith("loop all")]
    assert len(loop) == 1 and "mean W 350.75" in loop[0], r.stdout
    window = float(loop[0].split("window ")[1].split(" s")[0])
    assert 1.1 < window < 2.5
    j_step = float(loop[0].rsplit("J/step ", 1)[1])
    assert j_step == pytest.approx(350.75 * window / 10, rel=1e-9)


def test_energy_tdp_bound_and_failing_smi(tmp_path):
    """--source tdp is the labelled upper bound (--tdp-watts times the
    card count, at least 1); --source nvsmi with a failing nvidia-smi is
    an error, never the bound."""
    out = tmp_path / "power.csv"
    env = dict(os.environ, MURB_ENERGY_CMD=_workload(0.6))
    r = _run(["scripts/torch_measure_energy.py", "--source", "tdp",
              "--tdp-watts", "123", "--interval", "0.1", "--out", str(out),
              "--", "-n", "64", "-i", "10"], env=env)
    assert r.returncode == 0, r.stderr
    assert "power source: tdp" in r.stdout and "UPPER BOUND" in r.stdout
    t, ch, w = out.read_text().strip().splitlines()[1].split(",")
    assert ch == "tdp_bound_x1" and float(w) == 123.0
    env["PATH"] = (_fake_smi(tmp_path, 'echo "no device" >&2\nexit 9\n')
                   + os.pathsep + os.environ["PATH"])
    r = _run(["scripts/torch_measure_energy.py", "--source", "nvsmi",
              "--out", str(out), "--", "-n", "64", "-i", "10"], env=env)
    assert r.returncode != 0
    assert "nvidia-smi exited 9" in r.stderr


def _trajectory(path, frames=4, n=32):
    from murb_tpu_torch.io import TrajectoryWriter

    w = TrajectoryWriter(str(path), n)
    rng = np.random.default_rng(0)
    for f in range(frames):
        q = rng.normal(size=(3, n)).astype(np.float32)
        w.append(f * 5, q[0], q[1], q[2])
    w.close()


def test_serve_trajectory_playback(tmp_path):
    """Recorded MURBTRAJ frames replay through the port's live viewer."""
    path = tmp_path / "run.traj"
    _trajectory(path)
    r = _run(["scripts/torch_serve_trajectory.py", str(path), "--port", "0",
              "--fps", "50"])
    assert r.returncode == 0, r.stderr
    assert "4 frames x 32 bodies" in r.stdout
    assert "played 4 frames" in r.stdout


def test_render_trajectory(tmp_path):
    """A bf16 run's --dump-traj file renders to one PNG a frame."""
    pytest.importorskip("matplotlib")
    path = tmp_path / "run.traj"
    r = _run(["-m", "murb_tpu_torch", "-n", "256", "-i", "6", "--im",
              "cpu+naive", "--nv", "--device", "cpu", "--precision", "bf16",
              "--dump-traj", str(path), "--dump-every", "2"])
    assert r.returncode == 0, r.stderr
    r = _run(["scripts/torch_render_trajectory.py", str(path),
              str(tmp_path / "frames")])
    assert r.returncode == 0, r.stderr
    assert "wrote 4 frames" in r.stdout
    assert sorted(os.listdir(tmp_path / "frames")) == [
        f"frame_{k:06d}.png" for k in range(4)]
