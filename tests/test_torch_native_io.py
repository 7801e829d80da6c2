"""The port's native runtime (murb_tpu_torch/native.py and its copy of
murbnative.cpp) and trajectory files (murb_tpu_torch/io.py) against
murb_tpu's: the ``.tab`` parser, the metrics CSV text, and MURBTRAJ files
byte for byte.  Each runs with the C++ library (g++ is in this image) and
with the pure-python fallback."""
import numpy as np
import pytest
import torch

import murb_tpu.native as jnative
from murb_tpu.core.history import SimulationHistory as JHistory
from murb_tpu.io import TrajectoryWriter as JWriter
from murb_tpu_torch import cli
from murb_tpu_torch import native
from murb_tpu_torch.core.history import SimulationHistory
from murb_tpu_torch.io import TrajectoryWriter, read_trajectory
from murb_tpu_torch.ops.cuda import BUILD_DIR

torch.set_num_threads(2)
BACKENDS = pytest.mark.parametrize("fallback", [False, True],
                                   ids=["native", "fallback"])


def _backend(monkeypatch, fallback):
    if fallback:
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr("murb_tpu_torch.io.get_lib", lambda: None)


def test_native_builds_into_the_build_directory():
    """g++ is in this image: the library builds, into build/murb_tpu_torch/
    (never beside murb_tpu's source)."""
    assert native.get_lib() is not None
    lib = native.library_path()
    assert lib.exists() and lib.parent == BUILD_DIR
    assert lib.name.startswith("libmurbnative_")


def test_no_native_env_takes_the_fallback(monkeypatch, tmp_path):
    monkeypatch.setenv("MURB_NO_NATIVE", "1")
    native.get_lib.cache_clear()
    try:
        assert native.get_lib() is None
        h = SimulationHistory(2)
        h.save_metrics_to_csv(str(tmp_path / "m.csv"))
        assert (tmp_path / "m.csv").read_text().startswith("iteration,")
        assert native.now_us() > 0
    finally:
        monkeypatch.delenv("MURB_NO_NATIVE")
        native.get_lib.cache_clear()
    assert native.get_lib() is not None


@BACKENDS
def test_parse_tab_matches_numpy_and_murb_tpu(tmp_path, monkeypatch,
                                              fallback):
    rows = np.random.default_rng(0).normal(size=(500, 7)) * 1e5
    path = tmp_path / "t.tab"
    np.savetxt(path, rows, fmt="%.10g")
    _backend(monkeypatch, fallback)
    got = native.parse_tab(str(path))
    np.testing.assert_array_equal(got, np.loadtxt(path))
    np.testing.assert_array_equal(got, jnative.parse_tab(str(path)))


def test_parse_tab_blank_lines_and_errors(tmp_path):
    path = tmp_path / "t.tab"
    path.write_text("1 2 3 4 5 6 7\n\n   \n8 9 10 11 12 13 14\n")
    got = native.parse_tab(str(path))
    assert got.shape == (2, 7) and got[1, 0] == 8.0
    bad = tmp_path / "bad.tab"
    bad.write_text("1 2 3\n")
    with pytest.raises(ValueError, match="malformed row 0"):
        native.parse_tab(str(bad))
    with pytest.raises(FileNotFoundError):
        native.parse_tab(str(tmp_path / "missing.tab"))


@BACKENDS
def test_csv_text_matches_murb_tpu(tmp_path, monkeypatch, fallback):
    hists = SimulationHistory(3), JHistory(3)
    for h in hists:
        for i in range(3):
            h.set_energy_at(i, -1.23456789e40 * (i + 1) / 3.0)
            h.set_ang_momentum_at(i, 9.87e45 / 7.0)
            h.set_density_center_at(i, [i / 3.0, -i * 2.0, 3.5e-300])
    _backend(monkeypatch, fallback)
    hists[0].save_metrics_to_csv(str(tmp_path / "t.csv"))
    hists[1].save_metrics_to_csv(str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


@BACKENDS
def test_trajectory_roundtrip_and_bytes_match_murb_tpu(tmp_path, monkeypatch,
                                                       fallback):
    n = 100
    rng = np.random.default_rng(1)
    frames = [rng.normal(size=(3, n)).astype(np.float32) for _ in range(4)]
    jw = JWriter(str(tmp_path / "j.traj"), n)
    _backend(monkeypatch, fallback)
    tw = TrajectoryWriter(str(tmp_path / "t.traj"), n)
    assert (tw._handle is None) == fallback
    for w in (jw, tw):
        for k, f in enumerate(frames):
            w.append(k * 10, f[0], f[1], f[2])
        assert w.close() == 0
    assert (tmp_path / "t.traj").read_bytes() == \
        (tmp_path / "j.traj").read_bytes()
    idx, pos = read_trajectory(str(tmp_path / "t.traj"))
    np.testing.assert_array_equal(idx, [0, 10, 20, 30])
    assert pos.shape == (4, n, 3)
    np.testing.assert_array_equal(pos[2][:, 1], frames[2][1])


@BACKENDS
def test_trajectory_short_frame_rejected(tmp_path, monkeypatch, fallback):
    """A frame shorter than n_bodies raises instead of corrupting the
    stream (native: a copy past the buffer; fallback: a broken stride)."""
    _backend(monkeypatch, fallback)
    path = str(tmp_path / "short.traj")
    w = TrajectoryWriter(path, 100)
    full = np.zeros(100, np.float32)
    with pytest.raises(ValueError, match="elements"):
        w.append(0, np.zeros(50, np.float32), full, full)
    w.append(0, full, full, full)  # the writer is still usable
    assert w.close() == 0
    idx, pos = read_trajectory(path)
    assert list(idx) == [0] and pos.shape == (1, 100, 3)


def test_read_trajectory_refuses_other_files(tmp_path):
    path = tmp_path / "x.traj"
    path.write_bytes(b"NOTATRAJ" + bytes(12))
    with pytest.raises(ValueError, match="not a MURBTRAJ"):
        read_trajectory(str(path))


def test_now_us_monotonicish():
    a = native.now_us()
    assert native.now_us() >= a


@pytest.mark.parametrize("extra,frames", [
    ([], [0, 2, 4]),
    (["--scan"], [0, 2, 4]),
    (["-i", "6", "--ite-chunk", "4"], [0, 2, 4, 6]),
])
def test_cli_dump_traj(tmp_path, capsys, extra, frames):
    """Frame 0 (the initial conditions) and every --dump-every-th; neither
    --scan's segments nor --ite-chunk skip a record point; the last frame
    is the final state."""
    path = str(tmp_path / "run.traj")
    res = cli.run(["-n", "300", "-i", "4", "--im", "cpu+optim", "--nv",
                   "--device", "cpu", "--dump-traj", path, "--dump-every",
                   "2", *extra])
    assert res.rc == 0 and "Trajectory written" in capsys.readouterr().out
    idx, pos = read_trajectory(path)
    assert list(idx) == frames and pos.shape == (len(frames), 300, 3)
    fin = res.engine.bodies.unpadded()
    np.testing.assert_array_equal(pos[-1][:, 2], fin["qz"])


def test_cli_dump_traj_matches_murb_tpu_bytes(tmp_path, monkeypatch):
    """The same run in both packages writes the same header and frame
    layout; frame 0 (the shared initial state) byte for byte."""
    from murb_tpu import cli as jcli
    from murb_tpu.core import init as jinit
    from murb_tpu_torch.core.state import FIELDS, BodyState

    js = jinit.init_random(300, 4)
    ts = BodyState.from_numpy({k: np.asarray(getattr(js, k))
                               for k in FIELDS}, js.n, js.padding, "cpu")
    monkeypatch.setattr(jcli, "make_bodies", lambda *a, **k: js)
    monkeypatch.setattr(cli, "make_bodies", lambda *a, **k: ts)
    argv = ["-n", "300", "-i", "2", "--im", "cpu+naive", "--nv"]
    assert jcli.main([*argv, "--dump-traj", str(tmp_path / "j.traj")]) == 0
    assert cli.main([*argv, "--dump-traj", str(tmp_path / "t.traj"),
                     "--device", "cpu"]) == 0
    j, t = ((tmp_path / f).read_bytes() for f in ("j.traj", "t.traj"))
    frame = 8 + 3 * 300 * 4
    assert len(t) == len(j) == 20 + 3 * frame
    assert t[:20 + frame] == j[:20 + frame]
    _, pj = read_trajectory(str(tmp_path / "j.traj"))
    _, pt = read_trajectory(str(tmp_path / "t.traj"))
    np.testing.assert_allclose(pt, pj, rtol=1e-5)
