"""The port's CLI: murb-compatible flags, banner, exit codes, and the
promise that murb_tpu_torch never imports JAX or murb_tpu."""
import os
import subprocess
import sys

import pytest
import torch

from murb_tpu.utils.perf import Perf as JPerf
from murb_tpu.utils.strdate import str_date as jstr_date
from murb_tpu_torch import cli
from murb_tpu_torch.utils.args import parse_args
from murb_tpu_torch.utils.perf import Perf
from murb_tpu_torch.utils.strdate import str_date

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code_or_args, **kw):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240, **kw)


def test_module_entry_runs_the_proxy_on_cpu():
    p = _python(["-m", "murb_tpu_torch", "-n", "2048", "-i", "3", "--im",
                 "tpu+proxy", "--nv", "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    assert "validated order           : proxy m=12" in p.stdout, p.stdout
    assert "Entire simulation took" in p.stdout


def test_port_never_imports_jax_or_murb_tpu():
    code = (
        "import sys\n"
        "import murb_tpu_torch\n"
        "from murb_tpu_torch import cli\n"
        "rc = cli.main(['-n', '600', '-i', '2', '--im', 'tpu+proxy',"
        " '--nv', '--device', 'cpu', '--scan'])\n"
        "assert rc == 0, rc\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'murb_tpu'"
        " or m.startswith('murb_tpu.'))\n"
        "print('IMPORTED', bad)\n")
    p = _python(["-c", code])
    assert p.returncode == 0, p.stderr
    assert "IMPORTED []" in p.stdout, p.stdout


def test_parse_reference_flags():
    cfg = parse_args(["-n", "3000", "-i", "50", "--im", "gpu+tile+full",
                      "-s", "random", "--dt", "1800", "--soft", "1e8",
                      "--nv", "--gf", "-v", "--tol", "1e-5", "--seed", "7"])
    assert (cfg.n_bodies, cfg.n_iterations) == (3000, 50)
    assert cfg.impl_tag == "gpu+tile+full" and cfg.scheme == "random"
    assert cfg.dt == 1800.0 and cfg.softening == 1e8 and cfg.tol == 1e-5
    assert not cfg.visu_enable and cfg.show_gflops and cfg.verbose
    assert cfg.device == "cuda" and cfg.seed == 7
    assert cfg.visu_out is None and cfg.visu_live is None
    assert cfg.profile is None and cfg.gs_enable and cfg.visu_color
    with pytest.raises(SystemExit):
        parse_args(["-n", "10", "-i", "1", "--soft", "0"])
    with pytest.raises(SystemExit):
        parse_args(["-i", "5"])


@pytest.mark.parametrize("argv", [
    ["--im", "no+such+tag"],
    ["--precision", "bf16"],
])
def test_unknown_or_unported_exits_1(argv, capsys):
    rc = cli.main(["-n", "300", "-i", "1", "--nv", "--device", "cpu",
                   *argv])
    assert rc == 1
    out = capsys.readouterr()
    assert ("not yet ported" in out.out + out.err
            or "does not exist" in out.out), out


@pytest.mark.parametrize("argv", [
    ["--ngs", "--nvc", "--ww", "320", "--wh", "240"],
    ["--visu-live", "0"],
    ["--visu-out", "{tmp}/frames"],
    ["--profile", "{tmp}/trace"],
    ["--cam-azim", "30", "--cam-elev", "45", "--visu-out", "{tmp}/frames"],
])
def test_viewer_and_profile_flags_run_on_the_cpu(argv, tmp_path, monkeypatch,
                                                 capsys):
    """The viewer flags and --profile run to the end on the CPU, each with
    its effect: the window flags reach the viewer's config, the live
    viewer serves, frames and the Chrome trace are written, the camera is
    the one asked for."""
    import json

    made, real = [], cli.create_visu

    def create_visu(cfg):
        made.append((cfg, real(cfg)))
        return made[-1][1]

    monkeypatch.setattr(cli, "create_visu", create_visu)
    argv = [a.format(tmp=tmp_path) for a in argv]
    res = cli.run(["-n", "300", "-i", "3", "--im", "cpu+naive", "--device",
                   "cpu", *argv])
    assert res.rc == 0 and res.engine._iteration == 3
    cfg, visu = made[0]
    out = capsys.readouterr().out
    if "--ngs" in argv:
        assert (cfg.gs_enable, cfg.visu_color, cfg.win_width,
                cfg.win_height) == (False, False, 320, 240)
    if "--visu-live" in argv:
        assert "Live viewer on http://127.0.0.1:" in out
        assert visu._frame == 3          # one frame before each iteration
    if "--visu-out" in argv:
        pytest.importorskip("matplotlib")
        assert sorted(os.listdir(tmp_path / "frames")) == [
            f"frame_{k:06d}.png" for k in range(3)]
    if "--cam-azim" in argv:
        assert (visu.azim, visu.elev) == (30.0, 45.0)
    if "--profile" in argv:
        assert f"Profiler trace written to {tmp_path}/trace" in out
        assert "Profiled device time: not measured" in out
        with open(tmp_path / "trace" / "trace.json") as f:
            assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("argv,out", [
    (["--im", "tpu+mxu"], "sweep blocks (i x j)      : 0 x 0 (kernel default)"),
    (["--im", "tpu+mxu", "--block-i", "64", "--block-j", "512",
      "--dump-traj", "{tmp}/t.bin"], "Trajectory written to {tmp}/t.bin"),
    (["--im", "cpu+optim", "--save-state", "{tmp}/s.npz"],
     "State checkpoint written to {tmp}/s.npz"),
])
def test_flags_ported_in_the_exact_slice_run(argv, out, tmp_path, capsys):
    """tpu+mxu, --dump-traj and --save-state run to the end (their
    results: tests/test_torch_{mxu,native_io,checkpoint}.py)."""
    argv = [a.format(tmp=tmp_path) for a in argv]
    res = cli.run(["-n", "300", "-i", "2", "--nv", "--device", "cpu", *argv])
    assert res.rc == 0 and res.engine._iteration == 2
    res.engine.assert_finite()
    assert out.format(tmp=tmp_path) in capsys.readouterr().out


@pytest.mark.parametrize("argv,attr,value", [
    (["--im", "tpu+proxy"], "adapt_every", 64),
    (["--im", "tpu+proxy", "--scan"], "adapt_every", 0),
    (["--im", "tpu+proxy", "--adapt-every", "0"], "adapt_every", 0),
    (["--im", "tpu+proxy", "--scan", "--adapt-every", "5"], "adapt_every",
     5),
    (["--im", "cpu+optim", "--chunk", "256"], "chunk", 256),
    (["--im", "tpu+mxu", "--block-i", "512", "--block-j", "64"], "block_i",
     512),
])
def test_engine_options_from_the_cli(argv, attr, value):
    """--adapt-every: 64 in the frame loop, off under --scan, an explicit
    value (0 included) wins; --chunk and --block-i reach the engine."""
    res = cli.run(["-n", "2048", "-i", "1", "--nv", "--device", "cpu",
                   *argv])
    assert res.rc == 0 and getattr(res.engine, attr) == value


def test_check_finite_stops_on_a_non_finite_state(monkeypatch):
    from murb_tpu_torch.core.init import init_random

    s = init_random(300, 1, device="cpu")
    s.vx[3] = float("inf")
    monkeypatch.setattr(cli, "make_bodies", lambda *a, **k: s)
    argv = ["-n", "300", "-i", "2", "--im", "cpu+optim", "--nv", "--device",
            "cpu"]
    assert cli.run(argv).rc == 0       # unguarded, the run goes on
    with pytest.raises(FloatingPointError, match="after iteration 1"):
        cli.run(argv + ["--check-finite"])


def test_block_flags_are_checked_before_a_run(capsys):
    rc = cli.main(["-n", "300", "-i", "1", "--im", "tpu+hybrid", "--nv",
                   "--device", "cpu", "--block-j", "100"])
    assert rc == 1
    assert "block_j=100 is not supported" in capsys.readouterr().out


def test_cuda_device_without_cuda_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["-n", "300", "-i", "1", "--im", "tpu+proxy", "--nv"])
    assert rc == 1
    assert "does not fall back to the CPU" in capsys.readouterr().err


def test_profile_step_needs_a_card_and_counts_only_device_rows(monkeypatch,
                                                              capsys):
    from torch.profiler import ProfilerActivity, profile

    from murb_tpu_torch.utils import profile_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_step.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    assert profile_step.device_rows(prof) == []


def test_frame_loop_scan_and_list(capsys):
    assert cli.main(["-n", "300", "-i", "3", "--im", "cpu+optim", "--nv",
                     "--gf", "-v", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Iteration n°   3" in out and "Gflop/s" in out
    res = cli.run(["-n", "300", "-i", "4", "--im", "tpu+hybrid", "--nv",
                   "--scan", "--device", "cpu", "--precision", "fp64"])
    assert res.rc == 0 and res.engine.passes == 3
    assert res.engine.bodies.dtype == torch.float64
    assert res.engine._iteration == 4 and res.fps > 0
    assert cli.main(["--list-impls"]) == 0
    out = capsys.readouterr().out
    assert "tpu+proxy  (aliases: fmm, barnes-hut)" in out


def test_exact_fallback_banner(capsys):
    res = cli.run(["-n", "256", "-i", "1", "--im", "tpu+proxy", "--nv",
                   "--device", "cpu"])
    assert res.rc == 0 and not res.engine.using_proxy
    assert "exact fallback" in capsys.readouterr().out


def test_utils_match_jax():
    for t in (0.0, 3600.0, 3600 * 24 * 2 + 3600 * 3 + 60 * 4 + 5.25):
        assert str_date(t) == jstr_date(t)
    for us in (1.0e6, 2.5e3):
        p, j = Perf(elapsed_us=us), JPerf(elapsed_us=us)
        assert p.get_gflops(1024 ** 3) == j.get_gflops(1024 ** 3)
        assert p.get_fps(10) == j.get_fps(10)
        assert p.get_elapsed_time() == j.get_elapsed_time()
