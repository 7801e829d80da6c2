"""A configuration, a cell, a traffic mix and a per-layer metric are added
as files and entries alone: the harness finds, loads and checks them by
name with no file of it edited."""
import json
import shutil

import pytest

from nbody_bench import harness

from conftest import cpu_run

DUMMY_CONFIG = {"name": "galaxy_tiny", "scheme": "galaxy", "n": 1024,
                "soft": 2.0e8, "dt": 3600.0, "G": 6.67384e-11,
                "precision": "float32", "tol": 1e-4,
                "reference": "softened_euler"}
DUMMY_CELL = {"name": "tiny.exact", "config": "galaxy_tiny",
              "traffic": "two_steps", "tag": "tpu+tile", "engine": {},
              "precision": "float32", "warmup_frames": 2, "span_frames": 4,
              "profiled_frames": 2, "check": {"steps": 2, "stratum": 1},
              "limits": {"force_err": 1e-4, "update_ulp": 256}}
DUMMY_TRAFFIC = {"name": "two_steps", "clients": 1, "steps_per_frame": 2,
                 "readback": ["qx", "qy", "qz", "vx"]}
READER = '''"""Frames the run's window held (a dummy reader)."""


def read(run):
    return float(run.frames)
'''


@pytest.fixture
def root(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "nbody_bench", tmp_path / "nbody_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    data = tmp_path / "nbody_bench"
    for kind, obj in (("configs", DUMMY_CONFIG), ("workloads", DUMMY_CELL),
                      ("traffic", DUMMY_TRAFFIC)):
        (data / kind / f"{obj['name']}.json").write_text(json.dumps(obj))
    (data / "metrics" / "frames_held.py").write_text(READER)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "galaxy_tiny", "source": "test",
                             "file": "nbody_bench/configs/galaxy_tiny.json",
                             "reduced": ["n"], "why": "a test"})
    bench["workloads"].append({"name": "tiny.exact", "config": "galaxy_tiny",
                               "traffic": "two_steps", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "frames_held", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "frame loop and host I/O",
                               "moves": "steps_per_s",
                               "workloads": ["tiny.exact"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_files_alone_add_a_cell(root):
    spec = harness.Spec("tiny.exact", root)
    assert spec.config["n"] == 1024 and spec.traffic["steps_per_frame"] == 2
    assert [m["name"] for m in spec.per_layer] == [
        "readback_ms", "dispatch_ms", "launches_per_step",
        "device_idle_share", "frames_held"]
    res, view = cpu_run("tiny.exact", root=root, n=1024, seconds=0.2)
    assert res["correct"] and set(res["metrics"]) == {
        "steps_per_s", "frame_ms_p95", "setup_s"}
    assert res["metrics"]["steps_per_s"]["value"] == pytest.approx(
        2 * view.frames / view.window_s)
    res, _ = cpu_run("tiny.exact", root=root, n=1024, traced=True)
    assert res["correct"]
    assert res["metrics"]["frames_held"] == {"value": 4.0,
                                             "unit": "frames"}
    # the cells already there do not report the new metric
    res, _ = cpu_run("galaxy200k.exact", root=root, traced=True)
    assert "frames_held" not in res["metrics"]


def test_the_copy_runs_its_own_files(root):
    (root / "nbody_bench" / "metrics" / "frames_held.py").write_text(
        "def read(run):\n    return 7.0\n")
    res, _ = cpu_run("tiny.exact", root=root, n=1024, traced=True)
    assert res["metrics"]["frames_held"]["value"] == 7.0
