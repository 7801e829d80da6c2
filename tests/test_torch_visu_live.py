"""The port's live viewer server (murb_tpu_torch/visu/live.py): the checks
of tests/test_visu_live.py on the port -- the page, the binary frame
long-poll (including stride subsampling), the key-event edge triggering
the CLI loop consumes, the whole CLI loop on the CPU, and the factory
wiring -- over real HTTP on an ephemeral port.  No browser: the client
side is urllib.
"""
from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest

from murb_tpu_torch.core.init import make_bodies
from murb_tpu_torch.visu import create_visu, host_frame
from murb_tpu_torch.visu.live import (HEADER_BYTES, LiveSpheresVisu,
                                      decode_header)


@pytest.fixture()
def visu():
    v = LiveSpheresVisu(port=0, announce=False)
    yield v
    v.close()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read()


def _post_key(port, key):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/key",
        data=json.dumps({"key": key}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status


def test_serves_page_and_info(visu):
    status, body = _get(visu.port, "/")
    assert status == 200
    text = body.decode()
    assert "<html" in text and "MURBLIVE" in text
    # both reference renderer analogues are present in the page
    assert "drawElementsInstancedANGLE" in text      # instanced spheres
    assert "gl_PointCoord" in text                   # GS billboards
    assert "beatPulse" in text                       # 130-BPM strobe

    status, body = _get(visu.port, "/info")
    info = json.loads(body)
    assert info["frame"] == 0 and info["n"] == 0


def test_frame_roundtrip(visu):
    state = make_bodies(256, scheme="galaxy", seed=3, device="cpu")
    visu.refresh_display(state, time_s=7.5)

    status, body = _get(visu.port, "/frame?since=-1")
    assert status == 200
    head = decode_header(body)
    assert head["frame"] == 1
    assert head["n"] == 256 and head["stride"] == 1
    assert head["time"] == pytest.approx(7.5)

    d = host_frame(state)
    arrays = np.frombuffer(body[HEADER_BYTES:], np.float32).reshape(4, 256)
    np.testing.assert_allclose(arrays[0], np.asarray(d["qx"], np.float32))
    np.testing.assert_allclose(arrays[2], np.asarray(d["qz"], np.float32))
    # normalized speed channel spans [0, 1]
    assert arrays[3].min() >= 0.0 and arrays[3].max() <= 1.0 + 1e-6
    # bbox covers the (subsampled) points
    cx, cy, cz, hw = head["bbox"]
    assert np.abs(arrays[0] - cx).max() <= hw * (1 + 1e-5)

    # long-poll with current frame times out -> 204 (no new data)
    status, _ = _get(visu.port, "/frame?since=1&max=64&t=0.2")
    assert status == 204


def test_frame_stride_subsampling(visu):
    state = make_bodies(512, scheme="random", seed=1, device="cpu")
    visu.refresh_display(state)
    status, body = _get(visu.port, "/frame?since=-1&max=100")
    head = decode_header(body)
    assert head["stride"] == 6                       # ceil(512/100)
    assert head["n"] == len(range(0, 512, 6))
    arrays = np.frombuffer(body[HEADER_BYTES:], np.float32)
    assert arrays.size == 4 * head["n"]


def test_key_events_edge_triggered(visu):
    assert not visu.pressed_space_bar()
    assert _post_key(visu.port, "space") == 200
    assert _post_key(visu.port, "pageup") == 200
    assert visu.pressed_space_bar()
    assert not visu.pressed_space_bar()              # consumed
    assert visu.pressed_page_up()
    assert not visu.pressed_page_down()

    assert not visu.window_should_close()
    _post_key(visu.port, "close")
    assert visu.window_should_close()


def test_cli_live_viewer_end_to_end(tmp_path):
    """Full loop: murb CLI serving frames, viewer keys steering the run --
    space pause, PgUp doubling dt, close ending the simulation early."""
    import os
    import re
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from murb_tpu_torch.cli import main\n"
        "sys.exit(main(['-n', '512', '-i', '100000', '--im', 'cpu+naive',"
        " '--visu-live', '0', '--device', 'cpu']))\n" % repo
    )
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=repo)
    try:
        port = None
        deadline = time.time() + 60
        lines = []
        while time.time() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            m = re.search(r"http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "viewer URL never printed:\n" + "".join(lines)

        def info():
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/info", timeout=10) as r:
                return json.loads(r.read())

        def key(k):
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/key",
                data=json.dumps({"key": k}).encode(), method="POST"),
                timeout=10).read()

        deadline = time.time() + 60
        while info()["frame"] < 2 and time.time() < deadline:
            time.sleep(0.1)
        assert info()["frame"] >= 2          # frames are streaming

        key("space")                          # pause
        time.sleep(0.6)
        f0 = info()
        assert f0["paused"]
        time.sleep(0.5)
        assert info()["frame"] == f0["frame"]  # loop frozen
        key("pageup")
        key("space")                          # resume (dt key consumed next)
        deadline = time.time() + 30
        while info()["dt"] != 7200.0 and time.time() < deadline:
            time.sleep(0.1)
        assert info()["dt"] == 7200.0         # PgUp doubled the default dt

        key("close")
        out, _ = proc.communicate(timeout=60)
        assert "Simulation ended." in out
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_factory_selects_live(monkeypatch):
    from murb_tpu_torch.utils.args import MurbConfig

    cfg = MurbConfig(n_bodies=64, n_iterations=1, visu_live=0)
    v = create_visu(cfg)
    try:
        assert isinstance(v, LiveSpheresVisu)
    finally:
        v.close()
