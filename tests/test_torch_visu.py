"""The port's offline visualization (murb_tpu_torch.visu): the checks of
tests/test_visu.py on the port, and its palette, projection and live frame
encoding bit for bit against murb_tpu's on the same numpy arrays."""
import os

import numpy as np
import pytest

from murb_tpu.visu import cyberpunk_colors as jcolors
from murb_tpu.visu import project as jproject
from murb_tpu.visu.live import encode_frame as jencode
from murb_tpu_torch.core.init import make_bodies
from murb_tpu_torch.visu import (OfflineSpheresVisu, SpheresVisuNo,
                                 create_visu, cyberpunk_colors, host_frame,
                                 project)
from murb_tpu_torch.visu.live import encode_frame


def test_cyberpunk_palette_parity():
    """Vectorized palette matches the reference's scalar two-pass logic
    (ref: OGLSpheresVisuGS.cpp:86-172) on hand-computed cases."""
    vx = np.array([0.0, 5.0, 10.0])
    vy = np.zeros(3)
    vz = np.zeros(3)
    c = cyberpunk_colors(vx, vy, vz, time_s=0.0)
    np.testing.assert_allclose(c[0], [0.0, 0.02, 0.1], atol=1e-6)
    beat = ((np.sin(0.0) + 1) / 2) ** 8
    np.testing.assert_allclose(c[2], [min(0.8 + beat * 0.2, 1.0), 1.0, 1.0],
                               atol=1e-6)
    assert np.all(c >= 0.0) and np.all(c <= 1.0)


def test_projection():
    qx, qy, qz = np.array([1.0]), np.array([2.0]), np.array([3.0])
    u, v = project(qx, qy, qz, 0.0, 90.0)
    np.testing.assert_allclose([u[0], v[0]], [1.0, 2.0], atol=1e-6)
    u, v = project(qx, qy, qz, 0.0, 0.0)
    np.testing.assert_allclose(v[0], -3.0, atol=1e-6)
    u, v = project(qx, qy, qz, 90.0, 90.0)
    np.testing.assert_allclose(u[0], 2.0, atol=1e-6)


def test_offline_renderer_writes_frames(tmp_path):
    pytest.importorskip("matplotlib")
    visu = OfflineSpheresVisu(str(tmp_path), width=200, height=150,
                              elev=45.0)
    state = make_bodies(128, "galaxy", 1, device="cpu")
    visu.refresh_display(state, time_s=0.0)
    visu.refresh_display(state, time_s=1.0)
    files = sorted(os.listdir(tmp_path))
    assert files == ["frame_000000.png", "frame_000001.png"]


def test_create_visu_headless_default():
    from murb_tpu_torch.utils.args import MurbConfig

    cfg = MurbConfig(n_bodies=10, n_iterations=1, visu_enable=False)
    assert isinstance(create_visu(cfg), SpheresVisuNo)


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_pieces_match_murb_tpu_bit_for_bit(seed):
    """cyberpunk_colors, project and encode_frame of the port give
    murb_tpu's bytes on the same host frame (float32 and float64)."""
    d = host_frame(make_bodies(300, "galaxy", seed, device="cpu"))
    assert all(a.shape == (300,) for a in d.values())
    for dtype in (np.float32, np.float64):
        v = [d[k].astype(dtype) for k in ("vx", "vy", "vz")]
        q = [d[k].astype(dtype) for k in ("qx", "qy", "qz")]
        assert np.array_equal(cyberpunk_colors(*v, time_s=0.37),
                              jcolors(*v, time_s=0.37))
        for azim, elev in ((0.0, 90.0), (30.0, 20.0)):
            for a, b in zip(project(*q, azim, elev),
                            jproject(*q, azim, elev)):
                assert np.array_equal(a, b)
    args = (5, 300, 7.5, 3600.0, 1, 2, (1.0, 2.0, 3.0, 4.0),
            tuple(d[k] for k in ("qx", "qy", "qz", "vx")))
    assert encode_frame(*args) == jencode(*args)
