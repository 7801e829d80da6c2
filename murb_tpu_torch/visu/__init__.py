"""Visualization: headless interface + offline frame renderer.

Port of ``murb_tpu/visu/__init__.py`` (the reference's layer, ref:
src/common/ogl/).  A card host has no OpenGL context, so the design is
headless-first:

  * ``SpheresVisu``    -- the abstract frame interface
    (ref: src/common/ogl/SpheresVisu.hpp:4-15)
  * ``SpheresVisuNo``  -- no-op used with ``--nv`` / headless builds
    (ref: src/common/ogl/SpheresVisuNo.cpp:10-23)
  * ``OfflineSpheresVisu`` -- renders PNG frames with the geometry-shader
    renderer's velocity-magnitude "cyberpunk" palette and 130-BPM beat-pulse
    strobe (ref: src/common/ogl/OGLSpheresVisuGS.cpp:86-172), via matplotlib
    (optional dependency, gated).  Never on the hot path: it copies the
    state to the host at frame boundaries only, once a frame
    (``host_frame``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

_FRAME_FIELDS = ("qx", "qy", "qz", "vx", "vy", "vz")


def host_frame(state) -> dict[str, np.ndarray]:
    """Positions and velocities of the first ``n`` bodies of a
    ``BodyState`` on the host, in one device-to-host copy."""
    rows = torch.stack([getattr(state, k) for k in _FRAME_FIELDS])
    host = rows[:, : state.n].cpu().numpy()
    return dict(zip(_FRAME_FIELDS, host))


class SpheresVisu:
    """Abstract frame interface (ref: SpheresVisu.hpp:4-15)."""

    def refresh_display(self, state=None, time_s: float | None = None) -> None:
        raise NotImplementedError

    def window_should_close(self) -> bool:
        return False

    def pressed_space_bar(self) -> bool:
        return False

    def pressed_page_up(self) -> bool:
        return False

    def pressed_page_down(self) -> bool:
        return False


class SpheresVisuNo(SpheresVisu):
    """Headless no-op visualizer (ref: SpheresVisuNo.cpp:10-23)."""

    def refresh_display(self, state=None, time_s: float | None = None) -> None:
        pass


def cyberpunk_colors(vx, vy, vz, time_s: float = 0.0, bpm: float = 130.0):
    """Velocity-magnitude palette with beat-pulse strobe, vectorized parity
    with the reference's two-pass loop (ref: OGLSpheresVisuGS.cpp:86-172)."""
    norm = vx * vx + vy * vy + vz * vz
    lo, hi = float(np.min(norm)), float(np.max(norm))
    t = (norm - lo) / (hi - lo + 1e-6)

    freq = bpm / 60.0
    beat_phase = time_s * freq * 2.0 * 3.14159
    beat_pulse = ((np.sin(beat_phase) + 1.0) / 2.0) ** 8

    r = np.zeros_like(t)
    g = np.full_like(t, 0.02)
    b = np.full_like(t, 0.1)

    fast = t > 0.1
    r = np.where(fast, r + t * 0.1, r)
    g = np.where(fast, g + t * 0.9, g)
    b = np.where(fast, b + t * 1.5, b)

    strobe = t > 0.25
    flash = beat_pulse * 0.8
    r = np.where(strobe, r + flash, r)
    g = np.where(strobe, g + flash, g)
    b = np.where(strobe, b + flash, b)

    hyper = t > 0.8
    r = np.where(hyper, 0.8 + beat_pulse * 0.2, r)
    g = np.where(hyper, 1.0, g)
    b = np.where(hyper, 1.0, b)

    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def project(qx, qy, qz, azim_deg: float = 0.0, elev_deg: float = 90.0):
    """Orthographic camera projection -> (u, v) screen coordinates.

    The analogue of the reference's view matrix (``OGLControl``,
    ref: src/common/ogl/OGLControl.hpp:11-48) for the offline renderer:
    rotate by azimuth about z, then tilt by elevation; elev=90 is the
    top-down x-y view."""
    az = np.deg2rad(azim_deg)
    el = np.deg2rad(elev_deg)
    x = np.cos(az) * qx + np.sin(az) * qy
    y = -np.sin(az) * qx + np.cos(az) * qy
    u = x
    v = np.sin(el) * y - np.cos(el) * qz
    return u, v


class OfflineSpheresVisu(SpheresVisu):
    """PNG-per-frame renderer (matplotlib Agg).  ``--visu-out DIR``."""

    def __init__(self, out_dir: str, *, width: int = 1024, height: int = 768,
                 color: bool = True, max_frames: int = 10000,
                 azim: float = 0.0, elev: float = 90.0):
        import matplotlib

        matplotlib.use("Agg")
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.width = width
        self.height = height
        self.color = color
        self.max_frames = max_frames
        self.azim = azim
        self.elev = elev
        self._frame = 0

    def refresh_display(self, state=None, time_s: float | None = None) -> None:
        if state is None or self._frame >= self.max_frames:
            return
        import matplotlib.pyplot as plt

        d = host_frame(state)
        if self.color:
            colors = cyberpunk_colors(
                d["vx"], d["vy"], d["vz"],
                time_s=self._frame / 30.0 if time_s is None else time_s,
            )
        else:
            colors = "white"
        fig = plt.figure(
            figsize=(self.width / 100, self.height / 100), dpi=100,
            facecolor="black",
        )
        ax = fig.add_subplot(111, facecolor="black")
        u, v = project(d["qx"], d["qy"], d["qz"], self.azim, self.elev)
        ax.scatter(u, v, s=0.5, c=colors, linewidths=0)
        ax.set_axis_off()
        fig.savefig(
            os.path.join(self.out_dir, f"frame_{self._frame:06d}.png"),
            facecolor="black",
        )
        plt.close(fig)
        self._frame += 1


def create_visu(cfg, for_state=None) -> SpheresVisu:
    """Visu factory (ref: createVisu<T>, src/murb/main.cpp:272-307)."""
    if getattr(cfg, "visu_live", None) is not None and cfg.visu_enable:
        from murb_tpu_torch.visu.live import LiveSpheresVisu

        max_pts = int(os.environ.get("MURB_VISU_MAX_POINTS", "150000"))
        return LiveSpheresVisu(port=cfg.visu_live, max_points=max_pts)
    if cfg.visu_out and cfg.visu_enable:
        try:
            return OfflineSpheresVisu(
                cfg.visu_out, width=cfg.win_width, height=cfg.win_height,
                color=cfg.visu_color,
                azim=getattr(cfg, "cam_azim", 0.0),
                elev=getattr(cfg, "cam_elev", 90.0),
            )
        except ImportError:
            print("matplotlib unavailable; falling back to headless visu")
    return SpheresVisuNo()
