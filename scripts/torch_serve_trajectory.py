#!/usr/bin/env python
"""Play a recorded MURBTRAJ trajectory through murb_tpu_torch's live
WebGL viewer.

The port's counterpart of scripts/serve_trajectory.py: the live viewer
(murb_tpu_torch/visu/live.py) normally streams the running simulation;
this script feeds it a trajectory file instead, so a run recorded with
``python -m murb_tpu_torch --dump-traj`` can be replayed interactively
without simulating again.

Controls in the browser: space pauses playback, PgUp/PgDn double/halve
the playback rate, q ends the server.

Usage:
  python scripts/torch_serve_trajectory.py run.traj [--port 8797]
                                           [--fps 30] [--loop]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from murb_tpu_torch.io import read_trajectory          # noqa: E402
from murb_tpu_torch.visu.live import LiveSpheresVisu   # noqa: E402


class _FrameState:
    """The surface the viewer reads of a state (``visu.host_frame``): the
    six position and velocity tensors and the body count."""

    def __init__(self, pos: np.ndarray, vel: np.ndarray):
        self.n = pos.shape[0]
        for i, c in enumerate("xyz"):
            setattr(self, f"q{c}", torch.from_numpy(pos[:, i]))
            setattr(self, f"v{c}", torch.from_numpy(vel[:, i]))


def play(path: str, visu: LiveSpheresVisu, fps: float, loop: bool) -> int:
    indices, pos = read_trajectory(path)
    F = len(indices)
    # palette speeds from frame differences (the file stores positions)
    vel = np.empty_like(pos)
    vel[:-1] = pos[1:] - pos[:-1]
    vel[-1] = vel[-2] if F > 1 else 0.0
    print(f"{path}: {F} frames x {pos.shape[1]} bodies; "
          f"{fps:.1f} FPS{' (loop)' if loop else ''}")

    shown = 0
    while True:
        for f in range(F):
            if visu.window_should_close():
                return shown
            if visu.pressed_page_up():
                fps = min(fps * 2.0, 480.0)
            if visu.pressed_page_down():
                fps = max(fps / 2.0, 0.5)
            if visu.pressed_space_bar():
                visu.paused = True
                while not (visu.pressed_space_bar()
                           or visu.window_should_close()):
                    time.sleep(0.05)
                visu.paused = False
            visu.dt = float(indices[min(f + 1, F - 1)] - indices[f])
            visu.refresh_display(_FrameState(pos[f], vel[f]),
                                 time_s=float(indices[f]))
            shown += 1
            time.sleep(1.0 / fps)
        if not loop:
            return shown


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trajectory", help="MURBTRAJ file (--dump-traj output)")
    ap.add_argument("--port", type=int, default=8797)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--loop", action="store_true",
                    help="repeat until the viewer sends q or closes")
    args = ap.parse_args()

    visu = LiveSpheresVisu(port=args.port)
    try:
        shown = play(args.trajectory, visu, args.fps, args.loop)
    finally:
        visu.close()
    print(f"played {shown} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
