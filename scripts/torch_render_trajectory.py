#!/usr/bin/env python
"""Render a MURBTRAJ trajectory file to PNG frames (and optionally a GIF)
with murb_tpu_torch's reader and palette.

The port's counterpart of scripts/render_trajectory.py: the same
velocity-magnitude "cyberpunk" palette and 130-BPM beat pulse
(murb_tpu_torch/visu: ref src/common/ogl/OGLSpheresVisuGS.cpp:86-172),
estimated from frame-to-frame displacement since the trajectory stores
positions only.  It reads the files that ``python -m murb_tpu_torch
--dump-traj`` (or murb_tpu's) writes.  Needs matplotlib.

Usage:
  python scripts/torch_render_trajectory.py run.traj outdir \\
      [--gif out.gif] [--fps 30] [--azim 0] [--elev 90]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("traj")
    ap.add_argument("outdir")
    ap.add_argument("--gif", default=None)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--size", type=float, default=0.5, help="marker size")
    ap.add_argument("--azim", type=float, default=0.0, help="camera azimuth")
    ap.add_argument("--elev", type=float, default=90.0,
                    help="camera elevation (90 = top-down)")
    args = ap.parse_args()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from murb_tpu_torch.io import read_trajectory
    from murb_tpu_torch.visu import cyberpunk_colors, project

    idx, pos = read_trajectory(args.traj)
    os.makedirs(args.outdir, exist_ok=True)
    # the whole trajectory projected once; each frame reuses it
    su_all, sv_all = project(pos[..., 0], pos[..., 1], pos[..., 2],
                             args.azim, args.elev)
    lim = np.percentile(np.abs(np.stack([su_all, sv_all])), 99.5) * 1.1
    paths = []
    for f in range(len(idx)):
        if f > 0:
            v = pos[f] - pos[f - 1]
            colors = cyberpunk_colors(v[:, 0], v[:, 1], v[:, 2],
                                      time_s=f / args.fps)
        else:
            colors = np.full((pos.shape[1], 3), (0.0, 0.5, 0.8))
        fig = plt.figure(figsize=(8, 6), dpi=100, facecolor="black")
        ax = fig.add_subplot(111, facecolor="black")
        ax.scatter(su_all[f], sv_all[f], s=args.size, c=colors, linewidths=0)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_axis_off()
        out = os.path.join(args.outdir, f"frame_{f:06d}.png")
        fig.savefig(out, facecolor="black", bbox_inches="tight")
        plt.close(fig)
        paths.append(out)
    print(f"wrote {len(paths)} frames to {args.outdir}")

    if args.gif:
        try:
            from PIL import Image
        except ImportError:
            print("PIL unavailable; skipped GIF")
            return 0
        imgs = [Image.open(p) for p in paths]
        imgs[0].save(args.gif, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / args.fps), loop=0)
        print(f"wrote {args.gif}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
