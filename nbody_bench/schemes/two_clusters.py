"""Two Gaussian clusters at rest (murb-tpu ``bench.py:72-90``, the state of
its ``adaptive_two_clusters_1m`` row).

A frozen copy of ``murb_tpu_torch/utils/profile_step.two_clusters``: numpy's
``default_rng(seed)`` draws sigma-5 clusters of n/2 bodies centred at
(-75, 0, 0) and (75, 20, -10), masses U(0.5, 2) 1e10, in the same order, and
rounds them to float32 as that function does; the run's seed replaces its
fixed 42.  Radii are 1 and no ghosts are drawn (their positions are zero).
"""
from __future__ import annotations

import numpy as np


def generate(n: int, seed: int, pad_multiple: int = 256) -> dict:
    del pad_multiple  # ghosts at the origin, as the port pads this state
    rng = np.random.default_rng(seed)
    q = np.concatenate([
        rng.normal(0, 5.0, (n // 2, 3)) + [-75.0, 0.0, 0.0],
        rng.normal(0, 5.0, (n - n // 2, 3)) + [75.0, 20.0, -10.0],
    ]).astype(np.float32)
    m = (rng.uniform(0.5, 2.0, n) * 1e10).astype(np.float32)
    zero = np.zeros(n, np.float64)
    return {"m": m.astype(np.float64), "r": np.ones(n),
            "qx": q[:, 0].astype(np.float64),
            "qy": q[:, 1].astype(np.float64),
            "qz": q[:, 2].astype(np.float64),
            "vx": zero, "vy": zero.copy(), "vz": zero.copy(),
            "ghost_q": None, "ghost_v": None}
