"""The 95th percentile (numpy's linear interpolation) of every frame of the
window: its steps, the synchronise and the read-back, host clock."""
import numpy as np


def read(run):
    if not run.frame_s:
        return None
    return float(np.percentile(run.frame_s, 95)) * 1e3
