"""Kernels the device ran in the profiled frames, over their steps."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return t.launches() / (t.frames * run.steps_per_frame)
