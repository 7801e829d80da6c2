"""The share of the profiled frames in which the card ran no kernel, copy
or memset, in %: 1 - (the union of the device's intervals) / (the profiled
window, from the first frame's start to the last one's end).  Both terms
come from the same frames, so the share lies between 0 and 100; the
profiler's own host overhead is in it (the run's summary line gives the
profiled frame beside an unprofiled one)."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)
