"""Mean host time from entering ``compute_one_iteration()`` to its return
(every step of the frame), before the frame's synchronise; it holds the
step's own host syncs and, once a period, the engine's health check.  The
benchmark's span over the traced run's unprofiled frames, a whole number
of the cell's periods."""
import statistics


def read(run):
    s = run.spans["dispatch"]
    return statistics.fmean(s) * 1e3 / run.steps_per_frame if s else None
