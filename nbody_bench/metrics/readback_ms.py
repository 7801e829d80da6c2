"""Mean host time of a frame's positions copy (``core/state.host_array`` of
each read-back field), after the frame's synchronise: the benchmark's span
over the traced run's unprofiled frames."""
import statistics


def read(run):
    s = run.spans["readback"]
    return statistics.fmean(s) * 1e3 if s else None
