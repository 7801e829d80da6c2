"""Steps completed in the window over the window's wall time: from the
first timed frame's start to the last frame's read-back end (host clock)."""


def read(run):
    if not run.frames or run.window_s <= 0:
        return None
    return run.frames * run.steps_per_frame / run.window_s
