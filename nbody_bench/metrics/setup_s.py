"""Process start to the first timed frame: the imports, the CUDA context,
the kernel library's load (its build on a checkout's first run), the bodies,
the engine with its planner and validation, and the warm-up frames."""
import math


def read(run):
    return None if math.isnan(run.setup_s) else run.setup_s
