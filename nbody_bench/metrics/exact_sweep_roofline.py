"""The exact sweep's share of its floor: the least time one all-pairs step
over the n real bodies could take (``roofline.exact_sweep_floor_ms``: 20
flops a pair at 67 TFLOP/s, or one MUFU rsqrt a pair at 16 a clock an SM on
132 SMs at 1980 MHz, whichever is larger) over the step's kernel time, the
union of every kernel interval of the profiled frames over their steps, so a
renamed or split kernel still counts.  In %."""
from nbody_bench import roofline


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    kernel_ms = t.busy_us(("kernel",)) * 1e-3 / (t.frames
                                                 * run.steps_per_frame)
    if kernel_ms <= 0:
        return None
    return 100.0 * roofline.exact_sweep_floor_ms(run.n) / kernel_ms
