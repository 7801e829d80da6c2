"""Device ms a step of the near field's kernel K10 (``csrc/p2p.cu``
``p2p_kernel``, its fp32 and bf16 instances) in the profiled frames."""

KERNEL = r"\bp2p_kernel\b"


def read(run):
    t = run.trace
    if t is None:
        return None
    us = t.kernel_us(KERNEL)
    if us <= 0:
        return None
    return us * 1e-3 / (t.frames * run.steps_per_frame)
