"""Peaks of one NVIDIA H100 SXM and the operation counts of the kernels.

Frozen here so that no later change to the program can move the yardstick.
The counts are those of ``chip_smoke.py`` (the port's bring-up check): a
softened pair costs 20 flops (3 subtractions, 3 multiply-adds for r^2 + eps^2,
the cube of the rsqrt, 3 multiply-adds into the sum, the G m_j weight), and
one MUFU rsqrt, which the SFUs issue at 16 a clock an SM.

A path that leaves the fp32 cores or the MUFU (tensor-core products, a
polynomial rsqrt) makes this count the thing to correct, not the kernel: a
share above 100% means the count is wrong for the work the kernel now does.
"""
from __future__ import annotations

#: dense fp32 rate outside the tensor cores (NVIDIA data sheet, 700 W)
PEAK_FP32 = 67e12
#: dense TF32 tensor-core rate
PEAK_TF32 = 495e12
#: HBM3 bandwidth
PEAK_BYTES = 3.35e12
#: SMs of the SXM part and its boost clock
SMS = 132
CLOCK_HZ = 1.98e9
#: MUFU rsqrt results a clock an SM
MUFU_PER_CLOCK = 16
#: flops of one softened pair
PAIR_FLOPS = 20


def pair_floor_ms(pairs: float) -> dict:
    """The floors (ms) of an exact sweep over ``pairs`` softened pairs:
    ``fp32`` (20 flops a pair at the fp32 peak) and ``mufu`` (one rsqrt a
    pair at 16 a clock an SM on every SM)."""
    return {"fp32": PAIR_FLOPS * pairs / PEAK_FP32 * 1e3,
            "mufu": pairs / (MUFU_PER_CLOCK * SMS * CLOCK_HZ) * 1e3}


def exact_sweep_floor_ms(n: int) -> float:
    """The least time (ms) one exact all-pairs step of ``n`` bodies could
    take: the larger of its two floors over n^2 pairs (the real bodies, not
    the padded count)."""
    return max(pair_floor_ms(float(n) * n).values())
