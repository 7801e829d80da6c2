"""Shared kernel helpers: FLOPs model, acceleration container, block utils.

Port of ``murb_tpu/ops/common.py``.  ``BlockSpec``, ``bsplit`` and
``f32_inputs`` exist only for the TPU compiler and are not ported.
"""
from __future__ import annotations

import sys
from typing import NamedTuple

import torch

_FP32_NOTIFIED: set[str] = set()


class Accel(NamedTuple):
    """SoA accelerations, the analogue of ``accSoA_t<T>``
    (ref: src/common/core/Bodies.hpp:44-56)."""

    ax: torch.Tensor
    ay: torch.Tensor
    az: torch.Tensor


def not_yet_ported(what: str, item: str) -> NotImplementedError:
    """The error every branch of the JAX package that the port does not
    carry yet raises (never a silent substitute)."""
    return NotImplementedError(
        f"{what} is not yet ported to murb_tpu_torch (ROADMAP.md {item})")


def flops_per_iteration(n: int) -> int:
    """The reference's fixed accounting: 20 flops per interaction, N^2
    interactions (ref: src/murb/implem/SimulationNBodyNaive.cpp:15)."""
    return 20 * n * n


def pick_block(npad: int, target: int, minimum: int = 128) -> int:
    """Largest power-of-two block <= target that divides ``npad``."""
    b = target
    while b >= minimum:
        if npad % b == 0:
            return b
        b //= 2
    return minimum


def notify_fp32_compute(kernel: str, dtype: torch.dtype,
                        detail: str | None = None) -> None:
    """One notice per kernel tag when fp64 state enters a kernel that
    computes in fp32 (the contract of the JAX package's Pallas kernels,
    kept by the CUDA kernels that replace them)."""
    if kernel in _FP32_NOTIFIED or dtype != torch.float64:
        return
    _FP32_NOTIFIED.add(kernel)
    detail = detail or (
        "fp64 state is down-cast for the sweep (~1e-6 relative force error)")
    print(f"[murb-tpu-torch] note: {kernel} computes in fp32 internally; "
          f"{detail}. For bit-honest fp64 use --im cpu+naive or "
          f"--device cpu.", file=sys.stderr)
