"""Shared kernel helpers: FLOPs model, acceleration container, block utils.

Port of ``murb_tpu/ops/common.py``.  ``BlockSpec``, ``bsplit`` and
``f32_inputs`` exist only for the TPU compiler and are not ported.
"""
from __future__ import annotations

import functools
import sys
from typing import NamedTuple

import torch
import torch.utils._pytree as pytree

_FP32_NOTIFIED: set[tuple[str, torch.dtype]] = set()


class Accel(NamedTuple):
    """SoA accelerations, the analogue of ``accSoA_t<T>``
    (ref: src/common/core/Bodies.hpp:44-56)."""

    ax: torch.Tensor
    ay: torch.Tensor
    az: torch.Tensor


def _is_bf16(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16


def _in_float32(fn, out_dtype):
    """``fn`` with every bf16 tensor argument upcast to float32 (exact) and
    each float32 tensor output cast to ``out_dtype(tensor arguments)`` (no
    cast when it gives None).  Calls without a bf16 tensor pass through."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        leaves = pytree.tree_leaves((args, kw))
        if not any(_is_bf16(x) for x in leaves):
            return fn(*args, **kw)
        dt = out_dtype([x for x in leaves if isinstance(x, torch.Tensor)])
        args, kw = pytree.tree_map(
            lambda x: x.float() if _is_bf16(x) else x, (args, kw))
        out = fn(*args, **kw)
        if dt is None:
            return out
        return pytree.tree_map(
            lambda x: x.to(dt) if isinstance(x, torch.Tensor)
            and x.dtype == torch.float32 else x, out)

    return wrapped


def bf16_plain(fn=None, *, round_outputs: bool = True):
    """For a kernel's plain version: bf16 inputs are upcast to float32,
    which is exact, the version computes as it does for float32, and its
    float32 tensor outputs are rounded to bf16 -- what murb_tpu's Pallas
    kernels do with a bf16 state (they upcast their refs and cast the
    outputs back).  ``round_outputs=False`` keeps the outputs float32,
    where murb_tpu's kernel returns float32 (the P2M weights, K5's
    potentials).  Calls without a bf16 tensor pass through unchanged."""
    if fn is None:
        return functools.partial(bf16_plain, round_outputs=round_outputs)
    return _in_float32(fn, lambda ts: torch.bfloat16 if round_outputs
                       else None)


def bf16_chain(fn):
    """For a pairwise chain outside the kernels (the naive sweeps, the
    proxy's node sweeps, heavy corrections and potential rows): bf16
    inputs are upcast to float32 (exact), the chain computes in float32,
    and each float32 tensor output is rounded once, to the promoted dtype
    of the tensor inputs (bf16, or float32 beside float32 weights, as jnp
    promotes).  XLA keeps fp32 inside a fused bf16 chain and rounds where
    it ends; the kernels' plain versions (``bf16_plain``) and the exact
    metrics sweep (core/metrics.sweep_dtype) follow the same rule, so a
    bf16 state meets one rule on every path.  Calls without a bf16 tensor
    pass through unchanged."""
    def promoted(ts):   # 0-dim tensors (a softening) promote nothing
        return functools.reduce(torch.promote_types, (
            t.dtype for t in ts if t.is_floating_point() and t.dim()))

    return _in_float32(fn, promoted)


def weights_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the P2M weights a kernel returns for a state of
    ``dtype``: float32 for bf16, as murb_tpu's P2M kernels return them
    (ops/proxy_pallas.py:p2m_fused), so the M2L of a bf16 state sums fp32
    weights; the state's own otherwise."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


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
    """One notice per kernel tag and dtype when fp64 state enters a kernel
    that computes in fp32 (the contract of the JAX package's Pallas
    kernels, kept by the CUDA kernels that replace them), or bf16 state a
    kernel that has no bf16 instance: its wrapper upcasts the inputs to
    fp32, which is exact (ops/cuda.kernel_inputs)."""
    if (kernel, dtype) in _FP32_NOTIFIED or dtype not in (torch.float64,
                                                         torch.bfloat16):
        return
    _FP32_NOTIFIED.add((kernel, dtype))
    if dtype == torch.bfloat16:
        print(f"[murb-tpu-torch] note: {kernel} upcasts bf16 inputs to "
              "fp32 (exact): it has no bf16 instance yet, or takes them "
              "with float32 ones (ROADMAP.md Queue 1, item 1's bf16 "
              "loads).", file=sys.stderr)
        return
    detail = detail or (
        "fp64 state is down-cast for the sweep (~1e-6 relative force error)")
    print(f"[murb-tpu-torch] note: {kernel} computes in fp32 internally; "
          f"{detail}. For bit-honest fp64 use --im cpu+naive or "
          f"--device cpu.", file=sys.stderr)
