"""The norm-expansion all-pairs sweep: kernel K13 and its plain version.

Port of ``murb_tpu/ops/mxu.py``, the ``tpu+mxu`` engine's sweep.  With the
coordinates centred on the G*m-weighted mean (forces are translation
invariant; centring keeps the expansion's cancellation far below the
softening floor) and packed as mxu.py:132-142 packs them,

  A (8, nj) rows: cqx_j, cqy_j, cqz_j, |cq_j|^2, 1, 0, 0, 0
  B (8, ni) rows: -2cqx_i, -2cqy_i, -2cqz_i, 1, |cq_i|^2 + eps^2, 0, 0, 0

the sweep is S = A^T B (= |r_j - r_i|^2 + eps^2), W = gm_j rsqrt(S)^3,
P = A W, and the O(N) epilogue a_i = P[0:3, i] - cq_i P[4, i].  Self-pairs
stay in; they cancel in the epilogue.

The centring and packing are plain torch ops (jnp stages outside the
Pallas kernel in the reference).  On CUDA tensors ``acc_mxu_rect``
launches ``csrc/mxu.cu`` (K13, which replaces ``mxu._mxu_kernel``); on CPU
tensors it runs ``acc_mxu_rect_plain``, the same arithmetic in i-chunks
with ``torch.matmul`` for A^T B and A W, in the inputs' dtype.

``precision`` / ``s_precision`` keep murb_tpu's tiers ("default": one
bf16 pass for P, ~0.4% force error; "high", the default, and "highest":
fp32-class).  K13 computes every tier in fp32 on the CUDA cores, which
meets each tier's error bound; "default" is not yet a faster tier
(ROADMAP.md Queue 2, K13).  ``block_i`` / ``block_j`` pick one of K13's
compiled geometries (0 each: 128 targets a block, 256 sources a tile;
ops/cuda.check_blocks); the plain version ignores them.
"""
from __future__ import annotations

import torch

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import Accel, notify_fp32_compute

TAG = "tpu+mxu"
PRECISIONS = ("default", "high", "highest")


def check_precisions(precision: str, s_precision: str = "highest") -> None:
    """Refuse a precision tier murb_tpu does not have."""
    for name, p in (("precision", precision), ("s_precision", s_precision)):
        if p not in PRECISIONS:
            raise ValueError(f"{TAG}: unknown {name} {p!r} "
                             f"({', '.join(PRECISIONS)})")


def _centered_with_point(qx, qy, qz, gm):
    """The coordinates less their G*m-weighted mean, and that mean
    (mxu.py:185-190)."""
    w = gm / torch.clamp(gm.sum(), min=1.0)
    cx, cy, cz = (w * qx).sum(), (w * qy).sum(), (w * qz).sum()
    return qx - cx, qy - cy, qz - cz, (cx, cy, cz)


def _operands(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, center,
              center_point):
    """(A (8, nj), B (8, ni), centred targets (cqx_i, cqy_i, cqz_i)) in the
    inputs' dtype (mxu.py:120-142).  ``center_point`` (cx, cy, cz)
    overrides the centre computed from the j-set."""
    if center_point is not None:
        cx, cy, cz = center_point
        cqxj, cqyj, cqzj = qxj - cx, qyj - cy, qzj - cz
    elif center:
        cqxj, cqyj, cqzj, (cx, cy, cz) = _centered_with_point(qxj, qyj, qzj,
                                                              gmj)
    else:
        cx = cy = cz = 0.0
        cqxj, cqyj, cqzj = qxj, qyj, qzj
    cqi = (qxi - cx, qyi - cy, qzi - cz)
    nqj = cqxj * cqxj + cqyj * cqyj + cqzj * cqzj
    nqi = cqi[0] * cqi[0] + cqi[1] * cqi[1] + cqi[2] * cqi[2]
    one_j, zero_j = torch.ones_like(nqj), torch.zeros_like(nqj)
    one_i, zero_i = torch.ones_like(nqi), torch.zeros_like(nqi)
    a_mat = torch.stack([cqxj, cqyj, cqzj, nqj, one_j, zero_j, zero_j,
                         zero_j])
    b_mat = torch.stack([-2.0 * cqi[0], -2.0 * cqi[1], -2.0 * cqi[2], one_i,
                         nqi + float(soft) ** 2, zero_i, zero_i, zero_i])
    return a_mat, b_mat, cqi


def acc_mxu_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                       center: bool = True, center_point=None,
                       chunk: int = 1024) -> Accel:
    """The plain PyTorch K13, in the inputs' dtype: S = A^T B, W, P = A W
    and the epilogue, ``chunk`` targets at a time."""
    a_mat, b_mat, cqi = _operands(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft,
                                  center, center_point)
    out = torch.empty((3, qxi.shape[0]), dtype=qxi.dtype, device=qxi.device)
    for s in range(0, qxi.shape[0], chunk):
        sl = slice(s, s + chunk)
        inv = torch.rsqrt(a_mat.T @ b_mat[:, sl])              # (nj, c)
        p = a_mat @ (gmj[:, None] * (inv * inv * inv))          # (8, c)
        for c in range(3):
            out[c, sl] = p[c] - cqi[c][sl] * p[4]
    return Accel(out[0], out[1], out[2])


def acc_mxu_rect(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                 block_i: int = 0, block_j: int = 0,
                 precision: str = "high", s_precision: str = "highest",
                 center: bool = True, center_point=None) -> Accel:
    """Accelerations of the i-set due to the j-set by the norm expansion.

    ``center_point`` (cx, cy, cz) overrides the centre computed from the
    j-set, so that shards of one system agree.  CPU tensors run the plain
    version; CUDA tensors launch K13 (fp32 inside; float64 inputs are cast
    here, announced once, and the outputs cast back)."""
    check_precisions(precision, s_precision)
    cuda.check_blocks(TAG, block_i, block_j)
    if qxi.device.type == "cpu":
        return acc_mxu_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft,
                                  center=center, center_point=center_point)
    cuda.require_cuda(TAG, qxi)
    if not float(soft) > 0.0:
        raise ValueError(f"{TAG}: the sweep needs a positive softening")
    dtype, dev = qxi.dtype, qxi.device
    ni, nj = qxi.shape[0], qxj.shape[0]
    qi = cuda.kernel_inputs(TAG, dev, ni, qxi, qyi, qzi,
                            notify=notify_fp32_compute)
    *qj, gj = cuda.kernel_inputs(TAG, dev, nj, qxj, qyj, qzj, gmj,
                                 notify=notify_fp32_compute)
    a_mat, b_mat, cqi = _operands(*qi, *qj, gj, soft, center, center_point)
    cqi = [c.contiguous() for c in cqi]
    out = torch.empty((3, ni), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cuda.launch("murb_mxu_rect", a_mat.data_ptr(), gj.data_ptr(), nj,
                    b_mat.data_ptr(), cqi[0].data_ptr(), cqi[1].data_ptr(),
                    cqi[2].data_ptr(), ni, block_i, block_j,
                    out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                    cuda.stream(dev))
    acc_mxu_rect.launches += 1
    return Accel(*(o.to(dtype) for o in out))


acc_mxu_rect.launches = 0


def acc_mxu(qx, qy, qz, gm, soft, *, block_i: int = 0, block_j: int = 0,
            precision: str = "high", s_precision: str = "highest") -> Accel:
    """Square all-pairs case (the single-device engine)."""
    return acc_mxu_rect(qx, qy, qz, qx, qy, qz, gm, soft, block_i=block_i,
                        block_j=block_j, precision=precision,
                        s_precision=s_precision)
