"""Exact all-pairs sweep with precision tiers: kernel K4 and its plain version.

Port of ``murb_tpu/ops/hybrid.py`` (the force kernel; the potential rows
K5 and the fused K6 are not ported yet).  The TPU kernel split each block
between the vector unit and bf16 matrix-unit passes; the port keeps the
accuracy contract of each ``passes`` tier, not the TPU mechanism:

  passes 2 -- fp32-class, <= ~3e-5 max relative force error: K3's fp32
              sweep kernel.
  passes 1 -- runs the passes-2 code in this port (a faster tier is later
              work, ROADMAP.md Queue 2 K4).
  passes 3 -- the extended tier, <= ~1e-6: fp64 accumulation of every
              pair term, K4's own kernel.  The tier ``tpu+hybrid`` picks
              for fp64 state.

On CUDA tensors ``acc_hybrid_rect`` launches ``csrc/hybrid.cu`` (which
hands passes 1/2 to K3's kernel, counted here as K4 launches); on CPU
tensors it runs ``acc_hybrid_rect_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import Accel, notify_fp32_compute
from murb_tpu_torch.ops.naive import _pair_weights
from murb_tpu_torch.ops.tile import acc_tile_rect_plain


def acc_hybrid_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                          passes: int = 1) -> Accel:
    """The plain PyTorch version of each tier: passes 1/2 sum in the
    inputs' dtype (``acc_rect``); passes 3 computes each pair term in the
    inputs' dtype and sums the terms in float64."""
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if passes < 3:
        return acc_tile_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft)
    soft2 = float(soft) ** 2
    sums = [torch.zeros(qxi.shape[0], dtype=torch.float64, device=qxi.device)
            for _ in range(3)]
    for s in range(0, qxj.shape[0], 4096):
        sl = slice(s, s + 4096)
        d = [qj[sl][None, :] - qi[:, None]
             for qi, qj in ((qxi, qxj), (qyi, qyj), (qzi, qzj))]
        w = _pair_weights(*d, gmj[sl][None, :], soft2).double()
        for c in range(3):
            sums[c] += (w * d[c].double()).sum(1)
    return Accel(*(a.to(qxi.dtype) for a in sums))


def acc_hybrid_rect(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                    passes: int = 1) -> Accel:
    """Accelerations of the i-set due to the j-set at tier ``passes``.

    CPU tensors run the plain version; CUDA tensors launch K4 (fp32 inputs
    inside; float64 inputs are cast here and the outputs cast back)."""
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if qxi.device.type == "cpu":
        return acc_hybrid_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj,
                                     soft, passes=passes)
    tag = f"tpu+hybrid/p{passes}"
    cuda.require_cuda(tag, qxi)
    if not float(soft) > 0.0:
        raise ValueError(f"{tag}: the sweep needs a positive softening")
    notify = lambda t, d: notify_fp32_compute(
        t, d, detail=("fp64 state runs the extended tier (fp32 pair "
                      "weights, fp64 accumulation, ~1e-6 relative force "
                      "error)" if passes == 3 else None))
    dtype, dev = qxi.dtype, qxi.device
    ni, nj = qxi.shape[0], qxj.shape[0]
    xi, yi, zi = cuda.kernel_inputs(tag, dev, ni, qxi, qyi, qzi,
                                    notify=notify)
    xj, yj, zj, gj = cuda.kernel_inputs(tag, dev, nj, qxj, qyj, qzj, gmj,
                                        notify=notify)
    out = torch.empty((3, ni), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cuda.launch("murb_hybrid_rect", xi.data_ptr(), yi.data_ptr(),
                    zi.data_ptr(), ni, xj.data_ptr(), yj.data_ptr(),
                    zj.data_ptr(), gj.data_ptr(), nj,
                    ctypes.c_float(float(soft) ** 2), passes,
                    out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                    cuda.stream(dev))
    acc_hybrid_rect.launches += 1
    return Accel(*(o.to(dtype) for o in out))


acc_hybrid_rect.launches = 0


def acc_hybrid(qx, qy, qz, gm, soft, *, passes: int = 1) -> Accel:
    """Square all-pairs case (the single-device exact engine)."""
    return acc_hybrid_rect(qx, qy, qz, qx, qy, qz, gm, soft, passes=passes)
