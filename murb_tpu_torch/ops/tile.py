"""Exact fp32 rectangular all-pairs sweep: kernel K3 and its plain version.

Port of ``murb_tpu/ops/tile_pallas.py``.  ``acc_tile_rect`` computes the
accelerations of an i-set due to a j-set; on CUDA tensors it launches the
hand-written kernel ``csrc/tile.cu`` (which replaces the TPU kernel
``tile_pallas._tile_kernel``), on CPU tensors it runs
``acc_tile_rect_plain``.  The kernel masks ragged edges itself, so callers
pad nothing.  ``block_i``/``block_j`` pick one of its compiled geometries
(0 each: 128 targets a block, 512 sources a tile; ops/cuda.check_blocks);
the plain version has none and ignores them.  When the target blocks
cannot fill the card, the wrapper splits the j range into slices of whole
tiles (ops/cuda.tile_split) and hands the kernel a (slices, 3, ni)
scratch, which the kernel folds in slice order.  A bf16 state (all seven
arrays bf16) launches K3's bf16 instance, which reads the arrays as they
are and computes in fp32, counted in ``acc_tile_rect.bf16_launches``;
the sums are rounded to bf16, as murb_tpu's kernel casts them back.  It
serves ``tpu+tile`` /
``gpu+tile``, K4 passes 1/2 (ops/hybrid.py) and the proxy node sweep at
P >= 8000 nodes (ops/proxy.node_sweep).
"""
from __future__ import annotations

import ctypes

import torch

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import Accel, bf16_plain, notify_fp32_compute
from murb_tpu_torch.ops.naive import acc_rect_jchunked


@bf16_plain
def acc_tile_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft) -> Accel:
    """The plain PyTorch sweep (``acc_rect``, j-chunked to bound memory),
    in the inputs' dtype; bf16 inputs are upcast to fp32 and the sums
    rounded back (``bf16_plain``), as the kernel does."""
    return acc_rect_jchunked(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft,
                             chunk=4096)


def split_args(ni: int, nj: int, block_i: int, block_j: int,
               device: torch.device, entry: str = "murb_tile_resident",
               dtype: torch.dtype = torch.float32, channels: int = 3):
    """K3's j split on ``device``: ``((slices, tiles_per_slice, scratch
    pointer or None), scratch)``, the scratch a fresh (slices, channels,
    ni) ``dtype`` tensor (None for one slice) that the caller keeps until
    the launch is enqueued.  ``entry`` counts the resident blocks (K4's
    passes 3: ``murb_hybrid_resident`` with float64 slice sums; passes 1:
    ``murb_hybrid_fast_resident`` with P's four columns)."""
    slices, per = cuda.tile_split(ni, nj, cuda.sm_count(device),
                                  cuda.resident(entry, device, block_i,
                                                block_j),
                                  block_i, block_j)
    scratch = (torch.empty((slices, channels, ni), dtype=dtype,
                           device=device) if slices > 1 else None)
    return (slices, per, None if scratch is None else scratch.data_ptr()), \
        scratch


def acc_tile_rect(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                  block_i: int = 0, block_j: int = 0) -> Accel:
    """Accelerations of the i-set due to the j-set (rectangular sweep).

    CPU tensors run the plain version; CUDA tensors launch K3 (fp32 inside;
    float64 inputs are cast here and the outputs cast back; bf16 inputs
    take the bf16 instance, or, mixed with float32 ones, an exact upcast)."""
    cuda.check_blocks("tpu+tile", block_i, block_j)
    if qxi.device.type == "cpu":
        return acc_tile_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft)
    cuda.require_cuda("tpu+tile", qxi)
    cuda.refuse_grad("tpu+tile", soft)
    if not float(soft) > 0.0:
        raise ValueError("tpu+tile: the sweep needs a positive softening")
    dtype, dev = qxi.dtype, qxi.device
    ni, nj = qxi.shape[0], qxj.shape[0]
    b16 = cuda.all_bf16(qxi, qyi, qzi, qxj, qyj, qzj, gmj)
    xi, yi, zi = cuda.kernel_inputs("tpu+tile", dev, ni, qxi, qyi, qzi,
                                    notify=notify_fp32_compute, bf16=b16)
    xj, yj, zj, gj = cuda.kernel_inputs("tpu+tile", dev, nj, qxj, qyj, qzj,
                                        gmj, notify=notify_fp32_compute,
                                        bf16=b16)
    if b16:
        xj, yj, zj, gj = cuda.aligned4(xj, yj, zj, gj)
    out = torch.empty((3, ni), dtype=torch.float32, device=dev)
    sfx = "_bf16" if b16 else ""
    split, _scratch = split_args(ni, nj, block_i, block_j, dev,
                                 "murb_tile_resident" + sfx)
    with torch.cuda.device(dev):
        cuda.launch("murb_tile_rect" + sfx, xi.data_ptr(), yi.data_ptr(),
                    zi.data_ptr(), ni, xj.data_ptr(), yj.data_ptr(),
                    zj.data_ptr(), gj.data_ptr(), nj,
                    ctypes.c_float(float(soft) ** 2), block_i, block_j,
                    *split, out[0].data_ptr(), out[1].data_ptr(),
                    out[2].data_ptr(), cuda.stream(dev))
    if b16:
        acc_tile_rect.bf16_launches += 1
    else:
        acc_tile_rect.launches += 1
    return Accel(*(o.to(dtype) for o in out))


acc_tile_rect.launches = 0
acc_tile_rect.bf16_launches = 0


def acc_tile(qx, qy, qz, gm, soft, *, block_i: int = 0,
             block_j: int = 0) -> Accel:
    """Square all-pairs case (the single-device engines)."""
    return acc_tile_rect(qx, qy, qz, qx, qy, qz, gm, soft, block_i=block_i,
                         block_j=block_j)
