"""Anterpolation stages of the Chebyshev proxy: kernels K1 (P2M) and K2
(L2P) and their plain versions.

Port of ``murb_tpu/ops/proxy_pallas.py`` together with the stages it
fuses, ``bases`` / ``p2m`` / ``l2p`` of ``murb_tpu/ops/proxy.py``.  The
plain versions build the per-body bases Sx, Sy, Sz (n, m) and the combined
Syz (n, m^2) as tensors and contract them; the CUDA kernels
(``csrc/proxy.cu``) rebuild the bases on chip from the coordinates, so the
only device memory traffic is the coordinates in and the result out.

``p2m_fused`` and ``l2p_fused_multi`` run the plain version on CPU tensors
and launch the kernel on CUDA tensors.  The box center ``c`` and
half-widths ``h`` stay on the device; the kernels read them from device
memory, so a step never waits on the device.
"""
from __future__ import annotations

import math

import torch

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import notify_fp32_compute

#: highest order the kernels take (P = m^3 = 32,768 node outputs)
MAX_ORDER = 32
#: node fields one L2P call takes: force (3) plus up to 8 potential rows
#: (csrc/proxy.cu kMaxTotalFields; the kernel runs them in groups of 4)
MAX_FIELDS = 11
_L2P_GROUP = 4  # fields one K2 launch takes (csrc/proxy.cu kMaxFields)
_TAG = "tpu+proxy (fused anterpolation)"
_P2M_TILE = 64  # bodies per P2M tile (csrc/proxy.cu kP2MTile)


def _tj_nodes(m: int, dtype: torch.dtype, device) -> torch.Tensor:
    """T_j(t_k) for j = 1..m-1 at the first-kind nodes t_k, (m, m-1);
    computed in float64 on ``device`` (no host-to-device copy)."""
    k = torch.arange(m, dtype=torch.float64, device=device)
    theta = math.pi * (k + 0.5) / m
    j = torch.arange(1, m, dtype=torch.float64, device=device)
    return torch.cos(theta[:, None] * j[None, :]).to(dtype)


def _basis(t: torch.Tensor, m: int) -> torch.Tensor:
    """Lagrange-on-Chebyshev basis S (len(t), m):
    S_k(t) = 1/m + (2/m) sum_{j>=1} T_j(t_k) T_j(t), with T_j(t) from the
    three-term recurrence (ref: murb_tpu/ops/proxy.py:_basis)."""
    if m < 2:
        raise ValueError(f"Chebyshev order must be >= 2, got {m}")
    t = t.clamp(-1.0, 1.0)
    cols = [t]
    if m > 2:
        cols.append(2.0 * t * t - 1.0)
        for _ in range(3, m):
            cols.append(2.0 * t * cols[-1] - cols[-2])
    tj_t = torch.stack(cols[: m - 1], dim=1)                  # (n, m-1)
    return (1.0 / m) + (2.0 / m) * (tj_t @ _tj_nodes(m, t.dtype,
                                                     t.device).T)


def bases(qx, qy, qz, c, h, m: int):
    """Per-dimension interpolation matrices: Sx (n, m) and the combined
    Syz (n, m*m).  ``c`` and ``h`` are the box center and per-dimension
    half-widths, (3,) tensors."""
    sx = _basis((qx - c[0]) / h[0], m)
    sy = _basis((qy - c[1]) / h[1], m)
    sz = _basis((qz - c[2]) / h[2], m)
    syz = (sy[:, :, None] * sz[:, None, :]).reshape(qx.shape[0], m * m)
    return sx, syz


def p2m(sx, syz, gm_eff, m: int) -> torch.Tensor:
    """W (m^3,): source weights anterpolated to the proxy grid."""
    return ((gm_eff[:, None] * sx).T @ syz).reshape(m * m * m)


def l2p(sx, syz, fields, m: int) -> tuple:
    """A tuple of k (m^3,) node fields interpolated back to the bodies ->
    k x (n,) (the small tensor contracted first, as in
    murb_tpu/ops/proxy.py:l2p)."""
    fmat = torch.stack([f.reshape(m, m * m) for f in fields], dim=2)
    b = torch.einsum("jp,upf->juf", syz, fmat)                 # (n, m, k)
    out = torch.einsum("ju,juf->jf", sx, b)
    return tuple(out[:, i] for i in range(len(fields)))


def p2m_plain(qx, qy, qz, gm_eff, c, h, *, m: int) -> torch.Tensor:
    """The plain PyTorch P2M, in the inputs' dtype."""
    sx, syz = bases(qx, qy, qz, c, h, m)
    return p2m(sx, syz, gm_eff, m)


def l2p_plain(qx, qy, qz, c, h, fields, *, m: int) -> tuple:
    """The plain PyTorch L2P of a tuple of (m^3,) node fields."""
    sx, syz = bases(qx, qy, qz, c, h, m)
    return l2p(sx, syz, fields, m)


def _box(c, h, dev) -> torch.Tensor:
    """The (6,) float32 device box [c, h] the kernels read."""
    if c.device != dev or h.device != dev:
        raise ValueError(f"{_TAG}: box on {c.device}/{h.device}, "
                         f"expected {dev}")
    return torch.cat([c.reshape(3), h.reshape(3)]).to(torch.float32)


def _check_order(m: int) -> None:
    if not 2 <= m <= MAX_ORDER:
        raise ValueError(f"{_TAG}: order m={m} outside the kernels' "
                         f"range [2, {MAX_ORDER}]")


def p2m_fused(qx, qy, qz, gm_eff, c, h, *, m: int) -> torch.Tensor:
    """W (m^3,) = P2M.  CPU tensors run ``p2m_plain``; CUDA tensors launch
    K1 (fp32 inside; float64 inputs are cast here, W cast back)."""
    if qx.device.type == "cpu":
        return p2m_plain(qx, qy, qz, gm_eff, c, h, m=m)
    cuda.require_cuda(_TAG, qx)
    _check_order(m)
    dtype, dev, n = qx.dtype, qx.device, qx.shape[0]
    x, y, z, g = cuda.kernel_inputs(_TAG, dev, n, qx, qy, qz, gm_eff,
                                    notify=notify_fp32_compute)
    box = _box(c, h, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblocks = max(1, min(-(-n // _P2M_TILE), 4 * sms))
    p3 = m * m * m
    partial = torch.empty(nblocks * p3, dtype=torch.float32, device=dev)
    w = torch.empty(p3, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cuda.launch("murb_p2m", x.data_ptr(), y.data_ptr(), z.data_ptr(),
                    g.data_ptr(), n, box.data_ptr(), m, partial.data_ptr(),
                    nblocks, w.data_ptr(), cuda.stream(dev))
    p2m_fused.launches += 1
    return w.to(dtype)


p2m_fused.launches = 0


def l2p_fused_multi(qx, qy, qz, c, h, fields, *, m: int) -> tuple:
    """Interpolate a tuple of 1 to 11 (m^3,) node fields to the bodies ->
    tuple of (n,).  CPU tensors run ``l2p_plain``; CUDA tensors launch K2
    once per group of at most 4 fields, and count each launch."""
    k = len(fields)
    if not 1 <= k <= MAX_FIELDS:
        raise ValueError(f"{_TAG}: L2P takes 1 to {MAX_FIELDS} node fields, "
                         f"got {k}")
    if qx.device.type == "cpu":
        return l2p_plain(qx, qy, qz, c, h, fields, m=m)
    cuda.require_cuda(_TAG, qx)
    _check_order(m)
    dtype, dev, n = qx.dtype, qx.device, qx.shape[0]
    x, y, z = cuda.kernel_inputs(_TAG, dev, n, qx, qy, qz,
                                 notify=notify_fp32_compute)
    fmat = torch.stack(cuda.kernel_inputs(_TAG, dev, m ** 3, *fields,
                                          notify=notify_fp32_compute))
    box = _box(c, h, dev)
    out = torch.empty((k, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cuda.launch("murb_l2p", x.data_ptr(), y.data_ptr(), z.data_ptr(), n,
                    box.data_ptr(), m, fmat.data_ptr(), k, out.data_ptr(),
                    cuda.stream(dev))
    l2p_fused_multi.launches += -(-k // _L2P_GROUP)
    return tuple(o.to(dtype) for o in out)


l2p_fused_multi.launches = 0


def l2p_fused(qx, qy, qz, c, h, f_ax, f_ay, f_az, *, m: int) -> torch.Tensor:
    """a (n, 3) = L2P of the three node force fields."""
    return torch.stack(l2p_fused_multi(qx, qy, qz, c, h, (f_ax, f_ay, f_az),
                                       m=m), dim=1)
