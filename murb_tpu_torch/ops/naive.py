"""Naive all-pairs sweeps in plain PyTorch: the port's oracle.

Port of ``murb_tpu/ops/naive.py`` (ref:
src/murb/implem/SimulationNBodyNaive.cpp:34-53): for every pair (i, j)

    a_i += G * m_j * r_ij / (|r_ij|^2 + eps^2)^{3/2}

Softening keeps the j == i self-term and every zero-mass ghost contribution
exactly zero, so no masking is needed.  All sweeps compute in the dtype of
their inputs (float64 inputs give a float64 oracle), bf16 ones in float32
with the outputs rounded once (``ops/common.bf16_chain``).  ``soft`` is a
Python float or a 0-dim tensor, through which autograd reaches the
softening (murb_tpu_torch.diff).

  * ``acc_naive``         -- one (N, N) broadcast; the differential oracle.
  * ``acc_rect``          -- the rectangular (i-set x j-set) broadcast.
  * ``acc_rect_jchunked`` -- the same sum over j-chunks, O(ni * chunk) memory.
  * ``acc_chunked``       -- i-chunked square sweep, O(chunk * N) memory.
"""
from __future__ import annotations

import torch

from murb_tpu_torch.ops.common import Accel, bf16_chain


def soft_squared(soft, dtype: torch.dtype):
    """eps^2 for sweeps in ``dtype``: a Python float squared in double
    precision (each sweep's bits since the port began), a tensor cast to
    ``dtype`` and squared there, as murb_tpu forms it, so that a gradient
    reaches it."""
    if isinstance(soft, torch.Tensor):
        s = soft.to(dtype)
        return s * s
    return float(soft) ** 2


def _pair_weights(dx, dy, dz, gm_j, soft2):
    """w_ij = G*m_j / (|r_ij|^2 + eps^2)^{3/2} via rsqrt (no pow)."""
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + soft2)
    return gm_j * (inv * inv * inv)


@bf16_chain
def acc_rect(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft) -> Accel:
    """Accelerations of the i-set due to the j-set (one broadcast)."""
    soft2 = soft_squared(soft, qxi.dtype)
    dx = qxj[None, :] - qxi[:, None]
    dy = qyj[None, :] - qyi[:, None]
    dz = qzj[None, :] - qzi[:, None]
    w = _pair_weights(dx, dy, dz, gmj[None, :], soft2)
    return Accel((w * dx).sum(1), (w * dy).sum(1), (w * dz).sum(1))


def acc_naive(qx, qy, qz, gm, soft) -> Accel:
    """Full-broadcast all-pairs accelerations.  Tensors are (npad,)."""
    return acc_rect(qx, qy, qz, qx, qy, qz, gm, soft)


def acc_rect_jchunked(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                      chunk: int = 262_144) -> Accel:
    """``acc_rect`` summed over j-chunks of at most ``chunk`` sources: the
    live set is O(ni * chunk) instead of O(ni * nj).  A ragged last chunk
    is swept as it is."""
    nj = qxj.shape[0]
    ax = ay = az = None
    for s in range(0, max(nj, 1), chunk):
        sl = slice(s, min(s + chunk, nj))
        a = acc_rect(qxi, qyi, qzi, qxj[sl], qyj[sl], qzj[sl], gmj[sl], soft)
        if ax is None:
            ax, ay, az = a
        else:
            ax, ay, az = ax + a.ax, ay + a.ay, az + a.az
    return Accel(ax, ay, az)


def acc_chunked(qx, qy, qz, gm, soft, *, chunk: int = 1024) -> Accel:
    """i-chunked square all-pairs sweep with O(chunk * N) live memory."""
    parts = [acc_rect(qx[s:s + chunk], qy[s:s + chunk], qz[s:s + chunk],
                      qx, qy, qz, gm, soft)
             for s in range(0, qx.shape[0], chunk)]
    return Accel(*(torch.cat([p[c] for p in parts]) for c in range(3)))
