"""Anterpolation stages of the Chebyshev proxy: kernels K1 (P2M) and K2
(L2P) and their plain versions.

Port of ``murb_tpu/ops/proxy_pallas.py`` together with the stages it
fuses, ``bases`` / ``p2m`` / ``l2p`` of ``murb_tpu/ops/proxy.py``.  The
plain versions build the per-body bases Sx, Sy, Sz (n, m) and the combined
Syz (n, m^2) as tensors and contract them; the CUDA kernels
(``csrc/proxy.cu``) build the bases on chip from the coordinates and the
node table, so the only device memory traffic is the coordinates in, the
result out and, for K1, the work items' partials.  K1 is the run kernels'
P2M over one run of all the bodies (``csrc/cell_runs.cuh``), K2 a kernel
of its own that reads the fields as broadcasts (``csrc/proxy.cu``).

``p2m_fused`` and ``l2p_fused_multi`` run the plain version on CPU tensors
and launch the kernel on CUDA tensors.  A bf16 state launches each
kernel's bf16 instance (``murb_p2m_bf16``, ``murb_l2p_bf16``), which reads
the bodies as they are and computes in fp32, counted in
``bf16_launches``: W stays float32 (``weights_dtype``) and the L2P's
values are rounded to bf16, as murb_tpu's kernels return them.  The box
center ``c`` and half-widths ``h`` stay on the device; the kernels read
them from device memory, and K1's run bounds and work items (``one_run``)
and the node table (``node_table``) are built once per (n, m, device), so
a step never waits on the device.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import (bf16_plain, notify_fp32_compute,
                                       weights_dtype)

#: highest order the kernels take (P = m^3 = 32,768 node outputs)
MAX_ORDER = 32
#: node fields one L2P call takes: force (3) plus up to 8 potential rows
#: (csrc/proxy.cu kMaxTotalFields; the kernel runs them in groups of 4)
MAX_FIELDS = 11
_L2P_GROUP = 4  # fields one K2 launch takes (csrc/cell_runs.cuh kRunFields)
#: K2's geometry (csrc/proxy.cu): threads a block, the largest padded
#: order at which a thread takes 2 bodies, and the blocks of 2 bodies a
#: thread an SM must get for K2 to take them (else 1 body a thread)
ONE_L2P_THREADS = 128     # kOneThreads
ONE_L2P_MAX_TB_MW = 20    # kOneMaxTBMW
ONE_L2P_BLOCKS_AN_SM = 4
_TAG = "tpu+proxy (fused anterpolation)"


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
    # jnp.clip's form: at t = +-1 (the box's extreme bodies) maximum and
    # minimum split the gradient in half, as JAX's do; clamp passes it whole
    one = t.new_ones(())
    t = torch.minimum(torch.maximum(t, -one), one)
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


@bf16_plain(round_outputs=False)
def p2m_plain(qx, qy, qz, gm_eff, c, h, *, m: int) -> torch.Tensor:
    """The plain PyTorch P2M, in the inputs' dtype (bf16 inputs upcast,
    W float32: ``weights_dtype``)."""
    sx, syz = bases(qx, qy, qz, c, h, m)
    return p2m(sx, syz, gm_eff, m)


@bf16_plain
def l2p_plain(qx, qy, qz, c, h, fields, *, m: int) -> tuple:
    """The plain PyTorch L2P of a tuple of (m^3,) node fields."""
    sx, syz = bases(qx, qy, qz, c, h, m)
    return l2p(sx, syz, fields, m)


def _entry(name: str, x: torch.Tensor) -> str:
    """The C entry of K1 or K2 for bodies of ``x``'s dtype: the bf16
    instance for bf16, else the float32 one."""
    return name + "_bf16" if x.dtype == torch.bfloat16 else name


def _box(c, h, dev) -> torch.Tensor:
    """The (6,) float32 device box [c, h] the kernels read."""
    cuda.refuse_grad(_TAG, c, h)
    if c.device != dev or h.device != dev:
        raise ValueError(f"{_TAG}: box on {c.device}/{h.device}, "
                         f"expected {dev}")
    return torch.cat([c.reshape(3), h.reshape(3)]).to(torch.float32)


def _check_order(m: int) -> None:
    if not 2 <= m <= MAX_ORDER:
        raise ValueError(f"{_TAG}: order m={m} outside the kernels' "
                         f"range [2, {MAX_ORDER}]")


@functools.lru_cache(maxsize=None)
def node_table(m: int, device) -> torch.Tensor:
    """T_j(t_k) of order m, t_k = cos(pi (k + 1/2) / m), as the run kernels
    and K2 read it: (m, m - 1) float32, [k, j - 1] = T_j(t_k) for j =
    1..m-1, computed in float64 on the host once per (m, device) (murb_tpu's
    proxy_pallas.py:_tj_nodes)."""
    theta = np.pi * (np.arange(m)[:, None] + 0.5) / m
    t = np.cos(theta * np.arange(1, m)[None, :])
    return torch.from_numpy(t.astype(np.float32).ravel()).to(device)


@functools.lru_cache(maxsize=64)
def one_run_items(n: int, chunk: int, device):
    """The ``fmm_kernels.RunItems`` of one run of n bodies in items of
    ``chunk`` bodies: bounds {0, n}, prefix {0, nitems}, built once per
    (n, chunk, device)."""
    from murb_tpu_torch.ops.fmm_kernels import RunItems

    nitems = -(-n // chunk)
    bounds = torch.tensor([0, n], dtype=torch.int64, device=device)
    prefix = torch.tensor([0, nitems], dtype=torch.int64, device=device)
    return RunItems(bounds, prefix, max(nitems, 1), chunk)


@functools.lru_cache(maxsize=64)
def one_run(n: int, m: int, device, sms: int | None = None, chunk: int = 0):
    """K1's one run of n bodies at order m: ``one_run_items`` of ``chunk``
    bodies (0: ``fmm_kernels.p2m_chunk``'s pick for a card of ``sms`` SMs,
    by default the device's), looked up once per (n, m, device, chunk)."""
    from murb_tpu_torch.ops.fmm_kernels import p2m_chunk

    chunk = chunk or p2m_chunk(n, m, cuda.sm_count(device) if sms is None
                               else sms)
    return one_run_items(n, chunk, device)


def p2m_launch(x, y, z, g, box, m: int, chunk: int = 0) -> torch.Tensor:
    """K1 alone on n >= 1 float32 bodies (its bf16 instance on bf16 ones)
    and the (6,) box -> W (m^3,) float32, in items of ``chunk`` bodies (0:
    ``one_run``'s pick): the items' partials through scratch and the fold
    when the run has several items."""
    dev, n = x.device, x.shape[0]
    run = one_run(n, m, dev, chunk=chunk)
    w = torch.empty(m ** 3, dtype=torch.float32, device=dev)
    partial = (torch.empty(run.nitems * m ** 3, dtype=torch.float32,
                           device=dev) if run.nitems > 1 else None)
    with torch.cuda.device(dev):
        cuda.launch(_entry("murb_p2m", x), x.data_ptr(), y.data_ptr(),
                    z.data_ptr(),
                    g.data_ptr(), n, box.data_ptr(), m, run.bounds.data_ptr(),
                    run.prefix.data_ptr(), run.nitems, run.chunk,
                    node_table(m, dev).data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    w.data_ptr(), cuda.stream(dev))
    return w


def p2m_fused(qx, qy, qz, gm_eff, c, h, *, m: int,
              chunk: int = 0) -> torch.Tensor:
    """W (m^3,) = P2M.  CPU tensors run ``p2m_plain``; CUDA tensors launch
    K1 (fp32 inside; float64 inputs are cast here, W cast back; bf16
    inputs take the bf16 instance, W float32) in work items of ``chunk``
    bodies (0: ``fmm_kernels.p2m_chunk``'s pick; else
    ``fmm_kernels.check_p2m_chunk``'s range, on either device; the plain
    version has no items)."""
    if chunk:
        from murb_tpu_torch.ops.fmm_kernels import check_p2m_chunk

        check_p2m_chunk(chunk, m)
    if qx.device.type == "cpu":
        return p2m_plain(qx, qy, qz, gm_eff, c, h, m=m)
    cuda.require_cuda(_TAG, qx)
    _check_order(m)
    dtype, dev, n = qx.dtype, qx.device, qx.shape[0]
    if n == 0:
        return torch.zeros(m ** 3, dtype=weights_dtype(dtype), device=dev)
    b16 = cuda.all_bf16(qx, qy, qz, gm_eff)
    x, y, z, g = cuda.kernel_inputs(_TAG, dev, n, qx, qy, qz, gm_eff,
                                    notify=notify_fp32_compute, bf16=b16)
    w = p2m_launch(x, y, z, g, _box(c, h, dev), m, chunk)
    if b16:
        p2m_fused.bf16_launches += 1
    else:
        p2m_fused.launches += 1
    return w.to(weights_dtype(dtype))


p2m_fused.launches = 0
p2m_fused.bf16_launches = 0


def l2p_bodies(n: int, m: int, sms: int) -> int:
    """K2's bodies a thread for n bodies at order m on a card of ``sms``
    SMs: 2 (blocks of 256 bodies) where that gives every SM at least
    ONE_L2P_BLOCKS_AN_SM blocks and the padded order is at most
    ONE_L2P_MAX_TB_MW, else 1 (blocks of 128: twice the warps for the
    same bodies)."""
    if (m + 3) // 4 * 4 > ONE_L2P_MAX_TB_MW:
        return 1
    per = 2 * ONE_L2P_THREADS
    return 2 if -(-n // per) >= ONE_L2P_BLOCKS_AN_SM * sms else 1


def l2p_blocks(m: int) -> tuple:
    """The bodies a block K2 runs at order m: ONE_L2P_THREADS (1 body a
    thread) and, up to padded order ONE_L2P_MAX_TB_MW, twice that (2)."""
    one = ONE_L2P_THREADS
    return (one, 2 * one) if (m + 3) // 4 * 4 <= ONE_L2P_MAX_TB_MW else (one,)


def check_l2p_block(block: int, m: int) -> None:
    """Raise ValueError unless ``block`` is one of ``l2p_blocks(m)``
    (callers pass 0 for ``l2p_bodies``' pick unchecked)."""
    if block not in l2p_blocks(m):
        raise ValueError(f"{_TAG}: an L2P block of {block} bodies at m={m}; "
                         f"K2 runs blocks of {l2p_blocks(m)} bodies")


def l2p_block_for(block: int, m: int) -> int:
    """K2's block for a solver entry's ``block`` (the bodies a work item of
    the P2M and L2P stages): 0 for 0, else the largest of ``l2p_blocks(m)``
    not above it (so 1024 runs 256-body blocks where the order allows);
    below the smallest, ValueError."""
    if not block:
        return 0
    fits = [b for b in l2p_blocks(m) if b <= block]
    if not fits:
        raise ValueError(f"{_TAG}: block={block} at m={m}; K2 runs blocks "
                         f"of {l2p_blocks(m)} bodies, so the single-cell "
                         f"proxy takes block >= {l2p_blocks(m)[0]}")
    return fits[-1]


def l2p_launch(x, y, z, box, m: int, fields, block: int = 0) -> torch.Tensor:
    """K2 alone on float32 bodies (its bf16 instance on bf16 ones), the (6,)
    box and 1 to 11 float32
    contiguous (m^3,) fields -> (k, n) float32, one launch per group of at
    most 4 fields, in blocks of ``block`` bodies (0: ``l2p_bodies``' pick)."""
    dev, n, k = x.device, x.shape[0], len(fields)
    out = torch.empty((k, n), dtype=torch.float32, device=dev)
    tb = (block // ONE_L2P_THREADS if block
          else l2p_bodies(n, m, cuda.sm_count(dev)))
    with torch.cuda.device(dev):
        cuda.launch(_entry("murb_l2p", x), x.data_ptr(), y.data_ptr(),
                    z.data_ptr(), n, box.data_ptr(), m, tb,
                    node_table(m, dev).data_ptr(),
                    cuda.field_pointers(fields), k, out.data_ptr(),
                    cuda.stream(dev))
    return out


def l2p_fused_multi(qx, qy, qz, c, h, fields, *, m: int,
                    block: int = 0) -> tuple:
    """Interpolate a tuple of 1 to 11 (m^3,) node fields to the bodies ->
    tuple of (n,).  CPU tensors run ``l2p_plain``; CUDA tensors launch K2
    once per group of at most 4 fields, in blocks of ``block`` bodies (0:
    ``l2p_bodies``' pick; else one of ``l2p_blocks(m)``, checked on either
    device; the plain version has no blocks), and count each launch."""
    k = len(fields)
    if not 1 <= k <= MAX_FIELDS:
        raise ValueError(f"{_TAG}: L2P takes 1 to {MAX_FIELDS} node fields, "
                         f"got {k}")
    if block:
        check_l2p_block(block, m)
    if qx.device.type == "cpu":
        return l2p_plain(qx, qy, qz, c, h, fields, m=m)
    cuda.require_cuda(_TAG, qx)
    _check_order(m)
    dtype, dev, n = qx.dtype, qx.device, qx.shape[0]
    b16 = cuda.all_bf16(qx, qy, qz)
    x, y, z = cuda.kernel_inputs(_TAG, dev, n, qx, qy, qz,
                                 notify=notify_fp32_compute, bf16=b16)
    flds = cuda.kernel_inputs(_TAG, dev, m ** 3, *fields,
                              notify=notify_fp32_compute)
    out = l2p_launch(x, y, z, _box(c, h, dev), m, flds, block)
    if b16:
        l2p_fused_multi.bf16_launches += -(-k // _L2P_GROUP)
    else:
        l2p_fused_multi.launches += -(-k // _L2P_GROUP)
    return tuple(o.to(dtype) for o in out)


l2p_fused_multi.launches = 0
l2p_fused_multi.bf16_launches = 0


def l2p_fused(qx, qy, qz, c, h, f_ax, f_ay, f_az, *, m: int,
              block: int = 0) -> torch.Tensor:
    """a (n, 3) = L2P of the three node force fields (``block``: as
    ``l2p_fused_multi``'s)."""
    return torch.stack(l2p_fused_multi(qx, qy, qz, c, h, (f_ax, f_ay, f_az),
                                       m=m, block=block), dim=1)
