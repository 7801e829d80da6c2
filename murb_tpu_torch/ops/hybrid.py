"""Exact all-pairs sweeps of ``murb_tpu/ops/hybrid.py``: kernels K4 (force
with precision tiers), K5 (multi-row potential) and K6 (K4 and K5 fused),
each beside its plain version.

The TPU kernels split each block between the vector unit and bf16
matrix-unit passes; the port keeps the accuracy contract of each
``passes`` tier, not the TPU mechanism.  K4:

  passes 2 -- fp32-class, <= ~3e-5 max relative force error: K3's fp32
              sweep kernel.
  passes 1 -- the fast tier (``tpu+hybrid+fast``), murb_tpu's "W rounded
              once, one pass" (<= 5.1e-3 on the 4096 galaxy): its own
              kernel, ``csrc/hybrid_fast.cu``.  The weights W =
              rsqrt(d^2)^3 on the CUDA cores, rounded to TF32; the
              j-reduction P = W Q as one TF32 tensor-core pass, Q's
              columns G m_j (r_j - c, 1) split into two TF32 parts; the
              epilogue a_i = P[0:3] - (r_i - c) P[3], c the sources'
              G*m-weighted mean (``fast_center``).  ``acc_hybrid_fast_plain``
              computes the same arithmetic step by step.
  passes 3 -- the extended tier, <= ~1e-6: K3's register-tiled sweep
              with a Newton-refined rsqrt, each run of ``EXT_RUN`` = 4
              sources summed in fp32 and folded into fp64 sums, and K3's j
              split with fp64 slice partials (``ext_split_args``).  The
              tier ``tpu+hybrid`` picks for fp64 state.

On CUDA tensors ``acc_hybrid_rect`` launches ``csrc/hybrid.cu`` at
passes 2/3 (which hands passes 2 to K3's kernel, with K3's j split,
counted here as K4 launches) and ``csrc/hybrid_fast.cu`` at passes 1
(counted apart, in ``acc_hybrid_rect.fast_launches``), in the block
geometry ``block_i``/``block_j``; on CPU tensors it runs
``acc_hybrid_rect_plain``.  A bf16 state launches every tier's bf16
instance (``murb_hybrid_rect_bf16``: K3's for passes 2, the extended
sweep's for passes 3, counted in ``acc_hybrid_rect.bf16_launches``;
``murb_hybrid_fast_bf16`` for passes 1, in ``fast_bf16_launches``).  K5
and K6 launch theirs (``murb_phi_rows_rect_bf16``,
``murb_acc_phi_rows_bf16``, counted in each wrapper's ``bf16_launches``)
when every body array is bf16: the coordinates (and K6's G*m) are read as
they are, and the weight rows are packed float32, as murb_tpu's kernels
take them; the bf16 instances are compiled at the default geometry only
(``PHI_BLOCK_I`` x ``PHI_BLOCK_J``), so a bf16 call at another raises.

K5 ``phi_rows_rect`` (``csrc/phi_rows.cu``) and K6 ``acc_phi_rows_hybrid``
(``csrc/phi.cu``; their shared code ``csrc/phi.cuh``) take
up to 8 source-weight rows (one masked G*m row per galaxy) and return the
potentials phi_r[i] = sum_j w_r[j] * rsqrt(|r_j - r_i|^2 + eps^2), the
j == i term 1/eps included (callers subtract G m_i / eps,
core/metrics.energy_from_phi).  ``passes`` 1 and 2 both keep the fp32-class
contract (the force as K4 passes 2, phi to ~1e-6 relative): the kernels
sum in fp32 on every tier.  Both run K3's register-tiled sweep with R
weight rows (csrc/tile.cuh): 4 targets a thread at every R (2 at block_i
64, ``cuda.sweep_rows``), each source staged once as {x, y, z, G*m} and
one weight record, and K3's j split with their own resident count
(``phi_split_args``).  They are bound by instruction issue and the MUFU
rsqrt (about 15 slots a pair for K6 and 9 for K5 at R = 2, csrc/phi.cuh's
note).  The default geometry is 256 targets a block and 256 sources a
tile at every R (``cuda.PHI_BLOCK_I``, ``PHI_BLOCK_J``): unlike K3, these
sweeps want many resident warps, and K3's 128 x 512 leaves an SM 9
one-warp blocks at R = 2.  At the same block_j and j split K6's force is
K3's bit for bit and K5's rows are K6's.
"""
from __future__ import annotations

import ctypes

import torch

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import (Accel, bf16_plain, notify_fp32_compute,
                                       weights_dtype)
from murb_tpu_torch.ops.mxu import _fp32_matmul, tf32_round, tf32_split
from murb_tpu_torch.ops.naive import _pair_weights
from murb_tpu_torch.ops.tile import acc_tile_rect_plain, split_args
from murb_tpu_torch.utils import trace

#: sources a run of passes 3 sums in fp32 before its fp64 fold
#: (csrc/tile.cuh kExtRun)
EXT_RUN = 4
#: passes 3's default targets a block and sources a tile (csrc/hybrid.cu
#: kExtTargets, kExtSources)
EXT_BLOCK_I = 128
EXT_BLOCK_J = 128
#: passes 1's default targets a block and sources a tile (csrc/hybrid_fast.cu
#: kFastBlockI, kFastBlockJ), floats of a packed chunk of 8 sources
#: (kFastChunk) and the source count the packed array is padded to
#: (kFastPackSources)
FAST_BLOCK_I = 256
FAST_BLOCK_J = 256
FAST_CHUNK_FLOATS = 96
FAST_PACK_SOURCES = 512


def fast_center(qxj, qyj, qzj, gmj) -> torch.Tensor:
    """Passes 1's expansion point: the sources' G*m-weighted mean as a
    float32 (3,) tensor on their device, summed in float64 (0 when the
    masses sum to 0), with no host sync.  The kernel forms the same mean
    itself (csrc/sweep.cuh weighted_center_kernel, float64 sums in its own
    order)."""
    g = gmj.double()
    tot = g.sum()
    den = torch.where(tot != 0, tot, torch.ones_like(tot))
    return (torch.stack([(g * q.double()).sum() for q in (qxj, qyj, qzj)])
            / den).float()


@bf16_plain
def acc_hybrid_fast_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                          center=None, w_round=tf32_round,
                          split: bool = True) -> Accel:
    """Passes 1's arithmetic (csrc/hybrid_fast.cu) step by step, in the
    inputs' dtype: d^2 = dx^2 + (dy^2 + (dz^2 + eps^2)) with dx = x_j -
    x_i, W = rsqrt(d^2)^3 rounded by ``w_round`` (TF32 to nearest, ties
    away: the kernel's), Q = G m_j (r_j - c, 1) split into TF32 big and
    small parts (``split``), P = W Q_big + W Q_small summed in fp32 over
    4096-source chunks, and a = P[0:3] - (r_i - c) P[3].  ``center``
    (3,): c, else ``fast_center`` of the sources.  float64 inputs run
    unrounded: the float64 reference.  ``w_round`` and ``split`` exist for
    the controls that must fail the tier's contract."""
    exact = qxi.dtype == torch.float64
    c = (fast_center(qxj, qyj, qzj, gmj) if center is None
         else torch.as_tensor(center, device=qxi.device)).to(qxi.dtype)
    cols = torch.stack([gmj * (qxj - c[0]), gmj * (qyj - c[1]),
                        gmj * (qzj - c[2]), gmj], 1)
    if exact:
        q_big, q_small = cols, None
    elif split:
        q_big, q_small = tf32_split(cols)
    else:
        q_big, q_small = tf32_round(cols), None
    soft2 = float(soft) ** 2
    p = torch.zeros((qxi.shape[0], 4), dtype=qxi.dtype, device=qxi.device)
    with _fp32_matmul():
        for s in range(0, qxj.shape[0], 4096):
            sl = slice(s, s + 4096)
            dx, dy, dz = (qj[sl][None, :] - qi[:, None]
                          for qi, qj in ((qxi, qxj), (qyi, qyj), (qzi, qzj)))
            inv = torch.rsqrt(dx * dx + (dy * dy + (dz * dz + soft2)))
            w = inv * inv * inv
            if not exact:
                w = w_round(w)
            p += w @ q_big[sl]
            if q_small is not None:
                p += w @ q_small[sl]
    return Accel(*(p[:, k] - (q - c[k]) * p[:, 3]
                   for k, q in enumerate((qxi, qyi, qzi))))


@bf16_plain
def acc_hybrid_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                          passes: int = 1) -> Accel:
    """The plain PyTorch version of each tier: passes 1 the fast tier's
    arithmetic (``acc_hybrid_fast_plain``); passes 2 sums in the inputs'
    dtype (``acc_rect``); passes 3 computes each pair term in the inputs'
    dtype and sums the terms in float64."""
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if passes == 1:
        return acc_hybrid_fast_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft)
    if passes == 2:
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


def ext_split_args(ni: int, nj: int, block_i: int, block_j: int,
                   device: torch.device, entry: str = "murb_hybrid_resident"):
    """Passes 3's j split (``ops/tile.split_args``) at (block_i, block_j),
    0 for ``EXT_BLOCK_I`` x ``EXT_BLOCK_J``: its own resident count (the
    bf16 instance's: ``murb_hybrid_resident_bf16``) and float64 slice
    sums."""
    return split_args(ni, nj, block_i or EXT_BLOCK_I, block_j or EXT_BLOCK_J,
                      device, entry, torch.float64)


def fast_split_args(ni: int, nj: int, block_i: int, block_j: int,
                    device: torch.device,
                    entry: str = "murb_hybrid_fast_resident"):
    """Passes 1's j split (``ops/tile.split_args``) at (block_i, block_j),
    0 for ``FAST_BLOCK_I`` x ``FAST_BLOCK_J``: its own resident count (the
    bf16 instance's: ``murb_hybrid_fast_resident_bf16``) and a float32
    scratch of P's four columns a slice."""
    return split_args(ni, nj, block_i or FAST_BLOCK_I, block_j or FAST_BLOCK_J,
                      device, entry, torch.float32, 4)


def fast_packed(nj: int, device: torch.device) -> torch.Tensor:
    """Scratch for passes 1's packed sources: nj padded to
    ``FAST_PACK_SOURCES``, ``FAST_CHUNK_FLOATS`` floats a chunk of 8."""
    chunks = -(-nj // FAST_PACK_SOURCES) * (FAST_PACK_SOURCES // 8)
    return torch.empty(max(chunks, 1) * FAST_CHUNK_FLOATS,
                       dtype=torch.float32, device=device)


def hybrid_entry(passes: int, bf16: bool) -> tuple[str, str]:
    """(C entry, launch count) of tier ``passes``: passes 1 its own kernel
    (``murb_hybrid_fast``), counted apart from passes 2/3 (K3's kernel and
    the extended sweep, ``murb_hybrid_rect``); a bf16 state the entry's
    bf16 instance."""
    sfx = "_bf16" if bf16 else ""
    if passes == 1:
        return "murb_hybrid_fast" + sfx, "fast" + sfx + "_launches"
    return "murb_hybrid_rect" + sfx, ("bf16_launches" if bf16
                                      else "launches")


def acc_hybrid_rect(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                    passes: int = 1, block_i: int = 0,
                    block_j: int = 0) -> Accel:
    """Accelerations of the i-set due to the j-set at tier ``passes``.

    CPU tensors run the plain version; CUDA tensors launch K4 (fp32 inputs
    inside; float64 inputs are cast here and the outputs cast back)."""
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    tag = f"tpu+hybrid/p{passes}"
    cuda.check_blocks(tag, block_i, block_j)
    if qxi.device.type == "cpu":
        return acc_hybrid_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj,
                                     soft, passes=passes)
    cuda.require_cuda(tag, qxi)
    cuda.refuse_grad(tag, soft)
    if not float(soft) > 0.0:
        raise ValueError(f"{tag}: the sweep needs a positive softening")
    notify = lambda t, d: notify_fp32_compute(
        t, d, detail=("fp64 state runs the extended tier (fp32 pair "
                      "weights and runs of 4 sources, fp64 sums, ~1e-6 "
                      "relative force error)" if passes == 3 else None))
    dtype, dev = qxi.dtype, qxi.device
    ni, nj = qxi.shape[0], qxj.shape[0]
    with trace.span("exact.prepare"):
        b16 = cuda.all_bf16(qxi, qyi, qzi, qxj, qyj, qzj, gmj)
        xi, yi, zi = cuda.kernel_inputs(tag, dev, ni, qxi, qyi, qzi,
                                        notify=notify, bf16=b16)
        xj, yj, zj, gj = cuda.kernel_inputs(tag, dev, nj, qxj, qyj, qzj, gmj,
                                            notify=notify, bf16=b16)
        out = torch.empty((3, ni), dtype=torch.float32, device=dev)
        sfx = "_bf16" if b16 else ""
        entry, count = hybrid_entry(passes, b16)
        soft2 = ctypes.c_float(float(soft) ** 2)
        outs = (out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                cuda.stream(dev))
        if passes == 1:
            center = torch.empty(3, dtype=torch.float32, device=dev)
            packed = fast_packed(nj, dev)
            split, _scratch = fast_split_args(
                ni, nj, block_i, block_j, dev,
                "murb_hybrid_fast_resident" + sfx)
            args = (center.data_ptr(), soft2, block_i, block_j, *split,
                    packed.data_ptr(), *outs)
        else:
            if b16:
                xj, yj, zj, gj = cuda.aligned4(xj, yj, zj, gj)
            split, _scratch = (
                ext_split_args(ni, nj, block_i, block_j, dev,
                               "murb_hybrid_resident" + sfx)
                if passes == 3 else
                split_args(ni, nj, block_i, block_j, dev,
                           "murb_tile_resident" + sfx))
            args = (soft2, passes, block_i, block_j, *split, *outs)
    with trace.span("exact.sweep"), torch.cuda.device(dev):
        cuda.launch(entry, xi.data_ptr(), yi.data_ptr(), zi.data_ptr(), ni,
                    xj.data_ptr(), yj.data_ptr(), zj.data_ptr(),
                    gj.data_ptr(), nj, *args)
    setattr(acc_hybrid_rect, count, getattr(acc_hybrid_rect, count) + 1)
    return Accel(*(o.to(dtype) for o in out))


acc_hybrid_rect.launches = 0
acc_hybrid_rect.bf16_launches = 0
acc_hybrid_rect.fast_launches = 0
acc_hybrid_rect.fast_bf16_launches = 0


def acc_hybrid(qx, qy, qz, gm, soft, *, passes: int = 1, block_i: int = 0,
               block_j: int = 0) -> Accel:
    """Square all-pairs case (the single-device exact engine)."""
    return acc_hybrid_rect(qx, qy, qz, qx, qy, qz, gm, soft, passes=passes,
                           block_i=block_i, block_j=block_j)


# ------------------------------------------------- multi-row potential sweep
MAX_PHI_ROWS = 8  # csrc/tile.cuh kMaxPhiRows


def _check_rows(tag: str, gm_rows, nj: int, passes: int) -> None:
    if passes not in (1, 2):
        raise ValueError(f"{tag}: passes must be 1 or 2, got {passes}")
    if gm_rows.dim() != 2 or not 1 <= gm_rows.shape[0] <= MAX_PHI_ROWS \
            or gm_rows.shape[1] != nj:
        raise ValueError(f"{tag}: gm_rows shape {tuple(gm_rows.shape)}, "
                         f"expected (R <= {MAX_PHI_ROWS}, {nj})")


@bf16_plain(round_outputs=False)
def phi_rows_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gm_rows,
                        soft) -> torch.Tensor:
    """The plain PyTorch K5: (R, ni) potentials in the inputs' dtype,
    j-chunked to bound memory."""
    soft2 = float(soft) ** 2
    out = torch.zeros((gm_rows.shape[0], qxi.shape[0]), dtype=qxi.dtype,
                      device=qxi.device)
    for s in range(0, qxj.shape[0], 4096):
        sl = slice(s, s + 4096)
        d2 = sum((qj[sl][None, :] - qi[:, None]) ** 2
                 for qi, qj in ((qxi, qxj), (qyi, qyj), (qzi, qzj)))
        out += gm_rows[:, sl].to(qxi.dtype) @ torch.rsqrt(d2 + soft2).T
    return out


def phi_bf16_geometry(tag: str, block_i: int, block_j: int) -> None:
    """Refuse a geometry K5's and K6's bf16 instances are not compiled for
    (csrc/phi.cuh: the default, ``cuda.PHI_BLOCK_I`` x ``PHI_BLOCK_J``)."""
    if (block_i or cuda.PHI_BLOCK_I, block_j or cuda.PHI_BLOCK_J) != (
            cuda.PHI_BLOCK_I, cuda.PHI_BLOCK_J):
        raise ValueError(
            f"{tag}: the bf16 instance is compiled at {cuda.PHI_BLOCK_I}x"
            f"{cuda.PHI_BLOCK_J} only, not {block_i}x{block_j}")


def phi_weight_rows(tag: str, dev: torch.device, nj: int,
                    gm_rows) -> torch.Tensor:
    """The (R, nj) float32 weight rows that both instances of K5 and K6
    read (murb_tpu's kernels take them float32): one packed copy, bf16
    rows widened exactly, float64 ones cast (announced)."""
    return torch.stack(cuda.kernel_inputs(
        tag, dev, nj, *gm_rows, notify=notify_fp32_compute,
        bf16=True)).to(torch.float32)


def phi_split_args(ni: int, nj: int, nr: int, force: bool, block_i: int,
                   block_j: int, device: torch.device, bf16: bool = False):
    """K5's (``force`` False) or K6's geometry and j split on ``device``:
    ``((block_i, block_j, slices, tiles_per_slice, scratch pointer or
    None), scratch)``, the geometry resolved from its defaults, the split
    from the kernel's own resident blocks at ``nr`` rows (its bf16
    instance's with ``bf16``), and the scratch a fresh (slices, 3 + nr or
    nr, ni) float32 tensor (None for one slice) that the caller keeps until
    the launch is enqueued."""
    bi = block_i or cuda.PHI_BLOCK_I
    bj = block_j or cuda.PHI_BLOCK_J
    entry = "murb_phi_resident" + ("_bf16" if bf16 else "")
    slices, per = cuda.tile_split(
        ni, nj, cuda.sm_count(device),
        cuda.resident(entry, device, bi, bj, nr, int(force)), bi, bj)
    scratch = (torch.empty((slices, (3 if force else 0) + nr, ni),
                           dtype=torch.float32, device=device)
               if slices > 1 else None)
    return (bi, bj, slices, per,
            None if scratch is None else scratch.data_ptr()), scratch


def phi_rows_rect(qxi, qyi, qzi, qxj, qyj, qzj, gm_rows, soft, *,
                  passes: int = 2, block_i: int = 0,
                  block_j: int = 0) -> torch.Tensor:
    """(R, ni) potentials of the i-set under R <= 8 source-weight rows
    ``gm_rows`` (R, nj), which already include G.

    CPU tensors run the plain version; CUDA tensors launch K5 (fp32 inside;
    float64 inputs are cast here and phi cast back) at ``block_i`` targets
    a block and ``block_j`` sources a tile (0: the defaults)."""
    tag = f"phi_rows/p{passes}"
    ni, nj = qxi.shape[0], qxj.shape[0]
    _check_rows(tag, gm_rows, nj, passes)
    cuda.check_blocks(tag, block_i, block_j)
    if qxi.device.type == "cpu":
        return phi_rows_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gm_rows,
                                   soft)
    cuda.require_cuda(tag, qxi)
    cuda.refuse_grad(tag, soft)
    if not float(soft) > 0.0:
        raise ValueError(f"{tag}: the sweep needs a positive softening")
    dtype, dev = qxi.dtype, qxi.device
    b16 = cuda.all_bf16(qxi, qyi, qzi, qxj, qyj, qzj)
    if b16:
        phi_bf16_geometry(tag, block_i, block_j)
    xi, yi, zi = cuda.kernel_inputs(tag, dev, ni, qxi, qyi, qzi,
                                    notify=notify_fp32_compute, bf16=b16)
    xj, yj, zj = cuda.kernel_inputs(tag, dev, nj, qxj, qyj, qzj,
                                    notify=notify_fp32_compute, bf16=b16)
    if b16:
        xj, yj, zj = cuda.aligned4(xj, yj, zj)
    rows = phi_weight_rows(tag, dev, nj, gm_rows)
    nr = rows.shape[0]
    phi = torch.empty((nr, ni), dtype=torch.float32, device=dev)
    split, _scratch = phi_split_args(ni, nj, nr, False, block_i, block_j,
                                     dev, b16)
    with torch.cuda.device(dev):
        cuda.launch("murb_phi_rows_rect" + ("_bf16" if b16 else ""),
                    xi.data_ptr(), yi.data_ptr(), zi.data_ptr(), ni,
                    xj.data_ptr(), yj.data_ptr(), zj.data_ptr(), nj,
                    rows.data_ptr(), nr, ctypes.c_float(float(soft) ** 2),
                    *split, phi.data_ptr(), cuda.stream(dev))
    if b16:
        phi_rows_rect.bf16_launches += 1
    else:
        phi_rows_rect.launches += 1
    return phi.to(weights_dtype(dtype))  # float32 for bf16, as murb_tpu's


phi_rows_rect.launches = 0
phi_rows_rect.bf16_launches = 0


def phi_rows(qx, qy, qz, gm_rows, soft, *, passes: int = 2,
             block_i: int = 0, block_j: int = 0) -> torch.Tensor:
    """Square all-pairs multi-row potential sweep."""
    return phi_rows_rect(qx, qy, qz, qx, qy, qz, gm_rows, soft,
                         passes=passes, block_i=block_i, block_j=block_j)


# ------------------------------------- fused force + multi-row potential
@bf16_plain
def acc_phi_rows_plain(qx, qy, qz, gm, gm_rows, soft):
    """The plain PyTorch K6, in the inputs' dtype: the force sweep and the
    potential rows, each as its own plain sweep."""
    return (acc_tile_rect_plain(qx, qy, qz, qx, qy, qz, gm, soft),
            phi_rows_rect_plain(qx, qy, qz, qx, qy, qz, gm_rows, soft))


def acc_phi_rows_hybrid(qx, qy, qz, gm, gm_rows, soft, *, passes: int = 2,
                        block_i: int = 0, block_j: int = 0):
    """(Accel, phi (R, n)): forces from the full ``gm`` and up to 8
    source-weight-row potentials in one all-pairs sweep (the fused exact
    tracked step).

    CPU tensors run the plain version; CUDA tensors launch K6 (fp32 inside;
    float64 inputs are cast here and the outputs cast back) at ``block_i``
    targets a block and ``block_j`` sources a tile (0: the defaults)."""
    tag = f"tpu+hybrid+phi/p{passes}"
    n = qx.shape[0]
    _check_rows(tag, gm_rows, n, passes)
    cuda.check_blocks(tag, block_i, block_j)
    if qx.device.type == "cpu":
        return acc_phi_rows_plain(qx, qy, qz, gm, gm_rows, soft)
    cuda.require_cuda(tag, qx)
    cuda.refuse_grad(tag, soft)
    if not float(soft) > 0.0:
        raise ValueError(f"{tag}: the sweep needs a positive softening")
    dtype, dev = qx.dtype, qx.device
    b16 = cuda.all_bf16(qx, qy, qz, gm)
    if b16:
        phi_bf16_geometry(tag, block_i, block_j)
    x, y, z, g = cuda.kernel_inputs(tag, dev, n, qx, qy, qz, gm,
                                    notify=notify_fp32_compute, bf16=b16)
    if b16:
        x, y, z, g = cuda.aligned4(x, y, z, g)
    rows = phi_weight_rows(tag, dev, n, gm_rows)
    nr = rows.shape[0]
    out = torch.empty((3 + nr, n), dtype=torch.float32, device=dev)
    split, _scratch = phi_split_args(n, n, nr, True, block_i, block_j, dev,
                                     b16)
    with torch.cuda.device(dev):
        cuda.launch("murb_acc_phi_rows" + ("_bf16" if b16 else ""),
                    x.data_ptr(), y.data_ptr(), z.data_ptr(), g.data_ptr(),
                    n, rows.data_ptr(), nr, ctypes.c_float(float(soft) ** 2),
                    *split, out[0].data_ptr(), out[1].data_ptr(),
                    out[2].data_ptr(), out[3:].data_ptr(), cuda.stream(dev))
    if b16:
        acc_phi_rows_hybrid.bf16_launches += 1
    else:
        acc_phi_rows_hybrid.launches += 1
    out = out.to(dtype)
    return Accel(out[0], out[1], out[2]), out[3:]


acc_phi_rows_hybrid.launches = 0
acc_phi_rows_hybrid.bf16_launches = 0
