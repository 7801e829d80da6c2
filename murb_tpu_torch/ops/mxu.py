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
launches ``csrc/mxu.cu`` (K13, which replaces ``mxu._mxu_kernel``): S and
P are TF32 tensor-core products (``mma.sync`` m16n8k8).  On CPU tensors it
runs ``acc_mxu_rect_plain``, the same function at the same tier.

The tiers keep murb_tpu's contracts (``precision`` governs P,
``s_precision`` S; the engines pass ``precision`` only, so S runs at
"highest"), met in TF32.  A value x is split into big = tf32(x) and small =
tf32(x - big) (``tf32_split``: round to nearest, ties away from zero, as
``cvt.rna.tf32.f32``), so that big + small carries x to 2^-22:

  * P at "high" (the default) and "highest": 3xTF32-class, two products,
    W_big Q + W_small Q, where Q's eight columns are G m_j (x, y, z, 1)
    split into big and small (so big*small of A comes free; W_small = W -
    W_big is exact in fp32 and the tensor core reads it as TF32, its 13
    low bits truncated, ``tf32_trunc``): fp32-class, which murb_tpu's
    HIGHEST is;
  * P at "default": one product, W_big Q: W rounded to TF32 (10 mantissa
    bits against the bf16 pass's 7 in murb_tpu's "default", ~0.4% force
    error); the rounding of W scales whole pair terms, so the epilogue's
    cancellation does not amplify it;
  * S at every ``s_precision``: two products, every big*big, big*small,
    small*big and small*small term of the expansion (|cq|^2 and |cq_i|^2 +
    eps^2 split too: they are the large terms whose rounding close pairs
    cancel against).  One product on S stays within WithinRel 5e-4 on the
    galaxy but misses it 3 to 4 times over on the random box (the CPU
    study in tests/test_torch_mxu.py; chip_smoke.py phase 10 reads the
    200k galaxy), so "default" maps to two as well (``tier_passes``).

G m_j is folded into Q (the columns G m_j x_j, ..., G m_j) instead of W,
which saves one multiply a pair.  Only float64 inputs on the CPU run
unrounded, the float64 reference (the tests' and chip_smoke's); fp32
inputs run the tier's TF32 arithmetic on either device.  The plain version
rounds its operands explicitly and runs its products at torch's "highest"
float32 matmul precision, whatever ``allow_tf32`` says, so it and the
kernel differ only in the order and rounding of their fp32 sums (and the
card's rsqrt).  ``block_i`` / ``block_j`` pick one of K13's compiled
geometries (0 each: ``MXU_BLOCK_I`` targets a block, ``MXU_BLOCK_J``
sources a tile; ops/cuda.check_blocks); the plain version ignores them.
"""
from __future__ import annotations

import contextlib

import torch

from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import Accel, bf16_plain, notify_fp32_compute

TAG = "tpu+mxu"
PRECISIONS = ("default", "high", "highest")
#: TF32 products on P by ``precision`` (S takes two at every tier)
_P_PASSES = {"default": 1, "high": 2, "highest": 2}

#: K13's default targets a block and sources a staged tile (csrc/mxu.cu
#: kMxuBlockI, kMxuBlockJ): the fastest of the geometries
#: scripts/torch_kernel_ab.py times at 200,192^2, at both tiers
MXU_BLOCK_I = 512
MXU_BLOCK_J = 512
#: floats of K13's packed sources a chunk of 8 (csrc/mxu.cu kChunkFloats)
#: and the source count the packed array is padded to (the largest tile)
CHUNK_FLOATS = 192
PACK_SOURCES = 512


def check_precisions(precision: str, s_precision: str = "highest") -> None:
    """Refuse a precision tier murb_tpu does not have."""
    for name, p in (("precision", precision), ("s_precision", s_precision)):
        if p not in PRECISIONS:
            raise ValueError(f"{TAG}: unknown {name} {p!r} "
                             f"({', '.join(PRECISIONS)})")


def tier_passes(precision: str = "high",
                s_precision: str = "highest") -> tuple[int, int]:
    """(TF32 products on S, TF32 products on P) of a tier pair: S two at
    every ``s_precision`` (the module note)."""
    check_precisions(precision, s_precision)
    return 2, _P_PASSES[precision]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero: ``cvt.rna.tf32.f32``.  Adds half a TF32 ulp to the
    magnitude bits and clears the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` as a TF32 operand of the tensor cores reads it: its 13
    low bits ignored (truncated toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small): big = tf32(x), small = tf32(x - big); x - big is exact
    in fp32, and |x - (big + small)| <= 2^-22 |x|."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def split3_matmul(a: torch.Tensor, b: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """``a @ b`` (batched alike) as three products of TF32 operands,
    a_big b_big + a_big b_small + a_small b_big with both sides split by
    ``tf32_split``: about 2^-21 of each term where murb_tpu's bf16x3 (three
    bf16 passes) carries 2^-16.  The lossy M2L tier's arithmetic (K7's
    lossy instance, the sparse M2L's products); a product of two TF32
    values is exact in fp32, so the three run as plain fp32 products.
    float32 operands only.  ``out`` (3-D operands): the products are
    added into it in place (``baddbmm_``) and it is returned."""
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    if out is None:
        return ab @ bb + ab @ bs + as_ @ bb
    for x, y in ((ab, bb), (ab, bs), (as_, bb)):
        out.baddbmm_(x, y)
    return out


@contextlib.contextmanager
def tf32_matmul():
    """float32 products on the tensor cores (TF32) inside, the precision
    restored however the block exits: for operands that are TF32 values
    already (``split3_matmul``'s), where TF32 loses nothing."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


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


def tf32_operands(a_mat, b_mat, gmj):
    """The split operands of K13's products, fp32 (csrc/mxu.cu's packing):

    R (16, nj): the S product's source rows, [x_b, y_b, z_b, x_s, y_s,
      z_s, n_b, 1] then the same with n_s for n_b;
    T (ni, 16): the target rows that meet them, [bx_b, by_b, bz_b, bx_b,
      by_b, bz_b, 1, nB_b] then the same of the small parts;
    Q (nj, 8): the P product's columns, G m_j (x, y, z, 1) big then small.

    T R, summed over all 16 rows, is every term of the norm expansion
    S = |cq_j|^2 + (|cq_i|^2 + eps^2) - 2 cq_i . cq_j with both sides
    split; the products of TF32 values are exact in fp32."""
    (xb, xs), (yb, ys), (zb, zs), (nb, ns) = (tf32_split(a_mat[k])
                                              for k in range(4))
    one = torch.ones_like(xb)
    r = torch.stack([xb, yb, zb, xs, ys, zs, nb, one,
                     xb, yb, zb, xs, ys, zs, ns, one])
    (bxb, bxs), (byb, bys), (bzb, bzs), (nbb, nbs) = (
        tf32_split(b_mat[k]) for k in (0, 1, 2, 4))
    onei = torch.ones_like(bxb)
    t = torch.stack([bxb, byb, bzb, bxb, byb, bzb, onei, nbb,
                     bxs, bys, bzs, bxs, bys, bzs, onei, nbs], 1)
    splits = [tf32_split(c) for c in (gmj * a_mat[0], gmj * a_mat[1],
                                      gmj * a_mat[2], gmj)]
    q = torch.stack([b for b, _ in splits] + [s for _, s in splits], 1)
    return r, t, q


@contextlib.contextmanager
def _fp32_matmul():
    """float32 products in full float32 (no TF32 on a card) inside."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _plain_tf32(a_mat, b_mat, gmj, cqi, s_passes: int, p_passes: int,
                chunk: int, w_round=tf32_round) -> torch.Tensor:
    """K13's arithmetic at (s_passes, p_passes) in fp32, ``chunk`` targets
    at a time: (3, ni).  One pass on S is the first product alone (R's and
    T's first eight rows: no small part of the targets, n_s or nB_s).
    ``w_round`` makes W's TF32 part."""
    r, t, q = tf32_operands(a_mat, b_mat, gmj)
    k = 8 * s_passes
    out = torch.empty((3, b_mat.shape[1]), dtype=torch.float32,
                      device=b_mat.device)
    with _fp32_matmul():
        for s in range(0, b_mat.shape[1], chunk):
            sl = slice(s, s + chunk)
            inv = torch.rsqrt(t[sl, :k] @ r[:k])                # (c, nj)
            w = inv * inv * inv
            wb = w_round(w)
            p = wb @ q                                          # (c, 8)
            if p_passes == 2:     # W - W_b is exact; the card reads it
                p = p + tf32_trunc(w - wb) @ q     # as TF32, truncated
            p = p[:, :4] + p[:, 4:]
            for c in range(3):
                out[c, sl] = p[:, c] - cqi[c][sl] * p[:, 3]
    return out


@bf16_plain
def acc_mxu_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                       precision: str = "high", s_precision: str = "highest",
                       center: bool = True, center_point=None,
                       chunk: int = 1024) -> Accel:
    """The plain PyTorch K13, ``chunk`` targets at a time.

    fp32 inputs (on either device) run the tier's TF32 arithmetic (the
    module note); float64 inputs run the unrounded sweep in float64 (S =
    A^T B, W = gm rsqrt(S)^3, P = A W), the reference."""
    s_passes, p_passes = tier_passes(precision, s_precision)
    return _acc_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, s_passes,
                      p_passes, center=center, center_point=center_point,
                      chunk=chunk)


def _acc_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, s_passes: int,
               p_passes: int, *, center: bool = True, center_point=None,
               chunk: int = 1024, w_round=tf32_round) -> Accel:
    """``acc_mxu_rect_plain`` at explicit pass counts and W rounding (1 on
    S is no tier, nor is a W rounded otherwise than to nearest:
    chip_smoke.py's study of S and its control of the "default" check)."""
    dtype = qxi.dtype
    a_mat, b_mat, cqi = _operands(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft,
                                  center, center_point)
    if dtype == torch.float64:
        out = torch.empty((3, qxi.shape[0]), dtype=dtype, device=qxi.device)
        for s in range(0, qxi.shape[0], chunk):
            sl = slice(s, s + chunk)
            inv = torch.rsqrt(a_mat.T @ b_mat[:, sl])              # (nj, c)
            p = a_mat @ (gmj[:, None] * (inv * inv * inv))          # (8, c)
            for c in range(3):
                out[c, sl] = p[c] - cqi[c][sl] * p[4]
        return Accel(out[0], out[1], out[2])
    f32 = lambda v: v.to(torch.float32)
    out = _plain_tf32(f32(a_mat), f32(b_mat), f32(gmj), [f32(c) for c in cqi],
                      s_passes, p_passes, chunk, w_round)
    return Accel(*(o.to(dtype) for o in out))


def acc_mxu_rect(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                 block_i: int = 0, block_j: int = 0,
                 precision: str = "high", s_precision: str = "highest",
                 center: bool = True, center_point=None) -> Accel:
    """Accelerations of the i-set due to the j-set by the norm expansion.

    ``center_point`` (cx, cy, cz) overrides the centre computed from the
    j-set, so that shards of one system agree.  CPU tensors run the plain
    version; CUDA tensors launch K13 at the tier (fp32 inside; float64
    inputs are cast here, announced once, and the outputs cast back).
    Where the target blocks cannot fill the card, the j range is split
    into slices of whole tiles (ops/cuda.tile_split, K13's own resident
    blocks) and the kernel folds the slices' P in order before its
    epilogue."""
    _, p_passes = tier_passes(precision, s_precision)  # S: two, always
    cuda.check_blocks(TAG, block_i, block_j)
    if qxi.device.type == "cpu":
        return acc_mxu_rect_plain(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft,
                                  precision=precision,
                                  s_precision=s_precision, center=center,
                                  center_point=center_point)
    cuda.require_cuda(TAG, qxi)
    cuda.refuse_grad(TAG, soft,
                     *(() if center_point is None else center_point))
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
    bi, bj = block_i or MXU_BLOCK_I, block_j or MXU_BLOCK_J
    slices, per = cuda.tile_split(ni, nj, cuda.sm_count(dev),
                                  cuda.resident("murb_mxu_resident", dev, bi,
                                                bj), bi, bj)
    chunks = -(-nj // PACK_SOURCES) * PACK_SOURCES // 8
    packed = torch.empty(chunks * CHUNK_FLOATS, dtype=torch.float32,
                         device=dev)
    scratch = (torch.empty((slices, 4, ni), dtype=torch.float32, device=dev)
               if slices > 1 else None)
    out = torch.empty((3, ni), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cuda.launch("murb_mxu_rect", a_mat.data_ptr(), gj.data_ptr(), nj,
                    b_mat.data_ptr(), cqi[0].data_ptr(), cqi[1].data_ptr(),
                    cqi[2].data_ptr(), ni, bi, bj, p_passes, slices, per,
                    packed.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
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
