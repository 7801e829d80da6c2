"""Sweeps, the proxy solver, order validation and the CUDA kernel wrappers.

``make_acc_fn`` resolves an acceleration sweep by name for the engines
that wrap any kernel (tracking, leapfrog, KDK, the CLI's ``--kernel``);
port of ``murb_tpu/ops/__init__.py``.  Signature of what it returns:
``fn(qx, qy, qz, gm, soft) -> Accel``.
"""
from __future__ import annotations

from functools import partial


def acc_auto(qx, qy, qz, gm, soft):
    """The best exact sweep for the tensors' device: K4 at passes 2
    (fp32-class) on CUDA tensors, the i-chunked plain sweep on CPU tensors
    (murb_tpu picks the Pallas hybrid on the TPU, chunked elsewhere)."""
    if qx.device.type == "cuda":
        from murb_tpu_torch.ops.hybrid import acc_hybrid

        return acc_hybrid(qx, qy, qz, gm, soft, passes=2)
    from murb_tpu_torch.ops.naive import acc_chunked

    return acc_chunked(qx, qy, qz, gm, soft)


def make_acc_fn(name: str = "auto", *, block_i: int = 0, block_j: int = 0,
                chunk: int = 1024, m: int = 16, levels: int = 2,
                passes: int = 2, plan=None):
    """Resolve an acceleration kernel by name.

    auto     -- ``acc_auto``: K4 passes 2 on CUDA tensors, chunked on CPU
    naive    -- full-broadcast oracle (O(N^2) memory)
    chunked  -- i-chunked plain sweep, ``chunk`` targets at a time
    tile     -- the exact fp32 sweep (K3)
    hybrid   -- the tiered exact sweep (K4) at ``passes``
    mxu      -- the norm-expansion sweep (K13)
    proxy    -- the Chebyshev proxy at order ``m`` (caller owns validity)
    fmm      -- the L-level hierarchy at (``m``, ``levels``), K7-K9
    adaptive -- the occupied-cell sparse hierarchy with the exact P2P near
                field, K10-K12 (``plan``: ops/sparse_fmm.SparsePlan)

    ``block_i``/``block_j`` set the geometry of tile, hybrid and mxu (0:
    the kernel's default)."""
    if name == "auto":
        return acc_auto
    if name == "naive":
        from murb_tpu_torch.ops.naive import acc_naive

        return acc_naive
    if name == "chunked":
        from murb_tpu_torch.ops.naive import acc_chunked

        return partial(acc_chunked, chunk=chunk)
    if name == "tile":
        from murb_tpu_torch.ops.tile import acc_tile

        return partial(acc_tile, block_i=block_i, block_j=block_j)
    if name == "hybrid":
        from murb_tpu_torch.ops.hybrid import acc_hybrid

        return partial(acc_hybrid, block_i=block_i, block_j=block_j,
                       passes=passes)
    if name == "mxu":
        from murb_tpu_torch.ops.mxu import acc_mxu

        return partial(acc_mxu, block_i=block_i, block_j=block_j)
    if name == "proxy":
        from murb_tpu_torch.ops.proxy import acc_proxy

        return partial(acc_proxy, m=m)
    if name == "fmm":
        from murb_tpu_torch.ops.fmm import acc_fmm

        return partial(acc_fmm, m=m, levels=levels)
    if name == "adaptive":
        from murb_tpu_torch.ops.sparse_fmm import acc_adaptive

        if plan is None:
            raise ValueError("kernel 'adaptive' needs a SparsePlan "
                             "(ops/sparse_fmm.plan_adaptive)")
        return partial(acc_adaptive, plan=plan)
    raise ValueError(f"unknown kernel {name!r} "
                     "(auto, naive, chunked, tile, hybrid, mxu, proxy, fmm, "
                     "adaptive)")
