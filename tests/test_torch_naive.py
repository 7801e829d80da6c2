"""The port's oracle sweeps (murb_tpu_torch/ops/naive.py) against
murb_tpu's on the same inputs.

Tolerances: fp32 WithinRel 1e-5 with an rms floor of 1e-6 (the two
frameworks sum in different orders); fp64 WithinRel 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu.ops import naive as jn
from murb_tpu_torch.ops import naive as tn

torch.set_num_threads(2)
SOFT = 2.0e8


def inputs(n, scheme, dtype):
    """Seeded positions and G*m as numpy arrays, ghosts included."""
    s = jinit.SCHEMES[scheme](n, 11)
    q = [np.asarray(getattr(s, k)).astype(dtype) for k in ("qx", "qy", "qz")]
    gm = (np.asarray(s.m, np.float64) * G).astype(dtype)
    return q + [gm]


def check(got, ref, eps, floor, msg):
    for c, g, r in zip("xyz", got, ref):
        assert_within_rel(g.numpy(), np.asarray(r), eps,
                          f"{msg} a{c} (WithinRel {eps}, rms floor {floor})",
                          rms_floor=floor)


CASES = [(2048, "random", np.float32, 1e-5, 1e-6),
         (2049, "galaxy", np.float32, 1e-5, 1e-6),
         (2048, "galaxy", np.float64, 1e-12, 0.0),
         (2049, "random", np.float64, 1e-12, 0.0)]


@pytest.mark.parametrize("n,scheme,dtype,eps,floor", CASES)
def test_acc_naive_matches_jax(n, scheme, dtype, eps, floor):
    a = inputs(n, scheme, dtype)
    got = tn.acc_naive(*map(torch.from_numpy, a), SOFT)
    ref = jn.acc_naive(*map(jnp.asarray, a), SOFT)
    assert got.ax.dtype == torch.from_numpy(a[0]).dtype
    check(got, ref, eps, floor, f"acc_naive n={n} {scheme}")


@pytest.mark.parametrize("n,scheme,dtype,eps,floor", CASES)
def test_acc_rect_and_jchunked_match_jax(n, scheme, dtype, eps, floor):
    a = inputs(n, scheme, dtype)
    t, j = list(map(torch.from_numpy, a)), list(map(jnp.asarray, a))
    rows = slice(100, 700)
    got = tn.acc_rect(*(v[rows] for v in t[:3]), *t, SOFT)
    ref = jn.acc_rect(*(v[rows] for v in j[:3]), *j, SOFT)
    check(got, ref, eps, floor, f"acc_rect n={n}")
    got = tn.acc_rect_jchunked(*(v[rows] for v in t[:3]), *t, SOFT,
                               chunk=512)
    ref = jn.acc_rect_jchunked(*(v[rows] for v in j[:3]), *j, SOFT,
                               chunk=512)
    check(got, ref, eps, floor, f"acc_rect_jchunked n={n}")


@pytest.mark.parametrize("chunk", [256, 1000])
def test_acc_chunked_matches_jax(chunk):
    a = inputs(2049, "random", np.float32)
    got = tn.acc_chunked(*map(torch.from_numpy, a), SOFT, chunk=chunk)
    ref = jn.acc_chunked(*map(jnp.asarray, a), SOFT, chunk=256)
    check(got, ref, 1e-5, 1e-6, f"acc_chunked chunk={chunk}")


@pytest.mark.parametrize("npad", [256, 768, 2304, 200192, 200704])
def test_pick_block_and_flops_model_match_jax(npad):
    from murb_tpu.ops import common as jc
    from murb_tpu_torch.ops import common as tc

    for target in (256, 1024, 2048, 4096):
        assert tc.pick_block(npad, target) == jc.pick_block(npad, target)
    assert tc.flops_per_iteration(npad) == jc.flops_per_iteration(npad)


def test_ghosts_and_self_term_contribute_zero():
    a = inputs(2049, "random", np.float64)
    t = list(map(torch.from_numpy, a))
    n = 2049
    full = tn.acc_naive(*t, SOFT)
    real = tn.acc_rect(*(v[:n] for v in t[:3]), *(v[:n] for v in t), SOFT)
    for f, r in zip(full, real):
        assert_within_rel(f[:n].numpy(), r.numpy(), 1e-12,
                          "ghosts add nothing (WithinRel 1e-12)")
