"""The adaptive hierarchy's kernels (K10 near field, K11 windowed P2M, K12
windowed L2P) on a bf16 state against murb_tpu, on the CPU, and three
repairs: ``shard+uneven``'s bytes, and the sparse M2L's fused lossy form
against murb_tpu's.

On CPU tensors the wrappers run their plain versions, which upcast bf16 to
fp32 (exact), compute as for fp32 and round the outputs where murb_tpu's
kernels cast them back (``ops/common.bf16_plain``; K11's W stays float32).
On the card the bf16 instances (``murb_p2p_sorted_bf16``,
``murb_p2m_window_bf16``, ``murb_l2p_window_bf16``) read the bf16 arrays
and give their fp32 instances' bits on the arrays upcast
(chip_smoke.py phase 15).

Tolerances: each kernel at the K8/K9 tolerances of tests/test_torch_bf16.py
against murb_tpu's stages on the bf16 inputs upcast, which is what its
Pallas kernels compute (WithinRel 1e-2: W with an rms floor of 1e-4, the
fields and the near field 1e-3); the whole ``acc_adaptive`` at WithinRel
1e-2, rms floor 1e-2, against murb_tpu's on the upcast state (the port
rounds the far field, the near field and their sum each to bf16), and at
2e-2 / 2e-2 against murb_tpu's own bf16 path (test_torch_bf16.py's
``acc_proxy`` tolerance), whose distance from float64 (2.5e-2) is six
times the port's (4.0e-3): murb_tpu finds a bf16 state's cells in bf16
arithmetic, the port from the values upcast (ops/fmm_kernels.cell_box).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu.ops import p2p as jp
from murb_tpu.ops import sparse_fmm as js
from murb_tpu.ops.naive import acc_naive
from murb_tpu_torch.ops import anterp_kernels as tak
from murb_tpu_torch.ops import p2p as tp
from murb_tpu_torch.ops import p2p_kernels as tk
from murb_tpu_torch.ops import sparse_fmm as ts
from murb_tpu_torch.ops.p2p import _cell_ixyz
from test_torch_p2p import bodies, cubic_box
from test_torch_sparse_fmm import (clusters, force_stat, port_plan,
                                   window_case)

torch.set_num_threads(2)
SOFT = 0.01
BF16 = torch.bfloat16


def to_bf16(j, t):
    """(JAX arrays rounded to bf16 and upcast to fp32, the port's bf16
    tensors of the same values)."""
    jb = tuple(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32) for a in j)
    return jb, tuple(v.to(BF16) for v in t)


def f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, np.float64)


def test_near_field_bf16_matches_murb_tpu():
    """K10's plain version on the bf16 two clusters, force and potential,
    against murb_tpu's sweep on the state upcast; the pair count equal."""
    j, t, q = bodies("clusters")
    jb, tb = to_bf16(j, t)
    (jc, jh), (tc, th) = cubic_box(jb, tuple(v.float() for v in tb))
    pmax = tp.size_pmax(jp.estimate_brick_pairs(q, 4096, 3))
    racc, rphi, rnp = jp.p2p_sweep(*jb, jc, jh, SOFT, C=8, pmax=pmax,
                                   with_phi=True)
    acc, phi, n_pairs = tk.acc_p2p(*tb, tc, th, SOFT, C=8, pmax=pmax,
                                   with_phi=True)
    assert int(n_pairs) == int(rnp)
    assert acc.ax.dtype == BF16 and phi.dtype == BF16
    for k, a in enumerate(acc):
        assert_within_rel(f64(a), f64(racc[:, k]), 1e-2, f"bf16 K10 {k}",
                          rms_floor=1e-3)
    assert_within_rel(f64(phi), f64(rphi), 1e-2, "bf16 K10 phi",
                      rms_floor=1e-3)


def test_window_kernels_bf16_match_murb_tpu():
    """K11's W (float32, as murb_tpu's kernel returns it) and K12's fields
    (bf16) on the bf16 sorted bodies, against murb_tpu's window forms on
    the bodies upcast, rows [0, cap)."""
    n, m, C, cap = 2048, 6, 16, 300
    (jx, c, h, slots), (tx, tc, th, tslots, _) = window_case(7, n, C, cap)
    jb, tb = to_bf16(jx, tx)
    # the cells of the rounded positions, as murb_tpu's forms find them
    ci = _cell_ixyz(*(v.float() for v in tb[:3]), tc, th, C)
    w = tak.p2m_window(*tb, tc, th, tslots, cap, m=m, C=C, ci=ci)
    assert w.dtype == torch.float32
    wj = js.p2m_window(*jb, c, h, slots, cap, m=m, C=C, chunk=256)
    assert_within_rel(f64(w[:cap]), f64(wj[:cap]), 1e-2, "bf16 K11",
                      rms_floor=1e-4)
    rng = np.random.default_rng(8)
    fields = [rng.normal(size=(cap + 1, m ** 3)).astype(np.float32)
              for _ in range(3)]
    for f in fields:
        f[cap] = 0.0
    got = tak.l2p_window(*tb[:3], tc, th, tslots,
                         tuple(torch.from_numpy(f) for f in fields), m=m,
                         C=C, ci=ci)
    ref = js.l2p_window(*jb[:3], c, h, slots,
                        tuple(jnp.asarray(f) for f in fields), m=m, C=C,
                        chunk=256)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == BF16
        assert_within_rel(f64(a), f64(b), 1e-2, f"bf16 K12 field {k}",
                          rms_floor=1e-3)


def test_acc_adaptive_bf16_matches_murb_tpu():
    """The adaptive solve (K11, the sparse M2L, K12, K10, the heavy
    corrections) on the bf16 two clusters, the plan both packages' own,
    against murb_tpu's on the upcast state and its bf16 path, and each
    against float64."""
    j, t, q = clusters(1000, 1024)
    jb, tb = to_bf16(j, t)
    jplan = js.plan_adaptive(q, 1024, 6, 2, 4)
    got = ts.acc_adaptive(*tb, SOFT, port_plan(jplan))
    assert got[0].dtype == BF16
    g = [f64(v) for v in got]
    ref32 = js.acc_adaptive(*jb, SOFT, jplan)
    refb = js.acc_adaptive(*(a.astype(jnp.bfloat16) for a in jb), SOFT,
                           jplan)
    for k in range(3):
        assert_within_rel(g[k], f64(ref32[k]), 1e-2,
                          f"bf16 acc_adaptive {k} vs fp32", rms_floor=1e-2)
        assert_within_rel(g[k], f64(refb[k]), 2e-2,
                          f"bf16 acc_adaptive {k} vs bf16", rms_floor=2e-2)
    exact = acc_naive(*(a.astype(jnp.float64) for a in jb), SOFT)
    e_port = force_stat(g, exact, j[3])
    e_murb = force_stat([f64(v) for v in refb], exact, j[3])
    assert e_port <= 1e-2 and e_port <= e_murb, (e_port, e_murb)


def test_window_wrappers_take_the_bf16_instances():
    """A bf16 state names the bf16 entries; anything else the fp32 ones
    (the kernels' own launches run only on the card)."""
    x = torch.zeros(4, dtype=BF16)
    assert tak._entry("murb_p2m_window", x) == "murb_p2m_window_bf16"
    assert tak._entry("murb_l2p_window", x.float()) == "murb_l2p_window"
    for k in ("murb_p2p_sorted_bf16", "murb_p2m_window_bf16",
              "murb_l2p_window_bf16"):
        assert k in tak.cuda._SIGNATURES
    for fn in (tak.p2m_window, tak.l2p_window, tk.p2p_sweep_kernel_sorted):
        assert fn.bf16_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shard_uneven_counts_the_state_once(dtype):
    """``shard+uneven`` keeps the whole state on each shard; its banner
    figure is the state's bytes once, murb_tpu's (its engine reports its
    global state's), not the D replicas'."""
    from murb_tpu_torch.core import init as tinit
    from murb_tpu_torch.models import create_engine

    st = tinit.init_galaxy(1000, 3, dtype=dtype, device="cpu")
    e = create_engine("shard+uneven", st, soft=2e8, dt=3600.0, shards=4)
    assert e.n_shards == 4
    assert e.allocated_bytes == st.allocated_bytes
    e.run(1)
    assert e.allocated_bytes == st.allocated_bytes
    assert create_engine("shard+allgather", st, soft=2e8, dt=3600.0,
                         shards=4).allocated_bytes == st.allocated_bytes


def _bf16x3_dot_general(orig):
    """``jax.lax.dot_general`` with murb_tpu's bf16x3 tier
    (``Precision.HIGH``) computed as a TPU computes it: both operands split
    into bf16 big and small parts, big*big + big*small + small*big, exact
    products summed in fp32.  XLA's CPU backend ignores the precision, so
    murb_tpu's own CPU run would read its fp32 form."""
    def dot(lhs, rhs, dimension_numbers, precision=None,
            preferred_element_type=None, **kw):
        p = precision[0] if isinstance(precision, tuple) else precision
        if p != jax.lax.Precision.HIGH:
            return orig(lhs, rhs, dimension_numbers, precision=precision,
                        preferred_element_type=preferred_element_type, **kw)

        def split(x):
            x = x.astype(jnp.float32)
            big = x.astype(jnp.bfloat16).astype(jnp.float32)
            return big, (x - big).astype(jnp.bfloat16).astype(jnp.float32)

        (ab, as_), (bb, bs) = split(lhs), split(rhs)
        f = lambda a, b: orig(a, b, dimension_numbers,
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)
        return f(ab, bb) + f(ab, bs) + f(as_, bb)

    return dot


def test_fused_lossy_m2l_within_murb_tpus_bf16x3(monkeypatch):
    """The sparse M2L's fused form at the lossy tier (MURB_M2L_FUSED=1,
    ``--m2l-dots bf16x3``) on tests/test_torch_m2l_tiers.py's random level
    data: the port's (three TF32 products of split operands) against
    float64 within murb_tpu's fused bf16x3 form's distance from float64
    (its own code, its dots at the tier's arithmetic): 5.0e-7 against
    7.9e-6, so the port's form is a divergence kept on purpose (ROADMAP.md
    Queue 3), and murb_tpu's tier is lossier than its fp32 form."""
    C, m = 16, 4
    rng = np.random.default_rng(C)
    codes = np.unique(rng.integers(0, C ** 3, 300)).astype(np.int64)
    cap = len(codes) + 9
    tc = torch.full((cap,), ts._BIG, dtype=torch.int64)
    tc[:len(codes)] = torch.from_numpy(codes)
    w = rng.standard_normal((cap + 1, m ** 3)).astype(np.float32)
    w[len(codes):] = 0.0
    hl = np.array([3.0, 2.5, 4.0], np.float32) / C
    kw = dict(m=m, C=C, with_phi=True)
    ref = ts._m2l_sparse_level_scan(
        torch.from_numpy(w).double(), tc, torch.from_numpy(hl).double(),
        0.05, ts._canon_far(), lossy=False, **kw)
    port = ts._m2l_sparse_level_fused(torch.from_numpy(w), tc,
                                      torch.from_numpy(hl), 0.05,
                                      lossy=True, **kw)
    jargs = (jnp.asarray(w), jnp.asarray(tc.numpy(), jnp.int32),
             jnp.asarray(hl), 0.05)
    fp32 = js._m2l_sparse_level_fused(*jargs, m2l_dots="fp32", **kw)
    monkeypatch.setattr(jax.lax, "dot_general",
                        _bf16x3_dot_general(jax.lax.dot_general))
    murb = js._m2l_sparse_level_fused(*jargs, m2l_dots="bf16x3", **kw)

    def err(fields):
        return max(float(np.abs(f64(a) - f64(r)).max() / np.abs(f64(r)).max())
                   for a, r in zip(fields, ref))

    e_port, e_murb, e_fp32 = err(port), err(murb), err(fp32)
    assert e_port <= e_murb, (e_port, e_murb)
    assert e_fp32 < e_murb, (e_fp32, e_murb)
