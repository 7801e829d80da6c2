"""The port's M2L tiers against murb_tpu's: the dense hierarchy's dot tiers
(ops/fmm.level_sweep; K7's lossy instance, ops/fmm_kernels), the sparse
M2L's tiers, compression, fused form and offsets a batch
(ops/sparse_fmm.m2l_sparse_level), the validation ladders' tier drops
(models/engines.ProxyEngine), and ``--m2l-dots`` through the CLI and the
shard engines, on the CPU.

murb_tpu runs every tier in full fp32 on the CPU (its fused Pallas sweeps
gate out and XLA's CPU dots ignore the precision), except its bf16x3
kernel in interpret mode; the port's plain versions compute each tier's
own arithmetic (the lossy tier: three TF32 products of split operands,
``ops/mxu.split3_matmul``).  Inputs come from numpy with
tests/test_fmm.py's and tests/test_sparse_fmm.py's seeds.

Tolerances: those tests' (acc_fmm against the naive oracle, fp32 1e-4 and
the lossy tiers 1e-3; the mixed composition against the full sweep 2e-3
of max|f|; compression 1e-4 against the exact force, 0 < diff <= 2e-4
against the uncompressed solve; the scan chunk, the fused form and the
mixed tier 1e-5 against the default sweep); the lossy sweep's error
against float64 no larger than murb_tpu's bf16x3 kernel's on the same
input; the port against murb_tpu at the same tier 1e-5 net-relative (the
port's lossy arithmetic adds about 1e-7), except the compressed solve,
1e-4 (see its test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murb_tpu import G
from murb_tpu.core.init import SCHEMES
from murb_tpu.core.state import BodyState as JState
from murb_tpu.models import create_engine as jcreate
from murb_tpu.ops import fmm as jf
from murb_tpu.ops import fmm_pallas as jfp
from murb_tpu.ops import sparse_fmm as js
from murb_tpu.ops.naive import acc_naive, acc_rect
from murb_tpu_torch import cli
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine as tcreate
from murb_tpu_torch.ops import fmm as tf
from murb_tpu_torch.ops import fmm_kernels as tk
from murb_tpu_torch.ops import mxu as tm
from murb_tpu_torch.ops import sparse_fmm as ts

torch.set_num_threads(2)
SOFT, DT = 2.0e8, 3600.0


def force_stat(got, ref, gm=None) -> float:
    """ops/validate's statistic: max per-body vector error over
    max(|a_ref|, 1e-6 max|a_ref|), over the massive bodies."""
    g = np.stack([np.asarray(v, np.float64) for v in got], 1)
    r = np.stack([np.asarray(v, np.float64) for v in ref], 1)
    rn = np.linalg.norm(r, axis=1)
    err = np.linalg.norm(g - r, axis=1) / np.maximum(rn, rn.max() * 1e-6)
    return float(err[np.asarray(gm) > 0].max() if gm is not None
                 else err.max())


def rel(a, b) -> float:
    """max|a - b| over max|b|, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def carry(state) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(state, k))
                                 for k in FIELDS}, state.n, state.padding,
                                "cpu")


# ----------------------------------------------------- the dense tiers
@pytest.fixture(scope="module")
def random_1024():
    """tests/test_fmm.py's tier case: 1024 random bodies, seed 9, and the
    naive oracle's forces."""
    s = SCHEMES["random"](1024, 9)
    gm = jnp.asarray(G, s.qx.dtype) * s.m
    ref = acc_naive(s.qx, s.qy, s.qz, gm, SOFT)
    t = tuple(torch.from_numpy(np.array(v)) for v in (s.qx, s.qy, s.qz, gm))
    return (s.qx, s.qy, s.qz, gm), t, ref, np.asarray(s.m)


@pytest.mark.parametrize("dots,cap", [("fp32", 1e-4), ("mixed", 1e-3),
                                      ("bf16x3", 1e-3)])
def test_acc_fmm_tiers_against_the_oracle(random_1024, dots, cap):
    """Each tier of acc_fmm at m=10, L=2 within tests/test_fmm.py's cap of
    the naive oracle, and within 1e-5 of murb_tpu's acc_fmm at the tier."""
    j, t, ref, m = random_1024
    got = tf.acc_fmm(*t, SOFT, m=10, levels=2, m2l_dots=dots)
    err = force_stat([v.numpy() for v in got], ref, m)
    assert err < cap, f"{dots}: {err:.3e} against the oracle (cap {cap})"
    jgot = jf.acc_fmm(*j, SOFT, m=10, levels=2, m2l_dots=dots)
    gap = force_stat([v.numpy() for v in got], jgot, m)
    assert gap <= 1e-5, f"{dots}: {gap:.3e} from murb_tpu's acc_fmm"


def _level_case():
    """tests/test_fmm.py's composition case: m=4, C=4, seed 11."""
    rng = np.random.default_rng(11)
    hl = np.asarray([1.2e9, 1.0e9, 0.8e9], np.float32)
    w = rng.normal(size=(4 ** 3, 4 ** 3)).astype(np.float32)
    return w, hl


@pytest.mark.parametrize("nf", [3, 4])
def test_lossy_sweep_no_worse_than_murb_tpus_bf16x3_kernel(nf):
    """K7's lossy instance's arithmetic (the plain version at dots
    "bf16x3") against float64 is no worse than murb_tpu's bf16x3 kernel
    (m2l_level_fused(exact_dots=False), interpret mode) on the same input,
    in every subset, and within 1e-5 of max|f| (measured about 7e-7,
    against the bf16x3 kernel's 1e-5)."""
    w, hl = _level_case()
    kw = dict(m=4, C=4, with_phi=nf == 4)
    for subset in ("expand", "near", "far"):
        f64 = tk.m2l_level_plain(torch.from_numpy(w).double(),
                                 torch.from_numpy(hl).double(), SOFT,
                                 subset=subset, **kw)
        lossy = tk.m2l_level_plain(torch.from_numpy(w), torch.from_numpy(hl),
                                   SOFT, subset=subset, dots="bf16x3", **kw)
        ref = jfp.m2l_level_fused(jnp.asarray(w), jnp.asarray(hl), SOFT,
                                  subset=subset, tile=64, interpret=True,
                                  exact_dots=False, **kw)
        ours = max(rel(a, b) for a, b in zip(lossy, f64))
        theirs = max(rel(a, b) for a, b in zip(ref, f64))
        assert ours <= theirs, (subset, ours, theirs)
        assert ours <= 1e-5, (subset, ours)
        # the tier changes the arithmetic: not fp32's sums
        fp32 = tk.m2l_level_plain(torch.from_numpy(w), torch.from_numpy(hl),
                                  SOFT, subset=subset, **kw)
        assert any(not torch.equal(a, b) for a, b in zip(lossy, fp32))


@pytest.mark.parametrize("nf", [3, 4])
def test_mixed_composition_reproduces_the_expand_sweep(nf):
    """The mixed tier's expand sweep (near at fp32 plus far lossy,
    ops/fmm.level_sweep) against the full fp32 expand sweep within 2e-3 of
    max|f| (tests/test_fmm.py:test_fused_mixed_composition), and near plus
    far both at fp32 within 1e-6 (the partition)."""
    w, hl = _level_case()
    wt, ht = torch.from_numpy(w), torch.from_numpy(hl)
    kw = dict(m=4, C=4, with_phi=nf == 4)
    full = tk.m2l_level_plain(wt, ht, SOFT, subset="expand", **kw)
    mixed = tf.level_sweep(wt, ht, SOFT, subset="expand", m2l_dots="mixed",
                           **kw)
    near = tk.m2l_level_plain(wt, ht, SOFT, subset="near", **kw)
    far = tk.m2l_level_plain(wt, ht, SOFT, subset="far", **kw)
    assert len(mixed) == len(full) == nf
    for a, b, c, d in zip(mixed, full, near, far):
        assert rel(a, b) <= 2e-3
        assert rel(c + d, b) <= 1e-6


@pytest.mark.parametrize("tier", ["fp32", "mixed", "bf16x3"])
@pytest.mark.parametrize("finest", ["expand", "far"])
def test_field_grid_routes_each_sweep_as_murb_tpu(monkeypatch, tier,
                                                  finest):
    """Which K7 instance each sweep of fmm_field_grid runs
    (murb_tpu/ops/fmm.py:fused_sweep): under "mixed" an expand sweep is
    near at fp32 plus far lossy, and every other sweep (the subtracted
    near ones, the finest far sweep of the P2P mode) fp32; under "bf16x3"
    every sweep lossy; under "fp32" none."""
    calls = []

    def record(w, hl, soft, *, m, C, subset, with_phi, dots, tile):
        assert tile == 0          # K7's own items unless m2l_tile is given
        calls.append((C, subset, dots))
        z = torch.zeros((C ** 3, m ** 3), dtype=w.dtype)
        return (z,) * (4 if with_phi else 3)

    monkeypatch.setattr(tf, "m2l_level_fused", record)
    tf.fmm_field_grid(torch.zeros((8 ** 3, 8)), torch.ones(3), SOFT, m=2,
                      levels=3, finest_subset=finest, m2l_dots=tier)
    want = []
    for C in (4, 8):
        subset = finest if C == 8 else "expand"
        for sub in (subset,) + (("near",) if C < 8 else ()):
            if tier == "mixed" and sub == "expand":
                want += [(C, "near", "fp32"), (C, "far", "bf16x3")]
            else:
                want.append((C, sub, "bf16x3" if tier == "bf16x3"
                             else "fp32"))
    assert calls == want


# ----------------------------------------------------- the sparse tiers
def test_rank_compression_against_exact_uncompressed_and_murb_tpu():
    """m2l_rank=128 at m=6 on tests/test_sparse_fmm.py's 30k two-cluster
    case, where the finest level's cap crosses 2 rank: within 1e-4 of the
    exact force, and 0 < diff <= 2e-4 against the uncompressed solve
    (force; the potential rtol 2e-3).  Against murb_tpu's compressed solve
    within 1e-4 of max|a|: the bases differ, murb_tpu's Gram taking its
    products in fp32 and the port's in float64, and the port's truncation
    is the smaller (measured 5.6e-7 against the uncompressed solve, the gap
    to murb_tpu's 2.4e-5)."""
    rng = np.random.default_rng(7)
    n, npad = 30_000, 30_720
    q = np.concatenate([
        rng.normal(0, 5.0, (n // 2, 3)) + [-75.0, 0.0, 0.0],
        rng.normal(0, 5.0, (n - n // 2, 3)) + [75.0, 20.0, -10.0],
    ]).astype(np.float32)
    m = (rng.uniform(0.5, 2.0, n) * 1e10).astype(np.float32)
    qp = np.zeros((npad, 3), np.float32)
    qp[:n] = q
    gp = np.zeros(npad, np.float32)
    gp[:n] = m
    cols = (qp[:, 0], qp[:, 1], qp[:, 2], gp)
    jq = tuple(jnp.asarray(v) for v in cols)
    tq = tuple(torch.from_numpy(v.copy()) for v in cols)
    soft = 0.02
    jfull = js.plan_adaptive(q, npad, 6, 2, 6, m2l_rank=0)
    jcomp = js.plan_adaptive(q, npad, 6, 2, 6, m2l_rank=128)
    full = ts.SparsePlan.from_fields(**jfull._asdict())
    comp = ts.SparsePlan.from_fields(**jcomp._asdict())
    assert ts._resolve_rank(comp, comp.cell_caps[-1]) == 128, comp.cell_caps
    a_f, phi_f = ts.force_and_potential_adaptive(*tq, soft, full)
    a_c, phi_c = ts.force_and_potential_adaptive(*tq, soft, comp)
    idx = np.arange(0, n, 97)
    ref = acc_rect(jq[0][idx], jq[1][idx], jq[2][idx], *jq, soft)
    sc = float(np.sqrt(sum(np.asarray(r, np.float64) ** 2
                           for r in ref)).max())
    de = np.sqrt(sum((a_c[i].numpy()[idx] - np.asarray(ref[i])) ** 2
                     for i in range(3)))
    assert de.max() / sc <= 1e-4
    sel = gp > 0
    diff = max(rel(a_c[i].numpy()[sel], a_f[i].numpy()[sel])
               for i in range(3))
    assert 0.0 < diff <= 2e-4, diff
    np.testing.assert_allclose(phi_c.numpy()[sel], phi_f.numpy()[sel],
                               rtol=2e-3)
    ja_c, _ = js.force_and_potential_adaptive(*jq, soft, jcomp)
    gap = max(float(np.abs(np.asarray(ja_c[i])[sel]
                           - a_c[i].numpy()[sel]).max()
                    / np.abs(a_f[i].numpy()[sel]).max()) for i in range(3))
    assert gap <= 1e-4, gap


def test_m2l_basis_is_an_orthonormal_eigenbasis():
    """The shared basis: orthonormal columns, cached per (m, rank,
    device), and the leading eigenvectors of its Gram (a larger rank
    extends a smaller one's span)."""
    q = ts.m2l_basis(4, 32, "cpu")
    assert q.shape == (64, 32) and q.dtype == torch.float64
    assert torch.allclose(q.T @ q, torch.eye(32, dtype=torch.float64),
                          atol=1e-12)
    assert ts.m2l_basis(4, 32, "cpu") is q
    big = ts.m2l_basis(4, 48, "cpu")
    proj = big @ (big.T @ q)
    assert torch.allclose(proj, q, atol=1e-8)
    assert ts._M2L_RANKS == js._M2L_RANKS
    assert all(ts.default_m2l_rank(m) == js.default_m2l_rank(m) == 0
               for m in (4, 6, 8, 10, 12))


@pytest.fixture(scope="module")
def tight_clusters():
    """tests/test_sparse_fmm.py's scan-chunk case: 4096 bodies in two tight
    clusters, seed 3, murb_tpu's plan carried into the port."""
    rng = np.random.default_rng(3)
    n = 4096
    q = np.concatenate([
        rng.normal(0, 0.02, (n // 2, 3)) - 0.4,
        rng.normal(0, 0.02, (n - n // 2, 3)) + 0.4,
    ]).astype(np.float32)
    g = rng.uniform(0.5, 2.0, n).astype(np.float32)
    jplan, _ = js.best_adaptive_plan(q, n, 6)
    plan = ts.SparsePlan.from_fields(**jplan._asdict())
    t = tuple(torch.from_numpy(np.ascontiguousarray(q[:, i]))
              for i in range(3)) + (torch.from_numpy(g),)
    return t, plan


def _solve(case, **kw):
    t, plan = case
    return ts.solve_adaptive(*t, 1e-3, plan, heavy_k=1, heavy_factor=64.0,
                             with_phi=True, **kw)


def _close(a, p, ref_a, ref_p, tol=1e-5):
    s = float(ref_a.norm(dim=1).max())
    assert float((a - ref_a).abs().max()) <= tol * s
    assert float((p - ref_p).abs().max()) <= tol * float(ref_p.abs().max())


@pytest.mark.parametrize("env", [("MURB_M2L_SCAN_CHUNK", "5"),
                                 ("MURB_M2L_FUSED", "1")])
def test_schedule_forms_match_the_default_sweep(tight_clusters, monkeypatch,
                                                env):
    """MURB_M2L_SCAN_CHUNK=5 (158 offsets, and both mixed shells, 49 and
    109, in uneven batches) and MURB_M2L_FUSED=1 reproduce one offset a
    batch (MURB_M2L_SCAN_CHUNK=1) within 1e-5, force and potential, at
    fp32 and under the mixed tier (tests/test_sparse_fmm.py:472-503)."""
    monkeypatch.setenv("MURB_M2L_SCAN_CHUNK", "1")
    a_1, p_1 = _solve(tight_clusters)
    monkeypatch.delenv("MURB_M2L_SCAN_CHUNK")
    monkeypatch.setenv(*env)
    assert ts.m2l_schedule() != {"scan_chunk": 0, "fused": False}
    for dots in ("fp32", "mixed"):
        a, p = _solve(tight_clusters, m2l_dots=dots)
        _close(a, p, a_1, p_1)


def test_mixed_partitions_the_far_offsets_exactly(tight_clusters):
    """The mixed tier's two shells (|o|_inf = 2 and 3) partition the 158
    canonical far offsets: the two sweeps at fp32 sum to the whole sweep
    in float64 within 1e-12; the mixed solve is within 1e-5 of the fp32
    one (tests/test_sparse_fmm.py:506-530, where murb_tpu's CPU runs every
    tier at fp32)."""
    canon = ts._canon_far()
    shell = np.abs(canon).max(1)
    assert (len(canon), (shell <= 2).sum(), (shell >= 3).sum()) == \
        (158, 49, 109)
    C, m = 8, 3
    rng = np.random.default_rng(0)
    cells = torch.from_numpy(np.sort(rng.choice(C ** 3, 60, replace=False))
                             .astype(np.int64))
    w = torch.from_numpy(rng.standard_normal((61, m ** 3)))
    hl = torch.tensor([0.3, 0.2, 0.25], dtype=torch.float64)
    kw = dict(m=m, C=C, with_phi=True, lossy=False)
    whole = ts._m2l_sparse_level_scan(w, cells, hl, 0.05, canon, **kw)
    parts = [ts._m2l_sparse_level_scan(w, cells, hl, 0.05, canon[sel], **kw)
             for sel in (shell <= 2, shell >= 3)]
    for f, a, b in zip(whole, *parts):
        assert rel(a + b, f) <= 1e-12
    a_f, p_f = _solve(tight_clusters)
    a_m, p_m = _solve(tight_clusters, m2l_dots="mixed")
    _close(a_m, p_m, a_f, p_f)


def test_empty_offset_subset_gives_zero_fields():
    """No offsets, no contribution: zero fields of the right shape (murb_tpu
    divides by the offset count there, sparse_fmm.py:721)."""
    cells = torch.tensor([0, 5, 9], dtype=torch.int64)
    w = torch.ones((4, 8), dtype=torch.float32)
    for chunk in (0, 3):
        f = ts._m2l_sparse_level_scan(w, cells, torch.ones(3), 0.1,
                                      ts._canon_far()[:0], m=2, C=4,
                                      with_phi=True, lossy=True,
                                      scan_chunk=chunk)
        assert len(f) == 4
        assert all(x.shape == (3, 8) and not x.any() for x in f)


@pytest.mark.parametrize("dots", ["bf16x3", "mixed"])
def test_sparse_level_tiers_against_murb_tpu(dots):
    """One sparse level's sweep at each lossy tier within 1e-5 of max|f| of
    murb_tpu's (fp32 on its CPU) and of the port's fp32 sweep, and not
    equal to the latter (the tier runs its own arithmetic)."""
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
    got = ts.m2l_sparse_level(torch.from_numpy(w), tc, torch.from_numpy(hl),
                              0.05, m2l_dots=dots, **kw)
    fp32 = ts.m2l_sparse_level(torch.from_numpy(w), tc, torch.from_numpy(hl),
                               0.05, **kw)
    ref = js.m2l_sparse_level(jnp.asarray(w), jnp.asarray(tc.numpy(),
                                                          jnp.int32),
                              jnp.asarray(hl), 0.05, m2l_dots=dots, **kw)
    for g, f, r in zip(got, fp32, ref):
        assert rel(g.numpy(), r) <= 1e-5
        assert rel(g.numpy(), f.numpy()) <= 1e-5
    assert any(not torch.equal(g, f) for g, f in zip(got, fp32))


def test_tf32_scope_restores_the_flag():
    """The lossy tier's TF32 scope restores the float32 matmul precision,
    and so ``allow_tf32``, however it exits (a raise included); a lossy
    sweep on the CPU never touches it."""
    saved = torch.get_float32_matmul_precision()
    try:
        for before in ("highest", "high"):
            torch.set_float32_matmul_precision(before)
            flag = torch.backends.cuda.matmul.allow_tf32
            with tm.tf32_matmul():
                assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32 == flag
            with pytest.raises(RuntimeError, match="inside"):
                with tm.tf32_matmul():
                    raise RuntimeError("inside")
            assert torch.get_float32_matmul_precision() == before
            assert torch.backends.cuda.matmul.allow_tf32 == flag
        torch.set_float32_matmul_precision("highest")
        w, hl = _level_case()
        tk.m2l_level_plain(torch.from_numpy(w), torch.from_numpy(hl), SOFT,
                           m=4, C=4, dots="bf16x3")
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved)


def test_split3_matmul_arithmetic():
    """split3_matmul: three products of TF32 values (13 low bits clear),
    within 2^-20 of the float64 product's terms, batched alike."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((3, 5, 7)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 7, 4)).astype(np.float32))
    big, small = tm.tf32_split(a)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert not (small.view(torch.int32) & 0x1FFF).any()
    got = tm.split3_matmul(a, b).double()
    ref = a.double() @ b.double()
    bound = (a.double().abs() @ b.double().abs()) * 2.0 ** -20
    assert bool(((got - ref).abs() <= bound).all())
    # out=: the products added into the accumulator in place (three fp32
    # roundings of the running sum besides)
    out = torch.ones((3, 5, 4))
    assert tm.split3_matmul(a, b, out=out) is out
    slack = 3 * (ref.abs() + 1.0) * 2.0 ** -23
    assert bool(((out.double() - 1.0 - ref).abs() <= bound + slack).all())


def test_schedule_from_the_environment(monkeypatch):
    """m2l_schedule: MURB_M2L_SCAN_CHUNK a positive integer or 0 (unset,
    empty, not a number: the byte budget); MURB_M2L_FUSED "1" on, anything
    else (unset, "0", another word) off."""
    for var in ("MURB_M2L_SCAN_CHUNK", "MURB_M2L_FUSED"):
        monkeypatch.delenv(var, raising=False)
    assert ts.m2l_schedule() == {"scan_chunk": 0, "fused": False}
    for val, want in (("7", 7), ("", 0), ("x", 0), ("-2", 0)):
        monkeypatch.setenv("MURB_M2L_SCAN_CHUNK", val)
        assert ts.m2l_schedule()["scan_chunk"] == want
    for val, want in (("1", True), ("0", False), ("yes", False)):
        monkeypatch.setenv("MURB_M2L_FUSED", val)
        assert ts.m2l_schedule()["fused"] is want


# ------------------------------------------------------ the tier drops
#: injected errors of a lossy tier on top of the rung's own (murb_tpu's
#: tests/test_fmm.py:339 scale)
_LOSSY = {"fp32": 0.0, "mixed": 1e-3, "bf16x3": 3e-3}


def _inject(monkeypatch, proxy_err, fmm_err):
    """Both packages' ladders measure injected errors: measured_force_error
    returns what the rung's solver returns, acc_proxy ``proxy_err(m)`` and
    acc_fmm ``fmm_err(m, levels, tier)``, so no solve runs."""
    import murb_tpu.ops.fmm as jfm
    import murb_tpu.ops.proxy as jpr
    import murb_tpu.ops.validate as jva
    import murb_tpu_torch.ops.proxy as tpr
    import murb_tpu_torch.ops.validate as tva

    for mod in (jva, tva):
        monkeypatch.setattr(mod, "measured_force_error",
                            lambda qx, qy, qz, gm, soft, acc_fn, sample=512:
                            float(acc_fn(qx, qy, qz, gm)))
    for mod in (jpr, tpr):
        monkeypatch.setattr(mod, "acc_proxy",
                            lambda *a, m, cells=1, **kw: proxy_err(m))
    for mod in (jfm, tf):
        monkeypatch.setattr(
            mod, "acc_fmm",
            lambda *a, m, levels, m2l_dots="fp32", **kw:
            fmm_err(m, levels, m2l_dots))


def test_dense_tier_drop_picks_as_murb_tpu(monkeypatch):
    """tests/test_fmm.py:330-356 with the errors injected in both packages:
    under bf16x3 every hierarchy rung misses (3e-3), under mixed too
    (1e-3), and at fp32 the first rung meets tol; both ladders step
    bf16x3 -> mixed -> fp32 and pick the same (m, levels)."""
    _inject(monkeypatch, lambda m: 1.0,
            lambda m, lv, tier: (5e-5 if m >= 8 else 2e-4) + _LOSSY[tier])
    s = SCHEMES["random"](8192, 11)
    kw = dict(soft=SOFT, dt=DT, m2l_dots="bf16x3", tol=1e-4, validate=True)
    je = jcreate("tpu+proxy", s, **kw)
    te = tcreate("tpu+proxy", carry(s), **kw)
    assert te.levels >= 1 and te.m2l_dots == je.m2l_dots == "fp32"
    assert (te.m, te.levels, te.cells) == (je.m, je.levels, je.cells)
    assert te.validated_err == je.validated_err == 5e-5


def test_dense_tier_drop_after_a_single_cell_best(monkeypatch):
    """murb_tpu skips the tier drop when its ladder's best config is a
    single-cell rung (engines.py:630), though its hierarchy rungs missed
    by the tier: it keeps bf16x3 and the miss.  The port drops the tier
    whenever a hierarchy rung was measured, and meets tol at fp32."""
    _inject(monkeypatch, lambda m: 5e-4,
            lambda m, lv, tier: 5e-5 + _LOSSY[tier])
    s = SCHEMES["galaxy"](2048, 3)
    kw = dict(soft=SOFT, dt=DT, m=16, m2l_dots="bf16x3", validate=False)
    je = jcreate("tpu+proxy", s, **kw)
    te = tcreate("tpu+proxy", carry(s), **kw)
    je._validate_order(6e8)
    te._validate_order(6e8)
    assert (je.levels, je.m2l_dots, je.validated_err) == (0, "bf16x3", 5e-4)
    assert te.levels >= 2 and te.m2l_dots == "fp32"
    assert te.validated_err == 5e-5


def _cluster_bodies(n=2000, seed=7):
    """tests/test_sparse_fmm.py:_cluster_bodies."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([
        rng.normal(0, 1.0, (n // 2, 3)) + [-50.0, 0.0, 0.0],
        rng.normal(0, 1.0, (n - n // 2, 3)) + [50.0, 10.0, -5.0],
    ]).astype(np.float32)
    v = rng.normal(0, 1e-3, (n, 3)).astype(np.float32)
    m = (rng.uniform(0.5, 2.0, n) * 1e10).astype(np.float32)
    return JState.from_arrays(m, np.ones(n, np.float32), q[:, 0], q[:, 1],
                              q[:, 2], v[:, 0], v[:, 1], v[:, 2])


def _inject_adaptive(monkeypatch, err):
    """Both packages' adaptive ladders measure ``err(m, tier)`` from the
    plan's order and the tier acc_adaptive is called at."""
    import murb_tpu.ops.sparse_fmm as jsf
    import murb_tpu.ops.validate as jva
    import murb_tpu_torch.ops.validate as tva

    for mod in (jva, tva):
        monkeypatch.setattr(mod, "measured_force_error",
                            lambda qx, qy, qz, gm, soft, acc_fn, sample=512:
                            float(acc_fn(qx, qy, qz, gm)))
    for mod in (jsf, ts):
        monkeypatch.setattr(
            mod, "acc_adaptive",
            lambda *a, m2l_dots="fp32", **kw: err(a[5].m, m2l_dots))


@pytest.mark.parametrize("mixed,want_jax", [(1e-3, "fp32"),
                                            (3e-3, "bf16x3")])
def test_adaptive_tier_drop(monkeypatch, capsys, mixed, want_jax):
    """tests/test_sparse_fmm.py:330-356 with the errors injected: with
    each step an improvement both ladders step bf16x3 -> mixed -> fp32 at
    the first rung's m and pick the same order.  When mixed does not
    improve on bf16x3 murb_tpu stops there (engines.py:555) and escalates m
    to 12 under the miss; the port steps through to fp32 and meets tol."""
    lossy = dict(_LOSSY, mixed=mixed)
    _inject_adaptive(monkeypatch,
                     lambda m, tier: (5e-5 if m >= 6 else 2e-4)
                     + lossy[tier])
    kw = dict(soft=0.01, dt=1e-3, near="adaptive", validate=True,
              m2l_dots="bf16x3", tol=1e-4)
    je = jcreate("tpu+proxy", _cluster_bodies(), **kw)
    te = tcreate("tpu+proxy", carry(_cluster_bodies()), **kw)
    static = tcreate("tpu+proxy", carry(_cluster_bodies()), soft=0.01,
                     dt=1e-3, near="adaptive", validate=False)
    assert je.m2l_dots == want_jax
    assert te.m2l_dots == "fp32" and te.validated_err <= 1e-4
    assert te.m == static.m            # no escalation rung burned
    if want_jax == "fp32":
        assert (te.m, te.validated_err) == (je.m, je.validated_err)
    else:
        assert je.m == 12 and je.validated_err > 1e-4
    assert "dropping to fp32" in capsys.readouterr().out


# -------------------------------------------------- CLI and shard engines
def test_cli_near_adaptive_takes_the_tier(capsys):
    """``tpu+proxy --near adaptive --m2l-dots bf16x3``: the adaptive engine
    validates at the tier (stepping it toward fp32 only on a miss)."""
    res = cli.run(["-n", "2048", "-i", "2", "-s", "random", "--soft", "1e6",
                   "--nv", "--device", "cpu", "--im", "tpu+proxy", "--near",
                   "adaptive", "--m2l-dots", "bf16x3"])
    assert res.rc == 0
    e = res.engine
    e.assert_finite()
    assert e.near_mode == "adaptive" and e.validated_err <= 1e-4
    assert e.m2l_dots in ("bf16x3", "mixed", "fp32")


@pytest.mark.parametrize("mode,tier", [("proxy", "bf16x3"),
                                       ("adaptive", "mixed")])
def test_shard_engines_take_the_tier(mode, tier):
    """``shard+proxy`` (promoted to the hierarchy on the random box) and
    ``shard+adaptive`` on 2 CPU shards at a lossy tier: a step within 1e-5
    of the same engine's at fp32, and not its bits (the tier runs)."""
    s = carry(SCHEMES["random"](2048, 5))
    soft = SOFT if mode == "proxy" else 1e6
    acc = {}
    for dots in ("fp32", tier):
        e = tcreate(f"shard+{mode}", s, soft=soft, dt=DT, shards=2,
                    m2l_dots=dots, validate=False)
        assert e.m2l_dots == dots and e.mode in ("fmm", "adaptive")
        e.compute_one_iteration()
        e.assert_finite()
        acc[dots] = [v.numpy() for v in e.accelerations]
    assert force_stat(acc[tier], acc["fp32"]) <= 1e-5
    assert any(not np.array_equal(a, b)
               for a, b in zip(acc[tier], acc["fp32"]))
