"""The port's P2P near field (ops/p2p.py, ops/p2p_kernels.py) against
murb_tpu's (ops/p2p.py, ops/p2p_pallas.py).

The same numpy bodies (two tight clusters in a wide box and a uniform box,
as tests/test_p2p.py makes them) reach both packages.  On the CPU the
port's K10 wrapper runs its plain version, the chunked sweep; murb_tpu's
references are its jnp sweep and its Pallas kernel in interpret mode.

Tolerances: the host helpers (Morton keys, brick boxes, the pair
estimate, the capacities, the cost model) exactly; the sweeps within
1e-5 net-relative (max per-body vector error over max(|a|, 1e-6 max|a|);
the same pairs summed in another order) with the pair counts equal;
``acc_fmm(near="p2p")`` within 1e-5 of murb_tpu's and within 1e-4 of the
naive oracle (tests/test_p2p.py's contract).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from murb_tpu.ops import fmm as jf
from murb_tpu.ops import p2p as jp
from murb_tpu.ops.naive import acc_naive
from murb_tpu.ops.proxy import bounding_box as jbox
from murb_tpu_torch.ops import fmm as tf
from murb_tpu_torch.ops import p2p as tp
from murb_tpu_torch.ops import p2p_kernels as tk
from murb_tpu_torch.ops.proxy import bounding_box as tbox

torch.set_num_threads(2)
SOFT = 0.01


def bodies(kind: str, n: int = 4000, npad: int = 4096, seed: int = 0):
    """(JAX arrays, torch tensors, active positions (n, 3)) of
    tests/test_p2p.py's distributions, zero-mass ghosts to npad."""
    rng = np.random.default_rng(seed)
    if kind == "clusters":
        q = np.concatenate([
            rng.normal(0, 1.0, (n // 2, 3)) + [-50.0, 0.0, 0.0],
            rng.normal(0, 1.0, (n - n // 2, 3)) + [50.0, 10.0, -5.0],
        ]).astype(np.float32)
    else:
        q = rng.uniform(-100, 100, (n, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    qp = np.zeros((npad, 3), np.float32)
    qp[:n] = q
    gm = np.zeros(npad, np.float32)
    gm[:n] = m
    arrays = [qp[:, 0], qp[:, 1], qp[:, 2], gm]
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(a.copy()) for a in arrays), q)


def force_stat(got, ref, gm) -> float:
    g = np.stack([np.asarray(v, np.float64) for v in got], 1)
    r = np.stack([np.asarray(v, np.float64) for v in ref], 1)
    sel = np.asarray(gm) > 0
    rn = np.linalg.norm(r, axis=1)
    floor = np.maximum(rn, rn[sel].max() * 1e-6)
    return float((np.linalg.norm(g - r, axis=1) / floor)[sel].max())


def cubic_box(j, t):
    jc, jh = jbox(*j[:3], j[3] > 0)
    tc, th = tbox(*t[:3], t[3] > 0)
    return (jc, jnp.full_like(jh, jnp.max(jh))), (tc, th.max().expand(3))


@pytest.fixture(scope="module")
def clusters():
    j, t, q = bodies("clusters")
    (jc, jh), (tc, th) = cubic_box(j, t)
    est = jp.estimate_brick_pairs(q, 4096, 3)
    ref = jp.p2p_sweep(*j, jc, jh, SOFT, C=8, pmax=jp.size_pmax(est),
                       with_phi=True)
    return j, t, q, (tc, th), est, ref


# ------------------------------------------------------------ host helpers
@pytest.mark.parametrize("C", [2, 8, 64, 1024])
def test_morton_key_matches_jax(C):
    rng = np.random.default_rng(C)
    c = rng.integers(0, C, (3, 500)).astype(np.int32)
    got = tp.morton_key(*(torch.from_numpy(v) for v in c), C)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jp.morton_key(*(jnp.asarray(v) for v in c),
                                              C)))
    np.testing.assert_array_equal(tp._morton_np(*c.astype(np.int64), C),
                                  jp._morton_np(*c.astype(np.int64), C))


@pytest.mark.parametrize("kind,levels", [("clusters", 2), ("clusters", 3),
                                         ("clusters", 5), ("uniform", 2),
                                         ("uniform", 4)])
def test_estimate_and_capacities_match_jax(kind, levels):
    _, _, q = bodies(kind)
    est = tp.estimate_brick_pairs(q, 4096, levels)
    assert est == jp.estimate_brick_pairs(q, 4096, levels)
    for margin in (1.0, 1.5, 2.0):
        assert tp.size_pmax(est, margin) == jp.size_pmax(est, margin)
    assert tp.p2p_cost_model(est, 4096, 6, levels) == \
        jp.p2p_cost_model(est, 4096, 6, levels)
    assert (tp.DEFAULT_K, tp.DEFAULT_CHUNK, tp._SENTINEL_SHIFT) == \
        (jp.DEFAULT_K, jp.DEFAULT_CHUNK, jp._SENTINEL_SHIFT)


def test_cells_and_brick_boxes_match_jax(clusters):
    j, t, _, (tc, th), _, _ = clusters
    (jc, jh), _ = cubic_box(j, t)
    jci = jp._cell_ixyz(*j[:3], jc, jh, 8)
    tci = tp._cell_ixyz(*t[:3], tc, th, 8)
    for a, b in zip(tci, jci):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jlo, jhi = jp._brick_boxes(jci, 128)
    tlo, thi = tp._brick_boxes(tci, 128)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tp._adjacency(tlo, thi).numpy(),
                                  np.asarray(jp._adjacency(jlo, jhi)))


def test_pair_rows_is_the_row_major_list():
    """K10's CSR: row t keeps the candidates of rank < pmax - starts[t], so
    the kept pairs are the first pmax of the row-major list."""
    rng = np.random.default_rng(3)
    adj = torch.from_numpy(rng.random((40, 40)) < 0.2)
    counts, starts, n_pairs = tk.pair_rows(adj)
    flat = torch.nonzero(adj.reshape(-1)).reshape(-1)
    assert int(n_pairs) == flat.numel()
    assert counts.tolist() == adj.sum(1).tolist()
    for t in range(40):
        row = flat[(flat // 40) == t]
        if row.numel():
            assert int(starts[t]) == int((flat < row[0]).sum())


# ------------------------------------------------------------------ sweep
def test_p2p_sweep_matches_jax_sweep_and_pallas(clusters):
    """Against murb_tpu's jnp sweep and its Pallas kernel in interpret mode
    (as test_p2p_pallas_matches_jnp_sweep runs it), force and potential,
    with the pair counts equal."""
    from murb_tpu.ops.p2p_pallas import acc_p2p_pallas, size_pmax_runs

    j, t, _, (tc, th), est, (racc, rphi, rnp) = clusters
    (jc, jh), _ = cubic_box(j, t)
    acc, phi, n_pairs = tk.acc_p2p(*t, tc, th, SOFT, C=8,
                                   pmax=tp.size_pmax(est), with_phi=True)
    assert int(n_pairs) == int(rnp)
    ref = [np.asarray(racc)[:, d] for d in range(3)]
    assert force_stat([v.numpy() for v in acc], ref, j[3]) <= 1e-5
    sel = np.asarray(j[3]) > 0
    np.testing.assert_allclose(phi.numpy()[sel], np.asarray(rphi)[sel],
                               rtol=1e-5)
    pa, pphi, pnp = acc_p2p_pallas(*j, jc, jh, SOFT, C=8,
                                   pmax=size_pmax_runs(est, 4096 // 128),
                                   with_phi=True)
    assert int(pnp) == int(n_pairs)
    assert force_stat([v.numpy() for v in acc], pa, j[3]) <= 1e-5
    np.testing.assert_allclose(phi.numpy()[sel], np.asarray(pphi)[sel],
                               rtol=1e-5)


def test_capacity_drops_the_same_pairs(clusters):
    """pmax below the candidate count: both packages sweep the first pmax
    candidates in row-major order and report the true count."""
    j, t, _, (tc, th), est, _ = clusters
    (jc, jh), _ = cubic_box(j, t)
    small = max(est // 2 // 128 * 128, 128)
    ref = jp.p2p_sweep(*j, jc, jh, SOFT, C=8, pmax=small)
    acc, _, n_pairs = tk.p2p_sweep(*t, tc, th, SOFT, C=8, pmax=small)
    assert int(n_pairs) == int(ref[2]) > small
    assert force_stat([acc[:, d].numpy() for d in range(3)],
                      [np.asarray(ref[0])[:, d] for d in range(3)],
                      j[3]) <= 1e-5
    full = tk.p2p_sweep(*t, tc, th, SOFT, C=8, pmax=tp.size_pmax(est))[0]
    assert float((full - acc).abs().max()) > 0.0   # pairs were dropped


def test_kernel_wrapper_runs_the_plain_sweep_on_cpu(clusters):
    _, t, _, (tc, th), est, _ = clusters
    key, ci = tp.sorted_cells(*t[:3], t[3] > 0, tc, th, 8)
    _, perm = torch.sort(key, stable=True)
    args = [v[perm] for v in t], tuple(v[perm] for v in ci)
    tk.p2p_sweep_kernel_sorted.launches = 0
    got, n1 = tk.p2p_sweep_kernel_sorted(*args[0], args[1], SOFT,
                                         pmax=tp.size_pmax(est))
    ref, n2 = tp.p2p_sweep_plain_sorted(*args[0], args[1], SOFT,
                                        pmax=tp.size_pmax(est))
    assert int(n1) == int(n2) and tk.p2p_sweep_kernel_sorted.launches == 0
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="brick size"):
        tk.p2p_sweep_kernel_sorted(*(v[:200] for v in args[0]),
                                   tuple(v[:200] for v in args[1]), SOFT,
                                   pmax=128)


# ------------------------------------------------ K10's sub-tile classes
def sorted_cells_of(kind: str, n: int = 3990, C: int = 8):
    """(n_pad, 3) sorted int32 cells of a test box at C=8, sentinel rows
    last; n = 3990 leaves a sub-brick of 22 real and 10 sentinel rows."""
    _, t, _ = bodies(kind, n, 4096)
    c, h = tbox(*t[:3], t[3] > 0)
    key, ci = tp.sorted_cells(*t[:3], t[3] > 0, c, h.max().expand(3), C)
    _, perm = torch.sort(key, stable=True)
    return tuple(v[perm] for v in ci)


@pytest.mark.parametrize("kind", ["clusters", "uniform"])
def test_subtile_classes_hold_the_cell_mask(kind):
    """On the tests' two-cluster and random boxes: every body pair that
    passes the cell mask lies in a sub-tile pair not classed far, every
    body pair of an all-near sub-tile pair passes it, and no all-near
    sub-tile pair mixes a sentinel row with a real body."""
    ci = sorted_cells_of(kind)
    S, n = tp.SUB_K, ci[0].shape[0]
    lo, hi = tp._brick_boxes(ci, S)
    cls = tp.subtile_class(lo[:, None], hi[:, None], lo[None], hi[None])
    mask = torch.ones((n, n), dtype=torch.bool)
    for c in ci:
        c = c.to(torch.int16)
        mask &= (c[:, None] - c[None, :]).abs() <= 1
    blocks = mask.reshape(n // S, S, n // S, S)
    any_pass, all_pass = blocks.any(3).any(1), blocks.all(3).all(1)
    assert not (any_pass & (cls == tp.FAR)).any()
    assert all_pass[cls == tp.ALL_NEAR].all()
    assert torch.equal(cls == tp.ALL_NEAR, all_pass)
    sent = (ci[0] >= 8).reshape(n // S, S)
    has_sent, has_real = sent.any(1), (~sent).any(1)
    mixes = ((has_sent[:, None] | has_sent[None])
             & (has_real[:, None] | has_real[None]))
    assert not (mixes & (cls == tp.ALL_NEAR)).any()
    assert (has_sent & has_real).any()      # the case is there
    assert set(cls.unique().tolist()) == {tp.FAR, tp.MIXED, tp.ALL_NEAR}


@settings(max_examples=200, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), span=st.integers(1, 5),
       sent_t=st.integers(0, 32), sent_s=st.integers(0, 32))
def test_subtile_class_against_every_body_pair(seed, span, sent_t, sent_s):
    """Two 32-body sub-bricks of random cells (the last rows sentinels):
    all-near exactly when every body pair passes the mask, far only when
    none does."""
    rng = np.random.default_rng(seed)
    C = 8

    def sub(n_sent):
        c = rng.integers(0, C - span + 1, 3) + rng.integers(0, span, (32, 3))
        c[32 - n_sent:] = 2 * C + tp._SENTINEL_SHIFT
        return torch.from_numpy(c.astype(np.int32))

    a, b = sub(sent_t), sub(sent_s)
    cls = int(tp.subtile_class(a.amin(0), a.amax(0), b.amin(0), b.amax(0)))
    mask = ((a[:, None] - b[None]).abs() <= 1).all(-1)
    assert (cls == tp.ALL_NEAR) == bool(mask.all())
    if cls == tp.FAR:
        assert not mask.any()


def test_kernel_inputs_on_the_host():
    """What the K10 wrapper hands the kernel besides the bodies: the
    sub-brick boxes in 16-byte rows and the launch order, longest rows
    first, ties in brick order."""
    ci = sorted_cells_of("clusters")
    box = tk.subbrick_boxes(ci)
    lo, hi = tp._brick_boxes(ci, tp.SUB_K)
    assert box.shape == (4096 // 32, 2, 4) and box.dtype == torch.int32
    assert torch.equal(box[:, 0, :3], lo) and torch.equal(box[:, 1, :3], hi)
    assert not box[:, :, 3].any()
    counts = torch.tensor([3, 7, 7, 0, 7, 1])
    order = tk.launch_order(counts)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 2, 4, 0, 5, 3]


# ------------------------------------------------- the hierarchy with P2P
@pytest.mark.parametrize("kind,levels,m,soft", [
    ("clusters", 2, 6, 0.01), ("clusters", 3, 6, 0.01),
    ("uniform", 2, 8, 0.5)])
def test_acc_fmm_p2p_matches_jax_and_oracle(kind, levels, m, soft):
    j, t, q = bodies(kind)
    pmax = tp.size_pmax(tp.estimate_brick_pairs(q, 4096, levels))
    got = tf.acc_fmm(*t, soft, m=m, levels=levels, near="p2p", p2p_pmax=pmax)
    ref = jf.acc_fmm(*j, soft, m=m, levels=levels, near="p2p",
                     p2p_pmax=pmax)
    g = [v.numpy() for v in got]
    assert force_stat(g, ref, j[3]) <= 1e-5
    assert force_stat(g, acc_naive(*j, soft), j[3]) <= 1e-4


def test_force_and_potential_fmm_p2p_matches_jax():
    j, t, q = bodies("clusters", 2000, 2048)
    pmax = tp.size_pmax(tp.estimate_brick_pairs(q, 2048, 3))
    acc, phi = tf.force_and_potential_fmm(*t, SOFT, m=6, levels=3,
                                          near="p2p", p2p_pmax=pmax)
    jacc, jphi = jf.force_and_potential_fmm(*j, SOFT, m=6, levels=3,
                                            near="p2p", p2p_pmax=pmax)
    assert force_stat([v.numpy() for v in acc], jacc, j[3]) <= 1e-5
    sel = np.asarray(j[3]) > 0
    np.testing.assert_allclose(phi.numpy()[sel], np.asarray(jphi)[sel],
                               rtol=1e-5)


def test_p2p_mode_needs_a_capacity():
    _, t, _ = bodies("clusters", 500, 512)
    with pytest.raises(ValueError, match="p2p_pmax"):
        tf.acc_fmm(*t, SOFT, m=6, levels=2, near="p2p")
