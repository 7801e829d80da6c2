"""K5 (multi-row potential) and K6 (force and potential rows fused): their
plain versions against murb_tpu's Pallas kernels and a float64 sweep.

The CUDA kernels run only on a card (chip_smoke.py holds each against its
plain version there).  On the CPU the wrappers run the plain versions,
which are held to:

  * murb_tpu's ``phi_rows`` / ``acc_phi_rows_hybrid`` (passes 2, Pallas
    interpret mode, as tests/test_multigalaxy.py runs them): WithinRel 1e-5
    on phi (the bf16-split tier's fp32 class), 2e-4 on the force (the
    fused-vs-naive tolerance of murb_tpu's own test);
  * a numpy float64 sweep: WithinRel 1e-5 on phi, 1e-4 on the force.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu.ops import hybrid as jh
from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops import hybrid as th

torch.set_num_threads(2)
SOFT = 2.0e8


def case(scheme, n, seed, r):
    """Positions, G*m and R source-weight rows: row 0 the total, the
    others random 0/1 galaxy masks times G*m."""
    s = jinit.SCHEMES[scheme](n, seed)
    q = [np.array(getattr(s, k), np.float32) for k in ("qx", "qy", "qz")]
    gm = (np.asarray(s.m, np.float64) * G).astype(np.float32)
    rng = np.random.default_rng(seed)
    masks = [np.ones_like(gm)] + [
        (rng.random(gm.shape) < 0.5).astype(np.float32) for _ in range(r - 1)]
    return q, gm, np.stack([gm * mk for mk in masks])


def phi64(qi, qj, rows):
    """float64 sweep: (R, ni), the j == i term included."""
    qi = np.stack(qi, 1).astype(np.float64)
    qj = np.stack(qj, 1).astype(np.float64)
    d2 = ((qj[None, :, :] - qi[:, None, :]) ** 2).sum(-1)
    return rows.astype(np.float64) @ (1.0 / np.sqrt(d2 + SOFT ** 2)).T


def acc64(q, gm):
    qd = np.stack(q, 1).astype(np.float64)
    d = qd[None, :, :] - qd[:, None, :]
    w = gm.astype(np.float64)[None, :] / ((d ** 2).sum(-1) + SOFT ** 2) ** 1.5
    return (w[:, :, None] * d).sum(1).T


@pytest.mark.parametrize("r", [1, 2, 8])
def test_phi_rows_plain_matches_pallas_and_float64(r):
    q, gm, rows = case("random", 1024, 13 + r, r)
    ref = np.asarray(jh.phi_rows(*map(jnp.asarray, q), jnp.asarray(rows),
                                 SOFT, interpret=True))
    got = th.phi_rows(*map(torch.from_numpy, q), torch.from_numpy(rows),
                      SOFT)
    assert got.shape == (r, 1024) and got.dtype == torch.float32
    assert_within_rel(got.numpy(), ref, 1e-5, f"K5 plain vs Pallas R={r}",
                      rms_floor=1e-5)
    assert_within_rel(got.numpy(), phi64(q, q, rows), 1e-5,
                      f"K5 plain vs float64 R={r}", rms_floor=1e-5)


def test_phi_rows_rect_with_ghost_sources():
    """A rectangle whose j-set ends in zero-mass ghosts: they add exactly
    nothing (the same sum over the real sources alone)."""
    q, gm, rows = case("random", 500, 3, 2)          # npad 512, 12 ghosts
    t = [torch.from_numpy(v) for v in q]
    ti = [v[100:300] for v in t]
    full = th.phi_rows_rect(*ti, *t, torch.from_numpy(rows), SOFT)
    real = th.phi_rows_rect(*ti, *(v[:500] for v in t),
                            torch.from_numpy(rows[:, :500]), SOFT)
    torch.testing.assert_close(full, real, rtol=1e-6, atol=0)
    assert_within_rel(full.numpy(), phi64([v[100:300] for v in q], q, rows),
                      1e-5, "K5 rect plain vs float64", rms_floor=1e-5)


def test_phi_rows_keep_the_self_term():
    """phi includes 1/eps * w_i: an i-set of one body far from every
    source reads its own weight over eps, and the float64 check above
    fails for a sweep that skips the diagonal."""
    q, gm, rows = case("galaxy", 512, 4, 1)
    t = [torch.from_numpy(v) for v in q]
    phi = th.phi_rows(*t, torch.from_numpy(rows), SOFT)[0].double()
    d2 = sum((v.double()[None, :] - v.double()[:, None]) ** 2 for v in t)
    off = torch.from_numpy(rows[0]).double()[None, :] / torch.sqrt(
        d2 + SOFT ** 2)
    no_self = off.sum(1) - off.diagonal()
    torch.testing.assert_close(phi - no_self,
                               torch.from_numpy(rows[0]).double() / SOFT,
                               rtol=1e-4, atol=1e-6 * float(phi.abs().max()))
    lone = [torch.tensor([1e15]), torch.tensor([0.0]), torch.tensor([0.0])]
    one = th.phi_rows_rect(*lone, *lone, torch.tensor([[3.0e9]]), SOFT)
    assert float(one[0, 0]) == pytest.approx(3.0e9 / SOFT, rel=1e-6)


@pytest.mark.parametrize("r", [1, 2, 8])
def test_acc_phi_rows_plain_matches_pallas_and_float64(r):
    q, gm, rows = case("random", 1024, 21 + r, r)
    jacc, jphi = jh.acc_phi_rows_hybrid(*map(jnp.asarray, q),
                                        jnp.asarray(gm), jnp.asarray(rows),
                                        SOFT, interpret=True)
    acc, phi = th.acc_phi_rows_hybrid(*map(torch.from_numpy, q),
                                      torch.from_numpy(gm),
                                      torch.from_numpy(rows), SOFT)
    assert phi.shape == (r, 1024)
    a64 = acc64(q, gm)
    for c, g, ref, ref64 in zip("xyz", acc, jacc, a64):
        assert_within_rel(g.numpy(), np.asarray(ref), 2e-4,
                          f"K6 plain a{c} vs Pallas R={r}", rms_floor=2e-4)
        assert_within_rel(g.numpy(), ref64, 1e-4,
                          f"K6 plain a{c} vs float64 R={r}", rms_floor=1e-4)
    assert_within_rel(phi.numpy(), np.asarray(jphi), 1e-5,
                      f"K6 plain phi vs Pallas R={r}", rms_floor=1e-5)
    assert_within_rel(phi.numpy(), phi64(q, q, rows), 1e-5,
                      f"K6 plain phi vs float64 R={r}", rms_floor=1e-5)


def test_wrappers_run_the_plain_versions_on_cpu_and_check_arguments():
    q, gm, rows = case("galaxy", 512, 5, 3)
    t = [torch.from_numpy(v) for v in q]
    g, w = torch.from_numpy(gm), torch.from_numpy(rows)
    counts = (th.phi_rows_rect.launches, th.acc_phi_rows_hybrid.launches)
    torch.testing.assert_close(th.phi_rows(*t, w, SOFT),
                               th.phi_rows_rect_plain(*t, *t, w, SOFT),
                               rtol=0, atol=0)
    acc, phi = th.acc_phi_rows_hybrid(*t, g, w, SOFT, passes=1)
    pacc, pphi = th.acc_phi_rows_plain(*t, g, w, SOFT)
    for a, b in zip((*acc, phi), (*pacc, pphi)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert counts == (th.phi_rows_rect.launches,
                      th.acc_phi_rows_hybrid.launches)
    with pytest.raises(ValueError, match="passes"):
        th.phi_rows(*t, w, SOFT, passes=3)
    with pytest.raises(ValueError, match="gm_rows shape"):
        th.phi_rows(*t, torch.zeros(9, 512), SOFT)
    with pytest.raises(ValueError, match="gm_rows shape"):
        th.acc_phi_rows_hybrid(*t, g, torch.zeros(2, 511), SOFT)
    m = torch.zeros(256, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        th.phi_rows(m, m, m, torch.zeros(1, 256, device="meta"), SOFT)
    with pytest.raises(ValueError, match="cpu or cuda"):
        th.acc_phi_rows_hybrid(m, m, m, m, torch.zeros(1, 256, device="meta"),
                               SOFT)


# ------------------------------------------- the kernels' geometry (K3's)
@pytest.mark.parametrize("nr", range(1, 9))
def test_sweep_geometry_mirror_fits_and_keeps_k3s_targets(nr):
    """ops/cuda's mirrors of csrc/tile.cuh and csrc/phi.cuh at R rows: the
    weight record holds the rows and loads as one float, float2 or float4
    pieces; the staged double buffer of every block_j fits the 48 KB a
    kernel may use without opting in, the default's stays within 24 KB;
    every block keeps whole warps; at R <= 2 the targets a thread are
    K3's tile_rows (K5 and K6 keep them at every R)."""
    w = cuda.weight_stride(nr)
    assert w in (1, 2, 4, 8) and nr <= w < 2 * nr + 1
    assert cuda.staged_bytes(nr) == 16 + 4 * w
    for bj in cuda.SWEEP_BLOCKS:
        # static shared memory: 48 KB a block at most
        assert 2 * bj * cuda.staged_bytes(nr) <= 48 * 1024
        # the records start after 2 * bj float4 and stay aligned to w floats
        assert (2 * bj * 16) % (4 * w) == 0
    bj = cuda.PHI_BLOCK_J
    assert bj in cuda.SWEEP_BLOCKS and 2 * bj * cuda.staged_bytes(nr) \
        <= 24 * 1024
    for bi in cuda.SWEEP_BLOCKS:
        rt = cuda.sweep_rows(bi, nr)
        assert bi % rt == 0 and (bi // rt) % 32 == 0
        assert rt == cuda.tile_rows(bi)
    assert cuda.PHI_BLOCK_I in cuda.SWEEP_BLOCKS


def test_sweep_geometry_mirror_matches_the_sources():
    """The constants ops/cuda mirrors, read from csrc/tile.cuh and
    csrc/phi.cuh (K5's and K6's shared header)."""
    tile = (cuda.CSRC / "tile.cuh").read_text()
    phi = (cuda.CSRC / "phi.cuh").read_text()
    assert f"kMaxPhiRows = {th.MAX_PHI_ROWS};" in tile
    assert f"kPhiTargets = {cuda.PHI_BLOCK_I};" in phi
    assert "nr == 1 ? 1 : nr == 2 ? 2 : nr <= 4 ? 4 : 8" in tile
    assert f"kPhiSources = {cuda.PHI_BLOCK_J};" in phi
    assert re.search(r"int sweep_rows\(int bi, int /\*nr\*/\) \{\s*"
                     r"return tile_rows\(bi\);", tile)
    assert "murb_phi_resident" in cuda._SIGNATURES


@pytest.mark.parametrize("block_i,block_j", [(0, 0), (64, 512), (512, 64),
                                             (128, 256)])
def test_wrappers_take_a_block_geometry_and_run_the_plain_versions(
        block_i, block_j):
    """block_i/block_j pick the kernels' geometry on the card; on CPU
    tensors the wrappers run the plain versions whatever the geometry, and
    still agree with murb_tpu's Pallas kernels (interpret mode) at 1e-5 on
    phi and 2e-4 on the force."""
    q, gm, rows = case("random", 1024, 31, 2)
    t = [torch.from_numpy(v) for v in q]
    g, w = torch.from_numpy(gm), torch.from_numpy(rows)
    jq = [jnp.asarray(v) for v in q]
    phi = th.phi_rows(*t, w, SOFT, block_i=block_i, block_j=block_j)
    torch.testing.assert_close(phi, th.phi_rows_rect_plain(*t, *t, w, SOFT),
                               rtol=0, atol=0)
    ref = np.asarray(jh.phi_rows(*jq, jnp.asarray(rows), SOFT,
                                 interpret=True))
    assert_within_rel(phi.numpy(), ref, 1e-5,
                      f"K5 {block_i}x{block_j} vs Pallas", rms_floor=1e-5)
    rect = th.phi_rows_rect(*(v[:300] for v in t), *t, w, SOFT,
                            block_i=block_i, block_j=block_j)
    torch.testing.assert_close(rect, phi[:, :300], rtol=0, atol=0)
    acc, phi6 = th.acc_phi_rows_hybrid(*t, g, w, SOFT, block_i=block_i,
                                       block_j=block_j)
    jacc, jphi = jh.acc_phi_rows_hybrid(*jq, jnp.asarray(gm),
                                        jnp.asarray(rows), SOFT,
                                        interpret=True)
    for c, a, ref in zip("xyz", acc, jacc):
        assert_within_rel(a.numpy(), np.asarray(ref), 2e-4,
                          f"K6 {block_i}x{block_j} a{c} vs Pallas",
                          rms_floor=2e-4)
    assert_within_rel(phi6.numpy(), np.asarray(jphi), 1e-5,
                      f"K6 {block_i}x{block_j} phi vs Pallas",
                      rms_floor=1e-5)


@pytest.mark.parametrize("block_i,block_j", [(96, 0), (0, 1024), (32, 128),
                                             (128, 48)])
def test_wrappers_refuse_other_block_pairs_on_cpu_too(block_i, block_j):
    """A geometry outside {0} and ops/cuda.SWEEP_BLOCKS raises before any
    device is looked at, as K3's does: never rounded, never ignored."""
    q, gm, rows = case("galaxy", 512, 6, 2)
    t = [torch.from_numpy(v) for v in q]
    g, w = torch.from_numpy(gm), torch.from_numpy(rows)
    name = "block_j" if block_i in (0,) + cuda.SWEEP_BLOCKS else "block_i"
    with pytest.raises(ValueError, match=name):
        th.phi_rows(*t, w, SOFT, block_i=block_i, block_j=block_j)
    with pytest.raises(ValueError, match=name):
        th.phi_rows_rect(*t, *t, w, SOFT, block_i=block_i, block_j=block_j)
    with pytest.raises(ValueError, match=name):
        th.acc_phi_rows_hybrid(*t, g, w, SOFT, block_i=block_i,
                               block_j=block_j)
