"""The CUDA kernels' plain versions against murb_tpu's Pallas kernels.

The CUDA kernels themselves run only on a card (chip_smoke.py holds each
against its plain version there).  Here, on the CPU, each wrapper must run
exactly its plain version, and each plain version must agree with the TPU
kernel it replaces, run in Pallas interpret mode as tests/test_proxy.py
does:

  K1/K2  p2m_fused / l2p_fused_multi   rtol 1e-4, atol 1e-6 max|W| / 1e-5 max
  K3     acc_tile_rect                 WithinRel 1e-5
  K4     acc_hybrid_rect(passes=2)     WithinRel 2e-4, and each tier against
                                       a numpy float64 oracle (5e-3, 1e-4,
                                       1e-5 for passes 1, 2, 3)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from conftest import assert_within_rel
from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops import hybrid as th
from murb_tpu_torch.ops import proxy_kernels as tk
from murb_tpu_torch.ops import tile as tt
from murb_tpu_torch.ops.proxy import bounding_box

torch.set_num_threads(2)
SOFT = 2.0e8


def state_arrays(scheme, n, seed):
    s = jinit.SCHEMES[scheme](n, seed)
    q = [np.array(getattr(s, k), np.float32) for k in ("qx", "qy", "qz")]
    return q + [(np.asarray(s.m, np.float64) * G).astype(np.float32)]


def numpy_oracle(qi, qj, gmj):
    """float64 double loop over the j-set, vectorized over i."""
    qi = np.stack(qi, 1).astype(np.float64)
    qj = np.stack(qj, 1).astype(np.float64)
    acc = np.zeros_like(qi)
    for j in range(qj.shape[0]):
        d = qj[j] - qi
        w = float(gmj[j]) / (np.sum(d * d, 1) + SOFT ** 2) ** 1.5
        acc += w[:, None] * d
    return acc.T


# ------------------------------------------------------------- K1 and K2
@pytest.fixture(scope="module")
def anterp_case():
    m = 12
    a = state_arrays("galaxy", 512, 17)
    t = list(map(torch.from_numpy, a))
    c, h = bounding_box(*t[:3], t[3] > 0)
    return m, a, t, c, h


def test_p2m_plain_matches_pallas_p2m(anterp_case):
    from murb_tpu.ops.proxy_pallas import p2m_fused

    m, a, t, c, h = anterp_case
    ref = np.asarray(p2m_fused(*map(jnp.asarray, a), jnp.asarray(c.numpy()),
                               jnp.asarray(h.numpy()), m=m, block=256,
                               interpret=True))
    got = tk.p2m_plain(*t, c, h, m=m).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-6 * np.abs(ref).max(),
                               err_msg="K1 plain vs Pallas P2M "
                                       "(rtol 1e-4, atol 1e-6 max|W|)")


def test_l2p_plain_matches_pallas_l2p(anterp_case):
    from murb_tpu.ops.proxy_pallas import l2p_fused_multi

    m, a, t, c, h = anterp_case
    rng = np.random.default_rng(0)
    fields = [rng.normal(size=m ** 3).astype(np.float32) for _ in range(3)]
    ref = l2p_fused_multi(*map(jnp.asarray, a[:3]), jnp.asarray(c.numpy()),
                          jnp.asarray(h.numpy()),
                          tuple(map(jnp.asarray, fields)), m=m, block=256,
                          interpret=True)
    ref = np.stack([np.asarray(r) for r in ref], 1)
    got = tk.l2p_plain(*t[:3], c, h, tuple(map(torch.from_numpy, fields)),
                       m=m)
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max(),
                               err_msg="K2 plain vs Pallas L2P "
                                       "(rtol 1e-4, atol 1e-5 max)")


@pytest.mark.parametrize("k", [4, 5, 11])
def test_l2p_takes_force_plus_up_to_eight_potential_fields(anterp_case, k):
    """The tracked paths interpolate 3 + G fields, G <= 8, in one call
    (the kernel runs them in groups of 4): each field comes back as the
    one-field L2P of it; a twelfth field is refused."""
    m, a, t, c, h = anterp_case
    rng = np.random.default_rng(k)
    fields = tuple(torch.from_numpy(rng.normal(size=m ** 3).astype(
        np.float32)) for _ in range(k))
    got = tk.l2p_fused_multi(*t[:3], c, h, fields, m=m)
    assert len(got) == k
    for f, g in zip(fields, got):
        (one,) = tk.l2p_plain(*t[:3], c, h, (f,), m=m)
        torch.testing.assert_close(g, one, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="1 to 11 node fields"):
        tk.l2p_fused_multi(*t[:3], c, h, fields + fields[:1] * (12 - k),
                           m=m)


def test_l2p_plain_interpolates_low_degree_fields_exactly(anterp_case):
    """Chebyshev interpolation of order m reproduces polynomials of degree
    below m: node fields 1 and x_node come back as 1 and each body's x
    (float64, tolerance 1e-9 of the box)."""
    from murb_tpu_torch.ops.proxy import proxy_nodes

    m, a, t, c, h = anterp_case
    q = [v.double() for v in t[:3]]
    c, h = c.double(), h.double()
    px, py, pz = proxy_nodes(c, h, m, torch.float64)
    one, x = tk.l2p_plain(*q, c, h, (torch.ones_like(px), px), m=m)
    torch.testing.assert_close(one, torch.ones_like(one), rtol=0, atol=1e-9)
    torch.testing.assert_close(x, q[0], rtol=0, atol=1e-9 * float(h[0]))


def test_basis_is_a_partition_of_unity():
    """Lagrange bases sum to 1 at any point and interpolate the nodes."""
    for m in (2, 5, 12, 32):
        t = torch.linspace(-1, 1, 101, dtype=torch.float64)
        s = tk._basis(t, m)
        torch.testing.assert_close(s.sum(1), torch.ones(101,
                                                        dtype=torch.float64))
        k = torch.arange(m, dtype=torch.float64)
        nodes = torch.cos(torch.pi * (k + 0.5) / m)
        torch.testing.assert_close(tk._basis(nodes, m),
                                   torch.eye(m, dtype=torch.float64),
                                   atol=1e-12, rtol=0)
    with pytest.raises(ValueError):
        tk._basis(torch.zeros(3), 1)


# ------------------------------------------------------------------- K3
def test_tile_plain_matches_pallas_tile_on_rectangle_with_ghosts():
    from murb_tpu.ops.tile_pallas import acc_tile_rect

    a = state_arrays("random", 500, 21)          # npad 512: 12 ghosts
    rows = slice(256, 512)                       # i-set holds the ghosts
    ref = acc_tile_rect(*(jnp.asarray(v[rows]) for v in a[:3]),
                        *map(jnp.asarray, a), SOFT, interpret=True)
    t = list(map(torch.from_numpy, a))
    got = tt.acc_tile_rect_plain(*(v[rows] for v in t[:3]), *t, SOFT)
    for c, g, r in zip("xyz", got, ref):
        assert_within_rel(g.numpy(), np.asarray(r), 1e-5,
                          f"K3 plain vs Pallas tile a{c} (WithinRel 1e-5)",
                          rms_floor=1e-5)


# ------------------------------------------------------------------- K4
def test_hybrid_plain_matches_pallas_hybrid():
    from murb_tpu.ops.hybrid import acc_hybrid_rect

    a = state_arrays("galaxy", 512, 5)
    rows = slice(0, 256)
    ref = acc_hybrid_rect(*(jnp.asarray(v[rows]) for v in a[:3]),
                          *map(jnp.asarray, a), SOFT, passes=2,
                          interpret=True)
    t = list(map(torch.from_numpy, a))
    got = th.acc_hybrid_rect_plain(*(v[rows] for v in t[:3]), *t, SOFT,
                                   passes=2)
    for c, g, r in zip("xyz", got, ref):
        assert_within_rel(g.numpy(), np.asarray(r), 2e-4,
                          f"K4 plain vs Pallas hybrid p2 a{c} "
                          "(WithinRel 2e-4)", rms_floor=2e-4)


@pytest.mark.parametrize("passes,eps", [(1, 5e-3), (2, 1e-4), (3, 1e-5)])
def test_hybrid_tiers_against_float64_oracle(passes, eps):
    a = state_arrays("random", 300, 6)           # npad 512, ghosts as sources
    rows = slice(0, 200)
    ref = numpy_oracle([v[rows] for v in a[:3]], a[:3], a[3])
    t = list(map(torch.from_numpy, a))
    got = th.acc_hybrid_rect_plain(*(v[rows] for v in t[:3]), *t, SOFT,
                                   passes=passes)
    assert got.ax.dtype == torch.float32
    for c, g, r in zip("xyz", got, ref):
        assert_within_rel(g.numpy(), r, eps,
                          f"K4 p{passes} plain vs float64 a{c} "
                          f"(WithinRel {eps})", rms_floor=eps)


def test_extended_tier_separates_from_the_fp32_tier():
    """At N=8000 the passes-3 plain version sits within WithinRel 5e-8 of
    the float64 oracle, about one float32 rounding of the output, and the
    fp32 tier does not: a passes-3 path that summed in fp32 fails here."""
    a = state_arrays("random", 8000, 6)
    rows = slice(0, 128)
    ref = numpy_oracle([v[rows] for v in a[:3]], a[:3], a[3])
    t = list(map(torch.from_numpy, a))

    def check(passes):
        got = th.acc_hybrid_rect_plain(*(v[rows] for v in t[:3]), *t, SOFT,
                                       passes=passes)
        for c, g, r in zip("xyz", got, ref):
            assert_within_rel(g.numpy(), r, 5e-8,
                              f"K4 p{passes} plain vs float64 a{c} "
                              "(WithinRel 5e-8)", rms_floor=5e-8)

    check(3)
    with pytest.raises(AssertionError, match="beyond rel eps=5e-08"):
        check(2)


def ext_run_sum(qxi, qyi, qzi, qxj, qyj, qzj, gmj, soft, *,
                run: int = th.EXT_RUN, chunk: int = 4096):
    """K4 passes 3's arithmetic with torch ops, in float64 sums: each pair
    weight in fp32 with one Newton step on the rsqrt, each run of ``run``
    sources summed in fp32 in source order, the runs added in float64
    (any j split folds its float64 partials, so it rounds the same).  For
    float32 inputs."""
    if run < 1 or chunk % run:
        raise ValueError(f"run={run} must divide chunk={chunk}")
    f32 = torch.float32
    s2 = torch.tensor(float(soft) ** 2, dtype=f32)
    qi = [v.to(f32) for v in (qxi, qyi, qzi)]
    sums = [torch.zeros(qi[0].shape[0], dtype=torch.float64)
            for _ in range(3)]
    nj = qxj.shape[0]
    for s in range(0, nj, chunk):
        sl = slice(s, min(s + chunk, nj))
        d = [qj[sl].to(f32)[None, :] - q[:, None]
             for q, qj in zip(qi, (qxj, qyj, qzj))]
        d2 = d[0] * d[0] + (d[1] * d[1] + (d[2] * d[2] + s2))
        inv = torch.rsqrt(d2)
        inv = inv * ((-0.5 * d2 * inv) * inv + 1.5)
        w = gmj[sl].to(f32)[None, :] * (inv * inv * inv)
        for c in range(3):
            # runs of `run` terms (a ragged end padded with zero terms,
            # as the kernel's ghost sources add exactly 0)
            t = torch.nn.functional.pad(w * d[c], (0, -d2.shape[1] % run))
            t = t.reshape(t.shape[0], -1, run)
            part = t[:, :, 0]
            for j in range(1, run):
                part = part + t[:, :, j]
            sums[c] += part.double().sum(1)
    return sums


def unsplit_fp32_sum(qi, qj, gmj, tile=128):
    """K4 passes 2 with no j split at 128x128 (K3's arithmetic): fp32 pair
    terms summed in source order over each tile of ``tile`` sources, the
    tile partials added in fp32 in tile order."""
    f32 = torch.float32
    d = [b[None, :] - a[:, None] for a, b in zip(qi, qj)]
    d2 = d[0] * d[0] + (d[1] * d[1] + (d[2] * d[2]
                                       + torch.tensor(SOFT ** 2, dtype=f32)))
    w = gmj[None, :] * torch.rsqrt(d2) ** 3
    out = []
    for c in range(3):
        t = torch.nn.functional.pad(w * d[c], (0, -d2.shape[1] % tile))
        t = t.reshape(t.shape[0], -1, tile)
        part = t[:, :, 0]
        for j in range(1, tile):
            part = part + t[:, :, j]
        acc = part[:, 0]
        for k in range(1, part.shape[1]):
            acc = acc + part[:, k]
        out.append(acc.double())
    return out


def force_stat(got, ref) -> float:
    """ops/validate's statistic: max per-body vector error over
    max(|a_ref|, 1e-6 max |a_ref|)."""
    g = torch.stack([v.double() for v in got], 1)
    r = torch.stack([v.double() for v in ref], 1)
    rn = r.norm(dim=1)
    return float(((g - r).norm(dim=1)
                  / torch.clamp(rn, min=1e-6 * float(rn.max()))).max())


@pytest.mark.parametrize("scheme", ["galaxy", "random"])
def test_passes3_runs_hold_half_the_unsplit_fp32_error(scheme):
    """K4 passes 3's arithmetic (``ext_run_sum``: fp32 pair terms with a
    Newton-refined rsqrt, runs of ``EXT_RUN`` sources in fp32, fp64 sums)
    at 8192^2 against float64 on a 2048-row strided sample: at most half
    the error of the unsplit fp32 sum, and within the tier's 4e-7 (the
    contract chip_smoke.py holds the kernel to at 16384^2 and
    200,192^2).  It pins the run length: runs of 32 read 0.54 of the
    unsplit error on the galaxy."""
    a = [torch.from_numpy(v) for v in state_arrays(scheme, 8192, 123)]
    rows = torch.arange(0, 8192, 4)
    qi = [v[rows] for v in a[:3]]
    ref = tt.acc_tile_rect_plain(*(v.double() for v in qi),
                                 *(v.double() for v in a), SOFT)
    ext = force_stat(ext_run_sum(*qi, *a, SOFT), ref)
    fp32 = force_stat(unsplit_fp32_sum(qi, a[:3], a[3]), ref)
    assert ext <= 0.5 * fp32, (scheme, ext, fp32)
    assert ext <= 4e-7, (scheme, ext)


def test_passes3_run_and_geometry_are_the_kernels():
    """``EXT_RUN`` and passes 3's default geometry mirror csrc/tile.cuh's
    kExtRun and csrc/hybrid.cu's kExtTargets, kExtSources; a run that does
    not divide the emulation's chunk is refused."""
    import re

    src = (cuda.CSRC / "tile.cuh").read_text()
    assert int(re.search(r"kExtRun = (\d+);", src).group(1)) == th.EXT_RUN
    src = (cuda.CSRC / "hybrid.cu").read_text()
    assert int(re.search(r"kExtTargets = (\d+);", src).group(1)) \
        == th.EXT_BLOCK_I
    assert int(re.search(r"kExtSources = (\d+);", src).group(1)) \
        == th.EXT_BLOCK_J
    t = [torch.ones(8)] * 3
    with pytest.raises(ValueError, match="divide"):
        ext_run_sum(*t, *t, torch.ones(8), SOFT, run=3, chunk=8)


@pytest.mark.parametrize("block_i,block_j,bi,bj", [
    (0, 0, 128, 128), (64, 0, 64, 128), (0, 512, 128, 512),
    (256, 256, 256, 256)])
def test_ext_split_args_counts_passes3s_own_blocks(monkeypatch, block_i,
                                                   block_j, bi, bj):
    """Passes 3's j split is ops/tile.split_args at its own geometry (0:
    ``EXT_BLOCK_I`` x ``EXT_BLOCK_J``) and resident count
    (murb_hybrid_resident), with float64 slice sums."""
    asked = []
    monkeypatch.setattr(cuda, "sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda, "resident", lambda entry, dev, i, j:
                        asked.append((entry, i, j)) or 4)
    (slices, per, ptr), scratch = th.ext_split_args(
        16384, 16384, block_i, block_j, torch.device("cpu"))
    assert asked == [("murb_hybrid_resident", bi, bj)]
    assert (slices, per) == cuda.tile_split(16384, 16384, 132, 4, bi, bj)
    assert slices > 1 and ptr == scratch.data_ptr()
    assert scratch.dtype == torch.float64
    assert scratch.shape == (slices, 3, 16384)


def test_split_args_defaults_to_k3s_blocks_and_fp32(monkeypatch):
    """Without ``entry`` and ``dtype`` the split is K3's: its resident
    count (murb_tile_resident) and float32 slice sums."""
    asked = []
    monkeypatch.setattr(cuda, "sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda, "resident", lambda entry, dev, i, j:
                        asked.append((entry, i, j)) or 4)
    (slices, per, ptr), scratch = tt.split_args(16384, 16384, 0, 0,
                                                torch.device("cpu"))
    assert asked == [("murb_tile_resident", 0, 0)]
    assert (slices, per) == cuda.tile_split(16384, 16384, 132, 4)
    assert scratch.dtype == torch.float32 and ptr == scratch.data_ptr()


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_hybrid_wrapper_checks_its_geometry_on_cpu(passes):
    """The block geometry is checked before the CPU branch: a refused pair
    raises on CPU tensors too; an accepted one runs the plain version."""
    t = list(map(torch.from_numpy, state_arrays("random", 300, 6)))
    ref = th.acc_hybrid_rect_plain(*t[:3], *t, SOFT, passes=passes)
    for bi, bj in ((0, 0), (64, 512), (256, 128)):
        got = th.acc_hybrid_rect(*t[:3], *t, SOFT, passes=passes,
                                 block_i=bi, block_j=bj)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    with pytest.raises(ValueError, match="block_i=96"):
        th.acc_hybrid_rect(*t[:3], *t, SOFT, passes=passes, block_i=96)
    with pytest.raises(ValueError, match="block_j=100"):
        th.acc_hybrid_rect(*t[:3], *t, SOFT, passes=passes, block_j=100)


# -------------------------------------------------- wrappers on the CPU
def test_wrappers_run_their_plain_version_on_cpu_tensors():
    a = state_arrays("galaxy", 512, 3)
    t = list(map(torch.from_numpy, a))
    c, h = bounding_box(*t[:3], t[3] > 0)
    counts = (tk.p2m_fused.launches, tk.l2p_fused_multi.launches,
              tt.acc_tile_rect.launches, th.acc_hybrid_rect.launches)
    torch.testing.assert_close(tk.p2m_fused(*t, c, h, m=8),
                               tk.p2m_plain(*t, c, h, m=8), rtol=0, atol=0)
    w = tk.p2m_plain(*t, c, h, m=8)
    for g, r in zip(tk.l2p_fused_multi(*t[:3], c, h, (w, w), m=8),
                    tk.l2p_plain(*t[:3], c, h, (w, w), m=8)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    for g, r in zip(tt.acc_tile(*t, SOFT),
                    tt.acc_tile_rect_plain(*t[:3], *t, SOFT)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    for p in (1, 2, 3):
        for g, r in zip(th.acc_hybrid(*t, SOFT, passes=p),
                        th.acc_hybrid_rect_plain(*t[:3], *t, SOFT,
                                                 passes=p)):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    # the plain path is no launch
    assert counts == (tk.p2m_fused.launches, tk.l2p_fused_multi.launches,
                      tt.acc_tile_rect.launches, th.acc_hybrid_rect.launches)


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    m = torch.zeros(256, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tt.acc_tile_rect(m, m, m, m, m, m, m, SOFT)
    with pytest.raises(ValueError, match="cpu or cuda"):
        th.acc_hybrid_rect(m, m, m, m, m, m, m, SOFT, passes=2)
    c = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tk.p2m_fused(m, m, m, m, c, c, m=8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tk.l2p_fused_multi(m, m, m, c, c, (torch.zeros(512, device="meta"),),
                           m=8)
    with pytest.raises(ValueError, match="passes"):
        th.acc_hybrid_rect(m, m, m, m, m, m, m, SOFT, passes=4)


def test_kernel_inputs_checks_dtype_shape_and_device():
    dev = torch.device("cpu")
    seen = []
    note = lambda tag, dtype: seen.append((tag, dtype))
    x = torch.arange(8, dtype=torch.float64)
    (y,) = cuda.kernel_inputs("k", dev, 8, x, notify=note)
    assert y.dtype == torch.float32 and seen == [("k", torch.float64)]
    strided = torch.zeros(16)[::2]
    (z,) = cuda.kernel_inputs("k", dev, 8, strided, notify=note)
    assert z.is_contiguous()
    with pytest.raises(TypeError, match="dtype"):
        cuda.kernel_inputs("k", dev, 8, torch.zeros(8, dtype=torch.int32),
                           notify=note)
    with pytest.raises(ValueError, match="shape"):
        cuda.kernel_inputs("k", dev, 8, torch.zeros(9), notify=note)
    with pytest.raises(ValueError, match="meta"):
        cuda.kernel_inputs("k", dev, 8, torch.zeros(8, device="meta"),
                           notify=note)


# ------------------------------------------------------- K3's j split
@settings(max_examples=300, deadline=None)
@given(ni=st.integers(1, 400_000), nj=st.integers(0, 400_000),
       sms=st.integers(1, 200), resident=st.integers(1, 32),
       bi=st.sampled_from((0,) + cuda.SWEEP_BLOCKS),
       bj=st.sampled_from((0,) + cuda.SWEEP_BLOCKS))
# K5's and K6's geometry on the merger (256 x 256, the H100's resident
# blocks of K6 at R = 2, K5 at R = 2 and both at R = 8)
@example(ni=81_920, nj=81_920, sms=132, resident=12, bi=256, bj=256)
@example(ni=81_920, nj=81_920, sms=132, resident=17, bi=256, bj=256)
@example(ni=81_920, nj=81_920, sms=132, resident=8, bi=256, bj=256)
@example(ni=81_920, nj=81_920, sms=132, resident=9, bi=128, bj=512)
def test_tile_split_covers_every_source_once_in_order(ni, nj, sms, resident,
                                                      bi, bj):
    """Slices of whole tiles, in order, cover the j tiles exactly once,
    none empty, as csrc/tile.cu checks; one slice once the target blocks
    fill the card's resident slots TILE_WAVES times."""
    slices, per = cuda.tile_split(ni, nj, sms, resident, bi, bj)
    tiles = -(-nj // (bj or cuda.TILE_BLOCK_J))
    assert 1 <= slices <= max(tiles, 1)
    assert slices * per >= tiles and (slices == 1
                                      or (slices - 1) * per < tiles)
    covered = [t for s in range(slices)
               for t in range(s * per, min((s + 1) * per, tiles))]
    assert covered == list(range(tiles))
    blocks = -(-ni // (bi or cuda.TILE_BLOCK_I))
    if blocks >= cuda.TILE_WAVES * resident * sms:
        assert slices == 1


@pytest.mark.parametrize("ni,nj,want", [
    (1_048_576, 1_048_576, 1), (200_192, 200_192, 5), (16_384, 16_384, 32),
    (8_000, 8_000, 16), (5_000, 16_384, 32), (50_176, 200_704, 18),
    (2_048, 2_048, 4)])
def test_tile_split_at_the_main_path_shapes(ni, nj, want):
    """On 132 SMs at the default geometry (128 targets a block, 4 a
    thread, 512 sources a tile), of which an H100 SM holds 13 blocks: the
    1M sweep keeps one slice, the others split until they fill the slots
    four times or have one tile a slice."""
    assert cuda.tile_rows() == 4 and cuda.tile_rows(64) == 2
    slices, per = cuda.tile_split(ni, nj, 132, 13)
    assert slices == want
    assert (slices - 1) * per < -(-nj // 512) <= slices * per


@pytest.mark.parametrize("nr,force,resident,want", [
    (2, True, 12, 20), (2, False, 17, 27), (1, True, 14, 23),
    (1, False, 20, 32), (8, True, 8, 14), (8, False, 8, 14)])
def test_phi_split_at_the_merger(nr, force, resident, want):
    """K5's and K6's j split on the merger (81,920^2) at their default
    geometry (256 targets a block, 256 sources a tile: 320 target blocks)
    on 132 SMs, keyed by R through the blocks an H100 SM holds of each
    instance (murb_phi_resident, the occupancy calculator; read by
    scripts/torch_kernel_ab.py): whole tiles, every source once, in
    order."""
    bi, bj = cuda.PHI_BLOCK_I, cuda.PHI_BLOCK_J
    slices, per = cuda.tile_split(81_920, 81_920, 132, resident, bi, bj)
    assert (bi, bj) == (256, 256) and slices == want
    tiles = 81_920 // bj
    covered = [t for s in range(slices)
               for t in range(s * per, min((s + 1) * per, tiles))]
    assert covered == list(range(tiles))


# -------------------------------------------------------------- the build
def test_build_kernels_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda, "DEFAULT_NVCC", tmp_path / "no" / "nvcc")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build_kernels()
    assert not (tmp_path / "build").exists()


def test_library_path_is_keyed_by_the_sources():
    p = cuda.library_path()
    assert p.parent == cuda.BUILD_DIR and p.name.startswith("libmurb_kernels_")
    assert p == cuda.library_path()
    srcs = {s.name for s in cuda._sources()}
    assert {"tile.cu", "hybrid.cu", "proxy.cu", "phi.cu", "sweep.cuh"} <= srcs
