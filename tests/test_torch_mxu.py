"""The norm-expansion sweep (K13's plain version, ``tpu+mxu`` and
``--kernel mxu``) against murb_tpu's, on the CPU.

K13 itself runs only on a card (chip_smoke.py phase 10 holds it against
its plain version at each tier there).  Here the port's wrapper runs its
plain version, which computes each tier's TF32 arithmetic (ops/mxu.py),
and murb_tpu runs its Pallas kernel in interpret mode, as
tests/test_oracle.py does.  Tolerances:

  * both against the naive sweep: tests/test_oracle.py:99-100, WithinRel
    5e-4 with an rms floor of 5e-4 (the norm expansion's contract), at
    "high" and "highest"; at "default" (one TF32 pass on P) WithinRel 1e-3
    with an rms floor of 1e-3, which the CPU study reads at 0.04 to 0.3
    (per-body errors 1.2e-4 to 4.7e-4 of |a|), under murb_tpu's ~0.4% for
    its one bf16 pass;
  * the port ("high") against murb_tpu's sweep on the same inputs:
    WithinRel 1e-5 with an rms floor of 1e-5 (both fp32-class; measured
    gaps about 1e-6 of max|a|); each tier against murb_tpu's same tier at
    the contract's 5e-4;
  * engines: tests/test_engines_differential.py's four cases, WithinRel
    1e-3 on positions for the random scheme and 1e-1 for the chaotic
    galaxy, the port's tpu+mxu against murb_tpu's;
  * the tracked CLI: histories within rtol 1e-6 (tests/
    test_torch_tracking.py's exact paths).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import assert_within_rel
from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu.models import create_engine as jcreate
from murb_tpu.ops import mxu as jmxu
from murb_tpu.ops.naive import acc_naive, acc_rect
from murb_tpu_torch import cli
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine as tcreate
from murb_tpu_torch.ops import mxu as tmxu
from murb_tpu_torch.ops import make_acc_fn

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def arrays(js, dtype=np.float32):
    """(qx, qy, qz, G*m) of a murb_tpu state as numpy arrays."""
    q = [np.asarray(getattr(js, k), dtype) for k in ("qx", "qy", "qz")]
    return q + [(np.asarray(js.m, np.float64) * G).astype(dtype)]


def close(got, ref, eps, msg):
    for c, g, r in zip("xyz", got, ref):
        assert_within_rel(np.asarray(g), np.asarray(r), eps,
                          f"{msg} a{c} (WithinRel {eps})", rms_floor=eps)


@pytest.mark.parametrize("scheme,seed", [("galaxy", 5), ("random", 6)])
def test_acc_mxu_matches_jax_and_the_naive_sweep(scheme, seed):
    a = arrays(jinit.SCHEMES[scheme](512, seed))
    ref = jmxu.acc_mxu(*map(jnp.asarray, a), SOFT, interpret=True)
    got = tmxu.acc_mxu(*map(torch.from_numpy, a), SOFT)
    naive = acc_naive(*map(jnp.asarray, a), SOFT)
    close(got, ref, 1e-5, f"{scheme}: port vs murb_tpu acc_mxu")
    close(got, naive, 5e-4, f"{scheme}: port acc_mxu vs naive")
    close(ref, naive, 5e-4, f"{scheme}: murb_tpu acc_mxu vs naive")


def test_rect_with_center_point_matches_jax():
    """An i-set of 256 rows against all 2049 bodies, centred on a given
    point (what the shard engines will pass): the same as murb_tpu's."""
    a = arrays(jinit.init_galaxy(2049, 11))
    rows = slice(1024, 1280)
    cp = (1.0e8, -2.0e8, 5.0e7)
    ref = jmxu.acc_mxu_rect(*(jnp.asarray(v[rows]) for v in a[:3]),
                            *map(jnp.asarray, a), SOFT, interpret=True,
                            center_point=tuple(jnp.float32(c) for c in cp))
    t = list(map(torch.from_numpy, a))
    got = tmxu.acc_mxu_rect(*(v[rows] for v in t[:3]), *t, SOFT,
                            center_point=cp)
    close(got, ref, 1e-5, "rect with center_point: port vs murb_tpu")
    # the centre moves only the expansion's rounding, not the force
    own = tmxu.acc_mxu_rect(*(v[rows] for v in t[:3]), *t, SOFT)
    close(got, own, 5e-4, "center_point vs the j-set's own centre")


def test_float64_input_runs_the_plain_sweep_in_float64():
    """On the CPU a float64 state stays float64 through the plain version
    (WithinRel 1e-9 of the float64 naive sweep); murb_tpu casts it to fp32
    inside its kernel, which the norm expansion's 5e-4 contract covers."""
    a = arrays(jinit.init_random(512, 2), np.float64)
    got = tmxu.acc_mxu(*map(torch.from_numpy, a), SOFT)
    assert got.ax.dtype == torch.float64
    naive = acc_naive(*map(jnp.asarray, a), SOFT)
    assert naive.ax.dtype == jnp.float64
    close(got, naive, 1e-9, "float64 plain vs float64 naive")
    ref = jmxu.acc_mxu(*map(jnp.asarray, a), SOFT, interpret=True)
    close(ref, got, 5e-4, "murb_tpu (fp32 inside) vs the float64 port")


def test_ghosts_add_nothing():
    """2049 bodies padded to 2304: the padded sweep's real rows equal the
    sweep over the 2049 real bodies alone (WithinRel 1e-5: only the
    reduction order changes)."""
    js = jinit.init_galaxy(2049, 3)
    assert js.padding == 255
    t = list(map(torch.from_numpy, arrays(js)))
    padded = tmxu.acc_mxu(*t, SOFT)
    real = tmxu.acc_mxu(*(v[:2049] for v in t), SOFT)
    close([p[:2049] for p in padded], real, 1e-5, "padded vs unpadded")


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_precision_tiers(precision):
    """"high" and "highest" are one tier in the port (two TF32 products on
    P: the same numbers); "default" (one) stays within its 1e-3 of them.
    Each matches murb_tpu's tier within the norm expansion's contract."""
    a = arrays(jinit.init_galaxy(512, 5))
    t = list(map(torch.from_numpy, a))
    got = tmxu.acc_mxu(*t, SOFT, precision=precision)
    high = tmxu.acc_mxu(*t, SOFT)
    if precision == "default":
        close(got, high, 1e-3, "default vs high")
        assert any(not torch.equal(g, h) for g, h in zip(got, high))
    else:
        for g, h in zip(got, high):
            torch.testing.assert_close(g, h, rtol=0, atol=0)
    ref = jmxu.acc_mxu(*map(jnp.asarray, a), SOFT, precision=precision,
                       interpret=True)
    close(got, ref, 5e-4, f"precision={precision}: port vs murb_tpu")


# ------------------------------------------------------ TF32 arithmetic
_normal = st.floats(min_value=2.0 ** -100, max_value=2.0 ** 100, width=32)


def _f32(vals, signs):
    x = torch.tensor(vals, dtype=torch.float32)
    return torch.where(torch.tensor(signs), -x, x)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(_normal, st.booleans()), min_size=1, max_size=64))
def test_tf32_round_and_split(vals):
    """``tf32_round`` is cvt.rna.tf32.f32: 13 low bits zero, within half a
    TF32 ulp (2^-11 |x|), idempotent; the split's big + small carries x to
    2^-22 |x| and both parts are TF32 values."""
    x = _f32(*zip(*vals))
    r = tmxu.tf32_round(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    x64, r64 = x.double(), r.double()
    assert ((x64 - r64).abs() <= 2.0 ** -11 * x64.abs()).all()
    assert torch.equal(tmxu.tf32_round(r), r)
    assert torch.equal(torch.sign(r), torch.sign(x))
    big, small = tmxu.tf32_split(x)
    assert torch.equal(big, r)
    assert not (small.view(torch.int32) & 0x1FFF).any()
    assert ((x64 - big.double() - small.double()).abs()
            <= 2.0 ** -22 * x64.abs()).all()
    trunc = tmxu.tf32_trunc(x)
    assert not (trunc.view(torch.int32) & 0x1FFF).any()
    assert (trunc.double().abs() <= x64.abs()).all()
    assert ((x64 - trunc.double()).abs() <= 2.0 ** -10 * x64.abs()).all()


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(_normal, st.booleans()), min_size=1, max_size=64))
def test_tf32_round_ties_go_away_from_zero(vals):
    """A value exactly halfway between two TF32 values (13 low bits
    0x1000) rounds to the one of larger magnitude."""
    x = _f32(*zip(*vals))
    tie = ((x.view(torch.int32) & -0x2000) | 0x1000).view(torch.float32)
    r = tmxu.tf32_round(tie)
    assert (r.double().abs() > tie.double().abs()).all()
    assert torch.equal(r.view(torch.int32),
                       (tie.view(torch.int32) & -0x2000) + 0x2000)


def test_tier_mapping():
    """P: one TF32 product at "default", two at "high" and "highest"; S:
    two at every s_precision (one misses the contract on the random box,
    test_one_pass_on_s_misses_the_contract_on_the_random_box)."""
    assert tmxu.tier_passes("default") == (2, 1)
    assert tmxu.tier_passes("high") == tmxu.tier_passes("highest") == (2, 2)
    for s in tmxu.PRECISIONS:
        assert tmxu.tier_passes("high", s)[0] == 2
    with pytest.raises(ValueError, match="unknown precision"):
        tmxu.tier_passes("fast")


def _naive64(a, rows=slice(None)):
    """murb_tpu's direct sweep in float64 of the ``rows`` of ``a``."""
    a64 = [np.asarray(v, np.float64) for v in a]
    return acc_rect(*(jnp.asarray(v[rows]) for v in a64[:3]),
                    *map(jnp.asarray, a64), SOFT)


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("n", [2048, 2049])
@pytest.mark.parametrize("scheme,seed", [("galaxy", 21), ("random", 22)])
def test_tiers_against_murb_tpu_and_float64(scheme, seed, n, precision):
    """Each tier of the plain version (fp32 in, K13's TF32 arithmetic)
    against murb_tpu's acc_mxu_rect at the same tier (interpret mode) and
    the float64 naive sweep: "high"/"highest" at WithinRel 5e-4 (rms floor
    5e-4), "default" at 1e-3 (rms floor 1e-3; module note)."""
    a = arrays(jinit.SCHEMES[scheme](n, seed))
    got = tmxu.acc_mxu_rect_plain(*map(torch.from_numpy, a[:3]),
                                  *map(torch.from_numpy, a), SOFT,
                                  precision=precision)
    assert got.ax.dtype == torch.float32
    eps = 1e-3 if precision == "default" else 5e-4
    close(got, _naive64(a), eps, f"{scheme} n={n} {precision} vs float64")
    ref = jmxu.acc_mxu_rect(*map(jnp.asarray, a[:3]), *map(jnp.asarray, a),
                            SOFT, precision=precision, interpret=True)
    close(got, ref, eps, f"{scheme} n={n} {precision} vs murb_tpu")


@pytest.mark.parametrize("precision", ["default", "high"])
def test_close_pair_cancellation_on_a_strided_sample(precision):
    """A 256-row strided sample of the 16,384-body galaxy against all of
    it (the rect entry), where close pairs cancel the expansion's large
    terms: the tier's bound against the float64 naive sweep and murb_tpu."""
    js = jinit.init_galaxy(16_384, 31)
    a = arrays(js)
    rows = slice(0, 16_384, 64)
    t = list(map(torch.from_numpy, a))
    got = tmxu.acc_mxu_rect_plain(*(v[rows] for v in t[:3]), *t, SOFT,
                                  precision=precision)
    eps = 1e-3 if precision == "default" else 5e-4
    close(got, _naive64(a, rows), eps, f"strided {precision} vs float64")
    ref = jmxu.acc_mxu_rect(*(jnp.asarray(v[rows]) for v in a[:3]),
                            *map(jnp.asarray, a), SOFT, precision=precision,
                            interpret=True)
    close(got, ref, eps, f"strided {precision} vs murb_tpu")


def test_one_pass_on_s_misses_the_contract_on_the_random_box():
    """The study behind S's mapping: S in one TF32 product (without the
    targets' small parts, n_s and nB_s) stays within WithinRel 5e-4 on the
    galaxy but not on the random box, where it reads 3 to 4.5 times the
    allowance; two products read under 0.01 of it."""
    for scheme, one_pass_ok in (("galaxy", True), ("random", False)):
        a = arrays(jinit.SCHEMES[scheme](2048, 3))
        t = list(map(torch.from_numpy, a))
        naive = _naive64(a)
        one = tmxu._acc_plain(*t[:3], *t, SOFT, 1, 2)
        two = tmxu._acc_plain(*t[:3], *t, SOFT, 2, 2)
        close(two, naive, 5e-4, f"{scheme}: two products on S")
        if one_pass_ok:
            close(one, naive, 5e-4, f"{scheme}: one product on S")
        else:
            with pytest.raises(AssertionError, match="beyond rel"):
                close(one, naive, 5e-4, f"{scheme}: one product on S")


def test_plain_version_ignores_the_tf32_matmul_setting():
    """The plain version rounds its operands itself and runs its products
    at "highest" float32 precision whatever the global setting, which it
    leaves as it found it."""
    t = list(map(torch.from_numpy, arrays(jinit.init_galaxy(512, 8))))
    want = tmxu.acc_mxu(*t, SOFT)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = tmxu.acc_mxu(*t, SOFT)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_unknown_tier_and_blocks_are_refused():
    t = [torch.ones(256)] * 4
    with pytest.raises(ValueError, match="unknown precision 'bf16'"):
        tmxu.acc_mxu(*t, SOFT, precision="bf16")
    with pytest.raises(ValueError, match="unknown s_precision"):
        tmxu.acc_mxu(*t, SOFT, s_precision="fast")
    with pytest.raises(ValueError, match="block_i=96 is not supported"):
        tmxu.acc_mxu(*t, SOFT, block_i=96)
    with pytest.raises(ValueError, match="unknown precision"):
        tcreate("tpu+mxu", carry(jinit.init_random(256, 1)), soft=SOFT,
                precision="low")
    m = torch.zeros(256, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tmxu.acc_mxu(m, m, m, m, SOFT)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    t = list(map(torch.from_numpy, arrays(jinit.init_galaxy(512, 3))))
    count = tmxu.acc_mxu_rect.launches
    for bi, bj in ((0, 0), (64, 512), (512, 64)):
        got = tmxu.acc_mxu(*t, SOFT, block_i=bi, block_j=bj)
        for g, r in zip(got, tmxu.acc_mxu_rect_plain(*t[:3], *t, SOFT)):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert tmxu.acc_mxu_rect.launches == count   # the plain path is no launch


@pytest.mark.parametrize("n,n_ite,scheme,eps", [
    (2048, 1, "random", 1e-3), (2049, 3, "random", 1e-3),
    (2048, 4, "galaxy", 1e-1), (2049, 3, "galaxy", 1e-1)])
def test_mxu_engine_matches_jax_mxu_engine(n, n_ite, scheme, eps):
    js = jinit.SCHEMES[scheme](n, 123)
    je = jcreate("tpu+mxu", js, soft=SOFT, dt=DT)
    te = tcreate("tpu+mxu", carry(js), soft=SOFT, dt=DT)
    assert te.tag == "tpu+mxu" and te.precision == "high"
    for i in range(1, n_ite + 1):
        je.compute_one_iteration()
        te.compute_one_iteration()
        a, b = je.bodies.unpadded(), te.bodies.unpadded()
        for c in ("qx", "qy", "qz"):
            assert_within_rel(b[c], a[c], eps,
                              f"tpu+mxu {scheme} n={n} iter {i} {c}")


def test_make_acc_fn_mxu_is_the_sweep_with_blocks():
    t = list(map(torch.from_numpy, arrays(jinit.init_random(512, 4))))
    fn = make_acc_fn("mxu", block_i=256, block_j=128)
    assert fn.keywords == {"block_i": 256, "block_j": 128}
    for g, r in zip(fn(*t, SOFT), tmxu.acc_mxu(*t, SOFT)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_cli_tracking_kernel_mxu_matches_murb_tpu(tmp_path, monkeypatch,
                                                  capsys):
    """``--im tpu+tracking --kernel mxu`` in both packages on one state:
    the CSV histories within rtol 1e-6, the final positions WithinRel
    1e-4 (rms floor 1e-4)."""
    from murb_tpu import cli as jcli

    js = jinit.init_galaxy(2048, 123)
    monkeypatch.setattr(jcli, "make_bodies", lambda *a, **k: js)
    monkeypatch.setattr(cli, "make_bodies", lambda *a, **k: carry(js))
    common = ["-n", "2048", "-i", "4", "--im", "tpu+tracking", "--kernel",
              "mxu", "--nv"]
    assert jcli.main([*common, "--csv", str(tmp_path / "j.csv")]) == 0
    res = cli.run([*common, "--csv", str(tmp_path / "t.csv"), "--device",
                   "cpu"])
    assert res.rc == 0
    assert res.engine._acc.func is tmxu.acc_mxu
    j, t = (np.loadtxt(tmp_path / f, delimiter=",", skiprows=1, ndmin=2)
            for f in ("j.csv", "t.csv"))
    assert t.shape == j.shape == (4, 6)
    np.testing.assert_array_equal(t[:, 0], np.arange(4))
    for c in range(1, 6):
        np.testing.assert_allclose(t[:, c], j[:, c], rtol=1e-6,
                                   atol=1e-6 * np.abs(j[:, c]).max(),
                                   err_msg=f"CSV column {c} (rtol 1e-6)")
    fin = res.engine.bodies.unpadded()
    jcli_state = jcreate("tpu+tracking", js, soft=SOFT, dt=DT,
                         num_iterations=4,
                         acc_fn=lambda *a: jmxu.acc_mxu(*a, interpret=True))
    jcli_state.run(4)
    ref = jcli_state.bodies.unpadded()
    for k in ("qx", "qy", "qz"):
        assert_within_rel(fin[k], ref[k], 1e-4, f"final {k}", rms_floor=1e-4)


@pytest.mark.parametrize("scheme", ["galaxy", "random"])
def test_truncated_w_is_the_control_of_the_default_check(scheme):
    """chip_smoke.py's control of K13's "default" check: the plain version
    with W truncated to TF32 in place of rounded to nearest carries a bias
    of about -2^-12 (half a TF32 ulp of W on average), so over all bodies
    its rms gap to the rounding plain version is far above the 2e-5 that
    the kernel is held to there; rounding it is the plain version itself."""
    t = list(map(torch.from_numpy, arrays(jinit.SCHEMES[scheme](2048, 5))))
    plain = tmxu.acc_mxu_rect_plain(*t[:3], *t, SOFT, precision="default")
    same = tmxu._acc_plain(*t[:3], *t, SOFT, 2, 1, w_round=tmxu.tf32_round)
    for s, p in zip(same, plain):
        torch.testing.assert_close(s, p, rtol=0, atol=0)
    trunc = tmxu._acc_plain(*t[:3], *t, SOFT, 2, 1, w_round=tmxu.tf32_trunc)
    g = torch.stack([v.double() for v in trunc])
    p = torch.stack([v.double() for v in plain])
    rms = float((g - p).pow(2).sum().sqrt() / p.pow(2).sum().sqrt())
    bias = float(((g - p) * p).sum() / p.pow(2).sum())
    assert rms > 10 * 2e-5, rms
    assert -2.0 ** -11 < bias < -2.0 ** -13, bias
