"""``--precision bf16`` in murb_tpu_torch against murb_tpu, on the CPU.

The same bf16 inputs, made from murb_tpu's seeded states, go through
murb_tpu's kernels (its Pallas kernels in interpret mode, as
tests/test_oracle.py:243-264 runs them) and the port's wrappers, which run
their plain versions on CPU tensors: each upcasts bf16 to fp32 (exact),
computes as for fp32 and rounds the outputs to bf16 where murb_tpu's
kernel casts them back (``ops/common.bf16_plain``).

Tolerances: forces WithinRel 1e-2, one bf16 rounding of the fp32 result.
Where murb_tpu's own arithmetic differs from an fp32 sweep (K4's and K6's
P[0:3] - q P[3] algebra, K2's bf16x3 dots, its stages' fused bf16 chains
on XLA's CPU backend), the wider bound is stated beside the test and
recorded with both numbers in ROADMAP.md Queue 3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu_torch.core import init as tinit
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.common import bf16_plain, weights_dtype

torch.set_num_threads(2)
SOFT = 2.0e8
BF16 = torch.bfloat16


def to_torch(*arrays):
    """murb_tpu arrays (bf16 or not) as port tensors of the same values."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        t = torch.from_numpy(a.astype(np.float32))
        out.append(t.to(BF16) if a.dtype.name == "bfloat16" else t)
    return out


def f32(x) -> np.ndarray:
    """A tensor or array as float32 numpy (bf16 is exact in float32)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def bits(x) -> np.ndarray:
    return f32(x).view(np.uint32)


# ----------------------------------------------------------- the state
@pytest.mark.parametrize("n", [2048, 2049])
@pytest.mark.parametrize("scheme", ["random", "galaxy"])
def test_bf16_state_rounds_as_murb_tpu(scheme, n):
    """murb_tpu's float32 samples, through the port's ``from_arrays`` at
    bf16, give murb_tpu's bf16 state bit for bit, ghosts included, and
    the same bytes."""
    j32 = jinit.SCHEMES[scheme](n, 7)
    j16 = jinit.SCHEMES[scheme](n, 7, dtype=jnp.bfloat16)
    a = {k: np.asarray(getattr(j32, k)) for k in FIELDS}
    gq = np.stack([a[c][n:] for c in ("qx", "qy", "qz")], 1)
    gv = np.stack([a[c][n:] for c in ("vx", "vy", "vz")], 1)
    t = BodyState.from_arrays(*(a[k][:n] for k in FIELDS), n=n, dtype=BF16,
                              device="cpu", ghost_positions=gq,
                              ghost_velocities=gv)
    assert t.dtype == BF16 and (t.n, t.padding) == (j16.n, j16.padding)
    back = t.to_numpy()
    for k in FIELDS:
        assert back[k].dtype == np.float32, k
        np.testing.assert_array_equal(bits(back[k]), bits(getattr(j16, k)),
                                      err_msg=k)
    assert t.allocated_bytes == j16.allocated_bytes == 2 * 8 * j16.npad
    # murb_tpu's bf16 arrays cross into the port as they are
    c = BodyState.from_numpy({k: np.asarray(getattr(j16, k)) for k in FIELDS},
                             j16.n, j16.padding, "cpu")
    assert all(torch.equal(getattr(c, k), getattr(t, k)) for k in FIELDS)


@pytest.mark.parametrize("scheme", ["random", "galaxy"])
def test_port_schemes_sample_fp32_then_round(scheme):
    """The port's own schemes at bf16: the fp32 state rounded once."""
    s32 = tinit.make_bodies(2049, scheme, 5, device="cpu")
    s16 = tinit.make_bodies(2049, scheme, 5, dtype=BF16, device="cpu")
    assert s16.dtype == BF16 and s16.allocated_bytes * 2 == \
        s32.allocated_bytes
    for k in FIELDS:
        assert torch.equal(getattr(s16, k), getattr(s32, k).to(BF16)), k
    assert s16.unpadded()["qx"].dtype == np.float32


# ------------------------------------------------------ the wrappers' glue
def test_kernel_inputs_route_bf16():
    """bf16 goes to a bf16 instance as it is (no copy) and to any other
    kernel as an exact, announced float32 upcast; other dtypes raise."""
    x = torch.linspace(-3, 3, 64).to(BF16)
    seen = []
    (same,) = cuda.kernel_inputs("t", x.device, 64, x, bf16=True,
                                 notify=lambda *a: seen.append(a))
    assert same.data_ptr() == x.data_ptr() and not seen
    (up,) = cuda.kernel_inputs("t", x.device, 64, x,
                               notify=lambda *a: seen.append(a))
    assert up.dtype == torch.float32 and torch.equal(up, x.float())
    assert seen == [("t", BF16)]
    assert cuda.all_bf16(x, x) and not cuda.all_bf16(x, x.float())
    with pytest.raises(TypeError, match="bfloat16"):
        cuda.kernel_inputs("t", x.device, 64, x.half(), notify=print)


def test_c_entries_match_their_signatures():
    """Every ``extern "C"`` entry of csrc/*.cu, the bf16 instances' among
    them, has a ctypes signature with as many arguments as its C
    parameters, and every signature an entry: a mismatch would show only
    on the card."""
    import re
    from pathlib import Path

    entries = {}
    for src in sorted(Path(cuda.__file__).parents[1].joinpath(
            "csrc").glob("*.cu")):
        for m in re.finditer(r'extern "C"\s+\w+\s+(murb_\w+)\s*\(([^)]*)\)',
                             src.read_text()):
            entries[m.group(1)] = len([p for p in m.group(2).split(",")
                                       if p.strip()])
    assert {"murb_p2m_grid_bf16", "murb_l2p_grid_bf16",
            "murb_tile_rect_bf16"} <= set(entries)
    assert entries == {k: len(v) for k, v in cuda._SIGNATURES.items()}


def test_bf16_plain_upcasts_and_rounds():
    seen = []

    def fn(a, b, *, c):
        seen.append((a.dtype, b.dtype, c[0].dtype))
        return (a + b, {"w": c[0] * 2, "n": 3})

    a = torch.tensor([1.0, 2.0]).to(BF16)
    b = torch.tensor([0.5, 0.25])
    out = bf16_plain(fn)(a, b, c=[a])
    assert seen[-1] == (torch.float32,) * 3
    assert out[0].dtype == BF16 and out[1]["w"].dtype == BF16
    assert out[1]["n"] == 3
    kept = bf16_plain(round_outputs=False)(fn)(a, b, c=[a])
    assert kept[0].dtype == torch.float32
    f64 = bf16_plain(fn)(b.double(), b.double(), c=[b.double()])
    assert f64[0].dtype == torch.float64 and seen[-1][0] == torch.float64
    assert weights_dtype(BF16) == torch.float32
    assert weights_dtype(torch.float64) == torch.float64


# ------------------------------------------------- the kernels' plain versions
def _bf16_box(n=512, seed=13):
    """tests/test_oracle.py:243-264's state: murb_tpu's random box in bf16
    and G*m rounded to bf16."""
    s32 = jinit.init_random(n, seed)
    s16 = s32.astype(jnp.bfloat16)
    gm16 = jnp.asarray(np.float32(G) * np.asarray(s32.m)).astype(jnp.bfloat16)
    return (s16.qx, s16.qy, s16.qz, gm16)


def _check_forces(got, ref, eps, rms_floor, msg):
    for c, (g, r) in enumerate(zip(got, ref)):
        assert_within_rel(f32(g).astype(np.float64),
                          f32(r).astype(np.float64), eps, f"{msg} [{c}]",
                          rms_floor=rms_floor)


def _float64_forces(j):
    from murb_tpu_torch.ops.naive import acc_rect

    q = [t.double() for t in to_torch(*j)]
    return acc_rect(*q[:3], *q, SOFT)


@pytest.mark.parametrize("kernel", ["tile", "hybrid-p1", "hybrid-p2",
                                    "hybrid-p3", "phi-K6"])
def test_sweeps_match_murb_tpu_kernels(kernel):
    """K3, K4's three tiers and K6's force on bf16 inputs against murb_tpu's
    kernels (interpret mode): bf16 out on both sides.  K3 (both sides an
    fp32 sweep, one rounding) WithinRel 1e-2; K4 and K6 WithinRel 1e-2
    with an rms floor of 1e-2: murb_tpu's P[0:3] - q P[3] algebra misses
    the float64 sweep by up to 0.21 relative on cancelling components
    (ROADMAP.md Queue 3), where the port's sweep stays within 1e-2 of it
    with no floor (checked here).  K4's passes 1 is the lossy fast tier
    (TF32 weights, csrc/hybrid_fast.cu) and is held to float64 by its
    contract, murb_tpu's 5.1e-3 max per-body error."""
    from murb_tpu.ops import hybrid as jh
    from murb_tpu.ops.tile_pallas import acc_tile as jtile
    from murb_tpu_torch.ops import hybrid as th
    from murb_tpu_torch.ops.tile import acc_tile as ttile

    j = _bf16_box()
    t = to_torch(*j)
    if kernel == "tile":
        ref, got, floor = jtile(*j, SOFT), ttile(*t, SOFT), 0.0
    elif kernel.startswith("hybrid"):
        p = int(kernel[-1])
        ref = jh.acc_hybrid(*j, SOFT, passes=p)
        got, floor = th.acc_hybrid(*t, SOFT, passes=p), 1e-2
    else:
        rows = np.stack([f32(j[3]) * (np.arange(512) % 2 == k)
                         for k in range(2)])
        ref, phi_j = jh.acc_phi_rows_hybrid(
            *j, jnp.asarray(rows).astype(jnp.bfloat16), SOFT)
        got, phi_t = th.acc_phi_rows_hybrid(
            *t, torch.from_numpy(rows).to(BF16), SOFT)
        assert phi_t.dtype == BF16 and phi_j.dtype == jnp.bfloat16
        assert_within_rel(f32(phi_t), f32(phi_j), 1e-2, "K6 phi")
        floor = 1e-2
    assert got.ax.dtype == BF16 and ref.ax.dtype == jnp.bfloat16
    _check_forces(got, ref, 1e-2, floor, f"bf16 {kernel} vs murb_tpu")
    exact = _float64_forces(j)
    if kernel == "hybrid-p1":
        # the fast tier is lossy (TF32 weights, csrc/hybrid_fast.cu): held to
        # its contract, murb_tpu's 5.1e-3 max per-body error, bf16 out
        g = np.stack([f32(a).astype(np.float64) for a in got], 1)
        e = np.stack([f32(a).astype(np.float64) for a in exact], 1)
        en = np.linalg.norm(e, axis=1)
        worst = (np.linalg.norm(g - e, axis=1)
                 / np.maximum(en, 1e-6 * en.max())).max()
        assert worst <= 5.1e-3, worst
    else:
        _check_forces(got, exact, 1e-2, 0.0, f"bf16 {kernel} vs float64")


def test_phi_rows_match_murb_tpu_and_stay_fp32():
    """K5 on bf16 inputs: float32 potentials, as murb_tpu's kernel returns
    them, WithinRel 1e-2."""
    from murb_tpu.ops.hybrid import phi_rows_rect as jphi
    from murb_tpu_torch.ops.hybrid import phi_rows_rect as tphi

    j = _bf16_box()
    t = to_torch(*j)
    rows = np.stack([f32(j[3]) * (np.arange(512) % 3 == k)
                     for k in range(3)])
    ref = jphi(*j[:3], *j[:3], jnp.asarray(rows).astype(jnp.bfloat16), SOFT)
    got = tphi(*t[:3], *t[:3], torch.from_numpy(rows).to(BF16), SOFT)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert_within_rel(got.numpy(), np.asarray(ref), 1e-2, "bf16 K5")


@pytest.fixture(scope="module")
def galaxy16():
    """murb_tpu's 2048-body galaxy in bf16, its G*m, box and the port's
    copies."""
    from murb_tpu.ops import proxy as jp
    from murb_tpu_torch.ops import proxy as tp

    js = jinit.init_galaxy(2048, 123, dtype=jnp.bfloat16)
    gm = jnp.asarray(G, jnp.bfloat16) * js.m
    j = (js.qx, js.qy, js.qz, gm)
    t = to_torch(*j)
    jc, jh = jp.bounding_box(*j[:3], gm > 0)
    tc, th = tp.bounding_box(*t[:3], t[3] > 0)
    return j, t, (jc, jh), (tc, th)


def test_proxy_box_is_murb_tpus(galaxy16):
    """The box stage in bf16: murb_tpu's bits."""
    _, _, (jc, jh), (tc, th) = galaxy16
    assert tc.dtype == BF16
    np.testing.assert_array_equal(bits(tc), bits(jc))
    np.testing.assert_array_equal(bits(th), bits(jh))


@pytest.mark.parametrize("m", [8, 12])
def test_p2m_and_l2p_match_murb_tpu_kernels(galaxy16, m):
    """K1 and K2 on the bf16 galaxy against murb_tpu's proxy kernels
    (interpret mode): W float32 on both sides, WithinRel 1e-2; the
    interpolated fields bf16, WithinRel 1e-2 with an rms floor of 1e-3
    (values near zero of oscillating fields: murb_tpu dots in bf16x3)."""
    from murb_tpu.ops.proxy_pallas import l2p_fused_multi as jl2p
    from murb_tpu.ops.proxy_pallas import p2m_fused as jp2m
    from murb_tpu_torch.ops import proxy_kernels as tk

    j, t, (jc, jh), (tc, th) = galaxy16
    wj = jp2m(*j, jc, jh, m=m, block=512, interpret=True)
    wt = tk.p2m_fused(*t, tc, th, m=m)
    assert wt.dtype == torch.float32 and wj.dtype == jnp.float32
    assert_within_rel(wt.numpy(), np.asarray(wj), 1e-2, f"bf16 K1 m={m}")
    fields = [np.asarray(wj) * (k + 1) for k in range(4)]
    oj = jl2p(*j[:3], jc, jh, tuple(fields), m=m, block=512, interpret=True)
    ot = tk.l2p_fused_multi(*t[:3], tc, th,
                            tuple(torch.from_numpy(f.copy()) for f in fields),
                            m=m)
    for k, (a, b) in enumerate(zip(ot, oj)):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16
        assert_within_rel(f32(a).astype(np.float64),
                          f32(b).astype(np.float64), 1e-2,
                          f"bf16 K2 m={m} field {k}", rms_floor=1e-3)


def test_grid_p2m_and_l2p_match_murb_tpu():
    """K8 and K9 (the hierarchy's anterpolation) on murb_tpu's bf16 random
    box at C=4, m=8: W float32, the fields bf16, held to murb_tpu's grid
    stages (``murb_tpu/ops/fmm.py`` p2m_grid, l2p_grid) on the bf16 inputs
    upcast to fp32, which is what its Pallas kernels compute (they upcast
    their refs; their W comes in another layout).  WithinRel 1e-2, rms
    floors 1e-4 (W) and 1e-3 (fields) for values near zero."""
    from murb_tpu.ops import fmm as jf
    from murb_tpu.ops import proxy as jp
    from murb_tpu_torch.ops import fmm_kernels as fk
    from murb_tpu_torch.ops import proxy as tp

    js = jinit.init_random(2048, 7, dtype=jnp.bfloat16)
    gm = jnp.asarray(G, jnp.bfloat16) * js.m
    j = (js.qx, js.qy, js.qz, gm)
    t = to_torch(*j)
    jc, jh = jp.bounding_box(*j[:3], gm > 0)
    tc, th = tp.bounding_box(*t[:3], t[3] > 0)
    j32 = [v.astype(jnp.float32) for v in (*j, jc, jh)]
    wj = jf.p2m_grid(*j32, m=8, C=4)
    wt = fk.p2m_grid_fused(*t, tc, th, m=8, C=4)
    assert wt.dtype == torch.float32
    assert_within_rel(wt.numpy(), np.asarray(wj), 1e-2, "bf16 K8",
                      rms_floor=1e-4)
    fields = [np.asarray(wj) * (k + 1) for k in range(3)]
    oj = jf.l2p_grid(*j32[:3], *j32[4:], tuple(jnp.asarray(f)
                                               for f in fields), m=8, C=4)
    ot = fk.l2p_grid_fused(*t[:3], tc, th,
                           tuple(torch.from_numpy(f.copy()) for f in fields),
                           m=8, C=4)
    for k, (a, b) in enumerate(zip(ot, oj)):
        assert a.dtype == BF16
        assert_within_rel(f32(a).astype(np.float64),
                          f32(b).astype(np.float64), 1e-2,
                          f"bf16 K9 field {k}", rms_floor=1e-3)


@pytest.mark.parametrize("m", [12, 16])
def test_acc_proxy_matches_murb_tpu(galaxy16, m):
    """The whole proxy pass (box, heavy split, K1, the node sweep, K2, the
    heavy corrections) on the bf16 galaxy, bf16 out, against murb_tpu's
    ``acc_proxy`` (its bf16 jnp stages on the CPU).  WithinRel 2e-2, rms
    floor 2e-2: at 1e-2 the z component reads 1.58x its allowance, where
    the port misses the float64 sweep by 5.2e-3 of max|a| and murb_tpu by
    2.1e-2 (ROADMAP.md Queue 3)."""
    from murb_tpu.ops.proxy import acc_proxy as jproxy
    from murb_tpu_torch.ops.proxy import acc_proxy as tproxy

    j, t, _, _ = galaxy16
    ref, got = jproxy(*j, SOFT, m=m), tproxy(*t, SOFT, m=m)
    assert got.ax.dtype == BF16 and ref.ax.dtype == jnp.bfloat16
    _check_forces(got, ref, 2e-2, 2e-2, f"bf16 acc_proxy m={m}")


def test_acc_fmm_matches_murb_tpu():
    """The hierarchy (K8, K7, K9 and the stages) on the bf16 random box at
    (m, L) = (8, 2), against murb_tpu's ``acc_fmm``: WithinRel 4e-2, rms
    floor 4e-2 (at 2e-2 the y component reads 1.33x, where the port misses
    the float64 sweep by 3.5e-3 of max|a| and murb_tpu by 2.9e-2;
    ROADMAP.md Queue 3)."""
    from murb_tpu.ops.fmm import acc_fmm as jfmm
    from murb_tpu_torch.ops.fmm import acc_fmm as tfmm

    js = jinit.init_random(2048, 7, dtype=jnp.bfloat16)
    gm = jnp.asarray(G, jnp.bfloat16) * js.m
    j = (js.qx, js.qy, js.qz, gm)
    ref = jfmm(*j, SOFT, m=8, levels=2)
    got = tfmm(*to_torch(*j), SOFT, m=8, levels=2)
    assert got.ax.dtype == BF16 and ref.ax.dtype == jnp.bfloat16
    _check_forces(got, ref, 4e-2, 4e-2, "bf16 acc_fmm (8, 2)")
