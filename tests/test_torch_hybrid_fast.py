"""K4's one-pass fast tier (passes 1, ``tpu+hybrid+fast``) against its
contract and murb_tpu's, on the CPU.

The port's tier (csrc/hybrid_fast.cu; its plain version
``ops/hybrid.acc_hybrid_fast_plain``, which the wrapper runs on CPU
tensors) keeps murb_tpu's contract, not its bf16 Dekker splits: W rounded
once, one pass (murb_tpu/ops/hybrid.py:105-106).  The same seeded numpy
states reach both packages.

Tolerances: the force against float64 at most 5.1e-3 (the max relative
error the TPU measured for passes 1 on the N=4096 galaxy,
tests/test_oracle.py:162-165), and no better than passes 2
(test_oracle.py's ordering); two controls (W truncated to bf16; Q
unsplit about a far centre) must exceed that limit; the trajectories of
``tpu+hybrid+fast`` within the reference's 1e-3 (random) and 1e-1
(galaxy) of murb_tpu's after 3 steps at 2049 bodies
(tests/test_engines_differential.py).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu.models import create_engine as jcreate
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine as tcreate
from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops import hybrid as th
from murb_tpu_torch.ops.mxu import tf32_round

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0
CONTRACT = 5.1e-3


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def maxrel(got, exact) -> float:
    """tests/test_oracle.py's statistic: max per-body vector error over
    max(|a|, 1e-6 max|a|)."""
    g = torch.stack([v.double() for v in got], 1)
    e = torch.stack([v.double() for v in exact], 1)
    en = e.norm(dim=1)
    return float(((g - e).norm(dim=1)
                  / torch.clamp(en, min=1e-6 * float(en.max()))).max())


@pytest.fixture(scope="module")
def galaxy4096():
    """The N=4096 galaxy (seed 123) in fp32 and its float64 forces."""
    s = jinit.init_galaxy(4096, 123)
    q = [torch.from_numpy(np.array(getattr(s, k))) for k in ("qx", "qy",
                                                             "qz")]
    gm = torch.from_numpy(np.float32(G) * np.array(s.m))
    q64 = [v.double() for v in (*q, gm)]
    exact = th.acc_hybrid_fast_plain(*q64[:3], *q64, SOFT)
    return (*q, gm), exact


def test_plain_version_keeps_the_tier_contract(galaxy4096):
    """Passes 1's arithmetic against float64 at most 5.1e-3 and no better
    than passes 2 (the fp32 sweep); the wrapper on CPU tensors is the
    plain version."""
    q, exact = galaxy4096
    p1 = th.acc_hybrid_rect_plain(*q[:3], *q, SOFT, passes=1)
    p2 = th.acc_hybrid_rect_plain(*q[:3], *q, SOFT, passes=2)
    e1, e2 = maxrel(p1, exact), maxrel(p2, exact)
    assert e1 <= CONTRACT, e1          # 3.67e-4 (TF32 W, 2^-22 Q)
    assert e2 <= e1, (e1, e2)
    for a, b in zip(th.acc_hybrid(*q[:3], q[3], SOFT, passes=1), p1):
        assert torch.equal(a, b)
    # the float64 reference is the exact sweep
    ref = th.acc_hybrid_rect_plain(*(v.double() for v in q[:3]),
                                   *(v.double() for v in q), SOFT, passes=2)
    assert maxrel(exact, ref) <= 1e-12


def _bf16_trunc(x):
    return (x.contiguous().view(torch.int32) & -0x10000).view(torch.float32)


@pytest.mark.parametrize("control", ["w_bf16_truncated",
                                     "q_unsplit_far_centre"])
def test_broken_controls_fail_the_contract(galaxy4096, control):
    """The limit catches a broken rounding (W truncated to bf16: 6.5e-3)
    and a broken centring (Q in one TF32 part about a centre five galaxy
    radii away: 0.51)."""
    q, exact = galaxy4096
    kw = ({"w_round": _bf16_trunc} if control == "w_bf16_truncated"
          else {"split": False, "center": torch.tensor([1e9, 1e9, 1e9])})
    got = th.acc_hybrid_fast_plain(*q[:3], *q, SOFT, **kw)
    assert maxrel(got, exact) > CONTRACT


def test_rounding_and_centre_are_the_kernels(galaxy4096):
    """The weights are TF32 values rounded to nearest (ties away, the
    kernel's integer add), the centre the sources' G*m-weighted mean, and
    Q's two parts carry it to 2^-22."""
    q, _ = galaxy4096
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, 1.0 + 2 ** -12],
                     dtype=torch.float32)
    assert tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0]
    c = th.fast_center(*q)
    g = q[3].double()
    want = [float((g * v.double()).sum() / g.sum()) for v in q[:3]]
    scale = max(float(v.abs().max()) for v in q[:3])
    assert torch.allclose(c.double(), torch.tensor(want, dtype=torch.float64),
                          rtol=0, atol=1e-7 * scale)
    assert c.dtype == torch.float32
    assert th.fast_center(*(torch.zeros(4),) * 4).tolist() == [0.0] * 3


def test_bf16_plain_rounds_the_fp32_tier():
    """A bf16 state: the tier's arithmetic on the arrays upcast, the
    accelerations rounded to bf16 (ops/common.bf16_plain), as the bf16
    instance's outputs are."""
    s = jinit.init_random(512, 5)
    q = [torch.from_numpy(np.array(getattr(s, k))).to(torch.bfloat16)
         for k in ("qx", "qy", "qz")]
    gm = torch.from_numpy(np.float32(G) * np.array(s.m)).to(torch.bfloat16)
    got = th.acc_hybrid_rect_plain(*q, *q, gm, SOFT, passes=1)
    ref = th.acc_hybrid_fast_plain(*(v.float() for v in q),
                                   *(v.float() for v in (*q, gm)), SOFT)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))


@pytest.mark.parametrize("scheme,eps", [("random", 1e-3), ("galaxy", 1e-1)])
def test_fast_engine_matches_murb_tpu(scheme, eps):
    """``tpu+hybrid+fast`` against murb_tpu's (its passes-1 Pallas kernel in
    interpret mode) on 2049 bodies for 3 steps."""
    js = jinit.SCHEMES[scheme](2049, 123)
    ref = jcreate("tpu+hybrid+fast", js, soft=SOFT, dt=DT)
    tgt = tcreate("tpu+hybrid+fast", carry(js), soft=SOFT, dt=DT)
    assert tgt.passes == 1
    for _ in range(3):
        ref.compute_one_iteration()
        tgt.compute_one_iteration()
    a, b = ref.bodies.unpadded(), tgt.bodies.unpadded()
    for c in ("qx", "qy", "qz"):
        assert_within_rel(b[c], a[c], eps, f"{scheme} {c} after 3 steps")


def test_tiers_route_to_their_kernels():
    """Passes 1 launches its own entry and count, never K3's kernel
    (murb_hybrid_rect refuses passes 1); each entry has its bf16
    instance."""
    assert th.hybrid_entry(1, False) == ("murb_hybrid_fast", "fast_launches")
    assert th.hybrid_entry(1, True) == ("murb_hybrid_fast_bf16",
                                        "fast_bf16_launches")
    assert th.hybrid_entry(2, False) == ("murb_hybrid_rect", "launches")
    assert th.hybrid_entry(3, True) == ("murb_hybrid_rect_bf16",
                                        "bf16_launches")
    for attr in ("launches", "bf16_launches", "fast_launches",
                 "fast_bf16_launches"):
        assert getattr(th.acc_hybrid_rect, attr) == 0
    src = (Path(cuda.CSRC) / "hybrid.cu").read_text()
    assert src.count("if (passes < 2 || passes > 3)") == 2


def test_python_constants_mirror_the_kernel():
    """The wrapper's geometry, chunk and padding are the kernel's, and the
    packed scratch holds nj padded to whole packs."""
    src = (Path(cuda.CSRC) / "hybrid_fast.cu").read_text()
    const = dict(re.findall(r"constexpr int (kFast\w+) = (\d+);", src))
    assert (int(const["kFastBlockI"]), int(const["kFastBlockJ"]),
            int(const["kFastChunk"]), int(const["kFastPackSources"])) == (
        th.FAST_BLOCK_I, th.FAST_BLOCK_J, th.FAST_CHUNK_FLOATS,
        th.FAST_PACK_SOURCES)
    for nj, chunks in ((1, 64), (512, 64), (513, 128), (200_192, 25_024)):
        assert th.fast_packed(nj, torch.device("cpu")).numel() == \
            chunks * th.FAST_CHUNK_FLOATS
