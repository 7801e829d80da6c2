"""The port's CADNA analogue (murb_tpu_torch/numerics.py): murb_tpu's
tests/test_numerics.py cases, with the digit medians held to murb_tpu's on
the same state.

Tolerances on the medians: 0.5 digit for the fp32-against-float64 estimate
(the same arithmetic in both packages, summed in other orders) and 1.5
digits for the ulp ensemble (the two packages draw their perturbations
from different generators; the medians sit near 7 digits)."""
import dataclasses

import numpy as np
import pytest
import torch

from murb_tpu import numerics as jnum
from murb_tpu.core import init as jinit
from murb_tpu_torch import numerics as tnum
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine

torch.set_num_threads(2)


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def test_significant_digits_formula():
    a = np.array([1.0, 1.0, 1.0])
    b = np.array([1.0, 1.0 + 1e-6, 2.0])
    d = tnum.significant_digits(a, b)
    assert d[0] == 15.0                  # identical -> max digits
    assert 5.5 < d[1] < 6.5              # 1e-6 spread -> ~6 digits
    assert d[2] < 1.0                    # totally different -> ~0
    np.testing.assert_array_equal(d, jnum.significant_digits(a, b))


@pytest.mark.parametrize("tag", ["xla+chunked", "tpu+mxu"])
def test_vs_reference_digits_match_murb_tpu(tag):
    """fp32 trajectories agree with the float64 reference to about four
    digits after 3 steps of the random scheme; the float64 run is the
    plain sweep whatever the fp32 tag."""
    js = jinit.SCHEMES["random"](256, 3)
    d = tnum.significant_digits_vs_reference(carry(js), 3, tag=tag)
    jd = jnum.significant_digits_vs_reference(js, 3)
    assert np.median(d["qx"]) > 4.0 and d["qx"].min() >= 0.0
    for k in ("qx", "vx"):
        assert abs(np.median(d[k]) - np.median(jd[k])) <= 0.5, k
    txt = tnum.report(d)
    assert "qx" in txt and "median" in txt
    assert txt.splitlines()[0] == jnum.report(jd).splitlines()[0]


def test_stochastic_ensemble_digits_match_murb_tpu():
    js = jinit.SCHEMES["random"](256, 5)
    d = tnum.stochastic_ensemble_digits(carry(js), 2, replicas=3)
    jd = jnum.stochastic_ensemble_digits(js, 2, replicas=3)
    # one-ulp perturbations after 2 steps: positions still reproducible
    assert np.median(d["qx"]) > 5.0
    assert abs(np.median(d["qx"]) - np.median(jd["qx"])) <= 1.5
    # the same seed draws the same perturbations
    again = tnum.stochastic_ensemble_digits(carry(js), 2, replicas=3)
    for k in d:
        np.testing.assert_array_equal(d[k], again[k])
    with pytest.raises(ValueError, match="replicas"):
        tnum.stochastic_ensemble_digits(carry(js), 1, replicas=1)


def test_ulp_perturbation_moves_each_value_by_one_ulp():
    s = carry(jinit.SCHEMES["random"](256, 2))
    p = tnum._ulp_perturb(s, torch.Generator().manual_seed(0))
    for k in ("qx", "vz"):
        a, b = getattr(s, k), getattr(p, k)
        up = torch.nextafter(a, torch.full_like(a, float("inf")))
        down = torch.nextafter(a, torch.full_like(a, -float("inf")))
        assert bool(((b == up) | (b == down)).all())
        assert 0 < int((b == up).sum()) < a.numel()
    torch.testing.assert_close(p.m, s.m, rtol=0, atol=0)


def test_engine_assert_finite():
    e = create_engine("xla+chunked", carry(jinit.SCHEMES["random"](256, 1)))
    e.compute_one_iteration()
    e.assert_finite()  # a healthy state passes
    qx = e._state.qx.clone()
    qx[0] = float("nan")
    e._state = dataclasses.replace(e._state, qx=qx)
    with pytest.raises(FloatingPointError, match="non-finite"):
        e.assert_finite()
