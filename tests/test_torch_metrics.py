"""The port's conserved-quantity metrics against murb_tpu's, in float64.

murb_tpu reduces on scaled units (``MetricScales``) and multiplies the
scales back on the host; the port computes in native float64.  So the
values compared are murb_tpu's scaled results times their scales, as its
tracking engines record them.  The potential sweep takes its rsqrt in the
state's dtype in both packages and sums in float64: for a float32 state
the two differ by the rsqrt's last bit, about 1e-9 of the energy
(tolerance 1e-7); float64 states and |L| and the density center agree to
float64 rounding (tolerance 1e-12).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu.core import metrics as jm
from murb_tpu_torch.core import metrics as tm
from murb_tpu_torch.core.state import FIELDS, BodyState

torch.set_num_threads(2)
SOFT = 2.0e8


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def jax_metrics(js, **kw):
    """murb_tpu's metrics as its tracking engines record them."""
    sc = jm.metric_scales(js)
    e, l, dc = jm.all_metrics(js, SOFT, out_dtype=jnp.float64, scales=sc,
                              **kw)
    return (float(e) * sc.energy_scale, float(l) * sc.ang_momentum_scale,
            np.asarray(dc))


def check(got, ref, e_rtol):
    e, l, dc = got
    assert float(e) == pytest.approx(ref[0], rel=e_rtol)
    assert float(l) == pytest.approx(ref[1], rel=1e-12)
    np.testing.assert_allclose(dc.numpy(), ref[2], rtol=0,
                               atol=1e-12 * np.abs(ref[2]).max())
    assert e.dtype == l.dtype == dc.dtype == torch.float64


CASES = [("random", 2048, jnp.float32, 1e-7),
         ("random", 2049, jnp.float32, 1e-7),
         ("galaxy", 2048, jnp.float32, 1e-7),
         ("galaxy", 2049, jnp.float64, 1e-12)]


@pytest.mark.parametrize("scheme,n,dtype,e_rtol", CASES)
def test_all_metrics_match_murb_tpu(scheme, n, dtype, e_rtol):
    js = jinit.SCHEMES[scheme](n, 5).astype(dtype)
    check(tm.all_metrics(carry(js), SOFT), jax_metrics(js), e_rtol)


@pytest.mark.parametrize("scheme,n,dtype,e_rtol", CASES)
def test_masked_metrics_match_murb_tpu(scheme, n, dtype, e_rtol):
    js = jinit.SCHEMES[scheme](n, 6).astype(dtype)
    mask = np.zeros(js.npad, np.float32)
    mask[1:n:3] = 1.0                     # every third body, not the center
    got = tm.all_metrics(carry(js), SOFT, mask=torch.from_numpy(mask))
    check(got, jax_metrics(js, mask=jnp.asarray(mask)), e_rtol)


@pytest.mark.parametrize("n", [2048, 2049])
def test_energy_from_phi_matches_murb_tpu(n):
    """The fused paths' energy: the same potential sweep (self term
    included) handed to both packages gives the same energy, and equals
    the exact total energy."""
    js = jinit.init_galaxy(n, 7)
    ts = carry(js)
    q = [np.asarray(getattr(js, k), np.float64) for k in ("qx", "qy", "qz")]
    gm = np.asarray(js.m, np.float64) * np.float32(G)
    d2 = sum((a[None, :] - a[:, None]) ** 2 for a in q)
    phi = (gm[None, :] / np.sqrt(d2 + SOFT ** 2)).sum(1)
    sc = jm.metric_scales(js)
    ref = float(jm.energy_from_phi(js, jnp.asarray(phi), SOFT, jnp.float64,
                                   scales=sc)) * sc.energy_scale
    got = tm.energy_from_phi(ts, torch.from_numpy(phi), SOFT)
    assert float(got) == pytest.approx(ref, rel=1e-12)
    exact = tm.total_energy(ts, SOFT)
    assert float(got) == pytest.approx(float(exact), rel=1e-6)


def test_energy_from_phi_fails_without_the_self_term():
    """Dropping the j == i term from phi shifts the energy by
    sum_i m_i G m_i / (2 eps): a visible change on this state."""
    js = jinit.init_random(2048, 8)
    ts = carry(js)
    gm = ts.m.double() * float(np.float32(G))
    exact = float(tm.total_energy(ts, SOFT))
    qd = [getattr(ts, k).double() for k in ("qx", "qy", "qz")]
    d2 = sum((a[None, :] - a[:, None]) ** 2 for a in qd)
    inv = torch.rsqrt(d2 + SOFT ** 2)
    phi = (gm[None, :] * inv).sum(1)
    no_self = phi - gm / SOFT
    assert float(tm.energy_from_phi(ts, phi, SOFT)) == \
        pytest.approx(exact, rel=1e-7)
    shifted = float(tm.energy_from_phi(ts, no_self, SOFT))
    shift = float((ts.m.double() * gm).sum()) / (2 * SOFT)
    assert shifted == pytest.approx(exact + shift, rel=1e-7)
    assert abs(shift) > 1e-4 * abs(exact)


def test_proxy_method_matches_murb_tpu_and_exact():
    """``method="proxy"``: the Chebyshev potential at m=16 agrees with
    murb_tpu's proxy energy and with the exact energy within 1e-4, the
    tolerance of murb_tpu's own test (tests/test_metrics.py:111-117)."""
    js = jinit.init_galaxy(2048, 9)
    ts = carry(js)
    ref = jax_metrics(js, method="proxy", proxy_m=16)[0]
    got = float(tm.all_metrics(ts, SOFT, method="proxy", proxy_m=16)[0])
    assert got == pytest.approx(ref, rel=1e-4)
    assert got == pytest.approx(float(tm.total_energy(ts, SOFT)), rel=1e-4)
    with pytest.raises(ValueError, match="method"):
        tm.total_energy(ts, SOFT, method="fmm")


def test_metrics_survive_merger_scale_magnitudes():
    """Merger-scale states (masses ~1e26 kg, |L| ~ 1e47) are far beyond
    fp32's range; native float64 takes them directly, as murb_tpu's scaled
    reduction does (murb_tpu tests/test_metrics.py:321-357)."""
    rng = np.random.RandomState(7)
    n = 256
    m = rng.uniform(1e25, 7e26, n)
    q = rng.uniform(-4e11, 4e11, (n, 3))
    v = rng.uniform(-5e5, 5e5, (n, 3))
    ts = BodyState.from_arrays(m, np.zeros(n), q[:, 0], q[:, 1], q[:, 2],
                               v[:, 0], v[:, 1], v[:, 2], n=n, device="cpu")
    u = ts.unpadded()
    m, q = u["m"].astype(np.float64), np.stack(
        [u[k] for k in ("qx", "qy", "qz")], 1).astype(np.float64)
    v = np.stack([u[k] for k in ("vx", "vy", "vz")], 1).astype(np.float64)
    g32 = np.float64(np.float32(G))
    d = q[:, None, :] - q[None, :, :]
    inv = 1.0 / np.sqrt((d ** 2).sum(-1) + SOFT ** 2)
    pe = -(m * (g32 * m[None, :] * inv).sum(1) - m * g32 * m / SOFT)
    e_np = 0.5 * (pe + m * (v ** 2).sum(1)).sum()
    l_np = np.linalg.norm((m[:, None] * np.cross(q, v)).sum(0))
    e, l, dc = tm.all_metrics(ts, SOFT)
    assert abs(float(l)) > 1e40
    assert float(e) == pytest.approx(e_np, rel=1e-6)
    assert float(l) == pytest.approx(l_np, rel=1e-12)
    assert bool(torch.isfinite(dc).all())
