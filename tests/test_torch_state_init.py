"""murb_tpu_torch state and initializers against murb_tpu.

A state built by ``murb_tpu.core.init`` crosses into the port through
``BodyState.from_numpy`` bit for bit, ghosts included.  The port's
initializers draw from a torch.Generator, so they are held to the JAX
package's distributions, not its bits (murb_tpu/core/init.py:5-10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murb_tpu.core import init as jinit
from murb_tpu_torch.core import init as tinit
from murb_tpu_torch.core.state import FIELDS, BodyState

torch.set_num_threads(2)


def carry(js) -> BodyState:
    """The JAX state's eight padded arrays, ghosts included, in the port."""
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


@pytest.mark.parametrize("scheme,n,dtype", [("galaxy", 2049, jnp.float32),
                                            ("random", 2048, jnp.float32),
                                            ("random", 300, jnp.float64)])
def test_from_numpy_round_trip_is_exact(scheme, n, dtype):
    js = jinit.SCHEMES[scheme](n, 7).astype(dtype)
    ts = carry(js)
    assert (ts.n, ts.padding, ts.npad) == (js.n, js.padding, js.npad)
    back = ts.to_numpy()
    for k in FIELDS:
        a = np.asarray(getattr(js, k))
        assert back[k].dtype == a.dtype, k
        np.testing.assert_array_equal(back[k], a, err_msg=f"{k} (exact)")
    u_j, u_t = js.unpadded(), ts.unpadded()
    for k in FIELDS:
        np.testing.assert_array_equal(u_t[k], u_j[k], err_msg=k)
    assert ts.allocated_bytes == js.allocated_bytes


def test_from_numpy_rejects_wrong_length():
    js = jinit.init_random(300, 1)
    arrays = {k: np.asarray(getattr(js, k)) for k in FIELDS}
    arrays["qx"] = arrays["qx"][:-1]
    with pytest.raises(ValueError, match="qx"):
        BodyState.from_numpy(arrays, js.n, js.padding, "cpu")


def test_repad_astype_to():
    s = tinit.init_random(300, 2, device="cpu")       # npad 512
    assert s.npad == 512 and s.padding == 212
    r = s.repad(2048)
    assert r.npad == 2048 and r.n == 300
    assert float(r.m[300:].abs().max()) == 0.0         # ghosts stay massless
    torch.testing.assert_close(r.qx[:512], s.qx, rtol=0, atol=0)
    assert s.repad(256) is s
    d = s.astype(torch.float64)
    assert d.dtype == torch.float64 and d.allocated_bytes == 8 * 512 * 8
    assert s.to("cpu").device.type == "cpu"


def _stats(a):
    a = np.asarray(a, np.float64)
    return a.mean(), a.std()


def test_galaxy_distribution_matches_jax():
    n = 8192
    t = tinit.init_galaxy(n, 5, device="cpu").unpadded()
    j = jinit.init_galaxy(n, 5).unpadded()
    # body 0: the heavy central mass at rest at the origin
    assert t["m"][0] == np.float32(2.0e24) and t["r"][0] == 0.0
    for k in ("qx", "qy", "qz", "vx", "vy", "vz"):
        assert t[k][0] == 0.0, k
    m, r = t["m"][1:].astype(np.float64), t["r"][1:].astype(np.float64)
    assert m.min() >= 0.0 and m.max() < 5.0e20
    np.testing.assert_allclose(r, m * 2.5e-15, rtol=1e-6)
    q = np.stack([t["qx"], t["qy"], t["qz"]], 1)[1:].astype(np.float64)
    dist = np.linalg.norm(q, axis=1)
    assert dist.min() >= 1.0e8 * (1 - 1e-6) and dist.max() <= 2.0e8 * (1 + 1e-6)
    # circular velocities v = omega * (qy, -qx, 0)
    np.testing.assert_allclose(t["vx"][1:], t["qy"][1:] * 4.0e-6, rtol=1e-6)
    np.testing.assert_allclose(t["vy"][1:], -t["qx"][1:] * 4.0e-6, rtol=1e-6)
    assert np.all(t["vz"] == 0.0)
    # the same distributions as murb_tpu's: means/stds within sampling noise
    for k, rel in (("m", 0.03), ("qx", 0.05), ("qy", 0.05), ("qz", 0.05)):
        (mt, st), (mj, sj) = _stats(t[k][1:]), _stats(j[k][1:])
        assert abs(st - sj) <= rel * sj, f"{k} std {st} vs {sj} (rel {rel})"
        assert abs(mt - mj) <= 5 * sj / np.sqrt(n), f"{k} mean {mt} vs {mj}"


def test_random_distribution_matches_jax():
    n = 8192
    t = tinit.init_random(n, 9, device="cpu").unpadded()
    j = jinit.init_random(n, 9).unpadded()
    m = t["m"].astype(np.float64)
    assert m.min() >= 0.0 and m.max() < 5.0e21
    np.testing.assert_allclose(t["r"], m * 0.5e-14, rtol=1e-6)
    box = {"qx": (-6.65e8, 6.65e8), "qy": (-5e8, 5e8), "qz": (-15e8, -5e8)}
    for k, (lo, hi) in box.items():
        assert t[k].min() >= lo - 1.0 and t[k].max() <= hi + 1.0, k
    for k in ("vx", "vy", "vz"):
        assert np.abs(t[k]).max() <= 100.0, k
    for k in ("m", "qx", "qy", "qz", "vx", "vy", "vz"):
        (mt, st), (mj, sj) = _stats(t[k]), _stats(j[k])
        assert abs(st - sj) <= 0.03 * sj, f"{k} std {st} vs {sj} (rel 0.03)"
        assert abs(mt - mj) <= 5 * sj / np.sqrt(n), f"{k} mean {mt} vs {mj}"


def test_ghosts_are_massless_and_in_the_box():
    s = tinit.init_random(2049, 4, device="cpu")
    assert s.padding == 2304 - 2049
    for k in ("m", "r"):
        assert float(getattr(s, k)[s.n:].abs().max()) == 0.0
    gq = s.qz[s.n:]
    assert float(gq.min()) >= -15e8 - 1.0 and float(gq.max()) <= -5e8 + 1.0


def test_init_is_deterministic_by_seed():
    a, b, c = (tinit.init_galaxy(1000, s, device="cpu").to_numpy()
               for s in (3, 3, 4))
    for k in FIELDS:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["qx"], c["qx"])


def test_make_bodies_schemes(tmp_path):
    s = tinit.make_bodies(500, "random", 1, dtype=torch.float64,
                          device="cpu")
    assert s.dtype == torch.float64 and s.n == 500
    # any other scheme falls through to the two-galaxy file
    with pytest.raises(FileNotFoundError, match="scheme-file"):
        tinit.make_bodies(500, "milkyway_andromeda.tab", device="cpu",
                          scheme_file=str(tmp_path / "missing.tab"))


@pytest.mark.parametrize("build", [
    lambda: tinit.make_bodies(300, "random"),
    lambda: tinit.init_galaxy(300),
    lambda: tinit.init_random(300),
    lambda: BodyState.from_arrays(*([np.ones(4)] * 8)),
])
def test_builders_default_to_the_card_and_raise_without_one(monkeypatch,
                                                            build):
    """No device argument means the card: without one the builders raise
    instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
