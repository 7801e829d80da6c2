"""The port's history store and CSV export against murb_tpu's.

murb_tpu writes its CSV with the C++ writer of ``native/murbnative.cpp``
where it builds (the Python writer otherwise); the port writes with Python
only.  The text must be the same, byte for byte.
"""
import numpy as np
import pytest

from murb_tpu.core import history as jh
from murb_tpu_torch.core import history as th


def _series(rng, n):
    scale = 10.0 ** rng.uniform(-30, 40, size=(n, 5))
    vals = rng.normal(size=(n, 5)) * scale
    vals[0] = [0.0, -0.0, 1.0, -1e-300, 1e300]          # edge values
    return vals[:, 0], vals[:, 1], vals[:, 2:]


def _fill(h, e, l, dc):
    for i in range(len(e)):
        h.set_energy_at(i, e[i])
        h.set_ang_momentum_at(i, l[i])
        h.set_density_center_at(i, dc[i])


@pytest.mark.parametrize("n", [1, 7, 300])
def test_csv_text_equals_murb_tpu(tmp_path, n):
    e, l, dc = _series(np.random.default_rng(n), n)
    j, t = jh.SimulationHistory(n), th.SimulationHistory(n)
    _fill(j, e, l, dc)
    _fill(t, e, l, dc)
    j.save_metrics_to_csv(str(tmp_path / "j.csv"))
    t.save_metrics_to_csv(str(tmp_path / "t.csv"))
    jt = (tmp_path / "j.csv").read_text()
    assert (tmp_path / "t.csv").read_text() == jt
    assert jt.count("\n") == n + 1 and jt.startswith(th.CSV_HEADER + "\n")
    back = jh.SimulationHistory.load_metrics_from_csv(str(tmp_path / "t.csv"))
    np.testing.assert_array_equal(back.energies, e)
    np.testing.assert_array_equal(back.density_centers, dc)


def test_set_rows_fills_and_clips_like_per_row_setters():
    e, l, dc = _series(np.random.default_rng(3), 10)
    a, b = th.SimulationHistory(6), th.SimulationHistory(6)
    _fill(a, e[:6], l[:6], dc[:6])
    b.set_rows(0, e[:4], l[:4], dc[:4])
    b.set_rows(4, e[4:], l[4:], dc[4:])          # rows past 6 are dropped
    b.set_rows(9, e, l, dc)                      # starts past the end
    for k in ("energies", "ang_momentums", "density_centers"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))


def test_resize_and_getters_match_murb_tpu():
    e, l, dc = _series(np.random.default_rng(5), 8)
    j, t = jh.SimulationHistory(8), th.SimulationHistory(8)
    _fill(j, e, l, dc)
    _fill(t, e, l, dc)
    for n in (5, 12):
        j.set_num_iterations(n)
        t.set_num_iterations(n)
        assert t.num_iterations == j.num_iterations == n
        for k in ("energies", "ang_momentums", "density_centers"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    assert t.get_energy_at(3) == j.get_energy_at(3)
    assert t.get_ang_momentum_at(4) == j.get_ang_momentum_at(4)
    np.testing.assert_array_equal(t.get_density_center_at(2),
                                  j.get_density_center_at(2))


def test_multi_galaxy_global_series_is_the_sum(tmp_path):
    rng = np.random.default_rng(11)
    j = jh.MultiGalaxySimulationHistory(20, num_galaxies=3)
    t = th.MultiGalaxySimulationHistory(20, num_galaxies=3)
    for g in range(3):
        e, l, dc = _series(rng, 20)
        _fill(j.get_galaxy(g), e, l, dc)
        _fill(t.get_galaxy(g), e, l, dc)
    for _ in range(2):                           # idempotent
        j.update_global_properties()
        t.update_global_properties()
    for k in ("energies", "ang_momentums", "density_centers"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    j.save_metrics_to_csv(str(tmp_path / "j.csv"))
    t.save_metrics_to_csv(str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
