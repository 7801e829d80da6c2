"""The frozen roofline counts reproduce the kernel table's bounds."""
import pytest

from nbody_bench import roofline


def test_the_bounds_at_200192_squared():
    f = roofline.pair_floor_ms(200_192.0 ** 2)
    assert f["fp32"] == pytest.approx(11.9632, abs=5e-5)
    assert f["mufu"] == pytest.approx(9.5837, abs=5e-5)


def test_the_exact_step_counts_real_bodies():
    # n^2 at n = 200,000, not the padded 200,192: the fp32 floor binds
    assert roofline.exact_sweep_floor_ms(200_000) == pytest.approx(
        20 * 4e10 / 67e12 * 1e3)
