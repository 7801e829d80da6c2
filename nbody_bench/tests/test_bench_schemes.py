"""The frozen generators give the port's generators' arrays bit for bit."""
import numpy as np
import pytest
import torch

from nbody_bench import harness
from nbody_bench.harness import FIELDS

SEEDS = [0, 123, 2**31 + 11]


def _state(inputs, n):
    from murb_tpu_torch.core.state import BodyState

    return BodyState.from_arrays(*(inputs[k] for k in FIELDS), n=n,
                                 device="cpu",
                                 ghost_positions=inputs["ghost_q"],
                                 ghost_velocities=inputs["ghost_v"])


def _same_bits(a, b):
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), k
    assert (a.n, a.padding) == (b.n, b.padding)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1000, 2048])
def test_galaxy_is_the_ports(seed, n):
    from murb_tpu_torch.core.init import init_galaxy

    spec = harness.Spec("galaxy200k.exact")
    _same_bits(_state(harness.make_inputs(spec, seed, n), n),
               init_galaxy(n, seed, device="cpu"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1000, 2048])
def test_two_clusters_is_the_ports(seed, n):
    from murb_tpu_torch.utils.profile_step import two_clusters

    spec = harness.Spec("clusters1m.adaptive")
    _same_bits(_state(harness.make_inputs(spec, seed, n), n),
               two_clusters(n, seed, device="cpu"))


@pytest.mark.parametrize("cell", ["galaxy200k.exact", "clusters1m.adaptive"])
def test_same_seed_same_inputs_other_seed_other(cell):
    spec = harness.Spec(cell)
    a, b, c = (harness.make_inputs(spec, s, 512) for s in (7, 7, 8))
    for k in ("m", "qx", "qy", "qz"):
        assert np.array_equal(a[k], b[k]) and not np.array_equal(a[k], c[k])
