"""ProxyEngine's four options of murb_tpu's constructor (max_m, heavy_k,
box_margin, cost_slack; murb_tpu/models/engines.py:357-376): with one
value other than the default, the port and murb_tpu pick the same
configuration on the same state, each built through its package's
registry (``create_engine("tpu+proxy", ...)``), which must forward them."""
import numpy as np
import pytest
import torch

from murb_tpu.core import init as jinit
from murb_tpu.models import create_engine as jcreate
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine as tcreate
from murb_tpu_torch.models.engines import ProxyEngine as TProxy

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0


def pick(e):
    return e.m, e.levels, e.cells, e.using_proxy


@pytest.mark.parametrize("scheme", ["galaxy", "random"])
@pytest.mark.parametrize("option", [{"max_m": 12}, {"heavy_k": 4},
                                    {"box_margin": 3.0},
                                    {"cost_slack": 1000.0}])
def test_options_pick_as_murb_tpu(option, scheme):
    """2048 bodies: max_m=12 rejects the galaxy's m=16 rung, box_margin=3
    sends it to the hierarchy, cost_slack=1000 admits the random box's
    hierarchy, heavy_k=4 moves the validated error; the picks and
    ``using_proxy`` equal murb_tpu's, and the options are kept."""
    js = jinit.SCHEMES[scheme](2048, 7)
    ts = BodyState.from_numpy({k: np.asarray(getattr(js, k))
                               for k in FIELDS}, js.n, js.padding, "cpu")
    j = jcreate("tpu+proxy", js, soft=SOFT, dt=DT, **option)
    t = tcreate("tpu+proxy", ts, soft=SOFT, dt=DT, **option)
    assert pick(t) == pick(j), (option, scheme)
    (name, value), = option.items()
    assert getattr(t, name) == value == getattr(j, name)
    if t.validated_err is not None:
        assert j.validated_err is not None
        assert abs(t.validated_err - j.validated_err) <= \
            0.05 * j.validated_err + 1e-7


def test_defaults_are_murb_tpus():
    ts = BodyState.from_numpy({k: np.asarray(getattr(jinit.init_random(
        512, 1), k)) for k in FIELDS}, 512, 0, "cpu")
    t = TProxy(ts, soft=SOFT, dt=DT, m=8)
    assert (t.max_m, t.heavy_k, t.box_margin, t.cost_slack) == \
        (32, 1, 1.5, 30.0)
