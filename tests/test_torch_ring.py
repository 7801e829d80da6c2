"""The pipelined ring (murb_tpu_torch/ops/ring.py, kernel K14).

On the CPU the wrapper runs its plain version, which plays K14's two-slot
protocol on lists.  It is held against murb_tpu's fused RDMA ring in Pallas
TPU interpret mode (as tests/test_ring_pallas.py runs it), the protocol's
slot order is checked step by step, and the pipelined engine against the
ppermute engine.  K14 itself runs only on the card: the ``cuda`` test below
(skipped here) and chip_smoke.py phase 11 hold it against the plain
version."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from murb_tpu import G
from murb_tpu.core.init import SCHEMES
from murb_tpu.ops.ring_pallas import acc_ring_pipelined as j_ring
from murb_tpu.parallel.mesh import SHARD_AXIS, make_mesh as j_mesh
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine
from murb_tpu_torch.ops import ring
from murb_tpu_torch.parallel.mesh import make_mesh, shard_state

from conftest import assert_within_rel

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def _blocks(st, d, device="cpu"):
    mesh = make_mesh(devices=[device] * d)
    blocks = shard_state(st, mesh)
    g = torch.tensor(G, dtype=st.dtype).item()
    return mesh, [(b.qx, b.qy, b.qz) for b in blocks], [b.m * g
                                                        for b in blocks]


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_plain_ring_matches_murb_tpu_interpret(d, n_devices):
    """Every ring length, the D=1 pure compute, D=2 without the capacity
    handshake and D=3, the smallest with it, against murb_tpu's ring in
    interpret mode on the 1024-body galaxy (repadded to 256 D):
    WithinRel 1e-5 with rms floor 1e-7 (tests/test_ring_pallas.py:67-69)."""
    js = SCHEMES["galaxy"](1024, 7).repad(256 * d)
    gm = jnp.asarray(G, js.qx.dtype) * js.m
    fn = jax.shard_map(
        functools.partial(j_ring, soft=SOFT, axis_name=SHARD_AXIS,
                          n_devices=d, interpret=pltpu.InterpretParams()),
        mesh=j_mesh(d), in_specs=P(SHARD_AXIS), out_specs=P(SHARD_AXIS),
        check_vma=False)
    want = fn(js.qx, js.qy, js.qz, gm)
    mesh, qs, gms = _blocks(carry(js), d)
    got = ring.acc_ring_pipelined(mesh, qs, gms, SOFT)
    assert ring.acc_ring_pipelined.launches == 0     # the plain version
    for c, name in enumerate(("ax", "ay", "az")):
        assert_within_rel(torch.cat([a[c] for a in got]).numpy(),
                          np.asarray(getattr(want, name)), 1e-5,
                          f"ring d={d} {name}", rms_floor=1e-7)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_plain_protocol_slot_order(d):
    """Step k of shard s reads slot k % 2, which holds the block that
    started on shard (s - k) mod D: every block meets every shard once."""
    st = carry(SCHEMES["random"](512, 3)).repad(256 * d)
    mesh, qs, gms = _blocks(st, d)
    log = []
    ring.acc_ring_pipelined_plain(mesh, qs, gms, SOFT, log=log)
    assert log == [(k, s, k % 2, (s - k) % d) for k in range(d)
                   for s in range(d)]


def test_wrapper_refuses_what_it_does_not_run(monkeypatch):
    st = carry(SCHEMES["random"](512, 3))
    mesh, qs, gms = _blocks(st, 2)
    with pytest.raises(ValueError, match="block_i=96"):
        ring.acc_ring_pipelined(mesh, qs, gms, SOFT, block_i=96)
    with pytest.raises(ValueError, match="3 shards"):
        ring.acc_ring_pipelined(make_mesh(3, device="cpu"), qs, gms, SOFT)
    monkeypatch.setattr(mesh, "process_count", 2)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ring.acc_ring_pipelined(mesh, qs, gms, SOFT)


def test_engine_pipelined_matches_ppermute():
    """The pipelined engine lands on the ppermute engine's trajectory (the
    murb_tpu test's 1e-5, rms floor 1e-7, galaxy 1024, seed 9)."""
    st = carry(SCHEMES["galaxy"](1024, 9))
    a = create_engine("shard+ring", st, soft=SOFT, dt=DT, shards=4,
                      ring_impl="ppermute")
    b = create_engine("shard+ring", st, soft=SOFT, dt=DT, shards=4,
                      ring_impl="pipelined")
    assert a.ring_impl == "ppermute" and b.ring_impl == "pipelined"
    # CPU shards: auto takes the ppermute ring
    assert create_engine("shard+ring", st, shards=2).ring_impl == "ppermute"
    for _ in range(2):
        a.compute_one_iteration()
        b.compute_one_iteration()
    da, db = a.bodies.unpadded(), b.bodies.unpadded()
    for c in ("qx", "qy", "qz"):
        assert_within_rel(db[c], da[c], 1e-5, f"ring engines {c}",
                          rms_floor=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("delay_ns", [0, 5000])
def test_k14_matches_its_plain_version_on_the_card(delay_ns):
    """K14 at D = 1 to 4 shards on one card against the plain version in
    float64, with and without the protocol delay (WithinRel 1e-5, rms
    floor 5e-6, as chip_smoke.py phase 11 at 200k)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K14 has no interpret mode)")
    st = carry(SCHEMES["galaxy"](8192, 5)).to("cuda")
    for d in (1, 2, 3, 4):
        s = st.repad(256 * d)
        mesh, qs, gms = _blocks(s, d, "cuda:0")
        got = ring.acc_ring_pipelined(mesh, qs, gms, SOFT,
                                      delay_ns=delay_ns)
        want = ring.acc_ring_pipelined_plain(
            mesh, [tuple(v.double() for v in q) for q in qs],
            [g.double() for g in gms], SOFT)
        for c in range(3):
            assert_within_rel(torch.cat([a[c] for a in got]).cpu().numpy(),
                              torch.cat([a[c] for a in want]).cpu().numpy(),
                              1e-5, f"K14 d={d} c={c}", rms_floor=5e-6)
