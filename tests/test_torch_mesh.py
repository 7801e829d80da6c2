"""The port's device mesh (murb_tpu_torch/parallel/mesh.py): each
collective against its numpy definition on a mesh of virtual CPU shards,
the state's block split and replication, and the device checks of
``make_mesh`` (murb_tpu/parallel/mesh.py's, with the CUDA device count
monkeypatched)."""
import numpy as np
import pytest
import torch

from murb_tpu.core import init as jinit
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.parallel import mesh as M


def _blocks(rng, d, shape=(6,), dtype=np.float32):
    return [rng.normal(size=shape).astype(dtype) for _ in range(d)]


@pytest.mark.parametrize("d", [1, 3, 4])
def test_collectives_match_numpy(d):
    rng = np.random.default_rng(d)
    mesh = M.make_mesh(d, device="cpu")
    assert mesh.size == d and [mesh.axis_index(k) for k in range(d)] \
        == list(range(d))
    xs = _blocks(rng, d, (5, 2))
    ts = [torch.from_numpy(x) for x in xs]
    for got in mesh.all_gather(ts):
        np.testing.assert_array_equal(got.numpy(), np.concatenate(xs))
    for got in mesh.psum(ts):
        np.testing.assert_allclose(got.numpy(), np.sum(xs, 0), rtol=1e-6)
    for got in mesh.pmin(ts):
        np.testing.assert_array_equal(got.numpy(), np.min(xs, 0))
    for got in mesh.pmax(ts):
        np.testing.assert_array_equal(got.numpy(), np.max(xs, 0))
    # ppermute [(k, (k + 1) % d)]: shard k receives shard k - 1's block
    for k, got in enumerate(mesh.ppermute(ts)):
        np.testing.assert_array_equal(got.numpy(), xs[(k - 1) % d])


def test_integer_collectives():
    mesh = M.make_mesh(3, device="cpu")
    ts = [torch.tensor([k, 10 - k], dtype=torch.int64) for k in range(3)]
    assert mesh.psum(ts)[0].tolist() == [3, 27]
    assert mesh.pmax(ts)[2].tolist() == [2, 10]


def _state(n=1000, seed=3):
    js = jinit.init_galaxy(n, seed)
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def test_shard_and_replicate_state():
    st = _state().repad(256 * 4)
    mesh = M.make_mesh(4, device="cpu")
    blocks = M.shard_state(st, mesh)
    assert [b.npad for b in blocks] == [st.npad // 4] * 4
    for k, b in enumerate(blocks):
        rows = slice(k * b.npad, (k + 1) * b.npad)
        for f in FIELDS:
            assert torch.equal(getattr(b, f), getattr(st, f)[rows])
    back = M.gather_state(blocks, mesh, st.n, st.padding)
    assert (back.n, back.padding) == (st.n, st.padding)
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(st, f))
    reps = M.replicate_state(st, mesh)
    assert len(reps) == 4 and all(torch.equal(r.qx, st.qx) for r in reps)
    with pytest.raises(ValueError, match="not a multiple"):
        M.shard_state(_state(1000), M.make_mesh(3, device="cpu"))


def test_make_mesh_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = M.make_mesh(0, device="cuda")
    assert mesh.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert M.make_mesh(1, device="cuda").devices == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="requested 3 shards but only 2 "
                                         "devices"):
        M.make_mesh(3, device="cuda")
    # only an explicit list may put several shards on one card
    four = M.make_mesh(devices=["cuda:0"] * 4)
    assert four.size == 4 and four.all_cuda
    with pytest.raises(ValueError, match="device list"):
        M.make_mesh(2, devices=["cuda:0"] * 4)
    cpu = M.make_mesh(0, device="cpu")
    assert cpu.devices == [torch.device("cpu")] and not cpu.all_cuda
    assert M.make_mesh(5, device="cpu").size == 5


def test_make_mesh_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """With no card, CUDA shards (the default) raise before anything is
    built and name the CPU alternative; CPU shards still come as asked."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for call in (lambda: M.make_mesh(2), lambda: M.make_mesh(),
                 lambda: M.make_mesh(0, device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cpu = M.make_mesh(2, device="cpu")
    assert cpu.devices == [torch.device("cpu")] * 2 and not cpu.all_cuda


def test_maybe_init_distributed_needs_the_coordinator(monkeypatch):
    monkeypatch.delenv("MURB_COORDINATOR", raising=False)
    assert M.maybe_init_distributed("cpu") is False


def test_maybe_init_distributed_without_a_card_raises(monkeypatch):
    """No device given means CUDA shards: with no card the call raises and
    starts no process group, and never falls back to gloo."""
    started = []
    monkeypatch.setenv("MURB_COORDINATOR", "localhost:1")
    monkeypatch.setenv("MURB_NUM_PROCESSES", "1")
    monkeypatch.setenv("MURB_PROCESS_ID", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(M.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(M.dist, "init_process_group",
                        lambda *a, **k: started.append((a, k)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.maybe_init_distributed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.maybe_init_distributed("cuda")
    assert started == []
