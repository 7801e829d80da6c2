"""The adaptive plan's counts where the engine's positions lie: the occupied
cells per sparse level (``ops/sparse_fmm.level_stats``) and the candidate
brick pairs (``ops/p2p.estimate_brick_pairs``) that ``ProxyEngine``'s
planner and health check count on its state's device.

No JAX here, so the card's tests can run in this file: tests/
test_torch_sparse_fmm.py holds the counts on CPU tensors to murb_tpu's
numpy replica; here the card's counts are held to the CPU's (numpy input),
on the two-cluster box of the benchmark's 1M cell, and an engine whose
bodies outgrow its plan fails its health check and plans again, on the CPU
and on the card.  Tolerances: none, the counts and plans exactly.
"""
import dataclasses

import pytest
import torch

from murb_tpu_torch.models import create_engine
from murb_tpu_torch.models.engines import _active_positions
from murb_tpu_torch.ops import p2p as tp
from murb_tpu_torch.ops import sparse_fmm as ts
from murb_tpu_torch.utils import trace
from murb_tpu_torch.utils.profile_step import two_clusters

torch.set_num_threads(2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the counts on the card's tensors)")


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_moved_bodies_fail_the_health_check_and_replan(device):
    """Two clusters planned adaptively, then spread evenly over the cube
    around them: the occupied cells pass the plan's caps, so the health
    check (counted on the state's device, as the ``adapt`` span says) is
    not ok, ``maybe_adapt`` plans again, and the new plan holds them."""
    if device == "cuda":
        _card()
    n = 2048 if device == "cpu" else 65_536
    eng = create_engine("tpu+proxy", two_clusters(n, 5, device=device),
                        soft=0.02, dt=1e-6, near="adaptive")
    assert eng.near_mode == "adaptive" and eng.proxy_health()["ok"]
    old = eng._plan
    st = eng.bodies
    gen = torch.Generator().manual_seed(1)
    q = (torch.rand((st.npad, 3), generator=gen) * 160.0 - 80.0).to(device)
    eng._state = dataclasses.replace(
        st, qx=q[:, 0].contiguous(), qy=q[:, 1].contiguous(),
        qz=q[:, 2].contiguous())
    health = eng.proxy_health()
    assert not health["ok"]
    assert any(nc > cap for nc, cap in zip(health["n_cells_now"],
                                           health["cell_caps"]))
    trace.enable()
    try:
        assert eng.maybe_adapt() is True
    finally:
        trace.disable()
    (adapt,) = [r for r in trace.drain()["spans"] if r["name"] == "adapt"]
    assert adapt["attrs"] == {
        "ok": False, "reconfigured": True,
        "counts_device": str(eng.bodies.device),
        "n_cells_now": health["n_cells_now"],
        "p2p_pairs_now": health["p2p_pairs_now"]}
    assert adapt["attrs"]["counts_device"].startswith(device)
    assert eng._plan != old and eng.proxy_health()["ok"]


@pytest.mark.cuda
def test_card_counts_equal_the_cpu_counts_at_1m():
    """On the benchmark's 1M two-cluster box (1,048,576 bodies), the counts
    on the card equal the CPU's at every depth best_adaptive_plan visits,
    and so does the plan it picks and its cost."""
    _card()
    state = two_clusters(1 << 20, 42, device="cuda")
    qc = _active_positions(state)
    assert qc.is_cuda and qc.shape == (state.n, 3)
    q = qc.cpu().numpy()
    npad = state.npad
    assert ts.level_stats(qc, 2, 9) == ts.level_stats(q, 2, 9)
    for levels in range(3, 10):
        assert tp.estimate_brick_pairs(qc, npad, levels) == \
            tp.estimate_brick_pairs(q, npad, levels), levels
    assert ts.best_adaptive_plan(qc, npad, 6) == \
        ts.best_adaptive_plan(q, npad, 6)
