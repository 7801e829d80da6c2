"""shard+adaptive (murb_tpu_torch/parallel/shard_adaptive.py) against
murb_tpu's on the forced CPU mesh: the planner's plan and permutation
exactly, the step at murb_tpu's own tolerance
(tests/test_shard_adaptive.py), the health counters on the clustered state
of murb_tpu's multichip dry run, and the stray rows against the exact
oracle."""
import dataclasses

import numpy as np
import pytest
import torch

from murb_tpu.core.state import BodyState as JState
from murb_tpu.models import create_engine as jcreate
from murb_tpu.parallel.shard_adaptive import \
    plan_shard_adaptive as j_plan
from murb_tpu_torch import G
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine
from murb_tpu_torch.ops.naive import acc_naive
from murb_tpu_torch.ops.p2p import _cell_ixyz, morton_key
from murb_tpu_torch.ops.sparse_fmm import SparsePlan
from murb_tpu_torch.parallel.mesh import make_mesh, shard_state
from murb_tpu_torch.parallel.shard_adaptive import (make_local_step,
                                                    plan_shard_adaptive)

from conftest import assert_within_rel

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def _two_cluster_state(n=4000, seed=0, offset=(5e11, 1e11, -5e10),
                       v_sigma=10.0):
    """murb_tpu's clustered wide box: softening four orders below the
    box."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([
        rng.normal(0, 1.0, (n // 2, 3)) * 1e10 + [-5e11, 0.0, 0.0],
        rng.normal(0, 1.0, (n - n // 2, 3)) * 1e10 + list(offset),
    ]).astype(np.float32)
    m = (rng.uniform(0.5, 2.0, n) * 1e30).astype(np.float32)
    v = (rng.normal(0.0, 1.0, (n, 3)) * v_sigma).astype(np.float32)
    return JState.from_arrays(
        m, np.full(n, 1e8, np.float32), q[:, 0], q[:, 1], q[:, 2],
        v[:, 0], v[:, 1], v[:, 2])


@pytest.mark.parametrize("shards,levels", [(8, 0), (4, 0), (2, 5)])
def test_plan_and_permutation_equal_murb_tpu(shards, levels):
    js = _two_cluster_state()
    u = js.unpadded()
    q = np.stack([u["qx"], u["qy"], u["qz"]], 1).astype(np.float32)
    npad = js.npad
    ld = 2 if levels else 0
    jp, jperm = j_plan(q, npad, shards, 6, ld, levels)
    tp, tperm = plan_shard_adaptive(q, npad, shards, 6, ld, levels,
                                    device="cpu")
    np.testing.assert_array_equal(tperm, jperm)
    assert tp._replace(base=None) == jp._replace(base=None)
    assert tp.base == SparsePlan.from_fields(**jp.base._asdict())


@pytest.fixture(scope="module")
def stepped():
    """One pair of engines (8 shards, the two-cluster box, the order fixed
    at m=6 to keep the CPU sweep short), two steps each, beside the exact
    oracle."""
    js = _two_cluster_state()
    ref = jcreate("cpu+naive", js, soft=SOFT, dt=DT)
    a = jcreate("shard+adaptive", js, soft=SOFT, dt=DT, shards=8, m=6)
    b = create_engine("shard+adaptive", carry(js), soft=SOFT, dt=DT,
                      shards=8, m=6)
    out = {"plans": (a.adaptive_plan, b.adaptive_plan)}
    for i in range(2):
        for e in (ref, a, b):
            e.compute_one_iteration()
        if i == 0:
            out["acc"] = (a.accelerations, b.accelerations)
    out["pos"] = (ref.bodies.unpadded(), a.bodies.unpadded(),
                  b.bodies.unpadded())
    return out


def test_step_matches_murb_tpu(stepped):
    """The first step's accelerations at WithinRel 1e-4 (the solver's
    contract; the two packages sum in other orders) and the positions
    after 2 steps at murb_tpu's 1e-3 with rms floor 5e-6, against both
    murb_tpu and the exact oracle (tests/test_shard_adaptive.py:59-66)."""
    ja, ta = stepped["acc"]
    for c in ("ax", "ay", "az"):
        assert_within_rel(getattr(ta, c).numpy(), np.asarray(getattr(ja, c)),
                          1e-4, f"acc {c}", rms_floor=1e-5)
    ref, a, b = stepped["pos"]
    for c in ("qx", "qy", "qz"):
        assert_within_rel(b[c], a[c], 1e-3, f"vs murb_tpu {c}",
                          rms_floor=5e-6)
        assert_within_rel(b[c], ref[c], 1e-3, f"vs oracle {c}",
                          rms_floor=5e-6)


def test_identity_order_and_health():
    """The clustered state of murb_tpu's multichip dry run
    (__graft_entry__.py:96-117): the observation view keeps the caller's
    body order through a step, and the health counters equal murb_tpu's
    and report ok, with the validated error under 1e-4."""
    n = 2048
    rng = np.random.default_rng(5)
    half = n // 2
    qc = np.concatenate([
        rng.normal(0, 1.0, (half, 3)) * 1e10 + [-5e11, 0.0, 0.0],
        rng.normal(0, 1.0, (n - half, 3)) * 1e10 + [5e11, 1e11, 0.0],
    ]).astype(np.float32)
    z = np.zeros(n, np.float32)
    js = JState.from_arrays((rng.uniform(0.5, 2.0, n) * 1e30).astype(
        np.float32), np.full(n, 1e8, np.float32), qc[:, 0], qc[:, 1],
        qc[:, 2], z, z, z)
    a = jcreate("shard+adaptive", js, soft=SOFT, dt=DT, shards=8)
    b = create_engine("shard+adaptive", carry(js), soft=SOFT, dt=DT,
                      shards=8)
    m0 = np.asarray(js.m[:n])
    np.testing.assert_array_equal(b.bodies.unpadded()["m"], m0)
    a.compute_one_iteration()
    b.compute_one_iteration()
    np.testing.assert_array_equal(b.bodies.unpadded()["m"], m0)
    assert np.all(np.isfinite(b.bodies.unpadded()["qx"]))
    ha, hb = a.proxy_health(), b.proxy_health()
    assert hb["using_adaptive"] and hb["ok"]
    for k in ("strays", "stray_cap", "exports", "export_cap", "local_cells",
              "local_cap", "global_cells", "global_cap", "out_of_box", "m",
              "levels"):
        assert hb[k] == ha[k], k
    assert 0 < b.validated_err <= 1e-4
    assert (b.m, b.levels) == (a.adaptive_plan.base.m,
                               a.adaptive_plan.base.levels)


def test_fmm_promotes_clustered_wide_box_to_adaptive():
    js = _two_cluster_state(n=1000, seed=9)
    a = jcreate("shard+fmm", js, soft=SOFT, dt=DT, shards=8)
    b = create_engine("shard+fmm", carry(js), soft=SOFT, dt=DT, shards=8)
    assert a.mode == b.mode == "adaptive" and b.tag == "shard+adaptive"
    assert b.adaptive_plan.base.m == a.adaptive_plan.base.m


def test_stray_rows_are_exact():
    """Strays: plan at q0, then step at q1 where 8 bodies of cluster A sit
    deep in cluster B (murb_tpu's test_shard_adaptive_stray_completion):
    the accelerations within 1e-3 of the rms force of the exact oracle."""
    rng = np.random.default_rng(11)
    n, npad, d = 2000, 2048, 4
    q0 = np.concatenate([
        rng.normal(0, 1.0, (n // 2, 3)) * 1e10 + [-5e11, 0.0, 0.0],
        rng.normal(0, 1.0, (n - n // 2, 3)) * 1e10 + [5e11, 0.0, 0.0],
    ]).astype(np.float32)
    m = (rng.uniform(0.5, 2.0, n) * 1e30).astype(np.float32)
    plan, perm = plan_shard_adaptive(q0, npad, d, 6, device="cpu")
    q1 = q0.copy()
    q1[:8, 0] = 5e11 + rng.normal(0, 1.0, 8).astype(np.float32) * 1e10
    z = np.zeros(n, np.float32)
    st = BodyState.from_arrays(m, np.ones(n, np.float32), q1[:, 0],
                               q1[:, 1], q1[:, 2], z, z, z, device="cpu",
                               pad_multiple=npad)
    idx = torch.as_tensor(perm)
    stp = dataclasses.replace(st, **{k: getattr(st, k)[idx]
                                     for k in FIELDS})
    mesh = make_mesh(d, device="cpu")
    step = make_local_step(plan, SOFT, DT, mesh, integrate=False)
    _, accs = step(shard_state(stp, mesh))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(npad)
    gm = st.m * torch.tensor(G, dtype=torch.float32).item()
    ref = acc_naive(st.qx.double(), st.qy.double(), st.qz.double(),
                    gm.double(), SOFT)
    scale = float(torch.sqrt(sum((r[:n] ** 2).mean() for r in ref)))
    for c in range(3):
        got = torch.cat([a[c] for a in accs])[inv][:n].double()
        err = float((got - ref[c][:n]).abs().max())
        assert err <= 1e-3 * scale, err / scale


def test_a_stray_in_row_zero_gets_its_exact_row():
    """At 4 shards the two-cluster box's split cuts a cell, so shard 1's
    row 0 is a stray from the start.  The port writes each valid stray row
    once; murb_tpu's scatter also lets the unused rows, which point at row
    0, write row 0's old value back, and reads 0.448 of the rms force there
    (ROADMAP.md Queue 3).  Every row within 1e-3 of the rms force of the
    exact oracle."""
    js = _two_cluster_state()
    u = js.unpadded()
    q = np.stack([u["qx"], u["qy"], u["qz"]], 1).astype(np.float32)
    d, npad = 4, js.npad
    plan, perm = plan_shard_adaptive(q, npad, d, 6, device="cpu")
    st = carry(js)
    stp = dataclasses.replace(st, **{k: getattr(st, k)[torch.as_tensor(
        perm)] for k in FIELDS})
    mesh = make_mesh(d, device="cpu")
    blocks = shard_state(stp, mesh)
    # shard 1's row 0 lies below its key range: a stray at build
    b1 = blocks[1]
    c = torch.tensor(plan.c)
    h = torch.full((3,), plan.h)
    key0 = morton_key(*_cell_ixyz(b1.qx[:1], b1.qy[:1], b1.qz[:1], c, h,
                                  2 ** plan.base.levels),
                      2 ** plan.base.levels)
    assert int(key0) < plan.bounds[1]
    _, accs = make_local_step(plan, SOFT, DT, mesh, integrate=False)(blocks)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(npad)
    n = js.n
    gm = st.m * torch.tensor(G, dtype=torch.float32).item()
    ref = acc_naive(st.qx.double(), st.qy.double(), st.qz.double(),
                    gm.double(), SOFT)
    scale = float(torch.sqrt(sum((r[:n] ** 2).mean() for r in ref)))
    for k in range(3):
        got = torch.cat([a[k] for a in accs])[inv][:n].double()
        err = float((got - ref[k][:n]).abs().max())
        assert err <= 1e-3 * scale, err / scale


def test_replan_fires_and_stays_locked():
    """murb_tpu's re-plan contract (tests/test_shard_adaptive.py:192-240):
    cluster A drifts outward, leaves the frozen box within a few steps, and
    with ``adapt_every=1`` the engine re-plans from the gathered state and
    stays on the exact oracle's trajectory (2e-3, rms floor 5e-6)."""
    js = _two_cluster_state(n=2000, seed=5)
    vx = np.asarray(js.vx).copy()
    vx[: js.n // 2] -= 3.0e7
    st = carry(js)
    st = dataclasses.replace(st, vx=torch.from_numpy(vx))
    ref = create_engine("cpu+naive", st, soft=SOFT, dt=DT)
    tgt = create_engine("shard+adaptive", st, soft=SOFT, dt=DT, shards=4,
                        adapt_every=1)
    plan0 = tgt.adaptive_plan
    ref.run(4)
    tgt.run(4)
    assert tgt.adaptive_plan is not plan0, "re-plan never fired"
    assert (tgt.adaptive_plan.c, tgt.adaptive_plan.h) != (plan0.c, plan0.h)
    a, b = ref.bodies.unpadded(), tgt.bodies.unpadded()
    for c in ("qx", "qy", "qz"):
        assert_within_rel(b[c], a[c], 2e-3, f"replan {c}", rms_floor=5e-6)
    tgt.maybe_adapt()
    assert tgt.proxy_health()["ok"]
