"""The planners' rates by device type (ops/fmm.LEVEL_OVERHEAD,
ops/sparse_fmm.PLANNER_RATES) against murb_tpu's cost models.

On the CPU every pick and estimate is murb_tpu's bit for bit; for "cuda"
(a device value only, no card) each function takes the card's table and
its estimate is the model's formula at that table, written out here a
second time; every caller passes the state's device; a device type with
no table raises.  Exact equality throughout: the same arithmetic in the
same order.
"""
import numpy as np
import pytest
import torch

from murb_tpu.ops import fmm as jf
from murb_tpu.ops import sparse_fmm as js
from murb_tpu_torch.ops import fmm as tf
from murb_tpu_torch.ops import sparse_fmm as ts

torch.set_num_threads(2)
SOFT = 2.0e8
HALVES = (1.0e8, 6.65e8, 3e9, 1e11)


def clusters(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(0, 1.0, (n // 2, 3)) + [-50.0, 0.0, 0.0],
        rng.normal(0, 1.0, (n - n // 2, 3)) + [50.0, 10.0, -5.0],
    ]).astype(np.float32)


def model_ms(r, stats, n_bricks, npad, m, ld, lv, nf=3):
    """murb_tpu's adaptive step model at rank 0, written out again."""
    NO = len(js._far_offsets()[0])
    m2l = 0.0
    for nc in stats:
        m2l += NO * nc * m ** 6 * nf / r.mac_per_ms
        m2l += NO * nc * m ** 3 * 4 / r.gather_bytes_per_ms
    m2l += 686 * 8 ** ld * m ** 6 * nf / r.mac_per_ms
    p2p = n_bricks * 128 ** 2 * 26 / r.p2p_slots_per_ms
    anterp = npad * r.anterp_us_per_body / 1e3
    misc = r.misc_ms_per_level * (lv - ld) + r.misc_ms
    return r.factor * (m2l + p2p + anterp + misc)


def depth_ref(n, half, tol, overhead):
    """best_depth's candidates and pick at ``overhead``, written out."""
    lmin = tf.required_levels(half, SOFT)
    cands = []
    for lv in range(lmin, max(lmin, 4) + 1):
        m = tf.fmm_order(half, SOFT, lv, tol)
        cands.append((8 * n * m ** 3 + 686 * 8 ** lv * m ** 6
                      + overhead * (lv - lmin), m, lv))
    best = cands[0]
    for c in cands[1:]:
        if c[0] < best[0]:
            best = c
    return cands, (best[1], best[2])


# ------------------------------------------------ the tables themselves
def test_cpu_tables_are_murb_tpus_constants():
    r = ts.PLANNER_RATES["cpu"]
    assert (r.mac_per_ms, r.gather_bytes_per_ms, r.anterp_us_per_body,
            r.exact_slots_per_ms) == (js._MAC_PER_MS,
                                      js._GATHER_BYTES_PER_MS,
                                      js._ANTERP_US_PER_BODY,
                                      js._EXACT_SLOTS_PER_MS)
    # murb_tpu off the TPU: its jnp sweep's rate
    assert r.p2p_slots_per_ms == js._P2P_SLOTS_PER_MS == js._p2p_rate()
    assert (r.misc_ms_per_level, r.misc_ms, r.factor) == (0.5, 2.0, 2.0)
    assert tf.LEVEL_OVERHEAD["cpu"] == 3.5e10


def test_cuda_tables_hold_no_tpu_constant():
    """A CUDA state never gets murb_tpu's rates: every field of the card's
    table differs from the CPU table's (murb_tpu's); the rates and the
    factor are positive and finite, the misc times finite and not
    negative."""
    cpu, cuda = ts.PLANNER_RATES["cpu"], ts.PLANNER_RATES["cuda"]
    for field in ts.PlannerRates._fields:
        a, b = getattr(cpu, field), getattr(cuda, field)
        assert a != b, field
        assert np.isfinite(b) and (b >= 0 if field.startswith("misc")
                                   else b > 0), (field, b)
    assert tf.LEVEL_OVERHEAD["cuda"] != tf.LEVEL_OVERHEAD["cpu"]
    assert np.isfinite(tf.LEVEL_OVERHEAD["cuda"])
    assert tf.LEVEL_OVERHEAD["cuda"] > 0


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu"), "cuda",
                                    "cuda:0", torch.device("cuda", 1)])
def test_tables_are_chosen_by_device_type(device):
    kind = torch.device(device).type
    assert ts.planner_rates(device) is ts.PLANNER_RATES[kind]
    assert tf.level_overhead(device) == tf.LEVEL_OVERHEAD[kind]


@pytest.mark.parametrize("device", ["meta", "mps", torch.device("xpu")])
def test_unknown_device_type_raises(device):
    q = clusters(1000)
    with pytest.raises(ValueError, match="device type"):
        ts.planner_rates(device)
    with pytest.raises(ValueError, match="device type"):
        tf.level_overhead(device)
    with pytest.raises(ValueError, match="device type"):
        tf.best_depth(200_192, 6.65e8, SOFT, device=device)
    with pytest.raises(ValueError, match="device type"):
        ts.exact_cost_ms(4096, device)
    with pytest.raises(ValueError, match="device type"):
        ts.plan_cost_ms(q, 4096, 6, 2, 5, device=device)
    with pytest.raises(ValueError, match="device type"):
        ts.best_adaptive_plan(q, 4096, 6, max_levels=5, device=device)


# ------------------------------------------- CPU: murb_tpu bit for bit
@pytest.mark.parametrize("half", HALVES)
def test_cpu_depth_is_murb_tpus(half):
    for n in (1024, 200_192, 16_777_216):
        for tol in (1e-3, 1e-4):
            assert tf.best_depth(n, half, SOFT, tol, device="cpu") == \
                jf.best_depth(n, half, SOFT, tol)
            cands, pick = depth_ref(n, half, tol, 3.5e10)
            assert tf.depth_candidates(n, half, SOFT, tol,
                                       device="cpu") == cands
            assert pick == jf.best_depth(n, half, SOFT, tol)


@pytest.mark.parametrize("Ld,L", [(2, 4), (2, 6), (3, 7)])
def test_cpu_costs_are_murb_tpus(Ld, L):
    q = clusters(3000, seed=2)
    stats = js.level_stats(q, Ld, L)
    assert ts.plan_cost_ms(q, 4096, 8, Ld, L, device="cpu") == \
        js.plan_cost_ms(q, 4096, 8, Ld, L)
    for nf in (3, 4):
        assert ts._cost_from_stats(stats, 777, 4096, 6, Ld, L, nf,
                                   device="cpu") == \
            js._cost_from_stats(stats, 777, 4096, 6, Ld, L, nf)
    # the test's own formula is murb_tpu's, operation for operation
    assert model_ms(ts.PLANNER_RATES["cpu"], stats, 777, 4096, 6, Ld, L) \
        == js._cost_from_stats(stats, 777, 4096, 6, Ld, L)
    for npad in (2048, 131_072, 1_048_576):
        assert ts.exact_cost_ms(npad, "cpu") == js.exact_cost_ms(npad)


@pytest.mark.parametrize("seed", [0, 3])
def test_cpu_best_plan_is_murb_tpus(seed):
    q = clusters(4000, seed=seed)
    jplan, jcost = js.best_adaptive_plan(q, 4096, 6)
    tplan, tcost = ts.best_adaptive_plan(q, 4096, 6, device="cpu")
    assert tcost == jcost
    assert (tplan.dense_levels, tplan.levels, tplan.cell_caps,
            tplan.p2p_pmax) == (jplan.dense_levels, jplan.levels,
                                jplan.cell_caps, jplan.p2p_pmax)


# --------------------------------------- "cuda": the card's table
@pytest.mark.parametrize("half", HALVES)
def test_cuda_depth_uses_the_cards_overhead(half):
    for n in (1024, 200_192, 16_777_216):
        for tol in (1e-3, 1e-4):
            cands, pick = depth_ref(n, half, tol, tf.LEVEL_OVERHEAD["cuda"])
            assert tf.depth_candidates(n, half, SOFT, tol,
                                       device="cuda") == cands
            assert tf.best_depth(n, half, SOFT, tol, device="cuda") == pick
            assert tf.best_depth(n, half, SOFT, tol) == pick   # the default


@pytest.mark.parametrize("Ld,L", [(2, 4), (2, 6), (3, 7)])
def test_cuda_costs_are_the_formula_at_the_cards_table(Ld, L):
    q = clusters(3000, seed=2)
    r = ts.PLANNER_RATES["cuda"]
    stats = ts.level_stats(q, Ld, L)
    bricks = ts.estimate_brick_pairs(q, 4096, L)
    want = model_ms(r, stats, bricks, 4096, 8, Ld, L)
    for dev in ("cuda", "cuda:0"):
        assert ts.plan_cost_ms(q, 4096, 8, Ld, L, device=dev) == \
            pytest.approx(want, rel=1e-12)
    assert ts.plan_cost_ms(q, 4096, 8, Ld, L) == \
        ts.plan_cost_ms(q, 4096, 8, Ld, L, device="cuda")   # the default
    for nf in (3, 4):
        assert ts._cost_from_stats(stats, 777, 4096, 6, Ld, L, nf,
                                   device="cuda") == pytest.approx(
            model_ms(r, stats, 777, 4096, 6, Ld, L, nf), rel=1e-12)
    for npad in (2048, 131_072, 1_048_576):
        assert ts.exact_cost_ms(npad, "cuda") == \
            14.0 * npad * npad / r.exact_slots_per_ms
        assert ts.exact_cost_ms(npad) == ts.exact_cost_ms(npad, "cuda")


@pytest.mark.parametrize("seed", [0, 3])
def test_cuda_best_plan_is_the_cheapest_at_the_cards_table(seed):
    q = clusters(4000, seed=seed)
    r = ts.PLANNER_RATES["cuda"]
    plan, cost = ts.best_adaptive_plan(q, 4096, 6, device="cuda")
    assert plan.p2p_impl == "kernel"
    costs = {(ld, lv): model_ms(r, ts.level_stats(q, ld, lv),
                                ts.estimate_brick_pairs(q, 4096, lv), 4096,
                                6, ld, lv)
             for ld in (2, 3) for lv in range(ld + 1, 10)}
    best = min(costs.values())
    assert cost == pytest.approx(best, rel=1e-12)
    assert costs[(plan.dense_levels, plan.levels)] == \
        pytest.approx(best, rel=1e-12)


# ------------------------------------- every caller passes its device
@pytest.fixture
def planner_devices(monkeypatch):
    """Wrap the planners so each call records the device it was given
    (its default where the caller passed none)."""
    import inspect

    from murb_tpu_torch.ops import fmm, sparse_fmm

    seen = []

    def wrap(mod, name):
        orig = getattr(mod, name)
        sig = inspect.signature(orig)

        def recorded(*a, **k):
            bound = sig.bind(*a, **k)
            bound.apply_defaults()
            seen.append((name, torch.device(bound.arguments["device"]).type))
            return orig(*a, **k)

        monkeypatch.setattr(mod, name, recorded)

    wrap(fmm, "best_depth")
    for name in ("best_adaptive_plan", "exact_cost_ms"):
        wrap(sparse_fmm, name)
    return seen


def two_clusters_cpu(n, seed=7):
    from murb_tpu_torch.core.state import BodyState

    rng = np.random.default_rng(seed)
    q = clusters(n, seed)
    m = (rng.uniform(0.5, 2.0, n) * 1e10).astype(np.float32)
    z = np.zeros(n, np.float32)
    return BodyState.from_arrays(m, np.ones(n, np.float32), q[:, 0],
                                 q[:, 1], q[:, 2], z, z, z, device="cpu")


def test_proxy_engine_plans_at_its_devices_rates(planner_devices):
    """The auto policy on a clustered CPU state: the depth model, the
    adaptive planner and the exact model all get the CPU, so the engine
    declines where murb_tpu does (test_torch_adaptive_engines)."""
    from murb_tpu_torch.models import create_engine

    e = create_engine("tpu+proxy", two_clusters_cpu(2000), soft=0.01,
                      dt=1e-3, validate=False)
    assert not e.using_proxy and e.near_mode == "interp"
    assert {n for n, _ in planner_devices} == {
        "best_depth", "best_adaptive_plan", "exact_cost_ms"}
    assert {d for _, d in planner_devices} == {"cpu"}
    est = e.cost_estimates
    assert est["exact_ms"] == ts.exact_cost_ms(e._state.npad, "cpu")
    assert est["adaptive_ms"] >= est["exact_ms"]


def test_shard_engines_plan_at_their_devices_rates(planner_devices):
    """shard+proxy promoted to the hierarchy (best_depth at build and at
    a re-derivation) and shard+fmm promoted to the adaptive mode (the
    adaptive planner), on CPU shards."""
    from murb_tpu_torch.core.init import make_bodies
    from murb_tpu_torch.models import create_engine

    e = create_engine("shard+proxy", make_bodies(1000, "random", 1,
                                                  device="cpu"),
                      soft=SOFT, dt=3600.0, shards=2)
    assert e.mode == "fmm"
    e._reconfigure_far()
    a = create_engine("shard+fmm", two_clusters_cpu(1024, 9), soft=0.01,
                      dt=1e-3, shards=2)
    assert a.mode == "adaptive"
    names = [n for n, _ in planner_devices]
    assert names.count("best_depth") == 2
    assert names.count("best_adaptive_plan") >= 1
    assert {d for _, d in planner_devices} == {"cpu"}


def test_cli_plans_at_the_states_device(planner_devices):
    from murb_tpu_torch import cli
    from murb_tpu_torch.utils.args import parse_args

    cfg = parse_args(["-n", "1024", "-i", "1", "--im", "tpu+tracking",
                      "--kernel", "adaptive", "-s", "random", "--soft",
                      "1e6", "--device", "cpu"])
    plan = cli._validated_adaptive_plan(cfg, two_clusters_cpu(1024, 4))
    assert plan.p2p_impl == "plain"
    assert planner_devices == [("best_adaptive_plan", "cpu")]
