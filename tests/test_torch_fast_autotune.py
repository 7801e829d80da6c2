"""The fast solver's stage geometry (``block``, ``m2l_tile``) and its
autotune (murb_tpu/models/engines.py:663-743) in the port's ``ProxyEngine``
and solver entries; the proxy entries' ``heavy_k`` and ``heavy_factor``
against murb_tpu's; and the small entries the port took from murb_tpu
(``SimulationHistory.set_series``, ``load_metrics_from_csv``,
``leapfrog_positions``, ``BodyState.positions``/``velocities``,
``Perf.reset``/``get_mem_bandwidth_gbs``).  On the CPU the stages run their
plain versions, which have no geometry: here the wiring, the tables the
kernels would read and the checks; chip_smoke.py phase 17 times the
geometries on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu import G
from murb_tpu.core import history as jhist
from murb_tpu.core import init as jinit
from murb_tpu.core import integrators as jint
from murb_tpu.ops import proxy as jp
from murb_tpu.utils import perf as jperf
from murb_tpu_torch import cli
from murb_tpu_torch.core import history as thist
from murb_tpu_torch.core import integrators as tint
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine
from murb_tpu_torch.models.engines import ProxyEngine
from murb_tpu_torch.ops import fmm_kernels as fk
from murb_tpu_torch.ops import proxy as tp
from murb_tpu_torch.ops import proxy_kernels as tk
from murb_tpu_torch.ops.fmm import acc_fmm
from murb_tpu_torch.utils import autotune as at
from murb_tpu_torch.utils import perf as tperf

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0
CPU = {"device": "cpu"}
#: the hierarchy's engine on the random box: explicit (m, levels)
HIER = {"m": 8, "levels": 2}


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


@pytest.fixture(scope="module")
def galaxy():
    return carry(jinit.init_galaxy(2048, 7))


@pytest.fixture(scope="module")
def box():
    return carry(jinit.init_random(2048, 7))


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("MURB_TUNE_CACHE", path)
    monkeypatch.delenv("MURB_AUTOTUNE", raising=False)
    return path


@pytest.fixture
def no_sweep(monkeypatch):
    """Fail on any sweep of the stage geometry."""
    def sweep(self):
        raise AssertionError("the stage geometry was swept")

    monkeypatch.setattr(ProxyEngine, "_run_fast_autotune", sweep)


# ------------------------------------------------------- engine wiring
@pytest.mark.parametrize("im", ["tpu+proxy", "fmm", "barnes-hut"])
def test_registry_forwards_the_geometry(tune_cache, no_sweep, galaxy, box,
                                        im):
    """``create_engine`` hands ``block``, ``m2l_tile`` and ``autotune`` to
    the engine under each of the tag's names, as murb_tpu's registry does
    (murb_tpu/models/__init__.py:93)."""
    e = create_engine(im, galaxy, soft=SOFT, dt=DT, block=256,
                      autotune=False, m=12)
    assert (e.m, e.levels, e.block, e.m2l_tile) == (12, 0, 256, 0)
    h = create_engine(im, box, soft=SOFT, dt=DT, block=64, m2l_tile=4,
                      autotune=False, **HIER)
    assert (h.block, h.m2l_tile, h.tuned) == (64, 4, None)
    h.run(1)
    h.assert_finite()


def test_cli_autotune_reaches_the_engine(tune_cache, monkeypatch):
    seen = []
    monkeypatch.setattr(ProxyEngine, "_resolve_fast_blocks",
                        lambda self, autotune: seen.append(autotune))
    argv = ["-n", "1024", "-i", "1", "--im", "tpu+proxy", "--nv",
            "--device", "cpu"]
    assert cli.run(argv + ["--autotune"]).rc == 0
    assert cli.run(argv).rc == 0
    assert seen == [True, None]


@pytest.mark.parametrize("scheme,kw,pick", [
    ("galaxy", {}, {"block": 512, "m2l_tile": 0}),
    ("box", HIER, {"block": 128, "m2l_tile": 8})])
def test_stored_pick_is_applied(tune_cache, no_sweep, galaxy, box, scheme,
                                kw, pick):
    """A pick stored under the engine's key (``_fast_tune_tag``, npad, the
    device) is read back, kept in ``tuned`` and steps."""
    st = galaxy if scheme == "galaxy" else box
    kw = kw or {"m": 12}
    first = create_engine("tpu+proxy", st, soft=SOFT, dt=DT, **kw)
    assert first.tuned is None and (first.block, first.m2l_tile) == (0, 0)
    tag = first._fast_tune_tag
    assert tag == f"tpu+proxy/m{first.m}L{first.levels}c{first.cells}"
    at.store(tag, st.npad, pick, 0.5, **CPU)
    assert at._key(tag, st.npad, "cpu") == \
        f"torch/{tag}/n{st.npad}/cpu"
    e = create_engine("tpu+proxy", st, soft=SOFT, dt=DT, autotune=True,
                      **kw)
    assert (e.block, e.m2l_tile) == (pick["block"], pick["m2l_tile"])
    assert e.tuned["block"] == pick["block"] and "sweep" not in e.tuned
    e.run(1)
    e.assert_finite()


@pytest.mark.parametrize("bad", [{"block": 96}, {"block": 2048},
                                 {"block": 64}])
def test_stored_pick_the_kernels_cannot_run_is_skipped(tune_cache, no_sweep,
                                                       galaxy, bad):
    at.store("tpu+proxy/m12L0c1", galaxy.npad, {**bad, "m2l_tile": 0}, 0.5,
             **CPU)
    again = create_engine("tpu+proxy", galaxy, soft=SOFT, dt=DT, m=12)
    assert again._fast_tune_tag == "tpu+proxy/m12L0c1"
    assert again.tuned is None and again.block == 0


def test_maybe_adapt_looks_the_geometry_up_again(tune_cache, galaxy,
                                                 monkeypatch):
    """A reconfiguration clears the geometry and reads the new
    configuration's stored pick, with no sweep even where the engine was
    built with ``autotune=True`` (murb_tpu/models/engines.py:741-743)."""
    e = create_engine("tpu+proxy", galaxy, soft=SOFT, dt=DT, block=1024,
                      validate=False)
    assert e.block == 1024
    at.store("tpu+proxy/m20L0c1", galaxy.npad,
             {"block": 256, "m2l_tile": 0}, 0.5, **CPU)
    swept = []
    monkeypatch.setattr(ProxyEngine, "_run_fast_autotune",
                        lambda self: swept.append(1) or {})
    monkeypatch.setattr(ProxyEngine, "proxy_health",
                        lambda self: {"ok": False})

    def grow(self):
        self.m = 20

    monkeypatch.setattr(ProxyEngine, "_configure", grow)
    assert e.maybe_adapt()
    assert (e.m, e.block, e.m2l_tile) == (20, 256, 0)
    assert e.tuned["block"] == 256 and not swept
    # a configuration with no stored pick takes the kernels' own picks
    monkeypatch.setattr(ProxyEngine, "_configure",
                        lambda self: setattr(self, "m", 24))
    assert e.maybe_adapt()
    assert (e.block, e.m2l_tile, e.tuned) == (0, 0, None) and not swept


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_a_cpu_state_never_sweeps(tune_cache, no_sweep, galaxy, box,
                                  monkeypatch, how):
    """On the CPU the stages have no geometry: ``autotune=True`` or
    MURB_AUTOTUNE=1 only looks the pick up."""
    kw = {"autotune": True} if how == "argument" else {}
    if how == "environment":
        monkeypatch.setenv("MURB_AUTOTUNE", "1")
    for st, extra in ((galaxy, {}), (box, HIER)):
        e = create_engine("tpu+proxy", st, soft=SOFT, dt=DT, **kw,
                          **(extra or {"m": 12}))
        assert e.tuned is None and (e.block, e.m2l_tile) == (0, 0)


def test_a_card_state_sweeps_the_candidates(tune_cache, box, monkeypatch):
    """With a state on a card (faked: the CPU state reporting "cuda") and
    ``autotune=True`` the engine times each of ``_fast_candidates`` once
    through ``utils/autotune.tune`` and keeps the fastest; a second engine
    reads it without a sweep."""
    times = iter([3.0, 2.0, 2.5, 1.0, 4.0, 5.0, 6.0, 1.5])
    timed = []

    def fake_measure(run_fn, state0, **kw):
        timed.append(run_fn)
        return next(times)

    monkeypatch.setattr(at, "measure_steps", fake_measure)
    monkeypatch.setattr(BodyState, "device",
                        property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    e = create_engine("tpu+proxy", box, soft=SOFT, dt=DT, autotune=True,
                      **HIER)
    cands = e._fast_candidates()
    assert len(timed) == len(cands) == 8
    assert [p for p, _ in e.tuned["sweep"]] == cands
    assert (e.block, e.m2l_tile) == (cands[3]["block"], 0)
    again = create_engine("tpu+proxy", box, soft=SOFT, dt=DT, autotune=True,
                          **HIER)
    assert len(timed) == 8 and "sweep" not in again.tuned
    assert (again.block, again.m2l_tile) == (e.block, e.m2l_tile)
    assert at.lookup(e._fast_tune_tag, box.npad, device="cuda")["block"] \
        == e.block


@pytest.mark.parametrize("mode", ["adaptive", "exact"])
def test_adaptive_mode_and_exact_fallback_skip(tune_cache, monkeypatch,
                                               mode):
    """Neither the adaptive solver nor the exact fallback has the dense
    stages: the engine neither looks up nor sweeps (murb_tpu/models/
    engines.py:678-679), and an explicit geometry is not checked."""
    def lookup(*a, **k):
        raise AssertionError("looked up")

    monkeypatch.setattr(at, "lookup", lookup)
    js = jinit.init_random(1024, 5)
    kw = ({"near": "adaptive", "soft": 1e6, "m": 4, "levels": 3}
          if mode == "adaptive" else {"soft": SOFT, "m": 40})
    e = create_engine("tpu+proxy", carry(js), dt=DT, autotune=True, **kw)
    assert (e.near_mode == "adaptive") == (mode == "adaptive")
    assert e.using_proxy == (mode == "adaptive") and e.tuned is None
    create_engine("tpu+proxy", carry(js), dt=DT, block=100, **kw)


# ------------------------------------------------------------ entries
@pytest.mark.parametrize("scheme", ["galaxy", "box"])
def test_zero_geometry_gives_todays_forces_and_tables(galaxy, box, scheme):
    """block=0 and m2l_tile=0 give the forces of a call without them, bit
    for bit, and a geometry changes nothing on the CPU; on a card the
    kernels get the parent's tables at 0: K1's items of ``p2m_chunk``
    bodies and K7's plan in items of M2L_GROUP cells (the parent's
    ``_m2l_plan(..., group)``)."""
    st = galaxy if scheme == "galaxy" else box
    gm = st.m * G
    q = (st.qx, st.qy, st.qz)
    if scheme == "galaxy":
        ref = tp.acc_proxy(*q, gm, SOFT, m=12)
        runs = [tp.acc_proxy(*q, gm, SOFT, m=12, block=0),
                tp.acc_proxy(*q, gm, SOFT, m=12, block=512)]
    else:
        ref = acc_fmm(*q, gm, SOFT, **HIER)
        runs = [acc_fmm(*q, gm, SOFT, block=0, m2l_tile=0, **HIER),
                acc_fmm(*q, gm, SOFT, block=256, m2l_tile=4, **HIER)]
    for got in runs:
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    cpu = torch.device("cpu")
    run = tk.one_run(200_000, 12, cpu, sms=132)
    assert run.chunk == fk.p2m_chunk(200_000, 12, 132) == 256
    assert tk.one_run(200_000, 12, cpu, sms=132, chunk=1024).chunk == 1024
    parent = fk._m2l_plan(8, 4, "expand", 132, fk.M2L_GROUP)
    for plan in (fk.m2l_plan(8, 4, "expand", 132),
                 fk.m2l_plan(8, 4, "expand", 132, fk.M2L_GROUP)):
        assert np.array_equal(plan.items, parent.items)
        assert np.array_equal(plan.rows, parent.rows)


def _cover(bounds: np.ndarray, prefix: np.ndarray, nitems: int,
           chunk: int) -> np.ndarray:
    """How many times the run kernels' items (each warp's run search and
    j0 = bounds[r] + (item - prefix[r]) chunk) reach each body."""
    hits = np.zeros(int(bounds[-1]), np.int64)
    for item in range(nitems):
        r = np.searchsorted(prefix, item, "right") - 1
        if r >= len(bounds) - 1 or item >= prefix[-1]:
            continue     # past the last run's items: the kernel returns
        j0 = bounds[r] + (item - prefix[r]) * chunk
        hits[j0:min(j0 + chunk, bounds[r + 1])] += 1
    return hits


def _candidates(st, kw):
    return ProxyEngine(st, soft=SOFT, dt=DT, validate=False,
                       **kw)._fast_candidates()


@pytest.mark.parametrize("which", ["proxy", "hierarchy"])
def test_every_candidate_covers_each_body_and_pair_once(galaxy, box, which):
    """For each candidate the engine would time: K1's one run and K8's cell
    runs in items of ``block`` bodies reach every body exactly once (K2's
    block and K9's item read one body a thread slot each); K7's plan in
    items of at most ``m2l_tile`` cells admits each (cell, offset) pair of
    the default plan exactly once, in rows of the compiled width."""
    st, kw = (galaxy, {}) if which == "proxy" else (box, HIER)
    cands = _candidates(st, kw)
    assert cands[0] == {"block": 0, "m2l_tile": 0} and len(cands) <= 8
    n = st.npad
    m = 12 if which == "proxy" else HIER["m"]
    C = 2 ** HIER["levels"]
    order = fk.cell_order(st.qx, st.qy, st.qz,
                          *tp.bounding_box(st.qx, st.qy, st.qz, st.m > 0), C)
    bounds = order.bounds.numpy()
    base = fk.m2l_plan(m, C, "expand", 132)
    for p in cands:
        block = p["block"] or fk.p2m_chunk(n, m, 132)
        one = tk.one_run_items(n, block, torch.device("cpu"))
        assert (_cover(one.bounds.numpy(), one.prefix.numpy(), one.nitems,
                       block) == 1).all(), p
        if which == "proxy":
            assert tk.l2p_block_for(p["block"], m) in (0, 128, 256)
            continue
        items = fk.run_items(order.bounds, n, block)
        assert (_cover(bounds, items.prefix.numpy(), items.nitems,
                       block) == 1).all(), p
        tile = p["m2l_tile"] or fk.M2L_GROUP
        plan = fk.m2l_plan(m, C, "expand", 132, p["m2l_tile"])
        assert plan.items.shape[1] == fk.M2L_ITEM_INTS
        assert (plan.items[:, 4] >= 1).all() and \
            (plan.items[:, 4] <= tile).all()
        pairs = [(tuple(it[:3]), int(c)) for it in plan.items
                 for c in it[8:8 + it[4]]]
        want = [(tuple(it[:3]), int(c)) for it in base.items
                for c in it[8:8 + it[4]]]
        assert sorted(pairs) == sorted(want) and len(set(pairs)) == \
            len(pairs) == plan.cell_pairs == base.cell_pairs


@pytest.mark.parametrize("call,msg", [
    (lambda q, g: tp.acc_proxy(*q, g, SOFT, m=12, block=96), "multiples"),
    (lambda q, g: tp.acc_proxy(*q, g, SOFT, m=12, block=2048), "1024"),
    (lambda q, g: tp.acc_proxy(*q, g, SOFT, m=12, block=64), "K2 runs"),
    (lambda q, g: tp.force_and_potential_proxy(*q, g, SOFT, m=12,
                                               block=32), "multiples"),
    (lambda q, g: acc_fmm(*q, g, SOFT, m=8, levels=2, m2l_tile=17), "1 to"),
    (lambda q, g: acc_fmm(*q, g, SOFT, m=12, levels=2, block=32),
     "multiples of 64"),
    (lambda q, g: tk.l2p_fused_multi(*q, torch.zeros(3), torch.ones(3),
                                     (torch.zeros(24 ** 3),), m=24,
                                     block=256), "(128,)"),
    (lambda q, g: fk.m2l_level_fused(torch.zeros(64, 512), torch.ones(3),
                                     SOFT, m=8, C=4, tile=-1), "1 to")])
def test_a_geometry_the_kernels_cannot_run_raises(galaxy, call, msg):
    """A value no kernel runs raises ValueError naming the range, on the
    CPU as on a card; nothing is clamped."""
    with pytest.raises(ValueError, match=msg.replace("(", r"\(")
                       .replace(")", r"\)")):
        call((galaxy.qx, galaxy.qy, galaxy.qz), galaxy.m * G)


def test_k2_block_rule():
    """K2's block for an entry's ``block``: the largest of its blocks not
    above it (256 only up to padded order 20), 0 for 0."""
    assert [tk.l2p_block_for(b, 12) for b in (0, 128, 200, 256, 1024)] == \
        [0, 128, 128, 256, 256]
    assert tk.l2p_block_for(1024, 24) == 128
    assert tk.l2p_blocks(20) == (128, 256) and tk.l2p_blocks(21) == (128,)


# ------------------------------------------- heavy_k and heavy_factor
#: scheme -> (heavy_k, heavy_factor, WithinRel eps): options that move the
#: heavy set off the default's (the galaxy's central body, 1,633 times the
#: mean mass, stays in the expansion at factor 2000; the random box's
#: heaviest bodies weigh 2.01 times the mean, and factor 2 takes the top 4)
HEAVY_CASES = {"galaxy": (1, 2000.0, 1e-1), "random": (4, 2.0, 1e-3)}


@pytest.mark.parametrize("scheme", ["galaxy", "random"])
@pytest.mark.parametrize("fn", ["acc_proxy", "force_and_potential_proxy",
                                "force_and_potential_proxy_pergal",
                                "potential_proxy"])
def test_heavy_options_match_murb_tpu(scheme, fn):
    """With a ``heavy_factor`` (and ``heavy_k``) that changes the heavy
    set, each proxy entry agrees with murb_tpu's at the same arguments
    (WithinRel 1e-3 on the random scheme, 1e-1 on the galaxy, murb_tpu's
    own tolerances)."""
    k, factor, eps = HEAVY_CASES[scheme]
    js = jinit.SCHEMES[scheme](2048, 7)
    jgm = jnp.asarray(G, js.qx.dtype) * js.m
    ts = carry(js)
    tgm = torch.from_numpy(np.array(jgm))
    jq, tq = (js.qx, js.qy, js.qz), (ts.qx, ts.qy, ts.qz)
    mean = tgm.sum() / (tgm > 0).sum()
    moved = [tp.heavy_split(*tq, tgm, k, f, mean)[2] for f in
             (tp.HEAVY_FACTOR, factor)]
    assert not torch.equal(*moved), "the factor leaves the heavy set"
    kw = {"m": 12, "heavy_k": k, "heavy_factor": factor}
    masks = np.zeros((2, 2048), np.float32)
    masks[0, :1024] = masks[1, 1024:] = 1.0
    if fn == "force_and_potential_proxy_pergal":
        got = tp.force_and_potential_proxy_pergal(
            *tq, tgm, torch.from_numpy(masks), SOFT, **kw)
        ref = jp.force_and_potential_proxy_pergal(
            *jq, jgm, jnp.asarray(masks), SOFT, **kw)
    else:
        got = getattr(tp, fn)(*tq, tgm, SOFT, **kw)
        ref = getattr(jp, fn)(*jq, jgm, SOFT, **kw)
    if fn == "acc_proxy":
        pairs = zip(got, ref)
    elif fn == "potential_proxy":
        pairs = [(got, ref)]
    else:
        pairs = [*zip(got[0], ref[0]), (got[1], ref[1])]
    for a, b in pairs:
        assert_within_rel(a.numpy(), np.asarray(b), eps, f"{fn} {scheme}")


# ------------------------------------------------ the small entries
def test_history_series_and_csv_round_trip(tmp_path):
    """``set_series`` and ``load_metrics_from_csv``, murb_tpu's, on the
    same series: the port's file loads in both packages to the same
    rows."""
    rng = np.random.default_rng(3)
    e, l, dc = rng.normal(size=5), rng.random(5), rng.normal(size=(5, 3))
    th, jh = thist.SimulationHistory(2), jhist.SimulationHistory(2)
    for h in (th, jh):
        h.set_series(energies=e, ang_momentums=l, density_centers=dc)
        assert h.num_iterations == 5
    th.set_series(energies=e[:3])
    assert th.num_iterations == 3 and len(th.ang_momentums) == 5
    th.set_series(energies=e)
    path = str(tmp_path / "m.csv")
    th.save_metrics_to_csv(path)
    for cls in (thist.SimulationHistory, jhist.SimulationHistory):
        back = cls.load_metrics_from_csv(path)
        np.testing.assert_array_equal(back.energies, e)
        np.testing.assert_array_equal(back.ang_momentums, l)
        np.testing.assert_array_equal(back.density_centers, dc)
    one = str(tmp_path / "one.csv")
    thist.SimulationHistory(1).save_metrics_to_csv(one)
    assert thist.SimulationHistory.load_metrics_from_csv(one) \
        .num_iterations == 1


def test_leapfrog_positions_and_state_views():
    """``leapfrog_positions`` (x_0 at iteration 0, the x_n buffer after)
    and the stacked ``positions`` / ``velocities`` views equal murb_tpu's
    on one state."""
    js = jinit.init_galaxy(300, 4)
    ts = carry(js)
    jaux = jint.LeapfrogAux.zeros_like(js)._replace(nqx=js.qx * 2.0)
    taux = tint.LeapfrogAux.zeros_like(ts)._replace(nqx=ts.qx * 2.0)
    for it in (0, 1, 5):
        for a, b in zip(tint.leapfrog_positions(ts, taux, it),
                        jint.leapfrog_positions(js, jaux, it)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ts.positions().numpy(),
                                  np.asarray(js.positions()))
    np.testing.assert_array_equal(ts.velocities().numpy(),
                                  np.asarray(js.velocities()))
    assert ts.positions().shape == (ts.npad, 3)


def test_perf_reset_and_bandwidth():
    for mod in (tperf, jperf):
        p = mod.Perf(2.0e6)
        assert p.get_mem_bandwidth_gbs(2 * 1024 ** 3) == 1.0
        p.reset()
        assert p.get_elapsed_time() == 0.0
        assert p.get_mem_bandwidth_gbs(1.0) == 0.0
    assert tperf.Perf(1234.0).get_mem_bandwidth_gbs(5e9) == \
        jperf.Perf(1234.0).get_mem_bandwidth_gbs(5e9)
