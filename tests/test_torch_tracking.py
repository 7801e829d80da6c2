"""The port's tracked engines against murb_tpu's, on one carried state.

Each case builds its state with ``murb_tpu.core.init``, carries the arrays
into the port, runs the same engine in both packages, and compares the
recorded histories (murb_tpu's already multiplied back by its metric
scales) and the final positions.  murb_tpu runs its Pallas kernels in
interpret mode here, as tests/test_multigalaxy.py does.

Tolerances: histories within rtol 1e-6 on the exact paths and 1e-5 on the
proxy paths (murb_tpu's own tracked tests use 1e-5; the measured gaps are
1e-7 and 3e-6); final positions WithinRel 1e-4 with an rms floor of 1e-4.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu.core import init as jinit
from murb_tpu.models import create_engine as jcreate
from murb_tpu_torch import cli
from murb_tpu_torch.core import init as tinit
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine as tcreate

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOFT = 2.0e8
DT = 3600.0
SERIES = ("energies", "ang_momentums", "density_centers")


def carry(js) -> BodyState:
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


def half_masks(npad, n):
    a, b = np.zeros(npad, np.float32), np.zeros(npad, np.float32)
    a[: n // 2] = 1.0
    b[n // 2: n] = 1.0
    return [a, b]


def same_history(t, j, rtol, msg):
    for k in SERIES:
        ref = getattr(j, k)
        np.testing.assert_allclose(getattr(t, k), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max(),
                                   err_msg=f"{msg} {k} (rtol {rtol})")


def same_positions(te, je, msg):
    a, b = je.bodies.unpadded(), te.bodies.unpadded()
    for k in ("qx", "qy", "qz"):
        assert_within_rel(b[k], a[k], 1e-4, f"{msg} {k}", rms_floor=1e-4)


def run_both(tag, js, n_ite, **kw):
    je = jcreate(tag, js, soft=SOFT, dt=DT, num_iterations=n_ite, **kw)
    te = tcreate(tag, carry(js), soft=SOFT, dt=DT, num_iterations=n_ite,
                 **kw)
    je.run(n_ite)
    te.run(n_ite)
    return je, te


@pytest.mark.parametrize("scheme,n,kw,rtol", [
    ("random", 2048, {}, 1e-6),
    ("galaxy", 2049, {}, 1e-6),
    ("random", 1024, {"fused_exact": True}, 1e-6),
    ("galaxy", 2048, {"fused_proxy_m": 12}, 1e-5),
])
def test_tracking_engine_matches_murb_tpu(scheme, n, kw, rtol):
    js = jinit.SCHEMES[scheme](n, 3)
    je, te = run_both("gpu+tracking", js, 4, **kw)
    assert te._use_fused_exact() == bool(kw.get("fused_exact"))
    same_history(te.history, je.history, rtol, f"tracking {kw}")
    same_positions(te, je, f"tracking {kw}")


@pytest.mark.parametrize("kw,rtol", [({}, 1e-6), ({"fused_proxy_m": 12}, 1e-5)])
def test_leapfrog_tracking_matches_murb_tpu(kw, rtol):
    js = jinit.init_galaxy(2048, 9)
    je, te = run_both("gpu+leapfrog+tracking", js, 5, **kw)
    same_history(te.history, je.history, rtol, f"leapfrog tracking {kw}")
    same_positions(te, je, f"leapfrog tracking {kw}")


@pytest.mark.parametrize("scheme,n,kw,rtol", [
    ("random", 1024, {}, 1e-6),
    ("random", 1024, {"fused_exact": True}, 1e-6),
    ("galaxy", 2048, {"fused_proxy_m": 16}, 1e-5),
    ("galaxy", 1024, {"metrics_method": "proxy", "metrics_proxy_m": 16},
     1e-5),
])
def test_multi_galaxy_engine_matches_murb_tpu(scheme, n, kw, rtol):
    js = jinit.SCHEMES[scheme](n, 5)
    je, te = run_both("gpu+tracking+multi", js, 3,
                      masks=half_masks(js.npad, js.n), **kw)
    hj, ht = je.finalize_history(), te.finalize_history()
    for g in range(2):
        same_history(ht.galaxies[g], hj.galaxies[g], rtol, f"galaxy {g}")
    same_history(ht, hj, rtol, "global")
    total = ht.galaxies[0].energies + ht.galaxies[1].energies
    np.testing.assert_allclose(ht.energies, total, rtol=1e-12)
    same_positions(te, je, f"multi {kw}")


@pytest.mark.parametrize("tag,kw", [
    ("tpu+tracking", {}),
    ("tpu+tracking", {"fused_proxy_m": 12}),
    ("tpu+leapfrog+tracking", {"fused_proxy_m": 12}),
    ("tpu+tracking+multi", {"fused_exact": True}),
])
def test_run_matches_stepwise_and_copies_once(tag, kw, monkeypatch):
    js = jinit.init_galaxy(2048, 4)
    if tag.endswith("multi"):
        kw = dict(kw, masks=half_masks(js.npad, js.n))
    a = tcreate(tag, carry(js), soft=SOFT, dt=DT, num_iterations=6, **kw)
    b = tcreate(tag, carry(js), soft=SOFT, dt=DT, num_iterations=6, **kw)
    for _ in range(6):
        a.compute_one_iteration()
    copies = []
    real = type(b)._record
    monkeypatch.setattr(type(b), "_record",
                        lambda self, i0, rows: (copies.append(rows.shape),
                                                real(self, i0, rows)))
    b.run(4)
    b.run(3)                       # one row past the history is dropped
    assert [s[0] for s in copies] == [4, 2]
    series = [(a.history, b.history)]
    if tag.endswith("multi"):
        series = list(zip(a.history.galaxies, b.history.galaxies))
    for ha, hb in series:
        same_history(hb, ha, 1e-12, f"{tag} run vs stepwise")
    assert b._iteration == 7


def test_tracked_options_not_ported_raise_and_health():
    from murb_tpu.ops.sparse_fmm import plan_adaptive as jplan
    from murb_tpu_torch.ops.sparse_fmm import SparsePlan

    s = carry(jinit.init_galaxy(512, 1))
    u = s.unpadded()
    q = np.stack([u["qx"], u["qy"], u["qz"]], 1)[u["m"] > 0]
    plan = jplan(q, s.npad, 6, 2, 4)
    with pytest.raises(ValueError, match="exclusive"):
        tcreate("tpu+tracking", s, num_iterations=2, fused_proxy_m=12,
                fused_adaptive=SparsePlan.from_fields(**plan._asdict()))
    # the adaptive capacity health: murb_tpu's, field for field
    h = tcreate("tpu+tracking", s, num_iterations=2,
                fused_adaptive=SparsePlan.from_fields(
                    **plan._asdict())).proxy_health()
    assert h == jcreate("tpu+tracking", jinit.init_galaxy(512, 1),
                        num_iterations=2,
                        fused_adaptive=plan).proxy_health()
    assert h["ok"] and h["near"] == "adaptive"
    with pytest.raises(ValueError, match="exclusive"):
        tcreate("tpu+tracking", s, num_iterations=2, fused_proxy_m=12,
                fused_fmm=(8, 2))
    with pytest.raises(ValueError, match="metrics method"):
        tcreate("tpu+tracking", s, num_iterations=2, metrics_method="fmm")
    assert tcreate("tpu+tracking", s, num_iterations=2).proxy_health() is None
    js = jinit.init_galaxy(512, 1)
    for kw in ({"fused_fmm": (10, 2)}, {"fused_fmm": (6, 3)},
               {"fused_fmm": (8, 2), "validated_half": 1e12},
               {"fused_proxy_m": 12}, {"fused_proxy_m": 20},
               {"fused_proxy_m": 12, "validated_half": 1e12}):
        h = tcreate("tpu+leapfrog+tracking", s, num_iterations=2,
                    **kw).proxy_health()
        jh = jcreate("tpu+leapfrog+tracking", js, num_iterations=2,
                     **kw).proxy_health()
        assert h == jh, kw
    assert h["ok"] and h["levels"] == 0      # the certified box wins


def test_masks_are_zero_extended_to_the_state():
    js = jinit.init_random(300, 2)                      # npad 512
    short = [m[:300] for m in half_masks(js.npad, js.n)]
    e = tcreate("tpu+tracking+multi", carry(js), soft=SOFT, dt=DT,
                num_iterations=2, masks=short)
    assert e.masks.shape == (2, 512) and float(e.masks[:, 300:].sum()) == 0
    full = tcreate("tpu+tracking+multi", carry(js), soft=SOFT, dt=DT,
                   num_iterations=2, masks=half_masks(js.npad, js.n))
    e.run(2)
    full.run(2)
    for g in range(2):
        same_history(e.history.galaxies[g], full.history.galaxies[g], 0.0,
                     "short masks")
    with pytest.raises(ValueError, match="mask of 600"):
        tcreate("tpu+tracking+multi", carry(js), num_iterations=2,
                masks=[np.ones(600, np.float32)])


# ------------------------------------------------------ the merger's input
@pytest.fixture(scope="module")
def merger_tab(tmp_path_factory):
    """The real two-galaxy initial conditions, written by the repo's
    generator into a temporary directory (as bench.py:99-105 does)."""
    path = tmp_path_factory.mktemp("merger") / "mw_andromeda.tab"
    subprocess.run([sys.executable, "scripts/make_two_galaxy_tab.py",
                    str(path)], cwd=ROOT, check=True, capture_output=True,
                   timeout=240)
    return str(path)


def test_merger_loader_and_masks_match_murb_tpu(merger_tab):
    js = jinit.init_milkyway_andromeda(merger_tab)
    ts = tinit.make_bodies(0, "milkyway_andromeda", scheme_file=merger_tab,
                           device="cpu")
    assert (ts.n, ts.npad) == (js.n, js.npad) == (81920, 81920)
    back = ts.to_numpy()
    for k in FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(js, k)),
                                      err_msg=k)
    for npad, n in ((js.npad, js.n), (82176, 81920), (1024, 1000)):
        for a, b in zip(tinit.milkyway_andromeda_masks(npad, n),
                        jinit.milkyway_andromeda_masks(npad, n)):
            np.testing.assert_array_equal(a, b)
    mw, an = tinit.milkyway_andromeda_masks(js.npad, js.n)
    assert mw.sum() == an.sum() == 40960


# ----------------------------------------------------------------- the CLI
def _csv(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


@pytest.mark.parametrize("argv,rtol", [
    (["--scheme-file"], 1e-6),        # a cut of the merger file, exact
    (["--kernel", "proxy"], 1e-5),    # galaxy, the fused proxy
])
def test_cli_tracking_csv_matches_murb_tpu(argv, rtol, merger_tab, tmp_path,
                                           monkeypatch, capsys):
    from murb_tpu import cli as jcli

    common = ["-i", "4", "--im", "gpu+tracking", "--nv"]
    if argv == ["--scheme-file"]:
        cut = tmp_path / "cut.tab"
        with open(merger_tab) as f:
            cut.write_text("".join(next(f) for _ in range(1000)))
        common += ["-n", "1000", "-s", "milkyway_andromeda",
                   "--scheme-file", str(cut)]
    else:
        js = jinit.init_galaxy(2048, 123)
        monkeypatch.setattr(jcli, "make_bodies", lambda *a, **k: js)
        monkeypatch.setattr(cli, "make_bodies", lambda *a, **k: carry(js))
        common += ["-n", "2048", *argv]
    assert jcli.main([*common, "--csv", str(tmp_path / "j.csv")]) == 0
    res = cli.run([*common, "--csv", str(tmp_path / "t.csv"),
                   "--device", "cpu"])
    assert res.rc == 0
    assert f"Metrics written to {tmp_path / 't.csv'}" in capsys.readouterr().out
    j, t = _csv(tmp_path / "j.csv"), _csv(tmp_path / "t.csv")
    assert t.shape == j.shape == (4, 6)
    np.testing.assert_array_equal(t[:, 0], np.arange(4))
    for c in range(1, 6):
        np.testing.assert_allclose(t[:, c], j[:, c], rtol=rtol,
                                   atol=rtol * np.abs(j[:, c]).max(),
                                   err_msg=f"CSV column {c}")
    if argv == ["--kernel", "proxy"]:
        assert res.engine._fused_proxy_m == 12
        assert res.engine.proxy_health()["ok"]


@pytest.mark.parametrize("argv,msg", [
    (["--im", "tpu+kdk", "--kernel", "bogus"], "unknown kernel"),
    (["--im", "gpu+tracking", "-s", "milkyway_andromeda", "--scheme-file",
      "no/such.tab"], "not found"),
])
def test_cli_tracked_paths_refuse_what_is_not_ported(argv, msg, capsys):
    rc = cli.main(["-n", "512", "-i", "2", "--nv", "--device", "cpu", *argv])
    assert rc == 1
    assert msg in capsys.readouterr().out


@pytest.mark.parametrize("argv,tier,fused", [
    (["--kernel", "fmm", "--m2l-dots", "bf16x3"], "bf16x3", "_fused_fmm"),
    # proxy -> fmm (m > 32) -> the adaptive kernel (m > 16), at the tier
    (["--kernel", "proxy", "-s", "random", "--soft", "1e6", "--m2l-dots",
      "mixed"], "mixed", "_fused_adaptive"),
])
def test_cli_tracked_paths_run_the_lossy_m2l_tiers(argv, tier, fused,
                                                   capsys):
    """``--m2l-dots`` reaches the tracked step's fused far-field pass."""
    res = cli.run(["-n", "512", "-i", "2", "--nv", "--device", "cpu", "--im",
                   "gpu+tracking", *argv])
    assert res.rc == 0
    res.engine.assert_finite()
    assert res.engine._m2l_dots == tier
    assert getattr(res.engine, fused) not in (None, ())


def test_cli_multi_galaxy_on_the_merger_cut(merger_tab, tmp_path):
    """``tpu+tracking+multi`` through the CLI gets the Milky Way and
    Andromeda masks; on a cut of the file the first 1000 rows are all
    Milky Way, so the global series equals galaxy 0's and galaxy 1 is
    empty."""
    cut = tmp_path / "cut.tab"
    with open(merger_tab) as f:
        cut.write_text("".join(next(f) for _ in range(1000)))
    res = cli.run(["-n", "1000", "-i", "3", "--im", "gpu+tracking+multi",
                   "--nv", "--device", "cpu", "-s", "milkyway_andromeda",
                   "--scheme-file", str(cut), "--csv",
                   str(tmp_path / "m.csv")])
    assert res.rc == 0
    h = res.engine.history
    np.testing.assert_array_equal(h.energies, h.galaxies[0].energies)
    assert np.all(h.galaxies[1].energies == 0.0)
    assert _csv(tmp_path / "m.csv").shape == (3, 6)
