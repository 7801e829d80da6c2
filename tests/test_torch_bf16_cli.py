"""Every ``--im`` tag that murb_tpu runs in bf16 runs through the port's
CLI with ``--precision bf16 --device cpu``: 3 steps at 2048 bodies from
murb_tpu's bf16 galaxy (handed to the CLI as a bf16 checkpoint), the
final positions held to murb_tpu's engine on the same state at
tests/test_oracle.py's bf16 tolerance (WithinRel 2e-2, rms floor 2e-2),
and ``mem. allocated`` equal.  ``shard+adaptive``, whose ladder climbs
to its top in bf16 (no rung meets 1e-4), has a file of its own
(tests/test_torch_bf16_shard_adaptive.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu.core import init as jinit
from murb_tpu.models import create_engine as jcreate
from murb_tpu_torch import cli
from murb_tpu_torch.core import checkpoint as tck
from murb_tpu_torch.core.init import milkyway_andromeda_masks
from murb_tpu_torch.core.state import FIELDS, BodyState

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0
N = 2048

TAGS = ["nop", "xla+naive", "xla+chunked", "tpu+tile", "tpu+hybrid",
        "tpu+hybrid+fast", "tpu+hybrid+x3", "tpu+mxu", "tpu+proxy",
        "tpu+kdk", "tpu+yoshida4", "tpu+leapfrog", "tpu+leapfrog+tracking",
        "tpu+tracking", "tpu+tracking+multi", "shard+allgather",
        "shard+ring", "shard+uneven", "shard+proxy", "shard+fmm"]


def run_both(tag, tmp_path, n=N, scheme="galaxy"):
    """(murb_tpu's engine after 3 steps, the port's CLI run) on murb_tpu's
    bf16 state of ``scheme``."""
    js = jinit.SCHEMES[scheme](n, 123, dtype=jnp.bfloat16)
    kw, argv = {}, []
    if tag.startswith("shard+"):
        kw["shards"], argv = 4, ["--shards", "4"]
    if "leapfrog" in tag or "tracking" in tag:
        kw["num_iterations"] = 3
    if tag == "tpu+tracking+multi":
        kw["masks"] = milkyway_andromeda_masks(js.npad, js.n)
    ref = jcreate(tag, js, soft=SOFT, dt=DT, **kw)
    for _ in range(3):
        ref.compute_one_iteration()
    path = str(tmp_path / "s.npz")
    tck.save_state(path, BodyState.from_numpy(
        {k: np.asarray(getattr(js, k)) for k in FIELDS}, js.n, js.padding,
        "cpu"), dt=DT, soft=SOFT)
    res = cli.run(["-n", str(n), "-i", "3", "--im", tag, "--precision",
                   "bf16", "--nv", "--device", "cpu", "--load-state", path,
                   *argv])
    return ref, res


@pytest.mark.parametrize("tag", TAGS)
def test_tag_runs_in_bf16_as_murb_tpu(tag, tmp_path):
    check_tag(tag, tmp_path)


def check_tag(tag, tmp_path):
    """The port's CLI run of ``tag`` against murb_tpu's engine."""
    ref, res = run_both(tag, tmp_path)
    assert res.rc == 0
    eng = res.engine
    assert eng.bodies.dtype == torch.bfloat16
    a, b = ref.bodies.unpadded(), eng.bodies.unpadded()
    for c in ("qx", "qy", "qz"):
        assert_within_rel(np.asarray(b[c], np.float64),
                          np.asarray(a[c], np.float64), 2e-2,
                          f"{tag} bf16 {c} after 3 steps", rms_floor=2e-2)
    if "tracking" in tag:
        check_metrics(tag, eng, ref)
    # shard+uneven keeps a replica of the state on each shard and counts
    # one, as murb_tpu's banner does
    assert eng.allocated_bytes == ref.allocated_bytes
    assert ref.allocated_bytes == 2 * 8 * ref.bodies.npad


def check_metrics(tag, eng, ref):
    """The tracked metrics of the bf16 galaxy, float64 on both sides.  Row
    0's energy within 1e-3 (PERF.md §2's contract) of the exact energy of
    the initial bf16 state, the sweep in float64 with G*m as the engines
    form it (bf16) and the softening as the path takes it (the exact
    metrics sweep rounds eps to bf16, as murb_tpu's; the multi-galaxy
    path's potential rows, K5, take it unrounded); |L| within 1e-4 of
    murb_tpu's (ROADMAP.md Lessons); the energy within 2e-2 of murb_tpu's,
    whose own bf16 energy misses the exact one by 2.7e-3 (the exact sweep)
    and 1.3e-2 (the rows) on this state (ROADMAP.md Queue 3)."""
    from murb_tpu_torch.core import metrics as tm

    ht, hj = (e.finalize_history() if tag.endswith("multi") else e.history
              for e in (eng, ref))
    js = jinit.init_galaxy(N, 123, dtype=jnp.bfloat16)
    s0 = BodyState.from_numpy({k: np.asarray(getattr(js, k))
                               for k in FIELDS}, js.n, js.padding, "cpu")
    soft = SOFT if tag.endswith("multi") else float(
        torch.tensor(SOFT, dtype=torch.bfloat16))
    exact = 0.0
    # the multi-galaxy series sums each galaxy's own energy
    for mask in (milkyway_andromeda_masks(s0.npad, s0.n)
                 if tag.endswith("multi") else [np.ones(s0.npad)]):
        sg = tm.masked(s0, torch.from_numpy(mask))
        q64 = [v.double() for v in (sg.qx, sg.qy, sg.qz, sg.m)]
        pe = tm.potential_energy_per_body(*q64, tm._gm(sg).double(), soft)
        ke = tm.kinetic_energy_per_body(sg.m, sg.vx, sg.vy, sg.vz)
        exact += float((0.5 * pe + 0.5 * ke).sum())
    assert ht.energies.dtype == hj.energies.dtype == np.float64
    assert abs(ht.energies[0] - exact) <= 1e-3 * abs(exact), \
        (ht.energies[0], exact, hj.energies[0])
    np.testing.assert_allclose(ht.energies, hj.energies, rtol=2e-2,
                               err_msg=f"{tag} bf16 energies")
    np.testing.assert_allclose(ht.ang_momentums, hj.ang_momentums,
                               rtol=1e-4, err_msg=f"{tag} bf16 |L|")


def test_proxy_ladder_misses_and_keeps_as_murb_tpu(capsys):
    """The 4096-body galaxy in bf16 through each package's CLI (murb_tpu's
    in a process of its own, where x64 is off as its CLI runs it): no rung
    of the ladder meets 1e-4 (the forces come out in bf16), and both keep
    (m, levels, cells) = (16, 0, 1) with the same warning, the port's
    measured error within a factor of 2 of murb_tpu's either way (4.9e-3
    against 7.0e-3: the port's stages round each chain once, as XLA's fused
    chains do, ops/common.bf16_chain); the banner's memory is half the
    fp32 run's."""
    import os
    import re
    import subprocess
    import sys

    keep = ("WARNING: fast-solver validation missed tol=1.0e-04 after 6 "
            "escalations; keeping the best config m=16 levels=0 cells=1")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-m", "murb_tpu", "-n", "4096",
                          "-i", "1", "--im", "tpu+proxy", "--precision",
                          "bf16", "--nv"], capture_output=True, text=True,
                         timeout=600, env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert keep in ref.stdout, ref.stdout
    assert "mem. allocated            : 0.0625 MB" in ref.stdout
    res = cli.run(["-n", "4096", "-i", "1", "--im", "tpu+proxy",
                   "--precision", "bf16", "--nv", "--device", "cpu"])
    out = capsys.readouterr().out
    assert res.rc == 0
    e = res.engine
    assert (e.m, e.levels, e.cells) == (16, 0, 1)
    assert keep in out, out
    ref_err = float(re.search(re.escape(keep) + r" \(measured err ([^)]+)\)",
                              ref.stdout).group(1))
    assert ref_err / 2 <= e.validated_err <= 2 * ref_err, \
        (e.validated_err, ref_err)
    assert "mem. allocated            : 0.0625 MB" in out
