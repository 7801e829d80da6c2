"""Nothing the benchmark runs loads ``jax`` or ``murb_tpu`` (each module's
top-level name compared whole), and its yardstick loads nothing of the
program."""
import json
import subprocess
import sys

from nbody_bench import harness, run

_WALK = r"""
import json, sys, time
from nbody_bench import control, harness, run
for cell in ("galaxy200k.exact", "clusters1m.adaptive"):
    spec = harness.Spec(cell)
    for kind in ("metrics", "schemes", "references"):
        for p in sorted((spec.data / kind).glob("*.py")):
            harness.load_module(p)
    for traced in (False, True):
        harness.run_cell(spec, 3, 0.1, traced, "cpu", time.perf_counter(),
                         n=512)
print(json.dumps(sorted(sys.modules)))
"""

_YARDSTICK = r"""
import json, sys
from nbody_bench import check, roofline, trace
from nbody_bench.harness import load_module, ROOT
for kind in ("references", "schemes"):
    for p in sorted((ROOT / "nbody_bench" / kind).glob("*.py")):
        load_module(p)
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = _modules(_WALK)
    tops = {m.split(".")[0] for m in mods}
    assert "murb_tpu_torch" in tops          # the program ran
    assert not tops & run.FORBIDDEN, sorted(tops & run.FORBIDDEN)


def test_the_yardstick_loads_nothing_of_the_program():
    tops = {m.split(".")[0] for m in _modules(_YARDSTICK)}
    assert not tops & (run.FORBIDDEN | {"murb_tpu_torch"})


def test_names_are_compared_whole():
    names = ["murb_tpu_torch", "murb_tpu_torch.ops", "jaxtyping", "flaxen"]
    assert run.foreign_modules(names) == []
    assert run.foreign_modules(names + ["murb_tpu.core", "jax"]) == [
        "jax", "murb_tpu"]
