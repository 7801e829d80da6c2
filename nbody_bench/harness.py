"""One run of one cell: inputs from the seed, the engine, the frame loop, the
window or the traced frames, the metrics and the comparison.

Everything that belongs to a configuration, a cell, a traffic mix or a
metric is a file under ``nbody_bench/`` found by its name:
``workloads/<cell>.json`` (its ``config`` and ``traffic``, the ``--im``
tag, engine options, precision, frame counts, the comparison's sample and
limits), ``configs/<config>.json`` (sizes, physics and guarantees; its
``scheme`` names ``schemes/<scheme>.py`` and its ``reference``
``references/<reference>.py``), ``traffic/<traffic>.json`` (the frame
loop's shape) and ``metrics/<metric>.py`` (a ``read(run)`` that returns
the metric or None), for the metrics ``BENCHMARK.json`` gives the cell.

The traffic is the CLI's frame loop with a viewer: one client, frames back
to back, a frame being ``steps_per_frame`` calls of
``engine.compute_one_iteration()``, a synchronise, and the copy of the
``readback`` fields of the n bodies to the host (``core/state.host_array``).
A window ends on a whole number of the cell's ``period_frames`` (1 where
the file gives none): the frames run until ``--seconds`` are up and then
to the end of the period they are in, so a cost the program pays once a
period (``adapt_every``'s health check) weighs the same in every window.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import statistics
import time
from pathlib import Path

import numpy as np

from nbody_bench import check, trace

ROOT = Path(__file__).resolve().parent.parent
DATA = "nbody_bench"
FIELDS = ("m", "r", "qx", "qy", "qz", "vx", "vy", "vz")
_DTYPES = ("float32", "bfloat16")
#: the frame's consumer reads every this many bodies: a non-finite value
#: reaches every body's acceleration within a step (each sums over all the
#: others), so the strided read finds a non-finite state at most a frame
#: late, for a few microseconds where a full read takes 0.5-1.1 ms of the
#: card's host a 200k frame; the last frame is read whole
CONSUMER_STRIDE = 64


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file ``path`` as a module of its own."""
    name = "nbody_bench._loaded." + "_".join(path.relative_to(
        path.parents[1]).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """A cell as ``BENCHMARK.json`` and its files under ``root`` give it."""

    def __init__(self, workload: str, root: Path = ROOT):
        self.root = Path(root)
        self.data = self.root / DATA
        bench = load_json(self.root / "BENCHMARK.json")
        self.name = workload
        entries = {w["name"]: w for w in bench["workloads"]}
        if workload not in entries:
            raise KeyError(f"{workload!r} is not a cell of BENCHMARK.json "
                           f"({', '.join(sorted(entries))})")
        entry = entries[workload]
        self.cell = load_json(self.data / "workloads" / f"{workload}.json")
        for k in ("config", "traffic"):
            if entry[k] != self.cell[k]:
                raise ValueError(f"{workload}: BENCHMARK.json's {k} "
                                 f"{entry[k]!r} is not its file's "
                                 f"{self.cell[k]!r}")
        self.chips = int(entry["chips"])
        self.config = load_json(
            self.data / "configs" / f"{self.cell['config']}.json")
        self.traffic = load_json(
            self.data / "traffic" / f"{self.cell['traffic']}.json")
        # a metric without a ``workloads`` list: end to end, every cell's;
        # per layer, every cell that reports the metric it moves
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])
                          and m["moves"] in e2e]

    def module(self, kind: str, name: str):
        return load_module(self.data / kind / f"{name}.py")


class RunView:
    """What a metric reader sees of a run.  ``frames``, ``window_s`` and
    ``frame_s`` describe the frames of the window (in a traced run, the
    unprofiled frames before the profiled ones); ``spans`` holds each
    frame's host spans in seconds (``dispatch``: the steps' calls;
    ``sync``: the synchronise; ``readback``: the copies); ``trace`` the
    profiled frames (a ``trace.TraceView``, None without ``--trace 1``)."""

    def __init__(self, spec: Spec, n: int):
        self.spec, self.cell, self.config = spec, spec.cell, spec.config
        self.n = n
        self.steps_per_frame = int(spec.traffic["steps_per_frame"])
        self.frames = 0
        self.window_s = 0.0
        self.frame_s: list[float] = []
        self.spans: dict[str, list[float]] = {
            k: [] for k in ("dispatch", "sync", "readback")}
        self.setup_s = math.nan
        self.trace: trace.TraceView | None = None


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from the seed
    (Vitter's algorithm R), so the sampled steps of a window of unknown
    length are fixed by the seed and the frame count."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng([seed, 0xF4A3E])

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class FrameLoop:
    """The traffic's frame loop over one engine."""

    def __init__(self, engine, n: int, traffic: dict, view: RunView):
        from murb_tpu_torch.core.state import host_array

        self.engine, self.n, self.view = engine, n, view
        self.steps = int(traffic["steps_per_frame"])
        self.fields = tuple(traffic["readback"])
        self.host_array = host_array
        self.failed = 0

    def frame(self, record: bool, annotate: bool = False):
        """One frame; returns (state before its last step, that step's
        accelerations, state after, read-back arrays by field).  With
        ``record`` its times go to the view's spans and frame times."""
        ann = _annotation if annotate else _no_annotation
        eng = self.engine
        with ann("frame"):
            t0 = time.perf_counter()
            with ann("dispatch"):
                for i in range(self.steps):
                    if i == self.steps - 1:
                        pre = eng.bodies
                    eng.compute_one_iteration()
            t1 = time.perf_counter()
            with ann("sync"):
                eng.block_until_ready()
            t2 = time.perf_counter()
            post = eng.bodies
            with ann("readback"):
                host = self._read_back(post)
            t3 = time.perf_counter()
        # the frame's consumer: a frame with a non-finite value has failed
        with ann("consume"):
            self.last, self.last_ok = host, all(
                math.isfinite(float(h[::CONSUMER_STRIDE].sum()))
                for h in host.values())
            self.failed += not self.last_ok
        if record:
            v = self.view
            v.frame_s.append(t3 - t0)
            for k, dt in (("dispatch", t1 - t0), ("sync", t2 - t1),
                          ("readback", t3 - t2)):
                v.spans[k].append(dt)
        return pre, eng.accelerations, post, host

    def _read_back(self, state) -> dict:
        return {k: self.host_array(getattr(state, k)[:self.n])
                for k in self.fields}

    def first_step(self):
        """The run's first step alone, read back as a frame: the step the
        comparison follows from the benchmark's own inputs."""
        eng = self.engine
        eng.compute_one_iteration()
        eng.block_until_ready()
        return None, eng.accelerations, eng.bodies, self._read_back(
            eng.bodies)


def _annotation(name: str):
    import torch

    return torch.profiler.record_function(trace.SPAN + name)


_no_annotation = lambda name: contextlib.nullcontext()


def make_inputs(spec: Spec, seed: int, n: int) -> dict:
    """The configuration's bodies from ``seed``: float64 arrays."""
    return spec.module("schemes", spec.config["scheme"]).generate(n, seed)


def rounded(a: np.ndarray, precision: str) -> np.ndarray:
    """``a`` as the configuration's state precision holds it, in float64."""
    if precision != "float32":
        raise ValueError(f"no reference rounding for {precision!r}")
    return np.asarray(a, np.float32).astype(np.float64)


def build_engine(spec: Spec, inputs: dict, n: int, device, cell: dict):
    import torch

    from murb_tpu_torch.core.state import BodyState
    from murb_tpu_torch.models import create_engine

    if cell["precision"] not in _DTYPES:
        raise ValueError(f"precision {cell['precision']!r} not in {_DTYPES}")
    state = BodyState.from_arrays(
        *(inputs[k] for k in FIELDS), n=n,
        dtype=getattr(torch, cell["precision"]), device=device,
        ghost_positions=inputs["ghost_q"], ghost_velocities=inputs["ghost_v"])
    cfg = spec.config
    return create_engine(cell["tag"], state, soft=cfg["soft"], dt=cfg["dt"],
                         tol=cfg["tol"], **cell.get("engine", {}))


def _host_sample(item, n: int, before: dict | None = None) -> dict:
    """A kept step's arrays on the host in float64, (n, 3) each; the state
    before the step is ``before`` where given (the benchmark's inputs)."""
    pre, acc, post, host = item
    col = lambda t: t[:n].detach().double().cpu().numpy()
    xyz = lambda st, f: np.stack([col(getattr(st, f + c)) for c in "xyz"], 1)
    q1 = [host[k].astype(np.float64) if k in host else col(getattr(post, k))
          for k in ("qx", "qy", "qz")]
    return {**(before or {"q0": xyz(pre, "q"), "v0": xyz(pre, "v")}),
            "a": np.stack([col(acc.ax), col(acc.ay), col(acc.az)], 1),
            "q1": np.stack(q1, 1), "v1": xyz(post, "v")}


def run_cell(spec: Spec, seed: int, seconds: float, traced: bool, device,
             t_start: float, n: int | None = None,
             overrides: dict | None = None,
             engine_hook=None) -> tuple[dict, RunView]:
    """Run ``spec``'s cell once; returns (the result object, the run's
    view).  ``t_start`` is the ``time.perf_counter()`` of the process's
    start, from which set-up is counted.  ``n`` (a smaller body count),
    ``overrides`` (cell keys replaced, ``allow_tf32``) and ``engine_hook``
    (applied to the engine before the first frame) are for the controls
    and the tests."""
    import torch

    cell = dict(spec.cell, **(overrides or {}))
    cfg, traffic = spec.config, spec.traffic
    dev = torch.device(device)
    n = int(n or cfg["n"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.get("allow_tf32"))
    torch.backends.cudnn.allow_tf32 = bool(cell.get("allow_tf32"))
    view = RunView(spec, n)
    reference = spec.module("references", cfg["reference"])

    inputs = make_inputs(spec, seed, n)
    engine = build_engine(spec, inputs, n, dev, cell)
    if engine_hook is not None:
        engine_hook(engine)
    loop = FrameLoop(engine, n, traffic, view)
    chk = cell["check"]
    keep = Reservoir(int(chk["steps"]), seed)
    period = int(cell.get("period_frames", 1))
    whole = lambda k: -(-k // period) * period   # k frames up to periods

    # warm-up: every shape of the window, and as many kept steps as the
    # window keeps, so the allocator holds their blocks before it opens
    start = loop.first_step()
    spare = [loop.frame(record=False)
             for _ in range(max(int(cell["warmup_frames"]), keep.k + 1))]
    del spare
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    view.setup_s = t0 - t_start
    loop.failed = raised = 0
    try:
        if traced:    # frames with host spans, then profiled ones
            for _ in range(whole(int(cell["span_frames"]))):
                keep.offer(loop.frame(record=True))
            view.frames, view.window_s = keep.seen, time.perf_counter() - t0
            view.trace = _profiled(loop, keep, int(cell["profiled_frames"]),
                                   dev)
        else:
            while True:
                keep.offer(loop.frame(record=True))
                if (time.perf_counter() - t0 >= seconds
                        and keep.seen % period == 0):
                    break
            view.frames, view.window_s = keep.seen, time.perf_counter() - t0
    except Exception:   # a frame that raised: the window ends, not correct
        import traceback

        traceback.print_exc()
        raised = 1
    attempted = keep.seen + raised
    last_whole = all(np.isfinite(h).all() for h in loop.last.values())
    failed = loop.failed + raised + (loop.last_ok and not last_whole)
    mem_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)

    # the program's part ends here: its outputs to the host, its state freed
    first = {k: np.stack([rounded(inputs[x], cfg["precision"]) for x in f],
                         1) for k, f in (("q0", ("qx", "qy", "qz")),
                                         ("v0", ("vx", "vy", "vz")))}
    samples = [_host_sample(start, n, first)] + [_host_sample(it, n)
                                                 for it in keep.items]
    del start, keep, loop, engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    values = check.compare(samples, rounded(inputs["m"], cfg["precision"]),
                           cfg, reference, int(chk["stratum"]), seed, dev)
    checks = {k: (values[k], float(lim)) for k, lim in cell["limits"].items()}
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())

    metrics = {}
    for m in spec.per_layer if traced else spec.end_to_end:
        value = spec.module("metrics", m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info(dev, spec.chips, mem_peak)}
    if view.trace is not None:
        result["device"]["busy_s"] = view.trace.busy_us() * 1e-6
        result["device"]["window_s"] = view.trace.window_us * 1e-6
        result["breakdown"] = view.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, view


def _profiled(loop: FrameLoop, keep: Reservoir, frames: int, dev):
    """Run ``frames`` frames under ``torch.profiler``, each frame and its
    parts in the benchmark's spans; their trace view."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(frames):
            keep.offer(loop.frame(record=False, annotate=True))
    return trace.TraceView(trace.normalize(prof, frames))


def device_info(dev, chips: int, mem_peak: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(mem_peak)}


def summary(result: dict, view: RunView) -> str:
    """The run's line before the result: frames and frame times."""
    fs = sorted(view.frame_s)
    med = statistics.median(fs)
    if view.trace is not None:
        t = view.trace
        return (f"{view.spec.name}: {view.frames} unprofiled frames in "
                f"{view.window_s:.4f} s (frame ms median {med * 1e3:.4f}), "
                f"then {t.frames} profiled (frame ms mean "
                f"{t.window_us * 1e-3 / t.frames:.4f}, busy "
                f"{t.busy_us() * 1e-3 / t.frames:.4f}): the profiler's "
                f"overhead is the gap of the two frame times; set-up "
                f"{view.setup_s:.4f} s")
    slow = [f"{i}: {t * 1e3:.1f}" for i, t in enumerate(view.frame_s)
            if t > 3 * med]
    return (f"{view.spec.name}: {view.frames} frames in "
            f"{view.window_s:.4f} s; frame ms median {med * 1e3:.4f}, p95 "
            f"{float(np.percentile(fs, 95)) * 1e3:.4f}, max "
            f"{fs[-1] * 1e3:.4f}; set-up {view.setup_s:.4f} s; frames over "
            f"3x the median (index: ms) {{{', '.join(slow)}}}")

