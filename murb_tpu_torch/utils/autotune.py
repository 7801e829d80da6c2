"""Block-geometry autotuning with a persistent cache.

Port of ``murb_tpu/utils/autotune.py``.  The reference dispatches launch
geometry by N with hand-derived thresholds (thread count 256/512/1024 by
body count, ref: src/murb/implem/SimulationNBodyCUDATile.cu:40-52).  Here
the geometry of the exact sweeps (K3, K4, K13) is *measured*: on first use
of a (kernel, npad, device) combination the engine times each (block_i,
block_j) pair the kernel is compiled for over a few steps, after warm-up,
and persists the winner as JSON, so later runs pick the tuned blocks with
no hand-set constants.

Enable with ``MURB_AUTOTUNE=1`` (or ``autotune=True`` on the exact
engines, ``--autotune`` on the CLI); the cache file is
``$MURB_TUNE_CACHE`` or ``build/murb_tpu_torch/autotune.json``.  A key
(``torch/{kernel}/n{npad}/{device}``) carries the device's name
(``torch.cuda.get_device_name``, or ``cpu``), so a cache never hands one
card's geometry to another, and the ``torch/`` prefix keeps it apart from
``murb_tpu``'s entries in a shared cache.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

from murb_tpu_torch.ops.cuda import BUILD_DIR, SWEEP_BLOCKS


def _cache_path() -> str:
    return os.environ.get("MURB_TUNE_CACHE") or str(BUILD_DIR
                                                     / "autotune.json")


def _load() -> dict:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save(db: dict) -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(db, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only filesystem: tuning still applies in-process


#: prefix of every key: ``murb_tpu`` reads the same ``$MURB_TUNE_CACHE``
#: with keys ``{kernel}/n{npad}/{backend}`` and tunes blocks the port's
#: sweeps are not compiled for, so the two packages keep apart entries
KEY_PREFIX = "torch/"


def _key(kernel: str, npad: int, device) -> str:
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return f"{KEY_PREFIX}{kernel}/n{npad}/{name}"


def lookup(kernel: str, npad: int, *, device="cuda") -> dict | None:
    """Tuned parameters for this combination, or None."""
    return _load().get(_key(kernel, npad, device))


def store(kernel: str, npad: int, params: dict, ms: float, *,
          device="cuda") -> None:
    db = _load()
    db[_key(kernel, npad, device)] = {**params, "ms_per_step": round(ms, 4)}
    _save(db)


def enabled() -> bool:
    return os.environ.get("MURB_AUTOTUNE", "") not in ("", "0")


def block_candidates(kernel: str, npad: int) -> list[dict]:
    """The (block_i, block_j) pairs an exact sweep is compiled for
    (ops/cuda.SWEEP_BLOCKS), each no larger than ``npad``: the kernels mask
    ragged edges, so no pair needs to divide it."""
    fit = [b for b in SWEEP_BLOCKS if b <= npad]
    return ([{"block_i": bi, "block_j": bj} for bi in fit for bj in fit]
            or [{"block_i": 0, "block_j": 0}])  # fall back to kernel picks


def measure_steps(run_fn, state0, *, steps: int = 4,
                  warmup: int = 2) -> float:
    """ms/step of ``run_fn(state, n) -> state``, timed after ``warmup``
    steps: with CUDA events on a card, on the host clock on the CPU."""
    state = run_fn(state0, warmup)
    if state.device.type != "cuda":
        t0 = time.perf_counter()
        run_fn(state, steps)
        return (time.perf_counter() - t0) / steps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run_fn(state, steps)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def tune(kernel: str, npad: int, make_run_fn, state0, *,
         candidates: list[dict] | None = None, steps: int = 4,
         device="cuda") -> dict:
    """Sweep the candidates, persist and return the winner.

    ``make_run_fn(params) -> (state, n) -> state`` builds the timed loop
    for one parameter set; ``state0`` is copied for each candidate (the
    physics of the tuning steps is irrelevant, only their time).  A
    candidate the kernel refuses is skipped with a note.  A fresh sweep's
    result also carries ``sweep``: each candidate with its ms/step (None
    when refused)."""
    cached = lookup(kernel, npad, device=device)
    if cached is not None:
        return cached
    candidates = candidates or block_candidates(kernel, npad)
    best, best_ms, sweep = None, float("inf"), []
    for params in candidates:
        fresh = state0.clone() if state0 is not None else None
        try:
            ms = measure_steps(make_run_fn(params), fresh, steps=steps)
        except (ValueError, RuntimeError) as e:
            print(f"[murb-tpu-torch] autotune {kernel}: skipped {params} "
                  f"({e})", file=sys.stderr)
            sweep.append((params, None))
            continue
        sweep.append((params, ms))
        if ms < best_ms:
            best, best_ms = params, ms
    if best is None:
        best, best_ms = {"block_i": 0, "block_j": 0}, 0.0
    store(kernel, npad, best, best_ms, device=device)
    return {**best, "ms_per_step": best_ms, "sweep": sweep}
