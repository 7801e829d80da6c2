"""Helpers of the benchmark's own tests (run them with ``python -m pytest
nbody_bench/tests`` from the repository's root).  Tests that need the card
take the ``card`` fixture and carry the repository's ``cuda`` marker."""
from __future__ import annotations

import time

import pytest

from nbody_bench import harness

#: bodies of the CPU runs: the port's plain versions at a test's size
N_CPU = 2048


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


def cpu_overrides(spec: harness.Spec, overrides: dict | None = None) -> dict:
    """The cell's keys for a CPU run: windows of single frames and at most
    10 traced span frames (a frame of the adaptive solver takes about 0.4 s
    here), then ``overrides``."""
    return {"period_frames": 1,
            "span_frames": min(int(spec.cell["span_frames"]), 10),
            **(overrides or {})}


def cpu_run(cell: str, seed: int = 5, *, traced: bool = False,
            seconds: float = 0.3, overrides: dict | None = None,
            hook=None, root=harness.ROOT, n: int = N_CPU):
    """One run of ``cell`` on the CPU at ``n`` bodies: (result, view)."""
    spec = harness.Spec(cell, root)
    return harness.run_cell(spec, seed, seconds, traced, "cpu",
                            time.perf_counter(), n=n,
                            overrides=cpu_overrides(spec, overrides),
                            engine_hook=hook)
