"""Wall-clock performance timers with FPS / GFlop/s derivation (port of
``murb_tpu/utils/perf.py``).

Parity rebuild of ``Perf`` (ref: src/common/utils/Perf.cpp): microsecond
wall-clock timers, ``getElapsedTime`` in ms, ``getFPS``, and the reference's
idiosyncratic GFlop/s convention -- flops / seconds / 1024^3 (binary GiB
divisor, ~7.4% below SI GFLOP/s; ref: Perf.cpp:28) -- kept so every number is
directly comparable to the reference's published tables.
"""
from __future__ import annotations

import time


class Perf:
    def __init__(self, elapsed_us: float = 0.0):
        self._elapsed_us = float(elapsed_us)
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            raise RuntimeError("Perf.stop() without start()")
        self._elapsed_us = (time.perf_counter() - self._t0) * 1.0e6
        self._t0 = None

    def reset(self) -> None:
        self._elapsed_us = 0.0
        self._t0 = None

    def __iadd__(self, other: "Perf") -> "Perf":
        self._elapsed_us += other._elapsed_us
        return self

    # ------------------------------------------------------------- derived
    def get_elapsed_time(self) -> float:
        """Elapsed milliseconds (ref: Perf::getElapsedTime)."""
        return self._elapsed_us / 1.0e3

    def get_fps(self, n_frames: int) -> float:
        if self._elapsed_us <= 0.0:
            return 0.0
        return n_frames / (self._elapsed_us / 1.0e6)

    def get_gflops(self, flops: float) -> float:
        """flops / elapsed-seconds / 1024^3 (ref: Perf.cpp:28)."""
        if self._elapsed_us <= 0.0:
            return 0.0
        return flops / (self._elapsed_us / 1.0e6) / float(1024**3)

    def get_mem_bandwidth_gbs(self, bytes_moved: float) -> float:
        """bytes / elapsed-seconds / 1024^3, GFlop/s' binary divisor."""
        if self._elapsed_us <= 0.0:
            return 0.0
        return bytes_moved / (self._elapsed_us / 1.0e6) / float(1024**3)
