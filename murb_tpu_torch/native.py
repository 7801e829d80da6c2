"""ctypes bindings for the port's native runtime library
(``murb_tpu_torch/native/murbnative.cpp``): the ``.tab`` parser, the metrics
CSV writer, a microsecond clock and the trajectory writer (io.py).

Port of ``murb_tpu/native.py``.  ``get_lib`` builds the library with g++
at first use into ``build/murb_tpu_torch/`` (keyed by a hash of the source
and the flags, built under a temporary name and renamed into place) and
loads it.  Every capability has a pure-python fallback: without g++, when
the build fails, or with ``MURB_NO_NATIVE=1``, ``get_lib`` returns None and
the callers take it.  This is host I/O, not a device path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

from murb_tpu_torch.ops.cuda import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "native" / "murbnative.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmurbnative_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


@functools.lru_cache(maxsize=1)
def get_lib() -> ctypes.CDLL | None:
    """The native library, built on demand; None when unavailable."""
    if os.environ.get("MURB_NO_NATIVE") == "1":
        return None
    lib_path = library_path()
    if not lib_path.exists() and not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    D = ctypes.POINTER(ctypes.c_double)
    F = ctypes.POINTER(ctypes.c_float)
    lib.murb_now_us.restype = ctypes.c_double
    lib.murb_count_tab.argtypes = [ctypes.c_char_p]
    lib.murb_count_tab.restype = ctypes.c_long
    lib.murb_parse_tab.argtypes = [ctypes.c_char_p, D, ctypes.c_long,
                                   ctypes.c_int]
    lib.murb_parse_tab.restype = ctypes.c_long
    lib.murb_write_history_csv.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                           D, D, D, D, D]
    lib.murb_write_history_csv.restype = ctypes.c_int
    lib.murb_traj_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.murb_traj_open.restype = ctypes.c_void_p
    lib.murb_traj_append.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                     F, F, F]
    lib.murb_traj_append.restype = ctypes.c_int
    lib.murb_traj_close.argtypes = [ctypes.c_void_p]
    lib.murb_traj_close.restype = ctypes.c_long
    return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def parse_tab(path: str, cols: int = 7) -> np.ndarray:
    """Whitespace table of ``cols`` float64 columns (blank lines skipped);
    ``numpy.loadtxt`` without the native library."""
    lib = get_lib()
    if lib is None:
        return np.loadtxt(path, dtype=np.float64, ndmin=2)
    n = lib.murb_count_tab(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    out = np.empty((n, cols), dtype=np.float64)
    got = lib.murb_parse_tab(path.encode(), _dptr(out), n, cols)
    if got < 0:
        if got == -1:
            raise FileNotFoundError(path)
        raise ValueError(f"{path}: malformed row {-(got + 2)} "
                         f"(expected {cols} columns)")
    return out[:got]


def write_history_csv(path: str, energies, ang, density_centers) -> bool:
    """The native metrics CSV writer; False if unavailable (the caller
    writes the same text in Python)."""
    lib = get_lib()
    if lib is None:
        return False
    e = np.ascontiguousarray(energies, dtype=np.float64)
    a = np.ascontiguousarray(ang, dtype=np.float64)
    dc = np.asarray(density_centers, dtype=np.float64)
    dcx, dcy, dcz = (np.ascontiguousarray(dc[:, k]) for k in range(3))
    rc = lib.murb_write_history_csv(path.encode(), len(e), _dptr(e), _dptr(a),
                                    _dptr(dcx), _dptr(dcy), _dptr(dcz))
    return rc == 0


def now_us() -> float:
    """Wall clock in microseconds."""
    lib = get_lib()
    if lib is None:
        return time.time() * 1e6
    return lib.murb_now_us()
