"""Build and load the hand-written CUDA kernels (``murb_tpu_torch/csrc``).

The kernels are plain CUDA C++ for Hopper (``sm_90a``) with a C interface.
At first use ``build_kernels`` compiles every ``csrc/*.cu`` with ``nvcc``
(in parallel, one process per source) and links one shared library under
``build/murb_tpu_torch/`` at the repository
root, keyed by a hash of the sources and the flags, and loads it with
``ctypes``.  The library is built into a temporary name and renamed into
place, so concurrent processes never load a half-written file.

There is no fallback: a missing ``nvcc``, a failed build or a refused
launch raises.  The kernel wrappers (ops/tile.py, ops/hybrid.py,
ops/mxu.py, ops/proxy_kernels.py, ops/fmm_kernels.py, ops/p2p_kernels.py,
ops/anterp_kernels.py, ops/ring.py) call ``library()`` only for CUDA
tensors.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "murb_tpu_torch"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

# C entry points (csrc/*.cu) and their argument types; each returns the
# cudaError_t of its launches.
_SIGNATURES = {
    "murb_tile_rect": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _I,
                       _P, _P, _P, _P],
    "murb_hybrid_rect": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _I, _I,
                         _P, _P, _P, _P],
    "murb_mxu_rect": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                      _P],
    "murb_p2m": [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _P],
    "murb_l2p": [_P, _P, _P, _I, _P, _I, _P, _I, _P, _P],
    "murb_phi_rows_rect": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _F,
                           _P, _P],
    "murb_acc_phi_rows": [_P, _P, _P, _P, _I, _P, _I, _F, _P, _P, _P, _P,
                          _P],
    "murb_p2m_grid": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P,
                      _P],
    "murb_l2p_grid": [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _P, _I,
                      _P, _P],
    "murb_m2l_level": [_P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P],
    "murb_p2p_sorted": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _L, _F, _I,
                        _P, _P],
    "murb_p2m_window": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                        _P, _P, _P],
    "murb_l2p_window": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I,
                        _P, _I, _P, _P],
    # host arrays of D pointers (qx, qy, qz, bufs, ax, ay, az), D device
    # ids, D origin, compute and copy streams
    "murb_ring_pipelined": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _F, _I, _I, _L],
}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
        "murb_tpu_torch CUDA kernels are built from source at first use "
        "and need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmurb_kernels_{h.hexdigest()[:16]}.so"


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source, all started together, then one link.
    Returns the library path; the compiler's report (registers, shared
    memory, spills per kernel) is kept beside it as ``<lib>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(obj),
               str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
            *(str(o) for o in objs)]
    report, failed = [], None
    for cmd, proc in procs:
        report.append(proc.communicate()[0])
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, report[-1])
    if failed is None:
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        report.append(proc.stdout)
        if proc.returncode != 0:
            failed = (link, proc.returncode, proc.stdout)
    lib.with_suffix(".log").write_text("".join(report))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed is not None:
        tmp.unlink(missing_ok=True)
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                           f"{out[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build_kernels()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call C entry ``name`` and raise if it reports a CUDA error (a launch
    that is refused never runs, and no later synchronise reports it)."""
    status = getattr(library(), name)(*args)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def stream(device: torch.device) -> int:
    """The current PyTorch stream on ``device``, as a pointer for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream


def kernel_inputs(tag: str, device: torch.device, n: int, *tensors,
                  notify) -> list[torch.Tensor]:
    """Checked float32 contiguous copies (or views) of 1-D kernel inputs.

    Every tensor must lie on ``device`` with shape ``(n,)``.  float32 is
    taken as it is; float64 state is cast here, at the wrapper, and
    announced once through ``notify(tag, dtype)`` (the kernels compute in
    fp32); any other dtype raises."""
    out = []
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{tag}: tensor on {t.device}, expected {device}")
        if t.shape != (n,):
            raise ValueError(f"{tag}: shape {tuple(t.shape)}, expected ({n},)")
        if t.dtype == torch.float64:
            notify(tag, t.dtype)
            t = t.to(torch.float32)
        elif t.dtype != torch.float32:
            raise TypeError(f"{tag}: dtype {t.dtype} (float32 or float64)")
        out.append(t.contiguous())
    return out


def int_inputs(tag: str, device: torch.device, n: int,
               *tensors) -> list[torch.Tensor]:
    """Checked int32 contiguous copies (or views) of 1-D integer kernel
    inputs (cell coordinates, slots) of shape ``(n,)`` on ``device``."""
    out = []
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{tag}: tensor on {t.device}, expected {device}")
        if t.shape != (n,):
            raise ValueError(f"{tag}: shape {tuple(t.shape)}, expected ({n},)")
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{tag}: dtype {t.dtype} (int32 or int64)")
        out.append(t.to(torch.int32).contiguous())
    return out


#: the block sizes K3, K4 and K13 are compiled for (csrc/sweep.cuh): each
#: of block_i (targets per block) and block_j (sources per staged tile)
SWEEP_BLOCKS = (64, 128, 256, 512)


def check_blocks(tag: str, block_i: int, block_j: int) -> None:
    """Refuse a block geometry the sweeps are not compiled for: 0 (the
    kernel's default) or one of ``SWEEP_BLOCKS`` each, never rounded."""
    for name, b in (("block_i", block_i), ("block_j", block_j)):
        if b != 0 and b not in SWEEP_BLOCKS:
            raise ValueError(f"{tag}: {name}={b} is not supported (0 or one "
                             f"of {SWEEP_BLOCKS})")


def require_cuda(tag: str, t: torch.Tensor) -> None:
    """Wrappers take their plain version only for CPU tensors; anything
    that is neither CPU nor CUDA is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{tag}: tensors on {t.device} (cpu or cuda)")
