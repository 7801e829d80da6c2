"""Build and load the hand-written CUDA kernels (``murb_tpu_torch/csrc``).

The kernels are plain CUDA C++ for Hopper (``sm_90a``) with a C interface.
At first use ``build_kernels`` compiles every ``csrc/*.cu`` with ``nvcc``
(in parallel, one process per source) and links one shared library under
``build/murb_tpu_torch/`` at the repository
root, keyed by a hash of the sources and the flags, and loads it with
``ctypes``.  The library is built into a temporary name and renamed into
place, so concurrent processes never load a half-written file.

Every kernel that reads body arrays (K1-K6, K8-K14) also has a bf16
instance (the ``*_bf16`` entries), which reads a bf16 state's arrays as
they are; K7 reads fp32 fields only, and ``kernel_inputs`` upcasts bf16
exactly where a call mixes bf16 with float32 inputs.  There is no
fallback: a missing ``nvcc``, a failed build or a refused launch
raises.  The kernel wrappers
(ops/tile.py, ops/hybrid.py, ops/mxu.py, ops/proxy_kernels.py,
ops/fmm_kernels.py, ops/p2p_kernels.py, ops/anterp_kernels.py,
ops/ring.py) call ``library()`` only for CUDA tensors.
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

from murb_tpu_torch.utils import trace

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
                       _I, _I, _P, _P, _P, _P, _P],
    "murb_tile_resident": [_I, _I, _P],
    # the bf16 instances of K3, K4, K1, K2, K8 and K9: the same arguments,
    # the body arrays bf16
    "murb_tile_rect_bf16": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _I,
                            _I, _I, _P, _P, _P, _P, _P],
    "murb_tile_resident_bf16": [_I, _I, _P],
    "murb_hybrid_rect_bf16": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _I,
                              _I, _I, _I, _P, _P, _P, _P, _P],
    "murb_hybrid_resident_bf16": [_I, _I, _P],
    "murb_p2m_bf16": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P,
                      _P, _P],
    "murb_l2p_bf16": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _P, _P],
    "murb_p2m_grid_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I,
                           _P, _P, _P, _P],
    "murb_l2p_grid_bf16": [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _P,
                           _P, _I, _P, _P],
    "murb_hybrid_rect": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _I, _I,
                         _I, _I, _P, _P, _P, _P, _P],
    "murb_hybrid_resident": [_I, _I, _P],
    # K4's passes 1 (csrc/hybrid_fast.cu) and its bf16 instance
    "murb_hybrid_fast": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _F, _I, _I,
                         _I, _I, _P, _P, _P, _P, _P, _P],
    "murb_hybrid_fast_bf16": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _F, _I,
                              _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "murb_hybrid_fast_resident": [_I, _I, _P],
    "murb_hybrid_fast_resident_bf16": [_I, _I, _P],
    # K13 and its bf16 instance: the bodies, the centre (found or given)
    "murb_mxu_rect": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _P, _I, _I,
                      _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "murb_mxu_rect_bf16": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _P,
                           _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "murb_mxu_resident": [_I, _I, _P],
    "murb_mxu_resident_bf16": [_I, _I, _P],
    "murb_p2m": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P,
                 _P],
    "murb_l2p": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _P, _P],
    "murb_proxy_resident": [_I, _I, _I, _P, _P],
    "murb_phi_rows_rect": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _F,
                           _I, _I, _I, _I, _P, _P, _P],
    "murb_acc_phi_rows": [_P, _P, _P, _P, _I, _P, _I, _F, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P],
    "murb_phi_resident": [_I, _I, _I, _I, _P],
    # the bf16 instances of K5 and K6 (the default geometry only): the same
    # arguments, the body arrays bf16, the weight rows float32
    "murb_phi_rows_rect_bf16": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _F,
                                _I, _I, _I, _I, _P, _P, _P],
    "murb_acc_phi_rows_bf16": [_P, _P, _P, _P, _I, _P, _I, _F, _I, _I, _I,
                               _I, _P, _P, _P, _P, _P, _P],
    "murb_phi_resident_bf16": [_I, _I, _I, _I, _P],
    "murb_p2m_grid": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P,
                      _P, _P, _P],
    "murb_l2p_grid": [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _P, _P,
                      _I, _P, _P],
    "murb_m2l_level": [_P, _P, _F, _I, _I, _I, _P, _P, _I, _I, _P, _P,
                       _P],
    "murb_m2l_resident": [_I, _P],
    "murb_m2l_level_lossy": [_P, _P, _F, _I, _I, _I, _P, _P, _I, _I, _P,
                             _P, _P],
    "murb_m2l_resident_lossy": [_I, _P],
    "murb_runs_resident": [_I, _I, _P, _P],
    "murb_p2p_sorted": [_P, _P, _P, _P, _I, _P, _P, _L, _F, _I, _P, _P],
    "murb_p2m_window": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                        _I, _P, _P, _P, _P],
    "murb_l2p_window": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I,
                        _P, _P, _I, _P, _P],
    # the bf16 instances of K10, K11 and K12: the same arguments, the body
    # arrays (K10: its packed {x, y, z, G m} rows) bf16
    "murb_p2p_sorted_bf16": [_P, _P, _P, _P, _I, _P, _P, _L, _F, _I, _P,
                             _P],
    "murb_p2m_window_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                             _I, _I, _P, _P, _P, _P],
    "murb_l2p_window_bf16": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P,
                             _I, _P, _P, _I, _P, _P],
    # host arrays of D pointers (qx, qy, qz, bufs, ax, ay, az, scratch), D
    # device ids, D origin, compute and copy streams
    "murb_ring_pipelined": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _F, _I, _I, _I, _I, _L],
    # the bf16 ring: ld (the values between two slot rows) after n
    "murb_ring_pipelined_bf16": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _F, _I, _I, _I, _I, _L],
    # the ring across processes: l, d, first, n, host arrays of l pointers
    # (qx, qy, qz, gm, ax, ay, az, scratch), l device ids, l origin,
    # compute and copy streams, l regions, the two mapped neighbour
    # regions, the call's epoch; the bf16 instance's ld after n
    "murb_ring_pipelined_ipc": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, _P, _P, _P, _L, _F, _I,
                                _I, _I, _I, _L],
    "murb_ring_pipelined_ipc_bf16": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _L, _F, _I, _I, _I, _I, _L],
    # the ring across hosts: the ring across processes' arguments with the
    # inbound stream after the copy streams, and after the epoch the
    # receiving and sending staged ends, their epoch and the sending end's
    # previous value; the bf16 instance's ld after n
    "murb_ring_pipelined_hosts": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _L, _P, _P, _L, _L, _F, _I, _I, _I, _I,
                                  _L],
    "murb_ring_pipelined_hosts_bf16": [_I, _I, _I, _I, _I, _P, _P, _P, _P,
                                       _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _P, _L, _P, _P, _L, _L, _F,
                                       _I, _I, _I, _I, _L],
    # its regions: made and exported, mapped, released; a card's UUID; a
    # staged end's pinned host region, made (and proved) and freed
    "murb_ring_ipc_alloc": [_I, _I, _I, _P, _P],
    "murb_ring_ipc_open": [_I, _P, _P],
    "murb_ring_ipc_release": [_I, _P, _I],
    "murb_ring_card_uuid": [_I, _P, _I],
    "murb_ring_stage_alloc": [_I, _L, _P],
    "murb_ring_stage_free": [_P],
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
    with trace.span("build.library"):
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


def refuse_grad(tag: str, *values) -> None:
    """Raise if autograd is recording and any tensor among ``values``
    requires grad: a kernel has no backward, so its output would carry no
    gradient (murb_tpu's Pallas kernels define no VJP either).  Non-tensors
    (a Python softening, None) are ignored."""
    if torch.is_grad_enabled() and any(
            isinstance(v, torch.Tensor) and v.requires_grad for v in values):
        raise RuntimeError(
            f"{tag}: an input requires grad, and this CUDA kernel has no "
            "backward; differentiate through murb_tpu_torch.diff's methods "
            "(naive | chunked | proxy, which runs acc_proxy(fused=False)), "
            "or call it under torch.no_grad()")


def kernel_inputs(tag: str, device: torch.device, n: int, *tensors,
                  notify, bf16: bool = False) -> list[torch.Tensor]:
    """Checked contiguous copies (or views) of 1-D kernel inputs.

    Every tensor must lie on ``device`` with shape ``(n,)`` and need no
    gradient (``refuse_grad``).  float32 is taken as it is; float64 state
    is cast to float32 here, at the wrapper, and announced once through
    ``notify(tag, dtype)`` (the kernels compute in fp32).  bfloat16 is
    taken as it is, with no copy, when ``bf16`` (the wrapper launches the
    kernel's bf16 instance, which converts each load to fp32); else it is
    upcast to float32 here, which is exact, and announced through
    ``notify`` as float64 is.  Any other dtype raises."""
    refuse_grad(tag, *tensors)
    out = []
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{tag}: tensor on {t.device}, expected {device}")
        if t.shape != (n,):
            raise ValueError(f"{tag}: shape {tuple(t.shape)}, expected ({n},)")
        if t.dtype == torch.float64 or (t.dtype == torch.bfloat16
                                        and not bf16):
            notify(tag, t.dtype)
            t = t.to(torch.float32)
        elif t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{tag}: dtype {t.dtype} (float32, float64 or "
                            "bfloat16)")
        out.append(t.contiguous())
    return out


def aligned4(*tensors) -> list[torch.Tensor]:
    """The tensors, each copied where its data does not start 4-byte
    aligned: the bf16 sweeps (K3-K6) stage two sources a 4-byte cp.async
    (csrc/tile.cuh), so a bf16 view from an odd element is copied."""
    return [t if t.data_ptr() % 4 == 0 else t.clone() for t in tensors]


def all_bf16(*tensors) -> bool:
    """Whether every tensor is bfloat16: a wrapper launches its bf16
    instance only then (a mixed call, such as the proxy's bf16 node
    coordinates with float32 weights, upcasts its bf16 inputs).  K5's and
    K6's weight rows are not body arrays and do not count: both instances
    read them float32."""
    return all(t.dtype == torch.bfloat16 for t in tensors)


def int_inputs(tag: str, device: torch.device, n: int,
               *tensors) -> list[torch.Tensor]:
    """Checked int32 contiguous copies (or views) of 1-D integer kernel
    inputs (cell coordinates, slots) of shape ``(n,)`` on ``device``."""
    refuse_grad(tag, *tensors)
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


#: the block sizes K3-K6 and K13 take (csrc/sweep.cuh, csrc/tile.cuh): each
#: of block_i (targets per block) and block_j (sources per staged tile)
SWEEP_BLOCKS = (64, 128, 256, 512)


def check_blocks(tag: str, block_i: int, block_j: int) -> None:
    """Refuse a block geometry the sweeps are not compiled for: 0 (the
    kernel's default) or one of ``SWEEP_BLOCKS`` each, never rounded."""
    for name, b in (("block_i", block_i), ("block_j", block_j)):
        if b != 0 and b not in SWEEP_BLOCKS:
            raise ValueError(f"{tag}: {name}={b} is not supported (0 or one "
                             f"of {SWEEP_BLOCKS})")


#: K3's targets a thread at block_i 128 and more (csrc/tile.cu tile_rows,
#: a constexpr); block_i 64 takes 2, so that a block keeps a warp
TILE_ROWS = 4

#: K3's default targets a block and sources a tile (csrc/tile.cu
#: kTileTargets, kTileSources)
TILE_BLOCK_I = 128
TILE_BLOCK_J = 512

#: K3 splits its j range until its blocks fill the card's resident slots
#: this many times over: timed at 200,192^2, 16384^2 and 8000^2 in four
#: geometries (scripts/torch_kernel_ab.py), the count it gives was within
#: 1% of the fastest in ten of the twelve and within 8% in the others
TILE_WAVES = 4


def tile_rows(block_i: int = 0) -> int:
    """Targets a thread of K3 at ``block_i`` (csrc/tile.cuh tile_rows)."""
    return TILE_ROWS if (block_i or TILE_BLOCK_I) >= 128 else 2


#: K5's and K6's default targets a block and sources a tile (csrc/phi.cuh
#: kPhiTargets, kPhiSources) at every row count (the timings in PERF.md)
PHI_BLOCK_I = 256
PHI_BLOCK_J = 256


def sweep_rows(block_i: int, nr: int) -> int:
    """Targets a thread of the shared sweep (csrc/tile.cuh sweep_rows) at
    ``block_i`` with ``nr`` weight rows: K3's ``tile_rows`` at every nr."""
    return tile_rows(block_i)


def weight_stride(nr: int) -> int:
    """Floats of a staged source's weight record (csrc/tile.cuh): ``nr``
    rounded up to 1, 2, 4 or 8 (0 for K3)."""
    return 0 if nr <= 0 else next(w for w in (1, 2, 4, 8) if w >= nr)


def staged_bytes(nr: int) -> int:
    """Shared-memory bytes of one staged source with ``nr`` weight rows:
    the {x, y, z, G*m} float4 and its weight record."""
    return 16 + 4 * weight_stride(nr)


def tile_split(ni: int, nj: int, sm_count: int, resident: int,
               block_i: int = 0, block_j: int = 0) -> tuple[int, int]:
    """K3's j split, ``(slices, tiles_per_slice)``: slice s sweeps source
    tiles [s * tiles_per_slice, (s + 1) * tiles_per_slice) of the
    ceil(nj / block_j) tiles, every slice at least one.  ``resident``: the
    blocks of this geometry one SM holds at once (``resident``).  One
    slice once the target blocks fill the card's ``resident * sm_count``
    slots ``TILE_WAVES`` times; else as many as that takes, at most one a
    tile."""
    bi, bj = block_i or TILE_BLOCK_I, block_j or TILE_BLOCK_J
    tiles = -(-nj // bj)
    blocks = -(-ni // bi)
    want = TILE_WAVES * resident * sm_count
    if tiles <= 1 or blocks >= want:
        return 1, tiles
    per = -(-tiles // min(-(-want // blocks), tiles))
    return -(-tiles // per), per


@functools.lru_cache(maxsize=None)
def resident(entry: str, device: torch.device, block_i: int = 0,
             block_j: int = 0, *key: int) -> int:
    """Blocks of a sweep at (block_i, block_j) that one SM of ``device``
    holds at once, from its C entry ``entry`` (``murb_tile_resident``:
    K3, csrc/tile.cu; ``murb_hybrid_resident``: K4's passes 3,
    csrc/hybrid.cu; ``murb_hybrid_fast_resident``: K4's passes 1,
    csrc/hybrid_fast.cu; ``murb_phi_resident``: K5 and K6, csrc/phi.cu, whose
    ``key`` is (weight rows, force); ``murb_mxu_resident``: K13,
    csrc/mxu.cu; each ``_bf16`` name its bf16 instance's; the CUDA
    occupancy calculator)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        launch(entry, block_i, block_j, *key, ctypes.byref(blocks))
    if blocks.value < 1:
        raise RuntimeError(f"{entry} at {block_i}x{block_j} {key}: no block "
                           "fits an SM")
    return blocks.value


def field_pointers(fields) -> ctypes.Array:
    """A host array of the fields' device pointers, the L2P entries'
    ``fields`` argument (the tensors must outlive the call)."""
    return (ctypes.c_void_p * len(fields))(*(f.data_ptr() for f in fields))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_cuda(tag: str, t: torch.Tensor) -> None:
    """Wrappers take their plain version only for CPU tensors; anything
    that is neither CPU nor CUDA is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{tag}: tensors on {t.device} (cpu or cuda)")
