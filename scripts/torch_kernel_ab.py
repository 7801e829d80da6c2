"""K3's, K5's, K6's and K13's block geometries on one card; optionally
kernels against another source tree's builds of them.

    python scripts/torch_kernel_ab.py [--parent DIR] [--proxy]

Without ``--parent`` (this checkout only):

  - for K3 at 128, 256 and 512 targets a block (512 sources a tile) and
    at 128x128: the blocks one SM holds at once (``ops/cuda.resident``,
    the CUDA occupancy calculator), and the kernel's time at 200,192^2
    (the N=200,000 galaxy), 16384^2 (the random box) and 8000^2 (the m=20
    node sweep) at forced j-slice counts, with the count
    ``ops/cuda.tile_split`` picks marked;
  - for K5 and K6 on the merger (81,920^2, ``scripts/make_two_galaxy_tab.py``)
    at R = 1 (the total G*m row), 2 (the two galaxies, the merger's
    path) and 8 weight rows: resident blocks, the split ``tile_split``
    picks and the time at each candidate geometry and at forced slice
    counts, launches of the C entries only;
  - for K13 (the tensor-core sweep) at 200,192^2: its resident blocks, j
    slices and time through the wrapper at each tier ("high", "default")
    and a few block geometries;
  - the SASS of each K3/K5/K6 (``sweep_rows_kernel<R, NR, force>``), K10
    and K13 kernel (``cuobjdump -sass``, where the toolkit has it): its
    instructions, MUFU.RSQ, FMUL and HMMA counts, and the instructions a
    MUFU.RSQ (about the instructions a pair of the unrolled sweep; K13's
    HMMA a MUFU.RSQ is its tensor products a pair of a thread, each
    covering 4 of the thread's pairs); and the compiler's registers and
    spills of each sweep instance (the build's ``-Xptxas -v`` report).

With ``--parent DIR``, DIR the root of another tree (its C entries are
read from DIR's ``ops/cuda.py``, kernel by kernel; the script refuses a
tree that holds none of the entries below), DIR's sources of those
kernels are built into a library of their own with the flags of
ops/cuda.py, and each kernel is timed in turns (DIR, this, this, DIR) on
the same inputs:

  - first designs, where DIR's entry has the first design's signature:
    K10 (one target a thread, every body pair masked) on the 1M
    two-cluster box (murb_tpu's bench row ``adaptive_two_clusters_1m``,
    the plan ``create_engine`` picks, as chip_smoke.py phase 9 builds it),
    nf 3 and 4, whether the sums agree bit for bit, and this checkout's
    K10 also in brick order; K3 (one target a thread) at the three
    shapes; K13 (fp32 on the CUDA cores) at 200,192^2 on the galaxy's
    packed operands, this checkout at "high" and "default"; K14 (its own
    copy of the first sweep) at D = 1 to 4 shards of the 200k galaxy on
    this card; K5 and K6 (one target a thread, 128 sources a tile, no j
    split) on the merger at R = 1, 2 and 8, with the largest difference
    over max|phi| and max|a|;
  - the cell-run kernels' first design (K8, K9, K11, K12: each block
    searching its run, items of 512 and 128 bodies, the fields stacked) at
    (m, C) = (8, 4) and (6, 8) on the 200k random box, m = 18 and 32 at
    C = 2 on the 1M two-cluster box and that box's slots (``cell_run_cases``),
    k = 3 and 4: in turns by CUDA events around launches from the host and
    in a CUDA graph (``profile_step.graph_ms``), each side's largest
    difference from the float64 plain version and whether this checkout
    gives the same bits twice; K8's and K9's blocks an SM at m = 8, 18 and
    32 and the SM clock and power under their load at m = 18 and 32; the
    SASS counts (FFMA, LDS, BAR among them) and the compiler's registers
    and spills of every instance; then the wrappers through each tree's
    package in turns (``WRAPPERS_CODE``: before and after one profiler
    session, and the glue alone) and the FPS of the paths of
    ``CELL_RUN_FPS`` (``--no-fps`` skips them);
  - K1's and K2's first design (each block building the node table, K1
    a grid of 4 SMs' blocks and a reduce, K2 one body a thread) against
    the one-run design at ``PROXY_SHAPES`` (the 200k galaxy at m = 12,
    K2 at k = 3, 4, 5 and 11, and m = 20, and one 50k shard of
    ``shard+proxy``): alone in a CUDA graph and by CUDA events in turns,
    each side's largest difference from float64, this side's K1 at each
    chunk of ``PROXY_CHUNKS``, the SASS counts and the compiler's
    registers and spills of both builds' instances, the wrappers through
    each tree's package in fresh processes (``PROXY_WRAPPERS_CODE``,
    ``PROXY_WRAPPER_ROUNDS`` rounds, no profiler) and the FPS of
    ``PROXY_FPS`` in turns (``--no-fps`` skips them); ``--proxy`` runs
    this alone (without ``--parent``: this checkout's kernels alone and
    its wrappers);
  - the parent's build of an entry whose signature this checkout keeps
    (K3 at the three shapes, K14 at D = 1 and 4, K5 and K6, K7 at every
    shape of ``K7_SHAPES``, K13 at 200,192^2 at "high" and "default", K8,
    K9, K11 and K12 at ``cell_run_cases`` through this checkout's glue):
    both must give the same bits where
    the arithmetic is unchanged (K8's and K11's P2M fold splits runs of
    many items since the one-run redesign: there each side's distance
    from float64);
  - the merger's tracked steps through each tree's own package, in turns
    (subprocesses in DIR and here): ``create_engine("tpu+tracking+multi")``
    with no ``acc_fn`` (K6) and the CLI (K4 force, K5 metrics), FPS over
    49 steps after one;
  - K7 (one thread a cell pair) at every shape of ``K7_SHAPES`` and K4's
    passes 3 (one target a thread, fp64 per pair) at 16384^2, 30,208^2
    and 200,192^2, where DIR holds those first designs, and then the FPS
    of each path of ``FPS_RUNS`` through both trees' packages in
    ``FPS_ROUNDS`` rounds of turns (``--no-fps`` skips them).

Kernel times are medians of CUDA-event runs, launches only (the inputs are
packed once beforehand).  The last line is one JSON object with every
number.  Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ast
import ctypes
import functools
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from murb_tpu_torch.ops import cuda  # noqa: E402
from murb_tpu_torch.utils.profile_step import graph_ms  # noqa: E402

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_CTYPES = {"_P": _P, "_I": _I, "_L": _L, "_F": _F}
#: the C entries of the first designs, as this script calls them with
#: --parent, and each one's source
FIRST_SIGNATURES = {
    "murb_p2p_sorted": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _L, _F, _I,
                        _P, _P],
    "murb_tile_rect": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _I, _P,
                       _P, _P, _P],
    "murb_mxu_rect": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                      _P],
    "murb_ring_pipelined": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _F, _I, _I, _L],
    "murb_phi_rows_rect": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _F, _P,
                           _P],
    "murb_acc_phi_rows": [_P, _P, _P, _P, _I, _P, _I, _F, _P, _P, _P, _P,
                          _P],
    # K7's first design: the offset subset and a split count, no plan
    "murb_m2l_level": [_P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P],
    # the cell-run kernels' first design (K8, K9, K11, K12): a prefix of
    # items each block searched, the fields stacked
    "murb_p2m_grid": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P,
                      _P],
    "murb_l2p_grid": [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _P, _I,
                      _P, _P],
    "murb_p2m_window": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                        _P, _P, _P],
    "murb_l2p_window": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I,
                        _P, _I, _P, _P],
    # K1's and K2's first design (csrc/proxy.cu): each block built the node
    # table, K1 a grid of 4 SMs' blocks and a reduce, K2's fields stacked
    "murb_p2m": [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _P],
    "murb_l2p": [_P, _P, _P, _I, _P, _I, _P, _I, _P, _P],
}
#: the cell-run kernels' entries (one comparison covers all four)
CELL_RUN_ENTRIES = ("murb_p2m_grid", "murb_l2p_grid", "murb_p2m_window",
                    "murb_l2p_window")
#: each entry's sources (ring.cu launches tile.cu's sweep)
SOURCES = {"murb_p2p_sorted": ["p2p.cu"], "murb_tile_rect": ["tile.cu"],
           "murb_mxu_rect": ["mxu.cu"],
           "murb_ring_pipelined": ["ring.cu", "tile.cu"],
           "murb_phi_rows_rect": ["phi.cu", "phi_rows.cu"],
           "murb_acc_phi_rows": ["phi.cu", "phi_rows.cu"],
           "murb_m2l_level": ["fmm.cu"],
           "murb_hybrid_rect": ["hybrid.cu", "tile.cu"],
           "murb_p2m_grid": ["fmm.cu"], "murb_l2p_grid": ["fmm.cu"],
           "murb_p2m_window": ["anterp.cu"], "murb_l2p_window": ["anterp.cu"],
           "murb_p2m": ["proxy.cu"], "murb_l2p": ["proxy.cu"]}
#: entries compared with the parent's build when their signatures match
#: this checkout's (their arithmetic is meant to be unchanged)
SAME_ENTRIES = ("murb_tile_rect", "murb_ring_pipelined",
                "murb_phi_rows_rect", "murb_acc_phi_rows", "murb_m2l_level",
                "murb_mxu_rect", *CELL_RUN_ENTRIES)
OUT = cuda.BUILD_DIR / "kernel_ab"
SOFT = 2.0e8
SOFT2 = ctypes.c_float(SOFT ** 2)
ROOT = Path(__file__).resolve().parents[1]


def tree_signatures(root: Path) -> dict:
    """``_SIGNATURES`` of the tree at ``root`` (its ops/cuda.py, read as
    source, not imported)."""
    tree = ast.parse((root / "murb_tpu_torch" / "ops" / "cuda.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", "") == "_SIGNATURES"):
            return {k.value: [_CTYPES[e.id] for e in v.elts]
                    for k, v in zip(node.value.keys, node.value.values)}
    raise ValueError(f"{root}: no _SIGNATURES in murb_tpu_torch/ops/cuda.py")


def build_many(specs) -> list[Path]:
    """One shared library for each (name, csrc, sources) of ``specs``: one
    nvcc a source, all of them started together; each library's compiler
    report (-Xptxas -v) beside it as ``<lib>.log``."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda.find_nvcc()
    jobs = []
    for name, csrc, sources in specs:
        for src in sources:
            obj = OUT / f"{name}.{Path(src).stem}.o"
            jobs.append((name, src, obj, subprocess.Popen(
                [nvcc, *cuda.NVCC_FLAGS, "-c", "-I", str(csrc), "-o",
                 str(obj), str(csrc / src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    reports = {name: [] for name, _, _ in specs}
    for name, src, _, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} {src} failed:\n{out[-4000:]}")
        reports[name].append(out)
    libs = []
    for name, _, _ in specs:
        lib = OUT / f"lib{name}.so"
        subprocess.run([nvcc, "-shared", *cuda.NVCC_FLAGS[:2], "-o",
                        str(lib), *(str(o) for n, _, o, _ in jobs
                                    if n == name)],
                       check=True, capture_output=True)
        lib.with_suffix(".log").write_text("".join(reports[name]))
        libs.append(lib)
    return libs


def build(name: str, csrc: Path, sources: list[str]) -> Path:
    """One shared library from ``sources`` of ``csrc`` (``build_many``)."""
    return build_many([(name, csrc, sources)])[0]


def load(lib: Path, signatures: dict) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in signatures.items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = ctypes.c_int
    return dll


def call(dll, fn: str, *args) -> None:
    status = getattr(dll, fn)(*args)
    if status != 0:
        raise RuntimeError(f"{fn}: CUDA error {status} at launch")


def time_ms(fn, reps: int = 5, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def in_turns(old, new, **kw) -> dict:
    """Times in turns, old, new, new, old: each side's two readings."""
    t = [time_ms(f, **kw) for f in (old, new, new, old)]
    return {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]]}


def sass_counts(lib: Path, pattern: str) -> dict:
    """{kernel: {instructions, MUFU.RSQ, instructions a MUFU.RSQ, FFMA,
    FMUL, FADD, LDS, HMMA, BAR, DFMA, DADD, F2F, HMMA a MUFU.RSQ}} of the
    kernels in ``lib``
    whose name matches ``pattern`` (cuobjdump)."""
    tool = shutil.which("cuobjdump") or str(
        Path(cuda.find_nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists() and not shutil.which(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if not re.search(pattern, name):
            continue
        ops = Counter(m.group(1).split(".")[0] if not m.group(1).startswith(
            "MUFU") else m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                block))
        total, rsq = sum(ops.values()), ops.get("MUFU.RSQ", 0)
        out[name] = {"instructions": total, "MUFU.RSQ": rsq,
                     "per_rsq": total / rsq if rsq else None,
                     "FFMA": ops.get("FFMA", 0), "FMUL": ops.get("FMUL", 0),
                     "FADD": ops.get("FADD", 0), "LDS": ops.get("LDS", 0),
                     "HMMA": ops.get("HMMA", 0), "BAR": ops.get("BAR", 0),
                     "DFMA": ops.get("DFMA", 0),
                     "DADD": ops.get("DADD", 0), "F2F": ops.get("F2F", 0),
                     "HMMA_per_rsq": ops.get("HMMA", 0) / rsq if rsq
                     else None}
    return out


def sweep_label(name: str) -> str:
    """``sweep BI=<targets a block> BJ=<sources a tile> NR=<rows>
    force|no force[ ext]`` for a mangled sweep_rows_kernel<BI, BJ, NR,
    kForce[, kExt]> name (ext: K4's passes 3), ``p2m_runs MW=<w> <Runs>``
    or ``l2p_runs ...`` for a cell-run kernel, ``l2p_one_run MW=<w>
    TB=<bodies a thread>`` for K2, else the name."""
    r = re.search(r"(p2m_runs|l2p_runs)_kernelILi(\d+)ENS_(\d+)(\w+)", name)
    if r:
        return f"{r.group(1)} MW={r.group(2)} {r.group(4)[:int(r.group(3))]}"
    r = re.search(r"l2p_one_run_kernelILi(\d+)ELi(\d+)E", name)
    if r:
        return f"l2p_one_run MW={r.group(1)} TB={r.group(2)}"
    m = re.search(r"sweep_rows_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])"
                  r"(?:ELb([01]))?", name)
    if not m:
        return name
    bj = m.group(2) if m.group(2) != "0" else "run-time"
    return (f"sweep BI={m.group(1)} BJ={bj} NR={m.group(3)} "
            f"{'force' if m.group(4) == '1' else 'no force'}"
            + (" ext" if m.group(5) == "1" else ""))


def ptxas_report(lib: Path, pattern: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads}} of the
    kernels whose name matches ``pattern``, from the build's -Xptxas -v
    report beside ``lib``."""
    log = lib.with_suffix(".log")
    out, name = {}, None
    if not log.exists():
        return out
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(sweep_label(name), {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(sweep_label(name), {}).update(
                registers=int(m.group(1)))
    return out


def merger_tab() -> Path:
    """The merger's .tab (scripts/make_two_galaxy_tab.py), written once
    into the build directory."""
    tab = OUT / "milkyway_andromeda.tab"
    if not tab.exists():
        OUT.mkdir(parents=True, exist_ok=True)
        subprocess.run([sys.executable, str(ROOT / "scripts" /
                                             "make_two_galaxy_tab.py"),
                        str(tab)], check=True, capture_output=True)
    return tab


def merger_rows(masks, gm, nr: int, seed: int = 123):
    """K5's and K6's weight rows on the merger: R = 1 the total G*m row (the
    exact tpu+tracking row), R = 2 the two galaxies (the merger's own),
    R = 8 the two galaxies, the total and 5 random 0/1 masks (seeded)."""
    if nr == 1:
        return gm[None, :].contiguous()
    rows = [masks[0] * gm, masks[1] * gm]
    if nr > 2:
        gen = torch.Generator(device=gm.device).manual_seed(seed)
        rows.append(gm)
        rows += [(torch.rand(gm.shape, generator=gen, device=gm.device)
                  < 0.5).float() * gm for _ in range(nr - 3)]
    return torch.stack(rows[:nr]).contiguous()


def merger_case(dev):
    """The merger's positions, G*m and galaxy masks, fp32 on ``dev``."""
    from murb_tpu_torch import G
    from murb_tpu_torch.core.init import (init_milkyway_andromeda,
                                          milkyway_andromeda_masks)

    mg = init_milkyway_andromeda(str(merger_tab()), device=dev)
    q = [v.float().contiguous() for v in (mg.qx, mg.qy, mg.qz)]
    gm = (mg.m * G).float().contiguous()
    masks = [torch.as_tensor(m, device=dev)
             for m in milkyway_andromeda_masks(mg.npad, mg.n)]
    return q, gm, masks


def phi_call(dll, force: bool, q, gm, rows, out, bi=0, bj=0, split=None):
    """One launch of this checkout's K6 (force) or K5 entry at (bi, bj) and
    ``split`` = (slices, tiles_per_slice, scratch) (None: one slice)."""
    n, nr = q[0].shape[0], rows.shape[0]
    slices, per, scratch = split or (1, -(-n // (bj or cuda.PHI_BLOCK_J)),
                                     None)
    sp = None if scratch is None else scratch.data_ptr()
    ptrs = [v.data_ptr() for v in q]
    if force:
        call(dll, "murb_acc_phi_rows", *ptrs, gm.data_ptr(), n,
             rows.data_ptr(), nr, SOFT2, bi, bj, slices, per, sp,
             out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
             out[3:].data_ptr(), cuda.stream(q[0].device))
    else:
        call(dll, "murb_phi_rows_rect", *ptrs, n, *ptrs, n, rows.data_ptr(),
             nr, SOFT2, bi, bj, slices, per, sp, out.data_ptr(),
             cuda.stream(q[0].device))


def phi_split(n: int, nr: int, force: bool, bi: int, bj: int, dev,
              want: int | None = None):
    """(slices, tiles_per_slice, scratch) of K5/K6 at (bi, bj): the count
    tile_split picks, or ``want`` slices of whole tiles."""
    tiles = -(-n // bj)
    if want is None:
        slices, per = cuda.tile_split(
            n, n, cuda.sm_count(dev),
            cuda.resident("murb_phi_resident", dev, bi, bj, nr, int(force)),
            bi, bj)
    else:
        per = -(-tiles // min(want, tiles))
        slices = -(-tiles // per)
    scratch = (torch.empty((slices, (3 if force else 0) + nr, n),
                           dtype=torch.float32, device=dev)
               if slices > 1 else None)
    return slices, per, scratch


def run_phi_geometries(dev) -> dict:
    """K5 and K6 on the merger at R = 1, 2, 8: resident blocks, the picked
    split and the time at each candidate geometry and slice count."""
    q, gm, masks = merger_case(dev)
    n = q[0].shape[0]
    res = {"n": n}
    geoms = ((128, 512), (128, 256), (128, 128), (256, 512), (256, 256),
             (256, 128), (512, 256), (64, 256))
    for nr in (1, 2, 8):
        rows = merger_rows(masks, gm, nr)
        for force in (True, False):
            k = "K6" if force else "K5"
            out = torch.empty(((3 if force else 0) + nr, n),
                              dtype=torch.float32, device=dev)
            for bi, bj in geoms:
                resident = cuda.resident("murb_phi_resident", dev, bi, bj, nr,
                                         int(force))
                pick = phi_split(n, nr, force, bi, bj, dev)[0]
                row = {}
                for want in sorted({1, pick // 2 or 1, pick, 2 * pick}):
                    split = phi_split(n, nr, force, bi, bj, dev, want)
                    row[split[0]] = time_ms(lambda: phi_call(
                        cuda.library(), force, q, gm, rows, out, bi, bj,
                        split))
                res[f"{k} R={nr} {bi}x{bj}"] = {
                    "resident": resident, "split_pick": pick,
                    "ms_by_slices": row}
                print(f"[{k} R={nr} {n}^2 {bi}x{bj}] resident {resident}, "
                      f"tile_split picks {pick}; ms by slices "
                      + ", ".join(f"{s}: {t:.4f}" for s, t in row.items()))
    return res


def run_phi_first(old, dev) -> dict:
    """K5's and K6's first designs (one target a thread, 128 sources a
    tile, no split) against this checkout's at its defaults (through the
    wrappers' geometry and split), on the merger, in turns."""
    from murb_tpu_torch.ops.hybrid import phi_split_args

    q, gm, masks = merger_case(dev)
    n, s = q[0].shape[0], cuda.stream(dev)
    ptrs = [v.data_ptr() for v in q]
    res = {}
    for nr in (1, 2, 8):
        rows = merger_rows(masks, gm, nr)
        for force in (True, False):
            k = "K6" if force else "K5"
            c = (3 if force else 0) + nr
            outs = [torch.empty((c, n), dtype=torch.float32, device=dev)
                    for _ in range(2)]
            (bi, bj, slices, per, _), scratch = phi_split_args(
                n, n, nr, force, 0, 0, dev)

            def f_old():
                if force:
                    o = outs[0]
                    call(old, "murb_acc_phi_rows", *ptrs, gm.data_ptr(), n,
                         rows.data_ptr(), nr, SOFT2, o[0].data_ptr(),
                         o[1].data_ptr(), o[2].data_ptr(), o[3:].data_ptr(),
                         s)
                else:
                    call(old, "murb_phi_rows_rect", *ptrs, n, *ptrs, n,
                         rows.data_ptr(), nr, SOFT2, outs[0].data_ptr(), s)

            def f_new():
                phi_call(cuda.library(), force, q, gm, rows, outs[1], bi, bj,
                         (slices, per, scratch))

            f_old()
            f_new()
            torch.cuda.synchronize()
            po, pn = (o[c - nr:] for o in outs)
            r = {"geometry": f"{bi}x{bj}", "slices": slices,
                 "phi_max_rel_diff": float((po - pn).abs().max()
                                           / po.abs().max()),
                 **in_turns(f_old, f_new)}
            if force:
                r["acc_max_rel_diff"] = float((outs[0][:3] - outs[1][:3])
                                              .abs().max()
                                              / outs[0][:3].abs().max())
            res[f"{k} R={nr}"] = r
            print(f"[{k} first vs this, R={nr}, {n}^2] this at {bi}x{bj} in "
                  f"{slices} slices; max|dphi|/max|phi| "
                  f"{r['phi_max_rel_diff']:.3e}"
                  + (f", max|da|/max|a| {r['acc_max_rel_diff']:.3e}"
                     if force else "")
                  + f"; old {r['old_ms']} ms, new {r['new_ms']} ms")
    return res


def run_k3_parent(old, dev) -> dict:
    """The parent's K3 (same C entry) against this checkout's at the three
    shapes, at the wrapper's split, in turns; the sums must agree bit for
    bit."""
    from murb_tpu_torch.ops.tile import split_args

    res = {}
    for label, q, g in k3_shapes(dev):
        ni = q[0].shape[0]
        ptrs = [v.data_ptr() for v in q]
        outs = [torch.empty((3, ni), dtype=torch.float32, device=dev)
                for _ in range(2)]
        split, scratch = split_args(ni, ni, 0, 0, dev)
        scratches = [scratch, None if scratch is None
                     else torch.empty_like(scratch)]
        s = cuda.stream(dev)

        def f(dll, k):
            sp = None if scratches[k] is None else scratches[k].data_ptr()
            call(dll, "murb_tile_rect", *ptrs, ni, *ptrs, g.data_ptr(), ni,
                 SOFT2, 0, 0, split[0], split[1], sp,
                 *(o.data_ptr() for o in outs[k]), s)

        f(old, 0)
        f(cuda.library(), 1)
        torch.cuda.synchronize()
        r = {"slices": split[0], "bit_for_bit": bool(torch.equal(*outs)),
             **in_turns(lambda: f(old, 0), lambda: f(cuda.library(), 1))}
        res[label] = r
        print(f"[K3 parent vs this, {label}] {split[0]} slices; bit for bit "
              f"{r['bit_for_bit']}; parent {r['old_ms']} ms, this "
              f"{r['new_ms']} ms")
    return res


def run_k14_parent(old, dev) -> dict:
    """The parent's K14 (same C entry) against this checkout's at D = 1
    and 4 shards of the 200k galaxy on this card, in turns; bit for bit,
    and at D = 1 against this checkout's K3."""
    from murb_tpu_torch import G
    from murb_tpu_torch.core.init import init_galaxy
    from murb_tpu_torch.ops.tile import split_args

    res = {}
    for d in (1, 4):
        st = init_galaxy(200_000, 123, device=dev).repad(256 * d)
        b = st.npad // d
        blocks = [[v[k * b:(k + 1) * b].float().contiguous()
                   for v in (st.qx, st.qy, st.qz, st.m * G)]
                  for k in range(d)]
        f_old = ring_call(old, "murb_ring_pipelined", blocks, dev, False)
        f_new = ring_call(cuda.library(), "murb_ring_pipelined", blocks,
                          dev, False)
        f_old()
        f_new()
        torch.cuda.synchronize()
        a_old, a_new = (torch.cat(f.outs, 1) for f in (f_old, f_new))
        r = {"n": st.npad, "bit_for_bit": bool(torch.equal(a_old, a_new)),
             **in_turns(f_old, f_new, reps=3, runs=3)}
        if d == 1:
            q = blocks[0]
            split, scratch = split_args(b, b, 0, 0, dev)
            a3 = torch.empty((3, b), dtype=torch.float32, device=dev)
            call(cuda.library(), "murb_tile_rect",
                 *(v.data_ptr() for v in q[:3]), b,
                 *(v.data_ptr() for v in q), b, SOFT2, 0, 0, *split,
                 *(o.data_ptr() for o in a3), cuda.stream(dev))
            torch.cuda.synchronize()
            r["bit_for_bit_k3"] = bool(torch.equal(a3, a_new))
        res[f"D={d}"] = r
        print(f"[K14 parent vs this, D={d}, N={st.npad}] bit for bit "
              f"{r['bit_for_bit']}"
              + (f" (and K3's: {r['bit_for_bit_k3']})" if d == 1 else "")
              + f"; parent {r['old_ms']} ms, this {r['new_ms']} ms")
    return res


def run_phi_parent(old, dev) -> dict:
    """The parent's K5 and K6 (same C entries) against this checkout's at
    this checkout's default geometry and split, on the merger at R = 1, 2
    and 8, in turns; the sums must agree bit for bit."""
    from murb_tpu_torch.ops.hybrid import phi_split_args

    q, gm, masks = merger_case(dev)
    n = q[0].shape[0]
    res = {}
    for nr in (1, 2, 8):
        rows = merger_rows(masks, gm, nr)
        for force in (True, False):
            k = "K6" if force else "K5"
            c = (3 if force else 0) + nr
            outs = [torch.empty((c, n), dtype=torch.float32, device=dev)
                    for _ in range(2)]
            (bi, bj, slices, per, _), scratch = phi_split_args(
                n, n, nr, force, 0, 0, dev)
            scratches = [scratch, None if scratch is None
                         else torch.empty_like(scratch)]
            f = [lambda dll=dll, k=k2: phi_call(
                dll, force, q, gm, rows, outs[k], bi, bj,
                (slices, per, scratches[k])) for k2, dll in
                enumerate((old, cuda.library()))]
            f[0]()
            f[1]()
            torch.cuda.synchronize()
            r = {"geometry": f"{bi}x{bj}", "slices": slices,
                 "bit_for_bit": bool(torch.equal(*outs)),
                 **in_turns(f[0], f[1])}
            res[f"{k} R={nr}"] = r
            print(f"[{k} parent vs this, R={nr}, {n}^2] {bi}x{bj} in "
                  f"{slices} slices; bit for bit {r['bit_for_bit']}; parent "
                  f"{r['old_ms']} ms, this {r['new_ms']} ms")
    return res


MERGER_FPS = r"""
import json, sys, time
from murb_tpu_torch import cli
from murb_tpu_torch.core.init import (init_milkyway_andromeda,
                                      milkyway_andromeda_masks)
from murb_tpu_torch.models import create_engine
tab = sys.argv[1]
mg = init_milkyway_andromeda(tab, device="cuda")
masks = milkyway_andromeda_masks(mg.npad, mg.n)
eng = create_engine("tpu+tracking+multi", mg, soft=2.0e8, dt=3600.0,
                    num_iterations=50, masks=masks)
eng.run(1)
eng.block_until_ready()
t0 = time.perf_counter()
eng.run(49)
eng.block_until_ready()
k6 = 49 / (time.perf_counter() - t0)
res = cli.run(["-n", str(mg.n), "-i", "50", "--im", "tpu+tracking+multi",
               "-s", "milkyway_andromeda", "--scheme-file", tab, "--nv",
               "--gf", "--scan", "--device", "cuda"])
assert res.rc == 0
print(json.dumps({"k6_fps": k6, "cli_k4_k5_fps": res.fps}))
"""


def merger_fps_turns(parent: Path) -> dict:
    """The merger's tracked FPS through each tree's own package, in turns
    (parent, this, this, parent), one process each."""
    tab = str(merger_tab())
    out = {"parent": [], "this": []}
    for side, root in (("parent", parent), ("this", ROOT), ("this", ROOT),
                       ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", MERGER_FPS, tab],
                              cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"merger FPS in {root} failed:\n"
                               f"{proc.stderr[-3000:]}")
        out[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"[merger FPS, {side}] {out[side][-1]}")
    return out


def k3_shapes(dev):
    """(label, positions, G*m) of K3's three shapes, all fp32 on ``dev``."""
    from murb_tpu_torch import G
    from murb_tpu_torch.core.init import init_galaxy, init_random

    gal = init_galaxy(200_000, 123, device=dev)
    rnd = init_random(16_300, 123, device=dev)
    for label, st, ni in (("200192^2 galaxy", gal, gal.npad),
                          ("16384^2 random", rnd, rnd.npad),
                          ("8000^2 random", rnd, 8000)):
        q = [v[:ni].float().contiguous() for v in (st.qx, st.qy, st.qz)]
        yield label, q, (st.m[:ni] * G).float().contiguous()


def run_geometries(dev) -> dict:
    """K3's residency and forced j splits at each block geometry."""
    sms = cuda.sm_count(dev)
    geoms = ((128, 512), (256, 512), (512, 512), (128, 128))
    res = {"resident": {f"{bi}x{bj}": cuda.resident("murb_tile_resident",
                                                     dev, bi, bj)
                        for bi, bj in geoms}}
    print(f"[K3 resident blocks an SM, {sms} SMs] {res['resident']}")
    counts = {"200192^2 galaxy": (1, 2, 3, 4, 5, 6, 8, 10),
              "16384^2 random": (2, 4, 8, 16, 32),
              "8000^2 random": (2, 4, 8, 16)}
    for label, q, g in k3_shapes(dev):
        ni = q[0].shape[0]
        out = torch.empty((3, ni), dtype=torch.float32, device=dev)
        shape = {}
        for bi, bj in geoms:
            tiles = -(-ni // bj)
            pick = cuda.tile_split(ni, ni, sms, res["resident"][f"{bi}x{bj}"],
                                   bi, bj)[0]
            row = {}
            for want in sorted(set(counts[label]) | {pick}):
                per = -(-tiles // min(want, tiles))
                slices = -(-tiles // per)
                scratch = torch.empty((slices, 3, ni), dtype=torch.float32,
                                      device=dev)
                row[slices] = time_ms(lambda: call(
                    cuda.library(), "murb_tile_rect",
                    *(v.data_ptr() for v in q), ni,
                    *(v.data_ptr() for v in q), g.data_ptr(), ni, SOFT2, bi,
                    bj, slices, per,
                    scratch.data_ptr() if slices > 1 else None,
                    *(o.data_ptr() for o in out), cuda.stream(dev)))
            shape[f"{bi}x{bj}"] = {"split_pick": pick, "ms_by_slices": row}
            print(f"[K3 {label} {bi}x{bj}] blocks {-(-ni // bi)}, "
                  f"tile_split picks {pick}; ms by slices "
                  + ", ".join(f"{s}: {t:.4f}" for s, t in row.items()))
        res[label] = shape
    return res


def k10_case(dev):
    """The 1M two-cluster box's sorted bodies and K10's inputs under the
    plan the auto policy picks (chip_smoke.py phase 9's preamble)."""
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.ops import p2p as pp
    from murb_tpu_torch.ops import p2p_kernels as pk
    from murb_tpu_torch.ops import sparse_fmm as sf
    from murb_tpu_torch.ops.fmm import _heavy_setup
    from murb_tpu_torch.utils.profile_step import (TWO_CLUSTERS_DT,
                                                   TWO_CLUSTERS_SOFT,
                                                   two_clusters)

    st = two_clusters(device=dev)
    eng = create_engine("tpu+proxy", st, soft=TWO_CLUSTERS_SOFT,
                        dt=TWO_CLUSTERS_DT)
    plan = eng._plan
    q = (st.qx, st.qy, st.qz)
    c, h, *_rest, ge = _heavy_setup(*q, eng._gm(st), 1, sf.HEAVY_FACTOR)
    h = h.max().expand(3)
    key, ci = pp.sorted_cells(*q, ge > 0, c, h, 2 ** plan.levels)
    _, perm = torch.sort(key, stable=True)
    xs = [v[perm].float().contiguous() for v in (*q, ge)]
    ci = [v[perm].to(torch.int32).contiguous() for v in ci]
    B = st.npad // pp.DEFAULT_K
    adj = pp._adjacency(*pp._brick_boxes(ci, pp.DEFAULT_K)).contiguous()
    counts, starts, n_pairs = pk.pair_rows(adj)
    return {"xs": xs, "ci": ci, "B": B, "adj": adj, "starts": starts,
            "counts": counts, "pmax": plan.p2p_pmax,
            "soft2": float(torch.tensor(TWO_CLUSTERS_SOFT) ** 2),
            "body": torch.stack(xs, 1),
            "cell": torch.stack((*ci, torch.zeros_like(ci[0])), 1),
            "box": pk.subbrick_boxes(ci), "order": pk.launch_order(counts),
            "brick_order": torch.arange(B, dtype=torch.int32, device=dev),
            "n": st.npad, "n_pairs": int(n_pairs)}


def run_k10(old, new, dev) -> dict:
    k = k10_case(dev)
    n, s = k["n"], cuda.stream(dev)
    res = {"n": n, "pmax": k["pmax"], "n_pairs": k["n_pairs"]}
    for nf in (3, 4):
        o_old = torch.empty((nf, n), dtype=torch.float32, device=dev)
        o_new = torch.empty_like(o_old)

        def f_old():
            call(old, "murb_p2p_sorted", *(v.data_ptr() for v in k["xs"]),
                 *(v.data_ptr() for v in k["ci"]), k["B"],
                 k["adj"].data_ptr(), k["starts"].data_ptr(), k["pmax"],
                 k["soft2"], int(nf == 4), o_old.data_ptr(), s)

        def f_new(order="order", out=o_new):
            call(new, "murb_p2p_sorted", k["body"].data_ptr(),
                 k["cell"].data_ptr(), k["box"].data_ptr(),
                 k[order].data_ptr(), k["B"], k["adj"].data_ptr(),
                 k["starts"].data_ptr(), k["pmax"], k["soft2"],
                 int(nf == 4), out.data_ptr(), s)

        f_old()
        f_new()
        o_brick = torch.empty_like(o_old)
        f_new("brick_order", o_brick)
        torch.cuda.synchronize()
        r = {"bit_for_bit": bool(torch.equal(o_old, o_new)),
             "brick_order_bit_for_bit": bool(torch.equal(o_new, o_brick)),
             "max_abs_diff": float((o_old - o_new).abs().max()),
             **in_turns(f_old, f_new),
             "new_brick_order_ms": time_ms(lambda: f_new("brick_order",
                                                         o_brick))}
        res[f"nf{nf}"] = r
        print(f"[K10 nf={nf} N={n}] old vs new bit for bit "
              f"{r['bit_for_bit']} (max|d| {r['max_abs_diff']:.3e}); old "
              f"{r['old_ms']} ms, new {r['new_ms']} ms, new in brick order "
              f"{r['new_brick_order_ms']:.4f} ms (same bits "
              f"{r['brick_order_bit_for_bit']})")
    return res


def run_k3(old, dev) -> dict:
    from murb_tpu_torch.ops.tile import split_args

    res = {}
    for label, q, g in k3_shapes(dev):
        ni = q[0].shape[0]
        ptrs = [v.data_ptr() for v in q]
        outs = [torch.empty((3, ni), dtype=torch.float32, device=dev)
                for _ in range(2)]
        # scratch stays bound until the next shape: f_new writes to it
        split, scratch = split_args(ni, ni, 0, 0, dev)
        s = cuda.stream(dev)

        def f_old():
            call(old, "murb_tile_rect", *ptrs, ni, *ptrs, g.data_ptr(), ni,
                 SOFT2, 0, 0, *(o.data_ptr() for o in outs[0]), s)

        def f_new():
            call(cuda.library(), "murb_tile_rect", *ptrs, ni, *ptrs,
                 g.data_ptr(), ni, SOFT2, 0, 0, *split,
                 *(o.data_ptr() for o in outs[1]), s)

        f_old()
        f_new()
        torch.cuda.synchronize()
        rel = float(((outs[0] - outs[1]).abs().max()
                     / outs[0].abs().max()))
        r = {"slices": split[0], "bit_for_bit": bool(torch.equal(*outs)),
             "max_rel_diff": rel, **in_turns(f_old, f_new)}
        res[label] = r
        print(f"[K3 {label}] {split[0]} slices; old vs new bit for bit "
              f"{r['bit_for_bit']} (max|d|/max|a| {rel:.3e}); old "
              f"{r['old_ms']} ms, new {r['new_ms']} ms")
    return res


def galaxy_operands(dev):
    """The 200k galaxy's positions and G*m, fp32 on ``dev``, and the
    packed operands (A, B, centred targets) of its square sweep, which
    K13's first design took (this K13 builds them itself from the
    bodies)."""
    from murb_tpu_torch import G
    from murb_tpu_torch.core.init import init_galaxy
    from murb_tpu_torch.ops import mxu

    st = init_galaxy(200_000, 123, device=dev)
    q = [v.float().contiguous() for v in (st.qx, st.qy, st.qz)]
    gm = (st.m * G).float().contiguous()
    a_mat, b_mat, cqi = mxu._operands(*q, *q, gm, 2.0e8, True, None)
    return q, gm, a_mat, b_mat, [c.contiguous() for c in cqi]


def run_k13_geometries(dev) -> dict:
    """K13 through the wrapper at 200,192^2: resident blocks, j slices and
    time at each tier and a few geometries."""
    from murb_tpu_torch.ops import mxu

    q, gm, *_ = galaxy_operands(dev)
    n, sms = q[0].shape[0], cuda.sm_count(dev)
    res = {}
    for bi, bj in ((0, 0), (64, 64), (128, 128), (128, 256), (256, 256),
                   (512, 256), (512, 512)):
        gi, gj = bi or mxu.MXU_BLOCK_I, bj or mxu.MXU_BLOCK_J
        resident = cuda.resident("murb_mxu_resident", dev, gi, gj)
        slices = cuda.tile_split(n, n, sms, resident, gi, gj)[0]
        row = {"resident": resident, "slices": slices}
        for prec in ("high", "default"):
            row[prec] = time_ms(lambda: mxu.acc_mxu(
                *q, gm, 2.0e8, block_i=bi, block_j=bj, precision=prec),
                reps=3, runs=3)
        res[f"{gi}x{gj}"] = row
        print(f"[K13 {n}^2 {gi}x{gj}] resident {resident}, {slices} "
              f"slices; high {row['high']:.4f} ms, default "
              f"{row['default']:.4f} ms")
    return res


def run_k13_first(old, dev) -> dict:
    """K13's first design (fp32 on the CUDA cores) against this one on the
    galaxy's packed operands at 200,192^2, in turns."""
    from murb_tpu_torch.ops import mxu

    q, gm, a_mat, b_mat, cqi = galaxy_operands(dev)
    n, s = q[0].shape[0], cuda.stream(dev)
    outs = [torch.empty((3, n), dtype=torch.float32, device=dev)
            for _ in range(3)]

    def f_old():
        call(old, "murb_mxu_rect", a_mat.data_ptr(), gm.data_ptr(), n,
             b_mat.data_ptr(), *(c.data_ptr() for c in cqi), n, 0, 0,
             *(o.data_ptr() for o in outs[0]), s)

    bi, bj = mxu.MXU_BLOCK_I, mxu.MXU_BLOCK_J
    slices, per = cuda.tile_split(
        n, n, cuda.sm_count(dev), cuda.resident("murb_mxu_resident", dev, bi,
                                                bj), bi, bj)
    packed = torch.empty(-(-n // mxu.PACK_SOURCES) * mxu.PACK_SOURCES // 8
                         * mxu.CHUNK_FLOATS, dtype=torch.float32, device=dev)
    scratch = torch.empty((slices, 4, n), dtype=torch.float32, device=dev)

    center = torch.empty(3, dtype=torch.float32, device=dev)

    def f_new(passes, out):
        k13_call(cuda.library(), q, gm, center, bi, bj, passes, slices, per,
                 packed, scratch, out, s)

    res = {}
    f_old()
    for k, prec in enumerate(("high", "default"), 1):
        passes = mxu.tier_passes(prec)[1]
        f_new(passes, outs[k])
        torch.cuda.synchronize()
        rel = float((outs[0] - outs[k]).abs().max() / outs[0].abs().max())
        r = {"max_rel_diff": rel,
             **in_turns(f_old, lambda: f_new(passes, outs[k]), reps=3,
                        runs=3)}
        res[prec] = r
        print(f"[K13 first vs this, {prec}, {n}^2] max|d|/max|a| {rel:.3e}; "
              f"old {r['old_ms']} ms, new {r['new_ms']} ms")
    return res


def k13_call(dll, q, gm, center, bi, bj, passes, slices, per, packed,
             scratch, out, s):
    """One launch of K13's C entry (this design's arguments: the bodies,
    the centre found into ``center``) on the square sweep of ``q``."""
    n = q[0].shape[0]
    call(dll, "murb_mxu_rect", *(v.data_ptr() for v in q), n,
         *(v.data_ptr() for v in q), gm.data_ptr(), n, SOFT2, 1,
         center.data_ptr(), bi, bj, passes, slices, per, packed.data_ptr(),
         scratch.data_ptr(), *(o.data_ptr() for o in out), s)


def run_k13_same(old, dev) -> dict:
    """The parent's K13 (same C entry) against this checkout's on the
    galaxy at 200,192^2, at "high" and "default", at the wrapper's
    geometry and split, in turns; the sums must agree bit for bit."""
    from murb_tpu_torch.ops import mxu

    q, gm, *_ = galaxy_operands(dev)
    n, s = q[0].shape[0], cuda.stream(dev)
    bi, bj = mxu.MXU_BLOCK_I, mxu.MXU_BLOCK_J
    slices, per = cuda.tile_split(
        n, n, cuda.sm_count(dev), cuda.resident("murb_mxu_resident", dev, bi,
                                                bj), bi, bj)
    packed = [torch.empty(-(-n // mxu.PACK_SOURCES) * mxu.PACK_SOURCES // 8
                          * mxu.CHUNK_FLOATS, dtype=torch.float32,
                          device=dev) for _ in range(2)]
    scratch = [torch.empty((slices, 4, n), dtype=torch.float32, device=dev)
               for _ in range(2)]
    outs = [torch.empty((3, n), dtype=torch.float32, device=dev)
            for _ in range(2)]

    centers = [torch.empty(3, dtype=torch.float32, device=dev)
               for _ in range(2)]

    def f(dll, k, passes):
        k13_call(dll, q, gm, centers[k], bi, bj, passes, slices, per,
                 packed[k], scratch[k], outs[k], s)

    res = {}
    for prec in ("high", "default"):
        passes = mxu.tier_passes(prec)[1]
        f(old, 0, passes)
        f(cuda.library(), 1, passes)
        torch.cuda.synchronize()
        r = {"slices": slices, "bit_for_bit": bool(torch.equal(*outs)),
             **in_turns(lambda: f(old, 0, passes),
                        lambda: f(cuda.library(), 1, passes), reps=3,
                        runs=3)}
        res[prec] = r
        print(f"[K13 parent vs this, {prec}, {n}^2] {slices} slices; bit "
              f"for bit {r['bit_for_bit']}; parent {r['old_ms']} ms, this "
              f"{r['new_ms']} ms")
    return res


def ring_call(dll, fn, blocks, dev, first: bool):
    """A launch of K14's C entry of either design on the shards' blocks
    ((qx, qy, qz, G*m) each on ``dev``), everything allocated once."""
    from murb_tpu_torch.ops import ring

    d, n = len(blocks), blocks[0][0].shape[0]
    slices, per = ring.ring_split(n, cuda.sm_count(dev),
                                  cuda.resident("murb_tile_resident", dev), d)
    bufs, outs, scratch = [], [], []
    for b in blocks:
        buf = torch.empty((2, 4, n), dtype=torch.float32, device=dev)
        buf[0] = torch.stack(b)
        bufs.append(buf)
        outs.append(torch.empty((3, n), dtype=torch.float32, device=dev))
        scratch.append(torch.empty((slices, 3, n) if slices > 1 else 0,
                                   dtype=torch.float32, device=dev))
    ptrs = lambda ts: (ctypes.c_void_p * d)(*(t.data_ptr() for t in ts))
    arrays = [ptrs(b[c] for b in blocks) for c in range(3)]
    arrays += [ptrs(bufs)] + [ptrs(o[c] for o in outs) for c in range(3)]
    if not first:
        arrays.append(ptrs(scratch))
    ids = (ctypes.c_int * d)(*([dev.index] * d))
    side = [(torch.cuda.Stream(dev), torch.cuda.Stream(dev))
            for _ in range(d)]
    streams = [(ctypes.c_void_p * d)(*v) for v in (
        [cuda.stream(dev)] * d, [c.cuda_stream for c, _ in side],
        [p.cuda_stream for _, p in side])]
    tail = (SOFT2, 0, 0) + (() if first else (slices, per)) + (0,)

    def f():
        call(dll, fn, d, n, *(ctypes.addressof(a) for a in arrays),
             ctypes.addressof(ids), *(ctypes.addressof(x) for x in streams),
             *tail)

    f.keep = (bufs, scratch, arrays, streams, side, ids)
    f.outs = outs
    return f


def run_k14_first(old, dev) -> dict:
    """K14's first design against this one at D = 1 to 4 shards of the 200k
    galaxy on this card, in turns."""
    from murb_tpu_torch import G
    from murb_tpu_torch.core.init import init_galaxy

    res = {}
    for d in (1, 2, 3, 4):
        st = init_galaxy(200_000, 123, device=dev).repad(256 * d)
        b = st.npad // d
        blocks = [[v[k * b:(k + 1) * b].float().contiguous()
                   for v in (st.qx, st.qy, st.qz, st.m * G)]
                  for k in range(d)]
        f_old = ring_call(old, "murb_ring_pipelined", blocks, dev, True)
        f_new = ring_call(cuda.library(), "murb_ring_pipelined", blocks,
                          dev, False)
        f_old()
        f_new()
        torch.cuda.synchronize()
        a_old, a_new = (torch.cat(f.outs, 1) for f in (f_old, f_new))
        rel = float((a_old - a_new).abs().max() / a_old.abs().max())
        r = {"n": st.npad, "max_rel_diff": rel,
             **in_turns(f_old, f_new, reps=3, runs=3)}
        res[f"D={d}"] = r
        print(f"[K14 first vs this, D={d}, N={st.npad}] max|d|/max|a| "
              f"{rel:.3e}; old {r['old_ms']} ms, new {r['new_ms']} ms")
    return res


# ------------------------------------------------------ K7 and K4 passes 3
#: K7's shapes on the main paths, (m, C, subset, nf): the random-box step,
#: tracked --kernel fmm and shard+fmm (m=8, C=4); chip_smoke.py phase 8's
#: deeper shape (m=6, C=8); the 1M adaptive step's far sweep (m=6, C=4);
#: the ladder's repair (m=18, 32 at C=2)
K7_SHAPES = ((8, 4, "expand", 3), (8, 4, "expand", 4), (6, 8, "expand", 3),
             (6, 8, "near", 3), (6, 4, "far", 3), (6, 4, "far", 4),
             (18, 2, "expand", 4), (32, 2, "expand", 4))
#: K7's first design's offset-split rule (its ops/fmm_kernels.m2l_splits):
#: 128 target nodes a block, splits until the blocks hold 132 x 2048
#: threads, at most 16
_K7_FIRST_TARGETS, _K7_FIRST_FILL, _K7_FIRST_MAX = 128, 132 * 2048, 16
_K7_FIRST_SUBSETS = {"expand": 0, "near": 1, "far": 2}


def k7_first_splits(m: int, C: int) -> int:
    threads = C ** 3 * -(-m ** 3 // _K7_FIRST_TARGETS) * _K7_FIRST_TARGETS
    return max(1, min(_K7_FIRST_MAX, -(-_K7_FIRST_FILL // threads)))


@functools.lru_cache(maxsize=None)
def k7_case(m: int, C: int, dev):
    """(w (C^3, m^3), hl (3,)) float32 on ``dev``: seeded weights at the
    scale of the 200k random box's expansions, and that box's level
    half-widths at C cells a side."""
    from murb_tpu_torch.core.init import init_random
    from murb_tpu_torch.ops.proxy import bounding_box

    st = init_random(200_000, 123, device=dev)
    _, h = bounding_box(st.qx, st.qy, st.qz, st.m > 0)
    g = torch.Generator(device="cpu").manual_seed(1000 * m + C)
    w = torch.randn(C ** 3, m ** 3, generator=g) * 1e28
    return w.float().to(dev), (h / C).float().contiguous()


def k7_this(dll, m, C, subset, nf, dev, group=None, slots=None):
    """A launcher of this checkout's (or a variant's) K7 C entry on
    ``k7_case``, its plan made for ``group`` cells an item and ``slots``
    resident blocks (None: the package's)."""
    from murb_tpu_torch.ops import fmm_kernels as fk

    w, hl = k7_case(m, C, dev)
    if group is None:
        plan, (items, rows) = fk._plan_on(m, C, subset, nf, dev)
    else:
        plan = fk._m2l_plan(m, C, subset, slots, group)
        items, rows = (torch.from_numpy(t).to(dev)
                       for t in (plan.items, plan.rows))
    out = torch.empty((nf, C ** 3, m ** 3), dtype=torch.float32, device=dev)
    n = plan.scratch(m, C, nf)
    part = torch.empty(n, dtype=torch.float32, device=dev) if n else None

    def f():
        call(dll, "murb_m2l_level", w.data_ptr(), hl.data_ptr(),
             ctypes.c_float(SOFT ** 2), m, C, nf, items.data_ptr(),
             rows.data_ptr(), rows.shape[0], plan.nsplit,
             None if part is None else part.data_ptr(), out.data_ptr(),
             cuda.stream(dev))
    f.out, f.plan, f.keep = out, plan, (items, rows, part)
    return f


def k7_first(dll, m, C, subset, nf, dev):
    """A launcher of K7's first design (a parent tree's C entry)."""
    w, hl = k7_case(m, C, dev)
    nsplit = k7_first_splits(m, C)
    out = torch.empty((nf, C ** 3, m ** 3), dtype=torch.float32, device=dev)
    part = (torch.empty(nsplit * out.numel(), dtype=torch.float32,
                        device=dev) if nsplit > 1 else None)

    def f():
        call(dll, "murb_m2l_level", w.data_ptr(), hl.data_ptr(),
             ctypes.c_float(SOFT ** 2), m, C, _K7_FIRST_SUBSETS[subset], nf,
             nsplit, None if part is None else part.data_ptr(),
             out.data_ptr(), cuda.stream(dev))
    f.out, f.nsplit, f.keep = out, nsplit, part
    return f


def run_k7_parent(old, dev) -> dict:
    """K7's first design (the parent tree's build) against this checkout's
    at every main-path shape, in turns, launches only; the fields'
    largest difference over max|f|, whether this checkout gives the same
    bits twice, and the transfer entries each builds a launch."""
    from chip_smoke import m2l_work

    res = {}
    for m, C, subset, nf in K7_SHAPES:
        f_old = k7_first(old, m, C, subset, nf, dev)
        f_new = k7_this(cuda.library(), m, C, subset, nf, dev)
        f_old()
        f_new()
        torch.cuda.synchronize()
        first = f_new.out.clone()
        f_new()
        torch.cuda.synchronize()
        pairs = m2l_work(m, C, subset, nf)[0]
        reps = 1 if m >= 18 else 5
        r = {"pairs": pairs, "builds_old": pairs * m ** 6,
             "builds_new": f_new.plan.builds(m),
             "splits_old": f_old.nsplit, "splits_new": f_new.plan.nsplit,
             "max_rel_diff": float((f_old.out - f_new.out).abs().max()
                                   / f_old.out.abs().max()),
             "same_bits": bool(torch.equal(first, f_new.out)),
             **in_turns(f_old, f_new, reps=reps, runs=3 if m >= 18 else 5)}
        key = f"m={m} C={C} {subset} nf={nf}"
        res[key] = r
        print(f"[K7 first vs this, {key}] {pairs} cell pairs; T builds a "
              f"launch {r['builds_old']:.4g} -> {r['builds_new']:.4g}; "
              f"splits {r['splits_old']} -> {r['splits_new']}; max|df|/max|f| "
              f"{r['max_rel_diff']:.3e}; same bits twice {r['same_bits']}; "
              f"parent {r['old_ms']} ms, this {r['new_ms']} ms")
    return res


#: compile-time variants of K7 (csrc/fmm.cu edited in a copy): group = the
#: cells an item (the plan follows), slices = the source-node slices of a
#: 128-target block, unroll = the source loop's unroll, chunk = the source
#: nodes staged a chunk
K7_VARIANTS = {
    "group8": ({"kM2LGroup = 16;": "kM2LGroup = 8;"}, 8),
    "group12": ({"kM2LGroup = 16;": "kM2LGroup = 12;"}, 12),
    "unroll2": ({"#pragma unroll 1\n    for (int j = j0;":
                 "#pragma unroll 2\n    for (int j = j0;"}, 16),
    "slices2": ({"kM2LSlices = 4;": "kM2LSlices = 2;",
                 "__launch_bounds__(kM2LThreads, 1)":
                 "__launch_bounds__(kM2LThreads, 2)"}, 16),
    "chunk128": ({"kM2LSliceNodes = 64;": "kM2LSliceNodes = 32;"}, 16),
    "slices2_group8": ({"kM2LSlices = 4;": "kM2LSlices = 2;",
                        "__launch_bounds__(kM2LThreads, 1)":
                        "__launch_bounds__(kM2LThreads, 2)",
                        "kM2LGroup = 16;": "kM2LGroup = 8;"}, 8),
}


def run_k7_variants(dev) -> dict:
    """K7's compile-time variants (``K7_VARIANTS``) against this checkout's
    kernel at the main-path shapes, each from its own build (so a few
    percent between builds is noise): registers and spills, resident
    blocks, the largest difference from this checkout's fields, and the
    time, in turns (this, variant, variant, this)."""
    specs = []
    for name, (edits, _) in K7_VARIANTS.items():
        src = (cuda.CSRC / "fmm.cu").read_text()
        for a, b in edits.items():
            if a not in src:
                raise RuntimeError(f"K7 variant {name}: {a!r} not in fmm.cu")
            src = src.replace(a, b)
        d = OUT / f"k7_{name}"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(cuda.CSRC, d)
        (d / "fmm.cu").write_text(src)
        specs.append((f"k7_{name}", d, ["fmm.cu"]))
    libs = dict(zip(K7_VARIANTS, build_many(specs)))
    res = {"this": ptxas_report(cuda.build_kernels(), r"m2l_kernel")}
    shapes = [s for s in K7_SHAPES if s[:3] != (18, 2, "expand")]
    for name, lib in libs.items():
        dll = load(lib, {"murb_m2l_level": cuda._SIGNATURES["murb_m2l_level"],
                         "murb_m2l_resident": [_I, _P]})
        group = K7_VARIANTS[name][1]
        row = {"ptxas": ptxas_report(lib, r"m2l_kernel")}
        for m, C, subset, nf in shapes:
            blocks = ctypes.c_int(0)
            call(dll, "murb_m2l_resident", nf, ctypes.byref(blocks))
            slots = blocks.value * cuda.sm_count(dev)
            f_new = k7_this(cuda.library(), m, C, subset, nf, dev)
            f_var = k7_this(dll, m, C, subset, nf, dev, group, slots)
            f_new()
            f_var()
            torch.cuda.synchronize()
            reps = 1 if m >= 18 else 5
            r = {"resident": blocks.value, "nsplit": f_var.plan.nsplit,
                 "items": len(f_var.plan.items),
                 "max_rel_diff": float((f_var.out - f_new.out).abs().max()
                                       / f_new.out.abs().max()),
                 **in_turns(f_new, f_var, reps=reps,
                            runs=3 if m >= 18 else 5)}
            row[f"m={m} C={C} {subset} nf={nf}"] = r
            print(f"[K7 variant {name}, m={m} C={C} {subset} nf={nf}] "
                  f"resident {r['resident']}, {r['items']} items, "
                  f"{r['nsplit']} splits; max|df|/max|f| "
                  f"{r['max_rel_diff']:.3e}; this {r['old_ms']} ms, "
                  f"variant {r['new_ms']} ms")
        print(f"[K7 variant {name} ptxas] {row['ptxas']}")
        res[name] = row
    return res


def k4_shapes(dev):
    """(label, positions, G*m) of K4 passes 3's shapes: the 16384^2 random
    box (chip_smoke.py phase 3), the 30,000-body galaxy (``--im
    tpu+hybrid+x3`` through the CLI) and the 200,192^2 galaxy."""
    from murb_tpu_torch import G
    from murb_tpu_torch.core.init import init_galaxy, init_random

    for label, st in (("16384^2 random", init_random(16_300, 123,
                                                      device=dev)),
                      ("30208^2 galaxy", init_galaxy(30_000, 123,
                                                     device=dev)),
                      ("200192^2 galaxy", init_galaxy(200_000, 123,
                                                      device=dev))):
        q = [v.float().contiguous() for v in (st.qx, st.qy, st.qz)]
        yield label, q, (st.m * G).float().contiguous()


def run_k4p3_parent(old, dev) -> dict:
    """K4 passes 3's first design (the parent tree's build: one target a
    thread, fp64 sums of every pair term, no j split) against this
    checkout's (K3's sweep, runs of 4 in fp32 folded into fp64, j split)
    at K4's shapes, in turns; each side's max relative force error against
    float64 on a 4096-row strided sample, and this side's bits twice."""
    from murb_tpu_torch.ops.hybrid import ext_split_args
    from murb_tpu_torch.ops.tile import acc_tile_rect_plain

    res = {}
    for label, q, g in k4_shapes(dev):
        n = q[0].shape[0]
        ptrs = [v.data_ptr() for v in q]
        outs = [torch.empty((3, n), dtype=torch.float32, device=dev)
                for _ in range(2)]
        split, scratch = ext_split_args(n, n, 0, 0, dev)
        s = cuda.stream(dev)

        def f(dll, k, split):
            call(dll, "murb_hybrid_rect", *ptrs, n, *ptrs, g.data_ptr(), n,
                 SOFT2, 3, 0, 0, *split, *(o.data_ptr() for o in outs[k]), s)

        f_old = lambda: f(old, 0, (1, 0, None))
        f_new = lambda: f(cuda.library(), 1, split)
        f_old()
        f_new()
        torch.cuda.synchronize()
        first = outs[1].clone()
        f_new()
        torch.cuda.synchronize()
        rows = torch.arange(0, n, max(1, n // 4096), device=dev)
        ref = torch.stack(acc_tile_rect_plain(
            *(v.double()[rows] for v in q), *(v.double() for v in q),
            g.double(), SOFT), 1)
        rn = ref.norm(dim=1)
        floor = torch.clamp(rn, min=1e-6 * float(rn.max()))
        err = [float(((o[:, rows].double().T - ref).norm(dim=1)
                      / floor).max()) for o in outs]
        reps = 1 if n > 100_000 else 5
        r = {"slices": split[0], "err_old": err[0], "err_new": err[1],
             "same_bits": bool(torch.equal(first, outs[1])),
             **in_turns(f_old, f_new, reps=reps,
                        runs=3 if n > 100_000 else 5)}
        res[label] = r
        print(f"[K4 p3 first vs this, {label}] this in {split[0]} slices; "
              f"max rel force err parent {err[0]:.3e}, this {err[1]:.3e}; "
              f"same bits twice {r['same_bits']}; parent {r['old_ms']} ms, "
              f"this {r['new_ms']} ms")
    return res


def run_k4p3_geometries(dev) -> dict:
    """K4 passes 3 at several block geometries, each at the j split
    ``ops/cuda.tile_split`` picks from its resident blocks
    (``murb_hybrid_resident``), at 16384^2 and 200,192^2."""
    from murb_tpu_torch.ops.hybrid import ext_split_args

    res = {}
    for label, q, g in k4_shapes(dev):
        if label.startswith("30208"):
            continue
        n = q[0].shape[0]
        ptrs = [v.data_ptr() for v in q]
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        for bi, bj in ((128, 512), (256, 512), (128, 256), (256, 256),
                       (512, 512), (128, 128)):
            split, _scratch = ext_split_args(n, n, bi, bj, dev)
            resident = cuda.resident("murb_hybrid_resident", dev, bi, bj)
            ms = time_ms(lambda: call(
                cuda.library(), "murb_hybrid_rect", *ptrs, n, *ptrs,
                g.data_ptr(), n, SOFT2, 3, bi, bj, *split,
                *(o.data_ptr() for o in out), cuda.stream(dev)),
                reps=1 if n > 100_000 else 5, runs=3)
            res[f"{label} {bi}x{bj}"] = {"resident": resident,
                                         "slices": split[0], "ms": ms}
            print(f"[K4 p3 {label} {bi}x{bj}] resident {resident}, "
                  f"{split[0]} slices: {ms:.4f} ms")
    return res


FPS_CODE = r"""
import json, sys, time
import torch
from murb_tpu_torch import cli
kind = sys.argv[1]
if kind == "adaptive1m":
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.utils.profile_step import (TWO_CLUSTERS_DT,
                                                   TWO_CLUSTERS_SOFT,
                                                   two_clusters)
    st = two_clusters(device="cuda")
    eng = create_engine("tpu+proxy", st, soft=TWO_CLUSTERS_SOFT,
                        dt=TWO_CLUSTERS_DT)
    eng.run(1)
    eng.block_until_ready()
    t0 = time.perf_counter()
    eng.run(4)
    eng.block_until_ready()
    print(json.dumps({"fps": 4 / (time.perf_counter() - t0)}))
else:
    res = cli.run(sys.argv[2:] + ["--device", "cuda"])
    assert res.rc == 0
    print(json.dumps({"fps": res.fps}))
"""
#: the paths through K7 and K4 passes 3 whose FPS both trees are timed at;
#: the CLI's iteration counts keep each timed window near a second or more
#: (100 random-box steps, a quarter of a second, spread by a third)
FPS_RUNS = {
    "tpu+proxy -s random 200k": ["-n", "200000", "-i", "500", "--im",
                                 "tpu+proxy", "-s", "random", "--nv",
                                 "--gf", "--scan"],
    "tpu+tracking --kernel fmm -s random 200k": [
        "-n", "200000", "-i", "300", "--im", "tpu+tracking", "--kernel",
        "fmm", "-s", "random", "--nv", "--gf", "--scan"],
    "tpu+hybrid+x3 30000": ["-n", "30000", "-i", "1000", "--im",
                            "tpu+hybrid+x3", "--nv", "--gf", "--scan"],
    "two clusters 1M adaptive (5 steps)": None,
}
#: rounds of (parent, this, this, parent): 10 pairs a path
FPS_ROUNDS = 5
#: the paths of FPS_RUNS that launch the cell-run kernels on every step
#: (K8 and K9; K11 and K12), and their rounds: 6 pairs a path
CELL_RUN_FPS = ("tpu+proxy -s random 200k",
                "two clusters 1M adaptive (5 steps)")
CELL_RUN_FPS_ROUNDS = 3


def graph_turns(old, new, reps: int = 20) -> dict:
    """``profile_step.graph_ms`` (launches captured in a CUDA graph: no
    host time between them) in turns, old, new, new, old."""
    t = [graph_ms(f, reps=reps) for f in (old, new, new, old)]
    return {"old_graph_ms": [t[0], t[3]], "new_graph_ms": [t[1], t[2]]}


def clock_under_load(fn, seconds: float = 2.0) -> dict:
    """The SM clock (MHz) and power draw (W) nvidia-smi reads while ``fn``
    runs back to back for about ``seconds``: the medians of its samples,
    and how many."""
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-i", "0"],
                capture_output=True, text=True).stdout
            try:
                samples.append([float(v) for v in out.split(",")])
            except ValueError:
                pass
            time.sleep(0.05)

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    watch = threading.Thread(target=poll)
    watch.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    stop.set()
    watch.join()
    return {"sm_mhz": statistics.median(v[0] for v in samples),
            "watts": statistics.median(v[1] for v in samples),
            "samples": len(samples)} if samples else {}


def runs_resident(m: int, l2p: bool, dev) -> dict:
    """K8's (l2p False) or K9's blocks an SM at order m (the occupancy
    calculator), threads a block and warps a scheduler (4 an SM)."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        cuda.launch("murb_runs_resident", m, int(l2p), ctypes.byref(blocks),
                    ctypes.byref(threads))
    return {"blocks": blocks.value, "threads": threads.value,
            "warps_a_scheduler": blocks.value * threads.value / 128}


def cell_run_cases(dev):
    """The cell-run kernels' shapes: (label, kind, m, C, k, inputs).  K8 and
    K9 (k 3 and 4) at (m, C) = (8, 4) and (6, 8) on the 200k random box
    (chip_smoke.py phase 8) and at m = 18 and 32, C = 2 on the 1M
    two-cluster box (phase 9's repair); K11 and K12 (nf 3 and 4) on that
    box's sorted bodies and slots under the plan the auto policy picks
    (phase 9).  Fields: seeded normals at the scale of a node field."""
    from murb_tpu_torch import G
    from murb_tpu_torch.core.init import init_random
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.ops import fmm_kernels as fk
    from murb_tpu_torch.ops import p2p as pp
    from murb_tpu_torch.ops import sparse_fmm as sf
    from murb_tpu_torch.ops.fmm import _heavy_setup
    from murb_tpu_torch.ops.proxy import bounding_box
    from murb_tpu_torch.utils.profile_step import (TWO_CLUSTERS_DT,
                                                   TWO_CLUSTERS_SOFT,
                                                   two_clusters)

    gen = torch.Generator(device="cpu").manual_seed(11)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    cases = []
    st = init_random(200_000, 123, device=dev)
    g = (st.m * G).float().contiguous()
    c, h = bounding_box(st.qx, st.qy, st.qz, g > 0)
    q = (st.qx, st.qy, st.qz)
    for m, C in ((8, 4), (6, 8)):
        order = fk.cell_order(*q, c, h, C)
        cases.append((f"random 200k m={m} C={C}", "grid", m, C,
                      {"q": q, "g": g, "order": order, "c": c, "h": h,
                       "fields": [rnd(C ** 3, m ** 3) for _ in range(4)]}))
    st = two_clusters(device=dev)
    eng = create_engine("tpu+proxy", st, soft=TWO_CLUSTERS_SOFT,
                        dt=TWO_CLUSTERS_DT)
    plan = eng._plan
    q = (st.qx, st.qy, st.qz)
    c, h, *_rest, ge = _heavy_setup(*q, eng._gm(st), 1, sf.HEAVY_FACTOR)
    h = h.max().expand(3)
    ge = ge.float().contiguous()
    for m in (18, 32):
        order = fk.cell_order(*q, c, h, 2)
        cases.append((f"two clusters 1M m={m} C=2", "grid", m, 2,
                      {"q": q, "g": ge, "order": order, "c": c, "h": h,
                       "fields": [rnd(8, m ** 3) for _ in range(4)]}))
    C = 2 ** plan.levels
    key, ci = pp.sorted_cells(*q, ge > 0, c, h, C)
    key, perm = torch.sort(key, stable=True)
    cap = plan.cell_caps[-1]
    _, slots = sf._occupied_and_slots(key, cap)
    cases.append((f"two clusters 1M slots m={plan.m} cap={cap}", "window",
                  plan.m, C,
                  {"q": [v[perm].contiguous() for v in q],
                   "g": ge[perm].contiguous(),
                   "cells": [v[perm].to(torch.int32).contiguous()
                             for v in ci],
                   "box": torch.cat([c - h, 2.0 * h / C]).float(),
                   "c": c, "h": h, "ci": tuple(v[perm] for v in ci),
                   "slots64": slots,
                   "slots": slots.to(torch.int32), "cap": cap,
                   "fields": [torch.cat([rnd(cap, plan.m ** 3), torch.zeros(
                       1, plan.m ** 3, device=dev)]) for _ in range(4)]}))
    return cases


def cell_run_launchers(old, kind: str, m: int, C: int, k: int, a: dict,
                       dev) -> dict:
    """{"K8"/"K11": (old, new), "K9"/"K12": (old, new)}: launchers of the
    first design's entries (a parent tree's: items of 512 and 128 bodies
    found by each block's search, stacked fields) and of this checkout's
    (the package's glue, built once), each keeping its output as
    ``.out``."""
    from murb_tpu_torch.ops import anterp_kernels as ak
    from murb_tpu_torch.ops import fmm_kernels as fk

    n = a["q"][0].shape[0]
    p3 = m ** 3
    fmat = torch.stack(a["fields"][:k]).contiguous()
    flds = [f.contiguous() for f in a["fields"][:k]]
    if kind == "grid":
        order = a["order"]
        nrun, bounds = C ** 3, order.bounds
        runs_arg = (order.perm.data_ptr(),)
        box = order.box
        new_p2m_items = fk.p2m_grid_items(order, m)
        new_l2p_items = fk.l2p_grid_items(order, m)
    else:
        nrun = a["cap"] + 1
        bounds = ak.slot_items(a["slots"], a["cap"], 512)[0]
        runs_arg = tuple(v.data_ptr() for v in a["cells"])
        box = a["box"]
        new_p2m_items = ak.window_items(a["slots"], a["cap"], fk.p2m_chunk(
            n, m, cuda.sm_count(dev)))
        new_l2p_items = ak.window_items(a["slots"], a["cap"],
                                        fk.l2p_item(m))
    per = lambda chunk: F.pad(((bounds.diff() + chunk - 1) // chunk
                               ).cumsum(0), (1, 0))
    pre512, items512 = per(512), n // 512 + nrun + 1
    pre128, items128 = per(128), n // 128 + nrun + 1
    partial = torch.empty(items512 * p3, dtype=torch.float32, device=dev)
    w_old = torch.empty((nrun, p3), dtype=torch.float32, device=dev)
    o_old = torch.zeros((k, n), dtype=torch.float32, device=dev)
    q = [v.data_ptr() for v in a["q"]]
    grid = kind == "grid"

    def p2m_old():
        if grid:
            call(old, "murb_p2m_grid", *q, a["g"].data_ptr(), *runs_arg,
                 box.data_ptr(), m, C, bounds.data_ptr(), pre512.data_ptr(),
                 items512, partial.data_ptr(), w_old.data_ptr(),
                 cuda.stream(dev))
        else:
            call(old, "murb_p2m_window", *q, a["g"].data_ptr(), *runs_arg,
                 box.data_ptr(), m, nrun, bounds.data_ptr(),
                 pre512.data_ptr(), items512, partial.data_ptr(),
                 w_old.data_ptr(), cuda.stream(dev))

    def l2p_old():
        if grid:
            call(old, "murb_l2p_grid", *q, *runs_arg, n, box.data_ptr(), m, C,
                 bounds.data_ptr(), pre128.data_ptr(), items128,
                 fmat.data_ptr(), k, o_old.data_ptr(), cuda.stream(dev))
        else:
            call(old, "murb_l2p_window", *q, *runs_arg, n, box.data_ptr(), m,
                 nrun, bounds.data_ptr(), pre128.data_ptr(), items128,
                 fmat.data_ptr(), k, o_old.data_ptr(), cuda.stream(dev))

    def p2m_new():
        if grid:
            p2m_new.out = fk.p2m_grid_launch(*a["q"], a["g"], a["order"],
                                             new_p2m_items, m)
        else:
            p2m_new.out = ak.p2m_window_launch(*a["q"], a["g"], a["cells"],
                                               box, new_p2m_items, m)

    def l2p_new():
        if grid:
            l2p_new.out = fk.l2p_grid_launch(*a["q"], a["order"],
                                             new_l2p_items, m, flds)
        else:
            l2p_new.out = ak.l2p_window_launch(*a["q"], a["cells"], box,
                                               new_l2p_items, m, flds)

    p2m_old.out, l2p_old.out = w_old, o_old
    p2m_new.chunk = new_p2m_items.chunk
    return {("K8" if grid else "K11"): (p2m_old, p2m_new),
            ("K9" if grid else "K12"): (l2p_old, l2p_new)}


def cell_run_plain64(name: str, m: int, C: int, k: int, a: dict):
    """The float64 plain version of ``name`` on a ``cell_run_cases`` case:
    W (rows of the occupied slots for K11) or the (k, n) values."""
    from murb_tpu_torch.ops import anterp_kernels as ak
    from murb_tpu_torch.ops import fmm_kernels as fk

    q = [v.double() for v in a["q"]]
    c, h = a["c"].double(), a["h"].double()
    flds = [f.double() for f in a["fields"][:k]]
    if name == "K8":
        return fk.p2m_grid_plain(*q, a["g"].double(), c, h, m=m, C=C)
    if name == "K9":
        return torch.stack(fk.l2p_grid_plain(*q, c, h, flds, m=m, C=C))
    if name == "K11":
        return ak.p2m_window_plain(*q, a["g"].double(), c, h, a["slots64"],
                                   a["cap"], m=m, C=C,
                                   ci=a["ci"])[:a["cap"]]
    return torch.stack(ak.l2p_window_plain(*q, c, h, a["slots64"], flds,
                                           m=m, C=C, ci=a["ci"]))


def run_cell_runs_parent(old, dev) -> dict:
    """K8, K9, K11 and K12: the first design (the parent tree's build)
    against this checkout's at every shape of ``cell_run_cases``, in turns:
    CUDA events over launches from the host (each side's wrapper-free
    launch, this side's glue built once) and the launches captured in a
    CUDA graph (``graph_ms``: no host time between them); each side's
    largest difference from the float64 plain version over its largest
    value, and whether this checkout gives the same bits twice.  At m = 18
    and 32 also this checkout's SM clock and power under K8's and K9's
    load; and K8's and K9's blocks an SM at m = 8, 18 and 32."""
    res = {}
    for label, kind, m, C, a in cell_run_cases(dev):
        for k in (3, 4):
            for name, (f_old, f_new) in cell_run_launchers(
                    old, kind, m, C, k, a, dev).items():
                if name in ("K8", "K11") and k == 4:
                    continue        # P2M has no fields
                f_old()
                f_new()
                torch.cuda.synchronize()
                first = f_new.out.clone()
                f_new()
                torch.cuda.synchronize()
                ref = cell_run_plain64(name, m, C, k, a)
                rows = slice(0, a["cap"]) if name == "K11" else slice(None)

                def err(out):
                    return float((out[rows].double() - ref).abs().max()
                                 / ref.abs().max())

                big = m >= 18
                r = {"max_rel_diff": float((f_old.out - f_new.out).abs().max()
                                           / f_old.out.abs().max()),
                     "parent_err64": err(f_old.out),
                     "this_err64": err(f_new.out),
                     "same_bits": bool(torch.equal(first, f_new.out)),
                     **in_turns(f_old, f_new, reps=3 if big else 20,
                                runs=3 if big else 5),
                     **graph_turns(f_old, f_new, reps=3 if big else 20)}
                del ref
                if name in ("K8", "K11"):
                    r["chunk"] = f_new.chunk
                if big and kind == "grid":
                    r["load"] = clock_under_load(f_new)
                key = f"{name} {label}" + ("" if name in ("K8", "K11")
                                           else f" k={k}")
                res[key] = r
                print(f"[{key}] parent vs this max|d|/max {r['max_rel_diff']:.3e}"
                      f"; against float64: parent {r['parent_err64']:.3e}, "
                      f"this {r['this_err64']:.3e}; this the same bits twice "
                      f"{r['same_bits']}; events: parent {r['old_ms']} ms, "
                      f"this {r['new_ms']} ms; graph: parent "
                      f"{r['old_graph_ms']} ms, this {r['new_graph_ms']} ms"
                      + (f"; this under load {r['load']}" if "load" in r
                         else ""))
        del a
        torch.cuda.empty_cache()
    for m in (8, 18, 32):
        for name, l2p in (("K8", False), ("K9", True)):
            r = runs_resident(m, l2p, dev)
            res[f"{name} m={m} resident"] = r
            print(f"[{name} m={m} resident] {r}")
    return res


class using:
    """Route ``ops/cuda.launch`` to another build (a parent's library with
    this checkout's C entries) while the block runs."""

    def __init__(self, dll):
        self.dll = dll

    def __enter__(self):
        self.saved = cuda.library
        cuda.library = lambda: self.dll

    def __exit__(self, *exc):
        cuda.library = self.saved


def run_cell_runs_same(old, dev) -> dict:
    """K8, K9, K11 and K12 from a parent's build whose entries this
    checkout keeps, against this build, through this checkout's glue at
    every shape of ``cell_run_cases``: the same bits expected except where
    the P2M's fold splits a run's items (``fmm_kernels.fold_split``), each
    side's largest difference from the float64 plain version, times alone
    in a CUDA graph in turns."""
    res = {}
    for label, kind, m, C, a in cell_run_cases(dev):
        for k in (3, 4):
            for name, (_, f_new) in cell_run_launchers(
                    old, kind, m, C, k, a, dev).items():
                if name in ("K8", "K11") and k == 4:
                    continue

                def f_old(f=f_new):
                    with using(old):
                        f()
                    f_old.out = f.out

                f_old()
                torch.cuda.synchronize()
                out_old = f_old.out.clone()
                f_new()
                torch.cuda.synchronize()
                ref = cell_run_plain64(name, m, C, k, a)
                rows = slice(0, a["cap"]) if name == "K11" else slice(None)
                err = lambda out: float((out[rows].double() - ref).abs().max()
                                        / ref.abs().max())
                big = m >= 18
                r = {"bit_for_bit": bool(torch.equal(out_old, f_new.out)),
                     "max_rel_diff": float((out_old - f_new.out).abs().max()
                                           / out_old.abs().max()),
                     "parent_err64": err(out_old),
                     "this_err64": err(f_new.out),
                     **graph_turns(f_old, f_new, reps=3 if big else 20)}
                del ref
                key = f"{name} {label}" + ("" if name in ("K8", "K11")
                                           else f" k={k}")
                res[key] = r
                print(f"[{key} parent vs this] {r}")
        del a
        torch.cuda.empty_cache()
    return res


#: the wrappers through each tree's package (``WRAPPERS_CODE``): K8 and K9
#: (k = 3) on the random box at (8, 4), K11 and K12 (nf = 3) on the 1M
#: slots, K8 and K9 (k = 4) at m = 18 and 32 on the 1M box's C = 2 grid,
#: each cell order prebuilt; then each tree's glue alone (the work items);
#: then the wrappers again after one profiler session in the process
WRAPPERS_CODE = r"""
import json, statistics, sys
import torch
from torch.profiler import ProfilerActivity, profile
from murb_tpu_torch import G
from murb_tpu_torch.core.init import init_random
from murb_tpu_torch.models import create_engine
from murb_tpu_torch.ops import anterp_kernels as ak
from murb_tpu_torch.ops import fmm_kernels as fk
from murb_tpu_torch.ops import p2p as pp
from murb_tpu_torch.ops import sparse_fmm as sf
from murb_tpu_torch.ops.fmm import _heavy_setup
from murb_tpu_torch.ops.proxy import bounding_box
from murb_tpu_torch.utils.profile_step import (TWO_CLUSTERS_DT,
                                               TWO_CLUSTERS_SOFT,
                                               two_clusters)


def time_ms(fn, reps, runs):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


dev = torch.device("cuda", 0)
gen = torch.Generator(device="cpu").manual_seed(11)
rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
calls, glue = {}, {}
st = init_random(200_000, 123, device=dev)
g = (st.m * G).float().contiguous()
c, h = bounding_box(st.qx, st.qy, st.qz, g > 0)
q = (st.qx, st.qy, st.qz)
order = fk.cell_order(*q, c, h, 4)
f8 = [rnd(64, 512) for _ in range(3)]
calls["K8 m=8 C=4"] = lambda: fk.p2m_grid_fused(*q, g, c, h, m=8, C=4,
                                                order=order)
calls["K9 m=8 C=4 k=3"] = lambda: fk.l2p_grid_fused(*q, c, h, f8, m=8, C=4,
                                                    order=order)
st9 = two_clusters(device=dev)
eng = create_engine("tpu+proxy", st9, soft=TWO_CLUSTERS_SOFT,
                    dt=TWO_CLUSTERS_DT)
plan = eng._plan
q9 = (st9.qx, st9.qy, st9.qz)
c9, h9, *_rest, ge9 = _heavy_setup(*q9, eng._gm(st9), 1, sf.HEAVY_FACTOR)
h9 = h9.max().expand(3)
C9, m9 = 2 ** plan.levels, plan.m
key, ci = pp.sorted_cells(*q9, ge9 > 0, c9, h9, C9)
key, perm = torch.sort(key, stable=True)
xs, ys, zs, gs = (v[perm] for v in (*q9, ge9))
ci = tuple(v[perm] for v in ci)
cap = plan.cell_caps[-1]
_, slots = sf._occupied_and_slots(key, cap)
f9 = [torch.cat([rnd(cap, m9 ** 3), torch.zeros(1, m9 ** 3, device=dev)])
      for _ in range(3)]
calls["K11 1M slots"] = lambda: ak.p2m_window(xs, ys, zs, gs, c9, h9, slots,
                                              cap, m=m9, C=C9, ci=ci)
calls["K12 1M slots nf=3"] = lambda: ak.l2p_window(xs, ys, zs, c9, h9, slots,
                                                   f9, m=m9, C=C9, ci=ci)
order2 = fk.cell_order(*q9, c9, h9, 2)
for m in (18, 32):
    fm = [rnd(8, m ** 3) for _ in range(4)]
    calls[f"K8 m={m} C=2"] = lambda m=m: fk.p2m_grid_fused(
        *q9, ge9, c9, h9, m=m, C=2, order=order2)
    calls[f"K9 m={m} C=2 k=4"] = lambda m=m, fm=fm: fk.l2p_grid_fused(
        *q9, c9, h9, fm, m=m, C=2, order=order2)
sl32 = slots.to(torch.int32)
if hasattr(fk, "run_items"):
    glue["K8 items m=8 C=4"] = lambda: fk.p2m_grid_items(order, 8)
    glue["K9 items m=8 C=4"] = lambda: fk.l2p_grid_items(order, 8)
    glue["K11 items 1M slots"] = lambda: ak.window_items(
        sl32, cap, fk.p2m_chunk(xs.shape[0], m9, torch.cuda.
                                get_device_properties(dev).
                                multi_processor_count))
    glue["K12 items 1M slots"] = lambda: ak.window_items(
        sl32, cap, fk.l2p_item(m9))
else:
    glue["K8 items m=8 C=4"] = lambda: fk._work_items(order, 512)
    glue["K9 items m=8 C=4"] = lambda: fk._work_items(order, 128)
    glue["K11 items 1M slots"] = lambda: ak.slot_items(sl32, cap, 512)
    glue["K12 items 1M slots"] = lambda: ak.slot_items(sl32, cap, 128)


def timed(fns):
    return {k: time_ms(f, 3 if "m=18" in k or "m=32" in k else 20,
                       3 if "m=18" in k or "m=32" in k else 5)
            for k, f in fns.items()}


res = {"wrapper_ms": timed(calls), "glue_ms": timed(glue)}
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
    for f in calls.values():
        f()
    torch.cuda.synchronize()
res["wrapper_ms_after_profiler"] = timed(calls)
print(json.dumps(res))
"""


def wrapper_turns(parent: Path) -> dict:
    """``WRAPPERS_CODE`` through each tree's own package in turns (parent,
    this, this, parent), one process each: every reading of each side."""
    out = {"parent": [], "this": []}
    for side, root in (("parent", parent), ("this", ROOT), ("this", ROOT),
                       ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", WRAPPERS_CODE], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"wrappers in {root} failed:\n"
                               f"{proc.stderr[-3000:]}")
        out[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for part in ("wrapper_ms", "glue_ms", "wrapper_ms_after_profiler"):
        for key in out["this"][0][part]:
            print(f"[{part} {key}] parent "
                  f"{[r[part][key] for r in out['parent']]}, this "
                  f"{[r[part][key] for r in out['this']]}")
    return out


#: K1 and K2 at the proxy paths' shapes: (label, bodies, m, the k of K2)
#: -- the 200k galaxy (tpu+proxy, the tracked proxies: k = 3 + G), and one
#: of the four shards of shard+proxy (its first 50,000 bodies, the whole
#: galaxy's box)
PROXY_SHAPES = (("galaxy 200k", 200_000, 12, (3, 4, 5, 11)),
                ("galaxy 200k", 200_000, 20, (3,)),
                ("shard 50k", 50_000, 12, (3,)))
#: the bodies K1's chunk scan tries an item (this checkout's design)
PROXY_CHUNKS = (64, 128, 256, 512, 1024)


def proxy_case(dev):
    """The 200k galaxy's float32 positions, heavy-split weights and the
    (6,) box [c, h] the K1/K2 entries read (ops/proxy.acc_proxy's)."""
    from murb_tpu_torch import G
    from murb_tpu_torch.core.init import init_galaxy
    from murb_tpu_torch.ops.proxy import (HEAVY_FACTOR, HEAVY_K, bounding_box,
                                          heavy_split)

    st = init_galaxy(200_000, 123, device=dev)
    gm = (st.m * G).float()
    c, h = bounding_box(st.qx, st.qy, st.qz, gm > 0)
    mean_gm = gm.sum() / (gm > 0).sum()
    ge = heavy_split(st.qx, st.qy, st.qz, gm, HEAVY_K, HEAVY_FACTOR,
                     mean_gm)[4].contiguous()
    box = torch.cat([c.reshape(3), h.reshape(3)]).float()
    return (st.qx, st.qy, st.qz), ge, c, h, box


def proxy_resident(m: int, l2p: bool, tb: int, dev) -> dict:
    """K1's (l2p False) or K2's (``tb`` bodies a thread) blocks an SM at
    order m (the occupancy calculator), threads a block and warps a
    scheduler (4 an SM)."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        cuda.launch("murb_proxy_resident", m, int(l2p), tb,
                    ctypes.byref(blocks), ctypes.byref(threads))
    return {"blocks": blocks.value, "threads": threads.value,
            "warps_a_scheduler": blocks.value * threads.value / 128}


def proxy_is_first(signatures: dict) -> bool:
    """Whether a tree's K1/K2 entries are the first design's."""
    return (signatures.get("murb_p2m") == FIRST_SIGNATURES["murb_p2m"]
            and signatures.get("murb_l2p") == FIRST_SIGNATURES["murb_l2p"])


def proxy_launchers(dll, first: bool, q, g, box, m: int, fields, dev,
                    chunk: int | None = None, tb: int | None = None):
    """(K1 launcher, {k: K2 launcher}) of one build, each keeping its
    output as ``.out``: the first design's entries (a grid of 4 SMs'
    blocks, partials and a reduce; the fields stacked) or this design's
    with this checkout's glue (``ops/proxy_kernels.one_run``; K1's items
    of ``chunk`` bodies and K2's ``tb`` bodies a thread when given, else
    the wrapper's)."""
    from murb_tpu_torch.ops import proxy_kernels as tk

    n, p3 = q[0].shape[0], m ** 3
    ptrs = [v.data_ptr() for v in q]
    w = torch.empty(p3, dtype=torch.float32, device=dev)
    outs = {k: torch.empty((k, n), dtype=torch.float32, device=dev)
            for k in fields}
    if first:
        nblocks = max(1, min(-(-n // 64), 4 * cuda.sm_count(dev)))
        part = torch.empty(nblocks * p3, dtype=torch.float32, device=dev)

        def p2m():
            call(dll, "murb_p2m", *ptrs, g.data_ptr(), n, box.data_ptr(), m,
                 part.data_ptr(), nblocks, w.data_ptr(),
                 cuda.stream(dev))

        def l2p_of(k):
            fmat = torch.stack(fields[k]).contiguous()

            def l2p():
                call(dll, "murb_l2p", *ptrs, n, box.data_ptr(), m,
                     fmat.data_ptr(), k, outs[k].data_ptr(),
                     cuda.stream(dev))
            return l2p
    else:
        its = (tk.one_run(n, m, dev) if chunk is None
               else tk.one_run_items(n, chunk, dev))
        tb = tk.l2p_bodies(n, m, cuda.sm_count(dev)) if tb is None else tb
        table = tk.node_table(m, dev)
        part = (torch.empty(its.nitems * p3, dtype=torch.float32, device=dev)
                if its.nitems > 1 else None)

        def p2m():
            call(dll, "murb_p2m", *ptrs, g.data_ptr(), n, box.data_ptr(), m,
                 its.bounds.data_ptr(), its.prefix.data_ptr(), its.nitems,
                 its.chunk, table.data_ptr(),
                 None if part is None else part.data_ptr(), w.data_ptr(),
                 cuda.stream(dev))

        def l2p_of(k):
            flds = [f.contiguous() for f in fields[k]]
            ptr = cuda.field_pointers(flds)

            def l2p():
                call(dll, "murb_l2p", *ptrs, n, box.data_ptr(), m, tb,
                     table.data_ptr(), ptr, k, outs[k].data_ptr(),
                     cuda.stream(dev))
            l2p.keep = flds
            return l2p
    p2m.out = w
    l2ps = {}
    for k in fields:
        l2ps[k] = l2p_of(k)
        l2ps[k].out = outs[k]
    return p2m, l2ps


def run_proxy(old, dev) -> dict:
    """K1 and K2 at every shape of ``PROXY_SHAPES``: this checkout's
    build alone in a CUDA graph (``graph_ms``) and its largest difference
    from the float64 plain version over its largest value, the same bits
    twice; with ``old`` (a parent's build of the first design) both in
    turns, by CUDA events around launches from the host and in the graph.
    With this checkout's design also K1 alone at each chunk of
    ``PROXY_CHUNKS`` and K2 (k = 3) at 1 and 2 bodies a thread, their
    blocks an SM and, on the galaxy at m = 12, the SM clock and power
    under their load."""
    from murb_tpu_torch.ops import proxy_kernels as tk

    first_this = proxy_is_first(cuda._SIGNATURES)
    q_all, g_all, c, h, box = proxy_case(dev)
    gen = torch.Generator(device="cpu").manual_seed(5)
    res = {}
    for label, n, m, ks in PROXY_SHAPES:
        q = [v[:n].contiguous() for v in q_all]
        g = g_all[:n].contiguous()
        fields = {k: [torch.randn(m ** 3, generator=gen).to(dev)
                      for _ in range(k)] for k in ks}
        sides = {"this": proxy_launchers(cuda.library(), first_this, q, g,
                                         box, m, fields, dev)}
        if old is not None:
            sides["parent"] = proxy_launchers(old, True, q, g, box, m,
                                              fields, dev)
        q64 = [v.double() for v in q]
        w64 = tk.p2m_plain(*q64, g.double(), c.double(), h.double(), m=m)
        jobs = [("K1", w64, {s: v[0] for s, v in sides.items()})]
        for k in ks:
            a64 = torch.stack(tk.l2p_plain(*q64, c.double(), h.double(),
                                           [f.double() for f in fields[k]],
                                           m=m))
            jobs.append((f"K2 k={k}", a64,
                         {s: v[1][k] for s, v in sides.items()}))
        for name, ref, fns in jobs:
            key = f"{name} {label} m={m}"
            new = fns["this"]
            new()
            torch.cuda.synchronize()
            first = new.out.clone()
            new()
            torch.cuda.synchronize()
            err = lambda out: float((out.double() - ref).abs().max()
                                    / ref.abs().max())
            r = {"this_err64": err(new.out),
                 "same_bits": bool(torch.equal(first, new.out))}
            if old is None:
                r["this_graph_ms"] = graph_ms(new)
            else:
                f_old = fns["parent"]
                f_old()
                torch.cuda.synchronize()
                r.update(parent_err64=err(f_old.out),
                         max_rel_diff=float((f_old.out - new.out).abs().max()
                                            / f_old.out.abs().max()),
                         **in_turns(f_old, new, reps=20),
                         **graph_turns(f_old, new))
            res[key] = r
            print(f"[{key}] {r}")
        if not first_this and label == "galaxy 200k":
            scan = {}
            for chunk in PROXY_CHUNKS:
                f = proxy_launchers(cuda.library(), False, q, g, box, m,
                                    {}, dev, chunk=chunk)[0]
                f()
                torch.cuda.synchronize()
                scan[chunk] = {"graph_ms": graph_ms(f), "err64": float(
                    (f.out.double() - w64).abs().max() / w64.abs().max())}
            res[f"K1 {label} m={m} chunks"] = scan
            print(f"[K1 {label} m={m} chunk scan] {scan}")
        if not first_this:
            scan = {}
            for tb in (1, 2):
                f = proxy_launchers(cuda.library(), False, q, g, box, m,
                                    {3: fields[3]}, dev, tb=tb)[1][3]
                f()
                torch.cuda.synchronize()
                scan[tb] = {"graph_ms": graph_ms(f),
                            "same_bits": bool(torch.equal(
                                f.out, sides["this"][1][3].out))}
            res[f"K2 k=3 {label} m={m} bodies a thread"] = scan
            tb = tk.l2p_bodies(n, m, cuda.sm_count(dev))
            print(f"[K2 k=3 {label} m={m} bodies a thread] {scan} (the "
                  f"wrapper takes {tb})")
            occ = {"K1": proxy_resident(m, False, 1, dev),
                   "K2": proxy_resident(m, True, tb, dev)}
            if (label, m) == ("galaxy 200k", 12):
                occ["K1 load"] = clock_under_load(sides["this"][0])
                occ["K2 k=3 load"] = clock_under_load(sides["this"][1][3])
            res[f"{label} m={m} resident"] = occ
            print(f"[K1/K2 {label} m={m} resident] {occ}")
        del sides, w64
        torch.cuda.empty_cache()
    return res


#: K1 and K2 through a tree's own package (``p2m_fused``,
#: ``l2p_fused_multi``) at ``PROXY_SHAPES``, by CUDA events around calls
#: from the host, and the host's own time a call (200 calls queued
#: without a wait, a perf_counter around them), in a fresh process that
#: opens no profiler
PROXY_WRAPPERS_CODE = r"""
import json, statistics, time
import torch
from murb_tpu_torch import G
from murb_tpu_torch.core.init import init_galaxy
from murb_tpu_torch.ops.proxy import (HEAVY_FACTOR, HEAVY_K, bounding_box,
                                      heavy_split)
from murb_tpu_torch.ops.proxy_kernels import l2p_fused_multi, p2m_fused


def time_ms(fn, reps=20, runs=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def host_ms(fn, reps=200, runs=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
    return statistics.median(out)


dev = torch.device("cuda", 0)
st = init_galaxy(200_000, 123, device=dev)
gm = (st.m * G).float()
c, h = bounding_box(st.qx, st.qy, st.qz, gm > 0)
ge = heavy_split(st.qx, st.qy, st.qz, gm, HEAVY_K, HEAVY_FACTOR,
                 gm.sum() / (gm > 0).sum())[4]
gen = torch.Generator(device="cpu").manual_seed(5)
res = {}
for label, n, m, ks in SHAPES:
    q = [v[:n].contiguous() for v in (st.qx, st.qy, st.qz)]
    g = ge[:n].contiguous()
    calls = {f"K1 {label} m={m}": lambda: p2m_fused(*q, g, c, h, m=m)}
    for k in ks:
        f = tuple(torch.randn(m ** 3, generator=gen).to(dev)
                  for _ in range(k))
        calls[f"K2 k={k} {label} m={m}"] = (
            lambda f=f: l2p_fused_multi(*q, c, h, f, m=m))
    for key, fn in calls.items():
        res[key] = time_ms(fn)
        res[f"{key} host"] = host_ms(fn)
print(json.dumps(res))
"""


#: rounds of (parent, this, this, parent) of the wrappers' processes
PROXY_WRAPPER_ROUNDS = 3


def proxy_wrapper_turns(parent: Path | None) -> dict:
    """``PROXY_WRAPPERS_CODE`` through each tree's package, one fresh
    process each: ``PROXY_WRAPPER_ROUNDS`` rounds of parent, this, this,
    parent (this, this without a parent); every reading of each side."""
    code = f"SHAPES = {PROXY_SHAPES!r}\n" + PROXY_WRAPPERS_CODE
    order = (PROXY_WRAPPER_ROUNDS * (("parent", parent), ("this", ROOT),
                                     ("this", ROOT), ("parent", parent))
             if parent is not None else (("this", ROOT), ("this", ROOT)))
    out = {side: [] for side, _ in order}
    for side, root in order:
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"K1/K2 wrappers in {root} failed:\n"
                               f"{proc.stderr[-3000:]}")
        out[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for key in out["this"][0]:
        print(f"[wrapper_ms {key}] "
              + ", ".join(f"{side} {[r[key] for r in rows]}"
                          for side, rows in out.items()))
    return out


#: the galaxy's proxy paths whose FPS both trees are timed at (K1 and K2
#: on every step), 3 rounds of turns: 6 pairs a path
PROXY_FPS = {
    "tpu+proxy galaxy 200k": ["-n", "200000", "-i", "500", "--im",
                              "tpu+proxy", "--nv", "--gf", "--scan"],
    "tpu+tracking --kernel proxy galaxy 200k": [
        "-n", "200000", "-i", "300", "--im", "tpu+tracking", "--kernel",
        "proxy", "--nv", "--gf", "--scan"],
}
PROXY_FPS_ROUNDS = 3


def proxy_section(parent_root: Path | None, parent, libs: dict,
                  fps: bool) -> dict:
    """K1 and K2: SASS counts and the compiler's registers and spills of
    each build's instances, ``run_proxy``, the wrappers in fresh
    processes and, against a parent, the proxy paths' FPS in turns."""
    pattern = (r"p2m_partial|p2m_reduce|l2p_kernel|p2m_runs|l2p_runs|fold|"
               r"l2p_one_run")
    res = {"sass": {}, "ptxas": {}}
    for side, lib in libs.items():
        res["sass"][side] = {sweep_label(k): v for k, v in
                             sass_counts(lib, pattern).items()}
        res["ptxas"][side] = ptxas_report(lib, pattern)
        for name, c in res["sass"][side].items():
            print(f"[K1/K2 sass {side}] {name}: {c}")
        for name, c in res["ptxas"][side].items():
            print(f"[K1/K2 ptxas {side}] {name}: {c}")
    res["kernels"] = run_proxy(parent, torch.device("cuda", 0))
    res["wrappers"] = proxy_wrapper_turns(parent_root)
    if parent_root is not None and fps:
        res["fps"] = fps_turns(parent_root, PROXY_FPS, PROXY_FPS_ROUNDS)
    return res


def run_k7_same(old, dev) -> dict:
    """K7 (csrc/fmm.cu, which holds K8's and K9's entries) from the
    parent's build and this one at every shape of ``K7_SHAPES``: the same
    bits expected, times in turns."""
    res = {}
    for m, C, subset, nf in K7_SHAPES:
        f_old = k7_this(old, m, C, subset, nf, dev)
        f_new = k7_this(cuda.library(), m, C, subset, nf, dev)
        f_old()
        f_new()
        torch.cuda.synchronize()
        big = m >= 18
        r = {"bit_for_bit": bool(torch.equal(f_old.out, f_new.out)),
             **in_turns(f_old, f_new, reps=1 if big else 5,
                        runs=3 if big else 5)}
        key = f"m={m} C={C} {subset} nf={nf}"
        res[key] = r
        print(f"[K7 parent vs this, {key}] bit for bit {r['bit_for_bit']}; "
              f"parent {r['old_ms']} ms, this {r['new_ms']} ms")
    return res


def fps_turns(parent: Path, runs: dict = FPS_RUNS,
              rounds: int = FPS_ROUNDS) -> dict:
    """FPS of each of ``runs`` (``FPS_RUNS``) through each tree's own
    package, in ``rounds`` rounds of turns (parent, this, this, parent),
    one process each."""
    res = {}
    for label, argv in runs.items():
        out = {"parent": [], "this": []}
        for side, root in rounds * (("parent", parent), ("this", ROOT),
                                        ("this", ROOT), ("parent", parent)):
            args = ["adaptive1m"] if argv is None else ["cli", *argv]
            proc = subprocess.run([sys.executable, "-c", FPS_CODE, *args],
                                  cwd=root, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{label} in {root} failed:\n"
                                   f"{proc.stderr[-3000:]}")
            out[side].append(json.loads(
                proc.stdout.strip().splitlines()[-1])["fps"])
        res[label] = out
        print(f"[FPS {label}] parent {out['parent']}, this {out['this']}")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_kernel_ab")
    p.add_argument("--parent", type=Path,
                   help="root of a tree with first designs of K10, K3, K13, "
                        "K14, K5, K6, K7, K4's passes 3, the cell runs "
                        "(K8, K9, K11, K12) or K1 and K2, or with this "
                        "tree's entries of K3, K14, K5, K6, K7 and the cell "
                        "runs")
    p.add_argument("--proxy", action="store_true",
                   help="only K1 and K2 (and, with --parent, the proxy "
                        "paths' FPS): no other kernel")
    p.add_argument("--no-scan", action="store_true",
                   help="skip the geometry scans (K3, K5/K6, K13)")
    p.add_argument("--variants", action="store_true",
                   help="time K7's compile-time variants (K7_VARIANTS) and "
                        "K4 passes 3's block geometries")
    p.add_argument("--no-fps", action="store_true",
                   help="with --parent, skip the FPS runs through both "
                        "trees")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    firsts, same = [], []
    if args.parent is not None:
        theirs = tree_signatures(args.parent)
        firsts = [k for k, v in FIRST_SIGNATURES.items()
                  if theirs.get(k) == v]
        # K4's passes 3 keeps its entry's signature: its first design is
        # told by its kernel in the tree's csrc/hybrid.cu
        if "hybrid_ext_rect_kernel" in (args.parent / "murb_tpu_torch" /
                                        "csrc" / "hybrid.cu").read_text():
            firsts.append("murb_hybrid_rect")
        same = [k for k in SAME_ENTRIES
                if theirs.get(k) == cuda._SIGNATURES[k]]
        if not firsts and not same:
            print(f"torch_kernel_ab: {args.parent} holds none of the C "
                  f"entries {sorted(FIRST_SIGNATURES)}", file=sys.stderr)
            return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    libs = {"this": cuda.build_kernels()}
    if args.proxy:
        firsts = [k for k in firsts if k in ("murb_p2m", "murb_l2p")]
        same = []
    parent = None
    if firsts or same:
        print(f"[{args.parent}] first designs {firsts}; same entries {same}")
        pcsrc = args.parent / "murb_tpu_torch" / "csrc"
        # a tree before K5 had its own source holds K5 and K6 in phi.cu
        libs["parent"] = build("ab_parent", pcsrc,
                               sorted({s for k in firsts + same
                                       for s in SOURCES[k]
                                       if (pcsrc / s).exists()}))
        parent = load(libs["parent"],
                      {**{k: FIRST_SIGNATURES.get(k, cuda._SIGNATURES[k])
                          for k in firsts},
                       **{k: cuda._SIGNATURES[k] for k in same}})
    if args.proxy:
        result = {"device": smi, "k1k2": proxy_section(
            args.parent if firsts else None, parent if firsts else None,
            libs, not args.no_fps)}
        print(json.dumps(result))
        return 0
    pattern = (r"p2p_kernel|tile_rect|mxu_|sweep_rows|phi_rows|m2l_kernel|"
               r"hybrid_ext|p2m_runs|l2p_runs")
    sass = {side: {sweep_label(k): v
                   for k, v in sass_counts(lib, pattern).items()}
            for side, lib in libs.items()}
    for side, kernels in sass.items():
        for name, c in kernels.items():
            print(f"[sass {side}] {name}: {c}")
    ptxas = ptxas_report(libs["this"],
                         r"sweep_rows_kernel|m2l_kernel|p2m_runs|l2p_runs")
    for name, c in ptxas.items():
        print(f"[ptxas this] {name}: {c}")
    result = {"device": smi, "sass": sass, "ptxas": ptxas}
    if not args.no_scan:
        result.update(k3_geometry=run_geometries(dev),
                      phi_geometry=run_phi_geometries(dev),
                      k13_geometry=run_k13_geometries(dev))
    if args.variants:
        result["k7_variants"] = run_k7_variants(dev)
        result["k4p3_geometry"] = run_k4p3_geometries(dev)
    if firsts or same:
        runs = {"murb_tile_rect": ("k3_first", lambda: run_k3(parent, dev)),
                "murb_p2p_sorted": ("k10_first", lambda: run_k10(
                    parent, cuda.library(), dev)),
                "murb_mxu_rect": ("k13_first", lambda: run_k13_first(parent,
                                                                     dev)),
                "murb_ring_pipelined": ("k14_first", lambda: run_k14_first(
                    parent, dev)),
                "murb_acc_phi_rows": ("phi_first", lambda: run_phi_first(
                    parent, dev)),
                "murb_m2l_level": ("k7_first", lambda: run_k7_parent(
                    parent, dev)),
                "murb_hybrid_rect": ("k4p3_first", lambda: run_k4p3_parent(
                    parent, dev))}
        for k in firsts:
            if k not in ("murb_phi_rows_rect", "murb_p2m", "murb_l2p",
                         *CELL_RUN_ENTRIES):
                key, run = runs[k]         # K5 runs with murb_acc_phi_rows
                result[key] = run()
        if set(CELL_RUN_ENTRIES) & set(firsts):
            result["cell_runs_first"] = run_cell_runs_parent(parent, dev)
            result["cell_run_wrappers"] = wrapper_turns(args.parent)
            if not args.no_fps:
                result["cell_run_fps"] = fps_turns(
                    args.parent, {k: FPS_RUNS[k] for k in CELL_RUN_FPS},
                    CELL_RUN_FPS_ROUNDS)
        if "murb_p2m" in firsts:
            result["k1k2_first"] = proxy_section(args.parent, parent, libs,
                                                 not args.no_fps)
        same_runs = {"murb_tile_rect": ("k3_parent", run_k3_parent),
                     "murb_ring_pipelined": ("k14_parent", run_k14_parent),
                     "murb_acc_phi_rows": ("phi_parent", run_phi_parent),
                     "murb_m2l_level": ("k7_parent", run_k7_same),
                     "murb_mxu_rect": ("k13_parent", run_k13_same),
                     "murb_p2m_grid": ("cell_runs_parent",
                                       run_cell_runs_same)}
        for k in same:
            if k in same_runs:    # K5 with K6's, K9/K11/K12 with K8's
                key, run = same_runs[k]
                result[key] = run(parent, dev)
        if "murb_acc_phi_rows" in firsts:
            result["merger_fps"] = merger_fps_turns(args.parent)
        if ({"murb_m2l_level", "murb_hybrid_rect"} & set(firsts)
                and not args.no_fps):
            result["fps"] = fps_turns(args.parent)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
