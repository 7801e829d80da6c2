"""K3's, K5's, K6's and K13's block geometries on one card; optionally
kernels against another source tree's builds of them.

    python scripts/torch_kernel_ab.py [--parent DIR]

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
  - the parent's build of an entry whose signature this checkout keeps
    (K3 at the three shapes, K14 at D = 1 and 4): both must give the same
    bits where the arithmetic is unchanged;
  - the merger's tracked steps through each tree's own package, in turns
    (subprocesses in DIR and here): ``create_engine("tpu+tracking+multi")``
    with no ``acc_fn`` (K6) and the CLI (K4 force, K5 metrics), FPS over
    49 steps after one.

Kernel times are medians of CUDA-event runs, launches only (the inputs are
packed once beforehand).  The last line is one JSON object with every
number.  Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ast
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from murb_tpu_torch.ops import cuda  # noqa: E402

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
}
#: each entry's sources (ring.cu launches tile.cu's sweep)
SOURCES = {"murb_p2p_sorted": ["p2p.cu"], "murb_tile_rect": ["tile.cu"],
           "murb_mxu_rect": ["mxu.cu"],
           "murb_ring_pipelined": ["ring.cu", "tile.cu"],
           "murb_phi_rows_rect": ["phi.cu"], "murb_acc_phi_rows": ["phi.cu"]}
#: entries compared with the parent's build when their signatures match
#: this checkout's (their arithmetic is meant to be unchanged)
SAME_ENTRIES = ("murb_tile_rect", "murb_ring_pipelined",
                "murb_phi_rows_rect", "murb_acc_phi_rows")
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


def build(name: str, csrc: Path, sources: list[str]) -> Path:
    """One shared library from ``sources`` of ``csrc`` (one nvcc each, all
    started together)."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda.find_nvcc()
    objs, procs = [], []
    for src in sources:
        obj = OUT / f"{name}.{Path(src).stem}.o"
        procs.append(subprocess.Popen(
            [nvcc, *cuda.NVCC_FLAGS, "-c", "-I", str(csrc), "-o", str(obj),
             str(csrc / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        objs.append(str(obj))
    for src, proc in zip(sources, procs):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {src} failed:\n{out[-4000:]}")
    lib = OUT / f"lib{name}.so"
    subprocess.run([nvcc, "-shared", *cuda.NVCC_FLAGS[:2], "-o", str(lib),
                    *objs], check=True, capture_output=True)
    return lib


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
    FMUL, FADD, LDS, HMMA, HMMA a MUFU.RSQ}} of the kernels in ``lib``
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
                     "HMMA": ops.get("HMMA", 0),
                     "HMMA_per_rsq": ops.get("HMMA", 0) / rsq if rsq
                     else None}
    return out


def sweep_label(name: str) -> str:
    """``sweep BI=<targets a block> BJ=<sources a tile> NR=<rows>
    force|no force`` for a mangled sweep_rows_kernel<BI, BJ, NR, kForce>
    name, else the name."""
    m = re.search(r"sweep_rows_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])",
                  name)
    if not m:
        return name
    bj = m.group(2) if m.group(2) != "0" else "run-time"
    return (f"sweep BI={m.group(1)} BJ={bj} NR={m.group(3)} "
            f"{'force' if m.group(4) == '1' else 'no force'}")


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
    """The 200k galaxy's positions and G*m, fp32 on ``dev``, and K13's
    packed operands (A, B, centred targets) of its square sweep."""
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

    def f_new(passes, out):
        call(cuda.library(), "murb_mxu_rect", a_mat.data_ptr(), gm.data_ptr(),
             n, b_mat.data_ptr(), *(c.data_ptr() for c in cqi), n, bi, bj,
             passes, slices, per, packed.data_ptr(), scratch.data_ptr(),
             *(o.data_ptr() for o in out), s)

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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_kernel_ab")
    p.add_argument("--parent", type=Path,
                   help="root of a tree with first designs of K10, K3, K13, "
                        "K14, K5 or K6, or with this tree's entries of K3, "
                        "K14, K5 and K6")
    p.add_argument("--no-scan", action="store_true",
                   help="skip the geometry scans (K3, K5/K6, K13)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    firsts, same = [], []
    if args.parent is not None:
        theirs = tree_signatures(args.parent)
        firsts = [k for k, v in FIRST_SIGNATURES.items()
                  if theirs.get(k) == v]
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
    if firsts or same:
        print(f"[{args.parent}] first designs {firsts}; same entries {same}")
        libs["parent"] = build("ab_parent",
                               args.parent / "murb_tpu_torch" / "csrc",
                               sorted({s for k in firsts + same
                                       for s in SOURCES[k]}))
    pattern = r"p2p_kernel|tile_rect|mxu_|sweep_rows|phi_rows"
    sass = {side: {sweep_label(k): v
                   for k, v in sass_counts(lib, pattern).items()}
            for side, lib in libs.items()}
    for side, kernels in sass.items():
        for name, c in kernels.items():
            print(f"[sass {side}] {name}: {c}")
    ptxas = ptxas_report(libs["this"], r"sweep_rows_kernel")
    for name, c in ptxas.items():
        print(f"[ptxas this] {name}: {c}")
    result = {"device": smi, "sass": sass, "ptxas": ptxas}
    if not args.no_scan:
        result.update(k3_geometry=run_geometries(dev),
                      phi_geometry=run_phi_geometries(dev),
                      k13_geometry=run_k13_geometries(dev))
    if firsts or same:
        parent = load(libs["parent"],
                      {**{k: FIRST_SIGNATURES[k] for k in firsts},
                       **{k: cuda._SIGNATURES[k] for k in same}})
        runs = {"murb_tile_rect": ("k3_first", lambda: run_k3(parent, dev)),
                "murb_p2p_sorted": ("k10_first", lambda: run_k10(
                    parent, cuda.library(), dev)),
                "murb_mxu_rect": ("k13_first", lambda: run_k13_first(parent,
                                                                     dev)),
                "murb_ring_pipelined": ("k14_first", lambda: run_k14_first(
                    parent, dev)),
                "murb_acc_phi_rows": ("phi_first", lambda: run_phi_first(
                    parent, dev))}
        for k in firsts:
            if k != "murb_phi_rows_rect":    # run with murb_acc_phi_rows
                key, run = runs[k]
                result[key] = run()
        same_runs = {"murb_tile_rect": ("k3_parent", run_k3_parent),
                     "murb_ring_pipelined": ("k14_parent", run_k14_parent),
                     "murb_acc_phi_rows": ("phi_parent", run_phi_parent)}
        for k in same:
            if k in same_runs:    # murb_phi_rows_rect: with K6's
                key, run = same_runs[k]
                result[key] = run(parent, dev)
        if "murb_acc_phi_rows" in firsts:
            result["merger_fps"] = merger_fps_turns(args.parent)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
