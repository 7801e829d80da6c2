"""K3's and K13's block geometries on one card; optionally K10, K3, K13
and K14 against the first designs of another source tree.

    python scripts/torch_kernel_ab.py [--parent DIR]

Without ``--parent`` (this checkout only):

  - for K3 at 128, 256 and 512 targets a block (512 sources a tile) and
    at 128x128: the blocks one SM holds at once (``ops/cuda.resident``,
    the CUDA occupancy calculator), and the kernel's time at 200,192^2
    (the N=200,000 galaxy), 16384^2 (the random box) and 8000^2 (the m=20
    node sweep) at forced j-slice counts, with the count
    ``ops/cuda.tile_split`` picks marked;
  - for K13 (the tensor-core sweep) at 200,192^2: its resident blocks, j
    slices and time through the wrapper at each tier ("high", "default")
    and a few block geometries;
  - the SASS of each K3, K10 and K13 kernel (``cuobjdump -sass``, where the
    toolkit has it): its instructions, MUFU.RSQ, FMUL and HMMA counts, and
    the instructions a MUFU.RSQ (about the instructions a pair of the
    unrolled sweep; K13's HMMA a MUFU.RSQ is its tensor products a pair of
    a thread, each covering 4 of the thread's pairs).

With ``--parent DIR``, DIR the root of a tree that holds first designs (its
C entries are checked against DIR's ``ops/cuda.py``, kernel by kernel; the
script refuses a tree that holds none), also DIR's sources of those
kernels built into a library of their own with the flags of ops/cuda.py,
and for each first design found:

  - K10 (one target a thread, every body pair masked) on the 1M
    two-cluster box (murb_tpu's bench row ``adaptive_two_clusters_1m``,
    the plan ``create_engine`` picks, as chip_smoke.py phase 9 builds it):
    the C entries of both trees on the same inputs, nf 3 and 4, whether
    the sums agree bit for bit, and the kernel times in turns (DIR, this,
    this, DIR); this checkout's K10 also with the target bricks launched
    in brick order instead of the longest rows first;
  - K3 (one target a thread) at the three shapes: both trees in turns, and
    whether the sums agree bit for bit (this checkout splits j below the
    card's fill, so they then differ by rounding);
  - K13 (fp32 on the CUDA cores) at 200,192^2 on the galaxy's packed
    operands: both in turns, this checkout at "high" and "default", and
    their largest difference over max|a|;
  - K14 (its own copy of the first sweep) at D = 1 to 4 shards of the 200k
    galaxy on this card: both in turns, and their largest difference.

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
}
FIRST_SOURCES = {"murb_p2p_sorted": "p2p.cu", "murb_tile_rect": "tile.cu",
                 "murb_mxu_rect": "mxu.cu", "murb_ring_pipelined": "ring.cu"}
OUT = cuda.BUILD_DIR / "kernel_ab"
SOFT2 = ctypes.c_float(2.0e8 ** 2)


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
    """One shared library from ``sources`` of ``csrc``."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda.find_nvcc()
    objs = []
    for src in sources:
        obj = OUT / f"{name}.{Path(src).stem}.o"
        subprocess.run([nvcc, *cuda.NVCC_FLAGS, "-c", "-I", str(csrc), "-o",
                        str(obj), str(csrc / src)], check=True,
                       capture_output=True)
        objs.append(str(obj))
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
                   help="root of a tree with first designs of K10, K3, K13 "
                        "or K14")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    firsts = []
    if args.parent is not None:
        theirs = tree_signatures(args.parent)
        firsts = [k for k, v in FIRST_SIGNATURES.items()
                  if theirs.get(k) == v]
        if not firsts:
            print(f"torch_kernel_ab: {args.parent} holds none of the first "
                  f"designs' C entries {sorted(FIRST_SIGNATURES)}",
                  file=sys.stderr)
            return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    libs = {"this": cuda.build_kernels()}
    if firsts:
        print(f"[first designs in {args.parent}] {firsts}")
        libs["first"] = build("ab_first",
                              args.parent / "murb_tpu_torch" / "csrc",
                              [FIRST_SOURCES[k] for k in firsts])
    sass = {side: sass_counts(lib, r"p2p_kernel|tile_rect|mxu_")
            for side, lib in libs.items()}
    for side, kernels in sass.items():
        for name, c in kernels.items():
            print(f"[sass {side}] {name}: {c}")
    result = {"device": smi, "sass": sass, "k3_geometry": run_geometries(dev),
              "k13_geometry": run_k13_geometries(dev)}
    if firsts:
        first = load(libs["first"], {k: FIRST_SIGNATURES[k] for k in firsts})
        runs = {"murb_tile_rect": ("k3_first", lambda: run_k3(first, dev)),
                "murb_p2p_sorted": ("k10_first", lambda: run_k10(
                    first, cuda.library(), dev)),
                "murb_mxu_rect": ("k13_first", lambda: run_k13_first(first,
                                                                     dev)),
                "murb_ring_pipelined": ("k14_first", lambda: run_k14_first(
                    first, dev))}
        for k in firsts:
            key, run = runs[k]
            result[key] = run()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
