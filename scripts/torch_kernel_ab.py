"""K3's block geometries and j splits on one card; optionally K10 and K3
against the first designs of another source tree.

    python scripts/torch_kernel_ab.py [--parent DIR]

Without ``--parent`` (this checkout only):

  - for K3 at 128, 256 and 512 targets a block (512 sources a tile) and
    at 128x128: the blocks one SM holds at once (``ops/cuda.tile_resident``,
    the CUDA occupancy calculator), and the kernel's time at 200,192^2
    (the N=200,000 galaxy), 16384^2 (the random box) and 8000^2 (the m=20
    node sweep) at forced j-slice counts, with the count
    ``ops/cuda.tile_split`` picks marked;
  - the SASS of each K3 and K10 kernel (``cuobjdump -sass``, where the
    toolkit has it): its instructions and MUFU.RSQ count, whose ratio is
    about the instructions a pair of the unrolled sweep.

With ``--parent DIR``, DIR the root of a tree whose K10 and K3 are the
first designs (one target a thread, every body pair masked; their C entries
are checked against DIR's ``ops/cuda.py`` first, and the script refuses any
other tree), also: DIR's ``p2p.cu`` and ``tile.cu`` built into a library of
their own with the flags of ops/cuda.py, and

  - K10 on the 1M two-cluster box (murb_tpu's bench row
    ``adaptive_two_clusters_1m``, the plan ``create_engine`` picks, as
    chip_smoke.py phase 9 builds it): the C entries of both trees on the
    same inputs, nf 3 and 4, whether the sums agree bit for bit, and the
    kernel times in turns (DIR, this, this, DIR); this checkout's K10 also
    with the target bricks launched in brick order instead of the longest
    rows first;
  - K3 at the three shapes: both trees in turns, and whether the sums agree
    bit for bit (this checkout splits j below the card's fill, so they then
    differ by rounding).

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
#: the C entries of the first designs of K10 and K3, as this script calls
#: them with --parent
FIRST_SIGNATURES = {
    "murb_p2p_sorted": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _L, _F, _I,
                        _P, _P],
    "murb_tile_rect": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _I, _P,
                       _P, _P, _P],
}
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
    """{kernel: {instructions, MUFU.RSQ, instructions a MUFU.RSQ}} of the
    kernels in ``lib`` whose name matches ``pattern`` (cuobjdump)."""
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
                     "FADD": ops.get("FADD", 0), "LDS": ops.get("LDS", 0)}
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
    res = {"resident": {f"{bi}x{bj}": cuda.tile_resident(dev, bi, bj)
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_kernel_ab")
    p.add_argument("--parent", type=Path,
                   help="root of a tree with the first designs of K10, K3")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    if args.parent is not None:
        theirs = tree_signatures(args.parent)
        if any(theirs.get(k) != v for k, v in FIRST_SIGNATURES.items()):
            print(f"torch_kernel_ab: {args.parent} does not hold the first "
                  f"designs' C entries {sorted(FIRST_SIGNATURES)}",
                  file=sys.stderr)
            return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    libs = {"this": cuda.build_kernels()}
    if args.parent is not None:
        libs["first"] = build("ab_first",
                              args.parent / "murb_tpu_torch" / "csrc",
                              ["p2p.cu", "tile.cu"])
    sass = {side: sass_counts(lib, r"p2p_kernel|tile_rect")
            for side, lib in libs.items()}
    for side, kernels in sass.items():
        for name, c in kernels.items():
            print(f"[sass {side}] {name}: {c}")
    result = {"device": smi, "sass": sass, "k3_geometry": run_geometries(dev)}
    if args.parent is not None:
        first = load(libs["first"], FIRST_SIGNATURES)
        result["k3_first"] = run_k3(first, dev)
        result["k10_first"] = run_k10(first, cuda.library(), dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
