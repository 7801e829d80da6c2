#!/usr/bin/env python3
"""Smoke test of murb_tpu_torch on one CUDA card: the quickest proof that
the port builds, agrees with its plain versions and runs its main path.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. environment: torch, CUDA, the card, nvidia-smi's name and power limit,
     whether nvcc and triton are present;
  2. build: compile the CUDA kernels from murb_tpu_torch/csrc;
  3. kernel parity: each kernel against its plain PyTorch version (run in
     float64) at main-path shapes, with the max error and both times;
  4. the main path: ``tpu+proxy`` on the N=200,000 galaxy through the CLI
     (``murb_tpu_torch.cli.run``, whose exit code ``cli.main`` returns),
     plus a small CPU-vs-card trajectory check;
  5. K3 on the path: one ``acc_proxy`` at m=20 (8000 nodes) on that state;
  6. K4 on the path: ``--im tpu+hybrid`` (passes 2, which runs K3's
     kernel) and ``--im tpu+hybrid+x3`` (passes 3, K4's own kernel) at
     N=30,000 through the CLI;
  7. the tracked paths at full width: ``tpu+tracking`` and
     ``tpu+leapfrog+tracking --kernel proxy`` on the N=200,000 galaxy
     through the CLI (the fused proxy: K1 and K2; the energy of row 0 held
     to an exact K6 energy of the same state), and the Milky Way-Andromeda
     merger (81,920 bodies, made by scripts/make_two_galaxy_tab.py) with
     ``tpu+tracking+multi`` through the CLI (K4 force, K5 metrics) and
     through ``create_engine`` with no ``acc_fn`` (K6), beside the
     untracked exact engine on the same state; then, at N=2048, each
     tracked and integrator engine on the card against the CPU plain path;
  8. the multi-level hierarchy on the N=200,000 random box: K7 (nf 3 and
     4), K8 and K9 (k 3 and 4) against their plain versions in float64 at
     the main-path shape (m=8, C=4) and a deeper one (m=6, C=8, with the
     near sweep); ``tpu+proxy -s random`` through the CLI (the auto policy
     picks the hierarchy and validates it); ``tpu+tracking --kernel fmm``
     through the CLI (the fused hierarchy, row 0's energy held to an exact
     K6 energy); one ``acc_proxy(cells=2)`` on the 200k galaxy (K8/K9 at
     C=2); and an N=2048 card-against-CPU check of ``levels=2, m=8``;
  9. the adaptive sparse hierarchy: ``tpu+proxy`` on murb_tpu's bench box
     ``adaptive_two_clusters_1m`` (N=1,048,576, two Gaussian clusters, soft
     0.02, dt 1e-6) through ``create_engine`` with the auto policy, which
     must take the adaptive solver and validate it, beside the exact
     ``tpu+hybrid`` on the same state; K10 (nf 3 and 4, and under a pair
     capacity below the candidate count), K11 and K12 (nf 3 and 4) against
     their plain versions in float64 on that state's own sorted bodies,
     slots and fields; the dense hierarchy with K10 as its near field
     (``acc_fmm(near="p2p")``); the merger through the CLI with ``--near
     adaptive`` and with ``tpu+tracking --kernel adaptive`` (row 0's energy
     held to an exact K6 energy); an N=4096 card-against-CPU check of the
     adaptive step; and the repair (K7-K9 at m=18 and m=32);
 10. the exact large-N path: K13 against its plain version in float64 (a
     4096-row strided sample of the N=200,000 galaxy against all of it,
     and the 16384^2 galaxy) at every block pair it is compiled for;
     ``tpu+mxu`` on the N=200,000 galaxy through the CLI (its force error
     after 10 steps held to 5e-4) and ``tpu+tracking --kernel mxu`` (row
     0's energy held to the exact K6 energy); ``--autotune`` for tpu+mxu
     at 200k and tpu+hybrid at 16384 and 200k under a temporary cache,
     each candidate's time printed and a second run reading the winner
     without a sweep; ``--save-state`` after 10 steps and ``--load-state``
     for 10 more against 20 straight (bit for bit); ``--dump-traj
     --dump-every 5`` read back;
 11. the distributed modes, with shards on this one card (an explicit
     device list: the protocol is checked, not a link): K14 against its
     plain version in float64 on the 200k galaxy at D = 1 to 4 shards, with
     and without a sleep before every copy and compute; ``--im shard+ring
     --shards 1`` through the CLI (its force error after 10 steps held to
     5e-4); ``shard+ring`` on 4 shards against ``tpu+tile`` (accelerations,
     positions after 10 steps, FPS) and its sharded checkpoint round trip
     (bit for bit); ``shard+allgather`` and ``shard+uneven`` (0.6) on 4
     shards against ``tpu+hybrid``; ``shard+proxy`` on the galaxy (K1/K2)
     and on the random box (promoted to the hierarchy at phase 8's (m, L):
     K7-K9); ``shard+adaptive`` on the 1M two-cluster box (1 shard) and the
     merger (2 shards): K10-K12, health ok.
Each piece of the path (the CLI run of phase 4, the ``acc_proxy`` of phase
5, each CLI run of phase 6, each run of phases 7 to 11) starts from zeroed
launch counts, which are read right after it: K1 and K2 from phase 4, K3
from phase 5, K4 from phase 6, K5 and K6 from phase 7, K7 to K9 from the
``tpu+proxy -s random`` run of phase 8, K10 to K12 from the two-cluster
run of phase 9, K13 from the ``tpu+mxu`` run of phase 10, K14 from the
4-shard ``shard+ring`` run of phase 11.  Every kernel must have launched in
its piece.  The line before the last is the kernels' JSON
record (with each kernel's bound: the larger of its bytes over 3.35 TB/s
and its operations over the 67 TFLOP/s fp32 peak of an H100 SXM); the last
line is the result object.

Needs a CUDA device and the rest of the repository beside this file; it
exits non-zero without printing a result otherwise.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 123
SOFT = 2.0e8
DT = 3600.0
TOL = 1e-4
ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, fp32 FLOP/s
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes moved once over the
    memory rate, or operations over the fp32 rate, whichever is larger."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from murb_tpu_torch import G
    from murb_tpu_torch import cli
    from murb_tpu_torch.models import create_engine
    from murb_tpu_torch.core.init import (init_galaxy,
                                          init_milkyway_andromeda,
                                          init_random,
                                          milkyway_andromeda_masks)
    from murb_tpu_torch.core.metrics import energy_from_phi
    from murb_tpu_torch.ops import cuda
    from murb_tpu_torch.ops import fmm_kernels as fk
    from murb_tpu_torch.ops.anterp_kernels import l2p_window, p2m_window
    from murb_tpu_torch.ops.hybrid import (acc_hybrid_rect,
                                           acc_hybrid_rect_plain,
                                           acc_phi_rows_hybrid,
                                           acc_phi_rows_plain, phi_rows,
                                           phi_rows_rect,
                                           phi_rows_rect_plain)
    from murb_tpu_torch.ops.proxy import acc_proxy, bounding_box, heavy_split
    from murb_tpu_torch.ops.p2p_kernels import p2p_sweep_kernel_sorted
    from murb_tpu_torch.ops.proxy_kernels import (l2p_fused_multi, l2p_plain,
                                                  p2m_fused, p2m_plain)
    from murb_tpu_torch.ops.tile import acc_tile_rect, acc_tile_rect_plain
    from murb_tpu_torch.ops.validate import measured_force_error

    # The plain versions' matrix products run in full fp32, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(dev)

    # ---------------------------------------------------- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if os.path.exists(
            "/usr/local/cuda/bin/nvcc") else "absent")
    print(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name!r} count {torch.cuda.device_count()} nvcc {nvcc} "
          f"triton {triton_v}")
    print(smi)

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib_path = cuda.build_kernels()
    cuda.library()
    print(f"[2 build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line or "Used" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                print(f"[2 ptxas] {line.strip()}")

    def time_ms(fn, reps: int = 10, runs: int = 5) -> float:
        """Median over ``runs`` of the mean time of ``reps`` launches."""
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

    def norm_rel(got, ref) -> float:
        """Max per-body force error over max(|a_ref|, 1e-6 max |a_ref|)
        (the ops/validate statistic)."""
        g = torch.stack([v.double() for v in got], 1)
        r = torch.stack([v.double() for v in ref], 1)
        rn = r.norm(dim=1)
        floor = torch.clamp(rn, min=1e-6 * float(rn.max()))
        return float(((g - r).norm(dim=1) / floor).max())

    def within_rel(got, ref, eps: float, rms_floor: float) -> float:
        """Catch2 WithinRel with an rms floor (tests/conftest.py); returns
        the largest ratio of |a - b| to its allowance (<= 1 passes)."""
        worst = 0.0
        for g, r in zip(got, ref):
            g, r = g.double(), r.double()
            allow = (eps * torch.maximum(g.abs(), r.abs())
                     + rms_floor * float(r.pow(2).mean().sqrt()) + 1e-300)
            worst = max(worst, float(((g - r).abs() / allow).max()))
        return worst

    record = {}

    def keep(k, err, ms, plain_ms, nbytes, flops):
        b_ms, b_by = bound(nbytes, flops)
        # no single PyTorch call computes any of these kernels' functions
        record[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        return b_ms

    # ------------------------------------------------- 3. kernel parity
    n_main = 200_000
    st = init_galaxy(n_main, SEED, device=dev)
    gm = st.m * torch.tensor(G, dtype=torch.float32).item()
    c, h = bounding_box(st.qx, st.qy, st.qz, gm > 0)
    mean_gm = gm.sum() / (gm > 0).sum()
    gm_eff = heavy_split(st.qx, st.qy, st.qz, gm, 1, 100.0, mean_gm)[4]
    q64 = [v.double() for v in (st.qx, st.qy, st.qz)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for m in (12, 20):
        w = p2m_fused(st.qx, st.qy, st.qz, gm_eff, c, h, m=m)
        w64 = p2m_plain(*q64, gm_eff.double(), c.double(), h.double(), m=m)
        err_w = float((w.double() - w64).abs().max())
        scale_w = float(w64.abs().max())
        check(bool(torch.allclose(w.double(), w64, rtol=1e-4,
                                  atol=1e-6 * scale_w)),
              f"K1 m={m}: max|dW| {err_w:.3e} vs rtol 1e-4, atol "
              f"1e-6*max|W| ({1e-6 * scale_w:.3e})")
        ms = time_ms(lambda: p2m_fused(st.qx, st.qy, st.qz, gm_eff, c, h,
                                       m=m))
        plain_ms = time_ms(lambda: p2m_plain(st.qx, st.qy, st.qz, gm_eff, c,
                                             h, m=m))
        print(f"[3 K1 p2m m={m} N={n_main}] max|dW| {err_w:.3e} "
              f"(max|W| {scale_w:.3e}, tol rtol 1e-4 + 1e-6*max|W|) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if m == 12:
            # per body: the contraction (2 m^3) and three bases (~6 m^2)
            keep("K1", err_w, ms, plain_ms, 16 * n_main + 4 * m ** 3,
                 n_main * (2 * m ** 3 + 6 * m ** 2))

        # k=3: the force; 4: force + potential (tpu+tracking); 5: force + 2
        # galaxy potentials (the kernel runs groups of at most 4 fields)
        for k in ((3, 4, 5) if m == 12 else (3,)):
            fields = tuple(torch.randn(m ** 3, generator=gen, device=dev)
                           for _ in range(k))
            a = torch.stack(l2p_fused_multi(st.qx, st.qy, st.qz, c, h,
                                            fields, m=m))
            a64 = torch.stack(l2p_plain(*q64, c.double(), h.double(),
                                        tuple(f.double() for f in fields),
                                        m=m))
            err_a = float((a.double() - a64).abs().max())
            scale_a = float(a64.abs().max())
            check(bool(torch.allclose(a.double(), a64, rtol=1e-4,
                                      atol=1e-5 * scale_a)),
                  f"K2 m={m} k={k}: max|da| {err_a:.3e} vs rtol 1e-4, atol "
                  f"1e-5*max|a| ({1e-5 * scale_a:.3e})")
            ms = time_ms(lambda: l2p_fused_multi(st.qx, st.qy, st.qz, c, h,
                                                 fields, m=m))
            plain_ms = time_ms(lambda: l2p_plain(st.qx, st.qy, st.qz, c, h,
                                                 fields, m=m))
            b_ms, _ = bound(12 * n_main + 4 * k * (m ** 3 + n_main),
                            n_main * (2 * k * m ** 3 + 6 * m ** 2))
            print(f"[3 K2 l2p m={m} N={n_main} k={k}] max|da| {err_a:.3e} "
                  f"(max|a| {scale_a:.3e}, tol rtol 1e-4 + 1e-5*max|a|) "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"bound {b_ms:.4f} ms")
            if (m, k) == (12, 3):
                keep("K2", err_a, ms, plain_ms,
                     12 * n_main + 4 * k * (m ** 3 + n_main),
                     n_main * (2 * k * m ** 3 + 6 * m ** 2))

    sr = init_random(16_300, SEED, device=dev)      # npad 16384, 84 ghosts
    gr = sr.m * torch.tensor(G, dtype=torch.float32).item()
    jset = (sr.qx, sr.qy, sr.qz, gr)
    j64 = tuple(v.double() for v in jset)
    for label, ni in (("square 16384x16384", sr.npad),
                      ("rect 5000x16384", 5000)):
        iset = (sr.qx[:ni], sr.qy[:ni], sr.qz[:ni])
        got = acc_tile_rect(*iset, *jset, SOFT)
        ref = acc_tile_rect_plain(*(v.double() for v in iset), *j64, SOFT)
        worst = within_rel(got, ref, 5e-6, 5e-6)
        err = max(float((g.double() - r).abs().max())
                  for g, r in zip(got, ref))
        check(worst <= 1.0, f"K3 {label}: WithinRel 5e-6 (rms floor 5e-6) "
                            f"exceeded by {worst:.2f}x")
        ms = time_ms(lambda: acc_tile_rect(*iset, *jset, SOFT))
        plain_ms = time_ms(lambda: acc_tile_rect_plain(*iset, *jset, SOFT),
                           reps=3)
        print(f"[3 K3 tile {label}] max|da| {err:.3e} WithinRel 5e-6 "
              f"(rms floor 5e-6) at {worst:.3f} of the allowance; "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if ni == sr.npad:
            # 20 flops a pair: the reference's model
            keep("K3", err, ms, plain_ms, 40 * ni, 20 * ni * ni)

    # passes 1/2 run K3's fp32 kernel; passes 3 is K4's own fp64-accumulating
    # kernel.  On this input the fp32 tier already reads under 1e-6, so the
    # passes-3 limit sits below the fp32 tier's reading, and passes 3 must
    # also at least halve the passes-2 error: a passes-3 launch that ran the
    # fp32 code fails both.
    ref = acc_tile_rect_plain(*j64[:3], *j64, SOFT)
    rels = {}
    for passes, contract in ((1, 3e-5), (2, 3e-5), (3, 4e-7)):
        got = acc_hybrid_rect(*jset[:3], *jset, SOFT, passes=passes)
        rel = rels[passes] = norm_rel(got, ref)
        err = max(float((g.double() - r).abs().max())
                  for g, r in zip(got, ref))
        check(rel <= contract, f"K4 passes={passes}: max relative force "
                               f"error {rel:.3e} > {contract:g}")
        ms = time_ms(lambda: acc_hybrid_rect(*jset[:3], *jset, SOFT,
                                             passes=passes))
        plain_ms = time_ms(lambda: acc_hybrid_rect_plain(
            *jset[:3], *jset, SOFT, passes=passes), reps=3)
        print(f"[3 K4 hybrid passes={passes} N=16384] max rel force err "
              f"{rel:.3e} (contract {contract:g}) max|da| {err:.3e}; "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if passes == 3:
            keep("K4", err, ms, plain_ms, 40 * sr.npad, 20 * sr.npad ** 2)
    check(rels[3] <= 0.5 * rels[2], f"K4 passes=3 error {rels[3]:.3e} is not "
                                    f"at most half of passes=2's "
                                    f"{rels[2]:.3e}")
    del st, sr, w64, a64, ref

    # K5 and K6 at the merger's shape, 81,920^2 with R = 2 galaxy rows.  The
    # float64 reference takes 4096 strided i-rows against every source (as
    # ops/validate samples); the plain versions are timed at the full shape.
    # Contracts: phi within 1e-5 relative per element, the force within
    # K4 passes 2's 3e-5.
    tmpdir = tempfile.TemporaryDirectory()      # removed at exit
    tab = os.path.join(tmpdir.name, "milkyway_andromeda.tab")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                 "make_two_galaxy_tab.py"),
                    tab], check=True, capture_output=True, timeout=300)
    mg = init_milkyway_andromeda(tab, device=dev)
    print(f"[3 merger] {mg.n} bodies from scripts/make_two_galaxy_tab.py in "
          f"{time.perf_counter() - t0:.1f} s")
    masks = milkyway_andromeda_masks(mg.npad, mg.n)
    gmg = mg.m * torch.tensor(G, dtype=torch.float32).item()
    rows = torch.stack([torch.as_tensor(mk, device=dev) for mk in masks]) \
        * gmg[None, :]
    qm = (mg.qx, mg.qy, mg.qz)
    nm, r = mg.npad, rows.shape[0]
    idx = torch.linspace(0, nm - 1, 4096, device=dev).long()
    qm64 = tuple(v.double() for v in qm)
    qs64 = tuple(v[idx] for v in qm64)
    ref_phi = phi_rows_rect_plain(*qs64, *qm64, rows.double(), SOFT)

    def phi_err(phi):
        d = phi[:, idx].double() - ref_phi
        return float(d.abs().max()), float((d.abs() / ref_phi.abs()).max())

    phi = phi_rows(*qm, rows, SOFT)
    err5, rel5 = phi_err(phi)
    check(rel5 <= 1e-5, f"K5: max relative phi error {rel5:.3e} > 1e-5")
    ms = time_ms(lambda: phi_rows(*qm, rows, SOFT), reps=5)
    plain_ms = time_ms(lambda: phi_rows_rect_plain(*qm, *qm, rows, SOFT),
                       reps=1, runs=3)
    b5 = keep("K5", err5, ms, plain_ms, (24 + 8 * r) * nm,
              (10 + 2 * r) * nm * nm)
    print(f"[3 K5 phi_rows {nm}x{nm} R={r}] max rel phi err {rel5:.3e} "
          f"(contract 1e-5) max|dphi| {err5:.3e}; kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms bound {b5:.4f} ms")

    acc6, phi6 = acc_phi_rows_hybrid(*qm, gmg, rows, SOFT)
    ref_acc = acc_tile_rect_plain(*qs64, *qm64, gmg.double(), SOFT)
    rel6 = norm_rel([a[idx] for a in acc6], ref_acc)
    err6, prel6 = phi_err(phi6)
    check(rel6 <= 3e-5, f"K6: max relative force error {rel6:.3e} > 3e-5")
    check(prel6 <= 1e-5, f"K6: max relative phi error {prel6:.3e} > 1e-5")
    erra6 = max(float((a[idx].double() - b).abs().max())
                for a, b in zip(acc6, ref_acc))
    ms = time_ms(lambda: acc_phi_rows_hybrid(*qm, gmg, rows, SOFT), reps=5)
    plain_ms = time_ms(lambda: acc_phi_rows_plain(*qm, gmg, rows, SOFT),
                       reps=1, runs=3)
    b6 = keep("K6", erra6, ms, plain_ms, (28 + 8 * r) * nm,
              (20 + 2 * r) * nm * nm)
    print(f"[3 K6 acc_phi_rows {nm}x{nm} R={r}] max rel force err "
          f"{rel6:.3e} (contract 3e-5) max|da| {erra6:.3e}; max rel phi "
          f"err {prel6:.3e} (contract 1e-5) max|dphi| {err6:.3e}; kernel "
          f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {b6:.4f} ms")
    del ref_phi, ref_acc, acc6, phi6, phi
    torch.cuda.empty_cache()

    # ------------------------------------------------- 4. the main path
    wrappers = {"K1": p2m_fused, "K2": l2p_fused_multi, "K3": acc_tile_rect,
                "K4": acc_hybrid_rect, "K5": phi_rows_rect,
                "K6": acc_phi_rows_hybrid, "K7": fk.m2l_level_fused,
                "K8": fk.p2m_grid_fused, "K9": fk.l2p_grid_fused,
                "K10": p2p_sweep_kernel_sorted, "K11": p2m_window,
                "K12": l2p_window}

    def drive(run):
        """Zero every launch count, run one piece of the path, and return
        its result with the counts it left."""
        for fn in wrappers.values():
            fn.launches = 0
        out = run()
        return out, {k: fn.launches for k, fn in wrappers.items()}

    res, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "100", "--im", "tpu+proxy", "--nv", "--gf",
        "--scan", "--device", "cuda"]))
    check(res.rc == 0, f"cli exit code {res.rc}")
    eng = res.engine
    eng.assert_finite()
    launches = {k: counts[k] for k in ("K1", "K2")}
    check(eng.using_proxy, "tpu+proxy fell back to the exact sweep")
    check(eng.validated_err is not None and eng.validated_err <= TOL,
          f"validated error {eng.validated_err} > {TOL}")
    fin = eng.bodies
    gm_fin = eng._gm(fin)
    err_end = measured_force_error(
        fin.qx, fin.qy, fin.qz, gm_fin, SOFT,
        lambda a, b, cc, g: acc_proxy(a, b, cc, g, SOFT, m=eng.m))
    print(f"[4 main] tpu+proxy N={n_main} galaxy: m={eng.m} "
          f"cells={eng.cells} validated_err {eng.validated_err:.3e} "
          f"(err after 100 steps {err_end:.3e}, reported, not a contract); "
          f"{res.fps:.2f} FPS "
          f"{res.gflops:.1f} ref-GFlop/s ({res.elapsed_ms:.2f} ms for 99 "
          f"steps) on {smi}; launches {counts}")

    # small input: the card's trajectory agrees with the CPU plain path
    small = init_galaxy(2048, SEED, device="cpu")
    runs = []
    for d in ("cpu", dev):
        e = create_engine("tpu+proxy", small.to(d), soft=SOFT, dt=3600.0)
        e.run(3)
        runs.append((e.m, e.bodies.unpadded()))
    check(runs[0][0] == runs[1][0], f"m differs: cpu {runs[0][0]} "
                                    f"card {runs[1][0]}")
    worst = max(float(np.max(np.abs(runs[1][1][k] - runs[0][1][k])
                             / np.maximum(np.abs(runs[0][1][k]), 1e-30)))
                for k in ("qx", "qy", "qz"))
    check(worst <= 1e-4, f"card vs cpu positions differ by {worst:.3e}")
    print(f"[4 small] N=2048 galaxy, 3 steps: card vs CPU plain path "
          f"positions max rel diff {worst:.3e} (tol 1e-4), m={runs[0][0]}")

    # ------------------------------------------- 5. K3 inside acc_proxy
    err20, counts = drive(lambda: measured_force_error(
        fin.qx, fin.qy, fin.qz, gm_fin, SOFT,
        lambda a, b, cc, g: acc_proxy(a, b, cc, g, SOFT, m=20)))
    launches["K3"] = counts["K3"]
    check(err20 <= TOL, f"acc_proxy m=20 force error {err20:.3e} > {TOL}")
    print(f"[5 K3 path] acc_proxy m=20 (8000 nodes) force error {err20:.3e}; "
          f"launches {counts}")

    # ------------------------------------------- 6. K4 through the CLI
    # fp32 state takes passes 2 (K3's kernel, launched by K4's wrapper);
    # tpu+hybrid+x3 takes passes 3, K4's own kernel, whose count is kept.
    for tag in ("tpu+hybrid", "tpu+hybrid+x3"):
        res6, counts = drive(lambda: cli.run([
            "-n", "30000", "-i", "10", "--im", tag, "--nv", "--gf",
            "--device", "cuda"]))
        check(res6.rc == 0, f"cli {tag} exit code {res6.rc}")
        res6.engine.assert_finite()
        check(counts["K4"] > 0, f"K4 launched no time under {tag}")
        print(f"[6 K4 path] {tag} N=30000 (passes {res6.engine.passes}): "
              f"{res6.fps:.2f} FPS {res6.gflops:.1f} ref-GFlop/s on {smi}; "
              f"launches {counts}")
    launches["K4"] = counts["K4"]

    # ------------------------------------- 7. the tracked paths, full width
    # The energy of row 0 (the initial state) is held to the exact energy of
    # the same state from one K6 sweep (R = 1, the total G*m row) at rtol
    # 1e-3, the tolerance murb_tpu holds proxy energies to
    # (tests/test_multigalaxy.py:160-173).
    st0 = init_galaxy(n_main, SEED, device=dev)
    gm0 = st0.m * torch.tensor(G, dtype=torch.float32).item()
    e_exact = float(energy_from_phi(
        st0, acc_phi_rows_hybrid(st0.qx, st0.qy, st0.qz, gm0, gm0[None, :],
                                 SOFT)[1][0], SOFT))
    del st0, gm0

    def rows_finite(hist, n_rows, csv):
        check(hist.num_iterations == n_rows and all(
            bool(np.isfinite(getattr(hist, k)).all())
            for k in ("energies", "ang_momentums", "density_centers")),
            f"{n_rows} finite history rows")
        with open(csv) as f:
            lines = f.read().splitlines()
        check(len(lines) == n_rows + 1, f"{csv}: {len(lines) - 1} rows, "
                                        f"expected {n_rows}")

    fps = {"tpu+proxy": res.fps}
    for tag in ("tpu+tracking", "tpu+leapfrog+tracking"):
        csv = os.path.join(tmpdir.name, f"{tag}.csv")
        res7, counts = drive(lambda: cli.run([
            "-n", str(n_main), "-i", "100", "--im", tag, "--kernel", "proxy",
            "--nv", "--gf", "--scan", "--csv", csv, "--device", "cuda"]))
        check(res7.rc == 0, f"cli {tag} exit code {res7.rc}")
        eng7 = res7.engine
        eng7.assert_finite()
        check(eng7._fused_proxy_m > 0, f"{tag} did not take the fused proxy")
        check(counts["K1"] > 0 and counts["K2"] > 0,
              f"K1/K2 launched no time under {tag}: {counts}")
        rows_finite(eng7.history, 100, csv)
        e0 = float(eng7.history.energies[0])
        rel = abs(e0 / e_exact - 1.0)
        check(rel <= 1e-3, f"{tag} energy row 0 {e0:.6e} vs exact "
                           f"{e_exact:.6e}: rel {rel:.3e} > 1e-3")
        fps[tag] = res7.fps
        print(f"[7 tracked] {tag} --kernel proxy N={n_main}: m="
              f"{eng7._fused_proxy_m}, energy row 0 {e0:.9e} vs exact K6 "
              f"{e_exact:.9e} (rel {rel:.3e}, tol 1e-3); {res7.fps:.2f} FPS "
              f"vs tpu+proxy {res.fps:.2f} FPS in this run; launches {counts}")

    def galaxies_sum(hist, label):
        for k in ("energies", "ang_momentums", "density_centers"):
            total = sum(getattr(g, k) for g in hist.galaxies)
            check(bool(np.allclose(getattr(hist, k), total, rtol=1e-12,
                                   atol=0)),
                  f"{label}: global {k} is not the sum of the galaxies'")

    # the merger through the CLI: default --kernel (K4 force), K5 metrics
    csv = os.path.join(tmpdir.name, "merger.csv")
    res7, counts = drive(lambda: cli.run([
        "-n", str(mg.n), "-i", "50", "--im", "tpu+tracking+multi", "-s",
        "milkyway_andromeda", "--scheme-file", tab, "--nv", "--gf", "--scan",
        "--csv", csv, "--device", "cuda"]))
    check(res7.rc == 0, f"cli tpu+tracking+multi exit code {res7.rc}")
    res7.engine.assert_finite()
    launches["K5"] = counts["K5"]
    check(counts["K4"] > 0, f"K4 launched no time on the merger: {counts}")
    hist_cli = res7.engine.history
    rows_finite(hist_cli, 50, csv)
    galaxies_sum(hist_cli, "merger (CLI)")
    fps["merger tracked (K4 + K5)"] = res7.fps
    print(f"[7 merger] tpu+tracking+multi N={mg.n} through the CLI: "
          f"{res7.fps:.2f} FPS; launches {counts}")

    def timed(engine, n_steps):
        """Steps per second of ``run`` after one warm-up step."""
        engine.run(1)
        engine.block_until_ready()
        t0 = time.perf_counter()
        engine.run(n_steps - 1)
        engine.block_until_ready()
        return engine, (n_steps - 1) / (time.perf_counter() - t0)

    (eng7, fps_k6), counts = drive(lambda: timed(create_engine(
        "tpu+tracking+multi", mg, soft=SOFT, dt=DT, num_iterations=50,
        masks=masks), 50))
    launches["K6"] = counts["K6"]
    eng7.assert_finite()
    check(eng7._use_fused_exact(), "the merger engine did not fuse")
    hist = eng7.finalize_history()
    galaxies_sum(hist, "merger (create_engine)")
    check(all(bool(np.isfinite(getattr(hist, k)).all())
              for k in ("energies", "ang_momentums", "density_centers")),
          "finite merger history")
    d_e = float(np.max(np.abs(hist.energies / hist_cli.energies - 1.0)))
    check(d_e <= 1e-4, f"merger energies: K6 path vs K4+K5 path differ by "
                       f"{d_e:.3e} > 1e-4")
    (_, fps_exact), _ = drive(lambda: timed(create_engine(
        "tpu+hybrid", mg, soft=SOFT, dt=DT), 50))
    fps["merger tracked (K6)"] = fps_k6
    fps["merger untracked (tpu+hybrid)"] = fps_exact
    print(f"[7 merger] create_engine tpu+tracking+multi (no acc_fn, K6) "
          f"{fps_k6:.2f} FPS, untracked tpu+hybrid (passes 2) "
          f"{fps_exact:.2f} FPS: tracked/untracked {fps_k6 / fps_exact:.3f} "
          f"(K4+K5 through the CLI: {fps['merger tracked (K4 + K5)'] / fps_exact:.3f}); "
          f"energies of the two tracked paths differ by {d_e:.3e} (tol "
          f"1e-4); launches {counts}")
    print(f"[7 fps] {json.dumps(fps)} on {smi}")

    # small input: the card's tracked and integrator engines agree with the
    # CPU plain path (on the card tpu+tracking takes K6, on the CPU the
    # chunked force and the metrics' own sweep; the others run K4)
    for tag in ("tpu+tracking", "tpu+leapfrog+tracking", "tpu+leapfrog",
                "tpu+kdk", "tpu+yoshida4"):
        runs = []
        for d in ("cpu", dev):
            e = create_engine(tag, small.to(d), soft=SOFT, dt=DT,
                              num_iterations=5)
            e.run(5)
            runs.append(e)
        pos = max(float(np.max(np.abs(runs[1].bodies.unpadded()[k]
                                      - runs[0].bodies.unpadded()[k])
                               / np.maximum(np.abs(
                                   runs[0].bodies.unpadded()[k]), 1e-30)))
                  for k in ("qx", "qy", "qz"))
        hist = 0.0
        if hasattr(runs[0], "history"):
            ref = runs[0].history.energies
            hist = float(np.max(np.abs(runs[1].history.energies / ref - 1)))
        check(pos <= 1e-4 and hist <= 1e-5,
              f"{tag}: card vs cpu positions {pos:.3e} (tol 1e-4), energies "
              f"{hist:.3e} (tol 1e-5)")
        print(f"[7 small] {tag} N=2048 galaxy, 5 steps: card vs CPU plain "
              f"path positions max rel diff {pos:.3e} (tol 1e-4), energies "
              f"{hist:.3e} (tol 1e-5)")

    # ------------------------------ 8. the multi-level hierarchy, random
    # K7-K9 against their plain versions in float64 on the N=200,000 random
    # box (the main path's bodies), K7 and K9 on the real expansions and
    # fields.  Contracts, against the largest magnitude of each output:
    # K8 1e-5 and K7 3e-5 (fp32 sums of up to 3,128 bodies and 87,808
    # node pairs), K9 1e-4 (K2's, the basis recurrence in fp32).
    from murb_tpu_torch.ops.fmm import acc_fmm

    def rel_max(got, ref) -> float:
        return max(float((g.double() - r).abs().max() / r.abs().max())
                   for g, r in zip(got, ref))

    def m2l_work(m, C, subset, nf):
        """Useful flops of one level sweep: 2 nf per node pair of each
        (target, source) cell pair the subset admits, plus one transfer
        build (12 ops per node pair) per offset some pair uses."""
        reach, min_inf = {"expand": (3, 0), "near": (1, 0),
                          "far": (3, 2)}[subset]
        par = lambda o, i: i % 2 == 0 if o == 3 else (
            i % 2 == 1 if o == -3 else True)
        pairs = used = 0
        for o in itertools.product(range(-reach, reach + 1), repeat=3):
            if max(map(abs, o)) < min_inf:
                continue
            n_o = sum(
                all(0 <= i + d < C for i, d in zip(cell, o))
                and (subset == "near" or all(par(d, i)
                                             for d, i in zip(o, cell)))
                for cell in itertools.product(range(C), repeat=3))
            pairs += n_o
            used += n_o > 0
        return pairs, (2 * nf * pairs + 12 * used) * m ** 6

    sr8 = init_random(n_main, SEED, device=dev)
    g8 = sr8.m * torch.tensor(G, dtype=torch.float32).item()
    c8, h8 = bounding_box(sr8.qx, sr8.qy, sr8.qz, g8 > 0)
    ge8 = heavy_split(sr8.qx, sr8.qy, sr8.qz, g8, 1, 100.0,
                      g8.sum() / (g8 > 0).sum())[4]
    q8 = (sr8.qx, sr8.qy, sr8.qz)
    q8_64 = tuple(v.double() for v in q8)
    n8 = sr8.npad
    for m, C, subsets in ((8, 4, ("expand",)), (6, 8, ("expand", "near"))):
        shape = f"m={m} C={C} N={n8}"
        order = fk.cell_order(*q8, c8, h8, C)
        glue_ms = time_ms(lambda: fk.cell_order(*q8, c8, h8, C))
        w = fk.p2m_grid_fused(*q8, ge8, c8, h8, m=m, C=C, order=order)
        w64 = fk.p2m_grid_plain(*q8_64, ge8.double(), c8.double(),
                                h8.double(), m=m, C=C)
        err = rel_max([w], [w64])
        check(err <= 1e-5, f"K8 {shape}: max|dW| {err:.3e} of max|W|")
        ms = time_ms(lambda: fk.p2m_grid_fused(*q8, ge8, c8, h8, m=m, C=C,
                                               order=order))
        plain_ms = time_ms(lambda: fk.p2m_grid_plain(*q8, ge8, c8, h8, m=m,
                                                     C=C), reps=3)
        # q, gm and the permutation in, W out; the contraction and bases
        nbytes, flops = 24 * n8 + 4 * C ** 3 * m ** 3, \
            n8 * (2 * m ** 3 + 6 * m ** 2)
        b_ms = bound(nbytes, flops)[0]
        print(f"[8 K8 p2m_grid {shape}] max|dW|/max|W| {err:.3e} (tol "
              f"1e-5); kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
              f"{b_ms:.4f} ms; cell order (ids, sort, bounds) "
              f"{glue_ms:.4f} ms")
        if (m, C) == (8, 4):
            keep("K8", err * float(w64.abs().max()), ms, plain_ms, nbytes,
                 flops)

        hl = h8 / C
        fields64 = None
        for subset in subsets:
            for nf in (3, 4):
                f = fk.m2l_level_fused(w64.float(), hl, SOFT, m=m, C=C,
                                       subset=subset, with_phi=nf == 4)
                f64 = fk.m2l_level_plain(w64, hl.double(), SOFT, m=m, C=C,
                                         subset=subset, with_phi=nf == 4)
                err = rel_max(f, f64)
                check(err <= 3e-5, f"K7 {shape} {subset} nf={nf}: "
                                   f"{err:.3e} of max|f|")
                ms = time_ms(lambda: fk.m2l_level_fused(
                    w, hl, SOFT, m=m, C=C, subset=subset, with_phi=nf == 4))
                plain_ms = time_ms(lambda: fk.m2l_level_plain(
                    w, hl, SOFT, m=m, C=C, subset=subset, with_phi=nf == 4),
                    reps=2, runs=3)
                pairs, flops = m2l_work(m, C, subset, nf)
                nbytes = 4 * (1 + nf) * C ** 3 * m ** 3
                b_ms = bound(nbytes, flops)[0]
                print(f"[8 K7 m2l {shape} {subset} nf={nf}] max|df|/max|f| "
                      f"{err:.3e} (tol 3e-5); {pairs} cell pairs, "
                      f"{fk.m2l_splits(m, C)} offset splits; kernel "
                      f"{ms:.4f} ms plain {plain_ms:.4f} ms bound "
                      f"{b_ms:.4f} ms")
                if (m, C, subset, nf) == (8, 4, "expand", 3):
                    keep("K7", err * max(float(x.abs().max()) for x in f64),
                         ms, plain_ms, nbytes, flops)
                if subset == "expand" and nf == 4:
                    fields64 = f64
        for k in (3, 4):
            flds = tuple(x.float() for x in fields64[:k])
            a = fk.l2p_grid_fused(*q8, c8, h8, flds, m=m, C=C, order=order)
            a64 = fk.l2p_grid_plain(*q8_64, c8.double(), h8.double(),
                                    fields64[:k], m=m, C=C)
            err = rel_max(a, a64)
            check(err <= 1e-4, f"K9 {shape} k={k}: {err:.3e} of max|a|")
            ms = time_ms(lambda: fk.l2p_grid_fused(*q8, c8, h8, flds, m=m,
                                                   C=C, order=order))
            plain_ms = time_ms(lambda: fk.l2p_grid_plain(*q8, c8, h8, flds,
                                                         m=m, C=C), reps=3)
            # q and the permutation in, k fields in, k values a body out
            nbytes = 20 * n8 + 4 * k * (n8 + C ** 3 * m ** 3)
            flops = n8 * (2 * k * m ** 3 + 6 * m ** 2)
            b_ms = bound(nbytes, flops)[0]
            print(f"[8 K9 l2p_grid {shape} k={k}] max|da|/max|a| {err:.3e} "
                  f"(tol 1e-4); kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"bound {b_ms:.4f} ms")
            if (m, C, k) == (8, 4, 3):
                keep("K9", err * max(float(x.abs().max()) for x in a64), ms,
                     plain_ms, nbytes, flops)
    del w64, fields64, a64, f64
    torch.cuda.empty_cache()

    # the main path of the random box through the CLI: the auto policy
    # takes the hierarchy and validates it
    res8, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "100", "--im", "tpu+proxy", "-s", "random",
        "--nv", "--gf", "--scan", "--device", "cuda"]))
    check(res8.rc == 0, f"cli tpu+proxy -s random exit code {res8.rc}")
    e8 = res8.engine
    e8.assert_finite()
    check(e8.using_proxy and e8.levels >= 2,
          f"tpu+proxy -s random took m={e8.m} levels={e8.levels} "
          f"using_proxy={e8.using_proxy}, not the hierarchy")
    check(e8.validated_err is not None and e8.validated_err <= TOL,
          f"random box validated error {e8.validated_err} > {TOL}")
    for k in ("K7", "K8", "K9"):
        launches[k] = counts[k]
        check(counts[k] > 0, f"{k} launched no time on the random box")
    pick8 = (e8.m, e8.levels)     # shard+fmm must pick the same (phase 11)
    f8 = e8.bodies
    err_end = measured_force_error(
        f8.qx, f8.qy, f8.qz, e8._gm(f8), SOFT,
        lambda a, b, cc, g: acc_fmm(a, b, cc, g, SOFT, m=e8.m,
                                    levels=e8.levels))
    print(f"[8 main] tpu+proxy N={n_main} random: m={e8.m} "
          f"levels={e8.levels} validated_err {e8.validated_err:.3e} (err "
          f"after 100 steps {err_end:.3e}, reported, not a contract); "
          f"{res8.fps:.2f} FPS {res8.gflops:.1f} ref-GFlop/s "
          f"({res8.elapsed_ms:.2f} ms for 99 steps) on {smi}; launches "
          f"{counts}")

    # the fused tracked hierarchy: row 0's energy against one exact K6
    # sweep of the same state (rtol 1e-3, as in phase 7)
    e_exact8 = float(energy_from_phi(
        sr8, acc_phi_rows_hybrid(*q8, g8, g8[None, :], SOFT)[1][0], SOFT))
    csv = os.path.join(tmpdir.name, "random_tracking.csv")
    res8t, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "20", "--im", "tpu+tracking", "--kernel",
        "fmm", "-s", "random", "--nv", "--gf", "--scan", "--csv", csv,
        "--device", "cuda"]))
    check(res8t.rc == 0, f"cli tpu+tracking --kernel fmm exit {res8t.rc}")
    et = res8t.engine
    et.assert_finite()
    check(len(et._fused_fmm) == 2, "tpu+tracking did not fuse the hierarchy")
    check(all(counts[k] > 0 for k in ("K7", "K8", "K9")),
          f"K7-K9 launched no time under the tracked hierarchy: {counts}")
    rows_finite(et.history, 20, csv)
    e0 = float(et.history.energies[0])
    rel = abs(e0 / e_exact8 - 1.0)
    check(rel <= 1e-3, f"tracked fmm energy row 0 {e0:.6e} vs exact "
                       f"{e_exact8:.6e}: rel {rel:.3e} > 1e-3")
    print(f"[8 tracked] tpu+tracking --kernel fmm N={n_main} random: "
          f"(m, levels)={et._fused_fmm}, energy row 0 {e0:.9e} vs exact K6 "
          f"{e_exact8:.9e} (rel {rel:.3e}, tol 1e-3); {res8t.fps:.2f} FPS "
          f"vs tpu+proxy {res8.fps:.2f} FPS in this run; launches {counts}")
    del sr8, g8, ge8, q8, q8_64

    # the octant proxy: K8/K9 at C=2 on the 200k galaxy (the 13,824-node
    # sweep runs K3)
    err_c2, counts = drive(lambda: measured_force_error(
        fin.qx, fin.qy, fin.qz, gm_fin, SOFT,
        lambda a, b, cc, g: acc_proxy(a, b, cc, g, SOFT, m=12, cells=2)))
    check(counts["K8"] > 0 and counts["K9"] > 0,
          f"acc_proxy cells=2 launched no K8/K9: {counts}")
    check(err_c2 <= TOL, f"acc_proxy cells=2 force error {err_c2:.3e}")
    print(f"[8 cells=2] acc_proxy m=12 cells=2 on the galaxy after phase 4: "
          f"force error {err_c2:.3e} (tol {TOL}); launches {counts}")

    # small input: the hierarchy on the card agrees with the CPU plain path
    small_r = init_random(2048, SEED, device="cpu")
    runs = [create_engine("tpu+proxy", small_r.to(d), soft=SOFT, dt=DT,
                          m=8, levels=2) for d in ("cpu", dev)]
    for e in runs:
        e.run(3)
    worst = max(float(np.max(np.abs(runs[1].bodies.unpadded()[k]
                                    - runs[0].bodies.unpadded()[k])
                             / np.maximum(np.abs(
                                 runs[0].bodies.unpadded()[k]), 1e-30)))
                for k in ("qx", "qy", "qz"))
    check(worst <= 1e-4, f"levels=2 m=8: card vs cpu positions {worst:.3e}")
    print(f"[8 small] tpu+proxy levels=2 m=8 N=2048 random, 3 steps: card "
          f"vs CPU plain path positions max rel diff {worst:.3e} (tol 1e-4)")

    # ---------------------------- 9. the adaptive hierarchy, two clusters
    # murb_tpu's bench row adaptive_two_clusters_1m (bench.py:442-460):
    # N = 1,048,576 in two Gaussian clusters, soft 0.02, dt 1e-6, through
    # create_engine with the auto policy, which must take the adaptive
    # branch.  The kernel parity below runs on that state's own sorted
    # bodies, slots and fields under the plan the engine picked.
    from murb_tpu_torch.ops import anterp_kernels as ak
    from murb_tpu_torch.ops import p2p as pp
    from murb_tpu_torch.ops import p2p_kernels as pk
    from murb_tpu_torch.ops import sparse_fmm as sf
    from murb_tpu_torch.ops.fmm import _heavy_setup
    from murb_tpu_torch.utils.profile_step import (TWO_CLUSTERS_DT,
                                                   TWO_CLUSTERS_SOFT,
                                                   two_clusters)

    soft9, dt9 = TWO_CLUSTERS_SOFT, TWO_CLUSTERS_DT
    t0 = time.perf_counter()
    st9 = two_clusters(device=dev)
    t_state = time.perf_counter() - t0

    def build_and_run(n_steps):
        t1 = time.perf_counter()
        engine = create_engine("tpu+proxy", st9, soft=soft9, dt=dt9)
        return (time.perf_counter() - t1,) + timed(engine, n_steps)

    (t_build, e9, fps9), counts = drive(lambda: build_and_run(4))
    e9.assert_finite()
    check(e9.near_mode == "adaptive" and e9.using_proxy,
          f"the two-cluster box took near_mode={e9.near_mode} "
          f"using_proxy={e9.using_proxy}, not the adaptive solver")
    check(e9.validated_err is not None and e9.validated_err <= TOL,
          f"adaptive validated error {e9.validated_err} > {TOL}")
    for k in ("K10", "K11", "K12"):
        launches[k] = counts[k]
        check(counts[k] > 0, f"{k} launched no time on the adaptive path")
    plan = e9._plan
    health9 = e9.proxy_health()
    (_, fps_exact9), counts_x = drive(lambda: timed(create_engine(
        "tpu+hybrid", st9, soft=soft9, dt=dt9), 3))
    print(f"[9 main] tpu+proxy N={st9.n} two clusters (state in "
          f"{t_state:.1f} s, engine with plan and validation in "
          f"{t_build:.1f} s): near_mode={e9.near_mode} m={plan.m} dense "
          f"levels={plan.dense_levels} levels={plan.levels} cell caps "
          f"{plan.cell_caps} (occupied {health9['n_cells_now']}) pmax "
          f"{plan.p2p_pmax} n_pairs {health9['p2p_pairs_now']} (host "
          f"estimate), validated_err {e9.validated_err:.3e}; {fps9:.4f} FPS "
          f"over 3 steps after one; exact tpu+hybrid {fps_exact9:.4f} FPS "
          f"over 2 steps after one (launches {counts_x}); adaptive/exact "
          f"{fps9 / fps_exact9:.2f} on {smi}; launches {counts}")
    fps["two clusters adaptive"] = fps9
    fps["two clusters exact (tpu+hybrid)"] = fps_exact9

    # the solve's own preamble: box, heavy split, cubic box, one sort
    g9 = e9._gm(st9)
    q9 = (st9.qx, st9.qy, st9.qz)
    c9, h9, *_rest, ge9 = _heavy_setup(*q9, g9, 1, sf.HEAVY_FACTOR)
    h9 = h9.max().expand(3)
    C9 = 2 ** plan.levels
    key9, ci9 = pp.sorted_cells(*q9, ge9 > 0, c9, h9, C9)
    key9, perm9 = torch.sort(key9, stable=True)
    xs9, ys9, zs9, gs9 = (v[perm9] for v in (*q9, ge9))
    ci9 = tuple(v[perm9] for v in ci9)
    x64 = tuple(v.double() for v in (xs9, ys9, zs9, gs9))
    cap9 = plan.cell_caps[-1]
    cells9, slots9 = sf._occupied_and_slots(key9, cap9)
    n9, B9 = st9.npad, st9.npad // pp.DEFAULT_K
    # Contracts, against the largest magnitude of each output: K10 3e-5,
    # the exact fp32 sweeps' (K4, K6); K11 and K12 1e-4, K9's.  At C=128 a
    # body's in-cell coordinate comes from (q - lo) / cs near 100 in fp32
    # (ulp 8e-6), which the float64 plain version on the same fp32 inputs
    # does not round.
    def near_body_pairs(ci, pmax, C, chunk=2048):
        """The body pairs K10's function needs: those of the first
        ``pmax`` candidate brick pairs (row-major, as K10 keeps them) whose
        cells pass the mask max|dc| <= 1, both bodies real (no sentinel).
        Counted on the device from the sort's own cells."""
        K = pp.DEFAULT_K
        cells = torch.stack([v.to(torch.int16) for v in ci]).reshape(3, -1,
                                                                     K)
        B = cells.shape[1]
        real = cells[0] < C
        adj = pp._adjacency(*pp._brick_boxes(ci, K))
        flat = torch.nonzero(adj.reshape(-1)).reshape(-1)[:pmax]
        tb, sb = flat // B, flat % B
        total = torch.zeros((), dtype=torch.int64, device=flat.device)
        for p0 in range(0, flat.numel(), chunk):
            t, s = tb[p0:p0 + chunk], sb[p0:p0 + chunk]
            near = ((cells[:, t, :, None] - cells[:, s, None, :]).abs()
                    <= 1).all(0)
            near &= real[t][:, :, None] & real[s][:, None, :]
            total += near.sum()
        return int(total), flat.numel() * K * K

    # K10 (nf 3 and 4); the plain version sweeps 1024 pairs a step here.
    # The bound counts the body pairs that pass the cell mask, the work the
    # function needs; K10 computes every body pair of a swept brick pair.
    t0 = time.perf_counter()
    near9, swept_bodies9 = near_body_pairs(ci9, plan.p2p_pmax, C9)
    t_count = time.perf_counter() - t0
    for nf in (3, 4):
        kw = dict(pmax=plan.p2p_pmax, with_phi=nf == 4)
        got, npairs = pk.p2p_sweep_kernel_sorted(xs9, ys9, zs9, gs9, ci9,
                                                 soft9, **kw)
        ref, npairs64 = pp.p2p_sweep_plain_sorted(*x64, ci9, soft9,
                                                  chunk=1024, **kw)
        err = rel_max(got, ref)
        check(int(npairs) == int(npairs64), f"K10 n_pairs {int(npairs)} vs "
                                            f"plain {int(npairs64)}")
        check(err <= 3e-5, f"K10 nf={nf}: {err:.3e} of max|a|")
        ms = time_ms(lambda: pk.p2p_sweep_kernel_sorted(
            xs9, ys9, zs9, gs9, ci9, soft9, **kw), reps=5)
        plain_ms = time_ms(lambda: pp.p2p_sweep_plain_sorted(
            xs9, ys9, zs9, gs9, ci9, soft9, chunk=1024, **kw), reps=1,
            runs=3)
        swept = min(int(npairs), plan.p2p_pmax)
        nbytes = 28 * n9 + B9 * B9 + 8 * B9 + 4 * nf * n9
        flops = near9 * (20 if nf == 3 else 22)
        b_ms = bound(nbytes, flops)[0]
        print(f"[9 K10 p2p N={n9} B={B9} nf={nf}] {int(npairs)} brick "
              f"pairs ({swept} swept, pmax {plan.p2p_pmax}); {near9} body "
              f"pairs pass the cell mask of {swept_bodies9} swept (masked "
              f"out {1 - near9 / swept_bodies9:.4f}; counted in "
              f"{t_count:.2f} s); max|da|/max|a| {err:.3e} (tol 3e-5); "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.4f} "
              f"ms")
        if nf == 3:
            keep("K10", err * max(float(x.abs().max()) for x in ref), ms,
                 plain_ms, nbytes, flops)
        full4 = got
    # K10 under a capacity below the candidate count: the first pmax pairs
    # in row-major order are swept, the rest dropped, the true count kept
    pmax_t = max(int(npairs) // 2 // pp.DEFAULT_CHUNK * pp.DEFAULT_CHUNK,
                 pp.DEFAULT_CHUNK)
    got, np_t = pk.p2p_sweep_kernel_sorted(xs9, ys9, zs9, gs9, ci9, soft9,
                                           pmax=pmax_t, with_phi=True)
    ref, np_t64 = pp.p2p_sweep_plain_sorted(*x64, ci9, soft9, chunk=1024,
                                            pmax=pmax_t, with_phi=True)
    err = rel_max(got, ref)
    dropped = max(float((a - b).abs().max()) for a, b in zip(full4, got))
    check(int(np_t) == int(np_t64) == int(npairs),
          f"K10 pmax={pmax_t}: n_pairs {int(np_t)} vs plain {int(np_t64)} "
          f"vs {int(npairs)}")
    check(err <= 3e-5, f"K10 pmax={pmax_t} nf=4: {err:.3e} of max|a|")
    check(dropped > 0.0, f"K10 pmax={pmax_t} dropped no pair")
    print(f"[9 K10 p2p N={n9} nf=4 pmax={pmax_t} < n_pairs {int(np_t)}] "
          f"max|da|/max|a| {err:.3e} (tol 3e-5) against the plain version "
          f"under the same pmax; max change from the full sweep "
          f"{dropped:.3e}")
    del got, ref, full4
    # K11 and K12 on the finest slots; K12 reads the solve's real fields
    m9 = plan.m
    w9 = ak.p2m_window(xs9, ys9, zs9, gs9, c9, h9, slots9, cap9, m=m9, C=C9,
                       ci=ci9)
    w64 = ak.p2m_window_plain(*x64, c9.double(), h9.double(), slots9, cap9,
                              m=m9, C=C9, ci=ci9)
    err = rel_max([w9[:cap9]], [w64[:cap9]])
    check(err <= 1e-4, f"K11 m={m9}: {err:.3e} of max|W|")
    ms = time_ms(lambda: ak.p2m_window(xs9, ys9, zs9, gs9, c9, h9, slots9,
                                       cap9, m=m9, C=C9, ci=ci9))
    plain_ms = time_ms(lambda: ak.p2m_window_plain(
        xs9, ys9, zs9, gs9, c9, h9, slots9, cap9, m=m9, C=C9, ci=ci9),
        reps=3)
    nbytes = 32 * n9 + 4 * (cap9 + 1) * m9 ** 3
    flops = n9 * (2 * m9 ** 3 + 6 * m9 ** 2)
    b_ms = keep("K11", err * float(w64.abs().max()), ms, plain_ms, nbytes,
                flops)
    print(f"[9 K11 p2m_window N={n9} m={m9} C={C9} cap={cap9}] "
          f"max|dW|/max|W| {err:.3e} (tol 1e-4); kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms bound {b_ms:.4f} ms")
    fields9, _ = sf.hierarchy_fields(w9, cells9, c9, h9, soft9, plan,
                                     with_phi=True)
    for nf in (3, 4):
        flds = fields9[:nf]
        a = ak.l2p_window(xs9, ys9, zs9, c9, h9, slots9, flds, m=m9, C=C9,
                          ci=ci9)
        a64 = ak.l2p_window_plain(*x64[:3], c9.double(), h9.double(),
                                  slots9, tuple(f.double() for f in flds),
                                  m=m9, C=C9, ci=ci9)
        err = rel_max(a, a64)
        check(err <= 1e-4, f"K12 nf={nf}: {err:.3e} of max|a|")
        ms = time_ms(lambda: ak.l2p_window(xs9, ys9, zs9, c9, h9, slots9,
                                           flds, m=m9, C=C9, ci=ci9))
        plain_ms = time_ms(lambda: ak.l2p_window_plain(
            xs9, ys9, zs9, c9, h9, slots9, flds, m=m9, C=C9, ci=ci9), reps=3)
        nbytes = 28 * n9 + 4 * nf * ((cap9 + 1) * m9 ** 3 + n9)
        flops = n9 * (2 * nf * m9 ** 3 + 6 * m9 ** 2)
        b_ms = bound(nbytes, flops)[0]
        print(f"[9 K12 l2p_window N={n9} m={m9} nf={nf}] max|da|/max|a| "
              f"{err:.3e} (tol 1e-4); kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {b_ms:.4f} ms")
        if nf == 3:
            keep("K12", err * max(float(x.abs().max()) for x in a64), ms,
                 plain_ms, nbytes, flops)

    del w64, a64, x64, fields9
    torch.cuda.empty_cache()

    # the dense hierarchy with K10 as its near field: acc_fmm(near="p2p")
    # on a 65,536-body two-cluster box, L=4, m=6, held to the 1e-4 contract
    s65 = two_clusters(65_536, device=dev)
    g65 = s65.m * torch.tensor(G, dtype=torch.float32).item()
    u65 = s65.unpadded()
    qh65 = np.stack([u65[k] for k in ("qx", "qy", "qz")], 1)
    pmax65 = pp.size_pmax(pp.estimate_brick_pairs(qh65, s65.npad, 4))
    err65, counts = drive(lambda: measured_force_error(
        s65.qx, s65.qy, s65.qz, g65, soft9,
        lambda a, b, cc, g: acc_fmm(a, b, cc, g, soft9, m=6, levels=4,
                                    near="p2p", p2p_pmax=pmax65)))
    check(counts["K10"] > 0, f"acc_fmm near=p2p launched no K10: {counts}")
    check(err65 <= TOL, f"acc_fmm near=p2p force error {err65:.3e} > {TOL}")
    print(f"[9 fmm p2p] acc_fmm m=6 L=4 near=p2p N=65536 two clusters: "
          f"force error {err65:.3e} (tol {TOL}), pmax {pmax65}; launches "
          f"{counts}")

    # the merger through the CLI: tpu+proxy --near adaptive, and the fused
    # adaptive tracked step (K10 and K12 with phi), row 0's energy held to
    # an exact K6 energy of the same state (rtol 1e-3, as in phase 7)
    res9, counts = drive(lambda: cli.run([
        "-n", str(mg.n), "-i", "20", "--im", "tpu+proxy", "--near",
        "adaptive", "-s", "milkyway_andromeda", "--scheme-file", tab,
        "--nv", "--gf", "--scan", "--device", "cuda"]))
    check(res9.rc == 0, f"cli tpu+proxy --near adaptive exit {res9.rc}")
    res9.engine.assert_finite()
    check(res9.engine.near_mode == "adaptive", "merger --near adaptive did "
                                               "not take the adaptive solver")
    check(all(counts[k] > 0 for k in ("K10", "K11", "K12")),
          f"K10-K12 launched no time on the merger: {counts}")
    pm = res9.engine._plan
    print(f"[9 merger] tpu+proxy --near adaptive N={mg.n}: m={pm.m} dense "
          f"levels={pm.dense_levels} levels={pm.levels} caps {pm.cell_caps} "
          f"pmax {pm.p2p_pmax}, validated_err "
          f"{res9.engine.validated_err:.3e}; {res9.fps:.2f} FPS over 19 "
          f"steps; launches {counts}")
    fps["merger tpu+proxy --near adaptive"] = res9.fps
    e_exact_mg = float(energy_from_phi(
        mg, acc_phi_rows_hybrid(*qm, gmg, gmg[None, :], SOFT)[1][0], SOFT))
    csv = os.path.join(tmpdir.name, "merger_adaptive.csv")
    res9t, counts = drive(lambda: cli.run([
        "-n", str(mg.n), "-i", "20", "--im", "tpu+tracking", "--kernel",
        "adaptive", "-s", "milkyway_andromeda", "--scheme-file", tab, "--nv",
        "--gf", "--scan", "--csv", csv, "--device", "cuda"]))
    check(res9t.rc == 0, f"cli tpu+tracking --kernel adaptive {res9t.rc}")
    et9 = res9t.engine
    et9.assert_finite()
    check(et9._fused_adaptive is not None, "tpu+tracking --kernel adaptive "
                                           "did not fuse")
    check(counts["K10"] > 0 and counts["K12"] > 0,
          f"K10/K12 launched no time under the tracked adaptive step: "
          f"{counts}")
    rows_finite(et9.history, 20, csv)
    e0 = float(et9.history.energies[0])
    rel = abs(e0 / e_exact_mg - 1.0)
    check(rel <= 1e-3, f"tracked adaptive energy row 0 {e0:.6e} vs exact "
                       f"{e_exact_mg:.6e}: rel {rel:.3e} > 1e-3")
    print(f"[9 tracked] tpu+tracking --kernel adaptive N={mg.n} merger: "
          f"m={et9._fused_adaptive.m} L={et9._fused_adaptive.levels}, energy "
          f"row 0 {e0:.9e} vs exact K6 {e_exact_mg:.9e} (rel {rel:.3e}, tol "
          f"1e-3); {res9t.fps:.2f} FPS; launches {counts}")
    fps["merger tpu+tracking --kernel adaptive"] = res9t.fps
    print(f"[9 fps] {json.dumps(fps)} on {smi}")

    # small input: 3 adaptive steps on the card against the CPU plain path
    # (the same explicit geometry, m=6 L=5, on both devices); dt 0.05 moves
    # the bodies by about 1e-3 of their coordinates
    small_c = two_clusters(4096, device="cpu")
    runs = [create_engine("tpu+proxy", small_c.to(d), soft=soft9, dt=0.05,
                          m=6, levels=5, near="adaptive")
            for d in ("cpu", dev)]
    for e in runs:
        e.run(3)
    pos = [e.bodies.unpadded() for e in runs]
    q0 = small_c.unpadded()
    worst = max(float(np.max(np.abs(pos[1][k] - pos[0][k])
                             / np.maximum(np.abs(pos[0][k]), 1e-30)))
                for k in ("qx", "qy", "qz"))
    moved = max(float(np.max(np.abs(pos[0][k] - q0[k])
                             / np.maximum(np.abs(q0[k]), 1e-30)))
                for k in ("qx", "qy", "qz"))
    check(worst <= 1e-4, f"adaptive: card vs cpu positions {worst:.3e}")
    print(f"[9 small] tpu+proxy near=adaptive m=6 L=5 N=4096 two clusters, "
          f"3 steps of dt 0.05 (bodies moved up to {moved:.3e} of their "
          f"coordinates): card vs CPU plain path positions max rel diff "
          f"{worst:.3e} (tol 1e-4)")

    # the repair: K7-K9 at m=18 (the rung after 16) and m=32 (the ladder's
    # top order) on the two-cluster box, C=2.  K7's fp32 sums run over 8
    # cells x m^3 source nodes a target (46,656 at m=18, 262,144 at m=32),
    # so its contract is K9's 1e-4, not the m=8 sweep's 3e-5.  The plain
    # M2L builds its (m^3, m^3) transfer matrices in row blocks at m=32.
    C = 2
    for m in (18, 32):
        shape = f"m={m} C={C} N={n9}"
        w = fk.p2m_grid_fused(*q9, ge9, c9, h9, m=m, C=C)
        w64 = fk.p2m_grid_plain(*(v.double() for v in (*q9, ge9)),
                                c9.double(), h9.double(), m=m, C=C)
        e8 = rel_max([w], [w64])
        del w64
        t0 = time.perf_counter()
        f = fk.m2l_level_fused(w, h9 / C, soft9, m=m, C=C, with_phi=True)
        f64 = fk.m2l_level_plain(w.double(), h9.double() / C, soft9, m=m,
                                 C=C, with_phi=True)
        e7 = rel_max(f, f64)
        t_plain7 = time.perf_counter() - t0
        del f64
        a = fk.l2p_grid_fused(*q9, c9, h9, f, m=m, C=C)
        a64 = fk.l2p_grid_plain(*(v.double() for v in q9), c9.double(),
                                h9.double(), tuple(x.double() for x in f),
                                m=m, C=C)
        e9k = rel_max(a, a64)
        del a64
        check(e8 <= 1e-5 and e7 <= 1e-4 and e9k <= 1e-4,
              f"{shape}: K8 {e8:.3e} (1e-5) K7 {e7:.3e} (1e-4) K9 "
              f"{e9k:.3e} (1e-4)")
        ms = [time_ms(fn, reps=3) for fn in (
            lambda: fk.p2m_grid_fused(*q9, ge9, c9, h9, m=m, C=C),
            lambda: fk.m2l_level_fused(w, h9 / C, soft9, m=m, C=C,
                                       with_phi=True),
            lambda: fk.l2p_grid_fused(*q9, c9, h9, f, m=m, C=C))]
        print(f"[9 repair {shape}] K8 {e8:.3e} of max|W| (tol 1e-5), K7 "
              f"expand nf=4 {e7:.3e} of max|f| (tol 1e-4), K9 k=4 "
              f"{e9k:.3e} of max|a| (tol 1e-4); kernel ms K8 {ms[0]:.4f} "
              f"K7 {ms[1]:.4f} K9 {ms[2]:.4f}; the K7 check with its plain "
              f"version took {t_plain7:.1f} s")
        del w, f, a
        torch.cuda.empty_cache()

    # ------------------------------- 10. the exact large-N path, K13
    # murb_tpu's exact-ladder row (bench.py:373-377): tpu+mxu on the
    # N=200,000 galaxy, nothing cut.  K13 against its plain version run in
    # float64 on the same inputs: a 4096-row strided i-sample against all
    # 200k sources (the rect entry; the centre comes from the j-set, as in
    # the square run) and the 16384^2 galaxy, for every block pair the
    # kernel is compiled for.  Contract: tests/test_oracle.py:99-100,
    # WithinRel 5e-4 with an rms floor of 5e-4, on every component.
    from murb_tpu_torch.ops.mxu import acc_mxu_rect, acc_mxu_rect_plain
    from murb_tpu_torch.utils import autotune as at

    wrappers["K13"] = acc_mxu_rect
    s10 = init_galaxy(n_main, SEED, device=dev)
    g10 = s10.m * torch.tensor(G, dtype=torch.float32).item()
    q10 = (s10.qx, s10.qy, s10.qz, g10)
    q10_64 = tuple(v.double() for v in q10)
    idx10 = torch.linspace(0, s10.npad - 1, 4096, device=dev).long()
    s16 = init_galaxy(16_384, SEED, device=dev)
    g16 = s16.m * torch.tensor(G, dtype=torch.float32).item()
    q16 = (s16.qx, s16.qy, s16.qz, g16)
    q16_64 = tuple(v.double() for v in q16)
    cases10 = {
        "rect 4096x200k": (tuple(v[idx10] for v in q10[:3]), q10,
                           acc_mxu_rect_plain(*(v[idx10] for v in q10_64[:3]),
                                              *q10_64, SOFT)),
        "square 16384^2": (q16[:3], q16,
                           acc_mxu_rect_plain(*q16_64[:3], *q16_64, SOFT)),
    }
    worst13, max_rel13, abs13 = 0.0, 0.0, 0.0
    for label, (iset, jset, ref) in cases10.items():
        scale = max(float(r.abs().max()) for r in ref)
        for bi, bj in itertools.product(cuda.SWEEP_BLOCKS, repeat=2):
            got = acc_mxu_rect(*iset, *jset, SOFT, block_i=bi, block_j=bj)
            torch.cuda.synchronize()
            w = within_rel(got, ref, 5e-4, 5e-4)
            err = max(float((g.double() - r).abs().max())
                      for g, r in zip(got, ref))
            rel = norm_rel(got, ref)
            check(w <= 1.0, f"K13 {label} blocks {bi}x{bj}: WithinRel 5e-4 "
                            f"(rms floor 5e-4) exceeded by {w:.2f}x")
            ms = time_ms(lambda: acc_mxu_rect(*iset, *jset, SOFT, block_i=bi,
                                              block_j=bj), reps=3, runs=3)
            print(f"[10 K13 {label} blocks {bi}x{bj}] max|da|/max|a| "
                  f"{err / scale:.3e}, per-body rel {rel:.3e}, WithinRel "
                  f"5e-4 at {w:.3f} of the allowance; kernel {ms:.4f} ms")
            worst13 = max(worst13, w)
            max_rel13 = max(max_rel13, err / scale)
            if label.startswith("rect"):   # the main path's bodies
                abs13 = max(abs13, err)
    plain13 = {label: time_ms(lambda: acc_mxu_rect_plain(*iset, *jset, SOFT),
                              reps=1, runs=3)
               for label, (iset, jset, _) in cases10.items()}
    print(f"[10 K13] worst WithinRel share {worst13:.3f}, worst "
          f"max|da|/max|a| {max_rel13:.3e} over {len(cases10)} shapes x "
          f"{len(cuda.SWEEP_BLOCKS) ** 2} block pairs; plain (fp32) "
          f"{json.dumps(plain13)} ms")
    del cases10, q10_64, q16_64
    torch.cuda.empty_cache()

    # the main path through the CLI, from zeroed counts; the step's last
    # acceleration held to a float64 direct sweep on 512 strided rows
    res10, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "10", "--im", "tpu+mxu", "--nv", "--gf",
        "--scan", "--device", "cuda"]))
    check(res10.rc == 0, f"cli tpu+mxu exit code {res10.rc}")
    e10 = res10.engine
    e10.assert_finite()
    launches["K13"] = counts["K13"]
    check(counts["K13"] > 0, f"K13 launched no time on tpu+mxu: {counts}")
    f10 = e10.bodies
    err10 = measured_force_error(
        f10.qx, f10.qy, f10.qz, e10._gm(f10), SOFT,
        lambda a, b, cc, g: e10._acc_fn(a, b, cc, g))
    check(err10 <= 5e-4, f"tpu+mxu force error {err10:.3e} > 5e-4")
    bi0, bj0 = e10.block_i, e10.block_j
    ms13 = time_ms(lambda: acc_mxu_rect(*q10[:3], *q10, SOFT, block_i=bi0,
                                        block_j=bj0), reps=5, runs=3)
    plain_ms13 = time_ms(lambda: acc_mxu_rect_plain(*q10[:3], *q10, SOFT),
                         reps=1, runs=3)
    n10 = s10.npad
    # A (8 rows) and gm per source; B (8 rows), the centred target and the
    # output per target, each once; 20 flops a pair (the reference's model)
    b13 = keep("K13", abs13, ms13, plain_ms13, 4 * (9 * n10 + 14 * n10),
               20 * n10 * n10)
    fps["tpu+mxu 200k"] = res10.fps
    print(f"[10 main] tpu+mxu N={n_main} galaxy through the CLI: blocks "
          f"{bi0}x{bj0} (kernel default), {res10.fps:.3f} FPS "
          f"{res10.gflops:.1f} ref-GFlop/s ({res10.elapsed_ms:.2f} ms for 9 "
          f"steps); force error after 10 steps {err10:.3e} (tol 5e-4); K13 "
          f"at {n10}^2 {ms13:.4f} ms, plain {plain_ms13:.4f} ms, bound "
          f"{b13:.4f} ms on {smi}; launches {counts}")

    # the wrapper engines on K13: tpu+tracking --kernel mxu, row 0's energy
    # against the exact K6 energy of the same state (phase 7)
    csv = os.path.join(tmpdir.name, "mxu_tracking.csv")
    res10t, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "3", "--im", "tpu+tracking", "--kernel",
        "mxu", "--nv", "--scan", "--csv", csv, "--device", "cuda"]))
    check(res10t.rc == 0, f"cli tpu+tracking --kernel mxu exit {res10t.rc}")
    res10t.engine.assert_finite()
    check(counts["K13"] > 0, f"K13 launched no time under --kernel mxu: "
                             f"{counts}")
    rows_finite(res10t.engine.history, 3, csv)
    e0 = float(res10t.engine.history.energies[0])
    rel = abs(e0 / e_exact - 1.0)
    check(rel <= 1e-5, f"tracked mxu energy row 0 {e0:.6e} vs exact "
                       f"{e_exact:.6e}: rel {rel:.3e} > 1e-5")
    print(f"[10 tracked] tpu+tracking --kernel mxu N={n_main}: energy row 0 "
          f"{e0:.9e} vs exact K6 {e_exact:.9e} (rel {rel:.3e}, tol 1e-5); "
          f"{res10t.fps:.3f} FPS; launches {counts}")

    # --autotune through the CLI under a temporary cache: each candidate's
    # time, then a second run that reads the winner without sweeping
    os.environ["MURB_TUNE_CACHE"] = os.path.join(tmpdir.name, "tune.json")
    sweep_calls = []
    measure = at.measure_steps

    def counted(*a, **k):
        sweep_calls.append(1)
        return measure(*a, **k)

    at.measure_steps = counted
    tuned = {}
    try:
        for tag, n in (("tpu+mxu", n_main), ("tpu+hybrid", 16_384),
                       ("tpu+hybrid", n_main)):
            argv = ["-n", str(n), "-i", "3", "--im", tag, "--nv", "--scan",
                    "--device", "cuda"]
            del sweep_calls[:]
            r1 = cli.run(argv + ["--autotune"])
            n_swept = len(sweep_calls)
            r2 = cli.run(argv)
            check(r1.rc == 0 and r2.rc == 0, f"--autotune {tag} n={n}")
            t1 = r1.engine.tuned
            check(t1 is not None and "sweep" in t1 and n_swept > 0,
                  f"--autotune {tag} n={n} did not sweep")
            check(len(sweep_calls) == n_swept and "sweep" not in
                  r2.engine.tuned and (r2.engine.block_i, r2.engine.block_j)
                  == (r1.engine.block_i, r1.engine.block_j),
                  f"{tag} n={n}: the second run did not read the winner")
            cands = {f"{p['block_i']}x{p['block_j']}": ms
                     for p, ms in t1["sweep"]}
            tuned[f"{tag} n={n}"] = cands
            print(f"[10 autotune] {tag} N={n} ({n_swept} candidates): "
                  f"winner {r1.engine.block_i}x{r1.engine.block_j} "
                  f"{t1['ms_per_step']:.4f} ms/step; second run read "
                  f"{r2.engine.block_i}x{r2.engine.block_j} with no sweep; "
                  f"ms/step by blocks {json.dumps(cands)} on {smi}")
    finally:
        at.measure_steps = measure
        del os.environ["MURB_TUNE_CACHE"]

    # checkpoint and resume: 10 steps, save, load, 10 more, against 20
    # straight (K13 sums in a fixed order, so the two must agree bit for
    # bit)
    ck = os.path.join(tmpdir.name, "mxu.npz")
    base = ["-n", str(n_main), "--im", "tpu+mxu", "--nv", "--scan",
            "--device", "cuda"]
    ra = cli.run(base + ["-i", "10", "--save-state", ck])
    rb = cli.run(base + ["-i", "10", "--load-state", ck])
    rc_ = cli.run(base + ["-i", "20"])
    check(ra.rc == rb.rc == rc_.rc == 0, "checkpoint runs")
    pb, pc = rb.engine.bodies.to_numpy(), rc_.engine.bodies.to_numpy()
    diff = max(float(np.max(np.abs(pb[k].astype(np.float64) - pc[k])))
               for k in ("qx", "qy", "qz", "vx", "vy", "vz"))
    check(diff == 0.0, f"resumed run differs from the straight run by "
                       f"{diff:.3e}")
    print(f"[10 checkpoint] tpu+mxu N={n_main}: 10 steps, save, load, 10 "
          f"more against 20 straight: max |difference| {diff:g} (bit "
          f"for bit)")

    # trajectory dump: frames 0, 5, 10, the last one the final state
    tr = os.path.join(tmpdir.name, "mxu.traj")
    rd = cli.run(base + ["-i", "10", "--dump-traj", tr, "--dump-every", "5"])
    check(rd.rc == 0, "cli --dump-traj")
    from murb_tpu_torch.io import read_trajectory

    fidx, fpos = read_trajectory(tr)
    fin10 = rd.engine.bodies.unpadded()
    check(fidx.tolist() == [0, 5, 10] and fpos.shape == (3, n_main, 3),
          f"trajectory frames {fidx.tolist()} shape {fpos.shape}")
    check(all(np.array_equal(fpos[2][:, c], fin10[k])
              for c, k in enumerate(("qx", "qy", "qz"))),
          "the last frame is not the final state")
    check(np.array_equal(fpos[0][:, 0], s10.unpadded()["qx"]),
          "frame 0 is not the initial state")
    print(f"[10 dump] tpu+mxu --dump-traj --dump-every 5: frames "
          f"{fidx.tolist()}, {fpos.shape}, frame 10 equals the final state")
    print(f"[10 fps] {json.dumps(fps)} on {smi}")
    del s10, g10, q10, s16, q16, e10, f10
    torch.cuda.empty_cache()

    # ----------------------------- 11. the distributed modes, K14
    # Shards on one card (an explicit device list): the protocol is
    # checked, not a link.  K14 against its plain version in float64 on the
    # 200k galaxy at D = 1 to 4 (D = 3 the smallest with the capacity
    # handshake), each with and without a 5 us sleep before every copy and
    # compute; contract WithinRel 1e-5 (tests/test_ring_pallas.py:67-69)
    # with the rms floor 5e-6 of K3's 16384^2 check (sums over 200k
    # sources in fp32).  One float64 plain sweep of the whole state is the
    # reference: ghost rows (zero mass) change no real row, so each D's
    # padding compares its own rows.
    from murb_tpu_torch.ops.ring import (acc_ring_pipelined,
                                         acc_ring_pipelined_plain)
    from murb_tpu_torch.parallel.mesh import make_mesh, shard_state

    wrappers["K14"] = acc_ring_pipelined
    g_of = lambda s: s.m * torch.tensor(G, dtype=torch.float32).item()
    s11 = init_galaxy(n_main, SEED, device=dev).repad(256 * 4)
    q11 = [v.double() for v in (s11.qx, s11.qy, s11.qz, g_of(s11))]
    ref_parts = [acc_tile_rect_plain(*(v[i:i + 8192] for v in q11[:3]),
                                     *q11, SOFT)
                 for i in range(0, s11.npad, 8192)]
    ref11 = [torch.cat([p[c] for p in ref_parts]) for c in range(3)]
    del q11, ref_parts
    k14 = {}
    for d in (1, 2, 3, 4):
        sd = init_galaxy(n_main, SEED, device=dev).repad(256 * d)
        mesh_d = make_mesh(devices=[dev] * d)
        blocks = shard_state(sd, mesh_d)
        qs = [(b.qx, b.qy, b.qz) for b in blocks]
        gs = [g_of(b) for b in blocks]
        nd = sd.npad
        for delay in (0, 5000):
            acc = acc_ring_pipelined(mesh_d, qs, gs, SOFT, delay_ns=delay)
            torch.cuda.synchronize()
            got = [torch.cat([a[c] for a in acc]) for c in range(3)]
            ref_d = [r[:nd] for r in ref11]
            w = within_rel(got, ref_d, 1e-5, 5e-6)
            err = max(float((g.double() - r).abs().max())
                      for g, r in zip(got, ref_d))
            check(w <= 1.0, f"K14 D={d} delay={delay} ns: WithinRel 1e-5 "
                            f"(rms floor 5e-6) exceeded by {w:.2f}x")
            ms = time_ms(lambda: acc_ring_pipelined(mesh_d, qs, gs, SOFT,
                                                    delay_ns=delay),
                         reps=5, runs=3)
            # the plain version: the same protocol with torch ops, fp32
            plain = "" if delay else "{:.4f} ms".format(time_ms(
                lambda: acc_ring_pipelined_plain(mesh_d, qs, gs, SOFT),
                reps=1, runs=1))
            b_ms, _ = bound(28 * nd, 20 * nd * nd)
            print(f"[11 K14 ring N={nd} D={d} delay={delay} ns] max|da| "
                  f"{err:.3e}, WithinRel 1e-5 (rms floor 5e-6) at {w:.4f} "
                  f"of the allowance; kernel {ms:.4f} ms ({d * d} sweeps, "
                  f"{d * (d - 1)} slot copies of {16 * nd // d} bytes) "
                  f"bound {b_ms:.4f} ms" + (f" plain {plain}" if plain
                                            else ""))
            if delay == 0:
                k14[d] = (err, ms, float(plain.split()[0]))
        if d == 4:
            keep("K14", *k14[4], 28 * nd, 20 * nd * nd)
    del ref11, blocks, qs, gs, acc, got
    torch.cuda.empty_cache()

    # the main path through the CLI: --shards 1 is the mesh this card has,
    # K14 at D = 1 (pure compute); the force error after 10 steps held to
    # 5e-4 as tpu+mxu's
    res11, counts = drive(lambda: cli.run([
        "-n", str(n_main), "-i", "10", "--im", "shard+ring", "--shards", "1",
        "--nv", "--gf", "--scan", "--device", "cuda"]))
    check(res11.rc == 0, f"cli shard+ring exit code {res11.rc}")
    e11 = res11.engine
    e11.assert_finite()
    check(e11.ring_impl == "pipelined" and e11.n_shards == 1,
          f"shard+ring took {e11.ring_impl} on {e11.n_shards} shards")
    check(counts["K14"] > 0, f"K14 launched no time on shard+ring: {counts}")
    f11 = e11.bodies
    err11 = measured_force_error(
        f11.qx, f11.qy, f11.qz, g_of(f11), SOFT,
        lambda a, b, cc, g: acc_ring_pipelined(e11.mesh, [(a, b, cc)], [g],
                                               SOFT)[0])
    check(err11 <= 5e-4, f"shard+ring force error {err11:.3e} > 5e-4")
    fps["shard+ring --shards 1"] = res11.fps
    print(f"[11 main] shard+ring --shards 1 N={n_main} galaxy through the "
          f"CLI: {res11.fps:.3f} FPS {res11.gflops:.1f} ref-GFlop/s "
          f"({res11.elapsed_ms:.2f} ms for 9 steps); force error after 10 "
          f"steps {err11:.3e} (tol 5e-4) on {smi}; launches {counts}")

    # 4 shards on cuda:0 against the single-device exact sweep (tpu+tile,
    # K3): one step's accelerations, the positions after 10 steps at
    # tests/test_parallel.py:33-34's 1e-3 (rms floor 1e-6)
    s4 = init_galaxy(n_main, SEED, device=dev)
    quad = [dev] * 4
    (e4, fps4), counts = drive(lambda: timed(create_engine(
        "shard+ring", s4, soft=SOFT, dt=DT, devices=quad), 10))
    launches["K14"] = counts["K14"]
    check(counts["K14"] > 0, f"K14 launched no time on 4 shards: {counts}")
    e4.assert_finite()
    (et4, fps_t4), counts_t = drive(lambda: timed(create_engine(
        "tpu+tile", s4, soft=SOFT, dt=DT), 10))
    p4, pt4 = e4.bodies.unpadded(), et4.bodies.unpadded()
    for c in ("qx", "qy", "qz"):
        wpos = within_rel([torch.from_numpy(p4[c])],
                          [torch.from_numpy(pt4[c])], 1e-3, 1e-6)
        check(wpos <= 1.0, f"shard+ring 4 shards vs tpu+tile {c} after 10 "
                           f"steps: WithinRel 1e-3 exceeded by {wpos:.2f}x")
    a1 = create_engine("shard+ring", s4, soft=SOFT, dt=DT, devices=quad)
    t1 = create_engine("tpu+tile", s4, soft=SOFT, dt=DT)
    a1.compute_one_iteration()
    t1.compute_one_iteration()
    acc_a = [a[:s4.npad] for a in a1.accelerations]
    acc_t = list(t1.accelerations)
    wacc = within_rel(acc_a, acc_t, 1e-5, 1e-7)
    check(wacc <= 1.0, f"shard+ring 4 shards vs tpu+tile: one step's "
                       f"accelerations exceed WithinRel 1e-5 (rms floor "
                       f"1e-7) by {wacc:.2f}x")
    print(f"[11 ring 4 shards] create_engine shard+ring devices=[cuda:0]*4 "
          f"N={n_main}: {fps4:.3f} FPS over 9 steps after one, tpu+tile "
          f"{fps_t4:.3f} FPS (K3 launches {counts_t['K3']}); one step's "
          f"accelerations against tpu+tile at {wacc:.4f} of WithinRel 1e-5 "
          f"(rms floor 1e-7); positions after 10 steps within 1e-3; "
          f"launches {counts}")
    fps["shard+ring 4 shards"] = fps4
    fps["tpu+tile"] = fps_t4

    # the sharded checkpoint: a 4-shard state on the card, bit for bit
    ck11 = os.path.join(tmpdir.name, "ring4")
    e4.save_sharded(ck11)
    e4b = create_engine("shard+ring", s4, soft=SOFT, dt=DT, devices=quad)
    meta11 = e4b.load_sharded(ck11)
    same = all(torch.equal(getattr(x, k), getattr(y, k))
               for x, y in zip(e4.blocks, e4b.blocks)
               for k in ("m", "r", "qx", "qy", "qz", "vx", "vy", "vz"))
    check(same and meta11["iteration"] == 10,
          f"sharded checkpoint round trip: same={same} meta={meta11}")
    print(f"[11 checkpoint] save_sharded -> load_sharded of 4 shards on the "
          f"card: bit for bit, iteration {meta11['iteration']}")
    del e4, e4b, et4, a1, t1
    torch.cuda.empty_cache()

    # shard+allgather and shard+uneven (0.6) on 4 shards of the card against
    # the single-device exact engine (tpu+hybrid, passes 2): 3 steps each,
    # positions at 1e-3 (rms floor 1e-6); both run K4's wrapper
    (eh, _), _ = drive(lambda: timed(create_engine(
        "tpu+hybrid", s4, soft=SOFT, dt=DT), 3))
    ph = eh.bodies.unpadded()
    for tag, kw in (("shard+allgather", {}),
                    ("shard+uneven", {"gpu_fraction": 0.6})):
        (es, fps_s), counts = drive(lambda: timed(create_engine(
            tag, s4, soft=SOFT, dt=DT, devices=quad, **kw), 3))
        es.assert_finite()
        check(counts["K4"] > 0, f"K4 launched no time under {tag}: {counts}")
        ps = es.bodies.unpadded()
        worst = max(within_rel([torch.from_numpy(ps[c])],
                               [torch.from_numpy(ph[c])], 1e-3, 1e-6)
                    for c in ("qx", "qy", "qz"))
        check(worst <= 1.0, f"{tag} vs tpu+hybrid: {worst:.2f}x of 1e-3")
        fps[f"{tag} 4 shards"] = fps_s
        print(f"[11 {tag}] 4 shards on the card {kw}: {fps_s:.3f} FPS over "
              f"2 steps after one; positions after 3 steps at {worst:.4f} "
              f"of WithinRel 1e-3 against tpu+hybrid; launches {counts}")
    del eh, es
    torch.cuda.empty_cache()

    # shard+proxy on the 200k galaxy (4 shards): one expansion, K1/K2
    (ep, fps_p), counts = drive(lambda: timed(create_engine(
        "shard+proxy", s4, soft=SOFT, dt=DT, devices=quad), 20))
    ep.assert_finite()
    check(ep.mode == "proxy", f"shard+proxy took mode {ep.mode}")
    check(ep.validated_err is not None and ep.validated_err <= TOL,
          f"shard+proxy validated error {ep.validated_err}")
    check(counts["K1"] > 0 and counts["K2"] > 0,
          f"K1/K2 launched no time under shard+proxy: {counts}")
    fps["shard+proxy 4 shards"] = fps_p
    print(f"[11 shard+proxy] 4 shards, N={n_main} galaxy: m={ep.m}, "
          f"validated_err {ep.validated_err:.3e}; {fps_p:.3f} FPS over 19 "
          f"steps after one; launches {counts}")
    del ep

    # shard+fmm: shard+proxy promoted on the 200k random box, the (m, L)
    # of the single-device policy (phase 8's pick)
    r11 = init_random(n_main, SEED, device=dev)
    (ef, fps_f), counts = drive(lambda: timed(create_engine(
        "shard+proxy", r11, soft=SOFT, dt=DT, devices=quad), 20))
    ef.assert_finite()
    check(ef.mode == "fmm" and (ef.m, ef.levels) == pick8,
          f"shard+proxy -s random took {ef.mode} ({ef.m}, {ef.levels}), "
          f"tpu+proxy {pick8}")
    check(all(counts[k] > 0 for k in ("K7", "K8", "K9")),
          f"K7-K9 launched no time under shard+fmm: {counts}")
    check(ef.validated_err is not None and ef.validated_err <= TOL,
          f"shard+fmm validated error {ef.validated_err}")
    fps["shard+fmm 4 shards"] = fps_f
    print(f"[11 shard+fmm] 4 shards, N={n_main} random: (m, L)=({ef.m}, "
          f"{ef.levels}) as tpu+proxy, validated_err {ef.validated_err:.3e};"
          f" {fps_f:.3f} FPS over 19 steps after one; launches {counts}")
    del ef, r11

    # shard+adaptive: the 1M two-cluster box of phase 9 on 1 shard, and the
    # merger on 2 shards of the card
    for label, state, kw, soft_a, dt_a, steps in (
            ("1M two clusters, 1 shard", st9, {"shards": 1}, soft9, dt9, 4),
            (f"merger N={mg.n}, 2 shards", mg, {"devices": [dev] * 2}, SOFT,
             DT, 10)):
        t1 = time.perf_counter()
        (ea, fps_a), counts = drive(lambda: timed(create_engine(
            "shard+adaptive", state, soft=soft_a, dt=dt_a, **kw), steps))
        t_a = time.perf_counter() - t1
        ea.assert_finite()
        ha = ea.proxy_health()
        check(ha["ok"], f"shard+adaptive {label}: health {ha}")
        check(all(counts[k] > 0 for k in ("K10", "K11", "K12")),
              f"K10-K12 launched no time under shard+adaptive {label}: "
              f"{counts}")
        check(ea.validated_err is not None and ea.validated_err <= TOL,
              f"shard+adaptive validated error {ea.validated_err}")
        fps[f"shard+adaptive {label}"] = fps_a
        print(f"[11 shard+adaptive] {label}: m={ea.m} L={ea.levels}, "
              f"validated_err {ea.validated_err:.3e}, health {ha}; "
              f"{fps_a:.4f} FPS over {steps - 1} steps after one (build and "
              f"steps {t_a:.1f} s); launches {counts}")
        del ea
        torch.cuda.empty_cache()
    print(f"[11 fps] {json.dumps(fps)} on {smi}")

    for k, count in launches.items():
        check(count > 0, f"{k} launched no time on its piece of the path")
    meta = {
        "K1": ("p2m", "murb_tpu_torch/csrc/proxy.cu",
               "murb_tpu/ops/proxy_pallas.py:112"),
        "K2": ("l2p", "murb_tpu_torch/csrc/proxy.cu",
               "murb_tpu/ops/proxy_pallas.py:170"),
        "K3": ("tile_rect", "murb_tpu_torch/csrc/tile.cu",
               "murb_tpu/ops/tile_pallas.py:39"),
        "K4": ("hybrid_ext_rect", "murb_tpu_torch/csrc/hybrid.cu",
               "murb_tpu/ops/hybrid.py:63"),
        "K5": ("phi_rows", "murb_tpu_torch/csrc/phi.cu",
               "murb_tpu/ops/hybrid.py:219"),
        "K6": ("acc_phi_rows", "murb_tpu_torch/csrc/phi.cu",
               "murb_tpu/ops/hybrid.py:338"),
        "K7": ("m2l_level", "murb_tpu_torch/csrc/fmm.cu",
               "murb_tpu/ops/fmm_pallas.py:85"),
        "K8": ("p2m_grid", "murb_tpu_torch/csrc/cell_runs.cuh",
               "murb_tpu/ops/fmm_pallas.py:315"),
        "K9": ("l2p_grid", "murb_tpu_torch/csrc/cell_runs.cuh",
               "murb_tpu/ops/fmm_pallas.py:371"),
        "K10": ("p2p_sorted", "murb_tpu_torch/csrc/p2p.cu",
                "murb_tpu/ops/p2p_pallas.py:56"),
        "K11": ("p2m_window", "murb_tpu_torch/csrc/cell_runs.cuh",
                "murb_tpu/ops/anterp_pallas.py:139"),
        "K12": ("l2p_window", "murb_tpu_torch/csrc/cell_runs.cuh",
                "murb_tpu/ops/anterp_pallas.py:244"),
        "K13": ("mxu_rect", "murb_tpu_torch/csrc/mxu.cu",
                "murb_tpu/ops/mxu.py:49"),
        "K14": ("ring_pipelined", "murb_tpu_torch/csrc/ring.cu",
                "murb_tpu/ops/ring_pallas.py:50"),
    }
    kernels = [{"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[k], **record[k]}
               for k, (kname, source, replaces) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
