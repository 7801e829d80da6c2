"""murb-compatible command-line parsing for the port.

Port of ``murb_tpu/utils/args.py`` (ref: src/murb/main.cpp:61-165):
required ``-n``/``-i``; ``-v --dt --ngs --ww --wh --nv --nvc --im --soft -s
--gf``; the extensions ``--seed --precision --scheme-file --shards
--gpu-fraction --scan --csv --visu-out --visu-live --chunk --block-i
--block-j --autotune --save-state --save-every --load-state --profile
--dump-traj --dump-every --ite-chunk --cam-azim --cam-elev --kernel --tol
--m2l-dots --near --adapt-every --check-finite --list-impls``; and the
port's ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class MurbConfig:
    n_bodies: int
    n_iterations: int
    verbose: bool = False
    dt: float = 3600.0                      # ref: main.cpp:45
    gs_enable: bool = True
    softening: float = 2.0e8                # ref: main.cpp:47
    visu_enable: bool = True
    visu_color: bool = True
    win_width: int = 1024
    win_height: int = 768
    impl_tag: str = "cpu+naive"             # ref: main.cpp:40
    scheme: str = "galaxy"                  # ref: main.cpp:51
    show_gflops: bool = False
    seed: int = 123
    precision: str = "fp32"
    scheme_file: str | None = None
    shards: int = 0                          # 0 = all local devices
    gpu_fraction: float | None = None        # shard+uneven's row fraction
    scan: bool = False
    csv: str | None = None                   # metrics CSV (tracking engines)
    visu_out: str | None = None              # offline frame render directory
    visu_live: int | None = None             # live browser viewer port
    list_impls: bool = False
    chunk: int = 1024                        # i-chunk of xla+chunked
    block_i: int = 0                         # exact-sweep blocks, 0 = kernel
    block_j: int = 0
    autotune: bool = False                   # first-use block sweep
    save_state: str | None = None            # checkpoint written at the end
    save_every: int = 0                      # async periodic checkpoints
    load_state: str | None = None            # resume from a checkpoint
    profile: str | None = None               # torch.profiler trace directory
    dump_traj: str | None = None             # MURBTRAJ trajectory file
    dump_every: int = 1                      # record every k-th iteration
    ite_chunk: int = 1                       # iterations per frame
    cam_azim: float = 0.0                    # offline renderer camera
    cam_elev: float = 90.0
    check_finite: bool = False               # NaN/Inf guard per frame
    kernel: str = "auto"                     # acc kernel of wrapper engines
    tol: float = 1e-4
    m2l_dots: str = "fp32"                   # hierarchy level-sweep tier
    near: str = "auto"                       # tpu+proxy near-field mode
    adapt_every: int | None = None           # proxy re-check period (None:
    #                                          64 in the frame loop, off
    #                                          under --scan)
    device: str = "cuda"
    # True when the flag was given (the checkpoint's dt/softening win over
    # the defaults on --load-state, never over an explicit flag)
    dt_explicit: bool = False
    soft_explicit: bool = False


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="murb-tpu-torch",
        description="n-body simulation on PyTorch + CUDA "
                    "(murb-compatible CLI)",
        add_help=False,
    )
    req = p.add_argument_group("required arguments")
    req.add_argument("-n", dest="n_bodies", type=int, default=None,
                     help="the number of generated bodies.")
    req.add_argument("-i", dest="n_iterations", type=int, default=None,
                     help="the number of iterations to compute.")

    fac = p.add_argument_group("facultative arguments")
    fac.add_argument("-v", dest="verbose", action="store_true",
                     help="enable verbose mode.")
    fac.add_argument("-h", "--help", action="help",
                     help="display this help.")
    fac.add_argument("--dt", dest="dt", type=float, default=None,
                     help="select a fixed time step in second "
                          "(default is 3600 sec).")
    fac.add_argument("--ngs", dest="gs_enable", action="store_false",
                     help="disable geometry-style rendering for visu.")
    fac.add_argument("--ww", dest="win_width", type=int, default=1024,
                     help="the width of the window in pixel (default is "
                          "1024).")
    fac.add_argument("--wh", dest="win_height", type=int, default=768,
                     help="the height of the window in pixel (default is "
                          "768).")
    fac.add_argument("--nv", dest="visu_enable", action="store_false",
                     help="no visualization (disable visu).")
    fac.add_argument("--nvc", dest="visu_color", action="store_false",
                     help="visualization without colors.")
    fac.add_argument("--im", dest="impl_tag", type=str, default="cpu+naive",
                     help="code implementation tag (see --list-impls).")
    fac.add_argument("--soft", dest="softening", type=float, default=None,
                     help="softening factor (default is 2e8 m).")
    fac.add_argument("-s", dest="scheme", type=str, default="galaxy",
                     help='bodies scheme ("galaxy", "random" or a two-galaxy '
                          '.tab file scheme).')
    fac.add_argument("--gf", dest="show_gflops", action="store_true",
                     help="display the number of GFlop/s.")

    ext = p.add_argument_group("extensions")
    ext.add_argument("--seed", type=int, default=123,
                     help="RNG seed for the initial conditions "
                          "(default 123).")
    ext.add_argument("--precision", choices=("fp32", "fp64", "bf16"),
                     default="fp32",
                     help="state precision (default fp32; bf16 halves the "
                          "memory a body takes: the kernels read bf16 and "
                          "compute in fp32).")
    ext.add_argument("--scheme-file", dest="scheme_file", type=str,
                     default=None,
                     help="path to the two-galaxy .tab file for the merger "
                          "scheme (scripts/make_two_galaxy_tab.py writes "
                          "one).")
    ext.add_argument("--shards", type=int, default=0,
                     help="shards of the shard+... engines (0 = all local "
                          "devices: every card for --device cuda, one CPU "
                          "shard for --device cpu; across processes, the "
                          "global count).")
    ext.add_argument("--gpu-fraction", dest="gpu_fraction", type=float,
                     default=None,
                     help="shard+uneven / hetero: the fraction of rows "
                          "shard 0 sweeps, in (0, 1] (default 0.60; "
                          "reference env MURB_HETERO_GPU_FRACTION).")
    ext.add_argument("--scan", action="store_true",
                     help="time the whole run as one window after one "
                          "warm-up step (no per-iteration lines).")
    ext.add_argument("--csv", type=str, default=None,
                     help="write tracked metrics to this CSV (tracking "
                          "engines).")
    ext.add_argument("--visu-out", dest="visu_out", type=str, default=None,
                     help="render offline frames (PNG, needs matplotlib) "
                          "into this directory.")
    ext.add_argument("--visu-live", dest="visu_live", type=int, default=None,
                     nargs="?", const=8797, metavar="PORT",
                     help="serve a live WebGL viewer on this port (default "
                          "8797; 0 = ephemeral). Reach it via ssh -L. "
                          "Space pauses, PgUp/PgDn scale dt.")
    ext.add_argument("--chunk", type=int, default=1024,
                     help="i-chunk size of the chunked engines (default "
                          "1024).")
    ext.add_argument("--block-i", dest="block_i", type=int, default=0,
                     help="exact-sweep targets per block: 64, 128, 256 or "
                          "512 (0 = the kernel's or the tuned choice).")
    ext.add_argument("--block-j", dest="block_j", type=int, default=0,
                     help="exact-sweep sources per staged tile: 64, 128, "
                          "256 or 512 (0 = the kernel's or the tuned "
                          "choice).")
    ext.add_argument("--autotune", action="store_true", default=False,
                     help="time every block geometry of the exact sweep on "
                          "first use of this (kernel, N, device) and keep "
                          "the fastest in $MURB_TUNE_CACHE (default "
                          "build/murb_tpu_torch/autotune.json; also via "
                          "MURB_AUTOTUNE=1).")
    ext.add_argument("--list-impls", action="store_true", default=False,
                     help="list available implementation tags and exit.")
    ext.add_argument("--save-state", dest="save_state", type=str,
                     default=None,
                     help="write a state checkpoint (.npz) when the run "
                          "ends.")
    ext.add_argument("--save-every", dest="save_every", type=int, default=0,
                     help="also checkpoint to --save-state every K "
                          "iterations (asynchronous write-behind, atomic "
                          "rename).")
    ext.add_argument("--load-state", dest="load_state", type=str,
                     default=None,
                     help="resume from a state checkpoint (of either "
                          "package) instead of -s scheme; its dt and "
                          "softening hold unless --dt / --soft are given.")
    ext.add_argument("--profile", type=str, default=None,
                     help="run under torch.profiler (CPU and, on a card, "
                          "CUDA activities) and write a Chrome trace into "
                          "this directory; prints the device time.")
    ext.add_argument("--dump-traj", dest="dump_traj", type=str, default=None,
                     help="record positions to a binary MURBTRAJ file "
                          "(non-blocking background writer).")
    ext.add_argument("--dump-every", dest="dump_every", type=int, default=1,
                     help="record every k-th iteration (default 1).")
    ext.add_argument("--ite-chunk", dest="ite_chunk", type=int, default=1,
                     help="iterations per frame of the frame loop (verbose "
                          "lines print per frame; never skips a "
                          "--dump-every frame).")
    ext.add_argument("--cam-azim", dest="cam_azim", type=float, default=0.0,
                     help="offline renderer camera azimuth (degrees).")
    ext.add_argument("--cam-elev", dest="cam_elev", type=float, default=90.0,
                     help="offline renderer camera elevation (degrees; 90 = "
                          "top-down xy view).")
    ext.add_argument("--kernel", type=str, default="auto",
                     help="acceleration kernel for tracking/leapfrog/kdk "
                          "engines: auto|naive|chunked|tile|hybrid|mxu|"
                          "proxy|fmm|adaptive (fmm hands over to adaptive "
                          "when the dense hierarchy cannot meet --tol).")
    ext.add_argument("--tol", dest="tol", type=float, default=1e-4,
                     help="fast-solver relative force-error target "
                          "(tpu+proxy and --kernel proxy/fmm; default "
                          "1e-4).")
    ext.add_argument("--m2l-dots", dest="m2l_dots", default="fp32",
                     choices=("fp32", "mixed", "bf16x3"),
                     help="M2L tier of the hierarchies: fp32 (the "
                          "default), mixed (the near shell fp32, the far "
                          "shell lossy) or bf16x3 (every M2L product "
                          "lossy: three TF32 products of split operands); "
                          "the validation ladder steps a lossy tier that "
                          "misses --tol toward fp32.")
    ext.add_argument("--near", dest="near", default="auto",
                     choices=("auto", "interp", "adaptive"),
                     help="tpu+proxy near-field mode: interp = the dense "
                          "hierarchy's interpolated near list; adaptive = "
                          "the occupied-cell sparse hierarchy with an exact "
                          "P2P near field (clustered boxes at any "
                          "softening); auto (default) = interp where "
                          "feasible, adaptive when its cost model beats the "
                          "exact kernel.")
    ext.add_argument("--adapt-every", dest="adapt_every", type=int,
                     default=None,
                     help="re-derive the proxy/fmm configuration from the "
                          "current box every K iterations when the system "
                          "outgrew it (tpu+proxy only; 0 = off; default: 64 "
                          "in the frame loop, off under --scan).")
    ext.add_argument("--check-finite", dest="check_finite",
                     action="store_true",
                     help="abort with a clear error if the state goes "
                          "NaN/Inf (a device sync per frame).")
    ext.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="device for the state and every kernel (default "
                          "cuda; never falls back to the CPU).")
    return p


def parse_args(argv=None) -> MurbConfig:
    ns = build_parser().parse_args(argv)
    if not ns.list_impls and (ns.n_bodies is None or ns.n_iterations is None):
        build_parser().error("the arguments -n and -i are required")
    ns.dt_explicit = ns.dt is not None
    ns.soft_explicit = ns.softening is not None
    if ns.dt is None:
        ns.dt = 3600.0                       # ref: main.cpp:45
    if ns.softening is None:
        ns.softening = 2.0e8                 # ref: main.cpp:47
    if ns.softening == 0.0:
        # ref: main.cpp:152-155
        raise SystemExit("Softening factor can't be equal to 0... exiting.")
    fields = {f.name for f in dataclasses.fields(MurbConfig)}
    return MurbConfig(**{k: v for k, v in vars(ns).items() if k in fields})
