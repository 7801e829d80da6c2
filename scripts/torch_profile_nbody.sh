#!/usr/bin/env bash
# Profiling runs of murb_tpu_torch -- the analogue of the reference's
# nbody_profiling.sh (RUN / NSYS / NCU modes, ref:
# scripts/nbody_profiling.sh:64-108) and of scripts/profile_nbody.sh for
# murb_tpu.
#
#   MODE=RUN    a timed --scan run (the CLI's FPS line)
#   MODE=TRACE  a run under torch.profiler (--profile OUT): a Chrome trace
#               in OUT/trace.json (chrome://tracing or ui.perfetto.dev) and
#               the device time it holds ("Profiled device time: ... ms")
#   MODE=NSYS   the run under Nsight Systems, OUT/nbody.nsys-rep
#   MODE=NCU    the kernels under Nsight Compute, OUT/nbody.ncu-rep (the
#               run's first 20 kernel launches)
#
# NSYS and NCU need nsys / ncu on PATH; without them the script says so and
# exits 2 (it never falls back to another mode).  DEVICE=cpu runs the
# kernels' plain PyTorch versions (RUN and TRACE; the trace then holds no
# device time).
#
#   MODE=TRACE N=200000 I=20 IM=tpu+proxy bash scripts/torch_profile_nbody.sh
set -euo pipefail
cd "$(dirname "$0")/.."

MODE=${MODE:-RUN}          # RUN | TRACE | NSYS | NCU
N=${N:-30000}
I=${I:-50}
IM=${IM:-tpu+hybrid}
DEVICE=${DEVICE:-cuda}
OUT=${OUT:-build/murb_trace}

run=(python -m murb_tpu_torch -n "$N" -i "$I" --im "$IM" --nv --gf
     --device "$DEVICE")

need() {
    if ! command -v "$1" > /dev/null 2>&1; then
        echo "MODE=$MODE needs $1, which is not on PATH on this host;" \
             "MODE=TRACE profiles with torch.profiler instead" >&2
        exit 2
    fi
}

case "$MODE" in
  RUN)
    "${run[@]}" --scan
    ;;
  TRACE)
    "${run[@]}" --profile "$OUT"
    echo "trace: $OUT/trace.json (chrome://tracing or ui.perfetto.dev)"
    ;;
  NSYS)
    need nsys
    mkdir -p "$OUT"
    nsys profile --force-overwrite true -o "$OUT/nbody" "${run[@]}" --scan
    ;;
  NCU)
    need ncu
    mkdir -p "$OUT"
    ncu --force-overwrite --target-processes all -c 20 -o "$OUT/nbody" \
        "${run[@]}"
    ;;
  *)
    echo "unknown MODE=$MODE (RUN|TRACE|NSYS|NCU)" >&2; exit 1;;
esac
