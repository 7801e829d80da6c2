#!/usr/bin/env bash
# End-to-end showcase on murb_tpu_torch: generate a two-galaxy merger,
# simulate it with per-galaxy conserved-quantity tracking, record the
# trajectory, and render frames and metric plots (the port's counterpart of
# scripts/demo_two_galaxies.sh).  Runs on the card by default; DEVICE=cpu
# runs the kernels' plain versions (set I small there).
set -euo pipefail
cd "$(dirname "$0")/.."

OUT=${OUT:-/tmp/murb_torch_demo}
I=${I:-60}
DEVICE=${DEVICE:-cuda}
mkdir -p "$OUT"

echo "== 1. generate initial conditions (81,920 bodies)"
python scripts/make_two_galaxy_tab.py "$OUT/milkyway_andromeda.tab"

echo "== 2. simulate with per-galaxy tracking + trajectory recording"
python -m murb_tpu_torch -n 81920 -i "$I" -s mw+andromeda \
  --scheme-file "$OUT/milkyway_andromeda.tab" \
  --im gpu+tracking+multi --nv --gf -v --device "$DEVICE" \
  --csv "$OUT/metrics.csv" \
  --dump-traj "$OUT/run.traj" --dump-every 5 \
  --ite-chunk 5

echo "== 3. render"
python scripts/torch_render_trajectory.py "$OUT/run.traj" "$OUT/frames" \
  --gif "$OUT/merger.gif" --elev 60 --azim 20
python scripts/plot_history_metrics.py "$OUT/metrics.csv" "$OUT/metrics"

echo "demo artifacts in $OUT"
