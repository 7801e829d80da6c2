#!/usr/bin/env bash
# Two-phase test job of murb_tpu_torch (the port's counterpart of
# scripts/run_tests.sh): phase 1 runs the port's CPU tests, which hold it
# to murb_tpu on the same inputs (tests/test_torch_*.py); phase 2 runs
# chip_smoke.py on the CUDA card, which builds every kernel, holds each to
# its plain version and drives the main paths.  Phase 2 needs a card;
# PHASES=1 runs phase 1 alone.
set -euo pipefail
cd "$(dirname "$0")/.."

PHASES=${PHASES:-1 2}
WORKERS=${WORKERS:-4}

if [[ " $PHASES " == *" 1 "* ]]; then
  echo "== phase 1: the port's CPU tests against murb_tpu =="
  python -m pytest tests/test_torch_*.py -q -p no:cacheprovider \
    -p xdist -n "$WORKERS"
fi

if [[ " $PHASES " == *" 2 "* ]]; then
  echo "== phase 2: chip_smoke.py on the CUDA card =="
  python3 chip_smoke.py
fi
