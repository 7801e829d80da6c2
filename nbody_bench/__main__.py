"""``python -m nbody_bench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of ``BENCHMARK.json``."""
import sys

from nbody_bench.run import main

sys.exit(main())
