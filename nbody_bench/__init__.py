"""The benchmark of ``murb_tpu_torch``, the PyTorch and CUDA port of murb-tpu.

Run one cell with ``python -m nbody_bench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of the repository on a machine
with an NVIDIA card.  The last line of standard output is the run's result
as one JSON object.  See ``harness.py`` for what a run does and which file
holds what; nothing here imports ``jax`` or the JAX package ``murb_tpu``.
"""
