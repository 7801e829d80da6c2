"""``shard+adaptive`` in bf16 through the port's CLI, against murb_tpu's
engine on the same state (tests/test_torch_bf16_cli.py's check, in a file
of its own: in bf16 no rung of the adaptive ladder meets 1e-4, so both
packages measure every rung, and the run takes minutes on the CPU)."""
import torch

from test_torch_bf16_cli import check_tag

torch.set_num_threads(2)


def test_shard_adaptive_runs_in_bf16_as_murb_tpu(tmp_path):
    check_tag("shard+adaptive", tmp_path)
