"""Worker process of tests/test_torch_multiprocess.py (not a pytest module).

Usage: python torch_multiprocess_worker.py <process_id> <num_processes>
       <port> <checkpoint_dir>

Brings up torch.distributed (gloo) through the entry point the CLI uses
(murb_tpu_torch.parallel.mesh.maybe_init_distributed), builds 4 global CPU
shards (2 in each of 2 processes), runs two steps of shard+ring,
shard+allgather and shard+proxy on the 1024-body galaxy (seed 7, the same
on every process), and prints a checksum of each global state.  Then a
sharded checkpoint of the ring engine goes through a round trip across
both processes.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pid, nproc, port, ckpt = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
os.environ["MURB_COORDINATOR"] = f"localhost:{port}"
os.environ["MURB_NUM_PROCESSES"] = str(nproc)
os.environ["MURB_PROCESS_ID"] = str(pid)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from murb_tpu_torch.core.init import init_galaxy  # noqa: E402
from murb_tpu_torch.models import create_engine  # noqa: E402
from murb_tpu_torch.parallel.mesh import maybe_init_distributed  # noqa: E402

assert maybe_init_distributed("cpu"), "coordinator env not picked up"
assert dist.get_world_size() == nproc and dist.get_rank() == pid

for tag in ("shard+ring", "shard+allgather", "shard+proxy"):
    bodies = init_galaxy(1024, 7, device="cpu")
    engine = create_engine(tag, bodies, soft=2.0e8, dt=3600.0, shards=4)
    assert engine.mesh.local_size == 2 and engine.n_shards == 4
    engine.run(2)
    state = engine.bodies
    chk = float(state.qx.double().sum() + state.vy.double().sum())
    print(f"CHECKSUM {tag} {chk.hex()}", flush=True)
    if tag == "shard+ring":
        engine.save_sharded(ckpt)
        again = create_engine(tag, bodies, soft=2.0e8, dt=3600.0, shards=4)
        meta = again.load_sharded(ckpt)
        same = all(torch.equal(getattr(a, k), getattr(b, k))
                   for a, b in zip(engine.blocks, again.blocks)
                   for k in ("qx", "vz"))
        print(f"CHECKPOINT {meta['iteration']} {same}", flush=True)

dist.destroy_process_group()
print("WORKER_DONE", flush=True)
