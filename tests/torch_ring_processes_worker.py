"""Worker process of tests/test_torch_ring_processes.py (not a pytest module).

Usage: python torch_ring_processes_worker.py <process_id> <num_processes>
       <port>

Brings up torch.distributed (gloo) through the entry point the CLI uses
(murb_tpu_torch.parallel.mesh.maybe_init_distributed) with 2 CPU shards a
process, runs two steps of shard+ring with ring_impl="pipelined" on the
1024-body galaxy (seed 7, the same on every process) and prints a
checksum of the global state; plays the plain protocol once on the
engine's blocks and prints its log (this process's computes, global
shards); then reports host names that differ by process, runs the ring on
that mesh (its staged edges) and prints whether it gave the one-host bits
and what the engine's auto policy takes on CPU shards.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["MURB_COORDINATOR"] = f"localhost:{port}"
os.environ["MURB_NUM_PROCESSES"] = str(nproc)
os.environ["MURB_PROCESS_ID"] = str(pid)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from murb_tpu_torch import G  # noqa: E402
from murb_tpu_torch.core.init import init_galaxy  # noqa: E402
from murb_tpu_torch.models import create_engine  # noqa: E402
from murb_tpu_torch.ops import ring  # noqa: E402
from murb_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from murb_tpu_torch.parallel.shard_engine import auto_ring_impl  # noqa: E402

SOFT, DT = 2.0e8, 3600.0

assert mesh_mod.maybe_init_distributed("cpu"), "coordinator env not picked up"
assert dist.get_world_size() == nproc and dist.get_rank() == pid

bodies = init_galaxy(1024, 7, device="cpu")
engine = create_engine("shard+ring", bodies, soft=SOFT, dt=DT,
                       shards=2 * nproc, ring_impl="pipelined")
assert engine.ring_impl == "pipelined" and engine.mesh.local_size == 2
assert engine.mesh.single_host
engine.run(2)
assert ring.acc_ring_pipelined.launches == 0      # CPU: the plain version
state = engine.bodies
chk = float(state.qx.double().sum() + state.vy.double().sum())
print(f"CHECKSUM {chk.hex()}", flush=True)

g = torch.tensor(G, dtype=torch.float32).item()
log = []
qs = [(b.qx, b.qy, b.qz) for b in engine.blocks]
gs = [b.m * g for b in engine.blocks]
near = ring.acc_ring_pipelined_plain(engine.mesh, qs, gs, SOFT, log=log)
print(f"LOG {json.dumps(log)}", flush=True)

# processes on two hosts: the ring runs across them (staged edges) and
# gives the one-host bits; auto keeps ppermute on CPU shards
mesh_mod.host_name = lambda: f"host-{pid}"
far = mesh_mod.make_mesh(2 * nproc, device="cpu")
got = ring.acc_ring_pipelined(far, qs, gs, SOFT)
same = all(torch.equal(x, y) for a, b in zip(got, near)
           for x, y in zip(a, b))
print(f"HOSTS ran {auto_ring_impl(far)} {'same' if same else 'differ'} "
      f"{','.join(far.hosts)}", flush=True)

mesh_mod.destroy_distributed()
print("WORKER_DONE", flush=True)
