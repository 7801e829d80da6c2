"""Worker process of tests/test_torch_ring_hosts.py (not a pytest module).

Usage: python torch_ring_hosts_worker.py <process_id> <num_processes>
       <port> <hosts> <local_shards>

``hosts``: each process's host, comma-separated (``a,a,b``).  Brings up
torch.distributed (gloo) through the entry point the CLI uses
(murb_tpu_torch.parallel.mesh.maybe_init_distributed), places this
process on its host with ``create_engine(..., host=...)``, runs two steps
of shard+ring with ring_impl="pipelined" on the 1024-body galaxy (seed 7,
the same on every process) and prints a checksum of the global state;
plays the plain protocol on the engine's blocks with its log, then with a
2 ms sleep before every send of process 0's agent and of the last
process's, and prints the log, whether the delayed calls gave the same
bits, the agents' epoch and their message counts; then tears the groups
down with destroy_distributed.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
hosts, local = sys.argv[4].split(","), int(sys.argv[5])
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

SOFT, DT, DELAY_NS = 2.0e8, 3600.0, 2_000_000

assert mesh_mod.maybe_init_distributed("cpu"), "coordinator env not picked up"
assert dist.get_world_size() == nproc and dist.get_rank() == pid

engine = create_engine("shard+ring", init_galaxy(1024, 7, device="cpu"),
                       soft=SOFT, dt=DT, shards=local * nproc,
                       ring_impl="pipelined", host=hosts[pid])
mesh = engine.mesh
assert engine.ring_impl == "pipelined" and mesh.local_size == local
assert mesh.hosts == hosts and not mesh.single_host
engine.run(2)
assert ring.acc_ring_pipelined.launches == 0      # CPU: the plain version
state = engine.bodies
chk = float(state.qx.double().sum() + state.vy.double().sum())
print(f"CHECKSUM {chk.hex()}", flush=True)

g = torch.tensor(G, dtype=torch.float32).item()
qs = [(b.qx, b.qy, b.qz) for b in engine.blocks]
gs = [b.m * g for b in engine.blocks]
log = []
ref = ring.acc_ring_pipelined_plain(mesh, qs, gs, SOFT, log=log)
print(f"LOG {json.dumps(log)}", flush=True)
same = True
for delayed in (0, nproc - 1):
    got = ring.acc_ring_pipelined_plain(
        mesh, qs, gs, SOFT, host_delay_ns=DELAY_NS if pid == delayed else 0)
    same &= all(torch.equal(x, y) for a, b in zip(got, ref)
                for x, y in zip(a, b))
print(f"DELAYS {'same' if same else 'differ'}", flush=True)
agents = ring._AGENTS[0]
agents.drain()      # the last sends have returned
print(f"AGENTS {json.dumps({'epoch': agents.base, 'moved': agents.moved})}",
      flush=True)
mesh_mod.destroy_distributed()
assert not ring._AGENTS and not dist.is_initialized()
print("WORKER_DONE", flush=True)
