"""The port's multi-process runtime: two OS processes, each with 2 CPU
shards, one gloo process group (murb_tpu's tests/test_multihost.py, for
murb_tpu_torch).  Both processes must print the same global checksums of
shard+ring, shard+allgather and shard+proxy, equal to a 4-shard run in
one process, and round-trip a sharded checkpoint.  Every worker has a hard
time limit and is killed when it runs out."""
import os
import socket
import subprocess
import sys

import pytest
import torch

from murb_tpu_torch.core.init import init_galaxy
from murb_tpu_torch.models import create_engine

WORKER = os.path.join(os.path.dirname(__file__),
                      "torch_multiprocess_worker.py")
TAGS = ("shard+ring", "shard+allgather", "shard+proxy")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _checksums(out: str) -> dict:
    return {line.split()[1]: float.fromhex(line.split()[2])
            for line in out.splitlines() if line.startswith("CHECKSUM")}


def test_two_processes_agree_with_one(tmp_path):
    try:
        port = _free_port()
    except OSError as e:  # no socket support
        pytest.skip(f"sockets unavailable: {e}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MURB_")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), "2", str(port),
         str(tmp_path / "ckpt")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "WORKER_DONE" in out and "CHECKPOINT 2 True" in out, out

    c0, c1 = (_checksums(o) for o in outs)
    assert set(c0) == set(TAGS) and c0 == c1
    torch.set_num_threads(2)
    for tag in TAGS:
        e = create_engine(tag, init_galaxy(1024, 7, device="cpu"),
                          soft=2.0e8, dt=3600.0, shards=4)
        e.run(2)
        st = e.bodies
        chk = float(st.qx.double().sum() + st.vy.double().sum())
        # the psums add the two processes' partial sums in another order
        assert c0[tag] == pytest.approx(chk, rel=1e-6, abs=0.0), tag
