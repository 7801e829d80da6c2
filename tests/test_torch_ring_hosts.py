"""K14's ring across hosts (murb_tpu_torch/ops/ring.py).

Processes placed on separate hosts (``create_engine(..., host=...)``) run
the pipelined ring's protocol through staged edges: each process
boundary that crosses hosts travels through two host buffers a boundary,
one a slot parity, which this process's agent threads send and receive on
the gloo side group, tagged by the call's epoch and the step.  Two gloo
processes on hosts {a, b} (2 CPU shards each) and three on hosts
{a, a, b} (1 shard each) run the plain version through those staged ends
and must give the bits of one process with the same D shards; their
merged log is the one-process protocol order; a 2 ms sleep before every
send of one agent changes no bit.  Every worker has a hard time limit and
is killed when it runs out.  Beside them, pure-Python checks of the edge
table, the staged ends' buffer rule, the auto policy and the wrapper's
launch of the cross-host instance on a faked card (the kernel itself runs
only on the card, chip_smoke.py phase 11)."""
import contextlib
import ctypes
import json
import os
import socket
import subprocess
import sys
import types

import pytest
import torch

from murb_tpu_torch.core.init import init_galaxy
from murb_tpu_torch.models import create_engine
from murb_tpu_torch.ops import cuda, ring
from murb_tpu_torch.parallel.mesh import Mesh
from murb_tpu_torch.parallel.shard_engine import auto_ring_impl

WORKER = os.path.join(os.path.dirname(__file__), "torch_ring_hosts_worker.py")
SOFT = 2.0e8
META = torch.device("meta")
#: the worker runs: (hosts of the processes, local shards)
RUNS = {"ab": (["a", "b"], 2), "aab": (["a", "a", "b"], 1)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs():
    """Every run's workers' outputs, both runs started together."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MURB_")}
    procs = {}
    try:
        for name, (hosts, local) in RUNS.items():
            try:
                port = _free_port()
            except OSError as e:  # no socket support
                pytest.skip(f"sockets unavailable: {e}")
            procs[name] = [subprocess.Popen(
                [sys.executable, WORKER, str(i), str(len(hosts)), str(port),
                 ",".join(hosts), str(local)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env) for i in range(len(hosts))]
        outs = {name: [p.communicate(timeout=120)[0] for p in ps]
                for name, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    got = {}
    for name, ps in procs.items():
        for p, out in zip(ps, outs[name]):
            assert p.returncode == 0, f"worker of {name} failed:\n{out}"
            assert "WORKER_DONE" in out, out
        got[name] = [{line.split(" ", 1)[0]: line.split(" ", 1)[1]
                      for line in out.splitlines() if " " in line}
                     for out in outs[name]]
    return got


def _one_process_checksum(d: int) -> float:
    """One process's d-shard pipelined ring, 2 steps (one thread, as the
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        e = create_engine("shard+ring", init_galaxy(1024, 7, device="cpu"),
                          soft=SOFT, dt=3600.0, shards=d,
                          ring_impl="pipelined")
        e.run(2)
    finally:
        torch.set_num_threads(threads)
    st = e.bodies
    return float(st.qx.double().sum() + st.vy.double().sum())


@pytest.mark.parametrize("name", list(RUNS))
def test_processes_on_hosts_give_the_one_process_bits(runs, name):
    """2 steps of shard+ring across placed hosts: every process's checksum
    equals, bit for bit, one process's pipelined ring with the same D."""
    hosts, local = RUNS[name]
    sums = {float.fromhex(r["CHECKSUM"]) for r in runs[name]}
    assert sums == {_one_process_checksum(len(hosts) * local)}


@pytest.mark.parametrize("name", list(RUNS))
def test_merged_log_across_hosts_is_the_one_process_order(runs, name):
    """Each process logs its own computes with global shard indices (the
    block's origin rides in the staged buffers); merged they are the
    D-shard protocol: step k of shard s reads slot k % 2, which holds the
    block of shard (s - k) mod D."""
    hosts, local = RUNS[name]
    d = len(hosts) * local
    logs = [json.loads(r["LOG"]) for r in runs[name]]
    for p, log in enumerate(logs):
        assert {s for _, s, _, _ in log} == set(range(p * local,
                                                      (p + 1) * local))
    merged = sorted(tuple(e) for log in logs for e in log)
    assert merged == [(k, s, k % 2, (s - k) % d) for k in range(d)
                      for s in range(d)]


@pytest.mark.parametrize("name", list(RUNS))
def test_agents_carry_one_message_a_boundary_a_step(runs, name):
    """Every call of the ring across hosts (2 engine steps, the logged
    call, 2 with an agent's send delay) takes one epoch of D, and each
    agent moves D - 1 messages a call; a 2 ms sleep before the sends of
    the first or the last process's agent changes no bit."""
    hosts, local = RUNS[name]
    d, calls = len(hosts) * local, 5
    for r in runs[name]:
        agents = json.loads(r["AGENTS"])
        assert agents["epoch"] == calls * d
        assert agents["moved"] == {"out": calls * (d - 1),
                                   "in": calls * (d - 1)}
        assert r["DELAYS"] == "same"


# ------------------------------------------------ the protocol's tables
@pytest.mark.parametrize("hosts,l,staged,ipc", [
    # 2 hosts x 1 process x 1 shard: both boundaries staged
    (["a", "b"], 1, {("recv", 1, 0), ("recv", 0, 1), ("capacity", 1, 0),
                     ("send", 1, 0), ("capacity", 0, 1), ("send", 0, 1)},
     set()),
    # 2 hosts x 1 process x 2 shards
    (["a", "b"], 2, {("recv", 3, 0), ("recv", 1, 2), ("capacity", 2, 1),
                     ("send", 2, 1), ("capacity", 0, 3), ("send", 0, 3)},
     set()),
    # 2 hosts x 2 processes x 1 shard: IPC inside a host, staged between
    (["a", "a", "b", "b"], 1,
     {("recv", 1, 2), ("capacity", 2, 1), ("send", 2, 1), ("recv", 3, 0),
      ("capacity", 0, 3), ("send", 0, 3)},
     {("recv", 0, 1), ("capacity", 1, 0), ("send", 1, 0), ("recv", 2, 3),
      ("capacity", 3, 2), ("send", 3, 2)}),
    # 4 hosts x 1 x 1: every boundary staged
    (["a", "b", "c", "d"], 1,
     {(e, (g - 1) % 4 if e == "recv" else (g + 1) % 4, g)
      for g in range(4) for e in ("recv", "capacity", "send")}, set()),
])
def test_edges_across_hosts(hosts, l, staged, ipc):
    """Three edges a shard; inside a process a CUDA event, between two
    processes of one host an IPC flag, between hosts a staged edge."""
    p = len(hosts)
    edges = ring.ring_edges(p, l, hosts)
    assert len(edges) == 3 * p * l
    kinds = {k: {(e, a, b) for e, a, b, kind in edges if kind == k}
             for k in ("event", "ipc", "staged")}
    assert kinds["staged"] == staged and kinds["ipc"] == ipc
    for e, a, b, kind in edges:
        assert (kind == "event") == (a // l == b // l)
    # one host: no staged edge, the table of the ring across processes
    assert {k for *_, k in ring.ring_edges(p, l, ["a"] * p)} <= {"event",
                                                                 "ipc"}


@pytest.mark.parametrize("d", [2, 3, 4])
def test_staged_buffers_are_refilled_only_once_drained(d):
    """Three calls of one staged end (their epochs from a counter that
    other rings advance too): the emptied value a filler waits for before
    filling buffer k % 2 is exactly the one written when that buffer was
    last drained, and every filled value of a call is above every value of
    the calls before it (no stale flag passes)."""
    bases, prev, last_drained, seen = [0, 3 * d + 1, 9 * d], 0, {}, []
    for base in bases:
        for k in range(d - 1):
            want = last_drained.get(k % 2, 0)
            if k >= 2 or base == bases[0]:
                assert ring.stage_wait(base, k, prev) == want
            else:   # the previous call's last value covers both buffers
                assert ring.stage_wait(base, k, prev) >= want
                assert ring.stage_wait(base, k, prev) == prev
            last_drained[k % 2] = base + k + 1
            seen.append(base + k + 1)
        prev = base + d - 1
        assert prev == max(last_drained.values())
    assert seen == sorted(set(seen))


def test_auto_takes_the_pipelined_ring_across_hosts():
    """auto: pipelined on an all-CUDA mesh whose processes stand on several
    hosts, and no host exchange is made for the choice."""
    m = Mesh([torch.device("cuda", 0)] * 2, process_count=2, host="a")
    assert auto_ring_impl(m) == "pipelined" and m._hosts is None
    m._hosts = ["a", "b"]
    assert auto_ring_impl(m) == "pipelined"


def test_mesh_host_keyword_names_the_host_of_the_exchange(monkeypatch):
    """``host`` is what the host exchange reports for this process (the
    machine's name otherwise)."""
    from murb_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "host_name", lambda: "machine")
    assert mesh_mod.make_mesh(2, device="cpu", host="h1").hosts == ["h1"]
    assert mesh_mod.make_mesh(2, device="cpu").hosts == ["machine"]


# ---------------------------------------- the wrapper on a faked card
class _FakeLib:
    """csrc/ring.cu's setup entries as the wrapper calls them: regions and
    handles numbered by process and shard, one card (one UUID) for every
    process, staged ends in host memory."""

    def __init__(self, pi):
        self.pi, self.made, self.opened, self.stages = pi, 0, [], []

    def __call__(self, name, *a):
        if name == "murb_ring_ipc_alloc":
            dev, ld, size, ptr, handle = a
            ptr._obj.value = 0x1000 * (self.pi + 1) + self.made
            tag = f"h{self.pi}.{self.made}".encode()
            ctypes.memmove(handle, tag, len(tag))
            self.made += 1
        elif name == "murb_ring_card_uuid":
            ctypes.memmove(a[1], b"0" * 32, 32)
        elif name == "murb_ring_ipc_open":
            dev, handle, ptr = a
            self.opened.append(handle.raw.rstrip(b"\0").decode())
            ptr._obj.value = 0x9000 + len(self.opened)
        elif name == "murb_ring_stage_alloc":
            dev, nbytes, ptr = a
            mem = ctypes.create_string_buffer(ring.STAGE_HEAD + 2 * nbytes)
            self.stages.append((dev, nbytes, mem))
            ptr._obj.value = ctypes.addressof(mem)
        else:
            self.launch = (name, a)


class _FakeAgents:
    def __init__(self):
        self.base, self.jobs = 0, []

    def epoch(self, d):
        base, self.base = self.base, self.base + d
        return base

    def submit(self, end, base, d, delay_ns=0):
        prev, end.last = end.last, base + d - 1
        self.jobs.append((end.side, end.peer, base, prev, delay_ns))


@pytest.fixture
def fake_hosts(monkeypatch):
    """Process ``pi`` of a mesh placed on ``hosts`` (1 shard a process) on
    a faked card: cuda.launch recorded, the exchange answered for every
    process, the agents replaced by a recorder."""
    def make(pi, hosts, b16=False):
        lib, agents = _FakeLib(pi), _FakeAgents()
        stream = types.SimpleNamespace(cuda_stream=0)
        monkeypatch.setattr(cuda, "launch", lib)
        monkeypatch.setattr(cuda, "resident", lambda *a: 13)
        monkeypatch.setattr(cuda, "sm_count", lambda dev: 132)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev: stream)
        monkeypatch.setattr(ring, "_side_streams", lambda dev, s: (stream,
                                                                   stream))
        monkeypatch.setattr(ring, "_inbound_stream", lambda dev: stream)
        monkeypatch.setattr(ring, "_agents", lambda: agents)
        monkeypatch.setattr(ring, "_IPC", {})
        monkeypatch.setattr(ring, "_HELD", [])
        monkeypatch.setattr(ring, "_ENDS", {})
        monkeypatch.setattr(ring, "_register_release", lambda: None)
        for attr in ("launches", "bf16_launches", "ipc_launches",
                     "ipc_bf16_launches", "hosts_launches",
                     "hosts_bf16_launches"):
            monkeypatch.setattr(ring.acc_ring_pipelined, attr, 0)
        p = len(hosts)
        mesh = Mesh([torch.device("cuda", 0)], process_index=pi,
                    process_count=p)
        mesh._hosts = hosts

        def exchange(obj):
            return [dict(obj, handles=[f"h{q}.0".encode().ljust(64, b"\0")])
                    for q in range(p)]
        mesh.all_gather_object = exchange
        empty = torch.empty
        monkeypatch.setattr(torch, "empty", lambda *a, **kw: empty(
            *a, **dict(kw, device=META)))
        monkeypatch.setattr(cuda, "kernel_inputs",
                            lambda tag, dev, n, *t, **kw: list(t))
        dt = torch.bfloat16 if b16 else torch.float32
        qs = [tuple(torch.empty(1001, dtype=dt, device=META)
                    for _ in range(3))]
        gs = [torch.empty(1001, dtype=dt, device=META)]
        return lib, agents, mesh, qs, gs
    return make


@pytest.mark.parametrize("pi,hosts,left,right,b16", [
    (1, ["a", "b"], "staged", "staged", False),
    (1, ["a", "b"], "staged", "staged", True),
    (0, ["a", "a", "b", "b"], "staged", "ipc", False),
    (1, ["a", "a", "b", "b"], "ipc", "staged", True),
    (2, ["a", "b", "c", "d"], "staged", "staged", False),
])
def test_wrapper_launches_the_cross_host_instance(fake_hosts, pi, hosts,
                                                  left, right, b16):
    """On a mesh whose processes stand on several hosts the wrapper maps
    only the IPC neighbours, makes a pinned staged end for each boundary
    that crosses hosts (2 buffers of a slot, 16 n or 8 ld bytes; made
    once), counts every process's shards on the one card for K3's split,
    launches the cross-host instance with both epochs and the sending
    end's previous value, and gives the agents one job an end a call."""
    lib, agents, mesh, qs, gs = fake_hosts(pi, hosts, b16)
    p, d = len(hosts), len(hosts)
    ld = ring.slot_stride(1001) if b16 else 1001
    for call in range(3):
        ring.ring_sums(mesh, qs, gs, SOFT, host_delay_ns=7)
        name, a = lib.launch
        assert name == "murb_ring_pipelined_hosts" + ("_bf16" if b16 else "")
        assert a[:4] == (1, d, pi, 1001) and (not b16 or a[4] == ld)
        (l_ptr, r_ptr, epoch, in_stage, out_stage, sbase,
         out_prev) = a[-13:-6]
        assert epoch == ring.flag_epoch(call, d) and sbase == call * d
        assert (l_ptr == 0) == (left == "staged") == (in_stage is not None)
        assert (r_ptr == 0) == (right == "staged") == (out_stage
                                                       is not None)
        assert out_prev == (0 if call == 0 or right == "ipc"
                            else sbase - 1)
        assert a[-3:-1] == ring.ring_split(1001, 132, 13, d)
    assert [n for _, n, _ in lib.stages] == [
        4 * ld * (2 if b16 else 4)] * [left, right].count("staged")
    want = []
    for call in range(3):
        if right == "staged":
            want.append(("out", (pi + 1) % p, call * d,
                         call * d - 1 if call else 0, 7))
        if left == "staged":
            want.append(("in", (pi - 1) % p, call * d,
                         call * d - 1 if call else 0, 0))
    assert agents.jobs == want
    count = "hosts_bf16_launches" if b16 else "hosts_launches"
    assert getattr(ring.acc_ring_pipelined, count) == 3 * d
    assert ring.acc_ring_pipelined.ipc_launches == 0
    assert len(lib.opened) == [left, right].count("ipc")
