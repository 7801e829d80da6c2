"""K14's ring across processes (murb_tpu_torch/ops/ring.py).

Two OS processes of 2 CPU shards each, one gloo group, play the pipelined
ring's protocol (its plain version, the boundary slot through the mesh's
ppermute) and must give the bits of one process with 4 shards at
``ring_impl="pipelined"`` (itself held to murb_tpu's interpret-mode ring by
tests/test_torch_ring.py); their merged log is the one-process protocol
order; when the same processes report host names that differ, the ring
runs across those hosts (staged edges) and gives the same bits.  Every
worker has a hard time limit and is killed when it runs out.  Beside
them, pure-Python checks of the edges that cross a process, the flags'
epochs, the regions' exchange and the wrapper's launch of the
cross-process instance (on meta tensors: the kernel itself runs only on
the card, chip_smoke.py phase 11)."""
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

WORKER = os.path.join(os.path.dirname(__file__),
                      "torch_ring_processes_worker.py")
SOFT = 2.0e8
META = torch.device("meta")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs():
    """The two workers' outputs (run once for the module's tests)."""
    try:
        port = _free_port()
    except OSError as e:  # no socket support
        pytest.skip(f"sockets unavailable: {e}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MURB_")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
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
        assert "WORKER_DONE" in out, out
    return [{line.split(" ", 1)[0]: line.split(" ", 1)[1]
             for line in out.splitlines() if " " in line} for out in outs]


def test_two_processes_give_the_one_process_bits(runs):
    """2 processes x 2 shards, 2 steps: both checksums equal, bit for bit,
    one process's 4-shard pipelined ring (one thread, as the workers)."""
    c0, c1 = (float.fromhex(r["CHECKSUM"]) for r in runs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        e = create_engine("shard+ring", init_galaxy(1024, 7, device="cpu"),
                          soft=SOFT, dt=3600.0, shards=4,
                          ring_impl="pipelined")
        e.run(2)
    finally:
        torch.set_num_threads(threads)
    st = e.bodies
    chk = float(st.qx.double().sum() + st.vy.double().sum())
    assert c0 == c1 == chk


def test_merged_log_is_the_one_process_protocol_order(runs):
    """Each process logs its own computes with global shard indices; merged
    they are the 4-shard protocol: step k of shard s reads slot k % 2,
    which holds the block of shard (s - k) mod 4."""
    logs = [json.loads(r["LOG"]) for r in runs]
    assert {s for _, s, _, _ in logs[0]} == {0, 1}
    assert {s for _, s, _, _ in logs[1]} == {2, 3}
    merged = sorted(tuple(e) for log in logs for e in log)
    assert merged == [(k, s, k % 2, (s - k) % 4) for k in range(4)
                      for s in range(4)]


def test_processes_on_two_hosts_are_refused(runs):
    """Processes that report different host names are not refused: the
    pipelined ring runs across their hosts (every process boundary through
    staged ends) and gives the bits of the same processes on one host;
    auto keeps the ppermute ring on CPU shards."""
    for r in runs:
        assert r["HOSTS"] == "ran ppermute same host-0,host-1", r["HOSTS"]


# ------------------------------------------------ the protocol's tables
@pytest.mark.parametrize("p,l,want", [
    (1, 4, set()),
    (2, 2, {("recv", 3, 0), ("recv", 1, 2), ("capacity", 2, 1),
            ("send", 2, 1), ("capacity", 0, 3), ("send", 0, 3)}),
    (4, 1, {(e, (g - 1) % 4 if e == "recv" else (g + 1) % 4, g)
            for g in range(4) for e in ("recv", "capacity", "send")}),
    (3, 1, {(e, (g - 1) % 3 if e == "recv" else (g + 1) % 3, g)
            for g in range(3) for e in ("recv", "capacity", "send")}),
])
def test_edges_that_cross_a_process(p, l, want):
    """Three edges a shard (recv from the left, capacity and send from the
    right); those that cross a process of one host are the flags ("ipc"):
    a process's first shard's recv and its last shard's capacity and
    send; the others are CUDA events."""
    edges = ring.ring_edges(p, l)
    assert len(edges) == 3 * p * l
    assert {(e, a, b) for e, a, b, kind in edges if kind == "ipc"} == want
    for e, a, b, kind in edges:
        assert kind == ("ipc" if a // l != b // l else "event")
        assert (e == "recv") == (a == (b - 1) % (p * l))


@pytest.mark.parametrize("d", [2, 3, 4])
def test_flag_epochs_grow_over_three_calls(d):
    """The flags csrc/ring.cu writes after step k (epoch + k + 1) and waits
    for before step k > 0 (epoch + k) at calls 0, 1, 2: every wait of a
    call is above every value written by the calls before it, and the
    writes only grow, so no flag is reset and no call passes on a stale
    one."""
    epochs = [ring.flag_epoch(c, d) for c in range(3)]
    assert epochs == [0, d, 2 * d]
    writes = [[e + k + 1 for k in range(d)] for e in epochs]
    waits = [[e + k for k in range(1, d)] for e in epochs]
    flat = [v for w in writes for v in w]
    assert flat == sorted(set(flat))
    for c in range(1, 3):
        assert min(waits[c]) > max(writes[c - 1])
    # the end of a call: the right process's last writes have landed
    assert max(writes[0]) == epochs[1]
    with pytest.raises(RuntimeError, match="32-bit"):
        ring.flag_epoch(2 ** 32 // d, d)


# ---------------------------------------- the wrapper on a faked card
class _FakeLib:
    """The IPC entries of csrc/ring.cu as the setup calls them: regions
    and handles numbered by process and shard, every card one UUID."""

    def __init__(self, pi):
        self.pi, self.made, self.opened = pi, 0, []

    def __call__(self, name, *a):
        if name == "murb_ring_ipc_alloc":
            dev, ld, size, ptr, handle = a
            ptr._obj.value = 0x1000 * (self.pi + 1) + self.made
            name = f"h{self.pi}.{self.made}".encode()
            ctypes.memmove(handle, name, len(name))
            self.made += 1
        elif name == "murb_ring_card_uuid":
            ctypes.memmove(a[1], b"0" * 32, 32)
        elif name == "murb_ring_ipc_open":
            dev, handle, ptr = a
            self.opened.append(handle.raw.rstrip(b"\0").decode())
            ptr._obj.value = 0x9000 + len(self.opened)
        else:
            self.launch = (name, a)


@pytest.fixture
def fake_ipc(monkeypatch):
    """A process 1 of 2 (``shards`` a process) on a faked card: cuda.launch
    recorded, the host exchange answered for both processes."""
    def make(shards, b16=False):
        lib = _FakeLib(1)
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
        monkeypatch.setattr(ring, "_IPC", {})
        monkeypatch.setattr(ring, "_HELD", [])
        monkeypatch.setattr(ring, "_register_release", lambda: None)
        for attr in ("launches", "bf16_launches", "ipc_launches",
                     "ipc_bf16_launches", "hosts_launches",
                     "hosts_bf16_launches"):
            monkeypatch.setattr(ring.acc_ring_pipelined, attr, 0)
        mesh = Mesh([torch.device("cuda", 0)] * shards, process_index=1,
                    process_count=2)
        mesh._hosts = ["here", "here"]

        def exchange(obj):
            other = dict(obj, handles=[f"h0.{k}".encode().ljust(64, b"\0")
                                       for k in range(shards)])
            return [other, obj]
        mesh.all_gather_object = exchange
        # outputs and scratch on the meta device; kernel_inputs on meta
        # tensors (its device and shape checks skipped)
        empty = torch.empty
        monkeypatch.setattr(torch, "empty", lambda *a, **kw: empty(
            *a, **dict(kw, device=META)))
        monkeypatch.setattr(cuda, "kernel_inputs",
                            lambda tag, dev, n, *t, **kw: list(t))
        dt = torch.bfloat16 if b16 else torch.float32
        qs = [tuple(torch.empty(1001, dtype=dt, device=META)
                    for _ in range(3)) for _ in range(shards)]
        gs = [torch.empty(1001, dtype=dt, device=META)
              for _ in range(shards)]
        return lib, mesh, qs, gs
    return make


@pytest.mark.parametrize("shards,b16", [(1, False), (2, False), (2, True)])
def test_wrapper_launches_the_cross_process_instance(fake_ipc, shards,
                                                     b16):
    """On a mesh of two processes of this host the wrapper makes the
    regions once, maps the neighbour regions it writes into (the other
    process's first and last shard: one region at 1 shard a process),
    counts every process's shards on the card for K3's split, and
    launches the cross-process instance with the call's epoch."""
    lib, mesh, qs, gs = fake_ipc(shards, b16)
    for call in range(3):
        ring.ring_sums(mesh, qs, gs, SOFT)
        name, a = lib.launch
        assert name == "murb_ring_pipelined_ipc" + ("_bf16" if b16 else "")
        d = 2 * shards
        assert a[:4] == (shards, d, shards, 1001)
        if b16:
            assert a[4] == ring.slot_stride(1001)
        # ... the regions, the left and right neighbour, the epoch, soft2
        left, right, epoch = a[-9:-6]
        assert epoch == ring.flag_epoch(call, d)
        slices, per = a[-3:-1]
        assert (slices, per) == ring.ring_split(1001, 132, 13, d)
    assert lib.made == shards                     # the regions, made once
    want = ["h0.0"] if shards == 1 else ["h0.1", "h0.0"]
    assert sorted(lib.opened) == sorted(want)
    assert (left == right) == (shards == 1)
    assert {left, right} == {p for _, p, mapped in ring._HELD if mapped}
    count = "ipc_bf16_launches" if b16 else "ipc_launches"
    assert getattr(ring.acc_ring_pipelined, count) == 3 * shards * d
    assert ring.acc_ring_pipelined.launches == 0
    assert ring.acc_ring_pipelined.hosts_launches == 0
    assert len(ring._HELD) == shards + len(want)


def test_processes_whose_rings_differ_are_refused(fake_ipc):
    lib, mesh, qs, gs = fake_ipc(2)
    mesh.all_gather_object = lambda obj: [dict(obj, ld=obj["ld"] + 1), obj]
    with pytest.raises(ValueError, match="rings differ"):
        ring.ring_sums(mesh, qs, gs, SOFT)


def test_auto_takes_the_pipelined_ring_on_one_host():
    """auto: pipelined on an all-CUDA mesh of one host (one process or
    several) and across hosts, ppermute on CPU shards (no host exchange
    made)."""
    def mesh(hosts):
        m = Mesh([torch.device("cuda", 0)] * 2, process_count=len(hosts))
        m._hosts = hosts
        return m
    assert auto_ring_impl(mesh(["a"])) == "pipelined"
    assert auto_ring_impl(mesh(["a", "a"])) == "pipelined"
    assert auto_ring_impl(mesh(["a", "b"])) == "pipelined"
    cpu = Mesh(["cpu"] * 2, process_count=2)
    assert auto_ring_impl(cpu) == "ppermute" and cpu._hosts is None
