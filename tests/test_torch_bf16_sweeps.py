"""The bf16 instances of K5 and K6 (csrc/phi_rows.cu, csrc/phi.cu), K13
(csrc/mxu.cu) and
K14 (csrc/ring.cu), on the CPU.

The kernels run only on the card.  Here:

  * each wrapper's route, through its own code on meta tensors (a device
    that is not the CPU, so the wrapper takes its CUDA path; the launches
    are recorded, not run): the entry it picks for all-bf16, mixed and
    fp32 inputs, the counter it bumps, and that an all-bf16 call hands the
    kernel the body arrays as they are (no fp32 copy), a failed bf16
    launch raising;
  * every ``extern "C"`` entry's parameter kinds, in order, against its
    ctypes signature (an arity check alone passed a swapped pair);
  * the bf16 paths these kernels serve, by their plain versions, against
    murb_tpu: the merger's tracked energy (K6 fused, and K4 + K5),
    ``shard+ring`` on a 2-shard CPU mesh and K13, at the tolerances
    ROADMAP.md Queue 3 records for bf16.
"""
import contextlib
import ctypes
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_within_rel
from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu.models import create_engine as jcreate
from murb_tpu_torch.core.init import milkyway_andromeda_masks
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.models import create_engine
from murb_tpu_torch.ops import cuda, hybrid, mxu, ring

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0
BF16 = torch.bfloat16
META = torch.device("meta")


# ------------------------------------------------------- the wrappers' route
class _IntArrays:
    """``ctypes.c_int * d`` for the ring's device ids, a meta device's
    index (None) taken as 0."""

    def __mul__(self, d):
        return lambda *ids: (ctypes.c_int * d)(*(i or 0 for i in ids))


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA path on meta tensors: ``launches`` records each
    (entry, arguments), ``inputs`` each ``kernel_inputs`` result."""
    seen = types.SimpleNamespace(launches=[], inputs=[], rows=[])
    kernel_inputs, weight_rows = cuda.kernel_inputs, hybrid.phi_weight_rows

    def spy_inputs(*a, **kw):
        out = kernel_inputs(*a, **kw)
        seen.inputs.append(out)
        return out

    def spy_rows(*a, **kw):
        out = weight_rows(*a, **kw)
        seen.rows.append(out)
        return out

    stream = types.SimpleNamespace(cuda_stream=0)
    monkeypatch.setattr(cuda, "require_cuda", lambda tag, t: None)
    monkeypatch.setattr(cuda, "launch",
                        lambda name, *a: seen.launches.append((name, a)))
    monkeypatch.setattr(cuda, "resident", lambda *a: 4)
    monkeypatch.setattr(cuda, "sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda, "stream", lambda dev: 0)
    monkeypatch.setattr(cuda, "kernel_inputs", spy_inputs)
    monkeypatch.setattr(hybrid, "phi_weight_rows", spy_rows)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream)
    monkeypatch.setattr(ring, "_side_streams", lambda dev, s: (stream,
                                                               stream))
    monkeypatch.setattr(ring, "ctypes", types.SimpleNamespace(
        c_void_p=ctypes.c_void_p, c_float=ctypes.c_float,
        addressof=ctypes.addressof, c_int=_IntArrays()))
    for fn in (hybrid.phi_rows_rect, hybrid.acc_phi_rows_hybrid,
               mxu.acc_mxu_rect, ring.acc_ring_pipelined):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "bf16_launches", 0)
    return seen


def _bodies(n, dtypes):
    """Meta body arrays: x, y, z of the targets, then of the sources and
    G*m, each of its case's dtype."""
    return [torch.empty(n, dtype=dt, device=META) for dt in dtypes]


CASES = {"bf16": (BF16,) * 7,
         "mixed": (BF16,) * 6 + (torch.float32,),   # G*m float32
         "fp32": (torch.float32,) * 7}


def _call(kernel, case, n=1000):
    """Run one wrapper on meta tensors; returns (its function, the body
    arrays it took, in kernel_inputs order)."""
    b = _bodies(n, CASES[case])
    if kernel == "K5":
        # K5 reads no G*m: its mixed call gives float32 sources
        if case == "mixed":
            b[3:6] = [v.float() for v in b[3:6]]
        rows = torch.empty((2, n), dtype=BF16, device=META)
        hybrid.phi_rows_rect(*b[:6], rows, SOFT)
        return hybrid.phi_rows_rect, b[:6]
    if kernel == "K6":
        rows = torch.empty((2, n), dtype=BF16, device=META)
        hybrid.acc_phi_rows_hybrid(*b[:3], b[6], rows, SOFT)
        return hybrid.acc_phi_rows_hybrid, b[:3] + b[6:]
    if kernel == "K13":
        mxu.acc_mxu_rect(*b, SOFT)
        return mxu.acc_mxu_rect, b
    mesh = types.SimpleNamespace(distributed=False, local_size=2,
                                 devices=[META] * 2, all_cuda=True)
    second = _bodies(n, CASES[case])
    ring.acc_ring_pipelined(mesh, [b[:3], second[:3]], [b[6], second[6]],
                            SOFT)
    return ring.acc_ring_pipelined, b[:3] + b[6:] + second[:3] + second[6:]


ENTRIES = {"K5": "murb_phi_rows_rect", "K6": "murb_acc_phi_rows",
           "K13": "murb_mxu_rect", "K14": "murb_ring_pipelined"}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel", list(ENTRIES))
def test_wrapper_picks_the_instance(fake_card, kernel, case):
    """All-bf16 bodies launch the bf16 entry on the arrays as they are
    and count in ``bf16_launches``; a mixed or fp32 call the fp32 entry
    on float32 arrays (the bf16 ones upcast exactly) in ``launches``."""
    fn, bodies = _call(kernel, case)
    b16 = case == "bf16"
    entry = ENTRIES[kernel] + ("_bf16" if b16 else "")
    assert [name for name, _ in fake_card.launches] == [entry]
    args = fake_card.launches[0][1]
    assert len(args) == len(cuda._SIGNATURES[entry])
    count = 4 if kernel == "K14" else 1     # the ring: D^2 sweeps
    assert (fn.bf16_launches, fn.launches) == ((count, 0) if b16 else
                                               (0, count))
    taken = [t for out in fake_card.inputs for t in out][:len(bodies)]
    assert [t.dtype for t in taken] == [BF16 if b16 else torch.float32] * \
        len(bodies)
    if b16:     # the very tensors: no copy of a body array
        assert all(t is v for t, v in zip(taken, bodies))
    # K5's and K6's weight rows: float32 in both instances
    assert all(r.dtype == torch.float32 for r in fake_card.rows)


def test_k5_bf16_takes_three_source_rows(fake_card):
    """K5's bf16 entry takes the three source coordinate rows and no G*m
    (its sweep stages three raw rows a tile, never a copy from a null
    row); a source view that does not start 4-byte aligned is copied, the
    targets are not."""
    base = torch.empty(1001, dtype=BF16, device=META)
    odd = base[1:]
    assert odd.data_ptr() % 4 == 2
    rows = torch.empty((1, 1000), dtype=torch.float32, device=META)
    hybrid.phi_rows_rect(odd, odd, odd, odd, odd, odd, rows, SOFT)
    (name, args), = fake_card.launches
    assert name == "murb_phi_rows_rect_bf16"
    assert args[3] == 1000 and args[7] == 1000      # ni, then nj
    assert all(a % 4 == 2 for a in args[:3])        # targets as they are
    assert all(a % 4 == 0 for a in args[4:7])       # sources aligned
    assert len(args) == 18 and args[9] == 1         # rows, then R = 1
    src = (Path(cuda.CSRC) / "tile.cuh").read_text()
    assert "constexpr int kRawRows = kForce ? 4 : 3;" in src
    assert "for (int c = 0; c < kRawRows; ++c)" in src
    phi = (Path(cuda.CSRC) / "phi_rows.cu").read_text()
    k5 = phi[phi.index("murb_phi_rows_rect_bf16("):]
    assert "qxi, qyi, qzi, ni, qxj, qyj, qzj, nullptr, rows" in \
        " ".join(k5[:k5.index("}")].split())


def test_bf16_refusals_do_not_fall_back(fake_card, monkeypatch):
    """A failed bf16 launch raises and nothing runs the fp32 instance;
    K5's and K6's bf16 instances exist at 256x256 only, and another
    geometry raises before any launch."""
    def refuse(name, *a):
        fake_card.launches.append((name, a))
        raise RuntimeError(f"{name}: CUDA error 1 at launch")

    monkeypatch.setattr(cuda, "launch", refuse)
    for kernel in ENTRIES:
        fake_card.launches.clear()
        with pytest.raises(RuntimeError, match="_bf16: CUDA error"):
            _call(kernel, "bf16")
        assert [n for n, _ in fake_card.launches] == [ENTRIES[kernel]
                                                      + "_bf16"]
    fake_card.launches.clear()
    b = _bodies(512, CASES["bf16"])
    rows = torch.empty((1, 512), dtype=BF16, device=META)
    with pytest.raises(ValueError, match="256x256 only"):
        hybrid.phi_rows_rect(*b[:6], rows, SOFT, block_i=128)
    with pytest.raises(ValueError, match="256x256 only"):
        hybrid.acc_phi_rows_hybrid(*b[:3], b[6], rows, SOFT, block_j=512)
    assert not fake_card.launches


@pytest.mark.parametrize("n", [1000, 1001])
def test_bf16_ring_slots_keep_rows_aligned(fake_card, n):
    """The bf16 ring's slot rows sit ``slot_stride(n)`` values apart, even
    for an odd shard length, so each starts 4-byte aligned; the fp32
    ring's entry takes no stride."""
    assert ring.slot_stride(n) == n + n % 2
    mesh = types.SimpleNamespace(distributed=False, local_size=3,
                                 devices=[META] * 3, all_cuda=True)
    qs = [_bodies(n, (BF16,) * 3) for _ in range(3)]
    gs = [torch.empty(n, dtype=BF16, device=META) for _ in range(3)]
    out = ring.acc_ring_pipelined(mesh, qs, gs, SOFT)
    (name, args), = fake_card.launches
    assert name == "murb_ring_pipelined_bf16"
    assert args[:3] == (3, n, ring.slot_stride(n))
    assert ring.acc_ring_pipelined.bf16_launches == 9
    assert all(a.dtype == BF16 for acc in out for a in acc)


# --------------------------------------------------- the C entries' order
def _kind(param: str) -> str:
    """The ctypes kind of one C parameter declaration."""
    t = " ".join(param.split()).rsplit(" ", 1)[0]
    if "*" in t or t == "cudaStream_t":
        return "_P"
    return {"int": "_I", "float": "_F", "long long": "_L"}[t]


def test_c_entries_match_their_signatures_in_order():
    """Every ``extern "C"`` entry's parameter kinds (pointer, int, float,
    long long), in order, are its ctypes signature's: the new bf16 entries
    of K5, K6, K13 and K14 among them."""
    kinds = {_P: "_P", _I: "_I", _F: "_F", _L: "_L"}
    entries = {}
    for src in sorted(Path(cuda.CSRC).glob("*.cu")):
        for m in re.finditer(r'extern "C"\s+\w+\s+(murb_\w+)\s*\(([^)]*)\)',
                             src.read_text()):
            entries[m.group(1)] = [_kind(p) for p in m.group(2).split(",")
                                   if p.strip()]
    assert {"murb_phi_rows_rect_bf16", "murb_acc_phi_rows_bf16",
            "murb_phi_resident_bf16", "murb_mxu_rect_bf16",
            "murb_mxu_resident_bf16", "murb_ring_pipelined_bf16"} <= \
        set(entries)
    assert entries == {k: [kinds[a] for a in v]
                       for k, v in cuda._SIGNATURES.items()}
    # each bf16 instance takes its fp32 instance's arguments (the ring's
    # slot stride after n)
    for k in ("murb_phi_rows_rect", "murb_acc_phi_rows", "murb_mxu_rect",
              "murb_phi_resident", "murb_mxu_resident"):
        assert entries[k + "_bf16"] == entries[k], k
    ring_b16 = entries["murb_ring_pipelined_bf16"]
    assert ring_b16[:2] + ring_b16[3:] == entries["murb_ring_pipelined"]


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong


# ------------------------------------- the bf16 paths against murb_tpu
def f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def port_state(js) -> BodyState:
    """murb_tpu's state as the port's, the same values and dtype."""
    return BodyState.from_numpy({k: np.asarray(getattr(js, k))
                                 for k in FIELDS}, js.n, js.padding, "cpu")


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_merger_energy_matches_murb_tpu(fused):
    """``tpu+tracking+multi`` on murb_tpu's bf16 galaxy (N=2048, seed 123,
    as tests/test_torch_bf16_cli.py) with the two merger masks, K4 + K5
    or K6 fused (``fused_exact``, the card's ``create_engine`` path), on
    both packages.  K4 + K5 (the CLI's path; K5's rows float32): energy
    row 0 within 1e-3 of the float64 energy of the same bf16 state, each
    galaxy's own summed (the rows take the softening unrounded), within
    2e-2 of murb_tpu's, |L| within 1e-4 (ROADMAP.md Queue 3).  K6 returns
    its rows in the state's dtype, as murb_tpu's (hybrid.py:473), and the
    energy subtracts each body's self term G m_i / eps from its bf16 row:
    row 0 misses float64 by 4.4e-3 here (murb_tpu 3.5e-3; on the 1024
    galaxy 1.3e-2 and 3.0e-2), held within 2e-2 of float64 and of
    murb_tpu, the bound this file holds murb_tpu's bf16 path to."""
    from murb_tpu_torch.core import metrics as tm

    js = jinit.init_galaxy(2048, 123, dtype=jnp.bfloat16)
    masks = milkyway_andromeda_masks(js.npad, js.n)
    ref = jcreate("tpu+tracking+multi", js, soft=SOFT, dt=DT, masks=masks,
                  num_iterations=2, fused_exact=fused)
    s0 = port_state(js)
    eng = create_engine("tpu+tracking+multi", s0, soft=SOFT, dt=DT,
                        masks=masks, num_iterations=2, fused_exact=fused)
    for e in (ref, eng):
        for _ in range(2):
            e.compute_one_iteration()
    assert eng.bodies.dtype == BF16
    ht, hj = eng.finalize_history(), ref.finalize_history()
    exact = 0.0
    for mask in masks:
        sg = tm.masked(s0, torch.from_numpy(mask))
        q64 = [v.double() for v in (sg.qx, sg.qy, sg.qz, sg.m)]
        pe = tm.potential_energy_per_body(*q64, tm._gm(sg).double(), SOFT)
        ke = tm.kinetic_energy_per_body(sg.m, sg.vx, sg.vy, sg.vz)
        exact += float((0.5 * pe + 0.5 * ke).sum())
    tol = 2e-2 if fused else 1e-3
    assert abs(ht.energies[0] - exact) <= tol * abs(exact), \
        (ht.energies[0], exact, hj.energies[0])
    np.testing.assert_allclose(ht.energies, hj.energies, rtol=2e-2)
    np.testing.assert_allclose(ht.ang_momentums, hj.ang_momentums,
                               rtol=1e-4)


def test_bf16_shard_ring_two_shards_matches_murb_tpu():
    """``shard+ring`` with ``ring_impl="pipelined"`` on a 2-shard CPU mesh
    (K14's plain version, the two-slot protocol) with the bf16 galaxy: the
    first step's accelerations within one bf16 rounding (WithinRel 1e-2)
    of the float64 sweep, the positions after 2 steps within murb_tpu's
    ring at tests/test_oracle.py's bf16 tolerance (WithinRel 2e-2, rms
    floor 2e-2).  murb_tpu's own pipelined ring cannot take a bf16 state
    on the CPU (ring_pallas.py:67-71 stores the bf16 block into its fp32
    slot uncast, which interpret mode refuses; ROADMAP.md Queue 3), so
    its ``ppermute`` ring is the reference."""
    from murb_tpu_torch.ops.naive import acc_rect

    js = jinit.init_galaxy(1024, 123, dtype=jnp.bfloat16)
    ref = jcreate("shard+ring", js, soft=SOFT, dt=DT, shards=2,
                  ring_impl="ppermute")
    s0 = port_state(js)
    eng = create_engine("shard+ring", s0, soft=SOFT, dt=DT, shards=2,
                        ring_impl="pipelined")
    assert eng.n_shards == 2 and eng.ring_impl == "pipelined"
    eng.compute_one_iteration()
    q64 = [v.double() for v in (s0.qx, s0.qy, s0.qz)]
    exact = acc_rect(*q64, *q64, eng._gm(s0).double(), SOFT)
    for c, (a, r) in enumerate(zip(eng.accelerations, exact)):
        assert a.dtype == BF16
        assert_within_rel(f64(a[:s0.npad]), f64(r), 1e-2,
                          f"shard+ring bf16 acc {c}")
    eng.compute_one_iteration()
    for _ in range(2):
        ref.compute_one_iteration()
    a, b = ref.bodies.unpadded(), eng.bodies.unpadded()
    for c in ("qx", "qy", "qz"):
        assert_within_rel(f64(b[c]), f64(a[c]), 2e-2,
                          f"shard+ring bf16 {c} after 2 steps",
                          rms_floor=2e-2)


def test_bf16_mxu_matches_murb_tpu():
    """K13's plain version on the bf16 galaxy: the operands formed in fp32
    from the bf16 bodies (the port's rule; murb_tpu forms them in bf16,
    mxu.py:117-142) and the forces rounded to bf16 once.  Within one bf16
    rounding (WithinRel 1e-2, no floor) of the float64 sweep and of
    murb_tpu's kernel on the values upcast; within 2e-2 (rms floor 2e-2)
    of murb_tpu's bf16 path, which itself misses float64 by 0.72x of
    WithinRel 1e-2 with a 1e-2 floor (ROADMAP.md Queue 3)."""
    from murb_tpu.ops.mxu import acc_mxu_rect as jmxu
    from murb_tpu_torch.ops.naive import acc_rect

    js = jinit.init_galaxy(2048, 123, dtype=jnp.bfloat16)
    gm = jnp.asarray((np.float32(G) * np.asarray(js.m).astype(np.float32))
                     .astype(jnp.bfloat16))
    j = (js.qx, js.qy, js.qz, gm)
    t = [torch.from_numpy(np.asarray(a).astype(np.float32)).to(BF16)
         for a in j]
    got = mxu.acc_mxu_rect(*t[:3], *t, SOFT)
    assert all(g.dtype == BF16 for g in got)
    q64 = [v.double() for v in t]
    exact = acc_rect(*q64[:3], *q64, SOFT)
    up = [a.astype(jnp.float32) for a in j]
    ref32 = jmxu(*up[:3], *up, SOFT)
    ref16 = jmxu(*j[:3], *j, SOFT)
    for c in range(3):
        assert_within_rel(f64(got[c]), f64(exact[c]), 1e-2,
                          f"bf16 K13 {c} vs float64")
        assert_within_rel(f64(got[c]), f64(ref32[c]), 1e-2,
                          f"bf16 K13 {c} vs murb_tpu on the upcast values")
        assert_within_rel(f64(got[c]), f64(ref16[c]), 2e-2,
                          f"bf16 K13 {c} vs murb_tpu's bf16 path",
                          rms_floor=2e-2)
