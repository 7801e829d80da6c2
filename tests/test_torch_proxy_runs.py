"""K1 and K2 (csrc/proxy.cu: the run kernels of csrc/cell_runs.cuh over one
run of all the bodies, the ``OneRun`` accessor) emulated on the CPU, and
the glue their wrappers hand them.

The kernels run only on the card.  Here tests/test_torch_cell_runs.py's
fp32 emulation (basis_span's order, the P2M's items and the fold's order,
the L2P's two forms) runs over the one run, with each body's coordinate
t = clip((q - c) / h) in the box [c, h] (``OneRun::coord``), at m 4, 8, 12
and 20 and N 2047 and 20,000, the P2M with the wrapper's items (many, the
fold's split lanes) and with one item (no fold), and is held to:

  - float64 (``p2m_plain`` / ``l2p_plain``) within K1's contract (rtol
    1e-4, atol 1e-6 max|W|) and K2's (rtol 1e-4, atol 1e-5 max|a|),
    chip_smoke.py's;
  - murb_tpu's Pallas ``p2m_fused`` and ``l2p_fused_multi`` in interpret
    mode (tests/test_torch_kernels.py's reading) within the same
    contracts.

K8's runs of many items (eight cells at C = 2) take the split fold too:
held to float64 within K8's 1e-5 of max|W|.  The glue: the one run's
bounds, items and node table are built once per (n, m, device) and read
nothing back to the host.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murb_tpu import G
from murb_tpu.core import init as jinit
from murb_tpu_torch.ops import fmm_kernels as fk
from murb_tpu_torch.ops import proxy_kernels as tk
from murb_tpu_torch.ops.proxy import bounding_box
from test_torch_cell_runs import (_SYNCS, _Ops, bases, cell_t, emulate_p2m,
                                  fma, fold, rel)

torch.set_num_threads(2)
CPU = torch.device("cpu")
CSRC = Path(tk.__file__).resolve().parents[1] / "csrc"
SMS = 132   # the H100 SXM's SMs: the wrapper's items on the card


def galaxy(n: int, seed: int = 17):
    """float32 positions and G m of murb_tpu's galaxy (its first n bodies:
    the scheme pads n), and its box."""
    s = jinit.SCHEMES["galaxy"](n, seed)
    q = [torch.from_numpy(np.array(getattr(s, k)[:n], np.float32))
         for k in ("qx", "qy", "qz")]
    g = torch.from_numpy((np.asarray(s.m[:n], np.float64) * G).astype(
        np.float32))
    c, h = bounding_box(*q, g > 0)
    return q, g, c, h


def one_run_t(q, c, h):
    """OneRun::coord in fp32: clip((q - c) / h, -1, 1) a dimension."""
    return [((v - c[d]) / h[d]).clamp(-1.0, 1.0) for d, v in enumerate(q)]


def emulate_one_run_l2p(tx, ty, tz, fields, m: int):
    """(k, n) fp32 in K2's order (csrc/proxy.cu l2p_one_run_kernel): per
    body and field t_v = sum_w F[u, v, w] Sz[w], b_u = sum_v Sy[v] t_v, a =
    sum_u Sx[u] b_u, one fma a term (w past m adds F = Sz = 0: exact)."""
    Sx, Sy, Sz = bases(tx, m), bases(ty, m), bases(tz, m)
    outs = []
    for f in fields:
        F = f.reshape(m, m, m)
        acc = torch.zeros_like(tx)
        for u in range(m):
            bu = torch.zeros_like(acc)
            for v in range(m):
                t = torch.zeros_like(acc)
                for x in range(m):
                    t = fma(F[u, v, x].expand_as(t), Sz[:, x], t)
                bu = fma(Sy[:, v], t, bu)
            acc = fma(Sx[:, u], bu, acc)
        outs.append(acc)
    return torch.stack(outs)


def pallas_pad(v, n: int, fill):
    """A jnp copy of ``v`` padded to n with ``fill`` (Pallas takes whole
    blocks)."""
    out = np.full(n, fill, np.float32)
    out[:v.shape[0]] = v.numpy()
    return jnp.asarray(out)


def within(got, ref, rtol: float, atol_of_max: float) -> None:
    got, ref = got.double(), ref.double()
    atol = atol_of_max * float(ref.abs().max())
    bad = (got - ref).abs() > rtol * ref.abs() + atol
    assert not bool(bad.any()), (
        f"{int(bad.sum())} outside rtol {rtol} + {atol_of_max} max: worst "
        f"{float(((got - ref).abs() - rtol * ref.abs()).max()):.3e} vs "
        f"{atol:.3e}")


@pytest.mark.parametrize("n", [2047, 20_000])
@pytest.mark.parametrize("m", [4, 8, 12, 20])
def test_k1_one_run_emulation_within_float64_and_pallas(m, n):
    """K1's order of sums (the wrapper's items of p2m_chunk bodies and the
    split fold, and one item writing W) against float64 and murb_tpu's
    Pallas P2M, both within rtol 1e-4 + 1e-6 max|W|."""
    from murb_tpu.ops.proxy_pallas import p2m_fused

    q, g, c, h = galaxy(n)
    tx, ty, tz = one_run_t(q, c, h)
    bounds = torch.tensor([0, n])
    ref = tk.p2m_plain(*(v.double() for v in q), g.double(), c.double(),
                       h.double(), m=m)
    npad = -(-n // 2048) * 2048
    jref = torch.from_numpy(np.array(p2m_fused(
        *(pallas_pad(v, npad, float(c[d])) for d, v in enumerate(q)),
        pallas_pad(g, npad, 0.0), jnp.asarray(c.numpy()),
        jnp.asarray(h.numpy()), m=m, block=2048, interpret=True)))
    run = tk.one_run(n, m, CPU, sms=SMS)
    one = tk.one_run_items(n, n, CPU)
    assert run.nitems > 1 and one.nitems == 1
    assert fk.fold_split(run.nitems, 1) == fk.RUN_FOLD_SPLIT
    for items in (run, one):
        w = emulate_p2m(tx, ty, tz, g, bounds, items, m)[0]
        within(w, ref, 1e-4, 1e-6)
        within(w, jref, 1e-4, 1e-6)


@pytest.mark.parametrize("n", [2047, 20_000])
@pytest.mark.parametrize("m", [4, 8, 12, 20])
def test_k2_one_run_emulation_within_float64_and_pallas(m, n):
    """K2's order of sums (per body, the fields as broadcasts) for 3 and 4
    fields against float64 and murb_tpu's Pallas L2P, both within rtol
    1e-4 + 1e-5 max|a|; each body sums alone, so the blocks' bodies change
    no sum."""
    from murb_tpu.ops.proxy_pallas import l2p_fused_multi

    q, _, c, h = galaxy(n, seed=3)
    tx, ty, tz = one_run_t(q, c, h)
    rng = np.random.default_rng(m)
    fields = [torch.from_numpy(rng.standard_normal(m ** 3).astype(
        np.float32)) for _ in range(4)]
    npad = -(-n // 2048) * 2048
    got = emulate_one_run_l2p(tx, ty, tz, fields, m)
    for k in (3, 4):
        ref = tk.l2p_plain(*(v.double() for v in q), c.double(), h.double(),
                           [f.double() for f in fields[:k]], m=m)
        jref = l2p_fused_multi(
            *(pallas_pad(v, npad, float(c[d])) for d, v in enumerate(q)),
            jnp.asarray(c.numpy()), jnp.asarray(h.numpy()),
            tuple(jnp.asarray(f.numpy()) for f in fields[:k]), m=m,
            block=2048, interpret=True)
        for f in range(k):
            within(got[f], ref[f], 1e-4, 1e-5)
            within(got[f], torch.from_numpy(np.array(jref[f]))[:n], 1e-4,
                   1e-5)


@pytest.mark.parametrize("m", [8, 12])
def test_grid_p2m_split_fold_within_float64_contract(m):
    """K8 with cells of many items (C = 2, 8,192 bodies in items of 32:
    about 32 a cell, the split fold's lanes) within K8's 1e-5 of max|W|."""
    rng = np.random.default_rng(m)
    n, C = 8192, 2
    qt = [torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
          for _ in range(3)]
    gt = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    ct, ht = torch.zeros(3), torch.ones(3)
    order = fk.cell_order(*qt, ct, ht, C)
    items = fk.run_items(order.bounds, n, 32)
    assert fk.fold_split(items.nitems, C ** 3) == fk.RUN_FOLD_SPLIT
    perm, lo, cs = order.perm, order.box[:3], order.box[3:]
    cell = fk._cell_coords(torch.stack(qt), lo[:, None], cs[:, None],
                           C)[0][:, perm]
    tx, ty, tz = (cell_t(qt[d][perm], lo[d], cs[d], cell[d])
                  for d in range(3))
    w = emulate_p2m(tx, ty, tz, gt[perm], order.bounds, items, m)
    ref = fk.p2m_grid_plain(*(v.double() for v in qt), gt.double(),
                            ct.double(), ht.double(), m=m, C=C)
    assert rel(w, ref) <= 1e-5


def test_split_fold_sums_lanes_in_order():
    """The fold's order: lane l adds items l, l + split, ...; the lanes add
    in order (at split 1, the items in order)."""
    parts = [torch.tensor([float(i)]) for i in range(70)]
    assert float(fold(parts, 1)) == sum(range(70))
    assert float(fold(parts, fk.RUN_FOLD_SPLIT)) == sum(range(70))
    big = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8])]
    assert float(fold(big, 1)) == 0.0           # (1e8 + 1) - 1e8 in fp32
    assert float(fold(big, 2)) == 1.0           # lane 0: 1e8 - 1e8; lane 1


def test_fold_split_follows_the_items():
    # K1 at N = 200k, m = 12 (782 items of 256); K8 at C = 2 (790 over 8
    # cells); K8 at (8, 4) (1628 over 64) and K11's slots keep the serial
    # fold, so their bits stay
    assert fk.fold_split(782, 1) == 32
    assert fk.fold_split(790, 8) == 32
    assert fk.fold_split(1628, 64) == 1
    assert fk.fold_split(24_000, 21_954) == 1
    assert fk.fold_split(32, 1) == 32 and fk.fold_split(31, 1) == 1


def test_k2_bodies_a_thread_follow_the_blocks_an_sm():
    """Two bodies a thread where the 256-body blocks give every SM four
    (the galaxy: 782 blocks on 132 SMs), else one (a 50k shard: 196
    blocks); one above padded order 20."""
    assert tk.l2p_bodies(200_000, 12, SMS) == 2
    assert tk.l2p_bodies(200_000, 20, SMS) == 2
    assert tk.l2p_bodies(200_000, 21, SMS) == 1
    assert tk.l2p_bodies(50_000, 12, SMS) == 1
    assert tk.l2p_bodies(134_913, 12, SMS) == 2   # 528 blocks
    assert tk.l2p_bodies(134_912, 12, SMS) == 1   # 527


def test_one_run_glue_reads_nothing_back_and_is_cached():
    """K1's one run: bounds {0, n} and items {0, ceil(n / chunk)} of
    p2m_chunk bodies, and the node table K1 and K2 take, built once per
    (n, m, device), with no operation that reads a device value back to
    the host."""
    tk.one_run.cache_clear()
    tk.one_run_items.cache_clear()
    tk.node_table.cache_clear()
    with _Ops() as rec:
        run = tk.one_run(20_000, 12, CPU, sms=SMS)
        table = tk.node_table(20, CPU)
    assert rec.ops and not [op for op in rec.ops
                            if op.startswith(_SYNCS)], rec.ops
    assert tk.one_run(20_000, 12, CPU, sms=SMS) is run
    assert tk.node_table(20, CPU) is table is fk.node_table(20, CPU)
    assert run.chunk == fk.p2m_chunk(20_000, 12, SMS) == 64
    assert run.bounds.tolist() == [0, 20_000]
    assert run.prefix.tolist() == [0, -(-20_000 // run.chunk)]
    assert run.nitems == int(run.prefix[1]) == 313
    assert tk.one_run_items(1, 256, CPU).nitems == 1


def test_wrappers_run_the_plain_versions_on_the_cpu():
    q, g, c, h = galaxy(512)
    fields = tuple(torch.randn(8 ** 3) for _ in range(5))
    torch.testing.assert_close(tk.p2m_fused(*q, g, c, h, m=8),
                               tk.p2m_plain(*q, g, c, h, m=8), rtol=0,
                               atol=0)
    for a, b in zip(tk.l2p_fused_multi(*q, c, h, fields, m=8),
                    tk.l2p_plain(*q, c, h, fields, m=8)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_python_geometry_mirrors_the_source():
    runs = (CSRC / "cell_runs.cuh").read_text()
    proxy = (CSRC / "proxy.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert const(runs, "kRunFoldSplit") == fk.RUN_FOLD_SPLIT
    assert const(runs, "kRunFields") == tk._L2P_GROUP
    assert const(proxy, "kMaxTotalFields") == tk.MAX_FIELDS
    # K2: four fields a launch (kRunFields) from one staged chunk
    assert "const int kg = k - f0 < murb::kRunFields" in proxy
    assert const(proxy, "kOneThreads") == tk.ONE_L2P_THREADS
    assert const(proxy, "kOneMaxTBMW") == tk.ONE_L2P_MAX_TB_MW
    assert const(runs, "kRunMaxOrder") == tk.MAX_ORDER
    # OneRun's coordinate is the proxy's, not a one-cell grid's cell_t
    assert "return clip_unit((q - c) / h);" in runs
    # the fold's rule, as fold_split mirrors it
    assert re.search(r"nitems\) >=\s+static_cast<long long>\(kRunFoldSplit\)"
                     r" \* nrun", runs)


def test_field_pointers_hold_each_fields_address():
    """The L2P entries' host array of field pointers (K2, K9, K12), built
    anew each call (a cache would keep freed tensors' addresses)."""
    from murb_tpu_torch.ops import cuda

    fields = [torch.randn(27) for _ in range(5)]
    ptr = cuda.field_pointers(fields)
    assert list(ptr) == [f.data_ptr() for f in fields]
    assert cuda.field_pointers(fields[:2]) is not cuda.field_pointers(
        fields[:2])
