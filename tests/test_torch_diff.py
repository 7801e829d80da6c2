"""The port's differentiable simulation (murb_tpu_torch.diff) on the CPU.

Part 1 runs each check of tests/test_diff.py on the port, at its sizes and
bounds: the adjoint against central differences (rel 1e-5), masses and
positions, remat, the proxy gradient against the exact one (WithinRel
1e-2, rms floor 1e-3), the vmapped ensemble (1e-6), trajectory frames
(1e-7), the velocity fit (below 0.05 of the first loss) and the
integrators (1e-6).

Part 2 holds the port to murb_tpu.diff on the same states (built by
murb_tpu.core.init, carried across with BodyState.from_numpy): final
states, and gradients w.r.t. vx, m, qx, dt and soft, for every method and
integrator, within 1e-8 relative in float64 and 1e-3 in float32 (the max
error over the max magnitude of each gradient); trajectory frames, the
fit's losses, and ``acc_proxy(fused=False)`` (1e-8, rms floor 1e-12, in
float64).  murb_tpu's jitted proxy takes ``soft`` as a static argument, so
its proxy rollouts run unjitted here (``acc_proxy.__wrapped__``), which
lets ``jax.grad`` reach the softening as the port's autograd does.

Part 3: the kernel wrappers refuse a grad-requiring input
(ops/cuda.refuse_grad) unless autograd is off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import murb_tpu.ops.proxy as jproxy
from conftest import assert_within_rel
from murb_tpu import diff as jdiff
from murb_tpu.core import init as jinit
from murb_tpu_torch import G
from murb_tpu_torch.core.init import init_random
from murb_tpu_torch.core.state import FIELDS, BodyState
from murb_tpu_torch.diff import (ensemble, fit_initial_velocities, rollout,
                                 stack_states, target_loss, trajectory)
from murb_tpu_torch.ops import cuda
from murb_tpu_torch.ops.proxy import acc_proxy

torch.set_num_threads(2)
SOFT = 2.0e8
DT = 3600.0
METHODS = ("naive", "chunked", "proxy")
INTEGRATORS = ("euler", "kdk", "yoshida4")


def _state(n=64, seed=3, dtype=torch.float64):
    return init_random(n, seed, device="cpu").astype(dtype)


def _positions(s):
    return torch.stack([s.qx, s.qy, s.qz], 1)[: s.n].detach().numpy()


# ------------------------------------------- part 1: tests/test_diff.py
def test_grad_matches_finite_differences():
    """d(loss)/d(vx[i]) through a 5-step rollout vs central differences in
    f64: the adjoint is the exact derivative of the discrete scheme."""
    s = _state()
    target = _positions(s) * 1.001

    def loss(vx):
        st = dataclasses.replace(s, vx=vx)
        return target_loss(rollout(st, steps=5, dt=DT, soft=SOFT), target)

    vx = s.vx.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(vx), vx)
    with torch.no_grad():
        for i in (0, 7, 31):
            h = max(abs(float(s.vx[i])), 1e3) * 1e-4
            vp, vm = s.vx.clone(), s.vx.clone()
            vp[i] += h
            vm[i] -= h
            fd = (float(loss(vp)) - float(loss(vm))) / (2 * h)
            assert fd == pytest.approx(float(g[i]), rel=1e-5), (i, fd,
                                                                float(g[i]))


def test_grad_wrt_masses_and_positions():
    """The adjoint reaches masses and positions: finite, nonzero on real
    bodies, and zero on ghost positions (masked loss, zero mass)."""
    s = _state()
    target = _positions(s) * 1.001
    m = s.m.clone().requires_grad_()
    qx = s.qx.clone().requires_grad_()
    st = dataclasses.replace(s, m=m, qx=qx)
    gm, gq = torch.autograd.grad(
        target_loss(rollout(st, steps=3, dt=DT, soft=SOFT), target), (m, qx))
    assert torch.isfinite(gm).all() and torch.isfinite(gq).all()
    assert float(gm[: s.n].abs().max()) > 0
    assert float(gq[: s.n].abs().max()) > 0
    if s.npad > s.n:
        assert float(gq[s.n:].abs().max()) == 0.0


def test_remat_matches_no_remat():
    """With a grad-requiring input (so that remat checkpoints each step) the
    final state and the gradient match the uncheckpointed rollout."""
    s = _state()
    target = _positions(s)
    out = []
    for remat in (True, False):
        vx = s.vx.clone().requires_grad_()
        fin = rollout(dataclasses.replace(s, vx=vx), steps=4, dt=DT,
                      soft=SOFT, remat=remat)
        (g,) = torch.autograd.grad(target_loss(fin, target), vx)
        out.append((fin.qx.detach().numpy(), g.numpy()))
    assert_within_rel(out[0][0], out[1][0], 1e-12, "remat qx")
    assert_within_rel(out[0][1], out[1][1], 1e-12, "remat grad")


def test_proxy_gradient_matches_exact():
    """The proxy's plain path is differentiable and its gradient tracks the
    exact adjoint to about the force-error scale."""
    s = _state(n=256, seed=11, dtype=torch.float32)
    target = _positions(s) * 1.001

    def grad(method):
        vx = s.vx.clone().requires_grad_()
        st = dataclasses.replace(s, vx=vx)
        loss = target_loss(rollout(st, steps=3, dt=DT, soft=SOFT,
                                   method=method), target)
        return torch.autograd.grad(loss, vx)[0]

    assert_within_rel(grad("proxy")[: s.n].numpy(),
                      grad("chunked")[: s.n].numpy(), 1e-2, "proxy grad",
                      rms_floor=1e-3)


def test_ensemble_matches_sequential():
    """vmap'd batch rollout == per-member rollouts."""
    members = [_state(seed=k, dtype=torch.float32) for k in (1, 2, 3)]
    run = ensemble(rollout, steps=4, dt=DT, soft=SOFT, method="chunked")
    out = run(stack_states(members))
    for k, m in enumerate(members):
        ref = rollout(m, steps=4, dt=DT, soft=SOFT, method="chunked")
        assert_within_rel(out.qx[k].numpy(), ref.qx.numpy(), 1e-6,
                          f"member {k}")


def test_trajectory_ys_match_final():
    s = _state(dtype=torch.float32)
    final, qs = trajectory(s, steps=6, dt=DT, soft=SOFT, save_every=2)
    assert qs.shape == (3, s.npad, 3)
    assert_within_rel(qs[-1, :, 0].numpy(), final.qx.numpy(), 1e-7,
                      "last frame == final")


def test_fit_initial_velocities_descends():
    """The canonical adjoint demo: descend the initial velocities so the
    final positions hit a perturbed (realizable) target."""
    s = _state(n=32, seed=5)
    s_tgt = dataclasses.replace(s, vx=s.vx * 1.2, vy=s.vy * 0.8)
    target = _positions(rollout(s_tgt, steps=8, dt=DT, soft=SOFT))
    _, losses = fit_initial_velocities(s, target, steps=8, dt=DT, soft=SOFT,
                                       iters=25)
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])


def test_rollout_integrator_options():
    """kdk/yoshida4 rollouts integrate the same flow (they agree with Euler
    at small dt) and remain differentiable."""
    s = _state(n=48, seed=8)
    target = _positions(s)
    outs = {}
    for integ in INTEGRATORS:
        outs[integ] = rollout(s, steps=4, dt=DT, soft=SOFT, integrator=integ)
        vx = s.vx.clone().requires_grad_()
        loss = target_loss(rollout(dataclasses.replace(s, vx=vx), steps=4,
                                   dt=DT, soft=SOFT, integrator=integ),
                           target)
        (g,) = torch.autograd.grad(loss, vx)
        assert torch.isfinite(g).all(), integ
        assert float(g[: s.n].abs().max()) > 0, integ
    assert_within_rel(outs["kdk"].qx.numpy(), outs["euler"].qx.numpy(), 1e-6,
                      "kdk vs euler")
    assert_within_rel(outs["yoshida4"].qx.numpy(), outs["kdk"].qx.numpy(),
                      1e-6, "y4 vs kdk")


# ------------------------------------------ part 2: against murb_tpu.diff
def _pair(n=64, seed=3, jdtype=jnp.float64):
    js = jinit.init_random(n, seed).astype(jdtype)
    ts = BodyState.from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                              js.n, js.padding, "cpu")
    return js, ts


def _jax_rollout(method):
    """murb_tpu's rollout: jitted, or for the proxy unjitted over an
    unjitted acc_proxy (its ``soft`` is static under jit)."""
    return jdiff.rollout.__wrapped__ if method == "proxy" else jdiff.rollout


@pytest.fixture()
def unjitted_jax_proxy(monkeypatch):
    monkeypatch.setattr(jproxy, "acc_proxy", jproxy.acc_proxy.__wrapped__)


def _rel(got: torch.Tensor, want) -> float:
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("method", METHODS)
def test_gradients_match_murb_tpu_float64(method, integrator,
                                          unjitted_jax_proxy):
    """d(loss)/d(vx, m, qx, dt, soft) through a 3-step rollout, and the
    loss and final state, within 1e-8 of murb_tpu's in float64."""
    js, ts = _pair()
    target = np.stack([np.asarray(js.qx), np.asarray(js.qy),
                       np.asarray(js.qz)], 1)[: js.n] * 1.001
    kw = dict(steps=3, method=method, integrator=integrator)
    jroll = _jax_rollout(method)

    def jloss(vx, m, qx, dt, soft):
        st = dataclasses.replace(js, vx=vx, m=m, qx=qx)
        return jdiff.target_loss(jroll(st, dt=dt, soft=soft, **kw), target)

    jargs = (js.vx, js.m, js.qx, jnp.float64(DT), jnp.float64(SOFT))
    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(*jargs)
    leaves = [ts.vx.clone(), ts.m.clone(), ts.qx.clone(),
              torch.tensor(DT, dtype=torch.float64),
              torch.tensor(SOFT, dtype=torch.float64)]
    for t in leaves:
        t.requires_grad_()
    st = dataclasses.replace(ts, vx=leaves[0], m=leaves[1], qx=leaves[2])
    final = rollout(st, dt=leaves[3], soft=leaves[4], **kw)
    loss = target_loss(final, target)
    tg = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(jl), rel=1e-8)
    for name, a, b in zip(("vx", "m", "qx", "dt", "soft"), tg, jg):
        assert _rel(a, b) <= 1e-8, (name, _rel(a, b))
    jfinal = jroll(js, dt=DT, soft=SOFT, **kw)
    for k in ("qx", "qy", "qz", "vx", "vy", "vz"):
        assert _rel(getattr(final, k), getattr(jfinal, k)) <= 1e-8, k


@pytest.mark.parametrize("method", METHODS)
def test_gradients_match_murb_tpu_float32(method, unjitted_jax_proxy):
    """The same in float32 (the softening and dt float64 leaves, cast to the
    state's dtype inside): within 1e-3."""
    js, ts = _pair(jdtype=jnp.float32)
    target = np.stack([np.asarray(js.qx), np.asarray(js.qy),
                       np.asarray(js.qz)], 1)[: js.n] * 1.001
    jroll = _jax_rollout(method)

    def jloss(vx, m, qx, dt, soft):
        st = dataclasses.replace(js, vx=vx, m=m, qx=qx)
        return jdiff.target_loss(jroll(st, steps=3, dt=dt, soft=soft,
                                       method=method), target)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        js.vx, js.m, js.qx, jnp.float64(DT), jnp.float64(SOFT))
    leaves = [ts.vx.clone(), ts.m.clone(), ts.qx.clone(),
              torch.tensor(DT, dtype=torch.float64),
              torch.tensor(SOFT, dtype=torch.float64)]
    for t in leaves:
        t.requires_grad_()
    st = dataclasses.replace(ts, vx=leaves[0], m=leaves[1], qx=leaves[2])
    tg = torch.autograd.grad(target_loss(rollout(
        st, steps=3, dt=leaves[3], soft=leaves[4], method=method), target),
        leaves)
    for name, a, b in zip(("vx", "m", "qx", "dt", "soft"), tg, jg):
        assert _rel(a, b) <= 1e-3, (name, _rel(a, b))


def test_float_and_tensor_dt_soft_give_the_same_bits():
    """A Python dt and softening keep the engines' bits; 0-dim tensors of
    the state's dtype give the same rollout."""
    s = _state(dtype=torch.float32)
    for integ in INTEGRATORS:
        a = rollout(s, steps=2, dt=DT, soft=SOFT, integrator=integ,
                    remat=False)
        b = rollout(s, steps=2, dt=torch.tensor(DT), soft=torch.tensor(SOFT),
                    integrator=integ, remat=False)
        for k in ("qx", "vz"):
            assert torch.equal(getattr(a, k), getattr(b, k)), (integ, k)


def test_trajectory_matches_murb_tpu():
    js, ts = _pair()
    jfinal, jqs = jdiff.trajectory(js, steps=6, dt=DT, soft=SOFT,
                                   save_every=3)
    final, qs = trajectory(ts, steps=6, dt=DT, soft=SOFT, save_every=3)
    assert qs.shape == tuple(jqs.shape) == (2, ts.npad, 3)
    assert _rel(qs, jqs) <= 1e-8
    assert _rel(final.vy, jfinal.vy) <= 1e-8


def test_fit_losses_match_murb_tpu():
    """The fit's losses (the first from the same state and target; the
    rest after the same descent steps) within 1e-8 of murb_tpu's."""
    js, ts = _pair(n=32, seed=5)
    jt = jdiff.rollout(dataclasses.replace(js, vx=js.vx * 1.2,
                                           vy=js.vy * 0.8),
                       steps=8, dt=DT, soft=SOFT)
    target = np.stack([np.asarray(jt.qx), np.asarray(jt.qy),
                       np.asarray(jt.qz)], 1)[: js.n]
    _, jl = jdiff.fit_initial_velocities(js, target, steps=8, dt=DT,
                                         soft=SOFT, iters=3)
    _, tl = fit_initial_velocities(ts, target, steps=8, dt=DT, soft=SOFT,
                                   iters=3)
    assert tl == pytest.approx(jl, rel=1e-8)


@pytest.mark.parametrize("scheme,m", [("random", 12), ("galaxy", 12),
                                      ("galaxy", 20)])
def test_acc_proxy_unfused_matches_murb_tpu(scheme, m):
    """``acc_proxy(fused=False)``: the plain stages, and at m=20 (8000
    nodes) the node sweep's plain version, against murb_tpu's jnp stages
    (fused=False) in float64 at N=2048."""
    js = getattr(jinit, f"init_{scheme}")(2048, 1).astype(jnp.float64)
    q = [np.asarray(getattr(js, k)) for k in ("qx", "qy", "qz")]
    gm = np.asarray(js.m) * G
    ja = jproxy.acc_proxy(*map(jnp.asarray, q), jnp.asarray(gm), SOFT, m=m,
                          fused=False)
    ta = acc_proxy(*map(torch.from_numpy, q), torch.from_numpy(gm), SOFT,
                   m=m, fused=False)
    for c in range(3):
        assert_within_rel(ta[c].numpy(), np.asarray(ja[c]), 1e-8,
                          f"{scheme} m={m} axis {c}", rms_floor=1e-12)


def test_acc_proxy_unfused_two_cells_raises():
    s = _state(dtype=torch.float32)
    with pytest.raises(ValueError, match="ROADMAP"):
        acc_proxy(s.qx, s.qy, s.qz, s.m * G, SOFT, m=8, cells=2, fused=False)


def test_vmapped_gradient_without_remat():
    """A gradient under vmap (torch.func.grad) needs remat=False: it matches
    each member's autograd gradient."""
    members = [_state(n=32, seed=k) for k in (1, 2)]
    batch = stack_states(members)
    target = _positions(members[0])

    def loss(vx, st):
        st = dataclasses.replace(st, vx=vx)
        return target_loss(rollout(st, steps=2, dt=DT, soft=SOFT,
                                   remat=False), target)

    g = torch.func.vmap(torch.func.grad(loss))(batch.vx, batch)
    for k, st in enumerate(members):
        vx = st.vx.clone().requires_grad_()
        (ref,) = torch.autograd.grad(loss(vx, st), vx)
        assert _rel(g[k], ref.numpy()) <= 1e-12, k


def test_stack_states_refuses_other_shapes():
    with pytest.raises(ValueError, match="shapes must match"):
        stack_states([_state(n=32), _state(n=300)])


# ----------------------------------------------------- part 3: the guard
def test_kernel_inputs_refuse_grad_unless_autograd_is_off():
    from murb_tpu_torch.ops.proxy_kernels import _box

    cpu = torch.device("cpu")
    x = torch.ones(4, requires_grad=True)
    note = lambda *a: None
    with pytest.raises(RuntimeError, match="no backward"):
        cuda.kernel_inputs("K1", cpu, 4, x, notify=note)
    with pytest.raises(RuntimeError,
                       match=r"anterpolation\): an input requires grad"):
        _box(x[:3], torch.ones(3), cpu)
    with pytest.raises(RuntimeError, match="murb_tpu_torch.diff"):
        cuda.refuse_grad("K7", None, 2.0e8, torch.tensor(2.0e8,
                                                         requires_grad=True))
    with torch.no_grad():
        (y,) = cuda.kernel_inputs("K1", cpu, 4, x, notify=note)
        assert y is x
        assert _box(x[:3], torch.ones(3), cpu).shape == (6,)
    cuda.kernel_inputs("K1", cpu, 4, x.detach(), notify=note)
