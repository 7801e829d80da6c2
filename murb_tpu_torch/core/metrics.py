"""Conserved-quantity metrics: total energy, angular momentum, density center.

Port of ``murb_tpu/core/metrics.py`` (ref:
src/murb/implem/SimulationNBodyCUDAPropertyTracking.cu:217-304, 334-369).
The reference computes its metrics in double (ref: main.cpp:247-248), and
so does the port, in native float64 on either device.  ``murb_tpu`` scales
masses, positions and velocities to unit magnitude on the device and
multiplies the scales back on the host (``MetricScales``), because the TPU's
emulated float64 has float32's range; the H100's float64 has the full range,
so the port computes the values directly.  Every function returns device
tensors and never waits on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from murb_tpu_torch import G
from murb_tpu_torch.core.state import in_dtype

METRIC_DTYPE = torch.float64


def _gm(state) -> torch.Tensor:
    """G*m_j with G rounded to the state dtype first (as the engines do)."""
    return state.m * in_dtype(G, state.dtype)


def sweep_dtype(dtype: torch.dtype) -> torch.dtype:
    """The arithmetic of the exact potential sweep for a state of
    ``dtype``: its own, float32 for bf16.  murb_tpu forms the sweep in the
    state dtype, but XLA keeps fp32 inside the fused bf16 chain (distances,
    rsqrt), the rule of every pairwise chain of the port
    (ops/common.bf16_chain); rounding each op to bf16 instead reads the
    2048-body galaxy's potential energy 1.4% off float64 (ROADMAP.md
    Queue 3)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _soft2(soft, dtype) -> torch.Tensor:
    """eps^2 as the exact sweep forms it: eps in the state dtype, squared
    in the sweep's arithmetic."""
    return torch.tensor(soft, dtype=dtype).to(sweep_dtype(dtype)) ** 2


def _self_term(gm, soft2: torch.Tensor, out_dtype) -> torch.Tensor:
    """G m_i / eps, the j == i term every potential sweep includes (the
    reference compensates it, ref:
    SimulationNBodyCUDAPropertyTracking.cu:296-302); 1/eps is formed from
    ``soft2`` as the sweep that made phi forms it."""
    return gm.to(out_dtype) * float(torch.rsqrt(soft2))


def potential_energy_per_body(qx, qy, qz, m, gm, soft, *, chunk: int = 1024,
                              out_dtype=METRIC_DTYPE, method: str = "exact",
                              proxy_m: int = 16) -> torch.Tensor:
    """PE_i = -m_i * sum_j Gm_j * rsqrt(|r_ij|^2 + eps^2), self term removed.

    ``method="exact"``: an i-chunked sweep whose distances and rsqrt are in
    the state dtype (``sweep_dtype``: float32 for bf16) and whose sum is in
    ``out_dtype`` (O(chunk * N) memory), as ``murb_tpu`` computes it.
    ``method="proxy"``: the Chebyshev proxy sweep in O(N*m^3)
    (ops/proxy.potential_proxy; the caller picks ``proxy_m`` from the
    box)."""
    if method == "proxy":
        from murb_tpu_torch.ops.proxy import potential_proxy

        sweep = potential_proxy(qx, qy, qz, gm, soft, m=proxy_m).to(out_dtype)
    elif method == "exact":
        dtype = qx.dtype
        soft2 = float(_soft2(soft, dtype))
        qx, qy, qz = (q.to(sweep_dtype(dtype)) for q in (qx, qy, qz))
        gmo = gm.to(out_dtype)
        parts = []
        for s in range(0, qx.shape[0], chunk):
            sl = slice(s, s + chunk)
            dx = qx[None, :] - qx[sl, None]
            dy = qy[None, :] - qy[sl, None]
            dz = qz[None, :] - qz[sl, None]
            inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + soft2)
            parts.append((gmo[None, :] * inv.to(out_dtype)).sum(1))
        sweep = torch.cat(parts)
    else:
        raise ValueError(f"unknown metrics method {method!r} (exact, proxy)")
    return -(m.to(out_dtype) * (sweep - _self_term(gm, _soft2(soft, m.dtype),
                                                   out_dtype)))


def kinetic_energy_per_body(m, vx, vy, vz,
                            out_dtype=METRIC_DTYPE) -> torch.Tensor:
    """m_i |v_i|^2 (halved with the potential term in ``total_energy``)."""
    vx, vy, vz = (a.to(out_dtype) for a in (vx, vy, vz))
    return m.to(out_dtype) * (vx * vx + vy * vy + vz * vz)


def total_energy(state, soft, *, chunk: int = 1024, out_dtype=METRIC_DTYPE,
                 method: str = "exact", proxy_m: int = 16) -> torch.Tensor:
    """E = sum_i (PE_i/2 + KE_i/2) with KE_i = m_i |v_i|^2 (the reference
    halves both: PE for double counting, KE for the 1/2 m v^2 factor, ref:
    SimulationNBodyCUDAPropertyTracking.cu:296-302)."""
    pe = potential_energy_per_body(state.qx, state.qy, state.qz, state.m,
                                   _gm(state), soft, chunk=chunk,
                                   out_dtype=out_dtype, method=method,
                                   proxy_m=proxy_m)
    ke = kinetic_energy_per_body(state.m, state.vx, state.vy, state.vz,
                                 out_dtype)
    return (pe * 0.5 + ke * 0.5).sum()


def angular_momentum(state, out_dtype=METRIC_DTYPE) -> torch.Tensor:
    """|sum_i m_i (q_i x v_i)|, the reference's scalar ``angMomentums``
    series (ref: src/common/core/SimulationHistory.hpp:14)."""
    m = state.m.to(out_dtype)
    qx, qy, qz = (a.to(out_dtype) for a in (state.qx, state.qy, state.qz))
    vx, vy, vz = (a.to(out_dtype) for a in (state.vx, state.vy, state.vz))
    lx = (m * (qy * vz - qz * vy)).sum()
    ly = (m * (qz * vx - qx * vz)).sum()
    lz = (m * (qx * vy - qy * vx)).sum()
    return torch.sqrt(lx * lx + ly * ly + lz * lz)


def density_center(state, out_dtype=METRIC_DTYPE) -> torch.Tensor:
    """Mass-weighted mean position, shape (3,) (ref data model:
    src/common/core/SimulationHistory.hpp:15 ``densityCenters``)."""
    m = state.m.to(out_dtype)
    total = m.sum().clamp(min=1e-30)
    return torch.stack([(m * q.to(out_dtype)).sum() / total
                        for q in (state.qx, state.qy, state.qz)])


def energy_from_phi(state, phi, soft,
                    out_dtype=METRIC_DTYPE) -> torch.Tensor:
    """Total energy from a potential sweep already in hand, phi_i = sum_j
    Gm_j * rsqrt(d^2 + eps^2) with the self term included (compensated
    here, as the reference kernel does).  The fused tracking paths use it.
    For a bf16 state 1/eps is formed in fp32 from eps^2 in double, as the
    kernels (K5, K6) and the proxy's stages take it."""
    soft2 = (torch.tensor(float(soft) ** 2, dtype=torch.float32)
             if state.dtype == torch.bfloat16 else _soft2(soft, state.dtype))
    pe = -(state.m.to(out_dtype)
           * (phi.to(out_dtype) - _self_term(_gm(state), soft2, out_dtype)))
    ke = kinetic_energy_per_body(state.m, state.vx, state.vy, state.vz,
                                 out_dtype)
    return (pe * 0.5 + ke * 0.5).sum()


def masked(state, mask):
    """The state with the bodies outside ``mask`` (0/1 per body) made
    massless: they add nothing to any metric, as zero-mass ghosts."""
    return dataclasses.replace(state, m=state.m * mask.to(state.dtype))


def all_metrics(state, soft, *, chunk: int = 1024, out_dtype=METRIC_DTYPE,
                mask=None, method: str = "exact", proxy_m: int = 16):
    """(energy, |L|, density center), the analogue of COMPUTE_ALL_METRIC
    (ref: SimulationNBodyCUDAPropertyTracking.cu:4-7).

    ``mask`` (npad,) of 0/1 restricts the metrics to a body subset (the
    multi-galaxy engine): intra-subset potential energy is exact and
    cross-subset terms are left out, the reference's per-galaxy-then-sum
    model (ref: SimulationHistory.cpp:153-184)."""
    if mask is not None:
        state = masked(state, mask)
    return (total_energy(state, soft, chunk=chunk, out_dtype=out_dtype,
                         method=method, proxy_m=proxy_m),
            angular_momentum(state, out_dtype),
            density_center(state, out_dtype))
