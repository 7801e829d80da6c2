"""The plain float64 reference of a softened-gravity explicit-Euler step.

MUrB's physics (``SimulationNBodyNaive.cpp:34-53``, ``Bodies.cpp:259-278``):

    a_i = sum_j G m_j (q_j - q_i) / (|q_j - q_i|^2 + eps^2)^(3/2)
    q_i' = q_i + (v_i + a_i dt / 2) dt ;  v_i' = v_i + a_i dt

The self pair and zero-mass bodies add exactly 0.  Written from those
equations in plain PyTorch; it takes nothing from the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

#: pairs a block: the (rows, n, 3) float64 differences stay near 768 MiB
_PAIRS_A_BLOCK = 1 << 25


def accelerations(targets: np.ndarray, q: np.ndarray, mass: np.ndarray,
                  G: float, soft: float,
                  device: str | torch.device = "cpu") -> np.ndarray:
    """(k, 3) float64 accelerations of the bodies ``targets`` (k indices
    into ``q``) due to every body of ``q`` (n, 3) with masses ``mass``
    (n,), summed on ``device`` in float64, a block of target rows at a
    time: the differences q_j - q_i themselves, their weights, and the sum
    of weight times difference over j."""
    dev = torch.device(device)
    src = torch.as_tensor(np.asarray(q, np.float64), device=dev)
    gm = torch.as_tensor(np.asarray(mass, np.float64), device=dev) * G
    idx = torch.as_tensor(np.asarray(targets, np.int64), device=dev)
    eps2 = float(soft) ** 2
    rows = max(1, _PAIRS_A_BLOCK // max(src.shape[0], 1))
    out = []
    for s in range(0, idx.shape[0], rows):
        d = src[None, :, :] - src[idx[s:s + rows]][:, None, :]
        w = torch.linalg.vector_norm(d, dim=2)
        w.square_().add_(eps2).pow_(-1.5).mul_(gm)
        out.append(torch.bmm(w[:, None, :], d)[:, 0, :])
        del d, w
    return torch.cat(out).cpu().numpy()


def euler(q: np.ndarray, v: np.ndarray, a: np.ndarray,
          dt: float) -> tuple[np.ndarray, np.ndarray]:
    """(q', v') of one explicit Euler step in float64."""
    q, v, a = (np.asarray(x, np.float64) for x in (q, v, a))
    return q + (v + a * (dt * 0.5)) * dt, v + a * dt
