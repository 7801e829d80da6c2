"""Host-side order helpers of the multi-level Chebyshev hierarchy.

Only what order validation and ``ProxyEngine.proxy_health`` call is ported
(ref: murb_tpu/ops/fmm.py:451-522).  The hierarchy itself (``acc_fmm``,
kernels K7-K9) is not yet ported to murb_tpu_torch (ROADMAP.md Queue 1
item 7).
"""
from __future__ import annotations

import math

from murb_tpu_torch.ops.proxy import required_order


def required_levels(halfwidth: float, soft: float, *, a_target: float = 1.0,
                    max_levels: int = 4) -> int:
    """Hierarchy depth so the finest cells satisfy eps/h_L >= a_target."""
    if halfwidth <= soft * a_target:
        return 1
    return min(int(math.ceil(math.log2(halfwidth * a_target / soft))),
               max_levels)


#: Error prefactor of the hierarchical solver with 3x safety, measured by
#: the JAX package (murb_tpu/ops/fmm.py:492-506); the port keeps it so the
#: validation ladder takes the same rungs.
FMM_ERR_PREFACTOR = 0.3


def fmm_order(halfwidth: float, soft: float, levels: int,
              tol: float = 1e-4) -> int:
    """Chebyshev order for the hierarchical solver: the finest-level
    same-cell interpolation bound with the measured prefactor."""
    return required_order(halfwidth / 2 ** levels, soft,
                          tol / FMM_ERR_PREFACTOR, margin=0)
