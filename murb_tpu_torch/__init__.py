"""murb-tpu-torch: the PyTorch + CUDA port of ``murb_tpu``.

The same N-body engine as the JAX package beside it, written for an NVIDIA
H100: plain PyTorch tensor code between hand-written CUDA C++ kernels
(``murb_tpu_torch/csrc``).  This package never imports JAX or ``murb_tpu``;
the JAX package is the reference the port is tested against.

Layer map (mirrors ``murb_tpu``):
  - ``murb_tpu_torch.core``   -- body state, initializers, integrators,
                                 metrics and history
  - ``murb_tpu_torch.ops``    -- oracle sweeps, the proxy solver, order
                                 validation and the CUDA kernel wrappers
  - ``murb_tpu_torch.models`` -- engine registry behind one interface
  - ``murb_tpu_torch.parallel`` -- the device mesh and the sharded engines
  - ``murb_tpu_torch.utils``  -- CLI args, Perf timers
"""

__version__ = "0.1.0"

# Physical constants -- ref: src/common/core/SimulationNBodyInterface.hpp:18
G = 6.67384e-11

# Defaults -- ref: src/murb/main.cpp:45-47
DEFAULT_DT = 3600.0
DEFAULT_SOFTENING = 2.0e8

from murb_tpu_torch.core.state import BodyState  # noqa: E402,F401
from murb_tpu_torch.models import (  # noqa: E402,F401
    available_implementations,
    create_engine,
)
