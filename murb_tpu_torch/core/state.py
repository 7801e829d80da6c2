"""Body state container: SoA tensors with zero-mass ghost padding.

Port of ``murb_tpu/core/state.py``.  The reference keeps SoA and AoS mirrors
of (m, r, qx..qz, vx..vz) and pads the body count with zero-mass ghosts
(ref: src/common/core/Bodies.hpp:15-71, Bodies.cpp:160-161, 200-213).  Here
the state is eight 1-D tensors on one device; ghosts carry zero mass, so
their force contribution is exactly 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils._pytree as pytree

# Pad bodies to a multiple of this (kept from the JAX package so padded
# shapes, and so the differential tests' inputs, agree across the two).
PAD_MULTIPLE = 256

FIELDS = ("m", "r", "qx", "qy", "qz", "vx", "vy", "vz")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def in_dtype(x, dtype: torch.dtype):
    """``x`` rounded to ``dtype`` (a constant the JAX package forms in the
    state's dtype): a Python float that such a tensor takes exactly, or,
    for a tensor (a time step that autograd reaches), the tensor cast to
    ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return float(torch.tensor(x, dtype=dtype))


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a state of ``dtype`` is built from and read back
    as: float32 for bf16, which numpy lacks (bf16 -> float32 is exact)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``; bf16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def check_device(device: torch.device | str) -> torch.device:
    """The device a state builder is asked for.  A CUDA device with no card
    raises: the builders default to the card and never build on the CPU
    unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available (torch "
            f"{torch.__version__}); murb_tpu_torch builds its states on the "
            "card by default and does not fall back to the CPU -- pass "
            "device='cpu' to run the plain PyTorch versions")
    return device


@dataclasses.dataclass(frozen=True)
class BodyState:
    """SoA body state: masses, radii, positions, velocities.

    All tensors have shape ``(n + padding,)`` on one device; entries
    ``[n:]`` are zero-mass ghost bodies.
    """

    m: torch.Tensor   # mass (kg)
    r: torch.Tensor   # display radius (m) -- used only by visualization
    qx: torch.Tensor  # position (m)
    qy: torch.Tensor
    qz: torch.Tensor
    vx: torch.Tensor  # velocity (m/s)
    vy: torch.Tensor
    vz: torch.Tensor
    n: int
    padding: int

    # ------------------------------------------------------------------ sizes
    @property
    def npad(self) -> int:
        return self.n + self.padding

    @property
    def dtype(self) -> torch.dtype:
        return self.qx.dtype

    @property
    def device(self) -> torch.device:
        return self.qx.device

    @property
    def allocated_bytes(self) -> int:
        """Bytes held by this state (8 SoA arrays; no AoS mirror)."""
        return 8 * self.npad * self.qx.element_size()

    # ------------------------------------------------------------- construct
    @classmethod
    def from_arrays(cls, m, r, qx, qy, qz, vx, vy, vz, *, n: int | None = None,
                    pad_multiple: int = PAD_MULTIPLE,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda",
                    ghost_positions: np.ndarray | None = None,
                    ghost_velocities: np.ndarray | None = None) -> "BodyState":
        """Build a padded state from unpadded per-body arrays (numpy or
        tensors).  Ghosts get zero mass and radius; their positions and
        velocities default to zero."""
        device = check_device(device)
        m = np.asarray(m)
        if n is None:
            n = int(m.shape[0])
        npad = round_up(max(n, 1), pad_multiple)
        padding = npad - n
        np_dtype = numpy_dtype(dtype)

        def _pad(a, ghosts=None):
            a = np.asarray(a, dtype=np_dtype)
            out = np.zeros(npad, dtype=np_dtype)
            out[:n] = a[:n]
            if ghosts is not None and padding:
                out[n:] = np.asarray(ghosts, dtype=np_dtype)[:padding]
            return out

        gq, gv = ghost_positions, ghost_velocities
        arrays = {
            "m": _pad(m), "r": _pad(r),
            "qx": _pad(qx, None if gq is None else gq[:, 0]),
            "qy": _pad(qy, None if gq is None else gq[:, 1]),
            "qz": _pad(qz, None if gq is None else gq[:, 2]),
            "vx": _pad(vx, None if gv is None else gv[:, 0]),
            "vy": _pad(vy, None if gv is None else gv[:, 1]),
            "vz": _pad(vz, None if gv is None else gv[:, 2]),
        }
        state = cls.from_numpy(arrays, n, padding, device)
        # bf16: sampled as float32 and rounded once, as murb_tpu's schemes
        # round their float32 samples (murb_tpu/core/init.py:126-144)
        return state if state.dtype == dtype else state.astype(dtype)

    @classmethod
    def from_numpy(cls, arrays: dict, n: int, padding: int,
                   device: torch.device | str = "cuda") -> "BodyState":
        """The same state from its eight padded arrays, ghosts included (the
        layout of ``murb_tpu``'s ``BodyState``), copied to ``device``.  An
        ml_dtypes bfloat16 array (murb_tpu's bf16 state) gives a bf16
        tensor, through float32 (exact both ways)."""
        device = check_device(device)
        npad = n + padding
        tensors = {}
        for k in FIELDS:
            a = np.ascontiguousarray(np.asarray(arrays[k]))
            if a.shape != (npad,):
                raise ValueError(f"{k}: shape {a.shape} != ({npad},)")
            if a.dtype.name == "bfloat16":
                t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
            tensors[k] = t.to(device)
        return cls(**tensors, n=int(n), padding=int(padding))

    def to_numpy(self) -> dict[str, np.ndarray]:
        """The eight padded arrays, ghosts included (inverse of
        ``from_numpy``; a device-to-host sync point).  numpy has no
        bfloat16: a bf16 state gives float32 arrays (exact)."""
        return {k: host_array(getattr(self, k)) for k in FIELDS}

    # ------------------------------------------------------------------ views
    def unpadded(self) -> dict[str, np.ndarray]:
        """Host copies of the first ``n`` bodies (device-to-host sync point:
        call at observation points, never inside the step loop)."""
        return {k: host_array(getattr(self, k)[: self.n]) for k in FIELDS}

    def clone(self) -> "BodyState":
        """A copy that shares no storage with this state."""
        return dataclasses.replace(
            self, **{k: getattr(self, k).clone() for k in FIELDS})

    def astype(self, dtype: torch.dtype) -> "BodyState":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(dtype) for k in FIELDS})

    def to(self, device: torch.device | str) -> "BodyState":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in FIELDS})

    def repad(self, pad_multiple: int) -> "BodyState":
        """A state whose padded length is a multiple of ``pad_multiple``
        (the extra bodies are zero-mass ghosts at the origin)."""
        extra = round_up(self.npad, pad_multiple) - self.npad
        if extra == 0:
            return self
        pad = lambda a: torch.nn.functional.pad(a, (0, extra))
        return dataclasses.replace(
            self, **{k: pad(getattr(self, k)) for k in FIELDS},
            padding=self.padding + extra)


# A pytree node (the eight tensors its leaves, n and padding its context),
# so that torch.func.vmap maps over a stacked state (murb_tpu_torch.diff's
# ensemble), as jax.vmap does over murb_tpu's registered BodyState.
pytree.register_pytree_node(
    BodyState, lambda s: ([getattr(s, k) for k in FIELDS], (s.n, s.padding)),
    lambda leaves, ctx: BodyState(*leaves, n=ctx[0], padding=ctx[1]))
