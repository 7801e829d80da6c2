"""State snapshot and restore.

Port of ``murb_tpu/core/checkpoint.py``.  The reference has no
checkpointing (SURVEY.md section 5); this module writes a versioned
``.npz`` snapshot of the whole body state (the eight padded SoA arrays,
ghosts included) with ``n``/``padding``, the iteration counter, dt, the
softening and a format version -- murb_tpu's format, key for key, so a
checkpoint written by either package loads in the other.  A newer format
version is refused.

The orbax backend of murb_tpu (multi-host, sharded) waits for the
distributed slice (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from murb_tpu_torch.core.state import FIELDS, BodyState

FORMAT_VERSION = 1


def _payload(state: BodyState, iteration: int, dt: float,
             soft: float) -> dict:
    """The arrays and metadata of one snapshot (copies the state to the
    host: a device sync, never in the hot loop)."""
    payload = state.to_numpy()
    payload.update(
        __version__=np.int64(FORMAT_VERSION),
        n=np.int64(state.n),
        padding=np.int64(state.padding),
        iteration=np.int64(iteration),
        dt=np.float64(dt),
        soft=np.float64(soft),
    )
    return payload


def save_state(path: str, state: BodyState, *, iteration: int = 0,
               dt: float = 3600.0, soft: float = 2.0e8,
               extra: dict | None = None) -> None:
    """Write a snapshot; ``extra`` entries are stored as ``extra_<key>``."""
    payload = _payload(state, iteration, dt, soft)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_state(path: str, *, device: torch.device | str = "cuda"
               ) -> tuple[BodyState, dict]:
    """Read a snapshot onto ``device`` -> (BodyState, metadata dict with
    ``iteration``, ``dt``, ``soft`` and any extras)."""
    with np.load(path) as z:
        version = int(z["__version__"])
        if version > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has format version {version}; "
                f"this build reads <= {FORMAT_VERSION}")
        meta = {"iteration": int(z["iteration"]), "dt": float(z["dt"]),
                "soft": float(z["soft"])}
        for k in z.files:
            if k.startswith("extra_"):
                meta[k[len("extra_"):]] = z[k]
        state = BodyState.from_numpy({k: z[k] for k in FIELDS}, int(z["n"]),
                                     int(z["padding"]), device)
    return state, meta


class AsyncCheckpointWriter:
    """Write-behind periodic checkpointing for long runs (``--save-every``).

    ``save`` copies the state to the host (the one unavoidable device
    sync), then compresses and writes in a daemon thread.  The write is
    atomic (a ``.tmp`` file renamed over the target), so an interruption
    mid-write never corrupts the resume file.  At most one write is in
    flight; a snapshot that arrives while the disk is still busy is skipped
    and counted, not queued (the next interval retries).
    """

    def __init__(self, path: str):
        self.path = path
        self._thread: threading.Thread | None = None
        self.written = 0
        self.skipped = 0

    def save(self, state: BodyState, *, iteration: int, dt: float,
             soft: float) -> bool:
        """Snapshot and schedule the write; False if skipped (write busy)."""
        if self._thread is not None and self._thread.is_alive():
            self.skipped += 1
            return False
        payload = _payload(state, iteration, dt, soft)
        self._thread = threading.Thread(target=self._write, args=(payload,),
                                        daemon=True)
        self._thread.start()
        return True

    def _write(self, payload: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, self.path)
        self.written += 1

    def flush(self) -> None:
        """Block until any in-flight write has landed (call before a final
        synchronous ``save_state`` to the same path)."""
        if self._thread is not None:
            self._thread.join()
