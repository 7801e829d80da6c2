"""State snapshot and restore.

Port of ``murb_tpu/core/checkpoint.py``.  The reference has no
checkpointing (SURVEY.md section 5); this module writes a versioned
``.npz`` snapshot of the whole body state (the eight padded SoA arrays,
ghosts included) with ``n``/``padding``, the iteration counter, dt, the
softening and a format version -- murb_tpu's format, key for key, so a
checkpoint written by either package loads in the other.  A newer format
version is refused.

A bf16 state is written as float32 arrays, which is exact, with a
``dtype`` entry "bfloat16", and loads back as bf16 bit for bit.  murb_tpu's
``load_state`` reads such a file (as float32 arrays: it reads no
``dtype`` entry).  murb_tpu writes its own bf16 state as ml_dtypes
bfloat16, which ``np.savez_compressed`` stores as ``|V2`` and neither
package's loader can read back (ROADMAP.md Queue 3).

The sharded counterpart of murb_tpu's orbax backend (``save_state_orbax``
/ ``load_state_orbax``) is ``save_state_sharded`` / ``load_state_sharded``
on ``torch.distributed.checkpoint``: a checkpoint directory in which each
shard's blocks sit under their own keys, written by the process that holds
them, beside the layout and the metadata.  It runs in one process without
a process group, and across the processes of one.
"""
from __future__ import annotations

import os
import threading
import warnings

import numpy as np
import torch

from murb_tpu_torch.core.state import FIELDS, BodyState

FORMAT_VERSION = 1


def _payload(state: BodyState, iteration: int, dt: float,
             soft: float) -> dict:
    """The arrays and metadata of one snapshot (copies the state to the
    host: a device sync, never in the hot loop)."""
    payload = state.to_numpy()  # bf16: float32 arrays (exact)
    if state.dtype == torch.bfloat16:
        payload["dtype"] = np.str_("bfloat16")
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
        if "dtype" in z.files and str(z["dtype"]) == "bfloat16":
            state = state.astype(torch.bfloat16)  # exact: bf16 -> f32 -> bf16
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


# ------------------------------------------------------ sharded checkpoint
def _dcp(fn, *args, **kw):
    """Call torch.distributed.checkpoint's ``fn``; without a process group
    it runs in this process alone (and says so in a warning, dropped)."""
    import torch.distributed.checkpoint as dcp

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*torch.distributed is "
                                "disabled.*")
        return getattr(dcp, fn)(*args, **kw)


def save_state_sharded(path: str, blocks, mesh, *, n: int, padding: int,
                       iteration: int = 0, dt: float = 3600.0,
                       soft: float = 2.0e8) -> None:
    """Write a sharded state (``blocks``: this process's blocks, one per
    local shard of ``mesh``, as ``ShardedEngine.blocks`` holds them) to the
    checkpoint directory ``path``: block g's fields under ``shard{g}/{k}``,
    the layout (shards, rows a block, n, padding, format version) and the
    metadata (iteration, dt, soft).  Collective across processes."""
    sd = {f"shard{mesh.axis_index(j)}/{k}": getattr(b, k)
          for j, b in enumerate(blocks) for k in FIELDS}
    sd["layout"] = torch.tensor([mesh.size, blocks[0].npad, n, padding,
                                 FORMAT_VERSION], dtype=torch.int64)
    sd["meta/iteration"] = torch.tensor([iteration], dtype=torch.int64)
    sd["meta/step"] = torch.tensor([dt, soft], dtype=torch.float64)
    _dcp("save", sd, checkpoint_id=os.path.abspath(path))


def load_state_sharded(path: str, mesh) -> tuple[list, dict]:
    """Read a ``save_state_sharded`` checkpoint back onto ``mesh``, which
    must have its number of shards -> (this process's blocks, one per local
    shard on its device, metadata dict with ``n``, ``padding``,
    ``iteration``, ``dt``, ``soft``)."""
    path = os.path.abspath(path)
    head = {"layout": torch.zeros(5, dtype=torch.int64),
            "meta/iteration": torch.zeros(1, dtype=torch.int64),
            "meta/step": torch.zeros(2, dtype=torch.float64)}
    _dcp("load", head, checkpoint_id=path)
    shards, rows, n, padding, version = (int(x) for x in head["layout"])
    if version > FORMAT_VERSION:
        raise ValueError(f"checkpoint {path!r} has format version {version}; "
                         f"this build reads <= {FORMAT_VERSION}")
    if shards != mesh.size:
        raise ValueError(f"checkpoint {path!r} holds {shards} shards, the "
                         f"mesh has {mesh.size}")
    from torch.distributed.checkpoint import FileSystemReader

    dtypes = FileSystemReader(path).read_metadata().state_dict_metadata
    sd = {f"shard{mesh.axis_index(j)}/{k}": torch.empty(
        rows, dtype=dtypes[f"shard{mesh.axis_index(j)}/{k}"].properties.dtype,
        device=dev) for j, dev in enumerate(mesh.devices) for k in FIELDS}
    _dcp("load", sd, checkpoint_id=path)
    blocks = [BodyState(**{k: sd[f"shard{mesh.axis_index(j)}/{k}"]
                           for k in FIELDS}, n=rows, padding=0)
              for j in range(mesh.local_size)]
    dt, soft = (float(x) for x in head["meta/step"])
    return blocks, {"n": n, "padding": padding, "dt": dt, "soft": soft,
                    "iteration": int(head["meta/iteration"][0])}
