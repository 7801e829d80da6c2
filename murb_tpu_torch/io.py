"""Trajectory recording: non-blocking binary frame dumps and their reader.

Port of ``murb_tpu/io.py``; the files are byte for byte what murb_tpu
writes for the same frames.  Format ``MURBTRAJ`` v1: 8-byte magic, u32
version, u64 n_bodies, then per frame: u64 frame index + float32 qx[n],
qy[n], qz[n] (little-endian).

The native writer (native/murbnative.cpp) copies each frame into a bounded
queue drained by a background thread, so recording never stalls the
simulation loop; frames are dropped (and counted) if the disk cannot keep
up.  The pure-python fallback writes synchronously.  The reference has no
trajectory export (its visualizer reads the live arrays each frame, ref:
src/murb/main.cpp:279-287).
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np

from murb_tpu_torch.native import get_lib

MAGIC = b"MURBTRAJ"
VERSION = 1


class TrajectoryWriter:
    """Frames of ``n_bodies`` positions into ``path``; ``close`` returns the
    number of frames the native writer dropped."""

    def __init__(self, path: str, n_bodies: int):
        self.path = path
        self.n = int(n_bodies)
        self.dropped = 0
        self._lib = get_lib()
        self._handle = None
        self._file = None
        if self._lib is not None:
            self._handle = self._lib.murb_traj_open(path.encode(), self.n)
            if not self._handle:
                raise OSError(f"cannot open {path!r}")
        else:
            self._file = open(path, "wb")
            self._file.write(MAGIC)
            self._file.write(struct.pack("<IQ", VERSION, self.n))

    def append(self, frame_index: int, qx, qy, qz) -> None:
        """One frame from host arrays of at least ``n_bodies`` positions
        (the first ``n_bodies`` are written)."""
        q = [np.ascontiguousarray(a, dtype=np.float32)[: self.n]
             for a in (qx, qy, qz)]
        if min(len(a) for a in q) < self.n:
            # A short array would make the native writer copy past the
            # buffer's end and would desynchronize the fixed-stride stream.
            raise ValueError(f"frame arrays must have >= {self.n} elements, "
                             f"got {tuple(len(a) for a in q)}")
        if self._handle is not None:
            F = ctypes.POINTER(ctypes.c_float)
            if self._lib.murb_traj_append(self._handle, frame_index,
                                          *(a.ctypes.data_as(F) for a in q)):
                self.dropped += 1
        else:
            self._file.write(struct.pack("<Q", frame_index))
            for a in q:
                self._file.write(a.tobytes())

    def close(self) -> int:
        """Flush and close; returns the number of dropped frames."""
        if self._handle is not None:
            self.dropped = int(self._lib.murb_traj_close(self._handle))
            self._handle = None
        elif self._file is not None:
            self._file.close()
            self._file = None
        return self.dropped


def read_trajectory(path: str):
    """-> (frame_indices (F,), positions (F, n, 3))."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path!r} is not a MURBTRAJ file")
        version, n = struct.unpack("<IQ", f.read(12))
        if version > VERSION:
            raise ValueError(f"unsupported trajectory version {version}")
        frames, indices = [], []
        frame_bytes = 8 + 3 * n * 4
        while True:
            blob = f.read(frame_bytes)
            if len(blob) < frame_bytes:
                break
            (idx,) = struct.unpack_from("<Q", blob)
            frames.append(np.frombuffer(blob, dtype=np.float32,
                                        offset=8).reshape(3, n).T.copy())
            indices.append(idx)
    return np.asarray(indices, dtype=np.int64), np.asarray(frames)
