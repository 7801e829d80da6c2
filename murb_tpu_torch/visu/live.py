"""Live in-browser visualization served from the simulation process.

Port of ``murb_tpu/visu/live.py`` (its page, ``viewer.html``, is a copy).
The reference renders live through a GLFW/OpenGL window on the compute node
(GS billboard renderer ref: src/common/ogl/OGLSpheresVisuGS.cpp, instanced
sphere fallback ref: OGLSpheresVisuInst.cpp, camera ref: OGLControl.cpp).
A card host is headless too, so the drawing moves to the GPU in the user's
browser, and the host keeps only a frame feed:

  * a stdlib ThreadingHTTPServer runs beside the simulation loop and serves
    a single self-contained WebGL page (``viewer.html``) plus a binary
    long-poll frame endpoint (positions + normalized speed, fp32),
  * the page renders both reference modes — additive point-sprite "GS"
    billboards and instanced lit sphere meshes — with the cyberpunk
    velocity palette and 130-BPM beat pulse evaluated *in the shader*
    (parity with ``cyberpunk_colors``; ref: OGLSpheresVisuGS.cpp:86-172),
  * browser key events post back, so ``pressed_space_bar`` (pause) and
    ``pressed_page_up/down`` (dt scaling) finally do something: the
    reference declares them (ref: src/common/ogl/SpheresVisu.hpp:4-15) but
    its main loop never calls them.

Everything is stdlib + numpy; reach the viewer from a workstation with
``ssh -L PORT:127.0.0.1:PORT <host>``.
"""
from __future__ import annotations

import json
import os
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from murb_tpu_torch.visu import SpheresVisu, host_frame

_MAGIC = b"MURBLIVE"
_HEADER = "<8sIIffIIffff"  # magic, frame, n, time, dt, flags, stride, bbox
HEADER_BYTES = struct.calcsize(_HEADER)
FLAG_PAUSED = 1


def _page_html() -> bytes:
    path = os.path.join(os.path.dirname(__file__), "viewer.html")
    with open(path, "rb") as f:
        return f.read()


def encode_frame(frame: int, n: int, time_s: float, dt: float, flags: int,
                 stride: int, bbox: tuple, arrays: tuple) -> bytes:
    head = struct.pack(_HEADER, _MAGIC, frame, n, time_s, dt, flags, stride,
                       *bbox)
    return head + b"".join(np.ascontiguousarray(a, np.float32).tobytes()
                           for a in arrays)


def decode_header(buf: bytes) -> dict:
    (magic, frame, n, time_s, dt, flags, stride,
     cx, cy, cz, hw) = struct.unpack_from(_HEADER, buf)
    assert magic == _MAGIC, magic
    return dict(frame=frame, n=n, time=time_s, dt=dt, flags=flags,
                stride=stride, bbox=(cx, cy, cz, hw))


class LiveSpheresVisu(SpheresVisu):
    """Serve live frames to a browser; collect its key events.

    ``refresh_display`` snapshots the state (one device-to-host copy per
    displayed frame, at frame boundaries only) and wakes any long-polling
    clients.  The ``pressed_*`` methods are edge-triggered: they report a
    key once per browser event, mirroring a GLFW key poll between frames.
    """

    def __init__(self, port: int = 8797, host: str = "127.0.0.1",
                 max_points: int = 150_000, announce: bool = True):
        self._lock = threading.Condition()
        self._frame = 0
        self._payload_meta = None      # (time_s, dt, np arrays...) snapshot
        self._keys: set[str] = set()
        self._should_close = False
        self.paused = False
        self.dt = 0.0
        self.max_points = max(int(max_points), 1)

        visu = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: the sim loop owns stdout
                pass

            def _send(self, code, body=b"", ctype="application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path in ("/", "/index.html"):
                    self._send(200, _page_html(), "text/html; charset=utf-8")
                elif u.path == "/frame":
                    q = parse_qs(u.query)
                    since = int(q.get("since", ["-1"])[0])
                    mx = int(q.get("max", [str(visu.max_points)])[0])
                    tmo = float(q.get("t", ["10"])[0])
                    body = visu._wait_frame(since, mx, tmo)
                    if body is None:
                        self._send(204)
                    else:
                        self._send(200, body)
                elif u.path == "/info":
                    self._send(200, json.dumps(visu._info()).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                u = urlparse(self.path)
                if u.path == "/key":
                    ln = int(self.headers.get("Content-Length", 0))
                    try:
                        key = json.loads(self.rfile.read(ln))["key"]
                    except (ValueError, KeyError):
                        self._send(400, b"bad request", "text/plain")
                        return
                    visu._press(str(key))
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="murb-live-visu", daemon=True)
        self._thread.start()
        if announce:
            print(f"Live viewer on http://{host}:{self.port} "
                  f"(from a workstation: ssh -L {self.port}:{host}:"
                  f"{self.port} <this-host>)")

    # ------------------------------------------------------------ sim side
    def refresh_display(self, state=None, time_s: float | None = None) -> None:
        if state is None:
            return
        d = host_frame(state)
        qx = np.asarray(d["qx"], np.float32)
        qy = np.asarray(d["qy"], np.float32)
        qz = np.asarray(d["qz"], np.float32)
        norm = (np.asarray(d["vx"], np.float32) ** 2
                + np.asarray(d["vy"], np.float32) ** 2
                + np.asarray(d["vz"], np.float32) ** 2)
        # two-pass min/max normalization, parity with cyberpunk_colors
        lo, hi = float(norm.min()), float(norm.max())
        tn = (norm - lo) / (hi - lo + 1e-6)
        with self._lock:
            self._payload_meta = (float(time_s or 0.0), qx, qy, qz,
                                  tn.astype(np.float32))
            self._frame += 1
            self._lock.notify_all()

    def _info(self) -> dict:
        with self._lock:
            n = 0 if self._payload_meta is None else len(self._payload_meta[1])
            return dict(frame=self._frame, n=n, paused=self.paused,
                        dt=self.dt, closing=self._should_close)

    def _wait_frame(self, since: int, max_points: int,
                    timeout: float = 10.0) -> bytes | None:
        with self._lock:
            self._lock.wait_for(
                lambda: self._frame > since or self._should_close,
                timeout=min(timeout, 30.0),
            )
            if self._payload_meta is None or self._frame <= since:
                return None
            frame = self._frame
            time_s, qx, qy, qz, tn = self._payload_meta
            paused, dt = self.paused, self.dt
        n = len(qx)
        stride = max(1, -(-n // max(max_points, 1)))
        sub = (qx[::stride], qy[::stride], qz[::stride], tn[::stride])
        cx, cy, cz = (float(a.mean()) for a in sub[:3])
        hw = max(float(np.abs(a - m).max())
                 for a, m in zip(sub[:3], (cx, cy, cz))) or 1.0
        flags = FLAG_PAUSED if paused else 0
        return encode_frame(frame, len(sub[0]), time_s, dt, flags, stride,
                            (cx, cy, cz, hw), sub)

    def _press(self, key: str) -> None:
        with self._lock:
            if key == "close":
                self._should_close = True
                self._lock.notify_all()
            else:
                self._keys.add(key)

    # ------------------------------------------------------ loop interface
    def _pop(self, key: str) -> bool:
        with self._lock:
            if key in self._keys:
                self._keys.discard(key)
                return True
            return False

    def window_should_close(self) -> bool:
        return self._should_close

    def pressed_space_bar(self) -> bool:
        return self._pop("space")

    def pressed_page_up(self) -> bool:
        return self._pop("pageup")

    def pressed_page_down(self) -> bool:
        return self._pop("pagedown")

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
