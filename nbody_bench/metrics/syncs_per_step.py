"""Host waits on the device a step, in the profiled frames: the runtime's
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and
``cudaEventSynchronize`` calls and its synchronous ``cudaMemcpy``, counted
where the call starts inside one of the benchmark's ``dispatch`` spans
(the frame's ``compute_one_iteration()`` calls, before the frame's own
synchronise), over the frames' steps.  A blocking copy between the host
and the card (``.cpu()``, ``.item()``, a pageable host table's
``.to(device)``) is a ``cudaMemcpyAsync`` and then a
``cudaStreamSynchronize``: it counts once.  Each is a point where the host
stops feeding the card, and what a captured CUDA graph cannot hold."""
import bisect
import re

SYNC = re.compile(r"^cuda(?:(?:Stream|Device|Event)Synchronize|Memcpy)"
                  r"(?:_v\d+)?$")


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    dispatch = sorted((s, e) for name, s, e in t.spans if name == "dispatch")
    if not dispatch:
        return None
    starts = [s for s, _ in dispatch]

    def inside(x):
        i = bisect.bisect_right(starts, x) - 1
        return i >= 0 and x <= dispatch[i][1]

    waits = sum(1 for name, s, _ in t.host if SYNC.match(name) and inside(s))
    return waits / (t.frames * run.steps_per_frame)
