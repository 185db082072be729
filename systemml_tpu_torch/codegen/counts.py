"""Launch counts of the hand-written kernels' wrappers.

Each wrapper (codegen/kernels.py, compress/device.py, codegen/loop_graph.py)
adds one to its `.launches` where it launches its kernel, through
`count`: the process-wide count under a lock, and a tally of the calling
thread's own. A loop region's capture reads the thread's tally
(runtime/loopfuse._snapshot), so that parfor workers capturing at once
each count only their own launches.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_mine = threading.local()


def count(fn, n: int = 1) -> None:
    """Adds `n` to `fn.launches` and to this thread's tally of `fn`."""
    with _lock:
        fn.launches += n
    d = getattr(_mine, "d", None)
    if d is None:
        d = _mine.d = {}
    d[id(fn)] = d.get(id(fn), 0) + n


def mine(fn) -> int:
    """This thread's tally of `fn`'s launches (since the thread began)."""
    d = getattr(_mine, "d", None)
    return d.get(id(fn), 0) if d else 0
