"""Launch counters of the serve step's kernel wrappers, safe across
threads.

A wrapper calls `tick` where it launches its kernel. Two kinds of thread
share the counters in a replica fleet: engine threads whose step programs
replay CUDA graphs (a replay adds the counts its capture recorded,
`add`), and a thread that builds a new replica and captures its graphs
meanwhile. A capture launches nothing, so its thread records into a
private sink (`recording`) and the global counters see only launches.
"""
from __future__ import annotations

import contextlib
import threading

_lock = threading.Lock()
_tls = threading.local()


def _bump(target, key, n):
    """Add `n` to `target[key]` (a dict counter) in place."""
    target[key] = target.get(key, 0) + n


def tick(fn, name, key=None):
    """One launch of `fn`'s kernel: add one to the counter ``fn.<name>``
    (to its entry `key` when the counter is a dict), or to this thread's
    sink while it records."""
    sink = getattr(_tls, "sink", None)
    with _lock:
        if sink is not None:
            if key is None:
                _bump(sink, (fn, name), 1)
            else:
                _bump(sink.setdefault((fn, name), {}), key, 1)
        elif key is None:
            setattr(fn, name, getattr(fn, name) + 1)
        else:
            _bump(getattr(fn, name), key, 1)


@contextlib.contextmanager
def recording():
    """Within, this thread's `tick`s go into the yielded dict
    (``{(fn, name): n or {key: n}}``) and leave the counters alone."""
    prev = getattr(_tls, "sink", None)
    sink = {}
    _tls.sink = sink
    try:
        yield sink
    finally:
        _tls.sink = prev


def add(recorded):
    """Add a `recording`'s counts to the counters (a graph replay's)."""
    with _lock:
        for (fn, name), n in recorded.items():
            if isinstance(n, dict):
                counter = getattr(fn, name)
                for k, v in n.items():
                    _bump(counter, k, v)
            else:
                setattr(fn, name, getattr(fn, name) + n)
