"""Inline compile-stall accounting.

A copy of the reference package's `compilecache/stall.py`. In the port a
"stall" is wall time a live request spent building what should have been
built ahead of time: a first-use `nvcc` build of a kernel library
(`engine/kernels/build.py`) or a CUDA graph capture of a ring window
class (`compilecache/registry.py`), both noted through
`compilecache/tracker.py`. The meter keeps a bounded,
monotonically-sequenced log so the serve dispatch loop can attribute the
stalls of ONE dispatch window to the requests that rode it (the
`compile_ms` / `compiled` fields on `ServeEvent`).

Every note also lands in the shared metrics registry (histogram
`compile.stall`, counter `compile.stalls`), so the Prometheus/JSON
exporters see compile cost with no extra wiring.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import List, Optional, Tuple

_MAX_LOG = 4096


class StallMeter:
    """Thread-safe bounded log of (seq, thread, label, seconds) stalls.

    Entries carry the noting thread's ident so a reader can scope its
    window to its own thread — the serve dispatch loop does, which keeps
    per-dispatch attribution exact even when several QueryServices (or
    direct planner callers on other threads) share the process-wide
    meter. `suppressed()` is a thread-local mute: warmup replay wraps
    itself in it so deliberate pre-traffic compiles never count as
    inline stalls."""

    def __init__(self, max_log: int = _MAX_LOG):
        self._lock = threading.Lock()
        self._seq = 0
        self._log: "collections.deque[Tuple[int, int, str, float]]" = (
            collections.deque(maxlen=max_log))
        self._tls = threading.local()

    @contextlib.contextmanager
    def suppressed(self):
        """Mute notes from THIS thread for the duration (warmup replay:
        those compiles are ahead-of-time by definition). Other threads'
        genuine inline stalls keep recording."""
        prev = getattr(self._tls, "suppress", False)
        self._tls.suppress = True
        try:
            yield
        finally:
            self._tls.suppress = prev

    def note(self, label: str, seconds: float) -> None:
        if getattr(self._tls, "suppress", False):
            return
        with self._lock:
            self._seq += 1
            self._log.append((self._seq, threading.get_ident(),
                              label, seconds))
        try:
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.counter("compile.stalls")
            # per-kernel series via a proper Prometheus label; bounded
            # cardinality: kernel names pass through, filter labels
            # ("filter:count:<cql>") drop their CQL tail
            metrics.counter("compile.stalls.by_kernel",
                            kernel=":".join(label.split(":")[:2]))
            metrics.histogram("compile.stall").update(seconds)
        except Exception:
            pass  # observability must never break the dispatch path

    def token(self) -> int:
        """Opaque position marker; pass to `since()` to read everything
        noted after this point."""
        with self._lock:
            return self._seq

    def since(self, token: int,
              thread_ident: Optional[int] = None) -> List[Tuple[str, float]]:
        """Stalls noted after `token`; with `thread_ident`, only those
        noted by that thread (per-dispatch attribution: the dispatch's
        own synchronous work runs on the dispatch thread)."""
        with self._lock:
            if self._seq == token:  # steady state: no stalls since the
                return []           # token — O(1) on the dispatch path
            return [(label, secs) for seq, tid, label, secs in self._log
                    if seq > token
                    and (thread_ident is None or tid == thread_ident)]


# process-wide meter: the compile tracker's build and capture notes
# feed it; the serve dispatch loop reads deltas around each dispatch
STALLS = StallMeter()
