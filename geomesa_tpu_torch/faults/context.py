"""Per-request deadline propagation + per-dispatch recovery attribution.

A copy of the reference package's `faults/context.py`.

Deadline scope: the planner's execute/knn entry points wrap their body
in ``deadline_scope(monotonic_deadline)`` so every retry loop at a
dependency boundary — however deep in the storage/Kafka/device stack —
can refuse to sleep past the request's remaining budget WITHOUT the
deadline being threaded through every call signature. Thread-local by
design: the serve dispatch thread runs one request group at a time.

RecoveryMeter: same token/since discipline as compilecache.stall.STALLS
— retry attempts and injected faults noted during one dispatch window
are charged to the requests that rode it (ServeEvent.retries /
ServeEvent.fault_injected).
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import List, Optional, Tuple

_MAX_LOG = 8192

_tls = threading.local()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[float]):
    """Set the current thread's absolute deadline (time.monotonic
    seconds) for the duration. None = no deadline. Nested scopes keep
    the TIGHTER deadline — an outer request budget must not be relaxed
    by an inner helper."""
    prev = getattr(_tls, "deadline", None)
    if deadline is None:
        eff = prev
    elif prev is None:
        eff = deadline
    else:
        eff = min(prev, deadline)
    _tls.deadline = eff
    try:
        yield eff
    finally:
        _tls.deadline = prev


def current_deadline() -> Optional[float]:
    """The calling thread's absolute deadline, or None."""
    return getattr(_tls, "deadline", None)


class RecoveryMeter:
    """Thread-safe bounded log of (seq, thread, kind, label) recovery
    events: kind "retry" (one backoff attempt at a boundary) or "fault"
    (one injected fault observed)."""

    def __init__(self, max_log: int = _MAX_LOG):
        self._lock = threading.Lock()
        self._seq = 0
        self._log: "collections.deque" = collections.deque(maxlen=max_log)

    def note(self, kind: str, label: str) -> None:
        with self._lock:
            self._seq += 1
            self._log.append(
                (self._seq, threading.get_ident(), kind, label))

    def token(self) -> int:
        return self._seq  # an int read needs no lock

    def since(self, token: int,
              thread_ident: Optional[int] = None
              ) -> List[Tuple[str, str]]:
        """(kind, label) noted after `token`; with `thread_ident`, only
        events noted by that thread."""
        if self._seq == token:  # steady state: O(1), no lock
            return []
        with self._lock:
            return [(kind, label) for seq, tid, kind, label in self._log
                    if seq > token
                    and (thread_ident is None or tid == thread_ident)]


RECOVERY = RecoveryMeter()
