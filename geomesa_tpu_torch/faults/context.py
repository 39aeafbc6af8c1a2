"""Per-request deadline propagation.

Deadline scope: the planner's execute/knn entry points wrap their body
in ``deadline_scope(monotonic_deadline)`` so every retry loop at a
dependency boundary — however deep in the storage/Kafka/device stack —
can refuse to sleep past the request's remaining budget WITHOUT the
deadline being threaded through every call signature. Thread-local by
design: the serve dispatch thread runs one request group at a time.

The reference's RecoveryMeter, which charges retries and injected faults
to the requests of a dispatch window, comes with the retry and injection
code that notes into it (ROADMAP A8).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

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
