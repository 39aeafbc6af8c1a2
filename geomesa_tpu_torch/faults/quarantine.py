"""Poison-query quarantine.

A copy of the reference package's `faults/quarantine.py`.

A request that repeatedly crashes a kernel (permanent/OOM errors, not
shed/timeout/transient) must stop re-entering the dispatcher: each
crash costs a full dispatch, and a hot poison query can starve healthy
traffic while looking like "load". The registry keys strikes by the
request's coalescing fingerprint (serve.batcher.compat_key — same
canonical CQL + kind + kernel choice that would share a dispatch), and
after `strikes` crashes within `ttl_s` the service rejects the
fingerprint with a typed QueryRejected("quarantined", ...) at ADMISSION
— before it queues, before it dispatches.

Quarantine expires after `ttl_s` (a deploy may have fixed the kernel),
and the table is bounded so an adversarial stream of unique poison
queries cannot grow it without bound.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple


class QuarantineRegistry:
    def __init__(self, strikes: int = 3, ttl_s: float = 600.0,
                 max_entries: int = 1024,
                 clock: Callable[[], float] = time.monotonic):
        if strikes < 1:
            raise ValueError("strikes must be >= 1")
        self.strikes = strikes
        self.ttl_s = ttl_s
        self.clock = clock
        self.max_entries = max_entries
        self._lock = threading.Lock()
        # key -> (strike_count, last_strike_at)
        self._strikes: Dict[object, Tuple[int, float]] = {}
        # key -> quarantined_at
        self._blocked: Dict[object, float] = {}

    def _expire(self, now: float) -> None:
        # callers hold self._lock
        dead = [k for k, at in self._blocked.items()
                if now - at >= self.ttl_s]
        for k in dead:
            del self._blocked[k]
        stale = [k for k, (_, at) in self._strikes.items()
                 if now - at >= self.ttl_s]
        for k in stale:
            del self._strikes[k]

    def empty(self) -> bool:
        """True when neither strikes nor quarantines exist — the
        admission hot path checks this BEFORE computing the fingerprint
        (a canonical-CQL serialization) so the steady state pays one
        lock acquisition, not an AST walk per request."""
        with self._lock:
            return not self._blocked and not self._strikes

    def blocked(self, key: object) -> Optional[str]:
        """A human-readable reason when `key` is quarantined, else
        None. Expiry is evaluated lazily here."""
        if key is None:
            return None
        now = self.clock()
        with self._lock:
            self._expire(now)
            at = self._blocked.get(key)
            if at is None:
                return None
            remaining = self.ttl_s - (now - at)
            return (f"query crashed {self.strikes}+ times; quarantined "
                    f"for another ~{remaining:.0f}s")

    def strike(self, key: object) -> bool:
        """Record one crash for `key`; returns True when this strike
        crossed the quarantine threshold."""
        if key is None:
            return False
        now = self.clock()
        with self._lock:
            self._expire(now)
            count, _ = self._strikes.get(key, (0, now))
            count += 1
            if count >= self.strikes and len(self._blocked) < self.max_entries:
                self._strikes.pop(key, None)
                self._blocked[key] = now
                tripped = True
            else:
                # below threshold — or the blocked table is full: keep
                # the strike history (clamped at the threshold) so the
                # key quarantines the moment capacity frees, instead of
                # resetting its own count and never quarantining while
                # falsely reporting tripped
                if key not in self._strikes and \
                        len(self._strikes) >= self.max_entries:
                    self._strikes.clear()  # bound adversarial streams
                self._strikes[key] = (min(count, self.strikes), now)
                tripped = False
            blocked_n = len(self._blocked)
        try:
            from geomesa_tpu_torch.telemetry.recorder import RECORDER
            from geomesa_tpu_torch.utils.metrics import metrics

            if tripped:
                metrics.counter("fault.quarantined")
            metrics.gauge("fault.quarantine.active", blocked_n)
            RECORDER.note_event(
                "quarantine", action="trip" if tripped else "strike",
                key=repr(key), strikes=count)
        except Exception:
            pass
        return tripped

    def stats(self) -> dict:
        with self._lock:
            return {"quarantined": len(self._blocked),
                    "striking": len(self._strikes)}

    def clear(self) -> None:
        with self._lock:
            self._strikes.clear()
            self._blocked.clear()
