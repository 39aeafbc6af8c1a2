"""Per-dependency circuit breakers (closed / open / half-open).

A copy of the reference package's `faults/breaker.py`, with one
half-open probe.

One breaker per dependency (storage, kafka, device, ...) shared by
every call site of that dependency in the process. Semantics:

  closed     — calls flow; consecutive transient failures count up.
  open       — after `failure_threshold` consecutive failures, calls
               are rejected immediately with the typed `BreakerOpen`
               (no queue time wasted on a dead dependency). After
               `reset_timeout_s` the next `allow()` transitions to
               half-open.
  half-open  — one probe call passes; its success closes the
               breaker, its failure re-opens it (and restarts the
               reset clock).

Every transition is metrics-visible: gauge `fault.breaker.<name>`
(0=closed, 1=half-open, 2=open) plus counters
`fault.breaker.<name>.open|half_open|close` — the chaos checker asserts
open AND half-open transitions appeared under an outage plan.

The clock is injectable so the state machine is testable without
sleeps.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

_STATE_NUM = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


class BreakerOpen(RuntimeError):
    """Typed fail-fast rejection: the dependency's breaker is open.
    Carries `reason="breaker_open"` so protocol layers render it like
    the scheduler's QueryRejected family."""

    def __init__(self, dependency: str, retry_after_s: float):
        super().__init__(
            f"circuit breaker for {dependency!r} is open "
            f"(retry after ~{max(retry_after_s, 0.0):.2f}s)")
        self.dependency = dependency
        self.reason = "breaker_open"
        self.retry_after_s = max(retry_after_s, 0.0)


class CircuitBreaker:
    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probes = 0
        self._probe_at = 0.0  # when the last half-open probe was granted

    # -- state machine -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, state: str) -> None:
        # callers hold self._lock
        self._state = state
        try:
            from geomesa_tpu_torch.telemetry.recorder import RECORDER
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.gauge(f"fault.breaker.{self.name}", _STATE_NUM[state])
            metrics.counter(
                f"fault.breaker.{self.name}."
                + ("close" if state == "closed" else state))
            # flight-recorder event: a breaker flip is exactly the kind
            # of context a last-N-queries postmortem needs alongside the
            # traces (a bounded deque append — not a blocking call)
            RECORDER.note_event("breaker", dependency=self.name,
                                state=state)
        except Exception:
            pass  # observability must never wedge the breaker

    def allow(self) -> None:
        """Gate a call: raises BreakerOpen when the dependency is open
        (or half-open with its one probe already granted)."""
        if self._state == "closed":
            return  # the steady state takes no lock (one attribute read)
        with self._lock:
            if self._state == "open":
                elapsed = self.clock() - self._opened_at
                if elapsed < self.reset_timeout_s:
                    raise BreakerOpen(
                        self.name, self.reset_timeout_s - elapsed)
                self._probes = 0
                self._transition("half_open")
            if self._state == "half_open":
                if self._probes:
                    # a probe that never reported back (its failure was
                    # non-transient, so the retry fabric recorded
                    # neither success nor failure) must not wedge the
                    # breaker half-open forever: its slot goes stale
                    # after reset_timeout_s and a new probe round opens
                    since_probe = self.clock() - self._probe_at
                    if since_probe < self.reset_timeout_s:
                        raise BreakerOpen(
                            self.name,
                            self.reset_timeout_s - since_probe)
                    self._probes = 0
                self._probes += 1
                self._probe_at = self.clock()

    def record_success(self) -> None:
        if self._state == "closed" and not self._failures:
            return  # nothing to reset: the steady state takes no lock
        with self._lock:
            self._failures = 0
            if self._state != "closed":
                self._transition("closed")

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half_open" or (
                    self._state == "closed"
                    and self._failures >= self.failure_threshold):
                self._opened_at = self.clock()
                self._probes = 0
                if self._state != "open":
                    self._transition("open")
                else:  # pragma: no cover - defensive
                    self._opened_at = self.clock()

    def reset(self) -> None:
        with self._lock:
            self._failures = 0
            self._probes = 0
            if self._state != "closed":
                self._transition("closed")


class BreakerRegistry:
    """Lazy per-dependency breakers; `configure` (before first use or
    any time after) overrides thresholds — the chaos runner shrinks the
    reset timeout so open -> half-open -> closed plays out in-process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._config: Dict[str, dict] = {}

    def get(self, name: str) -> CircuitBreaker:
        b = self._breakers.get(name)
        if b is not None:  # the steady state: one dict read, no lock
            return b
        with self._lock:
            b = self._breakers.get(name)
            if b is None:
                b = self._breakers[name] = CircuitBreaker(
                    name, **self._config.get(name, {}))
            return b

    def configure(self, name: str, **kw) -> CircuitBreaker:
        with self._lock:
            self._config[name] = kw
            b = self._breakers[name] = CircuitBreaker(name, **kw)
            return b

    def restore_config(self, name: str) -> None:
        """Drop a `configure(name, ...)` override: the breaker goes back
        to the constructor defaults, closed."""
        with self._lock:
            self._config.pop(name, None)
            self._breakers[name] = CircuitBreaker(name)

    def states(self) -> Dict[str, str]:
        with self._lock:
            items = list(self._breakers.items())
        # one attribute read a breaker: a served window reads this, and
        # a state is a single reference, so no breaker lock is needed
        return {name: b._state for name, b in items}

    def reset(self, name: Optional[str] = None) -> None:
        with self._lock:
            items = ([self._breakers[name]] if name in self._breakers
                     else list(self._breakers.values())
                     if name is None else [])
        for b in items:
            b.reset()


BREAKERS = BreakerRegistry()
