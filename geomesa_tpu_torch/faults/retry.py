"""Bounded retry with exponential backoff + full jitter, deadline-aware.

A copy of the reference package's `faults/retry.py`.

The one retry loop every dependency boundary shares (AWS builders'-
library full-jitter shape): attempt k sleeps uniform(0, min(cap,
base * 2^k)). Three hard bounds keep it from becoming an unbounded
while-True loop:

  1. `max_attempts` caps total tries;
  2. only `classify(exc) == "transient"` errors retry — OOM and
     permanent errors surface immediately;
  3. the current deadline scope (faults.context) is never slept past:
     if the next backoff would cross the request's remaining budget the
     last error surfaces NOW, so a client sees the failure while its
     deadline can still act on it.

An optional circuit breaker gates every attempt (`allow` before,
`record_success`/`record_failure` after) so a dead dependency flips to
fail-fast instead of every request burning its full retry budget.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from random import Random
from typing import Callable, Optional

from geomesa_tpu_torch.faults import context
from geomesa_tpu_torch.faults.breaker import CircuitBreaker
from geomesa_tpu_torch.faults.errors import classify as _classify


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 4
    base_ms: float = 10.0
    cap_ms: float = 2000.0

    def backoff_ms(self, attempt: int, rng: Random) -> float:
        """Full-jitter delay for `attempt` (0-based count of failures
        so far): uniform(0, min(cap, base * 2^attempt))."""
        return rng.uniform(
            0.0, min(self.cap_ms, self.base_ms * (2.0 ** attempt)))


# jitter quality does not need determinism in production; tests inject
# their own seeded Random
_RNG = Random()


def retry_call(
    fn: Callable,
    *args,
    policy: RetryPolicy,
    label: str,
    breaker: Optional[CircuitBreaker] = None,
    classify: Callable[[BaseException], str] = _classify,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[Random] = None,
    **kw,
):
    """Call `fn(*args, **kw)` under the retry/breaker fabric. Returns
    the call's result; raises the breaker's BreakerOpen, or the last
    error once retries are exhausted / ineligible."""
    rng = rng or _RNG
    attempt = 0
    while True:
        if breaker is not None:
            breaker.allow()
        try:
            out = fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 — classification decides
            kind = classify(e)
            if breaker is not None and kind == "transient":
                # dependency-HEALTH signals only: a permanent error
                # (bad input) says nothing about the dependency, and
                # an OOM is a program-size signal with its own ladder
                # (halve the bucket, host-eval) — tripping the breaker
                # on OOM would fail-fast the very requests the ladder
                # exists to save
                breaker.record_failure()
            attempt += 1
            if kind != "transient" or attempt >= policy.max_attempts:
                raise
            delay_s = policy.backoff_ms(attempt - 1, rng) / 1000.0
            deadline = context.current_deadline()
            if deadline is not None and clock() + delay_s >= deadline:
                raise  # never retry past the request deadline
            try:
                from geomesa_tpu_torch.utils.metrics import metrics

                metrics.counter(f"fault.retry.{label}")
                context.RECOVERY.note("retry", label)
            except Exception:
                pass  # observability must never break the retry path
            sleep(delay_s)
            continue
        if breaker is not None:
            breaker.record_success()
        return out
