"""Admission control for the query-serving layer.

A copy of the reference package's `serve/scheduler.py`.

The serving shape this targets: many small BBOX/kNN/count queries from
concurrent clients against one device-resident store. The device executes
one program at a time, so the scheduler's job is to decide — BEFORE any
device work — which requests wait, which coalesce, and which are shed,
with explicit backpressure instead of unbounded buffering (the Clipper /
Orca admission-control stance; PAPERS.md serving citations).

Pieces:
- `ServeRequest`: one in-flight query (kind execute|count|knn) with a
  priority class, tenant label, absolute deadline, cancellation flag and
  a result future.
- `TokenBucket`: per-tenant rate limiting (rate r tokens/s, burst b).
- `AdmissionQueue`: bounded, priority-classed FIFO. `put` raises a typed
  `QueryRejected` when full (load shedding — the queue NEVER grows past
  its bound, so queue wait is bounded by design) and `drain_compatible`
  hands the batcher every queued request sharing a coalescing key.

Deadlines propagate into the planner's cooperative timeout checks via
`QueryPlanner.execute(timeout_ms=...)`; expiry surfaces as the typed
`plan.QueryTimeout`, distinct from `QueryRejected` (shed) and from real
errors — the three-way split a serving client needs for retry policy.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Deque, Dict, List, Optional

from geomesa_tpu_torch.plan.query import Query

# priority classes, highest first; index = scheduling order
PRIORITIES = ("interactive", "normal", "batch")

_ids = itertools.count()


class QueryRejected(RuntimeError):
    """Typed load-shed signal: the request never reached the device.

    reason:
      queue_full    — admission queue at capacity (backpressure)
      rate_limited  — tenant token bucket empty
      shed          — degradation ladder dropping low-priority work
      shutting_down — service draining; no new admissions
      cancelled     — caller cancelled while queued
      quarantined   — poison-query quarantine: this fingerprint crashed
                      repeatedly and is blocked for the quarantine TTL
                      (faults/quarantine.py, docs/ROBUSTNESS.md)
    """

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(
            f"query rejected ({reason})" + (f": {detail}" if detail else "")
        )
        self.reason = reason
        self.detail = detail


@dataclasses.dataclass
class ServeRequest:
    """One admitted (or to-be-admitted) query."""

    kind: str  # "execute" | "count" | "knn"
    query: Query
    # knn-only: host query coordinates + k + kernel choice
    qx: object = None
    qy: object = None
    k: int = 10
    impl: str = "sparse"
    tenant: str = ""
    priority: int = 1  # index into PRIORITIES
    deadline: Optional[float] = None  # absolute time.monotonic() seconds
    # degradation ladder opt-in: under sustained overload the service may
    # rewrite hints (loose bbox / sampling) for requests that allow it
    allow_degraded: bool = False
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    future: Future = dataclasses.field(default_factory=Future)
    enqueued_at: float = 0.0
    # telemetry (docs/OBSERVABILITY.md): the per-query Trace opened at
    # submit (None when tracing is off — every downstream telemetry
    # call no-ops on None), plus the perf_counter_ns enqueue stamp the
    # dispatch loop uses to record the cross-thread queue.wait span
    # (enqueued_at is time.monotonic seconds: a different clock)
    trace: object = None
    enqueued_ns: int = 0
    degraded: bool = False  # set by the service when the ladder rewrote hints
    # pre-degrade poison fingerprint, stashed by the service's ladder
    # BEFORE it rewrites hints: the coalescing key includes the hint
    # string, so striking the post-degrade key would never match the
    # key admission checks (quarantine would silently never trip for
    # degraded requests)
    quarantine_key: object = None
    # sharded serving (docs/SERVING.md "Sharded serving"): the shard-
    # affinity tag computed at admission (`shard_affinity`) — which
    # chips own the tiles this query's pruned partitions live on. The
    # planner's dispatch seam recomputes it authoritatively from the
    # plan and overrides; mesh_shape/shards end up on the ServeEvent.
    shards: str = ""
    mesh_shape: str = ""
    # approximate-answer tier + result cache (docs/SERVING.md
    # "Approximate answers"): the service attaches its ResultCache to
    # count/execute requests so the batcher can populate it with the
    # version the planner actually pinned; cache_hit marks a request
    # resolved without any dispatch, approx marks a sketch-served
    # answer (both ride the ServeEvent)
    cache: object = None
    cache_hit: bool = False
    approx: bool = False
    # degradation-ladder sketch rung (docs/SERVING.md "Degradation
    # ladder"): nonzero = the ladder injected the tolerance hint at
    # this level. The request is marked `degraded` — and spends the
    # SLO exactness budget — only if a sketch answer is actually
    # SERVED; a bound that does not fit runs exact, unmarked, with
    # the budget untouched.
    sketch_rung: int = 0
    # columnar wire (docs/SERVING.md "Columnar wire"): "columnar" when
    # the request opted into binary record-batch framing for its bulk
    # payload (execute features / density / topk grids). The protocol
    # layer sets it AND downgrades it typed when the capability is
    # absent; the dispatch path never reads it — encoding is a
    # response-time concern.
    wire: str = "json"

    def __post_init__(self):
        if self.kind not in ("execute", "count", "knn"):
            raise ValueError(f"unknown request kind {self.kind!r}")
        if not 0 <= self.priority < len(PRIORITIES):
            raise ValueError(
                f"priority must be in [0, {len(PRIORITIES)}), "
                f"got {self.priority}"
            )

    def cancel(self) -> bool:
        """Cancel a queued request; returns False once it started running."""
        return self.future.cancel()

    @property
    def remaining_ms(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return (self.deadline - time.monotonic()) * 1000.0

    @property
    def expired(self) -> bool:
        r = self.remaining_ms
        return r is not None and r <= 0.0


def shard_affinity(source, req: ServeRequest) -> tuple:
    """Admission-time shard affinity: the mesh shards owning the rows of
    the partitions `req`'s query touches, so a query lands where its
    tiles live. Metadata only and best effort: bbox/interval extraction,
    the manifest's partition pruning and the device cache's ownership map
    (`DeviceCacheManager.shards_for`), with no planning and no device
    work; a cold cache, a store without a mesh and any failure answer ()
    (the planner's mesh dispatch recomputes the authoritative value)."""
    planner = getattr(source, "planner", None)
    cache = getattr(planner, "cache", None)
    if cache is None or getattr(cache, "mesh", None) is None:
        return ()
    try:
        from geomesa_tpu_torch.cql.extract import (
            BBox, Interval, extract_bbox, extract_intervals)

        sft = source.storage.sft
        g = sft.default_geometry
        d = sft.default_dtg
        f = req.query.filter_ast
        bbox = extract_bbox(f, g.name) if g else BBox(-180, -90, 180, 90)
        interval = (extract_intervals(f, d.name) if d
                    else Interval(None, None))
        manifest = source.storage.manifest_snapshot()
        parts = source.storage.prune_partitions(bbox, interval,
                                                manifest=manifest)
        return cache.shards_for(parts)
    except Exception:  # noqa: BLE001 — a routing hint never fails admission
        return ()


class TokenBucket:
    """Classic token bucket: capacity `burst`, refill `rate` tokens/s.
    Thread-safe; `try_acquire` never blocks (admission control sheds,
    it does not queue on rates)."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError("token bucket rate and burst must be > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._stamp) * self.rate
            )
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class AdmissionQueue:
    """Bounded priority-classed FIFO. One deque per priority class;
    `pop` serves the highest class first, FIFO within a class, so a
    steady batch-class flood can never starve interactive queries of
    *ordering* (only of device time, which the bound caps)."""

    def __init__(self, max_depth: int):
        if max_depth < 1:
            raise ValueError("queue depth must be >= 1")
        self.max_depth = max_depth
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._classes: List[Deque[ServeRequest]] = [
            deque() for _ in PRIORITIES
        ]

    def __len__(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._classes)

    def depths(self) -> Dict[str, int]:
        """Per-priority-class occupancy snapshot, keyed by class name
        (`serve.queue.class_depth{priority=...}` gauges — a batch-class
        backlog behind an empty interactive lane reads differently from
        a uniformly full queue on a dashboard)."""
        with self._lock:
            return {PRIORITIES[i]: len(d)
                    for i, d in enumerate(self._classes)}

    def put(self, req: ServeRequest) -> None:
        with self._lock:
            if sum(len(d) for d in self._classes) >= self.max_depth:
                raise QueryRejected(
                    "queue_full",
                    f"admission queue at capacity ({self.max_depth})",
                )
            req.enqueued_at = time.monotonic()
            req.enqueued_ns = time.perf_counter_ns()
            self._classes[req.priority].append(req)
            self._not_empty.notify()

    def pop(
        self,
        timeout: Optional[float] = None,
        on_pop: Optional[Callable[[ServeRequest], None]] = None,
    ) -> Optional[ServeRequest]:
        """Highest-priority oldest request, or None on timeout. Requests
        cancelled while queued are skipped (their futures are already
        resolved by Future.cancel). `on_pop` runs under the queue lock
        before the request is returned, so a caller can mark it in-flight
        atomically with its removal — a drain loop that checks
        "queue empty AND nothing in flight" must never observe the window
        between the two."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                for d in self._classes:
                    while d:
                        req = d.popleft()
                        if req.future.cancelled():
                            continue
                        if on_pop is not None:
                            # gt: waive GT11
                            # (deliberate: the callback is the atomic
                            # pop+mark-inflight step, see docstring; its
                            # only consumer is _mark_inflight, which
                            # takes _state_lock, never this queue lock)
                            on_pop(req)
                        return req
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._not_empty.wait(remaining)
                else:
                    self._not_empty.wait()

    def drain_compatible(
        self,
        key: object,
        key_fn: Callable[[ServeRequest], object],
        limit: int,
    ) -> List[ServeRequest]:
        """Remove and return up to `limit` queued requests whose
        coalescing key matches `key` (any priority class — a batch-class
        request identical to an interactive one rides its dispatch for
        free). Non-matching requests keep their positions."""
        out: List[ServeRequest] = []
        if key is None or limit <= 0:
            return out
        with self._lock:
            for d in self._classes:
                if len(out) >= limit:
                    break
                keep: Deque[ServeRequest] = deque()
                while d:
                    req = d.popleft()
                    if req.future.cancelled():
                        continue
                    if len(out) < limit and key_fn(req) == key:
                        out.append(req)
                    else:
                        keep.append(req)
                d.extend(keep)
        return out

    def drain_all(self) -> List[ServeRequest]:
        """Empty the queue (non-graceful shutdown path)."""
        with self._lock:
            out = [r for d in self._classes for r in d]
            for d in self._classes:
                d.clear()
        return out


class RateLimiter:
    """Per-tenant token buckets sharing one (rate, burst) config; tenants
    appear lazily. rate=None disables limiting entirely."""

    def __init__(self, rate: Optional[float], burst: float = 8.0):
        self.rate = rate
        self.burst = burst
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def admit(self, tenant: str) -> None:
        if self.rate is None:
            return
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    self.rate, self.burst
                )
        if not bucket.try_acquire():
            raise QueryRejected(
                "rate_limited",
                f"tenant {tenant!r} over {self.rate:g} qps "
                f"(burst {self.burst:g})",
            )
