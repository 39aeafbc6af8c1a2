"""Query auditing.

A copy of the reference package's `plan/audit.py`.

Parity: geomesa-index-api audit (AuditWriter / QueryEvent persisted to a
*_queries table) [upstream, unverified]: one structured record per query with
filter, hints, planning/scan timings and hit counts — here a JSONL file (or
in-memory list) with per-phase wall timings.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import List, Optional


@dataclasses.dataclass
class QueryEvent:
    type_name: str
    filter: str
    hints: str
    plan_time_ms: float
    scan_time_ms: float
    compute_time_ms: float
    result_count: int
    partitions_scanned: int
    partitions_total: int
    user: str = ""
    timestamp: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServeEvent:
    """One serving-layer request record (the serve subsystem's analog of
    QueryEvent): queue wait vs device time, the coalesced batch size it
    rode in, and how it ended — the numbers a tail-latency investigation
    starts from. Written by serve.service.QueryService per request.

    The fields are the reference's. `retries`, `fault_injected` and
    `breaker_state` come from the recovery fabric (`faults/`);
    `mesh_shape` and `shards` from a mesh window's launch
    (`serve.batcher.note_launch_route`)."""

    type_name: str
    kind: str  # execute | count | knn
    tenant: str
    priority: str  # interactive | normal | batch
    queue_ms: float
    exec_ms: float
    batch_size: int  # members sharing this device dispatch (1 = alone)
    status: str  # ok | error | timeout
    degraded: bool = False
    # compile-stall attribution (docs/SERVING.md "Cold start"): wall ms
    # this dispatch spent inside inline XLA compiles, and which kernels/
    # filters compiled — a p99 spike traces to the exact kernel+bucket
    # that should have been in the warmup manifest
    compile_ms: float = 0.0
    compiled: str = ""  # comma-joined stall labels (bounded)
    # recovery attribution (docs/ROBUSTNESS.md, mirrors the compile_ms
    # pattern): how much of this request's latency went to the retry/
    # breaker fabric. `retries` = backoff attempts spent at dependency
    # boundaries during the dispatch window; `fault_injected` = injected
    # faults observed in the window (0 outside chaos runs);
    # `breaker_state` = non-closed breakers at completion, e.g.
    # "storage=open" ("" when all dependencies are healthy).
    retries: int = 0
    fault_injected: int = 0
    breaker_state: str = ""
    # pipelined dispatch (docs/SERVING.md "Pipelined dispatch"): True
    # when this request rode a pipelined window — exec_ms then spans
    # launch→deferred-sync, and count requests may have been fused onto
    # a kNN window's mask reduction
    pipelined: bool = False
    # telemetry correlation (docs/OBSERVABILITY.md): the id of the span
    # trace this request produced, "" when tracing was off. The
    # ServeEvent is the root span's summary — an audit-log latency
    # outlier joins its flight-recorder flame view on this key.
    trace_id: str = ""
    # sharded serving (docs/SERVING.md "Sharded serving"): the device
    # topology the window executed on ("" = single-chip, "(4,)" = a
    # 4-chip mesh) and which shards owned the window's tiles ("0,2" —
    # a single id means the shard-affinity route ran the window on that
    # chip alone). A per-shard latency regression slices the audit log
    # on these.
    mesh_shape: str = ""
    shards: str = ""
    # approximate-answer tier (docs/SERVING.md "Approximate answers"):
    # approx=True — the answer came from sketches with a typed bound
    # (no device work); cache_hit=True — resolved from the version-
    # exact result cache (no dispatch at all). Together with the
    # default exact path these are the three serving tiers a latency
    # investigation slices on.
    approx: bool = False
    cache_hit: bool = False
    user: str = ""
    timestamp: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class AuditWriter:
    """Collects QueryEvents (and serve-layer ServeEvents); optionally
    appends JSONL to a path. The in-memory list keeps only the most
    recent `max_events`: the serve layer writes one event per request,
    so a long-lived server would otherwise grow it without bound — the
    durable record is the JSONL path, not this buffer."""

    def __init__(self, path: Optional[str] = None,
                 max_events: int = 100_000):
        self.path = path
        self.max_events = max_events
        self.events: List[QueryEvent] = []
        # the serve dispatch thread, client threads resolving live-layer
        # fast paths and ingest writers all write() concurrently — the
        # buffer append + trim is a compound mutation (GT12)
        self._lock = threading.Lock()

    def write(self, event: "QueryEvent | ServeEvent") -> None:
        event.timestamp = time.time()
        with self._lock:
            self.events.append(event)
            if len(self.events) > self.max_events:
                del self.events[: len(self.events) - self.max_events]
            line = json.dumps(event.to_json()) + "\n" if self.path else None
        if line is not None:
            # file append OUTSIDE the lock (GT09): one full line per
            # write() — O_APPEND keeps concurrent lines whole, though
            # their order may differ from buffer order by a few events
            with open(self.path, "a") as f:
                f.write(line)

    def snapshot(self) -> "List[QueryEvent | ServeEvent]":
        """Copy of the in-memory buffer, consistent under writers."""
        with self._lock:
            return list(self.events)
