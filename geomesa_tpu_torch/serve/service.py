"""QueryService: the concurrent serving front end.

The port of the reference package's `serve/service.py` on its serial
route. It wires the admission scheduler (bounded queue, priority
classes, tenant rate limits, typed shedding) to the request batcher
(coalesced device dispatches) over a DataStore. One dispatch thread
drives the device — the card runs the window's launches in order on one
stream, so more dispatch threads would only interleave launches, not add
throughput; concurrency buys throughput here through COALESCING, not
parallel dispatch.

Lifecycle:

    svc = QueryService(store)                 # starts the dispatcher
    fut = svc.knn("gdelt", CQL, qx, qy, k=8)  # -> Future
    dists, idx, batch = fut.result(timeout=60)
    svc.close(drain=True)                     # graceful: finish queue

The service runs on whatever device its store runs on. kNN windows take
the pipelined route by default (`serve/pipeline.py`: prepare, transfer
and launch on the dispatch thread, the sync on a completer thread, up to
`pipeline_depth` windows in flight) and, where the window class allows,
the persistent ring (`serve/ringloop.py`: one captured CUDA graph per
ring slot); `pipeline=False` restores the fully serial dispatch, whose
one host sync a window is `KnnLaunch.sync`. A first-use kernel build or
graph capture on the dispatch path is a compile stall, charged to its
window's ServeEvents (`compile_ms`, `compiled`); `record_warmup()` and
`warmup()` (or `warmup_manifest`) move them ahead of traffic.

Degradation ladder (opt-in per request via allow_degraded, master switch
ServeConfig.degrade): as queue occupancy crosses the watermarks the
service first downgrades hints (level 1: loose bbox — skip the exact
residual re-check of the spatial primary; level 2: + 1-in-4 sampling),
then sheds batch-class work, and the bounded queue rejects the rest.
Responses from downgraded queries carry request.degraded = True. The
first rung, before loose bbox, is the sketch tier: an eligible count or
unweighted density gets the `approx_degrade_tolerance` hint and is
marked degraded only where a sketch answer is served
(`_resolve_approx`, `_finish_window`).

Approximate answers: a count with a `tolerance` hint answers at
admission from the planner's sketches when the bound fits
(`_approx_peek`, no queue, no dispatch); every miss is queued and pays
the exact path on the card.

Observability: per-request ServeEvents into the store's audit writer,
queue-wait and end-to-end latency histograms (p50/p95/p99 via the
Prometheus export), dispatch/coalesce/shed counters — all through
`geomesa_tpu_torch.utils.metrics` plus a per-instance `stats()` snapshot.
`trace=True` turns the process-wide span tracer on (each request's trace
lands in the flight recorder, `telemetry/recorder.py`); `profile=True`
folds every recorded trace into the continuous profiler
(`telemetry/prof.py`); `slo` loads an SLO engine (`telemetry/slo.py`)
that every resolved request feeds, whose burn rate is a second input of
the degradation ladder and whose spent exactness budget routes tolerant
requests exact. A `telemetry.export.MetricsServer` built over
`stats`/`export_gauges` serves it all over HTTP (set `metrics_port` to
the port it bound).

Sharded serving: `ServeConfig.mesh` resolves through
`parallel.mesh.serve_mesh` and is installed on the store (`set_mesh`);
the serial, pipelined and ring routes then serve kNN windows over the
mesh tier (the planner's mesh and shard-affinity routes, the ring's mesh
programs), and admission tags each request with the shards owning its
partitions (`shard_affinity`).

A mesh that spans processes (`parallel.distributed.global_mesh`) is
served by one `QueryService` in each process, every merge a collective
over the process group. The contract, as the reference's: every process
submits the same requests in the same order, and each window holds the
same requests in every process (one closed client a process, with
identical request streams, keeps it). Shard affinity is off there: every
window runs the whole mesh.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from geomesa_tpu_torch.approx.cache import ResultCache, result_key
from geomesa_tpu_torch.compilecache.stall import STALLS
from geomesa_tpu_torch.faults import (
    BREAKERS, RECOVERY, BreakerOpen, QuarantineRegistry, classify)
from geomesa_tpu_torch.faults.breaker import _STATE_NUM
from geomesa_tpu_torch.plan.audit import ServeEvent
from geomesa_tpu_torch.plan.planner import QueryTimeout
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.serve.batcher import (
    MIN_KNN_BATCH, _next_pow2, compat_key, execute_batch, fail_expired,
    fused_count_key, split_expired)
from geomesa_tpu_torch.serve.scheduler import (
    PRIORITIES, AdmissionQueue, QueryRejected, RateLimiter, ServeRequest)
from geomesa_tpu_torch.telemetry.prof import PROFILER
from geomesa_tpu_torch.telemetry.recorder import RECORDER
from geomesa_tpu_torch.telemetry.slo import SloEngine, SloSpec
from geomesa_tpu_torch.telemetry.trace import TRACER
from geomesa_tpu_torch.utils.metrics import metrics

@dataclasses.dataclass
class ServeConfig:
    """The reference's fields and defaults."""

    max_queue: int = 128        # admission bound (backpressure, not buffer)
    max_batch: int = 64         # coalescing cap per dispatch
    max_wait_ms: float = 2.0    # coalescing window: added latency ceiling
    default_timeout_ms: Optional[int] = None  # per-request deadline default
    tenant_rate: Optional[float] = None  # qps per tenant; None = unlimited
    tenant_burst: float = 8.0
    # poison-query quarantine: a fingerprint that crashes
    # `quarantine_after` dispatches within the TTL is rejected at
    # admission with QueryRejected("quarantined"); 0 disables
    quarantine_after: int = 3
    quarantine_ttl_s: float = 600.0
    degrade: bool = False       # master switch for the degradation ladder
    degrade_watermark: float = 0.75  # queue occupancy -> hint downgrades
    shed_watermark: float = 0.90     # queue occupancy -> shed batch class
    drain_timeout_s: float = 30.0
    # cold-start management: a warm-up manifest path replays BEFORE the
    # dispatcher takes traffic; track_compiles attaches the compile
    # tracker (extension builds and graph captures are counted, and
    # ServeEvents carry the stalls; warmup()/record_warmup() attach it
    # on demand too)
    warmup_manifest: Optional[str] = None
    track_compiles: bool = False
    # telemetry: trace=True enables the PROCESS-WIDE span tracer at
    # construction; flight_dump sets the flight recorder's crash-dump
    # path for this process
    trace: bool = False
    flight_dump: Optional[str] = None
    # SLO engine: a spec path (.toml/.json), a spec dict, an SloSpec, or
    # a ready SloEngine (tests inject one with a fake clock). Every
    # resolved request feeds its sliding windows, `slo.*` gauges export
    # at scrape time, and with `degrade` on the ladder takes the engine's
    # burn-rate boost beside queue occupancy
    slo: object = None
    # continuous profiler: fold every recorded trace into the process-
    # lifetime distributions (needs trace=True to have traces to fold;
    # the flag flips the process-wide PROFILER switch)
    profile: bool = False
    # pipelined dispatch: kNN windows run prepare/transfer/launch on the
    # dispatch thread and the sync on a completer thread, up to
    # `pipeline_depth` windows in flight. pipeline=False restores the
    # fully serial dispatch. pipeline_donate is the reference's switch
    # for donating the staged query buffers: the port never re-reads a
    # staged slot (its overflow fallback re-uploads the host copies), so
    # every value (None, True, False) runs the same; others are refused.
    pipeline: bool = True
    pipeline_depth: int = 2
    pipeline_donate: Optional[bool] = None
    # persistent serve loop: eligible kNN window classes replay one
    # captured program (frozen plan/mask/capacity, one CUDA graph per
    # slot of a `ring_depth` ring); ineligible or stale windows fall back
    # typed to the pipeline; ring=False disables the tier
    ring: bool = True
    ring_depth: int = 4
    # sharded serving: None = the store's own mesh (if any), "off" = one
    # device, "auto" = every card when there are several, N, or a Mesh
    # (a process-spanning one from `parallel.distributed.global_mesh`:
    # then every process serves the same requests in the same order and
    # the same windows, or the collectives of the merges mismatch)
    mesh: object = None
    # standing queries: bounds of the subscribe wire verbs (the table
    # size, each outbox and each attached sink's queue, a subscription's
    # push rate) and the auto-poll pump's period while subscriptions exist
    subscribe_max: int = 256
    subscribe_outbox: int = 1024
    subscribe_rate: Optional[float] = None
    subscribe_poll_ms: Optional[float] = None
    # approximate-answer tier: the master switch (off strips every
    # tolerance hint at admission) and the ladder's sketch-rung tolerance
    approx: bool = True
    approx_degrade_tolerance: float = 0.1
    # version-exact result cache: count/execute results keyed on
    # (typeName, canonical CQL, hints, manifest version) — repeated
    # dashboard queries cost a dict lookup, invalidation is exact by
    # construction (a write bumps the version). 0 disables.
    result_cache: int = 256


def _check_config(config: ServeConfig) -> None:
    """Refuse, typed, a donate switch the port cannot honour."""
    if not (config.pipeline_donate is None
            or isinstance(config.pipeline_donate, bool)):
        raise ValueError(f"ServeConfig.pipeline_donate="
                         f"{config.pipeline_donate!r}: None, True or False")


def _count_compat_key(req: ServeRequest):
    """compat_key for count requests, None for any other kind."""
    return compat_key(req) if req.kind == "count" else None


def _quarantine_key(req: ServeRequest):
    """Poison fingerprint: the coalescing key (canonical CQL + kind +
    kernel choice — exactly what would share the crashing dispatch), or
    a coarse (kind, type) key for requests that never coalesce."""
    return compat_key(req) or ("solo", req.kind, req.query.type_name)


class QueryService:
    """In-process serving API over a DataStore (or any store exposing
    get_feature_source). Thread-safe: submit from any thread."""

    def __init__(self, store, config: Optional[ServeConfig] = None,
                 autostart: bool = True):
        self.store = store
        self.config = config or ServeConfig()
        _check_config(self.config)
        # sharded serving: resolve the spec once and install it on the
        # store (existing sources re-tier, new ones inherit it). None
        # inherits the store's mesh; "off" clears one. The ring serves a
        # mesh through its mesh programs (planner `_ring_arm_mesh`).
        if self.config.mesh is not None:
            from geomesa_tpu_torch.parallel.mesh import serve_mesh

            self.mesh = serve_mesh(self.config.mesh)
        else:
            self.mesh = getattr(store, "mesh", None)
        if self.config.mesh is not None and hasattr(store, "set_mesh"):
            store.set_mesh(self.mesh)
        self.queue = AdmissionQueue(self.config.max_queue)
        self.limiter = RateLimiter(
            self.config.tenant_rate, self.config.tenant_burst)
        self.quarantine = QuarantineRegistry(
            strikes=max(self.config.quarantine_after, 1),
            ttl_s=self.config.quarantine_ttl_s)
        # version-exact result cache: admission peeks it before
        # queueing, the dispatch loop populates it, and a hit never
        # enters a coalescing window
        self.result_cache = (ResultCache(self.config.result_cache)
                             if self.config.result_cache > 0 else None)
        self.audit = getattr(store, "audit", None)
        if self.config.trace:
            TRACER.enable()
        if self.config.flight_dump:
            RECORDER.auto_dump_path = self.config.flight_dump
        if self.config.profile:
            PROFILER.enable()
        # SLO engine: a path, dict, SloSpec or a ready engine
        self.slo = None
        if self.config.slo is not None:
            spec = self.config.slo
            if isinstance(spec, SloEngine):
                self.slo = spec
            else:
                if isinstance(spec, str):
                    spec = SloSpec.load(spec)
                elif isinstance(spec, dict):
                    spec = SloSpec.from_dict(spec)
                self.slo = SloEngine(spec)
        self._closed = False
        self._stop = threading.Event()
        self._inflight = 0
        self._state_lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._worker: Optional[threading.Thread] = None
        # standing-query manager (geomesa_tpu_torch.subscribe): attached
        # by the wire layer when the first subscribe verb arrives, so
        # stats() surfaces subscription state
        self.subscriptions = None
        # the columnar wire's push fan-out: ONE PushMux per service,
        # shared by every connection so a subscription's frames can
        # mirror onto attached connections; built by wire_mux()
        self._push_mux = None
        # the bound port of a MetricsServer its owner started for this
        # service (port=0 lets the OS pick, so the bound value is kept
        # here and reported by stats())
        self.metrics_port: Optional[int] = None
        # pipelined dispatch path (serve/pipeline.py): the default for
        # kNN windows; its completer thread starts on the first window
        self.pipeline = None
        if self.config.pipeline:
            from geomesa_tpu_torch.serve.pipeline import DispatchPipeline

            self.pipeline = DispatchPipeline(
                self, depth=self.config.pipeline_depth, ring=self.config.ring,
                ring_depth=self.config.ring_depth)
        self.tracker = None          # the compile tracker, when attached
        self._recorder = None        # WarmupRecorder, when recording
        try:
            if self.config.track_compiles:
                self._ensure_tracker()
            if self.config.warmup_manifest:
                # startup hook: replay before the dispatcher takes traffic
                self.warmup(self.config.warmup_manifest)
        except BaseException:
            # a failed constructor (a missing manifest) must not keep the
            # process-wide tracker attached: close() is unreachable
            self._release_tracker()
            raise
        if autostart:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._loop, name="gmtpu-serve-dispatch", daemon=True)
        self._worker.start()

    def close(self, drain: bool = True,
              timeout_s: Optional[float] = None) -> None:
        """Stop the service. drain=True (graceful): admissions stop with
        QueryRejected(shutting_down) while every already-admitted request
        still executes; drain=False: queued requests are rejected."""
        with self._state_lock:
            self._closed = True
        if not drain:
            for r in self.queue.drain_all():
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(
                        QueryRejected("shutting_down", "service closed"))
        deadline = time.monotonic() + (
            timeout_s if timeout_s is not None
            else self.config.drain_timeout_s)
        while time.monotonic() < deadline:
            with self._state_lock:
                idle = self._inflight == 0
            if idle and len(self.queue) == 0:
                break
            time.sleep(0.005)
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        if self.pipeline is not None:
            # windows already launched still sync (no torn responses);
            # runs after the dispatch thread stopped submitting
            self.pipeline.close()
        with self._state_lock:
            mux = self._push_mux
        if mux is not None:
            mux.close()  # joins the per-sink writer threads
        self._release_tracker()

    # -- warmup / compile management ---------------------------------------

    def _ensure_tracker(self):
        """Attach the process-wide compile tracker to this service
        (refcounted: services share one, detached with the last)."""
        if self.tracker is None:
            from geomesa_tpu_torch.compilecache.tracker import acquire_tracker

            self.tracker = acquire_tracker(recorder=self._recorder)
        return self.tracker

    def _release_tracker(self) -> None:
        if self.tracker is not None and self.tracker.is_installed():
            from geomesa_tpu_torch.compilecache.tracker import release_tracker

            release_tracker(self.tracker)

    def record_warmup(self):
        """Start recording a warm-up manifest from live traffic: every
        kernel library this process has loaded (with its entry points),
        every library built and ring class captured from now on, and every
        dispatched query shape land in the returned WarmupRecorder. Call
        `.manifest().save(path)` on it when the workload is
        representative."""
        from geomesa_tpu_torch.compilecache.manifest import WarmupRecorder
        from geomesa_tpu_torch.engine.kernels import build

        self._recorder = WarmupRecorder()
        for name in build.loaded():
            secs = build.build_log.get(name, {}).get("seconds", 0.0)
            for entry in build.entry_points(name):
                self._recorder.record_library(name, entry, secs)
        tracker = self._ensure_tracker()
        tracker.recorder = self._recorder
        return self._recorder

    def warmup(self, manifest, check: bool = False):
        """Replay a warm-up manifest (a path, or a WarmupManifest): build
        every kernel library it names and run its query entries through
        the planner, which arms this service's ring window classes and so
        captures their graphs before traffic. With `check=True` a second
        pass must build and capture NOTHING (`report.residual_recompiles
        == 0`). Returns the WarmupReport."""
        from geomesa_tpu_torch.compilecache import warmup as _warmup
        from geomesa_tpu_torch.compilecache.manifest import WarmupManifest

        if isinstance(manifest, str):
            manifest = WarmupManifest.load(manifest)
        self._ensure_tracker()
        ring = self.pipeline.ring if self.pipeline is not None else None
        t0 = time.monotonic()
        run = _warmup.check if check else _warmup.replay
        report = run(manifest, store=self.store,
                     ring_depth=ring.depth if ring is not None else None)
        metrics.gauge("serve.warmup.seconds", time.monotonic() - t0)
        metrics.gauge("serve.warmup.ok", 1.0 if report.ok else 0.0)
        self._bump("warmups")
        return report

    # -- submission API ----------------------------------------------------

    def submit(self, req: ServeRequest) -> Future:
        """Admission control, then enqueue. Raises the typed
        QueryRejected (never queues unboundedly) on shed/limit/closed.
        With tracing on, opens the request's Trace (root span "query")
        and the "admit" child span; a rejected request finishes its
        trace here and still lands in the flight recorder."""
        trace = TRACER.start_trace(
            "query", kind=req.kind, type=req.query.type_name,
            tenant=req.tenant)
        if trace is None:
            try:
                self._admit(req)
                hit, value = self._cache_peek(req)
                if hit:
                    return self._resolve_cached(req, value)
                value = self._approx_peek(req)
                if value is not None:
                    return self._resolve_approx(req, value)
                return self._enqueue(req)
            except QueryRejected:
                self._observe_slo(req, "rejected", 0.0)
                raise
        req.trace = trace
        try:
            # the admit span must CLOSE before the request becomes
            # visible to the dispatcher (queue.put)
            with TRACER.scope(trace):
                with TRACER.span("admit"):
                    self._admit(req)
            hit, value = self._cache_peek(req)
            if hit:
                return self._resolve_cached(req, value)
            with TRACER.scope(trace):
                value = self._approx_peek(req)
            if value is not None:
                return self._resolve_approx(req, value)
            return self._enqueue(req)
        except BaseException as e:
            if isinstance(e, QueryRejected):
                self._observe_slo(req, "rejected", 0.0)
            trace.finish(status="rejected", error=type(e).__name__)
            RECORDER.record(trace)
            raise

    def _admit(self, req: ServeRequest) -> None:
        """Admission checks up to — but excluding — the queue put."""
        self._bump("submitted")
        with self._state_lock:
            closed = self._closed
        if closed:
            self._bump("rejected")
            raise QueryRejected("shutting_down", "service closed")
        if self.config.quarantine_after and not self.quarantine.empty():
            detail = self.quarantine.blocked(_quarantine_key(req))
            if detail is not None:
                self._bump("rejected")
                self._bump("quarantined")
                raise QueryRejected("quarantined", detail)
        try:
            self.limiter.admit(req.tenant)
        except QueryRejected:
            self._bump("rejected")
            raise
        if req.deadline is None and self.config.default_timeout_ms:
            req.deadline = (time.monotonic()
                            + self.config.default_timeout_ms / 1000.0)
        level = self.degrade_level()
        if level >= 2 and req.priority >= PRIORITIES.index("batch"):
            self._bump("rejected")
            self._bump("shed")
            raise QueryRejected(
                "shed", "sustained overload: batch class shed")
        if level >= 1 and self.config.degrade and req.allow_degraded:
            self._degrade(req, level)
        # approximation off, or a spent SLO exactness budget, strips the
        # tolerance hint: the request pays the exact path, never a silent
        # approximation. The two count apart: "budget_exact" means the
        # governor acted, so a disabled tier never reads as perpetual
        # budget exhaustion
        if req.query.hints.tolerance is not None and not self._approx_ok():
            req.query = dataclasses.replace(
                req.query, hints=dataclasses.replace(
                    req.query.hints, tolerance=None))
            if not self.config.approx:
                self._bump("approx_disabled")
            else:
                self._bump("approx_budget_exact")
                metrics.counter("approx.budget_exact")
        if req.kind in ("count", "execute") and self.result_cache is not None:
            # the batcher populates the cache with the version the
            # planner's plan actually pinned (exact-by-construction)
            req.cache = self.result_cache
        if self.mesh is not None:
            # shard-affinity admission: tag the request with the shards
            # owning its partitions (metadata only; the planner's mesh
            # dispatch recomputes the authoritative value)
            from geomesa_tpu_torch.serve.scheduler import shard_affinity

            try:
                source = self.store.get_feature_source(req.query.type_name)
            except Exception:  # noqa: BLE001 — dispatch raises it typed
                return
            shards = shard_affinity(source, req)
            if shards:
                req.shards = ",".join(map(str, shards))
                metrics.counter("serve.affinity.admitted", shards=req.shards)

    def _enqueue(self, req: ServeRequest) -> Future:
        try:
            self.queue.put(req)
        except QueryRejected:
            self._bump("rejected")
            raise
        metrics.gauge("serve.queue.depth", float(len(self.queue)))
        return req.future

    def query(self, type_name: str, cql: str = "INCLUDE",
              hints=None, **kw) -> Future:
        q = Query(type_name, cql, hints=hints) if hints is not None \
            else Query(type_name, cql)
        return self.submit(self._request("execute", q, **kw))

    def count(self, type_name: str, cql: str = "INCLUDE", **kw) -> Future:
        return self.submit(self._request("count", Query(type_name, cql), **kw))

    def knn(self, type_name: str, cql: str, qx, qy, k: int = 10,
            impl: str = "sparse", **kw) -> Future:
        req = self._request("knn", Query(type_name, cql), **kw)
        req.qx, req.qy, req.k, req.impl = qx, qy, k, impl
        return self.submit(req)

    def _request(self, kind: str, query: Query, tenant: str = "",
                 priority: "int | str" = "normal",
                 timeout_ms: Optional[int] = None,
                 allow_degraded: bool = False) -> ServeRequest:
        if isinstance(priority, str):
            priority = PRIORITIES.index(priority)
        deadline = (time.monotonic() + timeout_ms / 1000.0
                    if timeout_ms else None)
        return ServeRequest(kind=kind, query=query, tenant=tenant,
                            priority=priority, deadline=deadline,
                            allow_degraded=allow_degraded)

    # -- result cache ------------------------------------------------------

    def _approx_ok(self) -> bool:
        """Sketch serving allowed right now? The config switch AND the
        SLO exactness budget (a spent budget routes exact)."""
        if not self.config.approx:
            return False
        if self.slo is None:
            return True
        return not self.slo.exactness_spent()

    def _sketch_rung_ok(self, req: ServeRequest) -> bool:
        """Can the sketch tier plausibly answer this request? An
        ELIGIBLE filter takes the sketch rung (typed bound), an
        ineligible one keeps the loose-bbox/sampling rewrite. Memoized
        filter parse, no sketch builds, no I/O."""
        try:
            source = self.store.get_feature_source(req.query.type_name)
            eng = source.planner.approx_engine()
            if eng.store is None:
                return False
            return bool(eng._parse_filter(req.query)[0])
        except Exception:  # noqa: BLE001 — rung choice is best-effort
            return False

    def _approx_peek(self, req: ServeRequest):
        """Admission-time sketch resolution: a tolerant COUNT answers on
        the submit thread from already-built sketches. Returns the
        ApproxCount or None (every miss pays the queued path, where the
        planner retries the sketch tier and builds what is cold)."""
        if req.kind != "count" or req.query.hints.tolerance is None:
            return None
        try:
            source = self.store.get_feature_source(req.query.type_name)
            qr = source.planner.approx_count_result(req.query)
        except Exception:  # noqa: BLE001 — the queued path raises typed
            return None
        if qr is None:
            return None
        from geomesa_tpu_torch.approx.engine import ApproxCount

        return ApproxCount(int(qr.count), int(qr.bound), qr.confidence)

    def _resolve_approx(self, req: ServeRequest, value) -> Future:
        """Resolve a sketch-served request at admission: full tier
        bookkeeping (metrics, trace, audit), no queue, no dispatch."""
        req.approx = True
        if req.sketch_rung:
            # the ladder's speculative rung actually served: now the
            # request is a degraded answer (typed bound)
            req.degraded = True
            self._bump("degraded")
            metrics.counter("serve.degraded")
        self._bump("approx_served")
        self._bump("completed")
        metrics.counter("serve.requests", kind=req.kind, status="ok")
        metrics.counter("serve.tier", tier="sketch")
        metrics.histogram("serve.latency").update(0.0)
        self._observe_slo(req, "ok", 0.0)
        if req.future.set_running_or_notify_cancel():
            req.future.set_result(value)
        if req.trace is not None:
            RECORDER.record(req.trace.finish(status="ok", approx=True))
        if self.audit is not None:
            self.audit.write(ServeEvent(
                trace_id=(req.trace.trace_id
                          if req.trace is not None else ""),
                type_name=req.query.type_name,
                kind=req.kind,
                tenant=req.tenant,
                priority=PRIORITIES[req.priority],
                queue_ms=0.0,
                exec_ms=0.0,
                batch_size=1,
                status="ok",
                degraded=req.degraded,
                approx=True,
            ))
        return req.future

    def _cache_key(self, req: ServeRequest):
        """The request's result-cache key at the CURRENT committed
        manifest version, or None when uncacheable (knn, unversioned
        storage). Recomputed fresh at every peek — a key minted before a
        concurrent write must never serve the old version's entry after
        the write committed."""
        if self.result_cache is None or req.kind == "knn":
            return None
        try:
            source = self.store.get_feature_source(req.query.type_name)
        except Exception:
            return None  # the dispatch path raises the typed error
        storage = getattr(source, "storage", None)
        mv = getattr(storage, "manifest_version", None)
        if not callable(mv):
            return None
        return result_key(req.kind, req.query, mv())

    def _cache_peek(self, req: ServeRequest, count_miss: bool = True):
        """(hit, value) against the version-exact result cache."""
        if self.result_cache is None or req.kind == "knn":
            return False, None
        return self.result_cache.get(self._cache_key(req),
                                     count_miss=count_miss)

    def _resolve_cached(self, req: ServeRequest, value,
                        queue_ms: float = 0.0) -> Future:
        """Resolve a request straight from the result cache: no queue,
        no coalescing window, no dispatch — full bookkeeping (metrics,
        trace, audit) still applies so tier shares stay honest."""
        req.cache_hit = True
        self._bump("cache_hits")
        self._bump("completed")
        metrics.counter("serve.requests", kind=req.kind, status="ok")
        metrics.counter("serve.tier", tier="cached")
        latency_s = queue_ms / 1000.0
        metrics.histogram("serve.latency").update(latency_s)
        self._observe_slo(req, "ok", latency_s)
        if req.future.set_running_or_notify_cancel():
            req.future.set_result(value)
        if req.trace is not None:
            RECORDER.record(req.trace.finish(status="ok", cache_hit=True))
        if self.audit is not None:
            self.audit.write(ServeEvent(
                trace_id=(req.trace.trace_id
                          if req.trace is not None else ""),
                type_name=req.query.type_name,
                kind=req.kind,
                tenant=req.tenant,
                priority=PRIORITIES[req.priority],
                queue_ms=queue_ms,
                exec_ms=0.0,
                batch_size=1,
                status="ok",
                degraded=req.degraded,
                cache_hit=True,
            ))
        return req.future

    # -- degradation ladder ------------------------------------------------

    def degrade_level(self) -> int:
        """0 = nominal; 1 = hint downgrades; 2 = + shed batch class, from
        queue occupancy (so the ladder releases the moment the backlog
        drains) and, with an SLO engine, its burn-rate boost: a
        degrade-marked objective breaching the multi-window burn threshold
        engages the ladder even with an empty queue, and releases as the
        breach ages out of the fast window."""
        if not self.config.degrade:
            return 0
        occ = len(self.queue) / self.config.max_queue
        level = 0
        if occ >= self.config.shed_watermark:
            level = 2
        elif occ >= self.config.degrade_watermark:
            level = 1
        if self.slo is not None and level < 2:
            level = max(level, self.slo.degrade_boost())
        return level

    def _degrade(self, req: ServeRequest, level: int) -> None:
        """Rewrite hints toward cheaper execution: loose bbox, then 1-in-4
        sampling. Aggregations a rewrite would corrupt (stats, density)
        never degrade."""
        h = req.query.hints
        if h.is_stats or h.is_bin or h.is_arrow:
            return
        sketchable = (req.kind == "count"
                      or (req.kind == "execute" and h.is_density
                          and h.density_weight is None))
        if (sketchable and h.tolerance is None and self._approx_ok()
                and self._sketch_rung_ok(req)):
            # the rung is SPECULATIVE: it injects the tolerance hint and
            # records the level; degraded accounting happens only where
            # a sketch answer is served
            if self.config.quarantine_after and req.quarantine_key is None:
                req.quarantine_key = _quarantine_key(req)
            req.query = dataclasses.replace(
                req.query, hints=dataclasses.replace(
                    h, tolerance=self.config.approx_degrade_tolerance))
            req.sketch_rung = level
            return
        if h.is_density:
            return  # loose-bbox/sampling would corrupt the grid
        # stash the PRE-degrade fingerprint: strikes must land on the
        # same key admission checks (see ServeRequest.quarantine_key)
        if self.config.quarantine_after and req.quarantine_key is None:
            req.quarantine_key = _quarantine_key(req)
        changes = {"loose_bbox": True}
        if level >= 2 and h.sampling is None:
            changes["sampling"] = 4
        req.query = dataclasses.replace(
            req.query, hints=dataclasses.replace(h, **changes))
        req.degraded = True
        self._bump("degraded")
        metrics.counter("serve.degraded")

    def _observe_slo(self, req: ServeRequest, status: str,
                     latency_s: float) -> None:
        """Feed one resolved request into the SLO engine's sliding windows
        (a no-op without a spec). A sketch-served answer spends the
        exactness budget like a ladder-degraded one: approximation is
        budgeted, and the closed loop (exactness_spent -> tolerance
        stripped) keeps it from becoming silent degradation."""
        if self.slo is not None:
            self.slo.observe(req.kind, status, latency_s,
                             degraded=req.degraded or req.approx)

    # -- dispatch loop -----------------------------------------------------

    def _mark_inflight(self, _req: ServeRequest) -> None:
        # runs under the queue lock (pop's on_pop hook): removal and the
        # in-flight mark are one atomic step, so close(drain=True) can
        # never observe "queue empty, nothing in flight" while a popped
        # request is still on its way into _dispatch
        with self._state_lock:
            self._inflight += 1

    def _loop(self) -> None:
        while True:
            req = self.queue.pop(timeout=0.05, on_pop=self._mark_inflight)
            if req is None:
                if self._stop.is_set():
                    return
                continue
            try:
                self._dispatch(req)
            except Exception as e:  # noqa: BLE001 — the dispatcher must live
                # _dispatch resolves member futures before anything that
                # can throw here (audit/metrics); log, dump the flight
                # recorder's window, and keep serving
                logging.getLogger(__name__).exception(
                    "serve dispatch loop error")
                RECORDER.crash_dump("serve dispatch loop error", e)
            finally:
                with self._state_lock:
                    self._inflight -= 1

    def _gather(self, first: ServeRequest) -> List[ServeRequest]:
        """Coalescing window: collect queued requests compatible with
        `first` for up to max_wait_ms (bounded added latency), then go."""
        reqs = [first]
        key = compat_key(first)
        cap = self.config.max_batch
        if key is None or cap <= 1:
            return reqs
        deadline = time.monotonic() + self.config.max_wait_ms / 1000.0
        while len(reqs) < cap:
            got = self.queue.drain_compatible(
                key, compat_key, cap - len(reqs))
            reqs.extend(got)
            if len(reqs) >= cap:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            time.sleep(min(0.0005, remaining))
        return reqs

    def _run_window(self, live: List[ServeRequest]) -> None:
        """The device-facing part of one dispatch: source lookup +
        coalesced execution, futures resolved for every member."""
        try:
            # an unknown type name raises HERE, not in execute_batch's
            # guarded body — it must fail these futures, not the
            # dispatcher thread (one bad request would hang the service)
            source = self.store.get_feature_source(live[0].query.type_name)
        except BaseException as e:  # noqa: BLE001 — fan out like a dispatch
            for r in live:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(e)
        else:
            execute_batch(source, live)

    def _dispatch(self, first: ServeRequest) -> None:
        """One window: gather (and, for a pipelined kNN window, the count
        riders it can answer), fail the expired members typed, answer
        from the result cache when a twin filled it, else hand the window
        to the pipeline or run it serially and finish its bookkeeping."""
        g0_ns = time.perf_counter_ns()
        reqs = self._gather(first)
        g1_ns = time.perf_counter_ns()
        live, dead = split_expired(reqs)
        lead = live[0] if live else None
        pipelined = (self.pipeline is not None and lead is not None
                     and lead.kind == "knn")
        counts: List[ServeRequest] = []
        if pipelined:
            # cross-kind fusion: COUNT requests against the same (type,
            # CQL, hints) resolve from this window's mask reduction
            fkey = fused_count_key(lead)
            if fkey is not None:
                # only counts can match: skip the canonical CQL of every
                # other queued request (the drain scans the whole queue)
                got = self.queue.drain_compatible(
                    fkey, _count_compat_key, self.config.max_batch)
                counts, cdead = split_expired(got)
                dead = dead + cdead
        fail_expired(dead)
        for r in dead:
            self._bump("timeout")
            metrics.counter("serve.timeout")
            self._observe_slo(r, "timeout", time.monotonic() - r.enqueued_at)
            if r.trace is not None:
                r.trace.record("queue.wait", r.enqueued_ns, g1_ns)
                RECORDER.record(r.trace.finish(status="timeout"))
        if not live:
            return
        if lead.kind in ("count", "execute") and self.result_cache is not None:
            # second-chance peek: a twin that dispatched while this
            # request queued may have populated the cache — resolve the
            # whole window without any device work. Misses are unmetered
            # here (admission already counted them).
            hit, value = self._cache_peek(lead, count_miss=False)
            if hit:
                t_hit = time.monotonic()
                for r in live:
                    self._resolve_cached(
                        r, value,
                        queue_ms=(t_hit - r.enqueued_at) * 1000.0)
                return
        t0 = time.monotonic()
        now_ns = time.perf_counter_ns()
        for r in live + counts:
            metrics.histogram("serve.queue.wait").update(t0 - r.enqueued_at)
            if r.trace is not None:
                r.trace.record("queue.wait", r.enqueued_ns, now_ns)
        # everything recorded into the LEAD trace from here on is the
        # shared dispatch window; riders adopt a copy at completion
        adopt_from = (lead.trace.span_count()
                      if lead.trace is not None else 0)
        if lead.trace is not None:
            lead.trace.record("coalesce", g0_ns, g1_ns,
                              gathered=len(reqs), fused=len(counts))
        if self._recorder is not None:
            self._record_queries(live, counts)
        if pipelined:
            self._dispatch_pipelined(live, counts, lead, t0, g0_ns,
                                     adopt_from)
            return
        stall_token = STALLS.token()
        rec_token = RECOVERY.token()
        if lead.trace is not None:
            with TRACER.scope(lead.trace):
                with TRACER.span("dispatch", batch=len(live)):
                    self._run_window(live)
        else:
            self._run_window(live)
        t1 = time.monotonic()
        # compile-stall and recovery attribution: what THIS thread noted
        # during the window (a first-use build, a retried transfer or read
        # runs on the dispatch thread) is charged to the requests that
        # rode it
        ident = threading.get_ident()
        stalls = STALLS.since(stall_token, thread_ident=ident)
        recovery = RECOVERY.since(rec_token, thread_ident=ident)
        self._finish_window(live, [], lead, t0, t1, adopt_from, stalls,
                            recovery)

    def _dispatch_pipelined(self, live, counts, lead, t0, g0_ns,
                            adopt_from) -> None:
        """Hand a kNN window to the pipeline. It stays in flight past this
        method: it owns one inflight token until _window_complete releases
        it, so close(drain=True) waits for the completer too."""
        try:
            # the source lookup error fans out HERE (the serial path does
            # it inside _run_window)
            source = self.store.get_feature_source(lead.query.type_name)
        except BaseException as e:  # noqa: BLE001 — fan out typed
            for r in live + counts:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(e)
            self._finish_window(live, counts, lead, t0, time.monotonic(),
                                adopt_from, [], [], pipelined=True)
            return
        with self._state_lock:
            self._inflight += 1
        try:
            self.pipeline.submit(source, live, counts, lead, t0, g0_ns,
                                 adopt_from)
        except BaseException as e:
            # submit resolves all futures on its internal failure paths;
            # an exception HERE means the window never got a slot
            # (completer dead): fail whatever is still pending, then let
            # _loop log it
            with self._state_lock:
                self._inflight -= 1
            for r in live + counts:
                if not r.future.done() and \
                        r.future.set_running_or_notify_cancel():
                    r.future.set_exception(e)
            raise

    def _window_complete(self, win, t1: float, end_ns: int) -> None:
        """Pipeline completion callback (completer thread): the shared
        finish bookkeeping, then release the window's inflight token."""
        try:
            self._finish_window(win.live, win.counts, win.lead, win.t0, t1,
                                win.adopt_from, win.stalls, win.recovery,
                                pipelined=True)
        finally:
            with self._state_lock:
                self._inflight -= 1

    def _finish_window(self, live, counts, lead, t0, t1, adopt_from,
                       stalls, recovery, pipelined: bool = False) -> None:
        """Everything that happens after a window's futures are resolved:
        stall and recovery attribution, counters, metrics, quarantine
        accounting, rider trace adoption, audit events. Shared by the
        serial path (dispatch thread) and the pipeline (completer thread).
        Every request of the window carries the window's `retries` and
        `fault_injected` (the recovery events its threads noted) and the
        non-closed breakers at completion (`breaker_state`)."""
        retries = sum(1 for kind, _ in recovery if kind == "retry")
        faults_seen = sum(1 for kind, _ in recovery if kind == "fault")
        breaker_state = ",".join(
            f"{name}={state}"
            for name, state in sorted(BREAKERS.states().items())
            if state != "closed")
        if lead.trace is not None:
            # retry/fault notes render as instants at the window's end
            end_ns = time.perf_counter_ns()
            for kind, label in recovery:
                lead.trace.record(kind, end_ns, end_ns, label=label)
        compile_ms = sum(s for _, s in stalls) * 1000.0
        labels = list(dict.fromkeys(lbl for lbl, _ in stalls))
        compiled = ",".join(labels[:5])
        if len(labels) > 5:
            compiled += f",+{len(labels) - 5}"
        if stalls:
            self._bump("compile_stalled_dispatches")
            metrics.counter("serve.compile.stalled")
        self._bump("dispatches")
        members = len(live) + len(counts)
        self._bump("coalesced", members - 1)
        metrics.counter("serve.dispatch")
        if pipelined:
            self._bump("pipelined_windows")
            metrics.counter("serve.pipeline.windows")
        if members > 1:
            metrics.counter("serve.coalesced", members - 1)
        metrics.gauge("serve.queue.depth", float(len(self.queue)))
        struck: set = set()
        adopted: Optional[list] = None
        for r in live + counts:
            if r.future.cancelled():
                # cancelled between queue pop and execute: .exception()
                # would raise CancelledError and kill the dispatcher
                if r.trace is not None:
                    RECORDER.record(r.trace.finish(status="cancelled"))
                continue
            metrics.histogram("serve.latency").update(t1 - r.enqueued_at)
            status = "ok"
            exc = r.future.exception()
            if exc is not None:
                status = ("timeout" if isinstance(exc, QueryTimeout)
                          else "error")
                self._bump("failed")
                # poison-query accounting: a crash (permanent/OOM after
                # every recovery layer gave up) strikes the request's
                # fingerprint ONCE per dispatch; shed/timeout/transient,
                # breaker-open and OSError answers say nothing about the
                # QUERY being poisonous
                if (self.config.quarantine_after
                        and not isinstance(exc, (QueryRejected,
                                                 QueryTimeout,
                                                 BreakerOpen,
                                                 OSError))
                        and classify(exc) != "transient"):
                    key = (r.quarantine_key
                           if r.quarantine_key is not None
                           else _quarantine_key(r))
                    if key not in struck:
                        struck.add(key)
                        self.quarantine.strike(key)
            else:
                self._bump("completed")
                if r.approx:
                    self._bump("approx_served")
                    if r.sketch_rung and not r.degraded:
                        # a rung request sketch-served on the dispatch
                        # path: degraded accounting lands with the serve
                        r.degraded = True
                        self._bump("degraded")
                        metrics.counter("serve.degraded")
                metrics.counter(
                    "serve.tier", tier="sketch" if r.approx else "exact")
            # rejection is not failure for the SLOs, even where the wire
            # status says error: a window failed by shutdown fans
            # QueryRejected out, and shedding must not burn the
            # availability budget it protects
            self._observe_slo(
                r, "rejected" if isinstance(exc, QueryRejected) else status,
                t1 - r.enqueued_at)
            metrics.counter("serve.requests", kind=r.kind, status=status)
            if r.tenant:
                metrics.counter("serve.tenant.requests", tenant=r.tenant)
                metrics.histogram(
                    "serve.tenant.latency",
                    tenant=r.tenant).update(t1 - r.enqueued_at)
            if r.trace is not None:
                if r is not lead and lead.trace is not None:
                    # riders adopt a copy of the shared dispatch-window
                    # spans; the lead's own respond span stays out
                    if adopted is None:
                        adopted = [
                            s for s in
                            lead.trace.snapshot_spans()[adopt_from:]
                            if s.name != "respond"]
                    r.trace.adopt(
                        adopted, clamp_start_ns=r.trace.root.start_ns)
                RECORDER.record(r.trace.finish(
                    status=status, batch=members, degraded=r.degraded,
                    approx=r.approx))
            if self.audit is not None:
                self.audit.write(ServeEvent(
                    trace_id=(r.trace.trace_id
                              if r.trace is not None else ""),
                    type_name=r.query.type_name,
                    kind=r.kind,
                    tenant=r.tenant,
                    priority=PRIORITIES[r.priority],
                    queue_ms=(t0 - r.enqueued_at) * 1000.0,
                    exec_ms=(t1 - t0) * 1000.0,
                    batch_size=members,
                    pipelined=pipelined,
                    status=status,
                    degraded=r.degraded,
                    compile_ms=compile_ms,
                    compiled=compiled,
                    retries=retries,
                    fault_injected=faults_seen,
                    breaker_state=breaker_state,
                    mesh_shape=r.mesh_shape or lead.mesh_shape,
                    shards=r.shards or lead.shards,
                    approx=r.approx,
                    cache_hit=r.cache_hit,
                ))

    def _record_queries(self, live: List[ServeRequest],
                        counts: List[ServeRequest] = ()) -> None:
        """Record this dispatch's query shape into the warm-up recorder:
        one entry per dispatch (members share a compat key); the kNN
        bucket is the PADDED stacked-query axis the batcher builds, the
        shape a ring class is captured for. Fused count riders record
        their own count entry. Only default-hint queries are recorded:
        the replay runs with default hints."""
        from geomesa_tpu_torch.cql import ast
        from geomesa_tpu_torch.plan.hints import QueryHints

        lead = live[0]
        try:
            cql = ast.to_cql(lead.query.filter_ast)
        except Exception:  # noqa: BLE001 — an unkeyable filter records nothing
            return
        if lead.query.hints != QueryHints():
            return
        if lead.kind == "knn":
            total = sum(len(np.asarray(r.qx).ravel()) for r in live)
            padded = max(MIN_KNN_BATCH, _next_pow2(max(total, 1)))
            self._recorder.record_query(
                "knn", lead.query.type_name, cql,
                q=padded, k=lead.k, impl=lead.impl)
        else:
            self._recorder.record_query(lead.kind, lead.query.type_name, cql)
        if counts:
            self._recorder.record_query("count", lead.query.type_name, cql)

    # -- introspection -----------------------------------------------------

    def _bump(self, name: str, n: int = 1) -> None:
        with self._state_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def stats(self) -> Dict[str, int]:
        with self._state_lock:
            out = dict(self._counters)
        out.setdefault("dispatches", 0)
        out.setdefault("coalesced", 0)
        out["queue_depth"] = len(self.queue)
        out["degrade_level"] = self.degrade_level()
        out["quarantine"] = self.quarantine.stats()
        # serving-tier shares: sketch / cached / exact out of everything
        # completed
        sketch = out.get("approx_served", 0)
        cached = out.get("cache_hits", 0)
        completed = out.get("completed", 0)
        out["approx"] = {
            "enabled": self.config.approx,
            "allowed_now": self._approx_ok(),
            "budget_exact": out.get("approx_budget_exact", 0),
            "tiers": {"sketch": sketch, "cached": cached,
                      "exact": max(completed - sketch - cached, 0)},
        }
        if self.result_cache is not None:
            out["cache"] = self.result_cache.stats()
        if self.metrics_port is not None:
            out["metrics_port"] = self.metrics_port
        if self.pipeline is not None:
            out["pipeline"] = self.pipeline.stats()
        if self.mesh is not None:
            out["mesh"] = {"shape": [self.mesh.size], "devices": self.mesh.size}
        if self.tracker is not None:
            out["recompiles"] = self.tracker.total_recompiles()
        subs = self.subscriptions  # racing close() may null the attr
        if subs is not None:
            out["subscriptions"] = subs.stats()
        with self._state_lock:
            mux = self._push_mux
        if mux is not None:
            out["wire"] = mux.stats()
        if self.slo is not None:
            out["slo"] = self.slo.report()
        return out

    def wire_mux(self):
        """The service-wide push fan-out (serve/columnar.py PushMux):
        one per service, built on the first push or attach — frames
        encode once and fan to every connection sink attached to their
        subscription."""
        with self._state_lock:
            if self._push_mux is None:
                from geomesa_tpu_torch.serve.columnar import PushMux

                self._push_mux = PushMux(
                    queue_limit=self.config.subscribe_outbox)
            return self._push_mux

    def export_gauges(self) -> None:
        """Push point-in-time gauges (queue depth, degrade level,
        in-flight count, quarantine size) into the shared metrics
        registry, so a scrape sees NOW, not the last time a request
        happened to update a gauge, with a `fault.breaker.<name>` gauge
        per breaker (0 closed, 1 half-open, 2 open)."""
        metrics.gauge("serve.queue.depth", float(len(self.queue)))
        for cls, depth in self.queue.depths().items():
            metrics.gauge("serve.queue.class_depth", float(depth),
                          priority=cls)
        metrics.gauge("serve.degrade.level", float(self.degrade_level()))
        with self._state_lock:
            inflight = self._inflight
        metrics.gauge("serve.inflight", float(inflight))
        if self.slo is not None:
            self.slo.export_gauges()
        if self.pipeline is not None:
            p = self.pipeline.stats()
            metrics.gauge("serve.pipeline.inflight", float(p["inflight"]))
            metrics.gauge("serve.pipeline.max_inflight",
                          float(p["max_inflight"]))
            ring = p.get("ring")
            if ring is not None:
                metrics.gauge("serve.ring.programs", float(ring["programs"]))
        if self.result_cache is not None:
            c = self.result_cache.stats()
            metrics.gauge("serve.cache.entries", float(c["entries"]))
        metrics.gauge("serve.approx.allowed",
                      1.0 if self._approx_ok() else 0.0)
        q = self.quarantine.stats()
        metrics.gauge("fault.quarantine.active", float(q["quarantined"]))
        metrics.gauge("fault.quarantine.striking", float(q["striking"]))
        try:
            for name, state in BREAKERS.states().items():
                metrics.gauge(f"fault.breaker.{name}", _STATE_NUM[state])
        except Exception:  # noqa: BLE001 — gauge freshness is best-effort:
            # a scrape renders what IS fresh rather than fail because one
            # breaker-registry read raced a reconfigure
            pass


def self_check(verbose: bool = True, device=None) -> int:
    """An end-to-end smoke against a throwaway store on `device` (None =
    the card; pass "cpu" without one): coalescing happens (fewer
    dispatches than requests), coalesced kNN results match serial
    execution, the bounded queue sheds with a typed QueryRejected, and
    latency histograms export. Returns 0 on pass, 1 on failure; runs in
    a few seconds on the CPU."""
    import tempfile

    from geomesa_tpu_torch.core.columnar import FeatureBatch
    from geomesa_tpu_torch.core.sft import SimpleFeatureType
    from geomesa_tpu_torch.plan.datastore import DataStore

    def say(msg):
        if verbose:
            print(f"serve self-check: {msg}")

    rng = np.random.default_rng(7)
    n = 512
    sft = SimpleFeatureType.from_spec(
        "selfcheck", "name:String,score:Double,dtg:Date,*geom:Point")
    batch = FeatureBatch.from_pydict(sft, {
        "name": rng.choice(["a", "b", "c"], n).tolist(),
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
        "geom": np.stack(
            [rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)], 1),
    })
    cql = "BBOX(geom, -180, -90, 180, 90)"
    failures = 0
    with tempfile.TemporaryDirectory() as tmp:
        store = DataStore(tmp, use_device_cache=True, device=device)
        src = store.create_schema(sft)
        src.write(batch)

        qpts = rng.uniform(-60, 60, (8, 2))
        serial = [src.knn(cql, qpts[i:i + 1, 0], qpts[i:i + 1, 1], k=5)
                  for i in range(8)]

        svc = QueryService(store, ServeConfig(max_wait_ms=20.0),
                           autostart=False)
        try:
            futs = [svc.knn("selfcheck", cql, qpts[i:i + 1, 0],
                            qpts[i:i + 1, 1], k=5) for i in range(8)]
            cfuts = [svc.count("selfcheck", cql) for _ in range(3)]
            svc.start()
            results = [f.result(timeout=60) for f in futs]
            counts = [f.result(timeout=60) for f in cfuts]
        finally:
            svc.close(drain=True)
        st = svc.stats()
        say(f"dispatches={st['dispatches']} for 11 requests "
            f"(coalesced {st['coalesced']})")
        if st["dispatches"] >= 11:
            say("FAIL: no coalescing happened")
            failures += 1
        for i, ((d, ix, _), (sd, six, _)) in enumerate(zip(results, serial)):
            if not (np.allclose(d, sd) and np.array_equal(ix, six)):
                say(f"FAIL: coalesced kNN result {i} != serial")
                failures += 1
        if len(set(counts)) != 1 or counts[0] != n:
            say(f"FAIL: coalesced counts wrong: {counts}")
            failures += 1

        svc2 = QueryService(store, ServeConfig(max_queue=2),
                            autostart=False)
        try:
            svc2.count("selfcheck", cql)
            svc2.count("selfcheck", "BBOX(geom, 0, 0, 10, 10)")
            try:
                svc2.count("selfcheck", "BBOX(geom, -10, -10, 0, 0)")
                say("FAIL: bounded queue did not shed")
                failures += 1
            except QueryRejected as e:
                say(f"bounded queue shed with reason={e.reason!r}")
                if e.reason != "queue_full":
                    failures += 1
            svc2.start()
        finally:
            svc2.close(drain=True)

        prom = metrics.to_prometheus()
        for needle in ("serve_latency_seconds_bucket",
                       "serve_latency_seconds_p99"):
            if needle not in prom:
                say(f"FAIL: {needle} missing from Prometheus export")
                failures += 1
    say("FAIL" if failures else "OK")
    return 1 if failures else 0
