"""`gmtpu serve` wire protocol: JSON-lines request/response.

The port of the reference package's `serve/protocol.py`. One JSON object
per input line; one JSON response line per request, written IN
COMPLETION ORDER (a coalesced batch completes together; a shed request
answers immediately) — the id field is the correlation key:

    {"id": "r1", "op": "count", "typeName": "gdelt",
     "cql": "BBOX(geom,-10,-10,10,10)"}
    {"id": "r2", "op": "knn", "typeName": "gdelt", "cql": "INCLUDE",
     "x": [1.5], "y": [2.5], "k": 8}
    {"id": "r3", "op": "query", "typeName": "gdelt", "cql": "...",
     "maxFeatures": 100}
    {"id": "r4", "op": "query", "typeName": "gdelt", "cql": "...",
     "density": {"bbox": [-60, 20, 60, 70], "width": 512, "height": 512}}

Optional request fields: tenant, priority (interactive|normal|batch),
timeoutMs, allowDegraded. Responses: {"id", "ok": true, ...} with
op-specific payload, or {"id", "ok": false, "error":
rejected|unavailable|timeout|error, "reason", "message"}: "unavailable"
answers an open circuit breaker (a dependency outage, not the query)
with `retryAfterS`, the seconds until the breaker lets a probe through.
`{"op": "stats"}` answers the service's live counters, `{"op": "hello"}`
the connection's role and the wire it speaks, and `{"op": "drain"}` (on
an admin connection) drains the service in place.

Approximate answers: `"tolerance"` (the client's accuracy contract),
`"topkCells"` (the densest world-grid cells) and `"distinct"` (count the
distinct values of one attribute) become query hints; a sketch-served
answer carries `approx`, `bound`, `confidence` and the pre-computed
`lo`/`hi` of the exact value.

Columnar wire (`serve/columnar.py`): the hello advertises `["json",
"columnar"]`; a request (or the connection, via `{"op": "hello", "wire":
"columnar"}`) opts into binary framing for bulk payloads: feature
results as Arrow IPC, density and topk grids as raw f64 buffers, kNN
query points (`x`/`y` sections) and `op=ingest` Arrow IPC frames inbound
(`DataStore.write_batch`). A frame is a JSON header line whose `frame`
announces `nbytes` of raw payload after it. A connection without a binary
sink (`write_bytes`) is answered in JSON with a typed `"wireFallback"`.

Standing queries (`geomesa_tpu_torch.subscribe`) ride the same stream
against a live (Kafka) store:

    {"id": "s1", "op": "subscribe", "typeName": "vessels",
     "cql": "DWITHIN(geom, POINT(0 0), 50000, meters)", "ttlS": 600}
    {"id": "s2", "op": "subscribe", "typeName": "vessels",
     "density": {"bbox": [-180,-90,180,90], "width": 256, "height": 128}}
    {"id": "p1", "op": "poll"}
    {"id": "u1", "op": "unsubscribe", "subscription": "sub-1"}

The subscribe response carries the subscription id; from then on the
server interleaves PUSH FRAMES — JSON objects with an "event" field
instead of an "id" — into the response stream as Kafka batches fold in:
`enter`/`exit` (geofence transitions, fid lists), `density` and
`approx_density` (window totals), `state` (full re-sync), and the typed
`subscription_lagged` / `expired` / `quarantined` lifecycle frames.
`poll` folds pending Kafka messages and flushes outboxes (the
`subscribe_poll_ms` pump does it on a cadence otherwise); `pause`,
`resume`, `export_subscription` (the handoff snapshot) and
`subscriptions` (introspection) complete the verbs. `attach`/`detach`
mirror another connection's subscription onto this one, in JSON or
columnar framing: each push frame is encoded once per wire mode
(`columnar.PushMux`).

What a later slice brings answers typed instead of running another
route: {"ok": false, "error": "error", "reason": "not_ported",
"roadmap": item, "message"}.

Errors are per-request, never fatal to the stream: a malformed line
yields an ok=false response and the loop continues — one bad client
request must not drop everyone else's connection.
"""

from __future__ import annotations

import json
import math
import threading
import time
from time import perf_counter_ns
from typing import Iterable, Optional

import numpy as np

from geomesa_tpu_torch.errors import NotPortedError
from geomesa_tpu_torch.faults import BreakerOpen
from geomesa_tpu_torch.plan.hints import QueryHints
from geomesa_tpu_torch.plan.planner import QueryTimeout
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.serve import columnar as colwire
from geomesa_tpu_torch.serve.scheduler import (
    PRIORITIES, QueryRejected, ServeRequest)
from geomesa_tpu_torch.serve.service import QueryService, ServeConfig

MAX_FEATURE_ROWS = 10_000  # response-size guard for op=query

SUBSCRIBE_OPS = ("subscribe", "unsubscribe", "poll", "subscriptions",
                 "export_subscription", "pause", "resume")
ADMIN_ROLES = ("router", "admin")


def _finite(v: float):
    return None if (isinstance(v, float) and not math.isfinite(v)) else v


def _rows_json(batch, limit: int):
    """Feature rows as JSON dicts (geometry as WKT), capped at `limit`."""
    from geomesa_tpu_torch.core.columnar import DictColumn, GeometryColumn
    from geomesa_tpu_torch.core.wkt import to_wkt

    if batch is None or len(batch) == 0:
        return []
    n = min(len(batch), limit)
    names = batch.sft.attribute_names
    cols = {}
    for name in names:
        col = batch.columns[name]
        if isinstance(col, GeometryColumn):
            cols[name] = col
        elif isinstance(col, DictColumn):
            cols[name] = col.decode()
        else:
            cols[name] = np.asarray(col)
    rows = []
    for i in range(n):
        row = {}
        for name in names:
            col = batch.columns[name]
            m = cols[name]
            if isinstance(col, GeometryColumn):
                row[name] = (f"POINT ({m.x[i]} {m.y[i]})" if m.is_point
                             else to_wkt(m.geometry(i)))
            elif isinstance(col, DictColumn):
                row[name] = m[i]
            else:
                v = m[i].item()
                row[name] = _finite(v) if isinstance(v, float) else v
        rows.append(row)
    return rows


def _approx_fields(count: int, bound, confidence: float) -> dict:
    """The typed error bound of a sketch-served answer: the exact value
    lies in [lo, hi] = [count - bound, count + bound]."""
    return {"approx": True, "bound": bound, "confidence": float(confidence),
            "lo": max(0, count - int(bound)), "hi": count + int(bound)}


def _payload(kind: str, result, limit: int) -> dict:
    if kind == "count":
        doc = {"count": int(result)}
        if getattr(result, "approx", False):
            doc.update(_approx_fields(int(result), result.bound,
                                      result.confidence))
        return doc
    if kind == "knn":
        dists, idx, _batch = result
        return {
            "dists": [[_finite(float(d)) for d in row] for row in dists],
            "indices": [[int(j) for j in row] for row in idx],
        }
    out = {"kind": result.kind, "count": int(result.count)}
    if result.kind == "features":
        feats = result.features
        out["count"] = len(feats) if feats is not None else 0
        out["features"] = _rows_json(feats, limit)
    elif result.kind == "density" and result.grid is not None:
        out["shape"] = list(result.grid.shape)
        out["total"] = float(result.grid.sum())
    elif result.kind == "stats":
        out["stats"] = str(result.stats)
    elif result.kind == "topk_cells":
        out["cells"] = result.stats
    if getattr(result, "approx", False):
        out.update(_approx_fields(int(result.count), float(result.bound),
                                  result.confidence))
    return out


def _columnar_payload(kind: str, result, limit: int):
    """(response fields, frame payload) for a columnar-mode request, or
    (None, None) when this result kind has no columnar encoding
    (count/kNN/stats answers are already small and stay JSON, unmarked).
    The fields mirror `_payload` minus the bulk data in the frame."""
    if kind in ("count", "knn"):
        return None, None
    out = {"kind": result.kind, "count": int(result.count)}
    if result.kind == "features":
        feats = result.features
        out["count"] = len(feats) if feats is not None else 0
        desc, payload = colwire.encode_execute_frame(feats, limit)
    elif result.kind == "density" and result.grid is not None:
        out["shape"] = list(result.grid.shape)
        out["total"] = float(result.grid.sum())
        desc, payload = colwire.encode_density_frame(result.grid)
    elif result.kind == "topk_cells":
        desc, payload = colwire.encode_topk_frame(result.stats)
    else:
        return None, None
    out["frame"] = desc
    if getattr(result, "approx", False):
        out.update(_approx_fields(int(result.count), float(result.bound),
                                  result.confidence))
    return out, payload


def parse_request(doc: dict,
                  payload: Optional[bytes] = None) -> ServeRequest:
    op = doc.get("op", "query")
    kind = {"query": "execute", "execute": "execute",
            "count": "count", "knn": "knn"}.get(op)
    if kind is None:
        raise ValueError(f"unknown op {op!r}")
    type_name = doc["typeName"]
    kw = {}
    if (doc.get("tolerance") is not None or doc.get("topkCells")
            or doc.get("density") or doc.get("distinct")):
        # aggregation and approximate-answer hints; density is a one-shot
        # DensityScan window (the subscribe verb's spec shape)
        hkw = {}
        d = doc.get("density")
        if d:
            hkw.update(
                density_bbox=tuple(float(v) for v in d["bbox"]),
                density_width=int(d["width"]),
                density_height=int(d["height"]),
                density_weight=d.get("weight"))
        kw["hints"] = QueryHints(
            tolerance=(float(doc["tolerance"])
                       if doc.get("tolerance") is not None else None),
            topk_cells=(int(doc["topkCells"])
                        if doc.get("topkCells") else None),
            distinct=doc.get("distinct"),
            **hkw)
    query = Query(type_name, doc.get("cql", "INCLUDE"),
                  max_features=doc.get("maxFeatures"), **kw)
    priority = doc.get("priority", "normal")
    if isinstance(priority, str):
        priority = PRIORITIES.index(priority)
    req = ServeRequest(
        kind=kind, query=query, tenant=doc.get("tenant", ""),
        priority=priority,
        allow_degraded=bool(doc.get("allowDegraded", False)),
    )
    timeout_ms = doc.get("timeoutMs")
    if timeout_ms:
        req.deadline = time.monotonic() + float(timeout_ms) / 1000.0
    if kind == "knn":
        if payload is not None and doc.get("frame"):
            # columnar request staging: the x/y sections decode as f64
            # views straight into the batcher's stacking
            req.qx, req.qy = colwire.decode_knn_sections(
                doc["frame"], payload)
        else:
            req.qx = np.asarray(doc["x"], np.float64)
            req.qy = np.asarray(doc["y"], np.float64)
        if req.qx.shape != req.qy.shape or req.qx.ndim != 1:
            raise ValueError("knn x/y must be equal-length 1-d arrays")
        req.k = int(doc.get("k", 10))
        req.impl = doc.get("impl", "sparse")
    return req


def _error_response(rid, exc) -> dict:
    if isinstance(exc, QueryRejected):
        return {"id": rid, "ok": False, "error": "rejected",
                "reason": exc.reason, "message": str(exc)}
    if isinstance(exc, BreakerOpen):
        # fail-fast dependency outage: tell the client WHEN to retry
        return {"id": rid, "ok": False, "error": "unavailable",
                "reason": exc.reason,
                "retryAfterS": round(exc.retry_after_s, 3),
                "message": str(exc)}
    if isinstance(exc, QueryTimeout):
        return {"id": rid, "ok": False, "error": "timeout",
                "phase": exc.phase, "message": str(exc)}
    if isinstance(exc, NotPortedError):
        return {"id": rid, "ok": False, "error": "error",
                "reason": "not_ported", "roadmap": exc.later_slice,
                "message": str(exc)}
    return {"id": rid, "ok": False, "error": "error", "message": str(exc)}


def _parse_density(doc: dict):
    """The density window of a subscribe request, or None."""
    d = doc.get("density")
    if d is None:
        return None
    from geomesa_tpu_torch.subscribe import DensityWindow

    return DensityWindow(
        bbox=tuple(float(v) for v in d["bbox"]),
        width=int(d["width"]), height=int(d["height"]),
        weight_attr=d.get("weight"), decay=d.get("decay"),
        tolerance=(float(d["tolerance"])
                   if d.get("tolerance") is not None else None))


class _SubscribeSession:
    """Per-connection standing-query state: lazily creates the
    SubscriptionManager on the first subscribe verb (sharing the
    QueryService's tenant buckets and quarantine tuning), runs the
    auto-poll pump when configured, and flushes outboxes into the
    response stream.

    `push` is the PUSH-FRAME sink (events without an `id`): it routes
    through the service's PushMux so each frame is encoded once and
    fanned to this connection plus any attached mirrors — even the
    single-subscriber JSON path takes the one-encode buffer
    (docs/SERVING.md "Columnar wire"). `respond` stays the direct
    request/response writer."""

    def __init__(self, store, svc: QueryService, respond, push=None):
        self.store = store
        self.svc = svc
        self.respond = respond
        self.push = push if push is not None else respond
        self.manager = None
        self._stop = threading.Event()
        self._pump = None

    def _ensure(self):
        if self.manager is not None:
            return self.manager
        if not hasattr(self.store, "poll"):
            raise ValueError(
                "standing queries need a live (Kafka) store; this "
                "catalog is durable-only")
        from geomesa_tpu_torch.subscribe import (
            SubscribeConfig, SubscriptionManager)

        cfg = self.svc.config
        self.manager = SubscriptionManager(
            self.store,
            SubscribeConfig(
                max_subscriptions=cfg.subscribe_max,
                outbox_limit=cfg.subscribe_outbox,
                rate=cfg.subscribe_rate,
                quarantine_after=cfg.quarantine_after,
                quarantine_ttl_s=cfg.quarantine_ttl_s,
            ),
            limiter=self.svc.limiter)
        if self.svc.subscriptions is None:
            # stats surface: first manager wins; close() clears it —
            # a later connection must not shadow a live one, and a
            # closed one must not keep reporting a dead registry
            self.svc.subscriptions = self.manager
        if cfg.subscribe_poll_ms:
            self._pump = threading.Thread(
                target=self._pump_loop, name="gmtpu-subscribe-pump",
                daemon=True)
            self._pump.start()
        return self.manager

    def _pump_loop(self):
        interval = self.svc.config.subscribe_poll_ms / 1000.0
        while not self._stop.wait(interval):
            self.pump_once()

    def pump_once(self) -> int:
        """One poll + flush cycle. Typed broker errors surface as a
        `poll_error` frame — the stream stays alive, the client knows
        events are delayed, and the next cycle retries. The flush is
        guarded too: one raising write must not silently kill the pump
        thread and strand a live connection event-less."""
        if self.manager is None:
            return 0
        try:
            self.manager.poll_now()
        except Exception as e:  # noqa: BLE001 — typed surface, stream lives
            try:
                self.push({"event": "poll_error",
                           "error": type(e).__name__,
                           "message": str(e)})
            except Exception:
                return 0  # sink broken: frames stay queued, retry next tick
        try:
            return self.manager.flush(self.push)
        except Exception:  # noqa: BLE001 — pump thread must survive
            # a raising sink loses the frame in flight (the connection
            # is broken anyway); undrained frames stay in their bounded
            # outboxes and the next cycle retries instead of the pump
            # thread dying silently
            return 0

    def handle(self, rid, doc: dict) -> None:
        op = doc["op"]
        if self.manager is None and op != "subscribe":
            # only `subscribe` instantiates the manager (and its
            # auto-poll pump): a bare poll / introspection verb on a
            # subscription-less connection answers cheaply, and works
            # against durable-only catalogs too
            if op == "poll":
                self.respond({"id": rid, "ok": True, "applied": {},
                              "frames": 0})
            elif op == "subscriptions":
                self.respond({"id": rid, "ok": True, "subscriptions": 0})
            else:  # unsubscribe with nothing registered
                self.respond({"id": rid, "ok": False, "error": "error",
                              "message": "no such subscription"})
            return
        mgr = self._ensure()
        if op == "subscribe":
            # the manager runs `ack` under its flush lock, so the
            # response (which tells the client the subscription id) is
            # on the wire before any push frame referencing that id
            mgr.subscribe(
                doc["typeName"],
                cql=doc.get("cql", "INCLUDE"),
                density=_parse_density(doc),
                tenant=doc.get("tenant", ""),
                ttl_s=doc.get("ttlS"),
                rate=doc.get("rate"),
                outbox_limit=doc.get("outboxLimit"),
                initial_state=bool(doc.get("initialState", True)),
                handoff=doc.get("handoff"),
                paused=bool(doc.get("paused", False)),
                ack=lambda s: self.respond(
                    {"id": rid, "ok": True,
                     "subscription": s.sub_id, "mode": s.mode,
                     "status": s.status}))
            mgr.flush(self.push)  # deliver the initial state frame
        elif op == "unsubscribe":
            try:
                sub = mgr.unsubscribe(doc["subscription"])
            except KeyError:
                # same typed answer as the manager-less branch — an
                # unknown (or concurrently TTL-expired) id must not
                # leak a bare KeyError message
                self.respond({"id": rid, "ok": False, "error": "error",
                              "message": "no such subscription"})
                return
            mgr.flush(self.push)  # parting frames
            self.respond({"id": rid, "ok": True,
                          "subscription": sub.sub_id,
                          "status": sub.status})
        elif op in ("pause", "resume"):
            # lifecycle verbs for the fleet's re-home path (a paused
            # subscription must land paused on the survivor) and for
            # clients throttling their own streams
            try:
                sub = (mgr.pause if op == "pause"
                       else mgr.resume)(doc["subscription"])
            except KeyError:
                self.respond({"id": rid, "ok": False, "error": "error",
                              "message": "no such subscription"})
                return
            except ValueError as e:  # resume from non-paused, etc.
                self.respond({"id": rid, "ok": False, "error": "error",
                              "message": str(e)})
                return
            if op == "resume":
                mgr.flush(self.push)  # the resume's state resync frame
            self.respond({"id": rid, "ok": True,
                          "subscription": sub.sub_id,
                          "status": sub.status})
        elif op == "poll":
            applied = mgr.poll_now()
            frames = mgr.flush(self.push)
            self.respond({"id": rid, "ok": True, "applied": applied,
                          "frames": frames})
        elif op == "export_subscription":
            # failover handoff (docs/ROBUSTNESS.md): serialize one
            # predicate subscription's matched-set snapshot so the
            # client can re-subscribe against another replica with
            # `handoff` and continue its sequence numbers there
            sub = mgr.registry.maybe(doc.get("subscription"))
            if sub is None:
                self.respond({"id": rid, "ok": False, "error": "error",
                              "message": "no such subscription"})
                return
            try:
                snap = sub.handoff_snapshot()
            except ValueError as e:
                self.respond({"id": rid, "ok": False, "error": "error",
                              "message": str(e)})
                return
            self.respond({"id": rid, "ok": True,
                          "subscription": sub.sub_id, "handoff": snap})
        else:  # subscriptions: introspection
            self.respond({"id": rid, "ok": True, **mgr.stats()})

    def close(self) -> None:
        self._stop.set()
        if self._pump is not None:
            self._pump.join(timeout=5.0)
        if self.manager is not None:
            # final flush so cancelled/expired frames are not lost
            try:
                self.manager.flush(self.push)
            except Exception:
                # the stream is closing: a broken sink must not mask the
                # manager close that releases subscriptions
                pass
            self.manager.close()
            if self.svc.subscriptions is self.manager:
                self.svc.subscriptions = None


class _WireState:
    """Per-connection columnar-wire state (docs/SERVING.md "Columnar
    wire"): the negotiated session mode, the byte writer shared with
    the line writer under one lock (frames and lines interleave on one
    stream — the framing must never tear), and this connection's
    PushMux sinks. The OWNER sink (its own subscriptions' frames) is
    synchronous so the manager's flush-requeue contract holds; the
    MIRROR sink (frames attached from other connections) is threaded —
    a slow mirror backs up only its own bounded queue."""

    def __init__(self, svc: QueryService, write, write_bytes, out_lock):
        self.svc = svc
        self.write = write
        self.write_bytes = write_bytes
        self.out_lock = out_lock
        self.mode = colwire.WIRE_JSON
        self.mux = None
        # sink registration is reached from TWO threads (the reader
        # thread's poll/subscribe flush and the --live-poll-ms pump):
        # lazy init needs its own guard or a race registers an orphan
        # sink that leaks in the service-wide mux
        self._sink_lock = threading.Lock()
        self.owner_sink: Optional[str] = None
        # one mirror sink per wire MODE: a second attach asking for a
        # different encoding gets its own sink, so the response's
        # wireMode always states the encoding actually delivered
        self.mirror_sinks: dict = {}

    def can_columnar(self) -> bool:
        return self.write_bytes is not None and colwire.have_pyarrow()

    def fallback_reason(self) -> str:
        return ("pyarrow_unavailable" if not colwire.have_pyarrow()
                else "no_binary_sink")

    def request_mode(self, doc: dict) -> str:
        """The wire mode one request resolved to (per-request opt-in
        overrides the session default)."""
        return str(doc.get("wire", self.mode))

    def write_buf(self, buf: bytes) -> None:
        """One encoded frame/line onto the stream, under the same lock
        as respond() — columnar JSON fallback sinks decode to the
        identical text line the legacy path wrote."""
        with self.out_lock:
            if self.write_bytes is not None:
                self.write_bytes(buf)
            else:
                self.write(buf.decode("utf-8"))

    def _mux(self):
        if self.mux is None:
            self.mux = self.svc.wire_mux()
        return self.mux

    def push(self, frame: dict) -> None:
        """Push-frame sink: route through the mux so the frame is
        encoded ONCE and fanned to this connection + attached mirrors
        (the one-encode path holds even for a lone JSON subscriber)."""
        mux = self._mux()
        with self._sink_lock:
            if self.owner_sink is None:
                mode = (self.mode if self.can_columnar()
                        else colwire.WIRE_JSON)
                self.owner_sink = mux.register(
                    self.write_buf, mode=mode, threaded=False)
            owner = self.owner_sink
        mux.route(frame, owner=owner)

    def ensure_mirror(self, mode: str) -> str:
        mux = self._mux()
        with self._sink_lock:
            sink = self.mirror_sinks.get(mode)
            if sink is None:
                sink = mux.register(
                    self.write_buf, mode=mode, threaded=True)
                self.mirror_sinks[mode] = sink
            return sink

    def mirror_detach(self, subscription_id: str) -> None:
        """Detach every mode's mirror sink from one subscription."""
        if self.mux is None:
            return
        with self._sink_lock:
            sinks = list(self.mirror_sinks.values())
        for sink in sinks:
            self.mux.detach(sink, subscription_id)

    def close(self) -> None:
        if self.mux is None:
            return
        with self._sink_lock:
            sinks = [self.owner_sink] + list(self.mirror_sinks.values())
        for sink in sinks:
            if sink is not None:
                self.mux.unregister(sink)


def _handle_ingest(store, rid, doc: dict, payload: Optional[bytes],
                   respond) -> None:
    """Columnar bulk ingest: `{"op": "ingest", "typeName": ..., "frame":
    {...}}` + an Arrow IPC stream payload, written through
    `DataStore.write_batch`. Raises for the caller's per-request error
    isolation."""
    if payload is None:
        raise ValueError(
            "op=ingest needs a binary frame payload (an Arrow IPC stream)")
    if not colwire.have_pyarrow():
        respond({"id": rid, "ok": False, "error": "rejected",
                 "reason": "pyarrow_unavailable",
                 "message": "columnar ingest needs pyarrow on the server"})
        return
    rows, batches = store.write_batch(doc["typeName"], payload)
    from geomesa_tpu_torch.utils.metrics import metrics

    metrics.counter("wire.ingest.rows", rows)
    metrics.counter("wire.ingest.bytes", len(payload))
    respond({"id": rid, "ok": True, "rows": rows, "batches": batches})


def _handle_attach(svc: QueryService, wire: _WireState, rid, op: str,
                   doc: dict, respond) -> None:
    """`attach`/`detach`: mirror one subscription's push frames onto
    THIS connection (the cross-connection fan-out — the subscription
    itself lives on its owner connection's manager). One evaluation +
    one encode serve every mirror (PushMux)."""
    sub_id = doc.get("subscription")
    mgr = svc.subscriptions
    sub = mgr.registry.maybe(sub_id) if (mgr is not None
                                         and sub_id) else None
    if op == "detach":
        if sub_id:
            wire.mirror_detach(sub_id)
        respond({"id": rid, "ok": True, "subscription": sub_id})
        return
    if sub is None:
        respond({"id": rid, "ok": False, "error": "error",
                 "message": "no such subscription"})
        return
    mode = wire.request_mode(doc)
    out = {"id": rid, "ok": True, "subscription": sub_id}
    if mode == colwire.WIRE_COLUMNAR and not wire.can_columnar():
        mode = colwire.WIRE_JSON
        out["wireFallback"] = wire.fallback_reason()
    sink = wire.ensure_mirror(mode)
    out["sinks"] = svc.wire_mux().attach(sink, sub_id)
    out["wireMode"] = mode
    respond(out)


def serve_lines(
    store,
    lines: Iterable[str],
    write,
    config: Optional[ServeConfig] = None,
    service: Optional[QueryService] = None,
) -> int:
    """Run the JSON-lines loop: submit every request line to a
    QueryService over `store`, write one response line per request via
    `write(str)` as each completes, drain gracefully at end of input.
    Returns the number of requests processed. A service passed in is
    owned from then on: the loop drains and closes it either way. The
    stream is the process owner's, so it is admin: `{"op": "drain"}`
    drains the service in place."""
    svc = service if service is not None else QueryService(store, config)
    try:
        return serve_connection(store, svc, lines, write, admin=True)
    finally:
        svc.close(drain=True)


def serve_connection(store, svc: QueryService, lines: Iterable[str], write,
                     admin: bool = False, write_bytes=None,
                     read_bytes=None) -> int:
    """One JSON-lines conversation over a SHARED QueryService (the
    service outlives the connection — closing it is the caller's job;
    contrast `serve_lines`, which owns its service). `admin` seeds the
    connection's role; a hello with role router/admin upgrades it.

    `write_bytes`/`read_bytes` are the binary-frame transport (a socket's
    raw write and exact read, or `columnar.MemoryWire.read_exact`):
    without them the columnar wire downgrades typed to JSON and inbound
    binary frames are refused."""
    out_lock = threading.Lock()
    processed = 0
    is_admin = admin

    def respond(doc: dict) -> None:
        with out_lock:
            write(json.dumps(doc) + "\n")

    wire = _WireState(svc, write, write_bytes, out_lock)
    subs = _SubscribeSession(store, svc, respond, push=wire.push)

    def on_done(rid, req):
        def cb(fut):
            # clock reads only when this request is traced
            r0_ns = perf_counter_ns() if req.trace is not None else 0
            try:
                exc = fut.exception() if not fut.cancelled() else None
                if fut.cancelled():
                    respond({"id": rid, "ok": False, "error": "rejected",
                             "reason": "cancelled", "message": "cancelled"})
                elif exc is not None:
                    respond(_error_response(rid, exc))
                else:
                    limit = req.query.max_features or MAX_FEATURE_ROWS
                    doc = {"id": rid, "ok": True}
                    payload = None
                    if req.wire == colwire.WIRE_COLUMNAR:
                        e0_ns = (perf_counter_ns()
                                 if req.trace is not None else 0)
                        fields, payload = _columnar_payload(
                            req.kind, fut.result(), limit)
                        if payload is not None:
                            doc.update(fields)
                            if req.trace is not None:
                                req.trace.record(
                                    "wire.encode", e0_ns,
                                    perf_counter_ns(), kind=req.kind)
                    if payload is None:
                        doc.update(_payload(req.kind, fut.result(), limit))
                        fb = getattr(req, "wire_fallback", None)
                        if fb is not None:
                            doc["wireFallback"] = fb
                    if req.degraded:
                        doc["degraded"] = True
                    if req.cache_hit:
                        doc["cached"] = True
                    if payload is not None:
                        # one buffer, one locked write: the header line
                        # and its payload never interleave with another
                        wire.write_buf(colwire.frame_bytes(doc, payload))
                    else:
                        respond(doc)
            finally:
                if req.trace is not None:
                    # serialization + line write, per rider (callbacks
                    # run on the dispatch thread inside set_result)
                    req.trace.record("respond", r0_ns, perf_counter_ns())

        return cb

    try:
        for line in lines:
            line = line.strip()
            if not line:
                continue
            processed += 1
            rid = None
            try:
                doc = json.loads(line)
                rid = doc.get("id", processed)
                op = doc.get("op")
                payload = None
                fr = doc.get("frame")
                if fr and fr.get("nbytes"):
                    # inbound binary frame: its payload follows this header
                    # line and is consumed before the next line is read
                    if read_bytes is None:
                        raise ValueError(
                            "binary frames need a socket transport; this "
                            "stream is text-only")
                    payload = read_bytes(int(fr["nbytes"]))
                if op == "hello":
                    role = str(doc.get("role", "client"))
                    if role in ADMIN_ROLES:
                        is_admin = True
                    out = {"id": rid, "ok": True, "role": role,
                           "admin": is_admin,
                           # capability flag: this server understands
                           # subscribe(handoff=) re-homing
                           "rehome": True,
                           "wire": colwire.wire_capabilities()}
                    if doc.get("wire") == colwire.WIRE_COLUMNAR:
                        if wire.can_columnar():
                            wire.mode = colwire.WIRE_COLUMNAR
                            out["wireMode"] = colwire.WIRE_COLUMNAR
                        else:
                            out["wireMode"] = colwire.WIRE_JSON
                            out["wireFallback"] = wire.fallback_reason()
                    respond(out)
                    continue
                if op == "drain":
                    if not is_admin:
                        respond({"id": rid, "ok": False, "error": "rejected",
                                 "reason": "admin_required",
                                 "message": "drain needs an admin connection "
                                            "(hello with role router/admin)"})
                        continue
                    svc.close(drain=True)
                    respond({"id": rid, "ok": True, "state": "drained"})
                    continue
                if op == "ingest":
                    _handle_ingest(store, rid, doc, payload, respond)
                    continue
                if op in ("attach", "detach"):
                    _handle_attach(svc, wire, rid, op, doc, respond)
                    continue
                if op in SUBSCRIBE_OPS:
                    subs.handle(rid, doc)
                    continue
                if op == "stats":
                    stats = svc.stats()
                    if subs.manager is not None:
                        # handoff checkpoints of THIS connection's standing
                        # queries (no new RPC); an unchanged subscription
                        # ships nothing
                        stats["subs_checkpoint"] = subs.manager.checkpoints()
                    respond({"id": rid, "ok": True, "stats": stats})
                    continue
                req = parse_request(doc, payload)
                if wire.request_mode(doc) == colwire.WIRE_COLUMNAR:
                    if wire.can_columnar():
                        req.wire = colwire.WIRE_COLUMNAR
                    else:
                        # typed downgrade: the JSON answer says why
                        req.wire_fallback = wire.fallback_reason()
                fut = svc.submit(req)
                fut.add_done_callback(on_done(rid, req))
            except Exception as e:  # noqa: BLE001 — per-request isolation
                respond(_error_response(rid if rid is not None else processed, e))
    finally:
        subs.close()
        wire.close()
    return processed
