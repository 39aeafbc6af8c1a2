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

What a later slice brings answers typed instead of running another
route: {"ok": false, "error": "error", "reason": "not_ported",
"roadmap": item, "message"}. That covers the subscribe verbs and
`attach`/`detach` (ROADMAP A6).

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


class _WireState:
    """Per-connection columnar-wire state: the negotiated session mode
    and the byte writer, shared with the line writer under one lock
    (frames and lines interleave on one stream and must never tear)."""

    def __init__(self, write, write_bytes, out_lock):
        self.write = write
        self.write_bytes = write_bytes
        self.out_lock = out_lock
        self.mode = colwire.WIRE_JSON

    def can_columnar(self) -> bool:
        return self.write_bytes is not None and colwire.have_pyarrow()

    def fallback_reason(self) -> str:
        return ("pyarrow_unavailable" if not colwire.have_pyarrow()
                else "no_binary_sink")

    def request_mode(self, doc: dict) -> str:
        """The wire mode one request resolved to (a per-request opt-in
        overrides the session default)."""
        return str(doc.get("wire", self.mode))

    def write_buf(self, buf: bytes) -> None:
        """One encoded frame onto the stream, under the response lock."""
        with self.out_lock:
            if self.write_bytes is not None:
                self.write_bytes(buf)
            else:
                self.write(buf.decode("utf-8"))


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

    wire = _WireState(write, write_bytes, out_lock)

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
            if op in SUBSCRIBE_OPS or op in ("attach", "detach"):
                raise NotPortedError(f"op={op} (standing queries)",
                                     "ROADMAP A6")
            if op == "stats":
                respond({"id": rid, "ok": True, "stats": svc.stats()})
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
    return processed
