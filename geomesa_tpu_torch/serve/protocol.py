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
rejected|timeout|error, "reason", "message"}. The reference's
"unavailable" answer to an open circuit breaker comes with the breakers
(ROADMAP A5): nothing in the port opens one.
`{"op": "stats"}` answers the service's live counters, `{"op": "hello"}`
the connection's role and the wire it speaks, and `{"op": "drain"}` (on
an admin connection) drains the service in place.

What a later slice brings answers typed instead of running another
route: {"ok": false, "error": "error", "reason": "not_ported",
"roadmap": item, "message"}. That covers the subscribe verbs (ROADMAP
A6), ingest frames and the `tolerance`/`topkCells`/`distinct` hints (A4).
The columnar wire waits for A4 with `core/arrow_io.py`: the hello
advertises `["json"]`, and a `"wire": "columnar"` request is served as
JSON with a typed `"wireFallback"` saying so, along the reference's own
path for a missing codec.

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
from geomesa_tpu_torch.plan.hints import QueryHints
from geomesa_tpu_torch.plan.planner import QueryTimeout
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.serve.scheduler import (
    PRIORITIES, QueryRejected, ServeRequest)
from geomesa_tpu_torch.serve.service import QueryService, ServeConfig

MAX_FEATURE_ROWS = 10_000  # response-size guard for op=query

WIRE_JSON = "json"
WIRE_COLUMNAR = "columnar"
# the hello's capability list: the columnar codec is ROADMAP A4
WIRE_CAPABILITIES = [WIRE_JSON]
# the typed downgrade reason of a columnar ask (the reference says
# pyarrow_unavailable or no_binary_sink on its own missing-codec path)
COLUMNAR_FALLBACK = "columnar wire not ported (ROADMAP A4)"

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


def _payload(kind: str, result, limit: int) -> dict:
    if kind == "count":
        return {"count": int(result)}
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
    return out


def parse_request(doc: dict) -> ServeRequest:
    op = doc.get("op", "query")
    kind = {"query": "execute", "execute": "execute",
            "count": "count", "knn": "knn"}.get(op)
    if kind is None:
        raise ValueError(f"unknown op {op!r}")
    type_name = doc["typeName"]
    for field in ("tolerance", "topkCells", "distinct"):
        if doc.get(field) is not None:
            raise NotPortedError(f"the {field!r} request field "
                                 "(approximate answers)", "ROADMAP A4")
    if doc.get("frame"):
        raise NotPortedError("binary request frames (columnar wire)",
                             "ROADMAP A4")
    kw = {}
    d = doc.get("density")
    if d:
        # a one-shot DensityScan window (the subscribe verb's spec shape)
        kw["hints"] = QueryHints(
            density_bbox=tuple(float(v) for v in d["bbox"]),
            density_width=int(d["width"]),
            density_height=int(d["height"]),
            density_weight=d.get("weight"))
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
    if isinstance(exc, QueryTimeout):
        return {"id": rid, "ok": False, "error": "timeout",
                "phase": exc.phase, "message": str(exc)}
    if isinstance(exc, NotPortedError):
        return {"id": rid, "ok": False, "error": "error",
                "reason": "not_ported", "roadmap": exc.later_slice,
                "message": str(exc)}
    return {"id": rid, "ok": False, "error": "error", "message": str(exc)}


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
                     admin: bool = False) -> int:
    """One JSON-lines conversation over a SHARED QueryService (the
    service outlives the connection — closing it is the caller's job;
    contrast `serve_lines`, which owns its service). `admin` seeds the
    connection's role; a hello with role router/admin upgrades it."""
    out_lock = threading.Lock()
    processed = 0
    is_admin = admin

    def respond(doc: dict) -> None:
        with out_lock:
            write(json.dumps(doc) + "\n")

    def on_done(rid, req, wire_fallback):
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
                    doc.update(_payload(req.kind, fut.result(), limit))
                    if wire_fallback is not None:
                        doc["wireFallback"] = wire_fallback
                    if req.degraded:
                        doc["degraded"] = True
                    if req.cache_hit:
                        doc["cached"] = True
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
            if op == "hello":
                role = str(doc.get("role", "client"))
                if role in ADMIN_ROLES:
                    is_admin = True
                out = {"id": rid, "ok": True, "role": role,
                       "admin": is_admin, "wire": list(WIRE_CAPABILITIES)}
                if doc.get("wire") == WIRE_COLUMNAR:
                    out["wireMode"] = WIRE_JSON
                    out["wireFallback"] = COLUMNAR_FALLBACK
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
                raise NotPortedError("op=ingest (columnar bulk ingest)",
                                     "ROADMAP A4")
            if op in SUBSCRIBE_OPS or op in ("attach", "detach"):
                raise NotPortedError(f"op={op} (standing queries)",
                                     "ROADMAP A6")
            if op == "stats":
                respond({"id": rid, "ok": True, "stats": svc.stats()})
                continue
            req = parse_request(doc)
            fallback = (COLUMNAR_FALLBACK
                        if doc.get("wire") == WIRE_COLUMNAR else None)
            fut = svc.submit(req)
            fut.add_done_callback(on_done(rid, req, fallback))
        except Exception as e:  # noqa: BLE001 — per-request isolation
            respond(_error_response(rid if rid is not None else processed, e))
    return processed
