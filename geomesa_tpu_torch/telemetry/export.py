"""Trace + metrics exporters: Perfetto JSON, JSON-lines, and the live
HTTP endpoint.

A copy of the reference package's `telemetry/export.py`, reading the
port's metrics registry, circuit breakers and flight recorder.

- **Offline flame views**: `to_perfetto()` emits Chrome/Perfetto
  `trace_event` JSON (`{"traceEvents": [...]}` with `ph:"X"` complete
  events): each query trace becomes one "process" row (pid = trace
  sequence, labelled with the trace name + id) with one track per OS
  thread. Span/parent ids ride in `args` so a dump re-parses losslessly
  (`from_perfetto()`).
- **Streaming**: `write_jsonl()`, one JSON document per completed
  trace, the shape `FlightRecorder.record` stores.
- **Live scrape**: `MetricsServer`, a stdlib `http.server` on a daemon
  thread serving `/metrics` (Prometheus text), `/healthz` (JSON
  liveness), `/debug/traces` (Perfetto JSON of the flight recorder),
  `/debug/stats` (registry snapshot, serve stats, breakers, recorder),
  `/debug/gap` (the dispatch-gap report over recorded traces),
  `/debug/slo` (the SLO engine's report, telemetry/slo.py),
  `/debug/approx` (approximate-tier shares + result-cache counters) and
  `/debug/prof` (the continuous profiler's lifetime distributions,
  telemetry/prof.py).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, Iterable, List, Optional

__all__ = ["to_perfetto", "from_perfetto", "write_jsonl", "MetricsServer"]


# -- Perfetto / Chrome trace_event -----------------------------------------


def _trace_doc(trace) -> dict:
    """Accept a Trace or its to_json() dict."""
    return trace if isinstance(trace, dict) else trace.to_json()


def to_perfetto(traces: Iterable) -> dict:
    """Chrome trace_event JSON for a set of query traces. Timestamps are
    microseconds from the process perf_counter epoch (all traces share
    it, so cross-query overlap — coalescing windows, queue contention —
    lines up on one timeline)."""
    events: List[dict] = []
    for pid, trace in enumerate(map(_trace_doc, traces), start=1):
        label = f"{trace.get('name', 'trace')} {trace.get('trace_id', '')}"
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": label.strip()},
        })
        spans = [trace["root"]] + list(trace.get("spans", ()))
        for s in spans:
            args = {
                "span_id": s["id"],
                "parent_id": s.get("parent"),
                "trace_id": trace.get("trace_id"),
            }
            if s.get("attrs"):
                args.update(s["attrs"])
            events.append({
                "ph": "X",
                "name": s["name"],
                "cat": "gmtpu",
                "pid": pid,
                "tid": s.get("thread", 0),
                "ts": s["t0_ns"] / 1000.0,
                "dur": max(s["t1_ns"] - s["t0_ns"], 0) / 1000.0,
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def from_perfetto(doc: dict) -> List[dict]:
    """Re-parse a `to_perfetto()` document back into trace dicts (the
    recorder's storage shape). Spans regroup by the trace_id each event
    carries in args; the root is the span with no parent."""
    by_trace: Dict[str, List[dict]] = {}
    names: Dict[str, str] = {}
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        args = e.get("args", {})
        tid = args.get("trace_id")
        if tid is None:
            continue
        t0 = int(round(e["ts"] * 1000.0))
        span = {
            "name": e["name"],
            "id": args["span_id"],
            "parent": args.get("parent_id"),
            "t0_ns": t0,
            "t1_ns": t0 + int(round(e.get("dur", 0) * 1000.0)),
            "thread": e.get("tid", 0),
        }
        extra = {k: v for k, v in args.items()
                 if k not in ("span_id", "parent_id", "trace_id")}
        if extra:
            span["attrs"] = extra
        by_trace.setdefault(tid, []).append(span)
        if span["parent"] is None:
            names[tid] = e["name"]
    out = []
    for tid, spans in by_trace.items():
        root = next((s for s in spans if s["parent"] is None), None)
        rest = [s for s in spans if s is not root]
        out.append({
            "trace_id": tid,
            "name": names.get(tid, "trace"),
            "root": root,
            "spans": rest,
        })
    return out


def write_jsonl(traces: Iterable, write: Callable[[str], None]) -> int:
    """One JSON line per trace via `write`; returns the line count."""
    n = 0
    for trace in traces:
        write(json.dumps(_trace_doc(trace)) + "\n")
        n += 1
    return n


# -- live HTTP endpoint ----------------------------------------------------


class MetricsServer:
    """`/metrics` + `/healthz` + `/debug/*` on a daemon thread.

    `stats_fn` (optional) supplies the serving layer's live counters
    (`QueryService.stats()`); `pre_scrape` (optional) runs before each
    /metrics render so point-in-time gauges (queue depth, breaker
    states, quarantine size) are fresh at scrape time rather than
    last-update time. Both are called on the HTTP thread — they must be
    cheap and thread-safe, which `stats()`/gauge writes are."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 stats_fn: Optional[Callable[[], dict]] = None,
                 pre_scrape: Optional[Callable[[], None]] = None,
                 recorder=None,
                 slo_fn: Optional[Callable[[], dict]] = None):
        self.host = host
        self.port = port
        self.stats_fn = stats_fn
        self.pre_scrape = pre_scrape
        # /debug/slo provider (QueryService passes its engine's report;
        # None renders a typed "no spec loaded" document instead of 404
        # so dashboards can probe for SLO support)
        self.slo_fn = slo_fn
        if recorder is None:
            from geomesa_tpu_torch.telemetry.recorder import RECORDER
            recorder = RECORDER
        self.recorder = recorder
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        from time import monotonic

        self._started_at = monotonic()

    # handlers return (status, content_type, body-bytes)

    def _route(self, path: str):
        from time import monotonic

        if path == "/metrics":
            if self.pre_scrape is not None:
                try:
                    self.pre_scrape()
                except Exception:
                    pass  # a scrape must degrade, not 500, on hook bugs
            from geomesa_tpu_torch.utils.metrics import metrics

            return (200, "text/plain; version=0.0.4",
                    metrics.to_prometheus().encode())
        if path == "/healthz":
            doc = {"ok": True,
                   "uptime_s": round(monotonic() - self._started_at, 3),
                   # the BOUND port (port=0 requests an ephemeral one):
                   # a prober that reached us learns the canonical
                   # address other tools should use
                   "endpoint": {"host": self.host, "port": self.port}}
            if self.stats_fn is not None:
                try:
                    doc["serve"] = self.stats_fn()
                except Exception as e:
                    doc["ok"] = False
                    doc["error"] = str(e)
            return (200 if doc["ok"] else 503, "application/json",
                    json.dumps(doc).encode())
        if path == "/debug/traces":
            doc = to_perfetto(self.recorder.traces())
            return (200, "application/json", json.dumps(doc).encode())
        if path == "/debug/stats":
            return (200, "application/json",
                    json.dumps(self._debug_stats()).encode())
        if path == "/debug/gap":
            from geomesa_tpu_torch.telemetry.gap import gap_report

            doc = gap_report(self.recorder.traces())
            return (200, "application/json", json.dumps(doc).encode())
        if path == "/debug/slo":
            doc = ({"enabled": False} if self.slo_fn is None
                   else self.slo_fn())
            return (200, "application/json", json.dumps(doc).encode())
        if path == "/debug/approx":
            # serving-tier shares: sketch vs cached vs exact, the result-cache
            # hit/miss/evict counters, and whether the SLO exactness
            # governor currently allows sketch serving
            doc = {"enabled": False}
            if self.stats_fn is not None:
                try:
                    stats = self.stats_fn()
                    doc = dict(stats.get("approx") or {"enabled": False})
                    tiers = doc.get("tiers") or {}
                    total = sum(tiers.values())
                    if total:
                        doc["shares"] = {
                            k: round(v / total, 4)
                            for k, v in tiers.items()}
                    if "cache" in stats:
                        doc["cache"] = stats["cache"]
                except Exception as e:
                    doc = {"enabled": False, "error": str(e)}
            return (200, "application/json", json.dumps(doc).encode())
        if path == "/debug/prof":
            from geomesa_tpu_torch.telemetry.prof import PROFILER

            # samples ride along (bounded: <= 256 per reservoir) so a
            # saved /debug/prof document is directly comparable by the
            # sentinel's distribution-overlap test
            doc = PROFILER.snapshot(include_samples=True)
            return (200, "application/json", json.dumps(doc).encode())
        return (404, "text/plain", b"not found\n")

    def _debug_stats(self) -> dict:
        """The `/debug/stats` payload: metrics registry snapshot + serve
        stats + breaker states + recorder occupancy, one JSON doc."""
        from geomesa_tpu_torch.utils.metrics import metrics

        doc: dict = {"metrics": json.loads(metrics.to_json()),
                     "endpoint": {"host": self.host, "port": self.port,
                                  "url": self.url}}
        if self.stats_fn is not None:
            try:
                doc["serve"] = self.stats_fn()
            except Exception as e:
                doc["serve_error"] = str(e)
        try:
            from geomesa_tpu_torch.faults import BREAKERS

            doc["breakers"] = BREAKERS.states()
        except Exception:
            doc["breakers"] = {}
        doc["recorder"] = self.recorder.stats()
        return doc

    def start(self) -> int:
        """Bind and serve; returns the actual port (port=0 lets the OS
        pick — the tests and smoke use that)."""
        if self._httpd is not None:
            return self.port
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    status, ctype, body = server._route(self.path)
                except Exception as e:  # noqa: BLE001 — 500, not a crash
                    status, ctype = 500, "text/plain"
                    body = f"error: {e}\n".encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # quiet: stderr is for
                pass                            # the serve loop's use

        # (deliberate per-process bind: every host of a pod exposes its
        # own metrics endpoint — scrape configs enumerate hosts; the
        # one-box multi-process smoke does not start the exporter)
        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.5},
            name="gmtpu-metrics-http", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
