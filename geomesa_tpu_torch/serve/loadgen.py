"""Load generator for the serving layer (`gmtpu bench-serve`).

The port of the reference package's `serve/loadgen.py`: the closed,
open, sustained and subscribe modes (`run_subscribe`,
`run_subscribe_lanes`) and the kNN and count request factories. The
wire, approximate and fleet modes and `mesh_dispatch_count` come with
the tooling slice (ROADMAP A8). Three query workload shapes:

- closed loop: N clients issue back-to-back queries (each waits for its
  response before sending the next). Measures sustainable throughput and
  the latency the system settles into under exactly-N outstanding
  requests. Throughput rises with N until the device saturates.
- open loop: arrivals at a fixed rate regardless of completions — the
  shape real traffic has. Latency here includes queue wait, so an
  offered rate above capacity shows UNBOUNDED latency growth... unless
  admission control sheds, which is precisely what the bounded queue +
  QueryRejected are for. The report separates served from shed.
- sustained: a fixed-duration loop that keeps exactly K requests
  outstanding and reports points/s by the reference's accounting.

Reports throughput plus p50/p95/p99/max latency (exact, from raw
samples — the serving histograms are bucket estimates; a bench should
not inherit their quantization), and the service's dispatch/coalesce
counters so a coalesced-vs-serial comparison is one subtraction.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import wait as futures_wait
from typing import Callable, Dict, List, Optional

import numpy as np

from geomesa_tpu_torch.plan.planner import QueryTimeout
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.serve.scheduler import QueryRejected, ServeRequest
from geomesa_tpu_torch.serve.service import QueryService
from geomesa_tpu_torch.utils.metrics import metrics


@dataclasses.dataclass
class LoadReport:
    mode: str
    duration_s: float
    sent: int
    ok: int
    rejected: int
    timeouts: int
    errors: int
    throughput_qps: float
    mean_ms: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float
    dispatches: int
    coalesced: int
    # sustained mode: the headline pts/s (store points scanned x served
    # queries / wall) and how deep the dispatch pipeline actually ran
    pts_per_s: float = 0.0
    windows_in_flight_max: int = 0
    pipelined_windows: int = 0
    fused_counts: int = 0
    # persistent serve loop: how many windows rode a ring program, how
    # many fell back typed, and the per-window device-interaction count
    # (`serve.device.ops` delta / windows) — the number that compares the
    # ring with the pipelined route on identical work. The mesh's fields
    # come with the tooling slice (ROADMAP A8)
    ring_windows: int = 0
    ring_fallbacks: int = 0
    dispatches_per_window: float = 0.0
    # subscribe mode: N standing subscriptions folded over M kafka
    # batches — throughput is pushed events/s, latency is the per-batch
    # poll->eval->push cycle, and `dispatches` is the evaluator's device
    # call count (lanes and the fused remainder)
    subscriptions: int = 0
    batches: int = 0
    events_total: int = 0
    events_per_s: float = 0.0
    # a bounded sample of the raw end-to-end latencies, evenly strided
    # from the sorted samples (order statistics, so two runs of the
    # same workload produce comparable vectors)
    samples_ms: List[float] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        doc = dataclasses.asdict(self)
        doc.pop("samples_ms", None)  # report lines stay readable
        return doc


def device_ops_count() -> float:
    """Process-lifetime `serve.device.ops` counter: one tick per
    serve-path device interaction (utils.metrics.note_device_op). The
    delta across a measured run over the window count is
    `dispatches_per_window`."""
    with metrics._lock:
        return float(metrics.counters.get("serve.device.ops", 0.0))


def _report(mode: str, duration: float, lat_s: List[float], sent: int,
            rejected: int, timeouts: int, errors: int,
            stats: Dict[str, int]) -> LoadReport:
    lat = np.asarray(lat_s, np.float64) * 1000.0
    ok = len(lat)

    def q(p):
        return float(np.percentile(lat, p)) if ok else 0.0

    sorted_lat = np.sort(lat)
    stride = max(1, ok // 512)
    return LoadReport(
        mode=mode,
        duration_s=duration,
        sent=sent,
        ok=ok,
        rejected=rejected,
        timeouts=timeouts,
        errors=errors,
        throughput_qps=ok / duration if duration > 0 else 0.0,
        mean_ms=float(lat.mean()) if ok else 0.0,
        p50_ms=q(50), p95_ms=q(95), p99_ms=q(99),
        max_ms=float(lat.max()) if ok else 0.0,
        dispatches=stats.get("dispatches", 0),
        coalesced=stats.get("coalesced", 0),
        samples_ms=[round(float(v), 4) for v in sorted_lat[::stride]],
    )


class _Tally:
    def __init__(self):
        self.lock = threading.Lock()
        self.lat_s: List[float] = []
        self.sent = 0
        self.rejected = 0
        self.timeouts = 0
        self.errors = 0

    def outcome(self, t0: float, fut) -> None:
        try:
            fut.result()
            dt = time.monotonic() - t0
            with self.lock:
                self.lat_s.append(dt)
        except QueryTimeout:
            with self.lock:
                self.timeouts += 1
        except QueryRejected:
            with self.lock:
                self.rejected += 1
        except Exception:
            with self.lock:
                self.errors += 1


def run_closed_loop(
    service: QueryService,
    make_request: Callable[[int], ServeRequest],
    concurrency: int = 8,
    duration_s: float = 5.0,
    requests_per_client: Optional[int] = None,
) -> LoadReport:
    """N clients, each submit→wait→repeat until the duration elapses (or
    a fixed per-client request count when given — deterministic mode for
    tests)."""
    tally = _Tally()
    base = service.stats()
    deadline = time.monotonic() + duration_s

    def client(cid: int):
        i = 0
        while True:
            if requests_per_client is not None:
                if i >= requests_per_client:
                    return
            elif time.monotonic() >= deadline:
                return
            with tally.lock:
                tally.sent += 1
            t0 = time.monotonic()
            try:
                fut = service.submit(make_request(cid * 1_000_003 + i))
            except QueryRejected:
                with tally.lock:
                    tally.rejected += 1
                i += 1
                continue
            tally.outcome(t0, fut)
            i += 1

    t_start = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    stats = service.stats()
    delta = {k: stats.get(k, 0) - base.get(k, 0)
             for k in ("dispatches", "coalesced")}
    return _report("closed", wall, tally.lat_s, tally.sent,
                   tally.rejected, tally.timeouts, tally.errors, delta)


def run_open_loop(
    service: QueryService,
    make_request: Callable[[int], ServeRequest],
    rate_qps: float = 100.0,
    duration_s: float = 5.0,
) -> LoadReport:
    """Fixed-rate arrivals (uniform spacing), submissions never wait for
    completions. Latency = submit→resolve, queue wait included."""
    if rate_qps <= 0:
        raise ValueError("rate_qps must be > 0")
    tally = _Tally()
    base = service.stats()
    interval = 1.0 / rate_qps
    pending: List[tuple] = []
    t_start = time.monotonic()
    deadline = t_start + duration_s
    i = 0
    while True:
        due = t_start + i * interval
        now = time.monotonic()
        if due >= deadline:
            break
        if due > now:
            time.sleep(due - now)
        with tally.lock:
            tally.sent += 1
        t0 = time.monotonic()
        try:
            fut = service.submit(make_request(i))
            pending.append((t0, fut))
        except QueryRejected:
            with tally.lock:
                tally.rejected += 1
        i += 1
    for t0, fut in pending:
        tally.outcome(t0, fut)
    wall = time.monotonic() - t_start
    stats = service.stats()
    delta = {k: stats.get(k, 0) - base.get(k, 0)
             for k in ("dispatches", "coalesced")}
    return _report("open", wall, tally.lat_s, tally.sent,
                   tally.rejected, tally.timeouts, tally.errors, delta)


def run_sustained(
    service: QueryService,
    make_request: Callable[[int], ServeRequest],
    duration_s: float = 5.0,
    max_outstanding: int = 32,
    points_per_query: int = 0,
    requests: Optional[int] = None,
) -> LoadReport:
    """Sustained-throughput mode (`gmtpu bench-serve --mode sustained`):
    a fixed-duration closed loop that keeps exactly `max_outstanding`
    requests in flight — submissions are gated by a semaphore released
    from future callbacks, not by per-client turnarounds — and reports
    points/sec, not just latency percentiles: `pts_per_s =
    points_per_query * served_qps` (each served query scans the whole
    resident store), and the pipeline's windows in flight. `requests`
    caps total submissions for deterministic test runs."""
    tally = _Tally()
    base = service.stats()
    ops_base = device_ops_count()
    pipe = getattr(service, "pipeline", None)
    if pipe is not None:
        # the in-flight high-water must be THIS run's, not the service
        # lifetime's
        pipe.reset_max_inflight()
    gate = threading.Semaphore(max_outstanding)
    deadline = time.monotonic() + duration_s
    inflight = []
    t_start = time.monotonic()

    def on_done(t0):
        # latency stamps at RESOLUTION time (the callback runs on the
        # resolving thread), not when the harvest loop gets around to
        # the future — with K outstanding the two differ by up to the
        # whole run
        def cb(fut):
            dt = time.monotonic() - t0
            try:
                fut.result()
            except QueryTimeout:
                with tally.lock:
                    tally.timeouts += 1
            except QueryRejected:
                with tally.lock:
                    tally.rejected += 1
            except BaseException:  # noqa: BLE001 — tally, never raise
                with tally.lock:
                    tally.errors += 1
            else:
                with tally.lock:
                    tally.lat_s.append(dt)
            gate.release()

        return cb

    i = 0
    while time.monotonic() < deadline:
        if requests is not None and i >= requests:
            break
        if not gate.acquire(timeout=0.1):
            continue
        with tally.lock:
            tally.sent += 1
        t0 = time.monotonic()
        try:
            fut = service.submit(make_request(i))
        except QueryRejected:
            with tally.lock:
                tally.rejected += 1
            gate.release()
            i += 1
            continue
        i += 1
        inflight.append(fut)
        fut.add_done_callback(on_done(t0))
    # completion barrier only — outcomes were tallied in the callbacks
    # (wait() reports, never raises; a straggler past the bound is
    # abandoned rather than blocking the report)
    futures_wait(inflight, timeout=120)
    wall = time.monotonic() - t_start
    stats = service.stats()
    delta = {k: stats.get(k, 0) - base.get(k, 0)
             for k in ("dispatches", "coalesced")}
    rep = _report("sustained", wall, tally.lat_s, tally.sent,
                  tally.rejected, tally.timeouts, tally.errors, delta)
    rep.pts_per_s = rep.throughput_qps * points_per_query
    p = stats.get("pipeline") or {}
    pbase = base.get("pipeline") or {}
    rep.windows_in_flight_max = int(p.get("max_inflight", 0))
    rep.pipelined_windows = (stats.get("pipelined_windows", 0)
                             - base.get("pipelined_windows", 0))
    # deltas against the pre-run snapshot, like dispatches/coalesced
    rep.fused_counts = int(p.get("fused_counts", 0)
                           - pbase.get("fused_counts", 0))
    ring = p.get("ring") or {}
    ring_base = pbase.get("ring") or {}
    rep.ring_windows = int(ring.get("windows", 0) - ring_base.get("windows", 0))
    rep.ring_fallbacks = (sum((ring.get("fallbacks") or {}).values())
                          - sum((ring_base.get("fallbacks") or {}).values()))
    # per-window device interactions: the run's serve.device.ops delta
    # over its window count (pipelined windows when the pipeline ran, the
    # dispatch count on the serial stack)
    windows = rep.pipelined_windows or rep.dispatches
    if windows > 0:
        rep.dispatches_per_window = round(
            (device_ops_count() - ops_base) / windows, 3)
    return rep



def run_subscribe(
    store,
    type_name: str,
    make_batch: Callable[[int], object],
    subscriptions: int = 8,
    batches: int = 20,
    extent=(-60.0, 60.0),
    density_shape=(64, 32),
    seed: int = 0,
    manager=None,
) -> LoadReport:
    """Standing-query load mode: register N subscriptions (bbox geofences, dwithin geofences and a
    density window, cycling) over a live Kafka store, produce + poll M
    batches from `make_batch(i)`, and report pushed events/s plus the
    per-batch eval+push latency distribution (p99 is the line the
    standing-query workload is judged on). The evaluator's bounded
    dispatches are visible in the report: `dispatches` is one per lane
    class plus one fused call per folded batch."""
    from geomesa_tpu_torch.subscribe import DensityWindow, SubscriptionManager

    mgr = manager if manager is not None else SubscriptionManager(store)
    rng = np.random.default_rng(seed)
    geom = store.get_schema(type_name).default_geometry.name
    lo, hi = extent
    registered = []
    for i in range(subscriptions):
        kind = i % 3
        if kind == 0:
            x0 = float(rng.uniform(lo, hi - 30))
            y0 = float(rng.uniform(lo / 2, hi / 2 - 20))
            registered.append(mgr.subscribe(
                type_name,
                f"BBOX({geom}, {x0}, {y0}, {x0 + 30}, {y0 + 20})"))
        elif kind == 1:
            px = float(rng.uniform(lo / 2, hi / 2))
            py = float(rng.uniform(lo / 4, hi / 4))
            registered.append(mgr.subscribe(
                type_name,
                f"DWITHIN({geom}, POINT({px} {py}), 1500000, meters)"))
        else:
            w, h = density_shape
            registered.append(mgr.subscribe(type_name, density=DensityWindow(
                (lo, lo / 2, hi, hi / 2), w, h)))
    # warm fold OUTSIDE the measured window (the first delta's
    # allocations and the registration-time `state` snapshot frames):
    # the benchmark reports INCREMENTAL push throughput, not baseline
    # transfer
    store.write(type_name, make_batch(batches))
    mgr.poll_now()
    mgr.flush(lambda _f: None)
    frames: List[dict] = []
    lat_s: List[float] = []
    base = mgr.evaluator.stats()
    t_start = time.monotonic()
    for i in range(batches):
        store.write(type_name, make_batch(i))
        t0 = time.monotonic()
        mgr.poll_now()
        mgr.flush(frames.append)
        lat_s.append(time.monotonic() - t0)
    wall = time.monotonic() - t_start
    ev = mgr.evaluator.stats()
    # incremental events only: geofence transitions count per fid,
    # density folds per frame; lifecycle frames (state/lagged/...)
    # are bookkeeping, not workload output
    events = 0
    for f in frames:
        if f.get("event") in ("enter", "exit"):
            events += len(f.get("fids", ()))
        elif f.get("event") == "density":
            events += 1
    rep = _report("subscribe", wall, lat_s, batches, 0, 0, 0,
                  {"dispatches": ev.get("dispatches", 0)
                   - base.get("dispatches", 0), "coalesced": 0})
    rep.subscriptions = subscriptions
    rep.batches = batches
    rep.events_total = events
    rep.events_per_s = events / wall if wall > 0 else 0.0
    if manager is None:
        mgr.close()
    else:
        # caller-owned manager: cancel what THIS call registered, or
        # repeated runs accumulate 8 stale subs each — every
        # intervening poll pays fused evaluation for them until the
        # table bound rejects run ~32 with subscription_limit
        for s in registered:
            try:
                mgr.unsubscribe(s.sub_id)
            except KeyError:
                pass  # TTL-expired mid-run
    return rep


def run_subscribe_lanes(
    make_store,
    type_name: str,
    make_batch: Callable[[int], object],
    subscriptions: int = 1024,
    batches: int = 4,
    extent=(-60.0, 28.0, -30.0, 9.0),
    seed: int = 5,
    fused: bool = True,
    churn: bool = True,
) -> dict:
    """Lane-vs-fused comparison (docs/SERVING.md "Standing queries"):
    register S same-class bbox geofences on a FRESH store per mode
    (`make_store()`), then time the identical protocol under
    `SubscribeConfig(lanes=...)` both ways — first poll, `batches`
    steady polls, and optionally one membership-churn event (register +
    cancel + poll: a parameter-row write for lanes). Events are
    identical across modes by construction, so `speedup` is the
    lane/fused events-per-second ratio over matching windows.
    Subscriptions register BEFORE the seed batch lands: the empty-store
    bootstrap is then a bookkeeping write, keeping the first measured
    poll about evaluation, not baseline transfer. `fused=False` skips
    the fused leg (one mask per geofence: S-proportional work)."""
    from geomesa_tpu_torch.subscribe import SubscribeConfig, SubscriptionManager

    x_lo, x_hi, y_lo, y_hi = extent

    def _mode(lanes: bool) -> dict:
        store = make_store()
        mgr = SubscriptionManager(store, SubscribeConfig(
            max_subscriptions=subscriptions + 8, lanes=lanes))
        geom = store.get_schema(type_name).default_geometry.name
        rng = np.random.default_rng(seed)
        registered = []
        for _ in range(subscriptions):
            x0 = float(rng.uniform(x_lo, x_hi))
            y0 = float(rng.uniform(y_lo, y_hi))
            registered.append(mgr.subscribe(
                type_name,
                f"BBOX({geom}, {x0}, {y0}, {x0 + 2}, {y0 + 2})"))
        store.write(type_name, make_batch(10_001))
        frames: List[dict] = []
        base = mgr.evaluator.stats()
        polls = 0
        t_start = time.monotonic()
        mgr.poll_now()
        mgr.flush(frames.append)
        first_poll_s = time.monotonic() - t_start
        polls += 1
        for i in range(batches):
            store.write(type_name, make_batch(i))
            mgr.poll_now()
            mgr.flush(frames.append)
            polls += 1
        churn_poll_s = None
        if churn:
            x0 = float(rng.uniform(x_lo, x_hi))
            y0 = float(rng.uniform(y_lo, y_hi))
            mgr.subscribe(
                type_name,
                f"BBOX({geom}, {x0}, {y0}, {x0 + 2}, {y0 + 2})")
            mgr.unsubscribe(registered[0].sub_id)
            store.write(type_name, make_batch(batches))
            t0 = time.monotonic()
            mgr.poll_now()
            mgr.flush(frames.append)
            churn_poll_s = time.monotonic() - t0
            polls += 1
        wall = time.monotonic() - t_start
        ev = mgr.evaluator.stats()
        # enter/exit transitions only, as run_subscribe counts them —
        # registration-time `state` frames are bookkeeping, and on the
        # register-before-seed protocol they are empty anyway
        events = 0
        for f in frames:
            if f.get("event") in ("enter", "exit"):
                events += len(f.get("fids", ()))
        dispatches = ev.get("dispatches", 0) - base.get("dispatches", 0)
        out = {
            "mode": "lanes" if lanes else "fused",
            "polls": polls,
            "wall_s": round(wall, 3),
            "events_total": events,
            "events_per_s": round(events / wall, 1) if wall > 0 else 0.0,
            "dispatches": dispatches,
            "dispatches_per_poll":
                round(dispatches / polls, 3) if polls else 0.0,
            "lane_dispatches": ev.get("lane_dispatches", 0)
            - base.get("lane_dispatches", 0),
            "first_poll_s": round(first_poll_s, 3),
        }
        if churn_poll_s is not None:
            out["churn_poll_s"] = round(churn_poll_s, 3)
        mgr.close()
        return out

    lanes_rep = _mode(True)
    out = {
        "run": "subscribe_lanes",
        "subscriptions": subscriptions,
        "batches": batches,
        "lanes": lanes_rep,
        "fused": None,
    }
    if fused:
        fused_rep = _mode(False)
        out["fused"] = fused_rep
        if fused_rep["events_per_s"] > 0:
            out["speedup"] = round(
                lanes_rep["events_per_s"] / fused_rep["events_per_s"], 1)
    else:
        out["note"] = "fused leg skipped"
    return out


def knn_request_factory(type_name: str, cql: str, extent=(-60.0, 60.0),
                        k: int = 8, seed: int = 0,
                        **kw) -> Callable[[int], ServeRequest]:
    """Random single-point kNN requests sharing one (filter, k) — the
    maximally-coalescible serving workload. Points derive from the
    request index, so two runs offer identical work."""
    lo, hi = extent

    def make(i: int) -> ServeRequest:
        rng = np.random.default_rng(seed * 7_919 + i)
        req = ServeRequest(kind="knn", query=Query(type_name, cql), **kw)
        req.qx = rng.uniform(lo, hi, 1)
        req.qy = rng.uniform(lo, hi, 1)
        req.k = k
        return req

    return make


def count_request_factory(type_name: str, cqls: List[str],
                          **kw) -> Callable[[int], ServeRequest]:
    """Counts cycling through a fixed CQL set: coalescing dedups the
    repeats, distinct filters dispatch apart."""

    def make(i: int) -> ServeRequest:
        return ServeRequest(
            kind="count", query=Query(type_name, cqls[i % len(cqls)]), **kw)

    return make
