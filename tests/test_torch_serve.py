"""The port's serve stack (`geomesa_tpu_torch.serve`) against the
reference's `geomesa_tpu.serve`, case by case after tests/test_serve.py.

Both packages serve one catalog (600 rows written by the reference, the
port reading it on the CPU), each through its own QueryService on the
serial route (pipeline and ring off). Services are built with
autostart=False, given the whole request set, then started, so the
dispatcher's first window drains every compatible request and the
window count is ceil(N / max_batch) in both packages. Every service
closes in the fixture's teardown; every future is read with a timeout.

The pure cases (Histogram, the scheduler's units) run as one test
parametrised over both packages, so a slip in the copy shows.
"""

import dataclasses
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import geomesa_tpu.serve as rserve
import geomesa_tpu_torch.serve as pserve
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.audit import ServeEvent as RServeEvent
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.planner import QueryTimeout as RQueryTimeout
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.utils.metrics import Histogram as RHistogram
from geomesa_tpu.utils.metrics import metrics as rmetrics
from geomesa_tpu_torch.plan.audit import ServeEvent as PServeEvent
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.planner import QueryTimeout as PQueryTimeout
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.utils.metrics import Histogram as PHistogram
from geomesa_tpu_torch.utils.metrics import metrics as pmetrics

CQL = "BBOX(geom, -170, -80, 170, 80) AND score > -5"
N_ROWS = 600

PKG = {
    "ref": SimpleNamespace(
        serve=rserve, Histogram=RHistogram, metrics=rmetrics, Query=RQuery,
        QueryHints=RHints, QueryTimeout=RQueryTimeout,
        ServeEvent=RServeEvent),
    "port": SimpleNamespace(
        serve=pserve, Histogram=PHistogram, metrics=pmetrics, Query=PQuery,
        QueryHints=PHints, QueryTimeout=PQueryTimeout,
        ServeEvent=PServeEvent),
}


def make_rows(n=N_ROWS, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "name": rng.choice(["a", "b", "c"], n).tolist(),
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
        "geom": np.stack(
            [rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)], 1),
    }


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_serve"))
    rows = make_rows()
    sft = RSFT.from_spec("served", "name:String,score:Double,dtg:Date,*geom:Point")
    ref = RDataStore(root, use_device_cache=True)
    ref.create_schema(sft).write(RFB.from_pydict(sft, rows))
    port = PDataStore(root, use_device_cache=True, device="cpu")
    return {"ref": ref, "port": port, "rows": rows}


@pytest.fixture
def services():
    """make(pkg, store, **config) -> a stopped QueryService on the serial
    route; every one is closed at teardown."""
    made = []

    def make(pkg, store, autostart=False, **cfg):
        serve = PKG[pkg].serve
        config = serve.ServeConfig(pipeline=False, ring=False, **cfg)
        svc = serve.QueryService(store, config, autostart=autostart)
        made.append(svc)
        return svc

    yield make
    for svc in made:
        svc.close(drain=False, timeout_s=5.0)


def f64_count(rows, cql_score=-5.0):
    x, y = rows["geom"][:, 0], rows["geom"][:, 1]
    return int(((x >= -170) & (x <= 170) & (y >= -80) & (y <= 80)
                & (rows["score"] > cql_score)).sum())


def assert_same_knn(a, b):
    """Identical neighbour sets per query and bit-identical meters."""
    ad, ai, _ = a
    bd, bi, _ = b
    assert ad.shape == bd.shape and ai.dtype == bi.dtype
    for i in range(len(ad)):
        assert set(ai[i].tolist()) == set(bi[i].tolist()), i
    np.testing.assert_array_equal(np.sort(ad, 1), np.sort(bd, 1))


# -- pure cases: Histogram and the scheduler's units, both packages ---------


def _hist_counts_sum_quantiles(p):
    h = p.Histogram()
    for v in [0.001] * 50 + [0.004] * 45 + [0.3] * 5:
        h.update(v)
    assert h.count == 100
    assert h.sum == pytest.approx(0.05 + 0.18 + 1.5)
    assert h.quantile(0.5) <= 0.004
    assert h.quantile(0.99) >= 0.1
    snap = h.snapshot()
    assert snap["count"] == 100
    assert snap["p50_s"] <= snap["p95_s"] <= snap["p99_s"]


def _hist_empty_and_bounds(p):
    h = p.Histogram()
    assert h.quantile(0.99) == 0.0
    with pytest.raises(ValueError):
        h.quantile(1.5)
    with pytest.raises(ValueError):
        p.Histogram(buckets=[2.0, 1.0])


def _hist_overflow_clamps(p):
    h = p.Histogram(buckets=[0.001, 0.01])
    h.update(5.0)
    assert h.quantile(0.99) == 0.01


def _hist_merge(p):
    a, b = p.Histogram(), p.Histogram()
    for v in [0.001, 0.002]:
        a.update(v)
    for v in [0.004, 0.008, 0.016]:
        b.update(v)
    a.merge(b)
    assert a.count == 5
    assert a.sum == pytest.approx(0.031)
    with pytest.raises(ValueError):
        a.merge(p.Histogram(buckets=[1.0]))


def _hist_thread_safety(p):
    h = p.Histogram()

    def worker():
        for _ in range(2000):
            h.update(0.001)

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert h.count == 16000
    assert h.sum == pytest.approx(16.0, rel=1e-6)


def _hist_registry_exports(p):
    # a name of its own: the reference's tests/test_serve.py counts exactly
    # one update of "serve.test.latency" in the process-wide registry
    p.metrics.histogram("serve.parity.latency").update(0.012)
    prom = p.metrics.to_prometheus()
    assert "# TYPE serve_parity_latency_seconds histogram" in prom
    assert 'serve_parity_latency_seconds_bucket{le="+Inf"}' in prom
    for q in ("p50", "p95", "p99"):
        assert f"serve_parity_latency_seconds_{q} " in prom
    doc = json.loads(p.metrics.to_json())
    assert doc["histograms"]["serve.parity.latency"]["count"] >= 1


def _token_bucket(p):
    tb = p.serve.TokenBucket(rate=1000.0, burst=2.0)
    assert tb.try_acquire()
    assert tb.try_acquire()
    assert not tb.try_acquire()
    time.sleep(0.01)
    assert tb.try_acquire()


def _queue_bounded_and_priority_order(p):
    S, Q = p.serve.ServeRequest, p.Query
    q = p.serve.AdmissionQueue(max_depth=3)
    batch = S(kind="count", query=Q("t"), priority=2)
    normal = S(kind="count", query=Q("t"), priority=1)
    inter = S(kind="count", query=Q("t"), priority=0)
    q.put(batch)
    q.put(normal)
    q.put(inter)
    with pytest.raises(p.serve.QueryRejected) as ei:
        q.put(S(kind="count", query=Q("t")))
    assert ei.value.reason == "queue_full"
    assert q.pop(0.01) is inter
    assert q.pop(0.01) is normal
    assert q.pop(0.01) is batch
    assert q.pop(0.01) is None


def _drain_compatible_keeps_others(p):
    S, Q, key_fn = p.serve.ServeRequest, p.Query, p.serve.compat_key
    q = p.serve.AdmissionQueue(max_depth=10)
    a1 = S(kind="count", query=Q("t", "score > 0"))
    b = S(kind="count", query=Q("t", "score > 1"))
    a2 = S(kind="count", query=Q("t", "score>0"))
    for r in (a1, b, a2):
        q.put(r)
    got = q.drain_compatible(key_fn(a1), key_fn, limit=10)
    assert got == [a1, a2]
    assert q.pop(0.01) is b


def _cancelled_requests_skipped(p):
    S, Q = p.serve.ServeRequest, p.Query
    q = p.serve.AdmissionQueue(max_depth=4)
    a = S(kind="count", query=Q("t"))
    b = S(kind="count", query=Q("t"))
    q.put(a)
    q.put(b)
    assert a.cancel()
    assert q.pop(0.01) is b
    assert q.pop(0.01) is None


def _compat_keys(p):
    S, Q, key = p.serve.ServeRequest, p.Query, p.serve.compat_key

    def knn(cql, k=5, hints=None):
        r = S(kind="knn", query=Q("t", cql, hints=hints or p.QueryHints()))
        r.k = k
        return r

    assert key(knn("score > 0")) == key(knn("score>0"))
    assert key(knn("score > 0")) != key(knn("score > 1"))
    assert key(knn("score > 0", k=5)) != key(knn("score > 0", k=7))
    # hints are part of the key: a sampled query never aliases an exact one
    assert key(knn("score > 0", hints=p.QueryHints(sampling=4))) \
        != key(knn("score > 0"))
    e1 = S(kind="execute", query=Q("t", "score > 0"))
    c1 = S(kind="count", query=Q("t", "score > 0"))
    assert key(e1) != key(c1)


PURE = [_hist_counts_sum_quantiles, _hist_empty_and_bounds,
        _hist_overflow_clamps, _hist_merge, _hist_thread_safety,
        _hist_registry_exports, _token_bucket,
        _queue_bounded_and_priority_order, _drain_compatible_keeps_others,
        _cancelled_requests_skipped, _compat_keys]


@pytest.mark.parametrize("case", PURE, ids=[f.__name__[1:] for f in PURE])
@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_pure_cases(pkg, case):
    case(PKG[pkg])


# -- coalescing: served == serial, in each package and across them ---------


def knn_points(n, seed=42):
    return np.random.default_rng(seed).uniform(-60, 60, (n, 2))


def serve_knn(svc, pts, k, impl="sparse"):
    futs = [svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=k,
                    impl=impl) for i in range(len(pts))]
    svc.start()
    return [f.result(timeout=120) for f in futs]


@pytest.mark.parametrize("n_req", [10, 37, 70])
def test_coalesced_knn_equals_serial_and_reference(stores, services, n_req):
    """N single-point kNN requests in ceil(N/64) windows (a stacked Q
    padded to 16, 64 or 64+8) return what serial Q=1 calls return, in
    each package, and the two packages return the same neighbours and
    meters."""
    pts = knn_points(n_req)
    out = {}
    for pkg in ("ref", "port"):
        src = stores[pkg].get_feature_source("served")
        serial = [src.knn(CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=5)
                  for i in range(n_req)]
        svc = services(pkg, stores[pkg], max_wait_ms=20.0)
        served = serve_knn(svc, pts, k=5)
        svc.close(drain=True)
        for s, v in zip(serial, served):
            assert_same_knn(s, v)
        st = svc.stats()
        assert st["dispatches"] == -(-n_req // 64), st
        assert st["coalesced"] == n_req - st["dispatches"]
        out[pkg] = (served, st)
    for r, p in zip(out["ref"][0], out["port"][0]):
        assert_same_knn(r, p)
    assert out["ref"][1] == out["port"][1]


def test_fullscan_window_equals_reference(stores, services):
    pts = knn_points(12, seed=5)
    served = {}
    for pkg in ("ref", "port"):
        svc = services(pkg, stores[pkg])
        served[pkg] = serve_knn(svc, pts, k=7, impl="fullscan")
    for r, p in zip(served["ref"], served["port"]):
        assert_same_knn(r, p)


def test_count_dedup_single_dispatch(stores, services):
    counts = {}
    for pkg in ("ref", "port"):
        svc = services(pkg, stores[pkg])
        futs = [svc.count("served", CQL) for _ in range(6)]
        svc.start()
        counts[pkg] = [f.result(timeout=120) for f in futs]
        svc.close(drain=True)
        assert svc.stats()["dispatches"] == 1
    assert counts["port"] == counts["ref"] == [f64_count(stores["rows"])] * 6


def test_execute_rows_equal_reference(stores, services):
    """A feature execute submitted 4 times dispatches once; its rows equal
    the reference's served rows and the port's serial execute."""
    q = {"ref": RQuery("served", "score > 7", attributes=["score", "geom"],
                       sort_by=[("score", False)], max_features=20),
         "port": PQuery("served", "score > 7", attributes=["score", "geom"],
                        sort_by=[("score", False)], max_features=20)}
    got = {}
    for pkg in ("ref", "port"):
        svc = services(pkg, stores[pkg])
        futs = [svc.submit(PKG[pkg].serve.ServeRequest(kind="execute",
                                                        query=q[pkg]))
                for _ in range(4)]
        svc.start()
        res = [f.result(timeout=120) for f in futs]
        svc.close(drain=True)
        assert svc.stats()["dispatches"] == 1
        assert all(r is res[0] for r in res)  # one shared result object
        got[pkg] = res[0]
    serial = stores["port"].get_feature_source("served").get_features(q["port"])
    for r in (got["ref"], serial):
        assert r.kind == got["port"].kind == "features"
        a, b = r.features, got["port"].features
        assert len(a) == len(b) == 20
        np.testing.assert_array_equal(np.asarray(a.columns["score"]),
                                      np.asarray(b.columns["score"]))
        np.testing.assert_array_equal(a.geometry.x, b.geometry.x)


def test_stats_counters_equal_reference(stores, services):
    """A deterministic mixed run (kNN, counts, an execute, a cache hit)
    leaves the same stats() in both packages."""
    pts = knn_points(9, seed=11)
    snaps = {}
    for pkg in ("ref", "port"):
        svc = services(pkg, stores[pkg])
        futs = [svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=3)
                for i in range(9)]
        futs += [svc.count("served", "score > 2") for _ in range(3)]
        futs.append(svc.query("served", "score > 9"))
        svc.start()
        for f in futs:
            f.result(timeout=120)
        # the version-exact result cache answers a repeated count at
        # admission, with no dispatch
        assert svc.count("served", "score > 2").result(timeout=60) > 0
        svc.close(drain=True)
        snaps[pkg] = svc.stats()
    # the reference notes its filter compiles into its compile-stall
    # tracker; the port has none until ROADMAP A3 (b) (extension builds)
    assert "compile_stalled_dispatches" not in snaps["port"]
    snaps["ref"].pop("compile_stalled_dispatches", None)
    assert snaps["port"] == snaps["ref"]
    assert snaps["port"]["cache_hits"] == 1
    assert snaps["port"]["dispatches"] == 3


# -- admission: typed rejections and deadlines -----------------------------


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_overload_bounded_queue_typed_rejection(stores, services, pkg):
    p = PKG[pkg]
    svc = services(pkg, stores[pkg], max_queue=4)
    admitted = [svc.count("served", f"score > {i}") for i in range(4)]
    for i in range(6):
        with pytest.raises(p.serve.QueryRejected) as ei:
            svc.count("served", f"score > {10 + i}")
        assert ei.value.reason == "queue_full"
    assert len(svc.queue) == 4
    svc.start()
    for f in admitted:
        assert isinstance(f.result(timeout=120), int)
    svc.close(drain=True)
    assert svc.stats()["rejected"] == 6


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_deadline_expired_in_queue_raises_query_timeout(stores, services, pkg):
    svc = services(pkg, stores[pkg])
    fut = svc.count("served", CQL, timeout_ms=1)
    time.sleep(0.05)
    svc.start()
    with pytest.raises(PKG[pkg].QueryTimeout) as ei:
        fut.result(timeout=60)
    assert ei.value.phase == "queued"
    svc.close(drain=True)
    assert svc.stats()["timeout"] == 1


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tenant_rate_limit(stores, services, pkg):
    svc = services(pkg, stores[pkg], tenant_rate=0.001, tenant_burst=2)
    svc.count("served", CQL, tenant="tA")
    svc.count("served", CQL, tenant="tA")
    with pytest.raises(PKG[pkg].serve.QueryRejected) as ei:
        svc.count("served", CQL, tenant="tA")
    assert ei.value.reason == "rate_limited"
    svc.count("served", CQL, tenant="tB")  # a bucket per tenant


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_quarantine_rejects_poison_fingerprint(stores, services, pkg,
                                               monkeypatch):
    """Three crashing dispatches of one fingerprint quarantine it: the
    fourth is rejected typed at admission, other queries still run."""
    src = stores[pkg].get_feature_source("served")

    def boom(*a, **kw):
        raise RuntimeError("kernel crashed")

    svc = services(pkg, stores[pkg], autostart=True, quarantine_after=3,
                   result_cache=0)
    with monkeypatch.context() as m:
        m.setattr(src.planner, "count_result", boom)
        for _ in range(3):
            with pytest.raises(RuntimeError):
                svc.count("served", "score > 4").result(timeout=60)
        with pytest.raises(PKG[pkg].serve.QueryRejected) as ei:
            svc.count("served", "score > 4")
        assert ei.value.reason == "quarantined"
    assert svc.count("served", "score > 3").result(timeout=60) > 0
    st = svc.stats()
    assert st["quarantined"] == 1 and st["failed"] == 3


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_degradation_ladder(stores, services, pkg):
    svc = services(pkg, stores[pkg], max_queue=4, degrade=True,
                   degrade_watermark=0.5, shed_watermark=0.75)
    svc.count("served", "score > 1")
    svc.count("served", "score > 2")
    assert svc.degrade_level() == 1
    req = svc._request("count", PKG[pkg].Query("served", CQL),
                       allow_degraded=True)
    svc.submit(req)
    assert req.degraded and req.query.hints.loose_bbox
    assert req.sketch_rung == 0
    assert svc.degrade_level() == 2
    with pytest.raises(PKG[pkg].serve.QueryRejected) as ei:
        svc.count("served", "score > 3", priority="batch")
    assert ei.value.reason == "shed"
    svc.count("served", "score > 4", priority="interactive")
    svc.start()
    svc.close(drain=True)
    assert svc.stats()["degraded"] == 1


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_graceful_drain_and_shutdown_rejection(stores, services, pkg):
    svc = services(pkg, stores[pkg])
    futs = [svc.count("served", f"score > {i % 3}") for i in range(5)]
    svc.start()
    svc.close(drain=True)
    for f in futs:
        assert isinstance(f.result(timeout=1), int)
    with pytest.raises(PKG[pkg].serve.QueryRejected) as ei:
        svc.count("served", CQL)
    assert ei.value.reason == "shutting_down"


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_non_drain_close_rejects_queued(stores, services, pkg):
    svc = services(pkg, stores[pkg])
    fut = svc.count("served", CQL)
    svc.close(drain=False)
    with pytest.raises(PKG[pkg].serve.QueryRejected) as ei:
        fut.result(timeout=1)
    assert ei.value.reason == "shutting_down"


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_bad_type_name_fails_future_not_dispatcher(stores, services, pkg):
    svc = services(pkg, stores[pkg], autostart=True)
    bad = svc.count("no_such_type", "INCLUDE")
    with pytest.raises(Exception):
        bad.result(timeout=60)
    assert isinstance(svc.count("served", "score > 5").result(timeout=120), int)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_cancel_between_pop_and_execute_is_survivable(stores, services, pkg):
    svc = services(pkg, stores[pkg])
    req = svc._request("count", PKG[pkg].Query("served", CQL))
    svc.submit(req)
    assert req.cancel()
    svc.start()
    assert isinstance(svc.count("served", "score > 8").result(timeout=120), int)
    svc.close(drain=True)
    assert req.future.cancelled()


def test_serve_events_audited_with_reference_fields(stores, services):
    names = {pkg: [f.name for f in dataclasses.fields(PKG[pkg].ServeEvent)]
             for pkg in PKG}
    assert names["port"] == names["ref"]
    for pkg in ("ref", "port"):
        store = stores[pkg]
        base = len(store.audit.events)
        svc = services(pkg, store)
        futs = [svc.count("served", "score > 6") for _ in range(3)]
        svc.start()
        for f in futs:
            f.result(timeout=120)
        svc.close(drain=True)
        events = [e for e in store.audit.events[base:]
                  if isinstance(e, PKG[pkg].ServeEvent)]
        assert len(events) == 3
        assert all(e.status == "ok" and e.batch_size == 3 and e.kind == "count"
                   and e.priority == "normal" and not e.pipelined
                   for e in events)
        assert all(e.queue_ms >= 0 and e.exec_ms >= 0 and e.timestamp > 0
                   for e in events)


def test_latency_histograms_exported(stores, services):
    svc = services("port", stores["port"], autostart=True)
    svc.count("served", "score > 7").result(timeout=120)
    svc.close(drain=True)
    svc.export_gauges()
    prom = pmetrics.to_prometheus()
    for family in ("serve_latency_seconds", "serve_queue_wait_seconds"):
        assert f"# TYPE {family} histogram" in prom
        assert f'{family}_bucket{{le="+Inf"}}' in prom
        for q in ("p50", "p95", "p99"):
            assert f"{family}_{q} " in prom
    assert "serve_inflight" in prom


# -- options of later slices refuse typed ----------------------------------


@pytest.mark.parametrize("option, item", [
    ({"mesh": "auto"}, "A7"),
    ({"slo": {"objectives": []}}, "A8"), ({"profile": True}, "A8"),
    ({"subscribe_max": 16}, "A6"),
    ({"subscribe_outbox": 64}, "A6"), ({"subscribe_rate": 5.0}, "A6"),
    ({"subscribe_poll_ms": 10.0}, "A6"),
    ({"approx_degrade_tolerance": 0.2}, None)])
def test_later_options_raise_not_ported(stores, option, item):
    """Every option of a later slice is ported now (the name is kept from
    when they were not): the sketch rung's tolerance (item None), the
    standing queries' bounds (A6) and the profiler's switch (A8) construct
    and carry the value; the serving mesh (A7: "auto" on a host without
    two cards) resolves to no mesh, as the reference's does on one
    device; an SLO spec without objectives (A8) refuses with the
    reference's ValueError."""
    if "slo" in option:
        for pkg in ("ref", "port"):
            with pytest.raises(ValueError, match="no \\[objective"):
                PKG[pkg].serve.QueryService(
                    stores[pkg], PKG[pkg].serve.ServeConfig(**option),
                    autostart=False)
        return
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(**option),
                              autostart=False)
    (name, value), = option.items()
    assert getattr(svc.config, name) == value
    if item == "A7":
        assert svc.mesh is None
        from geomesa_tpu.parallel.mesh import serve_mesh as rserve_mesh

        assert rserve_mesh("auto", devices=["only-one"]) is None
    if name == "profile":
        from geomesa_tpu_torch.telemetry.prof import PROFILER

        assert PROFILER.enabled
        PROFILER.disable()
    svc.close()


def test_warmup_methods_raise_not_ported(stores, services):
    """The warm-up methods are ported (tests/test_torch_compilecache.py
    holds them to the reference), and so is the serving mesh's shard
    affinity (A7): off a mesh, and for a source without a planner, both
    packages answer ()."""
    svc = services("port", stores["port"])
    rec = svc.record_warmup()
    assert svc.warmup(rec.manifest()).ok
    out = {}
    for tag, pkg, store in (("ref", rserve, stores["ref"]),
                            ("port", pserve, stores["port"])):
        req = pkg.ServeRequest(kind="count",
                               query=PKG[tag].Query("served", CQL))
        src = store.get_feature_source("served")
        out[tag] = (pkg.scheduler.shard_affinity(src, req),
                    pkg.scheduler.shard_affinity(None, req))
    assert out["port"] == out["ref"] == ((), ())


def test_config_keeps_reference_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(rserve.ServeConfig)}
    port = {f.name: f.default for f in dataclasses.fields(pserve.ServeConfig)}
    assert list(port) == list(ref)
    assert {k for k in ref if port[k] != ref[k]} == set()


# -- load generator --------------------------------------------------------


def test_load_modes_on_the_port(stores, services):
    """Closed loop with a fixed request count, sustained with a request
    cap, and a short open loop: every request is accounted for and the
    kNN windows coalesce."""
    svc = services("port", stores["port"], autostart=True, max_wait_ms=5.0)
    make = pserve.knn_request_factory("served", CQL, k=4)
    rep = pserve.run_closed_loop(svc, make, concurrency=4,
                                 requests_per_client=5)
    assert rep.sent == rep.ok == 20 and rep.errors == 0
    assert 0 < rep.dispatches <= 20 and rep.p50_ms <= rep.p99_ms
    rep = pserve.run_sustained(svc, make, max_outstanding=16, requests=48,
                               points_per_query=N_ROWS, duration_s=60.0)
    assert rep.sent == rep.ok == 48
    assert rep.dispatches < 48  # 16 outstanding coalesce
    assert rep.pts_per_s == pytest.approx(rep.throughput_qps * N_ROWS)
    assert rep.dispatches_per_window >= 3  # mask, launch, read
    rep = pserve.run_open_loop(
        svc, pserve.count_request_factory("served", ["score > 1", "score > 2"]),
        rate_qps=100.0, duration_s=0.3)
    assert rep.sent == rep.ok + rep.rejected + rep.timeouts + rep.errors
    assert rep.ok > 0 and rep.to_json()["mode"] == "open"
