"""The port's persistent serve loop (`geomesa_tpu_torch.serve.ringloop`
and the planner's ring tier) against the reference's, after
tests/test_ringloop.py.

One catalog (600 rows written by the reference) serves both packages on
the CPU; cases that write get a catalog each, written by each package
from the same seeded rows. Rule: within a package the ring, pipelined
and serial routes are bit-identical; across packages neighbour sets are
equal (equal-distance swaps allowed) and meters bit-identical. On a CPU
store the ring runs its frozen body without a CUDA graph; the
`cuda`-marked cases at the end replay the graphs on the card and skip
here.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu.serve as rserve
import geomesa_tpu_torch.serve as pserve
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu_torch.compilecache.registry import registry
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.errors import (
    GraphCaptureError, KernelBuildError, KernelLaunchError)
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.serve.loadgen import device_ops_count
from geomesa_tpu_torch.serve.ringloop import RingLoop
from geomesa_tpu_torch.utils.metrics import metrics as pmetrics

CQL = "BBOX(geom, -170, -80, 170, 80) AND score > -5"
WINDOWS = 18  # >= 16 consecutive ring windows (the acceptance floor)
SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
SERVE = {"ref": rserve, "port": pserve}


def make_rows(n=600, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "name": rng.choice(["a", "b", "c"], n).tolist(),
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
        "geom": np.stack([rng.uniform(-170, 170, n),
                          rng.uniform(-80, 80, n)], 1)}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_ringloop"))
    sft = RSFT.from_spec("served", SPEC)
    ref = RDataStore(root, use_device_cache=True)
    ref.create_schema(sft).write(RFB.from_pydict(sft, make_rows()))
    return {"ref": ref,
            "port": PDataStore(root, use_device_cache=True, device="cpu")}


@pytest.fixture(scope="module")
def qpts():
    return np.random.default_rng(42).uniform(-60, 60, (WINDOWS + 4, 2))


def fresh_stores(tmp_path, n, seed):
    """A catalog a package, each written by its package from one seed."""
    rows = make_rows(n, seed)
    rs = RSFT.from_spec("served", SPEC)
    ref = RDataStore(str(tmp_path / "ref"), use_device_cache=True)
    rsrc = ref.create_schema(rs)
    rsrc.write(RFB.from_pydict(rs, rows))
    ps = PSFT.from_spec("served", SPEC)
    port = PDataStore(str(tmp_path / "port"), use_device_cache=True,
                      device="cpu")
    psrc = port.create_schema(ps)
    psrc.write(PFB.from_pydict(ps, rows))
    return {"ref": (ref, rsrc), "port": (port, psrc)}


def sequential(pkg, store, qpts, svc=None, lo=0, hi=WINDOWS, **cfg):
    """`hi - lo` consecutive single-request windows (each resolves before
    the next submits: the steady serve shape the ring exists for).
    Returns (results, pipeline stats)."""
    serve = SERVE[pkg]
    own = svc is None
    if own:
        svc = serve.QueryService(store, serve.ServeConfig(max_wait_ms=1.0, **cfg))
    try:
        out = [svc.knn("served", CQL, qpts[i:i + 1, 0], qpts[i:i + 1, 1],
                       k=5).result(timeout=300) for i in range(lo, hi)]
        return out, svc.stats()["pipeline"]
    finally:
        if own:
            svc.close(drain=True)


def assert_identical(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def assert_same_knn(a, b):
    ad, ai, _ = a
    bd, bi, _ = b
    for i in range(len(ad)):
        assert set(ai[i].tolist()) == set(bi[i].tolist()), i
    np.testing.assert_array_equal(np.sort(ad, 1), np.sort(bd, 1))


def test_ring_bit_identical_to_serial_and_pipelined(stores, qpts):
    """Acceptance: 18 consecutive windows, ring vs serial vs ring-off
    pipelined, identical bits in each package, every window on ONE armed
    program with no fallback; the port's equal the reference's."""
    got = {}
    for pkg in ("ref", "port"):
        src = stores[pkg].get_feature_source("served")
        Query = RQuery if pkg == "ref" else PQuery
        serial = [src.planner.knn(Query("served", CQL), qpts[i:i + 1, 0],
                                  qpts[i:i + 1, 1], k=5)
                  for i in range(WINDOWS)]
        ring, ring_p = sequential(pkg, stores[pkg], qpts)
        pipe, pipe_p = sequential(pkg, stores[pkg], qpts, ring=False)
        for i in range(WINDOWS):
            assert_identical(ring[i], serial[i])
            assert_identical(pipe[i], serial[i])
        r = ring_p["ring"]
        assert r["windows"] == WINDOWS and r["armed"] == 1
        assert r["programs"] == 1 and r["fallbacks"] == {}
        assert "ring" not in pipe_p
        got[pkg] = ring
    for a, b in zip(got["port"], got["ref"]):
        assert_same_knn(a, b)


def test_fused_count_rider_resolves_from_armed_scalar(stores):
    """COUNT riders on a ring window resolve from the arm-time mask
    reduction: equal to planner.count and to the reference's riders."""
    pts = np.random.default_rng(7).uniform(-60, 60, (5, 2))
    counts = {}
    for pkg in ("ref", "port"):
        serve = SERVE[pkg]
        svc = serve.QueryService(stores[pkg], serve.ServeConfig(
            max_wait_ms=50.0), autostart=False)
        warm = svc.knn("served", CQL, pts[0:1, 0], pts[0:1, 1], k=5)
        svc.start()
        warm.result(timeout=300)
        futs = [svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=5)
                for i in range(1, 4)]
        cfuts = [svc.count("served", CQL) for _ in range(3)]
        for f in futs:
            f.result(timeout=300)
        counts[pkg] = [f.result(timeout=300) for f in cfuts]
        st = svc.stats()["pipeline"]
        svc.close(drain=True)
        assert st["fused_counts"] >= 1 and st["ring"]["windows"] >= 1
    exact = stores["port"].get_feature_source("served").get_count(CQL)
    assert counts["port"] == counts["ref"] == [exact] * 3


def test_no_capture_after_the_first_window(stores, qpts):
    """The compile tracker over the post-arm run: the ring window class is
    captured once (on the first window, or before it by an earlier arm)
    and never again."""
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(
        max_wait_ms=1.0, track_compiles=True))
    try:
        sequential("port", None, qpts, svc=svc, lo=0, hi=2)
        base = svc.tracker.total_recompiles()
        sequential("port", None, qpts, svc=svc, lo=2, hi=WINDOWS)
        assert svc.tracker.total_recompiles() == base
        ring = svc.stats()["pipeline"]["ring"]
        assert ring["windows"] == WINDOWS and ring["armed"] == 1
    finally:
        svc.close(drain=True)


def test_dispatches_per_window_below_pipelined(stores, qpts):
    """The per-window device interactions (serve.device.ops delta over
    windows) on the ring are below the pipelined route's, in both
    packages."""
    for pkg in ("ref", "port"):
        serve = SERVE[pkg]
        ops = (device_ops_count if pkg == "port"
               else rserve.loadgen.device_ops_count)

        def measured(**cfg):
            svc = serve.QueryService(stores[pkg], serve.ServeConfig(
                max_wait_ms=1.0, **cfg))
            try:
                sequential(pkg, None, qpts, svc=svc, lo=0, hi=2)
                o0 = ops()
                sequential(pkg, None, qpts, svc=svc, lo=2, hi=WINDOWS)
                return (ops() - o0) / (WINDOWS - 2)
            finally:
                svc.close(drain=True)

        ring_pw, pipe_pw = measured(), measured(ring=False)
        assert ring_pw < pipe_pw, (pkg, ring_pw, pipe_pw)
        if pkg == "port":
            assert ring_pw == 3  # slot write, replay, readback


def test_sustained_loadgen_reports_ring_fields(stores):
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(max_wait_ms=1.0))
    try:
        rep = pserve.run_sustained(
            svc, pserve.knn_request_factory("served", CQL, k=5),
            duration_s=30.0, max_outstanding=4, points_per_query=600,
            requests=10)
    finally:
        svc.close(drain=True)
    assert rep.ok == 10 and rep.errors == 0
    assert rep.ring_windows >= 1 and rep.ring_fallbacks == 0
    assert rep.dispatches_per_window > 0
    doc = rep.to_json()
    assert doc["ring_windows"] == rep.ring_windows
    assert doc["dispatches_per_window"] == rep.dispatches_per_window


def test_write_goes_stale_then_rearms_fresh(tmp_path):
    """A committed write makes the armed program stale: the next window
    takes the pipelined route (the new rows visible) and the one after
    re-arms; every answer equals the serial one over the grown store, in
    both packages, and the port's equal the reference's."""
    st = fresh_stores(tmp_path, 300, 11)
    pts = np.random.default_rng(5).uniform(-60, 60, (8, 2))
    more = make_rows(200, 13)
    got = {}
    for pkg in ("ref", "port"):
        ds, src = st[pkg]
        serve = SERVE[pkg]
        svc = serve.QueryService(ds, serve.ServeConfig(max_wait_ms=1.0))
        try:
            for i in range(4):
                svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1],
                        k=5).result(timeout=300)
            st0 = svc.stats()["pipeline"]["ring"]
            batch = (RFB if pkg == "ref" else PFB).from_pydict(src.sft, more)
            src.write(batch)
            res = []
            for i in range(4, 8):
                res.append(svc.knn("served", CQL, pts[i:i + 1, 0],
                                   pts[i:i + 1, 1], k=5).result(timeout=300))
                if i == 4:
                    st1 = svc.stats()["pipeline"]["ring"]
            st2 = svc.stats()["pipeline"]["ring"]
        finally:
            svc.close(drain=True)
        assert st0["windows"] == 4 and st0["fallbacks"] == {}
        assert st1["fallbacks"] == {"stale": 1} and st1["windows"] == 4
        assert st2["armed"] == st0["armed"] + 1 and st2["windows"] == 7
        Query = RQuery if pkg == "ref" else PQuery
        for j, i in enumerate(range(4, 8)):
            assert_identical(res[j], src.planner.knn(
                Query("served", CQL), pts[i:i + 1, 0], pts[i:i + 1, 1], k=5))
        got[pkg] = res
    for a, b in zip(got["port"], got["ref"]):
        assert_same_knn(a, b)


def test_slot_write_oom_runs_the_halving_ladder(stores, monkeypatch):
    """An OOM on the ring's slot write halves the coalesced window and
    re-runs from the HOST query copies: every rider exact, like a
    pipelined window."""
    pts = np.random.default_rng(3).uniform(-60, 60, (6, 2))
    src = stores["port"].get_feature_source("served")
    serial = [src.knn(CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=5)
              for i in range(6)]
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(
        max_wait_ms=50.0), autostart=False)
    warm = svc.knn("served", CQL, pts[0:1, 0], pts[0:1, 1], k=5)
    svc.start()
    warm.result(timeout=300)
    stager = svc.pipeline.ring.stager(src.planner.device)
    real = stager.stage
    calls = []

    def stage_once_oom(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("injected: slot write")
        return real(*a, **kw)

    monkeypatch.setattr(stager, "stage", stage_once_oom)
    with pmetrics._lock:
        halved = pmetrics.counters.get("serve.oom.halved", 0)
    futs = [svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=5)
            for i in range(6)]
    try:
        results = [f.result(timeout=300) for f in futs]
    finally:
        svc.close(drain=True)
    for a, b in zip(results, serial):
        assert_identical(a, b)
    with pmetrics._lock:
        assert pmetrics.counters.get("serve.oom.halved", 0) > halved


def test_refusal_cache_keyed_by_manifest_version(tmp_path, monkeypatch):
    """A store without a device cache is refused (no_device_cache) once
    per manifest version: the next windows hit the refusal cache without
    a new arm, and a write (a new version) arms again."""
    rows = make_rows(300, 21)
    ps = PSFT.from_spec("served", SPEC)
    ds = PDataStore(str(tmp_path), use_device_cache=False, device="cpu")
    src = ds.create_schema(ps)
    src.write(PFB.from_pydict(ps, rows))
    arms = []
    real = src.planner.ring_arm

    def counting(*a, **kw):
        arms.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(src.planner, "ring_arm", counting)
    pts = np.random.default_rng(2).uniform(-60, 60, (6, 2))
    svc = pserve.QueryService(ds, pserve.ServeConfig(max_wait_ms=1.0))
    try:
        res = [svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1],
                       k=5).result(timeout=300) for i in range(3)]
        assert len(arms) == 1
        src.write(PFB.from_pydict(ps, make_rows(50, 22)))
        res += [svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1],
                        k=5).result(timeout=300) for i in range(3, 6)]
        ring = svc.stats()["pipeline"]["ring"]
    finally:
        svc.close(drain=True)
    assert len(arms) == 2
    assert ring["fallbacks"] == {"no_device_cache": 6} and ring["windows"] == 0
    for i in range(3, 6):
        assert_identical(res[i], src.knn(CQL, pts[i:i + 1, 0], pts[i:i + 1, 1],
                                         k=5))


def test_lru_eviction_at_max_programs(stores, monkeypatch):
    """Past MAX_PROGRAMS the least recently fed program goes: three
    window classes (k = 3, 4, 5) through a table of two."""
    monkeypatch.setattr(RingLoop, "MAX_PROGRAMS", 2)
    pts = np.random.default_rng(4).uniform(-60, 60, (4, 2))
    src = stores["port"].get_feature_source("served")
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(max_wait_ms=1.0))
    try:
        for k in (3, 4, 5, 3):
            got = svc.knn("served", CQL, pts[0:1, 0], pts[0:1, 1],
                          k=k).result(timeout=300)
            assert_identical(got, src.knn(CQL, pts[0:1, 0], pts[0:1, 1], k=k))
        ring = svc.stats()["pipeline"]["ring"]
    finally:
        svc.close(drain=True)
    # k=3 was evicted by k=5 and armed again
    assert ring["programs"] == 2 and ring["armed"] == 4 and ring["windows"] == 4


def test_drain_close_harvests_every_window_once(stores, qpts):
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(max_wait_ms=1.0))
    futs = [svc.knn("served", CQL, qpts[i:i + 1, 0], qpts[i:i + 1, 1], k=5)
            for i in range(8)]
    svc.close(drain=True)
    assert all(f.done() for f in futs)
    for f in futs:
        d, ix, _ = f.result(timeout=1)
        assert d.shape == (1, 5) and ix.shape == (1, 5)
    assert svc.stats()["pipeline"]["inflight"] == 0


# -- failures on a card store fail the window typed -------------------------


def failing(exc):
    def fn(*a, **kw):
        raise exc
    return fn


@pytest.mark.parametrize("where, exc", [
    ("capture", GraphCaptureError("injected: capture")),
    ("build", KernelBuildError("injected: nvcc failed")),
    ("launch", KernelLaunchError("injected: CUDA error 700"))])
def test_ring_failure_fails_the_window_typed(stores, monkeypatch, where, exc):
    """A failed capture, extension build or kernel launch on the ring
    fails every member with that error: the window is never answered by
    the pipelined route, the plain version or the host."""
    from geomesa_tpu_torch.plan import planner as pplanner

    registry.clear()
    if where == "capture":
        monkeypatch.setattr(registry, "ring_capture", failing(exc))
    else:  # the body a graph runs: its B1 launch builds and launches
        monkeypatch.setattr(pplanner, "knn_sparse_body", failing(exc))
    src = stores["port"].get_feature_source("served")
    launches = []
    monkeypatch.setattr(src.planner, "knn_launch",
                        lambda *a, **kw: launches.append(1))
    with pmetrics._lock:
        host0 = pmetrics.counters.get("serve.oom.hosteval", 0)
    pts = np.random.default_rng(6).uniform(-60, 60, (4, 2))
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(
        max_wait_ms=50.0), autostart=False)
    futs = [svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=5)
            for i in range(4)]
    svc.start()
    try:
        errs = [f.exception(timeout=60) for f in futs]
    finally:
        svc.close(drain=True)
    assert all(e is exc for e in errs), errs
    assert launches == []  # no pipelined launch answered the window
    st = svc.stats()
    assert st["pipeline"]["ring"]["fallbacks"] == {} and st["failed"] == 4
    with pmetrics._lock:
        assert pmetrics.counters.get("serve.oom.hosteval", 0) == host0
    registry.clear()


def test_pipelined_launch_failure_fails_the_window_typed(stores, monkeypatch):
    """The same on the pipelined route: a launch error fans out typed,
    with no serial re-run and no host evaluation."""
    src = stores["port"].get_feature_source("served")
    exc = KernelLaunchError("injected: CUDA error 700")
    calls = []

    def launch(*a, **kw):
        calls.append(1)
        raise exc

    monkeypatch.setattr(src.planner, "knn_launch", launch)
    pts = np.random.default_rng(8).uniform(-60, 60, (4, 2))
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(
        max_wait_ms=50.0, ring=False), autostart=False)
    futs = [svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=5)
            for i in range(4)]
    svc.start()
    try:
        assert all(f.exception(timeout=60) is exc for f in futs)
    finally:
        svc.close(drain=True)
    assert calls == [1]


def loose_request(pkg, cql, x, y, loose: bool):
    """One kNN request of `cql` with the loose-bbox hint set or not."""
    if pkg == "ref":
        from geomesa_tpu.plan.hints import QueryHints
        from geomesa_tpu.serve.scheduler import ServeRequest
        query = RQuery("served", cql, hints=QueryHints(loose_bbox=loose))
    else:
        from geomesa_tpu_torch.plan.hints import QueryHints
        from geomesa_tpu_torch.serve.scheduler import ServeRequest
        query = PQuery("served", cql, hints=QueryHints(loose_bbox=loose))
    return ServeRequest(kind="knn", query=query, qx=np.array([x]),
                        qy=np.array([y]), k=5), query


def test_loose_bbox_class_has_its_own_capture(stores):
    """One CQL with loose bbox off, then on, through one ring: the loose
    class drops the BBOX from its residual, so its mask differs and it
    must not replay the strict class's capture. Every window equals its
    class's serial answer (and the port's equal the reference's); the
    two classes answer differently for a point outside the box."""
    cql = "BBOX(geom, -20, -20, 20, 20) AND score > -5"
    pts = [(100.0, 50.0), (-120.0, -40.0), (5.0, 5.0)]
    got = {}
    for pkg in ("ref", "port"):
        serve = SERVE[pkg]
        src = stores[pkg].get_feature_source("served")
        svc = serve.QueryService(stores[pkg], serve.ServeConfig(max_wait_ms=1.0))
        try:
            for loose in (False, True, False, True):
                for x, y in pts:
                    req, query = loose_request(pkg, cql, x, y, loose)
                    res = svc.submit(req).result(timeout=300)
                    assert_identical(res, src.planner.knn(
                        query, np.array([x]), np.array([y]), k=5))
                    got[(pkg, loose, x)] = res
            ring = svc.stats()["pipeline"]["ring"]
        finally:
            svc.close(drain=True)
        assert ring["armed"] == 2 and ring["programs"] == 2, ring
        assert ring["fallbacks"] == {} and ring["windows"] == 4 * len(pts)
        x = pts[0][0]
        assert not np.array_equal(got[(pkg, False, x)][1], got[(pkg, True, x)][1])
    for key in [k for k in got if k[0] == "port"]:
        assert_same_knn(got[key], got[("ref",) + key[1:]])


def test_class_captures_share_frozen_inputs(stores):
    """Captures of one window class over one superbatch (other Q buckets,
    k or impl) share its frozen mask and padded columns; another class
    (the loose residual) freezes its own. held_bytes counts each storage
    once."""
    from geomesa_tpu_torch.plan.hints import QueryHints

    registry.clear()
    planner = stores["port"].get_feature_source("served").planner
    q = PQuery("served", CQL)
    a = planner.ring_arm(q, q_padded=8, k=5)
    held = registry.stats()["held_bytes"]
    b = planner.ring_arm(q, q_padded=16, k=7)
    c = planner.ring_arm(q, q_padded=8, k=5, impl="fullscan")
    assert len({id(a.capture), id(b.capture), id(c.capture)}) == 3
    assert a.capture.frozen is b.capture.frozen is c.capture.frozen
    frozen_bytes = sum(a.capture.frozen[n].untyped_storage().nbytes()
                       for n in ("mask", "maskf"))
    assert registry.stats()["held_bytes"] - held < frozen_bytes
    loose = PQuery("served", CQL, hints=QueryHints(loose_bbox=True))
    d = planner.ring_arm(loose, q_padded=8, k=5)
    assert d.capture is not a.capture
    assert d.capture.frozen is not a.capture.frozen
    assert registry.stats()["entries"] == 4
    registry.clear()


def test_last_closed_service_drops_its_captures(stores, qpts):
    """A planner's captures stay while a ring loop serves from them and
    go when the last one closes."""
    registry.clear()
    planner = stores["port"].get_feature_source("served").planner
    mine = lambda: [c for c in registry.held()  # noqa: E731
                    if c.owner_id == id(planner)]
    cfg = pserve.ServeConfig(max_wait_ms=1.0)
    one = pserve.QueryService(stores["port"], cfg)
    two = pserve.QueryService(stores["port"], cfg)
    try:
        sequential("port", None, qpts, svc=one, lo=0, hi=2)
        sequential("port", None, qpts, svc=two, lo=0, hi=2)
        assert len(mine()) == 1
    finally:
        one.close(drain=True)
    try:
        assert len(mine()) == 1  # `two` still serves from it
    finally:
        two.close(drain=True)
    assert mine() == []


def test_collected_planner_drops_its_captures(tmp_path):
    """Captures armed on a store that is then discarded (no service ever
    closed over them) go when its planner is collected."""
    import gc

    st = fresh_stores(tmp_path, 200, 17)
    ds, src = st["port"]
    prog = src.planner.ring_arm(PQuery("served", CQL), q_padded=8, k=5)
    oid = prog.capture.owner_id
    assert any(c.owner_id == oid for c in registry.held())
    del prog, src, st, ds
    gc.collect()
    assert not any(c.owner_id == oid for c in registry.held())


def test_profiler_seen_from_any_thread():
    """A capture on the dispatch thread must see a profiler that the main
    thread started (registry.profiler_active reads the process's flag)."""
    import threading

    from geomesa_tpu_torch.compilecache.registry import profiler_active

    seen = []
    assert not profiler_active()
    with torch.profiler.profile():
        t = threading.Thread(target=lambda: seen.append(profiler_active()))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [True] and not profiler_active()


# -- on the card: graph replays ---------------------------------------------


@pytest.fixture
def card_store(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ring's CUDA graphs replay there")
    rows = make_rows(1 << 16, 31)
    ps = PSFT.from_spec("served", SPEC)
    ds = PDataStore(str(tmp_path), use_device_cache=True, device="cuda")
    src = ds.create_schema(ps)
    src.write(PFB.from_pydict(ps, rows))
    return ds, src


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["sparse", "fullscan"])
def test_graph_replay_equals_pipelined_launch(card_store, impl):
    """Every window replayed from a captured graph equals the pipelined
    launch and the serial call, bit for bit."""
    from geomesa_tpu_torch.engine import knn_scan as ks

    ds, src = card_store
    pts = np.random.default_rng(1).uniform(-60, 60, (WINDOWS, 2))
    wrapper = ks.chord_blockmin_sparse if impl == "sparse" else ks.chord_blockmin
    out = {}
    for route, cfg in (("pipelined", dict(ring=False)), ("ring", {})):
        svc = pserve.QueryService(ds, pserve.ServeConfig(max_wait_ms=1.0, **cfg))
        try:
            before = wrapper.launches
            out[route] = [svc.knn("served", CQL, pts[i:i + 1, 0],
                                  pts[i:i + 1, 1], k=5, impl=impl
                                  ).result(timeout=300)
                          for i in range(WINDOWS)]
            launches = wrapper.launches - before
            st = svc.stats()["pipeline"]
        finally:
            svc.close(drain=True)
        assert launches == WINDOWS, (route, launches)  # one a window
    assert st["ring"]["windows"] == WINDOWS
    for i in range(WINDOWS):
        assert_identical(out["ring"][i], out["pipelined"][i])
        assert_identical(out["ring"][i], src.knn(
            CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=5, impl=impl))


@pytest.mark.cuda
def test_slot_outputs_survive_a_full_rotation(card_store):
    """Ring depth 2, windows in flight up to the pipeline's depth 2 and
    more windows than slots: each window's answer is its own (its slot's
    outputs were read back before the slot came round)."""
    ds, src = card_store
    pts = np.random.default_rng(2).uniform(-60, 60, (24, 2))
    svc = pserve.QueryService(ds, pserve.ServeConfig(
        max_wait_ms=0.0, max_batch=1, ring_depth=2), autostart=False)
    futs = [svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=5)
            for i in range(24)]
    svc.start()
    try:
        got = [f.result(timeout=300) for f in futs]
        st = svc.stats()["pipeline"]
    finally:
        svc.close(drain=True)
    assert st["ring"]["windows"] == 24 and st["ring"]["depth"] == 2
    for i in range(24):
        assert_identical(got[i], src.knn(CQL, pts[i:i + 1, 0],
                                         pts[i:i + 1, 1], k=5))


@pytest.mark.cuda
def test_capture_under_profiler_is_refused_typed(card_store):
    """Arming a new window class while torch.profiler traces the card
    raises GraphCaptureError instead of capturing (which crashes)."""
    ds, src = card_store
    registry.clear()
    with torch.profiler.profile():
        with pytest.raises(GraphCaptureError, match="profiler"):
            src.planner.ring_arm(PQuery("served", CQL), q_padded=8, k=5)
    prog = src.planner.ring_arm(PQuery("served", CQL), q_padded=8, k=5)
    assert len(prog.capture.graphs) == prog.depth
