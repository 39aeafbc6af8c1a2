"""The port's compile management (`geomesa_tpu_torch.compilecache`)
against the reference's, after tests/test_compilecache.py.

The reference records and replays jit signatures; the port records the
kernel libraries it builds and the ring classes it captures (kernel
entries of another shape), and the query entries both packages record
for one workload are the same. The whole contract runs on the CPU: a
ring window class on a CPU store is a capture without a graph, so the
first window pays it (its ServeEvents carry the stall), a warm-up replay
pays it instead, and a check replays a second time with no new build
and no new capture. The stall meter's cases run over both packages.
"""

import json

import numpy as np
import pytest

import geomesa_tpu.compilecache.stall as rstall
import geomesa_tpu.serve as rserve
import geomesa_tpu_torch.compilecache.stall as pstall
import geomesa_tpu_torch.serve as pserve
from geomesa_tpu.compilecache.manifest import WarmupRecorder as RRecorder
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu_torch.compilecache import warmup as pwarmup
from geomesa_tpu_torch.compilecache.manifest import (
    KernelEntry, QueryEntry, WarmupManifest, WarmupRecorder)
from geomesa_tpu_torch.compilecache.registry import registry
from geomesa_tpu_torch.plan.audit import ServeEvent
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.utils.metrics import metrics as pmetrics

CQL = "BBOX(geom, -170, -80, 170, 80) AND score > -5"


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_compilecache"))
    rng = np.random.default_rng(3)
    n = 600
    sft = RSFT.from_spec("served", "name:String,score:Double,dtg:Date,*geom:Point")
    ref = RDataStore(root, use_device_cache=True)
    ref.create_schema(sft).write(RFB.from_pydict(sft, {
        "name": rng.choice(["a", "b", "c"], n).tolist(),
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
        "geom": np.stack([rng.uniform(-170, 170, n),
                          rng.uniform(-80, 80, n)], 1)}))
    return {"ref": ref,
            "port": PDataStore(root, use_device_cache=True, device="cpu")}


def run_mixed_workload(svc, knn=6, counts=3):
    """kNN singles in one window plus counts (fused onto it)."""
    pts = np.random.default_rng(1).uniform(-60, 60, (knn, 2))
    futs = [svc.knn("served", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=5)
            for i in range(knn)]
    cfuts = [svc.count("served", CQL) for _ in range(counts)]
    for f in futs + cfuts:
        f.result(timeout=120)


# -- the manifest -----------------------------------------------------------


def test_recorder_dedups_and_counts():
    rec = WarmupRecorder()
    rec.record_library("chord_blockmin", "chord_blockmin_sparse_launch", 1.0)
    rec.record_library("chord_blockmin", "chord_blockmin_sparse_launch", 2.0)
    rec.record_ring("chord_blockmin_sparse", 64, 10, 1024, 4, 0.5)
    rec.record_ring("chord_blockmin_sparse", 64, 10, 1024, 2, 0.5)
    rec.record_query("count", "t", "INCLUDE")
    rec.record_query("count", "t", "INCLUDE")
    m = rec.manifest()
    lib = next(e for e in m.kernel_entries if e.kind_of == "library")
    assert lib.count == 2 and lib.compile_s == 2.0  # max observed
    rings = [e for e in m.kernel_entries if e.kind_of == "ring"]
    assert sorted(e.depth for e in rings) == [2, 4]
    assert m.query_entries[0].count == 2


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_recorder_bounded_on_high_cardinality(pkg):
    rec = (RRecorder if pkg == "ref" else WarmupRecorder)(max_entries=4)
    for i in range(10):
        rec.record_query("count", "t", f"score > {i}")
    rec.record_query("count", "t", "score > 0")  # existing key: counts
    m = rec.manifest()
    assert len(m) == 4 and rec.skipped == 6
    assert next(e for e in m.query_entries if e.cql == "score > 0").count == 2


def test_save_load_round_trip_and_version_gate(tmp_path):
    m = WarmupManifest([
        KernelEntry("library", "chord_blockmin",
                    entry="chord_blockmin_sparse_launch"),
        KernelEntry("ring", "chord_blockmin_sparse", q=8, k=5,
                    capacity=64, depth=4),
        QueryEntry("knn", "served", CQL, q=8, k=5, impl="sparse"),
    ])
    path = str(tmp_path / "m.json")
    m.save(path)
    m2 = WarmupManifest.load(path)
    assert [e.to_json() for e in m2.entries] == [e.to_json() for e in m.entries]
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"version": 99, "entries": []}, f)
    with pytest.raises(ValueError):
        WarmupManifest.load(bad)
    with open(bad, "w") as f:
        json.dump({"version": 1, "entries": [{"kind": "jit"}]}, f)
    with pytest.raises(ValueError):
        WarmupManifest.load(bad)


def test_query_entries_equal_the_reference_recorders(stores):
    """One workload through both packages' services records the same
    query entries (op, type, CQL, padded Q bucket, k, impl, count)."""
    entries = {}
    for pkg, serve in (("ref", rserve), ("port", pserve)):
        svc = serve.QueryService(stores[pkg], serve.ServeConfig(
            max_wait_ms=20.0), autostart=False)
        rec = svc.record_warmup()
        svc.start()
        try:
            run_mixed_workload(svc)
        finally:
            svc.close(drain=True)
        entries[pkg] = sorted(
            json.dumps(e.to_json(), sort_keys=True)
            for e in rec.manifest().query_entries)
    assert entries["port"] == entries["ref"]
    assert any('"op": "knn"' in e and '"q": 8' in e for e in entries["port"])


# -- replay / check ---------------------------------------------------------


def test_bad_library_entry_fails_soft():
    m = WarmupManifest([KernelEntry("library", "no_such_kernel", entry="f")])
    report = pwarmup.replay(m)
    assert report.kernels_failed == 1 and not report.ok and report.errors


def test_query_entries_without_store_are_skipped():
    report = pwarmup.replay(WarmupManifest([QueryEntry("count", "t", "INCLUDE")]))
    assert report.queries_skipped == 1 and report.ok


def test_ring_entry_no_query_armed_fails():
    registry.clear()
    m = WarmupManifest([KernelEntry("ring", "chord_blockmin_sparse", q=8,
                                    k=5, capacity=64, depth=4)])
    assert pwarmup.replay(m).ok  # not served on a ring: nothing to check
    report = pwarmup.replay(m, ring_depth=4)
    assert report.kernels_failed == 1 and "armed" in report.errors[0]


def test_ring_entry_needs_its_own_window_class(stores):
    """A ring entry is satisfied only by a capture of its window class
    (the digest of type, CQL and residual CQL) that this store's query
    entries armed: the loose-bbox class of the same CQL does not count."""
    from geomesa_tpu_torch.plan.hints import QueryHints
    from geomesa_tpu_torch.plan.planner import ring_class
    from geomesa_tpu_torch.plan.query import Query

    registry.clear()
    planner = stores["port"].get_feature_source("served").planner
    prog = planner.ring_arm(Query("served", CQL), q_padded=8, k=5, depth=4)
    plan = planner.plan(Query("served", CQL, hints=QueryHints(loose_bbox=True)))
    loose = ring_class("served", plan.cql, plan.residual_cql)
    assert loose != prog.capture.cls
    query = QueryEntry("knn", "served", CQL, q=8, k=5, impl="sparse")

    def ring(cls):
        return KernelEntry("ring", "chord_blockmin_sparse", q=8, k=5,
                           capacity=prog.cap, depth=4, cls=cls)

    ok = pwarmup.replay(WarmupManifest([query, ring(prog.capture.cls)]),
                        store=stores["port"], ring_depth=4)
    assert ok.ok and ok.kernels_cached == 1, ok
    bad = pwarmup.replay(WarmupManifest([query, ring(loose)]),
                         store=stores["port"], ring_depth=4)
    assert bad.kernels_failed == 1 and "armed" in bad.errors[0], bad
    registry.clear()


def test_record_roundtrip_warmup_no_builds_or_captures(stores, tmp_path):
    """The whole contract in one lifecycle: a cold workload records a
    manifest and its first window carries the capture stall; the manifest
    survives save/load; with the captures dropped (a fresh process's
    state), a service built with warmup_manifest replays it, check()
    reports no new build and no new capture, and the served windows after
    it carry no stall."""
    ds = stores["port"]
    registry.clear()
    svc1 = pserve.QueryService(ds, pserve.ServeConfig(max_wait_ms=20.0),
                               autostart=False)
    rec = svc1.record_warmup()
    svc1.start()
    audit0 = len(ds.audit.events)
    run_mixed_workload(svc1)
    svc1.close(drain=True)
    cold = [e for e in ds.audit.events[audit0:] if isinstance(e, ServeEvent)]
    stalled = [e for e in cold if e.compile_ms > 0]
    assert stalled and all("ring:chord_blockmin_sparse@ring4:q8" in e.compiled
                           for e in stalled)
    assert svc1.stats()["compile_stalled_dispatches"] == 1
    manifest = rec.manifest()
    ring = [e for e in manifest.kernel_entries if e.kind_of == "ring"]
    assert [(e.library, e.q, e.k, e.depth) for e in ring] == [
        ("chord_blockmin_sparse", 8, 5, 4)]
    assert {e.op for e in manifest.query_entries} == {"knn", "count"}
    path = str(tmp_path / "serve_manifest.json")
    manifest.save(path)
    assert ([e.to_json() for e in WarmupManifest.load(path).entries]
            == [e.to_json() for e in manifest.entries])

    registry.clear()  # the captures die with the process
    stalls0 = pmetrics.counters.get("compile.stalls", 0.0)
    svc2 = pserve.QueryService(ds, pserve.ServeConfig(
        max_wait_ms=20.0, warmup_manifest=path), autostart=False)
    assert registry.stats()["captures"] >= 1  # the startup replay captured
    report = svc2.warmup(path, check=True)
    assert pmetrics.counters.get("compile.stalls", 0.0) == stalls0
    assert report.ok and report.residual_recompiles == 0, report
    assert report.kernels_failed == 0 and report.queries_failed == 0
    base = svc2.tracker.total_recompiles()
    svc2.start()
    audit1 = len(ds.audit.events)
    run_mixed_workload(svc2)
    run_mixed_workload(svc2)
    svc2.close(drain=True)
    assert svc2.tracker.total_recompiles() == base
    assert svc2.stats()["recompiles"] == base
    assert svc2.stats().get("compile_stalled_dispatches", 0) == 0
    events = [e for e in ds.audit.events[audit1:] if isinstance(e, ServeEvent)]
    assert events and all(e.compile_ms == 0.0 and e.compiled == ""
                          for e in events)


def test_track_compiles_shares_one_refcounted_tracker(stores):
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(
        track_compiles=True), autostart=False)
    assert svc.tracker is not None
    svc2 = pserve.QueryService(stores["port"], pserve.ServeConfig(
        track_compiles=True), autostart=False)
    assert svc2.tracker is svc.tracker
    svc2.close()
    assert svc.tracker.is_installed()  # the survivor still counts
    svc.close()
    assert not svc.tracker.is_installed()
    assert svc.tracker.total_recompiles() >= 0  # readable after close


def test_failed_constructor_releases_the_tracker(stores, tmp_path):
    with pytest.raises(FileNotFoundError):
        pserve.QueryService(stores["port"], pserve.ServeConfig(
            warmup_manifest=str(tmp_path / "missing.json")), autostart=False)
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(
        track_compiles=True), autostart=False)
    try:
        assert svc.tracker.total_recompiles() == 0  # a fresh tracker
    finally:
        svc.close()


# -- the stall meter, both packages -----------------------------------------


@pytest.mark.parametrize("mod", [rstall, pstall], ids=["ref", "port"])
def test_stall_meter_window_thread_scope_and_mute(mod):
    import threading

    meter = mod.StallMeter(max_log=8)
    tok = meter.token()
    assert meter.since(tok) == []
    meter.note("build:x", 0.5)
    other = threading.Thread(target=meter.note, args=("ring:y", 0.25))
    other.start()
    other.join(timeout=10)
    assert not other.is_alive()
    assert meter.since(tok) == [("build:x", 0.5), ("ring:y", 0.25)]
    assert meter.since(tok, thread_ident=threading.get_ident()) == [
        ("build:x", 0.5)]
    with meter.suppressed():
        meter.note("muted", 1.0)
    assert len(meter.since(tok)) == 2
    for i in range(20):
        meter.note(f"n{i}", 0.0)
    assert len(meter.since(0)) == 8  # bounded log
