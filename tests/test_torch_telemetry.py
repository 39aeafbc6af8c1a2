"""The port's telemetry (`geomesa_tpu_torch.telemetry`, `utils/profiling.py`)
against the reference's `geomesa_tpu.telemetry`.

Both packages serve one catalog (600 rows written by the reference, the
port reading it on the CPU) with tracing on, through QueryServices on the
serial and the pipelined route (ring off), each over a fresh store so
residency loads in the first window of both. The traces must carry the
same span names (the reference's first-call XLA compile, `compile.stall`,
aside) and the same `kernel.dispatch` families. The pure functions (the
continuous profiler's fold, the gap report, the Perfetto round trip, the
sentinel) are fed the same trace documents in both packages and must
agree. No test asserts a wall-clock budget.
"""

import collections
import json
import os
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import geomesa_tpu.serve as rserve
import geomesa_tpu.telemetry as rtel
import geomesa_tpu_torch.serve as pserve
import geomesa_tpu_torch.telemetry as ptel
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.telemetry import sentinel as rsentinel
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.telemetry import sentinel as psentinel
from geomesa_tpu_torch.utils.metrics import metrics as pmetrics

CQL = "BBOX(geom, -170, -80, 170, 80) AND score > -5"
N_ROWS = 600
ROUTES = {"serial": False, "pipelined": True}

PKG = {
    "ref": SimpleNamespace(serve=rserve, tel=rtel, sentinel=rsentinel,
                           DataStore=lambda root: RDataStore(
                               root, use_device_cache=True)),
    "port": SimpleNamespace(serve=pserve, tel=ptel, sentinel=psentinel,
                            DataStore=lambda root: PDataStore(
                                root, use_device_cache=True, device="cpu")),
}


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_telemetry"))
    rng = np.random.default_rng(3)
    rows = {
        "name": rng.choice(["a", "b", "c"], N_ROWS).tolist(),
        "score": rng.uniform(-10, 10, N_ROWS),
        "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, N_ROWS),
        "geom": np.stack([rng.uniform(-170, 170, N_ROWS),
                          rng.uniform(-80, 80, N_ROWS)], 1),
    }
    sft = RSFT.from_spec("served", "name:String,score:Double,dtg:Date,*geom:Point")
    RDataStore(root, use_device_cache=True).create_schema(sft).write(
        RFB.from_pydict(sft, rows))
    return root


def serve_once(pkg, root, pipeline, trace=True, **cfg):
    """Three kNN requests and one count through a fresh store's service,
    all submitted before the start (the first window drains them); returns
    (answers, the recorded trace documents)."""
    p = PKG[pkg]
    p.tel.RECORDER.clear()
    if trace:
        p.tel.TRACER.enable()
    try:
        svc = p.serve.QueryService(p.DataStore(root), p.serve.ServeConfig(
            pipeline=pipeline, ring=False, result_cache=0, **cfg),
            autostart=False)
        futs = [svc.knn("served", CQL, [float(i)], [10.0], k=5)
                for i in range(3)]
        futs.append(svc.count("served", CQL))
        svc.start()
        answers = [f.result(timeout=120) for f in futs]
        svc.close(drain=True)
    finally:
        p.tel.TRACER.disable()
    return answers, p.tel.RECORDER.traces()


@pytest.fixture(scope="module")
def traced(catalog):
    """{(pkg, route): trace documents} for both packages and routes."""
    out = {}
    for pkg in PKG:
        for route, pipeline in ROUTES.items():
            out[pkg, route] = serve_once(pkg, catalog, pipeline)[1]
    return out


def span_profile(traces):
    """Per trace: (kind, span names without compile.stall, the sorted
    kernel.dispatch families); sorted, as a multiset of traces."""
    out = []
    for t in traces:
        names = frozenset(s["name"] for s in t["spans"]) - {"compile.stall"}
        kernels = tuple(sorted(
            (s.get("attrs") or {}).get("kernel", "") for s in t["spans"]
            if s["name"] == "kernel.dispatch"))
        out.append((t["root"]["attrs"]["kind"], tuple(sorted(names)), kernels))
    return sorted(out)


@pytest.mark.parametrize("route", list(ROUTES))
def test_span_names_and_kernel_families_match_reference(traced, route):
    """Every kNN and count trace of the port carries the reference's span
    names (plan, residency, kernel.dispatch, device.transfer, device.sync
    and the serve layer's) and the reference's kernel families."""
    port, ref = span_profile(traced["port", route]), span_profile(
        traced["ref", route])
    assert len(port) == len(ref) == 4
    assert port == ref
    knn = [names for kind, names, _ in port if kind == "knn"]
    for names in knn:
        assert {"plan", "residency", "kernel.dispatch", "device.sync",
                "device.transfer"} <= set(names)
    fams = collections.Counter(k for _, _, ks in port for k in ks)
    assert fams["knn_sparse"] >= 3 and fams["filter.mask"] >= 3


@pytest.mark.parametrize("route", list(ROUTES))
def test_tracing_adds_no_device_op(catalog, route):
    """A span adds no host synchronisation and no device op: the
    `serve.device.ops` delta of the same requests over a fresh store is
    the same with tracing off and on, and so are the answers."""
    deltas, answers = [], []
    for trace in (False, True):
        before = pmetrics.counters.get("serve.device.ops", 0.0)
        got, _ = serve_once("port", catalog, ROUTES[route], trace=trace)
        deltas.append(pmetrics.counters.get("serve.device.ops", 0.0) - before)
        answers.append(got)
    assert deltas[0] == deltas[1] > 0
    for a, b in zip(answers[0][:3], answers[1][:3]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert answers[0][3] == answers[1][3]


# -- pure functions on the same documents -----------------------------------


def synth_traces(n=24, seed=5):
    """Seeded trace documents with what live traffic rarely shows at once:
    riders sharing a window's span ids, overlapping windows, shard-stamped
    device spans, ring windows and lane evaluations."""
    rng = np.random.default_rng(seed)
    out = []
    sid = 1
    t = 0
    for i in range(n):
        proc = "aa" if i % 3 else "bb"
        base = t + int(rng.integers(0, 40_000))
        root = {"name": "query", "id": sid, "parent": None, "t0_ns": base,
                "t1_ns": base + 200_000, "thread": 1,
                "attrs": {"kind": "knn", "status": "ok"}}
        sid += 1
        win = {"name": "dispatch", "id": sid, "parent": root["id"],
               "t0_ns": base + 10_000, "t1_ns": base + 150_000, "thread": 2,
               "attrs": {"batch": 2}}
        sid += 1
        spans = [{"name": "admit", "id": sid, "parent": root["id"],
                  "t0_ns": base, "t1_ns": base + 5_000, "thread": 1}, win]
        sid += 1
        shards = ["0,1", "1", "0,1,2,3", ""][i % 4]
        for name, attrs in (("plan", {}), ("residency", {}),
                            ("kernel.dispatch", {"kernel": "filter.mask"}),
                            ("device.transfer", {"rows": 8, "staged": True}),
                            ("kernel.dispatch", {"kernel": ["knn_sparse",
                                                            "knn_mesh",
                                                            "knn_ring"][i % 3],
                                                 "q": 8, "k": 5,
                                                 "shards": shards}),
                            ("device.sync", {"shards": shards,
                                             "ring": bool(i % 2)}),
                            ("ring.slot", {"q": 8, "depth": 4}),
                            ("subscribe.lane.eval", {"cls": "bbox",
                                                     "rows": 64})):
            t0 = win["t0_ns"] + int(rng.integers(0, 100_000))
            span = {"name": name, "id": sid, "parent": win["id"],
                    "t0_ns": t0, "t1_ns": t0 + int(rng.integers(100, 40_000)),
                    "thread": 2}
            if attrs:
                span["attrs"] = attrs
            spans.append(span)
            sid += 1
        doc = {"trace_id": f"{proc}-{i}", "name": "query", "root": root,
               "spans": spans}
        out.append(doc)
        if i % 4 == 1:
            # a rider: its own root, the window's spans with their ids
            rider_root = dict(root, id=sid, t1_ns=root["t1_ns"] + 7_000)
            sid += 1
            out.append({"trace_id": f"{proc}-r{i}", "name": "query",
                        "root": rider_root,
                        "spans": [dict(s, parent=(rider_root["id"]
                                                  if s["parent"] == root["id"]
                                                  else s["parent"]))
                                  for s in spans[1:]]})
        t += int(rng.integers(50_000, 250_000))
    return out


@pytest.fixture(scope="module")
def documents(traced):
    """The served traces of both routes plus the synthetic set."""
    docs = []
    for route in ROUTES:
        docs += traced["port", route]
    return json.loads(json.dumps(docs + synth_traces()))


def test_profiler_snapshot_matches_reference(documents):
    """ContinuousProfiler.snapshot over the same documents, samples
    included (each reservoir is seeded), in both packages; and the
    recorder's hook folds only while the profiler is on."""
    snaps = {}
    for pkg in PKG:
        prof = PKG[pkg].tel.ContinuousProfiler()
        prof.enable()
        for d in documents:
            prof.fold(d)
        snaps[pkg] = prof.snapshot(include_samples=True)
        assert PKG[pkg].tel.render_prof(snaps[pkg])
    assert snaps["port"] == snaps["ref"]
    assert {"knn_sparse", "filter.mask"} <= set(snaps["port"]["kernels"])
    assert snaps["port"]["shards"]["lanes"]
    from geomesa_tpu_torch.telemetry.prof import PROFILER

    rec = ptel.FlightRecorder(capacity=4)
    PROFILER.reset()
    PROFILER.enable()
    try:
        rec.record(documents[0])
        assert PROFILER.snapshot()["traces"] == 1
    finally:
        PROFILER.disable()
    rec.record(documents[1])
    assert PROFILER.snapshot()["traces"] == 1
    PROFILER.reset()


def test_gap_report_matches_reference(documents):
    reps = {pkg: PKG[pkg].tel.gap_report(documents) for pkg in PKG}
    assert reps["port"] == reps["ref"]
    rep = reps["port"]
    assert rep["dispatch_gap"]["windows"] > 0
    assert rep["dispatch_gap"]["device_ms"] > 0
    assert 0.0 < rep["coverage"] <= 1.0
    assert rep["ring"]["windows"] and rep["shards"] and rep["lanes"]
    assert ptel.render_gap(rep)


def test_perfetto_round_trip_matches_reference(documents):
    docs = {pkg: PKG[pkg].tel.to_perfetto(documents) for pkg in PKG}
    assert docs["port"] == docs["ref"]
    backs = {pkg: PKG[pkg].tel.from_perfetto(json.loads(json.dumps(docs[pkg])))
             for pkg in PKG}
    assert backs["port"] == backs["ref"]
    by_id = {t["trace_id"]: t for t in backs["port"]}
    assert len(by_id) == len(documents)
    for t in documents:
        back = by_id[t["trace_id"]]
        assert {(s["id"], s["name"], s["parent"]) for s in back["spans"]} == {
            (s["id"], s["name"], s["parent"]) for s in t["spans"]}
    lines = {}
    for pkg in PKG:
        out = []
        assert PKG[pkg].tel.write_jsonl(documents, out.append) == len(documents)
        lines[pkg] = out
    assert lines["port"] == lines["ref"]


def test_sentinel_matches_reference(documents, tmp_path):
    """baseline_from_profile, compare's verdicts and exit_code: a profile
    against itself is ok, a 3x slower copy regresses, a faster one
    improves; the baseline file round-trips."""
    prof = ptel.ContinuousProfiler()
    prof.enable()
    for d in documents:
        prof.fold(d)
    snap = prof.snapshot(include_samples=True)
    rng = np.random.default_rng(2)
    lat = list(rng.uniform(1.0, 2.0, 64))
    out = {}
    for pkg in PKG:
        s = PKG[pkg].sentinel
        base = s.baseline_from_profile(snap, latency_samples_ms=lat,
                                       extra={"route": "served"},
                                       extra_samples={"x.y": lat[:9]})
        slow = s.baseline_from_profile(snap, latency_samples_ms=[
            3.0 * v for v in lat])
        fast = s.baseline_from_profile(snap, latency_samples_ms=[
            v / 3.0 for v in lat])
        same = s.compare(base, base)
        reps = (same, s.compare(base, slow), s.compare(base, fast),
                s.compare(base, {"metrics": {}}))
        out[pkg] = (base["metrics"], base["context"],
                    reps, [s.exit_code(r) for r in reps],
                    [s.exit_code(r, strict=True) for r in reps])
        assert s.render_verdicts(same)
        path = str(tmp_path / f"{pkg}.json")
        s.save_baseline(path, base)
        assert s.load_baseline(path)["metrics"] == json.loads(
            json.dumps(base["metrics"]))
    assert out["port"] == out["ref"]
    same, slow, fast, empty = out["port"][2]
    assert same["counts"]["regressed"] == 0 and not same["regressed"]
    assert slow["metrics"]["serve.latency"]["verdict"] == "regressed"
    assert fast["metrics"]["serve.latency"]["verdict"] == "improved"
    assert out["port"][3] == [0, 1, 0, 0]
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(ValueError, match="not a v1"):
        psentinel.load_baseline(str(bad))


# -- the live endpoint ------------------------------------------------------


ROUTES_HTTP = ("/metrics", "/healthz", "/debug/traces", "/debug/stats",
               "/debug/gap", "/debug/slo", "/debug/approx", "/debug/prof")


def test_metrics_server_answers_every_route(catalog):
    """A MetricsServer over a service with an SLO spec and the profiler
    on, on 127.0.0.1 with an ephemeral port: every route answers 200, the
    JSON routes parse, /metrics carries the serve and slo families, and
    stats() reports the bound port."""
    from geomesa_tpu_torch.telemetry.prof import PROFILER

    spec = {"objective": {"avail": {"kind": "availability", "goal": 0.99}}}
    p = PKG["port"]
    p.tel.TRACER.enable()
    PROFILER.reset()
    svc = pserve.QueryService(p.DataStore(catalog), pserve.ServeConfig(
        pipeline=False, ring=False, trace=True, profile=True, slo=spec))
    server = ptel.MetricsServer(port=0, stats_fn=svc.stats,
                                pre_scrape=svc.export_gauges,
                                slo_fn=svc.slo.report)
    try:
        svc.metrics_port = server.start()
        svc.knn("served", CQL, [0.0], [10.0], k=5).result(timeout=120)
        svc.count("served", CQL).result(timeout=120)
        bodies = {}
        for route in ROUTES_HTTP:
            with urllib.request.urlopen(f"{server.url}{route}",
                                        timeout=10) as r:
                assert r.status == 200, route
                bodies[route] = r.read().decode()
        for route in ROUTES_HTTP[1:]:
            json.loads(bodies[route])
        assert "serve_latency_seconds" in bodies["/metrics"]
        assert 'slo_budget_remaining{objective="avail"}' in bodies["/metrics"]
        assert json.loads(bodies["/debug/slo"])["objectives"]["avail"]
        assert json.loads(bodies["/debug/prof"])["traces"] >= 2
        assert json.loads(bodies["/debug/stats"])["serve"]["metrics_port"] \
            == server.port
        assert json.loads(bodies["/debug/traces"])["traceEvents"]
        assert json.loads(bodies["/debug/gap"])["traces"] >= 2
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{server.url}/nope", timeout=10)
    finally:
        server.stop()
        svc.close(drain=True)
        p.tel.TRACER.disable()
        PROFILER.disable()
        PROFILER.reset()


# -- geomesa.profile.dir ------------------------------------------------------


@pytest.fixture
def profile_dir(tmp_path):
    """A trace directory (not made yet); the process-wide capture registry
    starts empty (captures another test left behind would refuse the
    trace) and the property is cleared after."""
    from geomesa_tpu_torch.compilecache.registry import registry
    from geomesa_tpu_torch.utils.config import SystemProperties

    registry.clear()
    d = tmp_path / "prof"
    yield d
    SystemProperties.clear("geomesa.profile.dir")


def test_profile_dir_writes_a_trace_and_nothing_when_unset(catalog,
                                                           profile_dir):
    """Unset, an execute creates nothing; set, each execute writes one
    readable Chrome trace under <dir>/query-<seq>/ naming the mask's
    operators."""
    from geomesa_tpu_torch.utils.config import SystemProperties

    src = PDataStore(catalog, use_device_cache=True,
                     device="cpu").get_feature_source("served")
    n = src.get_count(CQL)
    profile_dir.mkdir()
    assert os.listdir(profile_dir) == []
    SystemProperties.set("geomesa.profile.dir", str(profile_dir))
    assert src.get_count(CQL) == n
    runs = os.listdir(profile_dir)
    assert len(runs) == 1 and runs[0].startswith("query-")
    with open(profile_dir / runs[0] / "trace.json") as f:
        doc = json.load(f)
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)
    SystemProperties.set("geomesa.profile.dir", str(profile_dir / "f"))
    (profile_dir / "f").write_text("")  # a file where the directory goes
    with pytest.raises(OSError):
        src.get_count(CQL)


def test_profile_dir_refuses_while_the_ring_holds_captures(catalog,
                                                           profile_dir):
    """torch.profiler traces the whole process and a graph replay under
    it crashed on the card: while a ring program holds captures,
    geomesa.profile.dir refuses typed (ProfileRefused), never silently
    untraced; once the ring's service closes, the trace runs."""
    from geomesa_tpu_torch.compilecache.registry import registry
    from geomesa_tpu_torch.errors import ProfileRefused
    from geomesa_tpu_torch.utils.config import SystemProperties

    ds = PDataStore(catalog, use_device_cache=True, device="cpu")
    src = ds.get_feature_source("served")
    svc = pserve.QueryService(ds, pserve.ServeConfig(max_wait_ms=1.0))
    try:
        svc.knn("served", CQL, [0.0], [10.0], k=5).result(timeout=120)
        svc.knn("served", CQL, [1.0], [10.0], k=5).result(timeout=120)
        assert svc.stats()["pipeline"]["ring"]["armed"] >= 1
        assert registry.held()
        SystemProperties.set("geomesa.profile.dir", str(profile_dir))
        with pytest.raises(ProfileRefused, match="ring"):
            src.get_count(CQL)
        assert not profile_dir.exists()
    finally:
        svc.close(drain=True)
    assert not registry.held()
    src.get_count(CQL)
    assert len(os.listdir(profile_dir)) == 1
