"""The port's pipelined dispatch (`geomesa_tpu_torch.serve.pipeline`)
against the reference's, after tests/test_pipeline.py.

Both packages serve one catalog (600 rows written by the reference, the
port reading it on the CPU). Each case runs the same requests through
the reference's QueryService and the port's, with the rule of
tests/test_torch_serve.py: neighbour sets equal per query (equal-distance
swaps allowed) and meters bit-identical (both packages recompute them in
f64 through `_canonical_dists`); within one package the routes are
bit-identical outright. The fake-planner cases (overlap, per-window
split) run over both packages.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu.serve as rserve
import geomesa_tpu_torch.serve as pserve
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.faults.fallback import host_fallback as r_host_fallback
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.serve.scheduler import ServeRequest as RRequest
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.engine.device import QueryStager
from geomesa_tpu_torch.faults import DeviceOOM
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.utils.metrics import metrics as pmetrics

CQL = "BBOX(geom, -170, -80, 170, 80) AND score > -5"
CQL_PLAIN = "BBOX(geom, -170, -80, 170, 80)"
WINDOWS = 16

SERVE = {"ref": rserve, "port": pserve}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_pipeline"))
    rng = np.random.default_rng(3)
    n = 600
    sft = RSFT.from_spec("served", "name:String,score:Double,dtg:Date,*geom:Point")
    rows = {
        "name": rng.choice(["a", "b", "c"], n).tolist(),
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
        "geom": np.stack([rng.uniform(-170, 170, n),
                          rng.uniform(-80, 80, n)], 1)}
    ref = RDataStore(root, use_device_cache=True)
    ref.create_schema(sft).write(RFB.from_pydict(sft, rows))
    return {"ref": ref,
            "port": PDataStore(root, use_device_cache=True, device="cpu")}


def assert_same_knn(a, b):
    """Identical neighbour sets per query and bit-identical meters."""
    ad, ai, _ = a
    bd, bi, _ = b
    assert ad.shape == bd.shape
    for i in range(len(ad)):
        assert set(ai[i].tolist()) == set(bi[i].tolist()), i
    np.testing.assert_array_equal(np.sort(ad, 1), np.sort(bd, 1))


def assert_identical(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# -- fake-planner overlap harness, both packages ----------------------------


class FakeLaunch:
    """A KnnLaunch stand-in whose sync blocks on a per-window gate: the
    test decides when each window's device work 'finishes'."""

    fused_ok = False
    mask_count = None
    deadline = None
    event = None
    ring = False

    def __init__(self, seq, q, k, events, gate):
        self.seq, self.q, self.k = seq, q, k
        self.events, self.gate = events, gate

    def sync(self):
        self.events.append(("sync_start", self.seq))
        assert self.gate.wait(timeout=30), "test gate never opened"
        self.events.append(("sync_done", self.seq))
        return (np.full((self.q, self.k), float(self.seq)),
                np.zeros((self.q, self.k), np.int32), None)


class FakePlanner:
    device = torch.device("cpu")

    def __init__(self, events, gates):
        self.events, self.gates = events, gates
        self.seq = 0

    def knn_launch(self, query, qx, qy, k=10, impl="sparse",
                   timeout_ms=None, staged=None, want_mask_count=False,
                   donate=False):  # the reference's pipeline passes donate
        self.seq += 1
        assert staged is not None, "pipeline must stage before launch"
        self.events.append(("launch", self.seq))
        return FakeLaunch(self.seq, len(qx), k, self.events,
                          self.gates[self.seq - 1])


def fake_service(pkg, events, gates, **cfg):
    source = SimpleNamespace(planner=FakePlanner(events, gates))
    store = SimpleNamespace(get_feature_source=lambda name: source, audit=None)
    cfg.setdefault("max_wait_ms", 0.0)
    cfg.setdefault("max_batch", 1)
    serve = SERVE[pkg]
    return serve.QueryService(store, serve.ServeConfig(ring=False, **cfg),
                              autostart=False)


def wait_for(events, ev, timeout=10.0):
    deadline = time.monotonic() + timeout
    while ev not in events:
        assert time.monotonic() < deadline, (ev, events)
        time.sleep(0.002)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_next_window_launches_before_previous_sync(pkg):
    """Window 2's transfer+launch proceed while window 1's device work is
    in flight; window 3 (depth 2) must wait."""
    events: list = []
    gates = [threading.Event() for _ in range(3)]
    svc = fake_service(pkg, events, gates, pipeline_depth=2)
    futs = [svc.knn("t", f"BBOX(geom, 0, 0, 1, {i + 1})",
                    np.array([0.0]), np.array([0.0]), k=5) for i in range(3)]
    svc.start()
    try:
        wait_for(events, ("launch", 2))
        assert ("sync_done", 1) not in events
        assert ("launch", 3) not in events  # the depth bound
        gates[0].set()
        wait_for(events, ("launch", 3))
        gates[1].set()
        gates[2].set()
        for f in futs:
            f.result(timeout=30)
    finally:
        for g in gates:
            g.set()
        svc.close(drain=True)
    assert events.index(("launch", 2)) < events.index(("sync_done", 1))
    p = svc.stats()["pipeline"]
    assert p["max_inflight"] >= 2 and p["windows"] == 3 and p["inflight"] == 0


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_results_split_per_window(pkg):
    events: list = []
    gates = [threading.Event() for _ in range(2)]
    for g in gates:
        g.set()
    svc = fake_service(pkg, events, gates)
    f1 = svc.knn("t", "BBOX(geom, 0, 0, 1, 1)", np.array([0.0]),
                 np.array([0.0]), k=5)
    f2 = svc.knn("t", "BBOX(geom, 0, 0, 1, 2)", np.array([0.0]),
                 np.array([0.0]), k=5)
    svc.start()
    d1, _, _ = f1.result(timeout=30)
    d2, _, _ = f2.result(timeout=30)
    svc.close(drain=True)
    # each window's rows came from ITS OWN launch (seq-valued)
    assert float(d1[0, 0]) == 1.0 and float(d2[0, 0]) == 2.0


# -- identity against the serial path, both packages ------------------------


def run_windows(pkg, store, qpts, counts=0, **cfg):
    """Every request queued, then released: one window per max_batch."""
    serve = SERVE[pkg]
    svc = serve.QueryService(store, serve.ServeConfig(**cfg), autostart=False)
    futs = [svc.knn("served", CQL, qpts[i:i + 1, 0], qpts[i:i + 1, 1], k=5)
            for i in range(len(qpts))]
    cfuts = [svc.count("served", CQL) for _ in range(counts)]
    svc.start()
    try:
        res = [f.result(timeout=120) for f in futs]
        cnts = [f.result(timeout=120) for f in cfuts]
    finally:
        svc.close(drain=True)
    return res, cnts, svc.stats()


ROUTES = {"serial": dict(pipeline=False, ring=False),
          "pipelined": dict(ring=False), "ring": {}}


def test_routes_bit_identical_over_16_windows_in_both_packages(stores):
    """Acceptance: serial, pipelined and ring over 16 windows of 4 are
    bit-identical within each package, and the port's equal the
    reference's (neighbour sets, meters)."""
    qpts = np.random.default_rng(42).uniform(-60, 60, (4 * WINDOWS, 2))
    got = {}
    for pkg in ("ref", "port"):
        for route, cfg in ROUTES.items():
            got[pkg, route] = run_windows(pkg, stores[pkg], qpts,
                                          max_batch=4, **cfg)
    for pkg in ("ref", "port"):
        base = got[pkg, "serial"][0]
        for route in ("pipelined", "ring"):
            for a, b in zip(got[pkg, route][0], base):
                assert_identical(a, b)
        st = got[pkg, "ring"][2]
        assert st["dispatches"] == WINDOWS
        assert st["pipeline"]["ring"]["windows"] == WINDOWS
        assert got[pkg, "pipelined"][2]["pipelined_windows"] == WINDOWS
    for a, b in zip(got["port", "ring"][0], got["ref", "serial"][0]):
        assert_same_knn(a, b)


def test_counts_fused_onto_the_knn_window(stores):
    """Counts released with a kNN window resolve from its mask reduction
    (no dispatch of their own) and equal the serial count, in both
    packages."""
    qpts = np.random.default_rng(7).uniform(-60, 60, (8, 2))
    for pkg in ("ref", "port"):
        res_p, cnt_p, st_p = run_windows(pkg, stores[pkg], qpts, counts=3,
                                         max_wait_ms=50.0, ring=False)
        res_s, cnt_s, st_s = run_windows(pkg, stores[pkg], qpts, counts=3,
                                         max_wait_ms=50.0, pipeline=False,
                                         ring=False)
        for a, b in zip(res_p, res_s):
            assert_identical(a, b)
        assert cnt_p == cnt_s
        assert st_p["pipeline"]["fused_counts"] == 3
        assert st_p["dispatches"] < st_s["dispatches"]
    src = stores["port"].get_feature_source("served")
    assert cnt_p == [src.get_count(CQL)] * 3


@pytest.mark.parametrize("cql", [CQL, CQL_PLAIN], ids=["banded", "plain"])
def test_fused_count_matches_planner_and_reference(stores, cql):
    """The fused mask reduction equals planner.count exactly, for a filter
    with an f32 band (the score comparison) and one without."""
    qpts = np.random.default_rng(7).uniform(-60, 60, (4, 2))
    out = {}
    for pkg, Query in (("ref", RQuery), ("port", PQuery)):
        src = stores[pkg].get_feature_source("served")
        launch = src.planner.knn_launch(Query("served", cql), qpts[:, 0],
                                        qpts[:, 1], k=5, want_mask_count=True)
        launch.sync()
        assert launch.fused_ok
        out[pkg] = launch.mask_count
        assert out[pkg] == src.planner.count(Query("served", cql))
    assert out["port"] == out["ref"]


def test_serial_launch_sync_composition(stores):
    """planner.knn == planner.knn_launch(...).sync() bit for bit, and a
    staged launch (the stager's f32 cast) equals the planner's upload."""
    src = stores["port"].get_feature_source("served")
    rng = np.random.default_rng(9)
    qx, qy = rng.uniform(-60, 60, 8), rng.uniform(-60, 60, 8)
    q = PQuery("served", CQL)
    a = src.planner.knn(q, qx, qy, k=5)
    assert_identical(a, src.planner.knn_launch(q, qx, qy, k=5).sync())
    slot = QueryStager(2).stage(("served", 5, "sparse", 8), qx, qy)
    assert_identical(a, src.planner.knn_launch(
        q, qx, qy, k=5, staged=tuple(slot)).sync())


def test_sustained_loadgen_reports_pipeline_depth(stores):
    svc = pserve.QueryService(stores["port"],
                              pserve.ServeConfig(max_wait_ms=1.0, ring=False))
    try:
        rep = pserve.run_sustained(
            svc, pserve.knn_request_factory("served", CQL, k=5),
            duration_s=30.0, max_outstanding=8, points_per_query=600,
            requests=12)
    finally:
        svc.close(drain=True)
    assert rep.mode == "sustained" and rep.ok == 12 and rep.errors == 0
    assert rep.pts_per_s > 0 and rep.pipelined_windows >= 1
    assert rep.windows_in_flight_max >= 1 and rep.ring_windows == 0
    assert rep.to_json()["pipelined_windows"] == rep.pipelined_windows


def test_drain_close_harvests_every_window_once(stores):
    qpts = np.random.default_rng(11).uniform(-60, 60, (8, 2))
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(
        max_wait_ms=1.0, max_batch=2, ring=False))
    futs = [svc.knn("served", CQL, qpts[i:i + 1, 0], qpts[i:i + 1, 1], k=5)
            for i in range(8)]
    svc.close(drain=True)
    assert all(f.done() for f in futs)
    for f in futs:
        d, ix, _ = f.result(timeout=1)
        assert d.shape == (1, 5) and ix.shape == (1, 5)
    p = svc.stats()["pipeline"]
    assert p["inflight"] == 0 and p["windows"] == svc.stats()["pipelined_windows"]


# -- the stager -------------------------------------------------------------


def test_stager_rotation_and_value_identity():
    stager = QueryStager(depth=2)
    rng = np.random.default_rng(5)
    qx = rng.uniform(-60, 60, 8)
    qy = rng.uniform(-60, 60, 8)
    key = ("t", 5, "sparse", 8)
    slots = [stager.stage(key, qx, qy) for _ in range(3)]
    # value identity with the serial conversion
    for s in slots:
        np.testing.assert_array_equal(s.qx.numpy(), np.asarray(qx, np.float32))
        np.testing.assert_array_equal(s.qy.numpy(), np.asarray(qy, np.float32))
    assert stager.stats() == {"keys": 1, "staged": 3}
    # two slots a key, handed out in turn: window 3 reuses window 1's
    assert [s.index for s in slots] == [0, 1, 0]
    assert slots[0] is slots[2] and slots[0] is not slots[1]
    for i in range(QueryStager.MAX_KEYS + 5):
        stager.stage(("t2", i, "sparse", 8), qx[:1], qy[:1])
    assert stager.stats()["keys"] <= QueryStager.MAX_KEYS
    assert key not in stager._rings  # the least recently staged went first
    with pytest.raises(ValueError):
        QueryStager(depth=1)


def test_host_pids_equal_the_device_pids(stores):
    """The band rows' partition ids come from the superbatch's host row
    offsets (no device read): they equal the device's per-row ids."""
    src = stores["port"].get_feature_source("served")
    src.planner.knn(PQuery("served", CQL), np.zeros(1), np.zeros(1), k=5)
    sb = src.planner.cache.superbatch()
    assert len(sb.ids) > 1
    rows = np.arange(len(sb.pids))
    np.testing.assert_array_equal(sb.host_pids(rows), sb.pids.numpy())


@pytest.mark.parametrize("donate", [None, True, False, "yes"])
def test_pipeline_donate_is_a_validated_reference_field(stores, donate):
    """pipeline_donate keeps the reference's values, which all run the
    same on the port; anything else is refused."""
    cfg = pserve.ServeConfig(pipeline_donate=donate)
    if donate == "yes":
        with pytest.raises(ValueError, match="pipeline_donate"):
            pserve.QueryService(stores["port"], cfg, autostart=False)
        return
    pserve.QueryService(stores["port"], cfg, autostart=False).close()


@pytest.mark.cuda
def test_real_planner_launches_the_next_window_before_the_last_syncs(tmp_path):
    """On the card, window N+1's launch (plan, the mask on the side
    stream with its band read, the kernels, the readback) returns while
    window N's kernels are still queued behind a long-running kernel:
    nothing in the launch waits for the caller's stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(23)
    n = 1 << 16
    ps = PSFT.from_spec("served", "name:String,score:Double,dtg:Date,*geom:Point")
    ds = PDataStore(str(tmp_path), use_device_cache=True, device="cuda")
    src = ds.create_schema(ps)
    src.write(PFB.from_pydict(ps, {
        "name": rng.choice(["a", "b"], n).tolist(),
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
        "geom": np.stack([rng.uniform(-170, 170, n),
                          rng.uniform(-80, 80, n)], 1)}))
    q = PQuery("served", CQL)
    pts = rng.uniform(-60, 60, (2, 8))
    serial = [src.planner.knn(q, pts[i], pts[i], k=5) for i in range(2)]
    stager = QueryStager(2, torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of one busy kernel, queued first
    t0 = time.perf_counter()
    launches = []
    for i in range(2):
        slot = stager.stage(("served", 5, "sparse", 8), pts[i], pts[i])
        launches.append(src.planner.knn_launch(q, pts[i], pts[i], k=5,
                                               staged=tuple(slot)))
    host_s = time.perf_counter() - t0
    assert not launches[0].event.query(), "window N finished before N+1 launched"
    assert host_s < 0.3, host_s
    for launch, want in zip(launches, serial):
        assert_identical(launch.sync(), want)


@pytest.mark.cuda
def test_card_stager_keeps_its_slot_buffers():
    """A stager made for `cuda` (no index, as a planner's device is)
    allocates each slot's device and pinned pairs once: a later window's
    copy never lands in memory an earlier window's launch still reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    stager = QueryStager(2, torch.device("cuda"))
    qx = np.arange(8, dtype=np.float64)
    slots = [stager.stage(("t", 5, "sparse", 8), qx + i, qx - i)
             for i in range(4)]
    ptrs = [(s.qx.data_ptr(), s.hx.data_ptr()) for s in slots]
    assert ptrs[0] == ptrs[2] and ptrs[1] == ptrs[3] and ptrs[0] != ptrs[1]
    torch.cuda.synchronize()
    np.testing.assert_array_equal(slots[3].qx.cpu().numpy(),
                                  np.asarray(qx + 3, np.float32))


# -- the OOM ladder on the pipelined route ----------------------------------


def oom_counters():
    with pmetrics._lock:
        return {k: pmetrics.counters.get(k, 0) for k in
                ("serve.oom.halved", "serve.oom.hosteval", "serve.oom.failed")}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_oom_ladder_on_the_pipelined_route(stores, monkeypatch, device):
    """A launch that runs out of memory halves the window of 8 down to
    single requests from their host copies. On a CPU store each is then
    evaluated on the host and equals the reference's answer; on a store
    whose device is the card (faked) each fails with a typed DeviceOOM
    and nothing runs on the host."""
    src = stores["port"].get_feature_source("served")

    def launch_oom(*a, **kw):
        raise torch.OutOfMemoryError("injected: CUDA out of memory")

    monkeypatch.setattr(src.planner, "knn_launch", launch_oom)
    monkeypatch.setattr(src.planner, "device", torch.device(device))
    svc = pserve.QueryService(stores["port"], pserve.ServeConfig(
        max_wait_ms=1.0, ring=False), autostart=False)
    cpu_stager = QueryStager(2)
    monkeypatch.setattr(svc.pipeline, "stager", lambda dev: cpu_stager)
    qpts = np.random.default_rng(13).uniform(-60, 60, (8, 2))
    before = oom_counters()
    futs = [svc.knn("served", CQL, qpts[i:i + 1, 0], qpts[i:i + 1, 1], k=5)
            for i in range(8)]
    svc.start()
    try:
        if device == "cuda":
            errs = [f.exception(timeout=60) for f in futs]
            assert all(isinstance(e, DeviceOOM) for e in errs), errs
        else:
            got = [f.result(timeout=60) for f in futs]
    finally:
        svc.close(drain=True)
    after = oom_counters()
    delta = {k: after[k] - before[k] for k in before}
    assert delta["serve.oom.halved"] == 7
    assert cpu_stager.stats()["staged"] == 1  # the ladder re-staged nothing
    if device == "cuda":
        assert delta["serve.oom.hosteval"] == 0 and delta["serve.oom.failed"] == 8
        return
    assert delta["serve.oom.hosteval"] == 8
    rsrc = stores["ref"].get_feature_source("served")
    for i, (d, ix, batch) in enumerate(got):
        req = RRequest(kind="knn", query=RQuery("served", CQL))
        req.qx, req.qy, req.k = qpts[i:i + 1, 0], qpts[i:i + 1, 1], 5
        rd, rix, rbatch = r_host_fallback(rsrc, req)
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(ix, rix)
        assert len(batch) == len(rbatch)
