"""The port's fault fabric (`geomesa_tpu_torch.faults`) against the
reference's, after tests/test_faults.py.

- `classify`: a CUDA OOM (`torch.OutOfMemoryError`, which
  `torch.cuda.OutOfMemoryError` names) is "oom"; nothing else is — a
  CUDA launch error or a kernel that failed to build is "permanent" and
  fails the request. Every other class is classified as the reference
  classifies it.
- The OOM ladder: a planner whose every launch raises
  `torch.OutOfMemoryError` halves a 64-request kNN window down to single
  requests. On a CPU store it then evaluates each on the host, and the
  answers equal the reference's `host_fallback` on the same catalog; a
  shared count group goes to one host evaluation without halving. On a
  store whose device is the card, each request fails with a typed
  `DeviceOOM` and nothing is evaluated on the host. Any other error fans
  out to every member untouched.
- Deadline scopes and quarantine on the reference's cases, parametrised
  over both packages.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import geomesa_tpu.faults as rfaults
import geomesa_tpu_torch.faults as pfaults
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.faults.fallback import host_fallback as r_host_fallback
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.planner import QueryTimeout as RQueryTimeout
from geomesa_tpu.serve.scheduler import QueryRejected as RRejected
from geomesa_tpu.serve.scheduler import ServeRequest as RRequest
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.planner import QueryTimeout as PQueryTimeout
from geomesa_tpu_torch.serve import QueryService, ServeConfig
from geomesa_tpu_torch.serve.scheduler import QueryRejected as PRejected
from geomesa_tpu_torch.utils.metrics import metrics as pmetrics

CQL = "BBOX(geom, -170, -80, 170, 80)"

PKG = {
    "ref": SimpleNamespace(f=rfaults, QueryTimeout=RQueryTimeout,
                           Rejected=RRejected),
    "port": SimpleNamespace(f=pfaults, QueryTimeout=PQueryTimeout,
                            Rejected=PRejected),
}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_faults"))
    rng = np.random.default_rng(9)
    n = 400
    sft = RSFT.from_spec("faulty", "name:String,score:Double,dtg:Date,*geom:Point")
    ref = RDataStore(root, use_device_cache=True)
    ref.create_schema(sft).write(RFB.from_pydict(sft, {
        "name": rng.choice(["a", "b", "c"], n).tolist(),
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_590_080_000_000, n),
        "geom": np.stack([rng.uniform(-170, 170, n),
                          rng.uniform(-80, 80, n)], 1)}))
    return {"ref": ref,
            "port": PDataStore(root, use_device_cache=True, device="cpu")}


@pytest.fixture
def services():
    made = []

    def make(store, **cfg):
        # the serial route: the ladder's cases patch planner.knn_launch
        svc = QueryService(store, ServeConfig(pipeline=False, ring=False,
                                              **cfg), autostart=False)
        made.append(svc)
        return svc

    yield make
    for svc in made:
        svc.close(drain=False, timeout_s=5.0)


def counter(name):
    with pmetrics._lock:
        return pmetrics.counters.get(name, 0)


# -- classify ---------------------------------------------------------------


@pytest.mark.parametrize("exc", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    pfaults.DeviceOOM("hbm")], ids=["torch", "torch.cuda", "DeviceOOM"])
def test_classify_cuda_oom_is_oom(exc):
    assert pfaults.classify(exc) == "oom"


NOT_OOM = [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: out of memory"),  # a launch error, not an alloc
    RuntimeError("nvcc failed building chord_blockmin.cu"),
    MemoryError("host allocation"),
    ValueError("x"), FileNotFoundError("gone"), PermissionError("denied"),
    IsADirectoryError("dir"), ConnectionResetError("x"), TimeoutError("t"),
    OSError("io")]


@pytest.mark.parametrize("exc", NOT_OOM, ids=lambda e: type(e).__name__)
def test_classify_matches_reference_and_never_oom(exc):
    assert pfaults.classify(exc) == rfaults.classify(exc)
    assert pfaults.classify(exc) != "oom"


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_taxonomy_cases(pkg):
    p = PKG[pkg]
    assert p.f.classify(OSError("x")) == "transient"
    assert p.f.classify(ConnectionResetError("x")) == "transient"
    assert p.f.classify(p.f.TransientError("x")) == "transient"
    assert p.f.classify(RuntimeError("x")) == "permanent"
    assert p.f.classify(p.f.PermanentError("x")) == "permanent"
    assert p.f.classify(FileNotFoundError("x")) == "permanent"
    assert p.f.classify(p.QueryTimeout("scan", 10.0, 5.0)) == "permanent"
    assert p.f.classify(p.f.DeviceOOM("hbm")) == "oom"


# -- deadline scopes and quarantine: the reference's cases, both packages ----


def _deadline_nested_keeps_tighter(f):
    with f.deadline_scope(50.0):
        with f.deadline_scope(80.0):
            assert f.current_deadline() == 50.0
        with f.deadline_scope(30.0):
            assert f.current_deadline() == 30.0
        with f.deadline_scope(None):
            assert f.current_deadline() == 50.0
    assert f.current_deadline() is None


def _quarantine_strikes_blocks_expires(f):
    t = [0.0]
    q = f.QuarantineRegistry(strikes=3, ttl_s=100.0, clock=lambda: t[0])
    key = ("knn", "t", "cql")
    assert q.blocked(key) is None
    assert not q.strike(key)
    assert not q.strike(key)
    assert q.strike(key)
    assert q.blocked(key) is not None
    assert q.blocked(("other",)) is None
    t[0] = 101.0
    assert q.blocked(key) is None


def _quarantine_full_table_keeps_strikes(f):
    t = [0.0]
    q = f.QuarantineRegistry(strikes=2, ttl_s=10.0, max_entries=1,
                             clock=lambda: t[0])
    q.strike("a")
    assert q.strike("a")
    t[0] = 5.0
    assert not q.strike("b")
    assert not q.strike("b")
    assert q.blocked("b") is None
    t[0] = 10.5
    assert q.strike("b")
    assert q.blocked("b") is not None


FABRIC = [_deadline_nested_keeps_tighter, _quarantine_strikes_blocks_expires,
          _quarantine_full_table_keeps_strikes]


@pytest.mark.parametrize("case", FABRIC, ids=[c.__name__[1:] for c in FABRIC])
@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_fabric_cases(pkg, case):
    case(PKG[pkg].f)


def test_one_crash_of_coalesced_batch_is_one_strike(stores, services,
                                                    monkeypatch):
    """N coalesced riders share the fingerprint: one crashing dispatch is
    ONE strike, so a 3-rider window does not quarantine the query."""
    src = stores["port"].get_feature_source("faulty")

    def crash(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(src.planner, "knn_launch", crash)
    svc = services(stores["port"], max_wait_ms=50.0, quarantine_after=3)
    futs = [svc.knn("faulty", CQL, np.array([1.0]), np.array([2.0]), k=3)
            for _ in range(3)]
    svc.start()
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result(timeout=60)
    with pytest.raises(RuntimeError):
        svc.knn("faulty", CQL, np.array([3.0]), np.array([4.0]),
                k=3).result(timeout=60)
    assert svc.quarantine.stats()["quarantined"] == 0


# -- the OOM ladder ---------------------------------------------------------


def oom(*a, **kw):
    raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 8.00 GiB")


def test_oom_halves_a_knn_window_down_to_host_eval(stores, services,
                                                   monkeypatch):
    """64 requests in one window: 63 halvings (64 -> 32 -> ... -> 1), then
    64 host evaluations, each equal to the reference's host_fallback."""
    src = stores["port"].get_feature_source("faulty")
    monkeypatch.setattr(src.planner, "knn_launch", oom)
    pts = np.random.default_rng(3).uniform(-60, 60, (64, 2))
    halved, hosteval = counter("serve.oom.halved"), counter("serve.oom.hosteval")
    svc = services(stores["port"], max_wait_ms=50.0)
    futs = [svc.knn("faulty", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=4)
            for i in range(64)]
    svc.start()
    got = [f.result(timeout=120) for f in futs]
    assert counter("serve.oom.halved") - halved == 63
    assert counter("serve.oom.hosteval") - hosteval == 64
    assert svc.stats()["dispatches"] == 1
    rsrc = stores["ref"].get_feature_source("faulty")
    for i, (d, ix, batch) in enumerate(got):
        req = RRequest(kind="knn", query=RQuery("faulty", CQL))
        req.qx, req.qy, req.k = pts[i:i + 1, 0], pts[i:i + 1, 1], 4
        rd, rix, rbatch = r_host_fallback(rsrc, req)
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(ix, rix)
        assert len(batch) == len(rbatch)
    # the host answers hold the device path's neighbours and meters too
    # (its indices point into the resident rows, so compare coordinates)
    monkeypatch.undo()
    for i in (0, 31, 63):
        d, ix, batch = src.knn(CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=4)
        hd, hix, hbatch = got[i]
        # the device rounds the same f64 meters once, to f32
        np.testing.assert_array_equal(hd.astype(d.dtype), d)
        np.testing.assert_array_equal(hbatch.geometry.x[hix], batch.geometry.x[ix])
        np.testing.assert_array_equal(hbatch.geometry.y[hix], batch.geometry.y[ix])


def test_oom_shared_count_group_host_evals_once(stores, services, monkeypatch):
    src = stores["port"].get_feature_source("faulty")
    base = src.get_count(CQL)
    monkeypatch.setattr(src.planner, "count_result", oom)
    halved, hosteval = counter("serve.oom.halved"), counter("fault.oom.hosteval")
    svc = services(stores["port"], max_wait_ms=50.0, result_cache=0)
    futs = [svc.count("faulty", CQL) for _ in range(4)]
    svc.start()
    counts = [f.result(timeout=120) for f in futs]
    assert counts == [base] * 4
    req = RRequest(kind="count", query=RQuery("faulty", CQL))
    assert r_host_fallback(stores["ref"].get_feature_source("faulty"), req) == base
    assert counter("serve.oom.halved") == halved
    assert counter("fault.oom.hosteval") - hosteval == 1


def test_oom_execute_host_rows_equal_reference(stores, services, monkeypatch):
    from geomesa_tpu_torch.plan.query import Query as PQuery

    src = stores["port"].get_feature_source("faulty")
    monkeypatch.setattr(src.planner, "execute", oom)
    svc = services(stores["port"])
    fut = svc.submit(pfaults_request("execute", PQuery("faulty", "score > 8")))
    svc.start()
    got = fut.result(timeout=120)
    ref = r_host_fallback(stores["ref"].get_feature_source("faulty"),
                          RRequest(kind="execute",
                                   query=RQuery("faulty", "score > 8")))
    assert got.kind == ref.kind == "features" and len(got.features) == len(ref.features)
    np.testing.assert_array_equal(np.asarray(got.features.columns["score"]),
                                  np.asarray(ref.features.columns["score"]))


OOM_SITE = {"knn": "knn_launch", "count": "count_result", "execute": "execute"}


@pytest.mark.parametrize("kind", sorted(OOM_SITE))
def test_oom_on_a_card_store_fails_typed_never_on_the_host(stores, services,
                                                            monkeypatch, kind):
    """A store whose device is the card: the ladder halves an 8-request
    kNN window down to single requests (a shared count or execute group
    does not halve) and then fails each future with a DeviceOOM that
    classifies as "oom". No request is evaluated on the host."""
    import geomesa_tpu_torch.faults.fallback as fallback

    src = stores["port"].get_feature_source("faulty")
    monkeypatch.setattr(src.planner, "device", torch.device("cuda"))
    monkeypatch.setattr(src.planner, OOM_SITE[kind], oom)

    def no_host_eval(*a, **kw):
        raise AssertionError("a card store's request was evaluated on the host")

    monkeypatch.setattr(fallback, "host_fallback", no_host_eval)
    names = ("serve.oom.halved", "serve.oom.hosteval", "serve.oom.failed")
    before = {n: counter(n) for n in names}
    svc = services(stores["port"], max_wait_ms=50.0, result_cache=0)
    if kind == "knn":
        futs = [svc.knn("faulty", CQL, np.array([float(i)]), np.array([1.0]),
                        k=2) for i in range(8)]
    elif kind == "count":
        futs = [svc.count("faulty", CQL) for _ in range(4)]
    else:
        futs = [svc.query("faulty", "score > 8") for _ in range(2)]
    svc.start()
    for f in futs:
        with pytest.raises(pfaults.DeviceOOM) as ei:
            f.result(timeout=60)
        assert pfaults.classify(ei.value) == "oom"
        assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)
    delta = {n: counter(n) - before[n] for n in names}
    assert delta == {"serve.oom.halved": 7 if kind == "knn" else 0,
                     "serve.oom.hosteval": 0,
                     "serve.oom.failed": 8 if kind == "knn" else 1}
    # the futures resolve before the dispatcher's bookkeeping: drain first
    svc.close(drain=True)
    assert svc.stats()["dispatches"] == 1
    assert svc.stats()["failed"] == len(futs)


def pfaults_request(kind, query):
    from geomesa_tpu_torch.serve import ServeRequest

    return ServeRequest(kind=kind, query=query)


def test_non_oom_error_fans_out_without_the_ladder(stores, services,
                                                   monkeypatch):
    src = stores["port"].get_feature_source("faulty")

    def launch_error(*a, **kw):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(src.planner, "knn_launch", launch_error)
    halved, hosteval = counter("serve.oom.halved"), counter("serve.oom.hosteval")
    svc = services(stores["port"], max_wait_ms=50.0)
    futs = [svc.knn("faulty", CQL, np.array([float(i)]), np.array([1.0]), k=2)
            for i in range(8)]
    svc.start()
    for f in futs:
        with pytest.raises(RuntimeError, match="launch failure"):
            f.result(timeout=60)
    assert counter("serve.oom.halved") == halved
    assert counter("serve.oom.hosteval") == hosteval
    # the futures resolve before the dispatcher's bookkeeping: drain first
    svc.close(drain=True)
    assert svc.stats()["failed"] == 8


def test_aggregation_hints_surface_typed(stores):
    from geomesa_tpu_torch.faults.fallback import host_execute
    from geomesa_tpu_torch.plan.hints import QueryHints
    from geomesa_tpu_torch.plan.query import Query

    q = Query("faulty", CQL, hints=QueryHints(density_bbox=(-10, -10, 10, 10),
                                              density_width=8, density_height=8))
    with pytest.raises(pfaults.PermanentError):
        host_execute(stores["port"].get_feature_source("faulty"), q)
