"""The port's KNearestNeighborSearchProcess against the reference's, on
the same seeded data: over a materialized FeatureBatch with every impl,
and over one store written by the reference (both packages open it, each
with its device cache) with every impl, through the widen loop.

Held: equal distances (the haversine route within 1e-6 m; mxu and grid,
which take f32 points into an f64 haversine as the reference does,
within 1e-7 relative: each point's cos is taken in f32, where the
packages' f32 cos differ in the last ulp; the f32-ranked scans' meters
within the bench's rule max(1 m, 1e-4 d)); the same rows behind
the indices (their x, y and speed, read through `KnnResult.features`);
the same widen rounds (a spy on each package's `window_query`, or on the
planner's `knn` for the planner route); the same `partial_recall` on a
store with fewer than k rows and an infinite maximum; the per-batch
capacity cache dropped after a forced overflow, as the reference's is.
The reference's scans run in Pallas interpret mode on the CPU.
"""

import numpy as np
import pytest
import torch

import geomesa_tpu.process.knn as ref_proc_mod
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan import DataStore as RDataStore
from geomesa_tpu.store.fs import FileSystemStorage as RStorage
import geomesa_tpu_torch.process.knn as port_proc_mod
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.errors import CudaUnavailableError
from geomesa_tpu_torch.plan import DataStore as PDataStore
from geomesa_tpu_torch.process import KNearestNeighborSearchProcess as PProc
from geomesa_tpu_torch.store.fs import FileSystemStorage as PStorage
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

SPEC = "speed:Double,dtg:Date,*geom:Point"
T0 = 1_600_000_000_000
DAY = 86400_000
K = 5
CQL = (f"BBOX(geom, -12, 36, 14, 56) AND dtg > {np.datetime64(T0 + 3600_000, 'ms')}Z"
       " AND speed > 5.0")
IMPLS = ["sparse", "fullscan", "haversine", "mxu", "grid", "auto"]


def cols(seed, n, days=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(30, 60, n)
    order = np.argsort(np.floor((x + 20) / 2.5) * 64 + np.floor((y - 30) / 2.5),
                       kind="stable")  # clustered tiles, as a store writes them
    return {"speed": rng.uniform(0, 30, n),
            "dtg": T0 + rng.integers(0, days * DAY, n),
            "geom": np.stack([x[order], y[order]], 1)}


def queries(seed, q):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-8, 10, q), rng.uniform(40, 52, q)], 1)
    return (RFB.from_pydict(RSFT.from_spec("q", "*geom:Point"), {"geom": pts}),
            PFB.from_pydict(PSFT.from_spec("q", "*geom:Point"), {"geom": pts}))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_knn_process"))
    c = cols(31, 40_000)  # three 16384-row data tiles for the fused scans
    rsrc = RDataStore(root, use_device_cache=True).create_schema(
        RSFT.from_spec("ais", SPEC))
    rsrc.write(RFB.from_pydict(rsrc.sft, c))
    psrc = PDataStore(root, use_device_cache=True, device="cpu"
                      ).get_feature_source("ais")
    return dict(root=root, cols=c, ref_src=rsrc, port_src=psrc,
                ref_batch=RFB.from_pydict(RSFT.from_spec("ais", SPEC), c),
                port_batch=PFB.from_pydict(PSFT.from_spec("ais", SPEC), c),
                q=queries(32, 12))


def rows(res):
    """(x, y, speed) of the rows behind the finite-distance indices."""
    f = res.features
    fin = np.isfinite(res.distances_m)
    i = res.indices[fin]
    return np.stack([np.asarray(f.geometry.x)[i], np.asarray(f.geometry.y)[i],
                     np.asarray(f.columns["speed"])[i]], 1)


def tolerance(impl, d):
    """Meters two packages' distances may differ by (module docstring)."""
    if impl in ("sparse", "fullscan"):
        return np.maximum(1.0, 1e-4 * d)
    if impl in ("mxu", "grid"):
        return 1e-6 + 1e-7 * d
    return 1e-6


def assert_same(r, p, impl):
    assert p.distances_m.shape == r.distances_m.shape
    assert p.partial_recall == r.partial_recall
    rd, pd = r.distances_m, p.distances_m
    np.testing.assert_array_equal(np.isfinite(pd), np.isfinite(rd))
    fin = np.isfinite(rd)
    assert np.all(np.abs(pd[fin] - rd[fin]) <= tolerance(impl, rd[fin]))
    np.testing.assert_array_equal(rows(p), rows(r))


@pytest.mark.parametrize("impl", IMPLS)
def test_batch_routes_match_reference(data, impl):
    rq, pq = data["q"]
    r = ref_proc_mod.KNearestNeighborSearchProcess().execute(
        rq, data["ref_batch"], num_desired=K, cql_filter=CQL, impl=impl)
    p = PProc().execute(pq, data["port_batch"], num_desired=K, cql_filter=CQL,
                        impl=impl, device="cpu")
    assert np.isfinite(p.distances_m).all()
    assert_same(r, p, impl)


def test_batch_mxu_route_with_its_certificate(data):
    """150 queries: knn_mxu itself runs (below 128 it defers to knn), and
    the queries its certificate flags are re-run on knn in both."""
    rq, pq = queries(34, 150)
    kw = dict(num_desired=K, cql_filter=CQL, impl="mxu")
    r = ref_proc_mod.KNearestNeighborSearchProcess().execute(
        rq, data["ref_batch"], **kw)
    p = PProc().execute(pq, data["port_batch"], device="cpu", **kw)
    assert np.isfinite(p.distances_m).all()
    assert_same(r, p, "mxu")


def spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def planner_spy(monkeypatch, planner):
    calls = []
    real = planner.knn

    def wrapped(*a, **kw):
        calls.append(kw.get("impl"))
        return real(*a, **kw)

    monkeypatch.setattr(planner, "knn", wrapped)
    return calls


@pytest.mark.parametrize("impl", IMPLS)
def test_store_routes_match_reference(data, monkeypatch, impl):
    """From a 4 km estimate the window widens several rounds; sparse and
    fullscan take the planner's scan, the rest the window path."""
    rq, pq = data["q"]
    rw = spy(monkeypatch, ref_proc_mod, "window_query")
    pw = spy(monkeypatch, port_proc_mod, "window_query")
    rk = planner_spy(monkeypatch, data["ref_src"].planner)
    pk = planner_spy(monkeypatch, data["port_src"].planner)
    kw = dict(num_desired=K, cql_filter=CQL, impl=impl,
              estimated_distance_m=4000.0)
    r = ref_proc_mod.KNearestNeighborSearchProcess().execute(
        rq, data["ref_src"], **kw)
    p = PProc().execute(pq, data["port_src"], device="cpu", **kw)
    assert (len(pw), len(pk)) == (len(rw), len(rk))
    assert max(len(pw), len(pk)) >= 3  # the loop widened
    assert np.isfinite(p.distances_m).all()
    # the planner's scans report canonical f64 meters
    assert_same(r, p, "haversine" if impl in ("sparse", "fullscan") else impl)


def test_store_auto_takes_the_planner_and_its_stats(data, monkeypatch):
    """At 2^20 rows or more, auto runs the planner's scan and the planner
    resolves auto from the stats sketches (the store's count patched,
    as tests/test_stats_selection.py does for the reference)."""
    rq, pq = data["q"]
    for storage in (RStorage, PStorage):
        monkeypatch.setattr(storage, "count", property(lambda self: 1 << 21))
    rk = planner_spy(monkeypatch, data["ref_src"].planner)
    pk = planner_spy(monkeypatch, data["port_src"].planner)
    rw = spy(monkeypatch, ref_proc_mod, "window_query")
    pw = spy(monkeypatch, port_proc_mod, "window_query")
    kw = dict(num_desired=K, cql_filter=CQL, impl="auto",
              estimated_distance_m=4000.0)
    r = ref_proc_mod.KNearestNeighborSearchProcess().execute(
        rq, data["ref_src"], **kw)
    p = PProc().execute(pq, data["port_src"], device="cpu", **kw)
    assert pk == rk and len(pk) >= 3 and set(pk) == {"auto"}
    assert pw == rw == []
    assert_same(r, p, "haversine")


def test_partial_recall_on_a_short_store(tmp_path, monkeypatch):
    """Two rows for k=5 and no maximum: the loop never fills and stops at
    MAX_WIDEN_ROUNDS in both, flagged partial_recall."""
    root = str(tmp_path / "short")
    c = {"speed": np.array([6.0, 7.0]), "dtg": np.array([T0, T0 + 5]),
         "geom": np.array([[1.0, 45.0], [2.0, 46.0]])}
    rsrc = RDataStore(root, use_device_cache=True).create_schema(
        RSFT.from_spec("ais", SPEC))
    rsrc.write(RFB.from_pydict(rsrc.sft, c))
    psrc = PDataStore(root, use_device_cache=True, device="cpu"
                      ).get_feature_source("ais")
    rq, pq = queries(33, 3)
    rw = spy(monkeypatch, ref_proc_mod, "window_query")
    pw = spy(monkeypatch, port_proc_mod, "window_query")
    kw = dict(num_desired=K, estimated_distance_m=1e7,
              max_search_distance_m=float("inf"), impl="haversine")
    r = ref_proc_mod.KNearestNeighborSearchProcess().execute(rq, rsrc, **kw)
    p = PProc().execute(pq, psrc, device="cpu", **kw)
    assert p.partial_recall and r.partial_recall
    assert len(pw) == len(rw) == port_proc_mod.MAX_WIDEN_ROUNDS + 1
    assert np.isinf(p.distances_m[:, 2:]).all()
    assert_same(r, p, "haversine")


def test_capacity_cache_dropped_after_forced_overflow(data):
    rq, pq = data["q"]
    rproc = ref_proc_mod.KNearestNeighborSearchProcess()
    pproc = PProc()
    kw = dict(num_desired=K, cql_filter=CQL, impl="sparse")
    rproc.execute(rq, data["ref_batch"], **kw)
    pproc.execute(pq, data["port_batch"], device="cpu", **kw)
    key = (CQL, K)
    rslot = rproc._cap_cache[id(data["ref_batch"])]
    pslot = pproc._cap_cache[id(data["port_batch"])]
    assert pslot[key] == rslot[key] > 1
    rslot[key] = pslot[key] = 1  # one tile: the query's tiles overflow it
    r = rproc.execute(rq, data["ref_batch"], **kw)
    p = pproc.execute(pq, data["port_batch"], device="cpu", **kw)
    assert key not in pslot and key not in rslot  # recalibrate next time
    assert_same(r, p, "sparse")
    # the slot lives as long as its batch
    batch = PFB.from_pydict(PSFT.from_spec("ais", SPEC), data["cols"])
    pproc.execute(pq, batch, device="cpu", **kw)
    bkey = id(batch)
    assert bkey in pproc._cap_cache
    del batch
    assert bkey not in pproc._cap_cache


def test_default_device_is_the_card(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the process runs on it")
    _, pq = data["q"]
    with pytest.raises(CudaUnavailableError):
        PProc().execute(pq, data["port_batch"], num_desired=K)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", IMPLS)
def test_batch_routes_on_the_card_match_the_cpu(data, impl):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, pq = data["q"]
    kw = dict(num_desired=K, cql_filter=CQL, impl=impl)
    c = PProc().execute(pq, data["port_batch"], device="cpu", **kw)
    g = PProc().execute(pq, data["port_batch"], device="cuda", **kw)
    assert_same(c, g, "sparse")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("impl", ["haversine", "mxu", "grid"])
def test_nan_rows_report_no_neighbour_as_the_reference(impl, dtype):
    """C1 through the process: a batch of 5,000 rows with 30 NaN x or y
    (ROADMAP C1's probe B; the f32 case rounds the coordinates to f32
    first) under INCLUDE. The engine ranks the NaN rows first on these
    routes; the process's `dists <= max_dist` turns them into +inf, so
    those slots report no neighbour, in both packages. On the grid route
    the NaN rows sit in the corner cell, out of these queries' rings, and
    the certificate proves their finite neighbours, in both packages."""
    rng = np.random.default_rng(2)
    n = 5000
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(30, 60, n)
    x[rng.choice(n, 15, replace=False)] = np.nan
    y[rng.choice(n, 15, replace=False)] = np.nan
    pts = np.stack([x, y], 1).astype(dtype).astype(np.float64)
    c = {"speed": rng.uniform(0, 30, n), "dtg": T0 + rng.integers(0, DAY, n),
         "geom": pts}
    rb = RFB.from_pydict(RSFT.from_spec("ais", SPEC), c)
    pb = PFB.from_pydict(PSFT.from_spec("ais", SPEC), c)
    rq, pq = queries(35, 3)
    r = ref_proc_mod.KNearestNeighborSearchProcess().execute(
        rq, rb, num_desired=K, impl=impl)
    p = PProc().execute(pq, pb, num_desired=K, impl=impl, device="cpu")
    assert not np.isnan(p.distances_m).any()
    # the NaN slots: no neighbour
    assert np.isinf(p.distances_m).any() == (impl != "grid")
    assert_same(r, p, impl)
    np.testing.assert_array_equal(p.indices[~np.isfinite(p.distances_m)],
                                  r.indices[~np.isfinite(r.distances_m)])
