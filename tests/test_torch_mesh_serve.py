"""Sharded serving on the port against the reference's, on the CPU.

After tests/test_mesh_serve.py and tests/test_device_cache.py's
TestMeshGrowthDelta: one catalog of 4 day partitions x 256 rows, so
under a 4-shard mesh (shard_rows = 1024 / 4 = 256) partition i lives on
shard i alone. The port serves it over four `cpu` shards; the reference
over the first 4 of its 8 CPU devices (through its planner, which takes
the same mesh routes), and a single-device port store over the same
files is the oracle: neighbour sets identical and meters bit-identical
(`_canonical_dists`), counts identical, density counts exact, the
`mesh_shape`/`shards` strings and the growth's upload rows equal to the
reference's. The ring's mesh programs are held in
tests/test_torch_mesh_ring.py.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import geomesa_tpu.serve.batcher as rbatcher
import geomesa_tpu_torch.serve as pserve
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.parallel.mesh import default_mesh as rdefault_mesh
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.parallel.mesh import default_mesh
from geomesa_tpu_torch.plan.audit import ServeEvent
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.utils.metrics import metrics
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

D = 4
ROWS_PER_DAY = 256
DAYS = ("2020-06-01", "2020-06-02", "2020-06-03", "2020-06-04")
SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
CQL = "BBOX(geom, -170, -80, 170, 80) AND score > -5"
# prunes (yyyy/MM/dd days) to day 3 = partition 2 = shard 2 alone
CQL_DAY3 = CQL + " AND dtg DURING 2020-06-03T00:00:00Z/2020-06-03T23:59:59Z"
DENSITY = dict(density_bbox=(-170, -80, 170, 80), density_width=32,
               density_height=32)


def _day_millis(day: str) -> int:
    return int(np.datetime64(day, "ms").astype(np.int64))


def rows(per_day=ROWS_PER_DAY, days=DAYS, seed=11):
    rng = np.random.default_rng(seed)
    n = per_day * len(days)
    dtg = np.concatenate([_day_millis(d) + rng.integers(
        6 * 3600_000, 18 * 3600_000, per_day) for d in days])
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-10, 10, n), "dtg": dtg,
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}


def _counter(name: str) -> float:
    return json.loads(metrics.to_json())["counters"].get(name, 0.0)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_mesh_serve"))
    sft = RSFT.from_spec("meshed", SPEC)
    RDataStore(root, use_device_cache=True).create_schema(sft).write(
        RFB.from_pydict(sft, rows()))
    ref = RDataStore(root, use_device_cache=True)
    ref.set_mesh(rdefault_mesh(jax.devices()[:D]))
    return SimpleNamespace(
        ref=ref, single=PDataStore(root, use_device_cache=True, device="cpu"),
        mesh=PDataStore(root, use_device_cache=True, device="cpu"), root=root)


@pytest.fixture
def services():
    made = []

    def make(store, pipeline=False, **kw):
        svc = pserve.QueryService(store, pserve.ServeConfig(
            mesh=default_mesh(["cpu"] * D), ring=False, pipeline=pipeline,
            max_wait_ms=20.0, **kw), autostart=False)
        made.append(svc)
        return svc

    yield make
    for svc in made:
        svc.close(drain=False, timeout_s=5.0)


def ref_route_strings(stores, cql):
    """The reference's ServeEvent strings for a window of `cql`: its
    planner's mesh launch through its `note_launch_route`."""
    launch = stores.ref.get_feature_source("meshed").planner.knn_launch(
        RQuery("meshed", cql), np.array([1.0]), np.array([2.0]), k=5)
    launch.sync()
    req = SimpleNamespace(mesh_shape="", shards="")
    rbatcher.note_launch_route([req], launch)
    return req.mesh_shape, req.shards


def assert_same(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    assert np.array_equal(a[0], b[0]), (a[0], b[0])  # bit-identical meters


def coords(out):
    """Per query: the neighbours' coordinates (row ids differ between
    the packages' batches only if their layouts did)."""
    d, idx, batch = out
    col = batch.columns["geom"]
    return [sorted(zip(col.x[i].tolist(), col.y[i].tolist())) for i in idx]


@pytest.mark.parametrize("route", ["serial", "pipelined"])
def test_mesh_window_bit_identical(stores, services, route):
    """Ten coalesced kNN requests run as ONE sharded program over the
    four shards (`knn.mesh.dispatches`), answers equal to the single-
    device store's and to the reference's mesh, and every ServeEvent
    names the topology and the owning shards as the reference's do."""
    rng = np.random.default_rng(42)
    q = rng.uniform(-60, 60, (10, 2))
    single = stores.single.get_feature_source("meshed")
    ref = stores.ref.get_feature_source("meshed")
    svc = services(stores.mesh, pipeline=route == "pipelined")
    base = _counter("knn.mesh.dispatches")
    n_events = len(stores.mesh.audit.events)
    futs = [svc.knn("meshed", CQL, q[i:i + 1, 0], q[i:i + 1, 1], k=5)
            for i in range(10)]
    svc.start()
    got = [f.result(timeout=120) for f in futs]
    svc.close(drain=True)
    assert svc.stats()["dispatches"] == 1, svc.stats()
    assert _counter("knn.mesh.dispatches") - base == 1
    for i, out in enumerate(got):
        s = single.knn(CQL, q[i:i + 1, 0], q[i:i + 1, 1], k=5)
        assert_same(out, s)
        r = ref.knn(CQL, q[i:i + 1, 0], q[i:i + 1, 1], k=5)
        assert coords(out) == coords(r)
        assert np.array_equal(out[0], np.asarray(r[0]))
    events = [e for e in stores.mesh.audit.events[n_events:]
              if isinstance(e, ServeEvent)]
    assert len(events) == 10
    want = ref_route_strings(stores, CQL)
    assert want == ("(4,)", "0,1,2,3")
    assert all((e.mesh_shape, e.shards) == want for e in events), events


def test_count_density_and_features_equal(stores, services):
    svc = services(stores.mesh)
    svc.start()
    try:
        cnt = svc.count("meshed", CQL).result(timeout=120)
        dens = svc.query("meshed", CQL, hints=PHints(**DENSITY)).result(
            timeout=120)
    finally:
        svc.close(drain=True)
    single = stores.single.get_feature_source("meshed")
    ref = stores.ref.get_feature_source("meshed")
    assert cnt == single.get_count(CQL) == ref.get_count(CQL)
    sgrid = single.get_features(PQuery("meshed", CQL, hints=PHints(**DENSITY))).grid
    rgrid = ref.get_features(RQuery("meshed", CQL, hints=RHints(**DENSITY))).grid
    assert np.array_equal(np.asarray(dens.grid), sgrid)
    assert np.array_equal(np.asarray(dens.grid), np.asarray(rgrid))
    box = "BBOX(geom, -40, -30, 40, 30) AND score > 2"
    mf = stores.mesh.get_feature_source("meshed").get_features(box).features
    sf = single.get_features(box).features
    pts = lambda b: sorted(zip(b.columns["geom"].x.tolist(),  # noqa: E731
                               b.columns["geom"].y.tolist()))
    assert len(mf) > 0 and pts(mf) == pts(sf)


def test_shard_affinity_routes_to_owner(stores, services):
    """A window whose pruned partitions live on ONE shard runs there alone
    (`knn.mesh.local_dispatches`); its answers and its ServeEvent's shard
    equal the reference's; admission tags the request with that shard."""
    svc = services(stores.mesh)
    svc.start()
    try:
        svc.count("meshed", CQL).result(timeout=120)  # residency warm
        for other in (stores.ref, stores.single):  # every partition resident
            other.get_feature_source("meshed").get_count(CQL)
        sb = stores.mesh.get_feature_source("meshed").planner.cache.superbatch()
        rsb = stores.ref.get_feature_source("meshed").planner.cache.superbatch()
        assert sb.shard_rows == rsb.shard_rows == ROWS_PER_DAY
        assert sb.owners == rsb.owners
        assert sorted(sb.owners.values()) == [(0,), (1,), (2,), (3,)]
        q = np.random.default_rng(7).uniform(-60, 60, (1, 2))
        base = _counter("knn.mesh.local_dispatches")
        tagged = _counter('serve.affinity.admitted{shards="2"}')
        n_events = len(stores.mesh.audit.events)
        out = svc.knn("meshed", CQL_DAY3, q[:, 0], q[:, 1], k=5).result(
            timeout=120)
    finally:
        svc.close(drain=True)
    assert _counter("knn.mesh.local_dispatches") - base == 1
    assert _counter('serve.affinity.admitted{shards="2"}') - tagged == 1
    events = [e for e in stores.mesh.audit.events[n_events:]
              if isinstance(e, ServeEvent) and e.kind == "knn"]
    assert len(events) == 1
    assert (events[0].mesh_shape, events[0].shards) == ref_route_strings(
        stores, CQL_DAY3) == ("(4,)", "2")
    assert_same(out, stores.single.get_feature_source("meshed").knn(
        CQL_DAY3, q[:, 0], q[:, 1], k=5))
    r = stores.ref.get_feature_source("meshed").knn(CQL_DAY3, q[:, 0], q[:, 1], k=5)
    assert coords(out) == coords(r)


def test_overflow_falls_back_to_the_dense_mesh_scan(tmp_path):
    """A capacity below the shards' match tiles overflows the sparse mesh
    program; sync runs the dense sharded scan (B2 on every shard), the
    answers stay the single-device ones and the capacity is dropped."""
    sft = PSFT.from_spec("meshed", SPEC)
    root = str(tmp_path / "wide")
    PDataStore(root, device="cpu").create_schema(sft).write(
        PFB.from_pydict(sft, rows(per_day=1 << 15, seed=5)))
    mesh_src = PDataStore(root, use_device_cache=True, device="cpu",
                          mesh=default_mesh(["cpu"] * D)).get_feature_source("meshed")
    single = PDataStore(root, use_device_cache=True, device="cpu"
                        ).get_feature_source("meshed")
    q = np.random.default_rng(3).uniform(-60, 60, (8, 2))
    first = mesh_src.knn(CQL, q[:, 0], q[:, 1], k=5)
    planner = mesh_src.planner
    key = next(k for k in planner._knn_caps if k[2] == ("mesh", D))
    planner._knn_caps[key] = 1  # each shard holds 2 tiles: it overflows
    launch = planner.knn_launch(PQuery("meshed", CQL), q[:, 0], q[:, 1], k=5)
    assert launch.impl == "mesh" and launch._dense is not None
    over = launch.sync()
    assert key not in planner._knn_caps
    s = single.knn(CQL, q[:, 0], q[:, 1], k=5)
    assert_same(first, s)
    assert_same(over, s)


def test_growth_uploads_delta_rows_as_the_reference(tmp_path):
    """The port's counterpart of TestMeshGrowthDelta: appending months
    uploads only the new rows and the mesh padding (equal appends, equal
    uploads, below the resident size), a rewrite of a resident partition
    takes the full re-upload, and every step's upload rows and count
    equal the reference's."""
    from geomesa_tpu.store.partition import DateTimeScheme as RScheme
    from geomesa_tpu_torch.store.partition import DateTimeScheme as PScheme

    rng = np.random.default_rng(7)

    def mk(n, month):
        t0 = np.datetime64(f"2020-{month:02d}-10").astype(
            "datetime64[ms]").astype(np.int64)
        return {"actor": rng.choice(["AA", "BB"], n).tolist(),
                "score": rng.uniform(-5, 5, n),
                "dtg": t0 + rng.integers(0, 86_400_000, n),
                "geom": np.stack([rng.uniform(-10, 10, n),
                                  rng.uniform(-10, 10, n)], 1)}

    writes = [mk(50, 6), mk(40, 7), mk(40, 8), mk(30, 6)]
    spec = "actor:String,score:Double,dtg:Date,*geom:Point"
    q = "BBOX(geom, -20, -20, 20, 20)"
    trace = {}
    for tag, DS, SFT, FB, Scheme, mesh, kw in (
            ("ref", RDataStore, RSFT, RFB, RScheme,
             rdefault_mesh(jax.devices()[:D]), {}),
            ("port", PDataStore, PSFT, PFB, PScheme,
             default_mesh(["cpu"] * D), {"device": "cpu"})):
        sft = SFT.from_spec("t", spec)
        ds = DS(str(tmp_path / tag), use_device_cache=True, **kw)
        src = ds.create_schema(sft, Scheme("yyyy/MM"))
        src.write(FB.from_pydict(sft, writes[0]))
        ds.set_mesh(mesh)
        counts = [src.get_count(q)]
        cache = src.planner.cache
        assert cache.superbatch_peek().mesh is mesh
        uploads = [cache.upload_rows]
        for w in writes[1:]:
            src.write(FB.from_pydict(sft, w))
            counts.append(src.get_count(q))
            uploads.append(cache.upload_rows)
        trace[tag] = (counts, uploads,
                      sum(e.padded for e in cache._entries.values()))
    assert trace["port"] == trace["ref"]
    counts, uploads, resident = trace["port"]
    deltas = np.diff(uploads).tolist()
    assert deltas[0] == deltas[1] < resident  # the delta path
    assert deltas[2] > deltas[1]  # a rewritten partition: the full re-tier
    assert counts == [50, 90, 130, 160]


def test_set_mesh_retier_ring_refusal_and_value_equality(stores, services):
    """set_mesh is a no-op for an equal mesh (by value); a new mesh drops
    the single-device segments and re-tiers with one upload of every
    resident row, sharded; the ring arms on a mesh superbatch (the mesh
    program over the four shards); clearing the mesh re-uploads the
    whole concat and answers the same; a service asking for a mesh with
    the ring, or inheriting the store's mesh with the default ring, now
    constructs and keeps the ring on."""
    src = PDataStore(stores.root, use_device_cache=True,
                     device="cpu").get_feature_source("meshed")
    cache = src.planner.cache
    src.get_count(CQL)  # single-device residency: one segment a partition
    assert all(e.dev is not None for e in cache._entries.values())
    mesh = default_mesh(["cpu"] * D)
    cache.set_mesh(mesh)
    v = cache._version
    assert all(e.dev is None for e in cache._entries.values())
    cache.set_mesh(default_mesh(["cpu"] * D))  # equal by value
    assert cache._version == v and cache.mesh is mesh
    before = cache.upload_rows
    sb = cache.superbatch()
    assert cache.upload_rows - before == len(sb.batch) == D * ROWS_PER_DAY
    assert cache.serving_mesh() is mesh and sb.dev["geom__x"].shard_rows == 256
    prog = src.planner.ring_arm(PQuery("meshed", CQL), 64, k=5)
    assert prog.impl == "mesh" and prog.shards == (0, 1, 2, 3)
    assert prog.mesh_shape == (D,) and prog.device == mesh.lead
    q = np.array([3.0]), np.array([4.0])
    on_mesh = src.knn(CQL, *q, k=5)
    cache.set_mesh(None)  # back to one device: the whole concat uploads
    before = cache.upload_rows
    assert cache.superbatch().mesh is None
    assert cache.upload_rows - before == D * ROWS_PER_DAY
    assert_same(src.knn(CQL, *q, k=5), on_mesh)
    for store, cfg in ((stores.mesh, pserve.ServeConfig(mesh=mesh)),
                       (PDataStore(stores.root, device="cpu", mesh=mesh),
                        pserve.ServeConfig())):
        svc = pserve.QueryService(store, cfg, autostart=False)
        try:
            assert svc.mesh == mesh and svc.config.ring
        finally:
            svc.close(drain=False, timeout_s=5.0)
    svc = services(stores.mesh)
    assert svc.mesh == mesh and svc.stats()["mesh"] == {"shape": [4], "devices": 4}
