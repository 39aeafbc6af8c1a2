"""The ring's mesh programs on the port against the serial and pipelined
mesh routes, the single-device ring and the reference's serial mesh
route, on the CPU (and, `cuda`-marked, replayed from CUDA graphs on the
card).

One catalog of 4 day partitions x 1024 rows, so under a 4-shard mesh
partition i lives on shard i. A ring window on the mesh runs the mesh
serving program over the frozen per-shard masks (B1 a shard, the merge on
the lead device): every window must be bit-identical (indices and
meters) to the serial and pipelined mesh routes and to the single-device
ring, neighbour coordinates and meters equal to the reference's serial
mesh route, its ServeEvents must name the mesh and its shards, a plan on
one shard refuses ("shard_affinity") and a growth write stales the
capture, which re-arms.
"""

import gc
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import geomesa_tpu_torch.serve as pserve
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.parallel.mesh import default_mesh as rdefault_mesh
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu_torch.compilecache.registry import registry
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.parallel.mesh import Mesh as PMesh, default_mesh
from geomesa_tpu_torch.plan.audit import ServeEvent
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.planner import RingIneligible
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.utils.metrics import metrics
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

D = 4
PER_DAY = 1024
WINDOWS = 18
DAYS = ("2020-06-01", "2020-06-02", "2020-06-03", "2020-06-04")
SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
CQL = "BBOX(geom, -150, -70, 150, 70) AND score > -6"
CQL_DAY3 = CQL + " AND dtg DURING 2020-06-03T00:00:00Z/2020-06-03T23:59:59Z"


def _day_millis(day: str) -> int:
    return int(np.datetime64(day, "ms").astype(np.int64))


def rows(days=DAYS, per_day=PER_DAY, seed=41):
    rng = np.random.default_rng(seed)
    n = per_day * len(days)
    dtg = np.concatenate([_day_millis(d) + rng.integers(
        6 * 3600_000, 18 * 3600_000, per_day) for d in days])
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-10, 10, n), "dtg": dtg,
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}


def counter(name: str) -> float:
    return json.loads(metrics.to_json())["counters"].get(name, 0.0)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_mesh_ring"))
    sft = RSFT.from_spec("meshed", SPEC)
    RDataStore(root, use_device_cache=True).create_schema(sft).write(
        RFB.from_pydict(sft, rows()))
    ref = RDataStore(root, use_device_cache=True)
    ref.set_mesh(rdefault_mesh(jax.devices()[:D]))
    return SimpleNamespace(
        root=root, ref=ref.get_feature_source("meshed"),
        single=PDataStore(root, use_device_cache=True, device="cpu"),
        mesh=PDataStore(root, use_device_cache=True, device="cpu",
                        mesh=default_mesh(["cpu"] * D)))


def serve(store, pts, cql=CQL, counts=0, **cfg):
    """One window a request (submitted and answered in turn), plus
    `counts` count riders on the first window; returns (answers, the
    service's pipeline stats with its mesh captures, its new ServeEvents,
    the counts)."""
    svc = pserve.QueryService(store, pserve.ServeConfig(
        max_wait_ms=0.0, **cfg))
    n_events = len(store.audit.events)
    try:
        cfut = [svc.count("meshed", cql) for _ in range(counts)]
        got = [svc.knn("meshed", cql, pts[i:i + 1, 0], pts[i:i + 1, 1],
                       k=6).result(timeout=120) for i in range(len(pts))]
        cnt = [f.result(timeout=120) for f in cfut]
        st = svc.stats().get("pipeline", {})
        # closing the service drops its captures: take them now
        st["captures"] = [c for c in registry.held() if c.mesh_parts is not None]
    finally:
        svc.close(drain=True)
    events = [e for e in store.audit.events[n_events:]
              if isinstance(e, ServeEvent) and e.kind == "knn"]
    return got, st, events, cnt


def same(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    assert np.array_equal(a[0], b[0]), (a[0], b[0])


def test_ring_windows_bit_identical_to_every_route(stores):
    """18 consecutive ring windows on the mesh (one armed program, no
    fallback) equal the serial and pipelined mesh routes and the
    single-device ring bit for bit, and the reference's serial mesh
    route's neighbours and meters; each ServeEvent names "(4,)" and the
    four shards; each ring window is one mesh dispatch."""
    registry.clear()
    pts = np.random.default_rng(3).uniform(-60, 60, (WINDOWS, 2))
    base = counter("knn.mesh.dispatches")
    ring, st, events, _ = serve(stores.mesh, pts)
    assert st["ring"]["windows"] == WINDOWS and st["ring"]["fallbacks"] == {}
    assert st["ring"]["armed"] == 1
    assert counter("knn.mesh.dispatches") - base == WINDOWS
    assert len(events) == WINDOWS
    assert all((e.mesh_shape, e.shards) == ("(4,)", "0,1,2,3") for e in events)
    serial, _, _, _ = serve(stores.mesh, pts, pipeline=False, ring=False)
    piped, pst, _, _ = serve(stores.mesh, pts, ring=False)
    assert "ring" not in pst or pst["ring"]["windows"] == 0
    single, sst, _, _ = serve(stores.single, pts)
    assert sst["ring"]["windows"] == WINDOWS
    ref = stores.ref
    for i in range(WINDOWS):
        for other in (serial[i], piped[i], single[i]):
            same(ring[i], other)
        rd, ri, rb = ref.knn(CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=6)
        pb = ring[i][2].columns["geom"]
        rg = rb.columns["geom"]
        assert (pb.x[ring[i][1]] == rg.x[np.asarray(ri)]).all()
        assert (pb.y[ring[i][1]] == rg.y[np.asarray(ri)]).all()
        assert np.array_equal(ring[i][0], np.asarray(rd))


def test_fused_count_rides_the_mesh_ring(stores):
    """A count coalesced into a ring window answers from the arm-time
    psum of the per-shard masks: the exact count."""
    registry.clear()
    pts = np.random.default_rng(4).uniform(-60, 60, (2, 2))
    got, st, _, cnt = serve(stores.mesh, pts, counts=3, max_batch=8)
    want = stores.single.get_feature_source("meshed").get_count(CQL)
    assert cnt == [want] * 3
    assert st["ring"]["windows"] >= 1


def test_one_shard_plan_refuses_shard_affinity(stores):
    """A plan pruned to one partition (one shard) is refused typed; the
    service serves it on the shard-affinity route, metered as a
    "shard_affinity" fallback, with the single-device answers."""
    src = stores.mesh.get_feature_source("meshed")
    src.get_count(CQL)  # every partition resident
    with pytest.raises(RingIneligible) as ei:
        src.planner.ring_arm(PQuery("meshed", CQL_DAY3), 8, k=6)
    assert ei.value.reason == "shard_affinity"
    pts = np.random.default_rng(5).uniform(-60, 60, (3, 2))
    base = counter("knn.mesh.local_dispatches")
    got, st, events, _ = serve(stores.mesh, pts, cql=CQL_DAY3)
    assert st["ring"]["fallbacks"] == {"shard_affinity": 3}
    assert counter("knn.mesh.local_dispatches") - base == 3
    assert all((e.mesh_shape, e.shards) == ("(4,)", "2") for e in events)
    single = stores.single.get_feature_source("meshed")
    # the same residency as the mesh's: kNN indices count resident rows
    single.get_count(CQL)
    for i in range(3):
        same(got[i], single.knn(CQL_DAY3, pts[i:i + 1, 0], pts[i:i + 1, 1],
                                k=6))


def test_growth_write_stales_the_capture_and_it_rearms(tmp_path):
    """A write that grows residency moves the superbatch and the manifest
    version: the next window falls back ("stale", served on the pipelined
    route), the one after re-arms over the new superbatch, and every
    answer equals a single-device store's over the same files."""
    sft = PSFT.from_spec("meshed", SPEC)
    root = str(tmp_path)
    PDataStore(root, device="cpu").create_schema(sft).write(
        PFB.from_pydict(sft, rows(days=DAYS[:3], per_day=256, seed=8)))
    mesh_ds = PDataStore(root, use_device_cache=True, device="cpu",
                         mesh=default_mesh(["cpu"] * D))
    single = PDataStore(root, use_device_cache=True,
                        device="cpu").get_feature_source("meshed")
    pts = np.random.default_rng(6).uniform(-60, 60, (6, 2))
    pre = [single.knn(CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=6)
           for i in (0, 1)]
    svc = pserve.QueryService(mesh_ds, pserve.ServeConfig(max_wait_ms=0.0))
    try:
        def ask(i):
            return svc.knn("meshed", CQL, pts[i:i + 1, 0], pts[i:i + 1, 1],
                           k=6).result(timeout=120)

        got = [ask(0), ask(1)]
        sb0 = mesh_ds.get_feature_source("meshed").planner.cache.superbatch_peek()
        mesh_ds.get_feature_source("meshed").write(PFB.from_pydict(
            sft, rows(days=DAYS[3:], per_day=256, seed=9)))
        got += [ask(i) for i in range(2, 6)]
        st = svc.stats()["pipeline"]["ring"]
    finally:
        svc.close(drain=True)
    sb1 = mesh_ds.get_feature_source("meshed").planner.cache.superbatch_peek()
    assert sb1 is not sb0 and sb1.shard_rows != sb0.shard_rows
    assert st["fallbacks"] == {"stale": 1} and st["armed"] == 2
    assert st["windows"] == 5
    held = [c for c in registry.held() if c.frozen.get("sb") is sb0]
    assert held == []  # the old layout's capture went with the re-arm
    for i in (0, 1):
        same(got[i], pre[i])
    after = PDataStore(root, use_device_cache=True,
                       device="cpu").get_feature_source("meshed")
    for i in range(2, 6):
        same(got[i], after.knn(CQL, pts[i:i + 1, 0], pts[i:i + 1, 1], k=6))


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card_mesh_store(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mesh ring's CUDA graphs "
                    "replay there")
    sft = PSFT.from_spec("meshed", SPEC)
    PDataStore(str(tmp_path), device="cuda").create_schema(sft).write(
        PFB.from_pydict(sft, rows(per_day=1 << 14, seed=12)))
    mesh = default_mesh([torch.device("cuda", 0)] * D)
    return (PDataStore(str(tmp_path), use_device_cache=True, device="cuda",
                       mesh=mesh),
            PDataStore(str(tmp_path), use_device_cache=True, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_mesh_graph_replay_on_the_card(card_mesh_store, split, monkeypatch):
    """On four shards of one card every ring window replays the mesh
    graphs (one graph a slot, or with `split` the per-card graphs and the
    merge graph): B1 four times a window, answers bit-identical to the
    pipelined mesh route and to the single-card ring."""
    from geomesa_tpu_torch.engine import knn_scan as ks

    monkeypatch.setattr(PMesh, "spans_devices", property(lambda s: split))
    registry.clear()
    mesh_ds, single_ds = card_mesh_store
    pts = np.random.default_rng(13).uniform(-60, 60, (WINDOWS, 2))
    mesh_ds.get_feature_source("meshed").get_count(CQL)  # residency
    before = ks.chord_blockmin_sparse.launches
    ring, st, events, _ = serve(mesh_ds, pts)
    # the arm's warm-up and captures are taken back off the count
    assert ks.chord_blockmin_sparse.launches - before == D * WINDOWS
    assert st["ring"]["windows"] == WINDOWS
    cap = st["captures"]
    assert cap and cap[0].graphs and (cap[0].split is not None) == split
    piped, _, _, _ = serve(mesh_ds, pts, ring=False)
    single, _, _, _ = serve(single_ds, pts)
    for i in range(WINDOWS):
        same(ring[i], piped[i])
        same(ring[i], single[i])
    assert all(e.mesh_shape == "(4,)" for e in events)


@pytest.mark.cuda
def test_set_mesh_none_releases_the_shards_on_the_card(card_mesh_store):
    """Clearing the mesh drops every shard: the card's allocated bytes
    return to what they were before the mesh residency was built."""
    mesh_ds, _ = card_mesh_store
    registry.clear()
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    src = mesh_ds.get_feature_source("meshed")
    src.get_count(CQL)
    resident = src.planner.cache.resident_bytes()
    assert torch.cuda.memory_allocated() - m0 >= sum(resident.values())
    mesh_ds.set_mesh(None)
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == m0
