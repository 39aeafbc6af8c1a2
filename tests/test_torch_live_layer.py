"""The port's live layer against the reference's, on the CPU.

The same seeded rows and messages go through both packages: geohash
encode/decode/neighbours/tiling, `BucketIndex` and
`SizeSeparatedBucketIndex`, `GeoMessage` bytes (byte for byte, and each
package decodes the other's), the feature cache (latest-wins upserts,
events, expiry, snapshots), the `KafkaDataStore` (counts, features,
density, kNN neighbour sets with bit-identical meters, deletes, two
consumers of one broker), layer views, the attribute fast path and its
audit event, visibility, a `kafka.poll` fault retried with the answers
unchanged, the reference's kNN that does not poll, and the
`LambdaDataStore` (persist, transient-wins merge, merged aggregations).

Also the planner over a storage without a manifest: a minimal storage
(sft, root, count, partitions, prune_partitions(bbox, interval), scan)
plans, counts and runs kNN as the reference's planner does, and its
INCLUDE count carries no version.
"""

import dataclasses
import time

import numpy as np
import pytest

from geomesa_tpu import faults as rf
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.core.wkt import parse_wkt as rwkt
from geomesa_tpu.core.wkt import point as rpoint
from geomesa_tpu.kafka import messages as rmsg
from geomesa_tpu.kafka import KafkaDataStore as RKafka
from geomesa_tpu.kafka import KafkaFeatureCache as RCache
from geomesa_tpu.lambda_store import LambdaDataStore as RLambda
from geomesa_tpu.plan.audit import AuditWriter as RAudit
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.planner import QueryPlanner as RPlanner
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.utils import geohash as rgh
from geomesa_tpu.utils import spatial_index as rsi
from geomesa_tpu_torch import faults as pf
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.core.wkt import parse_wkt as pwkt
from geomesa_tpu_torch.core.wkt import point as ppoint
from geomesa_tpu_torch.kafka import messages as pmsg
from geomesa_tpu_torch.kafka import KafkaDataStore as PKafka
from geomesa_tpu_torch.kafka import KafkaFeatureCache as PCache
from geomesa_tpu_torch.lambda_store import LambdaDataStore as PLambda
from geomesa_tpu_torch.plan.audit import AuditWriter as PAudit
from geomesa_tpu_torch.plan.explain import Explainer as PExplainer
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.planner import QueryPlanner as PPlanner
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.utils import geohash as pgh
from geomesa_tpu_torch.utils import spatial_index as psi

SPEC = "name:String:index=true,score:Double,dtg:Date,*geom:Point"
N = 2000
FILTERS = ["INCLUDE", "BBOX(geom, -90, -45, 90, 45) AND score > 0",
           "name = 'a' AND score < 2", "score BETWEEN -1 AND 1",
           "INTERSECTS(geom, POLYGON((-100 -50, 60 -60, 120 40, -30 70, -100 -50)))",
           "dtg DURING 2020-06-01T00:00:00Z/2020-07-15T00:00:00Z"]
KNN_CQL = "BBOX(geom, -120, -60, 120, 60) AND score > -3"
QX = np.array([0.5, -70.0, 100.0, 30.0, 179.0, -179.5, 10.0, 60.0])
QY = np.array([0.2, 30.0, -40.0, 55.0, 0.0, -20.0, -59.0, 10.0])
DENSITY = dict(density_bbox=(-180.0, -90.0, 180.0, 90.0), density_width=32,
               density_height=16)


def rows(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-5, 5, n),
            "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
            "geom": np.stack([rng.uniform(-180, 180, n),
                              rng.uniform(-90, 90, n)], 1)}


def batches(spec=SPEC, data=None, name="live", fids=None):
    data = rows() if data is None else data
    fids = [f"f{i}" for i in range(len(data["score"]))] if fids is None else fids
    return tuple(fb.from_pydict(sft.from_spec(name, spec), data, fids=fids)
                 for sft, fb in ((RSFT, RFB), (PSFT, PFB)))


def rows_of(result_or_batch):
    """{fid: the row's values} of a features result (or a batch)."""
    b = getattr(result_or_batch, "features", result_or_batch)
    if b is None:
        return {}
    cols = []
    for col in b.columns.values():
        if hasattr(col, "decode"):
            cols.append(col.decode())
        elif hasattr(col, "is_point"):
            cols.append(list(zip(col.x.tolist(), col.y.tolist())))
        else:
            cols.append(np.asarray(col).tolist())
    return {fid: tuple(c[i] for c in cols) for i, fid in enumerate(b.fids.decode())}


def knn_fids(out):
    """Per query: the neighbours' fids as a set and the sorted meters."""
    d, idx, batch = out
    fids = batch.fids.decode()
    return ([{fids[j] for j, dd in zip(idx[q], d[q]) if np.isfinite(dd)}
             for q in range(len(d))], np.sort(d, 1))


def same_knn(r, p):
    (rs, rd), (ps, pd) = knn_fids(r), knn_fids(p)
    assert ps == rs
    np.testing.assert_array_equal(pd, rd)


@pytest.fixture(autouse=True)
def _pristine_fabric():
    for f in (rf, pf):
        f.uninstall()
        f.BREAKERS.reset()
    yield
    for f in (rf, pf):
        f.uninstall()
        f.BREAKERS.reset()


@pytest.fixture(scope="module")
def live():
    rb, pb = batches()
    rds, pds = RKafka(), PKafka(device="cpu")
    rsrc, psrc = rds.create_schema(rb.sft), pds.create_schema(pb.sft)
    rsrc.write(rb)
    psrc.write(pb)
    return rds, pds, rsrc, psrc


# -- geohash and the bucket indices -------------------------------------------


@pytest.mark.parametrize("precision", [1, 5, 9, 12])
def test_geohash_equals_the_reference(precision):
    rng = np.random.default_rng(precision)
    lon, lat = rng.uniform(-180, 180, 200), rng.uniform(-90, 90, 200)
    lon[:4], lat[:4] = [-180, 180, 0, -5.6], [-90, 90, 0, 42.6]
    got = rgh.encode(lon, lat, precision)
    assert pgh.encode(lon, lat, precision).tolist() == got.tolist()
    for g in got[:40]:
        g = str(g)
        assert pgh.decode_bbox(g) == rgh.decode_bbox(g)
        assert pgh.decode(g) == rgh.decode(g)
        assert pgh.neighbors(g) == rgh.neighbors(g)
    if precision <= 5:
        for box in ((-10, -10, 10, 10), (170, 60, 180, 90), (-3.3, 41.0, -2.1, 43.7)):
            assert pgh.bboxes_for(box, min(precision, 3)) == rgh.bboxes_for(
                box, min(precision, 3))


def test_bucket_indices_equal_the_reference():
    rng = np.random.default_rng(0)
    xs, ys = rng.uniform(-180, 180, 800), rng.uniform(-90, 90, 800)
    ws = np.where(np.arange(800) % 7 == 0, rng.uniform(0, 30, 800), 0.1)
    out = []
    for mod in (rsi, psi):
        idx = mod.BucketIndex(90, 45)
        sep = mod.SizeSeparatedBucketIndex(tiers=3, base=2.0)
        for i, (x, y) in enumerate(zip(xs, ys)):
            idx.insert(f"k{i}", x, y, i)
            w = float(ws[i])
            sep.insert(f"k{i}", (x, y, x + w, y + w / 2), i)
        idx.insert("k0", 0.0, 0.0, 999)  # an upsert moves the entry
        seen = [idx.get("k0"), idx.remove("k3"), idx.get("k3"), len(idx),
                sep.remove("k7"), sep.get("k14"), len(sep)]
        for box in ((-30.0, -20.0, 40.0, 50.0), (170.0, 80.0, 180.0, 90.0), None):
            seen.append(sorted(v for _, v in idx.query(box)))
            seen.append(sorted(v for _, v in sep.query(box)))
        idx.clear()
        seen.append(len(idx))
        out.append(seen)
    assert out[0] == out[1]


# -- GeoMessage bytes ----------------------------------------------------------

MSG_SPEC = ("s:String,u:UUID,i:Integer,l:Long,d:Double,f:Float,b:Boolean,"
            "t:Date,x:Bytes,*geom:Geometry")


def _messages(m, point, wkt):
    full = {"s": "alpha é", "u": "4f1c7d7e-1a2b-4c3d-8e9f-000000000001",
            "i": -7, "l": 1 << 40, "d": 2.5, "f": 0.1, "b": True,
            "t": 1_595_000_000_000, "x": b"\x00\x01\xff", "geom": point(2.35, 48.85)}
    return [m.Change("id-1", full),
            m.Change("id-2", {**full, "geom": wkt(
                "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 2 1, 2 2, 1 1))")}),
            m.Change("id-3", {**full, "geom": wkt("LINESTRING (30 10, 10 30, 40 40)")}),
            m.Change("id-4", {**full, "geom": (1.5, -2.5), "s": None, "d": None}),
            m.Change("", {}),
            m.Delete("id-1"), m.Delete("ü-9"), m.Clear()]


@pytest.mark.parametrize("i", range(8))
def test_geomessage_bytes_equal_the_references(i):
    rs = rmsg.GeoMessageSerializer(RSFT.from_spec("m", MSG_SPEC))
    ps = pmsg.GeoMessageSerializer(PSFT.from_spec("m", MSG_SPEC))
    rm = _messages(rmsg, rpoint, rwkt)[i]
    pm = _messages(pmsg, ppoint, pwkt)[i]
    data = ps.serialize(pm)
    assert data == rs.serialize(rm)
    # each package decodes the other's bytes to the same message
    back, rback = ps.deserialize(data), rs.deserialize(data)
    assert type(back).__name__ == type(rback).__name__
    if hasattr(back, "fid"):
        assert back.fid == rback.fid
    if hasattr(back, "attributes"):
        assert ps.serialize(back) == data
        for k, v in back.attributes.items():
            rv = rback.attributes[k]
            assert (str(v) == str(rv)) if hasattr(v, "kind") else v == rv, k


# -- the cache -------------------------------------------------------------------


def test_cache_upserts_events_expiry_and_snapshots():
    out = []
    for cache_cls, m, point in ((RCache, rmsg, rpoint), (PCache, pmsg, ppoint)):
        sft = (RSFT if cache_cls is RCache else PSFT).from_spec("live", SPEC)
        cache = cache_cls(sft, expiry_ms=1000)
        events = []
        cache.add_listener(lambda e: events.append((e.kind, e.fid)))
        seen = [cache.snapshot()]
        for i in range(30):
            cache.apply(m.Change(f"f{i % 20}", {"name": "abc"[i % 3], "score": float(i),
                                                "dtg": i, "geom": point(i - 15.0, i / 2)}))
        snap = cache.snapshot()
        seen += [len(cache), cache.get("f3"), snap is cache.snapshot(), rows_of(snap),
                 cache.query_bbox((-5, 0, 5, 10)), cache.query_attribute("name", ["a"]),
                 cache.indexed_attributes]
        cache.apply(m.Delete("f4"))
        cache.apply(m.Delete("missing"))
        seen.append(cache.expire(now=time.time() - 10))
        seen.append(cache.expire(now=time.time() + 10))
        cache.apply(m.Change("z", {"name": None, "score": None, "dtg": 5,
                                   "geom": point(1.0, 2.0)}))
        seen.append(rows_of(cache.snapshot()))
        cache.apply(m.Clear())
        seen += [len(cache), cache.snapshot(), cache.attr_index_hits, events]
        out.append(seen)
    assert repr(out[1]) == repr(out[0])


# -- the store -------------------------------------------------------------------


@pytest.mark.parametrize("cql", FILTERS)
def test_live_counts_and_features_equal_the_references(live, cql):
    _, _, rsrc, psrc = live
    assert psrc.get_count(cql) == rsrc.get_count(cql)
    assert rows_of(psrc.get_features(cql)) == rows_of(rsrc.get_features(cql))


@pytest.mark.parametrize("cql", ["INCLUDE", FILTERS[1], FILTERS[4]])
def test_live_density_equals_the_references(live, cql):
    _, _, rsrc, psrc = live
    r = rsrc.get_features(RQuery("live", cql, hints=RHints(**DENSITY)))
    p = psrc.get_features(PQuery("live", cql, hints=PHints(**DENSITY)))
    assert p.kind == r.kind == "density" and p.count == r.count
    np.testing.assert_array_equal(p.grid, r.grid)
    hw = dict(DENSITY, density_weight="score")
    r = rsrc.get_features(RQuery("live", cql, hints=RHints(**hw)))
    p = psrc.get_features(PQuery("live", cql, hints=PHints(**hw)))
    np.testing.assert_allclose(p.grid, r.grid, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("impl", ["sparse", "fullscan"])
@pytest.mark.parametrize("k", [1, 10])
def test_live_knn_equals_the_references(live, impl, k):
    _, _, rsrc, psrc = live
    rsrc.get_count("INCLUDE")  # knn does not poll: the counts poll first
    psrc.get_count("INCLUDE")
    same_knn(rsrc.knn(KNN_CQL, QX, QY, k=k, impl=impl),
             psrc.knn(KNN_CQL, QX, QY, k=k, impl=impl))


def test_live_explain_and_include_count_carry_no_version(live):
    rds, pds, rsrc, psrc = live

    def lines(src):
        return [ln.strip() for ln in src.explain(FILTERS[1]).splitlines()
                if ln.strip().startswith(("Planning", "Primary", "Partitions"))]

    assert lines(psrc) == lines(rsrc)
    assert "Partitions: 1 of 1 after pruning" in lines(psrc)
    rr = rsrc.planner.count_result(RQuery("live", "INCLUDE"))
    pr = psrc.planner.count_result(PQuery("live", "INCLUDE"))
    assert pr.count == rr.count == N and pr.version is rr.version is None


def test_knn_before_a_count_sees_the_last_poll_as_the_reference():
    """FeatureSource.knn does not poll the topic (only get_features and
    get_count do), in both packages: written rows stay invisible to kNN
    until a count or a query polls them (ROADMAP, reference caveats)."""
    rb, pb = batches(data=rows(300, seed=3))
    out = []
    for ds, b in ((RKafka(), rb), (PKafka(device="cpu"), pb)):
        src = ds.create_schema(b.sft)
        src.write(b.select(np.arange(100)))
        src.get_count("INCLUDE")
        src.write(b.select(np.arange(100, 300)))
        before = knn_fids(src.knn("INCLUDE", QX, QY, k=5))
        n = src.get_count("INCLUDE")
        after = knn_fids(src.knn("INCLUDE", QX, QY, k=5))
        assert all(f <= {f"f{i}" for i in range(100)} for f in before[0])
        out.append((before, n, after))
    (rb_, rn, ra), (pb_, pn, pa) = out
    assert pb_[0] == rb_[0] and pa[0] == ra[0] and pn == rn == 300
    np.testing.assert_array_equal(pa[1], ra[1])


def test_live_deletes_upserts_clear_and_two_consumers():
    out = []
    for ds_cls, kw, b in ((RKafka, {}, batches()[0]), (PKafka, {"device": "cpu"},
                                                     batches()[1])):
        writer = ds_cls(**kw)
        reader = ds_cls(broker=writer.broker, **kw)
        writer.create_schema(b.sft)
        rsrc = reader.create_schema(b.sft)
        writer.write("live", b.select(np.arange(50)))
        seen = [rsrc.get_count("INCLUDE")]
        moved = b.select(np.arange(5))
        writer.write("live", type(moved)(moved.sft, {**moved.columns, "score": np.full(5, 9.5)},
                                         moved.fids, moved.valid))
        writer.delete("live", "f7")
        seen += [rsrc.get_count("INCLUDE"), rows_of(rsrc.get_features("score > 9"))]
        writer.clear("live")
        seen += [rsrc.get_count("INCLUDE"), rsrc.get_features("INCLUDE").features]
        out.append(seen)
    assert out[1] == out[0]


def test_layer_views_equal_the_references(live):
    rds, pds, _, _ = live
    rv = rds.create_layer_view("v", "live", "name = 'b'", attributes=["name", "score"])
    pv = pds.create_layer_view("v", "live", "name = 'b'", attributes=["name", "score"])
    assert pds.get_layer_view("live", "v") is pv
    for cql in ("INCLUDE", "score > 0", FILTERS[1]):
        assert pv.get_count(cql) == rv.get_count(cql)
        p, r = pv.get_features(cql), rv.get_features(cql)
        assert rows_of(p) == rows_of(r)
        assert list(p.features.sft.attribute_names) == ["name", "score"]
    with pytest.raises(TypeError):
        pv.write(None)


def test_attribute_fast_path_and_its_audit_event_equal_the_references():
    out = []
    for ds, b in ((RKafka(audit=RAudit()), batches()[0]),
                  (PKafka(audit=PAudit(), device="cpu"), batches()[1])):
        src = ds.create_schema(b.sft)
        src.write(b.select(np.arange(300)))
        cache = ds.cache("live")
        n0 = len(ds.audit.events)
        got = [rows_of(src.get_features("name = 'a'")),
               rows_of(src.get_features("name IN ('b', 'zz')")),
               rows_of(src.get_features("'c' = name")),
               rows_of(src.get_features("name = 'nobody'")), cache.attr_index_hits]
        # a projection takes the planner
        q = (RQuery if isinstance(ds, RKafka) else PQuery)(
            "live", "name = 'a'", attributes=["score"])
        got += [rows_of(src.get_features(q)), cache.attr_index_hits]
        events = [dataclasses.replace(e, plan_time_ms=0.0, scan_time_ms=0.0,
                                      compute_time_ms=0.0, timestamp=0.0)
                  for e in ds.audit.events[n0:]]
        got.append([(e.filter, e.hints, e.result_count, e.partitions_scanned,
                     e.partitions_total) for e in events
                    if e.hints == "attr-index-fast-path"])
        out.append(got)
    assert out[1] == out[0] and out[1][4] == 4


def test_live_visibility_equals_the_reference():
    spec = "name:String:index=true,vis:String,score:Double,*geom:Point;geomesa.vis.attr=vis"
    rng = np.random.default_rng(3)
    n = 60
    data = {"name": ["a"] * 30 + ["b"] * 30, "vis": ["admin"] * 20 + [None] * 40,
            "score": rng.uniform(0, 9, n), "geom": rng.uniform(-10, 10, (n, 2))}
    out = []
    for ds, b, Q, H in ((RKafka(), batches(spec, data, "sec")[0], RQuery, RHints),
                        (PKafka(device="cpu"), batches(spec, data, "sec")[1], PQuery, PHints)):
        src = ds.create_schema(b.sft)
        src.write(b)
        seen = [rows_of(src.get_features("name = 'a'")), ds.cache("sec").attr_index_hits]
        for auths in ((), ("admin",)):
            q = Q("sec", "INCLUDE", hints=H(auths=auths, exact_count=False))
            seen += [src.get_count(q), rows_of(src.get_features(Q("sec", "score > 3",
                                                                  hints=H(auths=auths))))]
        out.append(seen)
    assert out[1] == out[0] and out[1][1] == 0 and out[1][2] == 40


def test_kafka_poll_fault_retries_and_the_answers_are_unchanged():
    out = {}
    for name, f, ds, b in (("ref", rf, RKafka(), batches()[0]),
                           ("port", pf, PKafka(device="cpu"), batches()[1])):
        src = ds.create_schema(b.sft)
        plan = f.FaultPlan(seed=3, rules=[f.FaultRule(site="kafka.poll", error="io",
                                                      every=2)])
        tok = f.RECOVERY.token()
        with f.active(plan) as h:
            got = []
            for lo in range(0, 400, 100):
                src.write(b.select(np.arange(lo, lo + 100)))
                got += [src.get_count("INCLUDE"), src.get_count(FILTERS[1])]
            log = h.fire_log()
        retries = [k for k, _ in f.RECOVERY.since(tok) if k == "retry"]
        assert log and len(retries) == len(log)
        out[name] = (got, log)
    assert out["port"] == out["ref"]


def test_mesh_is_refused_typed(tmp_path):
    """`mesh=` is ported (A7): a live store and a lambda store over a
    four-shard mesh (four `cpu` shards; the reference's 4 CPU devices)
    reach their planners with it and count, and run kNN, as the
    reference's do."""
    import jax

    from geomesa_tpu.parallel.mesh import default_mesh as rmesh
    from geomesa_tpu_torch.parallel.mesh import default_mesh as pmesh

    meshes = {"r": rmesh(jax.devices()[:4]), "p": pmesh(["cpu"] * 4)}
    rb, pb = batches(data=rows(400, seed=9))
    out = {}
    for tag, kds_cls, lds_cls, kw, b, Q in (
            ("r", RKafka, RLambda, {}, rb, RQuery),
            ("p", PKafka, PLambda, {"device": "cpu"}, pb, PQuery)):
        kds = kds_cls(mesh=meshes[tag], **kw)
        src = kds.create_schema(b.sft)
        src.write(b)
        assert src.planner.mesh is meshes[tag]
        lds = lds_cls(str(tmp_path / tag), mesh=meshes[tag], **kw)
        lds.create_schema(b.sft)
        lds.write("live", b.select(np.arange(0, 300)))
        lds.persist("live", now=time.time() + 120.0)
        lds.write("live", b.select(np.arange(250, 400)))
        out[tag] = ([src.get_count(Q("live", c)) for c in FILTERS[:4]],
                    [lds.get_count(Q("live", c)) for c in FILTERS[:4]],
                    src.knn(KNN_CQL, QX, QY, k=5))
    assert out["p"][:2] == out["r"][:2]
    same_knn(out["r"][2], out["p"][2])


# -- the lambda store ------------------------------------------------------------


def test_lambda_persist_merge_and_aggregations_equal_the_references(tmp_path):
    data = rows(900, seed=4)
    data["dtg"] = 1_590_000_000_000 + data["dtg"] % (3 * 86_400_000)  # 4 days
    rb, pb = batches(data=data)
    out = []
    for tag, lds_cls, kw, b, Q, H in (
            ("r", RLambda, {}, rb, RQuery, RHints),
            ("p", PLambda, {"device": "cpu"}, pb, PQuery, PHints)):
        lds = lds_cls(str(tmp_path / tag), persist_after_ms=60_000, **kw)
        lds.create_schema(b.sft)
        lds.write("live", b.select(np.arange(0, 600)))
        seen = [lds.get_count(Q("live", "INCLUDE")), lds.persist("live")]
        seen.append(lds.persist("live", now=time.time() + 120.0))
        lds.write("live", b.select(np.arange(500, 900)))  # 100 written to both
        upd = b.select(np.arange(3))
        lds.write("live", type(upd)(upd.sft, {**upd.columns, "score": np.full(3, 99.0)},
                                    upd.fids, upd.valid))
        for cql in ("INCLUDE", FILTERS[1], FILTERS[4]):
            seen += [rows_of(lds.get_features(Q("live", cql))),
                     lds.get_count(Q("live", cql))]
            r = lds.get_features(Q("live", cql, hints=H(**DENSITY)))
            seen += [r.kind, r.count, r.grid.tolist()]
        st = lds.get_features(Q("live", FILTERS[1], hints=H(stats_string="MinMax(score)")))
        seen.append(st.stats.stats[0].result())
        with pytest.raises(TypeError):
            lds.get_features("INCLUDE")
        seen.append(lds.get_type_names())
        out.append(seen)
    assert out[1] == out[0]
    assert out[1][0] == 600 and out[1][1] == 0 and out[1][2] == 600


# -- the planner over a storage without a manifest --------------------------------


class _Storage:
    """The duck-typed storage surface the planner needs, and no manifest:
    two partitions split at lon 0."""

    def __init__(self, batch):
        self.sft = batch.sft
        self.root = "./.geomesa-no-such-storage"
        x = batch.columns["geom"].x
        self.parts = {"west": batch.select(np.nonzero(x < 0)[0]),
                      "east": batch.select(np.nonzero(x >= 0)[0])}

    @property
    def count(self):
        return sum(len(b) for b in self.parts.values())

    def partitions(self):
        return sorted(self.parts)

    def prune_partitions(self, bbox, interval):
        return [p for p in self.partitions()
                if (p == "west" and bbox.xmin < 0) or (p == "east" and bbox.xmax >= 0)]

    def scan(self, bbox=None, interval=None, columns=None):
        for p in (self.prune_partitions(bbox, interval) if bbox is not None
                  else self.partitions()):
            yield self.parts[p]


def test_planner_takes_a_storage_without_a_manifest():
    rb, pb = batches(data=rows(3000, seed=9))
    rp = RPlanner(_Storage(rb))
    pp = PPlanner(_Storage(pb), __import__("torch").device("cpu"))
    assert not hasattr(pp.storage, "manifest_snapshot")
    for cql in ("INCLUDE", "BBOX(geom, -120, -50, -10, 50) AND score > 0", FILTERS[4],
                "BBOX(geom, 10, -50, 120, 50)"):
        from geomesa_tpu.plan.explain import Explainer as RExplainer

        re_, pe = RExplainer(), PExplainer()
        rp.plan(RQuery("live", cql), re_)
        pp.plan(PQuery("live", cql), pe)
        assert [ln.strip() for ln in pe.lines[:4]] == [ln.strip() for ln in re_.lines[:4]]
        for exact in (True, False):
            rq = RQuery("live", cql, hints=RHints(exact_count=exact))
            pq = PQuery("live", cql, hints=PHints(exact_count=exact))
            assert pp.count(pq) == rp.count(rq)
            rr, pr = rp.count_result(rq), pp.count_result(pq)
            assert pr.count == rr.count and pr.version == rr.version
        assert rows_of(pp.execute(PQuery("live", cql))) == rows_of(
            rp.execute(RQuery("live", cql)))
        for impl in ("sparse", "fullscan"):
            same_knn(rp.knn(RQuery("live", cql), QX, QY, k=7, impl=impl),
                     pp.knn(PQuery("live", cql), QX, QY, k=7, impl=impl))
    r = pp.count_result(PQuery("live", "INCLUDE"))
    assert r.count == 3000 and r.version is None
