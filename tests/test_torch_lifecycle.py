"""The port's storage lifecycle against the reference's on the same
seeded catalogs: `delete_features` (INCLUDE, a BBOX with an attribute, a
polygon), `age_off`, `compact`, `read_all`, `remove_schema`, ORC files
and `geomesa.scan.batch.size`.

Each package writes its own copy of one seeded store (5 day partitions,
with feature ids), both with the device cache on. After each change the
deleted rows, counts, features by id, kNN neighbour sets (held by
coordinates: a delete shifts row indices) and the manifest's entry
counts equal the reference's. A served answer after a delete equals the
direct one, and after the stats are invalidated `impl="auto"` picks what
the reference picks.
"""

import os

import numpy as np
import pytest

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.utils.config import SystemProperties as RProps
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.utils.config import SystemProperties as PProps

SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
T0 = 1_600_000_000_000
DAY = 86400_000
N = 6000
COUNTS = ["INCLUDE", "BBOX(geom, -10, 35, 10, 55)",
          "BBOX(geom, -15, 30, 15, 60) AND score > 2.5",
          "INTERSECTS(geom, POLYGON((-12 33, 14 36, 9 58, -13 51, -12 33)))",
          f"dtg > 2020-09-14T12:00:00Z AND name = 'b'"]
KNN_CQL = "BBOX(geom, -18, 31, 18, 59) AND score > -5"
QX = np.array([0.5, -7.0, 11.0, 3.0])
QY = np.array([45.0, 38.0, 52.0, 57.0])


def rows(n, seed, days=4):
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-10, 10, n),
            "dtg": T0 + rng.integers(0, days * DAY, n),
            "geom": np.stack([rng.uniform(-20, 20, n),
                              rng.uniform(30, 60, n)], 1)}


def fids(n, seed):
    return [f"f{seed}-{i}" for i in range(n)]


def pair(tmp_path, encoding="parquet", n=N, seed=3):
    """(ref source, port source) over two catalogs of the same rows."""
    out = []
    for tag, ds_cls, sft_cls, fb in (
            ("r", lambda r: RDataStore(r, use_device_cache=True), RSFT, RFB),
            ("p", lambda r: PDataStore(r, use_device_cache=True, device="cpu"),
             PSFT, PFB)):
        ds = ds_cls(str(tmp_path / tag))
        sft = sft_cls.from_spec("life", SPEC)
        src = ds.create_schema(sft, encoding=encoding)
        src.write(fb.from_pydict(sft, rows(n, seed), fids=fids(n, seed)))
        out.append(src)
    return out


def by_fid(batch):
    if batch is None:
        return {}
    fid = [batch.fids.vocab[c] for c in batch.fids.codes]
    name = batch.columns["name"]
    g = batch.columns["geom"]
    return {f: (name.vocab[name.codes[i]], float(batch.columns["score"][i]),
                int(batch.columns["dtg"][i]), float(g.x[i]), float(g.y[i]))
            for i, f in enumerate(fid)}


def neighbours(src):
    d, idx, b = src.knn(KNN_CQL, QX, QY, k=6)
    g = b.columns["geom"]
    return [sorted(zip(np.asarray(g.x)[row], np.asarray(g.y)[row]))
            for row in np.asarray(idx)], np.sort(np.asarray(d), 1)


def entry_counts(src):
    return {k: sorted(e["count"] for e in v)
            for k, v in src.storage.manifest_snapshot().items()}


def assert_same(ref, port, knn=True):
    for cql in COUNTS:
        assert port.get_count(cql) == ref.get_count(cql), cql
    assert by_fid(port.storage.read_all()) == by_fid(ref.storage.read_all())
    assert entry_counts(port) == entry_counts(ref)
    if knn:
        (pn, pd), (rn, rd) = neighbours(port), neighbours(ref)
        assert pn == rn
        np.testing.assert_allclose(pd, rd, rtol=1e-4, atol=1.0)
        for impl in ("sparse", "fullscan"):
            assert neighbours_of(port, impl) == pn


def neighbours_of(src, impl):
    d, idx, b = src.knn(KNN_CQL, QX, QY, k=6, impl=impl)
    g = b.columns["geom"]
    return [sorted(zip(np.asarray(g.x)[row], np.asarray(g.y)[row]))
            for row in np.asarray(idx)]


DELETES = {
    "include": "INCLUDE",
    "bbox_and_attribute": "BBOX(geom, -12, 36, 6, 50) AND score < 1.5",
    "polygon": "INTERSECTS(geom, POLYGON((-9 40, 8 38, 12 51, -4 55, -9 40)))",
}


@pytest.mark.parametrize("case", sorted(DELETES))
def test_delete_features_matches_the_reference(tmp_path, case):
    ref, port = pair(tmp_path)
    assert_same(ref, port)  # residency warm before the delete
    n = port.delete_features(DELETES[case])
    assert n == ref.delete_features(DELETES[case]) > 0
    assert port.storage.count == ref.storage.count == N - n
    assert_same(ref, port, knn=case != "include")
    if case == "include":
        assert port.storage.read_all() is None
        assert port.storage.partitions() == []


def test_age_off_and_compact_match_the_reference(tmp_path):
    ref, port = pair(tmp_path)
    assert_same(ref, port)
    cut = T0 + DAY + DAY // 2
    n = port.age_off(cut)
    assert n == ref.age_off(cut) > 0
    assert port.storage.partitions() == ref.storage.partitions()
    assert len(port.storage.partitions()) == 3  # the first days are gone
    assert_same(ref, port)
    assert port.planner.cache.resident() == port.storage.partitions()
    for src, fb in ((ref, RFB), (port, PFB)):
        src.write(fb.from_pydict(src.sft, rows(500, 8, days=3),
                                 fids=fids(500, 8)))
    before = entry_counts(port)
    assert any(len(v) == 2 for v in before.values())
    removed = port.storage.compact()
    assert removed == ref.storage.compact() > 0
    assert all(len(v) == 1 for v in entry_counts(port).values())
    assert_same(ref, port)
    mv = port.storage.manifest_version()
    assert port.storage.compact() == 0  # nothing left to merge
    assert port.storage.manifest_version() == mv


def test_emptied_partition_leaves_the_device(tmp_path):
    ref, port = pair(tmp_path)
    port.get_count("INCLUDE")
    cache = port.planner.cache
    first = cache.resident()
    assert len(first) == 5
    assert port.age_off(T0 + DAY) == ref.age_off(T0 + DAY) > 0
    assert port.get_count("INCLUDE") == ref.get_count("INCLUDE")
    assert cache.resident() == port.storage.partitions() == first[1:]
    assert len(cache.superbatch().ids) == 4


def test_orc_round_trip_delete_and_compact(tmp_path):
    ref, port = pair(tmp_path, encoding="orc", n=3000)
    assert all(f["file"].endswith(".orc")
               for v in port.storage.manifest_snapshot().values() for f in v)
    assert_same(ref, port)
    # each package reads the other's ORC files
    assert by_fid(PDataStore(str(tmp_path / "r"), device="cpu")
                  .get_feature_source("life").storage.read_all()) == \
        by_fid(port.storage.read_all())
    for src, fb in ((ref, RFB), (port, PFB)):
        src.write(fb.from_pydict(src.sft, rows(300, 5), fids=fids(300, 5)))
    assert port.storage.compact() == ref.storage.compact() > 0
    cql = DELETES["bbox_and_attribute"]
    assert port.delete_features(cql) == ref.delete_features(cql) > 0
    assert_same(ref, port)


def test_remove_schema_drops_files_residency_and_captures(tmp_path):
    from geomesa_tpu_torch.compilecache.registry import registry
    from geomesa_tpu_torch.serve import QueryService, ServeConfig

    ref, port = pair(tmp_path)
    ds = PDataStore(str(tmp_path / "p"), use_device_cache=True, device="cpu")
    src = ds.get_feature_source("life")
    svc = QueryService(ds, ServeConfig(max_wait_ms=0.0))
    svc.knn("life", KNN_CQL, QX[:1], QY[:1], k=3).result(timeout=60)
    assert [c for c in registry.held() if c.owner_id == id(src.planner)]
    ds.remove_schema("life")
    svc.close(drain=True)
    assert not [c for c in registry.held() if c.owner_id == id(src.planner)]
    assert src.planner.cache.resident() == []
    rds = RDataStore(str(tmp_path / "r"))
    rds.remove_schema("life")
    assert ds.get_type_names() == rds.get_type_names() == []
    for store in (ds, rds):
        with pytest.raises(FileNotFoundError):
            store.remove_schema("life")
    assert not os.path.exists(str(tmp_path / "p" / "life"))


def test_scan_batch_size_bounds_every_batch(tmp_path):
    ref, port = pair(tmp_path)
    try:
        for props in (RProps, PProps):
            props.set("geomesa.scan.batch.size", 700)
        sizes = [len(b) for b in port.storage.scan()]
        assert max(sizes) <= 700 and sum(sizes) == N
        assert sizes == [len(b) for b in ref.storage.scan()]
        cql = "BBOX(geom, -15, 30, 15, 60) AND score > 2.5"
        got = port.get_features(PQuery("life", cql, sort_by=[("score", False)]))
        exp = ref.get_features(RQuery("life", cql, sort_by=[("score", False)]))
        assert by_fid(got.features) == by_fid(exp.features)
    finally:
        for props in (RProps, PProps):
            props.clear("geomesa.scan.batch.size")


def test_served_answers_follow_a_delete(tmp_path):
    from geomesa_tpu_torch.serve import QueryService, ServeConfig

    ref, port = pair(tmp_path)
    ds = PDataStore(str(tmp_path / "p"), use_device_cache=True, device="cpu")
    src = ds.get_feature_source("life")
    svc = QueryService(ds, ServeConfig(max_wait_ms=0.0))
    try:
        for _ in range(2):  # arm the ring
            svc.knn("life", KNN_CQL, QX, QY, k=6).result(timeout=60)
        cql = DELETES["bbox_and_attribute"]
        assert src.delete_features(cql) == ref.delete_features(cql)
        for _ in range(3):  # stale fallback, then the re-armed ring
            d, i, b = svc.knn("life", KNN_CQL, QX, QY, k=6).result(timeout=60)
            ed, ei, eb = src.knn(KNN_CQL, QX, QY, k=6)
            np.testing.assert_array_equal(d, ed)
            np.testing.assert_array_equal(i, ei)
            assert svc.count("life", KNN_CQL).result(timeout=60) == \
                ref.get_count(KNN_CQL)
        ring = svc.stats()["pipeline"]["ring"]
        assert ring["fallbacks"].get("stale", 0) >= 1 and ring["armed"] == 2
    finally:
        svc.close(drain=True)


def test_auto_impl_after_stats_invalidation(tmp_path):
    ref, port = pair(tmp_path)
    wide = "BBOX(geom, -25, 25, 25, 65)"

    def pick(src):
        plan = src.planner.plan(src.planner.plan(
            (RQuery if src is ref else PQuery)("life", wide)).query)
        return src.planner._knn_impl_from_stats(plan)

    assert pick(port) == pick(ref) == "fullscan"
    assert port.delete_features("score < -9") == ref.delete_features("score < -9")
    assert not port.planner.stats_manager().stats
    assert pick(port) == pick(ref)
    np.testing.assert_allclose(port.knn(wide, QX, QY, k=4, impl="auto")[0],
                               ref.knn(wide, QX, QY, k=4, impl="auto")[0],
                               rtol=1e-4, atol=1.0)
