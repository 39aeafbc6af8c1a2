"""Sharded residency on the port's mesh tier, against the reference's and
the port's single-device tier, on the CPU.

One catalog of 4 day partitions x 256 rows (shard_rows 256 under four
shards: partition i on shard i), written by the reference. A few rows of
every day sit on the f32 boundary band of the query's BBOX (their f64 x
is past the edge, their f32 x on it), so every shard re-decides band
rows in f64 and the per-shard row offsets are exercised. The port's mesh
is four `cpu` shards; the reference's the first 4 of its 8 CPU devices.
Counts, kNN (neighbour rows, bit-identical meters), density grids,
features, stats and BIN bytes must equal the single-device store's, and
counts, kNN and density the reference mesh store's; `mesh.gathers`
stays 0 on count, kNN and density.
"""

import json
import weakref
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.parallel.mesh import default_mesh as rdefault_mesh
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.parallel.mesh import Sharded, default_mesh
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.store.partition import DateTimeScheme as PScheme
from geomesa_tpu_torch.utils.metrics import metrics
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

D = 4
PER_DAY = 256
BAND = 6  # rows a day on the f32 band of the BBOX's east edge
DAYS = ("2020-06-01", "2020-06-02", "2020-06-03", "2020-06-04")
SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
CQL = "BBOX(geom, -40, -30, 40, 30) AND score > -8"
DENSITY = dict(density_bbox=(-40, -30, 40, 30), density_width=32,
               density_height=16)


def _day_millis(day: str) -> int:
    return int(np.datetime64(day, "ms").astype(np.int64))


def rows(days=DAYS, seed=23):
    rng = np.random.default_rng(seed)
    n = PER_DAY * len(days)
    x = rng.uniform(-60, 60, n)
    y = rng.uniform(-45, 45, n)
    for d in range(len(days)):
        at = d * PER_DAY + np.arange(BAND)
        # f64 just past (or just inside) x = 40; f32 rounds them onto it
        x[at] = 40.0 + np.where(np.arange(BAND) % 2, 1e-9, -1e-9)
        y[at] = rng.uniform(-20, 20, BAND)
    dtg = np.concatenate([_day_millis(dd) + rng.integers(
        6 * 3600_000, 18 * 3600_000, PER_DAY) for dd in days])
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-10, 10, n), "dtg": dtg,
            "geom": np.stack([x, y], 1)}


def gathers() -> float:
    return json.loads(metrics.to_json())["counters"].get("mesh.gathers", 0.0)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_mesh_residency"))
    sft = RSFT.from_spec("meshed", SPEC)
    RDataStore(root, use_device_cache=True).create_schema(sft).write(
        RFB.from_pydict(sft, rows()))
    ref = RDataStore(root, use_device_cache=True)
    ref.set_mesh(rdefault_mesh(jax.devices()[:D]))
    return SimpleNamespace(
        root=root, ref=ref.get_feature_source("meshed"),
        single=PDataStore(root, use_device_cache=True,
                          device="cpu").get_feature_source("meshed"),
        mesh=PDataStore(root, use_device_cache=True, device="cpu",
                        mesh=default_mesh(["cpu"] * D)
                        ).get_feature_source("meshed"))


def test_every_row_axis_column_is_sharded_in_its_own_allocation(stores):
    """Every row-axis column and the partition ids are `Sharded`; each
    shard is S rows in a storage of its own (no view of a whole column
    or of the host batch), and the residency bytes are the shards'."""
    stores.mesh.get_count(CQL)
    cache = stores.mesh.planner.cache
    sb = cache.superbatch()
    assert sb.mesh.size == D and sb.shard_rows == PER_DAY
    assert set(sb.dev) == {"name", "score", "dtg", "geom__x", "geom__y",
                           "__valid__"}
    assert not hasattr(sb, "placed")
    ptrs, total = set(), 0
    for col in list(sb.dev.values()) + [sb.pids]:
        assert isinstance(col, Sharded) and col.shard_rows == PER_DAY
        for shard in col.shards:
            st = shard.untyped_storage()
            assert st.nbytes() == PER_DAY * shard.element_size()
            assert st.data_ptr() not in ptrs
            ptrs.add(st.data_ptr())
            total += st.nbytes()
    assert all(e.dev is None for e in cache._entries.values())
    assert cache.resident_bytes() == {"cpu": total}
    host = sb.batch.columns["geom"]
    for i in range(D):
        np.testing.assert_array_equal(
            sb.dev["geom__x"].shards[i].numpy(),
            host.x[i * PER_DAY:(i + 1) * PER_DAY].astype(np.float32))
        np.testing.assert_array_equal(sb.pids.shards[i].numpy(),
                                      np.full(PER_DAY, i, np.int32))


def _pts(batch):
    g = batch.columns["geom"]
    return sorted(zip(g.x.tolist(), g.y.tolist(),
                      np.asarray(batch.columns["score"]).tolist()))


@pytest.mark.parametrize("kind", ["count", "knn", "density", "features",
                                  "stats", "bin"])
def test_queries_equal_the_reference_and_the_single_tier(stores, kind,
                                                        monkeypatch):
    """Each query kind over the sharded residency equals the single-device
    tier (and, for count, kNN and density, the reference's mesh store);
    count, kNN, density and stats gather no column."""
    m, s, r = stores.mesh, stores.single, stores.ref
    before = gathers()
    if kind == "count":
        got = m.get_count(CQL)
        assert got == s.get_count(CQL) == r.get_count(CQL)
        band = stores.mesh.planner.plan(PQuery("meshed", CQL)).compiled
        assert band.has_band
        # the band rows changed the answer: an f32-only count differs
        sb = m.planner.cache.superbatch()
        raw = sum(int(band.mask(dv, sb.batch).sum())
                  for dv in sb.shard_devs())
        assert raw != got
    elif kind == "knn":
        q = np.random.default_rng(5).uniform(-30, 30, (12, 2))
        md, mi, mb = m.knn(CQL, q[:, 0], q[:, 1], k=7)
        sd, si, _ = s.knn(CQL, q[:, 0], q[:, 1], k=7)
        rd, ri, rb = r.knn(CQL, q[:, 0], q[:, 1], k=7)
        np.testing.assert_array_equal(mi, si)
        assert np.array_equal(md, sd) and np.array_equal(md, np.asarray(rd))
        mg, rg = mb.columns["geom"], rb.columns["geom"]
        assert (mg.x[mi] == rg.x[np.asarray(ri)]).all()
    elif kind == "density":
        mq = m.get_features(PQuery("meshed", CQL, hints=PHints(**DENSITY)))
        sq = s.get_features(PQuery("meshed", CQL, hints=PHints(**DENSITY)))
        rq = r.get_features(RQuery("meshed", CQL, hints=RHints(**DENSITY)))
        assert np.array_equal(mq.grid, sq.grid)
        assert np.array_equal(mq.grid, np.asarray(rq.grid))
        assert mq.count == sq.count
    elif kind == "features":
        mf = m.get_features(CQL).features
        sf = s.get_features(CQL).features
        rf = r.get_features(CQL).features
        assert len(mf) == m.get_count(CQL) and _pts(mf) == _pts(sf)
        assert _pts(mf) == sorted(zip(rf.columns["geom"].x.tolist(),
                                      rf.columns["geom"].y.tolist(),
                                      np.asarray(rf.columns["score"]).tolist()))
    elif kind == "stats":
        from geomesa_tpu_torch.engine import stats as est

        # every reduction of the mesh's stats sees one shard's rows
        seen = []
        for name in ("masked_minmax", "masked_moments", "masked_histogram",
                     "masked_value_counts", "hll_registers", "z3_histogram"):
            def spy(*a, _fn=getattr(est, name), **k):
                seen.append(int(a[0].shape[0]))
                return _fn(*a, **k)
            monkeypatch.setattr(est, name, spy)
        stat = ("Count();MinMax(score);Histogram(score,8,-10,10);"
                "Enumeration(name);Z3Histogram(geom,dtg,day,8)")
        n = m.get_count(CQL)  # residency
        rows = m.planner.cache.superbatch().shard_rows
        mq = m.get_features(PQuery("meshed", CQL, hints=PHints(stats_string=stat)))
        assert seen == [rows] * (4 * D)  # Count() is the host mask's sum
        sq = s.get_features(PQuery("meshed", CQL, hints=PHints(stats_string=stat)))
        assert mq.stats.to_json() == sq.stats.to_json()
        assert mq.count == n
        # HLL registers merge by max (exact); the f64 moments are added
        # shard by shard, so they match the whole-column sums to f64
        # summation noise and the count exactly
        stat = "DescriptiveStats(score);Cardinality(score);MinMax(dtg)"
        seen.clear()
        mq = m.get_features(PQuery("meshed", CQL, hints=PHints(stats_string=stat)))
        assert seen == [rows] * (3 * D)
        sq = s.get_features(PQuery("meshed", CQL, hints=PHints(stats_string=stat)))
        (md, mc, mm), (sd, sc, sm) = mq.stats.stats, sq.stats.stats
        assert md.count == sd.count == mq.count
        assert md.sum == pytest.approx(sd.sum, rel=1e-12, abs=1e-9)
        assert md.sum_sq == pytest.approx(sd.sum_sq, rel=1e-12)
        assert mc.to_json() == sc.to_json() and mm.to_json() == sm.to_json()
    else:
        h = dict(bin_track="name")
        mq = m.get_features(PQuery("meshed", CQL, hints=PHints(**h)))
        sq = s.get_features(PQuery("meshed", CQL, hints=PHints(**h)))
        assert mq.kind == "bin" and mq.bin_bytes == sq.bin_bytes
        assert len(mq.bin_bytes) > 0
    if kind in ("count", "knn", "density", "stats"):
        assert gathers() == before


def test_growth_uploads_the_tail_and_keeps_old_rows_bit_identical(tmp_path):
    """Appending months moves every shard boundary: the new shards are
    rebuilt from the old ones (device to device) and the uploaded tail;
    only the tail counts in `upload_rows`, and every column equals a
    fresh sharded upload of the same files bit for bit."""
    rng = np.random.default_rng(9)

    def month(n, mo):
        t0 = np.datetime64(f"2020-{mo:02d}-10").astype(
            "datetime64[ms]").astype(np.int64)
        return {"name": rng.choice(["a", "b"], n).tolist(),
                "score": rng.uniform(-5, 5, n),
                "dtg": t0 + rng.integers(0, 86_400_000, n),
                "geom": np.stack([rng.uniform(-10, 10, n),
                                  rng.uniform(-10, 10, n)], 1)}

    sft = PSFT.from_spec("t", SPEC)
    mesh = default_mesh(["cpu"] * D)
    ds = PDataStore(str(tmp_path), use_device_cache=True, device="cpu")
    src = ds.create_schema(sft, PScheme("yyyy/MM"))
    src.write(PFB.from_pydict(sft, month(70, 6)))
    ds.set_mesh(mesh)
    cache = src.planner.cache
    assert src.get_count("INCLUDE AND score > -9") == 70
    old = cache.superbatch()
    old_x = [weakref.ref(t) for t in old.dev["geom__x"].shards]
    for mo, n in ((7, 40), (8, 90)):
        rows_before = cache.upload_rows
        old_concat = sum(e.padded for e in cache._entries.values())
        s_before = cache.superbatch().shard_rows
        src.write(PFB.from_pydict(sft, month(n, mo)))
        src.get_count("INCLUDE AND score > -9")
        sb = cache.superbatch()
        up = cache.upload_rows - rows_before
        assert up == len(sb.batch) - old_concat and 0 < up < len(sb.batch)
        assert sb.shard_rows != s_before
    fresh = PDataStore(str(tmp_path), use_device_cache=True, device="cpu",
                       mesh=default_mesh(["cpu"] * D)).get_feature_source("t")
    fresh.get_count("INCLUDE AND score > -9")
    fsb = fresh.planner.cache.superbatch()
    assert fsb.shard_rows == sb.shard_rows
    for k in sb.dev:
        for a, b in zip(sb.dev[k].shards, fsb.dev[k].shards):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    for a, b in zip(sb.pids.shards, fsb.pids.shards):
        assert torch.equal(a, b)
    del old
    import gc

    gc.collect()
    assert all(r() is None for r in old_x)  # the first layout's shards went


def test_set_mesh_none_and_a_new_mesh_release_every_shard(tmp_path):
    """Clearing the mesh or installing another one takes the full
    re-upload; no shard of the old layout stays referenced."""
    import gc

    sft = PSFT.from_spec("meshed", SPEC)
    ds = PDataStore(str(tmp_path), use_device_cache=True, device="cpu",
                    mesh=default_mesh(["cpu"] * D))
    src = ds.create_schema(sft)
    src.write(PFB.from_pydict(sft, rows(days=DAYS[:2], seed=3)))
    n = src.get_count(CQL)
    cache = src.planner.cache
    for nxt in (default_mesh(["cpu"] * 2), None):
        refs = [weakref.ref(t) for col in cache.superbatch().dev.values()
                for t in col.shards]
        before = cache.upload_rows
        ds.set_mesh(nxt)
        assert src.get_count(CQL) == n
        gc.collect()
        assert all(r() is None for r in refs)
        assert cache.upload_rows - before == len(cache.superbatch().batch)
    assert cache.superbatch().mesh is None
