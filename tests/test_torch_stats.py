"""The port's write-path stats sketches (geomesa_tpu_torch.stats,
plan/stats_manager.py) and the planner's stats-driven kNN choice against
the reference package's, on the same seeded batches.

The same two batches (a dtg schema with a String, an Integer and a
Double attribute) are written through both packages' DataStore into two
catalogs. Held exactly: `stats.json` parses to the same dict in both; a
store written by either package opens in the other with equal counts,
min/max, top-k and `estimate_count` over a set of boxes and intervals;
`_knn_impl_from_stats` picks the same kernel in both for a whole-world
window, a selective box, an attribute predicate and no stats (after
`invalidate`), and `planner.knn(impl="auto")` runs the route it picked;
the `z2` sketch (a schema without a dtg) over a stub storage; every Stat
kind's JSON reads across packages.
"""

import json
import os

import numpy as np
import pytest

import geomesa_tpu.engine.knn_scan as ref_knn_scan_mod
import geomesa_tpu.stats as ref_stats
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql.extract import BBox as RBBox
from geomesa_tpu.cql.extract import Interval as RInterval
from geomesa_tpu.plan import DataStore as RDataStore
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.plan.stats_manager import StatsManager as RStatsManager
import geomesa_tpu_torch.plan.planner as port_planner_mod
import geomesa_tpu_torch.stats as port_stats
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.cql.extract import BBox as PBBox
from geomesa_tpu_torch.cql.extract import Interval as PInterval
from geomesa_tpu_torch.plan import DataStore as PDataStore
from geomesa_tpu_torch.plan import Query as PQuery
from geomesa_tpu_torch.plan.stats_manager import StatsManager as PStatsManager

SPEC = "name:String,level:Integer,speed:Double,dtg:Date,*geom:Point"
T0 = 1_600_000_000_000
DAY = 86400_000
WEEK = 7 * DAY
NAMES = [f"ship{i}" for i in range(30)]


def batch_cols(seed, n):
    rng = np.random.default_rng(seed)
    return {"name": [NAMES[i] for i in rng.zipf(1.5, n) % len(NAMES)],
            "level": rng.integers(-5, 100, n).astype(np.int32),
            "speed": rng.uniform(0, 30, n),
            "dtg": T0 + rng.integers(0, 20 * DAY, n),
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}


def write_both(root, batches):
    ref = RDataStore(os.path.join(root, "ref")).create_schema(
        RSFT.from_spec("s", SPEC))
    port = PDataStore(os.path.join(root, "port"), device="cpu").create_schema(
        PSFT.from_spec("s", SPEC))
    for cols in batches:
        ref.write(RFB.from_pydict(ref.sft, cols))
        port.write(PFB.from_pydict(port.sft, cols))
    return ref, port


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_stats"))
    # a whole-world batch, then one packed into a box (selective windows)
    second = batch_cols(2, 3000)
    rng = np.random.default_rng(3)
    second["geom"] = np.stack([rng.uniform(10, 20, 3000),
                               rng.uniform(40, 50, 3000)], 1)
    ref, port = write_both(root, [batch_cols(1, 6000), second])
    return dict(root=root, ref=ref, port=port)


BOXES = [(-180.0, -90.0, 180.0, 90.0), (10.0, 40.0, 20.0, 50.0),
         (-30.0, -10.0, 5.0, 25.0), (100.0, 60.0, 101.0, 61.0)]
INTERVALS = [(None, None), (T0, T0 + 20 * DAY), (T0 + 3 * DAY, T0 + 4 * DAY),
             (T0 + 30 * DAY, T0 + 40 * DAY)]


def estimates(mgr, bbox_cls, interval_cls):
    return [mgr.estimate_count(bbox_cls(*b), interval_cls(*i))
            for b in BOXES for i in INTERVALS]


def test_stats_json_parses_to_the_same_dict(stores):
    with open(os.path.join(stores["root"], "ref", "s", "stats.json")) as f:
        ref = json.load(f)
    with open(os.path.join(stores["root"], "port", "s", "stats.json")) as f:
        port = json.load(f)
    assert ref == port
    assert set(port) == {"count", "topk:name", "minmax:level", "minmax:speed",
                         "minmax:dtg", "z3"}
    assert port["count"]["count"] == 9000


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_catalog_opens_in_the_other_package(stores, writer):
    root = os.path.join(stores["root"], writer)
    ref = RDataStore(root).get_feature_source("s").planner.stats_manager()
    port = PDataStore(root, device="cpu").get_feature_source(
        "s").planner.stats_manager()
    assert port.count == ref.count == 9000
    assert port.summary() == ref.summary()
    for attr in ("level", "speed", "dtg"):
        assert port.minmax(attr) == ref.minmax(attr)
    assert port.topk("name") == ref.topk("name")
    pe = estimates(port, PBBox, PInterval)
    assert pe == estimates(ref, RBBox, RInterval)
    assert pe[0] == 9000 and pe[-1] == 0  # world, all time; outside the data
    assert pe[4] >= 3000  # the packed box holds the whole second batch


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_explain_estimate_matches(stores, writer):
    root = os.path.join(stores["root"], writer)
    cql = (f"BBOX(geom, 10, 40, 20, 50) AND dtg DURING "
           f"{np.datetime64(T0, 'ms')}Z/{np.datetime64(T0 + 5 * DAY, 'ms')}Z")

    def line(src):
        return [ln.strip() for ln in src.explain(cql).splitlines()
                if "Estimated matches" in ln]

    got = line(PDataStore(root, device="cpu").get_feature_source("s"))
    assert got == line(RDataStore(root).get_feature_source("s"))
    assert len(got) == 1 and int(got[0].split("~")[1]) > 0


KNN_CASES = [
    ("BBOX(geom, -180, -90, 180, 90)", "fullscan"),
    ("BBOX(geom, 10, 40, 12, 42)", "sparse"),
    ("BBOX(geom, -180, -90, 180, 90) AND speed > 29.9", "sparse"),
    (f"dtg > {np.datetime64(T0 - DAY, 'ms')}Z", "fullscan"),
    ("name = 'ship3'", "sparse"),
]


@pytest.mark.parametrize("cql,expect", KNN_CASES)
def test_knn_impl_from_stats_matches_reference(stores, cql, expect):
    root = os.path.join(stores["root"], "ref")
    rp = RDataStore(root).get_feature_source("s").planner
    pp = PDataStore(root, device="cpu").get_feature_source("s").planner
    r = rp._knn_impl_from_stats(rp.plan(RQuery("s", cql)))
    p = pp._knn_impl_from_stats(pp.plan(PQuery("s", cql)))
    assert p == r == expect


def spy_routes(monkeypatch, module):
    calls = []
    for name, tag in (("knn_sparse_launch", "sparse"),
                      ("knn_fullscan_tiled", "fullscan")):
        real = getattr(module, name)

        def spy(*a, _real=real, _tag=tag, **kw):
            calls.append(_tag)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("cql,expect", KNN_CASES[:3])
def test_auto_runs_the_chosen_route(stores, monkeypatch, cql, expect):
    port = PDataStore(os.path.join(stores["root"], "port"), device="cpu"
                      ).get_feature_source("s")
    calls = spy_routes(monkeypatch, port_planner_mod)
    qx, qy = np.array([15.0, -20.0]), np.array([45.0, 10.0])
    d, i, _ = port.knn(cql, qx, qy, k=3, impl="auto")
    assert calls == [expect]
    launch = port.planner.knn_launch(cql, qx, qy, k=3, impl="auto")
    assert launch.impl == expect
    launch.sync()
    dd, ii, _ = port.knn(cql, qx, qy, k=3, impl=expect)
    np.testing.assert_array_equal(d, dd)
    np.testing.assert_array_equal(i, ii)


def test_no_stats_routes_sparse_in_both(tmp_path, monkeypatch):
    ref, port = write_both(str(tmp_path), [batch_cols(4, 2000)])
    ref.planner.stats_manager().invalidate()
    port.planner.stats_manager().invalidate()
    assert not os.path.exists(os.path.join(port.storage.root, "stats.json"))
    cql = "BBOX(geom, -180, -90, 180, 90)"
    r = ref.planner._knn_impl_from_stats(ref.planner.plan(RQuery("s", cql)))
    p = port.planner._knn_impl_from_stats(port.planner.plan(PQuery("s", cql)))
    assert p == r == "sparse"
    calls = spy_routes(monkeypatch, port_planner_mod)
    port.knn(cql, np.array([0.0]), np.array([0.0]), k=2, impl="auto")
    assert calls == ["sparse"]
    ref_calls = spy_routes(monkeypatch, ref_knn_scan_mod)
    ref.knn(cql, np.array([0.0]), np.array([0.0]), k=2, impl="auto")
    assert ref_calls == ["sparse"]
    # the next write finds data but no sketches: a full analyze, in both
    cols = batch_cols(5, 500)
    ref.write(RFB.from_pydict(ref.sft, cols))
    port.write(PFB.from_pydict(port.sft, cols))
    assert port.planner.stats_manager().count == 2500
    with open(os.path.join(ref.storage.root, "stats.json")) as f:
        rj = json.load(f)
    with open(os.path.join(port.storage.root, "stats.json")) as f:
        assert json.load(f) == rj


class StubStorage:
    """What StatsManager reads of a storage: root, sft, count, scan()."""

    def __init__(self, root, sft, batches):
        self.root, self.sft, self.batches = root, sft, batches

    @property
    def count(self):
        return sum(len(b) for b in self.batches)

    def scan(self):
        return iter(self.batches)


def test_z2_sketch_over_a_stub_storage(tmp_path):
    spec = "v:Double,*geom:Point"
    rng = np.random.default_rng(8)
    cols = [{"v": rng.uniform(0, 1, n),
             "geom": np.stack([rng.uniform(-170, 170, n),
                               rng.uniform(-80, 80, n)], 1)} for n in (700, 300)]
    out = {}
    for tag, sft_cls, fb, mgr_cls, bb, iv in (
            ("ref", RSFT, RFB, RStatsManager, RBBox, RInterval),
            ("port", PSFT, PFB, PStatsManager, PBBox, PInterval)):
        root = tmp_path / tag
        root.mkdir()
        sft = sft_cls.from_spec("z", spec)
        batches = [fb.from_pydict(sft, c) for c in cols]
        stub = StubStorage(str(root), sft, batches[:1])
        mgr = mgr_cls(stub)
        mgr.update(batches[0])
        stub.batches = batches
        mgr.update(batches[1])
        assert "z2" in mgr.stats and "z3" not in mgr.stats
        est = estimates(mgr, bb, iv)
        with open(root / "stats.json") as f:
            doc = json.load(f)
        # a fresh manager over the stub: the full analyze gives the same
        fresh = mgr_cls(StubStorage(str(root), sft, batches))
        fresh.invalidate()
        fresh.analyze()
        assert estimates(fresh, bb, iv) == est
        out[tag] = (est, doc)
    assert out["port"] == out["ref"]
    est = out["port"][0]
    assert est[0] == 1000  # the world box; the z2 sketch has no time bins


def test_every_stat_kind_reads_across_packages():
    rng = np.random.default_rng(9)
    vals = rng.normal(size=500)
    words = [NAMES[i % 7] for i in range(500)]
    mm, card = ref_stats.MinMax("v"), ref_stats.Cardinality("w")
    freq, topk = ref_stats.Frequency("w"), ref_stats.TopK("w", 3)
    hist = ref_stats.Histogram("v", 10, -3.0, 3.0)
    desc, enum = ref_stats.DescriptiveStats("v"), ref_stats.EnumerationStat("w")
    for s, v in ((mm, vals), (card, words), (freq, words), (topk, words),
                 (hist, vals), (desc, vals), (enum, words)):
        s.observe(v)
    z3 = ref_stats.Z3HistogramStat("geom", "dtg", "week", 4)
    z3.observe_grid(2640, np.arange(16).reshape(4, 4))
    group = ref_stats.GroupBy("w", lambda: ref_stats.MinMax("v"))
    group.observe_grouped("a", vals[:10])
    seq = ref_stats.parse_stats("MinMax(v);Count();TopK(w,4);Histogram(v,5,0,1)")
    for s in (mm, card, freq, topk, hist, desc, enum, z3, group, seq):
        doc = json.loads(json.dumps(s.to_json()))
        back = port_stats.Stat.from_json(doc)
        assert type(back).__name__ == type(s).__name__
        assert back.to_json() == doc
        # and the reverse: the port's JSON reads in the reference
        assert ref_stats.Stat.from_json(back.to_json()).to_json() == doc
    p = port_stats.parse_stats("MinMax(v);Count();TopK(w,4);Histogram(v,5,0,1)")
    assert p.to_json() == seq.to_json()
