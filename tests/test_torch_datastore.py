"""End to end: the port's DataStore against the reference's on one shared
catalog (written by the reference), both with the device cache on.

For k in {1, 10, 64} x impl in {sparse, fullscan}, plus a forced sparse
overflow, over 16 queries: the neighbour sets are identical and the
canonical f64 meters bit-identical; counts are equal, and equal to an
f64 NumPy count. The store is 3 days of 9000 rows over 4 day partitions,
each padded to 8192 or 16384 rows: 3 data tiles, so interpret-mode
Pallas stays cheap.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.errors import CudaUnavailableError
from geomesa_tpu_torch.plan import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.query import Query as PQuery

REPO = Path(__file__).resolve().parents[1]
SPEC = "speed:Double,dtg:Date,*geom:Point"
T0 = 1_600_000_000_000
DAY = 86400_000
Q = 16


def iso(ms):
    return str(np.datetime64(ms, "ms")) + "Z"


CQL = (f"BBOX(geom, -10.0, 35.0, 12.5, 55.0) AND dtg > {iso(T0 + 3600_000)} "
       f"AND dtg < {iso(T0 + 2 * DAY + 7200_000)} AND speed > 5.0")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_ds"))
    rng = np.random.default_rng(21)
    n = 3 * 9000
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(30, 60, n)
    order = np.argsort(np.floor((x + 20) / 2.5) * 64 + np.floor((y - 30) / 2.5),
                       kind="stable")  # coarse store order: clustered tiles
    x, y = x[order], y[order]
    t = T0 + np.repeat(np.arange(3), 9000) * DAY + rng.integers(0, DAY, n)
    speed = rng.uniform(0, 30, n)
    ref_ds = RDataStore(root, use_device_cache=True)
    src = ref_ds.create_schema(RSFT.from_spec("gdelt", SPEC))
    src.write(RFB.from_pydict(src.sft, {"speed": speed, "dtg": t,
                                        "geom": np.stack([x, y], 1)}))
    port_ds = PDataStore(root, use_device_cache=True, device="cpu")
    qx = rng.uniform(-8, 10, Q)
    qy = rng.uniform(37, 53, Q)
    return dict(ref=ref_ds.get_feature_source("gdelt"),
                port=port_ds.get_feature_source("gdelt"),
                root=root, x=x, y=y, t=t, speed=speed, qx=qx, qy=qy)


def assert_same(ref_out, port_out):
    rd, ri, _ = ref_out
    pd, pi, _ = port_out
    assert pd.shape == rd.shape and pd.dtype == rd.dtype
    assert pi.dtype == ri.dtype == np.int32
    for i in range(len(rd)):
        fin = np.isfinite(rd[i])
        assert set(ri[i][fin].tolist()) == set(pi[i][np.isfinite(pd[i])].tolist()), i
    # canonical meters: one f64 recompute in both, so bit-identical
    np.testing.assert_array_equal(np.sort(pd, 1), np.sort(rd, 1))


@pytest.mark.parametrize("impl", ["sparse", "fullscan"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_knn_matches_reference(stores, k, impl):
    s = stores
    ref_out = s["ref"].knn(CQL, s["qx"], s["qy"], k=k, impl=impl)
    port_out = s["port"].knn(CQL, s["qx"], s["qy"], k=k, impl=impl)
    assert np.isfinite(port_out[0]).all()
    assert_same(ref_out, port_out)


def test_forced_overflow_matches_reference(stores):
    s = stores
    outs = []
    for src in (s["ref"], s["port"]):
        src.knn(CQL, s["qx"], s["qy"], k=10)  # calibrates and caches
        caps = src.planner._knn_caps
        key = next(k for k in caps if k[1] == 10)
        caps[key] = 1  # 1 tile of capacity: the query's tiles overflow it
        outs.append(src.knn(CQL, s["qx"], s["qy"], k=10))
        assert key not in caps  # the fallback ran and dropped the capacity
    assert_same(*outs)


def test_counts_match_reference_and_f64(stores):
    s = stores
    x, y, t, speed = s["x"], s["y"], s["t"], s["speed"]
    for cql, exp in [
        (CQL, (x >= -10) & (x <= 12.5) & (y >= 35) & (y <= 55)
         & (t > T0 + 3600_000) & (t < T0 + 2 * DAY + 7200_000) & (speed > 5)),
        ("speed BETWEEN 3 AND 4", (speed >= 3) & (speed <= 4)),
        (f"NOT (BBOX(geom, 0, 40, 5, 45)) AND dtg > {iso(T0 + DAY)}",
         ~((x >= 0) & (x <= 5) & (y >= 40) & (y <= 45)) & (t > T0 + DAY)),
        ("INCLUDE", np.ones(len(x), bool)),
    ]:
        got = s["port"].get_count(cql)
        assert got == s["ref"].get_count(cql) == int(exp.sum()), cql


def test_fused_count_rides_the_knn_read(stores):
    s = stores
    launch = s["port"].planner.knn_launch(CQL, s["qx"], s["qy"], k=5,
                                          want_mask_count=True)
    d, i, _ = launch.sync()
    assert launch.mask_count == s["port"].get_count(CQL)
    assert_same(s["ref"].knn(CQL, s["qx"], s["qy"], k=5), (d, i, None))


def test_empty_window_matches_reference(stores):
    s = stores
    cql = f"dtg > {iso(T0 + 30 * DAY)}"
    r = s["ref"].knn(cql, s["qx"], s["qy"], k=4)
    p = s["port"].knn(cql, s["qx"], s["qy"], k=4)
    for a, b in zip(r[:2], p[:2]):
        np.testing.assert_array_equal(a, b)
    assert s["port"].get_count(cql) == 0


def test_scan_path_matches_cached(stores):
    s = stores
    scan = PDataStore(s["root"], use_device_cache=False, device="cpu")
    src = scan.get_feature_source("gdelt")
    assert src.get_count(CQL) == s["port"].get_count(CQL)
    rd = RDataStore(s["root"]).get_feature_source("gdelt")
    assert_same(rd.knn(CQL, s["qx"], s["qy"], k=10),
                src.knn(CQL, s["qx"], s["qy"], k=10))


def test_explain_agrees_with_reference(stores):
    def lines(src):
        return [ln.strip() for ln in src.explain(CQL).splitlines()
                if ln.strip().startswith(("Planning", "Primary", "Partitions"))]

    assert lines(stores["port"]) == lines(stores["ref"])
    assert any(ln.startswith("Partitions: 3 of 4") for ln in lines(stores["port"]))


def test_later_slice_options_raise_typed(stores, tmp_path):
    s = stores
    # impl="auto" is ported (the stats sketches choose the scan): it now
    # answers as the reference's does
    assert_same(s["ref"].knn(CQL, s["qx"], s["qy"], k=3, impl="auto"),
                s["port"].knn(CQL, s["qx"], s["qy"], k=3, impl="auto"))
    # a geomesa.vis.attr type is created on the port, and its counts
    # under each auths set equal the reference's
    vspec = "vis:String,dtg:Date,*geom:Point;geomesa.vis.attr=vis"
    rng = np.random.default_rng(2)
    n = 500
    rows = {"vis": [["", "a", "b", "a&b", None][i]
                    for i in rng.integers(0, 5, n)],
            "dtg": rng.integers(T0, T0 + DAY, n),
            "geom": np.stack([rng.uniform(-5, 5, n),
                              rng.uniform(40, 50, n)], 1)}
    pds = PDataStore(str(tmp_path / "vis"), device="cpu")
    psrc = pds.create_schema(PSFT.from_spec("v", vspec))
    psrc.write(PFB.from_pydict(psrc.sft, rows))
    rsrc = RDataStore(str(tmp_path / "vis")).get_feature_source("v")
    for auths in [(), ("a",), ("a", "b")]:
        for cql in ("INCLUDE", "BBOX(geom, -2, 41, 4, 48)"):
            assert psrc.get_count(PQuery("v", cql, hints=PHints(
                auths=auths))) == rsrc.get_count(RQuery("v", cql, hints=RHints(
                    auths=auths)))


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: DataStore() runs on it")
    with pytest.raises(CudaUnavailableError):
        PDataStore(str(tmp_path / "cat"))


def test_port_imports_no_jax_and_nothing_of_the_reference(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        from geomesa_tpu_torch import DataStore, FeatureBatch, SimpleFeatureType
        ds = DataStore({str(tmp_path)!r}, use_device_cache=True, device="cpu")
        sft = SimpleFeatureType.from_spec("t", "speed:Double,dtg:Date,*geom:Point")
        src = ds.create_schema(sft)
        rng = np.random.default_rng(0)
        n = 5000
        src.write(FeatureBatch.from_pydict(sft, {{
            "speed": rng.uniform(0, 30, n),
            "dtg": rng.integers({T0}, {T0 + 2 * DAY}, n),
            "geom": np.stack([rng.uniform(-5, 5, n), rng.uniform(40, 50, n)], 1)}}))
        d, i, _ = src.knn("BBOX(geom, -4, 41, 4, 49) AND speed > 5", [0.0], [45.0], k=3)
        assert np.isfinite(d).all() and src.get_count("speed > 5") > 0
        from geomesa_tpu_torch.parallel import default_mesh
        mds = DataStore({str(tmp_path)!r}, use_device_cache=True, device="cpu",
                        mesh=default_mesh(["cpu"] * 4))
        md, mi, _ = mds.get_feature_source("t").knn(
            "BBOX(geom, -4, 41, 4, 49) AND speed > 5", [0.0], [45.0], k=3)
        assert np.array_equal(mi, i) and np.array_equal(md, d)
        import torch
        from geomesa_tpu_torch.engine import pip_layer_sharded  # noqa: F401
        from geomesa_tpu_torch.engine.grid_index import knn_indexed_sharded
        from geomesa_tpu_torch.engine.raster import polygon_density_sharded  # noqa: F401
        from geomesa_tpu_torch.engine.stats import stats_sharded
        from geomesa_tpu_torch.engine.tube import (  # noqa: F401
            tube_select_pruned_sharded, tube_select_sharded)
        m4 = default_mesh(["cpu"] * 4)
        assert int(stats_sharded(m4, lambda v: v.sum(), torch.arange(8))) == 28
        gx = torch.linspace(-5, 5, 64)
        gd, gi, _ = knn_indexed_sharded(m4, gx[:2], gx[:2] + 45, gx, gx + 45,
                                        torch.ones(64, dtype=torch.bool), k=2)
        assert gi.shape == (2, 2)
        from geomesa_tpu_torch.process import DensityProcess
        poly = "INTERSECTS(geom, POLYGON((-3 42, 3 42, 0 48, -3 42)))"
        grid = DensityProcess().execute(src, (-5, 40, 5, 50), 32, 32, poly,
                                        weight_attr="speed", radius_pixels=1)
        assert grid.shape == (32, 32) and grid.sum() > 0
        assert src.get_count(poly + " AND speed > 5") > 0
        from geomesa_tpu_torch.engine import pip_layer
        ring = np.array([[-3.0, 42.0], [3.0, 42.0], [0.0, 48.0], [-3.0, 42.0]])
        px, py = np.sort(rng.uniform(-5, 5, 3000)), rng.uniform(40, 50, 3000)
        inside, info = pip_layer(px, py, ring[:-1, 0], ring[:-1, 1], ring[1:, 0],
                                 ring[1:, 1], np.zeros(3, np.int64), device="cpu")
        assert info["pairs"] > 0 and 0 < inside.sum() < 3000
        from geomesa_tpu_torch import Query
        r = src.get_features(Query("t", "BBOX(geom, -4, 41, 4, 49) AND speed > 5",
                                   attributes=["speed", "geom"],
                                   sort_by=[("speed", False)], max_features=50))
        assert r.kind == "features" and len(r.features) == 50
        assert (r.features.columns["speed"][:-1] >= r.features.columns["speed"][1:]).all()
        from geomesa_tpu_torch.process.tube import LineGapFill, TubeSelectProcess
        trk = FeatureBatch.from_pydict(sft, {{
            "speed": [1.0, 1.0], "dtg": [{T0}, {T0 + DAY}],
            "geom": np.array([[-3.0, 43.0], [3.0, 47.0]])}})
        hits = TubeSelectProcess().execute(trk, src, LineGapFill(20_000),
                                           buffer_m=50_000,
                                           max_time_window_ms={DAY})
        assert 0 < len(hits) < n
        import os
        import geomesa_tpu_torch.engine.grid_index  # noqa: F401
        import geomesa_tpu_torch.core.arrow_io  # noqa: F401
        import geomesa_tpu_torch.engine.bin  # noqa: F401
        import geomesa_tpu_torch.engine.geometry  # noqa: F401
        import geomesa_tpu_torch.engine.raster  # noqa: F401
        assert src.get_count("DWITHIN(geom, POINT(0 45), 300, kilometers)") > 0
        from geomesa_tpu_torch.plan.stats_manager import StatsManager
        from geomesa_tpu_torch.process.knn import KNearestNeighborSearchProcess
        assert os.path.exists(os.path.join(src.storage.root, "stats.json"))
        assert StatsManager(src.storage).count == n
        qb = FeatureBatch.from_pydict(SimpleFeatureType.from_spec("q", "*geom:Point"),
                                      {{"geom": np.array([[0.0, 45.0], [1.0, 44.0]])}})
        res = KNearestNeighborSearchProcess().execute(
            qb, src, num_desired=3, cql_filter="speed > 5", device="cpu")
        assert np.isfinite(res.distances_m).all() and not res.partial_recall
        from geomesa_tpu_torch.core.wkt import Geometry
        from geomesa_tpu_torch.plan.runner import run_stats  # noqa: F401
        from geomesa_tpu_torch.process.misc import StatsProcess, UniqueProcess
        from geomesa_tpu_torch.sql import SqlContext
        rs = SimpleFeatureType.from_spec("zones", "name:String,*geom:Polygon")
        ds.create_schema(rs).write(FeatureBatch.from_pydict(rs, {{
            "name": ["z0", "z1"],
            "geom": [Geometry("Polygon", [ring]),
                     Geometry("Polygon", [ring + [0.0, 3.0]])]}}))
        r = SqlContext(ds).sql(
            "SELECT z.name AS zone, COUNT(*) AS n FROM t e "
            "JOIN zones z ON st_contains(z.geom, e.geom) GROUP BY z.name")
        assert r.kind == "features" and int(r.features.columns["n"].sum()) > 0
        st = StatsProcess().execute(src, "Count();MinMax(speed);Cardinality(speed)",
                                    "speed > 5")
        assert st.stats[0].result()["count"] > 0
        zones = ds.get_feature_source("zones")
        assert UniqueProcess().execute(zones, "name") == [("z0", 1), ("z1", 1)]
        import geomesa_tpu_torch.approx.cache  # noqa: F401
        import geomesa_tpu_torch.faults  # noqa: F401
        import geomesa_tpu_torch.telemetry  # noqa: F401
        from geomesa_tpu_torch.serve import QueryService, ServeConfig, self_check
        import geomesa_tpu_torch.compilecache  # noqa: F401
        import geomesa_tpu_torch.serve.pipeline  # noqa: F401
        import geomesa_tpu_torch.serve.ringloop  # noqa: F401
        assert self_check(verbose=False, device="cpu") == 0
        cfg = ServeConfig()
        assert cfg.pipeline and cfg.ring
        svc = QueryService(ds, cfg, autostart=False)
        fut = svc.knn("t", "speed > 5", [0.0], [45.0], k=3)
        svc.start()
        assert np.isfinite(fut.result(timeout=120)[0]).all()
        svc.close(drain=True)
        import geomesa_tpu_torch.approx.engine  # noqa: F401
        import geomesa_tpu_torch.approx.sketches  # noqa: F401
        import geomesa_tpu_torch.core.crs  # noqa: F401
        import geomesa_tpu_torch.plan.interceptor  # noqa: F401
        import geomesa_tpu_torch.security.visibility  # noqa: F401
        import geomesa_tpu_torch.serve.columnar  # noqa: F401
        import geomesa_tpu_torch.parallel.distributed  # noqa: F401
        import geomesa_tpu_torch.parallel.launch  # noqa: F401
        from geomesa_tpu_torch.parallel import global_mesh, is_coordinator
        assert is_coordinator() and global_mesh(["cpu"] * 2).size == 2
        from geomesa_tpu_torch import QueryHints
        world = "BBOX(geom, -180, -90, 180, 90)"
        c = src.get_count(Query("t", world, hints=QueryHints(tolerance=0.1)))
        assert getattr(c, "approx", False) and c == src.get_count(world)
        from geomesa_tpu_torch.faults import FaultPlan, FaultRule, active
        import geomesa_tpu_torch.faults.harness  # noqa: F401
        from geomesa_tpu_torch.convert import converter_from_config
        from geomesa_tpu_torch.convert.schemas import GDELT_CONVERTER, GDELT_SFT
        from geomesa_tpu_torch.jobs import export_partitions, ingest_files
        from geomesa_tpu_torch.store.arrow_store import ArrowDataStore
        from geomesa_tpu_torch.core.arrow_io import write_ipc
        with active(FaultPlan(rules=[FaultRule(site="fs.read_partition",
                                               error="io", nth_call=1)])) as h:
            assert src.storage.read_all() is not None and h.fire_log()
        gd = os.path.join({str(tmp_path)!r}, "g.tsv")
        cols = [""] * 57
        cols[0], cols[1], cols[53], cols[54] = "e1", "20200601", "45.0", "1.0"
        with open(gd, "w") as fh:
            fh.write("\\t".join(cols) + "\\n")
        gsrc = ds.create_schema(GDELT_SFT)
        rep = ingest_files(gsrc, lambda: converter_from_config(
            GDELT_SFT, GDELT_CONVERTER), [gd], workers=2)
        assert rep.features == 1 and gsrc.get_count("INCLUDE") == 1
        assert export_partitions(src, lambda p, b: None, poly, workers=2)
        assert src.delete_features("speed < 1") > 0 and src.storage.compact() >= 0
        ipc = os.path.join({str(tmp_path)!r}, "t.arrow")
        write_ipc(ipc, [src.storage.read_all()])
        asrc = ArrowDataStore(ipc, device="cpu").get_feature_source()
        assert asrc.get_count("speed > 5") == src.get_count("speed > 5")
        import time
        from geomesa_tpu_torch.index import KVDataStore
        from geomesa_tpu_torch.kafka import KafkaDataStore
        from geomesa_tpu_torch.lambda_store import LambdaDataStore
        from geomesa_tpu_torch.core.columnar import DictColumn
        kb = src.storage.read_all()
        kb = FeatureBatch(kb.sft, kb.columns,
                          DictColumn.encode([f"k{{j}}" for j in range(len(kb))]), None)
        kv = KVDataStore(device="cpu").create_schema(kb.sft)
        kv.write(kb)
        assert kv.get_count(poly + " AND speed > 5") == src.get_count(poly + " AND speed > 5")
        lsrc = KafkaDataStore(device="cpu").create_schema(kb.sft)
        lsrc.write(kb)
        assert lsrc.get_count("INCLUDE") == len(kb)
        d, i, _ = lsrc.knn("speed > 5", [0.0], [45.0], k=3)
        assert np.isfinite(d).all()
        lam = LambdaDataStore(os.path.join({str(tmp_path)!r}, "lam"),
                              persist_after_ms=0, device="cpu")
        lam.create_schema(kb.sft)
        lam.write("t", kb.select(np.arange(100)))
        assert lam.persist("t", now=time.time() + 1.0) == 100
        lam.write("t", kb.select(np.arange(50, 150)))
        assert lam.get_count(Query("t", "INCLUDE")) == 150
        import torch
        from geomesa_tpu_torch.engine import lanes
        from geomesa_tpu_torch.subscribe import SubscriptionManager
        kds = KafkaDataStore(device="cpu")
        live = kds.create_schema(kb.sft)
        mgr = SubscriptionManager(kds)
        sub = mgr.subscribe("t", "BBOX(geom, -180, -90, 180, 90)")
        live.write(kb.select(np.arange(8)))
        kds.poll("t")
        assert len(sub.matched) == 8
        mgr.close()
        m, _ = lanes.lane_bbox(torch.zeros((1, 8)), torch.ones(1, dtype=torch.bool),
                               torch.zeros(4), torch.zeros(4),
                               torch.ones(4, dtype=torch.bool))
        assert m.all()
        import geomesa_tpu_torch.telemetry.export  # noqa: F401
        import geomesa_tpu_torch.telemetry.gap  # noqa: F401
        import geomesa_tpu_torch.telemetry.prof  # noqa: F401
        import geomesa_tpu_torch.telemetry.sentinel  # noqa: F401
        import geomesa_tpu_torch.telemetry.slo  # noqa: F401
        import geomesa_tpu_torch.utils.profiling  # noqa: F401
        from geomesa_tpu_torch.telemetry import (
            PROFILER, MetricsServer, SloEngine, SloSpec, gap_report,
            to_perfetto)
        from geomesa_tpu_torch.serve import QueryService, ServeConfig
        tsvc = QueryService(ds, ServeConfig(
            pipeline=False, ring=False, trace=True, profile=True,
            slo={{"objective": {{"a": {{"kind": "availability"}}}}}}))
        tsrv = MetricsServer(port=0, stats_fn=tsvc.stats,
                             pre_scrape=tsvc.export_gauges,
                             slo_fn=tsvc.slo.report)
        tsrv.start()
        tsvc.count("t", "speed > 5").result(timeout=120)
        import urllib.request
        with urllib.request.urlopen(tsrv.url + "/debug/prof", timeout=10) as r:
            assert r.status == 200
        tsrv.stop()
        tsvc.close(drain=True)
        PROFILER.disable()
        from geomesa_tpu_torch.telemetry import RECORDER
        assert gap_report(RECORDER.traces())["traces"] >= 1
        assert to_perfetto(RECORDER.traces())["traceEvents"]
        from geomesa_tpu_torch.utils.config import SystemProperties
        SystemProperties.set("geomesa.profile.dir",
                             os.path.join({str(tmp_path)!r}, "prof"))
        assert src.get_count("speed > 5") >= 0
        SystemProperties.clear("geomesa.profile.dir")
        assert os.listdir(os.path.join({str(tmp_path)!r}, "prof"))
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "geomesa_tpu."))
               or m == "geomesa_tpu"]
        print("LOADED", bad)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
