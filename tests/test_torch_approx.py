"""The port's approximate-answer tier (`geomesa_tpu_torch.approx`) against
the reference's on one catalog.

The catalog is written by the reference; the port reads it on the CPU
(`device="cpu"`) with the device cache on. On the same seeded rows:
sketch grids, count bounds, resampled density grids and topk cells are
identical between the packages; every sketch answer's bound contains
the exact count; distinct counts (HLL and exact) agree; a write makes
the sketches stale (typed fallthrough, never a torn merge); the sidecar
each package writes is loaded by the other with zero builds; and the
serve tier answers a tolerant count at admission, its sketch rung
included, as the reference's does.
"""

import json
import time

import numpy as np
import pytest

from geomesa_tpu.approx import ApproxCount as RApprox
from geomesa_tpu.approx import sketches as rsk
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql.extract import BBox, Interval
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.serve import QueryService as RService
from geomesa_tpu.serve import ServeConfig as RConfig
from geomesa_tpu.serve.protocol import serve_lines as r_serve_lines
from geomesa_tpu_torch.approx import ApproxCount as PApprox
from geomesa_tpu_torch.approx import sketches as psk
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.serve import QueryService as PService
from geomesa_tpu_torch.serve import ServeConfig as PConfig
from geomesa_tpu_torch.serve.protocol import serve_lines as p_serve_lines

SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
T0, T1 = 1_590_000_000_000, 1_600_000_000_000
INTERVAL_CQL = ("BBOX(geom, -90, -45, 90, 45) AND dtg DURING "
                "2020-05-25T00:00:00Z/2020-08-01T00:00:00Z")
CQLS = ["BBOX(geom, -180, -90, 180, 90)", "BBOX(geom, -60, -30, 60, 30)",
        "BBOX(geom, 0, 0, 90, 45)", INTERVAL_CQL]
INELIGIBLE = ["name = 'a'", "BBOX(geom, -60, -30, 60, 30) AND score > 0",
              "BBOX(geom,-10,-10,10,10) OR BBOX(geom,20,20,30,30)"]
PKG = {"ref": (RQuery, RHints, RApprox), "port": (PQuery, PHints, PApprox)}


def rows(seed, n, narrow=False):
    rng = np.random.default_rng(seed)
    dtg = (rng.integers(T0, T0 + 6 * 86_400_000, n) if narrow
           else rng.integers(T0, T1, n))
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-10, 10, n), "dtg": dtg,
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}


def make(root, seed=1, n=4096):
    """A reference-written catalog and both packages' stores over it."""
    ref = RDataStore(root, use_device_cache=True)
    src = ref.create_schema(RSFT.from_spec("apx", SPEC))
    src.write(RFB.from_pydict(src.sft, rows(seed, n)))
    return {"ref": ref,
            "port": PDataStore(root, use_device_cache=True, device="cpu")}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    return make(str(tmp_path_factory.mktemp("torch_approx")))


def planner(stores, pkg):
    return stores[pkg].get_feature_source("apx").planner


def query(pkg, cql, **hints):
    q_cls, h_cls, _ = PKG[pkg]
    return q_cls("apx", cql, hints=h_cls(**hints))


def both(stores, fn):
    return {pkg: fn(pkg, planner(stores, pkg)) for pkg in PKG}


# -- sketches and bound math ------------------------------------------------


def test_partition_sketches_equal_reference(stores):
    storage = planner(stores, "port").storage
    snap = storage.manifest_snapshot()
    rstore = rsk.PartitionSketchStore(planner(stores, "ref").storage)
    pstore = psk.PartitionSketchStore(storage)
    for name in snap:
        r, p = rstore.build(name, snap[name]), pstore.build(name, snap[name])
        assert p.token == r.token and p.rows == r.rows
        assert sorted(p.grids) == sorted(r.grids)
        for b in r.grids:
            np.testing.assert_array_equal(p.grids[b], r.grids[b])
    x = np.random.default_rng(3).uniform(-200, 200, 999)
    for a, b in zip(psk.world_cells(x, x / 2, 64), rsk.world_cells(x, x / 2, 64)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bound_math_equals_reference(stores, seed):
    storage = planner(stores, "port").storage
    snap = storage.manifest_snapshot()
    store = psk.PartitionSketchStore(storage)
    sketches = [store.build(n, snap[n]) for n in snap]
    rng = np.random.default_rng(seed)
    for _ in range(6):
        x0, x1 = sorted(rng.uniform(-185, 185, 2))
        y0, y1 = sorted(rng.uniform(-95, 95, 2))
        a, b = sorted(rng.integers(T0, T1, 2))
        for iv in (Interval(None, None), Interval(int(a), int(b))):
            bb = BBox(x0, y0, x1, y1)
            assert (psk.merge_count_bounds(sketches, bb, iv)
                    == rsk.merge_count_bounds(sketches, bb, iv))
        sure, maybe, _ = psk.merge_region(sketches, Interval(int(a), int(b)))
        rsure, rmaybe, _ = rsk.merge_region(sketches, Interval(int(a), int(b)))
        np.testing.assert_array_equal(sure, rsure)
        np.testing.assert_array_equal(maybe, rmaybe)
        g, bound = psk.resample_bounds(sure, maybe, (x0, y0, x1, y1), 9, 5)
        rg, rbound = rsk.resample_bounds(sure, maybe, (x0, y0, x1, y1), 9, 5)
        np.testing.assert_array_equal(g, rg)
        assert bound == rbound
        assert (psk.topk_cell_bounds(sure, maybe, BBox(x0, y0, x1, y1), 7)
                == rsk.topk_cell_bounds(sure, maybe, BBox(x0, y0, x1, y1), 7))


# -- counts, density, topk, distinct ------------------------------------------


@pytest.mark.parametrize("cql", CQLS)
def test_tolerant_count_equals_reference(stores, cql):
    got = both(stores, lambda pkg, pl: pl.count(query(pkg, cql,
                                                      tolerance=0.25)))
    assert isinstance(got["port"], PApprox) == isinstance(got["ref"], RApprox)
    assert isinstance(got["port"], PApprox)
    assert int(got["port"]) == int(got["ref"])
    assert got["port"].bound == got["ref"].bound
    assert got["port"].confidence == got["ref"].confidence == 1.0
    exact = planner(stores, "port").count(PQuery("apx", cql))
    assert abs(int(got["port"]) - exact) <= got["port"].bound


@pytest.mark.parametrize("cql", INELIGIBLE)
def test_ineligible_filters_route_exact(stores, cql):
    pl = planner(stores, "port")
    got = pl.count(query("port", cql, tolerance=0.5))
    assert not isinstance(got, PApprox)
    assert got == pl.count(PQuery("apx", cql)) == planner(
        stores, "ref").count(RQuery("apx", cql))
    assert pl.approx_engine().last_reason == "ineligible"


def test_density_and_topk_equal_reference(stores):
    dh = dict(density_bbox=(-60.0, -30.0, 60.0, 30.0), density_width=12,
              density_height=6)
    got = both(stores, lambda pkg, pl: pl.execute(
        query(pkg, CQLS[1], tolerance=0.5, **dh)))
    assert got["port"].approx and got["port"].bound == got["ref"].bound
    np.testing.assert_array_equal(got["port"].grid, got["ref"].grid)
    exact = planner(stores, "port").execute(query("port", CQLS[1], **dh))
    assert np.abs(got["port"].grid - exact.grid).max() <= got["port"].bound
    for tol in (1.0, None):
        got = both(stores, lambda pkg, pl: pl.execute(
            query(pkg, CQLS[1], tolerance=tol, topk_cells=5)))
        assert got["port"].kind == "topk_cells"
        assert got["port"].approx == (tol is not None) == got["ref"].approx
        assert got["port"].stats == got["ref"].stats
        assert got["port"].count == got["ref"].count


def test_topk_exact_ties_and_rounding(stores):
    """The exact fallback ranks (-count, row, col) over the 64 x 64 world
    grid of the matching rows; held to a NumPy binning and to the
    reference's on every cell (ties included)."""
    pl = planner(stores, "port")
    cells = pl.execute(query("port", CQLS[2], topk_cells=4096)).stats
    ref = planner(stores, "ref").execute(
        query("ref", CQLS[2], topk_cells=4096)).stats
    assert cells == ref
    r = rows(1, 4096)
    x, y = r["geom"][:, 0], r["geom"][:, 1]
    sel = (x >= 0) & (x <= 90) & (y >= 0) & (y <= 45)
    grid = np.zeros((64, 64), np.int64)
    # the device binning: f32 coordinates, f32 cell constants
    cx = np.floor((x.astype(np.float32) + np.float32(180))
                  / np.float32(360 / 64)).astype(int)
    cy = np.floor((y.astype(np.float32) + np.float32(90))
                  / np.float32(180 / 64)).astype(int)
    np.add.at(grid, (cy[sel], cx[sel]), 1)
    want = sorted(((-grid[r_, c], r_, c) for r_, c in zip(*np.nonzero(grid))))
    assert [(-c["count"], c["row"], c["col"]) for c in cells] == want


def test_distinct_equals_reference(stores):
    # three names: the 3-sigma HLL bound is 1, which fits a tolerance of 0.5
    for cql, tol in (("INCLUDE", 0.5), ("INCLUDE", 0.1), ("INCLUDE", None),
                     ("score > 0", 0.5), ("score > 0", None)):
        got = both(stores, lambda pkg, pl: pl.count(
            query(pkg, cql, distinct="name", tolerance=tol)))
        assert int(got["port"]) == int(got["ref"]) == 3
        assert isinstance(got["port"], PApprox) == isinstance(
            got["ref"], RApprox) == (cql == "INCLUDE" and tol == 0.5)
        if isinstance(got["port"], PApprox):
            assert got["port"].bound == got["ref"].bound
            assert got["port"].confidence == 0.99
    for bad in ("nope", "geom"):
        with pytest.raises(ValueError):
            planner(stores, "port").count(query("port", "INCLUDE",
                                                distinct=bad))


# -- staleness and the sidecar ------------------------------------------------


def test_stale_sketch_after_write_falls_through(tmp_path):
    s = make(str(tmp_path / "cat"), seed=11, n=1024)
    src = s["port"].get_feature_source("apx")
    pl = src.planner
    eng = pl.approx_engine()
    q = query("port", CQLS[1], tolerance=0.25)
    assert isinstance(pl.count(q), PApprox)
    src.write(PFB.from_pydict(src.sft, rows(999, 128, narrow=True)))
    snap = pl.storage.manifest_snapshot()
    assert any(eng.store.get(n, snap[n]) is None for n in snap)
    eng.allow_build = False
    try:
        a = pl.count(q)
        assert not isinstance(a, PApprox)
        assert eng.last_reason == "stale_sketch"
        assert a == pl.count(PQuery("apx", CQLS[1]))
    finally:
        eng.allow_build = True
    a2 = pl.count(q)
    assert isinstance(a2, PApprox)
    assert abs(int(a2) - pl.count(PQuery("apx", CQLS[1]))) <= a2.bound


@pytest.mark.parametrize("writer, reader", [("ref", "port"), ("port", "ref")])
def test_sidecar_loads_across_packages(tmp_path, writer, reader):
    """A sidecar one package wrote is loaded by the other with zero
    builds and gives the same approximate count and bound."""
    root = str(tmp_path / "cat")
    s = make(root, seed=21, n=1024)
    a1 = planner(s, writer).count(query(writer, CQLS[1], tolerance=0.25))
    with open(f"{root}/apx/.approx_sketches.json") as f:
        assert len(json.load(f)["partitions"]) >= 1
    fresh = (RDataStore(root, use_device_cache=True) if reader == "ref"
             else PDataStore(root, use_device_cache=True, device="cpu"))
    pl = fresh.get_feature_source("apx").planner
    eng = pl.approx_engine()
    st = eng.store.stats()
    assert st["sidecar_loaded"] >= 1 and st["sidecar_stale"] == 0
    eng.allow_build = False
    try:
        a2 = pl.count(query(reader, CQLS[1], tolerance=0.25))
    finally:
        eng.allow_build = True
    assert type(a2).__name__ == "ApproxCount"
    assert int(a2) == int(a1) and a2.bound == a1.bound


# -- the serve tier -----------------------------------------------------------


def test_admission_answer_and_tiers_equal_reference(stores):
    got = {}
    for pkg, svc_cls, cfg_cls in (("ref", RService, RConfig),
                                  ("port", PService, PConfig)):
        pl = planner(stores, pkg)
        assert isinstance(pl.count(query(pkg, CQLS[1], tolerance=0.25)),
                          PKG[pkg][2])  # warm: the peek never builds
        svc = svc_cls(stores[pkg], cfg_cls(max_wait_ms=0.0, pipeline=False,
                                           ring=False), autostart=False)
        try:
            req = svc._request("count", query(pkg, CQLS[1], tolerance=0.25))
            fut = svc.submit(req)
            assert fut.done() and req.approx  # resolved at admission
            st = svc.stats()
            got[pkg] = (int(fut.result()), fut.result().bound,
                        st["approx"]["tiers"], st["approx_served"])
        finally:
            svc.start()
            svc.close(drain=True)
    assert got["port"] == got["ref"]


def test_degrade_ladder_sketch_rung(stores):
    pl = planner(stores, "port")
    assert isinstance(pl.count(query("port", CQLS[1], tolerance=0.5)),
                      PApprox)
    cfg = PConfig(max_queue=4, degrade=True, degrade_watermark=0.25,
                  shed_watermark=0.9, max_wait_ms=0.0, pipeline=False,
                  ring=False, approx_degrade_tolerance=0.5)
    svc = PService(stores["port"], cfg, autostart=False)
    try:
        svc.count("apx", "score > 1")  # queue occupancy
        req = svc._request("count", PQuery("apx", CQLS[1]),
                           allow_degraded=True)
        fut = svc.submit(req)
        assert req.sketch_rung == 1 and not req.query.hints.loose_bbox
        assert req.query.hints.tolerance == 0.5
        assert fut.done() and isinstance(fut.result(), PApprox)
        assert req.degraded
        req2 = svc._request("count", PQuery("apx", "name = 'a'"),
                            allow_degraded=True)
        svc._degrade(req2, 1)
        assert req2.sketch_rung == 0
        assert req2.degraded and req2.query.hints.loose_bbox
    finally:
        svc.start()
        svc.close(drain=True)


def test_wire_fields_equal_reference(stores):
    docs = [{"id": "a1", "op": "count", "typeName": "apx", "cql": CQLS[1],
             "tolerance": 0.25},
            {"id": "t1", "op": "query", "typeName": "apx", "cql": CQLS[1],
             "topkCells": 3},
            {"id": "t2", "op": "query", "typeName": "apx", "cql": CQLS[1],
             "topkCells": 3, "tolerance": 1.0},
            {"id": "d1", "op": "count", "typeName": "apx", "cql": "INCLUDE",
             "distinct": "name", "tolerance": 0.5},
            {"id": "d2", "op": "query", "typeName": "apx", "cql": CQLS[1],
             "tolerance": 0.5, "density": {"bbox": [-60, -30, 60, 30],
                                           "width": 12, "height": 6}}]
    got = {}
    for pkg, serve_lines, cfg in (("ref", r_serve_lines, RConfig),
                                  ("port", p_serve_lines, PConfig)):
        out = []
        serve_lines(stores[pkg], (json.dumps(d) for d in docs), out.append,
                    cfg(max_wait_ms=0.0, pipeline=False, ring=False))
        got[pkg] = {d["id"]: d for d in map(json.loads, out)}
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p["a1"]["approx"] and p["a1"]["lo"] <= p["a1"]["count"] <= p["a1"]["hi"]
    assert p["t1"]["kind"] == "topk_cells" and len(p["t1"]["cells"]) == 3
    assert p["d1"]["count"] == 3 and p["d1"]["confidence"] == 0.99
    assert p["d2"]["approx"] and p["d2"]["kind"] == "density"


def test_sketch_answer_is_faster_than_exact(stores):
    """Warm tolerant counts against warm exact counts on the CPU store:
    the sketch path runs no device work."""
    pl = planner(stores, "port")
    qa, qe = query("port", CQLS[1], tolerance=0.25), PQuery("apx", CQLS[1])
    assert isinstance(pl.count(qa), PApprox)
    pl.count(qe)

    def p50(q, reps=9):
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            pl.count(q)
            ts.append(time.perf_counter() - t)
        return float(np.percentile(ts, 50))

    assert p50(qe) / p50(qa) >= 5.0
