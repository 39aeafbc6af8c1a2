"""The port's SqlContext against the reference package's, over catalogs
the reference writes (both packages open each one, the port on the CPU).

- The reference's spatial-join cases (`tests/test_sql_spatial_join.py`):
  JOIN ... ON st_contains / st_within / st_intersects, LEFT OUTER, GROUP
  BY over the join, and the point-point rejection.
- A parametrised selection from `tests/test_sql_engine_jobs.py` and
  `tests/test_sql_functions.py`: pushdown WHERE (BBOX, polygon literals,
  temporal BETWEEN, IN / LIKE / IS NULL), local st_* post-filters,
  aggregates with GROUP BY and HAVING, NULL semantics, DISTINCT,
  ORDER BY / LIMIT, equi-joins (inner, LEFT / RIGHT OUTER, chains), and
  the errors both packages raise.
- Config 2 as users write it, as a whole: a 200-polygon layer shaped as
  the reference bench's (`chip_smoke.gen_admin_layer`) x 2^14 Morton-
  ordered points of one day (one partition keeps their order), 1/64 of
  them within 1e-6 degrees of an edge; the per-region counts are equal,
  and the port's joined (region, point) pairs equal the reference's
  `pip_layer_join` pairs on the same arrays.

Held: equal result kinds and counts, equal schemas, and equal columns
(strings decoded, numbers bit for bit with NaN as NULL, geometry by its
CSR arrays). The reference's Pallas kernels run in interpret mode.
"""

import collections
import os
import sys

import numpy as np
import pytest

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.core.wkt import Geometry as RGeometry
from geomesa_tpu.engine import pip_sparse as ref_ps
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.sql.engine import SqlContext as RSql, SqlError as RSqlError
from geomesa_tpu_torch.plan import DataStore as PDataStore
from geomesa_tpu_torch.sql import SqlContext as PSql, SqlError as PSqlError

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the bench's seeded layer generator)
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)


def ring(cx, cy, r, ne=24, reverse=False):
    th = np.linspace(0, 2 * np.pi, ne, endpoint=False)
    if reverse:
        th = th[::-1]
    pts = np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1)
    return np.concatenate([pts, pts[:1]])


def column_values(c):
    if hasattr(c, "vocab"):
        return c.decode()
    if hasattr(c, "x"):
        if c.vertices is None:
            return (np.asarray(c.x).tolist(), np.asarray(c.y).tolist())
        return (c.vertices.tolist(), c.ring_offsets.tolist(),
                c.feature_rings.tolist())
    a = np.asarray(c)
    return (str(a.dtype), np.where(np.isnan(a), -7.5e300, a).tolist()
            if a.dtype.kind == "f" else a.tolist())


def assert_same(r, p):
    assert (p.kind, p.count) == (r.kind, r.count)
    if r.features is None:
        assert p.features is None
        return
    assert p.features.sft.to_spec() == r.features.sft.to_spec()
    assert len(p.features) == len(r.features)
    for k, c in r.features.columns.items():
        assert column_values(p.features.columns[k]) == column_values(c), k


def run_both(cat, q):
    r = RSql(cat["ref"]).sql(q)
    p = PSql(cat["port"]).sql(q)
    assert_same(r, p)
    return r, p


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """The reference's test_sql_spatial_join stores: four 8-degree
    regions (one with a hole) and 4,000 events."""
    root = str(tmp_path_factory.mktemp("torch_sql_spatial"))
    rng = np.random.default_rng(41)
    rsft = RSFT.from_spec("regions", "name:String,*geom:Polygon")
    centers = [(-20.0, -10.0), (0.0, 15.0), (25.0, -5.0), (40.0, 20.0)]
    polys = [RGeometry("Polygon", [ring(cx, cy, 8.0)]) for cx, cy in centers]
    polys[1] = RGeometry("Polygon", [ring(0.0, 15.0, 8.0),
                                     ring(0.0, 15.0, 3.0, reverse=True)])
    esft = RSFT.from_spec("events", "val:Double,*geom:Point")
    n = 4000
    px = np.sort(rng.uniform(-40, 60, n))
    py = rng.uniform(-30, 40, n)
    ds = RDataStore(root)
    ds.create_schema(rsft).write(RFB.from_pydict(
        rsft, {"name": [f"r{i}" for i in range(4)], "geom": polys}))
    ds.create_schema(esft).write(RFB.from_pydict(
        esft, {"val": rng.uniform(0, 10, n), "geom": np.stack([px, py], 1)}))
    return {"ref": RDataStore(root), "port": PDataStore(root, device="cpu")}


SPATIAL = {
    "contains": "SELECT e.val AS val, r.name AS region FROM events e "
                "JOIN regions r ON st_contains(r.geom, e.geom)",
    "within": "SELECT e.val AS val, r.name AS region FROM events e "
              "JOIN regions r ON st_within(e.geom, r.geom)",
    "intersects": "SELECT e.val AS val, r.name AS region FROM regions r "
                  "JOIN events e ON st_intersects(r.geom, e.geom)",
    "left_outer": "SELECT e.val AS val, r.name AS region FROM events e "
                  "LEFT JOIN regions r ON st_contains(r.geom, e.geom)",
    "group_by": "SELECT r.name AS region, COUNT(*) AS n FROM events e "
                "JOIN regions r ON st_contains(r.geom, e.geom) "
                "GROUP BY r.name ORDER BY region",
    "aggregates": "SELECT r.name AS region, COUNT(*) AS n, SUM(e.val) AS s, "
                  "AVG(e.val) AS a, MIN(e.val) AS lo, MAX(e.val) AS hi "
                  "FROM events e JOIN regions r ON st_contains(r.geom, e.geom) "
                  "GROUP BY r.name HAVING COUNT(*) > 100 ORDER BY s DESC LIMIT 2",
    "where_per_side": "SELECT r.name AS region, COUNT(*) AS n FROM events e "
                      "JOIN regions r ON st_contains(r.geom, e.geom) "
                      "WHERE e.val > 5 AND r.name <> 'r0' GROUP BY r.name "
                      "ORDER BY n DESC",
    "distinct": "SELECT DISTINCT r.name AS region FROM events e "
                "JOIN regions r ON st_contains(r.geom, e.geom) ORDER BY region",
    "select_polygons": "SELECT name, geom FROM regions ORDER BY name DESC",
}


@pytest.mark.parametrize("case", sorted(SPATIAL))
def test_spatial_join_equal(spatial, case):
    r, p = run_both(spatial, SPATIAL[case])
    assert p.count > 0


def test_spatial_join_counts_hold_the_hole(spatial):
    """The per-region counts: the point inside region 1's hole is not
    counted, the same as the reference's."""
    r, p = run_both(spatial, SPATIAL["group_by"])
    got = dict(zip(p.features.columns["region"].decode(),
                   np.asarray(p.features.columns["n"]).tolist()))
    assert set(got) == {"r0", "r1", "r2", "r3"} and min(got.values()) > 0


def test_point_point_join_rejected(spatial):
    q = ("SELECT e.val AS v FROM events e "
         "JOIN events f ON st_intersects(e.geom, f.geom)")
    with pytest.raises(RSqlError, match="polygon") as re_:
        RSql(spatial["ref"]).sql(q)
    with pytest.raises(PSqlError, match="polygon") as pe:
        PSql(spatial["port"]).sql(q)
    assert str(pe.value) == str(re_.value)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """gdelt (test_sql_engine_jobs' make_store), a NULL-bearing table, and
    the events / countries / regions of its join tests."""
    root = str(tmp_path_factory.mktemp("torch_sql_tables"))
    ds = RDataStore(root)
    rng = np.random.default_rng(21)
    n = 400
    sft = RSFT.from_spec("gdelt", "actor:String,score:Double,dtg:Date,*geom:Point")
    ds.create_schema(sft).write(RFB.from_pydict(sft, {
        "actor": rng.choice(["USA", "FRA", "CHN"], n).tolist(),
        "score": rng.uniform(-10, 10, n),
        "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
        "geom": np.stack([rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)], 1)}))
    nsft = RSFT.from_spec("t", "actor:String,score:Double,*geom:Point")
    ds.create_schema(nsft).write(RFB.from_pydict(nsft, {
        "actor": ["a", "a", "a", "b", None],
        "score": np.array([1.0, np.nan, 3.0, np.nan, 5.0]),
        "geom": np.random.default_rng(9).uniform(-10, 10, (5, 2))}))
    rng = np.random.default_rng(37)
    ev = RSFT.from_spec("events", "actor:String,score:Double,*geom:Point")
    m = 120
    ds.create_schema(ev).write(RFB.from_pydict(ev, {
        "actor": rng.choice(["USA", "FRA", "CHN", "XXX"], m).tolist(),
        "score": rng.uniform(-10, 10, m),
        "geom": np.stack([rng.uniform(-170, 170, m), rng.uniform(-80, 80, m)], 1)}))
    c = RSFT.from_spec("countries", "code:String,region:String,pop:Double,*geom:Point")
    ds.create_schema(c).write(RFB.from_pydict(c, {
        "code": ["USA", "FRA", "CHN", "GBR"], "region": ["AM", "EU", "AS", "EU"],
        "pop": [331.0, 67.0, 1412.0, 67.2],
        "geom": np.array([[-98.0, 39.0], [2.0, 46.0], [104.0, 35.0], [-2.0, 54.0]])}))
    rg = RSFT.from_spec("regions", "rcode:String,rname:String,*geom:Point")
    ds.create_schema(rg).write(RFB.from_pydict(rg, {
        "rcode": ["AM", "EU"], "rname": ["America", "Europe"],
        "geom": np.array([[-90.0, 40.0], [10.0, 50.0]])}))
    return {"ref": RDataStore(root), "port": PDataStore(root, device="cpu")}


BOX = "POLYGON ((-60 -30, 60 -30, 60 30, -60 30, -60 -30))"
QUERIES = [
    "SELECT actor, score FROM gdelt WHERE "
    "st_intersects(geom, st_makeBBOX(-60, -30, 60, 30)) AND score > 2.5",
    "SELECT COUNT(*) FROM gdelt WHERE actor = 'USA'",
    "SELECT score FROM gdelt WHERE score > 0 ORDER BY score DESC LIMIT 5",
    f"SELECT COUNT(*) FROM gdelt WHERE st_contains(st_geomFromWKT('{BOX}'), geom)",
    f"SELECT COUNT(*) FROM gdelt WHERE st_within(geom, st_geomFromWKT('{BOX}'))",
    "SELECT COUNT(*) FROM gdelt WHERE dtg BETWEEN "
    "'2020-06-01T00:00:00Z' AND '2020-08-01T00:00:00Z'",
    "SELECT * FROM gdelt WHERE st_area(geom) > 2",
    "SELECT * FROM gdelt WHERE st_x(geom) > 0 AND score > 0",
    "SELECT actor FROM gdelt WHERE actor IN ('USA', 'CHN') AND score < 0",
    "SELECT COUNT(*) FROM gdelt WHERE actor LIKE 'U%'",
    "SELECT actor, COUNT(*), SUM(score), MIN(score), MAX(score), "
    "AVG(score) AS mean_score FROM gdelt GROUP BY actor ORDER BY actor",
    "SELECT actor, COUNT(*) AS n FROM gdelt WHERE score > 0 "
    "GROUP BY actor ORDER BY n DESC LIMIT 2",
    "SELECT COUNT(*) AS n, AVG(score) AS m FROM gdelt",
    "SELECT actor, COUNT(*) AS n FROM gdelt WHERE "
    "st_intersects(geom, st_makeBBOX(-100, -60, 100, 60)) GROUP BY actor ORDER BY actor",
    "SELECT actor, COUNT(*) AS n FROM gdelt GROUP BY actor HAVING n > 130",
    "SELECT COUNT(*) FROM gdelt LIMIT 0",
    "SELECT COUNT(*) FROM gdelt WHERE score > 0 LIMIT 5",
    "SELECT DISTINCT actor FROM gdelt ORDER BY actor",
    "SELECT DISTINCT actor FROM gdelt LIMIT 2",
    "SELECT g.score FROM gdelt g WHERE g.score > 0 ORDER BY g.score LIMIT 3",
    "SELECT actor, COUNT(*) AS n, COUNT(score) AS nn, SUM(score) AS s, "
    "MIN(score) AS lo, AVG(score) AS m FROM t GROUP BY actor ORDER BY actor",
    "SELECT COUNT(*) AS n, MIN(score) AS lo, AVG(score) AS m FROM t "
    "WHERE score > 1000000000",
    "SELECT actor FROM t WHERE actor IS NULL",
    "SELECT e.actor, e.score, c.pop FROM events e JOIN countries c "
    "ON e.actor = c.code ORDER BY e.score DESC LIMIT 7",
    "SELECT e.actor, c.region, r.rname FROM events e "
    "JOIN countries c ON e.actor = c.code JOIN regions r ON c.region = r.rcode "
    "ORDER BY e.actor",
    "SELECT e.actor, c.pop FROM events e LEFT JOIN countries c ON e.actor = c.code",
    "SELECT e.actor, c.code FROM events e RIGHT JOIN countries c ON e.actor = c.code",
    "SELECT e.actor, COUNT(c.pop) AS npop, COUNT(*) AS nrows FROM events e "
    "LEFT JOIN countries c ON e.actor = c.code GROUP BY e.actor ORDER BY e.actor",
    "SELECT DISTINCT c.region FROM events e JOIN countries c "
    "ON e.actor = c.code ORDER BY c.region",
    "SELECT e.actor, c.pop FROM events e LEFT JOIN countries c "
    "ON e.actor = c.code WHERE c.pop > 1e9",
    "SELECT c.region, SUM(e.score) AS s FROM events e JOIN countries c "
    "ON e.actor = c.code WHERE e.score > 0 GROUP BY c.region "
    "HAVING SUM(e.score) > 10 ORDER BY s",
    "SELECT st_asText(geom) FROM gdelt LIMIT 1",
]
ERRORS = [
    "SELECT score, COUNT(*) FROM gdelt GROUP BY actor",
    "SELECT SUM(actor) FROM gdelt",
    "SELECT actor FROM gdelt HAVING actor = 'USA'",
    "SELECT * FROM events e JOIN countries c ON e.actor = c.code",
    "SELECT e.actor FROM events e JOIN countries c ON e.actor = e.actor",
]


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_queries_equal(tables, i):
    q = QUERIES[i]
    if "st_asText" in q:  # a select item that is a function: both refuse
        with pytest.raises(RSqlError):
            RSql(tables["ref"]).sql(q)
        with pytest.raises(PSqlError):
            PSql(tables["port"]).sql(q)
        return
    run_both(tables, q)


@pytest.mark.parametrize("i", range(len(ERRORS)))
def test_errors_equal(tables, i):
    with pytest.raises(RSqlError) as re_:
        RSql(tables["ref"]).sql(ERRORS[i])
    with pytest.raises(PSqlError) as pe:
        PSql(tables["port"]).sql(ERRORS[i])
    assert str(pe.value) == str(re_.value)


def test_join_side_size_guard(tables):
    from geomesa_tpu.utils.config import SystemProperties as RProps
    from geomesa_tpu_torch.utils.config import SystemProperties as PProps

    q = ("SELECT g.actor AS a, e.score AS s FROM gdelt g "
         "JOIN events e ON g.actor = e.actor")
    key = "geomesa.sql.join.max.rows"
    from geomesa_tpu.utils import config as rcfg
    from geomesa_tpu_torch.utils import config as pcfg

    assert PProps.SQL_JOIN_MAX_ROWS.name == RProps.SQL_JOIN_MAX_ROWS.name == key
    rcfg._overrides[key] = 100
    pcfg._overrides[key] = 100
    try:
        with pytest.raises(RSqlError, match="max.rows") as re_:
            RSql(tables["ref"]).sql(q)
        with pytest.raises(PSqlError, match="max.rows") as pe:
            PSql(tables["port"]).sql(q)
        assert str(pe.value) == str(re_.value)
    finally:
        rcfg._overrides.pop(key, None)
        pcfg._overrides.pop(key, None)
    run_both(tables, q)


CONFIG2_POLYS = 200
CONFIG2_POINTS = 1 << 14


@pytest.fixture(scope="module")
def config2(tmp_path_factory):
    """Config 2 at a small size: the bench's layer shape, Morton points."""
    import torch

    rng = np.random.default_rng(29)
    layer = chip_smoke.gen_admin_layer(rng, CONFIG2_POLYS)
    px, py, _ = chip_smoke.layer_points(torch, torch.device("cpu"), rng,
                                        CONFIG2_POINTS, layer)
    root = str(tmp_path_factory.mktemp("torch_sql_config2"))
    ds = RDataStore(root)
    rs = RSFT.from_spec("regions", "name:String,*geom:Polygon")
    ds.create_schema(rs).write(RFB.from_pydict(rs, {
        "name": [f"region-{i:05d}" for i in range(CONFIG2_POLYS)],
        "geom": [RGeometry("Polygon", rings) for rings in layer[6]]}))
    es = RSFT.from_spec("events", "eid:Integer,val:Double,dtg:Date,*geom:Point")
    n = len(px)
    ds.create_schema(es).write(RFB.from_pydict(es, {
        "eid": np.arange(n, dtype=np.int32), "val": rng.uniform(0, 10, n),
        "dtg": 1_600_000_000_000 + rng.integers(0, 86400_000, n),  # one day
        "geom": np.stack([px, py], 1)}))
    return {"ref": RDataStore(root), "port": PDataStore(root, device="cpu"),
            "layer": layer, "px": px, "py": py}


def test_config2_join_as_users_write_it(config2):
    q = ("SELECT r.name AS region, COUNT(*) AS n FROM events e "
         "JOIN regions r ON st_contains(r.geom, e.geom) "
         "GROUP BY r.name ORDER BY region")
    r, p = run_both(config2, q)
    pairs = ("SELECT r.name AS region, e.eid AS eid FROM events e "
             "JOIN regions r ON st_contains(r.geom, e.geom)")
    pp = PSql(config2["port"]).sql(pairs)
    got = collections.Counter(zip(pp.features.columns["region"].decode(),
                                  np.asarray(pp.features.columns["eid"]).tolist()))
    assert max(got.values()) == 1
    # the reference engine's pip_layer_join on the written arrays (eid is
    # the row of px, py)
    x1, y1, x2, y2, pol = config2["layer"][:5]
    rows, polys = ref_ps.pip_layer_join(config2["px"], config2["py"], x1, y1,
                                        x2, y2, pol, interpret=True)
    direct = collections.Counter(zip((f"region-{int(k):05d}" for k in polys),
                                     rows.tolist()))
    assert got == direct
    counts = dict(zip(p.features.columns["region"].decode(),
                      np.asarray(p.features.columns["n"]).tolist()))
    assert sum(counts.values()) == len(rows) > 0
