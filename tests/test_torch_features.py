"""End to end: feature results of `get_features` and the exact count, in
the port against the reference on one shared catalog (written by the
reference), on the cached route (device cache on) and the scan route
(cache off).

The store: 6,000 rows over three monthly partitions (2,000 rows each,
padded to 2,048 when resident), a String column with nulls and fids.
A third of the points lie 2e-6 to 8e-5 degrees off a star polygon's
edges, inside the f32 ambiguity band, so `refine` re-decides them in
f64; every other point lies at least 2.5e-4 degrees off the edges, where
the band flags nothing in either package (its edge sits at 1e-4 to
1.5e-4). So both packages re-test the same rows, and the counts of rows
re-tested can be held equal.

Rows, fids, sort order, projection and limits are identical; matches
are also held to an f64 NumPy evaluation of the written rows.
"""

import dataclasses

import numpy as np
import pytest

from geomesa_tpu.core.columnar import DictColumn as RDict
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.store.partition import DateTimeScheme as RScheme
from geomesa_tpu_torch.core.columnar import DictColumn as PDict
from geomesa_tpu_torch.plan import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.query import Query as PQuery

from test_torch_pip import edges_of, star_polygon_wkt

SPEC = "name:String,speed:Double,n:Integer,dtg:Date,*geom:Point"
JAN, FEB, MAR, APR = (1_451_606_400_000, 1_454_284_800_000,
                      1_456_790_400_000, 1_459_468_800_000)
NAMES = ["delta", "alpha", "echo", "bravo", "charlie", "zulu", "kilo"]
POLY = star_polygon_wkt(seed=5, n_shell=200, n_hole=30, cx=0.05, cy=0.0,
                        rx=0.6, ry=0.5)
# an edge 1e-7 degrees left of the origin, where a padded row lies: the
# origin is inside the polygon and inside its f32 band
PAD_POLY = "POLYGON((-1e-7 -1, 1 -1, 1 1, -1e-7 1, -1e-7 -1))"


def iso(ms):
    return str(np.datetime64(ms, "ms")) + "Z"


FEB_WINDOW = f"dtg > {iso(FEB + 3600_000)} AND dtg < {iso(MAR - 3600_000)}"
BBOX_TIME = (f"BBOX(geom, -0.5, -0.4, 0.55, 0.6) AND dtg > {iso(JAN + 86400_000)} "
             f"AND dtg < {iso(MAR + 10 * 86400_000)} AND speed > 5.0")
POLY_TIME = f"INTERSECTS(geom, {POLY}) AND {FEB_WINDOW}"


def _seg_dist(px, py, x1, y1, x2, y2, chunk=2048):
    """f64 distance from each point to its nearest edge."""
    out = []
    dx, dy = (x2 - x1)[None], (y2 - y1)[None]
    for s in range(0, len(px), chunk):
        qx, qy = px[s:s + chunk, None], py[s:s + chunk, None]
        t = np.clip(((qx - x1[None]) * dx + (qy - y1[None]) * dy)
                    / np.maximum(dx * dx + dy * dy, 1e-300), 0, 1)
        out.append(np.hypot(x1[None] + t * dx - qx, y1[None] + t * dy - qy).min(1))
    return np.concatenate(out)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_features"))
    rng = np.random.default_rng(17)
    m = 9000
    x = rng.uniform(-1, 1, m)
    y = rng.uniform(-1, 1, m)
    x1, y1, x2, y2 = edges_of(POLY)
    k = m // 3
    e = rng.integers(0, len(x1), k)
    s = rng.uniform(0.05, 0.95, k)
    nx, ny = y2[e] - y1[e], -(x2[e] - x1[e])
    norm = np.hypot(nx, ny)
    off = rng.choice([-1, 1], k) * rng.uniform(2e-6, 8e-5, k)
    x[:k] = x1[e] + s * (x2[e] - x1[e]) + off * nx / norm
    y[:k] = y1[e] + s * (y2[e] - y1[e]) + off * ny / norm
    d = _seg_dist(x, y, x1, y1, x2, y2)
    keep = ((d >= 2e-6) & (d <= 8e-5)) | (d >= 2.5e-4)
    x, y = x[keep][:6000], y[keep][:6000]
    n = len(x)
    assert n == 6000
    o = rng.permutation(n)
    x, y = x[o], y[o]
    t = np.concatenate([rng.integers(a, b, n // 3)
                        for a, b in ((JAN, FEB), (FEB, MAR), (MAR, APR))])
    speed = np.round(rng.uniform(0, 30, n), 1)  # ties for the sort
    cnt = rng.integers(0, 50, n).astype(np.int32)
    codes = rng.integers(-1, len(NAMES), n)  # -1: null
    names = [NAMES[c] if c >= 0 else None for c in codes]
    fids = [f"f{i:05d}" for i in range(n)]
    ref_ds = RDataStore(root, use_device_cache=True)
    src = ref_ds.create_schema(RSFT.from_spec("ais", SPEC),
                               scheme=RScheme("yyyy/MM", "dtg"))
    src.write(RFB.from_pydict(src.sft, {
        "name": names, "speed": speed, "n": cnt, "dtg": t,
        "geom": np.stack([x, y], 1)}, fids=fids))
    return dict(
        x=x, y=y, t=t, speed=speed, names=np.array(names, dtype=object),
        fids=np.array(fids),
        ref={"cached": ref_ds.get_feature_source("ais"),
             "scan": RDataStore(root).get_feature_source("ais")},
        port={"cached": PDataStore(root, use_device_cache=True, device="cpu")
              .get_feature_source("ais"),
              "scan": PDataStore(root, device="cpu").get_feature_source("ais")})


ROUTES = ["cached", "scan"]


def _decode(col):
    return (list(col.decode()) if isinstance(col, (RDict, PDict))
            else None)


def assert_same_features(p, r):
    """Kind, count, fids (in order), schema and every column identical."""
    assert p.kind == r.kind == "features"
    assert p.count == r.count
    if r.features is None:
        assert p.features is None
        return
    pf, rf = p.features, r.features
    assert len(pf) == len(rf) == p.count
    assert pf.sft.attribute_names == rf.sft.attribute_names
    assert _decode(pf.fids) == _decode(rf.fids)
    for name in rf.sft.attribute_names:
        pc, rc = pf.columns[name], rf.columns[name]
        if isinstance(rc, RDict):
            assert _decode(pc) == _decode(rc), name
        elif hasattr(rc, "x"):
            np.testing.assert_array_equal(pc.x, rc.x)
            np.testing.assert_array_equal(pc.y, rc.y)
        else:
            assert pc.dtype == rc.dtype, name
            np.testing.assert_array_equal(pc, rc)


def run(stores, route, cql, **kw):
    hints = kw.pop("hints", {})
    r = stores["ref"][route].get_features(RQuery("ais", cql, hints=RHints(**hints), **kw))
    p = stores["port"][route].get_features(PQuery("ais", cql, hints=PHints(**hints), **kw))
    return p, r


def f64_inside(s, wkt):
    from geomesa_tpu_torch.core.wkt import parse_wkt
    from geomesa_tpu_torch.engine.pip import points_in_polygon_np

    return points_in_polygon_np(s["x"], s["y"], parse_wkt(wkt))


@pytest.mark.parametrize("route", ROUTES)
def test_bbox_time_attribute_rows(stores, route):
    p, r = run(stores, route, BBOX_TIME)
    assert_same_features(p, r)
    s = stores
    exp = ((s["x"] >= -0.5) & (s["x"] <= 0.55) & (s["y"] >= -0.4) & (s["y"] <= 0.6)
           & (s["t"] > JAN + 86400_000) & (s["t"] < MAR + 10 * 86400_000)
           & (s["speed"] > 5.0))
    assert sorted(_decode(p.features.fids)) == sorted(s["fids"][exp].tolist())
    assert p.count > 500


@pytest.mark.parametrize("route", ROUTES)
def test_polygon_band_rows_refined(stores, route):
    from geomesa_tpu_torch.core.wkt import parse_wkt
    from geomesa_tpu_torch.engine.pip import polygon_edges

    p, r = run(stores, route, POLY_TIME)
    assert_same_features(p, r)
    s = stores
    tm = (s["t"] > FEB + 3600_000) & (s["t"] < MAR - 3600_000)
    exp = f64_inside(s, POLY) & tm
    assert sorted(_decode(p.features.fids)) == sorted(s["fids"][exp].tolist())
    # non-vacuous: matching rows inside the band, re-decided in f64
    near = _seg_dist(s["x"], s["y"], *polygon_edges(parse_wkt(POLY))) < 1e-4
    assert (exp & near).sum() > 100


SORTS = {
    "speed_asc": [("speed", True)],
    "speed_desc": [("speed", False)],
    "name_asc": [("name", True)],
    "name_desc": [("name", False)],
    "name_then_dtg_desc": [("name", True), ("dtg", False)],
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("key", sorted(SORTS))
def test_sort_by(stores, route, key):
    p, r = run(stores, route, POLY_TIME, sort_by=SORTS[key])
    assert_same_features(p, r)
    attr, asc = SORTS[key][0]
    col = p.features.columns[attr]
    if attr == "name":
        vals = _decode(col)
        nulls = [v is None for v in vals]
        text = [v for v in vals if v is not None]
        # nulls first ascending, last descending; text in order
        assert nulls == sorted(nulls, reverse=asc)
        assert text == sorted(text, reverse=not asc)
        assert any(nulls) and len(set(text)) == len(NAMES)
    else:
        assert np.all(np.diff(col) >= 0) if asc else np.all(np.diff(col) <= 0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("attrs", [["speed", "geom"], ["name"], ["dtg", "n", "name"]],
                         ids=["speed_geom", "name", "dtg_n_name"])
def test_projection(stores, route, attrs):
    p, r = run(stores, route, BBOX_TIME, attributes=attrs,
               sort_by=[("speed", False)])
    assert_same_features(p, r)
    assert p.features.sft.attribute_names == attrs


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("sort", [None, [("dtg", False)]], ids=["unsorted", "dtg_desc"])
def test_max_features(stores, route, sort):
    p, r = run(stores, route, POLY_TIME, sort_by=sort, max_features=37)
    assert_same_features(p, r)
    assert p.count == 37
    full, _ = run(stores, route, POLY_TIME, sort_by=sort)
    assert _decode(p.features.fids) == _decode(full.features.fids)[:37]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("by", [None, "name"], ids=["global", "by_name"])
def test_sampling(stores, route, by):
    hints = dict(sampling=3, sample_by=by)
    p, r = run(stores, route, BBOX_TIME, hints=hints)
    assert_same_features(p, r)
    full, _ = run(stores, route, BBOX_TIME)
    assert 0 < p.count < full.count
    assert set(_decode(p.features.fids)) <= set(_decode(full.features.fids))


@pytest.mark.parametrize("route", ROUTES)
def test_loose_bbox(stores, route):
    # the covering pushdown result is accepted for the bbox; the other
    # terms stay exact
    p, r = run(stores, route, BBOX_TIME, hints=dict(loose_bbox=True))
    assert_same_features(p, r)
    strict, _ = run(stores, route, BBOX_TIME)
    assert p.count >= strict.count
    assert (p.features.columns["speed"] > 5.0).all()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["no_partition", "no_match"])
def test_empty_result_kind(stores, route, case):
    cql = (f"dtg > {iso(APR + 86400_000)}" if case == "no_partition"
           else f"speed > 1000.0 AND {FEB_WINDOW}")
    p, r = run(stores, route, cql)
    assert p.kind == r.kind == "features"
    assert p.count == r.count == 0
    assert (p.features is None) == (r.features is None)
    if p.features is not None:
        assert len(p.features) == len(r.features) == 0


@pytest.mark.parametrize("route", ROUTES)
def test_pad_row_in_band_is_not_returned(stores, route):
    import torch

    from geomesa_tpu_torch.core.wkt import parse_wkt
    from geomesa_tpu_torch.engine.pip import points_in_polygon_band, polygon_edges

    # pad rows lie at the origin: inside PAD_POLY and inside its band,
    # so a refine that ignored row validity would bring them back
    e = [torch.from_numpy(a) for a in polygon_edges(parse_wkt(PAD_POLY))]
    o = torch.zeros(1, dtype=torch.float64)
    assert bool(points_in_polygon_band(o, o, *e)[0])
    assert f64_inside(dict(x=np.zeros(1), y=np.zeros(1)), PAD_POLY)[0]
    cql = f"INTERSECTS(geom, {PAD_POLY})"
    p, r = run(stores, route, cql)
    assert_same_features(p, r)
    exp = f64_inside(stores, PAD_POLY)
    assert p.count == int(exp.sum())
    assert sorted(_decode(p.features.fids)) == sorted(stores["fids"][exp].tolist())
    assert stores["port"][route].get_count(cql) == int(exp.sum())


@pytest.mark.parametrize("route", ROUTES)
def test_count_retests_only_the_query_partitions(stores, route, monkeypatch):
    import geomesa_tpu.cql.hosteval as r_hosteval
    import geomesa_tpu_torch.cql.compile as p_compile

    s = stores
    # all three months resident first
    assert s["port"][route].get_count("INCLUDE") == s["ref"][route].get_count("INCLUDE")
    seen = {"ref": 0, "port": 0}

    def counting(pkg, fn):
        def wrapped(f, batch):
            seen[pkg] += len(batch)
            return fn(f, batch)
        return wrapped

    monkeypatch.setattr(r_hosteval, "eval_filter_host",
                        counting("ref", r_hosteval.eval_filter_host))
    monkeypatch.setattr(p_compile, "eval_filter_host",
                        counting("port", p_compile.eval_filter_host))
    got = s["port"][route].get_count(POLY_TIME)
    exp = s["ref"][route].get_count(POLY_TIME)
    tm = (s["t"] > FEB + 3600_000) & (s["t"] < MAR - 3600_000)
    assert got == exp == int((f64_inside(s, POLY) & tm).sum())
    # the band rows of February's partition only (the scan route reads
    # just the window's rows of it), each re-tested in f64 once
    from geomesa_tpu_torch.core.wkt import parse_wkt
    from geomesa_tpu_torch.engine.pip import polygon_edges
    near = _seg_dist(s["x"], s["y"], *polygon_edges(parse_wkt(POLY))) < 1e-4
    feb = (s["t"] >= FEB) & (s["t"] < MAR)
    assert seen["port"] == seen["ref"] > 0
    assert int((near & tm).sum()) <= seen["port"] <= int((near & feb).sum())
    if route == "cached":
        assert seen["port"] == int((near & feb).sum())


@pytest.mark.parametrize("route", ROUTES)
def test_count_matches_reference(stores, route):
    s = stores
    for cql, limit in [(BBOX_TIME, None), (POLY_TIME, None), (POLY_TIME, 10),
                       (f"name = 'zulu' AND {FEB_WINDOW}", None),
                       (f"name IS NULL", None)]:
        rq = RQuery("ais", cql, max_features=limit)
        pq = PQuery("ais", cql, max_features=limit)
        assert s["port"][route].get_count(pq) == s["ref"][route].get_count(rq)
    rq = RQuery("ais", "INCLUDE", hints=RHints(exact_count=False), max_features=100)
    pq = PQuery("ais", "INCLUDE", hints=PHints(exact_count=False), max_features=100)
    assert s["port"][route].get_count(pq) == s["ref"][route].get_count(rq) == 100


def test_reference_catalog_read_whole(stores):
    # every row of the reference's catalog, through the port's feature
    # route, fid for fid with the written values
    s = stores
    p, r = run(stores, "scan", "INCLUDE", sort_by=[("speed", True), ("dtg", True)])
    assert_same_features(p, r)
    order = np.lexsort((s["t"], s["speed"]))
    assert _decode(p.features.fids) == s["fids"][order].tolist()
    np.testing.assert_array_equal(p.features.columns["geom"].x, s["x"][order])
    assert _decode(p.features.columns["name"]) == s["names"][order].tolist()


def test_count_only_hint_is_internal(stores):
    # count_only on execute gives kind count on the cached route, as in
    # the reference
    q = PQuery("ais", POLY_TIME)
    q = dataclasses.replace(q, hints=dataclasses.replace(q.hints, count_only=True))
    rq = RQuery("ais", POLY_TIME, hints=RHints(count_only=True))
    p = stores["port"]["cached"].planner.execute(q)
    r = stores["ref"]["cached"].planner.execute(rq)
    assert p.kind == r.kind == "count" and p.count == r.count > 0


def test_band_corrections_within_extra(stores):
    # band_corrections with an allowance re-tests only the allowed rows:
    # the rows of the unrestricted call that the allowance keeps
    import torch

    src = stores["port"]["cached"]
    src.get_count("INCLUDE")  # every month resident
    planner = src.planner
    plan = planner.plan(PQuery("ais", POLY_TIME))
    sb, allowed = planner._resident(plan)
    extra = torch.from_numpy(allowed)[sb.pids]
    idx_all, ex_all = plan.compiled.band_corrections(sb.dev, sb.batch)
    idx, ex = plan.compiled.band_corrections(sb.dev, sb.batch, extra=extra)
    keep = extra.numpy()[idx_all]
    np.testing.assert_array_equal(idx, idx_all[keep])
    np.testing.assert_array_equal(ex, ex_all[keep])
    assert 0 < len(idx) < len(idx_all)
