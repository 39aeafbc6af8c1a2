"""End to end: density through `get_features` and `DensityProcess`, and the
polygon count, in the port against the reference on one shared catalog
(written by the reference), on the cached route (device cache on) and
the scan route (cache off).

The store: 3 months of taxi-like pickups over the NYC envelope in Z2
order, monthly partitions padded to 8192 rows (6 data tiles resident),
so interpret-mode Pallas stays cheap. Points sit at least 1e-3 of a cell
from every edge of the 64x64 grid (the two packages' binning divides
differently only there: ROADMAP Queue C) and at least 1.5e-5 degrees from
the polygon's edges: the cached route grids the raw device mask, which
the reference computes against f64 edges on the CPU and the port in
f32, as the reference's own kernel does on its chip. Many points still
lie inside the 1e-4 degree band, so the counts exercise the f64 refine.

Unit-weight grids and counts are bit-identical; weighted grids agree
within the reference bench's per-cell bound (test_torch_density).
"""

import numpy as np
import pytest

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.process.density import DensityProcess as RDensityProcess
from geomesa_tpu.store.partition import DateTimeScheme as RScheme
from geomesa_tpu_torch.plan import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.plan.runner import query_mask_token
from geomesa_tpu_torch.process import DensityProcess as PDensityProcess

from test_torch_density import _morton, _off_edges, assert_weighted_close
from test_torch_pip import edges_of, star_polygon_wkt
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

SPEC = "fare:Double,dtg:Date,*geom:Point"
ENV = (-74.3, 40.5, -73.7, 41.0)
W = H = 64
JAN, FEB, APR = 1_451_606_400_000, 1_454_284_800_000, 1_459_468_800_000
POLY = star_polygon_wkt(seed=8, n_shell=300, n_hole=40, rx=0.22, ry=0.18)


def iso(ms):
    return str(np.datetime64(ms, "ms")) + "Z"


TIME = f"dtg > {iso(JAN + 3600_000)} AND dtg < {iso(FEB + 20 * 86400_000)}"
FILTERS = {
    "bbox_time": f"BBOX(geom, -74.2, 40.55, -73.8, 40.95) AND {TIME}",
    "polygon_time": f"INTERSECTS(geom, {POLY}) AND {TIME}",
    "disjoint": f"DISJOINT(geom, {POLY}) AND fare > 1.0",
}


def _seg_dist(px, py, x1, y1, x2, y2):
    """f64 distance from each point to its nearest edge."""
    dx, dy = (x2 - x1)[None], (y2 - y1)[None]
    t = ((px[:, None] - x1[None]) * dx + (py[:, None] - y1[None]) * dy)
    t = np.clip(t / np.maximum(dx * dx + dy * dy, 1e-300), 0, 1)
    return np.hypot(x1[None] + t * dx - px[:, None],
                    y1[None] + t * dy - py[:, None]).min(1)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_density_ds"))
    rng = np.random.default_rng(31)
    n = 18000
    x = rng.uniform(ENV[0], ENV[2], n)
    y = rng.uniform(ENV[1], ENV[3], n)
    # a third of the points 2e-5 .. 8e-5 degrees off the polygon's edges
    x1, y1, x2, y2 = edges_of(POLY)
    k = n // 3
    e = rng.integers(0, len(x1), k)
    t = rng.uniform(0.1, 0.9, k)
    nx, ny = y2[e] - y1[e], -(x2[e] - x1[e])
    norm = np.hypot(nx, ny)
    off = rng.choice([-1, 1], k) * rng.uniform(2e-5, 8e-5, k)
    x[:k] = x1[e] + t * (x2[e] - x1[e]) + off * nx / norm
    y[:k] = y1[e] + t * (y2[e] - y1[e]) + off * ny / norm
    x = _off_edges(x, ENV[0], (ENV[2] - ENV[0]) / W).astype(np.float64)
    y = _off_edges(y, ENV[1], (ENV[3] - ENV[1]) / H).astype(np.float64)
    keep = _seg_dist(x, y, x1, y1, x2, y2) >= 1.5e-5
    x, y = x[keep], y[keep]
    o = np.argsort(_morton(x, y), kind="stable")
    x, y = x[o], y[o]
    n = len(x)
    t = rng.integers(JAN, APR, n)
    fare = rng.uniform(0, 5, n)
    ref_ds = RDataStore(root, use_device_cache=True)
    src = ref_ds.create_schema(RSFT.from_spec("taxi", SPEC),
                               scheme=RScheme("yyyy/MM", "dtg"))
    src.write(RFB.from_pydict(src.sft, {"fare": fare, "dtg": t,
                                        "geom": np.stack([x, y], 1)}))
    return dict(
        root=root, x=x, y=y, t=t, fare=fare,
        ref={"cached": ref_ds.get_feature_source("taxi"),
             "scan": RDataStore(root).get_feature_source("taxi")},
        port={"cached": PDataStore(root, use_device_cache=True, device="cpu")
              .get_feature_source("taxi"),
              "scan": PDataStore(root, device="cpu").get_feature_source("taxi")})


def _queries(cql, weight=None, zsparse=None):
    kw = dict(density_bbox=ENV, density_width=W, density_height=H,
              density_weight=weight, density_zsparse=zsparse)
    return (RQuery("taxi", cql, hints=RHints(**kw)),
            PQuery("taxi", cql, hints=PHints(**kw)))


@pytest.mark.parametrize("route", ["cached", "scan"])
@pytest.mark.parametrize("weight", [None, "fare"], ids=["counts", "fare"])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_density_matches_reference(stores, route, weight, name):
    rq, pq = _queries(FILTERS[name], weight)
    r = stores["ref"][route].get_features(rq)
    p = stores["port"][route].get_features(pq)
    assert p.kind == r.kind == "density"
    assert p.grid.shape == (H, W) and p.grid.dtype == np.float32
    assert p.count == r.count > 0
    if weight is None:
        np.testing.assert_array_equal(p.grid, r.grid)
        assert p.grid.sum() > 0
    else:
        rc = stores["ref"][route].get_features(_queries(FILTERS[name])[0])
        assert_weighted_close(p.grid, r.grid, rc.grid)


@pytest.mark.parametrize("route", ["cached", "scan"])
def test_density_process_matches_reference(stores, route):
    for cql, weight, radius in [(FILTERS["polygon_time"], None, 2),
                                (FILTERS["bbox_time"], "fare", 0)]:
        r = RDensityProcess().execute(stores["ref"][route], ENV, W, H, cql,
                                      weight_attr=weight, radius_pixels=radius)
        p = PDensityProcess().execute(stores["port"][route], ENV, W, H, cql,
                                      weight_attr=weight, radius_pixels=radius)
        assert p.shape == r.shape == (H, W)
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("route", ["cached", "scan"])
def test_polygon_count_matches_reference_and_f64(stores, route):
    from geomesa_tpu_torch.engine.pip import points_in_polygon_np
    from geomesa_tpu_torch.core.wkt import parse_wkt

    s = stores
    inside = points_in_polygon_np(s["x"], s["y"], parse_wkt(POLY))
    tm = (s["t"] > JAN + 3600_000) & (s["t"] < FEB + 20 * 86400_000)
    for name, exp in [("polygon_time", inside & tm),
                      ("disjoint", ~inside & (s["fare"] > 1.0))]:
        got = s["port"][route].get_count(FILTERS[name])
        assert got == s["ref"][route].get_count(FILTERS[name]) == int(exp.sum())


def test_scatter_route_equals_zsparse(stores):
    src = stores["port"]["cached"]
    for name in FILTERS:
        z = src.get_features(_queries(FILTERS[name], zsparse=True)[1]).grid
        sc = src.get_features(_queries(FILTERS[name], zsparse=False)[1]).grid
        np.testing.assert_array_equal(z, sc)


def test_calibration_is_cached_per_filter(stores):
    src = stores["port"]["cached"]
    q = _queries(FILTERS["polygon_time"])[1]
    first = src.get_features(q).grid
    entries = dict(src.planner._zcalib._entries)
    again = src.get_features(q).grid
    np.testing.assert_array_equal(first, again)
    assert dict(src.planner._zcalib._entries).keys() == entries.keys()
    token = query_mask_token(q)
    # keyed on the query's mask token, then the partitions
    assert any(k[-1][:len(token)] == token for k in entries)


def test_empty_window_matches_reference(stores):
    cql = f"dtg > {iso(APR + 86400_000)}"
    for route in ("cached", "scan"):
        rq, pq = _queries(cql)
        r = stores["ref"][route].get_features(rq)
        p = stores["port"][route].get_features(pq)
        assert p.count == r.count == 0
        np.testing.assert_array_equal(p.grid, r.grid)
        assert p.grid.shape == (H, W)


def test_execute_without_density_raises_typed(stores):
    # the feature route is ported: a query without a density hint now
    # returns kind "features", row for row the reference's, on both routes
    for route in ("cached", "scan"):
        r = stores["ref"][route].get_features(RQuery("taxi", "fare > 1.0"))
        p = stores["port"][route].get_features(PQuery("taxi", "fare > 1.0"))
        assert p.kind == r.kind == "features"
        assert (p.count == r.count == len(p.features)
                == int((stores["fare"] > 1.0).sum()))
        for name in ("fare", "dtg"):
            np.testing.assert_array_equal(p.features.columns[name],
                                          r.features.columns[name])
        np.testing.assert_array_equal(p.features.columns["geom"].x,
                                      r.features.columns["geom"].x)


def test_exact_weights_pin_the_scatter_path(stores, monkeypatch):
    # density_exact_weights with a weight column keeps the f32 scatter
    # path even when the dictionary kernel is forced, as in the reference
    import geomesa_tpu_torch.plan.runner as runner

    src = stores["port"]["cached"]
    cql = FILTERS["bbox_time"]
    exp = src.get_features(_queries(cql, "fare", zsparse=False)[1]).grid

    def refuse(*args, **kwargs):
        raise AssertionError("the dictionary route ran under the pin")

    monkeypatch.setattr(runner, "_zsparse_grid", refuse)
    for zs in (None, True):
        _, pq = _queries(cql, "fare", zsparse=zs)
        pq.hints.density_exact_weights = True
        np.testing.assert_array_equal(src.get_features(pq).grid, exp)
