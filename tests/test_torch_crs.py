"""Output reprojection on the port (`geomesa_tpu_torch.core.crs`, the
runner's finish step and `st_transform`) against the reference's, after
tests/test_crs.py.

Both packages' `transform` run on the same seeded inputs for every
registered frame pair the reference tests (web mercator with its latitude
clamp, UTM north and south with the zone rule, polar stereographic, LAEA
Europe and the routes between families): the outputs are bit-identical.
So are `reproject_batch` over point and polygon batches, the features of
a query with `crs` (port on the CPU, reference on its own store over the
same catalog) and `st_transform` through `SqlContext`.
"""

import numpy as np
import pytest

from geomesa_tpu.core import crs as rcrs
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.core.wkt import Geometry as RGeometry
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.sql.engine import SqlContext as RSql
from geomesa_tpu_torch.core import crs as pcrs
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.core.wkt import Geometry as PGeometry
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.sql import SqlContext as PSql
from geomesa_tpu_torch.sql.functions import st_transform

# (from, to, lon range, lat range): inputs are drawn in 4326 and moved
# into `from` with the reference's transform first
ROUTES = [
    (4326, 3857, (-179, 179), (-89.9, 89.9)),   # past the clamp
    (3857, 4326, (-179, 179), (-84, 84)),
    (4326, 32633, (9, 21), (0, 84)),
    (32633, 4326, (9, 21), (0, 84)),
    (4326, 32756, (147, 153), (-80, 0)),
    (32756, 4326, (147, 153), (-80, 0)),
    (32633, 32634, (14, 20), (40, 70)),
    (32633, 3857, (9, 21), (10, 70)),
    (4326, 3413, (-179, 179), (60, 90)),
    (3413, 4326, (-179, 179), (60, 89)),
    (4326, 3031, (-179, 179), (-90, -60)),
    (3976, 4326, (-179, 179), (-89, -60)),
    (4326, 3035, (-10, 40), (35, 70)),
    (3035, 4326, (-10, 40), (35, 70)),
    (3035, 3413, (-10, 40), (60, 70)),
]


@pytest.mark.parametrize("src, dst, lons, lats", ROUTES,
                         ids=[f"{a}-{b}" for a, b, _, _ in ROUTES])
def test_transform_bit_identical(src, dst, lons, lats):
    rng = np.random.default_rng(src % 97 + dst % 89)
    lon, lat = rng.uniform(*lons, 400), rng.uniform(*lats, 400)
    x, y = rcrs.transform(lon, lat, 4326, src)
    got = pcrs.transform(x, y, src, dst)
    want = rcrs.transform(x, y, src, dst)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert pcrs.supported(src, dst) and rcrs.supported(src, dst)


def test_constants_zone_rule_and_refusals():
    assert pcrs.R_MAJOR == rcrs.R_MAJOR and pcrs._MAX_LAT == rcrs._MAX_LAT
    rng = np.random.default_rng(0)
    for lon, lat in zip(rng.uniform(-180, 180, 300), rng.uniform(-85, 85, 300)):
        assert pcrs.utm_zone_srid(lon, lat) == rcrs.utm_zone_srid(lon, lat)
    for lon, lat in ((15.0, 48.0), (151.2, -33.9), (-179.9, 10.0),
                     (179.9, -10.0), (-180.0, 0.0), (180.0, 0.0)):
        assert pcrs.utm_zone_srid(lon, lat) == rcrs.utm_zone_srid(lon, lat)
    x, y = pcrs.transform([1.0], [2.0], 4326, 4326)
    assert x[0] == 1.0 and y[0] == 2.0
    for pair in ((4326, 2154), (9999, 4326), (32661, 4326)):
        with pytest.raises(ValueError):
            rcrs.transform([0.0], [0.0], *pair)
        with pytest.raises(ValueError):
            pcrs.transform([0.0], [0.0], *pair)


def test_reproject_batch_bit_identical():
    rng = np.random.default_rng(7)
    n = 200
    pts = np.stack([rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)], 1)
    sq = np.array([[0, 0], [10, 0], [10, 10], [0, 10], [0, 0]], float)
    for spec, data in (("v:Double,*geom:Point",
                        {"v": rng.uniform(0, 1, n), "geom": pts}),
                       ("*geom:Polygon", None)):
        for to in (3857, 32633, 3035):
            if data is None:
                r = rcrs.reproject_batch(RFB.from_pydict(
                    RSFT.from_spec("p", spec),
                    {"geom": [RGeometry("Polygon", [sq])]}), to)
                p = pcrs.reproject_batch(PFB.from_pydict(
                    PSFT.from_spec("p", spec),
                    {"geom": [PGeometry("Polygon", [sq])]}), to)
                np.testing.assert_array_equal(p.columns["geom"].vertices,
                                              r.columns["geom"].vertices)
                np.testing.assert_array_equal(p.columns["geom"].bbox,
                                              r.columns["geom"].bbox)
            else:
                r = rcrs.reproject_batch(
                    RFB.from_pydict(RSFT.from_spec("p", spec), data), to)
                p = pcrs.reproject_batch(
                    PFB.from_pydict(PSFT.from_spec("p", spec), data), to)
            np.testing.assert_array_equal(p.columns["geom"].x,
                                          r.columns["geom"].x)
            np.testing.assert_array_equal(p.columns["geom"].y,
                                          r.columns["geom"].y)
            assert p.sft.attribute("geom").options["srid"] == str(to)
    same = PFB.from_pydict(PSFT.from_spec("p", "*geom:Point"),
                           {"geom": pts[:3]})
    assert pcrs.reproject_batch(same, 4326) is same


def test_query_crs_features_equal_reference(tmp_path):
    rng = np.random.default_rng(7)
    n = 500
    rows = {"v": rng.uniform(0, 1, n),
            "dtg": rng.integers(1_600_000_000_000, 1_600_300_000_000, n),
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}
    root = str(tmp_path / "c")
    sft = RSFT.from_spec("t", "v:Double,dtg:Date,*geom:Point")
    RDataStore(root).create_schema(sft).write(RFB.from_pydict(sft, rows))
    rsrc = RDataStore(root).get_feature_source("t")
    psrc = PDataStore(root, use_device_cache=True,
                      device="cpu").get_feature_source("t")
    cql = "BBOX(geom, -60, -30, 60, 30)"
    for to in (3857, pcrs.utm_zone_srid(10.0, 45.0)):
        kw = dict(crs=to, sort_by=[("v", True)], attributes=["v", "geom"])
        r = rsrc.get_features(RQuery("t", cql, **kw)).features
        p = psrc.get_features(PQuery("t", cql, **kw)).features
        np.testing.assert_array_equal(p.columns["geom"].x, r.columns["geom"].x)
        np.testing.assert_array_equal(p.columns["geom"].y, r.columns["geom"].y)
        assert p.sft.attribute("geom").options["srid"] == str(to)
    # the closed-form spherical mercator on the selected rows
    p = psrc.get_features(PQuery("t", cql, crs=3857)).features
    x, y = rows["geom"][:, 0], rows["geom"][:, 1]
    sel = (x >= -60) & (x <= 60) & (y >= -30) & (y <= 30)
    ex = np.radians(x[sel]) * pcrs.R_MAJOR
    ey = pcrs.R_MAJOR * np.log(np.tan(np.pi / 4 + np.radians(y[sel]) / 2))
    np.testing.assert_allclose(np.sort(p.columns["geom"].x), np.sort(ex),
                               rtol=1e-12)
    np.testing.assert_allclose(np.sort(p.columns["geom"].y), np.sort(ey),
                               rtol=1e-12)


def test_st_transform_through_sql(tmp_path):
    g = PGeometry("Point", [np.array([[10.0, 53.55]])])
    for dst in ("EPSG:3857", "EPSG:32633", 3035):
        out = st_transform(g, "EPSG:4326", dst)
        want = rcrs.transform([10.0], [53.55], 4326,
                              int(str(dst).replace("EPSG:", "")))
        np.testing.assert_array_equal(out.rings[0][0], [want[0][0], want[1][0]])
    rows = {"name": ["a", "b"], "geom": np.array([[10.0, 53.55], [-3.7, 40.4]])}
    root = str(tmp_path / "s")
    sft = RSFT.from_spec("pts", "name:String,*geom:Point")
    RDataStore(root).create_schema(sft).write(RFB.from_pydict(sft, rows))
    # 10 E is 1113194.9 m east in web mercator, 3.7 W is west of 0
    for bound, want in ((1_113_194.0, ["a"]), (1_113_195.0, [])):
        sql = ("SELECT name FROM pts WHERE st_x(st_transform(geom, "
               f"'EPSG:4326', 'EPSG:3857')) > {bound}")
        r = RSql(RDataStore(root)).sql(sql).features
        p = PSql(PDataStore(root, device="cpu")).sql(sql).features
        names = (list(p.columns["name"].decode()) if p is not None and len(p)
                 else [])
        assert names == want
        assert names == (list(r.columns["name"].decode())
                         if r is not None and len(r) else [])
