"""Density over extended geometries: the port's `engine/raster.py` against
the reference package's `engine/raster.py` and its independent NumPy
oracles (`tests/test_raster.py`: Amanatides-Woo cell walking for lines,
per-feature even-odd cell-center tests for polygons), on the reference's
cases, and end to end through both packages' DataStore over XZ2 polygon
and line layers.

Held: polygon coverage grids with unit weights identical to the
reference's; weighted grids and line grids (length fractions) equal to
the reference's within f32 summation-order noise and to the oracles
within the reference's own tolerances; the static k budgets identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_raster import (BBOX, line_oracle, polygon_oracle, random_lines,
                         random_polys)

from geomesa_tpu.core.columnar import FeatureBatch as RFB, GeometryColumn as RGC
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.core.wkt import Geometry as RG, parse_wkt as rparse
from geomesa_tpu.engine import raster as rr
from geomesa_tpu.engine.device import to_device as rtd
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB, GeometryColumn as PGC
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.core.wkt import Geometry as PG
from geomesa_tpu_torch.engine import raster as pr
from geomesa_tpu_torch.engine.device import to_device as ptd

CPU = torch.device("cpu")
NOISE = dict(rtol=1e-5, atol=1e-5)  # f32 summation order of weighted cells


def both(geoms, kind, weights, bbox, width, height, mask=None, pad=None):
    """(reference grid, port grid) of density_grid_geometry over the same
    features (reference Geometry objects)."""
    n = len(geoms)
    m = np.ones(n, bool) if mask is None else np.asarray(mask)
    w = np.asarray(weights, np.float64)
    rcol = RGC.from_geometries(geoms, kind=kind)
    pcol = PGC.from_geometries([PG(g.kind, [np.array(r) for r in g.rings],
                                   list(g.parts)) for g in geoms], kind=kind)
    rb = RFB(RSFT.from_spec("t", f"*geom:{kind}"), {"geom": rcol})
    pb = PFB(PSFT.from_spec("t", f"*geom:{kind}"), {"geom": pcol})
    if pad:
        rb, pb = rb.pad_to(pad), pb.pad_to(pad)
        m = np.concatenate([m, np.zeros(pad - n, bool)])
        w = np.concatenate([w, np.zeros(pad - n)])
    ref = np.asarray(rr.density_grid_geometry(
        rb.columns["geom"], rtd(rb), "geom", jnp.asarray(w, jnp.float32),
        jnp.asarray(m), bbox, width, height))
    got = pr.density_grid_geometry(
        pb.columns["geom"], ptd(pb, CPU), "geom",
        torch.from_numpy(w.astype(np.float32)), torch.from_numpy(m),
        bbox, width, height).numpy()
    assert got.dtype == np.float32 and got.shape == (height, width)
    return ref, got


def line_geoms(feats):
    return [RG("LineString", list(paths)) for paths in feats]


def poly_geoms(feats):
    return [RG("Polygon", rings) for rings in feats]


def test_lines_match_reference_and_oracle():
    rng = np.random.default_rng(42)
    feats = random_lines(rng, 60)
    w = rng.uniform(0.5, 3.0, len(feats))
    ref, got = both(line_geoms(feats), "LineString", w, BBOX, 32, 24)
    np.testing.assert_allclose(got, ref, **NOISE)
    np.testing.assert_allclose(got, line_oracle(feats, w, BBOX, 32, 24),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seg,w,want", [
    (np.array([[0.1, 0.1], [0.4, 0.3]]), 2.0, 2.0),  # inside one cell
    (np.array([[0.0, 0.0], [16.0, 0.0]]), 1.0, 0.5),  # half outside
])
def test_line_total_weight_is_inside_fraction(seg, w, want):
    ref, got = both([RG("LineString", [seg])], "LineString", [w], BBOX, 16, 16)
    np.testing.assert_allclose(got, ref, **NOISE)
    assert got.sum() == pytest.approx(want, rel=1e-5)


def test_line_mask_and_multilinestring():
    rng = np.random.default_rng(3)
    feats = random_lines(rng, 10)
    mask = np.zeros(10, bool)
    mask[::2] = True
    ref, got = both(line_geoms(feats), "LineString", np.ones(10), BBOX, 16, 16,
                    mask=mask, pad=16)
    np.testing.assert_allclose(got, ref, **NOISE)
    np.testing.assert_allclose(
        got, line_oracle([f for f, m in zip(feats, mask) if m], np.ones(5),
                         BBOX, 16, 16), rtol=2e-4, atol=2e-4)
    g = rparse("MULTILINESTRING((0 0, 2 0.5, 3 2), (-4 -4, -2 -3.5))")
    ref, got = both([g], "MultiLineString", [1.5], BBOX, 20, 20)
    np.testing.assert_allclose(got, ref, **NOISE)


def test_polygons_match_reference_and_oracle():
    rng = np.random.default_rng(7)
    feats = random_polys(rng, 80)
    ref, got = both(poly_geoms(feats), "Polygon", np.ones(80), BBOX, 40, 32)
    np.testing.assert_array_equal(got, ref)  # unit weights: identical
    np.testing.assert_array_equal(got, polygon_oracle(feats, np.ones(80), BBOX, 40, 32))
    w = rng.uniform(0.5, 3.0, 80)
    ref, got = both(poly_geoms(feats), "Polygon", w, BBOX, 40, 32)
    np.testing.assert_allclose(got, ref, **NOISE)
    np.testing.assert_allclose(got, polygon_oracle(feats, w, BBOX, 40, 32), **NOISE)


def test_polygon_hole_and_reversed_rings():
    outer = np.array([[-4.0, -4.0], [4.0, -4.0], [4.0, 4.0], [-4.0, 4.0], [-4.0, -4.0]])
    hole = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0]])
    variants = [[outer, hole], [outer[::-1].copy(), hole],
                [outer, hole[::-1].copy()], [outer[::-1].copy(), hole[::-1].copy()]]
    grids = []
    for rings in variants:
        ref, got = both([RG("Polygon", rings)], "Polygon", [1.0], BBOX, 32, 32)
        np.testing.assert_array_equal(got, ref)
        grids.append(got)
    want = polygon_oracle([[outer, hole]], [1.0], BBOX, 32, 32)
    for g in grids:
        np.testing.assert_array_equal(g, want)
    assert grids[0][16, 16] == 0.0 and grids[0][10, 10] == 1.0


def test_multipolygon_padding_and_mask():
    g = rparse("MULTIPOLYGON(((0 0, 3 0, 3 3, 0 3, 0 0)),((-5 -5, -4 -5, -4 -4, -5 -4, -5 -5)))")
    ref, got = both([g], "MultiPolygon", [2.5], BBOX, 32, 32)
    np.testing.assert_array_equal(got, ref)
    rng = np.random.default_rng(11)
    feats = random_polys(rng, 9)
    mask = np.array([True, False] * 4 + [True])
    ref, got = both(poly_geoms(feats), "Polygon", np.ones(9), BBOX, 24, 24,
                    mask=mask, pad=16)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, polygon_oracle(
        [f for f, m in zip(feats, mask) if m], np.ones(5), BBOX, 24, 24))


def test_multipoint_and_mixed_kinds():
    g = rparse("MULTIPOINT((0.1 0.1), (0.15 0.12), (5 5))")
    ref, got = both([g], "MultiPoint", [1.0], BBOX, 16, 16)
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == 3.0
    mixed = [rparse("LINESTRING(0 0, 4 3)"),
             rparse("POLYGON((-6 -6, -2 -6, -2 -2, -6 -2, -6 -6))"),
             rparse("POINT(5.5 5.5)"),
             rparse("GEOMETRYCOLLECTION(LINESTRING(0 0, 4 3), POINT(1 1))")]
    for mask in (None, [True, False, True, True]):
        ref, got = both(mixed, "Geometry", [1.0, 2.0, 3.0, 1.0], BBOX, 16, 16,
                        mask=mask)
        np.testing.assert_allclose(got, ref, **NOISE)


def test_static_budgets_identical():
    rng = np.random.default_rng(5)
    x1, y1, x2, y2 = (rng.uniform(-12, 12, 500) for _ in range(4))
    for bbox, w, h in ((BBOX, 32, 24), ((-3.0, -2.0, 5.0, 7.0), 512, 512)):
        assert pr.line_crossing_bounds(x1, y1, x2, y2, bbox, w, h) == \
            rr.line_crossing_bounds(x1, y1, x2, y2, bbox, w, h)
        assert pr.polygon_rowspan_bound(y1, y2, bbox, h) == \
            rr.polygon_rowspan_bound(y1, y2, bbox, h)


def test_tile_size_changes_no_cell():
    """The port sizes its tiles for the card (`_seg_tile`); any tile size
    gives the same unit-weight coverage and the same line grid within
    f32 summation noise."""
    rng = np.random.default_rng(17)
    polys = poly_geoms(random_polys(rng, 60))
    lines = line_geoms(random_lines(rng, 40))
    for geoms, kind in ((polys, "Polygon"), (lines, "LineString")):
        pcol = PGC.from_geometries([PG(g.kind, list(g.rings)) for g in geoms], kind=kind)
        pb = PFB(PSFT.from_spec("t", f"*geom:{kind}"), {"geom": pcol})
        dev = ptd(pb, CPU)
        ed = [dev[f"geom__{k}"] for k in ("ex1", "ey1", "ex2", "ey2")]
        ones = torch.ones(ed[0].shape[0])
        mask = torch.ones(ed[0].shape[0], dtype=torch.bool)
        grids = []
        for tile in (256, 1000, pr._seg_tile(8)):
            if kind == "Polygon":
                grids.append(pr.polygon_density(*ed, ones, mask, BBOX, 40, 32, 8,
                                                seg_tile=tile).numpy())
            else:
                grids.append(pr.line_density(*ed, ones, mask, BBOX, 40, 32, 8, 8,
                                             seg_tile=tile).numpy())
        for g in grids[1:]:
            if kind == "Polygon":
                np.testing.assert_array_equal(g, grids[0])
            else:
                np.testing.assert_allclose(g, grids[0], **NOISE)


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    from geomesa_tpu.plan import DataStore as RDS
    from geomesa_tpu.store.partition import XZ2Scheme as RXZ2
    from geomesa_tpu_torch.plan import DataStore as PDS

    root = str(tmp_path_factory.mktemp("torch_raster"))
    rng = np.random.default_rng(5)
    polys = poly_geoms(random_polys(rng, 200, extent=(-60, -30, 60, 30), rmax=3.0))
    sft = RSFT.from_spec("polys", "name:String,score:Double,*geom:Polygon")
    RDS(root).create_schema(sft, RXZ2(g=2)).write(RFB.from_pydict(sft, {
        "name": [f"p{i}" for i in range(200)], "score": rng.uniform(0, 10, 200),
        "geom": polys}))
    lines = line_geoms(random_lines(rng, 50, extent=(-5, -5, 5, 5)))
    sft = RSFT.from_spec("tracks", "w:Double,*geom:LineString")
    RDS(root).create_schema(sft, RXZ2(g=2)).write(RFB.from_pydict(sft, {
        "w": rng.uniform(1, 4, 50), "geom": lines}))
    return RDS(root), PDS(root, device="cpu"), PDS(root, use_device_cache=True,
                                                  device="cpu")


@pytest.mark.parametrize("name,cql,bbox,wh,weight", [
    ("polys", "BBOX(geom, -30, -20, 30, 20)", (-30.0, -20.0, 30.0, 20.0), (48, 32), None),
    ("polys", "INTERSECTS(geom, POLYGON ((-20 -10, 20 -10, 0 25, -20 -10)))",
     (-30.0, -20.0, 30.0, 20.0), (48, 32), "score"),
    ("tracks", "INCLUDE", (-6.0, -6.0, 6.0, 6.0), (24, 24), "w"),
    ("tracks", "DWITHIN(geom, POINT (0 0), 300, kilometers)", (-6.0, -6.0, 6.0, 6.0),
     (24, 24), None),
])
def test_density_through_datastores(layers, name, cql, bbox, wh, weight):
    from geomesa_tpu.plan import Query as RQ, QueryHints as RH
    from geomesa_tpu.process.density import DensityProcess as RDP
    from geomesa_tpu_torch.plan import Query as PQ, QueryHints as PH
    from geomesa_tpu_torch.process.density import DensityProcess as PDP

    rds, pds, pcached = layers
    kw = dict(density_bbox=bbox, density_width=wh[0], density_height=wh[1],
              density_weight=weight)
    ref = rds.get_feature_source(name).get_features(RQ(name, cql, hints=RH(**kw)))
    for ds in (pds, pcached):
        got = ds.get_feature_source(name).get_features(PQ(name, cql, hints=PH(**kw)))
        assert got.kind == "density" and got.count == ref.count > 0
        if weight is None and name == "polys":
            np.testing.assert_array_equal(got.grid, ref.grid)
        else:
            np.testing.assert_allclose(got.grid, ref.grid, **NOISE)
    r = RDP().execute(rds.get_feature_source(name), bbox, *wh, cql_filter=cql,
                      weight_attr=weight, radius_pixels=1)
    p = PDP().execute(pcached.get_feature_source(name), bbox, *wh, cql_filter=cql,
                      weight_attr=weight, radius_pixels=1)
    np.testing.assert_allclose(p, r, **NOISE)


@pytest.mark.parametrize("name,cql", [
    ("polys", "BBOX(geom, -30, -20, 30, 20)"),
    ("polys", "WITHIN(geom, POLYGON ((-40 -25, 40 -25, 40 25, -40 25, -40 -25)))"),
    ("tracks", "INTERSECTS(geom, POLYGON ((-2 -2, 2 -2, 2 2, -2 2, -2 -2)))"),
])
def test_counts_and_features_both_routes(layers, name, cql):
    """get_count and features over a non-point store on the cached and the
    scan route (loose bbox) equal the reference's."""
    from geomesa_tpu.plan import Query as RQ, QueryHints as RH
    from geomesa_tpu_torch.plan import Query as PQ, QueryHints as PH

    rds, pds, pcached = layers
    rsrc = rds.get_feature_source(name)
    for loose in (False, True):
        r = rsrc.get_features(RQ(name, cql, hints=RH(loose_bbox=loose)))
        for ds in (pds, pcached):
            src = ds.get_feature_source(name)
            p = src.get_features(PQ(name, cql, hints=PH(loose_bbox=loose)))
            assert len(p.features) == len(r.features) > 0, (cql, loose)
            key = "name" if name == "polys" else "w"
            pk, rk = p.features.columns[key], r.features.columns[key]
            if key == "name":
                pk, rk = pk.decode(), rk.decode()
            assert sorted(pk) == sorted(rk), (cql, loose)
            assert src.get_count(PQ(name, cql, hints=PH(loose_bbox=loose))) == \
                rsrc.get_count(RQ(name, cql, hints=RH(loose_bbox=loose)))


@pytest.mark.cuda
def test_raster_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    feats = random_polys(rng, 80)
    lines = random_lines(rng, 40)
    for geoms, kind in ((poly_geoms(feats), "Polygon"), (line_geoms(lines), "LineString")):
        pcol = PGC.from_geometries([PG(g.kind, list(g.rings)) for g in geoms], kind=kind)
        pb = PFB(PSFT.from_spec("t", f"*geom:{kind}"), {"geom": pcol})
        n = len(geoms)
        w = torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32))
        m = torch.ones(n, dtype=torch.bool)
        cpu = pr.density_grid_geometry(pcol, ptd(pb, CPU), "geom", w, m, BBOX, 40, 32)
        dev = torch.device("cuda")
        gpu = pr.density_grid_geometry(pcol, ptd(pb, dev), "geom", w.to(dev),
                                       m.to(dev), BBOX, 40, 32).cpu()
        np.testing.assert_allclose(gpu.numpy(), cpu.numpy(), **NOISE)
