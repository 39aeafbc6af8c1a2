"""The port's extended geometry columns and codecs against the reference
package's, on the same seeded geometries.

Held exactly (no tolerance: both sides are the same NumPy arithmetic):
- `GeometryColumn.from_geometries` (CSR vertices, ring offsets, feature
  rings, parts, bbox, feature kinds) and `edge_table()` (vertex owners,
  edge ends, edge owners, the shell-CCW / hole-CW flip) for polygons with
  holes, reversed shells, multipolygons, lines, multilines, points and
  mixed `Geometry` columns;
- `take`, `FeatureBatch.concat` (CSR with CSR, and CSR with points) and
  `pad_to`, then `geometry(i)` of every row;
- `to_wkt` byte for byte, `parse_wkt` (the canonical polygon fast path
  and the token parser), `to_wkb`/`parse_wkb` and `to_geojson`.
"""

import numpy as np
import pytest

from geomesa_tpu.core import columnar as rcol
from geomesa_tpu.core import wkt as rwkt
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu_torch.core import columnar as pcol
from geomesa_tpu_torch.core import wkt as pwkt
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT


def ring(rng, cx, cy, r, n, reverse=False):
    th = np.sort(rng.uniform(0, 2 * np.pi, n))
    if reverse:
        th = th[::-1]
    pts = np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1)
    return np.concatenate([pts, pts[:1]])


def wkts(kind, seed=7, n=40):
    """n seeded WKT strings of `kind` (mixed: every kind in turn)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = kind if kind != "Geometry" else (
            "Polygon", "LineString", "Point", "MultiPolygon", "MultiLineString")[i % 5]
        cx, cy = rng.uniform(-150, 150), rng.uniform(-60, 60)
        if k == "Point":
            out.append(rwkt.to_wkt(rwkt.point(cx, cy)))
        elif k == "LineString":
            out.append(rwkt.to_wkt(rwkt.Geometry(
                "LineString", [ring(rng, cx, cy, 2.0, 7)[:-1]])))
        elif k == "MultiLineString":
            out.append(rwkt.to_wkt(rwkt.Geometry(
                "MultiLineString", [ring(rng, cx, cy, 2.0, 5)[:-1],
                                    ring(rng, cx + 5, cy, 1.0, 4)[:-1]], [1, 1])))
        elif k == "Polygon":
            rings = [ring(rng, cx, cy, 3.0, 12, reverse=i % 3 == 1)]
            if i % 2:
                # a hole given CCW: edge_table must flip it to CW
                rings.append(ring(rng, cx, cy, 1.0, 6, reverse=i % 4 == 1))
            if i % 5 == 2:  # an open shell: the edge table closes it
                rings[0] = rings[0][:-1]
            out.append(rwkt.to_wkt(rwkt.Geometry("Polygon", rings)))
        elif k == "MultiPolygon":
            a = [ring(rng, cx, cy, 2.0, 9, reverse=True),
                 ring(rng, cx, cy, 0.5, 5)]
            b = [ring(rng, cx + 6, cy, 1.5, 8)]
            out.append(rwkt.to_wkt(rwkt.Geometry("MultiPolygon", a + b, [2, 1])))
    return out


KINDS = ["Polygon", "MultiPolygon", "LineString", "MultiLineString", "Geometry"]


def columns(kind, seed=7, n=40):
    text = wkts(kind, seed, n)
    r = rcol.GeometryColumn.from_geometries([rwkt.parse_wkt(t) for t in text])
    p = pcol.GeometryColumn.from_geometries([pwkt.parse_wkt(t) for t in text])
    return r, p


def assert_same_column(r, p):
    assert p.kind == r.kind
    for name in ("x", "y", "vertices", "ring_offsets", "feature_rings", "bbox",
                 "feature_kinds"):
        a, b = getattr(r, name), getattr(p, name)
        if a is None:
            assert b is None, name
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
            assert b.dtype == a.dtype, name
    assert p.feature_parts == r.feature_parts
    for i in range(len(r)):
        rg, pg = r.geometry(i), p.geometry(i)
        assert (pg.kind, pg.parts) == (rg.kind, rg.parts)
        assert len(pg.rings) == len(rg.rings)
        for a, b in zip(rg.rings, pg.rings):
            np.testing.assert_array_equal(b, a)


def assert_same_edges(r, p):
    re_, pe = r.edge_table(), p.edge_table()
    for name in ("vfeat", "x1", "y1", "x2", "y2", "efeat"):
        a, b = getattr(re_, name), getattr(pe, name)
        np.testing.assert_array_equal(b, a, err_msg=name)
        assert b.dtype == a.dtype, name
    assert p.edge_table() is pe  # memoised


@pytest.mark.parametrize("kind", KINDS)
def test_columns_and_edge_tables_equal(kind):
    r, p = columns(kind)
    assert_same_column(r, p)
    assert_same_edges(r, p)
    assert len(p.edge_table().x1) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_take_concat_pad_equal(kind):
    r, p = columns(kind, seed=11, n=30)
    idx = np.array([5, 0, 29, 5, 17, 3])
    assert_same_column(r.take(idx), p.take(idx))
    assert_same_edges(r.take(idx), p.take(idx))
    spec = f"name:String,*geom:{kind}"
    rs, ps = RSFT.from_spec("t", spec), PSFT.from_spec("t", spec)
    names = [f"f{i}" for i in range(30)]
    rb = rcol.FeatureBatch(rs, {"name": rcol.DictColumn.encode(names), "geom": r})
    pb = pcol.FeatureBatch(ps, {"name": pcol.DictColumn.encode(names), "geom": p})
    r2, p2 = columns("Polygon", seed=12, n=9)
    rb2 = rcol.FeatureBatch(rs, {"name": rcol.DictColumn.encode(names[:9]), "geom": r2})
    pb2 = pcol.FeatureBatch(ps, {"name": pcol.DictColumn.encode(names[:9]), "geom": p2})
    rc = rcol.FeatureBatch.concat([rb.select(idx), rb2, rb.pad_to(32)])
    pc = pcol.FeatureBatch.concat([pb.select(idx), pb2, pb.pad_to(32)])
    assert_same_column(rc.columns["geom"], pc.columns["geom"])
    assert_same_edges(rc.columns["geom"], pc.columns["geom"])
    np.testing.assert_array_equal(pc.valid, rc.valid)
    assert pc.columns["name"].decode() == rc.columns["name"].decode()


def test_concat_of_points_and_polygons_equal():
    """A point part and a CSR part concat through the Geometry objects."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-10, 10, (6, 2))
    r, p = columns("Polygon", seed=4, n=5)
    rpt = rcol.GeometryColumn.from_points(pts[:, 0], pts[:, 1])
    ppt = pcol.GeometryColumn.from_points(pts[:, 0], pts[:, 1])
    rs, ps = RSFT.from_spec("t", "*geom:Geometry"), PSFT.from_spec("t", "*geom:Geometry")
    rc = rcol.FeatureBatch.concat([rcol.FeatureBatch(rs, {"geom": rpt}),
                                   rcol.FeatureBatch(rs, {"geom": r})])
    pc = pcol.FeatureBatch.concat([pcol.FeatureBatch(ps, {"geom": ppt}),
                                   pcol.FeatureBatch(ps, {"geom": p})])
    assert_same_column(rc.columns["geom"], pc.columns["geom"])
    assert_same_edges(rc.columns["geom"], pc.columns["geom"])


def test_from_pydict_polygon_layer_equal():
    text = wkts("Polygon", seed=5, n=12)
    spec = "name:String,*geom:Polygon"
    data = {"name": [f"r{i}" for i in range(12)], "geom": text}
    rb = rcol.FeatureBatch.from_pydict(RSFT.from_spec("t", spec), data)
    pb = pcol.FeatureBatch.from_pydict(PSFT.from_spec("t", spec), data)
    assert_same_column(rb.columns["geom"], pb.columns["geom"])
    empty = pcol.FeatureBatch.from_pydict(PSFT.from_spec("t", spec),
                                          {"name": [], "geom": []})
    assert empty.columns["geom"].kind == "Polygon" and len(empty) == 0


def special_values_polygon():
    """A canonical polygon whose coordinates exercise repr's forms."""
    shell = np.array([[0.1, -0.0], [1e-05, 2.5e-300], [123456789.125, 1e+16],
                      [-179.99999999999997, 89.99999999999999], [0.1, -0.0]])
    return rwkt.Geometry("Polygon", [shell, shell[::-1] * 0.5])


@pytest.mark.parametrize("case", ["layer", "special", "odd_text"])
def test_wkt_text_and_parse_equal(case):
    if case == "layer":
        texts = wkts("Geometry", seed=9, n=25) + wkts("Polygon", seed=10, n=25)
    elif case == "special":
        texts = [rwkt.to_wkt(special_values_polygon())]
    else:  # non-canonical text: the token parser, never the fast path
        texts = ["POLYGON((0 0,1 0,1 1,0 0))", "POLYGON ((0 0 5, 1 0 5, 1 1 5, 0 0 5))",
                 "POLYGON ((0 0, 1 0, 1 1, 0 0),(0.2 0.2, 0.5 0.2, 0.2 0.5, 0.2 0.2))",
                 "polygon ((0 0, 1 0, 1 1, 0 0))", "POLYGON EMPTY",
                 "POLYGON Z ((0 0 1, 1 0 1, 1 1 1, 0 0 1))",
                 "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), ((5 5, 6 5, 6 6, 5 5)))",
                 "POLYGON ((1e5 2E-3, 3 4, 5 6, 1e5 2E-3))"]
    for t in texts:
        rg, pg = rwkt.parse_wkt(t), pwkt.parse_wkt(t)
        assert pg.kind == rg.kind and pg.parts == rg.parts
        assert len(pg.rings) == len(rg.rings)
        for a, b in zip(rg.rings, pg.rings):
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype and b.shape == a.shape
        assert pwkt.to_wkt(pg).encode() == rwkt.to_wkt(rg).encode()


@pytest.mark.parametrize("kind", ["Point", "LineString", "Polygon",
                                  "MultiLineString", "MultiPolygon"])
def test_wkb_and_geojson_equal(kind):
    texts = wkts(kind, seed=13, n=6) if kind != "Point" else [
        "POINT (1.5 -2.25)", "POINT (0.0 0.0)"]
    for t in texts:
        rg, pg = rwkt.parse_wkt(t), pwkt.parse_wkt(t)
        assert pwkt.to_wkb(pg) == rwkt.to_wkb(rg)
        assert pwkt.to_geojson(pg) == rwkt.to_geojson(rg)
        back = pwkt.parse_wkb(rwkt.to_wkb(rg))
        assert pwkt.to_wkt(back) == rwkt.to_wkt(rwkt.parse_wkb(rwkt.to_wkb(rg)))
