"""Spatial and distance predicates on extended-geometry (CSR) columns: the
port's `engine/geometry.py` masks against the reference package's
`engine/geometry.py`, through each package's compiled filter, on the
reference's polygon parity filters (`tests/test_cql.py` POLY_FILTERS over
its `make_poly_batch`), every other operator, its line-data and
known-answer cases, and a MultiPoint layer, with the coordinates on the
device in f64 and in f32.

Held: the masks are identical except on features with a vertex inside
the port's f32 band of a polygon literal's edges (the port tests "vertex
in literal" in f32, kernel B4; the reference's CPU fallback promotes to
its f64 edge table) or, for DWITHIN/BEYOND, a vertex whose f64 distance
lies within max(1 m, 1e-5 d) of d. Those features are counted and must
be few. Both packages' f64 host evaluations agree exactly. A tiny chunk
budget gives the masks of one chunk.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_cql import POLY_FILTERS, make_poly_batch
from test_torch_distance import port_batch, ring_m

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql import compile_filter as ref_compile, parse_cql as ref_parse
from geomesa_tpu.cql.hosteval import eval_filter_host as ref_host
from geomesa_tpu.engine.device import to_device as ref_to_device
from geomesa_tpu_torch.cql import ast as past
from geomesa_tpu_torch.cql import compile_filter as port_compile, parse_cql as port_parse
from geomesa_tpu_torch.cql.hosteval import _dist_to_segments_np
from geomesa_tpu_torch.cql.hosteval import eval_filter_host as port_host
from geomesa_tpu_torch.engine import geodesy as pgeo
from geomesa_tpu_torch.engine import geometry as pgeom
from geomesa_tpu_torch.engine.device import to_device as port_to_device
from geomesa_tpu_torch.engine.pip import points_in_polygon_band, polygon_edges

CPU = torch.device("cpu")
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
MAX_AMBIGUOUS = 3

LIT = "POLYGON ((2 2, 8 2, 8 8, 2 8, 2 2))"
EXTRA_FILTERS = [
    f"EQUALS(geom, {LIT})",
    f"OVERLAPS(geom, {LIT})",
    f"CROSSES(geom, {LIT})",
    f"TOUCHES(geom, {LIT})",
    "INTERSECTS(geom, LINESTRING (0 0, 10 5))",
    "CROSSES(geom, LINESTRING (0 0, 10 5, 3 9))",
    "INTERSECTS(geom, POINT (3.5 3.5))",
    "WITHIN(geom, MULTIPOLYGON (((-1 -1, 5 -1, 5 5, -1 5, -1 -1)), ((5 5, 11 5, 11 11, 5 11, 5 5))))",
    "BEYOND(geom, LINESTRING (12 0, 12 10), 150, kilometers)",
    "DWITHIN(geom, MULTIPOINT ((12 5), (-2 -2)), 200, kilometers)",
    f"DWITHIN(geom, {LIT}, 50, kilometers)",
    f"NOT INTERSECTS(geom, {LIT}) AND name > 'p3'",
]


def ambiguous_features(f, col, dev) -> np.ndarray:
    """Features with a vertex in a polygon literal's f32 band or, for a
    distance leaf, within the ring of its distance."""
    verts = dev["geom__verts"]
    vfeat = col.edge_table().vfeat
    vx, vy = col.vertices[:, 0], col.vertices[:, 1]
    flag = np.zeros(len(vx), bool)
    for node in past.walk(f):
        g = getattr(node, "geometry", None)
        if g is None:
            continue
        if "Polygon" in g.kind:
            edges = [torch.from_numpy(e.astype(np.float32)) for e in polygon_edges(g)]
            flag |= points_in_polygon_band(verts[:, 0], verts[:, 1], *edges).numpy()
        if isinstance(node, past.DistancePredicate):
            d = _dist_to_segments_np(vx, vy, g)
            flag |= np.abs(d - node.distance_m) <= ring_m(node.distance_m)
    out = np.zeros(len(col), bool)
    out[vfeat[flag]] = True
    return out


def check(rb, pb, cql, devs):
    rf = ref_parse(cql)
    exact = ref_host(rf, rb)
    np.testing.assert_array_equal(port_host(port_parse(cql), pb), exact, err_msg=cql)
    for dtype, (rdev, pdev) in devs.items():
        ref = np.asarray(ref_compile(rf, rb.sft).mask(rdev, rb))
        pf = port_compile(port_parse(cql), pb.sft)
        got = pf.mask(pdev, pb).numpy()
        amb = ambiguous_features(port_parse(cql), pb.columns["geom"], pdev)
        assert amb.sum() <= MAX_AMBIGUOUS, (cql, dtype, int(amb.sum()))
        np.testing.assert_array_equal(got[~amb], ref[~amb], err_msg=(cql, dtype))
    return got


def devices(rb, pb):
    return {k: (ref_to_device(rb, coord_dtype=j), port_to_device(pb, CPU, t))
            for k, (j, t) in DTYPES.items()}


@pytest.fixture(scope="module")
def polys():
    rb = make_poly_batch()
    pb = port_batch(rb)
    return rb, pb, devices(rb, pb)


@pytest.mark.parametrize("cql", POLY_FILTERS + EXTRA_FILTERS)
def test_polygon_layer(polys, cql):
    check(*polys[:2], cql, polys[2])


LINES = ["LINESTRING (0 0, 10 5)", "LINESTRING (20 20, 30 25)",
         "LINESTRING (1.2 2.2, 1.8 2.8)", "MULTILINESTRING ((3 1, 3 9), (4 4, 5 5))"]
LINE_CASES = [
    ("INTERSECTS(geom, POLYGON ((1 2, 6 2, 6 4, 1 4, 1 2)))", [True, False, True, True]),
    ("WITHIN(geom, POLYGON ((1 2, 6 2, 6 4, 1 4, 1 2)))", [False, False, True, False]),
    ("DISJOINT(geom, POLYGON ((1 2, 2 2, 2 3, 1 3, 1 2)))", [True, True, False, True]),
    ("CROSSES(geom, POLYGON ((1 2, 6 2, 6 4, 1 4, 1 2)))", [True, False, False, True]),
    ("DWITHIN(geom, POINT (20.5 20.3), 100, kilometers)", [False, True, False, False]),
    ("CONTAINS(geom, POINT (3 5))", [False, False, False, False]),
    ("BBOX(geom, 2.5, 0, 3.5, 10)", [True, False, False, True]),
]


@pytest.fixture(scope="module")
def lines():
    sft = RSFT.from_spec("l", "name:String,*geom:MultiLineString")
    rb = RFB.from_pydict(sft, {"name": ["through", "outside", "inside", "multi"],
                               "geom": LINES})
    pb = port_batch(rb)
    return rb, pb, devices(rb, pb)


@pytest.mark.parametrize("case", LINE_CASES, ids=[c[0][:24] for c in LINE_CASES])
def test_line_layer(lines, case):
    cql, expect = case
    got = check(*lines[:2], cql, lines[2])
    assert got.tolist() == expect, cql


KNOWN = ["POLYGON ((1 1, 2 1, 2 2, 1 2, 1 1))", "POLYGON ((4 4, 6 4, 6 6, 4 6, 4 4))",
         "POLYGON ((20 20, 21 20, 21 21, 20 21, 20 20))",
         "POLYGON ((-5 -5, 15 -5, 15 15, -5 15, -5 -5), (7 7, 8 7, 8 8, 7 8, 7 7))"]
KNOWN_LIT = "POLYGON ((0 0, 5 0, 5 5, 0 5, 0 0))"
KNOWN_CASES = [
    (f"INTERSECTS(geom, {KNOWN_LIT})", [True, True, False, True]),
    (f"WITHIN(geom, {KNOWN_LIT})", [True, False, False, False]),
    (f"DISJOINT(geom, {KNOWN_LIT})", [False, False, True, False]),
    ("CONTAINS(geom, POINT (1.5 1.5))", [True, False, False, True]),
    ("CONTAINS(geom, POINT (7.5 7.5))", [False, False, False, False]),
    (f"CONTAINS(geom, {KNOWN_LIT})", [False, False, False, True]),
    (f"OVERLAPS(geom, {KNOWN_LIT})", [False, True, False, False]),
]


@pytest.fixture(scope="module")
def known():
    sft = RSFT.from_spec("p", "name:String,*geom:Polygon")
    rb = RFB.from_pydict(sft, {"name": ["inside", "straddle", "outside", "holed"],
                               "geom": KNOWN})
    pb = port_batch(rb)
    return rb, pb, devices(rb, pb)


@pytest.mark.parametrize("case", KNOWN_CASES, ids=[c[0][:24] for c in KNOWN_CASES])
def test_known_answers(known, case):
    cql, expect = case
    assert check(*known[:2], cql, known[2]).tolist() == expect, cql


MP_CASES = [
    "INTERSECTS(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)))",
    "WITHIN(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)))",
    "DWITHIN(geom, POINT (5 5), 150, kilometers)",
    "BBOX(geom, 3, 3, 6, 6)",
    "CROSSES(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)))",
]


@pytest.fixture(scope="module")
def multipoints():
    rng = np.random.default_rng(9)
    geoms = []
    for _ in range(40):
        pts = rng.uniform(-1, 8, (rng.integers(1, 5), 2))
        geoms.append("MULTIPOINT (" + ", ".join(f"({float(x)!r} {float(y)!r})" for x, y in pts) + ")")
    sft = RSFT.from_spec("m", "name:String,*geom:MultiPoint")
    rb = RFB.from_pydict(sft, {"name": [f"m{i}" for i in range(40)], "geom": geoms})
    pb = port_batch(rb)
    return rb, pb, devices(rb, pb)


@pytest.mark.parametrize("cql", MP_CASES)
def test_multipoint_layer(multipoints, cql):
    got = check(*multipoints[:2], cql, multipoints[2])
    if cql.startswith(("INTERSECTS", "DWITHIN")):
        assert 0 < got.sum() < len(got), cql


@pytest.mark.parametrize("cql", [
    f"INTERSECTS(geom, {LIT})", f"WITHIN(geom, {LIT})",
    "CONTAINS(geom, POLYGON ((3.1 3.1, 3.4 3.1, 3.4 3.4, 3.1 3.4, 3.1 3.1)))",
    f"OVERLAPS(geom, {LIT})", "DWITHIN(geom, LINESTRING (12 0, 12 10), 300, kilometers)",
])
def test_chunked_equals_one_chunk(polys, cql, monkeypatch):
    """Tiny chunk budgets, and no skipping of edges (an infinite pad),
    give the masks of one chunk with the skips."""
    _, pb, devs = polys
    pdev = devs["f32"][1]
    f = port_parse(cql)
    monkeypatch.setattr(pgeom, "PAIR_BUDGET_BYTES", 1 << 40)
    want = pgeom.compile_extended_spatial(f, "geom", "Polygon")(None, pdev).numpy()
    assert 0 < want.sum() < len(want), cql
    for budget, pad in ((1, pgeom.PRUNE_PAD), (64, pgeom.PRUNE_PAD),
                        (4096, pgeom.PRUNE_PAD), (1 << 40, float("inf")),
                        (64, float("inf"))):
        monkeypatch.setattr(pgeom, "PAIR_BUDGET_BYTES", budget)
        monkeypatch.setattr(pgeom, "PRUNE_PAD", pad)
        monkeypatch.setattr(pgeo, "PAIR_BUDGET_BYTES", budget)
        got = pgeom.compile_extended_spatial(f, "geom", "Polygon")(None, pdev)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=(cql, budget, pad))


def _reference_proper(e, lit):
    """The reference's proper-crossing formula per data edge, in NumPy f64
    over the f32 column values (what its promoted arithmetic computes)."""
    ex1, ey1, ex2, ey2 = (np.asarray(a, np.float64)[:, None] for a in e)
    lx1, ly1, lx2, ly2 = (np.asarray(a)[None, :] for a in lit)

    def cross(ox, oy, ax, ay, bx, by):
        return (ax - ox) * (by - oy) - (ay - oy) * (bx - ox)
    d1 = cross(lx1, ly1, lx2, ly2, ex1, ey1)
    d2 = cross(lx1, ly1, lx2, ly2, ex2, ey2)
    d3 = cross(ex1, ey1, ex2, ey2, lx1, ly1)
    d4 = cross(ex1, ey1, ex2, ey2, lx2, ly2)
    return (((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))).any(axis=1)


@pytest.mark.parametrize("lit", [LIT, "POLYGON ((3.1 3.1, 3.4 3.1, 3.4 3.4, 3.1 3.4, 3.1 3.1))",
                                 "LINESTRING (0 0, 10 5, 3 9)"])
def test_skipped_edges_are_false_in_the_reference(polys, lit):
    """Every data edge that a skip drops adds nothing in the reference's
    formulas: no proper crossing, and no crossing of a literal vertex's
    rightward ray."""
    _, pb, devs = polys
    dev = devs["f32"][1]
    (x1, y1, x2, y2), lvx, lvy = pgeom._literal_arrays(
        port_parse(f"INTERSECTS(geom, {lit})").geometry)
    e = [dev[f"geom__{k}"].numpy() for k in ("ex1", "ey1", "ex2", "ey2")]
    ex1, ey1, ex2, ey2 = (a.astype(np.float64) for a in e)
    pad = pgeom.PRUNE_PAD
    kept = ((np.maximum(ex1, ex2) >= min(x1.min(), x2.min()) - pad)
            & (np.minimum(ex1, ex2) <= max(x1.max(), x2.max()) + pad)
            & (np.maximum(ey1, ey2) >= min(y1.min(), y2.min()) - pad)
            & (np.minimum(ey1, ey2) <= max(y1.max(), y2.max()) + pad))
    proper = _reference_proper(e, (x1, y1, x2, y2))
    assert (~kept).any() and proper.any() and not proper[~kept].any()
    py, px = lvy[None, :], lvx[None, :]
    cond = (ey1[:, None] <= py) != (ey2[:, None] <= py)
    den = np.where(e[3] == e[1], np.float32(1), e[3] - e[1]).astype(np.float64)
    xc = ex1[:, None] + (py - ey1[:, None]) / den[:, None] * (
        (e[2] - e[0]).astype(np.float64)[:, None])
    crossing = cond & (xc > px)
    kept = ((np.maximum(ey1, ey2) > lvy.min()) & (np.minimum(ey1, ey2) <= lvy.max())
            & (np.maximum(ex1, ex2) >= lvx.min() - pad))
    assert (~kept).any() and crossing.any() and not crossing[~kept].any()


@pytest.mark.cuda
def test_masks_on_the_card_match_cpu(polys):
    """On the card, vertex-in-literal launches B4; every operator's mask
    equals the CPU path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from geomesa_tpu_torch.engine import pip_kernels as pk

    _, pb, devs = polys
    cpu = devs["f32"][1]
    gpu = port_to_device(pb, torch.device("cuda"))
    pk.pip_crossing.launches = 0
    for cql in POLY_FILTERS + EXTRA_FILTERS:
        pf = port_compile(port_parse(cql), pb.sft)
        np.testing.assert_array_equal(pf.mask(gpu, pb).cpu().numpy(),
                                      pf.mask(cpu, pb).numpy(), err_msg=cql)
    assert pk.pip_crossing.launches > 0
