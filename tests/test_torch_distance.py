"""Distance predicates and point/line literals on point columns: the port's
compiled filter (geomesa_tpu_torch.cql.compile) against the reference
package's, on the reference's own parity filters (`tests/test_cql.py`
PARITY_FILTERS over its `make_batch`), with the coordinates on the
device in f64 and in f32.

Held, row for row:

- the port's raw mask equals the reference's, except on rows where a
  leaf of the filter is ambiguous by construction: a DWITHIN/BEYOND row
  whose f64 distance lies within max(1 m, 1e-5 d) of d (the two
  packages' trigonometry differs in the last ulps), or a polygon-literal
  row that the port's f32 band flags (the port tests polygons in f32,
  kernel B4; the reference's CPU fallback promotes to its f64 edge
  table). Such rows are counted and must be few;
- the port's mask with its band rows re-decided in f64 equals the
  reference's f64 host evaluation wherever no distance leaf is ambiguous;
- both packages' f64 host evaluations agree exactly.

`st_dwithin` in a SQL WHERE pushes down to the same DWITHIN mask through
SqlContext, and the chunked point-to-segments distance equals one chunk.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_cql import PARITY_FILTERS, make_batch

from geomesa_tpu.core.columnar import DictColumn as RDict, GeometryColumn as RGeom
from geomesa_tpu.core.wkt import to_wkt as ref_to_wkt
from geomesa_tpu.cql import compile_filter as ref_compile, parse_cql as ref_parse
from geomesa_tpu.cql.hosteval import eval_filter_host as ref_host
from geomesa_tpu.engine.device import to_device as ref_to_device
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.cql import ast as past
from geomesa_tpu_torch.cql import compile_filter as port_compile, parse_cql as port_parse
from geomesa_tpu_torch.cql.hosteval import _dist_to_segments_np
from geomesa_tpu_torch.cql.hosteval import eval_filter_host as port_host
from geomesa_tpu_torch.engine import geodesy as pgeo
from geomesa_tpu_torch.engine.device import to_device as port_to_device
from geomesa_tpu_torch.engine.pip import points_in_polygon_band, polygon_edges

CPU = torch.device("cpu")
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
# at most this many rows of a filter may sit in its ambiguity ring
MAX_AMBIGUOUS = 5


def port_batch(rb):
    """The port's FeatureBatch holding the same rows as a reference batch
    (strings decoded, geometries through exact WKT)."""
    cols = {}
    for a in rb.sft.attributes:
        col = rb.columns[a.name]
        if isinstance(col, RDict):
            cols[a.name] = col.decode()
        elif isinstance(col, RGeom):
            cols[a.name] = (np.stack([col.x, col.y], 1) if col.is_point else
                            [ref_to_wkt(col.geometry(i)) for i in range(len(col))])
        else:
            cols[a.name] = np.asarray(col)
    fids = rb.fids.decode() if rb.fids is not None else None
    return PFB.from_pydict(PSFT.from_spec(rb.sft.name, rb.sft.to_spec()), cols,
                           fids=fids)


def ring_m(d: float) -> float:
    return max(1.0, 1e-5 * d)


def ambiguous_rows(f, batch, dev, polygons: bool = True) -> np.ndarray:
    """Rows where a leaf of `f` is ambiguous between the packages (with
    `polygons` False, only its distance leaves)."""
    col = batch.columns["geom"]
    x, y = col.x, col.y
    out = np.zeros(len(batch), bool)
    for node in past.walk(f):
        g = getattr(node, "geometry", None)
        if g is None:
            continue
        if isinstance(node, past.DistancePredicate):
            if g.kind in ("Point", "MultiPoint") and sum(map(len, g.rings)) == 1:
                px, py = g.point
                dist = pgeo.haversine_m_np(x, y, px, py)
            else:
                dist = _dist_to_segments_np(x, y, g)
            out |= np.abs(dist - node.distance_m) <= ring_m(node.distance_m)
        if polygons and "Polygon" in g.kind:
            edges = [torch.from_numpy(e.astype(np.float32))
                     for e in polygon_edges(g)]
            out |= points_in_polygon_band(dev["geom__x"], dev["geom__y"],
                                          *edges).numpy()
    return out


@pytest.fixture(scope="module")
def batches():
    rb = make_batch(500)
    pb = port_batch(rb)
    devs = {k: (ref_to_device(rb, coord_dtype=j), port_to_device(pb, CPU, t))
            for k, (j, t) in DTYPES.items()}
    return rb, pb, devs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cql", PARITY_FILTERS)
def test_parity_filters(batches, cql, dtype):
    rb, pb, devs = batches
    rdev, pdev = devs[dtype]
    rf = ref_parse(cql)
    pf = port_compile(port_parse(cql), pb.sft)
    ref = np.asarray(ref_compile(rf, rb.sft).mask(rdev, rb))
    got = pf.mask(pdev, pb).numpy()
    amb = ambiguous_rows(port_parse(cql), pb, pdev)
    assert amb.sum() <= MAX_AMBIGUOUS, (cql, int(amb.sum()))
    np.testing.assert_array_equal(got[~amb], ref[~amb], err_msg=cql)
    # the band rows re-decided in f64: the reference's host evaluation
    exact = ref_host(rf, rb)
    fixed = got.copy()
    bidx, bexact = pf.band_corrections(pdev, pb)
    fixed[bidx] = bexact
    dist_amb = ambiguous_rows(port_parse(cql), pb, pdev, polygons=False)
    np.testing.assert_array_equal(fixed[~dist_amb], exact[~dist_amb], err_msg=cql)
    np.testing.assert_array_equal(port_host(port_parse(cql), pb), exact,
                                  err_msg=cql)


LITERAL_FILTERS = [
    "INTERSECTS(geom, POINT (1 2))",
    "INTERSECTS(geom, MULTIPOINT ((1 2), (3 4)))",
    "INTERSECTS(geom, LINESTRING (-40 -40, 40 40))",
    "EQUALS(geom, POINT (1 2))",
    "CONTAINS(geom, MULTIPOINT ((1 2), (3 4)))",
    "CONTAINS(geom, POLYGON ((-30 -30, 30 -30, 30 30, -30 30, -30 -30)))",
    "TOUCHES(geom, POLYGON ((-30 -30, 30 -30, 30 30, -30 30, -30 -30)))",
    "TOUCHES(geom, LINESTRING (-40 -40, 40 40))",
    "OVERLAPS(geom, POLYGON ((-30 -30, 30 -30, 30 30, -30 30, -30 -30)))",
    "CROSSES(geom, LINESTRING (-40 -40, 40 40))",
    "DWITHIN(geom, POLYGON ((-30 -30, 30 -30, 30 30, -30 30, -30 -30)), 300, kilometers)",
    "BEYOND(geom, LINESTRING (-40 -40, 40 40), 200, kilometers)",
    "DWITHIN(geom, MULTIPOINT ((1 2), (30 20)), 900, kilometers)",
    "DWITHIN(geom, POINT (1 2), 0, meters)",
]


@pytest.fixture(scope="module")
def on_points():
    """make_batch's rows plus rows exactly on the literals' points and on
    the line, so that the coincidence and on-line tests see hits."""
    rb = make_batch(500)
    geom = np.stack([rb.columns["geom"].x, rb.columns["geom"].y], 1)
    geom[:4] = [[1.0, 2.0], [3.0, 4.0], [1.0, 2.0], [30.0, 20.0]]
    t = np.linspace(0.05, 0.95, 20)
    geom[4:24] = np.stack([-40 + 80 * t, -40 + 80 * t], 1)
    rb = type(rb).from_pydict(rb.sft, {
        "name": rb.columns["name"].decode(), "age": rb.columns["age"],
        "score": rb.columns["score"], "dtg": rb.columns["dtg"], "geom": geom})
    pb = port_batch(rb)
    return rb, pb, {k: (ref_to_device(rb, coord_dtype=j),
                        port_to_device(pb, CPU, t)) for k, (j, t) in DTYPES.items()}


@pytest.mark.parametrize("cql", LITERAL_FILTERS)
def test_point_and_line_literals(on_points, cql):
    rb, pb, devs = on_points
    rf = ref_parse(cql)
    exact = ref_host(rf, rb)
    assert (port_host(port_parse(cql), pb) == exact).all(), cql
    for dtype, (rdev, pdev) in devs.items():
        ref = np.asarray(ref_compile(rf, rb.sft).mask(rdev, rb))
        got = port_compile(port_parse(cql), pb.sft).mask(pdev, pb).numpy()
        amb = ambiguous_rows(port_parse(cql), pb, pdev)
        assert amb.sum() <= MAX_AMBIGUOUS, (cql, dtype, int(amb.sum()))
        np.testing.assert_array_equal(got[~amb], ref[~amb], err_msg=(cql, dtype))
    if "POINT (1 2)" in cql and "EQUALS" in cql:
        assert exact[[0, 2]].all() and exact.sum() == 2


def test_point_to_segments_chunked_equals_one_chunk(monkeypatch):
    rng = np.random.default_rng(4)
    px = torch.from_numpy(rng.uniform(-60, 60, 3000).astype(np.float32))
    py = torch.from_numpy(rng.uniform(-60, 60, 3000).astype(np.float32))
    segs = [torch.from_numpy(rng.uniform(-50, 50, 77)) for _ in range(4)]
    monkeypatch.setattr(pgeo, "PAIR_BUDGET_BYTES", 1 << 40)
    whole = pgeo.point_to_segments_m(px, py, *segs)
    for budget in (1, 8 * 77 * 7, 8 * 77 * 1000):
        monkeypatch.setattr(pgeo, "PAIR_BUDGET_BYTES", budget)
        np.testing.assert_array_equal(
            pgeo.point_to_segments_m(px, py, *segs).numpy(), whole.numpy())
    assert whole.dtype == torch.float64
    np.testing.assert_allclose(
        whole.numpy(),
        pgeo.point_to_segments_m_np(px.numpy().astype(np.float64),
                                    py.numpy().astype(np.float64),
                                    *[s.numpy() for s in segs]),
        rtol=1e-6, atol=1e-3)


def test_latitude_band_is_exact():
    """within_segments_m == point_to_segments_m <= d, on rows packed
    around the band's edges (and NaN rows), in f32 and f64."""
    rng = np.random.default_rng(6)
    segs = [torch.from_numpy(a) for a in (np.array([-3.0, 2.0]), np.array([10.0, 12.5]),
                                          np.array([4.0, 5.0]), np.array([11.0, 14.0]))]
    d = 25_000.0
    reach = d / pgeo.DEG_M_LAT
    edge = np.concatenate([10.0 - reach + rng.uniform(-1e-3, 1e-3, 2000),
                           14.0 + reach + rng.uniform(-1e-3, 1e-3, 2000)])
    py = np.concatenate([edge, rng.uniform(5, 20, 2000), [np.nan]])
    px = rng.uniform(-4, 6, len(py))
    for dt in (torch.float32, torch.float64):
        x, y = torch.from_numpy(px).to(dt), torch.from_numpy(py).to(dt)
        got = pgeo.within_segments_m(x, y, *segs, d)
        want = pgeo.point_to_segments_m(x, y, *segs) <= d
        assert torch.equal(got, want) and 0 < int(got.sum()) < len(py)


def test_sql_st_dwithin_pushes_down(tmp_path):
    from geomesa_tpu.plan.datastore import DataStore as RDataStore
    from geomesa_tpu.sql.engine import SqlContext as RSql
    from geomesa_tpu_torch.plan import DataStore as PDataStore
    from geomesa_tpu_torch.sql import SqlContext as PSql

    rb = make_batch(500)
    RDataStore(str(tmp_path)).create_schema(rb.sft).write(rb)
    sql = ("SELECT name, age FROM t WHERE st_dwithin(geom, "
           "st_geomFromWKT('POINT (0 0)'), 2000000) ORDER BY age, name")
    r = RSql(RDataStore(str(tmp_path))).sql(sql)
    p = PSql(PDataStore(str(tmp_path), device="cpu")).sql(sql)
    assert p.kind == r.kind == "features"
    assert len(p.features) == len(r.features) > 0
    assert p.features.columns["name"].decode() == r.features.columns["name"].decode()
    np.testing.assert_array_equal(p.features.columns["age"], r.features.columns["age"])
    d = pgeo.haversine_m_np(rb.columns["geom"].x, rb.columns["geom"].y, 0.0, 0.0)
    assert len(p.features) == int((d <= 2_000_000).sum())


@pytest.mark.cuda
def test_distance_masks_on_the_card_match_cpu(on_points, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, pb, devs = on_points
    cpu = devs["f32"][1]
    gpu = port_to_device(pb, torch.device("cuda"))
    for cql in LITERAL_FILTERS + [c for c in PARITY_FILTERS if "geom" in c]:
        pf = port_compile(port_parse(cql), pb.sft)
        got = pf.mask(gpu, pb).cpu().numpy()
        amb = ambiguous_rows(port_parse(cql), pb, cpu)
        np.testing.assert_array_equal(got[~amb], pf.mask(cpu, pb).numpy()[~amb],
                                      err_msg=cql)
    x = torch.from_numpy(pb.columns["geom"].x.astype(np.float32))
    y = torch.from_numpy(pb.columns["geom"].y.astype(np.float32))
    segs = [torch.from_numpy(a) for a in polygon_edges(port_parse(
        "INTERSECTS(geom, LINESTRING (-40 -40, 40 40, 10 -30))").geometry)]
    dev = torch.device("cuda")
    want = pgeo.point_to_segments_m(x, y, *segs).numpy()
    monkeypatch.setattr(pgeo, "PAIR_BUDGET_BYTES", 4096)
    np.testing.assert_allclose(
        pgeo.point_to_segments_m(x.to(dev), y.to(dev),
                                 *(s.to(dev) for s in segs)).cpu().numpy(),
        want, rtol=1e-6, atol=1e-6)  # coslat is f32: the cos differs by ulps
