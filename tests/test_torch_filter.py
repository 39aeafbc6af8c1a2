"""The port's compiled filter (geomesa_tpu_torch.cql.compile) against the
reference package's, on one seeded batch that holds rows inside the f32
ulp band of every BBOX edge.

Both masks are taken raw (f32 coordinates on the device) and after the
band corrections are scattered in; both must be BIT-identical to the
reference's, and the corrected mask must equal the f64 host evaluation.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql import compile_filter as ref_compile, parse_cql as ref_parse
from geomesa_tpu.cql.ast import to_cql as ref_to_cql
from geomesa_tpu.cql.compile import f32_ulp_band as ref_band
from geomesa_tpu.cql.hosteval import eval_filter_host as ref_host
from geomesa_tpu.engine.device import to_device as ref_to_device
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.cql import compile_filter as port_compile, parse_cql as port_parse
from geomesa_tpu_torch.cql.ast import to_cql as port_to_cql
from geomesa_tpu_torch.cql.compile import f32_ulp_band as port_band
from geomesa_tpu_torch.engine.device import to_device as port_to_device

SPEC = "name:String,speed:Double,count:Integer,dtg:Date,*geom:Point"
T0 = 1_600_000_000_000
BOX = (-12.345678, 33.3, 7.1, 51.987654)


def _edge_values(rng, edge, n):
    """Values at and within a few f64 ulps .. f32 ulps of `edge`."""
    ulp32 = np.spacing(np.float32(edge)).astype(np.float64)
    off = np.concatenate([
        rng.uniform(-2, 2, n // 2) * ulp32,
        np.arange(-(n - n // 2) // 2, (n - n // 2) - (n - n // 2) // 2)
        * np.spacing(edge),
    ])
    return edge + off


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    n = 3000
    x = rng.uniform(-20, 15, n)
    y = rng.uniform(30, 55, n)
    # rows inside the f32 band of each of the four edges
    for j, edge in enumerate((BOX[0], BOX[2])):
        sl = slice(j * 200, (j + 1) * 200)
        x[sl] = _edge_values(rng, edge, 200)
    for j, edge in enumerate((BOX[1], BOX[3])):
        sl = slice(400 + j * 200, 400 + (j + 1) * 200)
        y[sl] = _edge_values(rng, edge, 200)
    names = rng.choice(["alpha", "beta", "gamma", None], n).tolist()
    cols = {
        "name": names,
        "speed": rng.uniform(0, 30, n),
        "count": rng.integers(0, 10, n).astype(np.int32),
        "dtg": rng.integers(T0, T0 + 10 * 86400_000, n),
        "geom": np.stack([x, y], 1),
    }
    rb = RFB.from_pydict(RSFT.from_spec("t", SPEC), cols).pad_to(4096)
    pb = PFB.from_pydict(PSFT.from_spec("t", SPEC), cols).pad_to(4096)
    return rb, ref_to_device(rb), pb, port_to_device(pb, torch.device("cpu"))


def _iso(ms):
    return str(np.datetime64(ms, "ms")) + "Z"


BBOX = f"BBOX(geom, {BOX[0]}, {BOX[1]}, {BOX[2]}, {BOX[3]})"
FILTERS = {
    "bbox": BBOX,
    "during": f"dtg DURING {_iso(T0 + 86400_000)}/{_iso(T0 + 5 * 86400_000)}",
    "gt": "speed > 5.0",
    "gt_int_literal": "speed > 5",
    "between": "speed BETWEEN 3.5 AND 17.25",
    "int_vs_fraction": "count >= 4.5",
    "and": f"{BBOX} AND dtg > {_iso(T0 + 86400_000)} AND speed > 5.0",
    "or": f"{BBOX} OR count = 3",
    "not": f"NOT ({BBOX})",
    "not_and_or": f"NOT (speed < 10 OR {BBOX}) AND count <> 2",
    "strings": "name = 'beta' OR name LIKE 'ga%' OR name IN ('alpha')",
    "is_null": "name IS NULL AND NOT speed BETWEEN 1 AND 2",
    "include": "INCLUDE",
}


def _corrected(compiled, dev, batch, mask):
    bidx, bexact = compiled.band_corrections(dev, batch)
    mask = np.array(mask)
    if len(bidx):
        mask[bidx] = bexact & batch.valid[bidx]
    return mask, bidx


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_mask_bit_identical_after_band(data, name):
    rb, rdev, pb, pdev = data
    cql = FILTERS[name]
    rf = ref_compile(ref_parse(cql), rb.sft)
    pf = port_compile(port_parse(cql), pb.sft)
    rmask = np.asarray(rf.mask(rdev, rb))
    pmask = pf.mask(pdev, pb).numpy()
    np.testing.assert_array_equal(pmask, rmask)
    assert pf.has_band == rf.has_band
    rfix, ridx = _corrected(rf, rdev, rb, rmask)
    pfix, pidx = _corrected(pf, pdev, pb, pmask)
    np.testing.assert_array_equal(pidx, ridx)
    np.testing.assert_array_equal(pfix, rfix)
    np.testing.assert_array_equal(pfix, ref_host(ref_parse(cql), rb))
    if "bbox" in name or "BBOX" in cql:
        assert pf.has_band and len(pidx) >= 800  # every edge row is flagged


def test_band_rows_really_flip(data):
    # the data does exercise the band: the f32 mask alone is wrong there
    rb, rdev, pb, pdev = data
    pf = port_compile(port_parse(BBOX), pb.sft)
    raw = pf.mask(pdev, pb).numpy()
    exact = ref_host(ref_parse(BBOX), rb)
    assert (raw != exact).any()


@pytest.mark.parametrize("bound", [0.0, 1.0, -12.345678, 179.99, 1e6])
def test_ulp_band_width(bound):
    assert port_band(bound) == ref_band(bound)


@pytest.mark.parametrize("cql", [
    "INTERSECTS(geom, POINT(0 0))",
    "TOUCHES(geom, POLYGON((0 0, 1 0, 1 1, 0 0)))",
    "DWITHIN(geom, POINT(0 0), 10, kilometers)",
])
def test_later_slice_predicates_raise_typed(data, cql):
    """Predicates an earlier slice refused (point literals, TOUCHES on a
    point column, DWITHIN) now compile: raw mask == the reference's ==
    its f64 host evaluation."""
    rb, rdev, pb, pdev = data
    got = port_compile(port_parse(cql), pb.sft).mask(pdev, pb).numpy()
    ref = np.asarray(ref_compile(ref_parse(cql), rb.sft).mask(rdev, rb))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ref_host(ref_parse(cql), rb))


def test_parser_copies_agree():
    for cql in FILTERS.values():
        assert port_to_cql(port_parse(cql)) == ref_to_cql(ref_parse(cql))
