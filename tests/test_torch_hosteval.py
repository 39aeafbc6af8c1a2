"""The port's f64 host evaluation (`cql/hosteval.py`) against the reference
package's, branch by branch: logic, comparisons (numeric, string,
property-property, literal first), BETWEEN, LIKE/ILIKE, IN, IS NULL,
the temporal operators, every spatial operator on a point column against
each literal kind, every spatial and distance operator on polygon, line
and multipoint columns, and DWITHIN/BEYOND on points against each
literal kind, over padded batches (padding never matches). Both are f64
NumPy with the same formulas, so the masks are identical.
"""

import numpy as np
import pytest

from test_cql import make_batch, make_poly_batch
from test_torch_distance import port_batch

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql import parse_cql as ref_parse
from geomesa_tpu.cql.hosteval import eval_filter_host as ref_host
from geomesa_tpu_torch.cql import parse_cql as port_parse
from geomesa_tpu_torch.cql.hosteval import eval_filter_host as port_host

POLY = "POLYGON ((-30 -30, 30 -30, 30 30, -30 30, -30 -30), (-5 -5, 5 -5, 5 5, -5 5, -5 -5))"
MPOLY = "MULTIPOLYGON (((2 2, 8 2, 8 8, 2 8, 2 2)), ((20 20, 30 20, 30 30, 20 30, 20 20)))"
LITERALS = {
    "point": "POINT (1 2)", "multipoint": "MULTIPOINT ((1 2), (3.5 3.5))",
    "line": "LINESTRING (-40 -40, 40 40)",
    "multiline": "MULTILINESTRING ((0 0, 10 5), (3 1, 3 9))",
    "polygon": POLY, "multipolygon": MPOLY,
}
SPATIAL_OPS = ["BBOX", "INTERSECTS", "WITHIN", "DISJOINT", "EQUALS", "CONTAINS",
               "OVERLAPS", "CROSSES", "TOUCHES"]

LOGIC = [
    "INCLUDE", "EXCLUDE", "NOT (age > 50 AND name = 'alpha')",
    "age > 50 OR score < -4", "17 < age", "age = score",
    "name >= 'beta'", "name BETWEEN 'alpha' AND 'beta'",
    "name NOT BETWEEN 'alpha' AND 'beta'", "score BETWEEN -1 AND 1",
    "age NOT BETWEEN 20 AND 80", "name LIKE 'g_mma'", "name ILIKE '%TA'",
    "name NOT LIKE 'a%'", "name IN ('alpha', 'delta')", "name NOT IN ('alpha')",
    "age IN (1, 2, 3, 50)", "age NOT IN (1, 2)", "name IS NULL",
    "name IS NOT NULL", "score IS NULL", "age IS NULL", "age IS NOT NULL",
    "dtg DURING 2020-06-05T00:00:00Z/2020-06-10T00:00:00Z",
    "dtg BEFORE 2020-06-05T00:00:00Z", "dtg AFTER 2020-06-20T12:00:00Z",
    "dtg TEQUALS 2020-06-05T00:00:00Z",
]
POINT_SPATIAL = [f"{op}(geom, {lit})" for op in SPATIAL_OPS[1:]
                 for lit in LITERALS.values()] + ["BBOX(geom, -20, -20, 20, 20)"]
POINT_DISTANCE = [f"{op}(geom, {lit}, {d}, kilometers)" for op, d in
                  (("DWITHIN", 900), ("BEYOND", 1500)) for lit in LITERALS.values()]


def on_literals(rb):
    """make_batch's rows with some moved onto the literals' points,
    lines and polygon boundaries."""
    geom = np.stack([rb.columns["geom"].x, rb.columns["geom"].y], 1)
    geom[:6] = [[1, 2], [3.5, 3.5], [-30, 0], [5, 1], [2, 2], [25, 30]]
    t = np.linspace(0.1, 0.9, 9)
    geom[6:15] = np.stack([-40 + 80 * t, -40 + 80 * t], 1)
    cols = {a.name: (rb.columns[a.name].decode() if a.type == "String"
                     else rb.columns[a.name]) for a in rb.sft.attributes}
    cols["geom"] = geom
    return RFB.from_pydict(rb.sft, cols)


@pytest.fixture(scope="module")
def points():
    rb = on_literals(make_batch(500))
    return rb.pad_to(512), port_batch(rb).pad_to(512)


@pytest.mark.parametrize("cql", LOGIC + POINT_SPATIAL + POINT_DISTANCE)
def test_point_column(points, cql):
    rb, pb = points
    got = port_host(port_parse(cql), pb)
    want = ref_host(ref_parse(cql), rb)
    np.testing.assert_array_equal(got, want, err_msg=cql)
    assert not got[500:].any()


def extended_batches():
    polys = make_poly_batch(40)
    lines = RFB.from_pydict(RSFT.from_spec("l", "name:String,*geom:MultiLineString"), {
        "name": [f"l{i}" for i in range(6)],
        "geom": ["LINESTRING (0 0, 10 5)", "LINESTRING (20 20, 30 25)",
                 "LINESTRING (1.2 2.2, 1.8 2.8)", "MULTILINESTRING ((3 1, 3 9), (4 4, 5 5))",
                 "LINESTRING (-40 -40, 40 40)", "LINESTRING (2 2, 8 2)"]})
    rng = np.random.default_rng(9)
    mps = ["MULTIPOINT (" + ", ".join(f"({float(x)!r} {float(y)!r})"
                                      for x, y in rng.uniform(-1, 9, (k, 2))) + ")"
           for k in rng.integers(1, 5, 12)]
    mps[0] = "MULTIPOINT ((1 2), (3.5 3.5))"
    mp = RFB.from_pydict(RSFT.from_spec("m", "name:String,*geom:MultiPoint"),
                         {"name": [f"m{i}" for i in range(12)], "geom": mps})
    return {"polygon": polys, "line": lines, "multipoint": mp}


@pytest.fixture(scope="module")
def extended():
    return {k: (rb.pad_to(64), port_batch(rb).pad_to(64))
            for k, rb in extended_batches().items()}


EXT_CASES = [f"{op}(geom, {lit})" for op in SPATIAL_OPS for lit in LITERALS.values()
             if op != "BBOX"] + ["BBOX(geom, 2, 2, 8, 8)"] + [
    f"{op}(geom, {lit}, 200, kilometers)" for op in ("DWITHIN", "BEYOND")
    for lit in LITERALS.values()]


@pytest.mark.parametrize("layer", ["polygon", "line", "multipoint"])
def test_extended_columns(extended, layer):
    rb, pb = extended[layer]
    hits = 0
    for cql in EXT_CASES:
        got = port_host(port_parse(cql), pb)
        np.testing.assert_array_equal(got, ref_host(ref_parse(cql), rb),
                                      err_msg=(layer, cql))
        assert not got[len(pb) - (64 - int(pb.valid.sum())):].any()
        hits += int(got.any())
    assert hits > len(EXT_CASES) // 3
