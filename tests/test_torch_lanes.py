"""The port's geofence lanes (`geomesa_tpu_torch.engine.lanes`) on the CPU.

The same seeded points and geofences go through each lane of both
packages and through the port's compiled filter:

- every lane row equals the port's compiled mask (and band) of the same
  predicate bit for bit, padded delta and all;
- against the reference's lanes the masks are equal outside the f32
  ambiguity band (either package's) and outside the DWITHIN ring, the
  rows whose f64 distance lies within max(1 m, 1e-5 d) of the radius:
  the reference takes the centre's radians in f32, the port in f64 as
  its compiled filter does. The ring and band rows are counted and
  bounded;
- inactive rows, invalid (pad) points and pad edges change nothing;
- `lane_polygon` in blocks (a small `LANE_BUDGET_BYTES`) equals one block.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql import parse_cql as rparse
from geomesa_tpu.engine import lanes as rlanes
from geomesa_tpu.subscribe import lanes as rsub
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.cql import compile_filter, parse_cql
from geomesa_tpu_torch.engine import lanes as planes
from geomesa_tpu_torch.engine.device import VALID, to_device
from geomesa_tpu_torch.engine.geodesy import haversine_m_np
from geomesa_tpu_torch.subscribe import lanes as psub

SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
CPU = torch.device("cpu")
N_REAL = 1000  # padded to 1024 rows, the last 24 invalid
MAX_AMBIGUOUS = 120  # band and ring rows of one class (96 placed on edges)


def star(cx, cy, n, seed, r0=4.0, r1=9.0):
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(r0, r1, n)
    pts = [(cx + a * np.cos(t), cy + a * np.sin(t)) for a, t in zip(r, ang)]
    pts.append(pts[0])
    return "POLYGON((" + ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in pts) + "))"


CLASSES = {
    "bbox": ["BBOX(geom, -20, -15, 25, 20)", "BBOX(geom, -50.5, -25.25, -10, 5)",
             "BBOX(geom, 0.1, 0.1, 0.3, 0.3)"],
    "dwithin": ["DWITHIN(geom, POINT(10 5), 2000000, meters)",
                "DWITHIN(geom, POINT(-30.123 -10.5), 1500000, meters)",
                "DWITHIN(geom, POINT(44.9 25.7), 500000, meters)"],
    "polygon": [f"INTERSECTS(geom, {star(0, 0, 16, 1)})",
                f"WITHIN(geom, {star(-30, 10, 40, 2, 8, 20)})",
                "INTERSECTS(geom, POLYGON((-40 -20, 10 -25, 30 15, -25 22, -40 -20)))"],
}


def points():
    """N_REAL seeded rows: uniform ones plus rows on the literals' edges,
    vertices and rings, where the f32 bands and the ring matter."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-60, 60, N_REAL)
    y = rng.uniform(-30, 30, N_REAL)
    k = 0
    for v in (-20, 25, -50.5, -10, 0.1, 0.3):  # on the boxes' x edges
        x[k:k + 8] = v
        k += 8
    for v in (-15, 20, -25.25, 5):  # on their y edges
        y[k:k + 8] = v
        k += 8
    # on the 2,000 km ring around (10, 5): a degree of latitude is
    # ~111.195 km, so these lie within ~1 m of the radius
    y[k:k + 16] = 5 + 2_000_000 / 111_194.9 * rng.choice([1, -1], 16)
    x[k:k + 16] = 10
    k += 16
    # on the small box's edges and inside it
    x[k:k + 8] = [0.1, 0.3, 0.2, 0.2, 0.15, 0.25, 0.1, 0.3]
    y[k:k + 8] = [0.2, 0.2, 0.1, 0.3, 0.15, 0.25, 0.1, 0.3]
    k += 8
    # on the quadrilateral's vertices and edge midpoints
    x[k:k + 8] = [-40, 10, 30, -25, -15, 20, 2.5, -32.5]
    y[k:k + 8] = [-20, -25, 15, 22, -22.5, -5, 18.5, 1]
    return x, y


@pytest.fixture(scope="module")
def data():
    x, y = points()
    rng = np.random.default_rng(8)
    cols = {"name": rng.choice(["a", "b"], N_REAL).tolist(),
            "score": rng.uniform(-5, 5, N_REAL),
            "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, N_REAL),
            "geom": np.stack([x, y], 1)}
    psft, rsft = PSFT.from_spec("live", SPEC), RSFT.from_spec("live", SPEC)
    pb = PFB.from_pydict(psft, cols).pad_to(1024)
    rb = RFB.from_pydict(rsft, cols).pad_to(1024)
    dev = to_device(pb, CPU)
    return psft, rsft, pb, rb, dev


def port_group(cls, cqls, sft, ebucket=0):
    g = psub.LaneGroup(cls, ebucket=ebucket)
    for i, cql in enumerate(cqls):
        spec, why = psub.classify(parse_cql(cql), sft)
        assert spec is not None and spec.cls == cls, why
        g.assign(f"s{i}", spec)
    return g


def port_lane(cls, group, dev):
    fn = getattr(planes, f"lane_{cls}")
    m, b = fn(torch.from_numpy(group.params), torch.from_numpy(group.active),
              dev["geom__x"], dev["geom__y"], dev[VALID])
    return m.numpy(), b.numpy()


def ebucket(cqls, sft):
    return max(psub.next_pow2(max(psub.classify(parse_cql(c), sft)[0].edges.shape[1],
                                  8)) for c in cqls)


@pytest.mark.parametrize("cls", list(CLASSES))
def test_lane_rows_equal_compiled_masks(data, cls):
    """Each lane row == the port's compiled mask and band, bit for bit."""
    psft, _, pb, _, dev = data
    cqls = CLASSES[cls]
    eb = ebucket(cqls, psft) if cls == "polygon" else 0
    group = port_group(cls, cqls, psft, eb)
    mask, band = port_lane(cls, group, dev)
    assert mask.shape == (group.cap, 1024)
    for i, cql in enumerate(cqls):
        f = compile_filter(parse_cql(cql), psft)
        np.testing.assert_array_equal(mask[i], f.mask(dev, pb).numpy(), err_msg=cql)
        want = f.band(dev, pb).numpy() if f.has_band else np.zeros(1024, bool)
        np.testing.assert_array_equal(band[i], want, err_msg=cql)
    assert mask.any(axis=1)[:len(cqls)].all()
    if cls != "dwithin":
        assert band[:len(cqls)].any(), "the edge rows must reach the band"


@pytest.mark.parametrize("cls", list(CLASSES))
def test_lanes_equal_reference_outside_band_and_ring(data, cls):
    psft, rsft, _, rb, dev = data
    cqls = CLASSES[cls]
    eb = ebucket(cqls, psft) if cls == "polygon" else 0
    mask, band = port_lane(cls, port_group(cls, cqls, psft, eb), dev)
    rg = rsub.LaneGroup(cls, ebucket=eb)
    for i, cql in enumerate(cqls):
        spec, _ = rsub.classify(rparse(cql), rsft)
        rg.assign(f"s{i}", spec)
    from geomesa_tpu.engine.device import VALID as RVALID, to_device as rdev

    r = rdev(rb)
    rmask, rband = (np.asarray(a) for a in getattr(rlanes, f"lane_{cls}")(
        rg.params, rg.active, r["geom__x"], r["geom__y"], r[RVALID]))
    col = rb.columns["geom"]
    amb_total = 0
    for i, cql in enumerate(cqls):
        amb = band[i] | rband[i]
        if cls == "dwithin":
            g = parse_cql(cql)
            d = float(g.distance_m)
            dist = haversine_m_np(col.x, col.y, *g.geometry.point)
            amb = amb | (np.abs(dist - d) <= max(1.0, 1e-5 * d))
        amb_total += int(amb.sum())
        np.testing.assert_array_equal(mask[i][~amb], rmask[i][~amb], err_msg=cql)
    assert amb_total <= MAX_AMBIGUOUS, amb_total
    if cls == "dwithin":
        assert amb_total >= 16, "the ring rows must be counted"


@pytest.mark.parametrize("cls", list(CLASSES))
def test_padding_changes_nothing(data, cls):
    """Inactive rows are all False, pad points are False, and a polygon
    in a wider E-bucket (more pad edges) gives the same rows."""
    psft, _, _, _, dev = data
    cqls = CLASSES[cls]
    eb = ebucket(cqls, psft) if cls == "polygon" else 0
    group = port_group(cls, cqls, psft, eb)
    mask, band = port_lane(cls, group, dev)
    assert not mask[len(cqls):].any() and not band[len(cqls):].any()
    assert not mask[:, N_REAL:].any() and not band[:, N_REAL:].any()
    group.release("s1")  # a released row reads False, the others keep theirs
    m2, b2 = port_lane(cls, group, dev)
    assert not m2[1].any() and not b2[1].any()
    keep = [0] + list(range(2, len(cqls)))
    np.testing.assert_array_equal(m2[keep], mask[keep])
    if cls == "polygon":
        wide = port_group(cls, cqls, psft, eb * 4)
        mw, bw = port_lane(cls, wide, dev)
        np.testing.assert_array_equal(mw, mask)
        np.testing.assert_array_equal(bw, band)


@pytest.mark.parametrize("budget", [4 * 64 * 1024, 4 * 64 * 100, 1])
def test_polygon_blocks_equal_one_block(data, budget, monkeypatch):
    psft, _, _, _, dev = data
    cqls = CLASSES["polygon"]
    group = port_group("polygon", cqls, psft, ebucket(cqls, psft))
    whole = port_lane("polygon", group, dev)
    monkeypatch.setattr(planes, "LANE_BUDGET_BYTES", budget)
    blocked = port_lane("polygon", group, dev)
    for a, b in zip(whole, blocked):
        np.testing.assert_array_equal(a, b)


def test_classify_reasons_match_the_reference(data):
    psft, rsft, _, _, _ = data
    cqls = ["name = 'a'", "BBOX(geom, 0, 0, 1, 1) AND score > 0",
            "NOT BBOX(geom, 0, 0, 1, 1)", "BEYOND(geom, POINT(0 0), 10, meters)",
            "INTERSECTS(geom, LINESTRING(0 0, 1 1))",
            "DWITHIN(geom, LINESTRING(0 0, 1 1), 10, meters)",
            "DISJOINT(geom, POLYGON((0 0, 1 0, 1 1, 0 0)))"] + \
        [c for v in CLASSES.values() for c in v]
    for cql in cqls:
        ps, pwhy = psub.classify(parse_cql(cql), psft)
        rs, rwhy = rsub.classify(rparse(cql), rsft)
        assert pwhy == rwhy, cql
        assert (ps is None) == (rs is None), cql
        if ps is not None and ps.cls != "dwithin":
            a = ps.params if ps.cls == "bbox" else ps.edges
            b = rs.params if rs.cls == "bbox" else rs.edges
            np.testing.assert_array_equal(a, b, err_msg=cql)
