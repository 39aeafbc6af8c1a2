"""The port's partition schemes against the reference package's, on the
same seeded batches: Z2 (points), XZ2 (points and polygons), attribute
and composite hierarchies.

Held exactly: `partitions_for` (the per-row names, byte for byte, which
the port builds from the distinct names of `group`), `group`'s codes
against those names, `prune` for boxes and intervals (a None covering set
included), `to_config`, and `scheme_from_config` of the reference's
config.
"""

import numpy as np
import pytest

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql.extract import BBox as RBBox, Interval as RInterval
from geomesa_tpu.store import partition as rpart
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.cql.extract import BBox as PBBox, Interval as PInterval
from geomesa_tpu_torch.store import partition as ppart

T0 = 1_600_000_000_000
DAY = 86400_000
SPEC = "kind:String,dtg:Date,*geom:Point"
POLY_SPEC = "kind:String,*geom:Polygon"


def point_data(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    x[:8] = [-180, 180, 0, -90, 90, 45, -45, 179.99999]  # cell edges
    y[:8] = [-90, 90, 0, -45, 45, 22.5, -22.5, 89.9999]
    return {"kind": rng.choice(["a", "b", "c", None], n).tolist(),
            "dtg": rng.integers(T0, T0 + 4 * DAY, n),
            "geom": np.stack([x, y], 1)}


def poly_data(n=200, seed=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(-170, 170), rng.uniform(-80, 80)
        w, h = rng.uniform(0.01, 30, 2)
        out.append(f"POLYGON (({cx} {cy}, {cx + w} {cy}, {cx + w} {cy + h}, "
                   f"{cx} {cy + h}, {cx} {cy}))")
    return {"kind": rng.choice(["a", "b"], n).tolist(), "geom": out}


SCHEMES = {
    "z2": lambda m: m.Z2Scheme(bits=2),
    "z2_bits4": lambda m: m.Z2Scheme(bits=4),
    "xz2": lambda m: m.XZ2Scheme(g=2),
    "xz2_g4": lambda m: m.XZ2Scheme(g=4),
    "attribute": lambda m: m.AttributeScheme("kind"),
    "datetime_z2": lambda m: m.CompositeScheme(
        [m.DateTimeScheme("yyyy/MM/dd"), m.Z2Scheme(bits=2)]),
    "z2_attribute": lambda m: m.CompositeScheme(
        [m.Z2Scheme(bits=2), m.AttributeScheme("kind")]),
    "attribute_datetime": lambda m: m.CompositeScheme(
        [m.AttributeScheme("kind"), m.DateTimeScheme("yyyy/MM/dd")]),
}
POLY_SCHEMES = {"xz2": SCHEMES["xz2"], "xz2_g4": SCHEMES["xz2_g4"],
                "attribute": SCHEMES["attribute"],
                "attribute_xz2": lambda m: m.CompositeScheme(
                    [m.AttributeScheme("kind"), m.XZ2Scheme(g=2)])}

BOXES = [(-180, -90, 180, 90), (-10, -10, 10, 10), (100, 40, 120, 60),
         (-180, -90, -179, -89), (0, 0, 0, 0)]
INTERVALS = [(None, None), (T0, T0 + DAY), (T0 + DAY, T0 + 2 * DAY - 1)]


def batches(spec, data):
    return (RFB.from_pydict(RSFT.from_spec("t", spec), data),
            PFB.from_pydict(PSFT.from_spec("t", spec), data))


def assert_same_scheme(rs, ps, rb, pb):
    assert ps.to_config() == rs.to_config()
    assert ppart.scheme_from_config(rs.to_config()).to_config() == rs.to_config()
    ref = rs.partitions_for(rb)
    got = ps.partitions_for(pb)
    assert [s.encode() for s in got] == [s.encode() for s in ref]
    names, codes = ps.group(pb)
    assert names == sorted(set(ref))
    assert [names[c] for c in codes] == ref
    for bb in BOXES:
        for iv in INTERVALS:
            assert ps.prune(PBBox(*bb), PInterval(*iv)) == \
                rs.prune(RBBox(*bb), RInterval(*iv)), (bb, iv)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_point_schemes_equal(scheme):
    rb, pb = batches(SPEC, point_data())
    assert_same_scheme(SCHEMES[scheme](rpart), SCHEMES[scheme](ppart), rb, pb)


@pytest.mark.parametrize("scheme", sorted(POLY_SCHEMES))
def test_polygon_schemes_equal(scheme):
    rb, pb = batches(POLY_SPEC, poly_data())
    assert_same_scheme(POLY_SCHEMES[scheme](rpart), POLY_SCHEMES[scheme](ppart),
                       rb, pb)


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="unknown partition scheme"):
        ppart.scheme_from_config({"scheme": "s2"})
