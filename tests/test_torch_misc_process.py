"""The port's remaining vector processes (`process/misc.py`) against the
reference package's, on one catalog the reference writes and on the
same seeded batches.

Held exactly: the returned rows (every column; geometry by its CSR
arrays), the stats, the unique counts and the hashes. ProximitySearch
runs the f64 haversine of both packages' `knn`; its rows are held equal
(no row of this data lies within a nanometre of the distance). Arrow and
BIN conversion return the reference's bytes.
"""

import numpy as np
import pytest

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan import DataStore as RDataStore
from geomesa_tpu.process import misc as rmisc
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.plan import DataStore as PDataStore
from geomesa_tpu_torch.process import misc as pmisc

SPEC = "vessel:String,heading:Double,n:Integer,dtg:Date,*geom:Point"
T0 = 1_600_000_000_000
HOUR = 3600_000
N = 3000


def data(n=N, seed=23):
    rng = np.random.default_rng(seed)
    return {"vessel": rng.choice(["v1", "v2", "v3", "v4", None], n).tolist(),
            "heading": rng.uniform(0, 360, n),
            "n": rng.integers(0, 50, n).astype(np.int32),
            "dtg": T0 + rng.integers(0, 48 * HOUR, n),
            "geom": np.stack([rng.uniform(-5, 5, n), rng.uniform(50, 56, n)], 1)}


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_misc_process"))
    cols = data()
    RDataStore(root).create_schema(RSFT.from_spec("ais", SPEC)).write(
        RFB.from_pydict(RSFT.from_spec("ais", SPEC), cols))
    return {"ref": RDataStore(root, use_device_cache=True).get_feature_source("ais"),
            "port": PDataStore(root, use_device_cache=True,
                               device="cpu").get_feature_source("ais"),
            "rb": RFB.from_pydict(RSFT.from_spec("ais", SPEC), cols),
            "pb": PFB.from_pydict(PSFT.from_spec("ais", SPEC), cols)}


def values(c):
    if hasattr(c, "vocab"):
        return c.decode()
    if hasattr(c, "x"):
        if c.vertices is None:
            return (np.asarray(c.x).tolist(), np.asarray(c.y).tolist())
        return (c.kind, c.vertices.tolist(), c.ring_offsets.tolist(),
                c.feature_rings.tolist(), c.feature_parts)
    return np.asarray(c).tolist()


def assert_same_batch(r, p):
    if r is None:
        assert p is None
        return
    assert p.sft.to_spec() == r.sft.to_spec()
    assert len(p) == len(r)
    for k, c in r.columns.items():
        assert values(p.columns[k]) == values(c), k


def queries(which):
    pts = np.array([[0.0, 53.0], [2.5, 51.0], [-4.0, 55.5]])
    spec = "*geom:Point"
    return (RFB.from_pydict(RSFT.from_spec("q", spec), {"geom": pts}) if which == "ref"
            else PFB.from_pydict(PSFT.from_spec("q", spec), {"geom": pts}))


@pytest.mark.parametrize("over", ["source", "batch"])
@pytest.mark.parametrize("cql", ["INCLUDE", "n > 25"])
def test_proximity_search_equal(cat, over, cql):
    rdata = cat["ref"] if over == "source" else cat["rb"]
    pdata = cat["port"] if over == "source" else cat["pb"]
    r = rmisc.ProximitySearchProcess().execute(queries("ref"), rdata, 40_000.0, cql)
    p = pmisc.ProximitySearchProcess().execute(queries("port"), pdata, 40_000.0,
                                               cql, device="cpu")
    assert 0 < len(p) < N
    assert_same_batch(r, p)


@pytest.mark.parametrize("cql", ["INCLUDE", "vessel = 'v2' AND heading < 90"])
def test_query_sampling_unique_equal(cat, cql):
    assert_same_batch(rmisc.QueryProcess().execute(cat["ref"], cql),
                      pmisc.QueryProcess().execute(cat["port"], cql))
    assert_same_batch(rmisc.SamplingProcess().execute(cat["ref"], 7, cql),
                      pmisc.SamplingProcess().execute(cat["port"], 7, cql))
    assert pmisc.UniqueProcess().execute(cat["port"], "vessel", cql) == \
        rmisc.UniqueProcess().execute(cat["ref"], "vessel", cql)


def test_join_point2point_dateoffset_hash_equal(cat):
    rng = np.random.default_rng(5)
    right = {"vessel": ["v1", "v3", "v4", "v9"], "flag": ["NL", "DE", "GB", "FR"],
             "len": rng.uniform(20, 300, 4),
             "geom": rng.uniform(0, 1, (4, 2))}
    rspec = "vessel:String,flag:String,len:Double,*geom:Point"
    rr = RFB.from_pydict(RSFT.from_spec("ships", rspec), right)
    pr = PFB.from_pydict(PSFT.from_spec("ships", rspec), right)
    assert_same_batch(
        rmisc.JoinProcess().execute(cat["rb"], rr, "vessel", "vessel"),
        pmisc.JoinProcess().execute(cat["pb"], pr, "vessel", "vessel"))
    assert_same_batch(
        rmisc.JoinProcess().execute(cat["rb"], rr, "vessel", "vessel", ["len"]),
        pmisc.JoinProcess().execute(cat["pb"], pr, "vessel", "vessel", ["len"]))
    assert_same_batch(rmisc.Point2PointProcess().execute(cat["rb"], "vessel"),
                      pmisc.Point2PointProcess().execute(cat["pb"], "vessel"))
    assert_same_batch(
        rmisc.DateOffsetProcess().execute(cat["rb"], "dtg", -HOUR),
        pmisc.DateOffsetProcess().execute(cat["pb"], "dtg", -HOUR))
    for attr in ("vessel", "n"):
        assert_same_batch(
            rmisc.HashAttributeProcess().execute(cat["rb"], attr, 97),
            pmisc.HashAttributeProcess().execute(cat["pb"], attr, 97))


@pytest.mark.parametrize("bidirectional", [False, True])
def test_route_search_equal(cat, bidirectional):
    route = "LINESTRING (-4 51, 0 53, 4 55.5)"
    kw = dict(buffer_m=30_000.0, heading_attr="heading",
              heading_tolerance_deg=40.0, bidirectional=bidirectional)
    r = rmisc.RouteSearchProcess().execute(cat["rb"], route, **kw)
    p = pmisc.RouteSearchProcess().execute(cat["pb"], route, **kw)
    assert len(p) > 0
    assert_same_batch(r, p)


def test_codec_processes_raise_typed(cat):
    """The codec processes (refused by an earlier slice) return the
    reference's bytes: Arrow IPC and BIN records, filtered and not."""
    for cql in ("INCLUDE", "heading > 180 AND BBOX(geom, -3, 51, 3, 55)",
                "heading > 1000"):
        p = pmisc.ArrowConversionProcess().execute(cat["port"], cql)
        assert p == rmisc.ArrowConversionProcess().execute(cat["ref"], cql), cql
        assert (p == b"") == (cql == "heading > 1000")
        p = pmisc.BinConversionProcess().execute(cat["port"], "vessel", cql)
        assert p == rmisc.BinConversionProcess().execute(cat["ref"], "vessel", cql), cql
        assert len(p) % 16 == 0 and (len(p) == 0) == (cql == "heading > 1000")
