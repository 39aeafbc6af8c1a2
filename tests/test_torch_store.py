"""Store state carried across: the port's Parquet store, partition schemes
and device batches against the reference package's.

A catalog written by either package loads in the other with the same
manifest, partitions, rows and `stats.json` (parsed), for a point layer
under the date scheme and for polygon and point layers under the Z2,
XZ2, attribute and composite schemes; both packages write the same rows
to the same partitions; the port's vectorised partition names are
byte-identical to the reference's per-row formatter; and the reference's
device batch (a polygon layer's CSR and edge-table keys included)
converts to the port's with the same keys and dtypes.
"""

import json
import os

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql.extract import BBox as RBBox, Interval as RInterval
from geomesa_tpu.engine.device import to_device as ref_to_device
from geomesa_tpu.plan import DataStore as RDataStore
from geomesa_tpu.store.fs import FileSystemStorage as RStorage
from geomesa_tpu.store import partition as rpart
from geomesa_tpu.store.partition import DateTimeScheme as RScheme
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.cql.extract import BBox as PBBox, Interval as PInterval
from geomesa_tpu_torch.engine.device import to_device as port_to_device
from geomesa_tpu_torch.interop import device_batch_from_numpy, feature_batch_from
from geomesa_tpu_torch.plan import DataStore as PDataStore
from geomesa_tpu_torch.store import partition
from geomesa_tpu_torch.store.fs import FileSystemStorage as PStorage
from geomesa_tpu_torch.store.partition import DateTimeScheme as PScheme

SPEC = "name:String,speed:Double,count:Integer,dtg:Date,*geom:Point"
T0 = 1_600_000_000_000
DAY = 86400_000


def columns(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "name": rng.choice(["a", "b", "c", None], n).tolist(),
        "speed": rng.uniform(0, 30, n),
        "count": rng.integers(0, 10, n).astype(np.int32),
        "dtg": rng.integers(T0, T0 + 3 * DAY, n),
        "geom": np.stack([rng.uniform(-20, 20, n), rng.uniform(30, 60, n)], 1),
    }


POLY_SPEC = "name:String,*geom:Polygon"
PT_SPEC = "name:String,speed:Double,*geom:Point"


def polygon_columns(n, seed):
    """n polygons over the globe, every third with a hole given in the
    shell's own winding (the edge table flips it)."""
    rng = np.random.default_rng(seed)
    geoms = []
    for i in range(n):
        cx, cy = rng.uniform(-170, 170), rng.uniform(-80, 80)
        r = rng.uniform(0.1, 8.0)
        th = np.sort(rng.uniform(0, 2 * np.pi, 9))
        shell = np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1)
        rings = [np.concatenate([shell, shell[:1]])]
        if i % 3 == 0:
            rings.append([cx, cy] + (rings[0] - [cx, cy]) * 0.3)
        body = ", ".join("(" + ", ".join(f"{x!r} {y!r}" for x, y in rg.tolist()) + ")"
                         for rg in rings)
        geoms.append(f"POLYGON ({body})")
    return {"name": rng.choice(["a", "b", None], n).tolist(), "geom": geoms}


def point_columns(n, seed):
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(["a", "b", "c", None], n).tolist(),
            "speed": rng.uniform(0, 30, n),
            "geom": np.stack([rng.uniform(-180, 180, n),
                              rng.uniform(-90, 90, n)], 1)}


# (spec, columns, scheme maker or None for the create_schema default)
LAYOUTS = {
    "datetime": (SPEC, columns, None),
    "polygons_xz2": (POLY_SPEC, polygon_columns, None),
    "points_z2": (PT_SPEC, point_columns, None),
    "polygons_attribute": (POLY_SPEC, polygon_columns,
                           lambda m: m.AttributeScheme("name")),
    "points_composite": (PT_SPEC, point_columns, lambda m: m.CompositeScheme(
        [m.AttributeScheme("name"), m.Z2Scheme(bits=2)])),
}


def write_layout(root, writer, layout, n=600):
    spec, cols, scheme = LAYOUTS[layout]
    mods = ((RDataStore, RSFT, RFB, rpart) if writer == "reference"
            else (lambda c: PDataStore(c, device="cpu"), PSFT, PFB, partition))
    ds_of, sft_of, fb_of, part = mods
    src = ds_of(root).create_schema(
        sft_of.from_spec(layout, spec),
        **({"scheme": scheme(part)} if scheme is not None else {}))
    src.write(fb_of.from_pydict(src.sft, cols(n, 1)))
    src.write(fb_of.from_pydict(src.sft, cols(n // 7, 2)))
    return os.path.join(root, layout)


def stats_json(path):
    with open(os.path.join(path, "stats.json")) as f:
        return json.load(f)


def column_values(c):
    if hasattr(c, "x"):
        if c.vertices is None:
            return (np.asarray(c.x).tolist(), np.asarray(c.y).tolist())
        return (c.vertices.tolist(), c.ring_offsets.tolist(),
                c.feature_rings.tolist(), c.bbox.tolist(), c.kind)
    return c.decode() if hasattr(c, "decode") else np.asarray(c).tolist()


def rows_of(storage):
    """All rows of a storage, per partition, in file order."""
    out = {}
    for name in storage.partitions():
        batches = list(storage.scan_partitions([name]))
        cols = {}
        for b in batches:
            for k, c in b.columns.items():
                cols.setdefault(k, []).append(column_values(c))
        out[name] = cols
    return out


def manifest_shape(storage):
    return {name: sorted(e["count"] for e in entries)
            for name, entries in storage.manifest_snapshot().items()}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_catalog_loads_across_packages(tmp_path, writer):
    root = str(tmp_path / "cat")
    if writer == "reference":
        src = RDataStore(root).create_schema(RSFT.from_spec("t", SPEC))
        src.write(RFB.from_pydict(src.sft, columns(5000, 1)))
        src.write(RFB.from_pydict(src.sft, columns(700, 2)))
    else:
        src = PDataStore(root, device="cpu").create_schema(PSFT.from_spec("t", SPEC))
        src.write(PFB.from_pydict(src.sft, columns(5000, 1)))
        src.write(PFB.from_pydict(src.sft, columns(700, 2)))
    path = os.path.join(root, "t")
    ref, port = RStorage.load(path), PStorage.load(path)
    assert port.manifest == ref.manifest
    assert port.partitions() == ref.partitions() and len(port.partitions()) >= 3
    assert port.count == ref.count == 5700
    assert port.sft.to_spec() == ref.sft.to_spec()
    assert manifest_shape(port) == manifest_shape(ref)
    assert rows_of(port) == rows_of(ref)
    # the other layouts: polygon and point layers under the spatial,
    # attribute and composite schemes, each with its stats.json
    for layout in LAYOUTS:
        lp = write_layout(root, writer, layout)
        lr, lpt = RStorage.load(lp), PStorage.load(lp)
        assert lpt.scheme.to_config() == lr.scheme.to_config(), layout
        assert lpt.manifest == lr.manifest and len(lr.partitions()) >= 2, layout
        assert rows_of(lpt) == rows_of(lr), layout
        assert lpt.count == lr.count, layout
        bb, iv = RBBox(-30.0, -20.0, 40.0, 50.0), RInterval(None, None)
        assert lpt.prune_partitions(PBBox(-30.0, -20.0, 40.0, 50.0),
                                    PInterval(None, None)) == \
            lr.prune_partitions(bb, iv), layout
        sj = stats_json(lp)
        rds = RDataStore(root).get_feature_source(layout)
        pds = PDataStore(root, device="cpu").get_feature_source(layout)
        assert pds.planner.stats_manager().count == \
            rds.planner.stats_manager().count == lr.count, layout
        assert stats_json(lp) == sj, layout  # loading rewrote nothing
        for cql in ("INCLUDE", "BBOX(geom, -30, -20, 40, 50)", "name = 'a'"):
            assert pds.get_count(cql) == rds.get_count(cql), (layout, cql)
    # pushed-down scans return the same covering rows
    bb, iv = (-5.0, 35.0, 5.0, 50.0), (T0 + DAY // 2, T0 + 2 * DAY)
    rs = [b for b in ref.scan(RBBox(*bb), RInterval(*iv))]
    ps = [b for b in port.scan(PBBox(*bb), PInterval(*iv))]
    assert sum(map(len, rs)) == sum(map(len, ps)) > 0
    np.testing.assert_array_equal(
        np.concatenate([b.columns["speed"] for b in ps]),
        np.concatenate([b.columns["speed"] for b in rs]))


def test_same_files_written_for_same_rows(tmp_path):
    # the two packages write the same rows, in the same order, per partition
    cols = columns(4000, 3)
    r = RStorage.create(str(tmp_path / "r"), RSFT.from_spec("t", SPEC), RScheme())
    p = PStorage.create(str(tmp_path / "p"), PSFT.from_spec("t", SPEC), PScheme())
    r.write(RFB.from_pydict(r.sft, cols))
    p.write(PFB.from_pydict(p.sft, cols))
    assert manifest_shape(p) == manifest_shape(r)
    assert rows_of(p) == rows_of(r)
    # and under every other scheme, polygon layers as WKT text included
    for layout in list(LAYOUTS)[1:]:
        spec, make, scheme = LAYOUTS[layout]
        scheme = scheme or (lambda m: m.XZ2Scheme(g=2) if "Polygon" in spec
                            else m.Z2Scheme(bits=2))
        data = make(900, 4)
        r = RStorage.create(str(tmp_path / f"r_{layout}"),
                            RSFT.from_spec("t", spec), scheme(rpart))
        p = PStorage.create(str(tmp_path / f"p_{layout}"),
                            PSFT.from_spec("t", spec), scheme(partition))
        r.write(RFB.from_pydict(r.sft, data))
        p.write(PFB.from_pydict(p.sft, data))
        assert manifest_shape(p) == manifest_shape(r), layout
        assert rows_of(p) == rows_of(r), layout
        for name in r.partitions():
            (re_,), (pe,) = r.manifest[name], p.manifest[name]
            rt = pq.read_table(os.path.join(r.root, name, re_["file"]))
            pt = pq.read_table(os.path.join(p.root, name, pe["file"]))
            assert pt.schema.names == rt.schema.names, layout
            assert pt.equals(rt), (layout, name)


@pytest.mark.parametrize("grouping", ["lookup", "sort"])
@pytest.mark.parametrize("pattern", ["yyyy", "yyyy/MM", "yyyy/MM/dd",
                                     "yyyy/MM/dd/HH", "yyyy/DDD"])
def test_partition_names_byte_identical(pattern, grouping, monkeypatch):
    if grouping == "sort":  # bucket spans too wide for the lookup table
        monkeypatch.setattr(partition, "_LUT_SPAN", 1)
    rng = np.random.default_rng(len(pattern))
    edges = np.array([0, -1, 1, 86400_000 - 1, 86400_000, -86400_000,
                      951_782_400_000 - 1, 951_782_400_000,  # 2000-02-29
                      T0, T0 - 1, 4_102_444_800_000 - 1], np.int64)
    millis = np.concatenate([
        edges, rng.integers(-2_000_000_000_000, 4_000_000_000_000, 3000)])
    ref = RScheme(pattern)._format(millis)
    port = PScheme(pattern)
    b = PFB.from_pydict(PSFT.from_spec("t", "dtg:Date"), {"dtg": millis})
    got = port.partitions_for(b)
    assert [s.encode() for s in got] == [s.encode() for s in ref]
    iv = (int(millis.min()), int(millis.min()) + 40 * DAY)
    assert port.prune(PBBox(-180, -90, 180, 90), PInterval(*iv)) == \
        RScheme(pattern).prune(RBBox(-180, -90, 180, 90), RInterval(*iv))


def test_partition_codes_group_rows():
    millis = np.array([T0 + 2 * DAY, T0, T0 + 5, T0 + 2 * DAY + 1], np.int64)
    names, codes = PScheme().partition_codes(millis)
    assert names == sorted(set(names)) and len(names) == 2
    assert codes.tolist() == [1, 0, 0, 1]


def test_device_batch_round_trip():
    rb = RFB.from_pydict(RSFT.from_spec("t", SPEC), columns(1000, 4)).pad_to(1024)
    pb = PFB.from_pydict(PSFT.from_spec("t", SPEC), columns(1000, 4)).pad_to(1024)
    ref = {k: np.asarray(v) for k, v in ref_to_device(rb).items()}
    carried = device_batch_from_numpy(ref, "cpu")
    own = port_to_device(pb, torch.device("cpu"))
    assert carried.keys() == own.keys() == ref.keys()
    for k in ref:
        assert carried[k].numpy().dtype == ref[k].dtype == own[k].numpy().dtype, k
        np.testing.assert_array_equal(carried[k].numpy(), ref[k])
        np.testing.assert_array_equal(own[k].numpy(), ref[k])


def test_polygon_device_batch_round_trip():
    """A polygon layer's device batch: the CSR and edge-table keys too."""
    data = polygon_columns(40, 5)
    rb = RFB.from_pydict(RSFT.from_spec("t", POLY_SPEC), data).pad_to(64)
    pb = PFB.from_pydict(PSFT.from_spec("t", POLY_SPEC), data).pad_to(64)
    ref = {k: np.asarray(v) for k, v in ref_to_device(rb).items()}
    own = port_to_device(pb, torch.device("cpu"))
    assert own.keys() == ref.keys() and "geom__efeat" in ref
    for k in ref:
        assert own[k].numpy().dtype == ref[k].dtype, k
        np.testing.assert_array_equal(own[k].numpy(), ref[k])
    carried = feature_batch_from(rb)
    assert carried.sft.to_spec() == pb.sft.to_spec()
    for k in ("x", "y", "vertices", "ring_offsets", "feature_rings", "bbox"):
        np.testing.assert_array_equal(getattr(carried.columns["geom"], k),
                                      getattr(pb.columns["geom"], k))
    assert carried.columns["name"].decode() == pb.columns["name"].decode()
    np.testing.assert_array_equal(carried.valid, pb.valid)


@pytest.mark.parametrize("scheme", ["z2", "xz2", "attribute", "composite"])
def test_other_schemes_match_reference(tmp_path, scheme):
    """A catalog the reference writes under each other scheme opens in
    the port with the same partitions, pruning and counts, and the port's
    create_schema picks the reference's default scheme without a dtg."""
    spec = POLY_SPEC if scheme == "xz2" else PT_SPEC
    make = polygon_columns if scheme == "xz2" else point_columns
    cfg = {"z2": None, "xz2": None,
           "attribute": lambda m: m.AttributeScheme("name"),
           "composite": lambda m: m.CompositeScheme(
               [m.Z2Scheme(bits=2), m.AttributeScheme("name")])}[scheme]
    kw = {} if cfg is None else {"scheme": cfg(rpart)}
    root = str(tmp_path / "cat")
    rsrc = RDataStore(root, use_device_cache=True).create_schema(
        RSFT.from_spec("t", spec), **kw)
    rsrc.write(RFB.from_pydict(rsrc.sft, make(800, 7)))
    pds = PDataStore(root, use_device_cache=True, device="cpu")
    psrc = pds.get_feature_source("t")
    assert psrc.storage.scheme.to_config() == rsrc.storage.scheme.to_config()
    assert pds.get_type_names() == RDataStore(root).get_type_names() == ["t"]
    assert pds.get_schema("t").to_spec() == rsrc.sft.to_spec()
    if cfg is None:  # the no-dtg default: Z2 for points, XZ2 otherwise
        p2 = PDataStore(str(tmp_path / "p"), device="cpu").create_schema(
            PSFT.from_spec("t", spec))
        assert p2.storage.scheme.to_config() == rsrc.storage.scheme.to_config()
    cqls = ("INCLUDE", "name = 'b'") if spec == POLY_SPEC else (
        "INCLUDE", "BBOX(geom, -60, -30, 60, 30)",
        "BBOX(geom, 100, 10, 170, 80) AND name = 'b'")
    for cql in cqls:
        assert psrc.get_count(cql) == rsrc.get_count(cql), cql
        bb = PBBox(-60.0, -30.0, 60.0, 30.0)
        assert psrc.storage.prune_partitions(bb, PInterval(None, None)) == \
            rsrc.storage.prune_partitions(RBBox(-60.0, -30.0, 60.0, 30.0),
                                          RInterval(None, None))
    rf = rsrc.get_features("name = 'a'").features
    pf = psrc.get_features("name = 'a'").features
    for k in rf.columns:
        assert column_values(pf.columns[k]) == column_values(rf.columns[k]), k
