"""Store state carried across: the port's Parquet store, partition scheme
and device batches against the reference package's.

A catalog written by either package loads in the other with the same
manifest, partitions and rows; the port's vectorised partition names are
byte-identical to the reference's per-row formatter; and the reference's
device batch converts to the port's with the same keys and dtypes.
"""

import os

import numpy as np
import pytest
import torch

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql.extract import BBox as RBBox, Interval as RInterval
from geomesa_tpu.engine.device import to_device as ref_to_device
from geomesa_tpu.plan import DataStore as RDataStore
from geomesa_tpu.store.fs import FileSystemStorage as RStorage
from geomesa_tpu.store.partition import DateTimeScheme as RScheme
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.cql.extract import BBox as PBBox, Interval as PInterval
from geomesa_tpu_torch.engine.device import to_device as port_to_device
from geomesa_tpu_torch.errors import NotPortedError
from geomesa_tpu_torch.interop import device_batch_from_numpy
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


def rows_of(storage):
    """All rows of a storage, per partition, in file order."""
    out = {}
    for name in storage.partitions():
        batches = list(storage.scan_partitions([name]))
        cols = {}
        for b in batches:
            for k, c in b.columns.items():
                v = (np.asarray(c.x).tolist(), np.asarray(c.y).tolist()) \
                    if hasattr(c, "x") else (c.decode() if hasattr(c, "decode")
                                             else np.asarray(c).tolist())
                cols.setdefault(k, []).append(v)
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


def test_other_schemes_raise_typed(tmp_path):
    ds = RDataStore(str(tmp_path / "cat"))
    ds.create_schema(RSFT.from_spec("pts", "*geom:Point"))  # z2 scheme
    with pytest.raises(NotPortedError, match="z2"):
        PDataStore(str(tmp_path / "cat"), device="cpu").get_feature_source("pts")
