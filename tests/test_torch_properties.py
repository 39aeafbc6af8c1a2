"""The `geomesa.force.count` and `geomesa.coord.dtype` system properties
on the port against the reference's planner under the same property.

One catalog (written by the reference) serves both packages on the CPU.
`geomesa.force.count=true` makes an estimate-allowed INCLUDE count run the
masked path (one QueryEvent) instead of the manifest shortcut, with the
same answer. `geomesa.coord.dtype=float64` stages f64 coordinates on the
cached and the scan routes and records the dtype in the device cache's
manifest; counts stay f64-exact and kNN answers equal the f32 store's
(same neighbour sets, meters bit-identical) and the reference's.
"""

import json
import os

import numpy as np
import pytest
import torch

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.plan.hints import QueryHints as RHints
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.utils.config import SystemProperties as RProps
from geomesa_tpu_torch.engine.device import to_device_cached
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.plan.hints import QueryHints as PHints
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.utils.config import SystemProperties as PProps

SPEC = "speed:Double,dtg:Date,*geom:Point"
T0, DAY = 1_600_000_000_000, 86_400_000
N = 6000
CQL = ("BBOX(geom, -10.0, 35.0, 12.5, 55.0) AND dtg > 2020-09-13T13:00:00Z "
       "AND speed > 5.0")
POLY = ("INTERSECTS(geom, POLYGON((-8 36, 10 37, 11 54, -5 52, -8 36))) "
        "AND speed > 5.0")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_props"))
    rng = np.random.default_rng(12)
    sft = RSFT.from_spec("gdelt", SPEC)
    RDataStore(root).create_schema(sft).write(RFB.from_pydict(sft, {
        "speed": rng.uniform(0, 30, N),
        "dtg": rng.integers(T0, T0 + 3 * DAY, N),
        "geom": np.stack([rng.uniform(-20, 20, N), rng.uniform(30, 60, N)],
                         1)}))
    return root


@pytest.fixture()
def prop():
    """Set a property in both packages for one test."""
    names = []

    def set_(name, value):
        names.append(name)
        RProps.set(name, value)
        PProps.set(name, value)

    yield set_
    for name in names:
        RProps.clear(name)
        PProps.clear(name)


@pytest.mark.parametrize("forced", [False, True])
def test_force_count(root, prop, forced):
    if forced:
        prop("geomesa.force.count", True)
    got = {}
    for pkg, ds, q in (
            ("ref", RDataStore(root, use_device_cache=True),
             RQuery("gdelt", "INCLUDE", hints=RHints(exact_count=False))),
            ("port", PDataStore(root, use_device_cache=True, device="cpu"),
             PQuery("gdelt", "INCLUDE", hints=PHints(exact_count=False)))):
        before = len(ds.audit.snapshot())
        n = ds.get_feature_source("gdelt").get_count(q)
        got[pkg] = (n, len(ds.audit.snapshot()) - before)
    assert got["port"] == got["ref"] == (N, 1 if forced else 0)


@pytest.mark.parametrize("cached", [True, False])
def test_coord_dtype_float64(root, prop, cached):
    f32 = PDataStore(root, use_device_cache=cached,
                     device="cpu").get_feature_source("gdelt")
    prop("geomesa.coord.dtype", "float64")
    f64 = PDataStore(root, use_device_cache=cached,
                     device="cpu").get_feature_source("gdelt")
    ref = RDataStore(root, use_device_cache=cached).get_feature_source("gdelt")
    assert f32.planner.coord_dtype == torch.float32
    assert f64.planner.coord_dtype == torch.float64
    for cql in (CQL, POLY, "speed > 20"):
        n = f64.get_count(cql)
        assert n == f32.get_count(cql) == ref.get_count(RQuery("gdelt", cql))
    rng = np.random.default_rng(3)
    qx, qy = rng.uniform(-8, 10, 12), rng.uniform(36, 54, 12)
    for impl in ("sparse", "fullscan"):
        a = f64.knn(CQL, qx, qy, k=10, impl=impl)
        b = f32.knn(CQL, qx, qy, k=10, impl=impl)
        r = ref.knn(RQuery("gdelt", CQL), qx, qy, k=10, impl=impl)
        for i in range(len(qx)):
            assert set(a[1][i].tolist()) == set(b[1][i].tolist())
            assert set(a[1][i].tolist()) == set(r[1][i].tolist())
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(np.sort(a[0], 1), np.sort(r[0], 1))
    dh = dict(density_bbox=(-20.0, 30.0, 20.0, 60.0), density_width=32,
              density_height=32)
    np.testing.assert_array_equal(
        f64.get_features(PQuery("gdelt", CQL, hints=PHints(**dh))).grid,
        ref.get_features(RQuery("gdelt", CQL, hints=RHints(**dh))).grid)
    if cached:
        sb = f64.planner.cache.superbatch()
        assert sb.dev["geom__x"].dtype == torch.float64
        f64.planner.cache.save_manifest()
        with open(os.path.join(root, "gdelt", ".device_cache.json")) as f:
            assert json.load(f)["coord_dtype"] == "float64"
        ref.planner.cache.save_manifest()
        with open(os.path.join(root, "gdelt", ".device_cache.json")) as f:
            assert json.load(f)["coord_dtype"] == "float64"


def test_batch_cache_keeps_a_slot_per_dtype(root):
    src = PDataStore(root, device="cpu").get_feature_source("gdelt")
    batch = src.get_features(PQuery("gdelt", "speed > 29")).features
    a = to_device_cached(batch, torch.device("cpu"), torch.float32)
    b = to_device_cached(batch, torch.device("cpu"), torch.float64)
    assert a["geom__x"].dtype == torch.float32
    assert b["geom__x"].dtype == torch.float64
    assert to_device_cached(batch, torch.device("cpu"), torch.float32) is a
