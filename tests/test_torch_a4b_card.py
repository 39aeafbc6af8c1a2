"""The A4 (b) slice's device work on the card: the visibility allow
table's gather and f64 coordinate staging, held to the port's own CPU
path (this file imports no JAX). Each test skips inside its body when
there is no CUDA device."""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import DataStore, FeatureBatch, SimpleFeatureType
from geomesa_tpu_torch.plan.runner import allow_table, gather_allow
from geomesa_tpu_torch.security.visibility import allow_mask
from geomesa_tpu_torch.utils.config import SystemProperties

VOCAB = ["", "user", "admin", "admin&user", "admin|ops", "(admin|ops)&user",
         None]
CQL = ("BBOX(geom, -10.0, 35.0, 12.5, 55.0) AND dtg > 2020-09-13T13:00:00Z "
       "AND speed > 5.0")
POLY = ("INTERSECTS(geom, POLYGON((-8 36, 10 37, 11 54, -5 52, -8 36))) "
        "AND speed > 5.0")


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_device_gather_on_the_card():
    need_card()
    rng = np.random.default_rng(2)
    codes = rng.integers(-2, len(VOCAB) + 3, 1 << 20).astype(np.int32)
    for auths in [(), ("user",), ("admin", "user"), ("ops",)]:
        got = gather_allow(allow_table(VOCAB, auths),
                           torch.from_numpy(codes).cuda())
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      allow_mask(VOCAB, codes, auths))


@pytest.mark.cuda
def test_float64_staging_on_the_card(tmp_path):
    need_card()
    rng = np.random.default_rng(12)
    n = 1 << 16
    sft = SimpleFeatureType.from_spec("gdelt", "speed:Double,dtg:Date,*geom:Point")
    root = str(tmp_path / "cat")
    DataStore(root, device="cpu").create_schema(sft).write(
        FeatureBatch.from_pydict(sft, {
            "speed": rng.uniform(0, 30, n),
            "dtg": rng.integers(1_600_000_000_000, 1_600_200_000_000, n),
            "geom": np.stack([rng.uniform(-20, 20, n), rng.uniform(30, 60, n)],
                             1)}))
    SystemProperties.set("geomesa.coord.dtype", "float64")
    try:
        cpu = DataStore(root, use_device_cache=True,
                        device="cpu").get_feature_source("gdelt")
        card = DataStore(root, use_device_cache=True).get_feature_source("gdelt")
    finally:
        SystemProperties.clear("geomesa.coord.dtype")
    f32 = DataStore(root, use_device_cache=True).get_feature_source("gdelt")
    for cql in (CQL, POLY):
        assert card.get_count(cql) == cpu.get_count(cql) == f32.get_count(cql)
    qx, qy = rng.uniform(-8, 10, 64), rng.uniform(36, 54, 64)
    for impl in ("sparse", "fullscan"):
        a = card.knn(CQL, qx, qy, k=10, impl=impl)
        b = f32.knn(CQL, qx, qy, k=10, impl=impl)
        c = cpu.knn(CQL, qx, qy, k=10, impl=impl)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[0], c[0])
    assert card.planner.cache.superbatch().dev["geom__x"].dtype == torch.float64
