"""A5's card-only checks (no JAX in this file: the card's machine runs
only the port): a `device.transfer` fault on a card store's served
window retries on the card and leaves the answer unchanged, on the
pipelined and ring routes (the ring's slot write happens before the
copy into its captured buffers, never inside a capture); the key-value
store's polygon count (B4/B5 through mask_refined) and the live layer's
kNN (B1/B2) on the card equal their runs on the CPU."""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import faults as pf
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.plan.audit import ServeEvent as PEvent
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.serve import QueryService as PService
from geomesa_tpu_torch.serve import ServeConfig as PConfig

SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
CQL = "BBOX(geom, -170, -80, 170, 80) AND score > -5"
ROUTES = {"pipelined": dict(ring=False), "ring": dict()}


def rows(n, seed):
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-10, 10, n),
            "dtg": rng.integers(1_590_000_000_000, 1_590_100_000_000, n),
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}


@pytest.mark.cuda
def test_card_transfer_fault_retries_and_the_answer_is_unchanged(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pf.uninstall()
    pf.BREAKERS.reset()
    ds = PDataStore(str(tmp_path), use_device_cache=True, device="cuda")
    sft = PSFT.from_spec("faulty", SPEC)
    src = ds.create_schema(sft)
    src.write(PFB.from_pydict(sft, rows(1 << 16, 9)))
    qx, qy = np.array([1.0, -40.0]), np.array([2.0, 10.0])
    clean = src.knn(CQL, qx, qy, k=5)
    for route in ("pipelined", "ring"):
        svc = PService(ds, PConfig(max_wait_ms=0.0, **ROUTES[route]))
        n0 = len(ds.audit.snapshot())
        plan = pf.FaultPlan(rules=[pf.FaultRule(site="device.transfer",
                                                error="io", every=2)])
        try:
            with pf.active(plan) as h:
                got = [svc.knn("faulty", CQL, qx, qy, k=5).result(timeout=120)
                       for _ in range(4)]
                log = h.fire_log()
        finally:
            svc.close(drain=True)
        events = [e for e in ds.audit.snapshot()[n0:]
                  if isinstance(e, PEvent)]
        assert log and sum(e.retries for e in events) == len(log)
        assert all(e.status == "ok" for e in events)
        for d, i, b in got:
            np.testing.assert_array_equal(d, clean[0])
            np.testing.assert_array_equal(i, clean[1])
    assert pf.BREAKERS.states().get("device", "closed") == "closed"


@pytest.mark.cuda
def test_kv_polygon_count_and_live_knn_on_the_card_equal_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from geomesa_tpu_torch.index import KVDataStore
    from geomesa_tpu_torch.kafka import KafkaDataStore

    sft = PSFT.from_spec("kv", "code:String:index=true," + SPEC)
    data = rows(1 << 14, 4)
    data["code"] = [f"c{i % 50}" for i in range(1 << 14)]
    batch = PFB.from_pydict(sft, data, fids=[f"f{i}" for i in range(1 << 14)])
    poly = ("INTERSECTS(geom, POLYGON((-120 -50, 60 -60, 150 30, -20 75, "
            "-120 -50))) AND score > 0")
    qx, qy = np.array([1.0, -40.0, 120.0]), np.array([2.0, 10.0, -30.0])
    out = {}
    for dev in ("cpu", "cuda"):
        kv = KVDataStore(device=dev).create_schema(sft)
        kv.write(batch)
        live = KafkaDataStore(device=dev).create_schema(sft)
        live.write(batch)
        assert live.get_count("INCLUDE") == 1 << 14  # polls the topic
        knn = {impl: live.knn(CQL, qx, qy, k=8, impl=impl)
               for impl in ("sparse", "fullscan")}
        out[dev] = (kv.get_count(poly), kv.get_count("code = 'c7'"), knn)
    assert out["cuda"][:2] == out["cpu"][:2]
    for impl in ("sparse", "fullscan"):
        (cd, ci, _), (gd, gi, _) = out["cpu"][2][impl], out["cuda"][2][impl]
        for q in range(len(qx)):
            assert set(ci[q].tolist()) == set(gi[q].tolist())
        np.testing.assert_array_equal(np.sort(gd, 1), np.sort(cd, 1))
