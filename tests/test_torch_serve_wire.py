"""The port's JSON-lines wire (`geomesa_tpu_torch.serve.protocol`)
against the reference's on the same request lines.

Both packages' `serve_lines` run over one catalog (written by the
reference, read by the port on the CPU), each with a stopped service
that the line iterator starts once every line is read: every request
then queues before any dispatch, so windows, cache hits and the 1 ms
deadline's expiry are the same in both runs. Responses are compared by
id once the timing fields (a timeout's elapsed milliseconds) are
removed. The standing-query verbs over this durable store answer as
the reference's (typed: a subscription needs a live store).
"""

import json
import time

import numpy as np
import pytest

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.serve import QueryService as RService
from geomesa_tpu.serve import ServeConfig as RConfig
from geomesa_tpu.serve.protocol import serve_lines as r_serve_lines
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.serve import QueryService as PService
from geomesa_tpu_torch.serve import ServeConfig as PConfig
from geomesa_tpu_torch.serve.protocol import serve_lines as p_serve_lines

CQL = "BBOX(geom, -60, -30, 60, 50) AND score > -5"
DENSITY = {"bbox": [-60, -30, 60, 50], "width": 64, "height": 32}

PACKAGES = {"ref": (RService, RConfig, r_serve_lines),
            "port": (PService, PConfig, p_serve_lines)}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_wire"))
    rng = np.random.default_rng(17)
    n = 2000
    sft = RSFT.from_spec("served", "name:String,score:Double,dtg:Date,*geom:Point")
    rows = {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-10, 10, n),
            "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}
    ref = RDataStore(root, use_device_cache=True)
    ref.create_schema(sft).write(RFB.from_pydict(sft, rows))
    return {"ref": ref,
            "port": PDataStore(root, use_device_cache=True, device="cpu")}


def run_wire(pkg, store, docs, autostart=False):
    """Responses by id of `docs` through `pkg`'s serve_lines, with every
    request queued before the service starts (unless `autostart`)."""
    service_cls, config_cls, serve_lines = PACKAGES[pkg]
    svc = service_cls(store, config_cls(pipeline=False, ring=False),
                      autostart=autostart)

    def lines():
        for d in docs:
            yield d if isinstance(d, str) else json.dumps(d)
        time.sleep(0.02)  # the 1 ms budgets expire while queued
        svc.start()

    out = []
    n = serve_lines(store, lines(), out.append, service=svc)
    assert n == len(docs)
    assert not svc._worker.is_alive()  # closed and joined
    return {d["id"]: d for d in map(json.loads, out)}


def untimed(doc):
    doc = dict(doc)
    if doc.get("error") == "timeout":
        doc.pop("message")  # carries the elapsed milliseconds
    return doc


SHARED = [
    {"id": "c1", "op": "count", "typeName": "served", "cql": CQL},
    {"id": "c2", "op": "count", "typeName": "served", "cql": CQL},
    {"id": "k1", "op": "knn", "typeName": "served", "cql": CQL,
     "x": [10.0, -20.0], "y": [20.0, 5.0], "k": 3},
    {"id": "k2", "op": "knn", "typeName": "served", "cql": CQL,
     "x": [1.5], "y": [2.5], "k": 3},
    {"id": "kf", "op": "knn", "typeName": "served", "cql": CQL,
     "x": [30.0], "y": [-10.0], "k": 4, "impl": "fullscan"},
    {"id": "q1", "op": "query", "typeName": "served", "cql": "score > 9",
     "maxFeatures": 5},
    {"id": "d1", "op": "query", "typeName": "served", "cql": CQL,
     "density": DENSITY},
    {"id": "t1", "op": "knn", "typeName": "served", "cql": "score > 0",
     "x": [0.0], "y": [0.0], "k": 2, "timeoutMs": 1},
    {"id": "p1", "op": "count", "typeName": "served", "cql": "score > 1",
     "priority": "interactive", "tenant": "t"},
    {"id": "bad", "op": "nope", "typeName": "served"},
    {"id": "nt", "op": "count", "typeName": "no_such_type"},
    "not json at all",
]


def test_responses_equal_reference(stores):
    got = {pkg: run_wire(pkg, stores[pkg], SHARED) for pkg in PACKAGES}
    assert set(got["port"]) == set(got["ref"])
    for rid in got["ref"]:
        assert untimed(got["port"][rid]) == untimed(got["ref"][rid]), rid
    p = got["port"]
    assert p["c1"]["ok"] and p["c1"]["count"] > 0
    assert p["c2"] == {**p["c1"], "id": "c2"}
    assert len(p["k1"]["dists"]) == 2 and len(p["k1"]["indices"][0]) == 3
    assert p["q1"]["kind"] == "features" and len(p["q1"]["features"]) <= 5
    assert p["d1"]["kind"] == "density" and p["d1"]["shape"] == [32, 64]
    assert p["d1"]["total"] == p["d1"]["count"] == p["c1"]["count"]
    assert p["t1"]["error"] == "timeout" and p["t1"]["phase"] == "queued"
    assert p["bad"]["error"] == "error" and p["nt"]["error"] == "error"
    # the malformed line answers under its sequence number
    assert p[len(SHARED)]["ok"] is False


def test_wire_answers_equal_direct_calls(stores):
    src = stores["port"].get_feature_source("served")
    p = run_wire("port", stores["port"], SHARED[:7])
    assert p["c1"]["count"] == src.get_count(CQL)
    d, i, _ = src.knn(CQL, [10.0, -20.0], [20.0, 5.0], k=3)
    assert p["k1"]["dists"] == d.tolist() and p["k1"]["indices"] == i.tolist()
    from geomesa_tpu_torch import Query, QueryHints

    g = src.get_features(Query("served", CQL, hints=QueryHints(
        density_bbox=tuple(DENSITY["bbox"]), density_width=64,
        density_height=32))).grid
    assert p["d1"]["total"] == float(g.sum())


# the standing-query verbs on a durable store, with what each answers
NOT_PORTED = [
    ({"id": "s1", "op": "subscribe", "typeName": "served", "cql": CQL},
     "need a live (Kafka) store"),
    ({"id": "s2", "op": "poll"}, None),
    ({"id": "s3", "op": "unsubscribe", "subscription": "sub-1"},
     "no such subscription"),
    ({"id": "s4", "op": "attach", "subscription": "sub-1"},
     "no such subscription"),
]


@pytest.mark.parametrize("doc, message", NOT_PORTED,
                         ids=[d["id"] for d, _ in NOT_PORTED])
def test_later_verbs_answer_not_ported(stores, doc, message):
    """The verbs are ported (the name is kept from when they were not):
    over a durable store each answers as the reference's, typed."""
    got = {pkg: run_wire(pkg, stores[pkg], [doc])[doc["id"]] for pkg in PACKAGES}
    assert got["port"] == got["ref"]
    p = got["port"]
    if message is None:
        assert p == {"id": "s2", "ok": True, "applied": {}, "frames": 0}
    else:
        assert p["ok"] is False and p["error"] == "error"
        assert message in p["message"] and "reason" not in p


# the A4 request fields and verb: answered as the reference answers them
A4_REQUESTS = [
    {"id": "i1", "op": "ingest", "typeName": "served",
     "frame": {"nbytes": 16}},
    {"id": "a1", "op": "count", "typeName": "served", "cql": CQL,
     "tolerance": 0.3},
    {"id": "a2", "op": "query", "typeName": "served", "cql": CQL,
     "topkCells": 3},
    {"id": "a3", "op": "count", "typeName": "served", "cql": CQL,
     "distinct": "name"},
]


@pytest.mark.parametrize("doc", A4_REQUESTS, ids=[d["id"] for d in A4_REQUESTS])
def test_a4_fields_answer_as_reference(stores, doc):
    """An ingest frame on a text-only stream is refused (the payload
    cannot be read); a tolerance on a filter the sketches cannot bracket
    is answered exactly; topk cells and distinct counts run exactly."""
    got = {pkg: run_wire(pkg, stores[pkg], [doc])[doc["id"]]
           for pkg in PACKAGES}
    assert got["port"] == got["ref"]
    p = got["port"]
    if doc["op"] == "ingest":
        assert p["ok"] is False and "socket transport" in p["message"]
    else:
        assert p["ok"] is True and "approx" not in p
    if "topkCells" in doc:
        assert p["kind"] == "topk_cells" and len(p["cells"]) == 3
    if "distinct" in doc:
        assert p["count"] == 3


def test_columnar_downgrades_typed(stores):
    """The hello advertises the columnar wire as the reference's does;
    on a connection with no binary sink (this text stream) a columnar ask
    is served as JSON with the reference's typed wireFallback."""
    docs = [{"id": "h", "op": "hello", "wire": "columnar"},
            {"id": "w", "op": "query", "typeName": "served",
             "cql": "score > 9", "maxFeatures": 3, "wire": "columnar"}]
    got = {pkg: run_wire(pkg, stores[pkg], docs) for pkg in PACKAGES}
    hello, resp = got["port"]["h"], got["port"]["w"]
    assert hello["wire"] == ["json", "columnar"] and hello["wireMode"] == "json"
    assert hello["wireFallback"] == resp["wireFallback"] == "no_binary_sink"
    assert hello == got["ref"]["h"] and hello["rehome"] is True
    assert resp == got["ref"]["w"]
    assert len(resp["features"]) == 3


def test_stats_and_drain_verbs(stores):
    docs = [{"id": "c", "op": "count", "typeName": "served", "cql": CQL},
            {"id": "s", "op": "stats"},
            {"id": "x", "op": "drain"}]
    p = run_wire("port", stores["port"], docs, autostart=True)
    assert p["s"]["ok"] and "dispatches" in p["s"]["stats"]
    assert p["x"] == {"id": "x", "ok": True, "state": "drained"}
    assert p["c"]["ok"]
