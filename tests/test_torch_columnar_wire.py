"""The port's columnar wire (`geomesa_tpu_torch.serve.columnar` and the
protocol's framing) against the reference's, after tests/test_wire.py.

One catalog (written by the reference) serves both packages on the CPU
over `MemoryWire` conversations. The hello negotiation and its typed
downgrades (no binary sink, no pyarrow) answer as the reference's;
columnar execute, density and topk payloads decode bit-identical to the
JSON path and their frame bytes equal the reference's; kNN query points
as x/y sections answer as the JSON request; `op=ingest` of an Arrow IPC
frame lands through `DataStore.write_batch`. A raw reader consumes
exactly `frame.nbytes` after each header line.
"""

import json
import time

import numpy as np
import pytest

import geomesa_tpu.serve as rserve
import geomesa_tpu.serve.protocol  # noqa: F401
import geomesa_tpu_torch.serve as pserve
import geomesa_tpu_torch.serve.protocol  # noqa: F401
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.plan.datastore import DataStore as RDataStore
from geomesa_tpu.serve import columnar as rcol
from geomesa_tpu_torch.core.arrow_io import to_arrow, to_ipc_bytes
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.plan.datastore import DataStore as PDataStore
from geomesa_tpu_torch.serve import columnar as pcol

SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
CQL = "BBOX(geom,-170,-80,170,80) AND score > -5"
DENSITY = {"bbox": [-180, -90, 180, 90], "width": 64, "height": 32}
PKG = {"ref": (rserve, rcol), "port": (pserve, pcol)}


def make_rows(n=600, seed=3, with_nulls=True):
    rng = np.random.default_rng(seed)
    names = rng.choice(["a", "b", "c"], n).tolist()
    if with_nulls:
        names = [None if i % 97 == 0 else v for i, v in enumerate(names)]
    return {"name": names, "score": rng.uniform(-10, 10, n),
            "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_colwire"))
    sft = RSFT.from_spec("served", SPEC)
    RDataStore(root, use_device_cache=True).create_schema(sft).write(
        RFB.from_pydict(sft, make_rows()))
    return {"ref": RDataStore(root, use_device_cache=True),
            "port": PDataStore(root, use_device_cache=True, device="cpu")}


def drive(pkg, store, requests, payloads=None, binary=True, timeout_s=60.0):
    """One in-memory conversation through `pkg`'s serve_connection over a
    service that is closed (drained) before the output is parsed.
    Returns {id: (doc, payload)}."""
    serve, col = PKG[pkg]
    svc = serve.QueryService(store, serve.ServeConfig(max_wait_ms=0.0))
    mem = col.MemoryWire()
    for doc in requests:
        mem.add(doc, (payloads or {}).get(doc.get("id")))
    out = bytearray()
    kw = dict(write_bytes=out.extend, read_bytes=mem.read_exact) if binary \
        else {}
    try:
        serve.protocol.serve_connection(
            store, svc, mem.lines(), lambda s: out.extend(s.encode()), **kw)
        want = {d["id"] for d in requests}
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = {d.get("id") for d, _ in col.parse_stream(bytes(out))}
            if want <= got:
                break
            time.sleep(0.005)
    finally:
        svc.close(drain=True)
    return {d.get("id"): (d, p) for d, p in col.parse_stream(bytes(out))}


def both(stores, requests, **kw):
    return {pkg: drive(pkg, stores[pkg], requests, **kw) for pkg in PKG}


# -- negotiation ----------------------------------------------------------------


def test_hello_advertises_and_upgrades(stores):
    got = both(stores, [{"id": "h", "op": "hello", "wire": "columnar"},
                        {"id": "p", "op": "hello"}])
    assert got["port"] == got["ref"]
    hello = got["port"]["h"][0]
    assert hello["wire"] == ["json", "columnar"]
    assert hello["wireMode"] == "columnar"


def test_no_binary_sink_downgrades_typed(stores):
    reqs = [{"id": "h", "op": "hello", "wire": "columnar"},
            {"id": "q", "op": "query", "typeName": "served", "cql": CQL,
             "maxFeatures": 5, "wire": "columnar"}]
    got = both(stores, reqs, binary=False)
    assert got["port"] == got["ref"]
    hello, q = got["port"]["h"][0], got["port"]["q"][0]
    assert hello["wireMode"] == "json"
    assert hello["wireFallback"] == q["wireFallback"] == "no_binary_sink"
    assert len(q["features"]) == 5 and got["port"]["q"][1] is None


def test_pyarrow_absent_skips_typed_to_json(stores, monkeypatch):
    monkeypatch.setattr(pcol, "_PA", None)
    monkeypatch.setattr(pcol, "_PA_CHECKED", True)
    assert pcol.wire_capabilities() == ["json"]
    got = drive("port", stores["port"], [
        {"id": "h", "op": "hello", "wire": "columnar"},
        {"id": "q", "op": "query", "typeName": "served", "cql": "INCLUDE",
         "maxFeatures": 5, "wire": "columnar"}])
    assert got["h"][0]["wire"] == ["json"]
    assert got["h"][0]["wireFallback"] == "pyarrow_unavailable"
    q, payload = got["q"]
    assert payload is None and q["wireFallback"] == "pyarrow_unavailable"
    assert len(q["features"]) == 5


# -- payload parity -------------------------------------------------------------


def test_execute_rows_bit_identical(stores):
    reqs = [{"id": "h", "op": "hello", "wire": "columnar"},
            {"id": "c", "op": "query", "typeName": "served", "cql": CQL,
             "maxFeatures": 600},
            {"id": "j", "op": "query", "typeName": "served", "cql": CQL,
             "maxFeatures": 600, "wire": "json"}]
    got = both(stores, reqs)
    cdoc, payload = got["port"]["c"]
    jdoc, _ = got["port"]["j"]
    assert payload is not None and "features" not in cdoc
    rows = pcol.decode_execute_payload(payload)
    assert rows == jdoc["features"] == got["ref"]["j"][0]["features"]
    assert cdoc["count"] == jdoc["count"] == len(rows)
    # the same batch and schema: the Arrow IPC bytes are the reference's
    assert payload == got["ref"]["c"][1]
    assert cdoc == got["ref"]["c"][0]


def test_density_and_topk_frames_equal_reference(stores):
    reqs = [{"id": "c", "op": "query", "typeName": "served", "cql": "INCLUDE",
             "density": DENSITY, "wire": "columnar"},
            {"id": "j", "op": "query", "typeName": "served", "cql": "INCLUDE",
             "density": DENSITY},
            {"id": "t", "op": "query", "typeName": "served", "cql": CQL,
             "topkCells": 6, "wire": "columnar"},
            {"id": "tj", "op": "query", "typeName": "served", "cql": CQL,
             "topkCells": 6}]
    got = both(stores, reqs)
    cdoc, payload = got["port"]["c"]
    jdoc, _ = got["port"]["j"]
    grid = pcol.decode_density_payload(cdoc["frame"], payload)
    assert cdoc["shape"] == jdoc["shape"] == list(grid.shape)
    assert cdoc["total"] == jdoc["total"] == float(grid.sum())
    assert grid.dtype == np.float64 and len(payload) == grid.size * 8
    tdoc, tpay = got["port"]["t"]
    assert pcol.decode_topk_payload(tdoc["frame"], tpay) == \
        got["port"]["tj"][0]["cells"]
    assert len(tpay) == 6 * 8 * 8
    for rid in ("c", "t"):
        assert got["port"][rid] == got["ref"][rid]


def test_codecs_bit_identical_to_reference():
    cells = [{"row": 3, "col": 7, "bbox": [-180.0, -90.0, -174.375, -87.1875],
              "count": 41, "bound": 3},
             {"row": 0, "col": 0, "bbox": [0.0, 0.0, 5.625, 2.8125],
              "count": 12, "bound": 0}]
    desc, payload = pcol.encode_topk_frame(cells)
    assert (desc, payload) == rcol.encode_topk_frame(cells)
    assert pcol.decode_topk_payload(desc, payload) == cells
    grid = np.random.default_rng(0).random((5, 7)).astype(np.float32)
    assert pcol.encode_density_frame(grid) == rcol.encode_density_frame(grid)
    frame = {"event": "enter", "subscription": "sub-9", "seq": 4,
             "fids": [f"f{i}" for i in range(57)]
             + ["has\nnewline", "", "tab\tand spaces"]}
    for mode in ("json", "columnar"):
        buf = pcol.encode_push(frame, mode)
        assert buf == rcol.encode_push(frame, mode)
        ((doc, pay),) = pcol.parse_stream(buf)
        assert pcol.decode_push(doc, pay) == frame
    qx, qy = np.array([1.5, -20.25]), np.array([2.5, 10.125])
    assert pcol.knn_sections(qx, qy) == rcol.knn_sections(qx, qy)


def test_knn_sections_answer_as_json(stores):
    qx = np.array([1.5, -20.25, 33.0])
    qy = np.array([2.5, 10.125, -44.0])
    desc, payload = pcol.knn_sections(qx, qy)
    reqs = [{"id": "b", "op": "knn", "typeName": "served", "cql": CQL,
             "k": 4, "frame": {"sections": desc}},
            {"id": "j", "op": "knn", "typeName": "served", "cql": CQL,
             "k": 4, "x": qx.tolist(), "y": qy.tolist()}]
    got = both(stores, reqs, payloads={"b": payload})
    p = got["port"]
    assert p["b"][0]["dists"] == p["j"][0]["dists"] == got["ref"]["b"][0]["dists"]
    assert p["b"][0]["indices"] == p["j"][0]["indices"]


# -- ingest ---------------------------------------------------------------------


def test_wire_ingest_roundtrip(tmp_path):
    rows = make_rows(n=256, seed=9, with_nulls=False)
    sft = PSFT.from_spec("served", SPEC)
    batch = PFB.from_pydict(sft, rows)
    ds = PDataStore(str(tmp_path / "ingest"), use_device_cache=True,
                    device="cpu")
    ds.create_schema(sft)
    payload = to_ipc_bytes(batch)
    got = drive("port", ds, [
        {"id": "w", "op": "ingest", "typeName": "served",
         "frame": {"kind": "ingest"}},
        {"id": "n", "op": "count", "typeName": "served", "cql": "INCLUDE"},
        {"id": "x", "op": "ingest", "typeName": "served"}],
        payloads={"w": payload})
    assert got["w"][0] == {"id": "w", "ok": True, "rows": 256, "batches": 1}
    assert got["n"][0]["count"] == 256
    assert got["x"][0]["ok"] is False and "binary frame" in got["x"][0]["message"]
    feats = ds.get_feature_source("served").get_features("INCLUDE").features
    assert sorted(np.asarray(feats.columns["score"])) == sorted(rows["score"])
    # the same frame through the reference's wire answers the same
    rds = RDataStore(str(tmp_path / "ref"), use_device_cache=True)
    rds.create_schema(RSFT.from_spec("served", SPEC))
    rgot = drive("ref", rds, [{"id": "w", "op": "ingest", "typeName": "served",
                               "frame": {"kind": "ingest"}}],
                 payloads={"w": payload})
    assert rgot["w"][0] == got["w"][0]


def test_write_batch_accepts_record_batch_and_ipc(tmp_path):
    sft = PSFT.from_spec("served", SPEC)
    batch = PFB.from_pydict(sft, make_rows(n=128, seed=5, with_nulls=False))
    ds = PDataStore(str(tmp_path / "wb"), device="cpu")
    ds.create_schema(sft)
    assert ds.write_batch("served", to_arrow(batch)) == (128, 1)
    assert ds.write_batch("served", to_ipc_bytes(batch)) == (128, 1)
    assert ds.write_batch("served", [to_arrow(batch)] * 2) == (256, 2)
    assert ds.get_feature_source("served").get_count() == 512


def test_raw_reader_consumes_exactly_nbytes():
    """A reader takes exactly `frame.nbytes` raw bytes after a header
    line, whatever the payload holds (newlines included)."""
    payload = b"\n{\"id\": 9}\n" + bytes(range(256))
    buf = (pcol.frame_bytes({"id": 1, "frame": {"kind": "x"}}, payload)
           + json.dumps({"id": 2}).encode() + b"\n"
           + pcol.frame_bytes({"id": 3, "frame": {"kind": "y"}}, b""))
    got = pcol.parse_stream(buf)
    assert [d["id"] for d, _ in got] == [1, 2, 3]
    assert got[0][1] == payload and got[0][0]["frame"]["nbytes"] == len(payload)
    assert got[1][1] is None and got[2][1] is None
    assert got == rcol.parse_stream(buf)
    with pytest.raises(ValueError, match="mid-frame"):
        pcol.parse_stream(buf[:buf.index(b"\n") + 5])
    mem = pcol.MemoryWire()
    mem.add({"id": 1, "frame": {"kind": "x"}}, payload)
    mem.add({"id": 2})
    lines = mem.lines()
    head = json.loads(next(lines))
    assert mem.read_exact(head["frame"]["nbytes"]) == payload
    assert json.loads(next(lines)) == {"id": 2}
