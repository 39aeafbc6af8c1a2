"""Columnar wire framing and codecs.

A copy of the reference package's `serve/columnar.py` without its push
fan-out (`PushMux` and `_PushSink` come with the standing queries,
ROADMAP A6: their only callers are the subscribe verbs and `attach`).

- **Framing.** A columnar response or request is a normal JSON header
  line whose `"frame"` object announces `nbytes` of RAW payload after
  the newline. Control flow stays line-oriented; only bulk bytes leave
  JSON. A payload may be split into named `sections` (kNN `x`/`y`).
- **Negotiation.** The `hello` response advertises `wire`
  capabilities; a request opts in with `"wire": "columnar"` (or the
  connection does, via `hello`). What cannot go columnar (no pyarrow,
  no binary sink, a result kind with no columnar encoding) is answered
  as JSON, with a typed `wireFallback` where the client asked.
- **Codecs.** `execute` feature results ride Arrow record-batch IPC
  (`core/arrow_io.py`, the schema derived once per type); density grids
  are ONE contiguous f64 buffer; topk cells a [k, 8] f64 table. The
  decoders rebuild payloads bit-identical to the JSON path.
- `MemoryWire` and `parse_stream` are the in-process request stream and
  the client-side decode loop that tests and `chip_smoke.py` drive.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from time import perf_counter
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "have_pyarrow", "wire_capabilities", "frame_bytes", "split_sections",
    "encode_execute_frame", "decode_execute_payload",
    "encode_density_frame", "decode_density_payload",
    "encode_topk_frame", "decode_topk_payload",
    "encode_push", "decode_push", "knn_sections", "decode_knn_sections",
    "MemoryWire", "parse_stream",
]

WIRE_JSON = "json"
WIRE_COLUMNAR = "columnar"

_PA = None
_PA_CHECKED = False
_PA_LOCK = threading.Lock()


def _pyarrow():
    """The pyarrow module, or None — checked once under a lock, never
    raising. The container may lack pyarrow entirely; the wire must
    then advertise json-only and downgrade typed, not crash at import
    time."""
    global _PA, _PA_CHECKED
    with _PA_LOCK:
        if not _PA_CHECKED:
            try:
                import pyarrow as pa

                _PA = pa
            # pyarrow's absence IS the signal: the json-only capability
            except Exception:
                _PA = None
            _PA_CHECKED = True
        return _PA


def have_pyarrow() -> bool:
    return _pyarrow() is not None


def wire_capabilities() -> List[str]:
    """What the hello handshake advertises. JSON always; columnar only
    when pyarrow can encode/decode the Arrow execute payloads."""
    return [WIRE_JSON, WIRE_COLUMNAR] if have_pyarrow() else [WIRE_JSON]


# -- framing ---------------------------------------------------------------


def frame_header_bytes(doc: dict, payload: bytes) -> bytes:
    """The JSON header line of one wire frame, its `frame.nbytes`
    stamped from the actual payload. Callers that can write two parts
    under one lock (fleet sockets) send header + payload separately
    and skip the full-payload concat copy."""
    frame = dict(doc.get("frame") or {})
    frame["nbytes"] = len(payload)
    doc = dict(doc)
    doc["frame"] = frame
    return json.dumps(doc).encode() + b"\n"


def frame_bytes(doc: dict, payload: bytes) -> bytes:
    """One wire frame: header line + raw payload as ONE buffer, for
    sinks that take a single write call (the framing cannot tear)."""
    return frame_header_bytes(doc, payload) + payload


def sections_payload(
        sections: List[Tuple[str, bytes]]) -> Tuple[list, bytes]:
    """(frame `sections` descriptor, concatenated payload)."""
    desc = [[name, len(buf)] for name, buf in sections]
    return desc, b"".join(buf for _, buf in sections)


def split_sections(frame: dict, payload: bytes) -> Dict[str, memoryview]:
    """Named zero-copy views over a sectioned payload."""
    out: Dict[str, memoryview] = {}
    view = memoryview(payload)
    off = 0
    for name, nbytes in frame.get("sections") or ():
        out[str(name)] = view[off:off + int(nbytes)]
        off += int(nbytes)
    return out


# -- execute results: Arrow record batches ---------------------------------


class SchemaCache:
    """Per-typeName Arrow schema cache: the schema is derived from the
    SFT once and reused for every response of that type (the per-call
    derivation is pure overhead on a hot execute stream). Entries hold
    a strong reference to the SFT they were derived from and hits
    require IDENTITY with the caller's SFT — a replaced schema (remove
    + recreate, even one whose new object recycles the old address)
    misses and re-derives, so a stale schema can never serve."""

    def __init__(self):
        self._lock = threading.Lock()
        # (type name, include_fid) -> (sft object, derived schema)
        self._schemas: Dict[tuple, tuple] = {}

    def get(self, sft, include_fid: bool):
        from geomesa_tpu_torch.core.arrow_io import arrow_schema

        key = (sft.name, bool(include_fid))
        with self._lock:
            entry = self._schemas.get(key)
        if entry is not None and entry[0] is sft:
            return entry[1]
        schema = arrow_schema(sft, include_fid=include_fid)
        with self._lock:
            # bound the cache: one entry per live (type, fid'ness);
            # entries of dropped types age out by eviction
            if len(self._schemas) > 256:
                self._schemas.clear()
            self._schemas[key] = (sft, schema)
        return schema

    def stats(self) -> dict:
        with self._lock:
            return {"schemas": len(self._schemas)}


SCHEMAS = SchemaCache()


def encode_execute_frame(batch, limit: int) -> Tuple[dict, bytes]:
    """One `execute` feature result as an Arrow IPC stream payload.
    Returns (frame descriptor, payload). `batch` is a FeatureBatch (or
    None/empty — encoded as a zero-row batch so decode still learns the
    schema)."""
    pa = _pyarrow()
    import io

    from geomesa_tpu_torch.core.arrow_io import to_arrow

    t0 = perf_counter()
    n = 0 if batch is None else min(len(batch), limit)
    if batch is not None and n < len(batch):
        batch = batch.select(np.arange(n))
    schema = None
    if batch is not None:
        schema = SCHEMAS.get(batch.sft, include_fid=batch.fids is not None)
    rb = to_arrow(batch, schema=schema) if batch is not None else None
    sink = io.BytesIO()
    if rb is not None:
        with pa.ipc.new_stream(sink, rb.schema) as writer:
            writer.write_batch(rb)
    payload = sink.getvalue()
    _note_encode("execute", n, len(payload), perf_counter() - t0)
    return {"kind": "execute", "rows": n}, payload


def decode_execute_payload(payload: bytes) -> List[dict]:
    """Payload -> the exact row dicts the JSON path would have
    carried. Delegates to `protocol._rows_json` — ONE source of truth
    for row rendering (WKT points, dict decode, epoch-millis dates,
    non-finite floats as None), so a future change to the JSON path
    cannot silently fork the two wire modes' decoded shapes."""
    pa = _pyarrow()
    import io

    if not payload:
        return []
    from geomesa_tpu_torch.core.arrow_io import from_arrow
    from geomesa_tpu_torch.serve.protocol import _rows_json

    rows: List[dict] = []
    reader = pa.ipc.open_stream(io.BytesIO(payload))
    for rb in reader:
        fb = from_arrow(rb)
        rows.extend(_rows_json(fb, len(fb)))
    return rows


# -- density / topk grids: single raw buffers ------------------------------


def encode_density_frame(grid: np.ndarray) -> Tuple[dict, bytes]:
    """The whole density grid as ONE contiguous little-endian f64
    buffer — the JSON path only ships shape+total; columnar clients get
    the actual cells without any per-cell serialization."""
    t0 = perf_counter()
    arr = np.ascontiguousarray(np.asarray(grid, dtype="<f8"))
    payload = arr.tobytes()
    _note_encode("density", int(arr.size), len(payload),
                 perf_counter() - t0)
    return {"kind": "density", "shape": list(arr.shape),
            "dtype": "<f8"}, payload


def decode_density_payload(frame: dict, payload: bytes) -> np.ndarray:
    shape = tuple(int(s) for s in frame["shape"])
    return np.frombuffer(payload, dtype=frame.get("dtype", "<f8")
                         ).reshape(shape)


_TOPK_FIELDS = ("row", "col", "x0", "y0", "x1", "y1", "count", "bound")


def encode_topk_frame(cells: List[dict]) -> Tuple[dict, bytes]:
    """Top-k cells as a [k, 8] f64 table (row, col, bbox x0 y0 x1 y1,
    count, bound) — one buffer instead of k JSON objects."""
    t0 = perf_counter()
    k = len(cells)
    table = np.empty((k, len(_TOPK_FIELDS)), dtype="<f8")
    for i, c in enumerate(cells):
        table[i, 0] = c["row"]
        table[i, 1] = c["col"]
        table[i, 2:6] = c["bbox"]
        table[i, 6] = c["count"]
        table[i, 7] = c["bound"]
    payload = table.tobytes()
    _note_encode("topk", k, len(payload), perf_counter() - t0)
    return {"kind": "topk_cells", "k": k}, payload


def decode_topk_payload(frame: dict, payload: bytes) -> List[dict]:
    k = int(frame["k"])
    table = np.frombuffer(payload, dtype="<f8").reshape(
        k, len(_TOPK_FIELDS))
    return [{
        "row": int(t[0]), "col": int(t[1]),
        "bbox": [float(t[2]), float(t[3]), float(t[4]), float(t[5])],
        "count": int(t[6]), "bound": int(t[7]),
    } for t in table]


# -- push frames -----------------------------------------------------------

# push frame fields that move into payload sections in columnar mode
_PUSH_COLUMN = "fids"


def encode_push(frame: dict, mode: str) -> bytes:
    """ONE encode of a push frame for one wire mode — the buffer the
    PushMux fans to every sink of that mode. JSON mode: the frame as a
    JSON line (exactly what respond() used to produce per subscriber).
    Columnar mode: frames with a fid column (`enter`/`exit`/predicate
    `state`) ship it as Arrow-style offsets + one utf8 data buffer —
    length-prefixed, so a fid containing ANY byte sequence (newlines
    included: fids are user data off the ingest path) round-trips
    exactly. Everything else stays a JSON line (the scalar frames are
    already tiny)."""
    if mode == WIRE_COLUMNAR and frame.get(_PUSH_COLUMN):
        fids = frame[_PUSH_COLUMN]
        data = [f.encode() for f in fids]
        lengths = np.array([len(d) for d in data], dtype="<i4")
        offsets = np.zeros(len(data) + 1, dtype="<i4")
        np.cumsum(lengths, out=offsets[1:])
        obuf = offsets.tobytes()
        dbuf = b"".join(data)
        head = {k: v for k, v in frame.items() if k != _PUSH_COLUMN}
        head["frame"] = {"kind": "push.fids", "count": len(fids),
                         "sections": [["offsets", len(obuf)],
                                      ["fids", len(dbuf)]]}
        return frame_bytes(head, obuf + dbuf)
    return json.dumps(frame).encode() + b"\n"


def decode_push(doc: dict, payload: Optional[bytes]) -> dict:
    """Inverse of encode_push: rebuild the frame dict the JSON path
    would have delivered (bit-identical — parity-tested)."""
    frame = doc.get("frame")
    if not frame or payload is None:
        return doc
    out = {k: v for k, v in doc.items() if k != "frame"}
    if frame.get("kind") == "push.fids":
        secs = split_sections(frame, payload)
        offsets = np.frombuffer(secs["offsets"], dtype="<i4")
        data = bytes(secs["fids"])
        out[_PUSH_COLUMN] = [
            data[offsets[i]:offsets[i + 1]].decode()
            for i in range(len(offsets) - 1)]
    return out


# -- kNN query staging: request buffers as NumPy views ---------------------


def knn_sections(qx, qy) -> Tuple[list, bytes]:
    """Encode kNN query points as two f64 payload sections (client
    side). The server decodes them as zero-copy views that flow
    straight into batcher.stack_queries / the pipeline's prepare stage
    — no per-point JSON number parsing."""
    bx = np.ascontiguousarray(np.asarray(qx, dtype="<f8")).tobytes()
    by = np.ascontiguousarray(np.asarray(qy, dtype="<f8")).tobytes()
    return sections_payload([("x", bx), ("y", by)])


def decode_knn_sections(frame: dict, payload: bytes):
    """(qx, qy) as read-only f64 views over the wire buffer."""
    secs = split_sections(frame, payload)
    if "x" not in secs or "y" not in secs:
        raise ValueError("knn frame needs x and y sections")
    qx = np.frombuffer(secs["x"], dtype="<f8")
    qy = np.frombuffer(secs["y"], dtype="<f8")
    return qx, qy


# -- telemetry -------------------------------------------------------------


def _note_encode(kind: str, rows: int, nbytes: int, secs: float) -> None:
    """wire.* counters + encode-latency histograms . Guarded: observability must never fail an
    encode that is already on the response path."""
    try:
        from geomesa_tpu_torch.utils.metrics import metrics

        metrics.counter("wire.rows", rows, kind=kind)
        metrics.counter("wire.bytes", nbytes, kind=kind)
        metrics.histogram("wire.encode.latency", kind=kind).update(secs)
    except Exception:
        pass


# -- in-memory wire helpers (tests, smokes, benches) -----------------------


class MemoryWire:
    """A pre-encoded request byte stream read the way the socket layer
    reads it: header lines via `lines()`, frame payloads via
    `read_exact`. One thread reads it; tests and `chip_smoke.py` drive
    `serve_connection` with it."""

    def __init__(self, data: bytes = b""):
        self.data = bytearray(data)
        self.pos = 0

    def add(self, doc: dict, payload: Optional[bytes] = None) -> None:
        if payload is None:
            self.data += json.dumps(doc).encode() + b"\n"
        else:
            self.data += frame_bytes(doc, payload)

    def lines(self):
        while True:
            nl = self.data.find(b"\n", self.pos)
            if nl < 0:
                return
            line = self.data[self.pos:nl]
            self.pos = nl + 1
            yield line.decode()

    def read_exact(self, n: int) -> bytes:
        out = bytes(self.data[self.pos:self.pos + n])
        if len(out) < n:
            raise OSError("stream ended mid-frame")
        self.pos += n
        return out


def parse_stream(data: bytes) -> List[Tuple[dict, Optional[bytes]]]:
    """Parse a response byte stream into (doc, payload) pairs — the
    client-side decode loop, shared by tests/smokes/benches."""
    out: List[Tuple[dict, Optional[bytes]]] = []
    pos = 0
    n = len(data)
    while pos < n:
        nl = data.find(b"\n", pos)
        if nl < 0:
            break
        line = data[pos:nl].strip()
        pos = nl + 1
        if not line:
            continue
        doc = json.loads(line)
        payload = None
        frame = doc.get("frame")
        if frame and frame.get("nbytes"):
            nb = int(frame["nbytes"])
            payload = bytes(data[pos:pos + nb])
            if len(payload) < nb:
                raise ValueError("response stream ended mid-frame")
            pos += nb
        out.append((doc, payload))
    return out
