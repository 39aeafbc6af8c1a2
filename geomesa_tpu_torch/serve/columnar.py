"""Columnar wire framing and codecs.

A copy of the reference package's `serve/columnar.py`.

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
  decoders rebuild payloads bit-identical to the JSON path. Push
  `enter`/`exit`/`state` frames carry their fid column as one utf8
  buffer (`encode_push`).
- **PushMux.** The push fan-out: each frame is encoded ONCE per wire
  mode and the same immutable buffer fans to every subscriber sink.
  Attached (mirror) sinks get a writer thread and a bounded queue each,
  so one slow subscriber never stalls the flusher or its peers; the
  subscription's OWNER connection writes synchronously and keeps the
  bounded-outbox contract (a failed write requeues frames).
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
    "PushMux", "MemoryWire", "parse_stream",
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


# -- push fan-out ----------------------------------------------------------


class _PushSink:
    """One subscriber endpoint. `threaded` sinks (socket connections)
    get a dedicated writer thread draining a bounded queue, so a slow
    peer backs up only its own queue; unthreaded sinks (the owner
    connection, in-process benches) write synchronously on the
    publisher's thread and keep the flush-requeue contract.

    Lock discipline: queue, counters and lifecycle flags live under
    ONE condition; the socket write itself always happens OUTSIDE it
    (a wedged peer must never hold the sink lock against the
    publisher)."""

    __slots__ = ("sink_id", "write", "mode", "limit", "threaded",
                 "_dead", "_sent", "_dropped", "_q", "_cond",
                 "_thread", "_stopping")

    def __init__(self, sink_id: str, write: Callable[[bytes], None],
                 mode: str, limit: int, threaded: bool):
        self.sink_id = sink_id
        self.write = write
        self.mode = mode
        self.limit = limit
        self.threaded = threaded
        self._dead = False
        self._stopping = False
        self._sent = 0
        self._dropped = 0
        self._q: "deque[bytes]" = deque()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        if threaded:
            self._thread = threading.Thread(
                target=self._drain_loop, daemon=True,
                name=f"gmtpu-wire-push-{sink_id}")
            self._thread.start()

    @property
    def dead(self) -> bool:
        with self._cond:
            return self._dead

    def offer(self, buf: bytes) -> None:
        """Enqueue (threaded) or write now (unthreaded). The queue is
        BOUNDED: a sink past its limit drops the frame and counts it —
        attached sinks are best-effort mirrors; the subscription's own
        lag/resync contract lives in the owner's outbox."""
        if not self.threaded:
            # synchronous, write outside any lock: exceptions propagate
            # to the flusher, which requeues undelivered frames
            # (manager._flush_all)
            with self._cond:
                if self._dead:
                    return
            self.write(buf)
            with self._cond:
                self._sent += 1
            return
        with self._cond:
            if self._dead:
                return
            if len(self._q) >= self.limit:
                self._dropped += 1
                return
            self._q.append(buf)
            self._cond.notify()

    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stopping:
                    # bounded wait (GT20 discipline): re-check the
                    # stop flag so close() can always join
                    self._cond.wait(timeout=0.25)
                if self._stopping and not self._q:
                    return
                buf = self._q.popleft() if self._q else None
            if buf is None:
                continue
            try:
                self.write(buf)
            except Exception:
                # the peer vanished: the sink dies (dead flag, reaped by
                # publish); the subscription's owner stream is unaffected
                with self._cond:
                    self._dead = True
                    self._stopping = True
                return
            with self._cond:
                self._sent += 1

    def snapshot(self) -> "tuple[int, int, bool]":
        with self._cond:
            return self._sent, self._dropped, self._dead

    def close(self) -> None:
        with self._cond:
            self._dead = True
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class PushMux:
    """Cross-connection push fan-out: serialize each frame ONCE per
    wire mode, fan the same immutable buffer to every registered sink.

    Routing: every connection with standing queries registers one sink
    (its own outbox frames flow through it — the one-encode path holds
    even for a single JSON subscriber); `attach(sink, subscription)`
    mirrors one subscription's frames to additional connections, which
    is the >10^3-subscriber story: ONE registered predicate, ONE
    evaluation, ONE encode, N sockets (docs/SERVING.md "Columnar
    wire")."""

    def __init__(self, queue_limit: int = 1024):
        self.queue_limit = queue_limit
        self._lock = threading.Lock()
        self._sinks: Dict[str, _PushSink] = {}
        self._attached: Dict[str, set] = {}   # subscription -> sink ids
        self._ids = 0
        self.encodes = 0
        self.frames = 0
        self.fanout = 0

    # -- membership --------------------------------------------------------

    def register(self, write: Callable[[bytes], None],
                 mode: str = WIRE_JSON, threaded: bool = True,
                 sink_id: Optional[str] = None) -> str:
        with self._lock:
            if sink_id is None:
                self._ids += 1
                sink_id = f"sink-{self._ids}"
            sink = _PushSink(sink_id, write, mode, self.queue_limit,
                             threaded)
            self._sinks[sink_id] = sink
        return sink_id

    def unregister(self, sink_id: str) -> None:
        with self._lock:
            sink = self._sinks.pop(sink_id, None)
            for ids in self._attached.values():
                ids.discard(sink_id)
        if sink is not None:
            sink.close()

    def attach(self, sink_id: str, subscription_id: str) -> int:
        """Mirror `subscription_id`'s frames onto `sink_id`. Returns
        the subscription's sink count (owner excluded)."""
        with self._lock:
            if sink_id not in self._sinks:
                raise KeyError(f"unknown sink {sink_id!r}")
            ids = self._attached.setdefault(subscription_id, set())
            ids.add(sink_id)
            return len(ids)

    def detach(self, sink_id: str, subscription_id: str) -> None:
        with self._lock:
            ids = self._attached.get(subscription_id)
            if ids is not None:
                ids.discard(sink_id)

    # -- publishing --------------------------------------------------------

    def route(self, frame: dict, owner: Optional[str] = None) -> int:
        """Fan one frame to its owner sink + every sink attached to its
        subscription. Returns deliveries offered."""
        targets = set()
        if owner is not None:
            targets.add(owner)
        sub = frame.get("subscription")
        if sub is not None:
            with self._lock:
                targets |= self._attached.get(sub, set())
        return self.publish(frame, sorted(targets))

    def publish(self, frame: dict, sink_ids) -> int:
        """Encode once per wire mode present among `sink_ids`, offer
        the shared buffer to each sink. A synchronous (owner) sink's
        write error propagates so the flusher can requeue; threaded
        sinks fail independently and are reaped."""
        with self._lock:
            sinks = [self._sinks[s] for s in sink_ids
                     if s in self._sinks]
        # reap sinks whose writer thread died (peer vanished) so the
        # table does not accumulate corpses across publishes
        for s in [s for s in sinks if s.dead]:
            self.unregister(s.sink_id)
        sinks = [s for s in sinks if not s.dead]
        if not sinks:
            return 0
        bufs: Dict[str, bytes] = {}
        # encode-before-fan: every mode's buffer exists before any sink
        # write, so a raising owner write cannot skew the encode count
        for sink in sinks:
            if sink.mode not in bufs:
                bufs[sink.mode] = encode_push(frame, sink.mode)
        with self._lock:
            self.frames += 1
            self.encodes += len(bufs)
        try:
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.counter("wire.push.encodes", len(bufs))
        except Exception:
            pass  # metrics are best-effort: never drop a push frame
        n = 0
        # threaded mirrors first: the owner's synchronous write may
        # raise (that is its flush-requeue contract) and must not
        # starve the mirrors of a frame that was already encoded
        for sink in sorted(sinks, key=lambda s: not s.threaded):
            sink.offer(bufs[sink.mode])
            n += 1
        with self._lock:
            self.fanout += n
        return n

    # -- introspection / lifecycle -----------------------------------------

    def stats(self) -> dict:
        with self._lock:
            sinks = list(self._sinks.values())
            attached = {k: len(v) for k, v in self._attached.items() if v}
            frames, encodes, fanout = self.frames, self.encodes, self.fanout
        snaps = [s.snapshot() for s in sinks]
        return {
            "sinks": len(sinks),
            "attached": attached,
            "frames": frames,
            "encodes": encodes,
            "fanout": fanout,
            "sent": sum(sent for sent, _, _ in snaps),
            "dropped": sum(d for _, d, _ in snaps),
            "dead": sum(1 for _, _, dead in snaps if dead),
        }

    def close(self) -> None:
        with self._lock:
            sinks = list(self._sinks.values())
            self._sinks.clear()
            self._attached.clear()
        for s in sinks:
            s.close()


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
