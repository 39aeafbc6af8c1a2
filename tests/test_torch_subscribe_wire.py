"""The port's standing-query wire against the reference's, on the CPU.

Both packages serve a live (Kafka) store written with the same seeded
rows, over `MemoryWire`-style conversations run by `serve_connection`
on a thread each (one service per package, shared by its connections):

- the seven subscribe verbs (`subscribe`, `poll`, `pause`, `resume`,
  `export_subscription`, `subscriptions`, `unsubscribe`), the hello's
  `rehome` capability and the stats verb's handoff checkpoints answer
  as the reference's, push frames and all, in stream order (each
  package's subscription ids mapped to registration order);
- `attach`/`detach` mirror one connection's subscription onto others in
  JSON and in columnar framing: the mirrored frames decode to the
  owner's, and `PushMux` encodes each frame once per wire mode;
- `PushMux` fans one encode to a thousand sinks;
- a failed poll answers the auto-poll pump with a typed `poll_error`
  frame, and the pump (`ServeConfig.subscribe_poll_ms`) delivers frames
  without a poll verb.
"""

import json
import queue
import re
import threading
import time

import numpy as np
import pytest

import geomesa_tpu.serve as rserve
import geomesa_tpu.serve.protocol as rproto
import geomesa_tpu_torch.serve as pserve
import geomesa_tpu_torch.serve.protocol as pproto
from geomesa_tpu import faults as rf
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.kafka import KafkaDataStore as RKafka
from geomesa_tpu.serve import columnar as rcol
from geomesa_tpu_torch import faults as pf
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.kafka import KafkaDataStore as PKafka
from geomesa_tpu_torch.serve import columnar as pcol

SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
BOX = "BBOX(geom, -20, -15, 25, 20)"
POLY = "INTERSECTS(geom, POLYGON((-40 -20, 10 -25, 30 15, -25 22, -40 -20)))"
DENS = {"bbox": [-60, -30, 60, 30], "width": 8, "height": 4}
FIDS = [f"f{i}" for i in range(24)]

PKG = {"ref": (RKafka, rserve, rproto, rcol, RFB, RSFT, rf),
       "port": (lambda: PKafka(device="cpu"), pserve, pproto, pcol, PFB, PSFT, pf)}


def rows(seed, fids=FIDS):
    rng = np.random.default_rng(seed)
    n = len(fids)
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-5, 5, n),
            "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
            "geom": np.stack([rng.uniform(-60, 60, n),
                              rng.uniform(-30, 30, n)], 1)}


class Live:
    """One package's live store and service, and its connections."""

    def __init__(self, pkg, **config):
        store_cls, serve, proto, col, fb, sft_cls, faults = PKG[pkg]
        self.pkg, self.proto, self.col, self.faults = pkg, proto, col, faults
        self.fb = fb
        self.sft = sft_cls.from_spec("live", SPEC)
        self.store = store_cls()
        self.store.create_schema(self.sft)
        self.svc = serve.QueryService(self.store, serve.ServeConfig(
            max_wait_ms=0.0, **config))
        self.conns = []

    def write(self, seed, fids=FIDS):
        self.store.write("live", self.fb.from_pydict(self.sft, rows(seed, fids),
                                                     fids=list(fids)))

    def connect(self, binary=True):
        c = Conn(self, binary)
        self.conns.append(c)
        return c

    def close(self):
        for c in self.conns:
            c.close()
        self.svc.close(drain=True)


class Conn:
    """serve_connection on a thread, fed one line at a time."""

    def __init__(self, live, binary):
        self.col = live.col
        self.lines: "queue.Queue" = queue.Queue()
        self.out = bytearray()
        self.lock = threading.Lock()

        def write_bytes(b):
            with self.lock:
                self.out.extend(b)

        kw = {"write_bytes": write_bytes} if binary else {}
        self.thread = threading.Thread(
            target=live.proto.serve_connection,
            args=(live.store, live.svc, iter(self.lines.get, None),
                  lambda s: write_bytes(s.encode())), kwargs=kw, daemon=True)
        self.thread.start()

    def docs(self):
        with self.lock:
            data = bytes(self.out)
        return [self.col.decode_push(d, p) for d, p in self.col.parse_stream(data)]

    def ask(self, doc, timeout_s=30.0):
        """Send one request and wait for its response."""
        self.lines.put(json.dumps(doc))
        return self.wait(lambda ds: any(d.get("id") == doc["id"] for d in ds),
                         timeout_s)

    def wait(self, cond, timeout_s=30.0):
        deadline = time.monotonic() + timeout_s
        while True:
            ds = self.docs()
            if cond(ds):
                return ds
            assert time.monotonic() < deadline, ds
            time.sleep(0.005)

    def answer(self, rid):
        return next(d for d in self.docs() if d.get("id") == rid)

    def close(self):
        self.lines.put(None)
        self.thread.join(timeout=30.0)
        assert not self.thread.is_alive()


def normalized(docs):
    """JSON text of `docs` with subscription ids numbered by first use."""
    text = json.dumps(docs, sort_keys=True)
    ids = {}
    return re.sub(r"sub-\d+", lambda m: ids.setdefault(m.group(0), f"S{len(ids)}"),
                  text)


@pytest.fixture(autouse=True)
def _pristine_fabric():
    for f in (rf, pf):
        f.uninstall()
        f.BREAKERS.reset()
    yield
    for f in (rf, pf):
        f.uninstall()
        f.BREAKERS.reset()


def converse(live):
    """The seven verbs on one JSON connection; returns every doc."""
    a = live.connect(binary=False)
    a.ask({"id": "h", "op": "hello"})
    sid = {}
    for rid, extra in (("s1", {"cql": BOX}), ("s2", {"density": DENS}),
                       ("s3", {"cql": POLY})):
        a.ask({"id": rid, "op": "subscribe", "typeName": "live", **extra})
        sid[rid] = a.answer(rid)["subscription"]
    live.write(1)
    a.ask({"id": "p1", "op": "poll"})
    a.ask({"id": "pa", "op": "pause", "subscription": sid["s1"]})
    live.write(2)
    a.ask({"id": "p2", "op": "poll"})
    a.ask({"id": "re", "op": "resume", "subscription": sid["s1"]})
    a.ask({"id": "r2", "op": "resume", "subscription": sid["s1"]})
    a.ask({"id": "x1", "op": "export_subscription", "subscription": sid["s1"]})
    a.ask({"id": "x2", "op": "export_subscription", "subscription": "sub-999999"})
    a.ask({"id": "x3", "op": "export_subscription", "subscription": sid["s2"]})
    a.ask({"id": "ls", "op": "subscriptions"})
    a.ask({"id": "st", "op": "stats"})
    a.ask({"id": "u1", "op": "unsubscribe", "subscription": sid["s1"]})
    a.ask({"id": "u2", "op": "unsubscribe", "subscription": "sub-999999"})
    a.ask({"id": "bad", "op": "subscribe", "typeName": "live", "cql": "nosuch = 1"})
    live.write(3)
    a.ask({"id": "p3", "op": "poll"})
    docs = a.docs()
    for d in docs:
        if d.get("id") == "st":  # the checkpoints and subscription stats only
            d["stats"] = {k: d["stats"][k] for k in ("subscriptions", "subs_checkpoint")}
        if d.get("id") == "bad":  # the parsers' messages differ in wording
            d.pop("message")
    return docs


def test_subscribe_verbs_answer_as_reference():
    got = {}
    for pkg in PKG:
        live = Live(pkg)
        try:
            got[pkg] = converse(live)
        finally:
            live.close()
    assert normalized(got["port"]) == normalized(got["ref"])
    by_id = {d["id"]: d for d in got["port"] if "id" in d}
    assert by_id["h"]["rehome"] is True
    assert by_id["p1"]["applied"] == {"live": 24} and by_id["p1"]["frames"] >= 2
    assert by_id["pa"]["status"] == "paused" and by_id["re"]["status"] == "active"
    assert by_id["r2"]["ok"] is False
    assert by_id["x1"]["ok"] and by_id["x1"]["handoff"]["cql"] == BOX
    assert by_id["x2"]["message"] == "no such subscription"
    assert by_id["x3"]["ok"] is False
    assert by_id["ls"]["subscriptions"] == 3
    assert by_id["u1"]["status"] == "cancelled" and by_id["u2"]["ok"] is False
    assert by_id["bad"]["ok"] is False
    events = {d["event"] for d in got["port"] if "event" in d}
    assert {"state", "enter", "exit", "density"} <= events


def mirror(live):
    """Owner connection A (JSON) subscribes; B attaches in JSON, C in
    columnar; A polls; B detaches; A polls again."""
    a, b, c = live.connect(binary=False), live.connect(), live.connect()
    a.ask({"id": "s1", "op": "subscribe", "typeName": "live", "cql": BOX})
    a.ask({"id": "s2", "op": "subscribe", "typeName": "live", "density": DENS})
    sid = a.answer("s1")["subscription"]
    b.ask({"id": "at", "op": "attach", "subscription": sid})
    c.ask({"id": "at", "op": "attach", "subscription": sid, "wire": "columnar"})
    c.ask({"id": "none", "op": "attach", "subscription": "sub-999999"})
    live.write(1)
    a.ask({"id": "p1", "op": "poll"})

    def has_enter(ds):
        return any(d.get("event") == "enter" for d in ds)

    b.wait(has_enter)
    c.wait(has_enter)
    b.ask({"id": "dt", "op": "detach", "subscription": sid})
    live.write(2)
    a.ask({"id": "p2", "op": "poll"})
    owner = [d for d in a.docs() if d.get("subscription") == sid and "event" in d]
    c.wait(lambda ds: len([d for d in ds if "event" in d]) == len(owner) - 1)
    time.sleep(0.05)
    wire = live.svc.stats()["wire"]
    return a.docs(), b.docs(), c.docs(), owner, wire


def test_attach_and_detach_mirror_in_both_modes():
    got = {}
    for pkg in PKG:
        live = Live(pkg)
        try:
            got[pkg] = mirror(live)
        finally:
            live.close()
    a, b, c, owner, wire = got["port"]
    mirrored = [d for d in owner if d["event"] != "state"]  # before the attach
    c_frames = [d for d in c if "event" in d]
    b_frames = [d for d in b if "event" in d]
    assert c_frames == mirrored and b_frames == mirrored[:len(b_frames)]
    assert 0 < len(b_frames) < len(c_frames), "detach stopped B's mirror"
    at = [d for d in c if d.get("id") == "at"][0]
    assert at["wireMode"] == "columnar" and at["sinks"] == 2
    assert [d for d in c if d.get("id") == "none"][0]["ok"] is False
    # one encode per wire mode a frame meets: json (A, B) + columnar (C)
    assert wire["encodes"] < wire["fanout"]
    for pkg in PKG:
        got[pkg] = [normalized(x) for x in got[pkg][:4]] + [got[pkg][4]]
        for k in ("sinks", "attached", "dropped", "dead"):
            got[pkg][4].pop(k, None)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("pkg", list(PKG))
def test_push_mux_one_encode_at_many_sinks(pkg):
    col = PKG[pkg][3]
    mux = col.PushMux()
    bufs = [[] for _ in range(1000)]
    sinks = [mux.register(bufs[i].append, mode="columnar" if i % 2 else "json",
                          threaded=False) for i in range(1000)]
    for s in sinks:
        mux.attach(s, "sub-x")
    frame = {"event": "enter", "subscription": "sub-x", "seq": 1,
             "fids": [f"f{j}" for j in range(64)]}
    for k in range(7):
        assert mux.route(dict(frame, seq=k + 1)) == 1000
    st = mux.stats()
    assert (st["frames"], st["encodes"], st["fanout"]) == (7, 14, 7000)
    assert all(len(b) == 7 for b in bufs)
    assert json.loads(bufs[0][0].decode()) == frame
    (doc, payload), = col.parse_stream(bufs[1][0])
    assert col.decode_push(doc, payload) == frame
    assert bufs[3][0] is bufs[1][0], "one buffer shared by the sinks of a mode"
    mux.close()


def test_push_mux_stats_equal_the_references():
    stats = {}
    for pkg in PKG:
        col = PKG[pkg][3]
        mux = col.PushMux(queue_limit=64)
        got = []
        owner = mux.register(got.append, mode="json", threaded=False)
        mirror_ = mux.register(got.append, mode="columnar", threaded=True)
        mux.attach(mirror_, "s")
        for k in range(5):
            mux.route({"event": "exit", "subscription": "s", "seq": k + 1,
                       "fids": ["a", "b"]}, owner=owner)
        mux.route({"event": "density", "subscription": "t", "seq": 1,
                   "total": 3.0}, owner=owner)
        deadline = time.monotonic() + 10
        while mux.stats()["sent"] < 11 and time.monotonic() < deadline:
            time.sleep(0.005)
        stats[pkg] = mux.stats()
        mux.close()
    assert stats["port"] == stats["ref"]
    assert stats["port"]["encodes"] == 11


def test_poll_error_frame_answers_as_reference():
    out = {}
    for pkg in PKG:
        live = Live(pkg)
        pushed = []
        session = live.proto._SubscribeSession(live.store, live.svc, pushed.append,
                                               push=pushed.append)
        try:
            session.handle("s1", {"op": "subscribe", "typeName": "live", "cql": BOX})
            live.write(1)
            f = live.faults
            plan = f.FaultPlan(seed=3, rules=[f.FaultRule(
                site="kafka.poll", error="unavailable", every=1, max_fires=4)])
            with f.active(plan):
                assert session.pump_once() == 0
            f.BREAKERS.reset("kafka")
            assert session.pump_once() >= 1
            out[pkg] = pushed
        finally:
            session.close()
            live.close()
    assert normalized(out["port"]) == normalized(out["ref"])
    err = [d for d in out["port"] if d.get("event") == "poll_error"]
    assert err and err[0]["error"] == "InjectedUnavailable"


def test_auto_poll_pump_delivers_frames():
    live = Live("port", subscribe_poll_ms=5.0)
    try:
        a = live.connect(binary=False)
        a.ask({"id": "s1", "op": "subscribe", "typeName": "live", "cql": BOX})
        live.write(1)
        a.wait(lambda ds: any(d.get("event") == "enter" for d in ds))
        assert live.svc.subscriptions is not None
        assert live.svc.stats()["subscriptions"]["subscriptions"] == 1
    finally:
        live.close()
    assert live.svc.subscriptions is None
