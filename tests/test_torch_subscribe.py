"""The port's standing queries (`geomesa_tpu_torch.subscribe`) against the
reference's, on the CPU.

Each test drives a reference `SubscriptionManager` over a reference
`KafkaDataStore` and the port's over the port's (`device="cpu"`) through
the same seeded batches, deletes and clears, in lockstep, and compares
after every poll:

- each predicate subscription's matched set (after the f64 band refine)
  between the packages and against a fresh one-shot `get_features` of
  the port's store;
- every pushed frame, with subscription ids mapped to registration order
  (each package numbers its own);
- density grids, and the evaluator's folds and device calls
  (`dispatches`, `lane_dispatches`).

The classes mirror `tests/test_subscribe.py`, at sizes where the
reference side is cheap (no test registers more than 64 subscriptions):
incremental parity over 20 batches with lanes on and off, exactly-once
under a `kafka.poll` and a `subscribe.eval` fault, slow consumers,
quarantine, lifecycle, expiry, lane churn, handoff and `run_subscribe`.
The reference's recompile counters have no meaning in eager PyTorch;
what is held instead is that churn inside a lane bucket reallocates no
table and a bucket's growth reallocates it once.
"""

import numpy as np
import pytest

from geomesa_tpu import faults as rf
from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.kafka import KafkaDataStore as RKafka
from geomesa_tpu.plan.query import Query as RQuery
from geomesa_tpu.serve import loadgen as rload
from geomesa_tpu.serve.scheduler import QueryRejected as RRejected
from geomesa_tpu import subscribe as rsub
from geomesa_tpu_torch import faults as pf
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.engine.density import grid_consts
from geomesa_tpu_torch.kafka import KafkaDataStore as PKafka
from geomesa_tpu_torch.plan.query import Query as PQuery
from geomesa_tpu_torch.serve import loadgen as pload
from geomesa_tpu_torch.serve.scheduler import QueryRejected as PRejected
from geomesa_tpu_torch import subscribe as psub

SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
N_FIDS = 48
BOX = "BBOX(geom, -20, -15, 25, 20)"
POLY = ("INTERSECTS(geom, POLYGON((-40 -20, 10 -25, 30 15, -25 22,"
        " -40 -20)))")
CQLS = [BOX, "BBOX(geom, -50, -25, -10, 5)",
        "DWITHIN(geom, POINT(10 5), 2000000, meters)",
        "DWITHIN(geom, POINT(-30 -10), 1500000, meters)", POLY,
        "name = 'a'", "score > 0 AND BBOX(geom, -40, -30, 40, 30)",
        "BEYOND(geom, POINT(0 0), 3000000, meters)"]
WINDOWS = [((-60.0, -30.0, 60.0, 30.0), 16, 8, {}),
           ((-30.0, -20.0, 30.0, 20.0), 12, 10, {"weight_attr": "score"}),
           ((-60.0, -30.0, 60.0, 30.0), 8, 4, {"decay": 0.5}),
           ((-180.0, -90.0, 180.0, 90.0), 16, 8, {"tolerance": 0.5})]

PKG = {"ref": (RKafka, rsub, RFB, RSFT, RQuery, rf),
       "port": (lambda: PKafka(device="cpu"), psub, PFB, PSFT, PQuery, pf)}


def rows(seed, fids):
    rng = np.random.default_rng(seed)
    n = len(fids)
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-5, 5, n),
            "dtg": rng.integers(1_590_000_000_000, 1_600_000_000_000, n),
            "geom": np.stack([rng.uniform(-60, 60, n),
                              rng.uniform(-30, 30, n)], 1)}


class Side:
    """One package's live store, manager and pushed frames."""

    def __init__(self, pkg, **config):
        store_cls, sub, fb, sft_cls, query, faults = PKG[pkg]
        self.pkg, self.sub, self.fb, self.query = pkg, sub, fb, query
        self.faults = faults
        self.sft = sft_cls.from_spec("live", SPEC)
        self.store = store_cls()
        self.src = self.store.create_schema(self.sft)
        self.mgr = sub.SubscriptionManager(self.store,
                                           sub.SubscribeConfig(**config))
        self.subs = []
        self.frames = []

    def subscribe(self, cql=None, window=None, **kw):
        if window is not None:
            bbox, w, h, extra = window
            kw["density"] = self.sub.DensityWindow(bbox, w, h, **extra)
        s = self.mgr.subscribe("live", cql or "INCLUDE", **kw)
        self.subs.append(s)
        return s

    def write(self, seed, fids):
        self.store.write("live", self.fb.from_pydict(self.sft, rows(seed, fids),
                                                     fids=list(fids)))

    def flush(self):
        return self.mgr.flush(self.frames.append)

    def oneshot(self, cql):
        res = self.src.get_features(self.query("live", cql))
        return set() if res.features is None else set(res.features.fids.decode())

    def norm_frames(self):
        ids = {s.sub_id: i for i, s in enumerate(self.subs)}
        return [dict(f, subscription=ids.get(f.get("subscription"), "?"))
                for f in self.frames]


def both(**config):
    return Side("ref", **config), Side("port", **config)


def replay(frames, k) -> set:
    """The matched set subscription `k`'s frames replay to, asserting no
    duplicate enter and no phantom exit."""
    state = set()
    for f in sorted((f for f in frames if f.get("subscription") == k
                     and f.get("event") in ("enter", "exit", "state")),
                    key=lambda f: f["seq"]):
        if f["event"] == "state":
            state = set(f["fids"])
        elif f["event"] == "enter":
            assert not set(f["fids"]) & state, "duplicate enter"
            state |= set(f["fids"])
        else:
            assert set(f["fids"]) <= state, "phantom exit"
            state -= set(f["fids"])
    return state


def density_oracle(window, batch):
    """f64 grid of a snapshot with the port's one-shot f32 binning."""
    bbox, w, h, extra = window
    grid = np.zeros((h, w), np.float64)
    if batch is None or len(batch) == 0:
        return grid
    col = batch.columns["geom"]
    xmin, dx, ymin, dy = grid_consts(bbox, w, h)
    c = np.floor((np.asarray(col.x, np.float32) - xmin) / dx)
    r = np.floor((np.asarray(col.y, np.float32) - ymin) / dy)
    inb = (c >= 0) & (c < w) & (r >= 0) & (r < h)
    wt = (np.asarray(batch.columns[extra["weight_attr"]], np.float64)
          if "weight_attr" in extra else np.ones(len(batch)))
    np.add.at(grid, (r[inb].astype(int), c[inb].astype(int)), wt[inb])
    return grid


def check(ref, port, tag=""):
    """Matched sets, frames and grids equal across packages; the port's
    matched sets equal its one-shot answers."""
    assert port.norm_frames() == ref.norm_frames(), tag
    for k, (r, p) in enumerate(zip(ref.subs, port.subs)):
        if p.status not in ("active", "paused"):
            continue
        if p.density is None:
            assert p.matched == r.matched, (tag, p.cql)
            assert p.matched == port.oneshot(p.cql), (tag, p.cql)
            assert replay(port.norm_frames(), k) == p.matched, (tag, p.cql)
        else:
            np.testing.assert_array_equal(p.grid, r.grid, err_msg=tag)


@pytest.fixture(autouse=True)
def _pristine_fabric():
    for f in (rf, pf):
        f.uninstall()
        f.BREAKERS.reset()
    yield
    for f in (rf, pf):
        f.uninstall()
        f.BREAKERS.reset()


class TestIncrementalParity:
    @pytest.mark.parametrize("lanes", [True, False])
    def test_parity_over_20_batches(self, lanes):
        sides = both(lanes=lanes)
        for s in sides:
            for cql in CQLS:
                s.subscribe(cql)
            for w in WINDOWS:
                s.subscribe(window=w)
        fids = [f"f{i}" for i in range(N_FIDS)]
        base = [s.mgr.evaluator.stats() for s in sides]
        for b in range(20):
            for s in sides:
                if b == 0:
                    s.write(1000, fids)
                elif b == 7:
                    for fid in fids[:3]:
                        s.store.delete("live", fid)
                elif b == 8:
                    s.write(2000 + b, fids[:3])
                elif b == 10:
                    s.store.clear("live")
                elif b == 11:
                    s.write(3000, fids)
                else:
                    s.write(4000 + b, [fids[(b * 7 + j) % N_FIDS] for j in range(24)])
                assert s.store.poll("live") > 0
                s.flush()
            check(*sides, tag=f"batch {b}")
            snap = sides[1].store.cache("live").snapshot()
            p = sides[1].subs
            for k, w in enumerate(WINDOWS[:2]):
                np.testing.assert_allclose(p[len(CQLS) + k].grid,
                                           density_oracle(w, snap), atol=1e-9)
        ev = [s.mgr.evaluator.stats() for s in sides]
        for key in ("folds", "dispatches", "lane_dispatches", "fallbacks",
                    "events", "approx_frames"):
            got = [e.get(key, 0) - b0.get(key, 0) for e, b0 in zip(ev, base)]
            assert got[1] == got[0], (key, got)
        # lanes: bbox, dwithin, polygon and the fused remainder a delta;
        # the deletes-only and clear-only windows dispatch nothing
        assert ev[1]["dispatches"] - base[1]["dispatches"] == (4 if lanes else 1) * 18
        for s in sides:
            s.mgr.close()


class TestExactlyOnce:
    @pytest.mark.parametrize("site, error", [("kafka.poll", "unavailable"),
                                             ("subscribe.eval", "io")])
    def test_fault_then_heal(self, site, error):
        """A failed poll folds nothing; a failed evaluation keeps the
        buffer; the next poll applies the window exactly once."""
        sides = both()
        fids = [f"f{i}" for i in range(24)]
        for s in sides:
            s.subscribe(BOX)
            s.subscribe(POLY)
            s.subscribe(window=WINDOWS[0])
            s.write(1, fids)
            s.store.poll("live")
            s.flush()
            s.write(2, fids)
            plan = s.faults.FaultPlan(seed=3, rules=[s.faults.FaultRule(
                site=site, error=error, every=1, max_fires=4)])
            before = set(s.subs[0].matched)
            with s.faults.active(plan):
                if site == "kafka.poll":
                    with pytest.raises(ConnectionError):
                        s.store.poll("live")
                else:
                    assert s.store.poll("live") == 24
                s.flush()
                assert s.subs[0].matched == before
                if site == "subscribe.eval":
                    assert s.mgr.evaluator.stats()["eval_errors"] == 1
                    assert s.store.poll("live") == 0  # the next fires too
            s.faults.BREAKERS.reset("kafka")
            s.store.poll("live")  # heals: applies (or folds) the window
            if site == "subscribe.eval":
                s.mgr.evaluator.pump("live")
            s.flush()
        check(*sides)
        assert sides[1].mgr.evaluator.stats()["folds"] == 2
        for s in sides:
            s.mgr.close()


class TestSlowConsumer:
    def test_outbox_overflow_lagged_resync(self):
        sides = both(outbox_limit=3)
        fids = [f"f{i}" for i in range(16)]
        for s in sides:
            sub = s.subscribe(BOX, initial_state=False)
            for b in range(8):
                s.write(100 + b, fids)
                s.store.poll("live")
            assert sub.lagged and sub.outbox_depth() <= 3 and sub.overflows
            s.flush()
            assert [f["event"] for f in s.frames][-1] == "state"
            s.write(999, fids)
            s.store.poll("live")
            s.flush()
        check(*sides)

    def test_failing_push_sink_loses_no_frames(self):
        sides = both()
        fids = [f"f{i}" for i in range(8)]
        for s in sides:
            s.subscribe(BOX, initial_state=False)
            for b in range(3):
                s.write(40 + b, fids)
                s.store.poll("live")
            delivered = []

            def broken(frame):
                if delivered:
                    raise BrokenPipeError("sink gone")
                delivered.append(frame)

            with pytest.raises(BrokenPipeError):
                s.mgr.flush(broken)
            s.frames += delivered
            s.flush()
            seqs = [f["seq"] for f in s.frames]
            assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))
        check(*sides)

    def test_terminal_frames_and_rate_limits(self):
        got = {}
        for pkg, (_, sub, *_) in PKG.items():
            a = sub.Subscription("live", "INCLUDE", outbox_limit=2)
            for fid in "abc":
                a.offer({"event": "enter", "fids": [fid]})
            assert a.offer({"event": "enter", "fids": ["d"]}) is False
            assert a.offer({"event": "quarantined", "message": "boom"})
            b = sub.Subscription("live", "INCLUDE", rate=2.0, rate_burst=2.0,
                                 outbox_limit=64)
            for i in range(6):
                b.offer({"event": "enter", "fids": [f"f{i}"]})
            got[pkg] = ([dict(f, subscription=0) for f in a.drain()],
                        len(b.drain()), b.outbox_depth())
        assert got["port"] == got["ref"]
        assert got["port"][1:] == (2, 4)


class _Poison:
    """A compiled filter whose mask crashes (the port's signatures)."""

    filter_ast = None
    _band_fn = None

    def params(self, dev, batch):
        return {}

    def mask_fn(self):
        def bad(params, dev):
            raise RuntimeError("poisoned predicate")
        return bad

    def mask_refined(self, dev, batch):
        raise RuntimeError("poisoned predicate")


class _RefPoison(_Poison):
    def params(self, batch):
        return {}


class TestQuarantine:
    def test_crashing_predicate_quarantined(self):
        sides = both(quarantine_after=2)
        fids = [f"f{i}" for i in range(16)]
        for s, poison in zip(sides, (_RefPoison(), _Poison())):
            s.subscribe(BOX)
            s.subscribe("score > 1.5")
            s.mgr.evaluator._filters[("live", "score > 1.5")] = poison
            for b in range(3):
                s.write(200 + b, fids)
                s.store.poll("live")
                s.flush()
            ev = s.mgr.evaluator.stats()
            assert ev["fallbacks"] == 2 and ev["strikes"] == 2
            assert s.subs[1].status == "quarantined"
        rejected = (RRejected, PRejected)
        for s, rej in zip(sides, rejected):
            with pytest.raises(rej) as exc:
                s.mgr.subscribe("live", "score > 1.5")
            assert exc.value.reason == "quarantined"
        assert sides[1].norm_frames() == sides[0].norm_frames()
        assert sides[1].subs[0].matched == sides[0].subs[0].matched == \
            sides[1].oneshot(BOX)

    def test_apply_phase_crash_strikes_not_stalls(self):
        sides = both(quarantine_after=2)
        fids = [f"f{i}" for i in range(16)]
        for s in sides:
            s.subscribe(BOX)
            s.subscribe(window=WINDOWS[1])

            def boom(d, batch):
                raise RuntimeError("weights crashed")

            s.mgr.evaluator._weights = boom
            for b in range(3):
                s.write(500 + b, fids)
                s.store.poll("live")
                s.flush()
            assert s.subs[1].status == "quarantined"
            assert s.mgr.evaluator.stats()["folds"] == 3
        assert sides[1].norm_frames() == sides[0].norm_frames()
        assert sides[1].subs[0].matched == sides[1].oneshot(BOX)

    def test_quarantine_after_zero_disables(self):
        for s, poison in zip(both(quarantine_after=0), (_RefPoison(), _Poison())):
            s.subscribe("score > 1.5")
            s.mgr.evaluator._filters[("live", "score > 1.5")] = poison
            for b in range(3):
                s.write(300 + b, [f"f{i}" for i in range(8)])
                s.store.poll("live")
            assert s.subs[0].status == "active"
            assert s.mgr.evaluator.stats().get("strikes", 0) == 0

    def test_infra_errors_do_not_strike(self):
        """The serving layer's exemption: transient and OSError failures
        re-seed instead of striking. In the port a device OOM is one too
        (the reference strikes it)."""
        for s in both(quarantine_after=2):
            sub = s.subscribe(BOX)
            ev = s.mgr.evaluator
            for _ in range(3):
                ev._strike(sub, ConnectionError("broker blip"))
            ev._strike(sub, FileNotFoundError("compaction-raced read"))
            if s.pkg == "port":
                ev._strike(sub, pf.DeviceOOM("out of memory"))
            st = ev.stats()
            assert st.get("strikes", 0) == 0
            assert st["eval_errors"] == (5 if s.pkg == "port" else 4)
            assert sub.status == "active" and sub._resync_pending()


class TestLifecycle:
    def test_ttl_expiry_and_registry_transitions(self):
        for pkg in PKG:
            sub_mod = PKG[pkg][1]
            reg = sub_mod.SubscriptionRegistry()
            now = [0.0]
            sub = sub_mod.Subscription("live", "INCLUDE", ttl_s=10.0,
                                       clock=lambda: now[0])
            reg.register(sub)
            v0 = reg.version("live")
            assert reg.expire_tick(now=5.0) == []
            assert reg.expire_tick(now=11.0) == [sub]
            assert sub.status == "expired" and reg.maybe(sub.sub_id) is None
            assert reg.version("live") > v0
            assert reg.take_parting() == [sub]
            assert [f["event"] for f in sub.drain()] == ["expired"]

    def test_pause_resume_resyncs(self):
        sides = both()
        fids = [f"f{i}" for i in range(16)]
        for s in sides:
            sub = s.subscribe(BOX, initial_state=False)
            s.write(5, fids)
            s.store.poll("live")
            s.mgr.pause(sub.sub_id)
            assert s.mgr.registry.active_for("live") == []
            s.flush()
            assert s.frames == []
            s.write(6, fids)
            s.store.poll("live")
            s.mgr.resume(sub.sub_id)
            s.flush()
            assert any(f["event"] == "state" for f in s.frames)
        check(*sides)
        for s in sides:
            s.mgr.unsubscribe(s.subs[0].sub_id)
            assert len(s.mgr.registry) == 0

    def test_close_detaches_store_hooks(self):
        s = Side("port")
        s.subscribe(BOX)
        s.write(1, [f"f{i}" for i in range(8)])
        s.store.poll("live")
        assert s.mgr.evaluator.stats()["folds"] == 1
        s.mgr.close()
        assert s.store._fold_hooks == []
        s.write(2, [f"f{i}" for i in range(8)])
        s.store.poll("live")
        assert s.mgr.evaluator.stats()["folds"] == 1
        st = s.mgr.evaluator._state("live")
        assert st.buffer == [] and not st.listening

    def test_subscribe_validation(self):
        errors = {}
        for s in both(max_subscriptions=1):
            got = []
            for kw in ({"cql": "nosuch = 3"},
                       {"window": ((-60, -30, 60, 30), 8, 4, {"weight_attr": "nosuch"})},
                       {"window": ((-60, -30, 60, 30), 8, 4, {"weight_attr": "name"})}):
                with pytest.raises(ValueError) as e:
                    s.subscribe(**kw)
                got.append(str(e.value))
            with pytest.raises(KeyError):
                s.mgr.subscribe("ghost", "INCLUDE")
            s.subscribe("INCLUDE")
            with pytest.raises(Exception) as e:
                s.subscribe("name = 'a'")
            got.append(e.value.reason)
            errors[s.pkg] = got
        assert errors["port"] == errors["ref"]
        assert errors["port"][-1] == "subscription_limit"


class TestExpiryEvents:
    def test_expiry_drives_geofence_exit(self):
        """Features aging out of the cache emit `removed` events that the
        next pump folds into geofence exits."""
        sides = both()
        for s in sides:
            s.subscribe("BBOX(geom, -180, -90, 180, 90)", initial_state=False)
            s.write(7, ["f0", "f1", "f2"])
            s.store.poll("live")
            cache = s.store.cache("live")
            cache.expiry_ms = 30
            cache._stamps["f0"] -= 10.0
            cache._stamps["f1"] -= 10.0
            assert cache.expire() == 2
            s.mgr.evaluator.pump("live")
            s.flush()
            exits = [f for f in s.frames if f["event"] == "exit"]
            assert exits and set(exits[-1]["fids"]) == {"f0", "f1"}
        check(*sides)


class TestLanes:
    def test_lane_vs_fused_parity_with_mid_run_churn(self):
        """lanes=True and lanes=False give the reference's answers over 12
        batches with a registration and a cancellation mid-run."""
        runs = {}
        fids = [f"f{i}" for i in range(N_FIDS)]
        for lanes in (True, False):
            sides = both(lanes=lanes)
            for s in sides:
                for cql in CQLS[:6]:
                    s.subscribe(cql)
                s.subscribe(window=WINDOWS[0])
            for b in range(12):
                for s in sides:
                    if b == 6:
                        for fid in fids[:4]:
                            s.store.delete("live", fid)
                    elif b == 7:
                        s.write(2000, fids[:4])
                    else:
                        s.write(4000 + b if b else 1000,
                                [fids[(b * 7 + j) % N_FIDS] for j in range(24)]
                                if b else fids)
                    if b == 4:
                        s.subscribe("BBOX(geom, -5, -5, 45, 25)")
                    if b == 8:
                        s.mgr.unsubscribe(s.subs[0].sub_id)
                    s.store.poll("live")
                    s.flush()
                check(*sides, tag=f"lanes={lanes} batch {b}")
            runs[lanes] = sides
        lane = runs[True][1].mgr.stats()["lanes"]
        assert lane["classes"]["bbox"]["rows"] == 2
        assert lane["classes"]["dwithin"]["rows"] == 2
        assert lane["classes"]["polygon"]["rows"] == 1
        assert lane["ineligible"] == {"non_spatial": 1}
        assert lane == runs[True][0].mgr.stats()["lanes"]
        assert runs[False][1].mgr.stats()["lanes"]["classes"] == {}
        for k in range(len(runs[True][1].subs)):
            a, b = runs[True][1].subs[k], runs[False][1].subs[k]
            if a.density is None and a.status == "active":
                assert a.matched == b.matched
        for sides in runs.values():
            for s in sides:
                s.mgr.close()

    def test_churn_inside_a_bucket_reallocates_nothing(self):
        """Cancel + register recycle rows of the 8-row bucket; growth past
        it reallocates the table once; answers equal the reference's."""
        sides = both(max_subscriptions=64)
        fids = [f"f{i}" for i in range(96)]
        rng = np.random.default_rng(1)
        boxes = []
        for _ in range(40):
            x0, y0 = float(rng.uniform(-60, 20)), float(rng.uniform(-30, 5))
            boxes.append(f"BBOX(geom, {x0}, {y0}, {x0 + 8}, {y0 + 6})")
        nxt = [0, 0]

        def reg(s, i, k):
            for _ in range(k):
                s.subscribe(boxes[nxt[i]])
                nxt[i] += 1

        def step(seed):
            for s in sides:
                s.write(seed, fids)
                s.store.poll("live")
                s.flush()
            check(*sides, tag=f"seed {seed}")
            return sides[1].mgr.evaluator._state("live").lanes.groups[("bbox",)]

        for i, s in enumerate(sides):
            reg(s, i, 8)
        group = step(1)
        assert group.cap == 8 and group.allocations == 1
        for k in range(5):
            for i, s in enumerate(sides):
                s.mgr.unsubscribe(s.subs[k].sub_id)
                reg(s, i, 1)
            group = step(10 + k)
        assert group.cap == 8 and group.allocations == 1, "churn reallocated"
        for i, s in enumerate(sides):
            reg(s, i, 6)
        group = step(20)
        assert group.cap == 16 and group.allocations == 2
        for k in range(5, 8):
            for i, s in enumerate(sides):
                s.mgr.unsubscribe(s.subs[k].sub_id)
                reg(s, i, 1)
            group = step(30 + k)
        assert group.cap == 16 and group.allocations == 2
        for s in sides:
            s.mgr.close()


class TestHandoff:
    def test_handoff_round_trip(self):
        sides = both()
        fids = [f"f{i}" for i in range(24)]
        out = {}
        for s in sides:
            sub = s.subscribe(BOX)
            s.write(1, fids)
            s.store.poll("live")
            s.flush()
            snap = sub.handoff_snapshot()
            assert snap["watermark"] == snap["seq"]
            s.mgr.close()
            b = s.sub.SubscriptionManager(s.store)
            with pytest.raises(ValueError):
                b.subscribe("live", "BBOX(geom, 0, 0, 1, 1)", handoff=snap)
            sub2 = b.subscribe("live", BOX, handoff=snap)
            frames = []
            b.flush(frames.append)
            s.write(2, fids)
            s.store.poll("live")
            b.flush(frames.append)
            assert sub2.matched == s.oneshot(BOX)
            with pytest.raises(ValueError):
                b.subscribe("live", density=s.sub.DensityWindow(
                    (-60.0, -30.0, 60.0, 30.0), 8, 4), handoff=snap)
            out[s.pkg] = (snap, [dict(f, subscription=0) for f in frames],
                          sub2.matched)
            b.close()
        assert out["port"] == out["ref"]
        snap, frames, _ = out["port"]
        assert frames[0]["event"] == "state" and frames[0]["seq"] == snap["watermark"] + 1


class TestLoadgen:
    def test_run_subscribe_reports(self):
        fids = [f"f{i}" for i in range(24)]
        reps = {}
        for pkg, mod in (("ref", rload), ("port", pload)):
            s = Side(pkg)
            rep = mod.run_subscribe(
                s.store, "live",
                lambda i, s=s: s.fb.from_pydict(s.sft, rows(700 + i, fids), fids=fids),
                subscriptions=3, batches=4)
            reps[pkg] = rep
            mgr = s.sub.SubscriptionManager(s.store)
            mod.run_subscribe(s.store, "live", lambda i, s=s: s.fb.from_pydict(
                s.sft, rows(800 + i, fids), fids=fids), subscriptions=3, batches=2,
                manager=mgr)
            assert len(mgr.registry) == 0
            mgr.close()
        for key in ("mode", "subscriptions", "batches", "events_total",
                    "dispatches"):
            assert getattr(reps["port"], key) == getattr(reps["ref"], key), key
        assert reps["port"].dispatches == 12 and reps["port"].events_total > 0

    def test_run_subscribe_lanes_matches_the_reference_events(self):
        fids = [f"f{i}" for i in range(N_FIDS)]
        reps = {}
        for pkg, mod in (("ref", rload), ("port", pload)):
            def make_store(pkg=pkg):
                return Side(pkg).store

            sft = Side(pkg)

            def batch(i, s=sft):
                return s.fb.from_pydict(s.sft, rows(600 + i, fids), fids=fids)

            reps[pkg] = mod.run_subscribe_lanes(make_store, "live", batch,
                                                subscriptions=32, batches=2)
        for mode in ("lanes", "fused"):
            for key in ("polls", "events_total", "dispatches", "lane_dispatches"):
                assert reps["port"][mode][key] == reps["ref"][mode][key], (mode, key)
