"""Subscription registry: standing queries over the Kafka live layer.

Parity role: the GeoMesa Kafka layer's KafkaFeatureEventSource consumers
plus `geomesa-process` analytics run continuously [upstream, unverified]
— a client registers a long-lived predicate (CQL / BBOX / DWITHIN
geofence) or a density/heatmap window and receives incremental push
updates as Kafka batches fold in, instead of re-issuing one-shot
queries.

This module is the STATE side of the subsystem (docs/SERVING.md
"Standing queries"): `Subscription` objects carry the standing query,
its per-subscription state (the matched-fid set that gives geofence
enter/exit semantics; the grid + per-fid contribution map that gives
incremental density), a bounded outbox of pending event frames, a
per-subscription push rate limit, and lifecycle (active / paused /
cancelled / expired / quarantined, TTL expiry). `SubscriptionRegistry`
is the thread-safe directory the evaluator reads; every membership or
lifecycle change bumps a per-type VERSION, the membership key the
evaluator reads with each atomic snapshot (subscribe/evaluator.py).

Slow consumers (docs/SERVING.md "Backpressure and lagged
subscriptions"): an outbox past its bound flips the subscription into
lagged mode — pending events are dropped for a single typed
`subscription_lagged` frame, incremental delivery is suspended, and the
next successful flush re-syncs the client with a full `state` frame
before incremental frames resume. Memory stays bounded; the client is
TOLD it missed events instead of silently losing them.

A copy of the reference package's `subscribe/registry.py`.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

# subscription lifecycle states
STATUSES = ("active", "paused", "cancelled", "expired", "quarantined")

_ids = itertools.count(1)


def _next_id() -> str:
    return f"sub-{next(_ids)}"


@dataclasses.dataclass
class DensityWindow:
    """A standing density/heatmap window: the DensityScan envelope +
    grid shape, folded incrementally (engine/density.py binning)."""

    bbox: Tuple[float, float, float, float]
    width: int
    height: int
    weight_attr: Optional[str] = None
    # fading-heatmap mode: grid *= decay per folded batch, no per-fid
    # subtraction (the exact incremental contract — and the parity test
    # — applies only when decay is None)
    decay: Optional[float] = None
    # approximate mode (docs/SERVING.md "Approximate answers"): a
    # tolerance turns this into a SKETCH-BACKED window — per poll the
    # evaluator folds the delta into one shared host-side occupancy
    # grid per type (NO device dispatch, however many subscribers) and
    # pushes typed `approx_density` frames carrying the resample bound.
    # Incompatible with weight_attr/decay (per-subscription semantics a
    # shared grid cannot carry) — validated at subscribe time.
    tolerance: Optional[float] = None

    def __post_init__(self):
        if self.width < 1 or self.height < 1:
            raise ValueError("density window needs width/height >= 1")
        x0, y0, x1, y1 = self.bbox
        if not (x1 > x0 and y1 > y0):
            raise ValueError(f"degenerate density bbox {self.bbox}")
        if self.decay is not None and not 0.0 < self.decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        if self.tolerance is not None:
            if self.tolerance <= 0.0:
                raise ValueError("density tolerance must be > 0")
            if self.weight_attr is not None or self.decay is not None:
                raise ValueError(
                    "approximate density (tolerance) does not support "
                    "weight_attr or decay — the shared sketch grid is "
                    "unweighted and exact-incremental")

    @property
    def approx(self) -> bool:
        return self.tolerance is not None


class Subscription:
    """One standing query. State transitions and outbox appends are
    guarded by the instance lock; the evaluator mutates matched/grid
    state only from its own serialized fold path."""

    def __init__(
        self,
        type_name: str,
        cql: str = "INCLUDE",
        density: Optional[DensityWindow] = None,
        tenant: str = "",
        sub_id: Optional[str] = None,
        ttl_s: Optional[float] = None,
        outbox_limit: int = 1024,
        rate: Optional[float] = None,
        rate_burst: float = 8.0,
        initial_state: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        if outbox_limit < 2:
            # the lagged frame itself needs a slot after overflow clears
            raise ValueError("outbox_limit must be >= 2")
        self.sub_id = sub_id or _next_id()
        self.type_name = type_name
        self.cql = cql
        self.density = density
        self.tenant = tenant
        self.clock = clock
        self.registered_at = clock()
        self.expires_at = (clock() + ttl_s) if ttl_s else None
        self.outbox_limit = outbox_limit
        self.initial_state = initial_state
        self.status = "active"
        self.lagged = False
        # set by the evaluator after a crashed fold: the next clean
        # fold re-seeds state from the live snapshot (lagged hand-off)
        self._resync = False
        # per-subscription push rate limit (frames/s): reuses the serve
        # scheduler's TokenBucket; None = unlimited
        self._bucket = None
        if rate is not None:
            from geomesa_tpu_torch.serve.scheduler import TokenBucket

            self._bucket = TokenBucket(rate, rate_burst)
        self._lock = threading.Lock()
        self._outbox: "deque[dict]" = deque()
        self._seq = 0
        # evaluator-owned incremental state (mutated only under the
        # evaluator's per-type fold serialization):
        self.matched: Set[str] = set()
        self.grid: Optional[np.ndarray] = None
        # fid -> (row, col, weight): the contribution to subtract when
        # the feature moves or leaves (exact incremental density)
        self.contrib: Dict[str, Tuple[int, int, float]] = {}
        if density is not None:
            self.grid = np.zeros((density.height, density.width),
                                 np.float64)
        # counters (introspection / bench): events offered, frames
        # drained, overflows
        self.events_offered = 0
        self.overflows = 0

    # -- identity ----------------------------------------------------------

    @property
    def mode(self) -> str:
        if self.density is None:
            return "predicate"
        return "approx_density" if self.density.approx else "density"

    def fingerprint(self) -> tuple:
        """Quarantine key: the predicate identity, NOT the sub id — a
        crashing predicate must stay blocked when re-registered under a
        fresh id (same stance as serve's coalescing fingerprint)."""
        if self.density is not None:
            d = self.density
            return ("subscribe", self.type_name, "density", d.bbox,
                    d.width, d.height, d.weight_attr, d.tolerance)
        return ("subscribe", self.type_name, "predicate", self.cql)

    # -- lifecycle ---------------------------------------------------------

    @property
    def live(self) -> bool:
        return self.status == "active"

    def expired(self, now: Optional[float] = None) -> bool:
        if self.expires_at is None:
            return False
        return (now if now is not None else self.clock()) >= self.expires_at

    def touch(self, ttl_s: Optional[float]) -> None:
        """Extend the TTL (client keep-alive)."""
        if ttl_s:
            self.expires_at = self.clock() + ttl_s

    # -- outbox ------------------------------------------------------------

    def offer(self, event: dict) -> bool:
        """Queue one event frame for push. Returns False when the
        subscription is lagged (event dropped by contract — a `state`
        re-sync frame replaces the missed window at the next flush).
        Overflow flips lagged mode: the queue is cleared down to one
        typed `subscription_lagged` frame so memory never grows past
        the bound."""
        terminal = event.get("event") in ("expired", "quarantined")
        with self._lock:
            self.events_offered += 1
            if self.lagged and not terminal:
                # lagged drops INCREMENTAL events (the state re-sync
                # replaces them) — but a terminal frame is the last
                # thing the client will ever hear; dropping it would
                # leave them waiting forever on a dead subscription
                return False
            if not terminal and len(self._outbox) >= self.outbox_limit:
                self.overflows += 1
                self.lagged = True
                dropped = len(self._outbox)
                self._outbox.clear()
                self._seq += 1
                self._outbox.append({
                    "event": "subscription_lagged",
                    "subscription": self.sub_id,
                    "seq": self._seq,
                    "dropped": dropped + 1,
                    "message": ("outbox overflow: incremental events "
                                "dropped; a state re-sync frame follows"),
                })
                self._note_lagged()
                return False
            self._seq += 1
            event = dict(event)
            event.setdefault("subscription", self.sub_id)
            event["seq"] = self._seq
            self._outbox.append(event)
            return True

    def _note_lagged(self) -> None:
        # under self._lock: cheap bookkeeping only (GT17 discipline —
        # the recorder append is a dict+deque, never I/O)
        try:
            from geomesa_tpu_torch.telemetry.recorder import RECORDER
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.counter("subscribe.lagged")
            RECORDER.note_event("subscribe", action="lagged",
                                subscription=self.sub_id,
                                tenant=self.tenant)
        except Exception:
            pass  # observability must never fail the fold

    def drain(self, limit: Optional[int] = None) -> List[dict]:
        """Pop queued frames for push, honoring the per-subscription
        rate limit (frames stay queued when the bucket is empty —
        backpressure into the bounded outbox, which is what eventually
        trips lagged mode for a chronically slow consumer). Draining
        the lagged marker frame arms a one-shot `state` re-sync: the
        flusher appends it and clears lagged mode."""
        out: List[dict] = []
        with self._lock:
            while self._outbox:
                if limit is not None and len(out) >= limit:
                    break
                if self._bucket is not None and not self._bucket.try_acquire():
                    break
                out.append(self._outbox.popleft())
        return out

    def resync_frame(self) -> dict:
        """The latest-state-only frame that ends a lagged window: the
        full matched set (or density total), after which incremental
        delivery resumes."""
        with self._lock:
            return self._resync_frame_locked()

    def queue_state_frame(self) -> None:
        """Queue the registration-time `state` frame: built AND
        enqueued under one lock so its seq is stamped exactly once
        (routing it through offer() would re-stamp, and the client's
        first frame would arrive seq=2 — a phantom gap under the
        monotonic-seq contract)."""
        with self._lock:
            self._outbox.append(self._resync_frame_locked())

    def take_resync_frame(self) -> Optional[dict]:
        """The lagged hand-off, checked-and-built atomically: returns
        the state frame only while still lagged with a drained outbox.
        A fold's offer() landing between the flusher's drain and this
        call forfeits the hand-off for the cycle (the next flush
        retries) — otherwise the state frame would outrun the queued
        increment's seq and the client would see non-monotonic
        sequence numbers."""
        with self._lock:
            if not (self.lagged and not self._outbox and self.live):
                return None
            return self._resync_frame_locked()

    def _resync_frame_locked(self) -> dict:
        self._seq += 1
        self.lagged = False
        # state reads stay under the lock: the evaluator mutates
        # the grid in place under the same lock, so a flush racing
        # a fold never serializes a half-applied grid
        frame = {"event": "state", "subscription": self.sub_id,
                 "seq": self._seq}
        if self.density is not None:
            frame["shape"] = [self.density.height, self.density.width]
            frame["total"] = (float(self.grid.sum())
                              if self.grid is not None else 0.0)
        else:
            frame["fids"] = sorted(self.matched)
        return frame

    def handoff_snapshot(self) -> dict:
        """Serializable failover hand-off (docs/ROBUSTNESS.md): the
        canonical predicate, the matched-fid baseline, and the seq /
        delivered-watermark pair. A fleet router re-homes the standing
        query onto a survivor by re-subscribing WITH this snapshot
        (manager.subscribe `handoff=`): the acceptor seeds its sequence
        counter from the watermark and answers with a full `state`
        resync frame, so the client reconciles instead of starting
        over. Predicate subscriptions only — a density grid's float
        state is replica-local by design and re-seeds from the live
        snapshot anyway."""
        if self.density is not None:
            raise ValueError(
                "density subscriptions do not hand off: the grid "
                "re-seeds from the live snapshot on re-subscribe")
        from geomesa_tpu_torch.cql import parse_cql
        from geomesa_tpu_torch.cql.ast import to_cql

        with self._lock:
            return {
                "type": self.type_name,
                # canonical form: the acceptor validates predicate
                # identity by string equality, not parse-tree walks
                "cql": to_cql(parse_cql(self.cql)),
                "matched": sorted(self.matched),
                "seq": self._seq,
                # last DELIVERED seq: frames still queued were never
                # pushed, so the acceptor's state frame re-covers them
                "watermark": self._seq - len(self._outbox),
                # a re-homed paused subscription must LAND paused (the
                # fleet router reads this; the acceptor ignores it)
                "status": self.status,
            }

    def requeue(self, frames: List[dict]) -> None:
        """Put back frames a failed flush drained but could not push
        (front of the queue, original order, seq already stamped) — a
        broken push sink must not silently lose delivered-to-nobody
        frames."""
        if not frames:
            return
        with self._lock:
            self._outbox.extendleft(reversed(frames))

    def outbox_depth(self) -> int:
        with self._lock:
            return len(self._outbox)

    def _resync_pending(self) -> bool:
        with self._lock:
            return self._resync

    def stats(self) -> dict:
        with self._lock:
            return {
                "id": self.sub_id,
                "type": self.type_name,
                "mode": self.mode,
                "tenant": self.tenant,
                "status": self.status,
                "lagged": self.lagged,
                "matched": len(self.matched),
                "outbox": len(self._outbox),
                "events_offered": self.events_offered,
                "overflows": self.overflows,
            }


class SubscriptionRegistry:
    """Thread-safe directory of subscriptions, grouped by feature type.

    The per-type `version` is the evaluator's cache key for the fused
    device kernel: it moves only on membership/lifecycle changes, so a
    steady subscription set never recompiles across folded batches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: Dict[str, Subscription] = {}
        self._by_type: Dict[str, List[str]] = {}
        self._versions: Dict[str, int] = {}
        # transitioned-out subscriptions (cancelled/expired) whose
        # final frames still need one last flush (manager.take_parting)
        self._parting: List[Subscription] = []

    # -- membership --------------------------------------------------------

    def register(self, sub: Subscription) -> Subscription:
        with self._lock:
            if sub.sub_id in self._subs:
                raise ValueError(f"duplicate subscription id {sub.sub_id!r}")
            self._subs[sub.sub_id] = sub
            self._by_type.setdefault(sub.type_name, []).append(sub.sub_id)
            self._versions[sub.type_name] = (
                self._versions.get(sub.type_name, 0) + 1)
        self._export_active()
        try:
            from geomesa_tpu_torch.telemetry.recorder import RECORDER

            RECORDER.note_event("subscribe", action="register",
                                subscription=sub.sub_id,
                                type=sub.type_name, mode=sub.mode,
                                tenant=sub.tenant)
        except Exception:
            pass
        return sub

    def get(self, sub_id: str) -> Subscription:
        with self._lock:
            return self._subs[sub_id]

    def maybe(self, sub_id: str) -> Optional[Subscription]:
        with self._lock:
            return self._subs.get(sub_id)

    def __len__(self) -> int:
        with self._lock:
            return sum(1 for s in self._subs.values()
                       if s.status in ("active", "paused"))

    def type_names(self) -> List[str]:
        with self._lock:
            return sorted(n for n, ids in self._by_type.items() if ids)

    def active_for(self, type_name: str) -> List[Subscription]:
        """Evaluation set: ACTIVE subscriptions of one type, in
        registration order (stable — the fused kernel's lane order)."""
        return self.active_snapshot(type_name)[1]

    def active_snapshot(
        self, type_name: str
    ) -> Tuple[int, List[Subscription]]:
        """(version, active subscriptions) read ATOMICALLY under the
        registry lock: every membership/lifecycle change bumps the
        version, so equal versions imply identical membership — the
        invariant the evaluator's fused-kernel cache keys on. Reading
        the two separately would let a registration land between the
        reads and stamp a stale subscription list into the new
        version's cached kernel."""
        with self._lock:
            ids = self._by_type.get(type_name, ())
            return (self._versions.get(type_name, 0),
                    [self._subs[i] for i in ids
                     if self._subs[i].status == "active"])

    def version(self, type_name: str) -> int:
        with self._lock:
            return self._versions.get(type_name, 0)

    # -- lifecycle ---------------------------------------------------------

    def _transition(self, sub_id: str, status: str,
                    final_frame: Optional[dict] = None) -> Subscription:
        assert status in STATUSES
        removing = False
        with self._lock:
            sub = self._subs[sub_id]
            if sub.status == status:
                return sub
            sub.status = status
            self._versions[sub.type_name] = (
                self._versions.get(sub.type_name, 0) + 1)
            removing = status in ("cancelled", "expired")
            if removing:
                ids = self._by_type.get(sub.type_name)
                if ids and sub_id in ids:
                    ids.remove(sub_id)
                del self._subs[sub_id]
                if final_frame is None:
                    self._parting.append(sub)
        if removing and final_frame is not None:
            # terminal frame FIRST, take_parting() visibility second:
            # once the subscription is in _parting a concurrent flush
            # can pop-and-drain it, and a frame offered after that
            # drain lands in an outbox nothing will ever flush again —
            # the client waits forever on a dead subscription. In the
            # gap (removed from _subs, not yet parting) a flush simply
            # doesn't see the sub; delivery waits for the next flush.
            sub.offer(final_frame)
            with self._lock:
                self._parting.append(sub)
        self._export_active()
        try:
            from geomesa_tpu_torch.telemetry.recorder import RECORDER

            RECORDER.note_event("subscribe", action=status,
                                subscription=sub_id,
                                type=sub.type_name, tenant=sub.tenant)
        except Exception:
            pass
        return sub

    def pause(self, sub_id: str) -> Subscription:
        return self._transition(sub_id, "paused")

    def resume(self, sub_id: str) -> Subscription:
        with self._lock:
            sub = self._subs[sub_id]
            if sub.status != "paused":
                raise ValueError(
                    f"cannot resume {sub_id!r} from {sub.status!r}")
        # a resumed subscription missed every batch folded while paused
        # (the evaluator may even have disarmed and dropped the buffered
        # window): its matched set / grid is stale, so it must re-seed
        # from the live snapshot — not just re-announce its old state.
        # Mark the re-seed BEFORE going active so a fold that interleaves
        # with the caller's eager resync (manager.resume) re-seeds
        # instead of diffing against the stale baseline.
        with sub._lock:
            sub._resync = True
        return self._transition(sub_id, "active")

    def cancel(self, sub_id: str) -> Subscription:
        return self._transition(sub_id, "cancelled")

    def quarantine(self, sub_id: str) -> Subscription:
        return self._transition(sub_id, "quarantined")

    def expire_tick(self, now: Optional[float] = None) -> List[Subscription]:
        """TTL sweep: returns the subscriptions expired by this tick,
        already transitioned with their final `expired` frame queued
        (queueing it here, not in the caller, keeps the frame ahead of
        take_parting() visibility — see _transition). Runs before
        every fold (subscribe/evaluator.py).
        Quarantined subscriptions are swept too — the evaluator stamps
        them with the quarantine TTL on trip, so an abandoned poisoned
        subscription is eventually removed instead of being pinned and
        re-scanned by every flush forever."""
        with self._lock:
            stale = [s.sub_id for s in self._subs.values()
                     if s.status in ("active", "paused", "quarantined")
                     and s.expired(now)]
        out = []
        for sid in stale:
            # two concurrent pumps (--live-poll-ms + a reader-thread
            # poll verb) can both collect the same expired id; the
            # loser's _transition finds it already removed — the
            # winner's tick owns the parting frame (same TOCTOU
            # discipline as manager.unsubscribe)
            try:
                out.append(self._transition(
                    sid, "expired", final_frame={"event": "expired"}))
            except KeyError:
                pass
        return out

    def subs(self) -> List[Subscription]:
        """Every registered subscription (any status), registration
        order — the flush iteration set."""
        with self._lock:
            return list(self._subs.values())

    def take_parting(self) -> List[Subscription]:
        """Pop the transitioned-out subscriptions whose final frames
        (`expired`, `quarantined`) still need delivery."""
        with self._lock:
            out, self._parting = self._parting, []
            return out

    def requeue_parting(self, subs: List[Subscription]) -> None:
        """Put back parting subscriptions a failed flush popped but
        never delivered terminal frames for (next flush retries)."""
        if not subs:
            return
        with self._lock:
            self._parting = list(subs) + self._parting

    # -- introspection -----------------------------------------------------

    def _export_active(self) -> None:
        """`subscribe.active{tenant}` gauge refresh on every membership
        change (docs/OBSERVABILITY.md metrics reference)."""
        with self._lock:
            per_tenant: Dict[str, int] = {}
            for s in self._subs.values():
                if s.status == "active":
                    per_tenant[s.tenant or "-"] = (
                        per_tenant.get(s.tenant or "-", 0) + 1)
        try:
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.gauge("subscribe.active", float(sum(per_tenant.values())))
            for tenant, n in per_tenant.items():
                metrics.gauge("subscribe.active.by_tenant", float(n),
                              tenant=tenant)
        except Exception:
            pass

    def stats(self) -> dict:
        with self._lock:
            subs = list(self._subs.values())
            types = {n: len(ids) for n, ids in self._by_type.items() if ids}
        by_status: Dict[str, int] = {}
        lagged = 0
        for s in subs:
            by_status[s.status] = by_status.get(s.status, 0) + 1
            if s.lagged:
                lagged += 1
        return {
            "subscriptions": len(subs),
            "by_status": by_status,
            # latest-state-only mode count (outbox overflow): the
            # `gmtpu top` subscriptions line reads this straight off
            # /debug/stats
            "lagged": lagged,
            "types": types,
        }
