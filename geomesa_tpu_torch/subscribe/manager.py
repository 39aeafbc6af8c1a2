"""SubscriptionManager: admission, push and lifecycle glue.

The wire layer (serve/protocol.py `subscribe`/`unsubscribe` verbs) and
the bench loadgen talk to THIS class; the registry holds state, the
evaluator folds deltas (one fused device dispatch per poll). Admission
reuses the PR-2 serving fabric: per-tenant token buckets (the same
RateLimiter the QueryService uses — pass the service's limiter in so
queries and subscriptions draw from one budget), a bounded subscription
table, and the PR-5 poison quarantine keyed by predicate fingerprint —
a predicate that crashed evaluation out of the registry is rejected at
(re-)registration with a typed QueryRejected("quarantined") until the
TTL lapses.

A copy of the reference package's `subscribe/manager.py`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

from geomesa_tpu_torch.subscribe.evaluator import DeltaEvaluator
from geomesa_tpu_torch.subscribe.registry import (
    DensityWindow, Subscription, SubscriptionRegistry)
from geomesa_tpu_torch.telemetry.trace import TRACER


@dataclasses.dataclass
class SubscribeConfig:
    max_subscriptions: int = 256     # admission bound (backpressure)
    outbox_limit: int = 1024         # per-subscription pending frames
    default_ttl_s: Optional[float] = None
    rate: Optional[float] = None     # per-subscription push frames/s
    rate_burst: float = 8.0
    # predicate quarantine (docs/ROBUSTNESS.md): strikes before a
    # crashing predicate is removed from evaluation; 0 disables
    quarantine_after: int = 3
    quarantine_ttl_s: float = 600.0
    # registration-rate tenant buckets (only used when no shared
    # limiter is passed in)
    tenant_rate: Optional[float] = None
    tenant_burst: float = 8.0
    # parametric lanes (subscribe/lanes.py): off puts every predicate
    # on the fused path — the bench's lane-vs-fused comparison and the
    # parity tests flip this
    lanes: bool = True


class SubscriptionManager:
    def __init__(self, store, config: Optional[SubscribeConfig] = None,
                 limiter=None):
        self.store = store
        self.config = config or SubscribeConfig()
        self.registry = SubscriptionRegistry()
        if limiter is None:
            from geomesa_tpu_torch.serve.scheduler import RateLimiter

            limiter = RateLimiter(self.config.tenant_rate,
                                  self.config.tenant_burst)
        self.limiter = limiter
        self.evaluator = DeltaEvaluator(
            store, self.registry,
            quarantine_after=self.config.quarantine_after,
            quarantine_ttl_s=self.config.quarantine_ttl_s,
            lanes=self.config.lanes)
        # serializes concurrent flushes (the --live-poll-ms pump thread
        # vs an explicit `poll` verb on the reader thread): without it,
        # two drains of the same outbox can interleave their writes
        # and deliver a subscription's frames out of seq order
        self._flush_lock = threading.Lock()
        # checkpoints(): last (watermark, status) handed out per
        # subscription — the seq-watermark cadence that keeps the
        # stats-probe piggyback from re-shipping unchanged snapshots
        self._checkpoint_marks: Dict[str, tuple] = {}

    # -- admission ---------------------------------------------------------

    def subscribe(
        self,
        type_name: str,
        cql: str = "INCLUDE",
        density: Optional[DensityWindow] = None,
        tenant: str = "",
        ttl_s: Optional[float] = None,
        rate: Optional[float] = None,
        outbox_limit: Optional[int] = None,
        initial_state: bool = True,
        handoff: Optional[dict] = None,
        paused: bool = False,
        ack: Optional[Callable[[Subscription], None]] = None,
    ) -> Subscription:
        """Register a standing query. Raises the serving layer's typed
        QueryRejected on admission failure (rate_limited /
        subscription_limit / quarantined / shutting_down analog), and
        ValueError for an invalid predicate — validation happens HERE,
        not at the first fold.

        `handoff` re-homes a standing query from another replica
        (docs/ROBUSTNESS.md): a Subscription.handoff_snapshot dict
        whose canonical CQL must match this registration's predicate.
        The new subscription continues the client's sequence numbers
        from the snapshot's delivered watermark and its first frame is
        a full `state` resync built from THIS replica's live snapshot,
        so the client reconciles instead of starting over. Predicate
        subscriptions only (density grids re-seed anyway).

        `paused=True` registers then immediately pauses, still inside
        the flush-excluded unit: the queued state frame stays in the
        outbox until resume (the fleet router re-homes a paused
        subscription with this — it lands paused, and the resume
        resync replaces the stale frame with current state).

        `ack` (the wire layer's subscribe response) runs under the
        flush lock, BEFORE any flusher — in particular the
        --live-poll-ms pump — can drain this subscription's outbox: the
        client always learns the subscription id before the first push
        frame that references it."""
        from geomesa_tpu_torch.serve.scheduler import QueryRejected

        sft = self.store.get_schema(type_name)  # KeyError for unknown
        sub = Subscription(
            type_name, cql=cql, density=density, tenant=tenant,
            ttl_s=ttl_s if ttl_s is not None else self.config.default_ttl_s,
            outbox_limit=(outbox_limit if outbox_limit is not None
                          else self.config.outbox_limit),
            rate=rate if rate is not None else self.config.rate,
            rate_burst=self.config.rate_burst,
            initial_state=initial_state)
        if handoff is not None:
            if density is not None:
                raise ValueError(
                    "density subscriptions do not hand off: the grid "
                    "re-seeds from the live snapshot on re-subscribe")
            from geomesa_tpu_torch.cql import parse_cql
            from geomesa_tpu_torch.cql.ast import to_cql

            canon = to_cql(parse_cql(cql))
            if handoff.get("type") != type_name:
                raise ValueError(
                    f"handoff type {handoff.get('type')!r} does not "
                    f"match subscribe type {type_name!r}")
            if handoff.get("cql") != canon:
                raise ValueError(
                    f"handoff predicate {handoff.get('cql')!r} does "
                    f"not match subscribe predicate {canon!r}")
            # continue the client's numbering from the last frame the
            # old replica DELIVERED; the state resync frame queued
            # below (always — it replaces the missed tail) is the
            # next seq the client sees
            sub._seq = int(handoff.get("watermark", 0))
        if self.config.quarantine_after:
            detail = self.evaluator.quarantine.blocked(sub.fingerprint())
            if detail is not None:
                raise QueryRejected("quarantined", detail)
        self.limiter.admit(tenant)
        if density is None:
            # compile now: a bad CQL (unknown attribute, unsupported
            # op) is the CLIENT's error and must answer the subscribe
            # request, not crash the first fold
            self.evaluator._filter_for(type_name, cql, sft)
        elif density.weight_attr is not None:
            # same contract for the density weight column: a typo'd or
            # non-numeric attribute answers HERE, typed — not as a
            # KeyError from the first fold over a non-empty topic
            if density.weight_attr not in sft:
                raise ValueError(
                    f"density weight attribute {density.weight_attr!r} "
                    f"not in schema {type_name!r}")
            wtype = sft.attribute(density.weight_attr).type
            if wtype not in ("Integer", "Long", "Double", "Float"):
                raise ValueError(
                    f"density weight attribute {density.weight_attr!r} "
                    f"is {wtype}, not numeric")
        self.evaluator.watch(type_name)
        # register + initial frame + ack as one flush-excluded unit (a
        # racing pump flush waits); inside, bootstrap-then-register
        # runs under the per-type eval lock: a concurrent fold can
        # neither see the subscription baseline-less nor tear it
        with self._flush_lock:
            # bound check under the same lock as registration: checked
            # outside, two concurrent subscribes at capacity-1 both
            # pass and the table exceeds max_subscriptions
            if len(self.registry) >= self.config.max_subscriptions:
                raise QueryRejected(
                    "subscription_limit",
                    f"subscription table at capacity "
                    f"({self.config.max_subscriptions})")
            self.evaluator.admit(sub)
            if initial_state or handoff is not None:
                sub.queue_state_frame()
            if paused:
                self.registry.pause(sub.sub_id)
            if ack is not None:
                ack(sub)
        return sub

    def unsubscribe(self, sub_id: str) -> Subscription:
        return self.registry.cancel(sub_id)

    def pause(self, sub_id: str) -> Subscription:
        return self.registry.pause(sub_id)

    def resume(self, sub_id: str) -> Subscription:
        sub = self.registry.resume(sub_id)
        # re-seed NOW so the next flush (which may run before any fold)
        # pushes a `state` frame built from the live snapshot rather
        # than the pre-pause matched set / grid
        self.evaluator.resync(sub)
        return sub

    def checkpoints(self) -> Dict[str, dict]:
        """Handoff snapshots for every live PREDICATE subscription
        whose delivered watermark advanced since the last call — the
        seq-watermark cadence the fleet piggybacks on the stats probe
        (docs/ROBUSTNESS.md "Standing queries"): no new RPC, bounded
        staleness of one probe interval once the stream quiesces, and
        an unchanged subscription ships zero bytes. Density grids are
        skipped — they re-seed from the survivor's live snapshot on
        re-home, so there is nothing to checkpoint. Called on the wire
        connection's reader thread (the stats verb), same thread as
        subscribe/unsubscribe — the marks dict needs no lock."""
        out: Dict[str, dict] = {}
        live = {}
        for sub in self.registry.subs():
            if (sub.density is not None
                    or sub.status not in ("active", "paused")):
                continue
            snap = sub.handoff_snapshot()
            live[sub.sub_id] = True
            mark = self._checkpoint_marks.get(sub.sub_id)
            if mark == (snap["watermark"], snap["status"]):
                continue
            # reader-confined: the stats verb that calls this runs on
            # the connection's ONE reader thread, so the marks dict never
            # crosses threads (_flush_lock guards outbox drains only)
            self._checkpoint_marks[sub.sub_id] = (
                snap["watermark"], snap["status"])
            out[sub.sub_id] = snap
        # prune marks of cancelled/expired subscriptions so a
        # long-lived connection's table does not grow forever
        for sid in list(self._checkpoint_marks):
            if sid not in live:
                del self._checkpoint_marks[sid]
        return out

    # -- driving -----------------------------------------------------------

    def poll_now(self) -> Dict[str, int]:
        """Poll every live topic with registered subscriptions; the
        store's fold hook pumps the evaluator, so by return every
        subscription's outbox holds this window's events. Typed broker
        errors (injected kafka.poll faults, BreakerOpen) propagate to
        the caller — the poll loop in the wire layer reports and
        retries on its own cadence."""
        out: Dict[str, int] = {}
        for name in self.registry.type_names():
            out[name] = self.store.poll(name)
        return out

    def flush(self, push: Callable[[dict], None]) -> int:
        """Drain every outbox through `push` (one dict frame per call),
        honoring per-subscription rate limits. A lagged subscription
        gets its `state` re-sync frame the moment its marker frame has
        been delivered. Returns frames pushed."""
        n = 0
        trace = TRACER.start_trace("subscribe.push")
        try:
            # ONE flusher at a time: drain order == write order, so a
            # subscription's frames always arrive in seq order even
            # when the pump thread races an explicit poll verb
            # the push sink IS this lock's critical section: flushers
            # are the only contenders and frame order is the contract
            with self._flush_lock:
                subs = self.registry.subs()
                parting = self.registry.take_parting()
                if trace is not None:
                    with TRACER.scope(trace):
                        with TRACER.span("subscribe.push",
                                         subs=len(subs)):
                            n = self._flush_all(subs, parting, push)
                else:
                    n = self._flush_all(subs, parting, push)
        finally:
            if trace is not None:
                from geomesa_tpu_torch.telemetry.recorder import RECORDER

                RECORDER.record(trace.finish(status="ok", frames=n))
        if n:
            try:
                from geomesa_tpu_torch.utils.metrics import metrics

                metrics.counter("subscribe.push.frames", n)
            except Exception:
                pass
        return n

    def _flush_all(self, subs, parting, push) -> int:
        n = 0
        parting_ids = {s.sub_id for s in parting}
        pending = list(subs) + list(parting)
        for i, sub in enumerate(pending):
            if sub.status == "paused":
                continue  # a paused consumer holds its outbox
            frames = sub.drain()
            # the lagged marker (or a resume/resync) has been drained:
            # hand the client the full current state and resume
            # incremental delivery (checked-and-built atomically so a
            # racing offer cannot make the state frame outrun a queued
            # frame's seq)
            resync = sub.take_resync_frame()
            if resync is not None:
                frames.append(resync)
            try:
                for k, frame in enumerate(frames):
                    push(frame)
                    n += 1
            except BaseException:
                # a broken push sink must not lose drained-but-unpushed
                # frames or later parting subscriptions' terminal
                # frames: put both back so the next flush retries
                sub.requeue(frames[k:])
                self.registry.requeue_parting(
                    [s for s in pending[i:]
                     if s.sub_id in parting_ids])
                raise
        return n

    def close(self) -> None:
        """Cancel every live subscription AND release the store-side
        hooks (fold hook + cache listeners): a closed manager must not
        keep costing every future poll or pin its evaluator alive."""
        for sub in self.registry.subs():
            if sub.status in ("active", "paused"):
                self.registry.cancel(sub.sub_id)
        self.evaluator.detach()

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        out = self.registry.stats()
        out["evaluator"] = self.evaluator.stats()
        out["lanes"] = self.evaluator.lane_stats()
        out["quarantine"] = self.evaluator.quarantine.stats()
        return out
