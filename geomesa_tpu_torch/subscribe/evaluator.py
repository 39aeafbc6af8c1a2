"""Delta-driven incremental evaluation for standing queries.

The evaluation contract (docs/SERVING.md "Standing queries"):

- The Kafka layer is the only writer of live state. Every
  `KafkaDataStore.poll` folds a message window into the
  KafkaFeatureCache ATOMICALLY (offset-pinned — kafka/store.py); the
  cache's FeatureEvents for that window land in this module's per-type
  delta buffer via a non-blocking listener (lint rule GT17 in the
  reference keeps listener bodies non-blocking), and the store's
  post-fold hook pumps the evaluator OUTSIDE the store lock.

- One poll = a HANDFUL of device calls, independent of how many
  subscriptions are registered: the window's changed rows stack into a
  single columnar delta (pow2-padded, so shapes repeat), lane-eligible
  geofences (bbox / dwithin / polygon — subscribe/lanes.py) evaluate as
  one [S]-batched call per CLASS (engine/lanes.py), and only the
  irregular remainder (compound CQL, attribute predicates, density
  windows) rides the FUSED call: every remaining predicate's compiled
  mask and f32 boundary band, stacked, plus every density window's cell
  binning, fetched to the host in one readback. `dispatches` counts
  those calls (lanes included), `lane_dispatches` the lane calls.

- Exactly-once: buffered events are consumed only after a successful
  evaluation. An injected `kafka.poll` fault fails the poll BEFORE the
  fold (no events buffered); an infrastructure failure inside the
  evaluator (device transfer, a device OOM, an injected
  `subscribe.eval` fault) leaves the buffer intact for the next poll —
  no missed events, and the diff-based state update (enter/exit = set
  difference against the previous matched set) makes re-evaluation
  idempotent, so no duplicates either.

- Exactness matches the one-shot planner: predicates evaluate on the
  same f32 device columns `to_device` builds, and rows flagged by the
  compiled filter's f32 boundary band are re-evaluated in f64 on host
  (cql/hosteval) before the matched-set diff — so the incremental
  matched set is bit-identical to a fresh planner query's fids.

- A predicate that CRASHES evaluation is struck against the faults/
  quarantine registry (keyed by predicate fingerprint, not sub id) and
  quarantined after the configured strikes — never retried forever.
  The crashing fold degrades to per-subscription evaluation so healthy
  subscriptions still get their events; a subscription that survives a
  crash re-syncs from the live snapshot on its next clean fold.

The port of the reference package's `subscribe/evaluator.py`. It runs
every device call on the store's device (`store.device`: the card unless
the store was made for the CPU) and never moves work to the CPU behind
the caller's back: a device OOM surfaces typed (`DeviceOOM`) and, as an
infrastructure answer, keeps the buffer for the next poll instead of
striking predicates (the reference strikes on an OOM). Eager PyTorch has
nothing to compile, so the reference's ExecutableRegistry route for the
fused kernel has no counterpart; density cells are the port's one-shot
binning (`engine.density.bin_cells`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.faults import harness as _faults
from geomesa_tpu_torch.subscribe.registry import (
    DensityWindow, Subscription, SubscriptionRegistry)
from geomesa_tpu_torch.telemetry.recorder import RECORDER
from geomesa_tpu_torch.telemetry.trace import TRACER
from geomesa_tpu_torch.utils.padding import next_pow2

# evaluation boundary fault site: fires once per fold, BEFORE any
# subscription state mutates — an injected failure must leave the delta
# buffer intact for the next poll (exactly-once), never half-apply a batch
_EVAL_SITE = _faults.site(
    "subscribe.eval", "standing-query fused delta evaluation")

_PAD_MIN = 16          # smallest delta bucket (tiny deltas share one shape)
_MAX_BUFFER = 65_536   # per-type delta buffer bound (overflow => resync)
_MAX_FILTERS = 256     # compiled-predicate cache bound (LRU-ish eviction)


def _infra_error(exc: BaseException) -> bool:
    """Infrastructure answer vs predicate crash — the serving layer's
    quarantine exemption: the OSError family (even when classified
    permanent — a compaction-raced read), transient failures and a
    device OOM say nothing about the PREDICATE being poisonous."""
    from geomesa_tpu_torch.faults import classify

    return isinstance(exc, OSError) or classify(exc) in ("transient", "oom")


@contextlib.contextmanager
def _typed_oom():
    """A device OOM inside the block surfaces as the fabric's DeviceOOM."""
    try:
        yield
    except torch.OutOfMemoryError as e:
        from geomesa_tpu_torch.faults import DeviceOOM

        raise DeviceOOM(f"standing-query evaluation: {e}") from e


class _TypeState:
    """Per-feature-type evaluator state. The eval lock serializes folds
    (delta windows apply in offset order — the store's poll already
    guarantees at-most-one fold per window); the buffer lock guards the
    listener-side event appends, which must stay cheap."""

    def __init__(self, type_name: str):
        self.type_name = type_name
        self.eval_lock = threading.Lock()
        self.buf_lock = threading.Lock()
        self.buffer: List[tuple] = []   # (kind, fid, attrs-or-None)
        self.overflowed = False
        self.listening = False
        self.listener_fn = None
        # listener gate: True while the type plausibly has active
        # subscriptions. A plain bool (GIL-atomic) because the
        # listener runs per folded MESSAGE inside the store lock; set on
        # admit, refreshed by each pump
        self.armed = False
        # lane membership (subscribe/lanes.py): same-shape geofence
        # classes as [S]-bucketed parameter tables; eval-lock confined
        self.lanes = None
        # approximate-density shared state: ONE host-side world
        # occupancy grid + fid->cell map per type, folded from deltas
        # with plain numpy — every approx_density subscriber resamples
        # it, so the fan-out costs no device work per poll. The per-fid
        # last-cell map makes re-application idempotent.
        self.approx_grid = None
        self.approx_cells: Dict[str, Tuple[int, int]] = {}
        self.approx_seeded = False
        # the last bootstrapped snapshot with its padded upload and fids
        # (`DeltaEvaluator._boot_inputs`); eval-lock confined
        self.boot = None


class DeltaEvaluator:
    """Incremental evaluator over one live store (KafkaDataStore duck
    type: `get_schema`, `cache`, `add_fold_hook`, `device`)."""

    def __init__(self, store, registry: SubscriptionRegistry,
                 quarantine=None, quarantine_after: int = 3,
                 quarantine_ttl_s: float = 600.0, lanes: bool = True):
        self.store = store
        self.device = store.device
        self.registry = registry
        # parametric lanes (subscribe/lanes.py): off puts every
        # predicate on the fused path
        self._lanes_enabled = lanes
        # quarantine_after=0 disables quarantine (the serve layer's
        # contract): strikes are never counted, a crashing predicate
        # just re-seeds and retries each fold
        self._quarantine_enabled = (quarantine is not None
                                    or quarantine_after > 0)
        if quarantine is None:
            from geomesa_tpu_torch.faults import QuarantineRegistry

            quarantine = QuarantineRegistry(
                strikes=max(quarantine_after, 1), ttl_s=quarantine_ttl_s)
        self.quarantine = quarantine
        self._types: Dict[str, _TypeState] = {}
        self._types_lock = threading.Lock()
        # compiled predicate cache, keyed by (type, cql)
        self._filters: Dict[Tuple[str, str], object] = {}
        # serializes compile/insert/evict; steady-state reads of live
        # keys stay lock-free (eviction never removes a live key)
        self._filters_lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._counters_lock = threading.Lock()
        store.add_fold_hook(self.pump)

    # -- counters ----------------------------------------------------------

    def _bump(self, name: str, n: int = 1) -> None:
        with self._counters_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def stats(self) -> Dict[str, int]:
        with self._counters_lock:
            out = dict(self._counters)
        for k in ("folds", "dispatches", "events", "fallbacks",
                  "resyncs", "eval_errors"):
            out.setdefault(k, 0)
        return out

    # -- wiring ------------------------------------------------------------

    def _state(self, type_name: str) -> _TypeState:
        with self._types_lock:
            st = self._types.get(type_name)
            if st is None:
                st = self._types[type_name] = _TypeState(type_name)
            return st

    def watch(self, type_name: str) -> None:
        """Attach the delta listener to the type's cache (idempotent)."""
        st = self._state(type_name)
        with st.buf_lock:
            if st.listening:
                return
            st.listening = True
            st.listener_fn = self._listener(st)
        self.store.cache(type_name).add_listener(st.listener_fn)

    def admit(self, sub: Subscription) -> None:
        """Bootstrap-then-register as one unit UNDER the per-type eval
        lock: a concurrent fold can neither evaluate the subscription
        before its baseline state exists nor overwrite a baseline
        mid-diff. Events buffered while the bootstrap snapshot is read
        are re-evaluated by the next fold (idempotent)."""
        st = self._state(sub.type_name)
        with st.eval_lock:
            st.armed = True  # before register: no event window is missed
            self.bootstrap(sub)
            self.registry.register(sub)

    def resync(self, sub: Subscription) -> None:
        """Eagerly re-seed a subscription from the live snapshot under
        the per-type eval lock (resume path)."""
        st = self._state(sub.type_name)
        with st.eval_lock:
            if sub._resync_pending():
                self._resync(sub)

    def detach(self) -> None:
        """Release every store-side hook this evaluator installed (the
        fold hook and per-type cache listeners)."""
        try:
            self.store.remove_fold_hook(self.pump)
        except (AttributeError, ValueError):
            pass
        with self._types_lock:
            states = list(self._types.values())
        for st in states:
            st.armed = False
            with st.buf_lock:
                fn, st.listener_fn = st.listener_fn, None
                st.listening = False
                st.buffer.clear()
            if fn is not None:
                try:
                    self.store.cache(st.type_name).remove_listener(fn)
                except (KeyError, ValueError):
                    pass

    def _listener(self, st: _TypeState):
        def on_feature_event(event) -> None:
            # listener body — buffer append only, no blocking calls (no
            # I/O, no device work); the heavy lifting happens in pump()
            if not st.armed:
                return
            with st.buf_lock:
                if len(st.buffer) >= _MAX_BUFFER:
                    st.buffer.clear()
                    st.overflowed = True
                st.buffer.append((event.kind, event.fid,
                                  event.attributes))

        return on_feature_event

    # -- registration-time state -------------------------------------------

    def _upload(self, batch):
        from geomesa_tpu_torch.engine.device import to_device

        padded = batch.pad_to(next_pow2(max(len(batch), _PAD_MIN)))
        with _typed_oom():
            return padded, to_device(padded, self.device)

    def bootstrap(self, sub: Subscription) -> None:
        """Seed a subscription's state from the CURRENT live snapshot
        (one-shot semantics), so subsequent folds are pure increments.
        Also the re-sync path after a crashed or overflowed fold."""
        sft = self.store.get_schema(sub.type_name)
        if sub.density is not None and sub.density.approx:
            # sketch-backed window: seed the SHARED per-type grid once
            # (host-side, no device work), then this sub's resample
            st = self._state(sub.type_name)
            self._seed_approx_shared(st, sft)
            self._apply_approx(st, sub, offer=False)
            return
        snap = self.store.cache(sub.type_name).snapshot()
        if sub.density is not None:
            cells = None
            if snap is not None and len(snap):
                rows, cols, inb = self._density_cells_host(
                    sub.density, sft, snap)
                w = self._weights(sub.density, snap)
                cells = (rows, cols, inb, w, _batch_fids(snap))
            # mutate under the subscription lock so a flush racing the
            # re-seed never serializes a half-built grid
            with sub._lock:
                sub.grid[:] = 0.0
                sub.contrib.clear()
                if cells is not None:
                    rows, cols, inb, w, fids = cells
                    for j in np.nonzero(inb)[0]:
                        sub.grid[rows[j], cols[j]] += w[j]
                        sub.contrib[fids[j]] = (
                            int(rows[j]), int(cols[j]), float(w[j]))
            return
        compiled = self._filter_for(sub.type_name, sub.cql, sft)
        matched: set = set()
        if snap is not None and len(snap):
            padded, dev, fids = self._boot_inputs(sub.type_name, snap)
            with _typed_oom():
                mask = compiled.mask_refined(dev, padded)[: len(snap)]
            matched = {fids[j] for j in np.nonzero(mask)[0]}
        sub.matched = matched

    def _boot_inputs(self, type_name: str, snap):
        """(padded batch, its upload, fids) of a snapshot, kept until the
        snapshot changes (it is immutable, and rebuilt on a change): N
        subscriptions bootstrapped over one snapshot upload and decode
        it once, not N times."""
        st = self._state(type_name)
        if st.boot is None or st.boot[0] is not snap:
            padded, dev = self._upload(snap)
            st.boot = (snap, padded, dev, _batch_fids(snap))
        return st.boot[1:]

    def _filter_for(self, type_name: str, cql: str, sft):
        key = (type_name, cql)
        got = self._filters.get(key)  # lock-free hot-path hit
        if got is None:
            from geomesa_tpu_torch.cql import compile_filter, parse_cql

            got = compile_filter(parse_cql(cql), sft)
            with self._filters_lock:
                if len(self._filters) >= _MAX_FILTERS:
                    # evict compiled filters no live subscription
                    # references (insertion order — oldest first; an
                    # evicted-but-needed one recompiles)
                    live = {(s.type_name, s.cql)
                            for s in self.registry.subs() if s.cql}
                    for k in [k for k in self._filters if k not in live]:
                        if len(self._filters) < _MAX_FILTERS:
                            break
                        del self._filters[k]
                got = self._filters.setdefault(key, got)
        return got

    # -- density helpers ---------------------------------------------------

    @staticmethod
    def _cells(d: DensityWindow, x, y, valid):
        """(cell, inb) device tensors of one window: the one-shot density
        binning (engine.density.bin_cells), so incremental folds land in
        the cells a `get_features` density would."""
        from geomesa_tpu_torch.engine.density import bin_cells

        return bin_cells(x, y, valid, d.bbox, d.width, d.height)

    @staticmethod
    def _rows_cols(d: DensityWindow, cell: np.ndarray, inb: np.ndarray):
        cell = cell.astype(np.int64)
        return cell // d.width, cell % d.width, inb

    def _density_cells_host(self, d: DensityWindow, sft, batch):
        """Bootstrap and fallback binning: one device pass over a batch."""
        from geomesa_tpu_torch.engine.device import VALID, fetch

        _, dev = self._upload(batch)
        g = _geom_name(sft)
        with _typed_oom():
            cell, inb = fetch(*self._cells(d, dev[f"{g}__x"], dev[f"{g}__y"],
                                           dev[VALID]))
        n = len(batch)
        return self._rows_cols(d, cell[:n], inb[:n])

    def _weights(self, d: DensityWindow, batch) -> np.ndarray:
        if d.weight_attr is None:
            return np.ones(len(batch), np.float64)
        col = batch.columns[d.weight_attr]
        return np.asarray(col, np.float64)

    # -- the fused remainder -----------------------------------------------

    def _eval_fused(self, st: _TypeState, sft, subs, delta, dev):
        """ONE device call for the remainder: every predicate's compiled
        mask and band stacked, every exact density window's cells, and
        one readback of all of it."""
        from geomesa_tpu_torch.engine.device import VALID, fetch

        pred = [s for s in subs if s.density is None]
        # approx windows never join the device call: they fold host-side
        # into the shared grid
        dens = [s for s in subs
                if s.density is not None and not s.density.approx]
        filters = [self._filter_for(st.type_name, s.cql, sft) for s in pred]
        geom = _geom_name(sft)
        self._bump("dispatches")
        t0 = time.perf_counter()
        n = dev[VALID].shape[0]
        none = torch.zeros((0, n), dtype=torch.bool, device=self.device)
        masks, bands = [], []
        for f in filters:
            params = f.params(dev, delta)
            masks.append(f.mask_fn()(params, dev))
            bands.append(f._band_fn(params, dev) if f._band_fn is not None
                         else torch.zeros_like(dev[VALID]))
        cells = [t for s in dens for t in self._cells(
            s.density, dev[f"{geom}__x"], dev[f"{geom}__y"], dev[VALID])]
        out = fetch(torch.stack(masks) if masks else none,
                    torch.stack(bands) if bands else none, *cells)
        try:
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.histogram("subscribe.eval").update(
                time.perf_counter() - t0)
        except Exception:
            pass
        cell_rows = [self._rows_cols(s.density, out[2 + 2 * i], out[3 + 2 * i])
                     for i, s in enumerate(dens)]
        return pred, out[0], out[1], cell_rows

    # -- pump: fold one delta window ---------------------------------------

    def pump(self, type_name: str) -> int:
        """Fold buffered FeatureEvents for `type_name` into every
        registered subscription. Called by the store's post-fold hook
        (outside the store lock) and by the manager's poll loop.
        Returns the number of events consumed; 0 when the buffer is
        empty or evaluation must be retried (buffer retained)."""
        st = self._state(type_name)
        self.registry.expire_tick()
        with st.eval_lock:
            return self._pump_locked(st)

    def _pump_locked(self, st: _TypeState) -> int:
        with st.buf_lock:
            events = list(st.buffer)
            n_ev = len(events)
            overflowed = st.overflowed
        version, subs = self.registry.active_snapshot(st.type_name)
        st.armed = bool(subs)  # refresh the listener gate
        if not subs:
            with st.buf_lock:
                del st.buffer[:n_ev]
                st.overflowed = False
            return n_ev
        if overflowed:
            # the delta buffer overflowed between pumps: incremental
            # continuity is lost — re-seed every subscription from the
            # live snapshot and tell clients via lagged/state frames.
            # Consume the buffer and clear the flag BEFORE the re-seed,
            # so a SECOND overflow landing mid-re-seed is not erased;
            # everything cleared here is covered by the bootstrap
            # snapshots, and events landing after stay queued for the
            # next pump, whose application is idempotent.
            with st.buf_lock:
                st.buffer.clear()
                st.overflowed = False
            # the shared approx grid missed the window too
            st.approx_seeded = False
            for sub in subs:
                try:
                    self.bootstrap(sub)
                    with sub._lock:
                        sub.lagged = True
                except Exception as e:  # noqa: BLE001 — strike, don't spread
                    self._strike(sub, e)
            self._bump("resyncs", len(subs))
            return n_ev
        if not events:
            return 0
        changed, removed, cleared = _coalesce(events)
        trace = TRACER.start_trace(
            "subscribe.eval", type=st.type_name, subs=len(subs),
            delta=len(changed) + len(removed))
        status = "ok"
        try:
            if trace is not None:
                with TRACER.scope(trace):
                    with TRACER.span("subscribe.eval", type=st.type_name,
                                     subs=len(subs)):
                        consumed = self._fold(st, subs, changed, removed,
                                              cleared)
            else:
                consumed = self._fold(st, subs, changed, removed, cleared)
        except Exception as e:  # noqa: BLE001 — taxonomy + retry contract
            # infrastructure failure (device transfer, device OOM,
            # injected subscribe.eval fault): NOTHING was applied — keep
            # the buffer so the next poll retries the whole window
            status = "error"
            self._bump("eval_errors")
            try:
                from geomesa_tpu_torch.utils.metrics import metrics

                metrics.counter("subscribe.eval.errors")
            except Exception:
                pass
            RECORDER.note_event("subscribe", action="eval_error",
                                type=st.type_name,
                                error=f"{type(e).__name__}: {e}")
            return 0
        finally:
            if trace is not None:
                RECORDER.record(trace.finish(status=status))
        with st.buf_lock:
            del st.buffer[:n_ev]
        self._bump("folds")
        return consumed

    def _fold(self, st: _TypeState, subs, changed, removed,
              cleared: bool) -> int:
        sft = self.store.get_schema(st.type_name)
        _EVAL_SITE.fire()
        # an all-approx subscription set never touches the device — not
        # even the delta upload
        needs_device = any(
            s.density is None or not s.density.approx for s in subs)
        delta, dev, fids = self._delta_batch(sft, changed,
                                             device=needs_device)
        try:
            # lane-eligible geofences first: one [S]-batched call per
            # CLASS (membership reconciled as row writes), then the
            # fused call over only the irregular remainder — skipped
            # entirely when nothing rides it
            lane_members, remainder = self._lane_sync(st, sft, subs)
            fused_live = any(
                s.density is None or not s.density.approx
                for s in remainder)
            with _typed_oom():
                lane_rows = self._eval_lanes(st, sft, lane_members, dev)
                pred, masks, bands, cells = (
                    self._eval_fused(st, sft, remainder, delta, dev)
                    if (delta is not None and fused_live) else (
                        [s for s in remainder if s.density is None], None,
                        None, None))
        except Exception as e:
            if _infra_error(e):
                # infrastructure answer, not a poisonous predicate: no
                # state was applied — propagate so _pump_locked keeps
                # the buffer and the next poll retries the window
                raise
            # a crashing fused or lane call: degrade to per-subscription
            # evaluation so the poisonous predicate is identified and
            # struck while healthy subscriptions still fold this window
            self._bump("fallbacks")
            self._fold_fallback(st, sft, subs, delta, dev, fids,
                                changed, removed, cleared)
            return len(changed) + len(removed) + (1 if cleared else 0)
        dens = [s for s in remainder
                if s.density is not None and not s.density.approx]
        approx_dens = [s for s in subs
                       if s.density is not None and s.density.approx]
        # lane subscriptions: per-row slices of the lane masks get the
        # same f64 band refinement and strike protection as fused rows
        for _group, members in lane_members:
            for sub, _row in members:
                try:
                    if sub._resync_pending():
                        self._resync(sub)
                        continue
                    pair = lane_rows.get(sub.sub_id)
                    mask = (self._refine_mask(st, sub, pair[0], pair[1],
                                              delta, fids)
                            if pair is not None else np.zeros(0, bool))
                    self._apply_predicate(sub, fids, mask, removed,
                                          cleared)
                except Exception as e:  # noqa: BLE001 — strike
                    self._strike(sub, e)
        # the per-subscription apply phase gets the same strike
        # protection as the fallback path: a predicate that crashes only
        # HERE (host-band refinement, density weights) is struck, not
        # retried forever, and one crash costs no other subscription
        # its window
        for i, sub in enumerate(pred):
            try:
                if sub._resync_pending():
                    self._resync(sub)
                    continue
                mask = (np.zeros(0, bool) if masks is None else
                        self._refine_mask(st, sub, masks[i], bands[i],
                                          delta, fids))
                self._apply_predicate(sub, fids, mask, removed, cleared)
            except Exception as e:  # noqa: BLE001 — strike, don't spread
                self._strike(sub, e)
        for i, sub in enumerate(dens):
            try:
                if sub._resync_pending():
                    self._resync(sub)
                    continue
                cell = None if cells is None else cells[i]
                self._apply_density(sub, delta, fids, cell, removed,
                                    cleared)
            except Exception as e:  # noqa: BLE001 — strike, don't spread
                self._strike(sub, e)
        if approx_dens:
            # sketch-backed windows: ONE shared host fold per type
            # (idempotent — per-fid last-cell map), then a per-sub
            # resample + typed approx_density frame. No device work.
            changed_any = self._fold_approx_shared(
                st, sft, delta, fids, removed, cleared)
            for sub in approx_dens:
                try:
                    if sub._resync_pending():
                        self._resync(sub)
                        continue
                    if changed_any:
                        self._apply_approx(st, sub)
                except Exception as e:  # noqa: BLE001 — strike, not spread
                    self._strike(sub, e)
        return len(changed) + len(removed) + (1 if cleared else 0)

    # -- lanes -------------------------------------------------------------

    def _lane_sync(self, st: _TypeState, sft, subs):
        """Reconcile lane membership against this fold's atomic
        registry snapshot (row writes only — subscribe/lanes.py);
        returns ([(group, [(sub, row)])], remainder). Lanes disabled
        (SubscribeConfig.lanes=False) routes everything fused."""
        if not self._lanes_enabled:
            return [], list(subs)
        from geomesa_tpu_torch.subscribe.lanes import LaneTable, classify

        if st.lanes is None:
            st.lanes = LaneTable()

        def spec_for(sub):
            f = self._filter_for(st.type_name, sub.cql, sft)
            return classify(f.filter_ast, sft)

        return st.lanes.sync(subs, spec_for)

    def _eval_lanes(self, st: _TypeState, sft, lane_members, dev):
        """One device call per lane group (engine/lanes.py), its table
        copied to the device, fetched once and sliced per member row.
        Returns {sub_id: (mask_row, band_row)} over the padded delta."""
        if dev is None or not lane_members:
            return {}
        from geomesa_tpu_torch.engine import lanes as lane_fns
        from geomesa_tpu_torch.engine.device import VALID, fetch, upload

        g = _geom_name(sft)
        x, y, valid = dev[f"{g}__x"], dev[f"{g}__y"], dev[VALID]
        out = {}
        for group, members in lane_members:
            fn = getattr(lane_fns, f"lane_{group.cls}")
            self._bump("dispatches")
            self._bump("lane_dispatches")
            t0 = time.perf_counter()
            with TRACER.span("subscribe.lane.eval", cls=group.cls,
                             rows=len(members), bucket=group.cap):
                mask, band = fetch(*fn(upload(group.params, self.device),
                                       upload(group.active, self.device),
                                       x, y, valid))
            try:
                from geomesa_tpu_torch.utils.metrics import metrics

                metrics.histogram("lane.eval").update(
                    time.perf_counter() - t0)
            except Exception:
                pass  # observability must never fail the fold
            for sub, row in members:
                out[sub.sub_id] = (mask[row], band[row])
        return out

    def lane_stats(self) -> dict:
        """Lanes introspection (manager.stats `lanes` section): per-
        class row counts/capacities plus the typed `lane_ineligible`
        reasons for the currently-registered predicate set."""
        with self._types_lock:
            states = list(self._types.values())
        classes: Dict[str, dict] = {}
        ineligible: Dict[str, int] = {}
        for st in states:
            if st.lanes is None:
                continue
            s = st.lanes.stats()
            for cls, c in s["classes"].items():
                agg = classes.setdefault(cls, {"rows": 0, "capacity": 0})
                agg["rows"] += c["rows"]
                agg["capacity"] += c["capacity"]
            for why, n in s["ineligible"].items():
                ineligible[why] = ineligible.get(why, 0) + n
        return {"enabled": self._lanes_enabled, "classes": classes,
                "ineligible": ineligible}

    # -- refinement --------------------------------------------------------

    def _refine_mask(self, st, sub, mask_row, band_row, delta, fids):
        """Shared by the fused and lane apply phases: copy the row,
        re-evaluate its band-flagged entries in f64 (cql/hosteval)."""
        n = len(fids)
        mask = np.asarray(mask_row[:n]).copy()
        band = np.asarray(band_row[:n])
        idx = np.nonzero(band)[0]
        if len(idx):
            from geomesa_tpu_torch.cql.hosteval import eval_filter_host

            # via _filter_for, not the dict: past _MAX_FILTERS live
            # predicates the cache evicts, and an evicted-but-needed
            # filter must recompile, not strike the subscription
            sub_filter = self._filter_for(
                st.type_name, sub.cql,
                self.store.get_schema(st.type_name))
            mask[idx] = eval_filter_host(
                sub_filter.filter_ast, delta.select(idx))
        return mask

    def _apply_predicate(self, sub: Subscription, fids, mask,
                         removed, cleared: bool) -> None:
        prev = sub.matched
        new = set() if cleared else set(prev)
        for fid in removed:
            new.discard(fid)
        for j, fid in enumerate(fids):
            if mask[j]:
                new.add(fid)
            else:
                new.discard(fid)
        enters = sorted(new - prev)
        exits = sorted(prev - new)
        sub.matched = new
        if enters:
            sub.offer({"event": "enter", "fids": enters})
            self._bump("events", len(enters))
        if exits:
            sub.offer({"event": "exit", "fids": exits})
            self._bump("events", len(exits))

    def _apply_density(self, sub: Subscription, delta, fids, cell,
                       removed, cleared: bool) -> None:
        d = sub.density
        grid = sub.grid
        changed_any = False
        if cell is not None and len(fids):
            rows, cols, inb = (np.asarray(c[: len(fids)]) for c in cell)
            w = self._weights(d, delta)[: len(fids)]
        exact = d.decay is None
        # in-place grid/contrib mutation under the subscription lock: a
        # racing flush reads the grid under the same lock, so it never
        # serializes a half-applied fold
        with sub._lock:
            if cleared:
                if sub.contrib or grid.any():
                    changed_any = True
                grid[:] = 0.0
                sub.contrib.clear()
            if d.decay is not None and d.decay < 1.0:
                grid *= d.decay
                changed_any = changed_any or bool(grid.any())
            for fid in removed:
                old = sub.contrib.pop(fid, None)
                if old is not None and exact:
                    grid[old[0], old[1]] -= old[2]
                    changed_any = True
            if cell is not None and len(fids):
                for j, fid in enumerate(fids):
                    old = sub.contrib.pop(fid, None)
                    if old is not None and exact:
                        grid[old[0], old[1]] -= old[2]
                        changed_any = True
                    if inb[j]:
                        grid[rows[j], cols[j]] += w[j]
                        sub.contrib[fid] = (int(rows[j]), int(cols[j]),
                                            float(w[j]))
                        changed_any = True
        if changed_any:
            sub.offer({
                "event": "density",
                "total": float(grid.sum()),
                "cells": int(np.count_nonzero(grid)),
            })
            self._bump("events")

    # -- approximate density (shared host grid, no device) -----------------

    def _approx_bins(self) -> int:
        from geomesa_tpu_torch.approx.sketches import DEFAULT_BINS

        return DEFAULT_BINS

    def _host_cells(self, sft, batch, n: int):
        """World-grid cells of the first `n` rows, pure numpy — THE
        shared sketch binning (approx.sketches.world_cells)."""
        from geomesa_tpu_torch.approx.sketches import world_cells

        col = batch.columns[_geom_name(sft)]
        return world_cells(np.asarray(col.x)[:n], np.asarray(col.y)[:n],
                           self._approx_bins())

    def _seed_approx_shared(self, st: _TypeState, sft) -> None:
        """Build the shared grid + fid->cell map from the live
        snapshot (idempotent; under the per-type eval lock)."""
        if st.approx_seeded:
            return
        b = self._approx_bins()
        grid = np.zeros((b, b), np.float64)
        cells: Dict[str, Tuple[int, int]] = {}
        snap = self.store.cache(st.type_name).snapshot()
        if snap is not None and len(snap):
            rows, cols = self._host_cells(sft, snap, len(snap))
            for j, fid in enumerate(_batch_fids(snap)):
                grid[rows[j], cols[j]] += 1.0
                cells[fid] = (int(rows[j]), int(cols[j]))
        st.approx_grid = grid
        st.approx_cells = cells
        st.approx_seeded = True

    def _fold_approx_shared(self, st: _TypeState, sft, delta, fids,
                            removed, cleared: bool) -> bool:
        """Fold one delta window into the shared grid — plain numpy,
        O(delta), IDEMPOTENT. Returns whether anything moved."""
        self._seed_approx_shared(st, sft)
        grid = st.approx_grid
        cells = st.approx_cells
        changed_any = False
        if cleared:
            if cells or grid.any():
                changed_any = True
            grid[:] = 0.0
            cells.clear()
        for fid in removed:
            old = cells.pop(fid, None)
            if old is not None:
                grid[old] -= 1.0
                changed_any = True
        if delta is not None and len(fids):
            rows, cols = self._host_cells(sft, delta, len(fids))
            for j, fid in enumerate(fids):
                new = (int(rows[j]), int(cols[j]))
                old = cells.get(fid)
                if old == new:
                    continue
                if old is not None:
                    grid[old] -= 1.0
                grid[new] += 1.0
                cells[fid] = new
                changed_any = True
        return changed_any

    def _apply_approx(self, st: _TypeState, sub: Subscription,
                      offer: bool = True) -> None:
        """Resample the shared grid onto one subscription's window and
        push the typed `approx_density` frame carrying the bound."""
        from geomesa_tpu_torch.approx.sketches import resample_bounds

        d = sub.density
        grid, bound = resample_bounds(
            st.approx_grid, None, d.bbox, d.width, d.height)
        with sub._lock:
            sub.grid = grid
        if not offer:
            return
        total = float(grid.sum())
        sub.offer({
            "event": "approx_density",
            "approx": True,
            "total": total,
            "cells": int(np.count_nonzero(grid)),
            "bound": float(bound),
            "confidence": 1.0,
            "within_tolerance": bound <= d.tolerance * max(total, 1.0),
        })
        self._bump("events")
        self._bump("approx_frames")

    # -- degraded per-subscription path ------------------------------------

    def _fold_fallback(self, st, sft, subs, delta, dev, fids,
                       changed, removed, cleared) -> None:
        """Per-subscription evaluation after a fused or lane crash: the
        poisonous predicate is struck (and quarantined after the
        configured strikes); everything healthy still folds this window
        exactly once."""
        approx_dens = [s for s in subs
                       if s.density is not None and s.density.approx]
        if approx_dens:
            # approx windows never rode the crashed call — the shared
            # host fold serves them exactly as on the clean path; only a
            # SHARED-fold failure strikes the whole set
            shared_err = None
            try:
                changed_any = self._fold_approx_shared(
                    st, sft, delta, fids, removed, cleared)
            except Exception as e:  # noqa: BLE001 — shared state failed
                shared_err = e
            for sub in approx_dens:
                try:
                    if shared_err is not None:
                        self._strike(sub, shared_err)
                    elif sub._resync_pending():
                        self._resync(sub)
                    elif changed_any:
                        self._apply_approx(st, sub)
                except Exception as e:  # noqa: BLE001 — strike, not spread
                    self._strike(sub, e)
        for sub in subs:
            if sub.density is not None and sub.density.approx:
                continue
            try:
                if sub._resync_pending():
                    self._resync(sub)
                    continue
                if sub.density is not None:
                    cell = None
                    if delta is not None and len(fids):
                        cell = self._density_cells_host(sub.density, sft,
                                                        delta)
                    self._apply_density(sub, delta, fids, cell,
                                        removed, cleared)
                else:
                    if delta is not None and len(fids):
                        f = self._filter_for(st.type_name, sub.cql, sft)
                        with _typed_oom():
                            mask = f.mask_refined(dev, delta)[: len(fids)]
                    else:
                        mask = np.zeros(0, bool)
                    self._apply_predicate(sub, fids, mask, removed,
                                          cleared)
            except Exception as e:  # noqa: BLE001 — strike, don't spread
                self._strike(sub, e)

    def _strike(self, sub: Subscription, exc: BaseException) -> None:
        if not self._quarantine_enabled or _infra_error(exc):
            # no strike: quarantine is disabled (quarantine_after=0), or
            # the failure is an infrastructure answer, not a predicate
            # crash. State for THIS sub may be partially applied, so
            # re-seed from the snapshot instead.
            self._bump("eval_errors")
            with sub._lock:
                sub._resync = True
            return
        self._bump("strikes")
        tripped = self.quarantine.strike(sub.fingerprint())
        with sub._lock:
            sub._resync = True  # survived strikes re-seed on next fold
        RECORDER.note_event(
            "subscribe", action="strike", subscription=sub.sub_id,
            error=f"{type(exc).__name__}: {exc}")
        if tripped:
            self.registry.quarantine(sub.sub_id)
            # stamp the quarantine TTL so an abandoned quarantined
            # subscription is swept by expire_tick instead of leaking
            with sub._lock:
                ttl_at = sub.clock() + self.quarantine.ttl_s
                sub.expires_at = (ttl_at if sub.expires_at is None
                                  else min(sub.expires_at, ttl_at))
            sub.offer({
                "event": "quarantined",
                "message": (f"predicate crashed evaluation "
                            f"{self.quarantine.strikes}+ times: "
                            f"{type(exc).__name__}"),
            })
            try:
                from geomesa_tpu_torch.utils.metrics import metrics

                metrics.counter("subscribe.quarantined")
            except Exception:
                pass

    def _resync(self, sub: Subscription) -> None:
        """Re-seed a subscription that missed a fold (post-crash) from
        the live snapshot and flag the client with a lagged/state
        hand-off instead of silently diverging."""
        self.bootstrap(sub)
        with sub._lock:
            sub._resync = False
            sub.lagged = True
        self._bump("resyncs")

    # -- delta construction ------------------------------------------------

    def _delta_batch(self, sft, changed: "dict[str, dict]",
                     device: bool = True):
        """Columnar delta: the window's changed rows as one pow2-padded
        FeatureBatch + DeviceBatch (f32 coords — the serving dtype).
        `device=False` (all-approx subscription sets) skips the upload."""
        if not changed:
            return None, None, []
        from geomesa_tpu_torch.core.columnar import FeatureBatch

        fids = list(changed)
        data = {a.name: [changed[f].get(a.name) for f in fids]
                for a in sft.attributes}
        batch = FeatureBatch.from_pydict(sft, data, fids=fids)
        if not device:
            return batch.pad_to(next_pow2(max(len(batch), _PAD_MIN))), None, fids
        padded, dev = self._upload(batch)
        return padded, dev, fids


def _coalesce(events: List[tuple]):
    """Fold a window's FeatureEvents, in order, into (changed,
    removed, cleared): latest-wins per fid, a Clear supersedes
    everything before it."""
    changed: Dict[str, dict] = {}
    removed: Dict[str, None] = {}
    cleared = False
    for kind, fid, attrs in events:
        if kind == "changed":
            changed[fid] = attrs
            removed.pop(fid, None)
        elif kind == "removed":
            changed.pop(fid, None)
            removed[fid] = None
        elif kind == "cleared":
            changed.clear()
            removed.clear()
            cleared = True
    return changed, list(removed), cleared


def _geom_name(sft) -> str:
    g = sft.default_geometry
    if g is None:
        raise ValueError(f"feature type {sft.name!r} has no geometry")
    return g.name


def _batch_fids(batch) -> List[str]:
    if batch.fids is None:
        return [str(i) for i in range(len(batch))]
    return [str(f) for f in batch.fids.decode()]
