"""Pipelined dispatch: keep the card busy across coalesced windows.

The port of the reference package's `serve/pipeline.py`. The serial
dispatch loop serialises, per window: host stacking -> host-to-device
transfer -> plan, mask and kernel launch -> device sync -> respond, and
the card idles through every host phase. This module overlaps them. Each
coalesced kNN window is split into stages:

    prepare   host stacking/padding of member query points
              (batcher.stack_queries — byte-identical to serial)
    transfer  host-to-device staging of the stacked queries through
              engine.device.QueryStager: pinned host slots, non_blocking
              copies on one copy stream, an event the compute stream
              waits on
    launch    planner.knn_launch: plan -> mask -> kernel launch, then the
              results' device-to-host copies and ONE CUDA event after
              them (PyTorch returns before the card finishes)
    sync      planner.KnnLaunch.sync on the COMPLETER thread: waits on
              that window's event alone, overflow fallback, result split,
              future resolution

The dispatch thread runs prepare/transfer/launch for window N+1 while
window N's kernels still run; the sync is deferred to a completer thread.
Windows in flight are bounded by `depth` (default 2: double buffering):
the dispatch thread blocks on the window semaphore when the pipeline is
full, which bounds device memory.

Cross-kind fusion rides here too: COUNT requests whose (type, CQL,
hints) match the kNN window (batcher.fused_count_key) resolve from the
window's reduction over its f64-exact mask — one launch instead of a
second dispatch. `KnnLaunch.fused_ok` stays in the contract; a declined
rider is dispatched serially on the completer.

Failure semantics match the serial path: device OOM runs the batcher's
halving ladder, re-staging from the HOST query copies each request
still holds (a staged slot is never re-read: the overflow fallback, too,
re-uploads the host copies); on a card store the ladder ends in a typed
DeviceOOM, never on the host. Any other error fans out
typed to every member.

Both threads share one interpreter: the dispatch thread's host work
(`dispatch_ms` in `stats()`) and the completer's (`complete_ms`) are
metered apart, so the split of a window's host time is visible.
"""

from __future__ import annotations

import logging
import threading
import time
from queue import Empty, SimpleQueue
from time import perf_counter_ns
from typing import Dict, List, Optional

from geomesa_tpu_torch.serve.batcher import (
    _oom_fallback, _run_group, batch_timeout_ms, note_launch_route,
    split_knn_results, stack_queries)
from geomesa_tpu_torch.serve.scheduler import QueryRejected, ServeRequest
from geomesa_tpu_torch.telemetry.recorder import RECORDER
from geomesa_tpu_torch.telemetry.trace import TRACER, new_span_id
from geomesa_tpu_torch.utils.metrics import metrics

_STOP = object()
log = logging.getLogger(__name__)


class PipelinedWindow:
    """One coalesced window moving through the pipeline stages."""

    __slots__ = ("source", "live", "counts", "lead", "t0", "g0_ns",
                 "adopt_from", "wid", "running", "running_counts",
                 "qx", "qy", "offsets", "staged", "launch", "stalls",
                 "recovery", "seq", "prep_start_ns")

    def __init__(self, source, live, counts, lead, t0, g0_ns, adopt_from,
                 seq):
        self.source = source
        self.live = live            # every popped member (incl. cancelled)
        self.counts = counts        # fused count riders
        self.lead = lead
        self.t0 = t0                # monotonic at dispatch start
        self.g0_ns = g0_ns          # perf_counter_ns at gather start
        self.adopt_from = adopt_from
        self.seq = seq
        self.wid: Optional[int] = None   # pre-allocated window span id
        self.running: List[ServeRequest] = []
        self.running_counts: List[ServeRequest] = []
        self.qx = self.qy = self.offsets = None
        self.staged = None
        self.launch = None
        self.stalls: list = []
        self.recovery: list = []
        self.prep_start_ns = 0


def _shutting_down() -> QueryRejected:
    return QueryRejected("shutting_down",
                         "service closed before the pipelined window synced")


class DispatchPipeline:
    """The pipelined execution path behind QueryService._dispatch.

    Owned by one QueryService; `submit` runs on the service's dispatch
    thread, the deferred syncs on this pipeline's completer thread.
    `depth` bounds windows in flight (submit blocks when full)."""

    def __init__(self, service, depth: int = 2,
                 ring: bool = True, ring_depth: int = 4):
        self.service = service
        self.depth = max(2, int(depth))
        self._stagers: Dict[str, object] = {}
        # persistent serve loop (serve/ringloop.py): eligible kNN windows
        # replay a captured ring program instead of the per-window
        # transfer+launch below; ineligible ones fall back typed to it
        self.ring = None
        if ring:
            from geomesa_tpu_torch.serve.ringloop import RingLoop

            self.ring = RingLoop(service, self.stager,
                                 depth=max(int(ring_depth), self.depth))
        self._slots = threading.BoundedSemaphore(self.depth)
        self._completions: SimpleQueue = SimpleQueue()
        self._lock = threading.Lock()
        self._seq = 0
        self._inflight = 0
        self._max_inflight = 0
        self._windows = 0
        self._fused = 0
        self._fused_declined = 0
        self._dispatch_ns = 0
        self._complete_ns = 0
        self._closed = False
        self._worker: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def _ensure_started(self) -> None:
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._worker = threading.Thread(
                target=self._complete_loop, name="gmtpu-serve-sync",
                daemon=True)
            self._worker.start()

    def close(self, timeout_s: float = 10.0) -> None:
        """Drain remaining completions and stop the completer. Windows
        already launched still sync (no torn responses on shutdown)."""
        with self._lock:
            self._closed = True
            worker = self._worker
        if worker is not None and worker.is_alive():
            self._completions.put(_STOP)
            worker.join(timeout=timeout_s)
        if self.ring is not None:
            # after the completer: no synced window still reads a capture
            self.ring.close()
        # a window enqueued AFTER the _STOP sentinel would sit in a queue
        # nobody reads: its member futures must fail typed
        while True:
            try:
                win = self._completions.get_nowait()
            except Empty:
                break
            if win is _STOP:
                continue
            exc = _shutting_down()
            for r in win.running + win.running_counts:
                if not r.future.done():
                    r.future.set_exception(exc)
            self._window_done(win)

    def stager(self, device):
        """The QueryStager of `device` (one per device, made on first use;
        the ring's slot writes go through it too)."""
        from geomesa_tpu_torch.engine.device import QueryStager

        name = str(device)
        with self._lock:
            st = self._stagers.get(name)
            if st is None:
                st = self._stagers[name] = QueryStager(self.depth, device)
            return st

    # -- dispatch-thread stages --------------------------------------------

    def submit(self, source, live: List[ServeRequest],
               counts: List[ServeRequest], lead, t0: float, g0_ns: int,
               adopt_from: int) -> None:
        """Run prepare/transfer/launch for one window and hand it to the
        completer. Blocks while `depth` windows are in flight. Every
        failure resolves member futures and completes the window's
        bookkeeping before returning."""
        from geomesa_tpu_torch.compilecache.stall import STALLS
        from geomesa_tpu_torch.faults import RECOVERY

        self._ensure_started()
        # bounded-wait acquire: a dead completer must fail the dispatch
        # thread loudly instead of wedging it on a slot that never frees
        while not self._slots.acquire(timeout=1.0):
            with self._lock:
                worker = self._worker
            if worker is None or not worker.is_alive():
                raise RuntimeError(
                    "pipeline completer is not running; window slots "
                    "cannot free")
        t_start = perf_counter_ns()
        with self._lock:
            self._seq += 1
            self._inflight += 1
            self._max_inflight = max(self._max_inflight, self._inflight)
            seq = self._seq
        win = PipelinedWindow(source, live, counts, lead, t0, g0_ns,
                              adopt_from, seq)
        if lead.trace is not None:
            win.wid = new_span_id()
        stall_token = STALLS.token()
        rec_token = RECOVERY.token()
        try:
            self._prepare(win)
            if win.running:
                # ring route first: slot write + one replay; a typed
                # refusal (ineligible/stale) keeps the pipelined
                # transfer+launch, and a feed ERROR lands in the same
                # failure ladder a launch error would
                if self.ring is None or not self.ring.try_feed(win):
                    self._transfer(win)
                    self._launch(win)
        except BaseException as e:  # noqa: BLE001 — serial-path parity
            self._note_meters(win, stall_token, rec_token)
            self._fail(win, e)
            self._window_done(win)
            return
        finally:
            with self._lock:
                self._dispatch_ns += perf_counter_ns() - t_start
        self._note_meters(win, stall_token, rec_token)
        if not win.running:
            # every kNN member was cancelled between pop and prepare: the
            # fused counts still deserve their (serial) dispatch
            if win.running_counts:
                _run_group(win.source, win.running_counts)
            self._window_done(win)
            return
        with self._lock:
            self._windows += 1
            closed = self._closed
        if closed:
            self._fail(win, _shutting_down())
            self._window_done(win)
            return
        self._completions.put(win)

    def _note_meters(self, win: PipelinedWindow, stall_token: int,
                     rec_token: int) -> None:
        """Build and capture stalls and recovery events (retried transfers
        and reads, injected faults) this thread noted during the window's
        stages are the window's (thread-scoped, like the serial path): the
        dispatch thread's prepare/stage/launch (a ring slot write and
        replay included) and the completer's sync each add their own."""
        from geomesa_tpu_torch.compilecache.stall import STALLS
        from geomesa_tpu_torch.faults import RECOVERY

        ident = threading.get_ident()
        win.stalls.extend(STALLS.since(stall_token, thread_ident=ident))
        win.recovery.extend(RECOVERY.since(rec_token, thread_ident=ident))

    def _prepare(self, win: PipelinedWindow) -> None:
        """Host stacking/padding (batcher.stack_queries). Marks member
        futures running — a rider cancelled while queued drops out here
        exactly like the serial execute_batch."""
        win.prep_start_ns = perf_counter_ns()
        win.running = [r for r in win.live
                       if r.future.set_running_or_notify_cancel()]
        win.running_counts = [r for r in win.counts
                              if r.future.set_running_or_notify_cancel()]
        if not win.running:
            return
        win.qx, win.qy, win.offsets = stack_queries(win.running)
        trace = win.lead.trace
        if trace is not None and win.wid is not None:
            trace.record("prepare", win.prep_start_ns, perf_counter_ns(),
                         parent_id=win.wid, batch=len(win.running))

    def _transfer(self, win: PipelinedWindow) -> None:
        """Stage the stacked queries into the next slot of the window's
        key: the copy overlaps the previous window's kernels."""
        lead = win.lead
        planner = win.source.planner
        key = (lead.query.type_name, lead.k, lead.impl, len(win.qx))
        with TRACER.scope(lead.trace, parent_id=win.wid):
            with TRACER.span("device.transfer", rows=len(win.qx), staged=True):
                win.staged = self.stager(planner.device).stage(
                    key, win.qx, win.qy)

    def _launch(self, win: PipelinedWindow) -> None:
        """planner.knn_launch: plan -> mask -> launch + readback. The
        fused count reduction rides the same launch when requested."""
        lead = win.lead
        planner = win.source.planner
        timeout_ms = batch_timeout_ms(win.running + win.running_counts)
        with TRACER.scope(lead.trace, parent_id=win.wid):
            win.launch = planner.knn_launch(
                lead.query, win.qx, win.qy, k=lead.k, impl=lead.impl,
                timeout_ms=timeout_ms, staged=tuple(win.staged),
                want_mask_count=bool(win.running_counts))
        if win.launch.event is not None:
            win.staged.consumed = win.launch.event
        # routing attribution lands BEFORE the deferred sync, so the
        # completer's ServeEvents carry it even when the window fails
        note_launch_route(win.running + win.running_counts, win.launch)

    # -- completer thread --------------------------------------------------

    def _complete_loop(self) -> None:
        while True:
            win = self._completions.get()
            if win is _STOP:
                return
            t_start = perf_counter_ns()
            try:
                self._sync(win)
            except Exception as e:  # noqa: BLE001 — the completer must live
                log.exception("serve pipeline completer error")
                RECORDER.crash_dump("serve pipeline completer error", e)
            with self._lock:
                self._complete_ns += perf_counter_ns() - t_start
            try:
                self._window_done(win)
            except Exception as e:  # noqa: BLE001 — the slot was released
                log.exception("serve pipeline finish error")
                RECORDER.crash_dump("serve pipeline finish error", e)

    def _sync(self, win: PipelinedWindow) -> None:
        """Deferred sync: wait on the window's event, split the results,
        resolve fused counts — and the serial path's failure ladder when
        the window errors."""
        from geomesa_tpu_torch.compilecache.stall import STALLS
        from geomesa_tpu_torch.faults import RECOVERY

        token = STALLS.token()
        rec_token = RECOVERY.token()
        lead = win.lead
        try:
            with TRACER.scope(lead.trace, parent_id=win.wid):
                with TRACER.span("device.sync", ring=bool(win.launch.ring)):
                    dists, idx, batch = win.launch.sync()
                split_knn_results(win.running, win.offsets, dists, idx, batch)
            self._resolve_counts(win)
        except BaseException as e:  # noqa: BLE001 — fan out, serial parity
            self._fail(win, e)
        finally:
            self._note_meters(win, token, rec_token)

    def _resolve_counts(self, win: PipelinedWindow) -> None:
        if not win.running_counts:
            return
        launch = win.launch
        if launch is not None and launch.fused_ok \
                and launch.mask_count is not None:
            with self._lock:
                self._fused += len(win.running_counts)
            metrics.counter("serve.fused.counts", len(win.running_counts))
            for r in win.running_counts:
                r.future.set_result(launch.mask_count)
        else:
            # the planner never declines today (the mask is f64-exact),
            # but the contract allows it: a declined rider gets its own
            # serial dispatch — slower, never wrong
            with self._lock:
                self._fused_declined += len(win.running_counts)
            _run_group(win.source, win.running_counts)

    def _fail(self, win: PipelinedWindow, exc: BaseException) -> None:
        """Window failure = the serial path's ladder: OOM halves and
        re-runs from the host query copies (a card store ends in a typed
        DeviceOOM), everything else fans out typed. Fused counts always
        get a real (serial) count attempt."""
        from geomesa_tpu_torch.faults import classify

        RECORDER.note_event(
            "pipeline", action="window_failed", seq=win.seq,
            members=len(win.running) + len(win.running_counts),
            error=type(exc).__name__)
        # done-future guards: a failure AFTER partial resolution must
        # only fail the still-pending members
        pending = [r for r in win.running if not r.future.done()]
        if pending:
            if isinstance(exc, Exception) and classify(exc) == "oom":
                _oom_fallback(win.source, pending, exc)
            else:
                for r in pending:
                    r.future.set_exception(exc)
        pending_counts = [r for r in win.running_counts
                          if not r.future.done()]
        if pending_counts:
            try:
                _run_group(win.source, pending_counts)
            except BaseException as e:  # noqa: BLE001 — never drop a rider
                for r in pending_counts:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _window_done(self, win: PipelinedWindow) -> None:
        """Completion bookkeeping, called exactly once per submitted
        window: record the window span, hand the window to the service's
        shared finish path, free the slot."""
        t1 = time.monotonic()
        end_ns = perf_counter_ns()
        trace = win.lead.trace
        if trace is not None and win.wid is not None:
            trace.record("dispatch", win.g0_ns, end_ns, span_id=win.wid,
                         batch=len(win.live), pipelined=True, seq=win.seq,
                         fused=len(win.counts))
        try:
            try:
                self.service._window_complete(win, t1, end_ns)
            except Exception as e:  # noqa: BLE001 — bookkeeping only: the
                # futures are resolved, and raising here would release the
                # service's in-flight token twice
                log.exception("serve pipeline finish error")
                RECORDER.crash_dump("serve pipeline finish error", e)
        finally:
            with self._lock:
                self._inflight -= 1
            self._slots.release()

    # -- introspection -----------------------------------------------------

    def reset_max_inflight(self) -> None:
        """Re-seed the windows-in-flight high-water mark at the current
        depth, so a measured run reports its own peak."""
        with self._lock:
            self._max_inflight = self._inflight

    def stats(self) -> dict:
        with self._lock:
            out = {
                "depth": self.depth,
                "windows": self._windows,
                "inflight": self._inflight,
                "max_inflight": self._max_inflight,
                "fused_counts": self._fused,
                "fused_declined": self._fused_declined,
                "dispatch_ms": self._dispatch_ns / 1e6,
                "complete_ms": self._complete_ns / 1e6,
                "stager": {"keys": 0, "staged": 0},
            }
            stagers = list(self._stagers.values())
        for st in stagers:
            for name, v in st.stats().items():
                out["stager"][name] += v
        if self.ring is not None:
            out["ring"] = self.ring.stats()
        return out
