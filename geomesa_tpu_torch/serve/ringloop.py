"""Persistent serve loop: ring-fed windows over captured CUDA graphs.

The port of the reference package's `serve/ringloop.py`. The pipeline
overlaps each window's host work with the previous window's kernels, but
every window still pays that host work: plan, residency walk, filter mask
(several passes over every resident row), tile selection, capacity and
the launches. This module pays it once per window class.

One **ring program** per (type, canonical CQL, hints, k, impl, Q bucket)
window class (planner.ring_arm): the plan, the resident superbatch, the
f64-exact filter mask and its padded columns, the tile list and the
calibrated capacity, the fused-count scalar and the capture are frozen
at arm time. On a card the capture is one CUDA graph per ring slot
(`compilecache/registry.py`): a replay writes the same output tensors as
the replay before it, so each slot has its own graph, its own static
query pair and its own outputs, and a slot comes round only after
`depth` windows — above the pipeline's in-flight bound, and the slot
write waits on the event of the window that last read it. On a mesh the
program is the mesh serving program over the frozen per-shard masks (B1
a shard, the merge on the lead device; its slots live on the lead). On
a mesh that spans processes each process replays its own shards' graphs
and the merge, a collective over the process group, runs after the
replay outside the graphs: every process must then feed the same
windows in the same order (the same requests, one closed client a
process), since the order of windows is the order of collectives. On
a CPU store the program calls the same frozen body without a graph. Per
window the work is ONLY

    slot write     the stager's copy into the next slot's query pair
    dispatch       ONE graph replay
    harvest        the completer thread's readback wait

`dispatches_per_window` (the `serve.device.ops` delta per window) meters
exactly this: the ring route is below the pipelined one.

Correctness contract:

- **bit-identity**: the graphs run the serial route's kernels over the
  same frozen mask, tile list and capacity, the slot carries the same
  host f64->f32 cast, and sync is the serial route's sync;
- **typed fallback**: only the reference's reasons (RingIneligible: a
  planner with interceptors, no manifest versions, no device cache, a
  non-point geometry, nothing resident, and on a mesh a window whose
  rows live on one shard, which the shard-affinity route serves) and
  a stale version send a window to the pipelined route, metered under
  `serve.ring.fallbacks`; a failed capture, build or launch fails the
  window typed (GraphCaptureError, KernelBuildError, KernelLaunchError)
  and is never answered from another route;
- **staleness**: `RingProgram.fresh()` per window is a lock-peek plus an
  int compare; a write sends the next window down the pipelined route,
  whose plan/ensure rebuilds residency, and the ring re-arms against the
  new version on the window after.
"""

from __future__ import annotations

import threading
from typing import Dict

from geomesa_tpu_torch.telemetry.trace import TRACER
from geomesa_tpu_torch.utils.metrics import metrics

__all__ = ["RingLoop"]


class RingLoop:
    """The ring-program table and feed seam behind DispatchPipeline.

    Owned by one pipeline; `try_feed` runs on the service's dispatch
    thread in place of transfer+launch, the harvest stays on the
    pipeline's completer. Armed programs are bounded (`MAX_PROGRAMS`,
    least-recently-fed eviction) and ineligibility is negative-cached per
    key until the storage version moves, so a permanently ineligible
    window class costs one dict probe per window, not one failed arm."""

    MAX_PROGRAMS = 32

    def __init__(self, service, stager, depth: int = 4):
        self.service = service
        self.stager = stager  # device -> the QueryStager that writes slots
        self.depth = max(2, int(depth))
        self._lock = threading.Lock()
        self._programs: Dict[tuple, object] = {}   # key -> RingProgram
        self._refused: Dict[tuple, tuple] = {}     # key -> (mv, reason)
        self._owners: Dict[int, object] = {}       # planners armed on
        self._windows = 0
        self._armed = 0
        self._fallbacks: Dict[str, int] = {}

    # -- feed seam (dispatch thread) ---------------------------------------

    def try_feed(self, win) -> bool:
        """Dispatch one prepared window over its ring program. Returns
        True with `win.launch` armed (the completer harvests it exactly
        like a pipelined launch), or False: the caller runs the pipelined
        transfer+launch. Raises only what a pipelined launch could raise,
        plus GraphCaptureError from an arm; the caller's failure ladder
        applies unchanged."""
        from geomesa_tpu_torch.serve.batcher import note_launch_route, ring_key

        lead = win.lead
        key = ring_key(lead, len(win.qx))
        if key is None:
            return False
        prog = self._current_program(key, win)
        if prog is None:
            return False
        stager = self.stager(prog.device)
        with TRACER.scope(lead.trace, parent_id=win.wid):
            with prog.capture.lock:
                with TRACER.span("ring.slot", q=int(len(win.qx)),
                                 depth=self.depth):
                    win.staged = stager.stage(key, win.qx, win.qy,
                                              ring=prog.slots)
                with TRACER.span("kernel.dispatch", kernel="knn_ring",
                                 q=int(len(win.qx)), k=prog.kk):
                    win.launch = prog.launch(
                        win.staged, win.qx, win.qy,
                        want_mask_count=bool(win.running_counts))
        note_launch_route(win.running + win.running_counts, win.launch)
        with self._lock:
            self._windows += 1
        return True

    def _current_program(self, key, win):
        """The fresh armed program for `key`, arming on first use — or
        None (typed fallback to the pipeline), with the reason metered."""
        with self._lock:
            prog = self._programs.pop(key, None)
            if prog is not None:
                self._programs[key] = prog  # re-insert = LRU touch
        if prog is not None:
            if prog.fresh():
                return prog
            # a version move stales EVERY armed program of that storage
            # generation: sweep them now so idle keys do not pin the
            # previous superbatch's device tensors
            with self._lock:
                for k in [k for k, p in self._programs.items()
                          if not p.fresh()]:
                    del self._programs[k]
            self._note_fallback("stale")
            # deliberately NOT re-armed inline: the pipelined window this
            # falls back to runs plan/ensure, rebuilding residency, so the
            # NEXT window's arm binds the new superbatch
            return None
        return self._arm(key, win)

    def _arm(self, key, win):
        """One-time arm for a window class: about one pipelined window's
        plan+mask work plus the capture, over every window after it."""
        from geomesa_tpu_torch.compilecache.registry import registry
        from geomesa_tpu_torch.plan.planner import RingIneligible

        lead = win.lead
        planner = win.source.planner
        if not hasattr(planner, "ring_arm"):
            return None
        mv_fn = getattr(planner.storage, "manifest_version", None)
        mv = None
        if mv_fn is not None:
            try:
                mv = int(mv_fn())
            except Exception:  # noqa: BLE001 — unversioned: no cache key
                mv = None
        with self._lock:
            refused = self._refused.get(key)
        if refused is not None and refused[0] == mv:
            # the same meter as a fresh refusal: stats and the exported
            # counter agree on every fallback, cached or not
            self._note_fallback(refused[1])
            return None
        try:
            prog = planner.ring_arm(lead.query, q_padded=len(win.qx),
                                    k=lead.k, impl=lead.impl,
                                    depth=self.depth)
        except RingIneligible as e:
            with self._lock:
                self._refused[key] = (mv, e.reason)
                while len(self._refused) > 4 * self.MAX_PROGRAMS:
                    self._refused.pop(next(iter(self._refused)))
            self._note_fallback(e.reason)
            return None
        with self._lock:
            self._refused.pop(key, None)
            self._programs[key] = prog
            self._armed += 1
            if id(planner) not in self._owners:
                self._owners[id(planner)] = planner
                registry.retain(planner)
            while len(self._programs) > self.MAX_PROGRAMS:
                # least-recently-fed program goes first; its device refs
                # free once in-flight windows sync
                self._programs.pop(next(iter(self._programs)))
        return prog

    def _note_fallback(self, reason: str) -> None:
        with self._lock:
            self._fallbacks[reason] = self._fallbacks.get(reason, 0) + 1
        metrics.counter("serve.ring.fallbacks")

    # -- lifecycle / introspection -----------------------------------------

    def close(self) -> None:
        """Drop every armed program (their device refs free once in-flight
        windows sync) and release the planners armed on: the last ring
        loop of a planner to close drops its captures from the registry."""
        from geomesa_tpu_torch.compilecache.registry import registry

        with self._lock:
            self._programs.clear()
            self._refused.clear()
            owners = list(self._owners.values())
            self._owners.clear()
        for planner in owners:
            registry.release(planner)

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": self.depth,
                "programs": len(self._programs),
                "armed": self._armed,
                "windows": self._windows,
                "fallbacks": dict(sorted(self._fallbacks.items())),
            }
