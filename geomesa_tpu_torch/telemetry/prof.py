"""Continuous serve profiler: always-on, bounded-cost trace folding.

A copy of the reference package's `telemetry/prof.py`. The flight
recorder keeps the last 256 traces; the gap report answers "where did
time go" over exactly that window. This module keeps the same
attribution over the process lifetime at a fixed memory bound: every
completed trace folds into reservoir-sampled per-phase / per-kernel /
per-shard distributions the moment the serve layer records it
(`FlightRecorder.record` calls `PROFILER.maybe_fold`), and
`MetricsServer`'s `/debug/prof` answers from all of it.

What one fold extracts (a single pass over the trace's span dicts):

- **per-phase**: duration reservoir + count/total per span name (admit,
  queue.wait, dispatch, prepare, plan, residency, device.transfer,
  kernel.dispatch, device.sync, merge, ...). Riders adopt copies of the
  shared window spans with span ids preserved, so the fold dedups by id
  against a bounded recently-seen set: N riders never count one kernel
  N times.
- **per-kernel family**: `kernel.dispatch` spans carry a `kernel` attr
  (filter.mask, knn_sparse, knn_fullscan, knn_mesh, knn_ring); host time
  to the launch folds per family, and the enclosing dispatch window's
  host gap (window minus device-phase time) folds alongside.
- **per-shard**: device-phase spans stamped with owning `shards` (the
  mesh's shards) accumulate per shard id; the report derives lane
  shares and an imbalance ratio (max/mean device time).
- **pipeline overlap**: a streaming estimate over dispatch windows in
  completion order (each new window against a small ring of recent
  ones), O(1) per fold; the gap report remains the exact number over
  the recorder's window.

Spans are host clocks: a `kernel.dispatch` span measures the launch's
host time (the card runs it asynchronously) and `device.sync` the wait
for its results. `fold()` is one span-list pass; `maybe_fold()` with the
profiler disabled is one attribute read. Reservoirs are fixed-size
(algorithm R), so memory is bounded whatever the uptime.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

__all__ = ["Reservoir", "ContinuousProfiler", "PROFILER", "render_prof"]

# ring.slot is the persistent serve loop's slot write — device-facing
# like device.transfer (serve/ringloop.py); its
# kernel family (knn_ring) folds from the kernel.dispatch attr as usual
DEVICE_PHASES = ("kernel.dispatch", "device.sync", "device.transfer",
                 "ring.slot")
_DEVICE_SET = frozenset(DEVICE_PHASES)
RESERVOIR_K = 256
_SEEN_CAP = 4096          # recently-seen span ids (rider dedup window)
_WINDOW_RING = 8          # recent dispatch windows for overlap estimate


class Reservoir:
    """Fixed-size uniform sample (algorithm R) + count/total. Not
    thread-safe on its own — the profiler folds under one lock."""

    __slots__ = ("k", "n", "total", "samples", "_random")

    def __init__(self, k: int = RESERVOIR_K, seed: int = 0):
        self.k = k
        self.n = 0
        self.total = 0.0
        self.samples: List[float] = []
        # bound method, not randrange: the fold budget is single-digit
        # microseconds per trace and randrange() alone costs ~0.6µs —
        # `int(random() * n)` is the classic algorithm-R form and ~8x
        # cheaper (the float truncation bias at 2^53 is irrelevant at
        # reservoir scale)
        self._random = random.Random(seed).random

    def add(self, v: float) -> None:
        # (caller-holds-lock: every Reservoir lives inside ONE
        # ContinuousProfiler, and add()/snapshot() run exclusively
        # under that profiler's _lock — a per-reservoir lock would
        # re-lock the same critical section per span)
        self.n += 1
        # (same: guarded by the owning profiler's _lock)
        self.total += v
        samples = self.samples
        if len(samples) < self.k:
            # (same: guarded by the owning profiler's _lock)
            samples.append(v)
        else:
            j = int(self._random() * self.n)
            if j < self.k:
                samples[j] = v

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        i = min(int(q * len(s)), len(s) - 1)
        return s[i]

    def snapshot(self, include_samples: bool = False) -> dict:
        s = sorted(self.samples)

        def q(p):
            return s[min(int(p * len(s)), len(s) - 1)] if s else 0.0

        doc = {
            "n": self.n,
            "total_ms": round(self.total, 3),
            "mean_ms": round(self.total / self.n, 4) if self.n else 0.0,
            "p50_ms": round(q(0.50), 4),
            "p90_ms": round(q(0.90), 4),
            "p99_ms": round(q(0.99), 4),
        }
        if include_samples:
            doc["samples_ms"] = [round(v, 4) for v in s]
        return doc


class ContinuousProfiler:
    """The process-wide aggregator behind `/debug/prof` and
    the sentinel. Disabled by default; `enable()` makes the recorder
    fold every trace it stores (`FlightRecorder.record` calls
    `maybe_fold`), `disable()` restores the one-attribute-read no-op
    path. `reset()` drops accumulated state (bench runs isolate their
    measured window with it)."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._traces = 0
        self._phases: Dict[str, Reservoir] = {}
        self._kernels: Dict[str, Dict[str, Reservoir]] = {}
        self._shards: Dict[str, List[float]] = {}   # sid -> [count, ms]
        self._seen: Dict[tuple, None] = {}          # insertion-ordered set
        # streaming pipeline-overlap estimate state
        self._recent_windows: List[tuple] = []      # (t0_ns, t1_ns)
        self._overlap_ns = 0
        self._window_ns = 0
        self._windows = 0
        self._inflight_max = 0

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._traces = 0
            self._phases.clear()
            self._kernels.clear()
            self._shards.clear()
            self._seen.clear()
            self._recent_windows.clear()
            self._overlap_ns = 0
            self._window_ns = 0
            self._windows = 0
            self._inflight_max = 0

    # -- folding -----------------------------------------------------------

    def maybe_fold(self, doc: Optional[dict]) -> None:
        """The recorder's hook: one attribute read when disabled."""
        if self.enabled and doc is not None:
            self.fold(doc)

    def fold(self, doc: dict) -> None:
        """Fold one completed trace (recorder storage shape). One pass
        over the span dicts; rider-adopted copies of shared window
        spans dedup by (process, span id) against a bounded
        recently-seen set."""
        spans = doc.get("spans")
        if not spans:
            return
        root = doc.get("root")
        proc = str(doc.get("trace_id", "")).split("-", 1)[0]
        # the hot loop binds everything it touches to locals — at the
        # single-digit-µs budget every self./global lookup shows up
        device_set = _DEVICE_SET
        with self._lock:
            self._traces += 1
            phases = self._phases
            phases_get = phases.get
            seen = self._seen
            if root is not None and root.get("t1_ns", 0):
                # the root is the request's end-to-end wall time — one
                # per request (riders own their roots), no dedup needed
                res = phases_get("query")
                if res is None:
                    res = phases["query"] = Reservoir()
                res.add(max(root["t1_ns"] - root["t0_ns"], 0) / 1e6)
            dispatch_windows = None
            device_in_window = 0
            kernel_fams = None
            for s in spans:
                key = (proc, s["id"])
                if key in seen:
                    continue
                seen[key] = None
                name = s["name"]
                dur_ns = s["t1_ns"] - s["t0_ns"]
                if dur_ns < 0:
                    dur_ns = 0
                dur_ms = dur_ns / 1e6
                res = phases_get(name)
                if res is None:
                    res = phases[name] = Reservoir()
                res.add(dur_ms)
                if name == "dispatch":
                    if dispatch_windows is None:
                        dispatch_windows = []
                    dispatch_windows.append((s["t0_ns"], s["t1_ns"]))
                elif name in device_set:
                    device_in_window += dur_ns
                    attrs = s.get("attrs")
                    if attrs:
                        if name == "kernel.dispatch":
                            fam = attrs.get("kernel")
                            if fam:
                                if kernel_fams is None:
                                    kernel_fams = {}
                                kernel_fams[fam] = kernel_fams.get(
                                    fam, 0.0) + dur_ms
                        ids = attrs.get("shards")
                        if ids:
                            for sid in str(ids).split(","):
                                lane = self._shards.get(sid)
                                if lane is None:
                                    lane = self._shards[sid] = [0, 0.0]
                                lane[0] += 1
                                lane[1] += dur_ms
            if len(seen) > _SEEN_CAP:
                # bounded dedup window: drop the oldest half. Rider
                # adoption happens within one dispatch window, so the
                # shared ids arrive near-adjacently — a 4096-entry
                # window dedups them with room to spare.
                for k in list(seen)[:_SEEN_CAP // 2]:
                    del seen[k]
            if dispatch_windows:
                self._fold_windows(dispatch_windows, device_in_window,
                                   kernel_fams)

    def _fold_windows(self, windows, device_ns: int, kernel_fams) -> None:
        """Per-kernel device/gap split + the streaming overlap
        estimate. Called under the lock from fold(); same local-binding
        discipline as the span loop — this runs once per window, and
        the ring comparison is the fold's second-hottest stretch."""
        win_ns = 0
        for t0, t1 in windows:
            if t1 > t0:
                win_ns += t1 - t0
        gap_ns = win_ns - device_ns
        if kernel_fams:
            # the window's host gap is attributed to every kernel
            # family that ran in it, weighted by its device share —
            # a per-family "what would speeding this kernel up buy"
            gap_ms = (gap_ns if gap_ns > 0 else 0) / 1e6
            kernels = self._kernels
            total_dev = sum(kernel_fams.values()) or 1.0
            for fam, dev_ms in kernel_fams.items():
                rec = kernels.get(fam)
                if rec is None:
                    rec = kernels[fam] = {
                        "device": Reservoir(), "gap": Reservoir()}
                rec["device"].add(dev_ms)
                rec["gap"].add(gap_ms * dev_ms / total_dev)
        recent = self._recent_windows
        overlap_ns = 0
        windows_n = 0
        inflight_max = self._inflight_max
        for t0, t1 in windows:
            if t1 <= t0:
                continue
            windows_n += 1
            inflight = 1
            win_overlap = 0
            for r0, r1 in recent:
                lo = t0 if t0 > r0 else r0
                hi = t1 if t1 < r1 else r1
                if hi > lo:
                    win_overlap += hi - lo
                    inflight += 1
            # clamp the pairwise sum to THIS window's extent: at depth
            # >2, three concurrent windows give 2x pairwise overlap per
            # window, and an unclamped sum would push overlap_share
            # past 1.0 ("150% of window time" is not a number an
            # operator can read)
            dur = t1 - t0
            overlap_ns += win_overlap if win_overlap < dur else dur
            if inflight > inflight_max:
                inflight_max = inflight
            recent.append((t0, t1))
            if len(recent) > _WINDOW_RING:
                del recent[0]
        self._windows += windows_n
        self._window_ns += win_ns
        self._overlap_ns += overlap_ns
        self._inflight_max = inflight_max

    # -- reporting ---------------------------------------------------------

    def snapshot(self, include_samples: bool = False) -> dict:
        """The /debug/prof document (and the sentinel's input)."""
        with self._lock:
            phases = {n: r.snapshot(include_samples)
                      for n, r in sorted(self._phases.items())}
            kernels = {
                fam: {"device": rec["device"].snapshot(include_samples),
                      "gap": rec["gap"].snapshot(include_samples)}
                for fam, rec in sorted(self._kernels.items())}
            lanes = {sid: {"count": int(c), "device_ms": round(ms, 3)}
                     for sid, (c, ms) in sorted(self._shards.items())}
            windows = self._windows
            window_ms = self._window_ns / 1e6
            overlap_ms = self._overlap_ns / 1e6
            inflight_max = self._inflight_max
            traces = self._traces
        imbalance = 0.0
        if lanes:
            vals = [v["device_ms"] for v in lanes.values()]
            mean = sum(vals) / len(vals)
            imbalance = max(vals) / mean if mean > 0 else 0.0
        return {
            "enabled": self.enabled,
            "traces": traces,
            "phases": phases,
            "kernels": kernels,
            "shards": {"lanes": lanes,
                       "imbalance_ratio": round(imbalance, 3)},
            "pipeline": {
                "windows": windows,
                "window_ms": round(window_ms, 3),
                "overlap_ms": round(overlap_ms, 3),
                "overlap_share": round(overlap_ms / window_ms, 4)
                if window_ms else 0.0,
                "windows_in_flight_max": inflight_max,
            },
        }


def render_prof(doc: dict) -> str:
    """The profile as text (the `/debug/prof` document rendered)."""
    lines = [
        f"continuous profile over {doc['traces']} trace(s)"
        + ("" if doc.get("enabled", True) else " (profiler now off)"),
        f"{'phase':<18}{'n':>8}{'total ms':>12}{'p50 ms':>10}"
        f"{'p90 ms':>10}{'p99 ms':>10}",
    ]
    for name, p in doc["phases"].items():
        lines.append(
            f"{name:<18}{p['n']:>8}{p['total_ms']:>12.2f}"
            f"{p['p50_ms']:>10.3f}{p['p90_ms']:>10.3f}"
            f"{p['p99_ms']:>10.3f}")
    if doc["kernels"]:
        lines.append("kernel families (device ms vs attributed host "
                     "gap ms per window):")
        for fam, rec in doc["kernels"].items():
            d, g = rec["device"], rec["gap"]
            lines.append(
                f"  {fam:<20} n={d['n']:<7} device p50 "
                f"{d['p50_ms']:.3f} / p99 {d['p99_ms']:.3f}   "
                f"gap p50 {g['p50_ms']:.3f}")
    lanes = doc["shards"]["lanes"]
    if lanes:
        parts = ", ".join(f"shard {sid}: {v['device_ms']:.1f} ms"
                          f"/{v['count']}" for sid, v in lanes.items())
        lines.append(
            f"shard lanes: {parts} (imbalance "
            f"{doc['shards']['imbalance_ratio']:.2f}x)")
    p = doc["pipeline"]
    if p["windows"]:
        lines.append(
            f"pipeline: {p['windows']} window(s), overlap "
            f"{p['overlap_ms']:.1f} ms ({p['overlap_share'] * 100:.1f}% "
            f"of window time), up to {p['windows_in_flight_max']} in "
            f"flight (streaming estimate)")
    return "\n".join(lines)


# process-wide profiler: FlightRecorder.record() folds into it when
# enabled; MetricsServer serves its snapshot at /debug/prof
PROFILER = ContinuousProfiler()
