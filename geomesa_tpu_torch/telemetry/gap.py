"""Dispatch-gap report: host-gap vs device-facing attribution from spans.

A copy of the reference package's `telemetry/gap.py`. Over any set of
query traces (the flight recorder's, or a `from_perfetto` dump) it
reports where the serve path's wall time went:

- **per-phase attribution**: total/mean/share for every span name
  (admit, queue.wait, dispatch, prepare, plan, residency,
  device.transfer, kernel.dispatch, device.sync, merge, ...);
- **coverage**: how much of each query's wall time the direct root
  phases explain (unexplained time means an un-instrumented seam).
  Child intervals are clamped to the root's extent, so overlapping
  pipelined phases never report more than 1.0;
- **dispatch gap**: within the dispatch windows, time in device-facing
  spans (kernel dispatch + sync + transfer + ring slot) vs host work
  between them. Coalesced riders adopt copies of the shared window
  spans (same span ids), so windows dedup by (process, span id);
  pipelined windows overlap in wall time, so window and stage intervals
  aggregate by interval union per process, never by summing durations;
- **pipeline**: windows in flight at most, time with two or more open,
  and transfer time that overlapped other windows;
- **ring**, **shards** and **lanes**: the ring's slot/kernel/harvest
  split, per-shard device time and the standing queries' lane classes.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

__all__ = ["gap_report", "render_gap", "DEVICE_PHASES"]

# span names that represent the device-facing part of a dispatch window;
# everything else inside the window is host work (the "gap").
# `ring.slot` is the persistent serve loop's slot write (serve/ringloop.py
# "Persistent serve loop") — a staged transfer by another name, so it
# counts as device-facing exactly like device.transfer.
DEVICE_PHASES = ("kernel.dispatch", "device.sync", "device.transfer",
                 "ring.slot")


def _doc(trace) -> dict:
    return trace if isinstance(trace, dict) else trace.to_json()


def _union_ns(intervals: List[Tuple[int, int]]) -> int:
    """Total covered length of possibly-overlapping [t0, t1) intervals."""
    merged = _merge(intervals)
    return sum(t1 - t0 for t0, t1 in merged)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, merged copy of possibly-overlapping [t0, t1) intervals."""
    if not intervals:
        return []
    out: List[Tuple[int, int]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def _clamp(t0: int, t1: int, lo: int, hi: int):
    """[t0, t1) clipped to [lo, hi), or None when empty."""
    a, b = max(t0, lo), min(t1, hi)
    return (a, b) if b > a else None


def _overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Covered length of union(a) ∩ union(b)."""
    am, bm = _merge(a), _merge(b)
    i = j = 0
    total = 0
    while i < len(am) and j < len(bm):
        lo = max(am[i][0], bm[j][0])
        hi = min(am[i][1], bm[j][1])
        if hi > lo:
            total += hi - lo
        if am[i][1] <= bm[j][1]:
            i += 1
        else:
            j += 1
    return total


def _max_concurrent(intervals: List[Tuple[int, int]]):
    """(max simultaneously-open intervals, ns with >=2 open, the
    merged [t0, t1) regions where >=2 are open). One sweep — the
    multi-open regions also drive the transfer-overlap attribution
    without a per-window quadratic rescan."""
    if not intervals:
        return 0, 0, []
    events = []
    for t0, t1 in intervals:
        events.append((t0, 1))
        events.append((t1, -1))
    events.sort()
    depth = best = 0
    multi_ns = 0
    multi: List[Tuple[int, int]] = []
    open_at = None
    prev = events[0][0]
    for t, d in events:
        if depth >= 2:
            multi_ns += t - prev
            if open_at is None:
                open_at = prev
        elif open_at is not None:
            if prev > open_at:
                multi.append((open_at, prev))
            open_at = None
        prev = t
        depth += d
        best = max(best, depth)
    if open_at is not None and prev > open_at:
        multi.append((open_at, prev))
    return best, multi_ns, _merge(multi)


def gap_report(traces: Iterable) -> dict:
    docs = [_doc(t) for t in traces]
    docs = [d for d in docs if d.get("root")]
    phases: Dict[str, Dict[str, float]] = {}
    wall_ns = 0
    covered_ns = 0
    # dispatch-window aggregation, deduped by (process, span id):
    # riders adopt the lead's window spans with ids PRESERVED, so the
    # same (process, id) appearing in several traces is one span. Span
    # ids alone are per-process counters — trace ids are pid-qualified
    # precisely so merged multi-process dumps (replica fleets) stay
    # distinguishable, and the dedup key must follow suit.
    windows: Dict[tuple, dict] = {}    # (proc, dispatch span id) -> span
    window_children: Dict[tuple, List[dict]] = {}
    seen_span_ids = set()
    # per-shard lane (the mesh's shards): device-facing
    # spans stamped with the owning shards (kernel.dispatch/device.sync
    # on a mesh service) aggregate per shard id, so a slow chip shows up
    # as ITS lane's total, not a fleet-wide average. Whole-mesh windows
    # credit every owning shard; shard-affinity windows credit one.
    shard_lanes: Dict[str, Dict[str, float]] = {}
    # ring-mode attribution: the
    # persistent serve loop's per-window cost splits into slot-wait
    # (ring.slot — the staged write into the ring), kernel (the one
    # pre-compiled dispatch, kernel.dispatch tagged knn_ring) and
    # harvest (the completer's combined read, device.sync tagged ring).
    # Aggregated over the same deduped span set as the phases table.
    ring = {"windows": 0, "slot_ms": 0.0, "kernel_ms": 0.0,
            "harvest_ms": 0.0}
    # lane attribution (the standing queries' evaluator):
    # each subscribe.lane.eval span is one per-class batched dispatch
    # stamped with its class and row count — aggregated per class so a
    # hot lane (say, 8k dwithin rows) shows up as ITS class's total,
    # next to the fused remainder in the phases table.
    lane_evals: Dict[str, Dict[str, float]] = {}
    for d in docs:
        proc = str(d.get("trace_id", "")).split("-", 1)[0]
        root = d["root"]
        root_dur = max(root["t1_ns"] - root["t0_ns"], 0)
        wall_ns += root_dur
        spans = list(d.get("spans", ()))
        by_id = {s["id"]: s for s in spans}
        root_children = [s for s in spans
                         if s.get("parent") == root["id"]]
        # clamp to the root's extent: a pipelined window's deferred sync
        # can outlive the rider that adopted it, and coverage is a share
        # of THIS root's wall time — it must stay <= 1.0
        covered_ns += _union_ns([iv for s in root_children
                                 if (iv := _clamp(s["t0_ns"], s["t1_ns"],
                                                  root["t0_ns"],
                                                  root["t1_ns"]))])
        for s in spans:
            if (proc, s["id"]) in seen_span_ids:
                continue  # adopted copy of a shared dispatch span
            seen_span_ids.add((proc, s["id"]))
            dur_ms = max(s["t1_ns"] - s["t0_ns"], 0) / 1e6
            p = phases.setdefault(
                s["name"], {"count": 0, "total_ms": 0.0})
            p["count"] += 1
            p["total_ms"] += dur_ms
            attrs = s.get("attrs") or {}
            if s["name"] == "ring.slot":
                ring["windows"] += 1
                ring["slot_ms"] += dur_ms
            elif s["name"] == "kernel.dispatch" \
                    and attrs.get("kernel") == "knn_ring":
                ring["kernel_ms"] += dur_ms
            elif s["name"] == "device.sync" and attrs.get("ring"):
                ring["harvest_ms"] += dur_ms
            if s["name"] == "subscribe.lane.eval":
                lane = lane_evals.setdefault(
                    str(attrs.get("cls", "?")),
                    {"count": 0, "total_ms": 0.0, "rows": 0})
                lane["count"] += 1
                lane["total_ms"] += dur_ms
                lane["rows"] += int(attrs.get("rows", 0) or 0)
            ids = attrs.get("shards", "")
            if ids and s["name"] in DEVICE_PHASES:
                for sid in str(ids).split(","):
                    lane = shard_lanes.setdefault(
                        sid.strip(), {"count": 0, "device_ms": 0.0})
                    lane["count"] += 1
                    lane["device_ms"] += dur_ms
            if s["name"] == "dispatch":
                windows[(proc, s["id"])] = s
        for s in spans:
            parent = by_id.get(s.get("parent"))
            while parent is not None:
                if parent["name"] == "dispatch":
                    window_children.setdefault(
                        (proc, parent["id"]), []).append(s)
                    break
                parent = by_id.get(parent.get("parent"))
    # per-process aggregation over the (deduped) windows. exec time is
    # the UNION of window intervals: pipelined windows overlap, and the
    # overlapped second is one second of device occupancy, not two.
    # Stage intervals are clamped to their window and unioned BY STAGE
    # NAME first, then across stages — overlapping transfer/kernel
    # windows dedup instead of double-counting (pre-fix, summing the
    # per-window unions let a pipelined run report device_ms > exec_ms
    # and coverage > 1.0).
    by_proc_windows: Dict[str, List[Tuple[int, int]]] = {}
    by_proc_device: Dict[str, List[Tuple[int, int]]] = {}
    by_proc_host: Dict[str, List[Tuple[int, int]]] = {}
    # transfer intervals clamped to their OWNING window (by span
    # parentage, not interval containment — overlapping windows both
    # contain the same instant)
    by_proc_transfer: Dict[str, List[Tuple[int, int]]] = {}
    transfer_overlap_ns = 0
    for (proc, wid), w in windows.items():
        w0, w1 = w["t0_ns"], w["t1_ns"]
        if w1 <= w0:
            continue
        by_proc_windows.setdefault(proc, []).append((w0, w1))
        kids = {s["id"]: s for s in window_children.get((proc, wid), ())}
        for s in kids.values():
            iv = _clamp(s["t0_ns"], s["t1_ns"], w0, w1)
            if iv is None:
                continue
            if s["name"] in DEVICE_PHASES:
                by_proc_device.setdefault(proc, []).append(iv)
                if s["name"] == "device.transfer":
                    by_proc_transfer.setdefault(proc, []).append(iv)
            else:
                by_proc_host.setdefault(proc, []).append(iv)
    exec_ns = sum(_union_ns(v) for v in by_proc_windows.values())
    device_ns = sum(_union_ns(v) for v in by_proc_device.values())
    host_work_ns = sum(_union_ns(v) for v in by_proc_host.values())
    inflight_max = 0
    multi_window_ns = 0
    for proc, ivs in by_proc_windows.items():
        depth, multi, multi_regions = _max_concurrent(ivs)
        inflight_max = max(inflight_max, depth)
        multi_window_ns += multi
        # transfer time spent while ANOTHER window was open — the
        # "transfer hides behind compute" evidence. Each transfer is
        # clamped to its OWNING window, which contributes depth 1
        # everywhere inside it, so "inside a >=2-deep region" is
        # exactly "overlapping some OTHER window" — one sweep per
        # process instead of a per-window quadratic rescan.
        if multi_regions:
            transfer_overlap_ns += _overlap_ns(
                by_proc_transfer.get(proc, []), multi_regions)
    gap_ns = max(exec_ns - device_ns, 0)
    for name, p in phases.items():
        p["mean_ms"] = p["total_ms"] / p["count"] if p["count"] else 0.0
        p["share"] = (p["total_ms"] * 1e6 / wall_ns) if wall_ns else 0.0
        p["total_ms"] = round(p["total_ms"], 3)
        p["mean_ms"] = round(p["mean_ms"], 4)
        p["share"] = round(p["share"], 4)
    return {
        "traces": len(docs),
        "wall_ms": round(wall_ns / 1e6, 3),
        "coverage": round(min(covered_ns / wall_ns, 1.0), 4)
        if wall_ns else 0.0,
        "phases": dict(sorted(phases.items())),
        "dispatch_gap": {
            "windows": len(windows),
            "exec_ms": round(exec_ns / 1e6, 3),
            "device_ms": round(device_ns / 1e6, 3),
            "host_instrumented_ms": round(host_work_ns / 1e6, 3),
            "host_gap_ms": round(gap_ns / 1e6, 3),
            "gap_fraction": round(gap_ns / exec_ns, 4) if exec_ns else 0.0,
        },
        "pipeline": {
            "windows_in_flight_max": inflight_max,
            "multi_window_ms": round(multi_window_ns / 1e6, 3),
            "transfer_overlap_ms": round(transfer_overlap_ns / 1e6, 3),
        },
        "ring": {
            "windows": ring["windows"],
            "slot_ms": round(ring["slot_ms"], 3),
            "kernel_ms": round(ring["kernel_ms"], 3),
            "harvest_ms": round(ring["harvest_ms"], 3),
        },
        "shards": {
            sid: {"count": lane["count"],
                  "device_ms": round(lane["device_ms"], 3)}
            for sid, lane in sorted(shard_lanes.items())
        },
        "lanes": {
            cls: {"count": lane["count"],
                  "total_ms": round(lane["total_ms"], 3),
                  "rows": lane["rows"]}
            for cls, lane in sorted(lane_evals.items())
        },
    }


def render_gap(report: dict) -> str:
    """Human-readable gap report."""
    lines = [
        f"dispatch-gap report over {report['traces']} trace(s), "
        f"wall {report['wall_ms']:.1f} ms "
        f"(root-phase coverage {report['coverage'] * 100:.1f}%)",
        f"{'phase':<18}{'count':>7}{'total ms':>12}{'mean ms':>11}"
        f"{'share':>8}",
    ]
    for name, p in report["phases"].items():
        lines.append(
            f"{name:<18}{p['count']:>7}{p['total_ms']:>12.2f}"
            f"{p['mean_ms']:>11.3f}{p['share'] * 100:>7.1f}%")
    g = report["dispatch_gap"]
    lines.append(
        f"dispatch windows: {g['windows']} — exec {g['exec_ms']:.1f} ms, "
        f"device {g['device_ms']:.1f} ms, "
        f"host gap {g['host_gap_ms']:.1f} ms "
        f"({g['gap_fraction'] * 100:.1f}% of window time)")
    p = report.get("pipeline") or {}
    if p.get("windows_in_flight_max", 0) >= 2:
        lines.append(
            f"pipeline: up to {p['windows_in_flight_max']} windows in "
            f"flight ({p['multi_window_ms']:.1f} ms with >=2 open, "
            f"{p['transfer_overlap_ms']:.1f} ms of transfer overlapped "
            f"other windows)")
    r = report.get("ring") or {}
    if r.get("windows", 0) >= 1:
        lines.append(
            f"ring: {r['windows']} window(s) — slot {r['slot_ms']:.1f} "
            f"ms, kernel {r['kernel_ms']:.1f} ms, harvest "
            f"{r['harvest_ms']:.1f} ms")
    lanes = report.get("shards") or {}
    if lanes:
        parts = ", ".join(
            f"shard {sid}: {lane['device_ms']:.1f} ms"
            f"/{lane['count']}" for sid, lane in lanes.items())
        lines.append(f"shard lanes: {parts}")
    sub_lanes = report.get("lanes") or {}
    if sub_lanes:
        parts = ", ".join(
            f"{cls}: {lane['total_ms']:.1f} ms/{lane['count']} eval(s)"
            f" over {lane['rows']} row(s)"
            for cls, lane in sub_lanes.items())
        lines.append(f"subscribe lanes: {parts}")
    if g["windows"] and g["gap_fraction"] > 0.5:
        lines.append(
            "  NOTE: >50% of dispatch-window time is host gap — the "
            "path is dispatch-bound, not kernel-bound")
    return "\n".join(lines)
