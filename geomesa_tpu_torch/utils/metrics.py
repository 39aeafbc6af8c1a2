"""Tiny metrics registry: counters, gauges, timers, histograms.

A copy of the reference package's `utils/metrics.py`, kept in the port
so that it imports nothing of the reference.

Parity: geomesa-metrics (Dropwizard/Micrometer registries + reporters)
[upstream, unverified], reduced to counters/gauges/timers/histograms with
JSON and Prometheus-text export — used by converters/ingest, the query
path, and the serve subsystem (queue-wait + end-to-end latency).
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


class Timer:
    """Thread-safe like Histogram: one registry Timer is shared by every
    thread timing the same name, and `count += 1` is a read-modify-write
    that drops updates without the lock (GT12)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def update(self, seconds: float):
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.max_s = max(self.max_s, seconds)

    @property
    def mean_s(self) -> float:
        with self._lock:
            return self.total_s / self.count if self.count else 0.0


# latency bounds in SECONDS: a 1-2-5 sub-millisecond decade (10µs ..
# 200µs) followed by the log-spaced 0.5ms .. ~65s doubling series — the
# sub-ms buckets exist so compile-stall and device-dispatch timings
# resolve instead of all landing in the bottom bucket, while a cold
# multi-second parquet->device scan still fits the same family. Fixed
# (not per-instance) so every histogram is mergeable across
# threads/shards by construction.
_SUB_MS_BUCKETS: Tuple[float, ...] = (
    0.00001, 0.00002, 0.00005, 0.0001, 0.0002)
DEFAULT_BUCKETS: Tuple[float, ...] = _SUB_MS_BUCKETS + tuple(
    0.0005 * (2.0 ** i) for i in range(18)
)


class Histogram:
    """Fixed-bucket latency histogram: thread-safe, mergeable, with
    bucket-interpolated quantiles. Values are observed in seconds (the
    Prometheus convention); the +Inf bucket is implicit (last slot)."""

    def __init__(self, buckets: Optional[Sequence[float]] = None):
        self.bounds: Tuple[float, ...] = tuple(buckets or DEFAULT_BUCKETS)
        if list(self.bounds) != sorted(self.bounds) or len(self.bounds) < 1:
            raise ValueError("histogram buckets must be sorted and non-empty")
        self._lock = threading.Lock()
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0

    def update(self, seconds: float) -> None:
        i = bisect.bisect_left(self.bounds, seconds)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += seconds

    def merge(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different buckets")
        with other._lock:
            counts, count, total = list(other.counts), other.count, other.sum
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.count += count
            self.sum += total

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (the Prometheus histogram_quantile
        estimate): linear within the winning bucket; values beyond the
        last finite bound clamp to it."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= rank and c > 0:
                if i >= len(self.bounds):  # +Inf bucket: clamp
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.bounds[-1]

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
        return {
            "count": count,
            "sum_s": total,
            "mean_s": total / count if count else 0.0,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
        }


class _TimerContext:
    def __init__(self, timer: Timer):
        self.timer = timer

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.update(time.perf_counter() - self._t0)
        return False


def _esc_label(value: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: Dict[str, object]) -> str:
    return ",".join(
        f'{k}="{_esc_label(str(v))}"' for k, v in sorted(labels.items()))


class MetricsRegistry:
    """Series are keyed by name alone (the common case, unchanged) or by
    name + sorted labels — `counter("serve.dispatch", tenant="acme")`
    creates series key `serve.dispatch{tenant="acme"}`. Labeled series
    export as proper Prometheus labels (one TYPE declaration per family,
    one sample line per label set) instead of name-mangled metric names;
    labeled histograms are ordinary `Histogram` objects sharing the
    fixed default buckets, so `merge()` keeps working across them."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.timers: Dict[str, Timer] = {}
        self.histograms: Dict[str, Histogram] = {}
        # series key -> (base family name, rendered label string);
        # unlabeled series never appear here (key IS the family)
        self._series: Dict[str, Tuple[str, str]] = {}
        self._family_counts: Dict[str, int] = {}

    # label values can be client-controlled (the serve layer labels
    # per-tenant series straight off the request's tenant field), so a
    # family's distinct label sets are BOUNDED: past the cap, new label
    # sets fold into the unlabeled aggregate series instead of growing
    # the registry (and every /metrics scrape) without limit — the same
    # adversarial-stream stance as the planner's filter cache and the
    # quarantine table
    MAX_LABELED_SERIES_PER_FAMILY = 512

    def _key(self, name: str, labels: Dict[str, object]) -> str:
        # callers hold self._lock
        if not labels:
            return name
        ls = _label_str(labels)
        key = f"{name}{{{ls}}}"
        if key not in self._series:
            count = self._family_counts.get(name, 0)
            if count >= self.MAX_LABELED_SERIES_PER_FAMILY:
                return name  # overflow: fold into the aggregate
            self._family_counts[name] = count + 1
            self._series[key] = (name, ls)
        return key

    def counter(self, name: str, inc: float = 1.0, **labels) -> None:
        with self._lock:
            key = self._key(name, labels)
            self.counters[key] = self.counters.get(key, 0.0) + inc

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self.gauges[self._key(name, labels)] = float(value)

    def timer(self, name: str, **labels) -> _TimerContext:
        with self._lock:
            t = self.timers.setdefault(self._key(name, labels), Timer())
        return _TimerContext(t)

    def histogram(self, name: str, **labels) -> Histogram:
        with self._lock:
            return self.histograms.setdefault(
                self._key(name, labels), Histogram())

    def to_json(self) -> str:
        with self._lock:
            return json.dumps(
                {
                    "counters": self.counters,
                    "gauges": self.gauges,
                    "timers": {
                        k: {"count": t.count, "total_s": t.total_s,
                            "mean_s": t.mean_s, "max_s": t.max_s}
                        for k, t in self.timers.items()
                    },
                    "histograms": {
                        k: h.snapshot() for k, h in self.histograms.items()
                    },
                }
            )

    def to_prometheus(self) -> str:
        """Prometheus text exposition format. Histograms export the
        standard cumulative `_bucket{le=...}` series plus `_p50/_p95/_p99`
        gauge families, so dashboards get quantiles without running
        histogram_quantile() themselves. Labeled series render as
        `family{label="value"} v` with ONE `# TYPE` declaration per
        family (the text format's contract), not one per label set."""
        out: List[str] = []
        with self._lock:
            counters = list(self.counters.items())
            gauges = list(self.gauges.items())
            timers = list(self.timers.items())
            hists = list(self.histograms.items())
            families = dict(self._series)

        def family_of(key: str) -> Tuple[str, str]:
            return families.get(key, (key, ""))

        def grouped(items):
            # the text format requires every sample of a family to be
            # CONTIGUOUS (strict parsers/promtool reject interleaving),
            # and insertion order interleaves the moment two families'
            # label sets appear alternately — group per family first,
            # preserving first-seen family order and per-family
            # insertion order
            by_family: Dict[str, list] = {}
            for k, v in items:
                base, ls = family_of(k)
                by_family.setdefault(base, []).append((ls, v))
            return by_family.items()

        for base, series in grouped(counters):
            name = _prom(base)
            out.append(f"# TYPE {name} counter")
            for ls, v in series:
                out.append(f"{name}{{{ls}}} {v}" if ls else f"{name} {v}")
        for base, series in grouped(gauges):
            name = _prom(base)
            out.append(f"# TYPE {name} gauge")
            for ls, v in series:
                out.append(f"{name}{{{ls}}} {v}" if ls else f"{name} {v}")
        for base, series in grouped(timers):
            name = _prom(base)
            out.append(f"# TYPE {name}_seconds summary")
            for ls, t in series:
                suffix = f"{{{ls}}}" if ls else ""
                out.append(f"{name}_seconds_count{suffix} {t.count}")
                out.append(f"{name}_seconds_sum{suffix} {t.total_s}")
        for base, series in grouped(hists):
            name = _prom(base) + "_seconds"
            out.append(f"# TYPE {name} histogram")
            quantile_lines: Dict[str, List[str]] = {}
            for ls, h in series:
                with h._lock:
                    counts, count, total = list(h.counts), h.count, h.sum
                cum = 0
                prefix = f"{ls}," if ls else ""
                suffix = f"{{{ls}}}" if ls else ""
                for bound, c in zip(h.bounds, counts):
                    cum += c
                    out.append(
                        f'{name}_bucket{{{prefix}le="{_le(bound)}"}} {cum}')
                out.append(f'{name}_bucket{{{prefix}le="+Inf"}} {count}')
                out.append(f"{name}_sum{suffix} {total}")
                out.append(f"{name}_count{suffix} {count}")
                for q, label in ((0.50, "p50"), (0.95, "p95"),
                                 (0.99, "p99")):
                    quantile_lines.setdefault(label, []).append(
                        f"{name}_{label}{suffix} {h.quantile(q)}")
            # the derived _p50/_p95/_p99 gauge families follow their
            # histogram family, each contiguous across its label sets
            for label, lines in quantile_lines.items():
                out.append(f"# TYPE {name}_{label} gauge")
                out.extend(lines)
        return "\n".join(out) + "\n"


def _prom(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else f"{bound:.10g}"


metrics = MetricsRegistry()


def note_device_op(n: int = 1) -> None:
    """Meter `n` serve-path device interactions (a staged transfer, a
    kernel/program dispatch, a band-correction read, the combined sync
    read) into the `serve.device.ops` counter — the per-window dispatch
    accounting `bench-serve`'s `dispatches_per_window` is derived from
    (docs/SERVING.md "Persistent serve loop"). Centralized so every
    dispatch route (serial, pipelined, mesh, ring) increments through
    one seam and the ring-vs-pipeline comparison can never drift on
    counting convention."""
    metrics.counter("serve.device.ops", n)
