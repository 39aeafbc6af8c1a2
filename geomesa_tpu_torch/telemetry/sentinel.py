"""Perf-regression sentinel: recorded baselines, typed verdicts.

A copy of the reference package's `telemetry/sentinel.py`.
`baseline_from_profile` flattens a continuous-profiler snapshot (with
its samples) and end-to-end latency samples into a baseline;
`save_baseline` writes it (on the coordinator process only) and
`compare` holds a fresh profile against it, with a typed verdict per
metric and `exit_code` nonzero on regression.

Noise tolerance is the design center: a metric regresses only when
BOTH hold:

- the median ratio (current/baseline) exceeds `threshold` (default
  1.5x), and
- the central mass of the two sample distributions has stopped
  overlapping (`overlap` of the [p10, p90] intervals below
  `min_overlap`): a shifted median within overlapping distributions
  is noise, not a regression.

Verdicts per metric: `ok`, `regressed`, `improved` (the same two-part
test in the other direction), `insufficient-data` (either side has
fewer than `min_n` samples). The run verdict is `regressed` iff any
metric regressed. Baselines are host-specific: the file records the
host, and a baseline compared with a replay of itself is `ok` on any
machine.
"""

from __future__ import annotations

import json
import os
import platform
import time
from typing import Dict, List, Optional

__all__ = ["baseline_from_profile", "save_baseline", "load_baseline",
           "compare", "render_verdicts", "exit_code",
           "DEFAULT_BASELINE"]

DEFAULT_BASELINE = "BASELINE_SERVE.json"
VERDICTS = ("ok", "regressed", "improved", "insufficient-data")

# default thresholds: a 3x synthetic slowdown must always trip, run-
# to-run CI jitter (typically < 1.3x on medians) must never
DEFAULT_THRESHOLD = 1.5
DEFAULT_MIN_OVERLAP = 0.20
DEFAULT_MIN_N = 8


def baseline_from_profile(profile: dict,
                          latency_samples_ms: Optional[List[float]] = None,
                          extra: Optional[dict] = None,
                          extra_samples: Optional[
                              Dict[str, List[float]]] = None) -> dict:
    """Flatten a ContinuousProfiler snapshot (include_samples=True)
    into the baseline's metric table. `latency_samples_ms` adds the
    load report's end-to-end `serve.latency` samples — the headline
    the sentinel guards even when tracing is off. `extra_samples` adds
    named latency-vector families wholesale (e.g. the approx bench's
    `approx.count.sketch` / `approx.count.exact` reservoirs — a
    regressed sketch path then fails CI like any other family)."""
    metrics: Dict[str, dict] = {}

    def put(name: str, snap: dict) -> None:
        samples = snap.get("samples_ms")
        if not samples:
            return
        metrics[name] = {
            "n": snap["n"],
            "median_ms": snap["p50_ms"],
            "samples_ms": samples,
        }

    for phase, snap in (profile.get("phases") or {}).items():
        put(f"phase.{phase}", snap)
    for fam, rec in (profile.get("kernels") or {}).items():
        put(f"kernel.{fam}.device", rec["device"])
    if latency_samples_ms:
        s = sorted(latency_samples_ms)
        metrics["serve.latency"] = {
            "n": len(s),
            "median_ms": s[len(s) // 2],
            "samples_ms": [round(v, 4) for v in s],
        }
    for name, samples in (extra_samples or {}).items():
        if not samples:
            continue
        s = sorted(samples)
        metrics[name] = {
            "n": len(s),
            "median_ms": s[len(s) // 2],
            "samples_ms": [round(v, 4) for v in s],
        }
    doc = {
        "version": 1,
        "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "host": {"platform": platform.platform(),
                 "machine": platform.machine(),
                 "python": platform.python_version()},
        "metrics": metrics,
    }
    if extra:
        doc["context"] = extra
    return doc


def save_baseline(path: str, doc: dict) -> str:
    from geomesa_tpu_torch.parallel.distributed import is_coordinator

    if not is_coordinator():
        # a process group: one baseline file, one writer — verdicts
        # compare against shared history, which process 0 curates
        return path
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_baseline(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != 1 or "metrics" not in doc:
        raise ValueError(
            f"{path} is not a v1 sentinel baseline (record one with "
            f"`save_baseline`)")
    return doc


def _central_interval(samples: List[float]) -> tuple:
    s = sorted(samples)
    n = len(s)
    lo = s[min(int(0.10 * n), n - 1)]
    hi = s[min(int(0.90 * n), n - 1)]
    return lo, hi


def _overlap(a: List[float], b: List[float]) -> float:
    """Overlap of the two samples' central [p10, p90] intervals as a
    fraction of their combined span, in [0, 1]. Degenerate (zero-width)
    intervals compare by containment: a constant distribution inside
    the other's central interval overlaps fully."""
    alo, ahi = _central_interval(a)
    blo, bhi = _central_interval(b)
    lo, hi = max(alo, blo), min(ahi, bhi)
    span = max(ahi, bhi) - min(alo, blo)
    if span <= 0.0:
        return 1.0  # both degenerate at the same point
    if hi < lo:
        return 0.0
    inter = hi - lo
    if inter == 0.0:
        # touching or a zero-width interval inside the other
        return 1.0 if (alo == ahi or blo == bhi) else 0.0
    return inter / span


def _median(samples: List[float]) -> float:
    s = sorted(samples)
    return s[len(s) // 2]


def compare(baseline: dict, current: dict,
            threshold: float = DEFAULT_THRESHOLD,
            min_overlap: float = DEFAULT_MIN_OVERLAP,
            min_n: int = DEFAULT_MIN_N) -> dict:
    """Verdict per metric family over the union of baseline and current
    metric tables (both in the `baseline_from_profile` shape, or a raw
    {name: {n, samples_ms}} table for `current`)."""
    base_m = baseline.get("metrics", baseline)
    cur_m = current.get("metrics", current)
    verdicts: Dict[str, dict] = {}
    for name in sorted(set(base_m) | set(cur_m)):
        b, c = base_m.get(name), cur_m.get(name)
        if (b is None or c is None
                or b.get("n", 0) < min_n or c.get("n", 0) < min_n
                or not b.get("samples_ms") or not c.get("samples_ms")):
            verdicts[name] = {
                "verdict": "insufficient-data",
                "baseline_n": (b or {}).get("n", 0),
                "current_n": (c or {}).get("n", 0),
            }
            continue
        bm = _median(b["samples_ms"])
        cm = _median(c["samples_ms"])
        ov = _overlap(b["samples_ms"], c["samples_ms"])
        if bm <= 0.0:
            # a zero-cost baseline phase cannot express a ratio; only a
            # clear distribution separation upward can regress it
            ratio = float("inf") if cm > 0.0 else 1.0
        else:
            ratio = cm / bm
        if ratio > threshold and ov < min_overlap:
            verdict = "regressed"
        elif ratio < 1.0 / threshold and ov < min_overlap:
            verdict = "improved"
        else:
            verdict = "ok"
        verdicts[name] = {
            "verdict": verdict,
            "median_ratio": round(ratio, 3) if ratio != float("inf")
            else "inf",
            "overlap": round(ov, 3),
            "baseline_median_ms": round(bm, 4),
            "current_median_ms": round(cm, 4),
        }
    counts = {v: 0 for v in VERDICTS}
    for d in verdicts.values():
        counts[d["verdict"]] += 1
    return {
        "thresholds": {"median_ratio": threshold,
                       "min_overlap": min_overlap, "min_n": min_n},
        "metrics": verdicts,
        "counts": counts,
        "regressed": counts["regressed"] > 0,
    }


def exit_code(report: dict, strict: bool = False) -> int:
    """1 on regression. `strict` additionally fails on any
    `insufficient-data` verdict — the guard against instrumentation
    loss (a renamed phase/kernel family stops being COMPARED, which
    must not read as green when the caller expects full coverage; the
    lint-gate smoke asserts zero insufficient-data on its identical
    replay for the same reason)."""
    if report.get("regressed"):
        return 1
    if strict and report.get("counts", {}).get("insufficient-data"):
        return 1
    return 0


def render_verdicts(report: dict) -> str:
    lines = [
        f"sentinel: {report['counts']['ok']} ok, "
        f"{report['counts']['regressed']} regressed, "
        f"{report['counts']['improved']} improved, "
        f"{report['counts']['insufficient-data']} insufficient-data "
        f"(threshold {report['thresholds']['median_ratio']:g}x median, "
        f"overlap < {report['thresholds']['min_overlap']:g})"]
    order = {"regressed": 0, "improved": 1, "ok": 2,
             "insufficient-data": 3}
    for name, d in sorted(report["metrics"].items(),
                          key=lambda kv: (order[kv[1]["verdict"]],
                                          kv[0])):
        if d["verdict"] == "insufficient-data":
            lines.append(
                f"  {d['verdict']:<18} {name:<28} "
                f"n={d['baseline_n']}/{d['current_n']}")
        else:
            lines.append(
                f"  {d['verdict']:<18} {name:<28} median "
                f"{d['baseline_median_ms']:.3f} -> "
                f"{d['current_median_ms']:.3f} ms "
                f"({d['median_ratio']}x, overlap {d['overlap']})")
    return "\n".join(lines)
