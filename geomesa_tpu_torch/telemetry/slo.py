"""SLO engine: declared objectives, sliding windows, error-budget burn.

A copy of the reference package's `telemetry/slo.py`.

- **Declared objectives** load from a TOML/JSON spec (`SloSpec.load`):
  per-query-kind latency thresholds, availability (1 - typed-error
  rate), exactness (1 - degraded-response rate), and a sustained
  throughput floor. `tomllib` reads `.toml` specs; `parse_toml_subset`
  (sections, `key = value` scalars, comments) stands in where it is
  missing.
- **Sliding windows**: the engine keeps a bounded deque of per-request
  observations (`observe()`, called by the QueryService for every
  resolved request: one tuple append under one lock) and evaluates each
  objective over a fast and a slow window (default 5m/1h; tests inject
  a fake `clock`).
- **Burn rate**: `bad_fraction / (1 - goal)`; 1.0 spends the budget
  exactly as fast as the goal allows. The multi-window rule (fast AND
  slow over `burn_threshold`) gates alerting and the degradation
  ladder, so one slow request never sheds traffic but a sustained
  breach does.
- **Error budget**: `slo.budget_remaining{objective}`, the fraction of
  the budget window's allowance still unspent.
- **Degradation input**: `degrade_boost()` maps breaching
  degrade-marked objectives onto the service's ladder (1 = hint
  downgrades, 2 = shed batch class; `QueryService.degrade_level` takes
  the max of this and queue occupancy), and `exactness_spent()` routes
  tolerant requests exact once the exactness budget is gone.

Exported state: `slo.budget_remaining{objective}` and
`slo.burn_rate{objective,window}` gauges (`export_gauges`, called by the
service's `export_gauges`) plus the `/debug/slo` JSON report.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

__all__ = ["Objective", "SloSpec", "SloEngine", "parse_toml_subset"]

KINDS = ("latency", "availability", "exactness", "throughput")

# statuses that spend availability budget. Rejections (load shedding)
# are deliberately NOT here: shedding is the system protecting its
# objectives, and counting it against availability would make the
# ladder burn the very budget it exists to preserve.
BAD_STATUSES = ("error", "timeout")


@dataclass(frozen=True)
class Objective:
    """One declared objective. `goal` is the target GOOD fraction
    (0.99 = "99% of requests meet the condition"); the error budget is
    `1 - goal`."""

    name: str
    kind: str                      # latency|availability|exactness|throughput
    goal: float = 0.99
    threshold_ms: float = 0.0      # latency: the per-request bound
    query_kind: str = ""           # filter: knn|count|execute ("" = all)
    min_per_s: float = 0.0         # throughput: served-requests/s floor
    pts_per_query: float = 0.0     # throughput: optional pts/s conversion
    degrade: bool = False          # feed the degradation ladder
    min_count: int = 8             # below this, verdict = insufficient-data

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"objective {self.name!r}: unknown kind {self.kind!r} "
                f"(one of {KINDS})")
        if not 0.0 < self.goal < 1.0:
            raise ValueError(
                f"objective {self.name!r}: goal must be in (0, 1), "
                f"got {self.goal}")
        if self.kind == "latency" and self.threshold_ms <= 0:
            raise ValueError(
                f"objective {self.name!r}: latency objectives need "
                f"threshold_ms > 0")
        if self.kind == "throughput" and self.min_per_s <= 0:
            raise ValueError(
                f"objective {self.name!r}: throughput objectives need "
                f"min_per_s > 0")

    @property
    def budget(self) -> float:
        return 1.0 - self.goal


@dataclass
class SloSpec:
    """The declared objective set plus window tuning. Windows are
    seconds; tests scale them down and drive a fake clock."""

    objectives: Dict[str, Objective] = field(default_factory=dict)
    fast_window_s: float = 300.0     # 5m: catches a fast burn
    slow_window_s: float = 3600.0    # 1h: confirms it is sustained
    burn_threshold: float = 2.0      # multi-window alert/degrade gate
    budget_window_s: float = 0.0     # 0 = slow window

    def __post_init__(self):
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise ValueError("SLO windows must be > 0 seconds")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast window must not exceed the slow window")
        if not self.budget_window_s:
            self.budget_window_s = self.slow_window_s

    @classmethod
    def from_dict(cls, doc: dict) -> "SloSpec":
        cfg = dict(doc.get("slo", ()))
        objectives = {}
        objs = doc.get("objective", doc.get("objectives", {}))
        if not isinstance(objs, dict) or not objs:
            raise ValueError(
                "SLO spec has no [objective.<name>] sections")
        for name, body in objs.items():
            if not isinstance(body, dict):
                raise ValueError(
                    f"objective {name!r} body must be a table/object")
            known = {f.name for f in
                     Objective.__dataclass_fields__.values()}  # type: ignore
            unknown = set(body) - (known - {"name"})
            if unknown:
                raise ValueError(
                    f"objective {name!r}: unknown key(s) "
                    f"{sorted(unknown)}")
            objectives[name] = Objective(name=name, **body)
        known_cfg = {"fast_window_s", "slow_window_s", "burn_threshold",
                     "budget_window_s"}
        unknown = set(cfg) - known_cfg
        if unknown:
            raise ValueError(f"[slo] unknown key(s) {sorted(unknown)}")
        return cls(objectives=objectives, **cfg)

    @classmethod
    def load(cls, path: str) -> "SloSpec":
        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            return cls.from_dict(json.loads(text))
        try:
            import tomllib  # Python >= 3.11

            doc = tomllib.loads(text)
        except ModuleNotFoundError:
            doc = parse_toml_subset(text)
        return cls.from_dict(doc)


def parse_toml_subset(text: str) -> dict:
    """A deliberately small TOML reader for SLO specs on hosts without
    tomllib: `[section]` / `[section.sub]` headers and scalar
    `key = value` lines (quoted strings, ints, floats, true/false),
    full-line and trailing comments. Arrays/dates/multiline strings are
    out of scope — a spec needing them should ship JSON instead."""
    root: dict = {}
    table = root
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise ValueError(f"spec line {lineno}: malformed header")
            table = root
            for part in line[1:-1].strip().split("."):
                part = part.strip()
                if not part:
                    raise ValueError(
                        f"spec line {lineno}: empty header segment")
                table = table.setdefault(part, {})
                if not isinstance(table, dict):
                    raise ValueError(
                        f"spec line {lineno}: header collides with a "
                        f"value")
            continue
        if "=" not in line:
            raise ValueError(f"spec line {lineno}: expected key = value")
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        if val.startswith(('"', "'")):
            quote = val[0]
            end = val.find(quote, 1)
            if end < 0:
                raise ValueError(
                    f"spec line {lineno}: unterminated string")
            table[key] = val[1:end]
            continue
        # strip a trailing comment from non-string scalars
        val = val.split("#", 1)[0].strip()
        if val in ("true", "false"):
            table[key] = val == "true"
            continue
        try:
            table[key] = int(val)
        except ValueError:
            try:
                table[key] = float(val)
            except ValueError:
                raise ValueError(
                    f"spec line {lineno}: cannot parse value {val!r}"
                ) from None
    return root


# observation tuple layout:
# (ts_s, kind, status, latency_s, degraded, weight)


class SloEngine:
    """Sliding-window objective evaluation over per-request
    observations.

    `observe()` is the hot-path entry (QueryService._finish_window, one
    call per resolved request): a tuple build + deque append under one
    lock. Everything else — evaluation, burn rates, gauge export, the
    /debug/slo report — runs on scrape/introspection threads and walks
    a snapshot. The `clock` is injectable so tests drive windows with a
    fake clock instead of sleeping."""

    def __init__(self, spec: SloSpec,
                 clock: Callable[[], float] = time.monotonic,
                 max_observations: int = 65536):
        if not spec.objectives:
            raise ValueError("SloEngine needs at least one objective")
        self.spec = spec
        self.clock = clock
        self._lock = threading.Lock()
        self._obs: "deque[tuple]" = deque(maxlen=max_observations)
        self._started_at = clock()
        self._dropped = 0
        # degrade_boost cache: the ladder consults the engine on EVERY
        # admission, and a full window walk there would put an O(obs)
        # scan on the submit path. A short clock-TTL keeps the boost
        # fresh at SLO timescales (burn windows are minutes) while the
        # admission path pays one clock read + compare.
        self.boost_ttl_s = 0.25
        self._boost_cache: Tuple[float, int] = (-1e18, 0)
        self._exact_cache: Tuple[float, bool] = (-1e18, False)

    # -- ingest ------------------------------------------------------------

    def observe(self, kind: str, status: str, latency_s: float,
                degraded: bool = False, weight: float = 1.0) -> None:
        """Record one resolved request. status: ok|error|timeout|
        rejected|cancelled (the ServeEvent vocabulary)."""
        t = (self.clock(), kind, status, latency_s, degraded, weight)
        with self._lock:
            if len(self._obs) == self._obs.maxlen:
                self._dropped += 1
            self._obs.append(t)

    # -- evaluation --------------------------------------------------------

    def _context(self) -> Tuple[float, List[tuple]]:
        """ONE deque snapshot trimmed to the outermost window, shared
        by every evaluation a report/export/boost pass makes. The
        copy-under-lock is the only contention with the dispatch
        thread's observe(), so it happens once per pass — not once per
        (objective x window x metric) as the naive per-window copy
        would (a /debug/slo scrape runs ~6 evaluations per
        objective)."""
        with self._lock:
            snap = list(self._obs)
        now = self.clock()
        cutoff = now - max(self.spec.slow_window_s,
                           self.spec.budget_window_s)
        # observations are appended in clock order; scan from the right
        out: List[tuple] = []
        for t in reversed(snap):
            if t[0] < cutoff:
                break
            out.append(t)
        return now, out

    def _window(self, ctx: Tuple[float, List[tuple]],
                window_s: float) -> List[tuple]:
        now, obs = ctx
        cutoff = now - window_s
        return [t for t in obs if t[0] >= cutoff]

    def _bad_fraction(self, obj: Objective, now: float,
                      obs: List[tuple],
                      window_s: float) -> Tuple[float, int]:
        """(bad fraction in [0, 1], sample count) for one objective
        over one window's observations."""
        if obj.query_kind:
            obs = [t for t in obs if t[1] == obj.query_kind]
        if obj.kind == "availability":
            n = len(obs)
            if n == 0:
                return 0.0, 0
            bad = sum(1 for t in obs if t[2] in BAD_STATUSES)
            return bad / n, n
        if obj.kind == "throughput":
            n = len(obs)
            # rate over the EFFECTIVE window: a just-started engine has
            # seen less than window_s of traffic, and dividing by the
            # full window would report a phantom shortfall
            eff = min(window_s, max(now - self._started_at, 1e-9))
            served = sum(t[5] for t in obs
                         if t[2] not in ("rejected", "cancelled"))
            rate = served / eff
            return max(0.0, 1.0 - rate / obj.min_per_s), n
        # latency / exactness evaluate over SERVED requests: an errored
        # request has no meaningful latency or exactness, and it is the
        # availability objective's job to charge it
        served = [t for t in obs if t[2] == "ok"]
        n = len(served)
        if n == 0:
            return 0.0, 0
        if obj.kind == "latency":
            bound = obj.threshold_ms / 1000.0
            bad = sum(1 for t in served if t[3] > bound)
        else:  # exactness
            bad = sum(1 for t in served if t[4])
        return bad / n, n

    def burn_rates(self, obj: Objective, _ctx=None) -> dict:
        """{'fast': ..., 'slow': ..., 'n_fast': ..., 'n_slow': ...} —
        burn = bad_fraction / budget, 1.0 = spending exactly at goal."""
        ctx = _ctx if _ctx is not None else self._context()
        out = {}
        for label, window_s in (("fast", self.spec.fast_window_s),
                                ("slow", self.spec.slow_window_s)):
            bad, n = self._bad_fraction(
                obj, ctx[0], self._window(ctx, window_s), window_s)
            out[label] = bad / obj.budget
            out[f"n_{label}"] = n
        return out

    def budget_remaining(self, obj: Objective, _ctx=None) -> float:
        ctx = _ctx if _ctx is not None else self._context()
        window_s = self.spec.budget_window_s
        bad, _n = self._bad_fraction(
            obj, ctx[0], self._window(ctx, window_s), window_s)
        return max(0.0, 1.0 - bad / obj.budget)

    def breaching(self, _ctx=None) -> List[str]:
        """Objectives whose fast AND slow burn exceed the threshold
        (the multi-window rule: sustained, not a blip) with enough
        samples to mean anything."""
        ctx = _ctx if _ctx is not None else self._context()
        out = []
        for name, obj in self.spec.objectives.items():
            rates = self.burn_rates(obj, _ctx=ctx)
            if (rates["fast"] > self.spec.burn_threshold
                    and rates["slow"] > self.spec.burn_threshold
                    and rates["n_fast"] >= obj.min_count):
                out.append(name)
        return out

    def degrade_boost(self) -> int:
        """The ladder input (QueryService.degrade_level): 2 when a
        degrade-marked objective is breaching with its budget fully
        spent, 1 when merely breaching, else 0. Cached for
        `boost_ttl_s` of engine-clock time — admission calls this per
        request and must not pay a window walk each time."""
        now = self.clock()
        cached_at, value = self._boost_cache
        if now - cached_at < self.boost_ttl_s:
            return value
        ctx = self._context()
        boost = 0
        for name in self.breaching(_ctx=ctx):
            obj = self.spec.objectives[name]
            if not obj.degrade:
                continue
            if self.budget_remaining(obj, _ctx=ctx) <= 0.0:
                boost = 2
                break
            boost = 1
        self._boost_cache = (now, boost)
        return boost

    def exactness_spent(self) -> bool:
        """True when any EXACTNESS objective's error budget is fully
        spent — the approximate-answer tier's governor (serve/service.py
        `_approx_ok`): sketch-served answers observe as
        degraded, so they spend this budget; once it is gone the serve
        layer strips tolerance hints and traffic moves to the EXACT
        path until the budget window recovers. Same clock-TTL cache
        discipline as degrade_boost (admission consults this per
        tolerant request)."""
        now = self.clock()
        cached_at, value = self._exact_cache
        if now - cached_at < self.boost_ttl_s:
            return value
        ctx = self._context()
        spent = False
        for obj in self.spec.objectives.values():
            if obj.kind != "exactness":
                continue
            rates = self.burn_rates(obj, _ctx=ctx)
            if (rates["n_slow"] >= obj.min_count
                    and self.budget_remaining(obj, _ctx=ctx) <= 0.0):
                spent = True
                break
        self._exact_cache = (now, spent)
        return spent

    # -- export ------------------------------------------------------------

    def export_gauges(self) -> None:
        """Refresh `slo.budget_remaining{objective}` and
        `slo.burn_rate{objective,window}` in the shared registry
        (called from the service's pre-scrape hook)."""
        from geomesa_tpu_torch.utils.metrics import metrics

        ctx = self._context()
        for name, obj in self.spec.objectives.items():
            rates = self.burn_rates(obj, _ctx=ctx)
            metrics.gauge("slo.budget_remaining",
                          self.budget_remaining(obj, _ctx=ctx),
                          objective=name)
            metrics.gauge("slo.burn_rate", rates["fast"],
                          objective=name, window="fast")
            metrics.gauge("slo.burn_rate", rates["slow"],
                          objective=name, window="slow")

    def report(self) -> dict:
        """The /debug/slo document. One `_context()` walk serves every
        number in it — the breaching list and the ladder boost derive
        from the per-objective rates computed in the loop rather than
        re-walking the windows through breaching()/degrade_boost()."""
        ctx = self._context()
        objectives = {}
        breaching: List[str] = []
        boost = 0
        for name, obj in self.spec.objectives.items():
            rates = self.burn_rates(obj, _ctx=ctx)
            remaining = self.budget_remaining(obj, _ctx=ctx)
            is_breaching = (
                rates["fast"] > self.spec.burn_threshold
                and rates["slow"] > self.spec.burn_threshold
                and rates["n_fast"] >= obj.min_count)
            if is_breaching:
                breaching.append(name)
                if obj.degrade and boost < 2:
                    boost = 2 if remaining <= 0.0 else 1
            if rates["n_slow"] < obj.min_count:
                state = "insufficient-data"
            elif remaining <= 0.0:
                state = "violated"
            elif (rates["fast"] > self.spec.burn_threshold
                    and rates["slow"] > self.spec.burn_threshold):
                state = "burning"
            else:
                state = "ok"
            doc = {
                "kind": obj.kind,
                "goal": obj.goal,
                "state": state,
                "burn_rate": {"fast": round(rates["fast"], 4),
                              "slow": round(rates["slow"], 4)},
                "samples": {"fast": rates["n_fast"],
                            "slow": rates["n_slow"]},
                "budget_remaining": round(remaining, 4),
                "degrade": obj.degrade,
            }
            if obj.kind == "latency":
                doc["threshold_ms"] = obj.threshold_ms
            if obj.query_kind:
                doc["query_kind"] = obj.query_kind
            if obj.kind == "throughput":
                doc["min_per_s"] = obj.min_per_s
                if obj.pts_per_query:
                    doc["min_pts_per_s"] = (obj.min_per_s
                                            * obj.pts_per_query)
            objectives[name] = doc
        with self._lock:
            held, dropped = len(self._obs), self._dropped
        return {
            "enabled": True,
            "windows": {"fast_s": self.spec.fast_window_s,
                        "slow_s": self.spec.slow_window_s,
                        "budget_s": self.spec.budget_window_s},
            "burn_threshold": self.spec.burn_threshold,
            "objectives": objectives,
            "breaching": breaching,
            "degrade_boost": boost,
            "observations": {"held": held, "dropped": dropped},
        }


def render_slo(report: dict) -> str:
    """Human-readable /debug/slo summary."""
    if not report.get("enabled"):
        return "slo: no spec loaded"
    lines = [
        f"slo: fast {report['windows']['fast_s']:g}s / slow "
        f"{report['windows']['slow_s']:g}s, burn threshold "
        f"{report['burn_threshold']:g}x"]
    for name, o in report["objectives"].items():
        lines.append(
            f"  {name:<20} {o['kind']:<13} {o['state']:<18} "
            f"burn {o['burn_rate']['fast']:.2f}x/"
            f"{o['burn_rate']['slow']:.2f}x  "
            f"budget {o['budget_remaining'] * 100:.1f}%")
    if report["breaching"]:
        lines.append(f"  BREACHING: {', '.join(report['breaching'])} "
                     f"(ladder boost {report['degrade_boost']})")
    return "\n".join(lines)
