"""Deterministic, seedable fault-injection harness.

A copy of the reference package's `faults/harness.py`: the same plan, the
same call sequence and the same seed give the same fire log in either
package.

Dependency boundaries register named sites once at import time:

    _READ_SITE = faults.site("fs.read_partition", "partition file read")

and call ``_READ_SITE.fire()`` on the hot path. When no harness is
installed the fire is a single module-global ``is None`` check — the
zero-overhead no-op fast path the serving SLO depends on.

With a harness installed (``with faults.active(plan): ...``), each fire
consults the plan's rules for the site under a per-site lock: the site
call counter, the per-site seeded RNG stream and the per-rule fire
budget all advance deterministically, so two runs of the same workload
with the same seed inject the SAME faults at the SAME calls — the chaos
checker replays a run and diffs the fire logs to prove it. Per-site RNG
streams are seeded from (plan.seed, site-name CRC), not Python's salted
``hash``, so replay holds across processes.

Every fire is appended to a bounded log (site, call index, rule error)
and noted into the RecoveryMeter so ServeEvents can attribute
per-dispatch fault counts (`ServeEvent.fault_injected`).
"""

from __future__ import annotations

import fnmatch
import threading
import time
import zlib
from random import Random
from typing import Dict, List, Optional, Tuple

from geomesa_tpu_torch.faults.errors import ERROR_KINDS
from geomesa_tpu_torch.faults.plan import FaultPlan, FaultRule

# registered site catalog: name -> description
SITES: Dict[str, str] = {}

_MAX_LOG = 65536


class FaultSite:
    """One named injection point. Cheap by construction: `fire` reads a
    single module global and returns immediately when inactive."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def fire(self) -> None:
        h = _HARNESS
        if h is None:
            return
        h.check(self.name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultSite({self.name!r})"


def site(name: str, doc: str = "") -> FaultSite:
    """Register (idempotently) and return a named injection site."""
    if doc or name not in SITES:
        SITES[name] = doc or SITES.get(name, "")
    return FaultSite(name)


def inject(name: str) -> None:
    """Ad-hoc fire for call sites without a prebound FaultSite."""
    h = _HARNESS
    if h is not None:
        h.check(name)


class _SiteState:
    __slots__ = ("lock", "count", "rng", "rules", "fires")

    def __init__(self, seed: int, name: str, rules: List[FaultRule]):
        self.lock = threading.Lock()
        self.count = 0
        # process-stable per-site stream: crc32, not salted str hash
        self.rng = Random((seed << 32) ^ zlib.crc32(name.encode()))
        self.rules = rules
        self.fires = [0] * len(rules)  # per-rule fire budget tracking


class FaultHarness:
    """Evaluates a FaultPlan at every site fire. Thread-safe; decisions
    are per-site-deterministic (see module docstring)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._states: Dict[str, _SiteState] = {}
        self._states_lock = threading.Lock()
        self._log_lock = threading.Lock()
        self._log: List[Tuple[str, int, str]] = []

    def _state(self, name: str) -> _SiteState:
        # always under the lock: this path only runs while a harness is
        # ACTIVE (chaos runs), so the acquisition is off the serving
        # no-op fast path entirely
        with self._states_lock:
            st = self._states.get(name)
            if st is None:
                rules = [r for r in self.plan.rules
                         if r.site == name
                         or fnmatch.fnmatchcase(name, r.site)]
                st = self._states[name] = _SiteState(
                    self.plan.seed, name, rules)
            return st

    def check(self, name: str) -> None:
        st = self._state(name)
        if not st.rules:
            return
        fired: Optional[Tuple[FaultRule, int]] = None
        with st.lock:
            st.count += 1
            for i, rule in enumerate(st.rules):
                if rule.max_fires is not None and st.fires[i] >= rule.max_fires:
                    continue
                hit = False
                if rule.nth_call is not None:
                    hit = st.count == rule.nth_call
                elif rule.every is not None:
                    hit = st.count % rule.every == 0
                elif rule.probability > 0.0:
                    # the roll ALWAYS advances the stream for an armed
                    # probability rule, so replay determinism survives
                    # other rules firing first
                    hit = st.rng.random() < rule.probability
                if hit and fired is None:
                    st.fires[i] += 1
                    fired = (rule, st.count)
        if fired is None:
            return
        rule, count = fired
        with self._log_lock:
            if len(self._log) < _MAX_LOG:
                self._log.append((name, count, rule.error))
        try:
            from geomesa_tpu_torch.faults.context import RECOVERY
            from geomesa_tpu_torch.telemetry.recorder import RECORDER
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.counter("fault.injected")
            metrics.counter(f"fault.injected.{name}")
            RECOVERY.note("fault", name)
            RECORDER.note_event("fault", site=name, call=count,
                                error=rule.error)
        except Exception:
            pass  # observability must never change injection behavior
        if rule.latency_ms:
            time.sleep(rule.latency_ms / 1000.0)
        exc_cls = ERROR_KINDS[rule.error]
        if exc_cls is not None:
            raise exc_cls(
                f"injected {rule.error} fault at {name} (call #{count})")

    def fire_log(self) -> List[Tuple[str, int, str]]:
        """(site, call index, error kind) per fire, in fire order."""
        with self._log_lock:
            return list(self._log)

    def fired_sites(self) -> List[str]:
        with self._log_lock:
            return sorted({s for s, _, _ in self._log})


_HARNESS: Optional[FaultHarness] = None
_INSTALL_LOCK = threading.Lock()


def install(plan: FaultPlan) -> FaultHarness:
    """Install a harness process-wide. Raises if one is already active
    (nested chaos runs would corrupt each other's determinism)."""
    global _HARNESS
    with _INSTALL_LOCK:
        if _HARNESS is not None:
            raise RuntimeError("a fault harness is already installed")
        h = FaultHarness(plan)
        _HARNESS = h
        return h


def uninstall() -> None:
    global _HARNESS
    with _INSTALL_LOCK:
        _HARNESS = None


def current() -> Optional[FaultHarness]:
    return _HARNESS


class active:
    """Context manager: ``with faults.active(plan) as harness: ...``"""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.harness: Optional[FaultHarness] = None

    def __enter__(self) -> FaultHarness:
        self.harness = install(self.plan)
        return self.harness

    def __exit__(self, *exc) -> bool:
        uninstall()
        return False
