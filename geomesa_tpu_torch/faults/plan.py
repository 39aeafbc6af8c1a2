"""Declarative fault plans: site -> schedule -> error type.

A copy of the reference package's `faults/plan.py`: the same JSON
format, so a plan saved by either package loads in the other.

A FaultPlan is a seeded, replayable description of WHICH injection
sites fail, WHEN, and HOW (in the lineage-driven fault injection spirit:
failure is an input, not an accident). JSON format:

    {
      "seed": 7,
      "rules": [
        {"site": "fs.read_partition", "error": "io",
         "every": 3, "max_fires": 8},
        {"site": "kafka.poll", "error": "unavailable", "nth_call": 2},
        {"site": "device.transfer", "error": "oom", "probability": 0.1},
        {"site": "fs.*", "error": "latency", "latency_ms": 5,
         "probability": 0.5}
      ]
    }

Schedules (first match wins per rule, rules evaluated in order):
  nth_call     fire exactly on the Nth call to the site (1-based)
  every        fire on every Nth call (count % every == 0)
  probability  fire with probability p per call (per-site seeded RNG —
               two runs with the same seed and call sequence replay the
               same fire decisions exactly)
  max_fires    stop a rule after N fires (lets a plan model recovery:
               the dependency "heals" and breakers can half-open/close)
  latency_ms   added latency when the rule fires; with error "latency"
               the call is delayed but succeeds.

Site names may be exact or fnmatch globs over the registered catalog
(faults.harness.SITES).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

from geomesa_tpu_torch.faults.errors import ERROR_KINDS


@dataclasses.dataclass
class FaultRule:
    site: str
    error: str = "io"
    probability: float = 0.0
    nth_call: Optional[int] = None
    every: Optional[int] = None
    max_fires: Optional[int] = None
    latency_ms: float = 0.0

    def __post_init__(self):
        if self.error not in ERROR_KINDS:
            raise ValueError(
                f"unknown fault error kind {self.error!r} "
                f"(have {', '.join(sorted(ERROR_KINDS))})")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(
                f"probability must be in [0, 1], got {self.probability}")
        if self.nth_call is not None and self.nth_call < 1:
            raise ValueError("nth_call is 1-based and must be >= 1")
        if self.every is not None and self.every < 1:
            raise ValueError("every must be >= 1")
        if (self.probability == 0.0 and self.nth_call is None
                and self.every is None):
            raise ValueError(
                f"rule for site {self.site!r} has no schedule "
                "(set probability, nth_call or every)")

    def to_json(self) -> dict:
        out = {"site": self.site, "error": self.error}
        if self.probability:
            out["probability"] = self.probability
        if self.nth_call is not None:
            out["nth_call"] = self.nth_call
        if self.every is not None:
            out["every"] = self.every
        if self.max_fires is not None:
            out["max_fires"] = self.max_fires
        if self.latency_ms:
            out["latency_ms"] = self.latency_ms
        return out


@dataclasses.dataclass
class FaultPlan:
    rules: List[FaultRule]
    seed: int = 0
    # dependencies whose breakers this plan is DESIGNED to cycle
    # (open + half-open): a chaos check fails unless their transitions
    # appear in metrics during the run
    expect_breakers: List[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        out = {"seed": self.seed,
               "rules": [r.to_json() for r in self.rules]}
        if self.expect_breakers:
            out["expect_breakers"] = list(self.expect_breakers)
        return out

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f, indent=1)
            f.write("\n")

    @classmethod
    def from_json(cls, doc: dict) -> "FaultPlan":
        rules = [FaultRule(**r) for r in doc.get("rules", [])]
        return cls(rules=rules, seed=int(doc.get("seed", 0)),
                   expect_breakers=list(doc.get("expect_breakers", ())))

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(json.load(f))
