"""The Stat DSL parser (a copy of the reference package's `stats/dsl.py`).

Parity: org.locationtech.geomesa.utils.stats.Stat / StatParser [upstream,
unverified]. Expressions are ';'-separated stat constructors:

    "MinMax(dtg);Frequency(name);TopK(actor);Histogram(score,20,-10,10);
     Cardinality(id);DescriptiveStats(score);Enumeration(code);
     Z3Histogram(geom,dtg,week,16);Count()"

Count() maps to DescriptiveStats on no attribute upstream; here it returns a
DescriptiveStats with a synthetic count-only role.
"""

from __future__ import annotations

import re

from geomesa_tpu_torch.stats.sketches import (
    Cardinality,
    DescriptiveStats,
    EnumerationStat,
    Frequency,
    Histogram,
    MinMax,
    SeqStat,
    Stat,
    TopK,
    Z3HistogramStat,
)

_CALL = re.compile(r"^\s*([A-Za-z0-9_]+)\s*\(([^)]*)\)\s*$")


def _parse_one(expr: str) -> Stat:
    m = _CALL.match(expr)
    if not m:
        raise ValueError(f"bad stat expression: {expr!r}")
    name = m.group(1).lower()
    args = [a.strip() for a in m.group(2).split(",") if a.strip()]
    if name == "minmax":
        return MinMax(args[0])
    if name == "cardinality":
        return Cardinality(args[0], p=int(args[1]) if len(args) > 1 else 12)
    if name == "frequency":
        return Frequency(args[0])
    if name == "topk":
        return TopK(args[0], k=int(args[1]) if len(args) > 1 else 10)
    if name == "histogram":
        if len(args) != 4:
            raise ValueError("Histogram(attr, bins, lo, hi)")
        return Histogram(args[0], int(args[1]), float(args[2]), float(args[3]))
    if name in ("descriptivestats", "stats"):
        return DescriptiveStats(args[0])
    if name in ("enumeration", "enumerationstat"):
        return EnumerationStat(args[0])
    if name == "z3histogram":
        return Z3HistogramStat(
            args[0],
            args[1],
            args[2] if len(args) > 2 else "week",
            int(args[3]) if len(args) > 3 else 16,
        )
    if name == "count":
        return DescriptiveStats("")
    raise ValueError(f"unknown stat {m.group(1)!r}")


def parse_stats(expression: str) -> SeqStat:
    parts = [p for p in expression.split(";") if p.strip()]
    return SeqStat([_parse_one(p) for p in parts])
