"""Mergeable stat sketches and the Stat DSL.

A copy of the reference package's `stats/`: parseable stat expressions
("MinMax(dtg);Frequency(name)") with mergeable implementations, read by
the planner's selectivity estimate (`plan/stats_manager.py`). Stats
queries (the `stats` kind of `execute`) come with a later slice.
"""

from geomesa_tpu_torch.stats.sketches import (
    Cardinality,
    DescriptiveStats,
    EnumerationStat,
    Frequency,
    GroupBy,
    Histogram,
    MinMax,
    SeqStat,
    Stat,
    TopK,
    Z3HistogramStat,
)
from geomesa_tpu_torch.stats.dsl import parse_stats

__all__ = [
    "Stat", "MinMax", "Cardinality", "Frequency", "TopK", "Histogram",
    "DescriptiveStats", "EnumerationStat", "GroupBy", "SeqStat",
    "Z3HistogramStat", "parse_stats",
]
