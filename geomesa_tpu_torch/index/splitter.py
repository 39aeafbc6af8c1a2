"""Filter splitting and index strategy selection.

Parity: geomesa-index-api planning's FilterSplitter + StrategyDecider
(SURVEY.md C6 steps 3-4) [upstream, unverified]. Every candidate index
offers a (primary-ranges, residual) option; the decider costs each option —
here with *exact* range key counts from the sorted adapter (strictly better
than upstream's sketch estimates, same contract) — and the cheapest wins.
An explicit hint override (QUERY_INDEX) short-circuits costing, as upstream.

The residual is always the full filter: index ranges are covering, and the
compiled-predicate mask removes false positives on device. This matches the
reference's handling of covering indices (XZ especially), where the
server-side residual re-checks everything the key schema can't decide.

A copy of the reference package's `index/splitter.py`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.index.adapter import IndexAdapter
from geomesa_tpu_torch.index.keyspace import ByteRange, IndexKeySpace


@dataclasses.dataclass
class IndexOption:
    """One way to answer a query: this index, these ranges."""

    index: IndexKeySpace
    ranges: List[ByteRange]
    cost: int  # estimated rows scanned

    @property
    def name(self) -> str:
        return getattr(self.index, "full_name", self.index.name)


class FilterSplitter:
    """Enumerate viable (index, ranges) options for a filter."""

    def __init__(self, indices: Sequence[IndexKeySpace]):
        self.indices = list(indices)

    def options(
        self, f: ast.Filter, max_ranges: int = 512
    ) -> List[IndexOption]:
        out = []
        for idx in self.indices:
            if isinstance(f, (ast.Include,)) or not idx.supports(f):
                continue
            ranges = idx.ranges(f, max_ranges=max_ranges)
            if ranges:
                out.append(IndexOption(idx, ranges, cost=-1))
        return out


class StrategyDecider:
    def __init__(self, adapter: IndexAdapter):
        self.adapter = adapter

    def decide(
        self,
        options: List[IndexOption],
        override: Optional[str] = None,
        explain=None,
    ) -> Optional[IndexOption]:
        e = explain if explain is not None else (lambda *_: None)
        if not options:
            e("No index options: full-table scan")
            return None
        if override:
            for opt in options:
                if opt.name == override or opt.index.name == override:
                    e(f"Index override: {opt.name}")
                    return opt
            e(f"Index override {override!r} not viable; falling back to cost")
        for opt in options:
            opt.cost = self.adapter.scan_count(opt.name, opt.ranges)
        best = min(options, key=lambda o: o.cost)
        e(
            "Strategy costs: "
            + ", ".join(f"{o.name}={o.cost}" for o in options)
            + f" -> chose {best.name}"
        )
        return best
