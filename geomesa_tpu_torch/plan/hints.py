"""Per-query hints.

Parity: geomesa-index-api QueryHints [upstream, unverified], as the
reference package's `plan/hints.py` models them, restricted to the hints
this slice of the port reads. Aggregation hints (density, bin, stats,
arrow), sampling, approximate answers and authorizations come with their
slices: a query cannot carry them here, so it cannot silently ignore them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class QueryHints:
    # exact count: force full evaluation for counts instead of estimates
    exact_count: bool = True

    # index override (upstream: QUERY_INDEX); recorded by explain only
    query_index: Optional[str] = None
