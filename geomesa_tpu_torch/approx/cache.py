"""Version-exact result cache for the serve layer.

A copy of the reference package's `approx/cache.py`.

Keys are (kind, typeName, CANONICAL CQL, hints, result-shape extras,
`manifest_snapshot()` version) — so invalidation is exact BY
CONSTRUCTION, not TTL: a committed write bumps the manifest version and
every key minted before it simply stops matching. A hit is therefore
always bit-identical to re-running the query against the same committed
state (asserted in tests/test_approx.py); bounded LRU keeps memory flat
and old-version entries age out through normal eviction.

The canonical-CQL discipline is load-bearing: keying on raw filter text
would miss-storm on equivalent spellings ("a=1 AND b=2" vs
"a = 1 AND b = 2").
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

_MISS = object()


def result_key(kind: str, query, version: Optional[int]
               ) -> Optional[tuple]:
    """The cache key for one (kind, query, manifest version), or None
    when the query is uncacheable: no committed version to pin
    (live/Kafka stores), a tolerance hint (approx answers are already
    microseconds and bound-dependent), or an unparseable filter. The
    filter ALWAYS canonicalizes through the AST."""
    if version is None or kind == "knn":
        return None
    h = query.hints
    if h.tolerance is not None:
        return None
    try:
        from geomesa_tpu_torch.cql import ast

        cql = ast.to_cql(query.filter_ast)
    except Exception:
        return None
    if kind == "count":
        return ("count", query.type_name, cql, str(h),
                query.max_features, int(version))
    attrs = tuple(query.attributes) if query.attributes is not None else None
    sort = tuple(query.sort_by) if query.sort_by else None
    return ("execute", query.type_name, cql, str(h), attrs, sort,
            query.max_features, query.crs, int(version))


class ResultCache:
    """Bounded LRU with hit/miss/evict metrics. Values are treated as
    immutable by every consumer (the same discipline the batcher's
    count/execute dedup already relies on), so sharing the object is
    safe and a hit is bit-identical by identity."""

    def __init__(self, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError("result cache needs max_entries >= 1")
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Optional[tuple],
            count_miss: bool = True) -> Tuple[bool, object]:
        """(hit, value). A None key is a structural miss (unmetered —
        the query was never cacheable). `count_miss=False` suppresses
        miss accounting for second-chance peeks (the dispatch loop
        re-peeks requests the admission peek already counted)."""
        if key is None:
            return False, None
        with self._lock:
            got = self._entries.get(key, _MISS)
            if got is _MISS:
                if count_miss:
                    self.misses += 1
                hit = False
                val = None
            else:
                self._entries.move_to_end(key)
                self.hits += 1
                hit = True
                val = got
        if hit or count_miss:
            try:
                from geomesa_tpu_torch.utils.metrics import metrics

                metrics.counter("serve.cache.hit" if hit
                                else "serve.cache.miss")
            except Exception:
                pass
        return hit, val

    def put(self, key: Optional[tuple], value) -> None:
        if key is None:
            return
        evicted = 0
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
                evicted += 1
        if evicted:
            try:
                from geomesa_tpu_torch.utils.metrics import metrics

                metrics.counter("serve.cache.evict", evicted)
            except Exception:
                pass

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "max_entries": self.max_entries,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}
