"""IndexAdapter SPI + the in-memory sorted-KV implementation.

Parity: geomesa-index-api's IndexAdapter (the contract a storage backend
implements: create tables, write mutations, scan key ranges) and the
in-memory TestGeoMesaDataStore backend (SURVEY.md C9-C11, §4) [upstream,
unverified]. The memory adapter is a real backend, not a test shim: sorted
key arrays + bisect scans are the moral equivalent of a single-tablet
Accumulo, and every index keyspace runs on it unmodified.

A copy of the reference package's `index/adapter.py`.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from geomesa_tpu_torch.index.keyspace import ByteRange, WriteKey


class IndexAdapter:
    """SPI: what a KV backend must implement (upstream IndexAdapter)."""

    def create_index(self, index_name: str) -> None:
        raise NotImplementedError

    def write(self, index_name: str, keys: Iterable[WriteKey]) -> None:
        raise NotImplementedError

    def delete(self, index_name: str, keys: Iterable[bytes]) -> None:
        raise NotImplementedError

    def scan(self, index_name: str, ranges: Sequence[ByteRange]) -> List[int]:
        """Row ids whose keys fall in any [lo, hi) range (dedupe preserved
        to the caller — an id may appear once per matching key)."""
        raise NotImplementedError

    def scan_count(self, index_name: str, ranges: Sequence[ByteRange]) -> int:
        """Number of keys in the ranges — the cost-estimation primitive
        (upstream estimates via stat sketches; a sorted store can afford
        exact counts, which is strictly better costing)."""
        raise NotImplementedError

    def size(self, index_name: str) -> int:
        raise NotImplementedError


class MemoryIndexAdapter(IndexAdapter):
    """Sorted parallel arrays per index; scans are bisect slices."""

    def __init__(self):
        self._keys: Dict[str, List[bytes]] = {}
        self._rows: Dict[str, List[int]] = {}

    def create_index(self, index_name: str) -> None:
        self._keys.setdefault(index_name, [])
        self._rows.setdefault(index_name, [])

    def write(self, index_name: str, keys: Iterable[WriteKey]) -> None:
        """Bulk merge: sort incoming pairs, one O(N+M) merge with the
        existing sorted arrays (per-key list.insert would make a batch
        load O(N^2)). Same-key writes replace (idempotent overwrite)."""
        incoming = sorted(((wk.key, wk.row) for wk in keys), key=lambda p: p[0])
        if not incoming:
            return
        # same key twice in one batch: last one wins
        dedup = []
        for key, row in incoming:
            if dedup and dedup[-1][0] == key:
                dedup[-1] = (key, row)
            else:
                dedup.append((key, row))
        ks, rs = self._keys[index_name], self._rows[index_name]
        out_k: List[bytes] = []
        out_r: List[int] = []
        i = j = 0
        while i < len(ks) and j < len(dedup):
            if ks[i] < dedup[j][0]:
                out_k.append(ks[i])
                out_r.append(rs[i])
                i += 1
            elif ks[i] == dedup[j][0]:
                out_k.append(dedup[j][0])
                out_r.append(dedup[j][1])
                i += 1
                j += 1
            else:
                out_k.append(dedup[j][0])
                out_r.append(dedup[j][1])
                j += 1
        out_k.extend(ks[i:])
        out_r.extend(rs[i:])
        out_k.extend(p[0] for p in dedup[j:])
        out_r.extend(p[1] for p in dedup[j:])
        self._keys[index_name] = out_k
        self._rows[index_name] = out_r

    def delete(self, index_name: str, keys: Iterable[bytes]) -> None:
        ks, rs = self._keys[index_name], self._rows[index_name]
        for key in keys:
            i = bisect.bisect_left(ks, key)
            if i < len(ks) and ks[i] == key:
                del ks[i]
                del rs[i]

    def _slices(
        self, index_name: str, ranges: Sequence[ByteRange]
    ) -> List[Tuple[int, int]]:
        ks = self._keys[index_name]
        out = []
        for lo, hi in ranges:
            a = bisect.bisect_left(ks, lo)
            b = bisect.bisect_left(ks, hi)
            if b > a:
                out.append((a, b))
        return out

    def scan(self, index_name: str, ranges: Sequence[ByteRange]) -> List[int]:
        rs = self._rows[index_name]
        seen: Set[int] = set()
        out: List[int] = []
        for a, b in self._slices(index_name, ranges):
            for r in rs[a:b]:
                if r not in seen:
                    seen.add(r)
                    out.append(r)
        return out

    def scan_count(self, index_name: str, ranges: Sequence[ByteRange]) -> int:
        return sum(b - a for a, b in self._slices(index_name, ranges))

    def size(self, index_name: str) -> int:
        return len(self._keys[index_name])
