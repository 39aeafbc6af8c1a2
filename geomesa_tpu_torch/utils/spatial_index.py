"""In-memory spatial indices for live (streaming) feature layers.

Parity: geomesa-utils o.l.g.utils.index SpatialIndex / BucketIndex /
SizeSeparatedBucketIndex [upstream, unverified] — the gridded in-memory
indices backing the Kafka feature cache. Host-side by design: streaming
upsert is a host concern; device residency comes from periodic snapshots
(SURVEY.md C12 TPU note).

`BucketIndex` grids the extent into uniform buckets and stores each entry in
the bucket of its center point — correct for points, and used with an
envelope-expansion query pad for small extended geometries.

`SizeSeparatedBucketIndex` tiers entries by envelope size so a large polygon
lands in a coarse grid (few buckets) while points stay in the fine grid —
queries probe every tier, expanding the query envelope by the tier's bucket
size so center-point binning never misses an overlapping entry.

A copy of the reference package's `utils/spatial_index.py`.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Generic, Iterator, List, Optional, Tuple, TypeVar

T = TypeVar("T")

BBox = Tuple[float, float, float, float]  # xmin, ymin, xmax, ymax


class BucketIndex(Generic[T]):
    """Uniform-grid point index: O(1) insert/remove, bbox query by bucket
    sweep. Thread-safe (coarse lock; streaming writers + query readers)."""

    def __init__(
        self,
        xbuckets: int = 360,
        ybuckets: int = 180,
        extents: BBox = (-180.0, -90.0, 180.0, 90.0),
    ):
        self.extents = extents
        self.nx = xbuckets
        self.ny = ybuckets
        self._dx = (extents[2] - extents[0]) / xbuckets
        self._dy = (extents[3] - extents[1]) / ybuckets
        self._buckets: Dict[Tuple[int, int], Dict[str, Tuple[float, float, T]]] = {}
        self._keys: Dict[str, Tuple[int, int]] = {}
        self._lock = threading.Lock()

    def _bucket(self, x: float, y: float) -> Tuple[int, int]:
        i = int((x - self.extents[0]) / self._dx) if self._dx else 0
        j = int((y - self.extents[1]) / self._dy) if self._dy else 0
        return (min(max(i, 0), self.nx - 1), min(max(j, 0), self.ny - 1))

    def insert(self, key: str, x: float, y: float, value: T) -> None:
        with self._lock:
            if key in self._keys:
                self._remove_locked(key)
            b = self._bucket(x, y)
            self._buckets.setdefault(b, {})[key] = (x, y, value)
            self._keys[key] = b

    def remove(self, key: str) -> Optional[T]:
        with self._lock:
            return self._remove_locked(key)

    def _remove_locked(self, key: str) -> Optional[T]:
        b = self._keys.pop(key, None)
        if b is None:
            return None
        entry = self._buckets[b].pop(key, None)
        if not self._buckets[b]:
            del self._buckets[b]
        return entry[2] if entry else None

    def get(self, key: str) -> Optional[T]:
        with self._lock:
            b = self._keys.get(key)
            if b is None:
                return None
            e = self._buckets[b].get(key)
            return e[2] if e else None

    def query(self, bbox: Optional[BBox] = None) -> Iterator[Tuple[str, T]]:
        """Entries whose point lies in bbox (None = everything)."""
        with self._lock:
            if bbox is None:
                items = [
                    (k, e[2]) for b in self._buckets.values() for k, e in b.items()
                ]
            else:
                xmin, ymin, xmax, ymax = bbox
                i0, j0 = self._bucket(xmin, ymin)
                i1, j1 = self._bucket(xmax, ymax)
                items = []
                for i in range(i0, i1 + 1):
                    for j in range(j0, j1 + 1):
                        for k, (x, y, v) in self._buckets.get((i, j), {}).items():
                            if xmin <= x <= xmax and ymin <= y <= ymax:
                                items.append((k, v))
        return iter(items)

    def clear(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._keys.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)


class SizeSeparatedBucketIndex(Generic[T]):
    """Tiered grids for mixed point/extended geometries.

    Tier t has bucket size `base * 4**t` degrees; an entry goes in the
    finest tier whose bucket size covers its envelope's larger side. Queries
    expand the search envelope by one bucket per tier so center-binned
    entries overlapping the query are always visited, then exact-check the
    stored envelope.
    """

    def __init__(
        self,
        tiers: int = 4,
        base: float = 1.0,
        extents: BBox = (-180.0, -90.0, 180.0, 90.0),
    ):
        self.extents = extents
        self._tiers: List[BucketIndex[Tuple[BBox, T]]] = []
        self._sizes: List[float] = []
        w = extents[2] - extents[0]
        h = extents[3] - extents[1]
        for t in range(tiers):
            size = base * (4.0**t)
            nx = max(1, int(math.ceil(w / size)))
            ny = max(1, int(math.ceil(h / size)))
            self._tiers.append(BucketIndex(nx, ny, extents))
            self._sizes.append(size)
        self._where: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _tier_for(self, bbox: BBox) -> int:
        side = max(bbox[2] - bbox[0], bbox[3] - bbox[1])
        for t, size in enumerate(self._sizes):
            if side <= size:
                return t
        return len(self._sizes) - 1

    def insert(self, key: str, bbox: BBox, value: T) -> None:
        with self._lock:
            old = self._where.pop(key, None)
            if old is not None:
                self._tiers[old].remove(key)
            t = self._tier_for(bbox)
            cx = (bbox[0] + bbox[2]) / 2.0
            cy = (bbox[1] + bbox[3]) / 2.0
            self._tiers[t].insert(key, cx, cy, (bbox, value))
            self._where[key] = t

    def remove(self, key: str) -> Optional[T]:
        with self._lock:
            t = self._where.pop(key, None)
            if t is None:
                return None
            e = self._tiers[t].remove(key)
            return e[1] if e else None

    def get(self, key: str) -> Optional[T]:
        with self._lock:
            t = self._where.get(key)
        if t is None:
            return None
        e = self._tiers[t].get(key)
        return e[1] if e else None

    def query(self, bbox: Optional[BBox] = None) -> Iterator[Tuple[str, T]]:
        out: List[Tuple[str, T]] = []
        for t, idx in enumerate(self._tiers):
            if bbox is None:
                out.extend((k, v[1]) for k, v in idx.query(None))
                continue
            pad = self._sizes[t]
            probe = (bbox[0] - pad, bbox[1] - pad, bbox[2] + pad, bbox[3] + pad)
            for k, (ebox, v) in idx.query(probe):
                if (
                    ebox[0] <= bbox[2]
                    and ebox[2] >= bbox[0]
                    and ebox[1] <= bbox[3]
                    and ebox[3] >= bbox[1]
                ):
                    out.append((k, v))
        return iter(out)

    def clear(self) -> None:
        with self._lock:
            for t in self._tiers:
                t.clear()
            self._where.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._where)
