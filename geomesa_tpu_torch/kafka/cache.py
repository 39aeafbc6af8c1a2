"""KafkaFeatureCache: latest-feature-per-id in-memory state + spatial index.

Parity: geomesa-kafka KafkaFeatureCache + KafkaFeatureEventSource [upstream,
unverified]: consumers fold GeoMessages into a map fid -> latest feature,
maintain a gridded spatial index for bbox queries, push feature events to
registered listeners, and expire features by age.

TPU integration (SURVEY.md C12): `snapshot()` materializes the live state as
an immutable columnar FeatureBatch — the double-buffered device refresh
boundary. Queries can run host-side from the index (low latency, small
results) or device-side on the latest snapshot (analytics).

A copy of the reference package's `kafka/cache.py`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.core.wkt import Geometry
from geomesa_tpu_torch.kafka.messages import Change, Clear, Delete, GeoMessage
from geomesa_tpu_torch.utils.spatial_index import BucketIndex


@dataclasses.dataclass
class FeatureEvent:
    kind: str  # changed | removed | cleared
    fid: Optional[str] = None
    attributes: Optional[Dict[str, object]] = None


Listener = Callable[[FeatureEvent], None]


class KafkaFeatureCache:
    def __init__(
        self,
        sft: SimpleFeatureType,
        expiry_ms: Optional[int] = None,
        xbuckets: int = 360,
        ybuckets: int = 180,
        index_attrs: Optional[List[str]] = None,
    ):
        self.sft = sft
        self.expiry_ms = expiry_ms
        self._geom = sft.default_geometry.name if sft.default_geometry else None
        self._rows: Dict[str, Dict[str, object]] = {}
        self._stamps: Dict[str, float] = {}
        self._index: BucketIndex[str] = BucketIndex(xbuckets, ybuckets)
        # CQEngine-analog attribute hash indexes (SURVEY.md:323-324): for
        # each indexed attribute, value -> set of fids, so live-layer
        # equality queries avoid the full snapshot scan
        if index_attrs is None:
            index_attrs = [
                a.name
                for a in sft.attributes
                if a.options.get("index", "").lower() in ("true", "full", "join")
            ]
        self._attr_index: Dict[str, Dict[object, set]] = {
            a: {} for a in index_attrs
        }
        self.attr_index_hits = 0  # counter: fast-path queries served
        self._listeners: List[Listener] = []
        self._lock = threading.Lock()
        self._snapshot: Optional[FeatureBatch] = None
        self._snapshot_dirty = True

    # -- message application ----------------------------------------------

    def apply(self, msg: GeoMessage) -> None:
        if isinstance(msg, Change):
            self._upsert(msg.fid, msg.attributes)
        elif isinstance(msg, Delete):
            self._delete(msg.fid)
        elif isinstance(msg, Clear):
            self.clear()
        else:
            raise TypeError(f"not a GeoMessage: {msg!r}")

    def _unindex_attrs(self, fid: str) -> None:
        """Caller holds the lock. Remove fid's old values from the
        attribute indexes."""
        old = self._rows.get(fid)
        if old is None:
            return
        for name, idx in self._attr_index.items():
            fids = idx.get(old.get(name))
            if fids is not None:
                fids.discard(fid)
                if not fids:
                    del idx[old.get(name)]

    def _upsert(self, fid: str, attrs: Dict[str, object]) -> None:
        with self._lock:
            self._unindex_attrs(fid)
            for name, idx in self._attr_index.items():
                idx.setdefault(attrs.get(name), set()).add(fid)
            self._rows[fid] = attrs
            self._stamps[fid] = time.time()
            if self._geom is not None:
                g = attrs.get(self._geom)
                if isinstance(g, Geometry):
                    cx, cy = g.point if g.is_point else (
                        (g.bbox[0] + g.bbox[2]) / 2.0,
                        (g.bbox[1] + g.bbox[3]) / 2.0,
                    )
                    self._index.insert(fid, cx, cy, fid)
            self._snapshot_dirty = True
        self._emit(FeatureEvent("changed", fid, attrs))

    def _delete(self, fid: str) -> None:
        with self._lock:
            self._unindex_attrs(fid)
            existed = self._rows.pop(fid, None) is not None
            self._stamps.pop(fid, None)
            self._index.remove(fid)
            if existed:
                self._snapshot_dirty = True
        if existed:
            self._emit(FeatureEvent("removed", fid))

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()
            self._stamps.clear()
            self._index.clear()
            for idx in self._attr_index.values():
                idx.clear()
            self._snapshot_dirty = True
        self._emit(FeatureEvent("cleared"))

    # -- expiry ------------------------------------------------------------

    def expire(self, now: Optional[float] = None) -> int:
        """Drop features older than expiry_ms; returns the evicted count.
        Called by the store's maintenance tick (upstream: Caffeine expiry).

        Expiry-driven removals emit `removed` FeatureEvents exactly like
        explicit deletes — a geofence subscription must see the EXIT
        when a feature ages out, not just when a Delete message arrives
        (the standing queries, ROADMAP A6). Selection and removal happen
        under ONE lock acquisition (the old collect-then-re-lock shape let a
        racing upsert refresh a fid between the scan and its delete,
        dropping a fresh row); events emit OUTSIDE the lock against a
        listener snapshot — the `_emit` discipline (GT11)."""
        if self.expiry_ms is None:
            return 0
        now = now if now is not None else time.time()
        cutoff = now - self.expiry_ms / 1000.0
        events = []
        with self._lock:
            stale = [fid for fid, ts in self._stamps.items()
                     if ts < cutoff]
            for fid in stale:
                self._unindex_attrs(fid)
                self._rows.pop(fid, None)
                self._stamps.pop(fid, None)
                self._index.remove(fid)
                events.append(FeatureEvent("removed", fid))
            if stale:
                self._snapshot_dirty = True
            listeners = list(self._listeners)
        for event in events:
            for fn in listeners:
                fn(event)
        return len(events)

    # -- reads -------------------------------------------------------------

    def get(self, fid: str) -> Optional[Dict[str, object]]:
        with self._lock:
            return self._rows.get(fid)

    def query_bbox(
        self, bbox: Tuple[float, float, float, float]
    ) -> List[Tuple[str, Dict[str, object]]]:
        """Host-side bbox query straight off the gridded index."""
        with self._lock:
            fids = [fid for fid, _ in self._index.query(bbox)]
            return [(fid, self._rows[fid]) for fid in fids if fid in self._rows]

    @property
    def indexed_attributes(self) -> List[str]:
        return sorted(self._attr_index)

    def query_attribute(
        self, name: str, values
    ) -> List[Tuple[str, Dict[str, object]]]:
        """Equality/IN lookup off the attribute hash index — O(matches),
        no snapshot scan. Raises KeyError for unindexed attributes."""
        with self._lock:
            idx = self._attr_index[name]
            self.attr_index_hits += 1
            fids: set = set()
            for v in values:
                fids |= idx.get(v, set())
            return [
                (fid, self._rows[fid])
                for fid in sorted(fids)
                if fid in self._rows
            ]

    def snapshot(self) -> Optional[FeatureBatch]:
        """Immutable columnar view of current state (device refresh boundary).
        Rebuilt only when dirty — repeated calls between updates are free."""
        with self._lock:
            if not self._snapshot_dirty:
                return self._snapshot
            if not self._rows:
                self._snapshot = None
                self._snapshot_dirty = False
                return None
            fids = list(self._rows.keys())
            data: Dict[str, list] = {a.name: [] for a in self.sft.attributes}
            for fid in fids:
                row = self._rows[fid]
                for a in self.sft.attributes:
                    data[a.name].append(row.get(a.name))
            self._snapshot = FeatureBatch.from_pydict(self.sft, data, fids=fids)
            self._snapshot_dirty = False
            return self._snapshot

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    # -- events ------------------------------------------------------------

    def add_listener(self, fn: Listener) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Listener) -> None:
        with self._lock:
            self._listeners.remove(fn)

    def _emit(self, event: FeatureEvent) -> None:
        # snapshot under the lock; INVOKE outside it (GT11): a listener
        # that queries the cache re-enters without self-deadlocking
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(event)
