"""Stats persistence + estimation.

A copy of the reference package's `plan/stats_manager.py`: the same
sketches in the same `<root>/stats.json`, so a store written by either
package opens in the other with the same estimates.

Parity: GeoMesaStats / StatsBasedEstimator + the stats-analyze command
(geomesa-index-api stats; SURVEY.md C5) [upstream, unverified]: compute
mergeable sketches over a store, persist them next to the data
(<root>/stats.json standing in for the stats metadata table), and serve
cheap estimates (count, bounds, histogram, top-k, spatio-temporal
selectivity) to the planner's cost model without scanning.
"""

from __future__ import annotations

import functools
import json
import os
import threading
from typing import Dict, Optional

import numpy as np

from geomesa_tpu_torch.core.columnar import DictColumn, GeometryColumn
from geomesa_tpu_torch.cql.extract import BBox, Interval
from geomesa_tpu_torch.curve.binned_time import TimePeriod, to_binned_time
from geomesa_tpu_torch.stats.sketches import (
    DescriptiveStats,
    MinMax,
    Stat,
    TopK,
    Z3HistogramStat,
)
from geomesa_tpu_torch.store.fs import FileSystemStorage

STATS_FILE = "stats.json"


def _locked(fn):
    """Serialize StatsManager state transitions: the serve layer makes a
    write-path update() (ingest thread) concurrent with refresh()/
    estimate_count() (dispatch thread) the NORMAL case, and both mutate
    self.stats + the persisted file."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


class StatsManager:
    def __init__(self, storage: FileSystemStorage):
        self.storage = storage
        self.stats: Dict[str, Stat] = {}
        self._loaded_mtime: float = -1.0
        self._lock = threading.RLock()  # reentrant: update -> analyze
        self._load()

    @property
    def path(self) -> str:
        return os.path.join(self.storage.root, STATS_FILE)

    def _load(self) -> None:
        if os.path.exists(self.path):
            self._loaded_mtime = os.path.getmtime(self.path)
            # loading stats.json under the lock IS the contract:
            # estimates must never observe half-loaded sketches
            with open(self.path) as f:
                raw = json.load(f)
            self.stats = {}
            for k, v in raw.items():
                try:
                    self.stats[k] = Stat.from_json(v)
                except ValueError as e:
                    # e.g. a sketch persisted under an older hash family:
                    # stale derived data — drop it (planner falls back to
                    # heuristics) rather than serving corrupt estimates
                    import logging

                    logging.getLogger(__name__).warning(
                        "dropping persisted stat %r: %s", k, e
                    )

    @_locked
    def refresh(self) -> None:
        """Reload stats.json if it changed on disk since the last load, so a
        long-lived planner sees stats analyzed after it was constructed
        (parity: GeoMesa's expiring metadata cache). A file that EXISTED
        at load time but is gone now means another process invalidated
        the stats (delete-features) — the in-memory copy must drop too,
        or update() would fold new batches into pre-delete sketches and
        re-persist them."""
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            if self._loaded_mtime != -1.0:
                self.stats = {}
                self._loaded_mtime = -1.0
            return
        if mtime != self._loaded_mtime:
            self._load()

    def _save(self) -> None:
        # atomic replace: a concurrent _load must never json-parse a
        # half-written file (same discipline as the device-cache manifest)
        tmp = self.path + ".tmp"
        # persisting under the lock serializes the sketch snapshot with
        # its mutators; the file swap is atomic
        with open(tmp, "w") as f:
            json.dump({k: s.to_json() for k, s in self.stats.items()}, f)
        os.replace(tmp, self.path)
        self._loaded_mtime = os.path.getmtime(self.path)

    def _init_stats(self) -> Dict[str, Stat]:
        sft = self.storage.sft
        g = sft.default_geometry
        d = sft.default_dtg
        stats: Dict[str, Stat] = {"count": DescriptiveStats("")}
        for a in sft.attributes:
            if a.is_geometry:
                continue
            if a.type in ("String", "UUID"):
                stats[f"topk:{a.name}"] = TopK(a.name, 20)
            elif a.type not in ("Bytes",) and not a.type.startswith(("List", "Map")):
                stats[f"minmax:{a.name}"] = MinMax(a.name)
        if g is not None and g.type == "Point" and d is not None:
            stats["z3"] = Z3HistogramStat(g.name, d.name, "week", 16)
        elif g is not None and g.type == "Point":
            # purely spatial type: single-bin reuse of the Z3 sketch as a
            # Z2 occupancy histogram (upstream keeps a Z2Histogram for
            # exactly this) so bbox selectivity stays estimable without a
            # dtg — the kNN auto kernel choice needs it
            stats["z2"] = Z3HistogramStat(g.name, "", "week", 16)
        return stats

    def _observe_batch(self, stats: Dict[str, Stat], batch) -> None:
        sft = self.storage.sft
        g = sft.default_geometry
        d = sft.default_dtg
        n = len(batch)
        stats["count"].observe_moments(n, 0.0, 0.0)
        for a in sft.attributes:
            col = batch.columns.get(a.name)
            if col is None:
                continue
            key_minmax = f"minmax:{a.name}"
            key_topk = f"topk:{a.name}"
            if key_minmax in stats and not isinstance(col, (DictColumn, GeometryColumn)):
                stats[key_minmax].observe(np.asarray(col))
            elif key_topk in stats and isinstance(col, DictColumn):
                # dict-coded: bincount the int32 codes and feed
                # (vocab, counts) — never materialize row strings
                valid = col.codes[col.codes >= 0]
                counts = np.bincount(valid, minlength=len(col.vocab))
                stats[key_topk].observe_counts(col.vocab, counts)
        if "z3" in stats and g is not None and d is not None:
            gc = batch.columns[g.name]
            bins, _ = to_binned_time(np.asarray(batch.columns[d.name]), TimePeriod.WEEK)
            z3: Z3HistogramStat = stats["z3"]  # type: ignore[assignment]
            b16 = z3.bins_per_dim
            cx = np.clip(((np.asarray(gc.x) + 180.0) / 360.0 * b16).astype(int), 0, b16 - 1)
            cy = np.clip(((np.asarray(gc.y) + 90.0) / 180.0 * b16).astype(int), 0, b16 - 1)
            # one bincount over (time-bin, cell) composite keys instead
            # of a per-bin np.add.at pass (ufunc.at is unbuffered and
            # ~100x slower at bench scale)
            ubins, binv = np.unique(bins, return_inverse=True)
            cells = b16 * b16
            flat = np.bincount(
                binv * cells + cy * b16 + cx, minlength=len(ubins) * cells
            ).reshape(len(ubins), b16, b16)
            for i, b in enumerate(ubins):
                z3.observe_grid(int(b), flat[i])
        elif "z2" in stats and g is not None:
            gc = batch.columns[g.name]
            z2: Z3HistogramStat = stats["z2"]  # type: ignore[assignment]
            b16 = z2.bins_per_dim
            cx = np.clip(((np.asarray(gc.x) + 180.0) / 360.0 * b16).astype(int), 0, b16 - 1)
            cy = np.clip(((np.asarray(gc.y) + 90.0) / 180.0 * b16).astype(int), 0, b16 - 1)
            z2.observe_grid(0, np.bincount(
                cy * b16 + cx, minlength=b16 * b16).reshape(b16, b16))

    @_locked
    def invalidate(self) -> None:
        """Drop persisted sketches (mergeable sketches cannot UN-observe,
        so deletes make them stale — the planner falls back to heuristics
        until the next analyze or write)."""
        self.stats = {}
        try:
            os.remove(self.path)
        except OSError:
            pass
        self._loaded_mtime = -1.0

    @_locked
    def analyze(self) -> dict:
        """Full-store sketch computation (the stats-analyze command)."""
        stats = self._init_stats()
        for batch in self.storage.scan():
            self._observe_batch(stats, batch)
        self.stats = stats
        self._save()
        return self.summary()

    @_locked
    def update(self, batch) -> None:
        """Write-path StatUpdater (upstream
        o.l.g.index.stats StatUpdater): fold ONE written batch into the
        persisted sketches, so planner estimates are live immediately
        after ingest with no stats-analyze. Sketches are mergeable, so
        incremental observation equals a fresh analyze over old+new data
        — PROVIDED the sketches cover everything already stored. With no
        sketches but existing data (store predating stats, or stats
        invalidated by a delete), a one-batch init would silently claim
        subset stats for the whole store (~2x-wrong counts), so that
        case runs a full analyze instead —
        the written batch is already on disk and is included."""
        self.refresh()
        if not self.stats:
            if self.storage.count > len(batch):
                self.analyze()
                return
            self.stats = self._init_stats()
        elif any(
            k in ("z2", "z3") and k not in self.stats
            for k in self._init_stats()
        ):
            # a store whose stats.json predates a newly-introduced sketch
            # kind (e.g. the z2 spatial histogram): incremental
            # observation of just this batch would claim subset stats for
            # the whole store, so rebuild everything once — the written
            # batch is already on disk and is included (without this,
            # stores written before the sketch never gain it)
            self.analyze()
            return
        if batch.valid is not None and not batch.valid.all():
            batch = batch.select(batch.valid)
        self._observe_batch(self.stats, batch)
        self._save()

    @_locked
    def summary(self) -> dict:
        out = {}
        for k, s in self.stats.items():
            r = s.result()
            if isinstance(r, dict) and "count" in r:
                out[k] = r["count"]
            elif isinstance(r, tuple):
                out[k] = list(r)
            elif isinstance(r, list):
                out[k] = r[:5]
            elif isinstance(r, dict):
                out[k] = {kk: int(np.asarray(v).sum()) for kk, v in list(r.items())[:5]}
            else:
                out[k] = str(r)
        return out

    # -- estimation (the planner cost model's inputs) ----------------------

    @property
    def count(self) -> Optional[int]:
        # under the lock like every other estimate: update()/refresh()
        # replace self.stats wholesale from another thread
        with self._lock:
            s = self.stats.get("count")
            return int(s.count) if s is not None else None

    @_locked
    def estimate_count(self, bbox: BBox, interval: Interval) -> Optional[int]:
        """Spatio-temporal selectivity from the Z3 histogram sketch (or the
        single-bin Z2 sketch for non-temporal types); None if stats were
        never analyzed (planner falls back to heuristics)."""
        z3 = self.stats.get("z3")
        if z3 is None:
            z2 = self.stats.get("z2")
            if z2 is not None:
                return z2.estimate(
                    bbox.xmin, bbox.ymin, bbox.xmax, bbox.ymax, [0])
            return self.count
        if interval.start is not None and interval.end is not None:
            from geomesa_tpu_torch.curve.binned_time import bins_for_interval

            bins = [b for b, _, _ in bins_for_interval(
                int(interval.start), int(interval.end), TimePeriod.WEEK
            )]
        else:
            bins = [int(k) for k in z3.counts.keys()]
        return z3.estimate(bbox.xmin, bbox.ymin, bbox.xmax, bbox.ymax, bins)

    @_locked
    def minmax(self, attr: str):
        s = self.stats.get(f"minmax:{attr}")
        return s.result() if s is not None else None

    @_locked
    def topk(self, attr: str):
        s = self.stats.get(f"topk:{attr}")
        return s.result() if s is not None else None
