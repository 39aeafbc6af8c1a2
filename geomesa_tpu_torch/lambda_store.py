"""Lambda store: transient live tier + persistent tier, merged on read.

Parity: geomesa-lambda LambdaDataStore [upstream, unverified]: recent writes
live in Kafka + an in-memory cache (transient tier) and are asynchronously
persisted after an age threshold to a backing persistent store; queries
merge both tiers with the transient feature winning on feature-id collision.

Here: transient = KafkaDataStore (in-process broker), persistent = the
partitioned Parquet DataStore. `persist()` is the explicit tick the
reference runs on a scheduled executor (upstream: OffsetManager-coordinated
expiry); call it from a host timer.

A copy of the reference package's `lambda_store.py`, with both tiers on
one device (`device=None`: the card). Aggregations over the merged rows
(density: B3) run on that device with the store's own zsparse
calibration cache. `mesh=` reaches both tiers' stores, as in the
reference.
"""

from __future__ import annotations

import time
from typing import List, Optional, Set, Union

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.engine.device import resolve_device, to_device
from geomesa_tpu_torch.kafka.store import InProcessBroker, KafkaDataStore
from geomesa_tpu_torch.plan.datastore import DataStore
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.plan.planner import QueryResult
from geomesa_tpu_torch.plan.runner import CalibCache, aggregate


class LambdaDataStore:
    def __init__(
        self,
        catalog: str,
        persist_after_ms: int = 60_000,
        broker: Optional[InProcessBroker] = None,
        mesh=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.persistent = DataStore(catalog, device=self.device, mesh=mesh)
        self.transient = KafkaDataStore(broker=broker, device=self.device,
                                        mesh=mesh)
        self.persist_after_ms = persist_after_ms
        # the zsparse calibrations of the merged aggregations
        self._calib = CalibCache()
        self._created: Set[str] = set()

    # -- schema ------------------------------------------------------------

    def create_schema(self, sft: SimpleFeatureType) -> None:
        self.persistent.create_schema(sft)
        self.transient.create_schema(sft)
        self._created.add(sft.name)

    def get_type_names(self) -> List[str]:
        return sorted(set(self.persistent.get_type_names()) | set(self._created))

    def get_schema(self, name: str) -> SimpleFeatureType:
        return self.persistent.get_schema(name)

    # -- writes (transient tier) ------------------------------------------

    def write(self, name: str, batch: FeatureBatch) -> None:
        self.transient.write(name, batch)

    def delete(self, name: str, fid: str) -> None:
        self.transient.delete(name, fid)

    # -- persistence tick --------------------------------------------------

    def persist(self, name: str, now: Optional[float] = None) -> int:
        """Move features older than persist_after_ms into the persistent
        store; returns how many were persisted."""
        self.transient.poll(name)
        cache = self.transient.cache(name)
        now = now if now is not None else time.time()
        cutoff = now - self.persist_after_ms / 1000.0
        snap = cache.snapshot()
        if snap is None:
            return 0
        with cache._lock:
            old = [fid for fid, ts in cache._stamps.items() if ts < cutoff]
        if not old:
            return 0
        fids = snap.fids.decode() if snap.fids is not None else []
        old_set = set(old)
        idx = [i for i, f in enumerate(fids) if f in old_set]
        if not idx:
            return 0
        moving = snap.select(np.asarray(idx))
        self.persistent.get_feature_source(name).write(moving)
        for fid in old:
            self.transient.delete(name, fid)
        self.transient.poll(name)
        return len(idx)

    # -- merged reads ------------------------------------------------------

    def get_features(self, query: "Query | str") -> QueryResult:
        """Query both tiers; merge feature results with transient-wins
        dedupe by fid.

        Aggregation hints (density/stats/bin/arrow) run over the MERGED
        deduped rows: both tiers are fetched as features with the same
        filter, deduped transient-wins,
        and the standard hint dispatcher (plan.runner.aggregate) runs on
        the merged batch — semantics identical to aggregating a single
        store holding the merged view. Trade: the merged rows come back
        to the host before aggregation (no per-tier partial aggregation;
        the transient tier is small by design, so the persistent tier's
        feature fetch dominates either way)."""
        if isinstance(query, str):
            raise TypeError("pass a Query(type_name, cql) to LambdaDataStore")
        if query.hints is not None and (
            query.hints.is_density or query.hints.is_stats
            or query.hints.is_bin or query.hints.is_arrow
        ):
            import dataclasses as _dc

            # strip ONLY the aggregation-kind fields: auths/sampling/etc
            # must survive into the tier fetches (a fresh QueryHints()
            # would fold visibility with EMPTY auths and hide rows the
            # caller is authorized to see)
            plain = _dc.replace(query, hints=_dc.replace(
                query.hints,
                density_bbox=None, density_width=None,
                density_height=None, density_weight=None,
                bin_track=None, bin_label=None,
                stats_string=None, arrow_encode=False,
            ))
            merged = self.get_features(plain)
            mb = merged.features
            sft = self.get_schema(query.type_name)
            if mb is None or not len(mb):
                mb = FeatureBatch.from_pydict(
                    sft, {a.name: [] for a in sft.attributes}
                )
            dev = to_device(mb, self.device)
            # visibility was folded by each tier's fetch
            result, _ = aggregate(
                sft, mb, dev, np.ones(len(mb), bool), query, self._calib)
            return result
        p = self.persistent.get_feature_source(query.type_name).get_features(query)
        t = self.transient.get_feature_source(query.type_name).get_features(query)
        if p.kind != "features":
            raise NotImplementedError(
                "aggregation hints over the merged lambda view are not "
                "supported; query a single tier"
            )
        return _merge_features(t, p)

    def get_count(self, query: "Query | str") -> int:
        r = self.get_features(query)
        return len(r.features) if r.features is not None else 0


def _merge_features(transient: QueryResult, persistent: QueryResult) -> QueryResult:
    tb = transient.features
    pb = persistent.features
    if tb is None or len(tb) == 0:
        return persistent
    if pb is None or len(pb) == 0:
        return transient
    tfids = set(tb.fids.decode()) if tb.fids is not None else set()
    if pb.fids is not None and tfids:
        keep = np.asarray([f not in tfids for f in pb.fids.decode()])
        pb = pb.select(np.nonzero(keep)[0])
    merged = FeatureBatch.concat([tb, pb]) if len(pb) else tb
    return QueryResult("features", features=merged, count=len(merged))
