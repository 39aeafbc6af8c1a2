"""KafkaDataStore: topic-per-type live layer over a pluggable broker.

Parity: geomesa-kafka KafkaDataStore [upstream, unverified]: writers produce
GeoMessages to one topic per feature type; consumers fold them into a
KafkaFeatureCache; queries are served from memory. The broker is pluggable:
`InProcessBroker` (default) is an in-process append-only log with offsets —
the "embedded broker" testing idea from the reference's test strategy — and
a real Kafka client could implement the same two methods.

Queries ride the standard QueryPlanner via a MemoryStorage adapter, so the
live layer supports the full hint surface (density/stats/bin/sampling) on
the latest snapshot: host upserts, device analytics (SURVEY.md C12).

A copy of the reference package's `kafka/store.py`, on the port's
device: `KafkaDataStore(device=None)` means the card
(`CudaUnavailableError` without one; pass device="cpu" for the CPU). Its
planner runs over `MemoryStorage`, which has no manifest: the planner
prunes through `prune_partitions(bbox, interval)` and an INCLUDE count
carries no version, as in the reference. As there, `get_features` and
`get_count` poll the topic first and `knn` (FeatureSource's) does not,
so a kNN sees the state of the last poll. `mesh=` reaches each type's
planner, as in the reference (the live layer keeps no device cache, so
its queries run on one device).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.core.wkt import Geometry, point
from geomesa_tpu_torch.cql import ast, parse_cql
from geomesa_tpu_torch.cql.extract import BBox, Interval
from geomesa_tpu_torch.engine.device import resolve_device
from geomesa_tpu_torch.faults import BREAKERS, RetryPolicy, retry_call
from geomesa_tpu_torch.faults import harness as _faults
from geomesa_tpu_torch.kafka.cache import KafkaFeatureCache
from geomesa_tpu_torch.kafka.messages import (
    Change,
    Clear,
    Delete,
    GeoMessageSerializer,
)
from geomesa_tpu_torch.plan.audit import AuditWriter, QueryEvent
from geomesa_tpu_torch.plan.datastore import FeatureSource
from geomesa_tpu_torch.plan.planner import QueryPlanner, QueryResult
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.plan.runner import finish_features


# broker-boundary fault sites + retry policy (docs/ROBUSTNESS.md): a
# real Kafka client drops connections and rebalances; the in-process
# broker never does — the harness makes those failure modes injectable
# on the exact code path a real client would take. Retries run OUTSIDE
# the store lock (see poll) so a flapping broker never stalls other
# topics' consumers behind a backoff sleep.
_POLL_SITE = _faults.site(
    "kafka.poll", "broker consume (offset window read)")
_PRODUCE_SITE = _faults.site(
    "kafka.produce", "broker produce (one GeoMessage)")
_KAFKA_RETRY = RetryPolicy(max_attempts=4, base_ms=5.0, cap_ms=200.0)


class InProcessBroker:
    """Append-only log per topic with consumer offsets (embedded broker)."""

    def __init__(self):
        self._topics: Dict[str, List[bytes]] = {}
        self._lock = threading.Lock()

    def produce(self, topic: str, payload: bytes) -> int:
        with self._lock:
            log = self._topics.setdefault(topic, [])
            log.append(payload)
            return len(log) - 1

    def consume(self, topic: str, offset: int) -> List[bytes]:
        with self._lock:
            log = self._topics.get(topic, [])
            return log[offset:]

    def end_offset(self, topic: str) -> int:
        with self._lock:
            return len(self._topics.get(topic, []))


class MemoryStorage:
    """Duck-typed storage over a KafkaFeatureCache snapshot, so the standard
    QueryPlanner (and its full hint surface) runs against live state."""

    def __init__(self, sft: SimpleFeatureType, cache: KafkaFeatureCache):
        self.sft = sft
        self.cache = cache
        # stats.json is never written for a live layer; point the stats
        # manager at a directory that does not exist
        self.root = os.path.join(".", f".geomesa-live-{sft.name}-nostats")

    @property
    def count(self) -> int:
        return len(self.cache)

    def partitions(self) -> List[str]:
        return ["live"]

    def prune_partitions(self, bbox: BBox, interval: Interval) -> List[str]:
        return ["live"] if len(self.cache) else []

    def scan(
        self,
        bbox: Optional[BBox] = None,
        interval: Optional[Interval] = None,
        columns: Optional[Sequence[str]] = None,
    ) -> Iterator[FeatureBatch]:
        snap = self.cache.snapshot()
        if snap is None:
            return
        yield snap  # covering superset; residual mask is the engine's job


class KafkaFeatureSource(FeatureSource):
    """FeatureSource whose writes produce GeoMessages and whose reads fold
    the topic into the cache first (lazy consume on query)."""

    def __init__(self, store: "KafkaDataStore", name: str):
        self._store = store
        self._name = name
        state = store._state[name]
        super().__init__(
            state["storage"],
            QueryPlanner(state["storage"], store.device, audit=store.audit,
                         mesh=store.mesh),
        )

    def write(self, batch: FeatureBatch) -> None:
        self._store.write(self._name, batch)

    def _attr_fast_path(self, query: Query):
        """Serve `attr = 'v'` / `attr IN (...)` on an INDEXED attribute
        straight from the cache's hash index (the CQEngine analog,
        SURVEY.md:323-324) — no snapshot build, no device round trip.
        Only plain feature fetches qualify; every hint/sort/aggregation
        falls through to the full planner path."""
        h = query.hints
        if (
            h != type(h)()  # any non-default hint
            or query.sort_by
            or query.attributes is not None
            or self.planner.interceptors  # must not bypass the chain
            # feature-level visibility rides the planner mask; the index
            # has no auth awareness, so it must not serve those types
            or (self.sft.user_data or {}).get("geomesa.vis.attr")
        ):
            return None
        f = query.filter_ast
        if isinstance(f, ast.Comparison) and f.op == "=":
            prop, lit = f.left, f.right
            if isinstance(prop, ast.Literal):
                prop, lit = lit, prop
            if not isinstance(prop, ast.Property) or not isinstance(lit, ast.Literal):
                return None
            name, values = prop.name, [lit.value]
        elif isinstance(f, ast.In) and not f.negate:
            name, values = f.prop.name, list(f.values)
        else:
            return None
        cache = self._store.cache(self._name)
        if name not in cache.indexed_attributes:
            return None
        import time as _time

        t0 = _time.perf_counter()
        rows = cache.query_attribute(name, values)
        if not rows:
            result = QueryResult("features", features=None, count=0)
        else:
            sft = self.sft
            data = {
                a.name: [row.get(a.name) for _, row in rows]
                for a in sft.attributes
            }
            batch = FeatureBatch.from_pydict(
                sft, data, fids=[fid for fid, _ in rows]
            )
            batch = finish_features(batch, query)
            result = QueryResult(
                "features", features=batch, count=len(batch)
            )
        # the fast path must not dodge the audit trail: these are the most
        # frequent live-layer queries
        audit = self._store.audit
        if audit is not None:
            dt = (_time.perf_counter() - t0) * 1000
            audit.write(
                QueryEvent(
                    type_name=query.type_name,
                    filter=ast.to_cql(query.filter_ast),
                    hints="attr-index-fast-path",
                    plan_time_ms=0.0,
                    scan_time_ms=dt,
                    compute_time_ms=0.0,
                    result_count=result.count,
                    partitions_scanned=1,
                    partitions_total=1,
                )
            )
        return result

    def get_features(self, query="INCLUDE"):
        self._store.poll(self._name)
        if isinstance(query, str):
            query = Query(self.sft.name, query)
        fast = self._attr_fast_path(query)
        if fast is not None:
            return fast
        return super().get_features(query)

    def get_count(self, query="INCLUDE") -> int:
        self._store.poll(self._name)
        return super().get_count(query)


class KafkaLayerView(KafkaFeatureSource):
    """Filtered/projected derived view over a live layer (read-only)."""

    def __init__(self, store, base_name, view_name, cql, attributes):
        super().__init__(store, base_name)
        self.view_name = view_name
        self.view_filter = parse_cql(cql) if isinstance(cql, str) else cql
        self.view_attributes = list(attributes) if attributes else None

    def _narrow(self, query):
        if isinstance(query, str):
            query = Query(self._name, query)
        f = query.filter_ast
        merged = (
            self.view_filter
            if isinstance(f, ast.Include)
            else ast.And((self.view_filter, f))
        )
        attrs = query.attributes
        if self.view_attributes is not None:
            attrs = (
                self.view_attributes
                if attrs is None
                else [a for a in attrs if a in self.view_attributes]
            )
        import dataclasses as _dc

        return _dc.replace(query, filter=merged, attributes=attrs)

    def write(self, batch) -> None:
        raise TypeError(f"layer view {self.view_name!r} is read-only")

    def get_features(self, query="INCLUDE"):
        return super().get_features(self._narrow(query))

    def get_count(self, query="INCLUDE") -> int:
        return super().get_count(self._narrow(query))


class KafkaDataStore:
    def __init__(
        self,
        broker: Optional[InProcessBroker] = None,
        audit: Optional[AuditWriter] = None,
        mesh=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.broker = broker if broker is not None else InProcessBroker()
        self.audit = audit if audit is not None else AuditWriter()
        self._state: Dict[str, dict] = {}
        # reentrant: schema registration and poll (consume -> cache fold
        # -> offset advance, one atomic unit per topic) run from query
        # threads AND the serve dispatch thread; a feature listener
        # calling back into the store must not self-deadlock
        self._lock = threading.RLock()
        # post-fold hooks (the standing queries' evaluator, ROADMAP A6):
        # invoked with the type name after a poll commits its window,
        # OUTSIDE the store lock — the evaluator dispatches device kernels
        # from here, which must never run under this lock (GT09)
        self._fold_hooks: List = []

    def add_fold_hook(self, fn) -> None:
        """Register `fn(type_name)` to run after every committed poll
        fold, outside the store lock."""
        with self._lock:
            self._fold_hooks.append(fn)

    def remove_fold_hook(self, fn) -> None:
        """Detach a fold hook (a closed SubscriptionManager must stop
        costing every future poll). Raises ValueError if absent."""
        with self._lock:
            self._fold_hooks.remove(fn)

    # -- schema ------------------------------------------------------------

    def create_schema(self, sft: SimpleFeatureType) -> KafkaFeatureSource:
        cache = KafkaFeatureCache(sft)
        with self._lock:
            self._state[sft.name] = {
                "sft": sft,
                "serializer": GeoMessageSerializer(sft),
                "cache": cache,
                "storage": MemoryStorage(sft, cache),
                "offset": 0,
            }
        return KafkaFeatureSource(self, sft.name)

    def get_type_names(self) -> List[str]:
        with self._lock:
            return sorted(self._state)

    def get_schema(self, name: str) -> SimpleFeatureType:
        with self._lock:
            return self._state[name]["sft"]

    def get_feature_source(self, name: str) -> KafkaFeatureSource:
        with self._lock:
            if name not in self._state:
                raise KeyError(f"no live schema {name!r}")
        return KafkaFeatureSource(self, name)

    def cache(self, name: str) -> KafkaFeatureCache:
        with self._lock:
            return self._state[name]["cache"]

    # -- layer views -------------------------------------------------------

    def create_layer_view(
        self,
        view_name: str,
        base_name: str,
        cql: str = "INCLUDE",
        attributes: Optional[List[str]] = None,
    ) -> "KafkaLayerView":
        """A derived read-only view of a live layer: the base layer's
        stream with a standing filter and/or projection (upstream: Kafka
        layer views, SURVEY.md C12). Views share the base cache — no data
        is duplicated; the view filter ANDs into every query."""
        with self._lock:
            if base_name not in self._state:
                raise KeyError(f"no live schema {base_name!r}")
        view = KafkaLayerView(self, base_name, view_name, cql, attributes)
        with self._lock:
            self._state[base_name].setdefault("views", {})[view_name] = view
        return view

    def get_layer_view(self, base_name: str, view_name: str) -> "KafkaLayerView":
        with self._lock:
            return self._state[base_name]["views"][view_name]

    # -- producer side -----------------------------------------------------

    def _produce(self, name: str, payload: bytes) -> int:
        """One broker produce under the recovery fabric: transient
        broker failures retry with backoff against the "kafka" breaker.
        Produces are latest-wins upserts keyed by fid, so a duplicate
        from an ambiguous failure (produced, then the ack was lost) is
        absorbed by the fold — retrying is safe."""

        def attempt():
            _PRODUCE_SITE.fire()
            return self.broker.produce(name, payload)

        return retry_call(attempt, policy=_KAFKA_RETRY, label="kafka",
                          breaker=BREAKERS.get("kafka"))

    def write(self, name: str, batch: FeatureBatch) -> None:
        """Produce one Change per feature (latest-wins upsert semantics)."""
        with self._lock:
            ser: GeoMessageSerializer = self._state[name]["serializer"]
        for fid, attrs in _batch_rows(batch):
            self._produce(name, ser.serialize(Change(fid, attrs)))

    def delete(self, name: str, fid: str) -> None:
        with self._lock:
            ser = self._state[name]["serializer"]
        self._produce(name, ser.serialize(Delete(fid)))

    def clear(self, name: str) -> None:
        with self._lock:
            ser = self._state[name]["serializer"]
        self._produce(name, ser.serialize(Clear()))

    # -- consumer side -----------------------------------------------------

    def poll(self, name: str) -> int:
        """Consume new messages into the cache; returns messages applied.
        The fold -> offset advance stays one atomic unit per topic: two
        query threads polling concurrently must not double-apply a
        message window (latest-wins would hide it for Change, not for
        Clear+replay interleavings) or skip one by racing the offset
        bump. The broker CONSUME (the part that can fail and back off)
        runs outside the lock against the pinned start offset; before
        folding, the offset is re-checked — if another poller applied a
        window meanwhile, this one discards its (now superseded) read
        instead of double-applying."""
        with self._lock:
            st = self._state[name]
            start = st["offset"]
            ser: GeoMessageSerializer = st["serializer"]
            cache: KafkaFeatureCache = st["cache"]

        def attempt():
            _POLL_SITE.fire()
            return self.broker.consume(name, start)

        msgs = retry_call(attempt, policy=_KAFKA_RETRY, label="kafka",
                          breaker=BREAKERS.get("kafka"))
        with self._lock:
            if st["offset"] != start:
                # a concurrent poll won the race and advanced the
                # offset; its fold covered log[start:its_end] — ours
                # would re-apply that prefix. The messages past its end
                # are picked up by the next poll (offset is authority).
                return 0
            for payload in msgs:
                cache.apply(ser.deserialize(payload))
            st["offset"] += len(msgs)
            hooks = list(self._fold_hooks)
        # post-fold hooks OUTSIDE the lock: the standing-query
        # evaluator pumps its delta buffer here (device dispatch); the
        # winner of the offset race is the only caller that reaches
        # this point, so one committed window pumps exactly once
        for hook in hooks:
            hook(name)
        return len(msgs)


def _batch_rows(batch: FeatureBatch) -> Iterator[Tuple[str, Dict[str, object]]]:
    """Iterate a columnar batch as (fid, attribute-dict) rows."""
    n = len(batch)
    fids = batch.fids.decode() if batch.fids is not None else [f"f{i}" for i in range(n)]
    cols = {}
    for a in batch.sft.attributes:
        col = batch.columns[a.name]
        if isinstance(col, GeometryColumn):
            if col.is_point:
                cols[a.name] = [point(float(x), float(y)) for x, y in zip(col.x, col.y)]
            else:
                cols[a.name] = [_extended_geom(col, i) for i in range(n)]
        elif isinstance(col, DictColumn):
            cols[a.name] = col.decode()
        else:
            arr = np.asarray(col)
            cols[a.name] = [v.item() if hasattr(v, "item") else v for v in arr]
    for i in range(n):
        yield str(fids[i]), {name: vals[i] for name, vals in cols.items()}


def _extended_geom(col: GeometryColumn, i: int) -> Geometry:
    return col.geometry(i)
