"""KVDataStore: the index-architecture datastore over an IndexAdapter.

Parity: GeoMesaDataStore over a KV backend — the Accumulo/HBase-shaped
path (SURVEY.md §3.1/§3.2): writes fan out to every enabled index's key
schema; reads run FilterSplitter -> StrategyDecider -> range scan ->
residual compiled-mask evaluation on device -> local runner. With the
MemoryIndexAdapter this is also the TestGeoMesaDataStore analog (§4): the
full planner/index/aggregation stack with no cluster.

Differences from the FS store (plan/datastore.py): the FS store prunes
*partitions* (file layout); this store scans *key ranges* (row layout) —
the two index disciplines of the reference, both ending in the same device
residual + aggregation pipeline (plan/runner.py).

A copy of the reference package's `index/kvstore.py`, on the port's
device. `KVDataStore(device=None)` means the card (`CudaUnavailableError`
without one; pass device="cpu" for the CPU). The residual is the compiled
f32 mask with its f64 band re-decided (`CompiledFilter.mask_refined`:
B4/B5 on a polygon literal), then the sampling hint, then the query's
feature-level visibility folded in (the port's `aggregate` does not fold
it: the planner does, and this source has no planner), then
`plan.runner.aggregate` with the source's own zsparse calibration cache
(density: B3).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.cql import ast, compile_filter
from geomesa_tpu_torch.engine.device import VALID, fetch, resolve_device, to_device
from geomesa_tpu_torch.faults import BREAKERS, RetryPolicy, retry_call
from geomesa_tpu_torch.faults import harness as _faults
from geomesa_tpu_torch.index.adapter import IndexAdapter, MemoryIndexAdapter
from geomesa_tpu_torch.index.keyspace import IndexKeySpace, default_indices
from geomesa_tpu_torch.index.splitter import FilterSplitter, StrategyDecider
from geomesa_tpu_torch.plan.explain import Explainer
from geomesa_tpu_torch.plan.interceptor import load_interceptors, run_interceptors
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.plan.runner import (
    CalibCache, aggregate, sample_mask, visibility_mask)
from geomesa_tpu_torch.utils.padding import next_pow2 as _next_pow2


# KV boundary fault sites (docs/ROBUSTNESS.md). Range scans are
# idempotent reads and retry against the storage breaker; the write
# transaction is DELIBERATELY non-retryable — on a durable adapter the
# failed transaction rolls back atomically, and the documented contract
# is "discard the source and reopen" (docstring below), which a blind
# replay inside half-advanced in-memory bookkeeping would violate
# (.gmtpu-waivers records this).
_KV_SCAN_SITE = _faults.site(
    "kvstore.scan", "index range scan (IndexAdapter.scan)")
_KV_WRITE_SITE = _faults.site(
    "kvstore.write", "index write transaction (fan-out + row store)")
_KV_RETRY = RetryPolicy(max_attempts=4, base_ms=5.0, cap_ms=250.0)


class KVFeatureSource:
    def __init__(
        self,
        sft: SimpleFeatureType,
        adapter: IndexAdapter,
        indices: Sequence[IndexKeySpace],
        device: torch.device,
    ):
        self.sft = sft
        self.adapter = adapter
        self.indices = list(indices)
        self.splitter = FilterSplitter(self.indices)
        self.decider = StrategyDecider(adapter)
        self.device = device
        # the zsparse calibrations of this source's density queries
        self._calib = CalibCache()
        # QueryInterceptor SPI (plan/interceptor.py), per feature type as
        # in the reference; SFT-configured interceptors load here too
        self.interceptors: List = load_interceptors(sft)
        for idx in self.indices:
            adapter.create_index(getattr(idx, "full_name", idx.name))
        # row storage: append-only batches with cumulative offsets
        self._batches: List[FeatureBatch] = []
        self._fids: List[List[str]] = []
        self._offsets: List[int] = [0]
        self._fid_row: Dict[str, int] = {}
        self._dead: set = set()
        self._seq = 0
        # a durable adapter (index/durable.py) also persists the row store;
        # restore batches / tombstones / fid map from it on (re)open
        self._durable = hasattr(adapter, "load_batches")
        if self._durable:
            from geomesa_tpu_torch.index.durable import ipc_to_batch

            for ipc, fids in adapter.load_batches():
                batch = ipc_to_batch(ipc, self.sft)
                base = self._offsets[-1]
                self._batches.append(batch)
                self._fids.append(list(fids))
                self._offsets.append(base + len(batch))
            self._dead = adapter.load_dead()
            for b, fids in enumerate(self._fids):
                for i, f in enumerate(fids):
                    r = self._offsets[b] + i
                    if r not in self._dead:
                        self._fid_row[f] = r
            self._seq = int(adapter.meta_get("seq", "0"))

    # -- writes ------------------------------------------------------------

    def write(self, batch: FeatureBatch, fids: Optional[Sequence[str]] = None) -> List[str]:
        """Index + store a batch; same-fid writes replace (upstream:
        idempotent same-key overwrite, §5.3). Returns the feature ids.

        Padding rows (valid=False) are compacted away first: they are a
        device-shape artifact, and storing them would also desync the
        durable row store (Arrow IPC persists valid rows only).

        Failure contract (§5.3 fail-fast): on a durable adapter the disk
        transaction rolls back atomically, but in-memory bookkeeping may
        have advanced — discard this source and reopen the store after a
        write exception; the reopened state is the pre-write state."""
        if batch.valid is not None and not bool(batch.valid.all()):
            keep = np.nonzero(batch.valid)[0]
            if fids is not None:
                fids = [fids[int(i)] for i in keep]
            batch = batch.select(keep)
        n = len(batch)
        if fids is None:
            fids = batch.fids.decode() if batch.fids is not None else None
        if fids is None:
            fids = [f"{self.sft.name}-{self._seq + i}" for i in range(n)]
        fids = [str(f) for f in fids]
        self._seq += n

        # the whole logical write — tombstoning replaced fids, the row
        # batch, every index's keys, and the fid sequence — commits as one
        # transaction on durable adapters: a crash leaves all or nothing
        import contextlib

        txn = (
            self.adapter.transaction()
            if self._durable
            else contextlib.nullcontext()
        )
        with txn:
            _KV_WRITE_SITE.fire()
            # replace-by-id: tombstone + de-index any previous row per fid
            stale = [self._fid_row[f] for f in fids if f in self._fid_row]
            if stale:
                self._delete_rows(stale)

            base = self._offsets[-1]
            rows = list(range(base, base + n))
            self._batches.append(batch)
            self._fids.append(list(fids))
            self._offsets.append(base + n)
            for i, f in enumerate(fids):
                self._fid_row[f] = base + i
            if self._durable:
                from geomesa_tpu_torch.index.durable import batch_to_ipc

                self.adapter.store_batch(batch_to_ipc(batch), fids)
            for idx in self.indices:
                name = getattr(idx, "full_name", idx.name)
                self.adapter.write(name, idx.write_keys(batch, fids, rows))
            if self._durable:
                self.adapter.meta_set("seq", str(self._seq))
        return list(fids)

    def _locate(self, row: int):
        b = bisect.bisect_right(self._offsets, row) - 1
        return b, row - self._offsets[b]

    def _delete_rows(self, rows: Sequence[int]) -> None:
        import contextlib

        # atomic on durable adapters (reentrant: write() already holds the
        # transaction on the replace-by-id path)
        txn = (
            self.adapter.transaction()
            if self._durable
            else contextlib.nullcontext()
        )
        with txn:
            by_batch: Dict[int, List[int]] = {}
            newly_dead: List[int] = []
            for r in rows:
                if r in self._dead:
                    continue
                b, i = self._locate(r)
                by_batch.setdefault(b, []).append(i)
                self._dead.add(r)
                newly_dead.append(r)
            if self._durable and newly_dead:
                self.adapter.mark_dead(newly_dead)
            for b, local in by_batch.items():
                sel = self._batches[b].select(np.asarray(sorted(local)))
                fids = [self._fids[b][i] for i in sorted(local)]
                rows_abs = [self._offsets[b] + i for i in sorted(local)]
                for idx in self.indices:
                    name = getattr(idx, "full_name", idx.name)
                    keys = [wk.key for wk in idx.write_keys(sel, fids, rows_abs)]
                    self.adapter.delete(name, keys)
                for f in fids:
                    if self._fid_row.get(f) in rows_abs:
                        del self._fid_row[f]

    def age_off(self, ttl_ms: int, now_ms: Optional[int] = None) -> int:
        """Delete features older than ttl (upstream: DtgAgeOffIterator /
        AgeOffIterator TTL enforcement, run as a maintenance sweep rather
        than scan-time filtering). Returns the number removed."""
        import time as _time

        d = self.sft.default_dtg
        if d is None:
            raise ValueError("age_off needs a default dtg attribute")
        now = now_ms if now_ms is not None else int(_time.time() * 1000)
        cutoff = now - int(ttl_ms)
        rows = []
        for b, batch in enumerate(self._batches):
            dtg = np.asarray(batch.columns[d.name], np.int64)
            for i in np.nonzero(dtg < cutoff)[0]:
                r = self._offsets[b] + int(i)
                if r not in self._dead:
                    rows.append(r)
        self._delete_rows(rows)
        return len(rows)

    def delete_features(self, query: "Query | str") -> int:
        """Delete everything matching the filter (upstream delete-features)."""
        r = self.get_features(query if not isinstance(query, str)
                              else Query(self.sft.name, query))
        if r.features is None or len(r.features) == 0:
            return 0
        fids = r.features.fids.decode() if r.features.fids is not None else []
        rows = [self._fid_row[f] for f in fids if f in self._fid_row]
        self._delete_rows(rows)
        return len(rows)

    # -- reads -------------------------------------------------------------

    @property
    def live_count(self) -> int:
        return self._offsets[-1] - len(self._dead)

    def _all_rows(self) -> List[int]:
        return [r for r in range(self._offsets[-1]) if r not in self._dead]

    def _gather(self, rows: Sequence[int]) -> FeatureBatch:
        by_batch: Dict[int, List[int]] = {}
        for r in sorted(rows):
            b, i = self._locate(r)
            by_batch.setdefault(b, []).append(i)
        parts = []
        for b in sorted(by_batch):
            idx = np.asarray(by_batch[b])
            sel = self._batches[b].select(idx)
            sel = FeatureBatch(
                sel.sft, sel.columns,
                DictColumn.encode([self._fids[b][i] for i in by_batch[b]]),
                sel.valid,
            )
            parts.append(sel)
        return FeatureBatch.concat(parts)

    def plan(self, query: "Query | str", explain: Optional[Explainer] = None):
        if isinstance(query, str):
            query = Query(self.sft.name, query)
        e = explain if explain is not None else Explainer()
        query = run_interceptors(query, self.interceptors, e)
        f = query.filter_ast
        e(f"Planning KV query: {ast.to_cql(f)}")
        options = self.splitter.options(f)
        e(f"Index options: {[o.name for o in options] or 'none (full scan)'}")
        chosen = self.decider.decide(options, query.hints.query_index, e)
        if chosen is not None:
            e(f"Chosen index: {chosen.name} with {len(chosen.ranges)} ranges "
              f"(~{chosen.cost} keys)")
        return query, f, chosen

    def explain(self, query: "Query | str") -> str:
        e = Explainer()
        self.plan(query, e)
        return e.render()

    def get_features(self, query: "Query | str" = "INCLUDE"):
        from geomesa_tpu_torch.plan.planner import QueryResult, _loosen_bbox

        query, f, chosen = self.plan(query)
        if chosen is not None:
            name = chosen.name

            def _scan():
                _KV_SCAN_SITE.fire()
                return [
                    r for r in self.adapter.scan(name, chosen.ranges)
                    if r not in self._dead
                ]

            rows = retry_call(_scan, policy=_KV_RETRY, label="storage",
                              breaker=BREAKERS.get("storage"))
        else:
            rows = self._all_rows()
        if not rows:
            return QueryResult("features", features=None, count=0)

        batch = self._gather(rows)
        padded = batch.pad_to(_next_pow2(len(batch)))
        dev = to_device(padded, self.device)
        if isinstance(f, ast.Include):
            (mask,) = fetch(dev[VALID])
        else:
            residual = f
            if query.hints.loose_bbox:
                g = self.sft.default_geometry
                if g is not None:
                    residual = _loosen_bbox(f, g.name)
            compiled = compile_filter(residual, self.sft)
            # mask_refined: f64 re-check of rows inside the f32 polygon
            # boundary band (no-op for band-free filters)
            mask = compiled.mask_refined(dev, padded)
        if query.hints.sampling:
            groups = None
            if query.hints.sample_by:
                col = padded.columns[query.hints.sample_by]
                groups = (
                    np.asarray(col.codes)
                    if isinstance(col, DictColumn)
                    else np.asarray(col)
                )
            mask = sample_mask(mask, query.hints.sampling, groups)
        # feature-level visibility, after sampling as in the reference
        # (whose aggregate folds it): every result kind hides the rows
        # the auths cannot see
        vm = visibility_mask(self.sft, padded, dev, query.hints)
        if vm is not None:
            (vm,) = fetch(vm)
            mask = mask & vm
        result, _ = aggregate(self.sft, padded, dev, mask, query, self._calib)
        return result

    def get_count(self, query: "Query | str" = "INCLUDE") -> int:
        if isinstance(query, str):
            query = Query(self.sft.name, query)
        # the shortcut must see the post-interceptor query; the intercepted
        # marker makes the nested get_features -> plan pass a no-op, so the
        # chain applies exactly once (no idempotence requirement)
        query = run_interceptors(query, self.interceptors)
        if (
            not query.hints.exact_count
            and isinstance(query.filter_ast, ast.Include)
            # live_count knows nothing about auths: visibility-configured
            # types count through the masked aggregation path
            and not (self.sft.user_data or {}).get("geomesa.vis.attr")
        ):
            return self.live_count
        r = self.get_features(query)
        if r.kind == "features":
            return len(r.features) if r.features is not None else 0
        return r.count

    def get_features_by_id(self, fids: Sequence[str]) -> FeatureBatch:
        rows = [self._fid_row[f] for f in fids if f in self._fid_row]
        if rows:
            return self._gather(rows)
        # well-formed empty batch (proper empty GeometryColumn/DictColumn)
        return FeatureBatch.from_pydict(
            self.sft, {a.name: [] for a in self.sft.attributes}
        )


class KVDataStore:
    """A catalog of KV-indexed feature types (in-memory by default), whose
    residual masks and aggregations run on `device` (None: the card)."""

    def __init__(self, adapter_factory=MemoryIndexAdapter, device=None):
        self.device = resolve_device(device)
        self._adapter_factory = adapter_factory
        self._sources: Dict[str, KVFeatureSource] = {}

    def create_schema(
        self,
        sft: SimpleFeatureType,
        indices: Optional[Sequence[IndexKeySpace]] = None,
    ) -> KVFeatureSource:
        if sft.name in self._sources:
            raise ValueError(f"schema {sft.name!r} already exists")
        adapter = self._adapter_factory()
        if indices is None:
            indices = default_indices(sft)
        src = KVFeatureSource(sft, adapter, indices, self.device)
        self._sources[sft.name] = src
        return src

    def get_feature_source(self, name: str) -> KVFeatureSource:
        return self._sources[name]

    def get_schema(self, name: str) -> SimpleFeatureType:
        return self._sources[name].sft

    def get_type_names(self) -> List[str]:
        return sorted(self._sources)

    def remove_schema(self, name: str) -> None:
        del self._sources[name]
