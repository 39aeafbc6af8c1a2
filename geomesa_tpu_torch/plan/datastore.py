"""DataStore / FeatureSource: the GeoTools-shaped entry API of the port.

The counterpart of the reference package's `plan/datastore.py`:

    ds = DataStore(catalog_dir, use_device_cache=True)   # on the card
    src = ds.create_schema(sft)
    src.write(batch)
    src.get_count("BBOX(geom, ...) AND dtg > ... AND speed > 5.0")
    dists, idx, batch = src.knn(cql, qx, qy, k=10)
    rows = src.get_features(Query(name, cql, attributes=["speed", "geom"],
                                  sort_by=[("dtg", False)])).features
    grid = src.get_features(Query(name, cql, hints=QueryHints(
        density_bbox=bbox, density_width=512, density_height=512))).grid

A catalog is a directory; each schema is a FileSystemStorage
subdirectory in the reference's on-disk format, partitioned by date when
the schema has a dtg and else by its geometry (Z2 for points, XZ2
otherwise), as the reference partitions it. `device=None` means the
card: it raises `CudaUnavailableError` when there is none (pass
device="cpu" to run on the CPU). `audit` collects a QueryEvent per
executed query and, under `serve.QueryService`, a ServeEvent per served
request (an in-memory `AuditWriter` by default, as in the reference).

Each type's planner loads the interceptors its schema names
(`geomesa.query.interceptors`, `plan/interceptor.py`) and stages
coordinates in the `geomesa.coord.dtype` dtype, on both routes.
`write_batch` is the columnar bulk ingest (Arrow record batches or IPC
bytes, the wire's `op=ingest`).

The lifecycle is the reference's: `FeatureSource.delete_features` and
`age_off` rewrite the touched files (exact f64 host evaluation) and
invalidate the stats sketches, which cannot un-observe a row;
`DataStore.remove_schema` drops a type's files, its residency and its
captured ring graphs.

`DataStore(catalog, use_device_cache=True, mesh=m)` or `ds.set_mesh(m)`
(`parallel.mesh.Mesh`, e.g. `default_mesh(["cpu"] * 4)` here or every
card there) makes a point store's residency the mesh tier: kNN windows
run on every shard and merge (`plan/planner.py`), with the single-device
answers.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, List, Optional, Union

import torch

from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.engine.device import resolve_device
from geomesa_tpu_torch.plan.interceptor import load_interceptors
from geomesa_tpu_torch.plan.audit import AuditWriter
from geomesa_tpu_torch.plan.explain import Explainer
from geomesa_tpu_torch.plan.planner import QueryPlanner, QueryResult
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.store.cache import DeviceCacheManager
from geomesa_tpu_torch.store.fs import METADATA, FileSystemStorage
from geomesa_tpu_torch.store.partition import (
    DateTimeScheme, PartitionScheme, XZ2Scheme, Z2Scheme)


class FeatureSource:
    def __init__(self, storage: FileSystemStorage, planner: QueryPlanner):
        self.storage = storage
        self.planner = planner

    @property
    def sft(self) -> SimpleFeatureType:
        return self.storage.sft

    def get_features(self, query: "Query | str" = "INCLUDE") -> QueryResult:
        """Run a query and return its QueryResult: kind "features" (the
        matching rows, sorted, limited and projected as the query asks;
        None when no row matched) or, with a density hint, kind
        "density"."""
        if isinstance(query, str):
            query = Query(self.sft.name, query)
        return self.planner.execute(query)

    def get_count(self, query: "Query | str" = "INCLUDE") -> int:
        if isinstance(query, str):
            query = Query(self.sft.name, query)
        return self.planner.count(query)

    def write(self, batch: FeatureBatch) -> None:
        """Append the batch, then fold it into the stats sketches (the
        write-path StatUpdater), so estimates are live with no analyze."""
        self.storage.write(batch)
        self.planner.update_stats(batch)

    def delete_features(self, cql: str) -> int:
        """Delete features matching an ECQL filter (the filter is
        required: pass "INCLUDE" to delete everything). Sketch stats
        cannot un-observe, so they are invalidated (estimates fall back
        until the next analyze or write). Returns rows deleted."""
        n = self.storage.delete_features(cql)
        if n:
            self.planner.stats_manager().invalidate()
        return n

    def age_off(self, older_than_ms: int) -> int:
        """Delete features whose dtg is before the cutoff. Returns rows
        deleted."""
        n = self.storage.age_off(older_than_ms)
        if n:
            self.planner.stats_manager().invalidate()
        return n

    def knn(self, query: "Query | str", qx, qy, k: int = 10,
            impl: str = "sparse"):
        """kNN push-down: device mask + fused scan (QueryPlanner.knn);
        impl "sparse", "fullscan" or "auto" (chosen from the stats
        sketches). Returns (dists, indices, batch)."""
        return self.planner.knn(query, qx, qy, k=k, impl=impl)

    def explain(self, query: "Query | str") -> str:
        if isinstance(query, str):
            query = Query(self.sft.name, query)
        e = Explainer()
        self.planner.plan(query, e)
        return e.render()


class DataStore:
    """A catalog of feature types over a directory, served on `device`."""

    def __init__(self, catalog: str, use_device_cache: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 audit: Optional[AuditWriter] = None, mesh=None):
        self.catalog = catalog
        self.device = resolve_device(device)
        self.audit = audit if audit is not None else AuditWriter()
        self.use_device_cache = use_device_cache
        # the serving mesh (`parallel.mesh.Mesh`): with the device cache
        # on, a point store's residency is the mesh tier (`set_mesh`)
        self.mesh = mesh
        os.makedirs(catalog, exist_ok=True)
        self._sources: Dict[str, FeatureSource] = {}
        # one planner (and one device cache) per type, even when sources
        # are resolved from several threads at once
        self._lock = threading.Lock()

    def _source(self, storage: FileSystemStorage) -> FeatureSource:
        with self._lock:
            mesh = self.mesh
        planner = QueryPlanner(storage, self.device, audit=self.audit,
                               mesh=mesh)
        planner.interceptors.extend(load_interceptors(storage.sft))
        if self.use_device_cache:
            # the scan path's coordinate dtype, or the routes' results
            # diverge for points near predicate boundaries
            planner.cache = DeviceCacheManager(
                storage, self.device, coord_dtype=planner.coord_dtype,
                mesh=mesh)
        return FeatureSource(storage, planner)

    def set_mesh(self, mesh) -> None:
        """Install a serving mesh on this store (None clears it): new
        sources take it at their planner's construction, existing ones
        re-tier their device cache at the next superbatch
        (`DeviceCacheManager.set_mesh`). `serve.QueryService` calls this
        when `ServeConfig.mesh` resolves to a mesh."""
        with self._lock:
            self.mesh = mesh
            sources = list(self._sources.values())
        for src in sources:
            src.planner.mesh = mesh
            if src.planner.cache is not None:
                src.planner.cache.set_mesh(mesh)

    def get_type_names(self) -> List[str]:
        return [name for name in sorted(os.listdir(self.catalog))
                if os.path.exists(os.path.join(self.catalog, name, METADATA))]

    def create_schema(self, sft: SimpleFeatureType,
                      scheme: Optional[PartitionScheme] = None,
                      encoding: str = "parquet") -> FeatureSource:
        """A new schema's store: `scheme` defaults to the dtg's days, or
        without a dtg to `_default_spatial_scheme`; `encoding` "parquet"
        or "orc"."""
        if scheme is None:
            scheme = (DateTimeScheme(dtg_attr=sft.default_dtg.name)
                      if sft.default_dtg is not None
                      else _default_spatial_scheme(sft))
        storage = FileSystemStorage.create(
            os.path.join(self.catalog, sft.name), sft, scheme, encoding)
        src = self._source(storage)
        with self._lock:
            self._sources[sft.name] = src
        return src

    def write_batch(self, type_name: str, data) -> "tuple[int, int]":
        """Columnar bulk ingest: `data` is a pyarrow RecordBatch, a list
        of them, or Arrow IPC stream bytes (the wire's `op=ingest`
        payload). Column buffers decode as NumPy views, with no
        per-feature dicts between the wire and the store. Returns (rows,
        batches) written."""
        from geomesa_tpu_torch.core.arrow_io import (
            from_arrow, ipc_feature_batches)

        src = self.get_feature_source(type_name)
        if isinstance(data, (bytes, bytearray, memoryview)):
            fbs = ipc_feature_batches(bytes(data), src.sft)
        elif isinstance(data, (list, tuple)):
            fbs = (from_arrow(rb, src.sft) for rb in data)
        else:
            fbs = (from_arrow(data, src.sft),)
        rows = batches = 0
        for fb in fbs:
            src.write(fb)
            rows += len(fb)
            batches += 1
        return rows, batches

    def get_feature_source(self, name: str) -> FeatureSource:
        with self._lock:
            src = self._sources.get(name)
        if src is not None:
            return src
        src = self._source(FileSystemStorage.load(os.path.join(self.catalog, name)))
        with self._lock:
            # first builder wins: every caller shares one planner per type
            return self._sources.setdefault(name, src)

    def get_schema(self, name: str) -> SimpleFeatureType:
        return self.get_feature_source(name).sft

    def remove_schema(self, name: str) -> None:
        """Delete a type: its files, and with them its device residency
        and the ring graphs captured over it (a service still open on it
        releases its ring programs when it closes)."""
        from geomesa_tpu_torch.compilecache.registry import registry

        with self._lock:
            src = self._sources.pop(name, None)
        if src is not None:
            registry.drop_owner(src.planner)
            if src.planner.cache is not None:
                src.planner.cache.invalidate()
        path = os.path.join(self.catalog, name)
        if not os.path.exists(os.path.join(path, METADATA)):
            raise FileNotFoundError(f"no schema {name!r} in catalog")
        shutil.rmtree(path)


def _default_spatial_scheme(sft: SimpleFeatureType) -> PartitionScheme:
    """Z2 (2 bits) for a point default geometry, XZ2 (g=2) otherwise."""
    g = sft.default_geometry
    if g is not None and g.type == "Point":
        return Z2Scheme(bits=2, geom_attr=g.name)
    if g is not None:
        return XZ2Scheme(g=2, geom_attr=g.name)
    raise ValueError("schema has neither dtg nor geometry; supply a scheme")
