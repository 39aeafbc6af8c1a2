"""ArrowDataStore: a read-oriented DataStore over Arrow IPC files.

A copy of the reference package's `store/arrow_store.py`, modelled on
geomesa-arrow's ArrowDataStore (read an Arrow IPC stream as a GeoTools
DataStore) [upstream, unverified]. The IPC files are the ones either
package writes (`core.arrow_io.write_ipc`, an Arrow export), carrying the SFT in schema metadata, so an exported
query result is immediately re-queryable: export -> hand the file around ->
open as a store. Writes go through `add_features` + `flush` (append
batches, rewrite the stream), matching upstream's file-granularity write
model.

Queries ride the STANDARD QueryPlanner over a duck-typed single-partition
storage, so the full surface — hints, interceptors, audit, visibility,
count shortcuts, consistent empty-result kinds — comes for free: the
compute layer does not care that the storage layer is a single file.
Queries run on `device` (None = the card, as everywhere in the port; pass
"cpu" to run on the CPU). The store has no device cache: each query
uploads the file's batch, and the kNN scans it with B1/B2.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence

from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.cql.extract import BBox, Interval
from geomesa_tpu_torch.engine.device import resolve_device
from geomesa_tpu_torch.plan.datastore import FeatureSource
from geomesa_tpu_torch.plan.planner import QueryPlanner
from geomesa_tpu_torch.store.fs import ManifestSnapshot


class _IpcStorage:
    """Duck-typed single-partition storage over one in-memory batch."""

    def __init__(self, sft: SimpleFeatureType, batch: FeatureBatch, root: str):
        self.sft = sft
        self.batch = batch
        # stats.json is never written for an IPC file; point the stats
        # manager somewhere that does not exist
        self.root = root + ".nostats"

    @property
    def count(self) -> int:
        return len(self.batch)

    def partitions(self) -> List[str]:
        return ["ipc"]

    def manifest_snapshot(self) -> ManifestSnapshot:
        """The one in-memory partition (the planner pins its plans to a
        snapshot; the count is the manifest estimate)."""
        return ManifestSnapshot({"ipc": [{"file": "ipc",
                                          "count": len(self.batch)}]})

    def prune_partitions(self, bbox: BBox, interval: Interval,
                         manifest=None) -> List[str]:
        return ["ipc"] if len(self.batch) else []

    def scan(
        self,
        bbox: Optional[BBox] = None,
        interval: Optional[Interval] = None,
        columns: Optional[Sequence[str]] = None,
    ) -> Iterator[FeatureBatch]:
        if len(self.batch):
            yield self.batch  # covering superset; residual mask follows


class ArrowFeatureSource(FeatureSource):
    def __init__(self, path: str, device=None):
        from geomesa_tpu_torch.core.arrow_io import read_ipc

        self.path = path
        batches = read_ipc(path)
        if not batches:
            raise ValueError(f"empty arrow stream: {path}")
        batch = (
            FeatureBatch.concat(batches) if len(batches) > 1 else batches[0]
        )
        storage = _IpcStorage(batch.sft, batch, path)
        super().__init__(storage, QueryPlanner(storage, resolve_device(device)))
        self._pending: List[FeatureBatch] = []

    def __len__(self) -> int:
        return len(self.storage.batch)

    # -- writes (file-granularity append) ----------------------------------

    def write(self, batch: FeatureBatch) -> None:
        self.add_features(batch)
        self.flush()

    def add_features(self, batch: FeatureBatch) -> None:
        if batch.sft.to_spec() != self.sft.to_spec():
            raise ValueError("schema mismatch on arrow append")
        self._pending.append(batch)

    def flush(self) -> None:
        """Rewrite the stream with appended batches (IPC streams are not
        appendable in place; upstream's writer also rewrites)."""
        from geomesa_tpu_torch.core.arrow_io import write_ipc

        if not self._pending:
            return
        self.storage.batch = FeatureBatch.concat(
            [self.storage.batch] + self._pending
        )
        self._pending = []
        tmp = self.path + ".tmp"
        # single-writer store by contract: the rewrite is the ingest path,
        # which runs before a store is served
        write_ipc(tmp, [self.storage.batch])
        os.replace(tmp, self.path)


class ArrowDataStore:
    """Catalog over a directory of `.arrow` IPC files (or one file). Each
    file is one feature type, named by the SFT in its metadata; queries
    run on `device` (None = the card)."""

    def __init__(self, path: str, device=None):
        self.path = path
        self._sources: Dict[str, ArrowFeatureSource] = {}
        if os.path.isdir(path):
            files = [
                os.path.join(path, fn)
                for fn in sorted(os.listdir(path))
                if fn.endswith(".arrow")
            ]
        else:
            files = [path]
        for fp in files:
            src = ArrowFeatureSource(fp, device)
            self._sources[src.sft.name] = src

    def get_feature_source(self, name: Optional[str] = None) -> ArrowFeatureSource:
        if name is None:
            if len(self._sources) != 1:
                raise ValueError("name required: store has multiple types")
            return next(iter(self._sources.values()))
        return self._sources[name]

    def get_schema(self, name: str) -> SimpleFeatureType:
        return self._sources[name].sft

    def get_type_names(self) -> List[str]:
        return sorted(self._sources)
