"""Filesystem (Parquet) storage: partitioned writes, pruned + pushed-down reads.

The counterpart of the reference package's `store/fs.py`, with the same
on-disk format, so either package loads a catalog the other wrote:

    <root>/metadata.json            sft spec + scheme config + manifest
    <root>/<partition>/<uuid>.parquet

Point geometry is stored as x/y float64 columns named <attr>__x/__y (so
row-group statistics prune on bbox); other geometries as WKT text plus
per-feature bbox columns <attr>__xmin/__ymin/__xmax/__ymax; strings as
dictionary columns, dates as int64 epoch millis. Compaction, deletes,
age-off, ORC files and the fault-injection/retry hooks come with a later
slice.
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads
import pyarrow.parquet as pq

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.core.wkt import parse_wkt, to_wkt
from geomesa_tpu_torch.cql.extract import BBox, Interval
from geomesa_tpu_torch.errors import NotPortedError
from geomesa_tpu_torch.store.partition import PartitionScheme, scheme_from_config

METADATA = "metadata.json"
FID = "__fid__"
# rows per scanned batch (the reference's geomesa.scan.batch.size default)
SCAN_BATCH_SIZE = 1 << 20

_STORE_SLICE = "the storage slice (ROADMAP Queue A, A5)"


class ManifestSnapshot(Dict[str, List[dict]]):
    """A partition->entries dict plus the commit version it was taken at."""

    version: int = 0


def _batch_to_table(batch: FeatureBatch) -> pa.Table:
    arrays: Dict[str, pa.Array] = {}
    for a in batch.sft.attributes:
        col = batch.columns[a.name]
        if isinstance(col, GeometryColumn):
            if col.is_point:
                arrays[f"{a.name}__x"] = pa.array(col.x, pa.float64())
                arrays[f"{a.name}__y"] = pa.array(col.y, pa.float64())
            else:
                arrays[a.name] = pa.array(
                    [to_wkt(col.geometry(i)) for i in range(len(col))],
                    pa.string())
                bb = col.bbox
                for j, suffix in enumerate(("xmin", "ymin", "xmax", "ymax")):
                    arrays[f"{a.name}__{suffix}"] = pa.array(bb[:, j], pa.float64())
        elif isinstance(col, DictColumn):
            codes = np.asarray(col.codes, np.int64)
            arrays[a.name] = pa.DictionaryArray.from_arrays(
                pa.array(codes, pa.int32(), mask=codes < 0),
                pa.array(col.vocab, pa.string()),
            )
        elif a.type == "Bytes":
            arrays[a.name] = pa.array(list(col), pa.binary())
        elif a.is_temporal:
            arrays[a.name] = pa.array(np.asarray(col, np.int64), pa.int64())
        else:
            arrays[a.name] = pa.array(col)
    if batch.fids is not None:
        codes = np.asarray(batch.fids.codes, np.int64)
        arrays[FID] = pa.DictionaryArray.from_arrays(
            pa.array(codes, pa.int32(), mask=codes < 0),
            pa.array(batch.fids.vocab, pa.string()),
        )
    return pa.table(arrays)


def _dict_column(col) -> DictColumn:
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if pa.types.is_dictionary(arr.type):
        codes = arr.indices.to_numpy(zero_copy_only=False)
        if codes.dtype.kind == "f":
            codes = np.where(np.isnan(codes), -1, codes)
        return DictColumn(codes.astype(np.int32), arr.dictionary.to_pylist())
    return DictColumn.encode(arr.to_pylist())


def _table_to_batch(t: pa.Table, sft: SimpleFeatureType) -> FeatureBatch:
    # projection support: narrow the SFT to the attributes present
    present = [
        a
        for a in sft.attributes
        if (a.name in t.schema.names)
        or (a.is_geometry and a.type == "Point" and f"{a.name}__x" in t.schema.names)
    ]
    if len(present) != len(sft.attributes):
        sft = SimpleFeatureType(sft.name, present, sft.user_data)
    cols: Dict[str, object] = {}
    for a in sft.attributes:
        if a.is_geometry:
            if a.type == "Point":
                cols[a.name] = GeometryColumn.from_points(
                    t.column(f"{a.name}__x").to_numpy(),
                    t.column(f"{a.name}__y").to_numpy())
            else:
                cols[a.name] = GeometryColumn.from_geometries(
                    [parse_wkt(w) for w in t.column(a.name).to_pylist()])
        elif a.type in ("String", "UUID"):
            cols[a.name] = _dict_column(t.column(a.name))
        elif a.type == "Bytes":
            cols[a.name] = np.array(t.column(a.name).to_pylist(), dtype=object)
        else:
            cols[a.name] = t.column(a.name).to_numpy()
    fids = _dict_column(t.column(FID)) if FID in t.schema.names else None
    return FeatureBatch(sft, cols, fids)


class FileSystemStorage:
    """A partitioned Parquet feature store."""

    def __init__(self, root: str, sft: SimpleFeatureType,
                 scheme: PartitionScheme, encoding: str = "parquet"):
        if encoding == "orc":
            raise NotPortedError("'orc' data files", _STORE_SLICE)
        if encoding != "parquet":
            raise ValueError(f"unknown encoding {encoding!r}")
        self.root = root
        self.sft = sft
        self.scheme = scheme
        self.encoding = encoding
        # manifest: partition -> list of {"file", "count"}
        self.manifest: Dict[str, List[dict]] = {}
        # guards the manifest (data files are immutable once written); the
        # version bumps on every committed write so snapshots are ordered
        self._lock = threading.Lock()
        self._mversion = 0

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, root: str, sft: SimpleFeatureType,
               scheme: PartitionScheme, encoding: str = "parquet"
               ) -> "FileSystemStorage":
        os.makedirs(root, exist_ok=True)
        if os.path.exists(os.path.join(root, METADATA)):
            raise FileExistsError(f"storage already exists at {root}")
        store = cls(root, sft, scheme, encoding)
        store._save_metadata()
        return store

    @classmethod
    def load(cls, root: str) -> "FileSystemStorage":
        with open(os.path.join(root, METADATA)) as f:
            meta = json.load(f)
        sft = SimpleFeatureType.from_spec(meta["name"], meta["spec"])
        store = cls(root, sft, scheme_from_config(meta["scheme"]),
                    meta.get("encoding", "parquet"))
        store.manifest = meta.get("manifest", {})
        return store

    def _save_metadata(self):
        """Persist metadata + manifest atomically (tmp file + rename).
        Mutation paths hold self._lock."""
        meta = {
            "version": 1,
            "name": self.sft.name,
            "spec": self.sft.to_spec(),
            "scheme": self.scheme.to_config(),
            "encoding": self.encoding,
            "manifest": self.manifest,
        }
        tmp = os.path.join(self.root, METADATA + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(self.root, METADATA))

    @property
    def count(self) -> int:
        with self._lock:
            return sum(f["count"]
                       for files in self.manifest.values() for f in files)

    # -- write -------------------------------------------------------------

    def write(self, batch: FeatureBatch) -> None:
        """Partition the batch by the scheme and append one parquet file per
        touched partition; the whole batch commits to the manifest in one
        step, so a reader sees all of it or none. Rows keep their order
        within each partition file."""
        if batch.valid is not None and not batch.valid.all():
            batch = batch.select(batch.valid)
        names, codes = self.scheme.group(batch)
        # stable grouping by partition code (radix sort on small codes)
        key = codes.astype(np.uint16) if len(names) <= 1 << 16 else codes
        order = np.argsort(key, kind="stable")
        bounds = np.searchsorted(codes[order], np.arange(len(names) + 1))
        staged = []
        for c in sorted(range(len(names)), key=names.__getitem__):
            name = names[c]
            sub = batch.select(order[bounds[c]:bounds[c + 1]])
            pdir = os.path.join(self.root, name)
            os.makedirs(pdir, exist_ok=True)
            fname = f"{uuid.uuid4().hex}.{self.encoding}"
            pq.write_table(_batch_to_table(sub), os.path.join(pdir, fname),
                           compression="zstd", row_group_size=64 * 1024)
            staged.append((name, fname, len(sub)))
        with self._lock:
            for name, fname, count in staged:
                self.manifest.setdefault(name, []).append(
                    {"file": fname, "count": count})
            try:
                self._save_metadata()
            except BaseException:
                # memory must never run ahead of the durable manifest
                for name, fname, count in staged:
                    entries = self.manifest.get(name, [])
                    if entries and entries[-1].get("file") == fname:
                        entries.pop()
                    if not entries:
                        self.manifest.pop(name, None)
                raise
            self._mversion += 1

    # -- read --------------------------------------------------------------

    def manifest_snapshot(self) -> ManifestSnapshot:
        """One consistent view of partition -> entry list, stamped with the
        commit version. Prune and read against the same snapshot."""
        with self._lock:
            snap = ManifestSnapshot(
                (name, list(entries))
                for name, entries in self.manifest.items())
            snap.version = self._mversion
            return snap

    def manifest_version(self) -> int:
        """The current committed write version (monotonic per
        instance) without copying the manifest — the serve result
        cache's peek-time key component (approx/cache.py)."""
        with self._lock:
            return self._mversion

    def partitions(self) -> List[str]:
        with self._lock:
            return sorted(self.manifest)

    def prune_partitions(self, bbox: BBox, interval: Interval,
                         manifest: Optional[Dict[str, List[dict]]] = None,
                         ) -> List[str]:
        names = (sorted(manifest) if manifest is not None
                 else self.partitions())
        pruned = self.scheme.prune(bbox, interval)
        if pruned is None:
            return names
        out = []
        for name in names:
            for p in pruned:
                if name == p or name.startswith(p + "/") or p == "":
                    out.append(name)
                    break
        return sorted(out)

    def _pushdown_expr(self, bbox: BBox, interval: Interval):
        """pyarrow filter from the covering bounds (row-group pruning)."""
        g = self.sft.default_geometry
        d = self.sft.default_dtg
        expr = None

        def AND(a, b):
            return b if a is None else (a if b is None else a & b)

        if g is not None and not bbox.is_whole_world:
            if g.type == "Point":
                e = ((pc.field(f"{g.name}__x") >= bbox.xmin)
                     & (pc.field(f"{g.name}__x") <= bbox.xmax)
                     & (pc.field(f"{g.name}__y") >= bbox.ymin)
                     & (pc.field(f"{g.name}__y") <= bbox.ymax))
            else:
                e = ((pc.field(f"{g.name}__xmin") <= bbox.xmax)
                     & (pc.field(f"{g.name}__xmax") >= bbox.xmin)
                     & (pc.field(f"{g.name}__ymin") <= bbox.ymax)
                     & (pc.field(f"{g.name}__ymax") >= bbox.ymin))
            expr = AND(expr, e)
        if d is not None and not interval.is_unbounded:
            if interval.start is not None:
                expr = AND(expr, pc.field(d.name) >= int(interval.start))
            if interval.end is not None:
                expr = AND(expr, pc.field(d.name) <= int(interval.end))
        return expr

    def scan(self, bbox: Optional[BBox] = None,
             interval: Optional[Interval] = None,
             columns: Optional[Sequence[str]] = None,
             ) -> Iterator[FeatureBatch]:
        """Yield batches from pruned partitions with parquet pushdown: a
        covering superset (exact evaluation is the device mask's job)."""
        bbox = bbox if bbox is not None else BBox(-180.0, -90.0, 180.0, 90.0)
        interval = interval if interval is not None else Interval(None, None)
        expr = self._pushdown_expr(bbox, interval)
        phys_cols = None
        if columns is not None:
            phys_cols = []
            for c in columns:
                a = self.sft.attribute(c)
                if a.is_geometry and a.type == "Point":
                    phys_cols += [f"{c}__x", f"{c}__y"]
                elif a.is_geometry:
                    phys_cols += [c, f"{c}__xmin", f"{c}__ymin",
                                  f"{c}__xmax", f"{c}__ymax"]
                else:
                    phys_cols.append(c)
        snap = self.manifest_snapshot()
        for name in self.prune_partitions(bbox, interval, manifest=snap):
            for entry in snap.get(name, []):
                path = os.path.join(self.root, name, entry["file"])
                cols = phys_cols
                if phys_cols is not None and FID in pq.read_schema(path).names:
                    cols = phys_cols + [FID]
                scanner = pads.dataset(path, format="parquet").scanner(
                    filter=expr, columns=cols, batch_size=SCAN_BATCH_SIZE)
                for t in _bounded_tables(scanner.to_batches(), SCAN_BATCH_SIZE):
                    if len(t):
                        yield _table_to_batch(t, self.sft)

    def scan_partitions(self, names: Sequence[str],
                        manifest: Optional[Dict[str, List[dict]]] = None,
                        ) -> Iterator[FeatureBatch]:
        """Every row of the named partitions, no pushdown (the device-cache
        residency read), pinned to `manifest` when given."""
        snap = manifest if manifest is not None else self.manifest_snapshot()
        for name in names:
            for entry in snap.get(name, []):
                t = pq.read_table(os.path.join(self.root, name, entry["file"]))
                if len(t):
                    yield _table_to_batch(t, self.sft)


def _bounded_tables(batches, target: int):
    """Regroup record batches into tables of at most `target` rows."""
    pending = []
    rows = 0
    for rb in batches:
        while rb.num_rows:
            take = min(rb.num_rows, target - rows)
            pending.append(rb.slice(0, take))
            rb = rb.slice(take)
            rows += take
            if rows >= target:
                yield pa.Table.from_batches(pending)
                pending, rows = [], 0
    if pending:
        yield pa.Table.from_batches(pending)
