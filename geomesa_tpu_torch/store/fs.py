"""Filesystem (Parquet) storage: partitioned writes, pruned + pushed-down reads.

The counterpart of the reference package's `store/fs.py`, with the same
on-disk format, so either package loads a catalog the other wrote:

    <root>/metadata.json            sft spec + scheme config + manifest
    <root>/<partition>/<uuid>.parquet

Point geometry is stored as x/y float64 columns named <attr>__x/__y (so
row-group statistics prune on bbox); other geometries as WKT text plus
per-feature bbox columns <attr>__xmin/__ymin/__xmax/__ymax; strings as
dictionary columns, dates as int64 epoch millis. Data files are Parquet
or ORC (`encoding`), as in the reference.

The lifecycle is the reference's: `write` appends one file per touched
partition, `compact` merges a partition's files into one, and
`delete_features`/`age_off` rewrite each touched file without the
matching rows (exact f64 host evaluation). Every mutation commits to the
manifest in one step and bumps `manifest_version`, so residency, the
result cache and armed ring programs see it. Reads and data-file writes
retry transient I/O against the "storage" circuit breaker at the
`fs.read_partition` and `fs.write_partition` fault sites; the manifest
commit (`fs.write_manifest`) is deliberately not retried (below).
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
from geomesa_tpu_torch.faults import BREAKERS, RetryPolicy, retry_call
from geomesa_tpu_torch.faults import harness as _faults
from geomesa_tpu_torch.store.partition import PartitionScheme, scheme_from_config

METADATA = "metadata.json"
FID = "__fid__"

# fault-injection sites + retry policy for the storage boundary. Reads and
# partition-file writes retry transient I/O against the "storage"
# breaker. The manifest commit is DELIBERATELY non-retryable: it runs
# under the manifest lock (sleeping there stalls every reader/writer) and
# the tmp+os.replace swap is already all-or-nothing — a failed commit
# leaves the previous manifest intact, never a torn one.
_READ_SITE = _faults.site(
    "fs.read_partition", "partition data file read (parquet/orc)")
_WRITE_SITE = _faults.site(
    "fs.write_partition", "partition data file write (staging)")
_MANIFEST_SITE = _faults.site(
    "fs.write_manifest", "metadata.json manifest commit (atomic swap)")
_STORAGE_RETRY = RetryPolicy(max_attempts=4, base_ms=5.0, cap_ms=250.0)


def _storage_retry(fn, *args):
    return retry_call(fn, *args, policy=_STORAGE_RETRY, label="storage",
                      breaker=BREAKERS.get("storage"))


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
    """A partitioned Parquet (or ORC) feature store."""

    def __init__(self, root: str, sft: SimpleFeatureType,
                 scheme: PartitionScheme, encoding: str = "parquet"):
        if encoding not in ("parquet", "orc"):
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
        from geomesa_tpu_torch.parallel.distributed import is_coordinator

        if not is_coordinator():
            # multi-process runtimes READ the FS store (each process
            # feeds from the shared files); mutation is single-writer
            # before serving. The gate keeps a non-coordinator process
            # from clobbering the shared manifest with its partial view
            # of the partition set
            return
        meta = {
            "version": 1,
            "name": self.sft.name,
            "spec": self.sft.to_spec(),
            "scheme": self.scheme.to_config(),
            "encoding": self.encoding,
            "manifest": self.manifest,
        }
        tmp = os.path.join(self.root, METADATA + ".tmp")
        # a failure HERE (before or during the tmp write) must leave the
        # previous manifest untouched: no torn manifest
        _MANIFEST_SITE.fire()
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
        """Partition the batch by the scheme and append one data file per
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
            # retryable: the file is not in the manifest yet, so a partial
            # write from a failed attempt is an invisible orphan the
            # successful attempt simply overwrites
            _storage_retry(self._write_data_file, sub,
                           os.path.join(pdir, fname))
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

    def compact(self) -> int:
        """Merge each partition's files into one (the FS store's compact
        command). Returns how many files were removed."""
        with self._lock:
            targets = list(self.manifest)
        removed = 0
        for name in targets:
            with self._lock:
                entries = list(self.manifest.get(name, []))
            if len(entries) <= 1:
                continue
            tables = [self._read_file(os.path.join(self.root, name, e["file"]),
                                      None, None)
                      for e in entries]
            merged = pa.concat_tables(tables, promote_options="permissive")
            count = sum(e["count"] for e in entries)
            fname = f"{uuid.uuid4().hex}.{self.encoding}"
            _storage_retry(self._write_table, merged,
                           os.path.join(self.root, name, fname))
            # crash-safety ordering: write the merged file, point the
            # manifest at it, persist — only then delete the old files
            with self._lock:
                # writes only APPEND, so the snapshot is a prefix of the
                # live list: keep any entry a concurrent write() added
                prev = self.manifest.get(name)
                tail = self.manifest.get(name, [])[len(entries):]
                self.manifest[name] = [{"file": fname, "count": count}] + tail
                try:
                    self._save_metadata()
                except BaseException:
                    # memory must never run ahead of the durable manifest:
                    # the merged file becomes an unreferenced orphan and
                    # the old files stay live
                    self.manifest[name] = prev
                    raise
                self._mversion += 1
            for entry in entries:
                os.remove(os.path.join(self.root, name, entry["file"]))
                removed += 1
        return removed

    def delete_features(self, cql: "str | object") -> int:
        """Delete features matching an ECQL filter: each touched file is
        rewritten without the matching rows (exact f64 host evaluation),
        with compact's crash-safety ordering (new file + manifest first,
        removals last). Returns rows deleted."""
        from geomesa_tpu_torch.cql import ast, parse_cql
        from geomesa_tpu_torch.cql.hosteval import eval_filter_host

        f = parse_cql(cql) if isinstance(cql, str) else cql
        if isinstance(f, ast.Include):
            # delete-all: persist the emptied manifest FIRST, remove files
            # last (a crash leaves orphans, never missing files)
            total = self.count
            with self._lock:
                paths = [os.path.join(self.root, name, entry["file"])
                         for name, entries in self.manifest.items()
                         for entry in entries]
                prev = self.manifest
                self.manifest = {}
                try:
                    self._save_metadata()
                except BaseException:
                    self.manifest = prev
                    raise
                self._mversion += 1
            for p in paths:
                os.remove(p)
            return total
        deleted = 0
        with self._lock:
            names = list(self.manifest)
        for name in names:
            new_entries = []
            removals = []
            with self._lock:
                entries = list(self.manifest.get(name, []))
            for entry in entries:
                batch = _table_to_batch(self._read_file(
                    os.path.join(self.root, name, entry["file"]), None, None),
                    self.sft)
                hit = eval_filter_host(f, batch)
                nh = int(hit.sum())
                if nh == 0:
                    new_entries.append(entry)
                    continue
                deleted += nh
                removals.append(entry["file"])
                keep = batch.select(~hit)
                if len(keep):
                    fname = f"{uuid.uuid4().hex}.{self.encoding}"
                    _storage_retry(self._write_data_file, keep,
                                   os.path.join(self.root, name, fname))
                    new_entries.append({"file": fname, "count": len(keep)})
            if not removals:
                continue
            with self._lock:
                # preserve entries a concurrent write() appended after
                # our snapshot (appends only: the snapshot is a prefix)
                prev = self.manifest.get(name)
                tail = self.manifest.get(name, [])[len(entries):]
                if new_entries or tail:
                    self.manifest[name] = new_entries + tail
                else:
                    del self.manifest[name]
                try:
                    self._save_metadata()
                except BaseException:
                    # a failed durable commit must not leave the deletion
                    # visible in memory (a restart would resurrect it)
                    if prev is not None:
                        self.manifest[name] = prev
                    else:
                        self.manifest.pop(name, None)
                    raise
                self._mversion += 1
            for fname in removals:
                os.remove(os.path.join(self.root, name, fname))
        return deleted

    def age_off(self, older_than_ms: int) -> int:
        """Delete features whose default dtg is strictly before
        `older_than_ms`. Returns rows deleted."""
        from geomesa_tpu_torch.cql import ast

        d = self.sft.default_dtg
        if d is None:
            raise ValueError("age_off needs a dtg attribute")
        return self.delete_features(ast.TemporalPredicate(
            "BEFORE", ast.Property(d.name), int(older_than_ms), None))

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
        """Yield batches from pruned partitions with pushdown: a covering
        superset (exact evaluation is the device mask's job). No batch is
        larger than `geomesa.scan.batch.size` rows."""
        from geomesa_tpu_torch.utils.config import SystemProperties

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
        target = int(SystemProperties.SCAN_BATCH_SIZE.get())
        snap = self.manifest_snapshot()
        for name in self.prune_partitions(bbox, interval, manifest=snap):
            for entry in snap.get(name, []):
                path = os.path.join(self.root, name, entry["file"])
                cols = phys_cols
                if phys_cols is not None and FID in self._file_schema_names(path):
                    cols = phys_cols + [FID]
                for t in self._stream_file(path, expr, cols, target):
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
                t = self._read_file(os.path.join(self.root, name, entry["file"]),
                                    None, None)
                if len(t):
                    yield _table_to_batch(t, self.sft)

    def read_all(self) -> Optional[FeatureBatch]:
        """Every row of the store in one batch (None when empty)."""
        batches = list(self.scan())
        return FeatureBatch.concat(batches) if batches else None

    # -- data files ----------------------------------------------------------

    def _write_data_file(self, sub: FeatureBatch, path: str) -> None:
        """Encode + write one partition data file: one idempotent unit for
        the retry fabric."""
        self._write_table(_batch_to_table(sub), path)

    def _write_table(self, table: pa.Table, path: str) -> None:
        _WRITE_SITE.fire()
        if self.encoding == "orc":
            from pyarrow import orc

            orc.write_table(_decode_dictionaries(table), path,
                            compression="zstd")
        else:
            pq.write_table(table, path, compression="zstd",
                           row_group_size=64 * 1024)

    def _file_schema_names(self, path: str) -> List[str]:
        if self.encoding == "orc":
            from pyarrow import orc

            return orc.ORCFile(path).schema.names
        return pq.read_schema(path).names

    def _read_file(self, path: str, expr, cols) -> pa.Table:
        """Read one data file with predicate + column pushdown (ORC through
        pyarrow.dataset). Transient failures retry against the storage
        breaker: committed data files are immutable, so a re-read is
        idempotent."""
        return _storage_retry(self._read_file_once, path, expr, cols)

    def _read_file_once(self, path: str, expr, cols) -> pa.Table:
        _READ_SITE.fire()
        if self.encoding == "orc":
            return pads.dataset(path, format="orc").to_table(
                filter=expr, columns=cols)
        return pq.read_table(path, filters=expr, columns=cols)

    def _stream_file(self, path: str, expr, cols, target: int):
        """Tables of at most `target` rows from one file. Parquet streams
        row groups with pushdown; ORC reads the whole file and slices it.
        Only the open retries: a failure mid-stream surfaces typed rather
        than replay rows already yielded."""
        if self.encoding == "orc":
            t = self._read_file(path, expr, cols)
            for off in range(0, max(len(t), 1), target):
                yield t.slice(off, target)
            return

        def _open():
            _READ_SITE.fire()
            return pads.dataset(path, format="parquet").scanner(
                filter=expr, columns=cols, batch_size=target)

        scanner = _storage_retry(_open)
        yield from _bounded_tables(scanner.to_batches(), target)


def _decode_dictionaries(table: pa.Table) -> pa.Table:
    """ORC has no dictionary type: cast dict columns to their value type
    (the read path re-encodes them into DictColumn)."""
    fields = []
    arrays = []
    for field in table.schema:
        col = table.column(field.name)
        if pa.types.is_dictionary(field.type):
            col = col.cast(field.type.value_type)
            field = pa.field(field.name, field.type.value_type)
        fields.append(field)
        arrays.append(col)
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


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
