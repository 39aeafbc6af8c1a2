"""Device cache manager: partitions resident on one device.

The counterpart of the reference package's `store/cache.py`, single-GPU
tier: each partition is loaded from its files, padded to the next power
of two, uploaded once as its own device segment, and the superbatch is a
device-side concat of the segments plus a partition-id row column. A
store with a non-point geometry column is not flat: its CSR ring tables
need offset rewrites on concat, so (as in the reference) its partitions
stay host-side and the superbatch is the full host concat, uploaded
whole whenever residency changes.
Queries mask pruned-out partitions by lane (`allowed[pids]`) instead of
launching per partition. Residency follows the storage manifest: a
partition whose file list changed is reloaded (a delete can shrink its
padded size), one the manifest no longer names (emptied by a delete or
an age-off) is dropped at the next `ensure`, the rest stay put.

The reference's lifecycle is here too: `refresh` (re-sync with the
storage manifest, dropping removed partitions), `invalidate`, `get`,
`resident`, `stats` (with the upload counters), the residency version
(`_version`, bumped by every residency change and stamped on each
superbatch) and the residency manifest (`save_manifest` / `resume`:
a restarted server rebuilds identical residency, or reports the
partitions whose files drifted). On one GPU this process is always the
coordinator that writes the manifest. The mesh tier and its delta-tile
growth come with the multi-GPU tier (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch
from geomesa_tpu_torch.engine.device import to_device
from geomesa_tpu_torch.store.fs import FileSystemStorage
from geomesa_tpu_torch.utils.padding import next_pow2

LAYOUT_VERSION = 1
MANIFEST = ".device_cache.json"

def _locked(fn):
    """Serialize a DeviceCacheManager method on the instance RLock."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


@dataclasses.dataclass
class CacheEntry:
    """One resident partition: host copy (padded) + its device segment."""

    files: List[str]
    count: int  # valid rows
    padded: int  # padded length (pow2)
    batch: FeatureBatch
    dev: Optional[dict]  # None for a non-flat store (see the module docstring)


@dataclasses.dataclass
class SuperBatch:
    """All resident partitions as ONE device batch + partition ids."""

    batch: FeatureBatch          # host concat (padded segments)
    dev: dict                    # device tensors of the concat
    pids: torch.Tensor           # i32 [N] partition id per row
    ids: Dict[str, int]          # partition name -> id
    version: int = 0             # the cache's residency version at build
    # host row offsets of the partitions' segments ([P + 1]): a row's
    # partition id without a device read (`host_pids`)
    starts: Optional[np.ndarray] = None
    # on a card, the event after the superbatch's device build: work on
    # another stream reading `dev`/`pids` waits on it alone
    ready: Optional[object] = None

    def host_pids(self, rows: np.ndarray) -> np.ndarray:
        """The partition id of each row in `rows`, from `starts`."""
        return np.searchsorted(self.starts, rows, side="right") - 1


class DeviceCacheManager:
    """Keeps partitions of a FileSystemStorage resident on `device`."""

    def __init__(self, storage: FileSystemStorage, device: torch.device,
                 coord_dtype: Optional[torch.dtype] = None):
        self.storage = storage
        self.device = device
        # the planner's coordinate dtype (geomesa.coord.dtype), so the
        # cached and scan routes stage the same values; None stages f32
        # and records no dtype in the manifest, as in the reference
        self.coord_dtype = coord_dtype
        self._lock = threading.RLock()
        self._entries: Dict[str, CacheEntry] = {}
        self._super: Optional[SuperBatch] = None
        self._version = 0  # bumped by every residency change
        self._applied_mversion = -1  # storage commit version last applied
        self.upload_count = 0  # host -> device uploads (partitions or wholes)
        self.upload_rows = 0   # rows those uploads carried
        # store-level grow-only vocabularies (per dict column) so device
        # code segments from different partitions stay comparable
        self._vocab: Dict[str, list] = {}
        self._flat = all((not a.is_geometry) or a.type == "Point"
                         for a in storage.sft.attributes)

    @property
    def _stage_dtype(self) -> torch.dtype:
        return self.coord_dtype or torch.float32

    def _partition_files(self, name: str,
                         manifest: Optional[dict] = None) -> List[str]:
        src = manifest if manifest is not None else self.storage.manifest
        return sorted(e["file"] for e in src.get(name, []))

    def _shared_vocab_recode(self, batch: FeatureBatch) -> FeatureBatch:
        """Re-encode dict columns against the store-level vocabularies."""
        cols = dict(batch.columns)
        changed = False
        for name, col in batch.columns.items():
            if not isinstance(col, DictColumn):
                continue
            vocab = self._vocab.setdefault(name, [])
            lookup = {v: i for i, v in enumerate(vocab)}
            remap = np.empty(len(col.vocab), np.int32)
            for i, v in enumerate(col.vocab):
                if v not in lookup:
                    lookup[v] = len(vocab)
                    vocab.append(v)
                remap[i] = lookup[v]
            codes = np.where(col.codes >= 0, remap[np.maximum(col.codes, 0)], -1)
            cols[name] = DictColumn(codes.astype(np.int32), vocab)
            changed = True
        if not changed:
            return batch
        return FeatureBatch(batch.sft, cols, batch.fids, batch.valid)

    def _load_partition(self, name: str, manifest: dict) -> Optional[CacheEntry]:
        batches = list(self.storage.scan_partitions([name], manifest=manifest))
        if not batches:
            return None
        batch = FeatureBatch.concat(batches)
        n = len(batch)
        padded = batch.pad_to(next_pow2(n))
        dev = None
        if self._flat:
            padded = self._shared_vocab_recode(padded)
            dev = to_device(padded, self.device, self._stage_dtype)
            self.upload_count += 1
            self.upload_rows += len(padded)
        return CacheEntry(files=self._partition_files(name, manifest),
                          count=n, padded=len(padded), batch=padded, dev=dev)

    @_locked
    def ensure(self, partitions: Optional[List[str]] = None,
               manifest: Optional[dict] = None) -> List[str]:
        """Make the named partitions (default: all) resident, pinned to the
        `manifest` snapshot; returns the partitions (re)loaded, and those
        dropped because a versioned snapshot no longer names them. A stale
        snapshot (older than one already applied) is replaced by a fresh
        one, so residency never rolls backward."""
        mv = getattr(manifest, "version", None)
        if manifest is None or (mv is not None and mv < self._applied_mversion):
            manifest = self.storage.manifest_snapshot()
            mv = manifest.version
        if mv is not None:
            self._applied_mversion = max(self._applied_mversion, mv)
        names = partitions if partitions is not None else sorted(manifest)
        loaded = []
        if mv is not None:
            # a partition the committed manifest no longer names (emptied
            # by a delete or an age-off) frees its device memory now
            loaded = [n for n in self._entries if n not in manifest]
            for n in loaded:
                del self._entries[n]
        for name in names:
            cur = self._entries.get(name)
            if cur is not None and cur.files == self._partition_files(name, manifest):
                continue
            entry = self._load_partition(name, manifest)
            changed = True
            if entry is None:
                changed = self._entries.pop(name, None) is not None
            else:
                self._entries[name] = entry
            if changed:
                loaded.append(name)
        if loaded:
            self._super = None
            self._version += 1
        return loaded

    @_locked
    def refresh(self) -> List[str]:
        """Re-sync with the storage manifest: load new and changed
        partitions, drop removed ones. Returns the changed names."""
        return self.ensure(manifest=self.storage.manifest_snapshot())

    @_locked
    def invalidate(self, partition: Optional[str] = None) -> None:
        """Drop one partition's residency (every partition's with None)."""
        if partition is None:
            self._entries.clear()
        else:
            self._entries.pop(partition, None)
        self._super = None
        self._version += 1

    @_locked
    def get(self, partition: str) -> Optional[CacheEntry]:
        return self._entries.get(partition)

    @_locked
    def resident(self) -> List[str]:
        return sorted(self._entries)

    @_locked
    def stats(self) -> dict:
        return {
            "partitions": len(self._entries),
            "rows": sum(e.count for e in self._entries.values()),
            "padded_rows": sum(e.padded for e in self._entries.values()),
            "uploads": self.upload_count,
            "upload_rows": self.upload_rows,
            "layout_version": LAYOUT_VERSION,
        }

    # -- manifest persistence (restart determinism) ------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.storage.root, MANIFEST)

    @_locked
    def save_manifest(self) -> None:
        """Write which partition files are resident, under which layout,
        atomically, in the reference's format (one GPU: this process is
        always the coordinator)."""
        doc = {
            "layout_version": LAYOUT_VERSION,
            "coord_dtype": (str(self.coord_dtype).replace("torch.", "")
                            if self.coord_dtype else None),
            "partitions": {
                name: {"files": e.files, "count": e.count, "padded": e.padded}
                for name, e in self._entries.items()
            },
        }
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, self.manifest_path)

    @_locked
    def resume(self) -> Tuple[List[str], List[str]]:
        """Rebuild residency from the saved manifest: reload every
        partition it names whose files still match. Returns (restored,
        stale); stale = layout drift or file-list drift, for the caller to
        `ensure()` afresh if wanted."""
        if not os.path.exists(self.manifest_path):
            return [], []
        with open(self.manifest_path) as f:
            doc = json.load(f)
        if doc.get("layout_version") != LAYOUT_VERSION:
            return [], sorted(doc.get("partitions", {}))
        restored, stale = [], []
        snap = self.storage.manifest_snapshot()
        for name, meta in sorted(doc.get("partitions", {}).items()):
            if self._partition_files(name, snap) != meta["files"]:
                stale.append(name)
                continue
            entry = self._load_partition(name, snap)
            if entry is None:
                stale.append(name)
                continue
            if entry.padded != meta["padded"]:
                raise RuntimeError(
                    f"non-deterministic rebuild for {name}: "
                    f"{entry.padded} != {meta['padded']}")
            self._entries[name] = entry
            restored.append(name)
        if restored:
            self._super = None
            self._version += 1
        return restored, stale

    @_locked
    def superbatch_peek(self) -> Optional[SuperBatch]:
        """The current superbatch if one is built, else None (no work)."""
        return self._super

    @_locked
    def superbatch(self) -> Optional[SuperBatch]:
        """The concatenated device view of every resident partition, in
        sorted partition order (None when nothing is resident)."""
        if self._super is not None:
            return self._super
        if not self._entries:
            return None
        names = sorted(self._entries)
        entries = [self._entries[n] for n in names]
        batch = FeatureBatch.concat([e.batch for e in entries])
        if self._flat:
            dev = {k: torch.cat([e.dev[k] for e in entries])
                   for k in entries[0].dev}
        else:
            dev = to_device(batch, self.device, self._stage_dtype)
            self.upload_count += 1
            self.upload_rows += len(batch)
        pids = torch.cat([
            torch.full((e.padded,), i, dtype=torch.int32, device=self.device)
            for i, e in enumerate(entries)])
        ready = None
        if pids.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(pids.device))
        self._super = SuperBatch(
            batch=batch, dev=dev, pids=pids,
            ids={n: i for i, n in enumerate(names)}, version=self._version,
            starts=np.concatenate(
                [[0], np.cumsum([e.padded for e in entries])]).astype(np.int64),
            ready=ready)
        return self._super
