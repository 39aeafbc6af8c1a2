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
partitions whose files drifted). In a process group only the
coordinator writes the manifest (`parallel.distributed.is_coordinator`).

The mesh tier (`set_mesh`, flat stores only): the superbatch keeps the
SERIAL row layout (partitions in sorted order, each pow2-padded) plus
trailing invalid rows to a multiple of the mesh size, so a row's global
index is its single-device index and the sharded answers are the
single-device ones. Residency is sharded as the reference's
`NamedSharding(mesh, P("shard"))` placement: shard i's rows [i*S,
(i+1)*S) of EVERY row-axis column, and of the partition ids, go from the
host straight to `mesh.devices[i]` (pinned, non_blocking), each shard
its own allocation even where the mesh repeats a device, and no
per-partition segments are kept (residency is not held twice). `dev`'s
columns and `pids` are `parallel.mesh.Sharded`; the planner evaluates
masks, counts and aggregates shard by shard on the shards' devices.
`owners` maps each partition to the shards holding its rows. A GROWTH
(new partitions sorting after every resident one, the resident ones
unchanged) moves every shard boundary (S grows): each new shard is
rebuilt from the old shards' rows, copied device to device in row
order, and its part of the uploaded tail; only the tail is uploaded
(and counted in `upload_rows`). Any other change, a new mesh and
clearing the mesh take the full re-upload and drop every old shard.

On a mesh that spans processes (`parallel.distributed.global_mesh`)
every process reads the whole superbatch on the host, as the
reference's processes do, and uploads only its own shards' rows; the
upload counters and `resident_bytes` are this process's. A growth
rebuilds this process's shards, copying the old rows device to device
where this process held them and uploading them otherwise. `owners` is
not used for shard affinity there: `shards_for` answers the whole mesh,
so every window runs the whole mesh's collective program.
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
from geomesa_tpu_torch.engine.device import to_device, upload
from geomesa_tpu_torch.parallel.mesh import on_shard
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
    # another stream reading `dev`/`pids` waits on it alone (on the mesh
    # tier one event a shard, on its device)
    ready: Optional[object] = None
    # the mesh tier: the mesh, rows per shard and the shards holding each
    # partition's rows; `dev`'s columns and `pids` are then
    # `parallel.mesh.Sharded`
    mesh: object = None
    shard_rows: int = 0
    owners: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def shard_devs(self) -> list:
        """One plain device batch a shard (its rows of every column, on
        its device); [dev] off the mesh tier."""
        if self.mesh is None:
            return [self.dev]
        from geomesa_tpu_torch.parallel.mesh import shard_dicts

        return shard_dicts(self.mesh, self.dev)

    def host_pids(self, rows: np.ndarray) -> np.ndarray:
        """The partition id of each row in `rows`, from `starts`."""
        return np.searchsorted(self.starts, rows, side="right") - 1

    def shards_for(self, partitions) -> tuple:
        """Sorted ids of the shards holding any of `partitions`' rows
        (empty off the mesh tier or when nothing matches). On a mesh that
        spans processes every shard: shard affinity is off there, so that
        every process runs the same collective program (a window routed
        to one shard would leave the other processes out of its merge)."""
        if self.mesh is not None and self.mesh.spans_processes:
            return tuple(range(self.mesh.size))
        out: set = set()
        for name in partitions:
            out.update(self.owners.get(name, ()))
        return tuple(sorted(out))


class DeviceCacheManager:
    """Keeps partitions of a FileSystemStorage resident on `device`."""

    def __init__(self, storage: FileSystemStorage, device: torch.device,
                 coord_dtype: Optional[torch.dtype] = None, mesh=None):
        self.storage = storage
        self.device = device
        # the serving mesh (`parallel.mesh.Mesh`): with one, a flat
        # store's superbatch is the mesh tier (module docstring)
        self.mesh = mesh
        # the last mesh superbatch's layout, for the growth path
        self._mesh_prev: Optional[dict] = None
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

    # -- the mesh tier -------------------------------------------------------

    def _mesh_active(self) -> bool:
        return self.mesh is not None and self._flat

    @_locked
    def serving_mesh(self):
        """The mesh a kNN window will really run on: the installed mesh
        when the tier is active (a flat store), else None. The serve
        pipeline keys its staging slots on this, not on the config."""
        return self.mesh if self._mesh_active() else None

    @_locked
    def set_mesh(self, mesh) -> None:
        """Install (or clear, with None) the serving mesh. A no-op for a
        mesh equal to the installed one (by value: every service resolves
        a fresh Mesh over the same devices). Otherwise residency is
        rebuilt at the next superbatch: entries keep their host copies,
        their single-device segments are dropped under a mesh (the mesh
        upload would otherwise hold the rows twice), and the residency
        version moves on."""
        if mesh is self.mesh or (mesh is not None and self.mesh is not None
                                 and mesh == self.mesh):
            return
        self.mesh = mesh
        if self._mesh_active():
            for e in self._entries.values():
                e.dev = None
        self._super = None
        self._mesh_prev = None  # a new placement: the full re-upload
        self._version += 1

    @_locked
    def shards_for(self, partitions) -> tuple:
        """The shards holding the named partitions' rows under the CURRENT
        mesh superbatch; a cold or stale cache answers () (no residency
        work on the caller's thread)."""
        if not self._mesh_active() or self._super is None:
            return ()
        return self._super.shards_for(partitions)

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
        if self._flat and not self._mesh_active():
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
        self._mesh_prev = None  # the growth path must not keep dropped rows
        self._version += 1

    @_locked
    def get(self, partition: str) -> Optional[CacheEntry]:
        return self._entries.get(partition)

    @_locked
    def resident(self) -> List[str]:
        return sorted(self._entries)

    @_locked
    def resident_bytes(self) -> Dict[str, int]:
        """Device bytes of the current residency by device: the
        superbatch's columns and partition ids and the partitions' own
        segments, each storage counted once."""
        from geomesa_tpu_torch.parallel.mesh import Sharded

        tensors = [e.dev for e in self._entries.values() if e.dev]
        if self._super is not None:
            tensors += [self._super.dev, self._super.pids]
        seen, out = set(), {}

        def add(t):
            if isinstance(t, Sharded):
                for x in t.shards:
                    add(x)
            elif isinstance(t, dict):
                for x in t.values():
                    add(x)
            elif isinstance(t, (tuple, list)):
                for x in t:
                    add(x)
            elif isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = (str(t.device), st.data_ptr())
                if key not in seen:
                    seen.add(key)
                    out[key[0]] = out.get(key[0], 0) + st.nbytes()

        add(tensors)
        return dict(sorted(out.items()))

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
        atomically, in the reference's format; only the coordinator
        process writes."""
        from geomesa_tpu_torch.parallel.distributed import is_coordinator

        if not is_coordinator():
            # multi-process: residency is the same in every process
            # (every process computes the same superbatch layout), so
            # the manifests would be byte-identical; one writer is the
            # contract anyway
            return
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
        if self._mesh_active():
            return self._mesh_superbatch(names, entries, batch)
        if self._flat and all(e.dev is not None for e in entries):
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

    def _mesh_superbatch(self, names, entries, batch) -> SuperBatch:
        """The mesh tier's superbatch (module docstring): the serial
        layout plus trailing invalid rows to a multiple of the mesh size,
        every row-axis column and the partition ids uploaded shard by
        shard from the host to their devices, or, on a growth, each shard
        rebuilt from the old shards' rows (device to device, in row order)
        and its part of the uploaded tail."""
        from geomesa_tpu_torch.parallel.mesh import Sharded, assemble, upload_rows

        mesh = self.mesh
        d = mesh.size
        devs = mesh.device_list
        total = len(batch)
        padded_total = -(-total // d) * d
        pids_host = np.concatenate([np.full(e.padded, i, np.int32)
                                    for i, e in enumerate(entries)])
        if padded_total > total:
            batch = batch.pad_to(padded_total)
            # the trailing rows carry the last partition's id; they are
            # invalid, so inert in every kernel
            pids_host = np.concatenate([
                pids_host, np.full(padded_total - total, pids_host[-1], np.int32)])
        s = padded_total // d
        prev = self._mesh_growth_prev(names)
        old = prev["concat_rows"] if prev is not None else 0
        # the host rows each local shard takes from the upload: past
        # `old`, unless an old row it needs is in another process
        s0 = prev["pids"].shard_rows if prev is not None else 1
        bounds = {}
        for i in mesh.local:
            lo = max(i * s, old)
            held = all(prev["pids"].shards[j] is not None
                       for j in range(i * s // s0, -(-min((i + 1) * s, old) // s0))
                       ) if prev is not None else True
            bounds[i] = (lo if held else i * s, (i + 1) * s)
        up = [i for i in mesh.local if bounds[i][1] > bounds[i][0]]
        parts = upload_rows(batch, [bounds[i] for i in up],
                            [devs[i] for i in up], self._stage_dtype) if up else []
        tails = dict(zip(up, parts))
        for i in up:
            lo, hi = bounds[i]
            tails[i]["__pids__"] = upload(pids_host[lo:hi], devs[i])
        self.upload_count += 1
        self.upload_rows += sum(max(0, hi - lo) for lo, hi in bounds.values())
        if prev is None:
            shard_dev = [tails[i] for i in mesh.local]
        else:
            keys = list(prev["dev"]) + ["__pids__"]
            old_cols = dict(prev["dev"], __pids__=prev["pids"])
            shard_dev = []
            for i in mesh.local:
                if bounds[i][0] == i * s:  # uploaded whole
                    shard_dev.append(tails[i])
                    continue
                with on_shard(devs[i]):
                    pieces = {k: _old_rows(old_cols[k], i * s,
                                           min((i + 1) * s, old), devs[i])
                              for k in keys}
                    for k, v in tails.get(i, {}).items():
                        pieces[k].append(v)
                    # torch.cat: a fresh allocation even for one piece
                    shard_dev.append({k: torch.cat(v) for k, v in pieces.items()})
        pids_l: list = [None] * d
        for i, p in zip(mesh.local, shard_dev):
            pids_l[i] = p.pop("__pids__")
        pids = Sharded(mesh, pids_l)
        dev = assemble(mesh, shard_dev)
        owners: Dict[str, tuple] = {}
        off = 0
        for name, e in zip(names, entries):
            lo, hi = off, off + e.padded
            owners[name] = tuple(range(lo // s, min((hi - 1) // s + 1, d)))
            off = hi
        ready = tuple(_ready_event(dv) if o == mesh.rank else None
                      for dv, o in zip(devs, mesh.owners))
        starts = np.concatenate(
            [[0], np.cumsum([e.padded for e in entries])]).astype(np.int64)
        starts[-1] = padded_total  # the trailing rows are the last partition's
        self._super = SuperBatch(
            batch=batch, dev=dev, pids=pids,
            ids={n: i for i, n in enumerate(names)}, version=self._version,
            starts=starts, ready=ready, mesh=mesh, shard_rows=s,
            owners=owners)
        self._mesh_prev = {
            "mesh": mesh, "names": tuple(names),
            "meta": {n: (e.padded, tuple(e.files)) for n, e in zip(names, entries)},
            "concat_rows": total, "dev": dev, "pids": pids}
        return self._super

    def _mesh_growth_prev(self, names) -> Optional[dict]:
        """The previous mesh layout when the pending rebuild is a pure
        GROWTH of it: the same mesh, its names a strict prefix of the new
        sorted ones (a name sorting into the middle would shift every
        later partition's rows), and every one of its entries unchanged
        (padded length and files). Else None: the full re-upload."""
        prev = self._mesh_prev
        if prev is None or prev["mesh"] is not self.mesh:
            return None
        pn = prev["names"]
        if len(names) <= len(pn) or tuple(names[:len(pn)]) != pn:
            return None
        for name in pn:
            e = self._entries.get(name)
            if e is None or (e.padded, tuple(e.files)) != prev["meta"][name]:
                return None
        return prev


def _old_rows(col, lo: int, hi: int, device: torch.device) -> list:
    """Global rows [lo, hi) of a previous superbatch's `Sharded` column,
    as pieces in row order on `device` (device-to-device copies; none
    when hi <= lo)."""
    out = []
    s0 = col.shard_rows
    for j in range(lo // s0, -(-hi // s0)) if hi > lo else ():
        a, b = max(lo, j * s0) - j * s0, min(hi, (j + 1) * s0) - j * s0
        out.append(col.shards[j][a:b].to(device, non_blocking=True))
    return out


def _ready_event(device: torch.device):
    """An event after the work queued so far on `device`'s current stream
    (None off CUDA)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev
