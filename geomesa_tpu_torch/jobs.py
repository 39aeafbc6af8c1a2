"""Parallel ingest/export jobs.

A copy of the reference package's `jobs.py`, modelled on geomesa-jobs and
the distributed halves of the ingest/export CLI (ConverterInputFormat ->
mapper -> GeoMesaOutputFormat) [upstream, unverified]. Upstream
distributes per-file converter tasks over MapReduce/Spark; the analog
here is a thread pool converting files
concurrently (parsing is I/O + pyarrow/numpy work that releases the GIL)
with a single writer fold, which preserves the reference's contract:
per-file task granularity, per-file failure isolation, resumability at file
granularity (completed files are recorded and skipped on re-run).

`export_partitions` filters each partition on a device: the store's own
(the card for a card store) unless the caller names another. Its worker
threads launch their masks on that device, each on its thread's current
stream.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, List, Sequence

from geomesa_tpu_torch.core.columnar import FeatureBatch


@dataclasses.dataclass
class IngestReport:
    files_ok: List[str]
    files_failed: List[str]  # "path: error"
    features: int
    skipped: List[str]  # already-ingested files (resume)
    records_failed: int = 0  # per-record converter failures in ok files


def _checkpoint_path(storage_root: str) -> str:
    return os.path.join(storage_root, ".ingest_checkpoint.json")


def _load_checkpoint(storage_root: str) -> set:
    p = _checkpoint_path(storage_root)
    if os.path.exists(p):
        with open(p) as f:
            return set(json.load(f).get("done", []))
    return set()


def _save_checkpoint(storage_root: str, done: set) -> None:
    p = _checkpoint_path(storage_root)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"done": sorted(done)}, f)
    os.replace(tmp, p)


def ingest_files(
    source,
    converter_factory: Callable[[], object],
    files: Sequence[str],
    workers: int = 4,
    on_error: str = "continue",  # or "raise"
) -> IngestReport:
    """Convert + write many files concurrently through one feature source.

    `source` is any object with .write(batch) and .storage.root (the FS
    FeatureSource); `converter_factory` builds a SimpleFeatureConverter
    (.convert(path) -> FeatureBatch) — one per worker thread, because
    converters keep per-run state (failure counters). Files already
    recorded in the ingest checkpoint are skipped (upstream: ingest
    resumability at file granularity).
    """
    root = source.storage.root
    done = _load_checkpoint(root)
    todo = [f for f in files if os.path.abspath(f) not in done]
    skipped = [f for f in files if os.path.abspath(f) in done]
    ok: List[str] = []
    failed: List[str] = []
    total = 0
    rec_failed = 0
    write_lock = threading.Lock()
    tls = threading.local()

    def task(path: str):
        if not hasattr(tls, "conv"):
            tls.conv = converter_factory()
        batch = tls.conv.convert(path)
        return path, batch, int(getattr(tls.conv, "failed", 0))

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        futures = {pool.submit(task, f): f for f in todo}
        for fut in as_completed(futures):
            try:
                path, batch, n_bad = fut.result()
            except Exception as e:  # per-file failure isolation
                failed.append(
                    f"{futures[fut]}: {e.__class__.__name__}: {e}"
                )
                if on_error == "raise":
                    for other in futures:
                        other.cancel()
                    raise
                continue
            rec_failed += n_bad
            if batch is not None and len(batch):
                with write_lock:  # single-writer fold
                    source.write(batch)
                total += len(batch)
            ok.append(path)
            done.add(os.path.abspath(path))
            with write_lock:
                _save_checkpoint(root, done)
    return IngestReport(ok, failed, total, skipped, rec_failed)


def export_partitions(
    source,
    writer: Callable[[str, FeatureBatch], None],
    cql: str = "INCLUDE",
    workers: int = 4,
    device=None,
) -> List[str]:
    """Per-partition parallel export (the distributed-export analog):
    `writer(partition_name, batch)` is called once per non-empty partition,
    concurrently. A filter is evaluated on `device` (default: the source
    planner's device) through `mask_refined`: the device mask, with the
    f32 boundary band's rows re-decided in f64. Returns the partitions
    exported."""
    import numpy as np
    import torch

    from geomesa_tpu_torch.cql import compile_filter, parse_cql
    from geomesa_tpu_torch.cql import ast as _ast
    from geomesa_tpu_torch.engine.device import to_device

    dev = (torch.device(device) if device is not None
           else source.planner.device)
    storage = source.storage
    names = storage.partitions()
    f = parse_cql(cql)
    compiled = None if isinstance(f, _ast.Include) else compile_filter(f, storage.sft)

    def task(name: str):
        batches = list(storage.scan_partitions([name]))
        if not batches:
            return None
        batch = FeatureBatch.concat(batches)
        if compiled is not None:
            dv = to_device(batch, dev)
            # f64 borderline refinement for polygon predicates (no-op
            # otherwise) keeps distributed exports oracle-exact
            mask = compiled.mask_refined(dv, batch)
            batch = batch.select(np.nonzero(mask)[0])
        if not len(batch):
            return None
        writer(name, batch)
        return name

    out = []
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        for res in pool.map(task, names):
            if res is not None:
                out.append(res)
    return sorted(out)
