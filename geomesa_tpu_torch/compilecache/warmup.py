"""Manifest replay: build and capture everything before the server takes
traffic.

The port of the reference package's `compilecache/warmup.py`. `replay()`
walks a WarmupManifest:

- a library entry builds (or finds built) its kernel library with nvcc
  and resolves the entry point it names;
- a query entry runs through the store's planner, as a live request would
  (the compiled-filter cache, the residency, the capacity calibration),
  and a kNN entry, when the caller serves a ring (`ring_depth`), also
  arms its ring window class, which captures its graphs into the
  process-wide registry (`compilecache/registry.py`), where the service's
  own ring finds them;
- a ring entry is then checked: the query entries must have captured it,
  over this store's planners and for the same window class (`cls`).

`check()` answers "would serving still build or capture anything?":
replay, then replay again and count the new extension builds and the new
captures. Nonzero means not ok. Replays run with the stall meter muted on
their thread: warm-up work is ahead of time by definition.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from geomesa_tpu_torch.compilecache.manifest import (
    KernelEntry, QueryEntry, WarmupManifest)

MAX_ERRORS = 32


@dataclasses.dataclass
class WarmupReport:
    kernels_total: int = 0
    kernels_compiled: int = 0   # built (library) or captured (ring) here
    kernels_cached: int = 0     # already built or captured in this process
    kernels_failed: int = 0
    queries_total: int = 0
    queries_run: int = 0
    queries_failed: int = 0
    queries_skipped: int = 0    # query entries with no store to run against
    compile_time_s: float = 0.0
    residual_recompiles: Optional[int] = None  # set by check()
    errors: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (self.kernels_failed == 0 and self.queries_failed == 0
                and (self.residual_recompiles in (None, 0)))


def _note_error(report: WarmupReport, msg: str) -> None:
    if len(report.errors) < MAX_ERRORS:
        report.errors.append(msg)


def compile_counts() -> tuple:
    """(extension builds, ring captures) made in this process so far."""
    from geomesa_tpu_torch.compilecache.registry import registry
    from geomesa_tpu_torch.engine.kernels import build

    builds = sum(1 for v in build.build_log.values() if not v.get("cached"))
    return builds, registry.stats()["captures"]


def _replay_library(entry: KernelEntry, report: WarmupReport) -> None:
    from geomesa_tpu_torch.engine.kernels import build

    report.kernels_total += 1
    t0 = time.perf_counter()
    try:
        was = build.library_path(entry.library).exists()
        lib = build.load(entry.library)
        getattr(lib, entry.entry)
    except Exception as e:  # noqa: BLE001 — one bad entry must not
        report.kernels_failed += 1     # abort the rest of the warm-up
        _note_error(report, f"kernel {entry.label}: {type(e).__name__}: {e}")
        return
    report.compile_time_s += time.perf_counter() - t0
    if was:
        report.kernels_cached += 1
    else:
        report.kernels_compiled += 1


def _replay_query(entry: QueryEntry, report: WarmupReport, store,
                  ring_depth: Optional[int], owners: list) -> None:
    import numpy as np

    from geomesa_tpu_torch.plan.planner import RingIneligible
    from geomesa_tpu_torch.plan.query import Query

    report.queries_total += 1
    if store is None:
        report.queries_skipped += 1
        return
    t0 = time.perf_counter()
    try:
        source = store.get_feature_source(entry.type_name)
        owners.append(source.planner)
        query = Query(entry.type_name, entry.cql)
        if entry.op == "knn":
            q = max(int(entry.q), 1)
            k = max(int(entry.k), 1)
            impl = entry.impl or "sparse"
            # (0, 0) is a valid lon/lat: what is built and captured
            # depends on the padded [q] bucket and the store, not values
            source.planner.knn(query, np.zeros(q), np.zeros(q), k=k, impl=impl)
            if ring_depth is not None:
                try:
                    source.planner.ring_arm(query, q_padded=q, k=k,
                                            impl=impl, depth=ring_depth)
                except RingIneligible:
                    pass  # served on the pipelined route: nothing to capture
        elif entry.op == "count":
            source.planner.count(query)
        else:
            source.planner.execute(query)
    except Exception as e:  # noqa: BLE001
        report.queries_failed += 1
        _note_error(report, f"query {entry.label}: {type(e).__name__}: {e}")
        return
    report.queries_run += 1
    report.compile_time_s += time.perf_counter() - t0


def _check_ring(entry: KernelEntry, report: WarmupReport,
                captured_before: set, owners) -> None:
    from geomesa_tpu_torch.compilecache.registry import registry

    report.kernels_total += 1
    cap = registry.find(entry.library, entry.cls, entry.q, entry.k,
                        entry.capacity, entry.depth, owners=owners)
    if cap is None:
        report.kernels_failed += 1
        _note_error(report, f"kernel {entry.label}: no query entry of the "
                            "manifest armed this ring class")
    elif id(cap) in captured_before:
        report.kernels_cached += 1
    else:
        report.kernels_compiled += 1


def replay(manifest: WarmupManifest, store=None,
           ring_depth: Optional[int] = None) -> WarmupReport:
    """Warm every manifest entry: libraries first, then queries (which arm
    ring classes when `ring_depth` is given), then the ring entries'
    check. `store` (a DataStore) is needed for query entries; without one
    they count as skipped."""
    from geomesa_tpu_torch.compilecache.registry import registry
    from geomesa_tpu_torch.compilecache.stall import STALLS

    report = WarmupReport()
    before = {id(c) for c in registry.held()}
    owners: list = []
    with STALLS.suppressed():
        for entry in manifest.kernel_entries:
            if entry.kind_of == "library":
                _replay_library(entry, report)
        for entry in manifest.query_entries:
            _replay_query(entry, report, store, ring_depth, owners)
        for entry in manifest.kernel_entries:
            if entry.kind_of == "ring":
                if ring_depth is None:
                    report.kernels_total += 1
                    report.kernels_cached += 1  # not served: nothing to do
                else:
                    _check_ring(entry, report, before, owners)
            elif entry.kind_of != "library":
                report.kernels_total += 1
                report.kernels_failed += 1
                _note_error(report, f"unknown kernel entry kind "
                                    f"{entry.kind_of!r}")
    return report


def check(manifest: WarmupManifest, store=None,
          ring_depth: Optional[int] = None) -> WarmupReport:
    """Replay, then prove the replay covers itself: a second pass over
    every entry must build and capture NOTHING. The report's
    `residual_recompiles` is the count of new builds plus new captures
    (0 = serving a workload shaped like this manifest builds and captures
    nothing inline)."""
    report = replay(manifest, store=store, ring_depth=ring_depth)
    b0, c0 = compile_counts()
    second = replay(manifest, store=store, ring_depth=ring_depth)
    b1, c1 = compile_counts()
    report.residual_recompiles = (b1 - b0) + (c1 - c0)
    report.kernels_failed += second.kernels_failed
    report.queries_failed += second.queries_failed
    for msg in second.errors:
        _note_error(report, msg)
    return report
