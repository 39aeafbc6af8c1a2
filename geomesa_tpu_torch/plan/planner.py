"""The query planner and executor: counts, features, density and kNN.

The counterpart of the reference package's `plan/planner.py`: parse the
CQL, extract the primary bbox and interval, prune partitions, make them
resident (or scan them), evaluate the compiled f32 mask on the device
and re-decide the rows of its f32 boundary band in f64 on the host.

`execute` has the reference's two routes. The cached route (device cache
on, and neither sampling nor loose bbox) masks every resident row with
partition pruning as a lane mask; the scan route reads the pruned
partitions into one batch. On both, a count-only query sums the mask on
the device and corrects the sum over the band rows of the query's
partitions (`band_count_correction`); density grids the device mask
(cached) or the refined mask (scan); features fetch the mask, `refine`
it, sample it (scan route) and finish the matching rows (plan.runner).
`count` is `execute` with `count_only`.

kNN masks the rows the same way and runs the fused scan:

  plan -> _knn_mask_setup -> knn_sparse_launch | knn_fullscan_tiled
       -> the results' readback, enqueued behind the launch (one event)
       -> KnnLaunch.sync (waits on that event; overflow falls back to
          the dense scan)
       -> _canonical_dists (one f64 recompute of the reported meters)

`ring_arm` freezes one window class for the serve ring (the plan, the
mask, the tile list, the capacity, the fused count) and captures its
body as CUDA graphs (`compilecache/registry.py`); `RingProgram.launch`
replays one per window, with the same sync. On a mesh superbatch the
frozen body is the mesh serving program (B1 on every shard's frozen
tile list, the merge on the lead device).

The write-path stats sketches (`plan/stats_manager.py`, updated by
`FeatureSource.write`) give `explain` its estimate and resolve kNN's
`impl="auto"` between the sparse and the dense scan. A `stats_string`
hint makes `execute` return kind "stats": the Stat DSL evaluated over the
f64-exact mask (`plan.runner.run_stats`).

`execute`, `count`, `knn` and `knn_launch` take the reference's
`timeout_ms` deadline: cooperative checks after planning ("planning")
and after the scan or the kNN mask ("scan") raise the typed
`QueryTimeout`, and the call runs inside `faults.deadline_scope`.
On a mesh-resident superbatch (`DataStore.set_mesh`, `store/cache.py`)
a kNN window runs as one sharded program over every shard's rows
(`_knn_launch_mesh`: B1 on each shard, the merge on the lead device, the
dense sharded B2 scan on overflow), or, when every allowed partition's
rows live on one shard, as the single-device scan on that shard's rows
(`_knn_launch_local`, shard affinity). Either way the indices are the
serial ones, so sync and `_canonical_dists` run unchanged. Residency is
sharded there, so every mask is built shard by shard on the shards'
devices (`_mesh_knn_mask`, `_execute_mesh`): a count adds the shards'
sums, a density grid adds the shards' scatters (`density_sharded`), and
features and stats fetch the per-shard masks and concatenate them.

`execute` and `count` read `geomesa.query.timeout` when no timeout is
given; `knn` and `knn_launch` do not, as in the reference. Every
`execute` writes a `QueryEvent` into the store's audit writer.

Query interceptors (`plan/interceptor.py`) run once per query at the
head of `plan`; the rewritten query is authoritative from there on, and a
planner with interceptors refuses the ring ("interceptors"). Feature-level
visibility (`geomesa.vis.attr`) folds the `auths` hint's allow mask into
every mask: the allow table over the visibility vocabulary is made on the
host and gathered on the device by code (`plan.runner.visibility_mask`).
A `tolerance` hint routes count, density and `topk_cells` through the
sketch engine (`approx/`) when its a-priori bound fits; a miss, and
`topk_cells` without a tolerance, pay the exact device path. The device
coordinate dtype follows `geomesa.coord.dtype` (`coord_dtype`).

Telemetry: the planner opens the reference's spans at the same seams
(`plan`; `residency`; `scan` on the scan route, which has no streaming
count here; `kernel.dispatch` with `kernel="filter.mask"`, `"knn_sparse"`,
`"knn_fullscan"` or `"knn_mesh"`; `device.sync`, with `shards` and `ring`
on a kNN read; `aggregate`). They are host clocks, no-ops without a
scoped trace, and add no device op or host wait. Under
`geomesa.profile.dir` each `execute` route runs inside
`utils.profiling.device_trace("query")`, a torch.profiler trace.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch
from geomesa_tpu_torch.cql import ast, compile_filter, extract_bbox, extract_intervals
from geomesa_tpu_torch.cql.compile import CompiledFilter
from geomesa_tpu_torch.cql.extract import BBox, Interval
from geomesa_tpu_torch.engine.device import (
    VALID, Readback, fetch, side_stream, to_device, upload)
from geomesa_tpu_torch.engine.geodesy import haversine_m_np
from geomesa_tpu_torch.engine.knn_scan import (
    capacity_bucket, count_match_tiles, knn_fullscan, knn_fullscan_tiled,
    knn_fullscan_tiled_body, knn_sparse_body, knn_sparse_launch,
    pad_scan_inputs, select_match_tiles)
from geomesa_tpu_torch.faults import deadline_scope
from geomesa_tpu_torch.plan.audit import AuditWriter, QueryEvent
from geomesa_tpu_torch.plan.explain import Explainer
from geomesa_tpu_torch.plan.interceptor import run_interceptors
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.plan.runner import (
    CalibCache, _check_attr_auth, aggregate, density_device_grid,
    query_mask_token, sample_mask, visibility_mask)
from geomesa_tpu_torch.plan.stats_manager import StatsManager
from geomesa_tpu_torch.store.cache import DeviceCacheManager
from geomesa_tpu_torch.utils.padding import next_pow2
from geomesa_tpu_torch.utils.profiling import device_trace
from geomesa_tpu_torch.store.fs import FileSystemStorage
from geomesa_tpu_torch.telemetry.trace import TRACER
from geomesa_tpu_torch.utils.config import SystemProperties
from geomesa_tpu_torch.utils.metrics import metrics, note_device_op


class QueryTimeout(TimeoutError):
    """Typed deadline expiry carrying the phase that blew the budget and
    the elapsed wall time. Subclasses TimeoutError so every caller that
    catches the bare type keeps working; the serve scheduler needs the
    distinction between deadline expiry, shed load
    (serve.scheduler.QueryRejected), and real errors."""

    def __init__(self, phase: str, elapsed_ms: float, timeout_ms: float):
        super().__init__(
            f"query exceeded timeout={timeout_ms:.0f}ms during {phase} "
            f"(elapsed {elapsed_ms:.0f}ms)"
        )
        self.phase = phase
        self.elapsed_ms = elapsed_ms
        self.timeout_ms = timeout_ms


def _deadline(timeout_ms: Optional[int]) -> Optional[float]:
    """The absolute time.monotonic() deadline of a budget (None = none)."""
    return time.monotonic() + timeout_ms / 1000.0 if timeout_ms else None


def _timeout_check(timeout_ms: Optional[int]):
    """A `check(phase)` that raises QueryTimeout once more than
    `timeout_ms` has passed since this call (never when it is 0/None)."""
    t0 = time.perf_counter()

    def check(phase: str) -> None:
        elapsed_ms = (time.perf_counter() - t0) * 1000
        if timeout_ms and elapsed_ms > timeout_ms:
            raise QueryTimeout(phase, elapsed_ms, timeout_ms)

    return check


@dataclasses.dataclass
class QueryResult:
    """What `execute` returns: kind "features" carries the matching rows
    (None when no row matched) and their count, kind "density" the
    [height, width] f32 grid and the match count, kind "stats" the
    evaluated Stat sequence and the match count, kind "arrow" the Arrow
    IPC bytes and kind "bin" the BIN records (each with the match count),
    kind "topk_cells" the densest world-grid cells (in `stats`), kind
    "count" only the count. A sketch-served answer sets `approx` and its
    deterministic `bound` (the exact value lies within +- bound) with its
    `confidence`."""

    kind: str
    features: Optional[FeatureBatch] = None
    grid: Optional[np.ndarray] = None
    count: int = 0
    stats: object = None
    bin_bytes: Optional[bytes] = None
    arrow_bytes: Optional[bytes] = None
    approx: bool = False
    bound: float = 0.0
    confidence: float = 1.0
    # the manifest commit version the result was pinned to
    version: Optional[int] = None


@dataclasses.dataclass
class QueryPlan:
    query: Query
    filter: ast.Filter
    bbox: BBox
    interval: Interval
    partitions: List[str]
    compiled: Optional[CompiledFilter]
    # plan-time manifest snapshot: residency loads pin to the same
    # committed write version the pruning saw
    manifest: Optional[dict] = None
    # the filter as canonical CQL, serialised once a plan: the text of a
    # polygon literal costs milliseconds
    cql: str = ""
    # the residual's canonical CQL (what `compiled` evaluates): differs
    # from `cql` under loose bbox, which drops the BBOX from the residual
    residual_cql: str = ""
    # the storage's partitions before pruning
    total_partitions: int = 0


class QueryPlanner:
    def __init__(self, storage: FileSystemStorage, device: torch.device,
                 cache: Optional[DeviceCacheManager] = None,
                 audit: Optional[AuditWriter] = None, mesh=None):
        self.storage = storage
        self.device = device
        self.cache = cache
        self.audit = audit
        # the store's serving mesh; the device cache's decides the route
        self.mesh = mesh
        # QueryInterceptor SPI: callables Query -> Query run before
        # planning (plan/interceptor.py)
        self.interceptors: List = []
        self.coord_dtype = (torch.float64
                            if SystemProperties.COORD_DTYPE.get() == "float64"
                            else torch.float32)
        # guards the compiled-filter cache, the kNN capacity cache and the
        # stats-manager singleton
        self._mutex = threading.Lock()
        self._compiled_filters: dict = {}
        self._knn_caps: dict = {}
        self._zcalib = CalibCache()
        self._stats_mgr: Optional[StatsManager] = None
        self._approx_engine = None

    # -- planning ----------------------------------------------------------

    def plan(self, query: Query, explain: Optional[Explainer] = None) -> QueryPlan:
        # telemetry seam: interceptors, bounds, pruning and the residual's
        # compile as one span (a no-op for an unscoped caller)
        with TRACER.span("plan"):
            return self._plan(query, explain)

    def _plan(self, query: Query, explain: Optional[Explainer]) -> QueryPlan:
        e = explain or Explainer()
        query = run_interceptors(query, self.interceptors, e)
        sft = self.storage.sft
        f = query.filter_ast
        cql = ast.to_cql(f)
        e.push(f"Planning '{query.type_name}' {cql}")
        g = sft.default_geometry
        d = sft.default_dtg
        bbox = extract_bbox(f, g.name) if g else BBox(-180, -90, 180, 90)
        interval = extract_intervals(f, d.name) if d else Interval(None, None)
        e(f"Primary bbox: ({bbox.xmin}, {bbox.ymin}, {bbox.xmax}, {bbox.ymax})")
        e(f"Primary interval: [{interval.start}, {interval.end}]")
        # a storage without a manifest (the live layer's) prunes and
        # counts its partitions itself, as in the reference
        snapshot_fn = getattr(self.storage, "manifest_snapshot", None)
        manifest = snapshot_fn() if snapshot_fn is not None else None
        if manifest is not None:
            partitions = self.storage.prune_partitions(bbox, interval,
                                                       manifest=manifest)
            total = len(manifest)
        else:
            partitions = self.storage.prune_partitions(bbox, interval)
            total = len(self.storage.partitions())
        e(f"Partitions: {len(partitions)} of {total} after pruning")
        est = self._stats_estimate(bbox, interval)
        if est is not None:
            e(f"Estimated matches (stats sketches): ~{est}")
        if query.hints.query_index:
            e(f"Index override requested: {query.hints.query_index!r} "
              "(single-strategy partition store; recorded only)")
        residual, residual_cql = f, cql
        if query.hints.loose_bbox and g is not None:
            residual = _loosen_bbox(residual, g.name)
            residual_cql = ast.to_cql(residual)
            e("Loose bbox: default-geometry BBOX predicates dropped from residual")
        compiled = None
        if not isinstance(residual, ast.Include):
            compiled = self._compile_cached(residual, residual_cql)
            e(f"Residual predicate: compiled mask over "
              f"{len(compiled.builders)} param table(s)")
        else:
            e("Residual predicate: none (INCLUDE)")
        if query.hints.is_density:
            e(f"Aggregation: density {query.hints.density_width}x"
              f"{query.hints.density_height} over {query.hints.density_bbox}")
        elif query.hints.is_stats:
            e(f"Aggregation: stats {query.hints.stats_string!r}")
        elif query.hints.is_bin:
            e(f"Aggregation: bin track={query.hints.bin_track}")
        e.pop()
        return QueryPlan(query, f, bbox, interval, partitions, compiled,
                         manifest=manifest, cql=cql, residual_cql=residual_cql,
                         total_partitions=total)

    def _compile_cached(self, residual: ast.Filter, key: str) -> CompiledFilter:
        """Reuse CompiledFilter across queries keyed on canonical CQL
        (`key`, the residual's)."""
        with self._mutex:
            got = self._compiled_filters.get(key)
        if got is not None:
            return got
        compiled = compile_filter(residual, self.storage.sft)
        with self._mutex:
            if len(self._compiled_filters) > 256:  # bound memory
                self._compiled_filters.clear()
            return self._compiled_filters.setdefault(key, compiled)

    # -- stats --------------------------------------------------------------

    def stats_manager(self) -> StatsManager:
        with self._mutex:
            if self._stats_mgr is None:
                self._stats_mgr = StatsManager(self.storage)
            return self._stats_mgr

    def _stats_estimate(self, bbox: BBox, interval: Interval):
        """Sketch-based selectivity (StatsBasedEstimator analog); None when
        no stats exist (neither analyzed nor write-path updated)."""
        mgr = self.stats_manager()
        mgr.refresh()
        if not mgr.stats:
            return None
        return mgr.estimate_count(bbox, interval)

    def update_stats(self, batch) -> None:
        """Write-path stats hook (StatUpdater analog): called by
        FeatureSource.write after the storage append."""
        self.stats_manager().update(batch)

    def _knn_impl_from_stats(self, plan: QueryPlan) -> str:
        """kNN `impl="auto"`: the dense fullscan when the sketches estimate
        that at least KNN_FULLSCAN_SELECTIVITY (default 0.5) of the store
        matches the plan's bbox and interval (nearly every tile bears a
        match, so the sparse scan cannot prune), else the sparse scan. The
        Z3 sketch is an upper bound, so a high estimate only forfeits
        pruning, never correctness. Sparse also when no spatial sketch
        exists (the estimate would be the bbox-blind store count) and when
        the filter has predicates the sketches cannot see."""
        total = getattr(self.storage, "count", 0) or 0
        if total <= 0:
            return "sparse"
        mgr = self.stats_manager()
        mgr.refresh()
        if "z3" not in mgr.stats and "z2" not in mgr.stats:
            return "sparse"
        if self._has_attribute_predicates(plan.filter):
            return "sparse"
        est = mgr.estimate_count(plan.bbox, plan.interval)
        if est is None:
            return "sparse"
        thresh = float(SystemProperties.KNN_FULLSCAN_SELECTIVITY.get())
        return "fullscan" if est >= thresh * total else "sparse"

    def _has_attribute_predicates(self, f) -> bool:
        """True if the filter references anything the spatial/temporal
        sketches cannot estimate: comparisons, IN/LIKE/BETWEEN/IsNull on
        attributes, or spatial/temporal predicates on non-default columns."""
        sft = self.storage.sft
        g = sft.default_geometry
        d = sft.default_dtg
        gname = g.name if g is not None else None
        dname = d.name if d is not None else None
        for node in ast.walk(f):
            if isinstance(node, (ast.SpatialPredicate, ast.DistancePredicate)):
                if node.prop.name != gname:
                    return True
            elif isinstance(node, ast.TemporalPredicate):
                if node.prop.name != dname:
                    return True
            elif isinstance(node, ast.Comparison):
                # dtg range comparisons are sketch-visible
                names = [e.name for e in (node.left, node.right)
                         if isinstance(e, ast.Property)]
                if any(nm != dname for nm in names):
                    return True
            elif isinstance(node, (ast.Between, ast.Like, ast.In, ast.IsNull)):
                return True
        return False

    # -- the f64-exact mask ------------------------------------------------

    def _resident(self, plan: QueryPlan):
        """Make the plan's partitions resident: (superbatch, allowed), with
        `allowed` a bool per resident partition that the plan keeps, or
        None when no resident row can match."""
        with TRACER.span("residency"):
            self.cache.ensure(plan.partitions, manifest=plan.manifest)
            sb = self.cache.superbatch()
        if sb is None:
            return None, None
        allowed = np.zeros(max(len(sb.ids), 1), bool)
        for name in plan.partitions:
            i = sb.ids.get(name)
            if i is not None:
                allowed[i] = True
        return sb, (allowed if allowed.any() else None)

    def _scan_batch(self, plan: QueryPlan):
        """The plan's partitions read into one batch padded to a power of
        two (only the columns the query needs), and its device tensors;
        (None, None) when nothing is read."""
        with TRACER.span("scan"):
            batches = list(self.storage.scan(
                plan.bbox, plan.interval,
                columns=_needed_columns(plan, self.storage.sft)))
        if not batches:
            return None, None
        batch = FeatureBatch.concat(batches)
        batch = batch.pad_to(next_pow2(len(batch)))
        return batch, to_device(batch, self.device, self.coord_dtype)

    @staticmethod
    def _raw_mask(plan: QueryPlan, dev, batch) -> torch.Tensor:
        """The compiled f32 device mask (validity when there is no filter)."""
        return (plan.compiled.mask(dev, batch) if plan.compiled is not None
                else dev[VALID])

    def _knn_mask_setup(self, plan: QueryPlan, query: Query, resident=None):
        """Residency (or scan) + the f64-exact filter mask: returns
        (sb, batch, dev, mask, is_empty); `sb` is None on the scan path.
        Band corrections are scattered in, ANDed with row validity and,
        on the cached path, with the partition allowance; the query's
        visibility mask is folded last, so no row its auths cannot see is
        anyone's neighbour. `resident`: the caller's `_resident(plan)`,
        when it already has it.

        On the cached path the mask is built on a side stream ordered
        after the superbatch's build alone (`engine.device.side_stream`):
        its uploads are pinned and non_blocking, the band rows' partition
        ids are looked up on the host, and the one host read it needs (the
        band rows) waits for the mask's own passes, not for a previous
        window's kernels still queued on the caller's stream."""
        sb = None
        if self.cache is not None:
            sb, allowed = resident if resident is not None else self._resident(plan)
            if allowed is None:
                return None, None, None, None, True
            batch, dev = sb.batch, sb.dev
            if sb.mesh is not None:
                return (sb, batch, dev,
                        self._mesh_knn_mask(plan, query, sb, allowed), False)
            with side_stream(self.device, after=sb.ready) as keep:
                with TRACER.span("kernel.dispatch", kernel="filter.mask"):
                    mask = (self._raw_mask(plan, dev, batch)
                            & upload(allowed, self.device)[sb.pids])
                note_device_op()
                if plan.compiled is not None and plan.compiled.has_band:
                    bidx, bexact = plan.compiled.band_corrections(dev, batch)
                    if len(bidx):
                        bexact = (bexact & batch.valid[bidx]
                                  & allowed[sb.host_pids(bidx)])
                        mask[upload(bidx, self.device)] = upload(
                            bexact, self.device)
                vm = visibility_mask(self.storage.sft, batch, dev,
                                     query.hints)
                if vm is not None:
                    mask &= vm
                keep(mask)
        else:
            batch, dev = self._scan_batch(plan)
            if batch is None:
                return None, None, None, None, True
            with TRACER.span("kernel.dispatch", kernel="filter.mask"):
                mask = self._raw_mask(plan, dev, batch) & dev[VALID]
            note_device_op()
            if plan.compiled is not None and plan.compiled.has_band:
                bidx, bexact = plan.compiled.band_corrections(dev, batch)
                if len(bidx):
                    mask[torch.from_numpy(bidx).to(self.device)] = (
                        torch.from_numpy(bexact & batch.valid[bidx]).to(self.device))
            vm = visibility_mask(self.storage.sft, batch, dev, query.hints)
            if vm is not None:
                mask &= vm
        return sb, batch, dev, mask, False

    def _mesh_knn_mask(self, plan: QueryPlan, query: Query, sb, allowed):
        """`_knn_mask_setup`'s cached mask on a mesh superbatch, shard by
        shard on the shards' devices (each on its side stream, after its
        shard's build): the compiled mask, the partition allowance
        gathered by the shard's partition ids, the band rows re-decided in
        f64 and scattered into the shard (their rows local to it) and the
        visibility mask. Returns the `Sharded` mask; no shard's rows leave
        its device."""
        from geomesa_tpu_torch.parallel.mesh import Sharded, my_shards, on_shard

        mesh, s_rows = sb.mesh, sb.shard_rows
        batch = sb.batch
        has_band = plan.compiled is not None and plan.compiled.has_band
        out: list = [None] * mesh.size
        devs = sb.shard_devs()
        with TRACER.span("kernel.dispatch", kernel="filter.mask"):
            for i, d in my_shards(mesh):
                dv = devs[i]
                with on_shard(d), side_stream(d, after=sb.ready[i]) as keep:
                    m = (self._raw_mask(plan, dv, batch)
                         & upload(allowed, d)[sb.pids.shards[i]])
                    note_device_op()
                    if has_band:
                        off = i * s_rows
                        bidx, bexact = plan.compiled.band_corrections(
                            dv, batch, row_offset=off)
                        if len(bidx):
                            rows = bidx + off
                            bexact = (bexact & batch.valid[rows]
                                      & allowed[sb.host_pids(rows)])
                            m[upload(bidx, d)] = upload(bexact, d)
                    vm = visibility_mask(self.storage.sft, batch, dv, query.hints)
                    if vm is not None:
                        m &= vm
                    keep(m)
                out[i] = m
        return Sharded(mesh, out)

    # -- execute -----------------------------------------------------------

    def execute(self, query: "Query | str",
                explain: Optional[Explainer] = None,
                timeout_ms: Optional[int] = None) -> QueryResult:
        """Plan and run one query: the cached route when the device cache
        is on, except with sampling (every n-th is defined over the global
        match order, not per partition) or loose bbox (the scan route
        re-applies the bbox by parquet pushdown, which resident whole
        partitions cannot), which take the scan route, as in the
        reference. `timeout_ms` overrides geomesa.query.timeout for this
        query (0 = none): the planner raises QueryTimeout after planning
        and, on the scan route, after the scan, once it has passed."""
        if timeout_ms is None:
            timeout_ms = int(SystemProperties.QUERY_TIMEOUT_MS.get())
        with deadline_scope(_deadline(timeout_ms)):
            return self._execute_deadlined(query, explain, timeout_ms)

    def _execute_deadlined(self, query, explain, timeout_ms) -> QueryResult:
        if isinstance(query, str):
            query = Query(self.storage.sft.name, query)
        t0 = time.perf_counter()
        check_timeout = _timeout_check(timeout_ms)
        plan = self.plan(query, explain)
        # interceptors may have rewritten more than the filter: the
        # rewritten query is authoritative from here on
        query = plan.query
        t_plan = time.perf_counter()
        check_timeout("planning")
        hints = query.hints
        if hints.is_density:
            # both routes refuse a weight the auths cannot see (the
            # reference checks it on the scan route only)
            _check_attr_auth(self.storage.sft, hints, [hints.density_weight])
        if hints.topk_cells or (hints.tolerance is not None
                                and (hints.count_only or hints.is_density)):
            # the sketch tier answers iff the a-priori bound fits; every
            # miss (metered) pays the exact path below, on the device
            result = None
            if hints.tolerance is not None:
                result = self.approx_engine().answer(plan, query)
            if result is None and hints.topk_cells:
                result = self._topk_exact(query, plan, timeout_ms)
            if result is not None:
                t_done = time.perf_counter()
                self._record(query, plan, int(result.count), t0, t_plan,
                             t_plan, t_done)
                return result
        # geomesa.profile.dir: a torch.profiler trace of the route (a
        # no-op when unset; utils/profiling.py)
        with device_trace("query", self.device):
            if (self.cache is not None and not hints.sampling
                    and not hints.loose_bbox):
                result, mask_count, t_scan = self._execute_cached(plan, query)
            else:
                result, mask_count, t_scan = self._execute_scan(
                    plan, query, check_timeout)
        self._record(query, plan, mask_count, t0, t_plan, t_scan,
                     time.perf_counter())
        if result.version is None and plan.manifest is not None:
            result.version = getattr(plan.manifest, "version", None)
        return result

    def _record(self, query, plan, mask_count, t0, t_plan, t_scan, t_done):
        """The query's metrics and its QueryEvent in the audit writer."""
        metrics.counter("query.count")
        metrics.counter("query.features.matched", mask_count)
        metrics.timer("query.plan").timer.update(t_plan - t0)
        metrics.timer("query.scan").timer.update(t_scan - t_plan)
        metrics.timer("query.compute").timer.update(t_done - t_scan)
        if self.audit is not None:
            self.audit.write(QueryEvent(
                type_name=query.type_name,
                filter=plan.cql,
                hints=str(query.hints),
                plan_time_ms=(t_plan - t0) * 1000,
                scan_time_ms=(t_scan - t_plan) * 1000,
                compute_time_ms=(t_done - t_scan) * 1000,
                result_count=mask_count,
                partitions_scanned=len(plan.partitions),
                partitions_total=plan.total_partitions,
            ))

    def _execute_cached(self, plan: QueryPlan, query: Query):
        """Over the cache's superbatch: one mask over every resident row,
        with partition pruning as a lane mask (allowed[pid]). A count is
        the device sum corrected over the band rows of the allowed
        partitions; density grids the raw f32 device mask (its cells dwarf
        the ~1e-7 degree band); features fetch the mask once and refine
        its band rows in f64 within the allowance. Returns (result,
        matching rows, the time residency ended)."""
        hints = query.hints
        sb, allowed = self._resident(plan)
        t_scan = time.perf_counter()
        if allowed is None:
            return self._empty_result(query), 0, t_scan
        if sb.mesh is not None:
            return self._execute_mesh(plan, query, sb, allowed) + (t_scan,)
        with TRACER.span("kernel.dispatch", kernel="filter.mask"):
            allowed_rows = torch.from_numpy(allowed).to(self.device)[sb.pids]
            vm = visibility_mask(self.storage.sft, sb.batch, sb.dev, hints)
            if vm is not None:
                # the band rows re-decided in f64 stay within the auths too
                allowed_rows = allowed_rows & vm
            dev_mask = self._raw_mask(plan, sb.dev, sb.batch) & allowed_rows
        has_band = plan.compiled is not None and plan.compiled.has_band

        if hints.count_only and not hints.sampling:
            r = self._count_result(plan, sb.dev, sb.batch, dev_mask,
                                   extra=allowed_rows)
            return r, r.count, t_scan

        if hints.is_density:
            # partition pruning feeds the mask too: a plan scanning other
            # partitions never reuses the calibration
            token = query_mask_token(query) + (tuple(sorted(plan.partitions)),)
            grid = density_device_grid(self.storage.sft, sb.batch, sb.dev,
                                       dev_mask, hints, self._zcalib,
                                       mask_token=token, mesh=sb.mesh)
            grid, total = fetch(grid, dev_mask.sum(dtype=torch.int32))
            if int(total) == 0:
                return self._empty_result(query), 0, t_scan
            return (QueryResult("density", grid=grid, count=int(total)),
                    int(total), t_scan)

        # stats and features: one mask fetch; the band rows of the
        # allowed partitions take their f64 value (the rest keep the
        # device mask, which already holds the allowance)
        with TRACER.span("device.sync"):
            (mask,) = fetch(dev_mask)
        if has_band:
            mask = plan.compiled.refine(mask, sb.dev, sb.batch,
                                        extra=allowed_rows)
        if not mask.any():
            return self._empty_result(query), 0, t_scan
        with TRACER.span("aggregate"):
            result, matched = aggregate(self.storage.sft, sb.batch, sb.dev,
                                        mask, query, self._zcalib)
        return result, matched, t_scan

    def _mesh_masks(self, plan: QueryPlan, hints, sb, allowed):
        """Each shard's f32 mask on its device: the compiled mask AND the
        allowance gathered by the shard's partition ids AND the visibility
        mask (no band correction). Returns (masks, extras), one a shard:
        `extras` are the allowance AND visibility, which a band row
        re-decided in f64 must also pass."""
        from geomesa_tpu_torch.parallel.mesh import my_shards, on_shard

        masks, extras = [], []
        devs = sb.shard_devs()
        for i, d in my_shards(sb.mesh):
            dv = devs[i]
            with on_shard(d):
                ar = upload(allowed, d)[sb.pids.shards[i]]
                vm = visibility_mask(self.storage.sft, sb.batch, dv, hints)
                if vm is not None:
                    # the band rows re-decided in f64 stay within the auths
                    ar = ar & vm
                masks.append(self._raw_mask(plan, dv, sb.batch) & ar)
                extras.append(ar)
        return masks, extras

    def _execute_mesh(self, plan: QueryPlan, query: Query, sb, allowed):
        """`_execute_cached` on a mesh superbatch, shard by shard: each
        shard's mask (the compiled mask, the allowance gathered by its
        partition ids and the visibility mask) on its device. A count adds
        the shards' sums (`psum`) and each shard's f64 band correction; a
        density grids the per-shard masks as they are; features and stats
        fetch the per-shard masks (one read), concatenate them in shard
        order and refine each shard's band rows. Returns (result, matching
        rows).

        On a mesh that spans processes a count and a density merge through
        collectives (`psum`, and the band corrections' `host_sum`) and
        every process gets the answer; features, Arrow, BIN and stats need
        every row's mask in one process, which would gather other
        processes' shards: they raise `RemoteShardError`, as the
        reference raises on a mesh with non-addressable devices."""
        from geomesa_tpu_torch.parallel.mesh import (
            Sharded, gather, host_sum, my_shards, on_shard, psum)

        hints = query.hints
        mesh, s_rows, batch = sb.mesh, sb.shard_rows, sb.batch
        devs = sb.shard_devs()
        with TRACER.span("kernel.dispatch", kernel="filter.mask"):
            masks, extras = self._mesh_masks(plan, hints, sb, allowed)
        has_band = plan.compiled is not None and plan.compiled.has_band

        def shard_sums():
            return psum(mesh, [m.sum(dtype=torch.int64) for m in masks])

        if hints.count_only and not hints.sampling:
            with TRACER.span("device.sync"):
                (total,) = fetch(shard_sums())
            total = int(total)
            if has_band:
                corr = 0
                for (i, d), m, ex in zip(my_shards(mesh), masks, extras):
                    with on_shard(d):
                        corr += plan.compiled.band_count_correction(
                            devs[i], batch, m, extra=ex,
                            row_offset=i * s_rows)
                total += host_sum(mesh, corr)
            return QueryResult("count", count=total), total
        if hints.is_density:
            token = query_mask_token(query) + (tuple(sorted(plan.partitions)),)
            grid = density_device_grid(self.storage.sft, batch, sb.dev,
                                       Sharded.from_local(mesh, masks), hints,
                                       self._zcalib, mask_token=token,
                                       mesh=mesh)
            grid, total = fetch(grid, shard_sums())
            if int(total) == 0:
                return self._empty_result(query), 0
            return QueryResult("density", grid=grid, count=int(total)), int(total)
        if mesh.spans_processes:
            gather(Sharded.from_local(mesh, masks), "mask")  # counted, refused
        with TRACER.span("device.sync"):
            mask = np.concatenate(fetch(*masks))
        if has_band:
            for (i, d), ex in zip(my_shards(mesh), extras):
                with on_shard(d):
                    mask = plan.compiled.refine(mask, devs[i], batch,
                                                extra=ex,
                                                row_offset=i * s_rows)
        if not mask.any():
            return self._empty_result(query), 0
        with TRACER.span("aggregate"):
            return aggregate(self.storage.sft, batch, sb.dev, mask, query,
                             self._zcalib)

    def _execute_scan(self, plan: QueryPlan, query: Query, check_timeout):
        """Scan the pruned partitions into one padded batch. A count is the
        device sum corrected over the band rows; otherwise fetch the mask,
        re-decide its band rows in f64 on the host, sample it, then grid
        or select. Returns (result, matching rows, the time the scan
        ended); raises QueryTimeout ("scan") past the deadline."""
        hints = query.hints
        batch, dev = self._scan_batch(plan)
        t_scan = time.perf_counter()
        check_timeout("scan")
        if batch is None:
            return self._empty_result(query), 0, t_scan
        with TRACER.span("kernel.dispatch", kernel="filter.mask"):
            dev_mask = self._raw_mask(plan, dev, batch)
        vm = visibility_mask(self.storage.sft, batch, dev, hints)
        if vm is not None:
            # rows the auths cannot see are invisible to counts and to
            # every aggregation
            dev_mask = dev_mask & vm
        if hints.count_only and not hints.sampling:
            r = self._count_result(plan, dev, batch, dev_mask, extra=vm)
            return r, r.count, t_scan
        with TRACER.span("device.sync"):
            (mask,) = fetch(dev_mask)
        if plan.compiled is not None and plan.compiled.has_band:
            mask = plan.compiled.refine(mask, dev, batch, extra=vm)
        if hints.sampling:
            groups = None
            if hints.sample_by:
                col = batch.columns[hints.sample_by]
                groups = (np.asarray(col.codes) if isinstance(col, DictColumn)
                          else np.asarray(col))
            mask = sample_mask(mask, hints.sampling, groups)
        with TRACER.span("aggregate"):
            result, matched = aggregate(self.storage.sft, batch, dev, mask,
                                        query, self._zcalib)
        return result, matched, t_scan

    @staticmethod
    def _count_result(plan: QueryPlan, dev, batch, dev_mask,
                      extra=None) -> QueryResult:
        """The device sum of `dev_mask` (which holds `extra`), corrected
        in f64 over the band rows within `extra`: one scalar read and
        one small fetch instead of the mask."""
        with TRACER.span("device.sync"):
            (total,) = fetch(dev_mask.sum(dtype=torch.int64))
        total = int(total)
        if plan.compiled is not None and plan.compiled.has_band:
            total += plan.compiled.band_count_correction(
                dev, batch, dev_mask, extra=extra)
        return QueryResult("count", count=total)

    def _empty_result(self, query: Query) -> QueryResult:
        """No row can match: a zero grid for density, the unobserved
        stats for a stats query, an empty IPC stream with the result's
        schema (sort metadata included) for arrow, no records for bin,
        else kind features with no batch; the kind never depends on
        whether rows matched (arrow before bin, as in `aggregate`)."""
        h = query.hints
        if h.is_density:
            return QueryResult("density", grid=np.zeros(
                (h.density_height, h.density_width), np.float32))
        if h.is_stats:
            from geomesa_tpu_torch.stats import parse_stats

            return QueryResult("stats", stats=parse_stats(h.stats_string))
        if h.is_arrow:
            from geomesa_tpu_torch.plan.runner import arrow_payload, finish_features

            sft = self.storage.sft
            empty = FeatureBatch.from_pydict(
                sft, {a.name: [] for a in sft.attributes})
            return QueryResult("arrow", arrow_bytes=arrow_payload(
                finish_features(empty, query), h))
        if h.is_bin:
            return QueryResult("bin", bin_bytes=b"")
        return QueryResult("features", features=None, count=0)

    # -- approximate answers -------------------------------------------------

    def approx_engine(self):
        """The lazily-built sketch answer engine (one per planner, like
        the stats manager; approx/engine.py)."""
        with self._mutex:
            if self._approx_engine is None:
                from geomesa_tpu_torch.approx.engine import SketchAnswerEngine

                self._approx_engine = SketchAnswerEngine(self)
            return self._approx_engine

    def _topk_exact(self, query: Query, plan: QueryPlan,
                    timeout_ms: Optional[int]) -> QueryResult:
        """Exact topk_cells: one device density over the sketch-aligned
        world grid (the filter mask restricts it to matching rows), then
        an exact host top-k ranked by (-count, row, col), with the same
        cell geometry as the sketch path."""
        from geomesa_tpu_torch.approx.sketches import DEFAULT_BINS

        eng = self.approx_engine()
        b = (eng.store.bins_per_dim if eng.store is not None
             else DEFAULT_BINS)
        k = int(query.hints.topk_cells)
        dq = dataclasses.replace(query, hints=dataclasses.replace(
            query.hints, topk_cells=None, tolerance=None, count_only=False,
            density_bbox=(-180.0, -90.0, 180.0, 90.0),
            density_width=b, density_height=b))
        r = self._execute_deadlined(dq, None, timeout_ms)
        cells: List[dict] = []
        if r.grid is not None:
            grid = np.asarray(r.grid)
            for rr, cc in zip(*np.nonzero(grid)):
                cells.append({
                    "row": int(rr), "col": int(cc),
                    "bbox": [-180.0 + cc * 360.0 / b,
                             -90.0 + rr * 180.0 / b,
                             -180.0 + (cc + 1) * 360.0 / b,
                             -90.0 + (rr + 1) * 180.0 / b],
                    "count": int(round(float(grid[rr, cc]))),
                    "bound": 0,
                })
            cells.sort(key=lambda d: (-d["count"], d["row"], d["col"]))
            cells = cells[:k]
        return QueryResult("topk_cells", stats=cells,
                           count=sum(c["count"] for c in cells),
                           version=r.version)

    def approx_count_result(self, query: Query) -> Optional[QueryResult]:
        """Admission-time sketch peek (serve/service.py): the microsecond
        count path only, over sketches already built; None on any miss, so
        the caller queues the request for the exact path. A planner with
        interceptors declines (the peek must not run a chain the queued
        path runs again)."""
        if query.hints.tolerance is None:
            return None
        if self.interceptors and not query.intercepted:
            return None
        # the property guard still judges the query: a blocked full-table
        # count raises here, and the queued path then answers it typed
        query = run_interceptors(query, [])
        return self.approx_engine().fast_count(query, build=False)

    # -- count -------------------------------------------------------------

    def count(self, query: "Query | str",
              timeout_ms: Optional[int] = None) -> int:
        """Exact match count: `execute` with count_only, capped by
        max_features. With exact_count=False and INCLUDE, the manifest
        row count, unless geomesa.force.count is set. A sketch-served
        answer (tolerance hint) returns an `ApproxCount`: an int carrying
        `.bound` and `.confidence`. `timeout_ms` propagates into the
        nested execute."""
        r = self.count_result(query, timeout_ms=timeout_ms)
        n = int(r.count)
        if r.approx:
            from geomesa_tpu_torch.approx.engine import ApproxCount

            return ApproxCount(n, int(r.bound), r.confidence)
        return n

    def count_result(self, query: "Query | str",
                     timeout_ms: Optional[int] = None) -> QueryResult:
        """`count` with provenance: a QueryResult(kind="count") carrying
        the committed manifest version the answer was pinned to (the
        serve result cache's key, approx/cache.py) and any approx bound.
        The serve batcher calls this. The interceptor chain runs here,
        once: the estimate shortcut must see the rewritten query, and the
        nested execute's plan passes the marked query through."""
        if isinstance(query, str):
            query = Query(self.storage.sft.name, query)
        query = run_interceptors(query, self.interceptors)
        if query.hints.distinct is not None:
            self._validate_distinct(query.hints.distinct)
        if (not query.hints.exact_count
                and not SystemProperties.FORCE_COUNT.get()
                and isinstance(query.filter_ast, ast.Include)
                # a manifest row count is not a distinct-value count
                and query.hints.distinct is None
                # a manifest count knows nothing about auths
                and not (self.storage.sft.user_data or {}).get(
                    "geomesa.vis.attr")):
            snap_fn = getattr(self.storage, "manifest_snapshot", None)
            if snap_fn is not None:
                # one snapshot pins count AND version atomically
                snap = snap_fn()
                n = sum(int(e["count"]) for files in snap.values()
                        for e in files)
                version = snap.version
            else:
                # no manifest, no version: nothing may cache this count
                n = self.storage.count
                version = None
            if query.max_features is not None:
                n = min(n, query.max_features)
            return QueryResult("count", count=n, version=version)
        if query.hints.tolerance is not None:
            # the microsecond path: memoized sketch merge; a miss is
            # metered and falls through to the exact path
            r = self.approx_engine().fast_count(query)
            if r is not None:
                return r
        if query.hints.distinct is not None:
            return self._distinct_exact(query, timeout_ms=timeout_ms)
        # tolerance stripped: fast_count above was the sketch attempt
        r = self.execute(dataclasses.replace(
            query, hints=dataclasses.replace(
                query.hints, count_only=True, tolerance=None)),
            timeout_ms=timeout_ms)
        if r.kind == "features":
            n = len(r.features) if r.features is not None else 0
        else:
            n = r.count
        if query.max_features is not None:
            n = min(n, query.max_features)
        return QueryResult("count", count=n, version=r.version,
                           approx=r.approx, bound=r.bound,
                           confidence=r.confidence)

    def _validate_distinct(self, attr: str) -> None:
        """A bad `distinct` hint is the client's error: answer it typed,
        not as a KeyError from a scan."""
        from geomesa_tpu_torch.core.sft import GEOMETRY_TYPES

        sft = self.storage.sft
        if attr not in sft:
            raise ValueError(
                f"distinct attribute {attr!r} not in schema {sft.name!r}")
        if sft.attribute(attr).type in GEOMETRY_TYPES:
            raise ValueError(
                f"distinct over geometry attribute {attr!r} is not "
                f"supported")

    def _distinct_exact(self, query: Query,
                        timeout_ms: Optional[int] = None) -> QueryResult:
        """Exact COUNT(DISTINCT attr): execute the query as features (the
        device mask, visibility and interceptors included) and count the
        named column's unique values on the host."""
        attr = query.hints.distinct
        q = dataclasses.replace(query, hints=dataclasses.replace(
            query.hints, tolerance=None, distinct=None, count_only=False))
        r = self.execute(q, timeout_ms=timeout_ms)
        feats = r.features
        n = 0
        if feats is not None and len(feats):
            col = feats.columns[attr]
            if isinstance(col, DictColumn):
                from geomesa_tpu_torch.approx.engine import present_values

                n = len(np.unique(present_values(col).astype(str)))
            else:
                n = len(np.unique(np.asarray(col)))
        return QueryResult("count", count=n, version=r.version)

    # -- kNN ---------------------------------------------------------------

    def knn(self, query: "Query | str", qx, qy, k: int = 10,
            impl: str = "sparse", timeout_ms: Optional[int] = None):
        """Serial kNN = launch + sync back to back, inside the request's
        deadline scope. Returns (dists [Q, k] meters np, indices [Q, k]
        np int32 into `batch` rows, batch)."""
        with deadline_scope(_deadline(timeout_ms)):
            return self._knn_launch(query, qx, qy, k=k, impl=impl,
                                    timeout_ms=timeout_ms).sync()

    def knn_launch(self, query: "Query | str", qx, qy, k: int = 10,
                   impl: str = "sparse", timeout_ms: Optional[int] = None,
                   staged=None, want_mask_count: bool = False) -> "KnnLaunch":
        """Plan -> prune -> mask -> kernel launch, returning a `KnnLaunch`
        without waiting for any result: the results' device-to-host
        copies are enqueued behind the launch and one CUDA event marks
        them done (`KnnLaunch.sync` waits on it alone). `want_mask_count`
        also reduces the (f64-exact) mask to a count that rides the same
        read. `timeout_ms` (None or 0 = none; geomesa.query.timeout is
        not read here, as in the reference) raises QueryTimeout after
        planning ("planning") or after the mask ("scan") once it has
        passed.

        `staged`: the (qx, qy) device pair a `QueryStager` slot already
        holds (the same f32 values as the planner's own upload); `qx`/`qy`
        stay the HOST copies, from which an overflow fallback re-uploads
        (the slot may be written again before the window syncs).

        impl: "sparse" scans only match-bearing data tiles, with a
        capacity calibrated once per (filter, k) and cached; an overflow
        falls back to the dense scan and drops the cached capacity.
        "fullscan" runs the dense scan. "auto" picks one of the two from
        the stats sketches (`_knn_impl_from_stats`)."""
        with deadline_scope(_deadline(timeout_ms)):
            return self._knn_launch(query, qx, qy, k=k, impl=impl,
                                    timeout_ms=timeout_ms, staged=staged,
                                    want_mask_count=want_mask_count)

    def _knn_launch(self, query, qx, qy, k, impl, timeout_ms, staged=None,
                    want_mask_count: bool = False) -> "KnnLaunch":
        if impl not in ("sparse", "fullscan", "auto"):
            raise ValueError(f"unknown kNN impl {impl!r}")
        if isinstance(query, str):
            query = Query(self.storage.sft.name, query)
        check_timeout = _timeout_check(timeout_ms)
        plan = self.plan(query)
        check_timeout("planning")
        query = plan.query
        sft = self.storage.sft
        g = sft.default_geometry
        if g is None or g.type != "Point":
            raise ValueError("planner.knn requires a point default geometry")

        sb, batch, dev, mask, is_empty = self._knn_mask_setup(plan, query)
        if is_empty:
            return KnnLaunch.ready(
                self,
                (np.full((len(qx), k), np.inf),
                 np.zeros((len(qx), k), np.int32),
                 FeatureBatch.from_pydict(sft, {a.name: [] for a in sft.attributes})),
                fused=want_mask_count)
        check_timeout("scan")

        x = dev[f"{g.name}__x"]
        y = dev[f"{g.name}__y"]
        kk = min(k, x.shape[0])
        mb = max(64, kk)
        if sb is not None and sb.mesh is not None:
            # the mesh tier: one sharded program over every shard, or the
            # owning shard alone (shard affinity)
            return self._knn_launch_mesh(plan, sb, qx, qy, k, kk, mb, mask,
                                         batch, staged, want_mask_count)
        if staged is not None:
            jqx, jqy = staged
        else:
            jqx = torch.from_numpy(np.asarray(qx, np.float32).ravel()).to(self.device)
            jqy = torch.from_numpy(np.asarray(qy, np.float32).ravel()).to(self.device)
        count_dev = mask.sum(dtype=torch.int64) if want_mask_count else None
        launch = KnnLaunch(self, k=k, kk=kk, impl=impl, batch=batch,
                           count_dev=count_dev, hq=_host_q(qx, qy))
        if impl == "auto":
            impl = launch.impl = self._knn_impl_from_stats(plan)
        if impl == "sparse":
            key = (plan.cql, kk)
            seed_cap = self._caps_seed(key)
            with TRACER.span("kernel.dispatch", kernel="knn_sparse",
                             q=int(jqx.shape[0]), k=kk):
                if seed_cap is None:
                    # calibration: the one scalar read a cold (filter, k)
                    # pays
                    seed_cap = capacity_bucket(int(count_match_tiles(mask)))
                fd, fi, ov, seed_cap = knn_sparse_launch(
                    jqx, jqy, x, y, mask, k=kk, tile_capacity=seed_cap,
                    m_blocks=mb)
            note_device_op()
            launch.arm_sparse(fd, fi, ov, x, y, mask, cap=seed_cap,
                              caps_key=key, mb=mb)
        else:
            with TRACER.span("kernel.dispatch", kernel="knn_fullscan",
                             q=int(jqx.shape[0]), k=kk):
                fd, fi = knn_fullscan_tiled(jqx, jqy, x, y, mask, k=kk,
                                            m_blocks=mb)
            note_device_op()
            launch.arm_dense(fd, fi)
        return launch

    def _knn_launch_mesh(self, plan, sb, qx, qy, k, kk, mb, mask, batch,
                         staged=None, want_mask_count: bool = False
                         ) -> "KnnLaunch":
        """The mesh route: one sharded program over the superbatch's mesh
        (`knn_scan.make_knn_serve_sharded`: B1 on every shard's rows, the
        merge on the lead device, the fused count summed over shards),
        the capacity calibrated once per (filter, k, mesh shape) from the
        largest shard's match tiles; an overflow falls back to the dense
        sharded scan at sync. The mesh superbatch keeps the serial
        layout, so the merged indices are the single-device ones. When
        every allowed partition's rows live on ONE shard the window runs
        there alone (`_knn_launch_local`)."""
        from geomesa_tpu_torch.engine.knn_scan import (
            make_knn_fullscan_sharded, make_knn_serve_sharded,
            shard_match_tiles)
        from geomesa_tpu_torch.parallel.mesh import on_shard

        mesh = sb.mesh
        shards = sb.shards_for(plan.partitions)
        if len(shards) == 1:
            return self._knn_launch_local(plan, sb, qx, qy, k, kk, mb, mask,
                                          batch, shards[0], staged,
                                          want_mask_count)
        g = self.storage.sft.default_geometry
        x = sb.dev[f"{g.name}__x"]
        y = sb.dev[f"{g.name}__y"]
        mesh_shape = (mesh.size,)
        lead = mesh.lead
        with on_shard(lead):
            if staged is not None:
                jqx, jqy = (t.to(lead) for t in staged)
            else:
                jqx, jqy = (upload(np.asarray(v, np.float32).ravel(), lead)
                            for v in (qx, qy))
            key = (plan.cql, kk, ("mesh",) + mesh_shape)
            seed_cap = self._caps_seed(key, mesh)
            with TRACER.span("kernel.dispatch", kernel="knn_mesh",
                             q=int(jqx.shape[0]), k=kk, mesh=mesh.size,
                             shards=",".join(map(str, shards))):
                if seed_cap is None:
                    # calibration: the one scalar read a cold key pays
                    seed_cap = capacity_bucket(int(shard_match_tiles(
                        mask, mesh.size)))
                out = make_knn_serve_sharded(mesh)(
                    jqx, jqy, x, y, mask, k=kk, tile_capacity=seed_cap,
                    m_blocks=mb, want_count=want_mask_count)
            metrics.counter("knn.mesh.dispatches")
            note_device_op()
            launch = KnnLaunch(self, k=k, kk=kk, impl="mesh", batch=batch,
                               count_dev=out[3] if want_mask_count else None,
                               hq=_host_q(qx, qy))
            launch.mesh_shape = mesh_shape
            launch.shards = shards

            def dense_fallback():
                # the overflow: the dense sharded scan (B2 on every shard)
                # over the host query copies cast as the stager casts them
                hx, hy = (upload(h.astype(np.float32), lead) for h in launch._hq)
                return make_knn_fullscan_sharded(mesh)(hx, hy, x, y, mask,
                                                       k=kk, m_blocks=mb)

            launch.arm_mesh(out[0], out[1], out[2], dense_fallback,
                            cap=seed_cap, caps_key=key)
        return launch

    def _knn_launch_local(self, plan, sb, qx, qy, k, kk, mb, mask, batch,
                          shard: int, staged=None,
                          want_mask_count: bool = False) -> "KnnLaunch":
        """The shard-affinity route: every allowed row lives on `shard`, so
        the window runs the single-device sparse scan on that shard's rows
        (its device's views), with no merge; sync lifts the local indices
        by `shard * shard_rows` to the serial ones. The fused count sums
        the shard's mask, which holds every allowed row."""
        from geomesa_tpu_torch.parallel.mesh import on_shard, shard_view

        mesh = sb.mesh
        s_rows = sb.shard_rows
        dev_s = mesh.devices[shard]
        g = self.storage.sft.default_geometry
        with on_shard(dev_s):
            lx = shard_view(sb.dev[f"{g.name}__x"], shard, s_rows, dev_s)
            ly = shard_view(sb.dev[f"{g.name}__y"], shard, s_rows, dev_s)
            lm = shard_view(mask, shard, s_rows, dev_s)
            if staged is not None:
                jqx, jqy = (shard_view(t, 0, int(t.shape[0]), dev_s)
                            for t in staged)
            else:
                jqx, jqy = (upload(np.asarray(v, np.float32).ravel(), dev_s)
                            for v in (qx, qy))
            launch = KnnLaunch(
                self, k=k, kk=kk, impl="sparse", batch=batch,
                count_dev=lm.sum(dtype=torch.int64) if want_mask_count else None,
                hq=_host_q(qx, qy))
            launch.mesh_shape = (mesh.size,)
            launch.shards = (shard,)
            launch.idx_offset = shard * s_rows
            key = (plan.cql, kk, ("shard", shard))
            seed_cap = self._caps_seed(key)
            metrics.counter("knn.mesh.local_dispatches")
            with TRACER.span("kernel.dispatch", kernel="knn_sparse",
                             q=int(jqx.shape[0]), k=kk, shards=str(shard)):
                if seed_cap is None:
                    seed_cap = capacity_bucket(int(count_match_tiles(lm)))
                fd, fi, ov, seed_cap = knn_sparse_launch(
                    jqx, jqy, lx, ly, lm, k=kk, tile_capacity=seed_cap,
                    m_blocks=mb)
            note_device_op()
            launch.arm_sparse(fd, fi, ov, lx, ly, lm, cap=seed_cap,
                              caps_key=key, mb=mb)
        return launch

    def ring_arm(self, query: "Query | str", q_padded: int, k: int = 10,
                 impl: str = "sparse", depth: int = 4) -> "RingProgram":
        """Arm ONE persistent serve program for a (type, canonical CQL,
        hints, k, impl, Q bucket) window class: plan -> residency -> the
        f64-exact filter mask -> the padded columns, the tile list and
        the capacity calibrated from that mask -> the fused-count scalar
        -> the capture (`compilecache.registry`: one CUDA graph per ring
        slot on a card), all exactly once. A window then pays a slot
        write, one replay and the harvest read.

        The capture is keyed by what shapes what it reads: this planner,
        the superbatch, the manifest version, the mask's class
        (`ring_class`: the type, the CQL and the residual CQL, which loose
        bbox makes differ), the impl, Q bucket, k, capacity and top-m
        width. The mask and padded columns are frozen once per (planner,
        superbatch, version, class) and shared by that class's captures
        (`registry.frozen_for`).

        Raises RingIneligible (typed: the serve loop keeps the pipelined
        route) for a planner with interceptors ("interceptors": they must
        run per request), storage without committed manifest versions
        ("no_version": staleness would be undetectable), no device cache
        ("no_device_cache"), a non-point geometry ("non_point"), no
        resident matching rows ("empty") or, on a mesh superbatch, a plan
        whose rows live on one shard ("shard_affinity"; the mesh program
        is `_ring_arm_mesh`). A failed capture raises GraphCaptureError
        (an OOM stays an OOM)."""
        from geomesa_tpu_torch.compilecache.registry import registry
        from geomesa_tpu_torch.engine import knn_scan

        if isinstance(query, str):
            query = Query(self.storage.sft.name, query)
        if self.interceptors:
            raise RingIneligible("interceptors")
        mv_fn = getattr(self.storage, "manifest_version", None)
        if mv_fn is None:
            raise RingIneligible("no_version")
        if self.cache is None:
            raise RingIneligible("no_device_cache")
        plan = self.plan(query)
        query = plan.query
        g = self.storage.sft.default_geometry
        if g is None or g.type != "Point":
            raise RingIneligible("non_point")
        mversion = int(mv_fn())
        sb, allowed = self._resident(plan)
        if allowed is None:
            raise RingIneligible("empty")
        if sb.mesh is not None:
            return self._ring_arm_mesh(plan, query, sb, allowed, q_padded, k,
                                       depth, mversion)
        cls = ring_class(query.type_name, plan.cql, plan.residual_cql,
                         query.hints.auths)
        frozen = registry.frozen_for(self, cls, sb, mversion)
        if frozen is None:
            _, _, dev, mask, _ = self._knn_mask_setup(
                plan, query, resident=(sb, allowed))
            x = dev[f"{g.name}__x"]
            y = dev[f"{g.name}__y"]
            # the fused-count rider's answer, frozen with the mask: the
            # one deliberate host read the arm pays
            (mask_count,) = fetch(mask.sum(dtype=torch.int64))
            xf, yf, maskf = pad_scan_inputs(x, y, mask)
            frozen = dict(sb=sb, mversion=mversion, x=x, y=y, mask=mask,
                          xf=xf, yf=yf, maskf=maskf,
                          mask_count=int(mask_count), tiles={})
        xf, yf, maskf = frozen["xf"], frozen["yf"], frozen["maskf"]
        n = frozen["x"].shape[0]
        kk = min(k, n)
        mb = max(64, kk)
        if impl == "auto":
            impl = self._knn_impl_from_stats(plan)
        caps_key, cap, ov = None, 0, None
        if impl == "sparse":
            caps_key = (plan.cql, kk)
            cap = self._caps_seed(caps_key)
            if cap is None:
                cap = capacity_bucket(int(count_match_tiles(frozen["mask"])))
            tile_ids, n_sel, live = _frozen_tiles(frozen, cap)
            if live > tile_ids.shape[0]:
                # a cached capacity below this mask's tiles: calibrate
                # from the frozen mask, so the armed overflow cannot fire
                cap = capacity_bucket(live)
                tile_ids, n_sel, live = _frozen_tiles(frozen, cap)
            ov = n_sel[0] > tile_ids.shape[0]
            kernel = "chord_blockmin_sparse"

            def body(qx, qy):
                return knn_sparse_body(qx, qy, xf, yf, maskf, tile_ids,
                                       n_sel, n, kk, mb)
        elif impl == "fullscan":
            kernel = "chord_blockmin"

            def body(qx, qy):
                return knn_fullscan_tiled_body(qx, qy, xf, yf, maskf, n, kk,
                                               mb)
        else:
            raise ValueError(f"unknown kNN impl {impl!r}")
        key = (id(sb), mversion, impl, int(q_padded), kk, cap, mb)
        capture = registry.ring_capture(
            kernel, key, depth, body, frozen,
            (knn_scan.chord_blockmin_sparse, knn_scan.chord_blockmin),
            self.device, q=int(q_padded), k=kk, capacity=cap, owner=self,
            cls=cls, stale=self._ring_stale(sb, mversion))
        metrics.counter("serve.ring.armed")
        return RingProgram(self, plan, sb, sb.batch, capture, k=k,
                           kk=kk, impl=impl, mb=mb, depth=depth,
                           mversion=mversion,
                           mask_count=frozen["mask_count"], cap=cap,
                           caps_key=caps_key, ov=ov, device=self.device)

    def _ring_stale(self, sb, mversion):
        """The registry's staleness test for this planner's captures: a
        capture over another superbatch or manifest version goes."""
        return lambda c: (c.owner_id == id(self)
                          and (c.frozen.get("sb") is not sb
                               or c.frozen.get("mversion") != mversion))

    def _ring_arm_mesh(self, plan, query, sb, allowed, q_padded, k, depth,
                       mversion) -> "RingProgram":
        """`ring_arm` on a mesh superbatch (the reference's mesh branch):
        the window runs the mesh serving program, B1 on every shard over
        its frozen tile list, the merge on the lead device. The per-shard
        masks, padded columns and tile lists are frozen once per class;
        the fused count is their `psum`, read once here; the capacity is
        the mesh route's, keyed `(cql, k, ("mesh",) + shape)` and
        calibrated from the largest shard. A plan whose rows live on one
        shard (or none) is refused ("shard_affinity"): the pipelined
        route's shard-affinity dispatch serves it. The capture is one CUDA
        graph per slot holding every shard's launches and the merge where
        the mesh repeats one card, one graph per card per slot plus the
        lead's merge graph where it spans cards (`compilecache.registry`);
        a dense sharded fallback (B2 on every shard) is armed for the
        overflow, which the calibration makes unreachable.

        On a mesh that spans processes each process captures its own
        shards' launches (one graph a slot) and the merge, a collective,
        runs after the replay outside the graph; the capacity and the
        live tiles are MAXed over the processes, so every process arms
        the same program."""
        from geomesa_tpu_torch.compilecache.registry import registry
        from geomesa_tpu_torch.engine import knn_scan
        from geomesa_tpu_torch.engine.knn_scan import (
            _shard_merge_topk, shard_match_tiles)
        from geomesa_tpu_torch.parallel.mesh import (
            any_of, my_shards, on_shard, psum)

        mesh = sb.mesh
        shards = sb.shards_for(plan.partitions)
        if len(shards) <= 1:
            raise RingIneligible("shard_affinity")
        g = self.storage.sft.default_geometry
        cls = ring_class(query.type_name, plan.cql, plan.residual_cql,
                         query.hints.auths)
        frozen = registry.frozen_for(self, cls, sb, mversion)
        if frozen is None:
            _, _, dev, mask, _ = self._knn_mask_setup(
                plan, query, resident=(sb, allowed))
            x, y = dev[f"{g.name}__x"], dev[f"{g.name}__y"]
            padded: list = [(None, None, None)] * mesh.size
            for i, d in my_shards(mesh):
                with on_shard(d):
                    padded[i] = pad_scan_inputs(
                        x.shards[i], y.shards[i], mask.shards[i])
            (mask_count,) = fetch(psum(mesh, [m.sum(dtype=torch.int64)
                                              for m in mask.local_shards]))
            frozen = dict(sb=sb, mversion=mversion, x=x, y=y, mask=mask,
                          xf=[p[0] for p in padded], yf=[p[1] for p in padded],
                          maskf=[p[2] for p in padded],
                          mask_count=int(mask_count), tiles={})
        x, y, mask = frozen["x"], frozen["y"], frozen["mask"]
        s_rows = sb.shard_rows
        kk = min(k, len(x))
        mb = max(64, kk)
        mesh_shape = (mesh.size,)
        caps_key = (plan.cql, kk, ("mesh",) + mesh_shape)
        cap = self._caps_seed(caps_key, mesh)
        if cap is None:
            cap = capacity_bucket(int(shard_match_tiles(mask, mesh.size)))
        tiles, live = _frozen_shard_tiles(frozen, cap, mesh)
        if live > tiles[mesh.local[0]][0].shape[0]:
            cap = capacity_bucket(live)
            tiles, live = _frozen_shard_tiles(frozen, cap, mesh)
        with on_shard(mesh.lead):
            ov = any_of(mesh, [tiles[i][1][0] > tiles[i][0].shape[0]
                               for i in mesh.local])
        xf, yf, maskf = frozen["xf"], frozen["yf"], frozen["maskf"]

        def shard_fn(i):
            tile_ids, n_sel = tiles[i]

            def run(qx, qy):
                return knn_sparse_body(qx, qy, xf[i], yf[i], maskf[i],
                                       tile_ids, n_sel, s_rows, kk, mb)
            return run

        def merge(outs):
            return _shard_merge_topk(mesh, [o[0] for o in outs],
                                     [o[1] for o in outs], s_rows, kk)

        key = (id(sb), mversion, "mesh", int(q_padded), kk, cap, mb)
        capture = registry.ring_capture(
            "chord_blockmin_sparse", key, depth, None, frozen,
            (knn_scan.chord_blockmin_sparse, knn_scan.chord_blockmin),
            mesh.lead, q=int(q_padded), k=kk, capacity=cap, owner=self,
            cls=cls, stale=self._ring_stale(sb, mversion),
            mesh_parts=(mesh, [shard_fn(i) for i in mesh.local], merge))
        metrics.counter("serve.ring.armed")
        return RingProgram(self, plan, sb, sb.batch, capture, k=k, kk=kk,
                           impl="mesh", mb=mb, depth=depth, mversion=mversion,
                           mask_count=frozen["mask_count"], cap=cap,
                           caps_key=caps_key, ov=ov, device=mesh.lead,
                           mesh_shape=mesh_shape, shards=shards)

    def _caps_seed(self, key, mesh=None):
        """The cached sparse capacity for `key` (None = cold, calibrate).
        A miss against an oversized cache clears it (bounded memory). On a
        mesh that spans processes the cache is each process's own, so the
        answer is the MAX over the processes (one collective): they then
        all calibrate, or none does."""
        with self._mutex:
            caps = self._knn_caps
            if key not in caps and len(caps) > 256:
                caps.clear()
            cap = caps.get(key)
        if mesh is not None and mesh.spans_processes:
            from geomesa_tpu_torch.parallel.mesh import pmax

            cap = pmax(mesh, -1 if cap is None else cap)
            cap = None if cap < 0 else cap
        return cap


def ring_class(type_name: str, cql: str, residual_cql: str,
               auths=()) -> str:
    """The digest of a ring window class's mask identity: the type, the
    filter's CQL (which prunes partitions), the residual's (which the
    mask evaluates; loose bbox drops the BBOX from it) and the auths
    (whose visibility mask is folded in)."""
    text = "\x1f".join((type_name, cql, residual_cql) + tuple(auths))
    return hashlib.sha1(text.encode("utf-8")).hexdigest()[:16]


def _frozen_shard_tiles(frozen: dict, cap: int, mesh):
    """[(tile_ids, n_sel)] a shard of the frozen per-shard masks at
    capacity `cap` (None for another process's shard), and the most live
    tiles of any shard (over every process of the mesh); selected once
    per capacity and shared by the class's captures."""
    from geomesa_tpu_torch.parallel.mesh import my_shards, on_shard, pmax

    got = frozen["tiles"].get(cap)
    if got is None:
        tiles: list = [None] * mesh.size
        for i, d in my_shards(mesh):
            with on_shard(d):
                tiles[i] = select_match_tiles(frozen["maskf"][i], cap)
        live = fetch(*[tiles[i][1] for i in mesh.local])
        got = frozen["tiles"][cap] = (
            tiles, pmax(mesh, max(int(v[0]) for v in live)))
    return got


def _frozen_tiles(frozen: dict, cap: int):
    """(tile_ids, n_sel, live tiles) of the frozen mask at capacity `cap`,
    selected once per capacity and shared by the class's captures."""
    got = frozen["tiles"].get(cap)
    if got is None:
        tile_ids, n_sel = select_match_tiles(frozen["maskf"], cap)
        (live,) = fetch(n_sel)
        got = frozen["tiles"][cap] = (tile_ids, n_sel, int(live[0]))
    return got


def _pad_to_k(dists: np.ndarray, idx: np.ndarray, k: int):
    """Pad a [Q, kk<=k] kNN result to k columns (inf distance, index 0)."""
    if dists.shape[1] < k:
        pad = k - dists.shape[1]
        dists = np.pad(dists, ((0, 0), (0, pad)), constant_values=np.inf)
        idx = np.pad(idx, ((0, 0), (0, pad)))
    return dists, idx


def _host_q(qx, qy):
    """Host f64 copies of the query points, for sync's meter recompute."""
    return (np.asarray(qx, np.float64).ravel(),
            np.asarray(qy, np.float64).ravel())


def _canonical_dists(dists, idx, batch, hq):
    """Canonical final meters: the device kernels RANK (their f32 refine
    picks the neighbour set and order); the reported distances are
    recomputed here in f64 from the f64 host coordinates and rounded ONCE
    to the result dtype, so every route reports identical bits whenever
    the neighbour sets agree."""
    if hq is None or dists.size == 0:
        return dists
    fin = np.isfinite(dists)
    if not fin.any():
        return dists
    col = batch.columns[batch.sft.default_geometry.name]
    cx = np.asarray(col.x, np.float64)
    cy = np.asarray(col.y, np.float64)
    qx, qy = hq
    ii = np.clip(idx, 0, len(cx) - 1)
    d64 = haversine_m_np(qx[:, None], qy[:, None], cx[ii], cy[ii])
    return np.where(fin, d64, dists).astype(dists.dtype, copy=False)


class KnnLaunch:
    """One launched-but-unsynced kNN window (planner.knn_launch, or a ring
    program's replay).

    The launch enqueued the kernels and, behind them, the device-to-host
    copies of the results (+ the sparse overflow flag + any fused count)
    with one CUDA event after them (`engine.device.Readback`). `sync()`
    waits on that event alone (never on the whole stream, which would
    also wait for windows launched since), runs the overflow -> dense
    fallback, writes the planner's capacity cache back, and returns what
    `planner.knn` returns. After a fused-count sync, `mask_count` holds
    the count. `event` (None on the CPU) marks the window's device work
    done: a staging slot the launch read may be written again after it."""

    __slots__ = ("planner", "k", "kk", "impl", "batch", "mask_count",
                 "fused_ok", "ring", "_ready", "_rb", "_ov", "_cap",
                 "_caps_key", "_x", "_y", "_mask", "_mb",
                 "_count_dev", "_hq", "_out", "_dense", "idx_offset",
                 "mesh_shape", "shards")

    def __init__(self, planner, k, kk, impl, batch, count_dev=None, hq=None):
        self.planner = planner
        self.k = k
        self.kk = kk
        self.impl = impl
        self.batch = batch
        self.mask_count = None
        self.fused_ok = count_dev is not None
        self.ring = False  # replayed by a ring program
        self._count_dev = count_dev
        self._ready = None
        self._rb = None
        self._ov = self._x = self._y = self._mask = None
        self._cap = self._caps_key = self._mb = None
        self._hq = hq
        self._out = None
        self._dense = None  # the mesh route's overflow fallback
        # the shard-affinity route's local -> serial index lift, and the
        # routing attribution ServeEvents carry (mesh shape, shards)
        self.idx_offset = 0
        self.mesh_shape: tuple = ()
        self.shards: tuple = ()

    @classmethod
    def ready(cls, planner, result, fused: bool = False) -> "KnnLaunch":
        """An already-resolved launch (the empty early-out); a fused count
        resolves to 0."""
        launch = cls(planner, k=0, kk=0, impl="none", batch=result[2])
        launch._ready = result
        launch.fused_ok = fused
        launch.mask_count = 0 if fused else None
        return launch

    @property
    def event(self):
        """The CUDA event after the window's kernels and readback (None on
        the CPU or for an early-out)."""
        return self._rb.event if self._rb is not None else None

    def arm_sparse(self, fd, fi, ov, x, y, mask, cap, caps_key, mb) -> None:
        """The sparse scan's outputs and what its overflow fallback (the
        dense scan, re-uploading the host query copies) reads."""
        self._ov = ov
        self._x, self._y, self._mask = x, y, mask
        self._cap, self._caps_key, self._mb = cap, caps_key, mb
        self._readback(fd, fi, ov)

    def arm_dense(self, fd, fi) -> None:
        self._readback(fd, fi)

    def arm_mesh(self, fd, fi, ov, dense_fallback, cap, caps_key) -> None:
        """A mesh program's merged outputs and its any-shard overflow flag,
        in one combined readback; `dense_fallback()` runs the dense
        sharded scan when sync sees the overflow."""
        self._ov = ov
        self._dense = dense_fallback
        self._cap, self._caps_key = cap, caps_key
        self._readback(fd, fi, ov)

    def _readback(self, *out) -> None:
        extra = (self._count_dev,) if self._count_dev is not None else ()
        self._out = len(out)
        self._rb = Readback(out + extra)

    def sync(self):
        """Wait for the window's readback; returns (dists [Q, k] np, idx
        [Q, k] np int32, batch)."""
        if self._ready is not None:
            return self._ready
        note_device_op()  # the one combined read
        attrs = {"shards": ",".join(map(str, self.shards))
                 if self.shards else ""}
        if self.ring:
            attrs["ring"] = True
        with TRACER.span("device.sync", **attrs):
            got = self._rb.wait()
            fd, fi = got[0], got[1]
            extra_host = got[self._out:]
            if self._ov is not None:
                cap = self._cap
                if bool(got[2]) and self._dense is not None:
                    fd, fi = fetch(*self._dense())
                    cap = -1
                elif bool(got[2]):
                    # the host f64 copies cast as the stager casts them: the
                    # staged f32 values, without re-reading a slot that may
                    # have been written since
                    dev = self._x.device
                    qx, qy = (upload(h.astype(np.float32), dev) for h in self._hq)
                    fd, fi = fetch(*knn_fullscan(qx, qy, self._x, self._y,
                                                 self._mask, k=self.kk,
                                                 m_blocks=self._mb))
                    cap = -1
                with self.planner._mutex:
                    caps = self.planner._knn_caps
                    if cap > 0:
                        caps[self._caps_key] = cap
                    else:
                        caps.pop(self._caps_key, None)
            fi = fi.astype(np.int32)
            if self.idx_offset:
                # the shard-affinity route: local rows -> serial rows
                fi = fi + np.int32(self.idx_offset)
            dists, idx = _pad_to_k(np.asarray(fd), np.asarray(fi), self.k)
            dists = _canonical_dists(dists, idx, self.batch, self._hq)
        if extra_host:
            self.mask_count = int(extra_host[0])
        # drop the device refs: they are the window's device footprint
        self._rb = self._ov = self._count_dev = self._dense = None
        self._x = self._y = self._mask = None
        self._ready = (dists, idx, self.batch)
        return self._ready


class RingIneligible(RuntimeError):
    """Typed refusal: this window class cannot take the persistent ring
    route. Carries the metered reason; the serve loop falls back to the
    pipelined dispatch — slower per window, never wrong."""

    def __init__(self, reason: str):
        super().__init__(f"ring-ineligible: {reason}")
        self.reason = reason


class RingProgram:
    """One armed persistent serve program (planner.ring_arm).

    Everything a window would otherwise recompute per dispatch is frozen
    here: the plan, the resident superbatch, the f64-exact filter mask
    and its padded columns, the tile list and the calibrated capacity,
    the fused-count scalar, and the capture (one CUDA graph per ring
    slot on a card). `launch()` is the whole per-window device
    interaction: one replay over the staged slot plus the readback.
    `fresh()` is the per-window staleness gate: a lock-peek plus an int
    compare, never residency work; False sends the window back to the
    pipelined route, whose plan/ensure rebuilds residency, and the ring
    loop re-arms against the new version.

    Bit-identity holds by construction: the body is the serial route's
    kernels over the same mask, tile list and capacity, the slot carries
    the same host f64->f32 cast, and sync runs the same overflow ladder
    and `_canonical_dists`."""

    __slots__ = ("planner", "plan", "sb", "batch", "capture", "k", "kk",
                 "impl", "mb", "depth", "mversion", "mask_count", "cap",
                 "caps_key", "ov", "device", "mesh_shape", "shards")

    def __init__(self, planner, plan, sb, batch, capture, k, kk, impl, mb,
                 depth, mversion, mask_count, cap, caps_key, ov=None,
                 device=None, mesh_shape=(), shards=()):
        self.planner = planner
        self.plan = plan
        self.sb = sb
        self.batch = batch
        self.capture = capture
        self.k = k
        self.kk = kk
        self.impl = impl
        self.mb = mb
        self.depth = depth
        self.mversion = mversion
        self.mask_count = mask_count
        self.cap = cap
        self.caps_key = caps_key
        self.ov = ov  # the sparse overflow flag over the frozen tiles
        # the device of the capture's slots (a mesh's lead device)
        self.device = device if device is not None else planner.device
        # a mesh program's attribution (impl "mesh"), as the mesh route's
        self.mesh_shape = mesh_shape
        self.shards = shards

    @property
    def slots(self):
        """The capture's slot ring (its graphs read these device pairs)."""
        return self.capture.slots

    def fresh(self) -> bool:
        """The superbatch is still the cache's current one and the storage
        commit version is the armed one."""
        cache = self.planner.cache
        if cache is None or cache.superbatch_peek() is not self.sb:
            return False
        try:
            return int(self.planner.storage.manifest_version()) == self.mversion
        except Exception:  # noqa: BLE001 — an unreadable version is stale
            return False

    def launch(self, slot, qx, qy, want_mask_count: bool = False
               ) -> KnnLaunch:
        """Replay the slot's graph (or, on the CPU, call the frozen body)
        and enqueue the readback; the caller holds `capture.lock` from the
        slot write through this call. The fused count resolves from the
        arm-time scalar: no per-window device work for count riders."""
        f = self.capture.frozen
        launch = KnnLaunch(self.planner, k=self.k, kk=self.kk, impl=self.impl,
                           batch=self.batch, hq=_host_q(qx, qy))
        launch.ring = True
        if want_mask_count:
            launch.fused_ok = True
            launch.mask_count = self.mask_count
        fd, fi = self.capture.replay(slot)
        note_device_op()
        if self.impl == "mesh":
            launch.mesh_shape, launch.shards = self.mesh_shape, self.shards
            launch.arm_mesh(fd, fi, self.ov, self._dense_fallback(launch),
                            cap=self.cap, caps_key=self.caps_key)
            metrics.counter("knn.mesh.dispatches")
        elif self.impl == "sparse":
            # the overflow is unreachable (the capacity was calibrated
            # from this frozen mask) but stays armed
            launch.arm_sparse(fd, fi, self.ov, f["x"], f["y"],
                              f["mask"], cap=self.cap,
                              caps_key=self.caps_key, mb=self.mb)
        else:
            launch.arm_dense(fd, fi)
        slot.consumed = launch.event
        metrics.counter("serve.ring.windows")
        return launch

    def _dense_fallback(self, launch):
        """The mesh program's overflow fallback, built only when a window
        sees the (unreachable) overflow: the dense sharded scan (B2 on
        every shard) over the frozen columns and the host query copies
        cast as the stager casts them, as the mesh route's."""
        from geomesa_tpu_torch.engine.knn_scan import make_knn_fullscan_sharded

        def run():
            f = self.capture.frozen
            mesh = self.sb.mesh
            hx, hy = (upload(h.astype(np.float32), mesh.lead)
                      for h in launch._hq)
            return make_knn_fullscan_sharded(mesh)(
                hx, hy, f["x"], f["y"], f["mask"], k=self.kk, m_blocks=self.mb)

        return run


def _loosen_bbox(f: ast.Filter, geom_name: str) -> ast.Filter:
    """LOOSE_BBOX semantics: drop default-geometry BBOX predicates from the
    residual; the covering pushdown result is accepted as-is for the
    spatial primary (attribute and temporal predicates stay exact)."""
    if (isinstance(f, ast.SpatialPredicate) and f.op == "BBOX"
            and f.prop.name == geom_name):
        return ast.Include()
    if isinstance(f, ast.And):
        kids = tuple(_loosen_bbox(c, geom_name) for c in f.children)
        kids = tuple(c for c in kids if not isinstance(c, ast.Include))
        if not kids:
            return ast.Include()
        return kids[0] if len(kids) == 1 else ast.And(kids)
    # do not descend through OR/NOT: dropping a disjunct would change results
    return f


def _needed_columns(plan: QueryPlan, sft):
    """The scan's column projection: the filter's attributes, the hints'
    and the requested projection's (None = every column, for full
    feature results)."""
    query = plan.query
    hints = query.hints
    needed = set()
    # the visibility column always rides the scan when configured:
    # dropping it would silently disable the feature-level auth mask
    vis_attr = (sft.user_data or {}).get("geomesa.vis.attr")
    if vis_attr:
        needed.add(vis_attr)
    for node in ast.walk(plan.filter):
        for field in ("prop", "left", "right"):
            v = getattr(node, field, None)
            if isinstance(v, ast.Property):
                needed.add(v.name)
    if hints.sample_by:
        needed.add(hints.sample_by)
    if hints.arrow_sort_field:
        needed.add(hints.arrow_sort_field)
    if hints.is_density:
        needed.add(sft.default_geometry.name)
        if hints.density_weight:
            needed.add(hints.density_weight)
    elif hints.is_bin:
        needed.add(sft.default_geometry.name)
        needed.add(hints.bin_track)
        if hints.bin_label:
            needed.add(hints.bin_label)
        if sft.default_dtg is not None:
            needed.add(sft.default_dtg.name)
    elif hints.is_stats:
        from geomesa_tpu_torch.stats import parse_stats
        from geomesa_tpu_torch.stats.sketches import Z3HistogramStat

        for s in parse_stats(hints.stats_string).stats:
            if isinstance(s, Z3HistogramStat):
                needed.add(s.geom)
                needed.add(s.dtg)
            elif s.attribute:
                needed.add(s.attribute)
    elif query.attributes is None:
        return None
    else:
        needed.update(query.attributes)
        for attr, _ in query.sort_by or []:
            needed.add(attr)
    return sorted(needed)
