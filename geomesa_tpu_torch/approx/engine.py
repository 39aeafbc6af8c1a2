"""SketchAnswerEngine: the microsecond answer path for tolerant queries.

A copy of the reference package's `approx/engine.py` (host NumPy over
`approx/sketches.py` and the port's `stats/` Cardinality). A miss falls
through to the exact path, which runs on the planner's device.

Resolves `count`, `density` and `topk_cells` queries directly from the
per-partition mergeable sketches (approx/sketches.py), merged under the
plan's `manifest_snapshot()` — reads are all-or-nothing per committed
write version — and returns answers with TYPED error bounds on the
wire: `approx=True, bound=B, confidence=1.0` means the exact answer is
guaranteed inside `[answer - B, answer + B]` (the bounds here are
deterministic cell-interval brackets, not probabilistic estimates).

Routing contract: the planner
consults this engine only when the client sent a `tolerance` hint (or
the serve ladder injected one), and the engine answers only when the
a-priori bound fits that tolerance — otherwise it returns None with a
metered reason and the query pays the exact device scan. Exactness is
therefore a budgeted contract: the serve layer strips tolerance hints
while the SLO exactness budget is spent, so budget exhaustion moves
traffic to the EXACT path, never to silent accuracy loss.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np

from geomesa_tpu_torch.approx.sketches import (
    PartitionSketchStore, StaleSketch, merge_count_bounds, merge_region,
    resample_bounds, topk_cell_bounds)
from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.telemetry.trace import TRACER

__all__ = ["ApproxCount", "SketchAnswerEngine", "StaleSketch",
           "sketch_eligible"]


def present_values(col) -> np.ndarray:
    """The distinct non-null values of a dictionary column, as an object
    array: its vocabulary at the codes that occur."""
    codes = np.asarray(col.codes)
    return np.asarray(col.vocab, dtype=object)[np.unique(codes[codes >= 0])]


class ApproxCount(int):
    """An int count carrying its typed error bound: every existing
    consumer (comparisons, JSON serialization, arithmetic) sees a plain
    int; approx-aware consumers (the wire payload, ServeEvents) read
    `.bound` / `.confidence`. The exact count is guaranteed in
    `[value - bound, value + bound]`."""

    approx = True

    def __new__(cls, value: int, bound: int, confidence: float = 1.0):
        self = super().__new__(cls, value)
        self.bound = int(bound)
        self.confidence = float(confidence)
        return self


def sketch_eligible(f, geom_name: Optional[str],
                    dtg_name: Optional[str]) -> bool:
    """True when the filter's EXACT semantics are captured by its
    covering (bbox AND interval) — the only shape the occupancy
    sketches can bracket. Anything else (OR/NOT, attribute predicates,
    DWITHIN, non-default columns) routes exact."""
    if isinstance(f, ast.Include):
        return True
    if isinstance(f, ast.And):
        return all(sketch_eligible(c, geom_name, dtg_name)
                   for c in f.children)
    if isinstance(f, ast.SpatialPredicate):
        return f.op == "BBOX" and f.prop.name == geom_name
    if isinstance(f, ast.TemporalPredicate):
        return f.prop.name == dtg_name
    if isinstance(f, ast.Comparison):
        return (isinstance(f.left, ast.Property)
                and f.left.name == dtg_name
                and isinstance(f.right, ast.Literal)
                and f.right.kind == "datetime"
                and f.op in ("=", "<", "<=", ">", ">="))
    if isinstance(f, ast.Between):
        return (f.prop.name == dtg_name
                and getattr(f.lo, "kind", None) == "datetime")
    return False


class SketchAnswerEngine:
    """One engine per planner (lazily built, like the stats manager).

    `answer(plan, query)` returns a QueryResult served from sketches,
    or None — in which case `last_reason` says why (metered):
      ineligible      — filter/hints outside the sketchable shape
      bound_exceeded  — a-priori bound does not fit the tolerance
      stale_sketch    — a pruned partition has no sketch at the plan's
                        snapshot version and the pinned rebuild raced
                        (typed fallthrough: never a torn merge)
      cold            — admission peek only (build=False): the sketch
                        is not built yet; the dispatch path builds it
      no_snapshot     — storage without manifest versioning
    """

    def __init__(self, planner, bins_per_dim: Optional[int] = None,
                 allow_build: bool = True):
        import threading

        self.planner = planner
        self.allow_build = allow_build
        self.store: Optional[PartitionSketchStore] = None
        self.last_reason = ""
        # fast-count memos (the microsecond path): parsed-filter
        # eligibility/bounds per filter TEXT, and merged [lo, hi] per
        # (canonical CQL, manifest version) — version in the key makes
        # staleness impossible by construction. Both bounded.
        self._lock = threading.Lock()
        self._parsed: dict = {}
        self._count_memo: dict = {}
        # per-(partition, attribute) HyperLogLog sketches for the
        # distinct tier (fast_distinct), token-matched like the
        # occupancy store: equal entry tokens imply the partition's
        # on-disk bytes are exactly what the sketch observed. Bounded,
        # oldest-first eviction.
        self._hll_parts: dict = {}
        try:
            kw = {}
            if bins_per_dim is not None:
                kw["bins_per_dim"] = bins_per_dim
            self.store = PartitionSketchStore(planner.storage, **kw)
        except (ValueError, AttributeError):
            self.store = None  # non-point / sketchless storage: disabled
        if self.store is not None:
            # sketch-warm spin-up: a process whose predecessor
            # persisted the sidecar
            # starts with version-exact sketches installed instead of
            # paying the pinned partition rescans on first use; a
            # stale/missing sidecar is the cold path, typed
            try:
                loaded, stale = self.store.load_sidecar()
                if loaded or stale:
                    from geomesa_tpu_torch.utils.metrics import metrics

                    metrics.counter("approx.sidecar.loaded", loaded)
                    metrics.counter("approx.sidecar.stale", stale)
            # (deliberate degrade: the sidecar is a warm-start
            # optimization — a corrupt/unreadable file must cost a
            # rebuild, never engine construction)
            except Exception:
                pass

    # -- metering ----------------------------------------------------------

    def _miss(self, reason: str, meter: bool = True) -> None:
        self.last_reason = reason
        if meter:
            try:
                from geomesa_tpu_torch.utils.metrics import metrics

                metrics.counter("approx.fallthrough", reason=reason)
            except Exception:
                pass
        return None

    def _served(self, kind: str, t0: float) -> None:
        try:
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.counter("approx.sketch_served", kind=kind)
            metrics.histogram("approx.answer").update(
                time.perf_counter() - t0)
        except Exception:
            pass

    # -- sketch collection -------------------------------------------------

    def _sketches(self, plan) -> List:
        """A version-exact sketch per pruned partition, built on demand
        from the plan's pinned snapshot. Raises StaleSketch when any
        partition cannot be served at the snapshot's version. After a
        merge that built anything, the sidecar persists ONCE (not per
        partition — a cold P-partition store must pay one file write,
        not P rewrites of the whole store)."""
        manifest = plan.manifest
        out = []
        built = 0
        for name in plan.partitions:
            entries = manifest.get(name, [])
            if not entries:
                continue
            sk = self.store.get(name, entries)
            if sk is None:
                if not self.allow_build:
                    raise StaleSketch(name, "builds disabled")
                sk = self._build_metered(name, entries)
                built += 1
            out.append(sk)
        if built:
            self._save_sidecar()
        return out

    def _build_metered(self, name, entries):
        """Build one partition's sketch from a pinned read, metered —
        builds are the sketch tier's only non-microsecond cost and
        must be visible in /metrics, not folded silently into a
        query's latency."""
        t0 = time.perf_counter()
        sk = self.store.build(name, entries)
        try:
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.counter("approx.sketch_built")
            metrics.histogram("approx.build").update(
                time.perf_counter() - t0)
        except Exception:
            pass
        return sk

    def _save_sidecar(self) -> None:
        """Persist the sketch store so the NEXT process (a restart, another
        process over the catalog) loads version-exact sketches instead of
        re-scanning partitions. Called once per merge that built
        anything."""
        try:
            self.store.save_sidecar()
        # (deliberate degrade: sidecar persistence must never fail the
        # answer that triggered the build — an unwritable catalog dir
        # just means the next process starts cold)
        except Exception:
            pass

    # -- answers -----------------------------------------------------------

    def answer(self, plan, query):
        """The sketch tier's single entry point: a QueryResult (kind
        count/density/topk_cells, approx fields set) or None."""
        from geomesa_tpu_torch.plan.planner import QueryResult

        hints = query.hints
        if self.store is None:
            return self._miss("ineligible")
        if plan.manifest is None:
            return self._miss("no_snapshot")
        sft = self.planner.storage.sft
        if (sft.user_data or {}).get("geomesa.vis.attr"):
            return self._miss("ineligible")  # auth masks need the rows
        if hints.sampling or hints.loose_bbox or hints.is_stats \
                or hints.is_bin or hints.is_arrow:
            return self._miss("ineligible")
        g = sft.default_geometry
        d = sft.default_dtg
        if not sketch_eligible(plan.filter, g.name if g else None,
                               d.name if d else None):
            return self._miss("ineligible")
        tol = hints.tolerance
        t0 = time.perf_counter()
        with TRACER.span("approx.answer"):
            try:
                if hints.topk_cells:
                    if tol is None:
                        return self._miss("ineligible")
                    sure, maybe, b = self._region(plan)
                    if sure is None:
                        cells: list = []
                        worst = 0
                        top = 0
                    else:
                        cells = topk_cell_bounds(sure, maybe, plan.bbox,
                                                 int(hints.topk_cells))
                        worst = max((c["bound"] for c in cells), default=0)
                        top = cells[0]["count"] if cells else 0
                    if worst > tol * max(top, 1):
                        return self._miss("bound_exceeded")
                    self._served("topk_cells", t0)
                    return QueryResult(
                        "topk_cells", stats=cells,
                        count=sum(c["count"] for c in cells),
                        approx=True, bound=float(worst),
                        confidence=1.0,
                        version=plan.manifest.version)
                if hints.is_density:
                    if hints.density_weight is not None:
                        return self._miss("ineligible")
                    if tol is None:
                        return self._miss("ineligible")
                    sure, maybe, b = self._region_clipped(plan)
                    h, w = int(hints.density_height), int(hints.density_width)
                    if sure is None:
                        grid = np.zeros((h, w), np.float64)
                        bound = 0.0
                    else:
                        grid, bound = resample_bounds(
                            sure, maybe, hints.density_bbox, w, h)
                    total = float(grid.sum())
                    if bound > tol * max(total, 1.0):
                        return self._miss("bound_exceeded")
                    self._served("density", t0)
                    return QueryResult(
                        "density", grid=grid, count=int(round(total)),
                        approx=True, bound=float(bound), confidence=1.0,
                        version=plan.manifest.version)
                # count
                if tol is None:
                    return self._miss("ineligible")
                if query.max_features is not None:
                    return self._miss("ineligible")
                lo, hi = merge_count_bounds(
                    self._sketches(plan), plan.bbox, plan.interval)
                est = (lo + hi) // 2
                bound = hi - est
                if bound > tol * max(est, 1):
                    return self._miss("bound_exceeded")
                self._served("count", t0)
                return QueryResult(
                    "count", count=est, approx=True, bound=float(bound),
                    confidence=1.0, version=plan.manifest.version)
            except StaleSketch:
                # satellite contract: a racing write / compaction can
                # never produce a torn merge — it produces a typed,
                # metered fallthrough to the exact device path
                return self._miss("stale_sketch")

    # -- the microsecond count path ----------------------------------------

    def _parse_filter(self, query):
        """(eligible, canonical_cql, bbox, interval) for the query's
        filter, memoized per filter TEXT — the fast path must not pay
        a CQL parse per request."""
        key = query.filter if isinstance(query.filter, str) else None
        if key is not None:
            with self._lock:
                got = self._parsed.get(key)
            if got is not None:
                return got
        from geomesa_tpu_torch.cql.extract import (
            BBox, Interval, extract_bbox, extract_intervals)

        sft = self.planner.storage.sft
        g = sft.default_geometry
        d = sft.default_dtg
        f = query.filter_ast
        eligible = sketch_eligible(f, g.name if g else None,
                                   d.name if d else None)
        cql = ast.to_cql(f)
        bbox = extract_bbox(f, g.name) if g else BBox(-180, -90, 180, 90)
        interval = (extract_intervals(f, d.name) if d
                    else Interval(None, None))
        out = (eligible, cql, bbox, interval)
        if key is not None:
            with self._lock:
                if len(self._parsed) > 512:
                    self._parsed.clear()
                self._parsed[key] = out
        return out

    def fast_count(self, query, build: bool = True):
        """The serve-path count entry: answer a tolerant count from the
        (canonical CQL, manifest version)-memoized sketch merge without
        paying the full planner pipeline — one manifest_snapshot() plus
        a dict hit when warm. Returns a QueryResult or None (metered
        fallthrough; the caller pays the exact path). The interceptor
        chain must already have run on `query`.

        `build=False` (the ADMISSION peek): only version-exact sketches
        already cached may answer — a cold/stale partition falls
        through instead of running a synchronous parquet rescan on the
        submit thread (on a wire connection that thread is the reader
        loop; the dispatch path builds, metered, where exact scans
        already run)."""
        # the admission peek (build=False) meters only its ONE
        # distinctive outcome — "cold" (sketch not built yet, builds
        # deferred to the dispatch thread). Every other fallthrough
        # reason is metered by the dispatch-path retry, so one request
        # never counts the same reason twice.
        meter = build
        hints = query.hints
        if hints.distinct is not None:
            return self.fast_distinct(query, build=build)
        if self.store is None:
            return self._miss("ineligible", meter)
        if hints.sampling or hints.loose_bbox or hints.is_stats \
                or hints.is_bin or hints.is_arrow or hints.is_density \
                or hints.topk_cells or query.max_features is not None:
            return self._miss("ineligible", meter)
        sft = self.planner.storage.sft
        if (sft.user_data or {}).get("geomesa.vis.attr"):
            return self._miss("ineligible", meter)
        snap_fn = getattr(self.planner.storage, "manifest_snapshot", None)
        if snap_fn is None:
            return self._miss("no_snapshot", meter)
        t0 = time.perf_counter()
        with TRACER.span("approx.answer"):
            eligible, cql, bbox, interval = self._parse_filter(query)
            if not eligible:
                return self._miss("ineligible", meter)
            snap = snap_fn()
            version = getattr(snap, "version", None)
            mkey = (query.type_name, cql, version)
            with self._lock:
                bounds = self._count_memo.get(mkey)
            if bounds is None:
                try:
                    parts = self.planner.storage.prune_partitions(
                        bbox, interval, manifest=snap)
                    sketches = []
                    built = 0
                    for name in parts:
                        entries = snap.get(name, [])
                        if not entries:
                            continue
                        sk = self.store.get(name, entries)
                        if sk is None:
                            if not (build and self.allow_build):
                                raise StaleSketch(name, "builds disabled")
                            sk = self._build_metered(name, entries)
                            built += 1
                        sketches.append(sk)
                    if built:
                        self._save_sidecar()  # once per merge, not per build
                    bounds = merge_count_bounds(sketches, bbox, interval)
                except StaleSketch:
                    # admission peek: a missing sketch here is routine
                    # first-touch cold, not the racing-write signal —
                    # "stale_sketch" (alert-worthy) is reserved for the
                    # building path, where a pinned read actually raced
                    return self._miss("cold" if not build
                                      else "stale_sketch")
                with self._lock:
                    if len(self._count_memo) > 512:
                        self._count_memo.clear()
                    self._count_memo[mkey] = bounds
            lo, hi = bounds
            est = (lo + hi) // 2
            bound = hi - est
            tol = hints.tolerance
            if tol is None or bound > tol * max(est, 1):
                return self._miss("bound_exceeded", meter)
            self._served("count", t0)
            from geomesa_tpu_torch.plan.planner import QueryResult

            return QueryResult("count", count=est, approx=True,
                               bound=float(bound), confidence=1.0,
                               version=version)

    # -- the distinct tier -------------------------------------------------

    # HLL precision for the distinct tier: p=12 -> 4096 registers,
    # relative standard error 1.04/sqrt(4096) ~ 1.6%. The wire bound is
    # the 3-sigma interval, shipped with confidence 0.99 (conservative
    # for a ~0.997 normal tail).
    _HLL_P = 12
    _HLL_RSE = 1.04 / math.sqrt(1 << _HLL_P)

    def _partition_hll(self, name, entries, attr: str, build: bool):
        """One partition's Cardinality sketch over `attr`: version-exact
        (entry-token-matched, like the occupancy store) and built from a
        PINNED scan of exactly `entries`' files. Raises StaleSketch on a
        cold miss with builds deferred (the admission peek) or a pinned
        read lost to compaction."""
        from geomesa_tpu_torch.approx.sketches import entry_token
        from geomesa_tpu_torch.stats.sketches import Cardinality

        token = entry_token(entries)
        key = (name, attr)
        with self._lock:
            got = self._hll_parts.get(key)
        if got is not None and got[0] == token:
            return got[1]
        if not (build and self.allow_build):
            raise StaleSketch(name, "builds disabled")
        sk = Cardinality(attr, p=self._HLL_P)
        t0 = time.perf_counter()
        try:
            batches = list(self.planner.storage.scan_partitions(
                [name], manifest={name: list(entries)}))
        except OSError as e:
            raise StaleSketch(name, f"pinned read failed ({e})") from e
        from geomesa_tpu_torch.core.columnar import DictColumn

        for batch in batches:
            if batch.valid is not None and not batch.valid.all():
                batch = batch.select(batch.valid)
            col = batch.columns[attr]
            if isinstance(col, DictColumn):
                # each present value once: a register is a max over the
                # values' hashes, so repeats change nothing
                sk.observe(present_values(col))
            else:
                sk.observe(np.asarray(col))
        try:
            from geomesa_tpu_torch.utils.metrics import metrics

            metrics.counter("approx.hll_built")
            metrics.histogram("approx.build").update(
                time.perf_counter() - t0)
        except Exception:
            pass
        with self._lock:
            while len(self._hll_parts) > 512:
                self._hll_parts.pop(next(iter(self._hll_parts)))
            self._hll_parts[key] = (token, sk)
        return sk

    def fast_distinct(self, query, build: bool = True):
        """`distinct`-hinted counts: estimate COUNT(DISTINCT attr) by
        merging the version-exact per-partition HyperLogLog sketches
        under ONE manifest snapshot — Cardinality.merge is a register
        max, associative and lossless, so the merged estimate equals
        the estimate of one sketch over the whole store. INCLUDE
        filters only: a predicate changes WHICH rows count, and the
        partition sketches observed them all. The 3-sigma bound must
        fit the tolerance, like every other sketch answer; otherwise
        the caller pays the exact feature scan + host unique count
        (plan/planner.py count_result)."""
        meter = build
        hints = query.hints
        attr = hints.distinct
        if hints.sampling or hints.loose_bbox or hints.is_stats \
                or hints.is_bin or hints.is_arrow or hints.is_density \
                or hints.topk_cells or query.max_features is not None:
            return self._miss("ineligible", meter)
        sft = self.planner.storage.sft
        if (sft.user_data or {}).get("geomesa.vis.attr"):
            return self._miss("ineligible", meter)
        if attr not in sft:
            return self._miss("ineligible", meter)
        if not isinstance(query.filter_ast, ast.Include):
            return self._miss("ineligible", meter)
        tol = hints.tolerance
        if tol is None:
            return self._miss("ineligible", meter)
        snap_fn = getattr(self.planner.storage, "manifest_snapshot", None)
        if snap_fn is None:
            return self._miss("no_snapshot", meter)
        t0 = time.perf_counter()
        with TRACER.span("approx.answer"):
            snap = snap_fn()
            version = getattr(snap, "version", None)
            mkey = ("distinct", query.type_name, attr, version)
            with self._lock:
                est = self._count_memo.get(mkey)
            if est is None:
                from geomesa_tpu_torch.stats.sketches import Cardinality

                merged = Cardinality(attr, p=self._HLL_P)
                try:
                    for name, entries in snap.items():
                        if entries:
                            merged.merge(self._partition_hll(
                                name, entries, attr, build))
                except StaleSketch:
                    # same cold-vs-raced split as the count tier
                    return self._miss("cold" if not build
                                      else "stale_sketch")
                est = int(round(merged.result()))
                with self._lock:
                    if len(self._count_memo) > 512:
                        self._count_memo.clear()
                    self._count_memo[mkey] = est
            bound = int(math.ceil(3.0 * self._HLL_RSE * est))
            if bound > tol * max(est, 1):
                return self._miss("bound_exceeded", meter)
            self._served("distinct", t0)
            from geomesa_tpu_torch.plan.planner import QueryResult

            return QueryResult("count", count=est, approx=True,
                               bound=float(bound), confidence=0.99,
                               version=version)

    def _region(self, plan):
        return merge_region(self._sketches(plan), plan.interval)

    def _region_clipped(self, plan):
        """The merged region with the FILTER bbox folded in: cells
        fully inside it stay certain, cells its edge cuts through move
        their mass to the uncertain component (rows there may or may
        not match), cells outside drop to zero — so a density window
        wider than the filter bbox still gets a valid bound."""
        from geomesa_tpu_torch.approx.sketches import cell_ranges

        sure, maybe, b = self._region(plan)
        if sure is None:
            return sure, maybe, b
        c0, c1, r0, r1, ci0, ci1, ri0, ri1 = cell_ranges(plan.bbox, b)
        keep = np.zeros((b, b), bool)
        keep[r0:r1 + 1, c0:c1 + 1] = True
        inner = np.zeros((b, b), bool)
        if ri0 <= ri1 and ci0 <= ci1:
            inner[ri0:ri1 + 1, ci0:ci1 + 1] = True
        maybe2 = np.where(keep, (maybe if maybe is not None else 0)
                          + np.where(inner, 0, sure), 0).astype(np.int64)
        sure2 = np.where(inner, sure, 0).astype(np.int64)
        return sure2, maybe2, b

    def stats(self) -> dict:
        out = {"enabled": self.store is not None,
               "allow_build": self.allow_build}
        if self.store is not None:
            out.update(self.store.stats())
        return out
