"""KNearestNeighborSearchProcess.

The counterpart of the reference package's `process/knn.py`. Parity:
geomesa-process knn/KNearestNeighborSearchProcess [upstream, unverified]:
the same parameters (inputFeatures, dataFeatures, numDesired,
estimatedDistance, maxSearchDistance) and guarantee (the k nearest by
geodesic distance within maxSearchDistance).

Over a materialized FeatureBatch there is no window to grow: one exact
pass over the batch. Over a FeatureSource, ONE covering window for all
query points at the current radius feeds the kNN; the radius doubles
while some query's k-th neighbour lies beyond the searched radius (or is
missing), up to max_search_distance_m and MAX_WIDEN_ROUNDS rounds.

Routes (`impl`): "sparse" and "fullscan" are the fused scans
(`engine/knn_scan.py`, kernels B1 and B2 in `engine/kernels/
chord_blockmin.cu`); "haversine" is the exact f64 `engine.knn.knn`;
"mxu" the centred chord product plus an exact refine (`knn_mxu`, its
uncertain queries re-run on `knn`); "grid" the grid index
(`engine/grid_index.py` `knn_indexed`). "auto" takes sparse (filtered)
or fullscan (INCLUDE) over batches of 2^20 rows or more, else haversine;
over a store of 2^20 rows or more it runs the planner's scan, which
resolves it from the stats sketches, and below that the window path.

`device` is where a batch's pass runs; None means the card (raising
`CudaUnavailableError` without one), as everywhere in the port. A
source's planner scan runs on the source's own device.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Union

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.cql import ast, compile_filter, parse_cql
from geomesa_tpu_torch.cql.extract import BBox
from geomesa_tpu_torch.engine.device import (
    VALID, fetch, resolve_device, to_device, to_device_cached)
from geomesa_tpu_torch.engine.grid_index import auto_grid_params, knn_indexed
from geomesa_tpu_torch.engine.knn import knn, knn_mxu
from geomesa_tpu_torch.engine.knn_scan import knn_fullscan_tiled, knn_sparse_auto
from geomesa_tpu_torch.plan.datastore import FeatureSource
from geomesa_tpu_torch.plan.planner import _pad_to_k
from geomesa_tpu_torch.plan.query import Query
from geomesa_tpu_torch.process.util import filter_batch, window_filter, window_query


@dataclasses.dataclass
class KnnResult:
    indices: np.ndarray  # [Q, k] into `features`
    distances_m: np.ndarray  # [Q, k] (inf where fewer than k within range)
    features: Optional[FeatureBatch]  # the candidate set the indices refer to
    # True when the widen loop hit its round cap before every query's
    # recall condition held: the neighbours are the best within the last
    # searched radius, and a closer point MAY lie between it and
    # max_search_distance_m
    partial_recall: bool = False


# Bound on the widen-and-retry rounds: the radius doubles a round, so 48
# rounds cover >14 decimal orders of magnitude from any sane estimate;
# hitting the cap means the window can never fill (e.g. an infinite
# max_search_distance over a region with < k points), and the answer is
# a partial_recall result, not an unbounded loop.
MAX_WIDEN_ROUNDS = 48


class KNearestNeighborSearchProcess:
    name = "KNearestNeighborSearchProcess"

    def __init__(self):
        # sparse-scan tile capacities cached across queries: per batch
        # (dropped with it), keyed by (filter, k); an overflow drops the key
        self._cap_cache: dict = {}
        # compiled CQL filters reused across execute() calls
        self._filter_cache: dict = {}

    def execute(
        self,
        input_features: FeatureBatch,
        data_features: Union[FeatureSource, FeatureBatch],
        num_desired: int = 10,
        estimated_distance_m: float = 10_000.0,
        max_search_distance_m: float = 1_000_000.0,
        cql_filter: str = "INCLUDE",
        query_tile: int = 1024,
        impl: str = "auto",
        device: Optional[Union[str, torch.device]] = None,
    ) -> KnnResult:
        """The k nearest data features of each input feature's point
        (module docstring for `impl` and `device`)."""
        dev = resolve_device(device)
        qcol = input_features.geometry
        qx, qy = np.asarray(qcol.x), np.asarray(qcol.y)

        if isinstance(data_features, FeatureBatch):
            eff = self._resolve_impl(impl, len(data_features), cql_filter)
            if eff in ("sparse", "fullscan"):
                # the whole batch stays resident (cached across calls) and
                # the filter becomes a device mask: no host compaction
                return self._solve_scan(
                    qx, qy, data_features, cql_filter, num_desired,
                    max_search_distance_m, eff, dev, query_tile=query_tile)
            candidates = filter_batch(data_features, cql_filter, dev)
            return self._solve(qx, qy, candidates, num_desired,
                               max_search_distance_m, query_tile, eff, dev)

        radius = max(float(estimated_distance_m), 1.0)
        # auto keeps the f64 window path for small stores; the planner's
        # fused scan (f32-keyed, exact neighbour sets) for large ones
        use_planner_scan = hasattr(data_features, "planner") and (
            impl in ("sparse", "fullscan")
            or (impl == "auto"
                and getattr(data_features.storage, "count", 0) >= (1 << 20)))
        rounds = 0
        while True:
            bbox = BBox(float(qx.min()), float(qy.min()), float(qx.max()),
                        float(qy.max())).buffer_degrees(radius)
            if use_planner_scan:
                result = self._solve_planner(
                    qx, qy, data_features, bbox, cql_filter, num_desired,
                    max_search_distance_m, impl)
            else:
                candidates = window_query(data_features, bbox, cql_filter)
                if candidates is None or len(candidates) == 0:
                    if (radius >= max_search_distance_m
                            or rounds >= MAX_WIDEN_ROUNDS):
                        empty = self._solve(
                            qx, qy,
                            candidates if candidates is not None
                            else input_features.select(np.zeros(0, np.int64)),
                            num_desired, max_search_distance_m, query_tile,
                            impl, dev)
                        if rounds >= MAX_WIDEN_ROUNDS:
                            empty.partial_recall = True
                        return empty
                    rounds += 1
                    radius = min(radius * 2, max_search_distance_m)
                    continue
                result = self._solve(qx, qy, candidates, num_desired,
                                     max_search_distance_m, query_tile, impl,
                                     dev)
            # recall condition: every query's k-th neighbour must lie within
            # the searched radius, else a closer point may sit outside the
            # window: widen and retry
            kth = result.distances_m[:, -1]
            unsafe = (kth > radius) & np.isfinite(kth)
            short = ~np.isfinite(kth)
            if (unsafe.any() or short.any()) and radius < max_search_distance_m:
                if rounds >= MAX_WIDEN_ROUNDS:
                    result.partial_recall = True
                    return result
                rounds += 1
                radius = min(radius * 2, max_search_distance_m)
                continue
            return result

    @staticmethod
    def _resolve_impl(impl: str, n: int, cql_filter: str) -> str:
        if impl != "auto":
            return impl
        if n >= (1 << 20):
            return "sparse" if cql_filter != "INCLUDE" else "fullscan"
        return "haversine"

    def _compiled(self, cql_filter: str, f: ast.Filter, sft):
        """The filter cache: the value holds the sft strongly, so its id()
        cannot be recycled onto another schema while the entry lives; the
        identity check guards the cleared-then-reused case."""
        fkey = (cql_filter, id(sft))
        ent = self._filter_cache.get(fkey)
        if ent is not None and ent[0] is sft:
            return ent[1]
        if len(self._filter_cache) > 256:
            self._filter_cache.clear()
        compiled = compile_filter(f, sft)
        self._filter_cache[fkey] = (sft, compiled)
        return compiled

    def _solve_scan(self, qx, qy, batch: FeatureBatch, cql_filter: str,
                    k: int, max_dist: float, eff: str, dev: torch.device,
                    query_tile: int = 256) -> KnnResult:
        """Fused-scan solve over the whole resident batch. query_tile
        applies to the fullscan route (each tile re-scans the batch); the
        sparse route ranks all queries in one pass."""
        dv = to_device_cached(batch, dev, coord_dtype=torch.float32)
        g = batch.sft.default_geometry
        cx, cy = dv[f"{g.name}__x"], dv[f"{g.name}__y"]
        mask = dv[VALID]
        f = parse_cql(cql_filter)
        if not isinstance(f, ast.Include):
            compiled = self._compiled(cql_filter, f, batch.sft)
            mask = mask & compiled.mask(dv, batch)
            if compiled.has_band:
                # the f64 re-check of the rows in the f32 boundary band,
                # scattered into the device mask at their indices
                bidx, bexact = compiled.band_corrections(dv, batch)
                if len(bidx):
                    if batch.valid is not None:
                        bexact = bexact & batch.valid[bidx]
                    mask[torch.from_numpy(bidx).to(dev)] = (
                        torch.from_numpy(bexact).to(dev))
        # the clamp binds only when n < k
        kk = min(k, len(batch))
        mb = max(64, kk)
        jqx = torch.from_numpy(np.asarray(qx, np.float32)).to(dev)
        jqy = torch.from_numpy(np.asarray(qy, np.float32)).to(dev)
        if eff == "sparse":
            # a capacity slot per batch, dropped with it (id() alone could
            # be recycled onto a new batch; a stale capacity is never
            # wrong, since an overflow falls back, but wastes a dense rerun)
            bkey = id(batch)
            slot = self._cap_cache.get(bkey)
            if slot is None:
                slot = self._cap_cache[bkey] = {}
                weakref.finalize(batch, self._cap_cache.pop, bkey, None)
            key = (cql_filter, kk)
            fd, fi, cap = knn_sparse_auto(jqx, jqy, cx, cy, mask, k=kk,
                                          tile_capacity=slot.get(key),
                                          m_blocks=mb)
            if cap > 0:
                slot[key] = cap
            else:
                slot.pop(key, None)  # overflow: recalibrate
        else:
            fd, fi = fetch(*knn_fullscan_tiled(jqx, jqy, cx, cy, mask, k=kk,
                                               m_blocks=mb,
                                               query_tile=query_tile))
            fi = fi.astype(np.int32)
        dists, idx = _pad_to_k(fd, fi, k)
        dists = np.where(dists <= max_dist, dists, np.inf)
        return KnnResult(idx, dists, batch)

    def _solve_planner(self, qx, qy, source, bbox: BBox, cql_filter: str,
                       k: int, max_dist: float, impl: str) -> KnnResult:
        """Store path: the planner's device mask + fused scan (its result
        is already padded to k columns). "auto" flows through: the planner
        resolves it from its stats sketches."""
        dists, idx, batch = source.planner.knn(
            _window_cql(source.sft, bbox, cql_filter), qx, qy, k=k, impl=impl)
        dists = np.where(dists <= max_dist, dists, np.inf)
        return KnnResult(idx, dists, batch)

    def _solve(self, qx, qy, candidates: Optional[FeatureBatch], k: int,
               max_dist: float, query_tile: int, impl: str,
               dev: torch.device) -> KnnResult:
        if candidates is None or len(candidates) == 0:
            return KnnResult(np.zeros((len(qx), k), np.int32),
                             np.full((len(qx), k), np.inf), candidates)
        use_mxu = impl == "mxu"
        use_grid = impl == "grid" or (
            impl == "auto" and len(qx) >= 512 and len(candidates) >= (1 << 20))
        dv = to_device(candidates, dev, coord_dtype=torch.float32
                       if (use_mxu or use_grid) else torch.float64)
        g = candidates.sft.default_geometry
        cx, cy, valid = dv[f"{g.name}__x"], dv[f"{g.name}__y"], dv[VALID]
        # the clamp binds only for n < k candidate sets
        kk = min(k, len(candidates))
        tqx = torch.from_numpy(np.asarray(qx, np.float64)).to(dev)
        tqy = torch.from_numpy(np.asarray(qy, np.float64)).to(dev)
        if use_grid:
            # many queries against a large batch: one sort amortized over
            # all queries; uncertain queries fall back inside
            g_edge, slots = auto_grid_params(len(candidates))
            dists, idx = fetch(*knn_indexed(tqx, tqy, cx, cy, valid, k=kk,
                                            g=g_edge, ring_radius=2,
                                            cell_slots=slots))
        elif use_mxu:
            dists, idx, flags = fetch(*knn_mxu(tqx, tqy, cx, cy, valid, k=kk,
                                               with_flags=True))
            if flags.any():
                # the certificate failed for these queries: re-solve just
                # them on the exact haversine path
                rows = torch.from_numpy(np.nonzero(flags)[0]).to(dev)
                ed, ei = fetch(*knn(tqx[rows], tqy[rows], cx, cy, valid, k=kk,
                                    query_tile=min(query_tile, max(len(rows), 1))))
                dists, idx = dists.copy(), idx.copy()
                dists[flags] = ed
                idx[flags] = ei
        else:
            dists, idx = fetch(*knn(tqx, tqy, cx, cy, valid, k=kk,
                                    query_tile=min(query_tile, max(len(qx), 1))))
        dists, idx = _pad_to_k(dists, idx, k)
        dists = np.where(dists <= max_dist, dists, np.inf)
        return KnnResult(idx, dists, candidates)


def _window_cql(sft, bbox: BBox, cql_filter: str) -> Query:
    """BBOX-window Query ANDed with an optional ECQL filter."""
    return Query(sft.name, window_filter(sft, bbox, cql_filter))
