"""Device-OOM host-evaluation fallback.

A copy of the reference package's `faults/fallback.py` over the port's
host evaluator (`cql/hosteval.py`). When a dispatch exhausts device
memory, the serve batcher first halves the coalesced batch bucket
(smaller stacked-query axis, smaller launch) and, for a request that
still OOMs alone, evaluates it HERE: full host scan, exact f64 filter
evaluation, and a NumPy haversine kNN — slow, but correct and
device-free, so a memory-squeezed server degrades to answers instead of
errors.

Supported kinds: count, plain feature execute, knn. Aggregation hints
(density/stats) have device-shaped outputs this path cannot reproduce;
those surface the original OOM as a typed error instead. The type's
interceptor chain runs as on the device path, and feature-level
visibility masks the rows on the host (`security.visibility.allow_mask`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from geomesa_tpu_torch.faults.errors import PermanentError


def _intercepted(source, query):
    """Run the planner's QueryInterceptor chain as the device path does
    (plan() -> run_interceptors): a guard or rewrite configured on the
    type binds on the host path too. The chain marks the query, so it
    applies exactly once."""
    interceptors = getattr(getattr(source, "planner", None),
                           "interceptors", None)
    if not interceptors:
        return query
    from geomesa_tpu_torch.plan.interceptor import run_interceptors

    return run_interceptors(query, interceptors)


def _host_scan(source, query):
    """Materialize the source's rows on host (no device touch), with
    the same plan-time filter-column projection the device path uses
    left OFF — the host evaluator may need any referenced column."""
    from geomesa_tpu_torch.core.columnar import FeatureBatch

    batches = list(source.storage.scan())
    if not batches:
        return None
    return FeatureBatch.concat(batches)


def _host_mask(source, query, batch) -> np.ndarray:
    from geomesa_tpu_torch.core.columnar import DictColumn
    from geomesa_tpu_torch.cql.hosteval import eval_filter_host
    from geomesa_tpu_torch.plan.runner import VIS_ATTR_KEY
    from geomesa_tpu_torch.security.visibility import allow_mask

    mask = eval_filter_host(query.filter_ast, batch)
    vis_attr = (source.sft.user_data or {}).get(VIS_ATTR_KEY)
    col = batch.columns.get(vis_attr) if vis_attr else None
    if isinstance(col, DictColumn):
        mask = mask & allow_mask(col.vocab, col.codes, query.hints.auths)
    return mask


def host_count(source, query) -> int:
    query = _intercepted(source, query)
    batch = _host_scan(source, query)
    if batch is None:
        return 0
    n = int(_host_mask(source, query, batch).sum())
    if query.max_features is not None:
        n = min(n, query.max_features)
    return n


def host_execute(source, query):
    """Plain feature results (QueryResult kind="features")."""
    from geomesa_tpu_torch.plan.planner import QueryResult
    from geomesa_tpu_torch.plan.runner import finish_features

    query = _intercepted(source, query)
    h = query.hints
    if h.is_density or h.is_stats:
        raise PermanentError(
            "host fallback cannot evaluate aggregation hints "
            "(density/stats need the device)")
    if h.count_only:
        n = host_count(source, query)
        return QueryResult("count", count=n)
    batch = _host_scan(source, query)
    if batch is None:
        return QueryResult("features", features=None, count=0)
    sel = batch.select(_host_mask(source, query, batch))
    sel = finish_features(sel, query)
    return QueryResult("features", features=sel, count=len(sel))


def host_knn(source, query, qx, qy, k: int
             ) -> Tuple[np.ndarray, np.ndarray, object]:
    """Exact brute-force kNN on host: same (dists [Q,k] meters, idx
    [Q,k] into batch rows, batch) contract as planner.knn. Row order
    matches the device scan path (storage scan order), so indices are
    comparable on an identical snapshot."""
    from geomesa_tpu_torch.core.columnar import FeatureBatch
    from geomesa_tpu_torch.engine.geodesy import haversine_m_np
    from geomesa_tpu_torch.plan.planner import _pad_to_k

    query = _intercepted(source, query)
    qx = np.asarray(qx, np.float64).ravel()
    qy = np.asarray(qy, np.float64).ravel()
    batch = _host_scan(source, query)
    if batch is None:
        sft = source.sft
        empty = FeatureBatch.from_pydict(
            sft, {a.name: [] for a in sft.attributes})
        return (np.full((len(qx), k), np.inf),
                np.zeros((len(qx), k), np.int32), empty)
    mask = _host_mask(source, query, batch)
    g = batch.sft.default_geometry
    col = batch.columns[g.name]
    cx = np.asarray(col.x, np.float64)
    cy = np.asarray(col.y, np.float64)
    kk = min(k, len(batch))
    dists = np.empty((len(qx), kk), np.float64)
    idx = np.empty((len(qx), kk), np.int64)
    for i in range(len(qx)):
        d = haversine_m_np(qx[i], qy[i], cx, cy)
        d = np.where(mask, d, np.inf)
        order = np.argsort(d, kind="stable")[:kk]
        idx[i] = order
        dists[i] = d[order]
    dists, idx = _pad_to_k(dists, idx.astype(np.int32), k)
    return dists, idx, batch


def host_fallback(source, req):
    """Resolve one ServeRequest on the host path; returns the value its
    future expects. `req` is a serve.scheduler.ServeRequest."""
    from geomesa_tpu_torch.utils.metrics import metrics

    metrics.counter("fault.oom.hosteval")
    if req.kind == "count":
        return host_count(source, req.query)
    if req.kind == "knn":
        return host_knn(source, req.query, req.qx, req.qy, req.k)
    return host_execute(source, req.query)
