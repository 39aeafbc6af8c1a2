"""Request coalescing: compatible in-flight queries share one device
execution.

A copy of the reference package's `serve/batcher.py` over the port's
planner: a coalesced kNN window is one `planner.knn_launch(...).sync()`,
which launches B1 (`chord_blockmin_sparse`) or B2 (`chord_blockmin`) once
for the whole stacked query axis. The pipelined route's cross-kind
count fusion (`fused_count_key`), the ring's window-class key
(`ring_key`) and the launch attribution (`note_launch_route`: the mesh
shape and the shards a mesh window ran on) are here; a sketch-served count
answers its riders an `ApproxCount`.

The engine kernels are already batched over query sets — `knn_sparse_scan`
/ `knn_fullscan_tiled` take [Q] query-point arrays and compute every row
independently — so N concurrent kNN requests with the same store, filter,
k and kernel choice stack their query points into ONE kernel launch
instead of N. That is the continuous-batching lever (Orca/Clipper shape,
PAPERS.md): under concurrent load, throughput-per-chip is bounded by
dispatches, not by rows.

Compatibility rules (see docs/SERVING.md):
- knn:   same (type, canonical CQL, hints, k, impl) — query points are
         the batched axis; results split back per request. Stacked Q pads
         to a pow2 (floor 8), as in the reference.
- count / execute: same (type, canonical CQL, hints, projection, sort,
         limit) — byte-identical queries, executed ONCE with the
         result shared (dedup). QueryResult is treated as immutable by
         every consumer, so sharing the object is safe.

Anything else returns key None and never coalesces. Correctness first:
keys include the full hint string, so auths/visibility, sampling and
aggregation hints can never alias across tenants.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.plan.planner import QueryTimeout
from geomesa_tpu_torch.serve.scheduler import ServeRequest
from geomesa_tpu_torch.telemetry.trace import TRACER
from geomesa_tpu_torch.utils.padding import next_pow2 as _next_pow2

# floor for the padded stacked-query axis, as in the reference: keeps
# the stacked shapes a handful ({8, 16, 32, ...}) across ragged batches
MIN_KNN_BATCH = 8


def compat_key(req: ServeRequest) -> Optional[tuple]:
    """Coalescing key, or None when the request must run alone. The
    filter canonicalizes through the AST so textual variants ("a=1 AND
    b=2" vs "a = 1 AND b = 2") still coalesce."""
    q = req.query
    try:
        cql = ast.to_cql(q.filter_ast)
    except Exception:
        return None
    hints = str(q.hints)
    if req.kind == "knn":
        return ("knn", q.type_name, cql, hints, req.k, req.impl)
    if req.kind == "count":
        return ("count", q.type_name, cql, hints, q.max_features)
    # execute: only byte-identical result specs dedup
    attrs = tuple(q.attributes) if q.attributes is not None else None
    sort = tuple(q.sort_by) if q.sort_by else None
    return ("execute", q.type_name, cql, hints, attrs, sort,
            q.max_features)


def ring_key(req: ServeRequest, q_padded: int) -> Optional[tuple]:
    """Ring-program window-class key: the kNN compat key extended with the
    padded stacked-query bucket (a captured graph is shape-specific, so
    windows that pad to different pow2 buckets arm separate programs).
    None = this request never rides the ring."""
    if req.kind != "knn":
        return None
    base = compat_key(req)
    if base is None:
        return None
    return base + (int(q_padded),)


def fused_count_key(req: ServeRequest) -> Optional[tuple]:
    """Cross-kind fusion: the compat key of a COUNT request that may ride
    this kNN request's window, or None when fusion is unsafe. A count
    against the same (type, canonical CQL, hints) is one reduction over
    the filter mask the kNN launch computes anyway.

    Gates (each a case where the fused mask count could diverge from
    `planner.count`): INCLUDE filters (`count` answers them from the
    manifest), sampling / loose_bbox / aggregation hints (the count path
    treats the mask differently), and max_features (the fused key pins
    None: a bounded count clamps)."""
    if req.kind != "knn":
        return None
    q = req.query
    try:
        if isinstance(q.filter_ast, ast.Include):
            return None
        cql = ast.to_cql(q.filter_ast)
    except Exception:
        return None
    h = q.hints
    if h.sampling or h.loose_bbox or h.is_density or h.is_stats:
        return None
    return ("count", q.type_name, cql, str(h), None)


def note_launch_route(reqs: List[ServeRequest], launch) -> None:
    """Stamp the launch's routing attribution (mesh topology + owning
    shards) onto every member so ServeEvents report where the window ran:
    "(4,)" and "0,1,2,3" for a whole-mesh window, one shard id for the
    shard-affinity route; nothing off the mesh tier."""
    mesh_shape = getattr(launch, "mesh_shape", ()) or ()
    shards = getattr(launch, "shards", ()) or ()
    if not mesh_shape and not shards:
        return
    ms = str(tuple(mesh_shape)) if mesh_shape else ""
    sh = ",".join(map(str, shards))
    for r in reqs:
        r.mesh_shape = ms
        r.shards = sh


def stack_queries(reqs: List[ServeRequest]):
    """Host prep for one kNN window: stack member query points into one
    [Q] array pair padded to a pow2 (floor MIN_KNN_BATCH). Shared by the
    serial path and the pipeline's prepare stage so the two build
    byte-identical kernel inputs. Returns (qx, qy, offsets) with qx/qy
    already padded (repeat of the first point: cheap, in-bounds,
    discarded on split)."""
    xs = [np.asarray(r.qx, np.float64).ravel() for r in reqs]
    ys = [np.asarray(r.qy, np.float64).ravel() for r in reqs]
    offsets = np.cumsum([0] + [len(x) for x in xs])
    qx = np.concatenate(xs)
    qy = np.concatenate(ys)
    total = len(qx)
    padded = max(MIN_KNN_BATCH, _next_pow2(total))
    if padded > total:
        qx = np.concatenate([qx, np.full(padded - total, qx[0])])
        qy = np.concatenate([qy, np.full(padded - total, qy[0])])
    return qx, qy, offsets


def split_knn_results(reqs: List[ServeRequest], offsets, dists, idx,
                      batch) -> None:
    """Resolve one kNN window's member futures from the stacked [Q, k]
    result rows ("merge": set_result runs protocol callbacks inline)."""
    with TRACER.span("merge", members=len(reqs)):
        for i, r in enumerate(reqs):
            a, b = offsets[i], offsets[i + 1]
            r.future.set_result((dists[a:b], idx[a:b], batch))


def batch_timeout_ms(reqs: List[ServeRequest]) -> Optional[int]:
    """Deadline for a shared dispatch: the LONGEST remaining budget among
    members (a short-deadline rider must not kill work others still
    want). None if any member is deadline-free. Floored at 1ms so a
    nearly-expired straggler doesn't disable the check entirely."""
    remaining = []
    for r in reqs:
        ms = r.remaining_ms
        if ms is None:
            return None
        remaining.append(ms)
    return max(1, int(max(remaining)))


def split_expired(
    reqs: List[ServeRequest],
) -> Tuple[List[ServeRequest], List[ServeRequest]]:
    """Requests whose deadline passed while queued never reach the
    device; their futures get a typed QueryTimeout(phase="queued")."""
    live, dead = [], []
    for r in reqs:
        (dead if r.expired else live).append(r)
    return live, dead


def fail_expired(reqs: List[ServeRequest]) -> None:
    now = time.monotonic()
    for r in reqs:
        if r.future.set_running_or_notify_cancel():
            waited_ms = (now - r.enqueued_at) * 1000.0
            # the original budget = wait so far + (negative) remaining
            budget_ms = waited_ms + (r.remaining_ms or 0.0)
            r.future.set_exception(
                QueryTimeout("queued", waited_ms, budget_ms)
            )


def execute_batch(source, reqs: List[ServeRequest]) -> None:
    """Run one coalesced group against its FeatureSource and resolve
    every member future. `reqs` share a compat key (or are a singleton).
    Exceptions fan out to every member — a failed shared dispatch fails
    all riders identically, like N serial runs of the same query would.

    Device OOM is the exception to the fan-out: a batch that exhausts
    device memory HALVES its bucket (the padded stacked-query axis
    shrinks with it) and retries each half. A request that still OOMs
    alone fails with a typed DeviceOOM when its store lives on the card:
    the port never moves a card's work to the host. On a CPU store it
    falls back to exact host evaluation (faults/fallback.py), as the
    reference does."""
    running = [r for r in reqs if r.future.set_running_or_notify_cancel()]
    if not running:
        return
    _run_group(source, running)


def _run_group(source, reqs: List[ServeRequest]) -> None:
    from geomesa_tpu_torch.faults import classify

    timeout_ms = batch_timeout_ms(reqs)
    try:
        if reqs[0].kind == "knn":
            _execute_knn(source, reqs, timeout_ms)
        else:
            _execute_shared(source, reqs, timeout_ms)
    except BaseException as e:  # noqa: BLE001 — fan the failure out
        if isinstance(e, Exception) and classify(e) == "oom":
            _oom_fallback(source, reqs, e)
            return
        for r in reqs:
            r.future.set_exception(e)


def _oom_fallback(source, reqs: List[ServeRequest],
                  oom: BaseException) -> None:
    from geomesa_tpu_torch.faults import DeviceOOM
    from geomesa_tpu_torch.telemetry.recorder import RECORDER
    from geomesa_tpu_torch.utils.metrics import metrics

    if reqs[0].kind == "knn" and len(reqs) > 1:
        # halve the batch bucket: each kNN half pads to a smaller pow2
        # stacked-query axis, so the retried program is genuinely
        # smaller — not the same allocation failing twice. Only kNN
        # qualifies: count/execute groups DEDUP to one planner run
        # whose program size is independent of rider count, so halving
        # them would just re-fail the identical allocation
        metrics.counter("serve.oom.halved")
        # flight-recorder lifecycle event: each ladder step records, so
        # a crash dump shows the descent (64 -> 32 -> ... -> 1) that
        # preceded an incident instead of one opaque OOM
        RECORDER.note_event("oom", action="halved", batch=len(reqs),
                            query_kind=reqs[0].kind)
        mid = len(reqs) // 2
        _run_group(source, reqs[:mid])
        _run_group(source, reqs[mid:])
        return
    device = getattr(getattr(source, "planner", None), "device", None)
    if getattr(device, "type", None) != "cpu":
        # the store's tensors are on the card: the ladder ends here, and
        # the client sees the OOM, typed, instead of a host answer
        metrics.counter("serve.oom.failed")
        RECORDER.note_event("oom", action="failed", batch=len(reqs),
                            query_kind=reqs[0].kind)
        exc = DeviceOOM(f"out of memory on {device}: {oom}")
        exc.__cause__ = oom
        for r in reqs:
            r.future.set_exception(exc)
        return
    # host evaluation, ONCE per group: shared count/execute riders get
    # the same (immutable) result object, exactly like _execute_shared
    RECORDER.note_event("oom", action="hosteval", batch=len(reqs),
                        query_kind=reqs[0].kind)
    try:
        from geomesa_tpu_torch.faults.fallback import host_fallback

        out = host_fallback(source, reqs[0])
    except BaseException as e:  # noqa: BLE001 — surface typed, not raw
        exc = e if isinstance(e, Exception) else oom
        for r in reqs:
            r.future.set_exception(exc)
        return
    metrics.counter("serve.oom.hosteval")
    for r in reqs:
        r.future.set_result(out)


# result-cache value-size gates: the LRU bounds entry COUNT, so
# entries must be individually small or a handful of wide execute
# results pins gigabytes. Feature results cap at the wire's row
# ceiling; grids/payloads at a few MB. Oversized results simply
# re-execute — correctness is untouched.
_CACHE_MAX_ROWS = 10_000          # == protocol.MAX_FEATURE_ROWS
_CACHE_MAX_GRID_CELLS = 1 << 20   # 1M f64 cells = 8 MB


def _cacheable_value(provenance) -> bool:
    feats = getattr(provenance, "features", None)
    if feats is not None and len(feats) > _CACHE_MAX_ROWS:
        return False
    grid = getattr(provenance, "grid", None)
    if grid is not None and grid.size > _CACHE_MAX_GRID_CELLS:
        return False
    return True


def _cache_put(lead: ServeRequest, provenance, value) -> None:
    """Populate the service's version-exact result cache from one
    executed dispatch. `provenance` is the QueryResult carrying the
    manifest version the PLAN pinned — keying on a version read any
    later could stamp a pre-write key onto post-write data. Approx,
    degraded and oversized results never cache (the cache's contract
    is exact bit-identical replay within a bounded memory envelope)."""
    cache = lead.cache
    if (cache is None or lead.degraded or provenance.approx
            or provenance.version is None
            or not _cacheable_value(provenance)):
        return
    from geomesa_tpu_torch.approx.cache import result_key

    cache.put(result_key(lead.kind, lead.query, provenance.version),
              value)


def _execute_shared(source, reqs: List[ServeRequest],
                    timeout_ms: Optional[int]) -> None:
    """count/execute dedup: one planner run, every rider gets the same
    (immutable) result object. Successful exact results populate the
    version-exact result cache (docs/SERVING.md "Approximate
    answers"); sketch-served answers mark every rider `approx` for
    ServeEvent/SLO attribution."""
    lead = reqs[0]
    if lead.kind == "count":
        qr = source.planner.count_result(lead.query, timeout_ms=timeout_ms)
        if qr.approx:
            from geomesa_tpu_torch.approx.engine import ApproxCount

            out = ApproxCount(int(qr.count), int(qr.bound), qr.confidence)
        else:
            out = int(qr.count)
        provenance = qr
    else:
        out = source.planner.execute(lead.query, timeout_ms=timeout_ms)
        provenance = out
    if provenance.approx:
        for r in reqs:
            r.approx = True
    _cache_put(lead, provenance, out)
    with TRACER.span("merge", members=len(reqs)):
        for r in reqs:
            r.future.set_result(out)


def _execute_knn(source, reqs: List[ServeRequest],
                 timeout_ms: Optional[int] = None) -> None:
    """Stack member query points into one [Q] kernel launch and split
    the [Q, k] result rows back out. Rows are computed independently by
    the kernels, so per-request results are identical to serial runs of
    the same kernel (tests/test_torch_serve.py). The dispatch seam is
    launch + sync, the composition planner.knn is too; `sync` is the
    window's one host sync."""
    with TRACER.span("knn.stack", members=len(reqs)):
        qx, qy, offsets = stack_queries(reqs)
    lead = reqs[0]
    launch = source.planner.knn_launch(
        lead.query, qx, qy, k=lead.k, impl=lead.impl,
        timeout_ms=timeout_ms,
    )
    note_launch_route(reqs, launch)
    dists, idx, batch = launch.sync()
    split_knn_results(reqs, offsets, dists, idx, batch)
