"""Aggregation push-down shared by the planner's cached and scan routes.

The counterpart of the reference package's `plan/runner.py`: `aggregate`
dispatches a batch, its device arrays and a host row mask to the device
density grid (`density_device_grid`: point layers with the
cell-dictionary route and its cross-query calibration cache,
`_zsparse_grid`; line, polygon and multipoint layers rasterized by
`engine/raster.py`), to `run_stats` (the Stat DSL over the masked rows,
its reductions in `engine/stats.py`), to Arrow IPC bytes (`arrow_encode`,
optionally a sorted DELTA batch), to BIN records (`bin_track`, packed on
the device by `engine/bin.py`) or to the matching features, finished by
`finish_features` (sort, max features, attribute redaction, projection,
output reprojection). `sample_mask` thins a mask for the sampling hint,
and `query_mask_token` keys mask-dependent caches on the query.

Visibility: `visibility_mask` is the feature-level allow mask of the
query's `auths` (the allow table over the visibility column's vocabulary,
evaluated on the host by `security/visibility.py` and gathered on the
device from the resident int32 codes, failing closed as `allow_mask`
does); `redact_attributes` nulls the attributes whose `visibility` option
the auths do not satisfy; `_check_attr_auth` refuses aggregations (stats,
bin, density weight) that would read such an attribute's values.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import weakref
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch
from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.curve.binned_time import TimePeriod, to_binned_time
from geomesa_tpu_torch.engine.density import density_grid_auto
from geomesa_tpu_torch.engine.density_zsparse import density_zsparse
from geomesa_tpu_torch.engine.device import VALID, fetch, upload
from geomesa_tpu_torch.security.visibility import VisibilityEvaluator
from geomesa_tpu_torch.utils.padding import next_pow2

if TYPE_CHECKING:
    from geomesa_tpu_torch.plan.query import Query

_SCATTER = "scatter"  # cached verdict: the dictionary kernel mostly overflows
_CALIB_CACHE_MAX = 8


class CalibCache:
    """Zsparse calibrations across queries, newest last, at most
    `_CALIB_CACHE_MAX`. An entry pins its coordinate tensor by weakref, so
    a recycled `id()` can never alias a new batch. One per planner."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}

    def get(self, key, xa):
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            ref, calib = hit
            if ref() is xa:
                return calib
            del self._entries[key]
            return None

    def put(self, key, xa, calib) -> None:
        with self._lock:
            self._entries[key] = (weakref.ref(xa), calib)
            while len(self._entries) > _CALIB_CACHE_MAX:
                self._entries.pop(next(iter(self._entries)))


def _zsparse_grid(xa, ya, w, dev_mask, bbox, width, height, cache: CalibCache,
                  mask_token=None, weighted=False) -> Optional[torch.Tensor]:
    """density_zsparse with the cross-query calibration cache.

    The calibration depends on the resident arrays AND the query's mask,
    so the key carries a `mask_token` (everything that shapes the mask
    for fixed arrays). The kernel's stale-mass check stays on as the
    backstop: exact for unweighted grids, f32-noise-bounded for weighted
    ones, which is why the token, not the check, is the correctness
    mechanism. Returns None when an earlier identical query found the
    dictionary kernel mostly overflowing: the scatter path wins then."""
    key = (id(xa), tuple(xa.shape), tuple(bbox), width, height, mask_token)
    calib = cache.get(key, xa)
    if calib is _SCATTER:
        return None
    grid, calib = density_zsparse(
        xa, ya, w, dev_mask, tuple(bbox), width, height, calib=calib,
        stale_exact=not weighted)
    # dictionary tiles in the minority: the NEXT identical query goes
    # straight to scatter (this one already paid both paths)
    overflowing = len(calib.dense_ids) > max(len(calib.tile_ids), 1)
    cache.put(key, xa, _SCATTER if overflowing else calib)
    return grid


def density_device_grid(sft: SimpleFeatureType, batch, dev, dev_mask, hints,
                        cache: CalibCache, mask_token=None,
                        mesh=None) -> torch.Tensor:
    """Device density grid for one batch (weight column or ones), shared
    by the planner's cached and scan routes so weighting semantics cannot
    diverge between them. Point layers scatter per feature; extended
    geometries rasterize (`engine.raster.density_grid_geometry`): lines
    by in-cell length, polygons by cell-center coverage. The ones weight
    is sized off the staged coordinates, as in the reference. On a mesh
    superbatch (`mesh`) a point layer takes the sharded scatter, as the
    reference's mesh route does: each shard grids its rows and the grids
    add (`engine.density.density_sharded`); counts stay exact."""
    g = sft.default_geometry
    x = dev[f"{g.name}__x"]
    y = dev[f"{g.name}__y"]
    bbox = tuple(hints.density_bbox)
    geom_col = batch.columns[g.name]
    if mesh is not None and geom_col.is_point:
        from geomesa_tpu_torch.engine.density import density_sharded

        # the weights shard by shard, where their rows live
        w = (dev[hints.density_weight].map(lambda t: t.to(torch.float32))
             if hints.density_weight
             else x.map(lambda t: torch.ones_like(t, dtype=torch.float32)))
        return density_sharded(mesh, x, y, w, dev_mask, bbox,
                               hints.density_width, hints.density_height)
    w = (dev[hints.density_weight].to(torch.float32) if hints.density_weight
         else torch.ones_like(x, dtype=torch.float32))
    if not geom_col.is_point:
        from geomesa_tpu_torch.engine.raster import density_grid_geometry

        return density_grid_geometry(geom_col, dev, g.name, w, dev_mask, bbox,
                                     hints.density_width, hints.density_height)
    # exact_weights + a weight column pins the f32 scatter path: the
    # dictionary kernel must not override the fidelity opt-in
    exact_pin = bool(hints.density_exact_weights and hints.density_weight)
    use_z = hints.density_zsparse
    if use_z is None:
        # AUTO: the calibration pass is itself the per-tile dictionary-
        # vs-scatter decision, so no separate order heuristic is needed
        use_z = not exact_pin
    elif use_z and exact_pin:
        use_z = False
    if use_z:
        grid = _zsparse_grid(
            x, y, w, dev_mask, bbox, hints.density_width,
            hints.density_height, cache, mask_token=mask_token,
            weighted=hints.density_weight is not None)
        if grid is not None:
            return grid
    return density_grid_auto(x, y, w, dev_mask, bbox, hints.density_width,
                             hints.density_height,
                             exact_weights=hints.density_exact_weights)


_FID_BATCH_SEQ = itertools.count()


def apply_fid_policy(batch: FeatureBatch, include_fid: bool) -> FeatureBatch:
    """Deterministic __fid__ presence for wire formats: fids synthesized
    when requested but absent (the store may have kept none), stripped
    when not, so a result's schema never depends on which rows matched.
    Synthesized fids carry a process-unique batch tag (`b<seq>.<row>`):
    results of different shards merge client-side at the IPC level."""
    if include_fid and batch.fids is None:
        tag = f"b{next(_FID_BATCH_SEQ)}"
        return dataclasses.replace(batch, fids=DictColumn.encode(
            [f"{tag}.{i}" for i in range(len(batch))]))
    if not include_fid and batch.fids is not None:
        return dataclasses.replace(batch, fids=None)
    return batch


def arrow_payload(sel: FeatureBatch, hints) -> bytes:
    """The ArrowScan encoding of finished features: one IPC stream, or a
    sorted DELTA batch (the sort stamped in its schema metadata) when
    `arrow_sort_field` is set."""
    from geomesa_tpu_torch.core.arrow_io import to_ipc_bytes, to_sorted_ipc_bytes

    sel = apply_fid_policy(sel, hints.arrow_include_fid)
    if hints.arrow_sort_field:
        if hints.arrow_sort_field not in sel.columns:
            raise ValueError(
                f"arrow_sort_field {hints.arrow_sort_field!r} is not in the "
                "result columns: include it in the query's projection (the "
                "delta merge needs the key client-side)")
        return to_sorted_ipc_bytes(sel, hints.arrow_sort_field,
                                   hints.arrow_sort_reverse)
    return to_ipc_bytes(sel)


def bin_bytes(sft: SimpleFeatureType, batch: FeatureBatch, dev,
              mask: np.ndarray, hints) -> bytes:
    """BIN records of the masked rows: the lanes packed on the device over
    every staged row (track codes, dtg, lat, lon, optional label), one
    fetch, then the selected rows serialized on the host. Over a sharded
    batch each shard packs its own rows on its device and the packed
    rows concatenate in shard order (the packing is row by row)."""
    from geomesa_tpu_torch.engine.bin import bin_pack, encode_bin
    from geomesa_tpu_torch.parallel.mesh import Sharded, on_shard, shard_dicts

    g, d = sft.default_geometry, sft.default_dtg
    vx = dev[f"{g.name}__x"]
    if isinstance(vx, Sharded):
        parts = [(dv, i * vx.shard_rows, dev_)
                 for i, (dv, dev_) in enumerate(zip(shard_dicts(vx.mesh, dev),
                                                    vx.mesh.device_list))]
    else:
        parts = [(dev, 0, dev[VALID].device)]

    def track_codes(name, lo, n, device):
        col = batch.columns[name]
        codes = (np.asarray(col.codes) if isinstance(col, DictColumn)
                 else np.asarray(col).astype(np.int32))
        return torch.from_numpy(
            np.ascontiguousarray(codes[lo:lo + n])).to(device)

    packed = []
    for dv, lo, device in parts:
        with on_shard(device):
            x = dv[f"{g.name}__x"]
            n = int(x.shape[0])
            dtg = (dv[d.name] if d is not None
                   else torch.zeros_like(x, dtype=torch.int64))
            label = (track_codes(hints.bin_label, lo, n, device)
                     if hints.bin_label else None)
            packed.append(bin_pack(track_codes(hints.bin_track, lo, n, device),
                                   dtg, dv[f"{g.name}__y"], x, label=label))
    packed = np.concatenate(fetch(*packed))
    return encode_bin(packed, np.nonzero(mask)[0])


VIS_ATTR_KEY = "geomesa.vis.attr"
_EVALUATOR = VisibilityEvaluator()


def allow_table(vocab, auths) -> np.ndarray:
    """bool[|vocab|]: which visibility expressions `auths` satisfy (an
    empty or null expression is public). |vocab| evaluations, not |rows|."""
    aset = frozenset(auths)
    return np.array([_EVALUATOR.parse(v).evaluate(aset) if v else True
                     for v in vocab], dtype=bool)


def gather_allow(table: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """The allow table gathered by dictionary code on the codes' device,
    bit for bit `security.visibility.allow_mask`: codes outside the
    vocabulary are denied (fail closed) and -1 (null) is public."""
    n = len(table)
    if n == 0:
        return codes < 0
    t = upload(table, codes.device)
    gathered = torch.index_select(t, 0, codes.clamp(0, n - 1))
    return torch.where((codes >= 0) & (codes < n), gathered, codes < 0)


def visibility_mask(sft: SimpleFeatureType, batch: FeatureBatch, dev,
                    hints) -> Optional[torch.Tensor]:
    """Feature-level visibility: the device bool mask of the rows whose
    visibility expression the query's auths satisfy, or None when the
    type configures no visibility column (user_data `geomesa.vis.attr`)."""
    vis_attr = (sft.user_data or {}).get(VIS_ATTR_KEY)
    if not vis_attr or vis_attr not in batch.columns:
        return None
    col = batch.columns[vis_attr]
    if not isinstance(col, DictColumn):
        raise ValueError(
            f"visibility column {vis_attr!r} must be a String attribute")
    return gather_allow(allow_table(col.vocab, hints.auths), dev[vis_attr])


def redact_attributes(sel: FeatureBatch, hints) -> FeatureBatch:
    """Per-attribute visibility: null out the columns whose `visibility`
    option the query's auths do not satisfy, folded into the result
    projection so every feature and arrow result redacts identically.
    Strings become null codes, floats NaN, geometries NaN points (or
    zero-ring features); int and temporal columns, which have no null,
    are dropped from the result."""
    vis_attrs = [a for a in sel.sft.attributes if a.options.get("visibility")]
    if not vis_attrs:
        return sel
    from geomesa_tpu_torch.core.columnar import GeometryColumn

    cols = dict(sel.columns)
    changed = False
    n = len(sel)
    for a in vis_attrs:
        if _EVALUATOR.can_see(a.options["visibility"], hints.auths):
            continue
        changed = True
        col = cols[a.name]
        if isinstance(col, DictColumn):
            cols[a.name] = DictColumn(np.full(n, -1, np.int32), [])
        elif isinstance(col, GeometryColumn):
            if col.is_point:
                cols[a.name] = GeometryColumn(
                    col.kind, np.full(n, np.nan), np.full(n, np.nan))
            else:
                cols[a.name] = GeometryColumn(
                    col.kind, np.full(n, np.nan), np.full(n, np.nan),
                    np.zeros((0, 2), np.float64), np.zeros(1, np.int64),
                    np.zeros(n + 1, np.int64), [[0]] * n,
                    np.full((n, 4), np.nan))
        else:
            arr = np.asarray(col)
            if arr.dtype.kind == "f":
                cols[a.name] = np.full(n, np.nan)
            else:
                del cols[a.name]
    if not changed:
        return sel
    if set(cols) != set(sel.columns):
        kept = [a for a in sel.sft.attributes if a.name in cols]
        sub = SimpleFeatureType(sel.sft.name, kept, sel.sft.user_data)
        return FeatureBatch(sub, cols, sel.fids, sel.valid)
    return dataclasses.replace(sel, columns=cols)


def query_mask_token(query: "Query") -> tuple:
    """Everything that shapes the result mask for FIXED resident arrays:
    the type, the canonical filter text, the auths, sampling and loose
    bbox. Keys mask-dependent plan caches such as the zsparse
    calibration: equal tokens over the same arrays give identical
    masks."""
    h = query.hints
    return (query.type_name, ast.to_cql(query.filter_ast), tuple(h.auths),
            h.sampling, h.sample_by, h.loose_bbox)


def _check_attr_auth(sft: SimpleFeatureType, hints, names) -> None:
    """Aggregations (stats, bin, density weight) read attribute VALUES:
    one naming a visibility-protected attribute the auths cannot see
    raises PermissionError rather than stream protected data through
    sketch, grid or record bytes."""
    for name in names:
        if not name or name not in sft:
            continue
        vis = sft.attribute(name).options.get("visibility")
        if vis and not _EVALUATOR.can_see(vis, hints.auths):
            raise PermissionError(
                f"insufficient authorizations for attribute {name!r} "
                f"(visibility {vis!r})")


def aggregate(sft: SimpleFeatureType, batch: FeatureBatch, dev,
              mask: np.ndarray, query: "Query", cache: CalibCache):
    """A host row mask over `batch` to the query's result: the density
    grid, the stats, Arrow IPC bytes or BIN records when the hints ask for
    one (arrow before bin, as in the reference), else the matching
    features. Returns (result, the mask's matching rows). The planner
    has already folded the feature-level visibility mask into `mask`;
    aggregations naming an attribute the auths cannot see refuse
    (`_check_attr_auth`)."""
    from geomesa_tpu_torch.plan.planner import QueryResult

    hints = query.hints
    if hints.is_stats:
        from geomesa_tpu_torch.stats import parse_stats

        names = []
        for s in parse_stats(hints.stats_string).stats:
            names.append(getattr(s, "attribute", None))
            # a Z3 histogram reads a second attribute (the dtg column)
            names.append(getattr(s, "dtg", None))
        _check_attr_auth(sft, hints, names)
    if hints.is_bin:
        _check_attr_auth(sft, hints, [hints.bin_track, hints.bin_label])
    if hints.is_density and hints.density_weight:
        _check_attr_auth(sft, hints, [hints.density_weight])
    if hints.is_density:
        grid = density_device_grid(
            sft, batch, dev, torch.from_numpy(mask).to(dev[VALID].device),
            hints, cache, mask_token=query_mask_token(query))
        (grid,) = fetch(grid)
        n = int(mask.sum())
        return QueryResult("density", grid=grid, count=n), n
    if hints.is_stats:
        stats = run_stats(batch, dev, mask, hints.stats_string)
        n = int(mask.sum())
        return QueryResult("stats", stats=stats, count=n), n
    rows = np.nonzero(mask)[0]
    if hints.is_arrow:
        sel = finish_features(batch.select(rows), query)
        return (QueryResult("arrow", arrow_bytes=arrow_payload(sel, hints),
                            count=len(sel)), len(rows))
    if hints.is_bin:
        return (QueryResult("bin", bin_bytes=bin_bytes(sft, batch, dev, mask,
                                                       hints),
                            count=len(rows)), len(rows))
    sel = finish_features(batch.select(rows), query)
    return QueryResult("features", features=sel, count=len(sel)), len(rows)


def run_stats(batch: FeatureBatch, dev, mask: np.ndarray, expression: str):
    """Evaluate a Stat DSL expression over the masked rows: each sketch's
    reduction runs on the device of `dev` (`engine/stats.py`) over the
    batch's host columns, and folds into the sketch objects on the host.
    A Z3 histogram reads the device coordinates; vocabulary and time-bin
    sizes are padded to powers of two, as in the reference. On a mesh
    superbatch each reduction runs shard by shard over that shard's rows
    of the columns and the mask, on its device: the sums through
    `stats_sharded` (added in shard order), min/max and the HLL registers
    merged by min/max on the lead; no column is whole on one card."""
    from geomesa_tpu_torch.engine import stats as est
    from geomesa_tpu_torch.stats import parse_stats
    from geomesa_tpu_torch.stats.sketches import (
        Cardinality, DescriptiveStats, EnumerationStat, Frequency, Histogram,
        MinMax, TopK, Z3HistogramStat)

    from geomesa_tpu_torch.parallel.mesh import Sharded

    valid = dev[VALID]
    mesh = valid.mesh if isinstance(valid, Sharded) else None
    device = mesh.lead if mesh is not None else valid.device
    seq = parse_stats(expression)
    mask = np.ascontiguousarray(mask, bool)
    if mesh is not None:  # each shard's rows of the mask on its device
        s_rows = len(mask) // mesh.size
        tmask = Sharded(mesh, [
            torch.from_numpy(mask[i * s_rows:(i + 1) * s_rows]).to(d)
            for i, d in enumerate(mesh.device_list)])
    else:
        tmask = torch.from_numpy(mask).to(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def reduce(fn, *cols):
        """fn(*columns, mask): summed over the shards on a mesh."""
        if mesh is not None:
            return est.stats_sharded(mesh, fn, *(np.asarray(c) for c in cols),
                                     tmask)
        return fn(*(tensor(c) for c in cols), tmask)

    def partials(fn, col) -> list:
        """fn(column, mask) a shard (one whole part off a mesh), on the
        lead device."""
        if mesh is None:
            return [fn(tensor(col), tmask)]
        return [p.to(device) if isinstance(p, torch.Tensor)
                else tuple(t.to(device) for t in p)
                for p in est.shard_partials(mesh, fn, np.asarray(col), tmask)]

    def value_counts(col: DictColumn) -> np.ndarray:
        n = next_pow2(max(len(col.vocab), 1))
        (counts,) = fetch(reduce(
            lambda c, m: est.masked_value_counts(c, m, n), col.codes))
        return counts

    for s in seq.stats:
        if isinstance(s, Z3HistogramStat):
            bins, _ = to_binned_time(np.asarray(batch.columns[s.dtg]),
                                     TimePeriod.parse(s.period))
            ub, tb = np.unique(bins, return_inverse=True)
            nt = next_pow2(max(len(ub), 1))
            gx, gy = dev[f"{s.geom}__x"], dev[f"{s.geom}__y"]
            if mesh is not None:
                # over the sharded coordinates where they live: per-shard
                # count grids, added (exact)
                (grids,) = fetch(est.stats_sharded(
                    mesh, lambda x, y, t, m: est.z3_histogram(
                        x, y, t, m, nt, s.bins_per_dim),
                    gx, gy, tb.astype(np.int32), tmask))
            else:
                (grids,) = fetch(est.z3_histogram(
                    gx, gy, tensor(tb.astype(np.int32)), tmask, nt,
                    s.bins_per_dim))
            for i, b in enumerate(ub):
                s.observe_grid(int(b), grids[i])
            continue
        col = batch.columns.get(s.attribute) if s.attribute else None
        is_dict = isinstance(col, DictColumn)
        if isinstance(s, (TopK, EnumerationStat, Frequency)) and is_dict:
            s.observe_counts(col.vocab, value_counts(col)[: len(col.vocab)])
        elif isinstance(s, MinMax) and col is not None and not is_dict:
            if mask.any():
                parts = partials(est.masked_minmax, col)
                mn, mx = fetch(torch.stack([p[0] for p in parts]).amin(),
                               torch.stack([p[1] for p in parts]).amax())
                s.observe(np.array([float(mn), float(mx)]))
        elif isinstance(s, Histogram) and col is not None:
            (h,) = fetch(reduce(lambda v, m: est.masked_histogram(
                v, m, s.lo, s.hi, s.bins), col))
            s.observe_counts(h)
        elif isinstance(s, DescriptiveStats):
            if s.attribute and col is not None and not is_dict:
                c, sm, ssq = fetch(*reduce(est.masked_moments, col))
                s.observe_moments(int(c), float(sm), float(ssq))
            else:  # Count()
                s.observe_moments(int(mask.sum()), 0.0, 0.0)
        elif isinstance(s, Cardinality) and is_dict:
            # distinct codes present under the mask: exact for dict columns
            present = [v for v, c in zip(col.vocab, value_counts(col)) if c > 0]
            s.observe(np.asarray(present, dtype=object))
        elif isinstance(s, Cardinality) and col is not None:
            parts = partials(lambda v, m: est.hll_registers(v, m, s.p), col)
            (regs,) = fetch(torch.stack(parts).amax(0))
            s.observe_registers(regs)
        elif (isinstance(s, Frequency) and getattr(s, "numeric_keys", False)
              and col is not None and not is_dict):
            (table,) = fetch(reduce(lambda v, m: est.cms_table(
                v, m, s.width, s.depth), col))
            s.observe_table(table)
        else:  # host fallback (e.g. MinMax over strings)
            if is_dict:
                vals = np.asarray(col.decode(), dtype=object)
                sel = vals[mask]
                s.observe(sel[sel != None])  # noqa: E711
            elif col is not None:
                s.observe(np.asarray(col), mask)
    return seq


def finish_features(sel: FeatureBatch, query: "Query") -> FeatureBatch:
    """The LocalQueryRunner tail: sort, max features, attribute
    redaction, projection, then reprojection to the query's `crs` (host
    f64, `core/crs.py`)."""
    if query.sort_by:
        sel = sel.select(sort_order(sel, query.sort_by))
    if query.max_features is not None and len(sel) > query.max_features:
        sel = sel.select(np.arange(query.max_features))
    sel = redact_attributes(sel, query.hints)
    if query.attributes is not None:
        sel = project(sel, query.attributes)
    if query.crs is not None:
        from geomesa_tpu_torch.core.crs import reproject_batch

        sel = reproject_batch(sel, query.crs)
    return sel


def sort_order(batch: FeatureBatch, sort_by) -> np.ndarray:
    """Row order for `sort_by` [(attr, ascending)], first key first. A
    string column sorts by its text (codes ranked by vocabulary), nulls
    (code -1) first ascending; np.lexsort takes its keys last-first."""
    keys = []
    for attr, ascending in reversed(list(sort_by)):
        col = batch.columns[attr]
        v = np.asarray(col.codes) if isinstance(col, DictColumn) else np.asarray(col)
        if isinstance(col, DictColumn):
            rank = np.argsort(np.argsort(np.asarray(col.vocab, dtype=object)))
            v = np.where(v >= 0, rank[np.clip(v, 0, None)], -1)
        keys.append(v if ascending else -v)
    return np.lexsort(keys) if keys else np.arange(len(batch))


def project(batch: FeatureBatch, attributes) -> FeatureBatch:
    attrs = [batch.sft.attribute(a) for a in attributes]
    sft = SimpleFeatureType(batch.sft.name, attrs, batch.sft.user_data)
    cols = {a.name: batch.columns[a.name] for a in attrs}
    return FeatureBatch(sft, cols, batch.fids, batch.valid)


def sample_mask(mask: np.ndarray, n: int, groups=None) -> np.ndarray:
    """Keep every n-th matching feature; with `groups`, every n-th within
    each group (SAMPLE_BY semantics: per-track thinning)."""
    out = np.zeros_like(mask)
    if groups is None:
        idx = np.nonzero(mask)[0]
        out[idx[::n]] = True
        return out
    for gval in np.unique(groups[mask]):
        idx = np.nonzero(mask & (groups == gval))[0]
        out[idx[::n]] = True
    return out
