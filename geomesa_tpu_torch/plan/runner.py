"""Aggregation push-down shared by the planner's cached and scan routes.

The counterpart of the reference package's `plan/runner.py`, restricted
to the density aggregation over point layers: the device grid from a
batch, its device arrays and a row mask (`density_device_grid`), the
cell-dictionary route with its cross-query calibration cache
(`_zsparse_grid`), and the token that keys that cache on the query's
mask (`query_mask_token`). Feature results, stats, bin and arrow
aggregations come with their slices.
"""

from __future__ import annotations

import threading
import weakref
from typing import TYPE_CHECKING, Optional

import torch

from geomesa_tpu_torch.core.sft import SimpleFeatureType
from geomesa_tpu_torch.cql import ast
from geomesa_tpu_torch.engine.density import density_grid_auto
from geomesa_tpu_torch.engine.density_zsparse import density_zsparse
from geomesa_tpu_torch.errors import NotPortedError

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
                        cache: CalibCache, mask_token=None) -> torch.Tensor:
    """Device density grid for one batch (weight column or ones), shared
    by the planner's cached and scan routes so weighting semantics cannot
    diverge between them. Point layers only; the mesh and non-point
    routes come with their slices."""
    g = sft.default_geometry
    if not batch.columns[g.name].is_point:
        raise NotPortedError("density over non-point geometries",
                             "the extended-geometry slice (engine/raster.py)")
    x = dev[f"{g.name}__x"]
    y = dev[f"{g.name}__y"]
    w = (dev[hints.density_weight].to(torch.float32) if hints.density_weight
         else torch.ones_like(x, dtype=torch.float32))
    bbox = tuple(hints.density_bbox)
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


def query_mask_token(query: "Query") -> tuple:
    """Everything that shapes the result mask for FIXED resident arrays:
    the type and the canonical filter text (the port has no auths,
    sampling or loose-bbox hints). Keys mask-dependent plan caches such as
    the zsparse calibration: equal tokens over the same arrays give
    identical masks."""
    return (query.type_name, ast.to_cql(query.filter_ast))
