"""Shared process helpers: window queries and batch-side filtering.

The counterpart of the reference package's `process/util.py`: a process
reads its candidate features either through a source's feature route
(`window_query`: a BBOX window ANDed with an optional ECQL filter) or, for
an in-memory batch, through the compiled filter over f64 coordinates
(`filter_batch`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import FeatureBatch
from geomesa_tpu_torch.core.wkt import box
from geomesa_tpu_torch.cql import ast, compile_filter, parse_cql
from geomesa_tpu_torch.cql.extract import BBox
from geomesa_tpu_torch.engine.device import fetch, to_device
from geomesa_tpu_torch.plan.query import Query


def filter_batch(batch: FeatureBatch, cql_filter: str,
                 device: torch.device) -> FeatureBatch:
    """Apply an ECQL filter to an in-memory batch on `device`: the
    compiled mask over f64 coordinates, then a host select."""
    f = parse_cql(cql_filter)
    if isinstance(f, ast.Include):
        return batch
    compiled = compile_filter(f, batch.sft)
    dev = to_device(batch, device, coord_dtype=torch.float64)
    (mask,) = fetch(compiled.mask(dev, batch))
    return batch.select(mask)


def window_filter(sft, bbox: BBox, cql_filter: str = "INCLUDE") -> ast.Filter:
    """BBOX window ANDed with an optional ECQL filter, as an AST."""
    g = sft.default_geometry
    window = ast.SpatialPredicate(
        "BBOX", ast.Property(g.name),
        box(bbox.xmin, bbox.ymin, bbox.xmax, bbox.ymax),
    )
    base = parse_cql(cql_filter)
    return window if isinstance(base, ast.Include) else ast.And((window, base))


def window_query(source, bbox: BBox,
                 cql_filter: str = "INCLUDE") -> Optional[FeatureBatch]:
    """BBOX-window query ANDed with an optional ECQL filter, through the
    source's feature route (None when no row matched)."""
    combined = window_filter(source.sft, bbox, cql_filter)
    return source.get_features(Query(source.sft.name, combined)).features


def candidates_for(data, bbox: BBox, cql_filter: str = "INCLUDE",
                   device: Optional[torch.device] = None
                   ) -> Optional[FeatureBatch]:
    """Uniform candidate retrieval: the window query for a FeatureSource,
    the filtered batch (on `device`) for a FeatureBatch. The filter
    applies on both paths; the window does not constrain a batch (the
    process's test is exact regardless)."""
    if isinstance(data, FeatureBatch):
        return filter_batch(data, cql_filter, device)
    return window_query(data, bbox, cql_filter)
