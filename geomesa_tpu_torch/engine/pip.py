"""Point-in-polygon over an edge table.

The counterpart of the reference package's `engine/pip.py`. The polygon
is decomposed on the host into an edge table (all rings concatenated:
the even-odd rule makes holes and multi-parts free), and the device test
is a crossing-number count of [N] points against [E] edges with the
half-open edge rule (kernel B4), plus the f32 boundary-ambiguity band
(kernel B5) whose rows the caller re-decides in f64 on the host.

Both device tests run in f32, as the reference's Pallas kernels do (on
the CPU the reference's dense fallback promotes to its f64 edge table,
so raw masks can differ near edges; after the f64 refine they agree:
ROADMAP Queue C). `points_in_polygon_np` is the NumPy f64 oracle with
the identical edge rule.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from geomesa_tpu_torch.core.wkt import Geometry
from geomesa_tpu_torch.engine.pip_kernels import (
    pip_band, pip_crossing, points_in_polygon_np_edges)

# f32 boundary ambiguity band, degrees. Must dominate (a) the f64->f32
# coordinate cast error (ulp(180) ~ 2.1e-5) and (b) the crossing-x
# arithmetic error, which the band test scales per edge by its slope
# (nearly-horizontal edges amplify t = (py-y1)/(y2-y1)); edges flatter
# than the band are caught by the endpoint-proximity term instead.
BAND_EPS = 1e-4


def polygon_edges(geom: Geometry) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: all ring edges of a geometry as (x1,y1,x2,y2), f64.

    Rings of polygon kinds are closed if not explicitly closed; line kinds
    keep open paths (a closing edge would fabricate a phantom segment).
    Even-odd counting over the concatenated edge table handles holes and
    multi-parts without any per-ring bookkeeping.
    """
    close = "Polygon" in geom.kind or geom.kind in ("Geometry", "GeometryCollection")
    x1s, y1s, x2s, y2s = [], [], [], []
    for ring in geom.rings:
        r = np.asarray(ring, np.float64)
        if len(r) < 2:
            continue
        if close and not np.array_equal(r[0], r[-1]):
            r = np.concatenate([r, r[:1]], axis=0)
        x1s.append(r[:-1, 0])
        y1s.append(r[:-1, 1])
        x2s.append(r[1:, 0])
        y2s.append(r[1:, 1])
    if not x1s:
        z = np.zeros(0, np.float64)
        return z, z, z, z
    return (
        np.concatenate(x1s),
        np.concatenate(y1s),
        np.concatenate(x2s),
        np.concatenate(y2s),
    )


def _f32(*tensors: torch.Tensor):
    return [t.to(torch.float32).contiguous() for t in tensors]


def points_in_polygon(px, py, x1, y1, x2, y2) -> torch.Tensor:
    """Crossing-number test: [N] points vs [E] edges -> bool [N].

    Edge rule: an edge crosses the rightward ray from p iff exactly one
    endpoint is at or below p's y (half-open: y1 <= py < y2 or
    y2 <= py < y1) and the edge's x at py is strictly right of px. Even
    crossings = outside."""
    return pip_crossing(*_f32(px, py, x1, y1, x2, y2))


def points_in_polygon_band(px, py, x1, y1, x2, y2,
                           eps: float = BAND_EPS) -> torch.Tensor:
    """Boundary-ambiguity flags: True where the f32 crossing test may
    disagree with f64. Per edge: a crossing whose x lands within the
    slope-amplified error of px, or a near-horizontal edge (both endpoint
    ys within eps of py) whose eps-inflated x-span holds the point. A
    general endpoint-y strip is not needed: vertex comparisons are
    consistent across a closed ring's incident edges in any precision, so
    parity survives rounding away from the boundary. Callers re-evaluate
    flagged rows on the host in f64 (cql.hosteval)."""
    return pip_band(*_f32(px, py, x1, y1, x2, y2), eps=eps)


def points_in_polygon_np(px, py, geom: Geometry) -> np.ndarray:
    """NumPy f64 oracle with the identical edge rule."""
    return points_in_polygon_np_edges(px, py, *polygon_edges(geom))
