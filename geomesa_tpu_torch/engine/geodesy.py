"""Geodetic distance: haversine on the WGS84 mean sphere, and the
equirectangular point-to-segments distance of the distance predicates.

The counterpart of the reference package's `engine/geodesy.py`:
`haversine_m` on torch tensors (f32 or f64, the inputs' dtype) and the
NumPy f64 `haversine_m_np`, the oracle distance every route reports;
`point_to_segments_m`, chunked over points so that its [chunk, S]
temporaries stay under `PAIR_BUDGET_BYTES` (a chunk's minimum is exact,
so the chunking changes no bit), and its NumPy f64 twin
`point_to_segments_m_np`, which the host evaluation uses.
`within_segments_m` is the distance predicate `point_to_segments_m <= d`
evaluated only on the rows whose latitude lies within d of the segments'
latitude span; every other row is False without its distance (see there
why that is exact).
"""

from __future__ import annotations

import math

import numpy as np
import torch

EARTH_RADIUS_M = 6_371_008.8  # IUGG mean radius
DEG_M_LAT = 111_194.9  # pi * R / 180, the equirectangular scale
# bytes of one [chunk, S] temporary of `point_to_segments_m`
PAIR_BUDGET_BYTES = 1 << 28


def _rad(a):
    return torch.deg2rad(a) if isinstance(a, torch.Tensor) else math.radians(a)


def _cos(a):
    return torch.cos(a) if isinstance(a, torch.Tensor) else math.cos(a)


def haversine_m(lon1, lat1, lon2, lat2, dtype=None) -> torch.Tensor:
    """Great-circle distance in meters; broadcasts over inputs. Computes
    in the inputs' dtype (or `dtype`), with the reference's formula. A
    Python float operand is a weak scalar, as in the reference: its own
    radians and cosine are taken in f64, then rounded to the tensors'
    dtype where they meet a tensor."""
    if dtype is not None:
        lon1, lat1, lon2, lat2 = (torch.as_tensor(a, dtype=dtype)
                                  for a in (lon1, lat1, lon2, lat2))
    rlon1, rlat1, rlon2, rlat2 = (_rad(a) for a in (lon1, lat1, lon2, lat2))
    dlat = rlat2 - rlat1
    dlon = rlon2 - rlon1
    a = (
        torch.sin(dlat / 2) ** 2
        + _cos(rlat1) * _cos(rlat2) * torch.sin(dlon / 2) ** 2
    )
    return 2.0 * EARTH_RADIUS_M * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def haversine_m_np(lon1, lat1, lon2, lat2):
    """NumPy f64 reference implementation (the oracle's distance)."""
    rlon1, rlat1, rlon2, rlat2 = (
        np.radians(np.asarray(a, np.float64)) for a in (lon1, lat1, lon2, lat2)
    )
    dlat = rlat2 - rlat1
    dlon = rlon2 - rlon1
    a = (
        np.sin(dlat / 2) ** 2
        + np.cos(rlat1) * np.cos(rlat2) * np.sin(dlon / 2) ** 2
    )
    return 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def point_to_segments_m(px: torch.Tensor, py: torch.Tensor, sx1, sy1, sx2,
                        sy2) -> torch.Tensor:
    """Approximate min distance (meters) from points to a set of segments.

    Equirectangular local projection around each point's latitude, the
    reference's formula and constants (a documented divergence from a
    geodesic calculator, sub-percent for segment spans far below the
    Earth's radius). px, py: [N]; s*: [S] tensors. The arithmetic runs in
    the promoted dtype of the points and the segments, as in the
    reference (f64 segments promote f32 points). Returns [N], the minimum
    over segments, computed over chunks of points whose [chunk, S]
    temporaries each hold at most PAIR_BUDGET_BYTES."""
    n, s = px.shape[0], sx1.shape[0]
    dt = torch.promote_types(px.dtype, sx1.dtype)
    out = torch.empty(n, dtype=dt, device=px.device)
    if n == 0:
        return out
    step = max(1, PAIR_BUDGET_BYTES
               // (max(s, 1) * torch.empty(0, dtype=dt).element_size()))
    segs = [a[None, :] for a in (sx1, sy1, sx2, sy2)]
    for i in range(0, n, step):
        sl = slice(i, min(i + step, n))
        out[sl] = _segments_min(px[sl], py[sl], *segs)
    return out


def within_segments_m(px: torch.Tensor, py: torch.Tensor, sx1, sy1, sx2, sy2,
                      d: float) -> torch.Tensor:
    """bool [N]: `point_to_segments_m(...) <= d`, the same mask, with the
    distances computed only for rows whose latitude lies within
    d / DEG_M_LAT (widened by a millionth, plus 1e-9 degrees) of the
    segments' latitude span.

    Exact: for a row south of every segment by more than that, each
    segment's projected ay and by exceed d (f64, relative rounding
    ~1e-16), the clamped t keeps cy between them, so every distance
    exceeds d; symmetrically to the north. A NaN latitude is False on
    both sides."""
    out = torch.zeros(px.shape[0], dtype=torch.bool, device=px.device)
    if sy1.shape[0] == 0 or px.shape[0] == 0:
        return out
    reach = d / DEG_M_LAT * (1 + 1e-6) + 1e-9
    lo = float(torch.minimum(sy1.min(), sy2.min())) - reach
    hi = float(torch.maximum(sy1.max(), sy2.max())) + reach
    pyd = py.to(torch.float64)
    rows = torch.nonzero((pyd >= lo) & (pyd <= hi)).flatten()
    if rows.shape[0]:
        out[rows] = point_to_segments_m(px[rows], py[rows], sx1, sy1, sx2,
                                        sy2) <= d
    return out


def _segments_min(px, py, sx1, sy1, sx2, sy2) -> torch.Tensor:
    coslat = torch.cos(torch.deg2rad(py))[:, None]
    ax = (sx1 - px[:, None]) * DEG_M_LAT * coslat
    ay = (sy1 - py[:, None]) * DEG_M_LAT
    bx = (sx2 - px[:, None]) * DEG_M_LAT * coslat
    by = (sy2 - py[:, None]) * DEG_M_LAT
    dx = bx - ax
    dy = by - ay
    seg_len2 = dx * dx + dy * dy
    t = torch.clamp(-(ax * dx + ay * dy) / torch.clamp(seg_len2, min=1e-12),
                    0.0, 1.0)
    cx = ax + t * dx
    cy = ay + t * dy
    d2 = cx * cx + cy * cy
    return torch.sqrt(torch.amin(d2, dim=1))


def point_to_segments_m_np(px, py, x1, y1, x2, y2) -> np.ndarray:
    """The NumPy f64 twin of `point_to_segments_m` (the host
    evaluation's), whole, unchunked."""
    coslat = np.cos(np.radians(py))[:, None]
    ax = (x1[None, :] - px[:, None]) * DEG_M_LAT * coslat
    ay = (y1[None, :] - py[:, None]) * DEG_M_LAT
    bx = (x2[None, :] - px[:, None]) * DEG_M_LAT * coslat
    by = (y2[None, :] - py[:, None]) * DEG_M_LAT
    dx, dy = bx - ax, by - ay
    L2 = np.maximum(dx * dx + dy * dy, 1e-12)
    t = np.clip(-(ax * dx + ay * dy) / L2, 0, 1)
    cx, cy = ax + t * dx, ay + t * dy
    return np.sqrt(np.min(cx * cx + cy * cy, axis=1))
