"""Parametric geofence lanes: one class of geofences batched over [S] rows.

The counterpart of the reference package's `engine/lanes.py`, which is
plain JAX (it inlines the dense crossing formula instead of calling the
Pallas kernel), so it becomes plain PyTorch here. One lane evaluates
every same-class geofence as one [S, N] broadcast over an [S]-row
parameter table: registering or cancelling a geofence is a row write
(subscribe/lanes.py), never a new program.

Bit-identity contract: each lane row equals the port's compiled filter
mask for the same predicate on the same delta (`cql/compile.py`), with
the same f32 operations in the same order and the same scalar handling:

- ``lane_bbox``: `_bbox` and its ulp band. The compiled filter compares
  the f32 column with Python floats, which PyTorch rounds to f32; the
  table holds those f32 values.
- ``lane_dwithin``: the single-point DWITHIN, `haversine_m(x, y, px, py)
  <= d` with Python floats for the centre. A Python float is a weak
  scalar there: its radians and cosine are taken in f64 on the host and
  rounded to f32 where they meet the column. The table row is those
  rounded values (subscribe/lanes.py `classify` computes them with the
  same `math` calls), so the lane never takes the centre's radians or
  cosine in f32. No band, as the compiled DWITHIN has none.
- ``lane_polygon``: B4's crossing parity and B5's band
  (`engine/pip_kernels.py` `_crossing_x`, `crossing_and_band`) with an
  extra [S] axis. Each operation is its own eager op, so nothing is
  contracted into a fused multiply-add, as B4's `_rn` intrinsics keep it
  on the card. Pad edges are degenerate points at a far coordinate: no
  crossing condition and no band term fires for them, so padding
  changes neither the integer crossing sum nor the band.

Every lane ANDs its rows with the `active` column and the delta's
validity column (the compiled filter's top-level `& dev[VALID]`).
`lane_polygon` works in blocks of geofences and points so that each
[s, n, E] temporary stays under `LANE_BUDGET_BYTES`; the per-element
arithmetic does not depend on the blocks.
"""

from __future__ import annotations

import torch

from geomesa_tpu_torch.engine.geodesy import EARTH_RADIUS_M
from geomesa_tpu_torch.engine.pip import BAND_EPS

__all__ = ["lane_bbox", "lane_dwithin", "lane_polygon", "LANE_BUDGET_BYTES"]

# bytes of one f32 [s, n, E] temporary of lane_polygon
LANE_BUDGET_BYTES = 1 << 28


def _live(active: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return active[:, None] & valid[None, :]


def lane_bbox(prm, active, x, y, valid):
    """BBOX lane: [S, 8] f32 rows (x0, x1, y0, y1, ex0, ex1, ey0, ey1) vs
    [N] points -> (mask, band) bool [S, N]."""
    X = x[None, :]
    Y = y[None, :]
    x0, x1 = prm[:, 0:1], prm[:, 1:2]
    y0, y1 = prm[:, 2:3], prm[:, 3:4]
    mask = (X >= x0) & (X <= x1) & (Y >= y0) & (Y <= y1)
    band = ((torch.abs(X - x0) <= prm[:, 4:5]) | (torch.abs(X - x1) <= prm[:, 5:6])
            | (torch.abs(Y - y0) <= prm[:, 6:7]) | (torch.abs(Y - y1) <= prm[:, 7:8]))
    live = _live(active, valid)
    return mask & live, band & live


def lane_dwithin(prm, active, x, y, valid):
    """DWITHIN lane: [S, 4] f32 rows (centre lon and lat in radians, the
    cosine of that latitude, meters) vs [N] points -> (mask, all-False
    band) [S, N]: `engine.geodesy.haversine_m` term for term."""
    rlon1 = torch.deg2rad(x)[None, :]
    rlat1 = torch.deg2rad(y)[None, :]
    dlat = prm[:, 1:2] - rlat1
    dlon = prm[:, 0:1] - rlon1
    a = (torch.sin(dlat / 2) ** 2
         + torch.cos(rlat1) * prm[:, 2:3] * torch.sin(dlon / 2) ** 2)
    h = 2.0 * EARTH_RADIUS_M * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    mask = (h <= prm[:, 3:4]) & _live(active, valid)
    return mask, torch.zeros_like(mask)


def _polygon_block(edges, px, py, e32):
    """(mask, band) [s, n] of one block: edges [s, 4, E], px/py [n]."""
    px = px[None, :, None]
    py = py[None, :, None]
    x1 = edges[:, 0][:, None, :]
    y1 = edges[:, 1][:, None, :]
    x2 = edges[:, 2][:, None, :]
    y2 = edges[:, 3][:, None, :]
    cond = (y1 <= py) != (y2 <= py)
    den = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
    t = (py - y1) / den
    xc = x1 + t * (x2 - x1)
    crossings = (cond & (xc > px)).sum(dim=2)
    near_flat = ((torch.abs(py - y1) <= e32) & (torch.abs(py - y2) <= e32)
                 & (px >= torch.minimum(x1, x2) - e32)
                 & (px <= torch.maximum(x1, x2) + e32))
    err = e32 * (1.0 + torch.abs(x2 - x1) / torch.maximum(torch.abs(y2 - y1), e32))
    band = (near_flat | (cond & (torch.abs(xc - px) <= err))).any(dim=2)
    return (crossings % 2) == 1, band


def lane_polygon(edges, active, x, y, valid):
    """Polygon lane: [S, 4, E] f32 edge tables (x1, y1, x2, y2) vs [N]
    points -> (mask, band) bool [S, N], in blocks whose [s, n, E] f32
    temporaries stay under `LANE_BUDGET_BYTES`."""
    s_all, _, e = edges.shape
    n_all = x.shape[0]
    mask = torch.zeros((s_all, n_all), dtype=torch.bool, device=x.device)
    band = torch.zeros_like(mask)
    if s_all and n_all and e:
        e32 = torch.tensor(BAND_EPS, dtype=torch.float32, device=x.device)
        per_row = max(1, LANE_BUDGET_BYTES // (4 * e))  # [n, E] elements a geofence
        n_step = min(n_all, per_row)
        s_step = max(1, min(s_all, per_row // n_step))
        for s0 in range(0, s_all, s_step):
            for n0 in range(0, n_all, n_step):
                m, b = _polygon_block(edges[s0:s0 + s_step], x[n0:n0 + n_step],
                                      y[n0:n0 + n_step], e32)
                mask[s0:s0 + s_step, n0:n0 + n_step] = m
                band[s0:s0 + s_step, n0:n0 + n_step] = b
    live = _live(active, valid)
    return mask & live, band & live
