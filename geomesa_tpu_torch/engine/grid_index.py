"""Device-side grid index: one sort to build, per-query candidate pruning
for kNN with an exactness certificate.

The counterpart of the reference package's `engine/grid_index.py`, in
plain PyTorch (`knn_indexed_sharded` runs it shard by shard on a mesh):

  build:  cell(p) = (floor((lon+180)/360*G), floor((lat+90)/180*G)) on a
          G x G lon/lat grid; a stable sort of where(mask, cell, G*G)
          (masked rows sink to the tail) carries x, y and the row id;
          per-cell [start, end) offsets by searchsorted.
  query:  each query gathers the (2R+1)^2 cells around its own, S slots
          a cell, takes exact haversine over them and the top k.
  proof:  every point outside the searched square is at least the
          square's nearer edge away (a meridian arc in latitude, the
          distance to the meridian great circle in longitude); the result
          is certified iff the k-th distance (plus a 1 m / 1e-6 guard) is
          within that, no gathered cell overflowed its S slots, k
          candidates were found and no longitude edge was clipped.

`knn_indexed` re-runs the uncertain queries on the exact `knn`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.engine.device import fetch
from geomesa_tpu_torch.engine.geodesy import EARTH_RADIUS_M, haversine_m
from geomesa_tpu_torch.engine.knn import (_div_mul, _nan_back, _nan_first,
                                          _topk_smallest, knn)


def auto_grid_params(match_count: int,
                     per_cell_target: int = 16) -> Tuple[int, int]:
    """(g, cell_slots) sized to the matched-point count: the grid edge
    puts ~per_cell_target matches in a cell on the global mean (a power of
    two in [64, 2048]), with 16x that in slots to absorb the skew of
    geographic data. The reference's rule, unchanged: correctness never
    depends on it (an overflowing cell only flags its queries)."""
    g = 1 << max(
        6, min(11, int(math.sqrt(max(match_count, 1) / per_cell_target)
                       ).bit_length())
    )
    return g, 16 * per_cell_target


class GridIndex(NamedTuple):
    """Batch-resident spatial index (tensors on one device)."""

    sx: torch.Tensor      # [N] lon, sorted by cell
    sy: torch.Tensor      # [N] lat, sorted by cell
    sidx: torch.Tensor    # [N] original row of each sorted point (int32)
    starts: torch.Tensor  # [G*G + 1] cell -> first sorted row (int32)
    counts: torch.Tensor  # [G*G] matched points per cell (int32)
    g: int                # grid edge


def _cells(x: torch.Tensor, y: torch.Tensor, g: int):
    cx = torch.clamp(torch.floor(_div_mul(x + 180.0, 360.0, g)).to(torch.int32),
                     0, g - 1)
    cy = torch.clamp(torch.floor(_div_mul(y + 90.0, 180.0, g)).to(torch.int32),
                     0, g - 1)
    return cx, cy


def build_grid_index(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                     g: int = 128) -> GridIndex:
    """Sort the batch by grid cell, masked rows last: one stable sort,
    then gathers. Reusable across every query against this batch."""
    cx, cy = _cells(x, y, g)
    key = torch.where(mask, cy * g + cx, torch.full_like(cx, g * g))
    skey, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        skey, torch.arange(g * g + 1, dtype=torch.int32, device=x.device))
    return GridIndex(sx=x[order], sy=y[order], sidx=order.to(torch.int32),
                     starts=starts.to(torch.int32),
                     counts=torch.diff(starts).to(torch.int32), g=g)


def knn_grid(qx: torch.Tensor, qy: torch.Tensor, index: GridIndex, k: int,
             ring_radius: int = 2, cell_slots: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-or-flagged kNN from the grid index: (dists [Q, k], original
    indices [Q, k] int32, uncertain [Q] bool). An uncertain query's
    result is the best among its gathered candidates; the caller re-runs
    it on a full scan. The certificate is computed in the reference's
    dtypes and order (f32 cell edges; the query's dtype beyond)."""
    gq, r, s = index.g, ring_radius, cell_slots
    dev = qx.device
    q = qx.shape[0]
    qcx, qcy = _cells(qx, qy, gq)
    offs = torch.arange(-r, r + 1, dtype=torch.int32, device=dev)
    ox = offs.repeat(2 * r + 1)               # [ncell]
    oy = offs.repeat_interleave(2 * r + 1)    # [ncell]
    ccx = qcx[:, None] + ox
    ccy = qcy[:, None] + oy
    inside = (ccx >= 0) & (ccx < gq) & (ccy >= 0) & (ccy < gq)
    cells = torch.where(inside, ccy * gq + ccx, torch.zeros_like(ccx)).long()
    base = index.starts[cells]
    cnt = torch.where(inside, index.counts[cells], torch.zeros_like(ccx))
    overflow = (cnt > s).any(1)
    # clipped lon edges hide antimeridian neighbours; lat edges are poles
    clipped_lon = ((ccx < 0) | (ccx >= gq)).any(1)

    slot = torch.arange(s, dtype=torch.int32, device=dev)
    valid = (slot < torch.clamp(cnt, max=s)[:, :, None]).reshape(q, -1)
    lanes = torch.clamp((base[:, :, None] + slot).reshape(q, -1), 0,
                        index.sx.shape[0] - 1).long()
    d = haversine_m(qx[:, None], qy[:, None], index.sx[lanes], index.sy[lanes])
    d = d.masked_fill(~valid, float("inf"))
    # NaN first, as the reference's fused top_k(-d) ranks it (knn.py)
    kd, sel = _topk_smallest(_nan_first(d), k)
    kd = _nan_back(kd)
    ki = torch.take_along_dim(index.sidx[lanes], sel, dim=1)

    # certificate: margins to the square's outer edges, in degrees
    cw = 360.0 / gq
    ch = 180.0 / gq
    west = qx - (-180.0 + (qcx - r).to(torch.float32) * cw)
    east = (-180.0 + (qcx + r + 1).to(torch.float32) * cw) - qx
    south = qy - (-90.0 + (qcy - r).to(torch.float32) * ch)
    north = (-90.0 + (qcy + r + 1).to(torch.float32) * ch) - qy
    deg = torch.tensor(math.pi / 180.0, dtype=torch.float32, device=dev)
    lat_bound = torch.minimum(south, north) * deg * EARTH_RADIUS_M
    dlon = torch.clamp(torch.minimum(west, east), 0.0, 90.0) * deg
    lon_bound = EARTH_RADIUS_M * torch.asin(torch.sin(dlon) * torch.cos(qy * deg))
    d_out = torch.minimum(lat_bound, lon_bound)
    kth = kd[:, k - 1]
    short = ~torch.isfinite(kth)  # fewer than k candidates gathered
    # f32 safety margin: a rounding-level false "certified" would break
    # exactness silently, so demand a 1 m + 1e-6-relative gap
    guard = kth + torch.clamp(1e-6 * kth, min=1.0)
    uncertain = (guard > d_out) | overflow | clipped_lon | short
    return kd, ki, uncertain


def knn_indexed(qx, qy, dx, dy, mask, k: int, g: int = 128,
                ring_radius: int = 2, cell_slots: int = 256,
                index: Optional[GridIndex] = None):
    """Grid-index kNN with an exact fallback: the queries the certificate
    cannot prove are re-run on `knn` over the whole batch (one bool-vector
    read decides whether any is needed). Pass a prebuilt `index` to reuse
    it across query rounds. Returns (dists [Q, k], indices [Q, k])."""
    if index is None:
        index = build_grid_index(dx, dy, mask, g=g)
    kd, ki, uncertain = knn_grid(qx, qy, index, k=k, ring_radius=ring_radius,
                                 cell_slots=cell_slots)
    (flags,) = fetch(uncertain)
    if not flags.any():
        return kd, ki
    rows = torch.from_numpy(np.nonzero(flags)[0]).to(qx.device)
    fd, fi = knn(qx[rows], qy[rows], dx, dy, mask, k=k,
                 query_tile=max(1, min(1024, len(rows))))
    kd = kd.clone()
    ki = ki.clone()
    kd[rows] = fd
    ki[rows] = fi
    return kd, ki


def knn_indexed_sharded(mesh, qx, qy, dx, dy, mask, k: int, g: int = 128,
                        ring_radius: int = 2, cell_slots: int = 256):
    """Grid-index kNN with the data sharded over `mesh`: each shard builds
    the grid index of ITS rows and runs the certified search for the
    queries (copied to its device), local indices lift to global
    (`local + shard * shard_rows`), and the shards' top-ks merge on the
    lead device in the reference's pool order (`parallel.mesh.
    merge_topk`). A query is uncertain if ANY shard's certificate failed
    for it; callers re-run those on an exact sharded scan
    (`knn.knn_sharded`). `dx`/`dy`/`mask` are `Sharded` or whole tensors
    of a length that divides by the mesh size. Returns (dists [Q, k],
    global indices [Q, k], uncertain [Q]) on the lead device."""
    from geomesa_tpu_torch.parallel.mesh import (
        exchange, my_shards, merge_topk, on_shard, replicated, shards_of)

    xs, ys, ms = (shards_of(mesh, a) for a in (dx, dy, mask))
    qxs, qys = replicated(mesh, qx), replicated(mesh, qy)
    shard_n = int(xs[mesh.local[0]].shape[0])
    fds, gis, uns = [], [], []
    for i, d in my_shards(mesh):
        with on_shard(d):
            index = build_grid_index(xs[i], ys[i], ms[i], g=g)
            kd, ki, unc = knn_grid(qxs[i], qys[i], index, k=k,
                                   ring_radius=ring_radius,
                                   cell_slots=cell_slots)
            fds.append(kd)
            gis.append(ki.to(torch.int64) + i * shard_n)
            uns.append(unc)
    md, mi = merge_topk(mesh, fds, gis, k)
    uncertain = torch.stack(exchange(mesh, uns)).any(dim=0)
    return md, mi, uncertain
