"""Tube select: the spatio-temporal corridor join of TubeSelectProcess.

The counterpart of the reference package's `engine/tube.py`. The tube is
a compact array of (lon, lat, time) samples with a radius and a half time
window; a data point matches when it lies within the radius AND the time
window of ANY sample. Gap filling lives on the host in process/tube.py.

The reference has no Pallas kernel here (`jax.jit` over `lax.scan`), so
both passes are plain PyTorch:

  tube_select         every point against every sample, in chunks of
                      `data_tile` points x `tube_tile` samples
  tube_select_pruned  only the data tiles whose envelope reaches a
                      corridor segment's box (bbox + margins + time
                      window): `tube_tile_hits` picks them, the test runs
                      over the gathered tiles, and more tiles than the
                      capacity fall back to the dense pass

`tube_select_sharded` and `tube_select_pruned_sharded` run them shard by
shard over data sharded on a mesh (the tube replicated, the hits sharded
like the data).

The pairwise test is the reference's chord-squared DIFFERENCE form: d <= r
on the sphere iff |u_point - u_sample|^2 <= (2 sin(r / 2R))^2, with unit
vectors and thresholds computed once per point and sample in the input
dtype (f32 on the engine path, f64 on the process path). The dot-product
form would round cos(r/R) to 1.0f below r ~ 2.2 km and drop true matches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from geomesa_tpu_torch.engine.geodesy import EARTH_RADIUS_M

# tube samples per pruning segment: a long track's segment boxes must stay
# local or the prune is vacuous (the reference's constant: it decides
# which tiles are scanned)
SEG = 16

# the dense pass's chunk, points x samples per step, and the pruning
# tile: sizes timed on the card (PERF.md, section 6). Smaller chunks
# leave the card idle behind ~14 PyTorch calls a chunk; the pruning tile
# trades tighter envelopes against more tiles
DATA_CHUNK = 65536
TUBE_CHUNK = 2048
PRUNE_TILE = 1024

_BIG = 3.0e8  # pad coordinate: tile envelopes exclude pad rows
_INF64 = 1 << 60


def _on(v, device, dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """`v` (tensor, array or scalar) as a tensor on `device`, converted to
    `dtype` from its own precision (a Python float is an f64), or kept
    in its own dtype when None."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.to(device=device, dtype=dtype)


def _unit3(lon: torch.Tensor, lat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    rlon = torch.deg2rad(lon)
    rlat = torch.deg2rad(lat)
    cl = torch.cos(rlat)
    return cl * torch.cos(rlon), cl * torch.sin(rlon), torch.sin(rlat)


def tube_select(x, y, t, mask, tube_x, tube_y, tube_t, radius_m,
                half_window_ms, tube_tile: int = TUBE_CHUNK,
                data_tile: int = DATA_CHUNK) -> torch.Tensor:
    """bool [N]: a point matches if within the radius AND the time window
    of ANY tube sample. Tube arrays are [T]; the radius and the window
    may be scalars or [T]. The [data_tile, tube_tile] block is the only
    pairwise intermediate, so memory stays O(N + T)."""
    n = x.shape[0]
    T = tube_x.shape[0]
    dev = x.device
    if T == 0 or n == 0:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    fdt = x.dtype
    radius = _on(radius_m, dev, fdt).broadcast_to((T,))
    window = _on(half_window_ms, dev, torch.int64).broadcast_to((T,))
    # unit vectors in the tube's own dtype (the differences promote)
    tux, tuy, tuz = _unit3(_on(tube_x, dev), _on(tube_y, dev))
    tt = _on(tube_t, dev, torch.int64)
    half = torch.sin(radius / (2.0 * EARTH_RADIUS_M))
    # a negative radius never matches (chord^2 >= 0 > -1), as the
    # reference's pad samples
    thresh = torch.where(radius < 0, torch.full_like(radius, -1.0),
                         4.0 * half * half)
    # |t - tt| <= w as a range: no [data, tube] int64 difference
    lo, hi = tt - window, tt + window
    ux, uy, uz = _unit3(x, y)
    t = _on(t, dev, torch.int64)
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    for s in range(0, T, tube_tile):
        su = (tux[s:s + tube_tile], tuy[s:s + tube_tile], tuz[s:s + tube_tile])
        sth, slo, shi = (thresh[s:s + tube_tile], lo[s:s + tube_tile],
                         hi[s:s + tube_tile])
        for d in range(0, n, data_tile):
            e = min(d + data_tile, n)
            dx = ux[d:e, None] - su[0]
            c = dx * dx
            dx = uy[d:e, None] - su[1]
            c += dx * dx
            dx = uz[d:e, None] - su[2]
            c += dx * dx
            td = t[d:e, None]
            hit = (c <= sth) & (td >= slo) & (td <= shi)
            out[d:e] |= hit.any(1)
    return out & _on(mask, dev, torch.bool)


def tube_tile_hits(x, y, t, tube_x, tube_y, tube_t, half_window_ms,
                   margin_lon: float, margin_lat: float,
                   data_tile: int) -> torch.Tensor:
    """bool [ceil(N / data_tile)]: the data tiles whose envelope (over
    all rows: the filter mask still applies in the test) intersects some
    segment box of SEG samples, expanded by the degree margins (and
    shifted by +-360 degrees, for corridors that cross the antimeridian)
    and by the time window. Conservative, so a pruned tile cannot
    match."""
    n = x.shape[0]
    pad = (-n) % data_tile
    xp = torch.nn.functional.pad(x, (0, pad), value=_BIG)
    yp = torch.nn.functional.pad(y, (0, pad), value=_BIG)
    tp = torch.nn.functional.pad(t, (0, pad))
    nt = xp.shape[0] // data_tile
    xt, yt, tt_ = (a.view(nt, data_tile) for a in (xp, yp, tp))
    neg = torch.full_like(xt, -_BIG)
    txmin, txmax = xt.amin(1), torch.where(xt >= _BIG, neg, xt).amax(1)
    tymin, tymax = yt.amin(1), torch.where(yt >= _BIG, neg, yt).amax(1)
    ttmin, ttmax = tt_.amin(1), tt_.amax(1)

    T = tube_x.shape[0]
    spad = (-T) % SEG
    sx = torch.nn.functional.pad(tube_x, (0, spad), value=_BIG)
    sy = torch.nn.functional.pad(tube_y, (0, spad), value=_BIG)
    st = torch.nn.functional.pad(tube_t, (0, spad))
    sw = torch.nn.functional.pad(
        _on(half_window_ms, x.device, torch.int64).broadcast_to((T,)),
        (0, spad), value=-1)
    K = sx.shape[0] // SEG
    sxs, sys_, sts, sws = (a.view(K, SEG) for a in (sx, sy, st, sw))
    live = sxs < _BIG / 2
    big, nbig = torch.full_like(sxs, _BIG), torch.full_like(sxs, -_BIG)
    sxmin = torch.where(live, sxs, big).amin(1) - margin_lon
    sxmax = torch.where(live, sxs, nbig).amax(1) + margin_lon
    symin = torch.where(live, sys_, big).amin(1) - margin_lat
    symax = torch.where(live, sys_, nbig).amax(1) + margin_lat
    wmax = sws.amax(1)
    stmin = torch.where(live, sts, torch.full_like(sts, _INF64)).amin(1) - wmax
    stmax = torch.where(live, sts, torch.full_like(sts, -_INF64)).amax(1) + wmax

    a0, a1 = txmax[:, None], txmin[:, None]
    x_overlap = (
        ((a0 >= sxmin[None, :]) & (a1 <= sxmax[None, :]))
        | ((a0 >= sxmin[None, :] + 360.0) & (a1 <= sxmax[None, :] + 360.0))
        | ((a0 >= sxmin[None, :] - 360.0) & (a1 <= sxmax[None, :] - 360.0))
    )
    return (
        x_overlap
        & (tymax[:, None] >= symin[None, :]) & (tymin[:, None] <= symax[None, :])
        & (ttmax[:, None] >= stmin[None, :]) & (ttmin[:, None] <= stmax[None, :])
    ).any(1)


def _tube_pruned_call(x, y, t, mask, tube_x, tube_y, tube_t, radius_m,
                      half_window_ms, margin_lon: float, margin_lat: float,
                      data_tile: int, tile_capacity: int):
    """(hits bool [N] or None, overflow): the test over the tiles
    `tube_tile_hits` selects when they are at most `tile_capacity`, else
    (None, True) and the caller falls back to the dense pass. The tile
    list is read once (one host sync), so only selected tiles are
    gathered and tested; the reference's fixed-capacity slots (lowest
    tile ids first, dead slots masked) select the same tiles."""
    n = x.shape[0]
    hit = tube_tile_hits(x, y, t, tube_x, tube_y, tube_t, half_window_ms,
                         margin_lon, margin_lat, data_tile)
    nt = hit.shape[0]
    ids = torch.nonzero(hit).flatten()
    if ids.shape[0] > min(tile_capacity, nt):
        return None, True
    pad = nt * data_tile - n
    valid = _on(mask, x.device, torch.bool)

    def tiles(a, value=0):
        return torch.nn.functional.pad(a, (0, pad), value=value).view(
            nt, data_tile)[ids].reshape(-1)

    hits_sel = tube_select(tiles(x, _BIG), tiles(y, _BIG), tiles(t),
                           tiles(valid, False), tube_x, tube_y, tube_t,
                           radius_m, half_window_ms)
    out = torch.zeros((nt, data_tile), dtype=torch.bool, device=x.device)
    out[ids] = hits_sel.view(-1, data_tile)
    return out.reshape(-1)[:n] & valid, False


def tube_margins(tube_y, radius_m) -> Tuple[float, float]:
    """Conservative degree margins covering a `radius_m` geodesic reach:
    1 deg latitude >= 110574 m everywhere; longitude degrees shrink by
    cos(lat), evaluated at the highest latitude the corridor can reach. A
    corridor whose reach includes a pole spans every longitude."""
    rmax = float(np.max(_host(radius_m)))
    margin_lat = rmax / 110574.0 * 1.01
    lat_max = float(np.max(np.abs(_host(tube_y))))
    pole_dist_m = max(90.0 - lat_max, 0.0) * 110574.0
    if rmax * 1.01 >= pole_dist_m:
        return 360.0, float(margin_lat)
    lat_reach = lat_max + margin_lat  # provably < 90 here
    margin_lon = min(
        360.0,
        rmax / (111320.0 * np.cos(np.radians(lat_reach))) * 1.01,
    )
    return float(margin_lon), float(margin_lat)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def default_capacity(n: int, data_tile: int) -> int:
    """The calibration's first capacity: a quarter of the tiles, at least
    64 (the reference's rule)."""
    return max(64, -(-n // data_tile) // 4)


def tube_select_pruned(x, y, t, mask, tube_x, tube_y, tube_t, radius_m,
                       half_window_ms, data_tile: int = PRUNE_TILE,
                       tile_capacity: "int | None" = None):
    """`tube_select` over only the data tiles within the corridor's
    per-segment reach. Exact for any input order; fast when rows arrive in
    store (Z) order, where tile envelopes are tight.

    Returns (bool [N] hits, capacity used). tile_capacity=None calibrates
    at a quarter of the tiles (at least 64), then all tiles; on overflow
    the dense pass runs instead and the capacity used is -1 (callers drop
    their cached value). Each pruned call reads its tile count once. The
    radius passes through f32, as in the reference, before the test
    converts it to the coordinates' dtype."""
    margin_lon, margin_lat = tube_margins(tube_y, radius_m)
    T = tube_x.shape[0]
    dev = x.device
    t = _on(t, dev, torch.int64)
    tube_x, tube_y = _on(tube_x, dev), _on(tube_y, dev)
    tube_t = _on(tube_t, dev, torch.int64)
    radius_b = _on(radius_m, dev, torch.float32).broadcast_to((T,))
    window_b = _on(half_window_ms, dev, torch.int64).broadcast_to((T,))
    n = x.shape[0]
    args = (x, y, t, mask, tube_x, tube_y, tube_t, radius_b, window_b,
            margin_lon, margin_lat)
    if tile_capacity is None:
        cap = default_capacity(n, data_tile)
        hits, ov = _tube_pruned_call(*args, data_tile=data_tile,
                                     tile_capacity=cap)
        if not ov:
            return hits, cap
        tile_capacity = -(-n // data_tile)  # all tiles
    hits, ov = _tube_pruned_call(*args, data_tile=data_tile,
                                 tile_capacity=tile_capacity)
    if ov:
        return (tube_select(x, y, t, mask, tube_x, tube_y, tube_t,
                            radius_b, window_b), -1)
    return hits, tile_capacity


def _tube_shards(mesh, x, y, t, mask, tube_x, tube_y, tube_t):
    """Per shard: its rows of the data and its copy of the tube (None for
    another process's shard)."""
    from geomesa_tpu_torch.parallel.mesh import shards_of

    data = [shards_of(mesh, a) for a in (x, y, t, mask)]
    tube = [tuple(_on(a, d) for a in (tube_x, tube_y, tube_t))
            if o == mesh.rank else None
            for d, o in zip(mesh.device_list, mesh.owners)]
    return data, tube


def tube_select_sharded(mesh, x, y, t, mask, tube_x, tube_y, tube_t,
                        radius_m, half_window_ms,
                        tube_tile: int = TUBE_CHUNK):
    """`tube_select` with the data sharded over `mesh` and the tube (small)
    replicated: every shard tests its own rows under its device; the hits
    stay sharded like the data (`Sharded`; no merge). The radius passes
    through f32, as the reference broadcasts it. Data arrays are
    `Sharded` or whole tensors of a length that divides by the mesh
    size."""
    from geomesa_tpu_torch.parallel.mesh import Sharded, my_shards, on_shard

    (xs, ys, ts, ms), tube = _tube_shards(mesh, x, y, t, mask, tube_x,
                                          tube_y, tube_t)
    T = int(tube[mesh.local[0]][0].shape[0])
    out = []
    for i, d in my_shards(mesh):
        with on_shard(d):
            radius = _on(radius_m, d, torch.float32).broadcast_to((T,))
            window = _on(half_window_ms, d, torch.int64).broadcast_to((T,))
            out.append(tube_select(xs[i], ys[i], ts[i], ms[i], *tube[i],
                                   radius, window, tube_tile=tube_tile))
    return Sharded.from_local(mesh, out)


def tube_select_pruned_sharded(mesh, x, y, t, mask, tube_x, tube_y, tube_t,
                               radius_m, half_window_ms,
                               data_tile: int = 8192,
                               tile_capacity: int = 64):
    """The tile-pruned tube select with the data sharded over `mesh` (the
    tube replicated, the hits sharded like the data): each shard prunes
    and tests its own tiles at `tile_capacity`. Returns (hits `Sharded`,
    overflow: True if ANY shard had more reachable tiles than the
    capacity; the caller MUST then fall back to `tube_select_sharded`,
    and an overflowed shard's hits are all False). On a mesh that spans
    processes the flag is their MAX, so every process falls back."""
    from geomesa_tpu_torch.parallel.mesh import Sharded, my_shards, on_shard, pmax

    margin_lon, margin_lat = tube_margins(tube_y, radius_m)
    (xs, ys, ts, ms), tube = _tube_shards(mesh, x, y, t, mask, tube_x,
                                          tube_y, tube_t)
    T = int(tube[mesh.local[0]][0].shape[0])
    out, overflow = [], False
    for i, d in my_shards(mesh):
        with on_shard(d):
            radius = _on(radius_m, d, torch.float32).broadcast_to((T,))
            window = _on(half_window_ms, d, torch.int64).broadcast_to((T,))
            hits, ov = _tube_pruned_call(
                xs[i], ys[i], _on(ts[i], d, torch.int64), ms[i], *tube[i],
                radius, window, margin_lon, margin_lat, data_tile=data_tile,
                tile_capacity=tile_capacity)
            if ov:
                hits = torch.zeros(xs[i].shape[0], dtype=torch.bool, device=d)
            overflow = overflow or ov
            out.append(hits)
    return Sharded.from_local(mesh, out), bool(pmax(mesh, int(bool(overflow))))
