"""Density rasterization of extended geometries (lines, polygons, points).

The counterpart of the reference package's `engine/raster.py`
(DensityScan over non-point geometries), with the reference's
formulations, each a loop over [seg_tile, k] tiles of segments that
scatter into one f32 grid on the device:

- **Lines** (`line_density`): length-proportional apportioning. A
  feature's weight is spread over cells in proportion to the planar
  length of its path inside each cell over its total planar length. Per
  segment, the cell-boundary crossings are parametric t-values forming
  two arithmetic sequences (vertical and horizontal grid lines), sorted
  in a fixed-size row, and each interval's midpoint cell receives
  weight x dt. Segments are Liang-Barsky-clipped to the envelope first.

- **Polygons** (`polygon_density`): cell-center coverage by winding
  numbers over the ORIENTED edge table (`core.columnar.EdgeTable`: shells
  CCW, holes CW). Per edge and spanned grid row, the crossing column is
  scattered once into an [H, W+1] accumulator and a reversed row cumsum
  materializes "every cell left of the crossing".

- **MultiPoint** (`density_grid_geometry`): every vertex scatters the
  feature's full weight.

The static budgets (`line_crossing_bounds`, `polygon_rowspan_bound`) are
the reference's host f64 NumPy, copied exactly: a smaller k would drop
crossings without an error. The binning constants meet f32 tensors as
f32 device scalars (the division by a host scalar on CUDA multiplies by
its reciprocal, which rounds differently). The sharded polygon density
comes with the mesh slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from geomesa_tpu_torch.engine.density import density_grid

BBox = Tuple[float, float, float, float]

# elements of one [seg_tile, k] tile, and the most segments a tile holds.
# Each tile is ~30-60 PyTorch calls, so on the card the tile count, not
# the arithmetic, sets the time: the reference's cap of 8,192 segments (a
# TPU scan's choice) made 1,776 tiles and 1.4 s of the config-2 layer's
# coverage on the H100. A tile's size changes no unit-weight cell.
_DEF_TILE_BUDGET = 1 << 24
_MAX_SEG_TILE = 1 << 21


def _seg_tile(k: int) -> int:
    t = _DEF_TILE_BUDGET // max(k, 1)
    t = 1 << (int(t).bit_length() - 1)
    return int(min(max(t, 256), _MAX_SEG_TILE))


def _clip_np(x1, y1, x2, y2, bbox):
    """Host Liang-Barsky: clipped (t0, t1, ok) per segment (f64 NumPy)."""
    xmin, ymin, xmax, ymax = bbox
    ddx, ddy = x2 - x1, y2 - y1
    t0 = np.zeros_like(x1)
    t1 = np.ones_like(x1)
    ok = np.ones(len(x1), dtype=bool)
    for p, q in ((-ddx, x1 - xmin), (ddx, xmax - x1),
                 (-ddy, y1 - ymin), (ddy, ymax - y1)):
        r = q / np.where(p == 0, 1.0, p)
        t0 = np.where(p < 0, np.maximum(t0, r), t0)
        t1 = np.where(p > 0, np.minimum(t1, r), t1)
        ok &= ~((p == 0) & (q < 0))
    ok &= t0 <= t1
    return t0, t1, ok


def line_crossing_bounds(x1, y1, x2, y2, bbox: BBox, width: int,
                         height: int) -> Tuple[int, int]:
    """Host: max vertical/horizontal grid-line crossings of any clipped
    segment, the static (kx, ky) budget of `line_density`."""
    if len(x1) == 0:
        return 1, 1
    xmin, ymin, xmax, ymax = bbox
    dx = (xmax - xmin) / width
    dy = (ymax - ymin) / height
    t0, t1, ok = _clip_np(x1, y1, x2, y2, bbox)
    ddx, ddy = x2 - x1, y2 - y1
    xa, xb = x1 + t0 * ddx, x1 + t1 * ddx
    ya, yb = y1 + t0 * ddy, y1 + t1 * ddy
    nx = (np.floor((np.maximum(xa, xb) - xmin) / dx)
          - np.floor((np.minimum(xa, xb) - xmin) / dx))
    ny = (np.floor((np.maximum(ya, yb) - ymin) / dy)
          - np.floor((np.minimum(ya, yb) - ymin) / dy))
    nx = np.where(ok, nx, 0)
    ny = np.where(ok, ny, 0)
    return int(max(nx.max(), 1)), int(max(ny.max(), 1))


def polygon_rowspan_bound(y1, y2, bbox: BBox, height: int) -> int:
    """Host: max grid rows spanned by any edge (clipped to the envelope),
    the static k budget of `polygon_density`."""
    if len(y1) == 0:
        return 1
    _, ymin, _, ymax = bbox
    dy = (ymax - ymin) / height
    ylow = np.minimum(y1, y2)
    yhigh = np.maximum(y1, y2)
    rlo = np.maximum(np.ceil((ylow - ymin) / dy - 0.5), 0.0)
    rhi = np.minimum(np.ceil((yhigh - ymin) / dy - 0.5), float(height))
    return int(max((rhi - rlo).max(), 1))


# cells past the grid where masked-out tile entries scatter their zero
# weight, spread so that they do not all contend for one address (the
# reference sends them to cell 0; on the card the atomics on one address
# took 204 ms of the config-2 layer's 216 ms coverage). They are dropped
# after the loop, so they change no cell.
_SINKS = 1 << 16


def _scatter(acc: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
             w: torch.Tensor) -> None:
    """acc[idx] += w where valid; other entries add 0 to a sink cell."""
    n = acc.shape[0] - _SINKS
    sink = n + torch.arange(idx.numel(), device=idx.device) % _SINKS
    acc.index_add_(0, torch.where(valid.reshape(-1), idx.reshape(-1).long(), sink),
                   torch.where(valid, w, torch.zeros_like(w)).reshape(-1))


def _scalars(device, *values):
    """f32 device scalars: the reference's weak Python floats meeting f32."""
    return [torch.tensor(np.float32(v), device=device) for v in values]


def _tiles(seg_tile: int, *arrays):
    """[n] arrays as [seg_tile] slices (the last one short; the reference
    pads it with masked-out rows, which scatter nothing)."""
    n = arrays[0].shape[0]
    for s in range(0, n, seg_tile):
        yield [a[s:s + seg_tile] for a in arrays]


def line_density(x1, y1, x2, y2, wseg, segmask, bbox: BBox, width: int,
                 height: int, kx: int, ky: int, seg_tile: int = 2048
                 ) -> torch.Tensor:
    """Exact length-proportional line rasterization -> [height, width] f32.

    `wseg` is the per-segment weight DENSITY factor: an interval dt inside
    one cell adds wseg * dt, so callers pass w_feature * seg_len /
    total_feature_len for the documented semantics."""
    device = x1.device
    f32 = torch.float32
    xmin, ymin, xmax, ymax = bbox
    dx_, dy_ = (xmax - xmin) / width, (ymax - ymin) / height
    xmin_t, ymin_t, xmax_t, ymax_t, dx, dy = _scalars(
        device, xmin, ymin, xmax, ymax, dx_, dy_)
    one = torch.ones((), dtype=f32, device=device)
    jx = torch.arange(kx, dtype=f32, device=device)
    jy = torch.arange(ky, dtype=f32, device=device)
    grid = torch.zeros(height * width + _SINKS, dtype=f32, device=device)
    for ax1, ay1, ax2, ay2, w, m in _tiles(
            seg_tile, *(a.to(f32) for a in (x1, y1, x2, y2, wseg)), segmask):
        ddx = ax2 - ax1
        ddy = ay2 - ay1
        # Liang-Barsky clip to the envelope
        t0 = torch.zeros_like(ax1)
        t1 = torch.ones_like(ax1)
        ok = m.clone()
        for p, q in ((-ddx, ax1 - xmin_t), (ddx, xmax_t - ax1),
                     (-ddy, ay1 - ymin_t), (ddy, ymax_t - ay1)):
            r = q / torch.where(p == 0, one, p)
            t0 = torch.where(p < 0, torch.maximum(t0, r), t0)
            t1 = torch.where(p > 0, torch.minimum(t1, r), t1)
            ok = ok & ~((p == 0) & (q < 0))
        ok = ok & (t0 <= t1)
        t1c = torch.maximum(t1, t0)

        # crossing t-values with vertical / horizontal grid lines: two
        # arithmetic sequences over the CLIPPED coordinate span, each t
        # against the ORIGINAL segment parameterization; unused slots park
        # at t1 (zero-length intervals add nothing)
        def crossings(lo, hi, orig, delta, start, step, jj):
            i_first = torch.floor((lo - start) / step) + 1.0
            cnt = torch.floor((hi - start) / step) - i_first + 1.0
            line = start + (i_first[:, None] + jj[None, :]) * step
            t = (line - orig[:, None]) / torch.where(delta == 0, one, delta)[:, None]
            return torch.where(jj[None, :] < cnt[:, None], t, t1c[:, None])

        xa = ax1 + t0 * ddx
        xb = ax1 + t1c * ddx
        ya = ay1 + t0 * ddy
        yb = ay1 + t1c * ddy
        tx = crossings(torch.minimum(xa, xb), torch.maximum(xa, xb), ax1, ddx,
                       xmin_t, dx, jx)
        ty = crossings(torch.minimum(ya, yb), torch.maximum(ya, yb), ay1, ddy,
                       ymin_t, dy, jy)
        ts = torch.cat([t0[:, None], t1c[:, None], tx, ty], dim=1)
        ts = torch.minimum(torch.maximum(ts, t0[:, None]), t1c[:, None])
        ts = torch.sort(ts, dim=1).values
        dt = ts[:, 1:] - ts[:, :-1]
        tm = (ts[:, 1:] + ts[:, :-1]) * 0.5
        xm = ax1[:, None] + tm * ddx[:, None]
        ym = ay1[:, None] + tm * ddy[:, None]
        colc = torch.floor((xm - xmin_t) / dx).to(torch.int32)
        rowc = torch.floor((ym - ymin_t) / dy).to(torch.int32)
        inb = ((colc >= 0) & (colc < width) & (rowc >= 0) & (rowc < height)
               & ok[:, None] & (dt > 0))
        _scatter(grid, rowc * width + colc, inb, w[:, None] * dt)
    return grid[:height * width].reshape(height, width)


def polygon_density(x1, y1, x2, y2, wedge, edgemask, bbox: BBox, width: int,
                    height: int, k: int, seg_tile: int = 2048) -> torch.Tensor:
    """Cell-center polygon coverage -> [height, width] f32 grid. Needs the
    oriented edge table (shells CCW, holes CW); `wedge` is the owning
    feature's weight replicated per edge."""
    return torch.clamp(_polygon_density_signed(
        x1, y1, x2, y2, wedge, edgemask, bbox, width, height, k, seg_tile),
        min=0.0)


def _polygon_density_signed(x1, y1, x2, y2, wedge, edgemask, bbox: BBox,
                            width: int, height: int, k: int,
                            seg_tile: int = 2048) -> torch.Tensor:
    """Signed (pre-clamp) winding grid: linear in the edge set."""
    device = x1.device
    f32 = torch.float32
    xmin, ymin, xmax, ymax = bbox
    xmin_t, ymin_t, dx, dy = _scalars(
        device, xmin, ymin, (xmax - xmin) / width, (ymax - ymin) / height)
    one = torch.ones((), dtype=f32, device=device)
    jj = torch.arange(k, dtype=f32, device=device)
    acc = torch.zeros(height * (width + 1) + _SINKS, dtype=f32, device=device)
    for ax1, ay1, ax2, ay2, w, m in _tiles(
            seg_tile, *(a.to(f32) for a in (x1, y1, x2, y2, wedge)), edgemask):
        ddy = ay2 - ay1
        s = torch.where(ddy > 0, one, -one)
        ylow = torch.minimum(ay1, ay2)
        yhigh = torch.maximum(ay1, ay2)
        rlo = torch.clamp(torch.ceil((ylow - ymin_t) / dy - 0.5), min=0.0)
        rhi = torch.clamp(torch.ceil((yhigh - ymin_t) / dy - 0.5), max=float(height))
        r = rlo[:, None] + jj[None, :]
        valid = ((jj[None, :] < (rhi - rlo)[:, None]) & m[:, None]
                 & (ddy != 0)[:, None])
        py = ymin_t + (r + 0.5) * dy
        t = (py - ay1[:, None]) / torch.where(ddy == 0, one, ddy)[:, None]
        xc = ax1[:, None] + t * (ax2 - ax1)[:, None]
        # cells whose center is strictly left of the crossing receive the
        # signed weight: scatter at the crossing column, prefix later
        cmax = torch.ceil((xc - xmin_t) / dx - 0.5)
        valid = valid & (cmax >= 1)
        colp = torch.clamp(cmax, max=float(width)).to(torch.int32)
        rowp = r.to(torch.int32)
        _scatter(acc, rowp * (width + 1) + colp, valid,
                 (s * w)[:, None].expand_as(t))
    a = acc[:height * (width + 1)].reshape(height, width + 1)
    rev = torch.flip(torch.cumsum(torch.flip(a, [1]), dim=1), [1])
    # a cell center within ~1e-6 relative of an edge crossing can see one
    # signed contribution flip sides (f32), leaving a +-w residue there;
    # the caller's clamp keeps the grid non-negative
    return rev[:, 1:]


def polygon_density_sharded(mesh, x1, y1, x2, y2, wedge, edgemask,
                            bbox: BBox, width: int, height: int, k: int,
                            seg_tile: int = 2048) -> torch.Tensor:
    """`polygon_density` with the oriented EDGE table sharded over `mesh`:
    each shard builds the signed winding grid of its edges under its
    device (linear in the edges, so edges of one polygon may land on
    different shards), the grids add on the lead device in shard order
    (`parallel.mesh.psum`) and the sum is clamped ONCE (the clamp is not
    linear). Edge arrays are `Sharded` or whole tensors of a length that
    divides by the mesh size. Returns the [height, width] grid."""
    from geomesa_tpu_torch.parallel.mesh import my_shards, on_shard, psum, shards_of

    cols = [shards_of(mesh, a) for a in (x1, y1, x2, y2, wedge, edgemask)]
    parts = []
    for i, d in my_shards(mesh):
        with on_shard(d):
            parts.append(_polygon_density_signed(
                *(c[i] for c in cols), bbox, width, height, k, seg_tile))
    return torch.clamp(psum(mesh, parts), min=0.0)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def density_grid_geometry(geom_col, dev: dict, name: str, weights: torch.Tensor,
                          mask: torch.Tensor, bbox: BBox, width: int,
                          height: int) -> torch.Tensor:
    """Density rasterization dispatched on the geometry kind.

    `geom_col` is the HOST GeometryColumn (the static sizing source), `dev`
    the device batch with the matching CSR/edge tensors, `weights` and
    `mask` per FEATURE on the device. The k budgets are rounded up to
    powers of two, as in the reference, and memoized on the column per
    envelope and grid (their host f64 pass over every edge took seconds
    a call at the config-2 layer's width). Mixed "Geometry" columns split
    per base kind and sum the sub-grids (`_density_mixed`)."""
    kind = geom_col.kind
    if kind in ("Geometry", "GeometryCollection"):
        return _density_mixed(geom_col, name, weights, mask, bbox, width, height)
    efeat = dev[f"{name}__efeat"].long()
    ex1, ey1 = dev[f"{name}__ex1"], dev[f"{name}__ey1"]
    ex2, ey2 = dev[f"{name}__ex2"], dev[f"{name}__ey2"]
    et = geom_col.edge_table()
    if "Point" in kind:  # MultiPoint: every vertex scatters full weight
        vfeat = dev[f"{name}__vfeat"].long()
        verts = dev[f"{name}__verts"]
        return density_grid(verts[:, 0], verts[:, 1], weights[vfeat], mask[vfeat],
                            bbox, width, height)
    key = (tuple(bbox), width, height)
    if "LineString" in kind:
        # +1 margin: the host bound is f64, the tiles count in f32, and a
        # rounding flip at a cell boundary may admit one extra crossing
        kx, ky = geom_col.memo(("line_k",) + key, lambda: tuple(
            _pow2(b + 1) for b in line_crossing_bounds(
                et.x1, et.y1, et.x2, et.y2, bbox, width, height)))
        seg_len = torch.hypot(ex2 - ex1, ey2 - ey1)
        total = torch.zeros(len(geom_col), dtype=seg_len.dtype,
                            device=seg_len.device).index_add_(0, efeat, seg_len)
        wseg = (weights[efeat] * seg_len
                / torch.where(total == 0, torch.ones_like(total), total)[efeat])
        return line_density(ex1, ey1, ex2, ey2, wseg, mask[efeat], bbox, width,
                            height, kx, ky, seg_tile=_seg_tile(kx + ky + 2))
    k = geom_col.memo(("polygon_k",) + key, lambda: _pow2(
        polygon_rowspan_bound(et.y1, et.y2, bbox, height) + 1))
    return polygon_density(ex1, ey1, ex2, ey2, weights[efeat], mask[efeat],
                           bbox, width, height, k, seg_tile=_seg_tile(k))


def _density_mixed(geom_col, name: str, weights, mask, bbox: BBox, width: int,
                   height: int) -> torch.Tensor:
    """Mixed-kind density: split the host column per base kind (codes 0-5
    -> code % 3), upload each subset's CSR/edge arrays, and sum the
    sub-grids. GeometryCollection features (code 6) have no single base
    kind and bin their representative point, as in the reference."""
    device = weights.device

    def put(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dtype)

    codes = geom_col.feature_kinds
    if codes is None:
        # no per-feature kinds: every feature bins its representative point
        return density_grid(put(geom_col.x), put(geom_col.y), weights, mask,
                            bbox, width, height)
    grid = torch.zeros((height, width), dtype=torch.float32, device=device)
    coll = np.nonzero(codes == 6)[0]
    if len(coll):
        jc = put(coll, torch.int64)
        grid = grid + density_grid(put(geom_col.x[coll]), put(geom_col.y[coll]),
                                   weights[jc], mask[jc], bbox, width, height)
    base = codes % 3
    for code, sub_kind in ((0, "MultiPoint"), (1, "MultiLineString"),
                           (2, "MultiPolygon")):
        idx = np.nonzero((base == code) & (codes != 6))[0]
        if not len(idx):
            continue
        sub = dataclasses.replace(geom_col.take(idx), kind=sub_kind,
                                  feature_kinds=None)
        et = sub.edge_table()
        sub_dev = {
            f"{name}__efeat": put(et.efeat, torch.int32),
            f"{name}__ex1": put(et.x1), f"{name}__ey1": put(et.y1),
            f"{name}__ex2": put(et.x2), f"{name}__ey2": put(et.y2),
            f"{name}__vfeat": put(et.vfeat, torch.int32),
            f"{name}__verts": put(sub.vertices),
        }
        jidx = put(idx, torch.int64)
        grid = grid + density_grid_geometry(sub, sub_dev, name, weights[jidx],
                                            mask[jidx], bbox, width, height)
    return grid
