"""Density (heatmap) grids.

The counterpart of the reference package's `engine/density.py`
(DensityScan / DensityProcess parity): rasterize matching points into a
width x height f32 weight grid over a query envelope. Points outside the
envelope or the mask never contribute (a NaN coordinate bins to index 0,
as the reference's binning makes it: `bin_cells`); the kernel-radius
spread of DensityProcess is a separable gaussian blur of the final grid.
`density_sharded` grids each shard of a mesh and adds the shards' grids.

Binning arithmetic is the reference's: in `(x - xmin) / dx` the envelope
constants meet an f32 column, so they are rounded to f32 first
(`grid_consts`) and the subtract and divide run in f32. They are handed
over as device tensors, never as Python scalars: PyTorch's CUDA division
by a host scalar multiplies by its reciprocal, which rounds differently.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

BBox = Tuple[float, float, float, float]


def grid_consts(bbox: BBox, width: int, height: int):
    """(xmin, dx, ymin, dy) as the f32 values the binning divides by."""
    xmin, ymin, xmax, ymax = bbox
    return (np.float32(xmin), np.float32((xmax - xmin) / width),
            np.float32(ymin), np.float32((ymax - ymin) / height))


def bin_cells(x, y, mask, bbox: BBox, width: int, height: int):
    """(raster cell id row*W+col i32, in-bounds-and-masked bool). Cells of
    rows that are out of bounds or masked out are 0: they carry no weight
    (the reference clips them instead; a zero weight lands nowhere).

    A NaN coordinate bins to index 0, as in the reference, which casts
    the floor to int32 before its bounds check (XLA converts NaN to 0):
    a row with a NaN x lands in column 0, one with a NaN y in row 0.
    Infinite and out-of-range values stay out of bounds."""
    xmin, dx, ymin, dy = (torch.tensor(v, device=x.device)
                          for v in grid_consts(bbox, width, height))
    return _bin(x, y, mask, xmin, dx, ymin, dy, width, height)


def _bin(x, y, mask, xmin, dx, ymin, dy, width: int, height: int):
    """`bin_cells` over envelope constants given as 0-d device tensors."""
    colf = torch.floor((x - xmin) / dx)
    rowf = torch.floor((y - ymin) / dy)
    zero = torch.zeros((), dtype=colf.dtype, device=x.device)
    colf = torch.where(torch.isnan(colf), zero, colf)
    rowf = torch.where(torch.isnan(rowf), zero, rowf)
    inb = (colf >= 0) & (colf < width) & (rowf >= 0) & (rowf < height) & mask
    col = torch.where(inb, colf, zero).to(torch.int32)
    row = torch.where(inb, rowf, zero).to(torch.int32)
    return row * width + col, inb


def density_grid(x, y, weights, mask, bbox: BBox, width: int,
                 height: int) -> torch.Tensor:
    """Masked scatter-add of points into a [height, width] f32 grid.

    Grid cell (row, col) covers lon in [xmin + col*dx, xmin + (col+1)*dx),
    lat analogously, row 0 at ymin (south): callers flip for images. On
    the card the scatter's atomics add in no fixed order, so weighted
    cells carry f32 summation-order noise; unit-weight counts are exact.
    """
    return _scatter(*bin_cells(x, y, mask, bbox, width, height), weights,
                    width, height)


def _scatter(cell, inb, weights, width: int, height: int) -> torch.Tensor:
    w = torch.where(inb, weights.to(torch.float32),
                    torch.zeros((), dtype=torch.float32, device=cell.device))
    flat = torch.zeros(height * width, dtype=torch.float32,
                       device=cell.device)
    flat.index_add_(0, cell, w)
    return flat.reshape(height, width)


def density_grid_slotted(x, y, weights, mask, bbox_slot: torch.Tensor,
                         width: int, height: int) -> torch.Tensor:
    """`density_grid` with the envelope as a DEVICE [4] f32 tensor (xmin,
    ymin, xmax, ymax), so one captured program could serve every envelope
    without a rebuild. The cell sizes are f32 divisions on the device
    here, against the static path's f64-then-f32 constants, so the two
    agree bit for bit only where the envelope's cell sizes round-trip f32
    (the tile-aligned case). No serve route calls it: the ring dispatches
    kNN windows only."""
    xmin, ymin, xmax, ymax = bbox_slot.to(torch.float32).unbind()
    w = torch.tensor(width, dtype=torch.float32, device=bbox_slot.device)
    h = torch.tensor(height, dtype=torch.float32, device=bbox_slot.device)
    cell, inb = _bin(x, y, mask, xmin, (xmax - xmin) / w, ymin,
                     (ymax - ymin) / h, width, height)
    return _scatter(cell, inb, weights, width, height)


def density_grid_auto(x, y, weights, mask, bbox: BBox, width: int,
                      height: int, exact_weights: bool = False) -> torch.Tensor:
    """The reference's backend dispatch. Its matrix-unit branch is a TPU
    formulation, so on the port this is always the f32 scatter
    (`density_grid`); `exact_weights` (the `density_exact_weights` hint)
    therefore changes nothing here."""
    return density_grid(x, y, weights, mask, bbox, width, height)


def gaussian_blur(grid: torch.Tensor, radius_pixels: int) -> torch.Tensor:
    """Separable gaussian spread (DensityProcess radiusPixels analog),
    zero-padded at the edges like `numpy.convolve(mode="same")`. cuDNN's
    TF32 is turned off so the card convolves in full f32."""
    if radius_pixels <= 0:
        return grid
    r = radius_pixels
    sigma = torch.tensor(max(r / 2.0, 0.5), dtype=torch.float32,
                         device=grid.device)
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=grid.device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    k = (k / k.sum()).reshape(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        rows = F.conv1d(grid.unsqueeze(1), k, padding=r).squeeze(1)
        cols = F.conv1d(rows.t().unsqueeze(1), k, padding=r).squeeze(1)
    return cols.t().contiguous()


# -- the mesh ---------------------------------------------------------------------


def density_sharded(mesh, x, y, weights, mask, bbox: BBox, width: int,
                    height: int) -> torch.Tensor:
    """Sharded density: each shard scatters its own rows (`density_grid`,
    under its device) and the shards' grids add on the lead device in
    shard order (`parallel.mesh.psum`). Returns the [height, width] grid.
    Counts are exact; weighted cells carry f32 summation-order noise as
    on one device. Inputs are `Sharded` or whole tensors whose length
    divides by the mesh size."""
    from geomesa_tpu_torch.parallel.mesh import my_shards, on_shard, psum, shards_of

    cols = [shards_of(mesh, a) for a in (x, y, weights, mask)]
    parts = []
    for i, dev in my_shards(mesh):
        with on_shard(dev):
            parts.append(density_grid(*(c[i] for c in cols), bbox, width,
                                      height))
    return psum(mesh, parts)
