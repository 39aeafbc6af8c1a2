"""Cell-dictionary density: the store-order-aware heatmap kernel.

The counterpart of the reference package's `engine/density_zsparse.py`
(single device). Index scans emit rows in store order, the Z curve, so a
4096-point data tile touches only a handful of distinct density cells.
One calibration pass builds, per tile, the sorted dictionary of its
distinct in-bounds matching cells (on the device: a sort per tile, and
one [n_tiles] read to size it), and the kernel (B3) sums each tile's
mask-folded weights per dictionary slot:

  per tile:  counts[s, j] = sum of lw over points with cell == dict[s, j]
  finally:   grid[dict] += counts                        (one scatter)

Exactness: the contract of `density.density_grid` for any input order.
Counts are exact; weighted sums agree with the scatter path to f32
summation-order noise. Tiles with no matching point are pruned; tiles
with more distinct cells than `capd` go to the exact scatter fallback.
`DATA_TILE`, `MAX_CAPD`, `BIGCELL` and the capd rule are the reference's:
they decide which tiles take that fallback. All S selected tiles go to
one kernel launch (the reference chunks the tile list to fit TPU VMEM).

`density_zsparse_sharded` runs the same plan shard by shard over a
mesh: one global calibration, B3 on every shard's tiles, the shards'
grids added.

The kernel wrapper takes its plain PyTorch version only for tensors on
the CPU; on a CUDA tensor it launches the kernel (built from
`kernels/density_zsparse.cu` at first use) or raises. `launches` on the
wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.engine.density import (
    BBox, bin_cells, density_grid, grid_consts)
from geomesa_tpu_torch.engine.device import check_kernel_inputs, fetch

DATA_TILE = 4096
MAX_CAPD = 512   # beyond this many distinct cells the scatter path wins
BIGCELL = 1 << 30
_INT32_MAX = (1 << 31) - 1


class DensityCalib(NamedTuple):
    """Plan from one calibration pass (cacheable across queries, like
    the sparse kNN tile capacity). `dicts` lives on the device."""

    tile_ids: np.ndarray   # [S] tiles the dictionary kernel scans
    dicts: torch.Tensor    # [S, capd] i32: distinct cells, -1 pads at the end
    capd: int              # dictionary width (pow2)
    dense_ids: np.ndarray  # tiles with > capd distinct cells -> fallback
    n_tiles: int


def _pad(t: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return t.contiguous()
    return torch.cat([t, torch.zeros(pad, dtype=t.dtype, device=t.device)])


def _tile_sorted_cells(x, y, mask, bbox: BBox, width: int, height: int,
                       data_tile: int):
    """Per-tile sorted cell ids (BIGCELL for masked/out rows), first-
    occurrence flags, and distinct counts."""
    pad = (-x.shape[0]) % data_tile
    cells, ok = bin_cells(_pad(x.float(), pad), _pad(y.float(), pad),
                          _pad(mask, pad), bbox, width, height)
    nt = cells.shape[0] // data_tile
    big = torch.full((), BIGCELL, dtype=torch.int32, device=x.device)
    s = torch.sort(torch.where(ok, cells, big).reshape(nt, data_tile),
                   dim=1).values
    live = s < BIGCELL
    first = torch.cat([live[:, :1], (s[:, 1:] != s[:, :-1]) & live[:, 1:]], 1)
    return s, first, first.sum(dim=1, dtype=torch.int32)


def _tile_dicts(s, first, capd: int) -> torch.Tensor:
    """[nt, capd] distinct-cell dictionaries (-1 pads): re-sort with
    duplicates pushed to BIGCELL, take the first capd slots."""
    big = torch.full((), BIGCELL, dtype=s.dtype, device=s.device)
    t2 = torch.sort(torch.where(first, s, big), dim=1).values[:, :capd]
    return torch.where(t2 >= BIGCELL, torch.full_like(t2, -1), t2).contiguous()


def calibrate_density(x, y, mask, bbox: BBox, width: int, height: int,
                      data_tile: int = DATA_TILE,
                      slack: float = 2.0) -> DensityCalib:
    """One device sort pass + one [n_tiles] i32 read: per-tile distinct-
    cell dictionaries under the CURRENT mask. capd is a pow2 bucket of the
    median distinct count x slack, between 8 and MAX_CAPD."""
    s, first, distinct = _tile_sorted_cells(
        x, y, mask, bbox, width, height, data_tile)
    (dn,) = fetch(distinct)
    nt = len(dn)
    ids = np.nonzero(dn > 0)[0]
    if len(ids) == 0:
        return DensityCalib(
            np.zeros(0, np.int32),
            torch.zeros((0, 8), dtype=torch.int32, device=x.device), 8,
            np.zeros(0, np.int32), nt)
    capd = _capd(dn[ids], slack)
    fits = dn[ids] <= capd
    sel = ids[fits].astype(np.int32)
    at = torch.from_numpy(sel.astype(np.int64)).to(x.device)
    dicts = _tile_dicts(s[at], first[at], capd)
    return DensityCalib(sel, dicts, capd, ids[~fits].astype(np.int32), nt)


def _capd(distinct: np.ndarray, slack: float) -> int:
    """The dictionary width: a pow2 bucket of the median distinct count
    of the live tiles x slack, between 8 and MAX_CAPD."""
    return int(min(MAX_CAPD, max(8, 1 << int(np.ceil(np.log2(max(
        float(np.median(distinct)) * slack, 2.0)))))))


# -- kernel B3 ----------------------------------------------------------------


def zsparse_counts_plain(x, y, lw, tile_ids, dicts, bbox: BBox, width: int,
                         height: int, data_tile: int = DATA_TILE):
    """Plain PyTorch version of `zsparse_counts` (same contract): the slot
    of each point by binary search over its tile's dictionary, then one
    scatter-add of the matching weights."""
    s, capd = dicts.shape
    ids = tile_ids.long()
    tiles = lambda a: a.reshape(-1, data_tile)[ids]  # noqa: E731
    cells, ok = bin_cells(tiles(x), tiles(y), True, bbox, width, height)
    w = torch.where(ok, tiles(lw), torch.zeros((), dtype=lw.dtype,
                                               device=lw.device))
    keys = torch.where(dicts < 0, torch.full_like(dicts, _INT32_MAX),
                       dicts).contiguous()  # pads sort as +infinity
    pos = torch.searchsorted(keys, cells).clamp(max=capd - 1)
    hit = torch.gather(keys, 1, pos) == cells
    slot = pos + torch.arange(s, device=x.device)[:, None] * capd
    out = torch.zeros(s * capd, dtype=torch.float32, device=x.device)
    out.index_add_(0, slot.reshape(-1),
                   torch.where(hit, w, torch.zeros_like(w)).reshape(-1))
    return out.reshape(s, capd)


def _lib():
    from geomesa_tpu_torch.engine.kernels.build import load

    lib = load("density_zsparse")
    fn = lib.zsparse_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.zsparse_grid_blocks.argtypes = [ctypes.c_int]
        lib.zsparse_grid_blocks.restype = ctypes.c_int
    return lib


def grid_blocks(capd: int) -> int:
    """Blocks of B3's persistent grid for a dictionary of width `capd`
    (rounded up to a multiple of 4) on the current CUDA device: a launch
    over S selected tiles runs min(S, grid_blocks) blocks."""
    n = _lib().zsparse_grid_blocks(capd + (-capd) % 4)
    if n < 0:
        raise RuntimeError(f"zsparse grid query failed: CUDA error {-n}")
    return n


def zsparse_counts(x, y, lw, tile_ids, dicts, bbox: BBox, width: int,
                   height: int, data_tile: int = DATA_TILE) -> torch.Tensor:
    """Per-tile dictionary sums (B3): x, y, lw f32 [N] (N a multiple of
    data_tile; lw is the weight with the mask folded in), tile_ids i32
    [S], dicts i32 [S, capd] (sorted, -1 pads at the end, capd <= 512)
    -> f32 [S, capd]: for each selected tile and slot, the sum of lw over
    the tile's in-bounds points whose raster cell is that slot's.

    On the card, data_tile must be a multiple of 32 and x, y, lw and
    dicts must start on 16 bytes (the kernel's TMA copies); a capd that
    is not a multiple of 4 is padded with -1 slots for the launch."""
    if x.shape[0] % data_tile:
        raise ValueError(f"n={x.shape[0]} is not a multiple of "
                         f"data_tile={data_tile}")
    if x.device.type == "cpu":
        return zsparse_counts_plain(x, y, lw, tile_ids, dicts, bbox, width,
                                    height, data_tile)
    if x.device.type != "cuda":
        raise ValueError(f"zsparse_counts runs on cuda or cpu, not {x.device}")
    s, capd = dicts.shape
    if s == 0:  # nothing to launch
        return torch.zeros((0, capd), dtype=torch.float32, device=x.device)
    if capd > MAX_CAPD or tile_ids.shape != (s,):
        raise ValueError(f"dicts {tuple(dicts.shape)} and tile_ids "
                         f"{tuple(tile_ids.shape)} do not fit the kernel")
    if data_tile <= 0 or data_tile % 32:
        raise ValueError(f"data_tile={data_tile}: the kernel takes a "
                         f"positive multiple of 32")
    f32, i32 = torch.float32, torch.int32
    check_kernel_inputs(x, y, lw, tile_ids, dicts,
                        dtypes=(f32, f32, f32, i32, i32))
    if capd % 4:
        dicts = torch.cat([dicts, torch.full((s, (-capd) % 4), -1, dtype=i32,
                                             device=x.device)], 1)
    for name, t in (("x", x), ("y", y), ("lw", lw), ("dicts", dicts)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on 16 bytes, as the "
                             f"kernel's TMA copies need")
    out = torch.empty(dicts.shape, dtype=f32, device=x.device)
    xmin, dx, ymin, dy = (float(v) for v in grid_consts(bbox, width, height))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().zsparse_launch(
            x.data_ptr(), y.data_ptr(), lw.data_ptr(), tile_ids.data_ptr(),
            dicts.data_ptr(), out.data_ptr(), s, dicts.shape[1], data_tile,
            xmin, dx, ymin, dy, width, height, stream)
    if err != 0:
        raise RuntimeError(f"zsparse kernel launch failed: CUDA error {err}")
    zsparse_counts.launches += 1
    return out[:, :capd].contiguous()


zsparse_counts.launches = 0


# -- driver ---------------------------------------------------------------------


def _fold_index(dicts, width: int, height: int):
    """(flat grid index of each dictionary slot, grid size): a slot's
    cell, or for a -1 pad in slot j the sink width*height + j, so that no
    sink takes more than one add per row (one sink for every pad would
    serialise its atomic adds)."""
    cells = width * height
    sinks = cells + torch.arange(dicts.shape[1], dtype=dicts.dtype,
                                 device=dicts.device)
    return torch.where(dicts < 0, sinks, dicts), cells + dicts.shape[1]


def _fold_counts(counts, dicts, width: int, height: int) -> torch.Tensor:
    """Scatter per-tile count rows into the raster grid via their cell
    dictionaries (`_fold_index`)."""
    idx, size = _fold_index(dicts, width, height)
    grid = torch.zeros(size, dtype=torch.float32, device=counts.device)
    grid.index_add_(0, idx.reshape(-1), counts.reshape(-1))
    return grid[:width * height].reshape(height, width)


def _expected_mass(x, y, w, mask, bbox: BBox, width: int, height: int):
    """The mask's in-bounds weight, summed in f64 (the mass check's
    oracle; the f64 accumulation bounds the oracle's own error)."""
    _, ok = bin_cells(x, y, mask, bbox, width, height)
    return torch.where(ok, w.double(), torch.zeros((), dtype=torch.float64,
                                                   device=x.device)).sum()


def density_zsparse(x, y, weights, mask, bbox: BBox, width: int, height: int,
                    calib: Optional[DensityCalib] = None,
                    data_tile: int = DATA_TILE, check_stale: bool = True,
                    stale_exact: bool = False
                    ) -> Tuple[torch.Tensor, DensityCalib]:
    """Store-order density grid (module docstring): ([height, width] f32
    grid, calib). Pass `calib` back on repeat queries over the same
    arrays and filter to skip the calibration pass.

    A reused calib is validated (`check_stale`): a stale plan would
    silently drop points (a tile pruned under the old mask, or a cell
    missing from a cached dictionary), so the grid's total mass is held
    against the mask's expected mass and a mismatch recalibrates. With
    `stale_exact` (unweighted grids: small-integer counts, exact in f32)
    the check runs at atol=0.5, so one dropped point recalibrates; the
    default tolerance only bounds f32 noise of weighted grids, which is
    why callers caching calibs key them on the filter too
    (plan.runner._zsparse_grid)."""
    reused_calib = calib is not None
    pad = (-x.shape[0]) % data_tile
    xp = _pad(x.float(), pad)
    yp = _pad(y.float(), pad)
    wp = _pad(weights.float(), pad)
    mp = _pad(mask, pad)
    if calib is None:
        calib = calibrate_density(xp, yp, mp, bbox, width, height,
                                  data_tile=data_tile)
    dev = x.device
    grid = torch.zeros((height, width), dtype=torch.float32, device=dev)
    lwp = torch.where(mp, wp, torch.zeros((), dtype=torch.float32, device=dev))
    if len(calib.tile_ids):
        tile_ids = torch.from_numpy(calib.tile_ids).to(dev)
        counts = zsparse_counts(xp, yp, lwp, tile_ids, calib.dicts, bbox,
                                width, height, data_tile)
        grid = grid + _fold_counts(counts, calib.dicts, width, height)
    if len(calib.dense_ids):
        # overflow tiles (unsorted input / cell-dense regions): gather
        # their points and take the exact scatter path
        ids = torch.from_numpy(calib.dense_ids.astype(np.int64)).to(dev)
        tiles = lambda a: a.reshape(-1, data_tile)[ids].reshape(-1)  # noqa: E731
        grid = grid + density_grid(tiles(xp), tiles(yp), tiles(wp),
                                   tiles(mp), bbox, width, height)
    if reused_calib and check_stale:
        expected, got = fetch(
            _expected_mass(xp, yp, wp, mp, bbox, width, height),
            grid.double().sum())
        rtol, atol = (0.0, 0.5) if stale_exact else (1e-5, 1e-3)
        if not np.isclose(float(got), float(expected), rtol=rtol, atol=atol):
            # the cached plan no longer covers this mask: recalibrate
            return density_zsparse(x, y, weights, mask, bbox, width, height,
                                   calib=None, data_tile=data_tile)
    return grid, calib


# -- the mesh ---------------------------------------------------------------------


def density_zsparse_sharded(mesh, x, y, weights, mask, bbox: BBox, width: int,
                            height: int, data_tile: int = DATA_TILE,
                            slack: float = 2.0) -> torch.Tensor:
    """Data-parallel cell-dictionary density over a mesh: the [height,
    width] grid on the lead device.

    One GLOBAL calibration (the tiles' dictionaries are a property of the
    row layout, not of the shard cut; the distinct counts of every shard
    give one capd, as `calibrate_density` over the whole array would),
    partitioned by shard: the rows split contiguously and a shard is a
    whole number of tiles, so no tile crosses a shard. Each shard runs B3
    (`zsparse_counts`) over its own tiles, the lists padded to a common
    length with all -1 dictionaries (their rows match nothing and fold
    into the sinks), its overflow tiles take the exact scatter, and the
    shards' grids add on the lead device in shard order (`psum`). Inputs
    are `Sharded` or whole tensors; n must split into shards of whole
    data tiles."""
    from geomesa_tpu_torch.parallel.mesh import (
        exchange, my_shards, on_shard, psum, shards_of)

    xs, ys, ws, ms = (shards_of(mesh, a) for a in (x, y, weights, mask))
    per = int(xs[mesh.local[0]].shape[0])
    if per % data_tile:
        raise ValueError(
            f"shards of {per} rows do not split into data_tile={data_tile} "
            "tiles (pad the batch; the planner's pow2 padding does)")
    sorted_cells: list = [None] * mesh.size
    for i, dev in my_shards(mesh):
        with on_shard(dev):
            xs[i], ys[i], ws[i] = xs[i].float(), ys[i].float(), ws[i].float()
            sorted_cells[i] = _tile_sorted_cells(
                xs[i], ys[i], ms[i], bbox, width, height, data_tile)
    # every shard's distinct counts (one read; from every process where
    # the mesh spans them): the one global calibration
    dn = list(fetch(*exchange(mesh, [sorted_cells[i][2] for i in mesh.local])))
    live = np.concatenate(dn)
    live = live[live > 0]
    capd = _capd(live, slack) if len(live) else 8
    sel = [np.nonzero((v > 0) & (v <= capd))[0] for v in dn]
    dense = [np.nonzero(v > capd)[0] for v in dn]
    n_slots = max(max(len(t) for t in sel), 1)
    parts = []
    for i, dev in my_shards(mesh):
        with on_shard(dev):
            s, first, _ = sorted_cells[i]
            ids = np.zeros(n_slots, np.int64)
            ids[:len(sel[i])] = sel[i]
            at = torch.from_numpy(ids).to(dev)
            dicts = _tile_dicts(s[at], first[at], capd)
            dicts[len(sel[i]):] = -1  # the padding slots match nothing
            lw = torch.where(ms[i], ws[i], torch.zeros((), dtype=torch.float32,
                                                       device=dev))
            counts = zsparse_counts(xs[i], ys[i], lw, at.to(torch.int32),
                                    dicts, bbox, width, height, data_tile)
            grid = _fold_counts(counts, dicts, width, height)
            if len(dense[i]):
                did = torch.from_numpy(dense[i].astype(np.int64)).to(dev)
                tiles = lambda a: a.reshape(-1, data_tile)[did].reshape(-1)  # noqa: E731
                grid = grid + density_grid(tiles(xs[i]), tiles(ys[i]),
                                           tiles(ws[i]), tiles(ms[i]), bbox,
                                           width, height)
            parts.append(grid)
    return psum(mesh, parts)
