"""Polygon-layer crossing kernels (B6-B9) and their plain versions.

The counterpart of the `pallas_call` wrappers of the reference package's
`engine/pip_sparse.py`, as `pip_kernels.py` is for `pip_pallas.py`. Every
kernel tests the 512 points of a point tile against the 512 edges of an
edge tile with the shared predicate (`pip_kernels.crossing_and_band`) and
sums int32 counts per point:

  pip_grouped      (B6): per covered point tile, crossings and band flags
                         over the tile's edge tiles (a CSR row)
  pip_assign       (B7): per-polygon parity over a CSR row whose edge
                         tiles are grouped by polygon: assign, count, band
  pip_pairs_count  (B8): crossings over a list of (point tile, edge tile)
                         pairs in any order, into [n_ptiles + 1, 512]
  pip_pairs_band   (B9): band flags over the same pairs, into
                         [n_ptiles + 1, 512]

Each wrapper takes its plain PyTorch version only for tensors on the CPU;
on a CUDA tensor it launches the kernel (built from
`kernels/pip_layer.cu` at first use) or raises. `launches` on each
wrapper counts its kernel launches. `pair_csr` turns a pair list into the
CSR input of B6/B7 on the host, `pairs_csr` into B8/B9's on the device.
Outputs are zero on tiles no pair names.

B6/B7 hand out CSR rows longest first (`row_order`), sort each point
tile's points by y (`tile_y_order`) and let each warp of `WARP_POINTS`
sorted points (`warp_ys`) skip every `CHUNK`-edge chunk whose y-span,
widened by 2 eps, misses all of its points (`kept_chunks`) and, in the
chunks it keeps, every edge whose y-span misses the warp's y-range
(`kept_edges`): the rule of `pip_kernels.out_of_reach`, which the CUDA
source proves exact. B8 and B9 walk B6's way over one CSR row per point
tile (`pairs_csr`): B8 the crossings alone, with a reach margin of 0
(eps = 0), B9 the band alone. These functions state that
structure in PyTorch, for tests and for counting what the kernels skip;
the plain versions test every pair.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from geomesa_tpu_torch.engine.device import check_kernel_inputs
from geomesa_tpu_torch.engine.pip_kernels import (
    _device_of, crossing_and_band, edge_chunk_bounds, out_of_reach)

TILE = 512  # POINT_TILE == EDGE_TILE
# kPerThread, kChunk and kThreads of kernels/pip_layer.cu (B6/B7)
PER_THREAD = 1
CHUNK = 32
THREADS = TILE // PER_THREAD
WARP_POINTS = 32 * PER_THREAD
# elements of one [pairs, 512, 512] block in the plain versions (~64 MB f32)
_PLAIN_CHUNK_ELEMS = 1 << 24


class PairCSR(NamedTuple):
    """Host CSR over the covered point tiles (all int32 numpy): row k is
    point tile rows[k] with edge tiles ets[row_ptr[k]:row_ptr[k+1]];
    pinfo (B7 only) is the pair's polygon rank + 1, negated on the last
    edge tile of that polygon's run in its row."""

    rows: np.ndarray
    row_ptr: np.ndarray
    ets: np.ndarray
    pinfo: Optional[np.ndarray]


def pair_csr(pair_pt, pair_et,
             poly_of_tile: Optional[np.ndarray] = None) -> PairCSR:
    """CSR input of B6 (pairs stably sorted by point tile: each tile is one
    row, owned by one block) or, with `poly_of_tile` (polygon rank per
    edge tile), of B7: pairs in the stable (point tile, polygon) lexsort
    order with the flush markers, as the reference's `pip_layer_assign`
    builds them."""
    pt = np.asarray(pair_pt, np.int64)
    et = np.asarray(pair_et, np.int64)
    pinfo = None
    if poly_of_tile is None:
        order = np.argsort(pt, kind="stable")
        pt, et = pt[order], et[order]
    else:
        pid = np.asarray(poly_of_tile, np.int64)[et]
        order = np.lexsort((pid, pt))
        pt, et, pid = pt[order], et[order], pid[order]
        last = np.ones(len(pt), bool)
        last[:-1] = (pt[1:] != pt[:-1]) | (pid[1:] != pid[:-1])
        pinfo = np.where(last, -(pid + 1), pid + 1).astype(np.int32)
    starts = np.flatnonzero(np.diff(pt, prepend=-1))
    return PairCSR(pt[starts].astype(np.int32),
                   np.r_[starts, len(pt)].astype(np.int32),
                   et.astype(np.int32), pinfo)


def pairs_csr(pair_pt: torch.Tensor, pair_et: torch.Tensor, n_ptiles: int):
    """B8/B9's CSR of a pair list, int32 (rows, row_ptr, ets) on the pairs'
    device with no host sync: row t is point tile t (every tile, empty
    rows included) with the edge tiles of its pairs in list order (a
    stable sort by point tile; a duplicate pair stays twice)."""
    srt, order = torch.sort(pair_pt, stable=True)
    dev = pair_pt.device
    tiles = torch.arange(n_ptiles + 1, dtype=srt.dtype, device=dev)
    row_ptr = torch.searchsorted(srt, tiles).to(torch.int32)
    rows = torch.arange(n_ptiles, dtype=torch.int32, device=dev)
    return rows, row_ptr, pair_et[order].to(torch.int32).contiguous()


def row_order(row_ptr: torch.Tensor) -> torch.Tensor:
    """The B6/B7 blocks' order of the CSR rows: int32, longest row first,
    equal lengths in row order. On row_ptr's device, with no host sync."""
    lens = row_ptr[1:] - row_ptr[:-1]
    return torch.argsort(lens, descending=True, stable=True).to(torch.int32)


def tile_y_order(py: torch.Tensor) -> torch.Tensor:
    """int64 [n_ptiles, 512]: each point tile's slots in the order B6/B7
    sort them: the kernel's unique 64-bit keys, y's order-preserving bits
    (NaN last) and then the slot."""
    u = py.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    key = torch.where(torch.isnan(py), 0xFFFFFFFF, key).reshape(-1, TILE)
    slots = torch.arange(TILE, device=py.device)
    return torch.argsort(key * TILE + slots, dim=1)


def warp_ys(py: torch.Tensor) -> torch.Tensor:
    """f32 [n_ptiles, 512 // WARP_POINTS, WARP_POINTS]: each warp's y
    after the tile's y-sort (ascending, NaN last)."""
    q = torch.gather(py.reshape(-1, TILE), 1, tile_y_order(py))
    return q.reshape(-1, TILE // WARP_POINTS, WARP_POINTS)


def warp_y_ranges(ys: torch.Tensor):
    """(ymin, ymax) f32 [..., warps] of `warp_ys`, NaN ignored (a warp of
    NaN points gets (+inf, -inf))."""
    nan = torch.isnan(ys)
    return (torch.where(nan, float("inf"), ys).amin(-1),
            torch.where(nan, -float("inf"), ys).amax(-1))


def tile_chunk_bounds(y1, y2):
    """(lo, hi) f32 [n_etiles, 512 // CHUNK]: the y-bounds of each edge
    tile's chunks (`edge_chunk_bounds`: NaN ends ignored, a chunk of NaN
    edges gets (+inf, -inf))."""
    return tuple(a.reshape(-1, TILE // CHUNK)
                 for a in edge_chunk_bounds(y1, y2, CHUNK))


def kept_chunks(ys, bounds, pt, et, eps: float):
    """bool [M, warps, chunks]: for each pair (point tile pt[m], edge tile
    et[m]), the chunks that each warp tests. ys: `warp_ys`; bounds:
    `tile_chunk_bounds`. A chunk is kept when it is in reach of one of the
    warp's points (`out_of_reach` of a one-point range); NaN points reach
    nothing."""
    lo, hi = (b[et.long()][:, None, None, :] for b in bounds)
    y = ys[pt.long()][..., None]
    return (~out_of_reach(lo, hi, y, y, eps) & ~torch.isnan(y)).any(2)


def kept_edges(ys, bounds, y1, y2, pt, et, eps: float):
    """bool [M, warps, 512]: the edges of edge tile et[m] that each warp of
    point tile pt[m] tests: those of its kept chunks (`kept_chunks`) whose
    own y-span (NaN ends ignored) is in reach of the warp's y-range
    (`warp_y_ranges`)."""
    e, p = et.long(), pt.long()
    y1t, y2t = y1.reshape(-1, TILE)[e], y2.reshape(-1, TILE)[e]
    ymin, ymax = (a[:, :, None] for a in warp_y_ranges(ys[p]))
    reach = ~out_of_reach(torch.fmin(y1t, y2t)[:, None, :],
                          torch.fmax(y1t, y2t)[:, None, :], ymin, ymax, eps)
    return reach & kept_chunks(ys, bounds, pt, et, eps).repeat_interleave(
        CHUNK, dim=2)


def kept_counts(py, y1, y2, pt, et, eps: float):
    """(chunks, edges) int64 [M]: for each pair, the chunks all its warps
    keep and the edges they test (`kept_chunks`, `kept_edges`), 1024 pairs
    at a time. Times WARP_POINTS, the tests B6/B7 make on the pair, chunk
    by chunk or edge by edge. Counted from the data; the kernels count
    nothing."""
    ys = warp_ys(py)
    bounds = tile_chunk_bounds(y1, y2)
    chunks, edges = [], []
    for s in range(0, pt.shape[0], 1 << 10):
        p, e = pt[s:s + (1 << 10)], et[s:s + (1 << 10)]
        chunks.append(kept_chunks(ys, bounds, p, e, eps).sum((1, 2)))
        edges.append(kept_edges(ys, bounds, y1, y2, p, e, eps).sum((1, 2)))
    if not chunks:
        z = torch.zeros(0, dtype=torch.int64, device=py.device)
        return z, z
    return torch.cat(chunks), torch.cat(edges)


# -- plain versions --------------------------------------------------------


def _pair_counts(px, py, x1, y1, x2, y2, pt, et, eps: float,
                 cross: bool = True, band: bool = True):
    """(crossings, band flags) int32 [M, 512] per pair m: each point of
    tile pt[m] against the 512 edges of tile et[m] (None where not
    asked), over pair chunks so the [pairs, 512, 512] temporaries stay
    bounded."""
    pxt, pyt = px.reshape(-1, TILE), py.reshape(-1, TILE)
    ex = [a.reshape(-1, TILE) for a in (x1, y1, x2, y2)]
    m = pt.shape[0]
    dev = px.device
    out_c = torch.zeros((m, TILE), dtype=torch.int32, device=dev) if cross else None
    out_b = torch.zeros((m, TILE), dtype=torch.int32, device=dev) if band else None
    e32 = torch.tensor(eps, dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK_ELEMS // (TILE * TILE))
    for s in range(0, m, step):
        p = pt[s:s + step].long()
        e = et[s:s + step].long()
        c, b = crossing_and_band(pxt[p][:, :, None], pyt[p][:, :, None],
                                 *[a[e][:, None, :] for a in ex], e32)
        if cross:
            out_c[s:s + step] = c.sum(dim=2, dtype=torch.int32)
        if band:
            out_b[s:s + step] = b.sum(dim=2, dtype=torch.int32)
    return out_c, out_b


def _row_pairs(rows, row_ptr):
    """Point tile of each pair of a CSR: rows repeated over row lengths."""
    return torch.repeat_interleave(rows.long(), (row_ptr[1:] - row_ptr[:-1]).long())


def pip_grouped_plain(px, py, x1, y1, x2, y2, rows, row_ptr, ets,
                      n_ptiles: int, eps: float):
    """Plain PyTorch version of `pip_grouped` (same contract)."""
    pt = _row_pairs(rows, row_ptr)
    c, b = _pair_counts(px, py, x1, y1, x2, y2, pt, ets, eps)
    z = torch.zeros((n_ptiles, TILE), dtype=torch.int32, device=px.device)
    return z.index_add(0, pt, c), z.index_add(0, pt, b)


def pip_assign_plain(px, py, x1, y1, x2, y2, rows, row_ptr, ets, pinfo,
                     n_ptiles: int, eps: float):
    """Plain PyTorch version of `pip_assign` (same contract). A run is a
    stretch of a row's pairs that ends at a flush marker (pinfo < 0) or
    at the row's end; only runs that end at a marker are flushed, as in
    the kernel, whose running count restarts with each row."""
    pt = _row_pairs(rows, row_ptr)
    c, b = _pair_counts(px, py, x1, y1, x2, y2, pt, ets, eps)
    dev = px.device
    z = torch.zeros((n_ptiles, TILE), dtype=torch.int32, device=dev)
    m = pt.shape[0]
    if m == 0:
        return z, z.clone(), z.clone()
    flush = pinfo < 0
    start = torch.ones(m, dtype=torch.bool, device=dev)
    start[1:] = (pt[1:] != pt[:-1]) | flush[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    n_runs = int(run[-1]) + 1
    runs = torch.zeros((n_runs, TILE), dtype=torch.int32, device=dev)
    runs.index_add_(0, run, c)
    ends = flush.nonzero().flatten()  # each run ends at most once at a marker
    parity = runs[run[ends]] & 1
    tiles = pt[ends]
    assign = z.index_add(0, tiles, parity * (-pinfo[ends].long()).to(torch.int32)[:, None])
    count = z.index_add(0, tiles, parity)
    return assign, count, z.index_add(0, pt, b)


def pip_pairs_count_plain(px, py, x1, y1, x2, y2, pair_pt, pair_et,
                          n_ptiles: int):
    """Plain PyTorch version of `pip_pairs_count` (same contract)."""
    c, _ = _pair_counts(px, py, x1, y1, x2, y2, pair_pt, pair_et, 0.0,
                        band=False)
    z = torch.zeros((n_ptiles + 1, TILE), dtype=torch.int32, device=px.device)
    return z.index_add(0, pair_pt.long(), c)


def pip_pairs_band_plain(px, py, x1, y1, x2, y2, pair_pt, pair_et,
                         n_ptiles: int, eps: float):
    """Plain PyTorch version of `pip_pairs_band` (same contract)."""
    _, b = _pair_counts(px, py, x1, y1, x2, y2, pair_pt, pair_et, eps,
                        cross=False)
    z = torch.zeros((n_ptiles + 1, TILE), dtype=torch.int32, device=px.device)
    return z.index_add(0, pair_pt.long(), b)


# -- kernels ---------------------------------------------------------------


def _lib():
    from geomesa_tpu_torch.engine.kernels.build import load

    lib = load("pip_layer")
    if lib.pip_grouped_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pip_grouped_launch.argtypes = [p] * 13 + [i, i, f, p]
        lib.pip_assign_launch.argtypes = [p] * 15 + [i, i, f, p]
        for fn in (lib.pip_pairs_count_launch, lib.pip_pairs_band_launch):
            fn.argtypes = [p] * 12 + [i, i, f, p]
        for fn in (lib.pip_grouped_launch, lib.pip_assign_launch,
                   lib.pip_pairs_count_launch, lib.pip_pairs_band_launch):
            fn.restype = ctypes.c_int
    return lib


def _check(points, edges, ids, outs, n_ptiles: int):
    """Refuse what the kernels do not take: another dtype or device, a
    strided layout, or point/edge arrays that are not whole tiles."""
    f32, i32 = torch.float32, torch.int32
    check_kernel_inputs(*points, *edges, *ids, *outs,
                        dtypes=(f32,) * 6 + (i32,) * (len(ids) + len(outs)))
    if any(t.dim() != 1 for t in (*points, *edges, *ids)):
        raise ValueError("kernel inputs must be flat")
    if points[0].shape[0] != n_ptiles * TILE or points[1].shape != points[0].shape:
        raise ValueError(f"points must be [n_ptiles * {TILE}]")
    if edges[0].shape[0] % TILE or any(e.shape != edges[0].shape for e in edges):
        raise ValueError(f"edge arrays must match and be whole {TILE}-edge tiles")


def _run(name, *args):
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = getattr(_lib(), f"{name}_launch")(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _in_range(*checks) -> None:
    """Refuse index tensors with entries outside [0, hi) (pairs of
    (tensor, hi)): the kernels read through them unchecked. One host
    sync for all of them."""
    live = [(t, hi) for t, hi in checks if t.numel()]
    if live:
        ext = torch.stack([torch.stack([t.min(), t.max()]) for t, _ in live])
        for (_, hi), (lo, top) in zip(live, ext.tolist()):
            if lo < 0 or top >= hi:
                raise ValueError(f"tile index out of range [0, {hi})")


def _check_aligned(*edges):
    if any(a.data_ptr() % 16 for a in edges):
        raise ValueError("edge arrays must be 16-byte aligned (cp.async)")


def _check_csr(rows, row_ptr, ets, pinfo, n_ptiles, x1, y1, x2, y2):
    _check_aligned(x1, y1, x2, y2)
    if row_ptr.shape[0] != rows.shape[0] + 1:
        raise ValueError("row_ptr must have one entry more than rows")
    if pinfo is not None and pinfo.shape != ets.shape:
        raise ValueError("pinfo must match ets")
    _in_range((rows, n_ptiles), (row_ptr, ets.shape[0] + 1),
              (ets, x1.shape[0] // TILE))


def _bounds(x1):
    """Scratch for B6-B9's prologue: (min y, max y) f32 of every chunk."""
    return torch.empty(2 * (x1.shape[0] // CHUNK), dtype=torch.float32,
                       device=x1.device)


def pip_grouped(px, py, x1, y1, x2, y2, rows, row_ptr, ets, n_ptiles: int,
                eps: float):
    """Union crossing and band-flag counts (B6): int32 (counts, band)
    [n_ptiles, 512]. Points: f32 [n_ptiles * 512]; edges: f32, whole
    512-edge tiles; rows, row_ptr, ets: int32 CSR (`pair_csr`)."""
    if _device_of(px, "pip_grouped") == "cpu":
        return pip_grouped_plain(px, py, x1, y1, x2, y2, rows, row_ptr, ets,
                                 n_ptiles, eps)
    outs = [torch.zeros((n_ptiles, TILE), dtype=torch.int32, device=px.device)
            for _ in range(2)]
    _check((px, py), (x1, y1, x2, y2), (rows, row_ptr, ets), outs, n_ptiles)
    _check_csr(rows, row_ptr, ets, None, n_ptiles, x1, y1, x2, y2)
    if rows.shape[0]:
        _run("pip_grouped", px, py, x1, y1, x2, y2, _bounds(x1), row_order(row_ptr),
             rows, row_ptr, ets, *outs, rows.shape[0], x1.shape[0] // TILE,
             float(eps))
        pip_grouped.launches += 1
    return tuple(outs)


pip_grouped.launches = 0


def pip_assign(px, py, x1, y1, x2, y2, rows, row_ptr, ets, pinfo,
               n_ptiles: int, eps: float):
    """Per-polygon parity (B7): int32 (assign, count, band) [n_ptiles,
    512]. assign sums parity * (polygon rank + 1) over the row's
    polygons, count sums parity. Inputs as `pip_grouped`, plus pinfo
    (`pair_csr` with `poly_of_tile`)."""
    if _device_of(px, "pip_assign") == "cpu":
        return pip_assign_plain(px, py, x1, y1, x2, y2, rows, row_ptr, ets,
                                pinfo, n_ptiles, eps)
    outs = [torch.zeros((n_ptiles, TILE), dtype=torch.int32, device=px.device)
            for _ in range(3)]
    _check((px, py), (x1, y1, x2, y2), (rows, row_ptr, ets, pinfo), outs,
           n_ptiles)
    _check_csr(rows, row_ptr, ets, pinfo, n_ptiles, x1, y1, x2, y2)
    if rows.shape[0]:
        _run("pip_assign", px, py, x1, y1, x2, y2, _bounds(x1), row_order(row_ptr),
             rows, row_ptr, ets, pinfo, *outs, rows.shape[0], x1.shape[0] // TILE,
             float(eps))
        pip_assign.launches += 1
    return tuple(outs)


pip_assign.launches = 0


def _pairs_walk(name, px, py, x1, y1, x2, y2, pair_pt, pair_et, n_ptiles,
                eps) -> torch.Tensor:
    """B8/B9's launch over one CSR row per point tile (`pairs_csr`) into a
    zeroed int32 [n_ptiles + 1, 512] (an empty pair list launches nothing:
    the zeros are the counts)."""
    out = torch.zeros((n_ptiles + 1, TILE), dtype=torch.int32, device=px.device)
    _check_aligned(x1, y1, x2, y2)
    _check((px, py), (x1, y1, x2, y2), (pair_pt, pair_et), (out,), n_ptiles)
    if pair_pt.shape != pair_et.shape:
        raise ValueError("pair_pt and pair_et must match")
    _in_range((pair_pt, n_ptiles), (pair_et, x1.shape[0] // TILE))
    if pair_pt.shape[0]:
        rows, row_ptr, ets = pairs_csr(pair_pt, pair_et, n_ptiles)
        _run(name, px, py, x1, y1, x2, y2, _bounds(x1), row_order(row_ptr),
             rows, row_ptr, ets, out, n_ptiles, x1.shape[0] // TILE, float(eps))
    return out


def pip_pairs_count(px, py, x1, y1, x2, y2, pair_pt, pair_et, n_ptiles: int):
    """Crossing counts over the pairs (B8): int32 [n_ptiles + 1, 512] (the
    last row is the reference's scratch tile, here always zero).
    pair_pt, pair_et: int32 [M], in any order, a duplicate pair counted
    twice. The kernel walks one row per point tile (`pairs_csr`) as B6
    does, crossings only, with a reach margin of 0; edge arrays must be
    16-byte aligned (cp.async)."""
    if _device_of(px, "pip_pairs_count") == "cpu":
        return pip_pairs_count_plain(px, py, x1, y1, x2, y2, pair_pt, pair_et,
                                     n_ptiles)
    out = _pairs_walk("pip_pairs_count", px, py, x1, y1, x2, y2, pair_pt,
                      pair_et, n_ptiles, 0.0)
    if pair_pt.shape[0]:
        pip_pairs_count.launches += 1
    return out


pip_pairs_count.launches = 0


def pip_pairs_band(px, py, x1, y1, x2, y2, pair_pt, pair_et, n_ptiles: int,
                   eps: float):
    """Band-flag counts over the pairs (B9), as `pip_pairs_count`, band
    flags only (the reach margin 2 eps, as B6's)."""
    if _device_of(px, "pip_pairs_band") == "cpu":
        return pip_pairs_band_plain(px, py, x1, y1, x2, y2, pair_pt, pair_et,
                                    n_ptiles, eps)
    out = _pairs_walk("pip_pairs_band", px, py, x1, y1, x2, y2, pair_pt,
                      pair_et, n_ptiles, eps)
    if pair_pt.shape[0]:
        pip_pairs_band.launches += 1
    return out


pip_pairs_band.launches = 0
