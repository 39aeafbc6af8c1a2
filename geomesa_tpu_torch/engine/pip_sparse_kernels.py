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
  pip_pairs_count  (B8): crossings, one pair (point tile, edge tile) at a
                         time, into [n_ptiles + 1, 512]
  pip_pairs_band   (B9): band flags over the same walk

Each wrapper takes its plain PyTorch version only for tensors on the CPU;
on a CUDA tensor it launches the kernel (built from
`kernels/pip_layer.cu` at first use) or raises. `launches` on each
wrapper counts its kernel launches. `pair_csr` turns a pair list into the
CSR input of B6/B7 on the host. Outputs are zero on tiles no pair names.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from geomesa_tpu_torch.engine.device import check_kernel_inputs
from geomesa_tpu_torch.engine.pip_kernels import _device_of, crossing_and_band

TILE = 512  # POINT_TILE == EDGE_TILE
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
        lib.pip_grouped_launch.argtypes = [p] * 11 + [i, f, p]
        lib.pip_assign_launch.argtypes = [p] * 13 + [i, f, p]
        lib.pip_pairs_count_launch.argtypes = [p] * 9 + [i, p]
        lib.pip_pairs_band_launch.argtypes = [p] * 9 + [i, f, p]
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


def _check_csr(rows, row_ptr, ets, pinfo, n_ptiles, x1):
    if row_ptr.shape[0] != rows.shape[0] + 1:
        raise ValueError("row_ptr must have one entry more than rows")
    if pinfo is not None and pinfo.shape != ets.shape:
        raise ValueError("pinfo must match ets")
    _in_range((rows, n_ptiles), (row_ptr, ets.shape[0] + 1),
              (ets, x1.shape[0] // TILE))


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
    _check_csr(rows, row_ptr, ets, None, n_ptiles, x1)
    if rows.shape[0]:
        _run("pip_grouped", px, py, x1, y1, x2, y2, rows, row_ptr, ets, *outs,
             rows.shape[0], float(eps))
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
    _check_csr(rows, row_ptr, ets, pinfo, n_ptiles, x1)
    if rows.shape[0]:
        _run("pip_assign", px, py, x1, y1, x2, y2, rows, row_ptr, ets, pinfo,
             *outs, rows.shape[0], float(eps))
        pip_assign.launches += 1
    return tuple(outs)


pip_assign.launches = 0


def _pairs_launch(name, px, py, x1, y1, x2, y2, pair_pt, pair_et, n_ptiles,
                  *eps):
    out = torch.zeros((n_ptiles + 1, TILE), dtype=torch.int32, device=px.device)
    _check((px, py), (x1, y1, x2, y2), (pair_pt, pair_et), (out,), n_ptiles)
    if pair_pt.shape != pair_et.shape:
        raise ValueError("pair_pt and pair_et must match")
    _in_range((pair_pt, n_ptiles), (pair_et, x1.shape[0] // TILE))
    if pair_pt.shape[0]:
        _run(name, px, py, x1, y1, x2, y2, pair_pt, pair_et, out,
             pair_pt.shape[0], *[float(e) for e in eps])
    return out


def pip_pairs_count(px, py, x1, y1, x2, y2, pair_pt, pair_et, n_ptiles: int):
    """Crossing counts over the pair walk (B8): int32 [n_ptiles + 1, 512]
    (the last row is the reference's scratch tile, here always zero).
    pair_pt, pair_et: int32 [M]."""
    if _device_of(px, "pip_pairs_count") == "cpu":
        return pip_pairs_count_plain(px, py, x1, y1, x2, y2, pair_pt, pair_et,
                                     n_ptiles)
    out = _pairs_launch("pip_pairs_count", px, py, x1, y1, x2, y2, pair_pt,
                        pair_et, n_ptiles)
    if pair_pt.shape[0]:
        pip_pairs_count.launches += 1
    return out


pip_pairs_count.launches = 0


def pip_pairs_band(px, py, x1, y1, x2, y2, pair_pt, pair_et, n_ptiles: int,
                   eps: float):
    """Band-flag counts over the pair walk (B9), as `pip_pairs_count`."""
    if _device_of(px, "pip_pairs_band") == "cpu":
        return pip_pairs_band_plain(px, py, x1, y1, x2, y2, pair_pt, pair_et,
                                    n_ptiles, eps)
    out = _pairs_launch("pip_pairs_band", px, py, x1, y1, x2, y2, pair_pt,
                        pair_et, n_ptiles, eps)
    if pair_pt.shape[0]:
        pip_pairs_band.launches += 1
    return out


pip_pairs_band.launches = 0
