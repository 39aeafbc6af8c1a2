"""Crossing-number point-in-polygon kernels (B4, B5) and their plain versions.

The counterpart of the reference package's `engine/pip_pallas.py`. Both
kernels test [N] points against an [E] edge table (x1, y1, x2, y2), f32,
with the half-open edge rule:

  pip_crossing  (B4): bool [N], odd number of edges crossed by the ray
                      to the right of the point (even-odd rule)
  pip_band      (B5): bool [N], the f32 boundary-ambiguity flags that
                      the caller re-decides in f64 on the host

Each wrapper takes its plain PyTorch version only for tensors on the
CPU; on a CUDA tensor it launches the kernel (built from
`kernels/pip_crossing.cu` at first use) or raises. `launches` on each
wrapper counts its kernel launches; one launch is two kernels on one
stream, the `chunk_bounds` prologue (skipped when E = 0) and the main
kernel. There is no work threshold: the reference's `use_pallas_pip`
crossover is a TPU figure.

The kernels skip, for each block of `BLOCK_POINTS` consecutive points,
every chunk of `CHUNK` edges and every edge whose y-span cannot reach
the block's y-range (`out_of_reach`, the rule the CUDA source proves
exact). So they are fast only on points in spatial order, which the
caller must give them: the stores keep rows in write order within a
partition. `edge_chunk_bounds`, `block_y_range`, `out_of_reach` and
`kept_edge_mask` state that rule in PyTorch, for tests and for counting
what a kernel skips; the plain versions test every pair.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from geomesa_tpu_torch.engine.device import check_kernel_inputs, count_launch

# elements of one [chunk, E] block in the plain versions (~64 MB f32)
_PLAIN_CHUNK_ELEMS = 1 << 24
# kChunk and kThreads * kPerThread of kernels/pip_crossing.cu
CHUNK = 32
BLOCK_POINTS = 512


def _crossing_x(py, x1, y1, x2, y2):
    """(cond, xc) [chunk, E]: whether the edge's y-span straddles py
    (half-open) and the edge's x at py, in f32 with the multiply and the
    add rounded separately, as the kernel writes them."""
    cond = (y1 <= py) != (y2 <= py)
    den = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
    t = (py - y1) / den
    return cond, x1 + t * (x2 - x1)


def crossing_and_band(px, py, x1, y1, x2, y2, e32):
    """(crossing, band) bool [chunk, E]: the shared predicate of the PIP
    kernels (the reference's `pip_sparse._crossing_and_band`, whose
    docstring proves the band sufficient). e32: eps as an f32 tensor."""
    cond, xc = _crossing_x(py, x1, y1, x2, y2)
    near_flat = ((torch.abs(py - y1) <= e32) & (torch.abs(py - y2) <= e32)
                 & (px >= torch.minimum(x1, x2) - e32)
                 & (px <= torch.maximum(x1, x2) + e32))
    err = e32 * (1.0 + torch.abs(x2 - x1)
                 / torch.maximum(torch.abs(y2 - y1), e32))
    return cond & (xc > px), near_flat | (cond & (torch.abs(xc - px) <= err))


def _plain(px, py, x1, y1, x2, y2, row_fn):
    """Apply row_fn(px [c,1], py [c,1], edges [1,E]...) -> [c] over point
    chunks, so the [chunk, E] temporaries stay bounded."""
    n, e = px.shape[0], x1.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=px.device)
    if e == 0 or n == 0:
        return out
    edges = [a.reshape(1, e) for a in (x1, y1, x2, y2)]
    step = max(1, _PLAIN_CHUNK_ELEMS // e)
    for s in range(0, n, step):
        sl = slice(s, min(s + step, n))
        out[sl] = row_fn(px[sl, None], py[sl, None], *edges)
    return out


def pip_crossing_plain(px, py, x1, y1, x2, y2):
    """Plain PyTorch version of `pip_crossing` (same contract)."""
    def rows(px, py, x1, y1, x2, y2):
        cond, xc = _crossing_x(py, x1, y1, x2, y2)
        return ((cond & (xc > px)).sum(dim=1) % 2) == 1
    return _plain(px, py, x1, y1, x2, y2, rows)


def pip_band_plain(px, py, x1, y1, x2, y2, eps: float):
    """Plain PyTorch version of `pip_band` (same contract)."""
    e32 = torch.tensor(eps, dtype=torch.float32, device=px.device)

    def rows(px, py, x1, y1, x2, y2):
        return crossing_and_band(px, py, x1, y1, x2, y2, e32)[1].any(dim=1)
    return _plain(px, py, x1, y1, x2, y2, rows)


def edge_chunk_bounds(y1, y2, chunk: int = CHUNK):
    """(lo, hi) f32 [ceil(E / chunk)]: the least and greatest y-end of each
    run of `chunk` edges in table order, NaN ends ignored (the prologue
    kernel's fminf/fmaxf); a chunk of NaN edges gets (+inf, -inf)."""
    inf = float("inf")
    lo = torch.fmin(y1, y2)
    hi = torch.fmax(y1, y2)
    lo = torch.where(torch.isnan(lo), inf, lo)
    hi = torch.where(torch.isnan(hi), -inf, hi)
    pad = (-lo.shape[0]) % chunk
    lo = torch.nn.functional.pad(lo, (0, pad), value=inf)
    hi = torch.nn.functional.pad(hi, (0, pad), value=-inf)
    return lo.reshape(-1, chunk).amin(1), hi.reshape(-1, chunk).amax(1)


def block_y_range(py, block: int = BLOCK_POINTS):
    """(ymin, ymax) f32 [ceil(N / block)]: each block's y-range over its
    points, NaN ignored; a block of NaN points gets (+inf, -inf)."""
    inf = float("inf")
    pad = (-py.shape[0]) % block
    q = torch.nn.functional.pad(py, (0, pad), value=float("nan")).reshape(-1, block)
    nan = torch.isnan(q)
    return (torch.where(nan, inf, q).amin(1), torch.where(nan, -inf, q).amax(1))


def out_of_reach(lo, hi, ymin, ymax, eps=None):
    """bool, the four arguments broadcast: True where no point with y in
    [ymin, ymax] can be crossed (eps None: B4) or band-flagged (B5,
    within eps) by an edge whose y-ends lie in [lo, hi]. B4 needs
    min(y1,y2) <= py < max(y1,y2); B5 widens by 2 eps, in f64 (the
    kernels' skip rule, B4-B7; a NaN bound skips nothing)."""
    if eps is None:
        return (lo > ymax) | (hi <= ymin)
    m = 2.0 * float(np.float32(eps))
    return ((lo.double() - ymax.double() > m)
            | (ymin.double() - hi.double() > m))


def kept_edge_mask(ymin, ymax, y1, y2, eps=None, chunk: int = CHUNK):
    """(by_chunk, staged) bool [B, E]: for blocks of points with y-ranges
    [ymin, ymax], the edges of the chunks that the kernel keeps, and of
    those the edges that it stages (eps None: B4's rule, else B5's)."""
    e = y1.shape[0]
    lo, hi = edge_chunk_bounds(y1, y2, chunk)
    ymin, ymax = ymin[:, None], ymax[:, None]
    by_chunk = (~out_of_reach(lo[None, :], hi[None, :], ymin, ymax, eps)
                ).repeat_interleave(chunk, dim=1)[:, :e]
    staged = by_chunk & ~out_of_reach(torch.fmin(y1, y2)[None, :],
                                      torch.fmax(y1, y2)[None, :], ymin, ymax, eps)
    return by_chunk, staged


def kept_edges(py, y1, y2, eps=None):
    """(by_chunk, staged) int64 [ceil(N / BLOCK_POINTS)]: per block of
    the kernels' size, the counts of `kept_edge_mask`, 4096 blocks at a
    time. Counted from the data; the kernels count nothing."""
    ymin, ymax = block_y_range(py)
    step = 4096
    counts = [torch.stack([m.sum(1) for m in kept_edge_mask(
        ymin[s:s + step], ymax[s:s + step], y1, y2, eps)])
        for s in range(0, ymin.shape[0], step)]
    by_chunk, staged = torch.cat(counts, dim=1)
    return by_chunk, staged


def _lib():
    from geomesa_tpu_torch.engine.kernels.build import load

    lib = load("pip_crossing")
    ptrs = [ctypes.c_void_p] * 7
    if lib.pip_crossing_launch.argtypes is None:
        lib.pip_crossing_launch.argtypes = ptrs + [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p]
        lib.pip_crossing_launch.restype = ctypes.c_int
        lib.pip_band_launch.argtypes = ptrs + [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.pip_band_launch.restype = ctypes.c_int
    return lib


def _launch(name, px, py, x1, y1, x2, y2, *extra):
    out = torch.empty(px.shape[0], dtype=torch.bool, device=px.device)
    f32 = torch.float32
    check_kernel_inputs(px, py, x1, y1, x2, y2, out,
                        dtypes=(f32,) * 6 + (torch.bool,))
    if px.shape != py.shape or not (x1.shape == y1.shape == x2.shape == y2.shape):
        raise ValueError("points and edge arrays must match in length")
    e = x1.shape[0]
    # the prologue kernel's per-chunk (min y, max y), f32 pairs
    bounds = torch.empty(2 * (-(-e // CHUNK)), dtype=f32, device=px.device)
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(_lib(), f"{name}_launch")
        err = fn(px.data_ptr(), py.data_ptr(), x1.data_ptr(), y1.data_ptr(),
                 x2.data_ptr(), y2.data_ptr(), out.data_ptr(),
                 bounds.data_ptr(), bounds.shape[0], px.shape[0], e, *extra,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _device_of(px: torch.Tensor, name: str) -> str:
    if px.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {px.device}")
    return px.device.type


def pip_crossing(px, py, x1, y1, x2, y2):
    """Even-odd point-in-polygon (B4): [N] points x [E] edges, f32 ->
    bool [N]. An edge crosses when exactly one endpoint is at or below
    py (half-open) and its x at py is strictly right of px."""
    if _device_of(px, "pip_crossing") == "cpu":
        return pip_crossing_plain(px, py, x1, y1, x2, y2)
    if px.shape[0] == 0:  # nothing to launch
        return torch.zeros(0, dtype=torch.bool, device=px.device)
    out = _launch("pip_crossing", px, py, x1, y1, x2, y2)
    count_launch(pip_crossing)
    return out


pip_crossing.launches = 0


def pip_band(px, py, x1, y1, x2, y2, eps: float):
    """Boundary-ambiguity flags (B5): bool [N], True where some edge is
    near-flat within eps of the point, or crosses within the
    slope-inflated error of px (engine.pip.points_in_polygon_band)."""
    if _device_of(px, "pip_band") == "cpu":
        return pip_band_plain(px, py, x1, y1, x2, y2, eps)
    if px.shape[0] == 0:  # nothing to launch
        return torch.zeros(0, dtype=torch.bool, device=px.device)
    out = _launch("pip_band", px, py, x1, y1, x2, y2, float(eps))
    count_launch(pip_band)
    return out


pip_band.launches = 0


def points_in_polygon_np_edges(px, py, x1, y1, x2, y2) -> np.ndarray:
    """NumPy f64 oracle over an explicit edge table (same edge rule),
    over point chunks so the [chunk, E] temporaries stay bounded."""
    px = np.asarray(px, np.float64)
    py = np.asarray(py, np.float64)
    x1 = np.asarray(x1, np.float64)[None, :]
    y1 = np.asarray(y1, np.float64)[None, :]
    x2 = np.asarray(x2, np.float64)[None, :]
    y2 = np.asarray(y2, np.float64)[None, :]
    den = np.where(y2 == y1, 1.0, y2 - y1)
    out = np.zeros(len(px), bool)
    step = max(1, _PLAIN_CHUNK_ELEMS // 4 // max(x1.shape[1], 1))
    for s in range(0, len(px), step):
        qx = px[s:s + step, None]
        qy = py[s:s + step, None]
        cond = (y1 <= qy) != (y2 <= qy)
        xc = x1 + (qy - y1) / den * (x2 - x1)
        out[s:s + step] = (np.sum(cond & (xc > qx), axis=1) % 2) == 1
    return out
