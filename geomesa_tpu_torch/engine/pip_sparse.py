"""Sparse pair-list point-in-polygon-LAYER: the config-2 spatial join.

The counterpart of the reference package's `engine/pip_sparse.py`
(`Within()` over an admin-boundary polygon layer x point events). The
host structures are copied from it unchanged, so both packages build the
same pair list, array for array, and the same `.npz` prep:

  - points are cut into POINT_TILE-point tiles in store (Z) order, the
    edge table is padded so each polygon fills whole EDGE_TILE-edge
    tiles (degenerate y = BIG edges never cross and never flag);
  - `build_pairs` keeps a (point tile, edge tile) pair when the edge
    tile's polygon bbox meets the point tile's bbox, the edge tile
    y-overlaps it and is not entirely left of it. Whole polygons are
    dropped together, so a closed ring's parity is never split.

The device kernels (`pip_sparse_kernels.py`, built from
`kernels/pip_layer.cu`) count crossings and f32 ambiguity-band flags over
the pairs: B6 per covered point tile for the union (`pip_layer`), B7 with
per-polygon parity for the relation join (`pip_layer_assign`,
`pip_layer_join`), and B8 (crossings) and B9 (band flags) per point tile
over a pair list in any order (`pip_layer_sparse`). Flagged
points are re-decided in f64 on the host over the same pair list.

Union semantics: total crossing parity equals point-in-union for
DISJOINT polygons (admin boundaries). Holes are interior rings in the
same table. Overlapping polygons need per-polygon parity: the assignment
function's count reports them.

What the TPU forced and the port drops: the capacity classes, the SMEM
budgets (`MAX_ETAB_SLOTS`, `MAX_PAIRS_PER_CALL`), the appended all-BIG
dummy edge tile and the pow2 tile padding. One launch covers every
covered tile. Entry points take `device=None` (the card) where the reference
takes `interpret`.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.engine.device import fetch, resolve_device
from geomesa_tpu_torch.engine.pip_sparse_kernels import (
    pair_csr, pip_assign, pip_grouped, pip_pairs_band, pip_pairs_count)

POINT_TILE = 512
EDGE_TILE = 512
BIG = 1e9  # degenerate-edge y (never crosses, never near a real point)


class PairList(NamedTuple):
    """Host-built sparse join structure (all numpy)."""

    pair_pt: np.ndarray     # [M] point-tile id per pair (sorted)
    pair_et: np.ndarray     # [M] edge-tile id per pair
    first: np.ndarray       # [M] 1 where a new point tile starts
    covered: np.ndarray     # [n_ptiles] bool: tile appears in >=1 pair
    n_ptiles: int
    n_etiles: int


def _group_ids(ids: np.ndarray):
    """(unique_ids, counts, order): group ANY int id array (sparse,
    large, unsorted) with an O(n) run-length fast path for already-sorted
    input. `order` sorts ids grouped (slice(None) when already sorted)."""
    ids = np.asarray(ids, np.int64)
    if bool((np.diff(ids) >= 0).all()):
        order = slice(None)
        s = ids
    else:
        order = np.argsort(ids, kind="stable")
        s = ids[order]
    if not len(s):
        return s, np.zeros(0, np.int64), order
    starts = np.concatenate([[0], np.nonzero(np.diff(s))[0] + 1])
    counts = np.diff(np.concatenate([starts, [len(s)]]))
    return s[starts], counts, order


def pad_polygon_edges(
    x1, y1, x2, y2, poly_of_edge
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad the concatenated oriented edge table so each polygon occupies
    whole EDGE_TILE tiles (degenerate BIG edges fill the tail). Returns
    (x1, y1, x2, y2, poly_of_tile [n_etiles] — ORIGINAL polygon ids)."""
    poly_of_edge = np.asarray(poly_of_edge, np.int64)
    pids, counts, order = _group_ids(poly_of_edge)
    padded_counts = -(-counts // EDGE_TILE) * EDGE_TILE
    total = int(padded_counts.sum())
    starts = np.concatenate([[0], np.cumsum(padded_counts)[:-1]])
    # destination of each (pid-sorted) edge = its polygon's padded start
    # + rank within the polygon
    src_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(poly_of_edge)) - np.repeat(src_starts, counts)
    dest = np.repeat(starts, counts) + rank
    outs = []
    for arr, fill in zip((x1, y1, x2, y2), (0.0, BIG, 0.0, BIG)):
        # x slots of degenerate edges are dead (the y test gates them out)
        # but hold finite values for the f64 refine and the f32 upload
        buf = np.full(total, fill, np.float64)
        buf[dest] = np.asarray(arr, np.float64)[order]
        outs.append(buf)
    tiles_per = padded_counts // EDGE_TILE
    poly_of_tile = np.repeat(pids, tiles_per)
    return (*outs, poly_of_tile)


def _cumsum0(counts):
    return np.concatenate([[0], np.cumsum(counts)[:-1]])


def _expand_ranges(starts, counts):
    """[sum(counts)] indices: for each i, starts[i] .. starts[i]+counts[i]."""
    total = int(counts.sum())
    rank = np.arange(total) - np.repeat(_cumsum0(counts), counts)
    return np.repeat(starts, counts) + rank


def build_pairs(
    ptile_bbox: np.ndarray,   # [T, 4] xmin,ymin,xmax,ymax per point tile
    etile_bbox: np.ndarray,   # [E, 4] per edge tile (degenerates excluded)
    poly_of_tile: np.ndarray,  # [E] owning polygon per edge tile
    poly_bbox: np.ndarray,    # [P, 4]
    margin: float = 1e-3,
) -> PairList:
    """Bbox-prune (point tile x edge tile) pairs, polygon-atomically.

    Pair (T, et) survives iff bbox(poly(et)) intersects bbox(T) (expanded
    by `margin` for the f32 band) AND et y-overlaps T AND et is not
    entirely LEFT of T (the +x crossing ray can never reach a tile whose
    ex1 < px0; right-side tiles are kept — the ray points at them).
    Sorted by point tile. Vectorized: tiles and polygons expand into
    bucket-grid (cell, id) pairs, a CSR over cells joins them into
    (polygon, tile) candidates, and the per-pair prunes are flat masks."""
    T = ptile_bbox.shape[0]
    E = etile_bbox.shape[0]
    P = poly_bbox.shape[0]
    px0, py0, px1, py1 = (ptile_bbox[:, i] for i in range(4))

    empty = PairList(np.zeros(0, np.int32), np.zeros(0, np.int32),
                     np.ones(0, np.int32), np.zeros(T, bool), T, E)
    if T == 0 or E == 0 or P == 0:
        return empty

    # ---- bucket grid CSR: cell -> point tiles (tiles register in every
    # cell their bbox touches; Z-ordered tiles overwhelmingly span one)
    G = 128
    gx0 = np.clip(((px0 + 180) / 360 * G).astype(np.int64), 0, G - 1)
    gx1 = np.clip(((px1 + 180) / 360 * G).astype(np.int64), 0, G - 1)
    gy0 = np.clip(((py0 + 90) / 180 * G).astype(np.int64), 0, G - 1)
    gy1 = np.clip(((py1 + 90) / 180 * G).astype(np.int64), 0, G - 1)
    w = gx1 - gx0 + 1
    h = gy1 - gy0 + 1
    reps = w * h
    tid = np.repeat(np.arange(T), reps)
    rank = np.arange(int(reps.sum())) - np.repeat(_cumsum0(reps), reps)
    wrep = np.repeat(w, reps)
    cell = ((np.repeat(gx0, reps) + rank % wrep) * G
            + np.repeat(gy0, reps) + rank // wrep)
    order = np.argsort(cell, kind="stable")
    cell_s, tile_s = cell[order], tid[order]
    cell_lo = np.searchsorted(cell_s, np.arange(G * G))
    cell_hi = np.searchsorted(cell_s, np.arange(G * G) + 1)

    # ---- polygons -> covered cells (both ends clamped INTO the grid so
    # out-of-domain bboxes still query the edge cells)
    bx0, by0, bx1, by1 = (poly_bbox[:, i] for i in range(4))
    cx_lo = np.minimum(
        np.maximum(((bx0 - margin + 180) / 360 * G).astype(np.int64), 0),
        G - 1)
    cx_hi = np.maximum(
        np.minimum(((bx1 + margin + 180) / 360 * G).astype(np.int64), G - 1),
        0)
    cy_lo = np.minimum(
        np.maximum(((by0 - margin + 90) / 180 * G).astype(np.int64), 0),
        G - 1)
    cy_hi = np.maximum(
        np.minimum(((by1 + margin + 90) / 180 * G).astype(np.int64), G - 1),
        0)
    pw = cx_hi - cx_lo + 1
    ph = cy_hi - cy_lo + 1
    preps = pw * ph
    pid_c = np.repeat(np.arange(P), preps)
    prank = np.arange(int(preps.sum())) - np.repeat(_cumsum0(preps), preps)
    pwrep = np.repeat(pw, preps)
    pcell = ((np.repeat(cx_lo, preps) + prank % pwrep) * G
             + np.repeat(cy_lo, preps) + prank // pwrep)

    # ---- CSR join: (polygon, cell) -> candidate (polygon, tile)
    cnt = cell_hi[pcell] - cell_lo[pcell]
    if cnt.sum() == 0:
        return empty
    cand_poly = np.repeat(pid_c, cnt)
    cand_tile = tile_s[_expand_ranges(cell_lo[pcell], cnt)]
    # dedupe (a tile can reach one polygon through several cells)
    key = np.unique(cand_poly.astype(np.int64) * T + cand_tile)
    cand_poly = (key // T).astype(np.int64)
    cand_tile = (key % T).astype(np.int64)

    # ---- polygon-bbox x tile-bbox filter
    hit = (
        (px1[cand_tile] >= bx0[cand_poly] - margin)
        & (px0[cand_tile] <= bx1[cand_poly] + margin)
        & (py1[cand_tile] >= by0[cand_poly] - margin)
        & (py0[cand_tile] <= by1[cand_poly] + margin)
    )
    cand_poly, cand_tile = cand_poly[hit], cand_tile[hit]
    if not len(cand_poly):
        return empty

    # ---- expand each surviving (polygon, tile) over the polygon's edge
    # tiles (contiguous in poly_of_tile: pad_polygon_edges emits
    # pid-sorted tiles)
    et_lo = np.searchsorted(poly_of_tile, cand_poly, side="left")
    et_hi = np.searchsorted(poly_of_tile, cand_poly, side="right")
    ecnt = et_hi - et_lo
    pair_pt = np.repeat(cand_tile, ecnt)
    pair_et = _expand_ranges(et_lo, ecnt)

    # ---- per-pair y-overlap + not-entirely-left prune (degenerate-only
    # tiles carry +-inf bboxes and fail the y test)
    ex1b = etile_bbox[pair_et, 2]
    ey0b = etile_bbox[pair_et, 1]
    ey1b = etile_bbox[pair_et, 3]
    keep = (
        (py1[pair_pt] >= ey0b - margin) & (py0[pair_pt] <= ey1b + margin)
        & (px0[pair_pt] <= ex1b + margin)
    )
    pt = pair_pt[keep]
    et = pair_et[keep]

    order = np.argsort(pt, kind="stable")
    pt, et = pt[order], et[order]
    first = np.ones(len(pt), np.int32)
    first[1:] = (pt[1:] != pt[:-1]).astype(np.int32)
    covered = np.zeros(T, bool)
    covered[pt] = True
    return PairList(pt.astype(np.int32), et.astype(np.int32), first,
                    covered, T, E)


def _tile_pair_csr(pl_: "PairList"):
    """CSR view of the (pt-sorted) pair list: (tiles [K], starts [K+1])
    so tile tiles[i]'s edge tiles are pair_et[starts[i]:starts[i+1]]."""
    pt = np.asarray(pl_.pair_pt, np.int64)
    s = np.nonzero(np.asarray(pl_.first))[0]
    return pt[s], np.concatenate([s, [len(pt)]])


def _ets_of_tile(pl_, tiles, starts, ptid: int) -> np.ndarray:
    k = int(np.searchsorted(tiles, ptid))
    if k >= len(tiles) or tiles[k] != ptid:
        return np.zeros(0, np.int64)
    return np.asarray(pl_.pair_et[starts[k]: starts[k + 1]], np.int64)


class LayerPrep(NamedTuple):
    """Everything the layer kernels need, host-built once per (point
    batch, layer): the prepared-geometry analog."""

    pxp: np.ndarray
    pyp: np.ndarray
    ex1: np.ndarray
    ey1: np.ndarray
    ex2: np.ndarray
    ey2: np.ndarray
    pairs: PairList
    n_ptiles: int
    n_etiles: int


def prepare_layer(
    px_np, py_np, x1, y1, x2, y2, poly_of_edge, margin: float = 1e-3
) -> LayerPrep:
    """Z-tile the points, polygon-pad the edges, bbox-prune pairs."""
    n = len(px_np)
    npad = (-n) % POINT_TILE
    pxp = np.concatenate([px_np, np.full(npad, 1e8)])
    pyp = np.concatenate([py_np, np.full(npad, 1e8)])
    n_ptiles = len(pxp) // POINT_TILE
    tx = pxp.reshape(n_ptiles, POINT_TILE)
    ty = pyp.reshape(n_ptiles, POINT_TILE)
    ptile_bbox = np.stack(
        [tx.min(1), ty.min(1), tx.max(1), ty.max(1)], 1
    )
    # padded tail tile bbox is at 1e8: never intersects a polygon

    ex1, ey1, ex2, ey2, poly_of_tile = pad_polygon_edges(
        x1, y1, x2, y2, poly_of_edge
    )
    n_etiles = len(ex1) // EDGE_TILE
    tiles = lambda a: a.reshape(n_etiles, EDGE_TILE)  # noqa: E731
    real = tiles(ey1) < BIG / 2  # degenerate edges excluded from bboxes

    def _bb(a, lo):
        v = np.where(real, tiles(a), np.inf if lo else -np.inf)
        return v.min(1) if lo else v.max(1)

    etile_bbox = np.stack([
        _bb(np.minimum(ex1, ex2), True), _bb(np.minimum(ey1, ey2), True),
        _bb(np.maximum(ex1, ex2), False), _bb(np.maximum(ey1, ey2), False),
    ], 1)
    # per-polygon bboxes via reduceat over pid-sorted edges; the bbox
    # table and build_pairs work in DENSE RANK space (0..P-1), so
    # sparse/large polygon ids never size an array
    poe = np.asarray(poly_of_edge, np.int64)
    pids, counts, order = _group_ids(poe)
    bounds = np.concatenate([[0], np.cumsum(counts)[:-1]])
    exmin = np.minimum(x1, x2)[order]
    eymin = np.minimum(y1, y2)[order]
    exmax = np.maximum(x1, x2)[order]
    eymax = np.maximum(y1, y2)[order]
    poly_bbox = np.stack([
        np.minimum.reduceat(exmin, bounds),
        np.minimum.reduceat(eymin, bounds),
        np.maximum.reduceat(exmax, bounds),
        np.maximum.reduceat(eymax, bounds),
    ], 1)
    pot_rank = np.searchsorted(pids, poly_of_tile)
    pairs = build_pairs(
        ptile_bbox, etile_bbox, pot_rank, poly_bbox, margin=margin
    )
    return LayerPrep(pxp, pyp, ex1, ey1, ex2, ey2, pairs,
                     n_ptiles, n_etiles)


def _poly_of_tile_from(prep: "LayerPrep", poly_of_edge):
    """(rank_of_tile [n_etiles], unique_ids [P]): per-edge-tile polygon
    RANKS (dense 0..P-1: the i32 kernel encoding and every internal group
    key use ranks, so sparse/large ids neither overflow nor size arrays)
    plus the rank -> original-id mapping for outputs."""
    pids, counts, _ = _group_ids(np.asarray(poly_of_edge, np.int64))
    tiles_per = -(-counts // EDGE_TILE)
    return np.repeat(np.arange(len(pids)), tiles_per), pids


# --- f64 refines (host, exact) ---------------------------------------------


def _refine_band_f64(px_np, py_np, ex1, ey1, ex2, ey2, pl_, inside, flagged):
    """Exact f64 re-evaluation of band-flagged points over the SAME pair
    candidate set, vectorized per point tile ([pts-in-tile, E] ops).
    Mutates `inside` in place; returns the refined count."""
    refined = 0
    csr_tiles, csr_starts = _tile_pair_csr(pl_)
    by_tile: dict = {}
    for i in flagged:
        by_tile.setdefault(i // POINT_TILE, []).append(i)
    for ptid, idxs in by_tile.items():
        ets = _ets_of_tile(pl_, csr_tiles, csr_starts, ptid)
        ii = np.asarray(idxs)
        if not len(ets):
            inside[ii] = False
            continue
        sl = np.concatenate(
            [np.arange(e * EDGE_TILE, (e + 1) * EDGE_TILE) for e in ets]
        )
        a1, b1 = ex1[sl], ey1[sl]
        a2, b2 = ex2[sl], ey2[sl]
        pxi = px_np[ii][:, None]
        pyi = py_np[ii][:, None]
        condx = (b1[None, :] <= pyi) != (b2[None, :] <= pyi)
        tt = (pyi - b1[None, :]) / np.where(b2 == b1, 1.0, b2 - b1)[None, :]
        xc = a1[None, :] + tt * (a2 - a1)[None, :]
        inside[ii] = (np.sum(condx & (xc > pxi), axis=1) % 2) == 1
        refined += len(ii)
    return refined


def _multi_assign_f64(idx, px_np, py_np, prep, poly_of_tile):
    """Exact f64 enumeration of EVERY containing polygon for the given
    points (the overlap path of pip_layer_join)."""
    pl_ = prep.pairs
    ex1, ey1, ex2, ey2 = prep.ex1, prep.ey1, prep.ex2, prep.ey2
    csr_tiles, csr_starts = _tile_pair_csr(pl_)
    out_pt = []
    out_poly = []
    by_tile: dict = {}
    for i in idx:
        by_tile.setdefault(i // POINT_TILE, []).append(i)
    for ptid, pts in by_tile.items():
        ets = _ets_of_tile(pl_, csr_tiles, csr_starts, int(ptid))
        if not len(ets):
            continue
        pids = poly_of_tile[ets]
        ii = np.asarray(pts)
        pxi = px_np[ii][:, None]
        pyi = py_np[ii][:, None]
        for pid in np.unique(pids):
            sl = np.concatenate([
                np.arange(e * EDGE_TILE, (e + 1) * EDGE_TILE)
                for e in ets[pids == pid]
            ])
            a1, b1 = ex1[sl], ey1[sl]
            a2, b2 = ex2[sl], ey2[sl]
            condx = (b1[None] <= pyi) != (b2[None] <= pyi)
            tt = (pyi - b1[None]) / np.where(b2 == b1, 1.0, b2 - b1)[None]
            xc = a1[None] + tt * (a2 - a1)[None]
            inside = (np.sum(condx & (xc > pxi), 1) % 2) == 1
            hit = ii[inside]
            out_pt.append(hit)
            out_poly.append(np.full(len(hit), pid, np.int64))
    if not out_pt:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(out_pt), np.concatenate(out_poly)


def _refine_assign_f64(idx, poly_id, count, px_np, py_np, prep,
                       poly_of_tile):
    """Exact f64 per-polygon parity for the given point indices, over the
    pair list's candidate polygons of each point's tile."""
    pl_ = prep.pairs
    ex1, ey1, ex2, ey2 = prep.ex1, prep.ey1, prep.ex2, prep.ey2
    csr_tiles, csr_starts = _tile_pair_csr(pl_)
    by_tile: dict = {}
    for i in idx:
        by_tile.setdefault(i // POINT_TILE, []).append(i)
    poly_id = poly_id.copy()
    count = count.copy()
    for ptid, pts in by_tile.items():
        ets = _ets_of_tile(pl_, csr_tiles, csr_starts, int(ptid))
        ii = np.asarray(pts)
        if not len(ets):
            poly_id[ii] = -1
            count[ii] = 0
            continue
        pids = poly_of_tile[ets]
        pxi = px_np[ii][:, None]
        pyi = py_np[ii][:, None]
        acc_id = np.full(len(ii), -1, np.int64)
        acc_n = np.zeros(len(ii), np.int64)
        for pid in np.unique(pids):
            sl = np.concatenate([
                np.arange(e * EDGE_TILE, (e + 1) * EDGE_TILE)
                for e in ets[pids == pid]
            ])
            a1, b1 = ex1[sl], ey1[sl]
            a2, b2 = ex2[sl], ey2[sl]
            condx = (b1[None] <= pyi) != (b2[None] <= pyi)
            tt = (pyi - b1[None]) / np.where(b2 == b1, 1.0, b2 - b1)[None]
            xc = a1[None] + tt * (a2 - a1)[None]
            inside = (np.sum(condx & (xc > pxi), 1) % 2) == 1
            acc_id = np.where(inside, pid, acc_id)
            acc_n += inside
        poly_id[ii] = np.where(acc_n == 1, acc_id, -1)
        count[ii] = acc_n
    return poly_id, count


# --- LayerPrep persistence ---------------------------------------------------
# The pair list is (point batch x layer)-intrinsic state, like a
# prepared-geometry cache: content-addressed on the input arrays, persisted
# as one .npz with the reference's keys (either package loads the other's),
# with a small in-process LRU in front.

_PREP_MEM_CACHE: "dict[str, LayerPrep]" = {}
_PREP_MEM_MAX = 4
# bytes cap so one-shot joins over big batches cannot pin multi-GB padded
# copies for the process lifetime; the entry just built is always
# admitted — eviction only sheds OLDER entries
_PREP_MEM_MAX_BYTES = 512 << 20
_PREP_LOCK = threading.Lock()


def _prep_nbytes(prep: LayerPrep) -> int:
    return sum(a.nbytes for a in prep[:6]) + sum(
        a.nbytes for a in prep.pairs[:4])


def _prep_cache_put(key: str, prep: LayerPrep) -> None:
    with _PREP_LOCK:
        _PREP_MEM_CACHE[key] = prep
        while len(_PREP_MEM_CACHE) > 1 and (
            len(_PREP_MEM_CACHE) > _PREP_MEM_MAX
            or sum(map(_prep_nbytes, _PREP_MEM_CACHE.values()))
            > _PREP_MEM_MAX_BYTES
        ):
            oldest = next(iter(_PREP_MEM_CACHE))
            if oldest == key:  # never evict the entry just inserted
                break
            _PREP_MEM_CACHE.pop(oldest)


def layer_prep_key(px_np, py_np, x1, y1, x2, y2, poly_of_edge,
                   margin: float = 1e-3) -> str:
    """Content fingerprint of (point batch, polygon layer, tiling
    constants): sha1 over the raw bytes, with the reference's suffix, so
    both packages key the same inputs alike."""
    import hashlib

    h = hashlib.sha1()
    for a in (px_np, py_np, x1, y1, x2, y2, poly_of_edge):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(f"m{margin};pt{POINT_TILE};et{EDGE_TILE};v1".encode())
    return h.hexdigest()


def save_layer_prep(prep: LayerPrep, path: str) -> None:
    import os

    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(
                f,
                pxp=prep.pxp, pyp=prep.pyp,
                ex1=prep.ex1, ey1=prep.ey1, ex2=prep.ex2, ey2=prep.ey2,
                pair_pt=prep.pairs.pair_pt, pair_et=prep.pairs.pair_et,
                first=prep.pairs.first, covered=prep.pairs.covered,
                scalars=np.asarray(
                    [prep.n_ptiles, prep.n_etiles,
                     prep.pairs.n_ptiles, prep.pairs.n_etiles], np.int64),
            )
        os.replace(tmp, path)
    except BaseException:
        # never leave a partial multi-hundred-MB tmp behind
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_layer_prep(path: str) -> LayerPrep:
    with np.load(path, allow_pickle=False) as z:
        sc = z["scalars"]
        return LayerPrep(
            z["pxp"], z["pyp"], z["ex1"], z["ey1"], z["ex2"], z["ey2"],
            PairList(z["pair_pt"], z["pair_et"], z["first"], z["covered"],
                     int(sc[2]), int(sc[3])),
            int(sc[0]), int(sc[1]),
        )


def prepare_layer_cached(
    px_np, py_np, x1, y1, x2, y2, poly_of_edge,
    margin: float = 1e-3, cache_dir: "str | None" = None,
    key: "str | None" = None,
) -> LayerPrep:
    """prepare_layer behind a content-addressed cache: in-process LRU
    first, then `cache_dir` (or the geomesa.spatial.prep.cache.dir system
    property; empty = memory only) on disk. A corrupt/unreadable disk
    entry falls through to a rebuild. `key` may carry a precomputed
    layer_prep_key to skip re-hashing the inputs."""
    import os

    from geomesa_tpu_torch.utils.config import SystemProperties

    if key is None:
        key = layer_prep_key(
            px_np, py_np, x1, y1, x2, y2, poly_of_edge, margin)
    with _PREP_LOCK:
        hit = _PREP_MEM_CACHE.get(key)
        if hit is not None:
            # true LRU: refresh recency (eviction pops insertion order)
            _PREP_MEM_CACHE.pop(key)
            _PREP_MEM_CACHE[key] = hit
    if hit is not None:
        return hit
    if cache_dir is None:
        cache_dir = str(SystemProperties.SPATIAL_PREP_CACHE_DIR.get()) or None
    path = os.path.join(cache_dir, f"layerprep_{key}.npz") if cache_dir else None
    prep = None
    if path and os.path.exists(path):
        try:
            prep = load_layer_prep(path)
        except Exception:
            prep = None
    if prep is None:
        prep = prepare_layer(px_np, py_np, x1, y1, x2, y2, poly_of_edge,
                             margin=margin)
        if path:
            try:
                os.makedirs(cache_dir, exist_ok=True)
                save_layer_prep(prep, path)
            except OSError:
                pass
    _prep_cache_put(key, prep)
    return prep


def prepare_layer_async(
    px_np, py_np, x1, y1, x2, y2, poly_of_edge,
    margin: float = 1e-3, cache_dir: "str | None" = None,
    key: "str | None" = None,
):
    """Start the (cached) prep build on a worker thread so the caller can
    overlap it with work that does not need pairs (the point upload).
    Returns a 0-arg callable that joins and yields the LayerPrep. The
    build is NumPy, which releases the GIL for its big vector ops."""
    out: dict = {}

    def work():
        try:
            out["prep"] = prepare_layer_cached(
                px_np, py_np, x1, y1, x2, y2, poly_of_edge,
                margin=margin, cache_dir=cache_dir, key=key)
        except BaseException as e:  # re-raise on join
            out["err"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()

    def result() -> LayerPrep:
        t.join()
        if "err" in out:
            raise out["err"]
        return out["prep"]

    return result


# --- device entry points ----------------------------------------------------


def _f32(a, dev: torch.device) -> torch.Tensor:
    """f32 contiguous tensor on `dev` (host arrays are cast on the host
    before the copy, as `to_device` does)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def _i32(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def upload_points(px_np, py_np, device=None):
    """The padded f32 point tiles on the device (`points_device` of the
    entry points): px/py padded with 1e8 to whole POINT_TILE tiles, exactly as
    `prepare_layer` pads them, so it can run before the prep exists."""
    dev = resolve_device(device)
    npad = (-len(px_np)) % POINT_TILE
    return tuple(_f32(np.concatenate([np.asarray(a, np.float64),
                                      np.full(npad, 1e8)]), dev)
                 for a in (px_np, py_np))


def upload_edges(prep: LayerPrep, device=None):
    """The padded f32 edge table on the device (`edges_device` of the
    entry points): (x1, y1, x2, y2), n_etiles * EDGE_TILE each."""
    dev = resolve_device(device)
    return tuple(_f32(a, dev) for a in (prep.ex1, prep.ey1, prep.ex2, prep.ey2))


def pip_layer_grouped(
    px, py, x1, y1, x2, y2, pair_pt, pair_et,
    n_ptiles: int = 0, n_etiles: int = 0, eps: float = 1e-4, device=None,
):
    """Grouped-by-point-tile execution of the pair list (B6): one launch
    over every covered point tile. Points [n_ptiles * POINT_TILE] and the
    padded edges [n_etiles * EDGE_TILE] may be tensors or arrays (cast to
    f32 on `device`). Returns DEVICE tensors (counts, band), int32
    [n_ptiles * POINT_TILE], zero on uncovered tiles."""
    dev = resolve_device(device)
    if not len(pair_pt):
        z = torch.zeros(n_ptiles * POINT_TILE, dtype=torch.int32, device=dev)
        return z, z.clone()
    csr = pair_csr(pair_pt, pair_et)
    counts, band = pip_grouped(
        *[_f32(a, dev) for a in (px, py, x1, y1, x2, y2)],
        *[_i32(a, dev) for a in csr[:3]], n_ptiles=n_ptiles, eps=eps)
    return counts.reshape(-1), band.reshape(-1)


def _device_layer(prep, dev, points_device, edges_device):
    if points_device is None:
        points_device = (_f32(prep.pxp, dev), _f32(prep.pyp, dev))
    if edges_device is None:
        edges_device = upload_edges(prep, dev)
    return tuple(points_device), tuple(edges_device)


def pip_layer(
    px_np: np.ndarray,
    py_np: np.ndarray,
    x1: np.ndarray,
    y1: np.ndarray,
    x2: np.ndarray,
    y2: np.ndarray,
    poly_of_edge: np.ndarray,
    eps: float = 1e-4,
    device=None,
    refine_f64: bool = True,
    prep: "LayerPrep | None" = None,
    points_device=None,
    edges_device=None,
):
    """End-to-end: prepare_layer + the union kernel (B6) + f64 band
    refinement. Returns (inside bool [N], info dict).

    Points are assumed Z/store-ordered (tile bboxes are only tight then);
    correctness holds for any order. `points_device` optionally supplies
    the padded point tensors already on the device (`upload_points`, run
    while an async prep builds), `edges_device` the padded f32 edge table
    (`upload_edges`); without them this call uploads both. The host
    refine reads px_np/py_np. The kernel's outputs come back in one
    fetch."""
    n = len(px_np)
    dev = resolve_device(device)
    if prep is None:
        prep = prepare_layer(px_np, py_np, x1, y1, x2, y2, poly_of_edge)
    ex1, ey1, ex2, ey2 = prep.ex1, prep.ey1, prep.ex2, prep.ey2
    n_ptiles, n_etiles = prep.n_ptiles, prep.n_etiles
    pl_ = prep.pairs

    if len(pl_.pair_pt) == 0:
        # same info keys as the normal return
        return np.zeros(n, bool), {"pairs": 0, "refined": 0,
                                   "n_ptiles": n_ptiles,
                                   "n_etiles": n_etiles,
                                   "flagged": 0, "refine_s": 0.0}

    pts, edges = _device_layer(prep, dev, points_device, edges_device)
    counts, band = fetch(*pip_layer_grouped(
        *pts, *edges, pl_.pair_pt, pl_.pair_et,
        n_ptiles=n_ptiles, n_etiles=n_etiles, eps=eps, device=dev))
    inside = (counts[:n] % 2) == 1
    flagged = np.nonzero(band[:n] > 0)[0]

    refined = 0
    refine_s = 0.0
    if refine_f64 and len(flagged):
        t0 = time.perf_counter()
        refined = _refine_band_f64(
            px_np, py_np, ex1, ey1, ex2, ey2, pl_, inside, flagged)
        refine_s = time.perf_counter() - t0
    return inside, {
        "pairs": int(len(pl_.pair_pt)), "refined": refined,
        "n_ptiles": n_ptiles, "n_etiles": n_etiles,
        "flagged": int(len(flagged)), "refine_s": round(refine_s, 3),
    }


def pip_layer_sharded(
    mesh,
    px_np: np.ndarray,
    py_np: np.ndarray,
    x1: np.ndarray,
    y1: np.ndarray,
    x2: np.ndarray,
    y2: np.ndarray,
    poly_of_edge: np.ndarray,
    eps: float = 1e-4,
    refine_f64: bool = True,
    prep: "LayerPrep | None" = None,
):
    """The polygon-layer join over a device mesh: the point tiles are
    sharded (shard i holds tiles [i*T, (i+1)*T), T = ceil(tiles / D), the
    last shard padded with 1e8 points), the padded edge table rides
    replicated (every shard's device holds a copy). Each shard runs B6
    once (`pip_layer_grouped`) over a CSR of ITS pairs with local tile
    ids, then the same host parity finish and f64 band refine as
    `pip_layer`. Returns (inside bool [N], info): the reference's
    `pip_layer_sharded` keys, `cap` the pow2 class of the most pairs a
    tile (the reference's one capacity class; B6 needs none). On a mesh
    that spans processes each process runs its own shards and the
    per-shard counts and band flags are all-gathered (`parallel.mesh.
    exchange`), so every process returns the whole answer, as the
    reference's replicated result."""
    from geomesa_tpu_torch.parallel.mesh import exchange, my_shards, on_shard

    n = len(px_np)
    if prep is None:
        prep = prepare_layer(px_np, py_np, x1, y1, x2, y2, poly_of_edge)
    pl_ = prep.pairs
    ex1, ey1, ex2, ey2 = prep.ex1, prep.ey1, prep.ex2, prep.ey2
    n_etiles = prep.n_etiles
    d = mesh.size
    if len(pl_.pair_pt) == 0:
        return np.zeros(n, bool), {
            "pairs": 0, "refined": 0, "n_ptiles": prep.n_ptiles,
            "n_etiles": n_etiles, "flagged": 0, "cap": 0, "shards": d}
    nt = prep.n_ptiles
    tpd = -(-nt // d)
    pt = np.asarray(pl_.pair_pt, np.int64)
    et = np.asarray(pl_.pair_et, np.int64)
    most = int(np.bincount(pt).max())
    cap = max(4, 1 << int(np.ceil(np.log2(max(most, 1)))))
    pad_pts = tpd * d * POINT_TILE - len(prep.pxp)
    pxp = np.concatenate([prep.pxp, np.full(pad_pts, 1e8)])
    pyp = np.concatenate([prep.pyp, np.full(pad_pts, 1e8)])
    outs = []
    for i, dev in my_shards(mesh):
        lo, hi = i * tpd, (i + 1) * tpd
        mine = (pt >= lo) & (pt < hi)
        rows = slice(lo * POINT_TILE, hi * POINT_TILE)
        with on_shard(dev):
            outs.append(pip_layer_grouped(
                pxp[rows], pyp[rows], ex1, ey1, ex2, ey2, pt[mine] - lo,
                et[mine], n_ptiles=tpd, n_etiles=n_etiles, eps=eps,
                device=dev))
    got = fetch(*exchange(mesh, [o[0] for o in outs]),
                *exchange(mesh, [o[1] for o in outs]))
    counts = np.concatenate(got[:d])
    band = np.concatenate(got[d:])
    inside = (counts[:n] % 2) == 1
    flagged = np.nonzero(band[:n] > 0)[0]
    refined = 0
    if refine_f64 and len(flagged):
        refined = _refine_band_f64(
            px_np, py_np, ex1, ey1, ex2, ey2, pl_, inside, flagged)
    return inside, {
        "pairs": int(len(pt)), "refined": refined, "n_ptiles": nt,
        "n_etiles": n_etiles, "flagged": int(len(flagged)), "cap": cap,
        "shards": d}


def pip_layer_assign(
    px_np: np.ndarray,
    py_np: np.ndarray,
    x1: np.ndarray,
    y1: np.ndarray,
    x2: np.ndarray,
    y2: np.ndarray,
    poly_of_edge: np.ndarray,
    eps: float = 1e-4,
    device=None,
    refine_f64: bool = True,
    prep: "LayerPrep | None" = None,
    poly_of_tile: "tuple | None" = None,
    points_device=None,
    edges_device=None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Point -> polygon ASSIGNMENT over the layer (the relation-join /
    JoinProcess result shape): returns (poly_id [N] — containing polygon
    id, -1 outside every polygon, count [N] int32 — how many polygons
    contain the point (==1 for disjoint layers; >1 reveals overlap, where
    poly_id is -1), info dict). Band-flagged points are re-evaluated in
    f64 per candidate polygon on the host (exact assignment).

    One launch of the per-polygon kernel (B7) covers every covered tile,
    however many edge tiles its row holds, so no row is ever left to the
    host: info["host_rows"] is always 0 (the reference's TPU budget sent
    rows wider than its scalar memory to an exact host pass; the key
    stays for callers that read it). `points_device`/`edges_device` as
    in `pip_layer`."""
    n = len(px_np)
    dev = resolve_device(device)
    if prep is None:
        prep = prepare_layer(px_np, py_np, x1, y1, x2, y2, poly_of_edge)
    pl_ = prep.pairs
    n_ptiles, n_etiles = prep.n_ptiles, prep.n_etiles
    if len(pl_.pair_pt) == 0:
        return (np.full(n, -1, np.int32), np.zeros(n, np.int32),
                {"pairs": 0, "refined": 0})

    # polygon RANKS per edge tile + rank->id mapping (_poly_of_tile_from);
    # callers holding one (pip_layer_join) pass it
    if poly_of_tile is None:
        poly_of_tile, poly_uids = _poly_of_tile_from(prep, poly_of_edge)
    else:
        poly_of_tile, poly_uids = poly_of_tile

    csr = pair_csr(pl_.pair_pt, pl_.pair_et, poly_of_tile=poly_of_tile)
    pts, edges = _device_layer(prep, dev, points_device, edges_device)
    out_a, out_n, out_b = fetch(*pip_assign(
        *pts, *edges, *[_i32(a, dev) for a in csr], n_ptiles=n_ptiles,
        eps=eps))
    assign = out_a.reshape(-1)[:n]
    count = out_n.reshape(-1)[:n]
    band = out_b.reshape(-1)[:n]
    poly_id = np.where(count == 1, assign - 1, -1).astype(np.int32)

    refine_idx = np.nonzero(band > 0)[0] if refine_f64 else (
        np.zeros(0, np.int64))
    refined = 0
    if len(refine_idx):
        poly_id, count = _refine_assign_f64(
            refine_idx, poly_id, count, px_np, py_np, prep, poly_of_tile)
        refined = len(refine_idx)
    # map dense kernel ranks back to the caller's original polygon ids
    out_ids = np.full(n, -1, np.int64)
    valid_a = poly_id >= 0
    out_ids[valid_a] = poly_uids[poly_id[valid_a]]
    return out_ids, count, {
        "pairs": int(len(pl_.pair_pt)), "refined": refined,
        "host_rows": 0,
        "flagged": int((band > 0).sum()),
    }


def pip_layer_join(
    px_np: np.ndarray,
    py_np: np.ndarray,
    x1: np.ndarray,
    y1: np.ndarray,
    x2: np.ndarray,
    y2: np.ndarray,
    poly_of_edge: np.ndarray,
    eps: float = 1e-4,
    device=None,
    prep: "LayerPrep | None" = None,
    points_device=None,
    edges_device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full spatial-join pair emission: returns (point_rows [M],
    polygon_ids [M]) — one row per (point, containing polygon) pair,
    INCLUDING multiplicity for overlapping layers (points contained in
    k polygons emit k pairs, enumerated exactly on the host from the
    pair list's candidates). The SQL `JOIN ... ON st_contains` route."""
    dev = resolve_device(device)
    if prep is None:
        prep = prepare_layer(px_np, py_np, x1, y1, x2, y2, poly_of_edge)
    groups = _poly_of_tile_from(prep, poly_of_edge)
    poly_id, count, _info = pip_layer_assign(
        px_np, py_np, x1, y1, x2, y2, poly_of_edge,
        eps=eps, device=dev, prep=prep, poly_of_tile=groups,
        points_device=points_device, edges_device=edges_device,
    )
    single = np.nonzero(count == 1)[0]
    pt_rows = [single]
    polys = [poly_id[single].astype(np.int64)]
    multi = np.nonzero(count > 1)[0]
    if len(multi):
        mp, mrank = _multi_assign_f64(multi, px_np, py_np, prep,
                                      groups[0])
        pt_rows.append(mp)
        polys.append(groups[1][mrank])  # ranks -> original ids
    return np.concatenate(pt_rows), np.concatenate(polys)


def chunk_pairs(pair_pt, pair_et, cap: Optional[int] = None):
    """Split the (pt-sorted) pair list into chunks of <= cap pairs,
    PREFERRING tile boundaries (None: one chunk). A single tile denser
    than cap is split mid-tile; the partial counts add exactly (crossing
    counts and band flags are both additive)."""
    M = len(pair_pt)
    if cap is None:
        return [(0, M)] if M else []
    chunks = []
    start = 0
    while start < M:
        end = min(start + cap, M)
        if end < M:
            # back off to the last tile boundary if one exists
            back = end
            while back > start and pair_pt[back] == pair_pt[back - 1]:
                back -= 1
            if back > start:
                end = back
        chunks.append((start, end))
        start = end
    return chunks


def pip_layer_sparse(
    px,                     # [n_ptiles * POINT_TILE] padded, tile-ordered
    py,
    x1,                     # [n_etiles * EDGE_TILE] polygon-padded
    y1,
    x2,
    y2,
    pair_pt,                # [M] int32, sorted by point tile
    pair_et,                # [M] int32
    n_ptiles: int = 0,
    n_etiles: int = 0,
    eps: float = 1e-4,
    device=None,
    max_pairs_per_call: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse-pair crossing counts (B8) + boundary-band flags (B9), each
    one walk per point tile over its pairs. Returns host
    arrays (counts int32 [n_ptiles*POINT_TILE], band int32 same shape),
    zero on tiles no pair names. `max_pairs_per_call` cuts the pair list into launches of at
    most that many pairs (`chunk_pairs`; None: one launch each), with the
    same result however it is cut: chunks add into one device
    accumulator, fetched once."""
    dev = resolve_device(device)
    pt_np = np.asarray(pair_pt, np.int32)
    et_np = np.asarray(pair_et, np.int32)
    args = [_f32(a, dev) for a in (px, py, x1, y1, x2, y2)]
    acc_c = acc_b = None
    for s0, s1 in chunk_pairs(pt_np, et_np, cap=max_pairs_per_call):
        seg_pt, seg_et = _i32(pt_np[s0:s1], dev), _i32(et_np[s0:s1], dev)
        cc = pip_pairs_count(*args, seg_pt, seg_et, n_ptiles)
        bb = pip_pairs_band(*args, seg_pt, seg_et, n_ptiles, eps)
        acc_c = cc if acc_c is None else acc_c.add_(cc)
        acc_b = bb if acc_b is None else acc_b.add_(bb)
    if acc_c is None:
        z = np.zeros(n_ptiles * POINT_TILE, np.int32)
        return z, z.copy()
    out_c, out_b = fetch(acc_c[:n_ptiles], acc_b[:n_ptiles])
    return out_c.reshape(-1), out_b.reshape(-1)
