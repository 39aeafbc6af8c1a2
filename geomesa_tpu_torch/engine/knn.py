"""Brute-force kNN on the device: the exact haversine fold, the centred
chord matmul with an exact refine, and kNN over a compacted mask.

The counterpart of the reference package's `engine/knn.py`:

- `knn`          exact kNN, queries in tiles, data in tiles folded into a
                 running top-k: memory O(query_tile * data_tile).
- `knn_mxu`      top-M by the centred chord key (one [Q,4]x[4,N] product
                 a tile, full f32), then exact haversine over the M
                 candidates, with a per-query exactness certificate.
- `knn_compact`  gathers the mask's matches first, then runs either.
- `knn_sharded`, `knn_compact_sharded`: per-shard top-ks over a mesh's
                 row shards, merged on the lead device; `knn_ring` shards
                 the queries too and rotates the data shards past them.

The reference writes these in `jax.jit` over `lax.map`/`lax.scan`, with no
Pallas kernel; here they are plain PyTorch (loops over the same tiles).
The selection primitives `_topk_smallest` and `_twolevel_smallest` also
serve the fused scan (`knn_scan.py`).

NaN order: a stable sort ranks NaN last, and so does the fused scan in
both packages. Inside the reference's jitted haversine fold (and the
grid's gather) XLA folds the negation of `top_k(-d)` into the distance's
constant, so a NaN distance reaches `top_k` with the sign that ranks it
AHEAD of every finite one. `knn` and `knn_grid` mirror that through
`_nan_first`/`_nan_back`: NaN distances rank first, lower index first
among them, and come back as NaN. `knn_mxu`'s chord selection ranks a
NaN key last in the reference as here (no folded negation there).

Tie order: `lax.top_k` breaks ties toward the lower index, and
`torch.topk` promises no order on CUDA. Both selections here take the
first k of a STABLE ascending sort instead, which gives exactly the
lower-index-first rule on every device. The rows sorted are short (at
most m_blocks * 128 lanes, or one minimum per 128 blocks), so the sort
costs little beside the scan.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from geomesa_tpu_torch.engine.geodesy import EARTH_RADIUS_M, haversine_m

# Lanes of one [query_tile, data_tile] distance block when the caller gives
# no data_tile. The reference sizes it at 2^27 lanes for a TPU; on the card
# the haversine's ~10 live temporaries make a block of 2^27 f64 lanes ~10
# GB, so the port takes 2^25 (128 MB a temporary in f32, 256 MB in f64).
# The result does not depend on it but for the order of exact ties.
KNN_BLOCK_LANES = 1 << 25


def _topk_smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest along the last axis -> (values, indices), ascending,
    ties toward the lower index. Fewer than k candidates pad with +inf
    values and index 0 (the reference's padding rule)."""
    kk = min(k, d.shape[-1])
    vals, idx = torch.sort(d, dim=-1, stable=True)
    vals, idx = vals[..., :kk], idx[..., :kk]
    if kk < k:
        pad = list(d.shape[:-1]) + [k - kk]
        vals = torch.cat([vals, vals.new_full(pad, float("inf"))], -1)
        idx = torch.cat([idx, idx.new_zeros(pad)], -1)
    return vals, idx


def _nan_first(d: torch.Tensor) -> torch.Tensor:
    """Selection key that ranks NaN distances first: NaN -> -inf (a
    distance is never -inf, so `_nan_back` restores them), in one pass."""
    inf = float("inf")
    return torch.nan_to_num(d, nan=-inf, posinf=inf, neginf=-inf)


def _nan_back(v: torch.Tensor) -> torch.Tensor:
    return v.masked_fill(v == -float("inf"), float("nan"))


def _twolevel_smallest(
    d: torch.Tensor, m: int, block: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-m smallest over the last axis via two-level block
    selection: the m blocks with the smallest minima hold every true
    top-m element (a block left out would have m elements <= it), so the
    exact top-m over those m*block gathered lanes is the answer."""
    n = d.shape[-1]
    nb = n // block
    if nb * block != n or nb < m or n <= 4 * m:
        return _topk_smallest(d, m)
    lead = d.shape[:-1]
    blk = d.reshape(*lead, nb, block)
    bmin = blk.amin(dim=-1)
    _, bidx = _topk_smallest(bmin, m)  # [..., m] winning blocks
    g = torch.take_along_dim(blk, bidx[..., None], dim=-2)
    vals, within = _topk_smallest(g.reshape(*lead, m * block), m)
    blk_of = torch.take_along_dim(bidx, within // block, dim=-1)
    return vals, blk_of * block + (within % block)


def _unit3(lon: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """[N] lon/lat degrees -> [N, 3] unit vectors on the sphere (f32)."""
    rl = torch.deg2rad(lon.float())
    rt = torch.deg2rad(lat.float())
    c = torch.cos(rt)
    return torch.stack([c * torch.cos(rl), c * torch.sin(rl), torch.sin(rt)], -1)


def knn(qx: torch.Tensor, qy: torch.Tensor, dx: torch.Tensor,
        dy: torch.Tensor, mask: torch.Tensor, k: int,
        query_tile: int = 1024, data_tile: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN: [Q] query points vs [N] masked data points. Returns
    (dists [Q, k] meters, indices [Q, k] int32 into the data arrays);
    masked points get +inf distance (index still in range).

    Each data tile's [query_tile, data_tile] distances fold into a running
    top-k (exact: the global top-k is a subset of the union of the tiles'
    top-ks). The running best comes BEFORE the tile's candidates in the
    pool and the selection is stable, so among equal distances the earlier
    candidate wins, as in the reference. Distances are in the promoted
    dtype of the inputs, at least f32. Each query's result is independent
    of the others, so a query tile holds min(query_tile, Q) rows; the
    default data_tile is sized from query_tile (`KNN_BLOCK_LANES`). A NaN
    distance ranks ahead of every finite one and is returned as NaN, as
    the reference's jitted fold ranks it (module docstring)."""
    q = qx.shape[0]
    n = dx.shape[0]
    if data_tile is None:
        data_tile = max(k, min(n, KNN_BLOCK_LANES // max(query_tile, 1)))
    dist_dtype = torch.promote_types(
        torch.promote_types(qx.dtype, dx.dtype), torch.float32)
    dev = qx.device
    rows = max(1, min(query_tile, q))
    out_d, out_i = [], []
    for q0 in range(0, q, rows):
        tx = qx[q0:q0 + rows, None]
        ty = qy[q0:q0 + rows, None]
        bd = torch.full((tx.shape[0], k), float("inf"), dtype=dist_dtype,
                        device=dev)
        bi = torch.zeros((tx.shape[0], k), dtype=torch.int32, device=dev)
        for base in range(0, n, data_tile):
            dxt = dx[base:base + data_tile]
            dyt = dy[base:base + data_tile]
            mt = mask[base:base + data_tile]
            pad = data_tile - dxt.shape[0]
            if pad:  # the last tile, zero-padded and masked as the reference's
                dxt = torch.nn.functional.pad(dxt, (0, pad))
                dyt = torch.nn.functional.pad(dyt, (0, pad))
                mt = torch.nn.functional.pad(mt, (0, pad))
            d = haversine_m(tx, ty, dxt[None, :], dyt[None, :]).masked_fill(
                ~mt[None, :], float("inf"))
            # bd and ld stay in _nan_first's key form until the output
            ld, li = _twolevel_smallest(_nan_first(d), k)
            # padded lanes carry +inf, but the contract is "index in range"
            gi = torch.clamp(li + base, max=n - 1).to(torch.int32)
            nd, sel = _topk_smallest(torch.cat([bd, ld], 1), k)
            bi = torch.take_along_dim(torch.cat([bi, gi], 1), sel, dim=1)
            bd = nd
        out_d.append(_nan_back(bd))
        out_i.append(bi)
    if not out_d:
        return (torch.full((0, k), float("inf"), dtype=dist_dtype, device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev))
    return torch.cat(out_d), torch.cat(out_i)


def _div_mul(t: torch.Tensor, div: float, mul: float) -> torch.Tensor:
    """`t / div * mul` rounded as the reference's jitted code computes it:
    XLA folds the two constants into one, (1/div) * mul in t's dtype, so
    a value on a cell edge lands in the same cell in both packages."""
    return t * ((torch.ones((), dtype=t.dtype, device=t.device) / div) * mul)


def _morton16(lon: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """Z-order key from 16-bit-quantized lon/lat (int64; the reference's
    uint32 values)."""
    qx = torch.clamp(_div_mul(lon + 180.0, 360.0, 65535.0), 0, 65535).to(torch.int64)
    qy = torch.clamp(_div_mul(lat + 90.0, 180.0, 65535.0), 0, 65535).to(torch.int64)

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(qx) | (spread(qy) << 1)


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 products in full f32 (no TF32) for the call, whatever the
    caller's setting: the certificate's noise model assumes f32 rounding
    (the reference's Precision.HIGHEST)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


_MXU_BLK = 128  # block-minima granularity of knn_mxu's deferred selection
_MXU_BIG = 8.0  # > max chord^2 (4.0): the key of masked pool slots


def knn_mxu(qx: torch.Tensor, qy: torch.Tensor, dx: torch.Tensor,
            dy: torch.Tensor, mask: torch.Tensor, k: int,
            query_tile: int = 64, data_tile: Optional[int] = None,
            margin: Optional[int] = None, with_flags: bool = False,
            presorted: bool = False):
    """kNN by the centred chord key plus an exact refine; same contract
    as `knn`.

    chord^2 = |q-c|^2 + |d-c|^2 - 2 (q-c).(d-c) with c the query tile's
    centroid, so f32 resolution is relative to the tile's spread. Queries
    are Z-ordered (stable sort of `_morton16`) so tiles of `query_tile`
    are compact. Per data tile, one [query_tile, 4] x [4, data_tile]
    product gives the ranking key |d-c|^2 - 2 (q-c).(d-c) (+1e9 where
    masked), reduced to per-128-lane block minima; the M = max(4k, 64)
    winning blocks are re-keyed lane by lane, the top M lanes kept, and
    the final k come from exact haversine over them (in the promoted
    dtype). `with_flags=True` also returns a per-query bool: True when
    the rounding-noise bound cannot prove the result exact (the caller
    re-runs those queries on `knn`). Fewer than 128 queries take `knn`."""
    q = qx.shape[0]
    n = dx.shape[0]
    dev = qx.device
    if q < 128:
        fd, fi = knn(qx, qy, dx, dy, mask, k=k,
                     query_tile=min(query_tile, max(q, 1)), data_tile=data_tile)
        flags = torch.zeros(q, dtype=torch.bool, device=dev)
        return (fd, fi, flags) if with_flags else (fd, fi)
    m = margin if margin is not None else max(4 * k, 64)
    m = min(m, n) if n else m
    if data_tile is None:
        data_tile = max(m, min(n, KNN_BLOCK_LANES // max(query_tile, 1)))
    data_tile = -(-data_tile // _MXU_BLK) * _MXU_BLK

    inv = None
    if not presorted:
        order = torch.argsort(_morton16(qx, qy), stable=True)
        inv = torch.argsort(order, stable=True)
        qx, qy = qx[order], qy[order]

    pad = (-q) % query_tile
    # edge-pad so padded lanes do not drag the tile centroid off-cluster
    qxp = torch.cat([qx, qx[-1:].expand(pad)])
    qyp = torch.cat([qy, qy[-1:].expand(pad)])
    tiles_q = _unit3(qxp, qyp).reshape(-1, query_tile, 3)

    dpad = (-n) % data_tile
    du = _unit3(torch.nn.functional.pad(dx, (0, dpad)),
                torch.nn.functional.pad(dy, (0, dpad)))  # [n + dpad, 3]
    mp = torch.nn.functional.pad(mask, (0, dpad))
    nb_tile = data_tile // _MXU_BLK
    lanes = torch.arange(_MXU_BLK, device=dev)

    chord2, cidx, r2 = [], [], []
    with _full_f32_matmul():
        for tq in tiles_q:
            c = tq.mean(dim=0)
            tqc = tq - c
            nq = (tqc * tqc).sum(-1)  # [query_tile]
            r2_tile = nq.max()  # squared tile radius, for the noise bound
            aug_q = torch.cat([tqc, torch.ones_like(tqc[:, :1])], 1)
            minima = []
            for base in range(0, n + dpad, data_tile):
                dtc = du[base:base + data_tile] - c
                nd = (dtc * dtc).sum(-1)
                ndm = torch.where(mp[base:base + data_tile], nd,
                                  torch.full_like(nd, 1e9))
                aug_d = torch.cat([-2.0 * dtc, ndm[:, None]], 1)
                key = aug_q @ aug_d.T  # [query_tile, data_tile]
                minima.append(key.view(query_tile, nb_tile, _MXU_BLK).amin(-1))
            minima = torch.cat(minima, 1)
            mb = min(m, minima.shape[-1])
            _, blk_ids = _twolevel_smallest(minima, mb)
            # re-key the winning blocks lane by lane (same centred form)
            lane = (blk_ids[:, :, None] * _MXU_BLK + lanes).reshape(query_tile, -1)
            gdc = du[lane] - c  # [query_tile, mb * BLK, 3]
            nd_g = (gdc * gdc).sum(-1)
            s_g = (tqc[:, None, :] @ gdc.transpose(1, 2))[:, 0, :]
            ch = torch.where(mp[lane], nq[:, None] + nd_g - 2.0 * s_g,
                             torch.full_like(nd_g, _MXU_BIG))
            bs, within = _topk_smallest(ch, m)
            bi = torch.clamp(torch.take_along_dim(lane, within, dim=1), max=n - 1)
            chord2.append(bs)
            cidx.append(bi)
            r2.append(r2_tile.expand(query_tile))
    chord2 = torch.cat(chord2)[:q]
    cidx = torch.cat(cidx)[:q]
    r2 = torch.cat(r2)[:q]

    # exact refine: haversine over the M gathered candidates per query
    dist_dtype = torch.promote_types(
        torch.promote_types(qx.dtype, dx.dtype), torch.float32)
    d = haversine_m(qx[:, None].to(dist_dtype), qy[:, None].to(dist_dtype),
                    dx[cidx].to(dist_dtype), dy[cidx].to(dist_dtype))
    # masked or unfilled slots carry chord2 == 8; a point at a query's
    # antipode reaches 4, so the cut sits strictly between
    d = d.masked_fill(chord2 >= 6.0, float("inf"))
    fd, sel = _topk_smallest(d, k)
    fi = torch.take_along_dim(cidx, sel, dim=1).to(torch.int32)
    fd_out = fd if inv is None else fd[inv]
    fi_out = fi if inv is None else fi[inv]
    if not with_flags:
        return fd_out, fi_out

    # exactness certificate: if the exact k-th..M-th chord^2 span is wider
    # than 2B (B the rounding-noise bound), no excluded point can beat the
    # k-th neighbour. The constants are f32, as in the reference.
    eps = torch.tensor(6e-8, dtype=torch.float32, device=dev)
    kappa = torch.tensor(8.0, dtype=torch.float32, device=dev)
    eta = torch.tensor(1.3e-7, dtype=torch.float32, device=dev)
    finite = torch.isfinite(d)
    has_unfilled = (~finite).any(1)  # the pool held every candidate
    d_m = torch.where(finite, d, torch.full_like(d, -float("inf"))).amax(1)
    chord_k = 2.0 * torch.sin(_div_mul(fd[:, -1], 2.0 * EARTH_RADIUS_M, 1.0))
    chord_m = 2.0 * torch.sin(_div_mul(
        torch.where(torch.isfinite(d_m), d_m, torch.zeros_like(d_m)),
        2.0 * EARTH_RADIUS_M, 1.0))
    bound = kappa * eps * r2 + 8.0 * eta * chord_k
    uncertain = ~has_unfilled & (chord_m * chord_m - chord_k * chord_k
                                 < 2.0 * bound)
    if inv is not None:
        uncertain = uncertain[inv]
    return fd_out, fi_out, uncertain


def knn_compact(qx: torch.Tensor, qy: torch.Tensor, dx: torch.Tensor,
                dy: torch.Tensor, mask: torch.Tensor, k: int, capacity: int,
                impl: str = "mxu", query_tile: int = 64):
    """kNN over the mask's matches only: the matching rows are gathered
    into [capacity] candidate slots first, so the distance work is
    O(Q * matches) instead of O(Q * N). Returns (dists [Q, k], indices
    [Q, k] into the ORIGINAL arrays, overflow device bool): `overflow` is
    True iff more than `capacity` rows match, and then the lowest-index
    matches were dropped; callers must check it and fall back.

    The slots hold the matching rows in DESCENDING row order (the
    reference's top_k over where(mask, iota, -1)), so distance ties
    between slots go to the higher original row, as there."""
    n = dx.shape[0]
    if n >= (1 << 31):
        raise ValueError("knn_compact supports n < 2^31 rows per batch")
    capacity = min(capacity, n)
    overflow = mask.sum(dtype=torch.int64) > capacity
    iota = torch.arange(n, dtype=torch.int32, device=dx.device)
    picked = torch.topk(torch.where(mask, iota, torch.full_like(iota, -1)),
                        capacity).values
    idx = torch.clamp(picked, min=0).long()
    valid = picked >= 0
    cx, cy = dx[idx], dy[idx]
    if impl == "mxu":
        fd, fi = knn_mxu(qx, qy, cx, cy, valid, k=k, query_tile=query_tile)
    else:
        fd, fi = knn(qx, qy, cx, cy, valid, k=k)
    return fd, idx[fi.long()].to(torch.int32), overflow


# -- the mesh (each process drives its own shards) ------------------------------


def knn_sharded(mesh, qx: torch.Tensor, qy: torch.Tensor, dx, dy, mask,
                k: int, query_tile: int = 1024, debug_check: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with the data sharded over the mesh: each shard's local
    top-k (`knn`), then the all-gather merge on the lead device
    (`parallel.mesh.merge_topk`). Returns (dists [Q, k], global indices
    [Q, k]). The global top-k is a subset of the union of the shards'
    top-ks, so the merge is exact.

    The reference merges on every device and its `debug_check` asserts
    that every device's merge is bitwise the same; here `debug_check`
    runs the merge once on each shard's device and asserts the same."""
    from geomesa_tpu_torch.parallel.mesh import (
        my_shards, merge_topk, on_shard, replicated, shards_of)

    xs, ys, ms = (shards_of(mesh, a) for a in (dx, dy, mask))
    qxs, qys = replicated(mesh, qx), replicated(mesh, qy)
    shard_n = int(xs[mesh.local[0]].shape[0])
    fds, gis = [], []
    for i, dev in my_shards(mesh):
        with on_shard(dev):
            d, ix = knn(qxs[i], qys[i], xs[i], ys[i], ms[i], k=k,
                        query_tile=query_tile)
            fds.append(d)
            gis.append(ix.to(torch.int64) + i * shard_n)
    md, gi = merge_topk(mesh, fds, gis, k)
    if debug_check:
        div = 0
        for _, dev in my_shards(mesh):
            od, oi = merge_topk(mesh, fds, gis, k, device=dev)
            # equality, not subtraction: inf - inf would read as divergence
            div += int((od.to(md.device) != md).sum()
                       + (oi.to(gi.device) != gi).sum())
        if div:
            raise AssertionError(
                "knn_sharded replication invariant violated: devices "
                f"disagree on the merged top-k (divergence {div})")
    return md, gi.to(torch.int32)


def knn_compact_sharded(mesh, qx: torch.Tensor, qy: torch.Tensor, dx, dy,
                        mask, k: int, capacity: int, query_tile: int = 64):
    """`knn_compact` under the data-sharded merge: each shard compacts its
    own matches (`capacity` per shard) and runs the chord kNN over them;
    the shards' top-ks merge as in `knn_sharded`. Returns (dists [Q, k],
    global indices [Q, k], overflow: True if ANY shard's matches exceeded
    `capacity`, and then the caller MUST fall back to the full sharded
    scan)."""
    from geomesa_tpu_torch.parallel.mesh import (
        any_of, my_shards, merge_topk, on_shard, replicated, shards_of)

    xs, ys, ms = (shards_of(mesh, a) for a in (dx, dy, mask))
    qxs, qys = replicated(mesh, qx), replicated(mesh, qy)
    shard_n = int(xs[mesh.local[0]].shape[0])
    fds, gis, ovs = [], [], []
    for i, dev in my_shards(mesh):
        with on_shard(dev):
            d, ix, ov = knn_compact(qxs[i], qys[i], xs[i], ys[i], ms[i], k=k,
                                    capacity=capacity, query_tile=query_tile)
            fds.append(d)
            gis.append(ix.to(torch.int64) + i * shard_n)
            ovs.append(ov)
    md, gi = merge_topk(mesh, fds, gis, k)
    return md, gi.to(torch.int32), any_of(mesh, ovs)


def knn_ring(mesh, qx, qy, dx, dy, mask, k: int, query_tile: int = 1024):
    """Exact kNN with BOTH the queries and the data sharded: the ring
    top-k. Query shard i (on `devices[i]`) keeps a running top-k; at step
    s the data shard owned by (i - s) % D visits it (on a repeated device
    a view; across cards a copy, the reference's `ppermute`) and is
    folded in, the running best first in the pool, so equal distances
    keep the earlier candidate. Returns (dists, global indices), each
    `Sharded` like the queries.

    On a mesh that spans processes the ring would pass data shards
    between processes; it raises `RemoteShardError` there instead (the
    port does not move shards across processes; `knn_sharded` answers
    the same queries with a collective merge)."""
    from geomesa_tpu_torch.errors import RemoteShardError
    from geomesa_tpu_torch.parallel.mesh import Sharded, on_shard, shards_of

    if mesh.spans_processes:
        raise RemoteShardError(
            "knn_ring visits every data shard from every query shard; on a "
            f"mesh that spans processes ({mesh}) that moves shards between "
            "processes: use knn_sharded")
    d_count = mesh.size
    xs, ys, ms = (shards_of(mesh, a) for a in (dx, dy, mask))
    qxs, qys = shards_of(mesh, qx), shards_of(mesh, qy)
    shard_n = int(xs[0].shape[0])
    dist_dtype = torch.promote_types(
        torch.promote_types(qxs[0].dtype, xs[0].dtype), torch.float32)
    out_d, out_i = [], []
    for me, dev in enumerate(mesh.device_list):
        with on_shard(dev):
            tqx, tqy = qxs[me], qys[me]
            q = tqx.shape[0]
            bd = torch.full((q, k), float("inf"), dtype=dist_dtype, device=dev)
            bi = torch.zeros((q, k), dtype=torch.int32, device=dev)
            for step in range(d_count):
                owner = (me - step) % d_count
                ld, li = knn(tqx, tqy, xs[owner].to(dev), ys[owner].to(dev),
                             ms[owner].to(dev), k=k, query_tile=query_tile)
                gi = (li.to(torch.int64) + owner * shard_n).to(torch.int32)
                nd, sel = _topk_smallest(torch.cat([bd, ld.to(dist_dtype)], 1), k)
                bi = torch.take_along_dim(torch.cat([bi, gi], 1), sel, dim=1)
                bd = nd
            out_d.append(bd)
            out_i.append(bi)
    return Sharded(mesh, out_d), Sharded(mesh, out_i)
