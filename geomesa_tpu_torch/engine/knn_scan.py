"""Fused scan kNN: chord-key block minima + deferred block refine.

The counterpart of the reference package's `engine/knn_scan.py`. One
pass over the (masked) points computes, per query, the minimum of the
centred chord ranking key over every BLK-lane block; the m blocks with
the smallest minima are then refined with exact f32 haversine over their
lanes, and the final k come from that pool:

  minima = chord_blockmin(x, y, maskf)      # CUDA kernel (B2), or
         = chord_blockmin_sparse(...)       # over match-bearing tiles (B1:
                                            # the same kernel, a tile list)
  blocks = two-level top-m over minima      # m winning blocks per query
  refine = exact haversine over m*BLK lanes -> top-k

The ranking key is the reference's centred augmented form:
  key(q, d) = |d-c|^2 - 2 (q-c).(d-c) + (1-mask) * PENALTY
monotonic in chord^2 within a query row; c is the query set's mean unit
vector. Exactness needs m_blocks >= k (checked). BLK, DATA_TILE and
PENALTY keep the reference's values: they fix the tile-capacity units,
the overflow flag and the `blk_ok` threshold PENALTY/2.

The mesh programs (`knn_sparse_sharded`, `make_knn_serve_sharded`,
`make_knn_fullscan_sharded`) run the same scans on every shard's rows
and merge the shards' top-ks exactly (`parallel/mesh.py`).

Each kernel wrapper takes its plain PyTorch version only for tensors on
the CPU; on a CUDA tensor it launches the kernel (built from
`kernels/chord_blockmin.cu` at first use) or raises. `launches` on each
wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from geomesa_tpu_torch.engine.device import check_kernel_inputs, count_launch, fetch
from geomesa_tpu_torch.engine.geodesy import haversine_m
from geomesa_tpu_torch.engine.knn import _topk_smallest, _twolevel_smallest, _unit3
from geomesa_tpu_torch.errors import KernelLaunchError

BLK = 128  # minima granularity: one minimum per BLK data lanes
DATA_TILE = 16384  # points per data tile (the sparse scan's selection unit)
PENALTY = 1e9  # additive key for masked rows (|key| <= 12 for real rows)

# elements of one [Q, chunk] key block in the plain versions (~64 MB f32)
_PLAIN_CHUNK_ELEMS = 1 << 24


def _aug_q(qx: torch.Tensor, qy: torch.Tensor):
    """([Q, 4] augmented queries [-2(q-c), 1], [3] centroid c), f32."""
    qu = _unit3(qx, qy)
    c = qu.mean(dim=0)
    aug = torch.cat([-2.0 * (qu - c), torch.ones_like(qu[:, :1])], 1)
    return aug.contiguous(), c.contiguous()


def _prelude(x, y, maskf, c):
    """Per-point [dx, dy, dz, ndm] in f32, as the kernel stages it."""
    rlon = torch.deg2rad(x)
    rlat = torch.deg2rad(y)
    cl = torch.cos(rlat)
    dx = cl * torch.cos(rlon) - c[0]
    dy = cl * torch.sin(rlon) - c[1]
    dz = torch.sin(rlat) - c[2]
    nd = dx * dx + dy * dy + dz * dz
    return dx, dy, dz, nd + (1.0 - maskf) * PENALTY


def _blockmin_plain(aug, c, x, y, maskf, blk):
    """Plain block minima of the key over x/y/maskf [M] -> [Q, M/blk]: the
    [Q,4]x[4,chunk] product written out elementwise in f32 (no TF32)."""
    q = aug.shape[0]
    m = x.shape[0]
    dx, dy, dz, ndm = _prelude(x, y, maskf, c)
    a0, a1, a2 = aug[:, 0:1], aug[:, 1:2], aug[:, 2:3]
    out = torch.empty((q, m // blk), dtype=torch.float32, device=x.device)
    step = max(blk, (_PLAIN_CHUNK_ELEMS // max(q, 1)) // blk * blk)
    for s in range(0, m, step):
        sl = slice(s, min(s + step, m))
        key = a0 * dx[sl] + a1 * dy[sl] + a2 * dz[sl] + ndm[sl]
        out[:, s // blk: sl.stop // blk] = key.reshape(q, -1, blk).amin(-1)
    return out


def chord_blockmin_plain(qx, qy, x, y, maskf, blk: int = BLK,
                         data_tile: int = DATA_TILE):
    """Plain PyTorch version of `chord_blockmin` (same contract)."""
    _check_tiling(x.shape[0], blk, data_tile)
    aug, c = _aug_q(qx, qy)
    return _blockmin_plain(aug, c, x, y, maskf, blk), c


def chord_blockmin_sparse_plain(qx, qy, x, y, maskf, tile_ids, n_sel,
                                blk: int = BLK, data_tile: int = DATA_TILE):
    """Plain PyTorch version of `chord_blockmin_sparse` (same contract)."""
    n = x.shape[0]
    _check_tiling(n, blk, data_tile)
    aug, c = _aug_q(qx, qy)
    ids = tile_ids.long()
    cap = ids.shape[0]
    sel = lambda a: a.view(n // data_tile, data_tile)[ids].reshape(-1)  # noqa: E731
    minima = _blockmin_plain(aug, c, sel(x), sel(y), sel(maskf), blk)
    live = torch.arange(cap, device=x.device) < n_sel.reshape(())
    live = live.repeat_interleave(data_tile // blk)
    return torch.where(live[None, :], minima,
                       torch.full_like(minima, PENALTY)), c


def _check_tiling(n: int, blk: int, data_tile: int) -> None:
    if n % data_tile or data_tile % blk or blk % 32 or blk > 2048:
        raise ValueError(
            f"bad tiling: n={n} must be a multiple of data_tile={data_tile}, "
            f"which must be a multiple of blk={blk} (a multiple of 32, "
            "at most 2048)")


def _lib():
    from geomesa_tpu_torch.engine.kernels.build import load

    lib = load("chord_blockmin")
    if lib.chord_blockmin_sparse_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        sparse = (lib.chord_blockmin_sparse_launch,
                  lib.chord_blockmin_sparse_prelude_launch)
        dense = (lib.chord_blockmin_dense_launch,
                 lib.chord_blockmin_dense_prelude_launch)
        for fn in sparse:
            fn.argtypes = [p] * 8 + [i] * 4 + [p]
        for fn in dense:
            fn.argtypes = [p] * 6 + [i, ctypes.c_longlong, i, p]
        for fn in sparse + dense:
            fn.restype = ctypes.c_int
    return lib


def _run(entry: str, *args) -> None:
    ptr = lambda t: t.data_ptr() if isinstance(t, torch.Tensor) else t  # noqa: E731
    with torch.cuda.device(args[2].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(*map(ptr, args), stream)
    if err != 0:
        raise KernelLaunchError(f"{entry} failed: CUDA error {err}")


def _launch_dense(aug, c, x, y, maskf, blk, prelude_only: bool = False):
    """B2's launch: [Q, N/blk] minima. `prelude_only` launches the variant
    that skips the keys (its output is not the minima), to time the
    prelude's share."""
    q, n = aug.shape[0], x.shape[0]
    out = torch.empty((q, n // blk), dtype=torch.float32, device=x.device)
    check_kernel_inputs(aug, c, x, y, maskf, out, dtypes=(torch.float32,) * 6)
    entry = ("chord_blockmin_dense_prelude_launch" if prelude_only
             else "chord_blockmin_dense_launch")
    _run(entry, aug, c, x, y, maskf, out, q, n, blk)
    return out


def _launch_sparse(aug, c, x, y, maskf, tile_ids, n_sel, blk, data_tile,
                   prelude_only: bool = False):
    """B1's launch: [Q, C * data_tile/blk] minima, B2's kernel over the
    tile list; `prelude_only` as `_launch_dense`'s (dead columns are
    PENALTY either way)."""
    q, slots = aug.shape[0], tile_ids.shape[0]
    out = torch.empty((q, slots * (data_tile // blk)), dtype=torch.float32,
                      device=x.device)
    check_kernel_inputs(aug, c, x, y, maskf, out, tile_ids, n_sel,
                        dtypes=(torch.float32,) * 6 + (torch.int32,) * 2)
    entry = ("chord_blockmin_sparse_prelude_launch" if prelude_only
             else "chord_blockmin_sparse_launch")
    _run(entry, aug, c, x, y, maskf, tile_ids, n_sel, out, q, slots, blk,
         data_tile)
    return out


def chord_blockmin(qx, qy, x, y, maskf, blk: int = BLK,
                   data_tile: int = DATA_TILE):
    """Dense block minima (B2): [Q] queries x [N] points -> ([Q, N/blk]
    minima of the centred chord key, [3] centroid). N must be a multiple
    of data_tile; maskf is the predicate mask as f32 0/1."""
    n = x.shape[0]
    _check_tiling(n, blk, data_tile)
    if x.device.type == "cpu":
        return chord_blockmin_plain(qx, qy, x, y, maskf, blk, data_tile)
    if x.device.type != "cuda":
        raise ValueError(f"chord_blockmin runs on cuda or cpu, not {x.device}")
    aug, c = _aug_q(qx, qy)
    out = _launch_dense(aug, c, x, y, maskf, blk)
    count_launch(chord_blockmin)
    return out, c


chord_blockmin.launches = 0


def chord_blockmin_sparse(qx, qy, x, y, maskf, tile_ids, n_sel,
                          blk: int = BLK, data_tile: int = DATA_TILE):
    """Sparse block minima (B1): only the data tiles named by `tile_ids`
    [C] int32 are scanned; slots at or past the device scalar `n_sel` [1]
    int32 come out as exactly PENALTY (n_sel > C, the overflow, leaves
    every slot live). Returns ([Q, C * data_tile/blk] minima over the
    selected tiles in tile_ids order, [3] centroid). The kernel is B2's,
    walking the live slots' chunks."""
    n = x.shape[0]
    _check_tiling(n, blk, data_tile)
    if x.device.type == "cpu":
        return chord_blockmin_sparse_plain(qx, qy, x, y, maskf, tile_ids,
                                           n_sel, blk, data_tile)
    if x.device.type != "cuda":
        raise ValueError(f"chord_blockmin_sparse runs on cuda or cpu, not {x.device}")
    aug, c = _aug_q(qx, qy)
    out = _launch_sparse(aug, c, x, y, maskf, tile_ids, n_sel.reshape(1), blk,
                         data_tile)
    count_launch(chord_blockmin_sparse)
    return out, c


chord_blockmin_sparse.launches = 0


def _pad(t: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(t, (0, pad)) if pad else t.contiguous()


def _refine(qx, qy, xf, yf, maskf, orig_blk, n, k, blk, blk_ok=None):
    """Exact f32 haversine over the selected blocks' lanes -> top-k.
    `blk_ok` [Q, mb] masks selected blocks that are capacity-padding
    artifacts (sparse dead slots alias data tile 0 and would otherwise
    duplicate tile-0 lanes in the pool)."""
    q = qx.shape[0]
    mb = orig_blk.shape[1]
    nb = xf.shape[0] // blk
    gx = xf.view(nb, blk)[orig_blk].reshape(q, mb * blk)
    gy = yf.view(nb, blk)[orig_blk].reshape(q, mb * blk)
    gv = (maskf.view(nb, blk) > 0.5)[orig_blk].reshape(q, mb * blk)
    if blk_ok is not None:
        gv = gv & blk_ok.repeat_interleave(blk, dim=1)
    lane = (orig_blk[:, :, None] * blk
            + torch.arange(blk, device=xf.device)).reshape(q, mb * blk)
    d = haversine_m(qx[:, None].float(), qy[:, None].float(), gx, gy)
    d = torch.where(gv & (lane < n), d, torch.full_like(d, float("inf")))
    fd, sel = _topk_smallest(d, k)
    fi = torch.clamp(torch.take_along_dim(lane, sel, dim=1), max=n - 1)
    return fd, fi


def _check_k(k: int, m_blocks: int) -> None:
    if k > m_blocks:
        raise ValueError(
            f"k={k} exceeds m_blocks={m_blocks}: the deferred block "
            "selection only guarantees the top-m_blocks elements"
        )


def knn_fullscan(qx, qy, x, y, mask, k: int, m_blocks: int = 64,
                 blk: int = BLK, data_tile: int = DATA_TILE
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over the masked batch in one dense scan: (dists [Q, k]
    meters f32, indices [Q, k] into the original arrays). m_blocks >= k
    required; N is padded to data_tile internally (padding masked out)."""
    _check_k(k, m_blocks)
    xf, yf, maskf = pad_scan_inputs(x, y, mask, data_tile)
    return knn_fullscan_body(qx, qy, xf, yf, maskf, x.shape[0], k,
                             m_blocks, blk, data_tile)


def pad_scan_inputs(x, y, mask, data_tile: int = DATA_TILE):
    """(xf, yf, maskf): the points and the mask as f32, padded to whole
    data tiles (padding masked out). A copy of every column whenever N is
    not a multiple of data_tile, so the ring serve loop does it once at
    arm time."""
    pad = (-x.shape[0]) % data_tile
    return _pad(x.float(), pad), _pad(y.float(), pad), _pad(mask.float(), pad)


def knn_fullscan_body(qx, qy, xf, yf, maskf, n: int, k: int,
                      m_blocks: int = 64, blk: int = BLK,
                      data_tile: int = DATA_TILE):
    """`knn_fullscan` over inputs already padded (`pad_scan_inputs`): B2,
    the two-level block selection and the refine. No host sync, so a
    CUDA graph can capture it."""
    minima, _ = chord_blockmin(qx, qy, xf, yf, maskf, blk=blk,
                               data_tile=data_tile)
    mb = min(m_blocks, xf.shape[0] // blk)
    _, blkid = _twolevel_smallest(minima, mb)
    return _refine(qx, qy, xf, yf, maskf, blkid, n, k, blk)


def select_match_tiles(maskf: torch.Tensor, tile_capacity: int,
                       data_tile: int = DATA_TILE):
    """(tile_ids [C] int32, n_sel [1] int32) on the device, C =
    min(tile_capacity, tiles): the ids of the match-bearing tiles of the
    padded f32 mask in ascending order, first C of them, padding slots
    set to tile 0 (the reference's top_k selection, without a host
    sync); n_sel counts every match-bearing tile, so n_sel > C flags an
    overflow."""
    ntiles = maskf.shape[0] // data_tile
    cap = min(tile_capacity, ntiles)
    tmatch = maskf.view(ntiles, data_tile).amax(dim=1) > 0.0
    n_sel = tmatch.sum(dtype=torch.int32).reshape(1)
    ar = torch.arange(ntiles, device=maskf.device)
    order = torch.sort(torch.where(tmatch, ar, torch.full_like(ar, ntiles)),
                       stable=True).values[:cap]
    tile_ids = torch.where(order < ntiles, order,
                           torch.zeros_like(order)).to(torch.int32)
    return tile_ids, n_sel


def knn_sparse_scan(qx, qy, x, y, mask, k: int, tile_capacity: int,
                    m_blocks: int = 64, blk: int = BLK,
                    data_tile: int = DATA_TILE):
    """Exact kNN scanning ONLY data tiles that hold at least one match:
    (dists [Q, k], indices [Q, k], overflow bool device scalar). If more
    than `tile_capacity` tiles match, `overflow` is set, the top-k ignored
    the highest-id matching tiles, and the caller MUST fall back to
    `knn_fullscan`. Nothing here reads the device back."""
    _check_k(k, m_blocks)
    xf, yf, maskf = pad_scan_inputs(x, y, mask, data_tile)
    tile_ids, n_sel = select_match_tiles(maskf, tile_capacity, data_tile)
    overflow = n_sel[0] > tile_ids.shape[0]
    fd, fi = knn_sparse_body(qx, qy, xf, yf, maskf, tile_ids, n_sel,
                             x.shape[0], k, m_blocks, blk, data_tile)
    return fd, fi, overflow


def knn_sparse_body(qx, qy, xf, yf, maskf, tile_ids, n_sel, n: int, k: int,
                    m_blocks: int = 64, blk: int = BLK,
                    data_tile: int = DATA_TILE):
    """`knn_sparse_scan` over padded inputs and a selected tile list: B1,
    the two-level block selection and the refine -> (dists [Q, k],
    indices [Q, k]). No host sync, so a CUDA graph can capture it."""
    minima, _ = chord_blockmin_sparse(qx, qy, xf, yf, maskf, tile_ids, n_sel,
                                      blk=blk, data_tile=data_tile)
    bpt = data_tile // blk  # blocks per tile
    mb = min(m_blocks, minima.shape[1])
    vals, selblk = _twolevel_smallest(minima, mb)
    # dead capacity slots emit exactly PENALTY and alias data tile 0: a
    # selected block is real only if its minimum is below the penalty
    blk_ok = vals < PENALTY / 2
    orig_blk = tile_ids.long()[selblk // bpt] * bpt + selblk % bpt
    return _refine(qx, qy, xf, yf, maskf, orig_blk, n, k, blk, blk_ok=blk_ok)


def count_match_tiles(mask: torch.Tensor, data_tile: int = DATA_TILE
                      ) -> torch.Tensor:
    """Device count of match-bearing data tiles (the capacity calibration
    input: one scalar crosses to the host, not the mask)."""
    n = mask.shape[0]
    mf = _pad(mask.to(torch.int32), (-n) % data_tile)
    return (mf.view(-1, data_tile).amax(dim=1) > 0).sum(dtype=torch.int32)


def capacity_bucket(tiles_hit: int, slack: float = 1.25,
                    floor: int = 64) -> int:
    """pow2 capacity bucket from a tiles-hit measurement: slack absorbs
    drift between calibration and the live query (dead slots are cheap)."""
    need = max(int(tiles_hit * slack), 1)
    return max(floor, 1 << int(np.ceil(np.log2(need))))


def knn_sparse_launch(qx, qy, x, y, mask, k: int,
                      tile_capacity: Optional[int] = None,
                      m_blocks: int = 64):
    """Async half of the sparse kNN: calibrate the capacity if the caller
    has none (one scalar read), then launch the scan and return the
    device-resident (dists, idx, overflow, tile_capacity)."""
    if tile_capacity is None:
        tile_capacity = capacity_bucket(int(count_match_tiles(mask)))
    fd, fi, ov = knn_sparse_scan(qx, qy, x, y, mask, k=k,
                                 tile_capacity=tile_capacity,
                                 m_blocks=m_blocks)
    return fd, fi, ov, tile_capacity


def knn_sparse_finish(fd, fi, ov, qx, qy, x, y, mask, k: int,
                      tile_capacity: int, m_blocks: int = 64, extra=()):
    """Sync half: ONE read of results + overflow flag (+ any `extra`
    device values, such as the fused count), falling back to the dense
    `knn_fullscan` on overflow. Returns (dists np, idx np int32,
    capacity_used (-1 after the fallback), extra_host tuple)."""
    fd, fi, ov, *extra_host = fetch(fd, fi, ov, *extra)
    if bool(ov):
        fd, fi = fetch(*knn_fullscan(qx, qy, x, y, mask, k=k,
                                     m_blocks=m_blocks))
        return fd, fi.astype(np.int32), -1, tuple(extra_host)
    return fd, fi.astype(np.int32), tile_capacity, tuple(extra_host)


def knn_sparse_auto(qx, qy, x, y, mask, k: int,
                    tile_capacity: Optional[int] = None, m_blocks: int = 64):
    """The framework-facing sparse kNN: calibrate the capacity if the
    caller has none, run the sparse scan and, on overflow, the dense
    fullscan. Returns (dists np, idx np int32, capacity_used), -1 after
    the fallback so the caller recalibrates. Composed from the launch
    and finish halves, as the planner's path is."""
    fd, fi, ov, tile_capacity = knn_sparse_launch(
        qx, qy, x, y, mask, k=k, tile_capacity=tile_capacity,
        m_blocks=m_blocks)
    fd, fi, cap, _ = knn_sparse_finish(
        fd, fi, ov, qx, qy, x, y, mask, k=k, tile_capacity=tile_capacity,
        m_blocks=m_blocks)
    return fd, fi, cap


# -- the mesh (each process drives its own shards) ------------------------------


def _scan_shards(mesh, qx, qy, x, y, mask, scan):
    """Run `scan(qx, qy, x, y, mask)` -> (fd, fi, ...) on every local
    shard's rows (`parallel.mesh.shards_of`), each under its own device
    with the queries copied there, one shard after another with no host
    sync. Returns (per-local-shard outputs, shard rows)."""
    from geomesa_tpu_torch.parallel.mesh import (
        my_shards, on_shard, replicated, shards_of)

    xs, ys, ms = (shards_of(mesh, a) for a in (x, y, mask))
    qxs, qys = replicated(mesh, qx), replicated(mesh, qy)
    outs = []
    for i, dev in my_shards(mesh):
        with on_shard(dev):
            outs.append(scan(qxs[i], qys[i], xs[i], ys[i], ms[i]))
    return outs, int(xs[mesh.local[0]].shape[0])


def _shard_merge_topk(mesh, fds, fis, shard_n: int, k: int):
    """The mesh merge shared by the sparse program and its fullscan
    overflow fallback: local indices lift to global (`local + shard *
    shard_n`; the mesh superbatch keeps the serial layout, so the global
    index IS the serial index), the shards' top-ks pool on the lead
    device in shard order and one stable re-top-k keeps the k smallest
    (`parallel.mesh.merge_topk`)."""
    from geomesa_tpu_torch.parallel.mesh import merge_topk

    gis = [fi.to(torch.int64) + i * shard_n for i, fi in zip(mesh.local, fis)]
    return merge_topk(mesh, fds, gis, k)


def knn_sparse_sharded(mesh, qx, qy, dx, dy, mask, k: int, tile_capacity: int,
                       m_blocks: int = 64):
    """`knn_sparse_scan` on every shard's rows (B1 once per shard, each
    shard padding its rows to DATA_TILE on its own), merged exactly:
    (dists [Q, k], global indices [Q, k], overflow: True if ANY shard
    overflowed its `tile_capacity`, and then the caller MUST fall back to
    the dense sharded scan). `dx`/`dy`/`mask` are `Sharded` or whole
    tensors of a length that divides by the mesh size; results are on
    the lead device. The serving program without its count."""
    return make_knn_serve_sharded(mesh)(qx, qy, dx, dy, mask, k,
                                        tile_capacity, m_blocks)


def shard_match_tiles(mask, n_shards: int, data_tile: int = DATA_TILE
                      ) -> torch.Tensor:
    """The MAX over shards of the per-shard match-bearing tile count: the
    mesh route's capacity calibration input (one scalar crosses to the
    host, as `count_match_tiles` on one device). Each shard pads its
    rows to `data_tile` on its own, as `knn_sparse_scan` does on it.
    `mask` is `Sharded` or a whole tensor cut into `n_shards`; on a mesh
    that spans processes the MAX is taken over them (`parallel.mesh.
    pmax`), so every process sizes the same program."""
    from geomesa_tpu_torch.parallel.mesh import Sharded, pmax

    if isinstance(mask, Sharded):
        mesh = mask.mesh
        local = torch.stack([count_match_tiles(m, data_tile).to(mesh.lead)
                             for m in mask.local_shards]).max()
        if not mesh.spans_processes:
            return local
        return torch.tensor(pmax(mesh, int(local.item())), dtype=local.dtype,
                            device=mesh.lead)
    n = mask.shape[0]
    s = n // n_shards
    m = mask.to(torch.int32).reshape(n_shards, s)
    pad = (-s) % data_tile
    if pad:
        m = F.pad(m, (0, pad))
    per_shard = (m.reshape(n_shards, -1, data_tile).amax(dim=2) > 0).sum(
        dim=1, dtype=torch.int32)
    return per_shard.max()


def make_knn_serve_sharded(mesh):
    """The mesh-serving kNN program for `mesh`: every shard runs
    `knn_sparse_scan` (B1) over its own rows, the top-ks merge on the
    lead device, the overflow flags OR and, with `want_count`, the fused
    count adds the shards' mask sums (`psum`). Global indices are
    `local + shard * shard_rows`: under the mesh superbatch's serial
    layout the results are the single-device kernel's. Returns
    run(qx, qy, x, y, mask, k, tile_capacity, m_blocks, want_count) ->
    (dists, indices, overflow[, count])."""
    from geomesa_tpu_torch.parallel.mesh import any_of, psum

    def run(qx, qy, x, y, mask, k, tile_capacity, m_blocks=64,
            want_count=False):
        def scan(qx, qy, lx, ly, lm):
            fd, fi, ov = knn_sparse_scan(qx, qy, lx, ly, lm, k=k,
                                         tile_capacity=tile_capacity,
                                         m_blocks=m_blocks)
            cnt = lm.sum(dtype=torch.int64) if want_count else None
            return fd, fi, ov, cnt

        outs, shard_n = _scan_shards(mesh, qx, qy, x, y, mask, scan)
        md, gi = _shard_merge_topk(mesh, [o[0] for o in outs],
                                   [o[1] for o in outs], shard_n, k)
        ov_any = any_of(mesh, [o[2] for o in outs])
        if want_count:
            return md, gi, ov_any, psum(mesh, [o[3] for o in outs])
        return md, gi, ov_any

    return run


def make_knn_fullscan_sharded(mesh):
    """The dense mesh fallback of `make_knn_serve_sharded`'s overflow:
    every shard runs the exact `knn_fullscan` (B2) over its rows and the
    merge is the same, so the overflow path keeps the single-device
    answers too. Returns run(qx, qy, x, y, mask, k, m_blocks) -> (dists,
    indices)."""

    def run(qx, qy, x, y, mask, k, m_blocks=64):
        outs, shard_n = _scan_shards(
            mesh, qx, qy, x, y, mask,
            lambda *a: knn_fullscan(*a, k=k, m_blocks=m_blocks))
        return _shard_merge_topk(mesh, [o[0] for o in outs],
                                 [o[1] for o in outs], shard_n, k)

    return run


def knn_fullscan_tiled(qx, qy, x, y, mask, k: int, m_blocks: int = 64,
                       query_tile: int = 256):
    """knn_fullscan for arbitrary Q: queries in tiles of `query_tile`
    (each tile centres its own key and re-scans the batch). The last
    tile is padded with its edge query, as the reference does."""
    _check_k(k, m_blocks)
    xf, yf, maskf = pad_scan_inputs(x, y, mask)
    return knn_fullscan_tiled_body(qx, qy, xf, yf, maskf, x.shape[0], k,
                                   m_blocks, query_tile)


def knn_fullscan_tiled_body(qx, qy, xf, yf, maskf, n: int, k: int,
                            m_blocks: int = 64, query_tile: int = 256):
    """`knn_fullscan_tiled` over padded inputs (`pad_scan_inputs`): one B2
    launch per query tile, no host sync."""
    q = qx.shape[0]
    if q <= query_tile:
        return knn_fullscan_body(qx, qy, xf, yf, maskf, n, k, m_blocks)
    pad = (-q) % query_tile
    qxp = torch.cat([qx, qx[-1:].expand(pad)])
    qyp = torch.cat([qy, qy[-1:].expand(pad)])
    parts = [knn_fullscan_body(qxp[s:s + query_tile], qyp[s:s + query_tile],
                               xf, yf, maskf, n, k, m_blocks)
             for s in range(0, q + pad, query_tile)]
    fd = torch.cat([p[0] for p in parts])[:q]
    fi = torch.cat([p[1] for p in parts])[:q]
    return fd, fi


# f32 scan-ranking error budget (the reference's model, unchanged): the
# scan ranks by f32 haversine over f32-rounded coordinates; err_m(d)
# bounds |d_f32 - d_f64| including the amplification near the antipode.
KNN_F32_ABS_M = 4.0
KNN_F32_REL_A = 1e-5
_R_EARTH_M = 6_371_000.0


def knn_f32_err_m(d):
    """Upper bound on |f32 scan distance - f64 true distance| at true
    distance d meters; monotone increasing on [0, pi*R)."""
    d = np.asarray(d, np.float64)
    half = d / (2.0 * _R_EARTH_M)
    s = np.sin(np.clip(2.0 * half, 0.0, np.pi))
    amp = np.where(
        s > 1e-9,
        2.0 * _R_EARTH_M * KNN_F32_REL_A * np.sin(half) ** 2 / s,
        np.inf,  # at/after the antipode nothing is certifiable
    )
    return KNN_F32_ABS_M + amp


def knn_exact_refine(qx_np, qy_np, x_np, y_np, fd, fi, k):
    """f64 re-ranking of the k' > k candidates a scan returned, with a
    certificate that the true top-k (f64 haversine over the original f64
    coordinates) lies inside the candidate set: a row not returned has
    f32 distance >= L (the largest returned), so L > B + err_m(B), with B
    the refined k-th distance, proves nothing was missed. Returns
    (d64 [Q, k] sorted, idx [Q, k], certified [Q] bool)."""
    from geomesa_tpu_torch.engine.geodesy import haversine_m_np

    fd = np.asarray(fd)
    fi = np.asarray(fi)
    Q, kp = fd.shape
    if kp < k:
        raise ValueError(f"need at least k={k} candidates, got {kp}")
    d64 = np.empty((Q, kp))
    for i in range(Q):
        d64[i] = np.where(
            np.isfinite(fd[i]),
            haversine_m_np(qx_np[i], qy_np[i], x_np[fi[i]], y_np[fi[i]]),
            np.inf,
        )
    order = np.argsort(d64, axis=1, kind="stable")[:, :k]
    dists = np.take_along_axis(d64, order, axis=1)
    idx = np.take_along_axis(fi, order, axis=1)
    # an inf anywhere in fd means fewer than k' matches exist, so nothing
    # was cut off: L=inf certifies those rows through the same comparison
    L = np.where(np.isfinite(fd).all(1), fd.max(1), np.inf)
    B = dists[:, -1]
    with np.errstate(invalid="ignore"):
        certified = (L > B + knn_f32_err_m(B)) | ~np.isfinite(B)
    return dists, idx, certified
