"""The skip of the port's polygon-layer kernels (B6-B9) on the CPU.

The CUDA kernels (`engine/kernels/pip_layer.cu`) hand out CSR rows
longest first, sort each point tile's 512 points by y, and let each warp
of 32 * P sorted points skip every C-edge chunk of an edge tile whose
y-span, widened by 2 eps in f64, misses all of the warp's points, and
in the chunks it keeps every edge that misses the warp's y-range. The
kernels cannot run here, so `mirror` repeats their structure in PyTorch
from the module's own statement of it (`row_order`, `tile_y_order`,
`warp_ys`, `warp_y_ranges`, `tile_chunk_bounds`, `kept_chunks`,
`kept_edges`): per row and edge tile, the shared predicate over only the
edges each warp keeps, the B7
flush at each polygon's last edge tile, the counts written back to the
points' slots. B8 and B9 walk the same way over one CSR row per point
tile that their wrappers build from a pair list in any order
(`pairs_csr`): B8 crossings only, with a reach margin of 0 (eps = 0),
B9 band counts only. The mirror must equal the plain versions, which test
every pair, bit for bit, at the kernels' P and C; the plain
versions must equal the reference's Pallas kernels in interpret mode
(band flags identical, crossing counts identical outside band-flagged
points: the reference's CPU run contracts an FMA, as
`test_torch_pip_layer.py` states). The cases hold points at exactly
y +- eps of near-flat edges and 1-2 f32 ulps either side, points on
vertices, NaN, infinite and pad (1e8) points, edges with NaN x-ends and
y-ends, the BIG pad edges that fill each polygon's last tile, rows of
one edge tile and of every edge tile, and polygons of one to four edge
tiles, so B7's runs cross chunks and the kernel's two copy stages.
"""

import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.engine import pip_sparse as R
from geomesa_tpu_torch.engine import pip_sparse as P
from geomesa_tpu_torch.engine import pip_sparse_kernels as psk
from geomesa_tpu_torch.engine.pip_kernels import crossing_and_band, out_of_reach

from test_torch_pip import eps_boundary_points
from test_torch_pip_layer import assert_counts, ref_assign_tables
from test_torch_pip_prune import ring_edges
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

EPS = 1e-4
T = psk.TILE


# -- cases -------------------------------------------------------------------


def layer_edges(name):
    """Edge tiles of a case: star-shaped rings (every other edge near-flat,
    `ring_edges`) of 1900, 700, 300 and 64 edges (4, 2, 1 and 1 tiles
    once padded with BIG edges), as f32 numpy (x1, y1, x2, y2), with the
    polygon rank of each tile. 'nan' puts NaN x-ends on near-flat edges
    and NaN y-ends on others."""
    rng = np.random.default_rng(41)
    rings = [ring_edges(rng, 1900, cx=0.0, cy=0.0, rx=2.0, ry=1.6),
             ring_edges(rng, 700, cx=1.5, cy=0.5, rx=0.6, ry=0.5),
             ring_edges(rng, 300, cx=-1.2, cy=-0.8, rx=0.4, ry=0.3),
             ring_edges(rng, 64, cx=0.1, cy=0.1, rx=0.3, ry=0.2)]
    cols = [np.concatenate([r[i] for r in rings]) for i in range(4)]
    pol = np.concatenate([np.full(len(r[0]), k) for k, r in enumerate(rings)])
    if name == "nan":
        flat = np.nonzero(np.abs(cols[3] - cols[1]) <= 2 * EPS)[0]
        cols[2][flat[0::4]] = np.nan   # one NaN x-end: x2
        cols[0][flat[2::4]] = np.nan   # one NaN x-end: x1
        cols[3][flat[1:-1:8] + 1] = np.nan  # a y-end of a steep neighbour
        cols[1][flat[5:-1:8] + 1] = np.nan
        cols[0][7] = cols[2][7] = np.nan  # both x-ends
    *edges, poly = P.pad_polygon_edges(*cols, pol)
    rank = np.unique(poly, return_inverse=True)[1].astype(np.int64)
    return tuple(np.asarray(a, np.float32) for a in edges), rank


def nan_edge_points(edges, rng):
    """Points within eps (and just beyond) of the finite x-end of every
    edge with one NaN x-end: a kernel that drops the NaN end from the
    near-flat x-span flags them, the plain version does not."""
    x1, y1, x2, y2 = edges
    e = np.float32(EPS)
    one = np.nonzero((np.isnan(x1) ^ np.isnan(x2)) & ~np.isnan(y1) & ~np.isnan(y2))[0]
    xs, ys = [], []
    for j in one:
        xf = x2[j] if np.isnan(x1[j]) else x1[j]
        for dx in (0.0, 0.5, -0.5, 0.99, -0.99, 2.0):
            for yy in (y1[j], y2[j], y1[j] + e, y1[j] - e,
                       np.nextafter(y1[j] + e, np.float32(np.inf))):
                xs.append(np.float32(xf + dx * e))
                ys.append(np.float32(yy + np.float32(rng.choice([0.0, 0.3, -0.3])) * e))
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


def layer_points(name, edges, rng):
    """f32 points of a case over the rings' envelope: a third uniform,
    the rest on edges and within a few ulps of them, plus the case's own
    set; in no spatial order, as a point tile may hold them."""
    x1, y1, x2, y2 = (a.astype(np.float64) for a in edges)
    real = np.nonzero(np.isfinite(x1) & np.isfinite(y1) & np.isfinite(x2)
                      & np.isfinite(y2) & (y1 < R.BIG / 2))[0]
    n = 1500
    x = rng.uniform(-2.3, 2.3, n)
    y = rng.uniform(-1.9, 1.9, n)
    e = rng.choice(real, n - n // 3)
    t = rng.choice([0.0, 0.5, 0.25, 1.0], n - n // 3)
    ulp = rng.choice([0.0, 1.0, -1.0, 2.0], (2, n - n // 3)) * float(np.spacing(np.float32(2.0)))
    x[n // 3:] = x1[e] + t * (x2[e] - x1[e]) + ulp[0]
    y[n // 3:] = y1[e] + t * (y2[e] - y1[e]) + ulp[1]
    x, y = x.astype(np.float32), y.astype(np.float32)
    if name == "eps_boundary":
        bx, by = eps_boundary_points([a[real] for a in edges], EPS, n_edges=40)
    elif name == "vertices":
        vx = np.concatenate([edges[0][real], edges[2][real]])
        vy = np.concatenate([edges[1][real], edges[3][real]])
        k = rng.choice(len(vx), 800, replace=False)
        bx = np.concatenate([vx[k], vx[k], vx[k]])
        by = np.concatenate([vy[k], np.nextafter(vy[k], np.float32(np.inf)),
                             np.nextafter(vy[k], np.float32(-np.inf))])
    elif name == "nan_pad":
        x[5::37] = np.nan
        y[11::41] = np.nan
        x[17::53] = y[17::53] = np.nan
        y[23::97] = np.inf
        y[29::101] = -np.inf
        bx = by = np.zeros(0, np.float32)
    else:  # nan edges
        bx, by = nan_edge_points(edges, rng)
    x, y = np.concatenate([x, bx]), np.concatenate([y, by])
    p = rng.permutation(len(x))
    pad = (-len(x)) % T + (T if name == "nan_pad" else 0)  # a whole pad tile too
    return (np.concatenate([x[p], np.full(pad, 1e8, np.float32)]),
            np.concatenate([y[p], np.full(pad, 1e8, np.float32)]))


def layer_pairs(n_ptiles, rank, rng):
    """Pairs (point tile, edge tile): tile 0 meets every edge tile, tile 1
    one (a row of one edge tile), the others every tile of a random subset
    of the polygons, so rows differ in length."""
    n_etiles = len(rank)
    pt, et = [], []
    for p in range(n_ptiles):
        if p == 0:
            tiles = np.arange(n_etiles)
        elif p == 1:
            tiles = np.array([rng.integers(n_etiles)])
        else:
            polys = rng.choice(rank.max() + 1, rng.integers(1, rank.max() + 1),
                               replace=False)
            tiles = np.nonzero(np.isin(rank, polys))[0]
        pt += [p] * len(tiles)
        et += list(tiles)
    return np.asarray(pt, np.int32), np.asarray(et, np.int32)


CASES = {"eps_boundary": "rings", "vertices": "rings", "nan_pad": "rings",
         "nan_edges": "nan"}


def shuffled_pairs(pt, et, rng):
    """The pair list in random order with a tenth of its pairs twice (B9
    takes its pairs in any order and counts a duplicate pair twice)."""
    dup = rng.choice(len(pt), max(1, len(pt) // 10), replace=False)
    o = rng.permutation(len(pt) + len(dup))
    return np.concatenate([pt, pt[dup]])[o], np.concatenate([et, et[dup]])[o]


def make_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    edges, rank = layer_edges(CASES[name])
    px, py = layer_points(name, edges, rng)
    pt, et = layer_pairs(len(px) // T, rank, rng)
    return SimpleNamespace(px=px, py=py, edges=edges, rank=rank, pt=pt, et=et,
                           n_ptiles=len(px) // T, n_etiles=len(rank))


def tensors(case):
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (case.px, case.py, *case.edges)]


def csr(case, assign):
    c = psk.pair_csr(case.pt, case.et, poly_of_tile=case.rank if assign else None)
    return [torch.from_numpy(a) for a in (c if assign else c[:3])]


# -- the mirror ----------------------------------------------------------------


def mirror(args, rows, row_ptr, ets, pinfo, n_ptiles, eps=EPS):
    """The B6 (pinfo None) or B7 kernel's structure in PyTorch, the
    reach margin 2 eps. Returns (outputs as the plain version's, {"chunk":
    tests in kept chunks, "edge": tests of kept edges, "all": all
    tests})."""
    px, py, *edges = args
    wp = psk.WARP_POINTS
    ys = psk.warp_ys(py)
    bounds = psk.tile_chunk_bounds(edges[1], edges[3])
    order = psk.tile_y_order(py)
    pxt, pyt = px.reshape(-1, T), py.reshape(-1, T)
    et_tiles = [a.reshape(-1, T) for a in edges]
    e32 = torch.tensor(eps, dtype=torch.float32)
    outs = [torch.zeros((n_ptiles, T), dtype=torch.int32)
            for _ in range(2 if pinfo is None else 3)]
    kept = {"chunk": 0, "edge": 0, "all": 0}
    for r in psk.row_order(row_ptr).tolist():
        tile = int(rows[r])
        slots = order[tile]
        qx, qy = pxt[tile][slots][:, None], pyt[tile][slots][:, None]
        cross = torch.zeros(T, dtype=torch.int32)
        band, assign, count = cross.clone(), cross.clone(), cross.clone()
        for m in range(int(row_ptr[r]), int(row_ptr[r + 1])):
            et = ets[m:m + 1]
            keep = psk.kept_edges(ys, bounds, edges[1], edges[3],
                                  rows[r:r + 1], et, eps)[0]
            mask = keep.repeat_interleave(wp, 0)
            c, b = crossing_and_band(qx, qy, *[a[et] for a in et_tiles], e32)
            cross += (c & mask).sum(1, dtype=torch.int32)
            band += (b & mask).sum(1, dtype=torch.int32)
            chunks = psk.kept_chunks(ys, bounds, rows[r:r + 1], et, eps)[0]
            kept["chunk"] += int(chunks.sum()) * psk.CHUNK * wp
            kept["edge"] += int(keep.sum()) * wp
            kept["all"] += T * T
            if pinfo is not None and int(pinfo[m]) < 0:
                parity = cross & 1
                assign += parity * -int(pinfo[m])
                count += parity
                cross[:] = 0
        vals = (cross, band) if pinfo is None else (assign, count, band)
        for o, v in zip(outs, vals):
            o[tile, slots] = v
    return tuple(outs), kept


# -- tests ---------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return make_case(request.param)


def mirror_pairs(args, pt, et, n_ptiles, eps, launches=2):
    """B8's (eps = 0, crossings) and B9's (eps, band) structure: the pair
    list cut into `launches` consecutive pieces, each turned into one CSR
    row per point tile (`pairs_csr`) and walked as B6 walks with the reach
    margin 2 eps; the pieces' outputs add, as `pip_layer_sparse` adds its
    launches. Returns ((crossings, band) [n_ptiles, 512], kept as
    `mirror`'s)."""
    outs = [torch.zeros((n_ptiles, T), dtype=torch.int32) for _ in range(2)]
    kept = {"chunk": 0, "edge": 0, "all": 0}
    cuts = np.linspace(0, len(pt), launches + 1).astype(int)
    for s0, s1 in zip(cuts[:-1], cuts[1:]):
        got, k = mirror(args, *psk.pairs_csr(pt[s0:s1], et[s0:s1], n_ptiles),
                        None, n_ptiles, eps)
        for o, g in zip(outs, got):
            o += g
        kept = {key: kept[key] + k[key] for key in kept}
    return tuple(outs), kept


@pytest.mark.parametrize("kind", ["grouped", "assign", "pairs_count", "pairs_band"])
def test_mirror_equals_plain(case, kind):
    """The kernels' structure equals the plain versions bit for bit: B6
    and B7 over the pair CSR, B8 (reach margin 0) and B9 over the pair
    list shuffled with a tenth of its pairs twice and cut into two
    launches, so that a point tile's pairs are split between them."""
    args = tensors(case)
    if kind.startswith("pairs"):
        pt, et = (torch.from_numpy(a) for a in shuffled_pairs(
            case.pt, case.et, np.random.default_rng(3)))
        if kind == "pairs_count":
            plain = psk.pip_pairs_count_plain(*args, pt, et, case.n_ptiles)
            (got, _), kept = mirror_pairs(args, pt, et, case.n_ptiles, 0.0)
        else:
            plain = psk.pip_pairs_band_plain(*args, pt, et, case.n_ptiles, EPS)
            (_, got), kept = mirror_pairs(args, pt, et, case.n_ptiles, EPS)
        assert not plain[-1].any()  # the reference's scratch tile
        plain, got = (plain[:-1],), (got,)
    else:
        c = csr(case, kind == "assign")
        if kind == "grouped":
            plain = psk.pip_grouped_plain(*args, *c, case.n_ptiles, EPS)
            pinfo = None
        else:
            plain = psk.pip_assign_plain(*args, *c, case.n_ptiles, EPS)
            pinfo = c[3]
        got, kept = mirror(args, *c[:3], pinfo, case.n_ptiles)
    assert int(plain[-1].sum()) > 0  # band flags (B8: crossings) exist
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    # the rule skips: a warp tests a minority of the pairs, fewer edge by edge
    assert kept["chunk"] < 0.5 * kept["all"]
    assert kept["edge"] <= kept["chunk"]


def ref_grouped(case):
    """The reference's `_pip_grouped_call` over every covered tile."""
    tiles, counts = np.unique(case.pt, return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    o = np.argsort(case.pt, kind="stable")
    cap = max(2, 1 << int(np.ceil(np.log2(counts.max()))))
    etab = np.full((len(tiles), cap), case.n_etiles, np.int32)
    for k, (s, n) in enumerate(zip(starts, counts)):
        etab[k, :n] = case.et[o][s:s + n]
    rc, rb = R._pip_grouped_call(*ref_points(case, tiles), *ref_edges(case),
                                 jnp.asarray(etab), cap=cap,
                                 n_etiles=case.n_etiles, eps=EPS, interpret=True)
    return tiles, np.asarray(rc), np.asarray(rb)


def ref_points(case, tiles):
    return [jnp.asarray(a.reshape(-1, T)[tiles]) for a in (case.px, case.py)]


def ref_edges(case):
    """The f32 edges with the reference's appended all-BIG dummy tile."""
    return [jnp.asarray(np.concatenate([a, np.full(T, fill, np.float32)]))
            for a, fill in zip(case.edges, (0.0, R.BIG, 0.0, R.BIG))]


def np_counts(case, fused: bool):
    """(crossings, band) int64 [n_ptiles, 512] over the case's pairs in
    NumPy f32, with x1 + t*(x2-x1) rounded once (fused, as the
    reference's CPU run contracts it) or twice (as the port and its CUDA
    kernels round it)."""
    f, e = np.float32, np.float32(EPS)
    cross = np.zeros((case.n_ptiles, T), np.int64)
    band = np.zeros_like(cross)
    px, py = (a.reshape(-1, T) for a in (case.px, case.py))
    edges = [a.reshape(-1, T) for a in case.edges]
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for p, q in zip(case.pt, case.et):
            qx, qy = px[p][:, None], py[p][:, None]
            x1, y1, x2, y2 = (a[q][None, :] for a in edges)
            cond = (y1 <= qy) != (y2 <= qy)
            t = (qy - y1) / np.where(y2 == y1, f(1), y2 - y1)
            xc = ((x1.astype(np.float64) + t.astype(np.float64) * (x2 - x1)).astype(f)
                  if fused else x1 + t * (x2 - x1))
            near_flat = ((np.abs(qy - y1) <= e) & (np.abs(qy - y2) <= e)
                         & (qx >= np.minimum(x1, x2) - e) & (qx <= np.maximum(x1, x2) + e))
            err = e * (f(1) + np.abs(x2 - x1) / np.maximum(np.abs(y2 - y1), e))
            cross[p] += (cond & (xc > qx)).sum(1)
            band[p] += (near_flat | (cond & (np.abs(xc - qx) <= err))).sum(1)
    return cross, band


def assert_band(got, ref, case, tiles):
    """The port's band counts equal the separately rounded NumPy
    evaluation, the reference's the fused one; the two differ on few
    points, and only there may the port and the reference differ."""
    _, sep = np_counts(case, fused=False)
    _, fused = np_counts(case, fused=True)
    np.testing.assert_array_equal(got, sep)
    np.testing.assert_array_equal(ref, fused[tiles])
    assert (sep != fused).mean() < 0.01
    same = sep[tiles] == fused[tiles]
    np.testing.assert_array_equal(got[tiles][same], ref[same])


def test_plain_grouped_equals_reference(case):
    tiles, rc, rb = ref_grouped(case)
    gc, gb = (a.numpy() for a in psk.pip_grouped_plain(
        *tensors(case), *csr(case, False), case.n_ptiles, EPS))
    assert_band(gb, rb, case, tiles)
    assert_counts(gc[tiles], rc, rb, "B6 crossings")
    np.testing.assert_array_equal(gc, np_counts(case, fused=False)[0])


def test_plain_assign_equals_reference(case):
    prep = SimpleNamespace(pairs=SimpleNamespace(pair_pt=case.pt, pair_et=case.et),
                           n_etiles=case.n_etiles)
    tiles, etab, pin, cap = ref_assign_tables(prep, case.rank)
    ra, rn, rb = (np.asarray(a) for a in R._pip_assign_call(
        *ref_points(case, tiles), *ref_edges(case), jnp.asarray(etab),
        jnp.asarray(pin), cap=cap, n_etiles=case.n_etiles, eps=EPS,
        interpret=True))
    ga, gn, gb = (a.numpy() for a in psk.pip_assign_plain(
        *tensors(case), *csr(case, True), case.n_ptiles, EPS))
    assert_band(gb, rb, case, tiles)
    assert_counts(ga[tiles], ra, rb, "B7 assign")
    assert_counts(gn[tiles], rn, rb, "B7 count")


def test_nan_x_ends_flag_nothing_near_the_finite_end():
    """The near-flat x-span propagates NaN (torch.minimum/maximum, as the
    reference's jnp.minimum/maximum): a point within eps of a near-flat
    edge with one NaN x-end is not flagged by that edge. An x-span that
    drops the NaN end (fminf/fmaxf) flags some of the case's points, so
    the case tells the two apart; the plain version and the reference's
    pair walk (B8/B9) agree on it."""
    case = make_case("nan_edges")
    args = tensors(case)
    pt, et = (torch.from_numpy(a) for a in (case.pt, case.et))
    plain_b = psk.pip_pairs_band_plain(*args, pt, et, case.n_ptiles, EPS)
    plain_c = psk.pip_pairs_count_plain(*args, pt, et, case.n_ptiles)
    o = np.argsort(case.pt, kind="stable")
    rc, rb = R._pip_sparse_call(
        jnp.asarray(case.px), jnp.asarray(case.py),
        *[jnp.asarray(a) for a in case.edges], jnp.asarray(case.pt[o]),
        jnp.asarray(case.et[o]), n_ptiles=case.n_ptiles,
        n_etiles=case.n_etiles, eps=EPS, interpret=True)
    rb = np.asarray(rb).reshape(-1, T)
    rc = np.asarray(rc).reshape(-1, T)
    cov = np.unique(case.pt)
    assert_band(plain_b.numpy()[:-1], rb[cov], case, cov)
    assert_counts(plain_c.numpy()[cov], rc[cov], rb[cov], "B8 crossings")
    # the same pairs with the NaN-dropping x-span flag more points
    px, py = (a.reshape(-1, T) for a in args[:2])
    x1, y1, x2, y2 = (a.reshape(-1, T) for a in args[2:])
    e32 = torch.tensor(EPS, dtype=torch.float32)
    extra = 0
    for p, e in zip(pt.tolist(), et.tolist()):
        qx, qy = px[p][:, None], py[p][:, None]
        a, b, c, d = x1[e][None], y1[e][None], x2[e][None], y2[e][None]
        _, band = crossing_and_band(qx, qy, a, b, c, d, e32)
        dropped = ((torch.abs(qy - b) <= e32) & (torch.abs(qy - d) <= e32)
                   & (qx >= torch.fmin(a, c) - e32) & (qx <= torch.fmax(a, c) + e32))
        extra += int((dropped & ~band).any(1).sum())
    assert extra > 0


def test_pairs_csr_rows_every_tile_in_list_order():
    pt = torch.tensor([3, 0, 3, 1, 3, 0, 3], dtype=torch.int32)
    et = torch.tensor([7, 2, 5, 9, 7, 4, 1], dtype=torch.int32)
    rows, row_ptr, ets = psk.pairs_csr(pt, et, 5)
    assert rows.dtype == row_ptr.dtype == ets.dtype == torch.int32
    assert rows.tolist() == [0, 1, 2, 3, 4]  # empty rows 2 and 4 too
    assert row_ptr.tolist() == [0, 2, 3, 3, 7, 7]
    assert ets.tolist() == [2, 4, 9, 7, 5, 7, 1]  # duplicates kept, stable
    assert psk.row_order(row_ptr).tolist() == [3, 0, 1, 2, 4]
    empty = psk.pairs_csr(pt[:0], et[:0], 2)
    assert empty[1].tolist() == [0, 0, 0] and empty[2].numel() == 0


def test_row_order_longest_first():
    row_ptr = torch.tensor([0, 2, 7, 8, 13, 15, 15], dtype=torch.int32)
    order = psk.row_order(row_ptr)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 3, 0, 4, 2, 5]  # ties in row order


def test_tile_y_order_and_warp_ranges():
    rng = np.random.default_rng(5)
    py = rng.uniform(-1, 1, 2 * T).astype(np.float32)
    py[3] = np.nan
    py[10] = -0.0
    py[11] = 0.0
    py[12] = np.inf
    py[T:] = np.nan  # a tile of NaN points
    py[T + 7] = 0.5
    t = torch.from_numpy(py)
    order = psk.tile_y_order(t)
    q = torch.gather(t.reshape(-1, T), 1, order)
    assert torch.isnan(q[0, -1]) and q[0, -2] == np.inf
    assert (q[0, 1:-1] >= q[0, :-2]).all()  # ascending, NaN last
    assert q[1, 0] == 0.5
    assert sorted(order[0].tolist()) == list(range(T))
    ys = psk.warp_ys(t)
    w = psk.WARP_POINTS
    assert ys.shape == (2, T // w, w)
    torch.testing.assert_close(ys.reshape(2, T), q, rtol=0, atol=0, equal_nan=True)
    ymin, ymax = psk.warp_y_ranges(ys)
    assert ymin.shape == (2, T // w)
    assert ymin[0, 0] == q[0, 0] and ymax[0, -1] == np.inf
    assert ymin[1, 0] == ymax[1, 0] == 0.5
    assert ymin[1, 1] == np.inf and ymax[1, 1] == -np.inf


def test_kept_counts_match_the_mirror():
    case = make_case("eps_boundary")
    args = tensors(case)
    c = csr(case, False)
    _, kept = mirror(args, *c, None, case.n_ptiles)
    chunks, edges = psk.kept_counts(args[1], args[3], args[5],
                                    torch.from_numpy(case.pt),
                                    torch.from_numpy(case.et), EPS)
    assert chunks.shape == edges.shape == (len(case.pt),)
    assert int(chunks.sum()) * psk.CHUNK * psk.WARP_POINTS == kept["chunk"]
    assert int(edges.sum()) * psk.WARP_POINTS == kept["edge"]
    assert (edges <= chunks * psk.CHUNK).all()


def test_reached_edge_slots_hold_every_deciding_edge(case):
    """`chip_smoke.reached_edge_slots`, the edges whose x-ends B6/B7's
    data-dependent bound charges: every edge that crosses or flags a
    point of a paired tile is among them, and they are the edges that the
    kernels' rule keeps for one of those points, less those with a NaN
    y-end (whose x at py is NaN)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    args = tensors(case)
    inp = dict(pts=args[:2], edges=args[2:],
               pairs=[torch.from_numpy(a) for a in (case.pt, case.et)])
    got = cs.reached_edge_slots(torch, inp, 2.0 * float(np.float32(EPS)))
    px, py, *edges = (a.reshape(-1, T) for a in args)
    y1, y2 = edges[1], edges[3]
    decides = torch.zeros_like(got)
    kept = torch.zeros_like(got)
    e32 = torch.tensor(EPS, dtype=torch.float32)
    for p, e in zip(case.pt.tolist(), case.et.tolist()):
        q = py[p][:, None]
        c, b = crossing_and_band(px[p][:, None], q, *[a[e][None] for a in edges], e32)
        decides[e] |= (c | b).any(0)
        kept[e] |= (~out_of_reach(torch.fmin(y1[e], y2[e])[None], torch.fmax(
            y1[e], y2[e])[None], q, q, EPS) & ~torch.isnan(q)).any(0)
    assert decides.any() and not (decides & ~got).any()
    assert torch.equal(got, kept & ~torch.isnan(y1 - y2))
    assert got.sum() < got[np.unique(case.et)].numel()


def test_constants_match_the_cuda_source():
    src = (Path(psk.__file__).parent / "kernels" / "pip_layer.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kTile"] == psk.TILE
    assert const["kPerThread"] == psk.PER_THREAD
    assert const["kChunk"] == psk.CHUNK
    assert const["kThreads"] == psk.THREADS
    assert psk.THREADS * psk.PER_THREAD == psk.TILE
