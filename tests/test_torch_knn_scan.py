"""The port's kNN scan (geomesa_tpu_torch.engine.knn_scan) against the
reference package's, on the same seeded inputs.

The reference runs its Pallas kernels in interpret mode on the CPU, at
the small TINY tiling of tests/test_knn_scan.py; the port runs the plain
PyTorch versions of its CUDA kernels, which are what its wrappers take
for CPU tensors. Tolerances: block minima within 1e-5 absolute (real
keys satisfy |key| <= 12, so this is a few f32 ulps of association
order), dead slots exactly 1e9, kNN distances within rtol 1e-6 (the two
packages' f32 trig may differ in the last ulp), neighbour sets identical
up to equal-distance swaps.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.engine import geodesy as ref_geo
from geomesa_tpu.engine import knn as ref_knn
from geomesa_tpu.engine import knn_scan as ref
from geomesa_tpu_torch.engine import geodesy as port_geo
from geomesa_tpu_torch.engine import knn as port_knn
from geomesa_tpu_torch.engine import knn_scan as port

TINY = dict(blk=256, data_tile=2048)


def make(n, q, seed=7, sorted_x=False, sel=0.4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n)
    if sorted_x:
        x = np.sort(x)
    y = rng.uniform(-90, 90, n)
    mask = rng.random(n) < sel
    qx = rng.uniform(-30, 30, q)
    qy = rng.uniform(-60, 60, q)
    return qx, qy, x, y, mask


def jx(*arrays):
    return [jnp.asarray(a, jnp.float32) if a.dtype != bool else jnp.asarray(a)
            for a in arrays]


def tx(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) if a.dtype != bool
            else torch.from_numpy(a) for a in arrays]


def assert_same_knn(rd, ri, pd, pi):
    """Identical neighbour sets (equal-distance swaps allowed) and f32
    distances within rtol 1e-6."""
    rd, ri = np.asarray(rd), np.asarray(ri)
    pd, pi = np.asarray(pd), np.asarray(pi)
    assert rd.shape == pd.shape
    np.testing.assert_allclose(np.sort(pd, 1), np.sort(rd, 1), rtol=1e-6)
    for i in range(len(rd)):
        fin = np.isfinite(rd[i])
        a = dict(zip(ri[i][fin].tolist(), rd[i][fin].tolist()))
        b = dict(zip(pi[i][np.isfinite(pd[i])].tolist(),
                     pd[i][np.isfinite(pd[i])].tolist()))
        if a.keys() != b.keys():
            # only ties at the k-th distance may swap members
            kth = max(a.values())
            for j in a.keys() ^ b.keys():
                assert abs(a.get(j, b.get(j)) - kth) <= 1e-6 * kth, (i, j)


class TestBlockMinima:
    @pytest.mark.parametrize("seed", [3, 11])
    def test_dense_plain_matches_reference(self, seed):
        rng = np.random.default_rng(seed)
        n, q = 3 * 2048, 8
        x = rng.uniform(-180, 180, n)
        y = rng.uniform(-90, 90, n)
        mf = (rng.random(n) < 0.5).astype(np.float32)
        mf[2048:4096] = 0.0  # one tile with no match
        qx = rng.uniform(-30, 30, q)
        qy = rng.uniform(30, 60, q)
        rm, rc = ref.chord_blockmin(*jx(qx, qy, x, y, mf), interpret=True, **TINY)
        pm, pc = port.chord_blockmin(*tx(qx, qy, x, y, mf), **TINY)
        rm, pm = np.asarray(rm), pm.numpy()
        assert pm.shape == rm.shape == (q, n // 256)
        assert np.abs(pm - rm).max() <= 1e-5
        np.testing.assert_allclose(pc.numpy(), np.asarray(rc), atol=1e-6)
        # all-masked blocks are exactly the penalty in both
        assert (pm[:, 8:16] == 1e9).all() and (rm[:, 8:16] == 1e9).all()

    def test_sparse_plain_matches_reference_and_dead_slots(self):
        rng = np.random.default_rng(5)
        n, q = 4 * 2048, 6
        x = rng.uniform(-180, 180, n)
        y = rng.uniform(-90, 90, n)
        mf = (rng.random(n) < 0.3).astype(np.float32)
        qx = rng.uniform(-30, 30, q)
        qy = rng.uniform(-60, 60, q)
        ids = np.array([1, 3, 0, 0], np.int32)
        rm, _ = ref.chord_blockmin_sparse(
            *jx(qx, qy, x, y, mf), jnp.asarray(ids), jnp.int32(2),
            interpret=True, **TINY)
        pm, _ = port.chord_blockmin_sparse(
            *tx(qx, qy, x, y, mf), torch.from_numpy(ids),
            torch.tensor([2], dtype=torch.int32), **TINY)
        rm, pm = np.asarray(rm), pm.numpy()
        assert pm.shape == rm.shape == (q, 4 * 8)
        assert np.abs(pm[:, :16] - rm[:, :16]).max() <= 1e-5
        assert (pm[:, 16:] == 1e9).all() and (rm[:, 16:] == 1e9).all()

    def test_nan_rows_plain_matches_reference(self):
        """A row with a NaN coordinate makes its block's minimum NaN in the
        reference (its min propagates NaN) and in the plain version
        (torch.amin), which the CUDA kernel must equal (min.NaN.f32)."""
        rng = np.random.default_rng(19)
        n, q = 2 * 2048, 4
        x = rng.uniform(-180, 180, n)
        y = rng.uniform(-90, 90, n)
        x[[3, 700, 2048 + 511]] = np.nan
        y[1500] = np.nan
        mf = (rng.random(n) < 0.5).astype(np.float32)
        qx = rng.uniform(-30, 30, q)
        qy = rng.uniform(30, 60, q)
        rm, _ = ref.chord_blockmin(*jx(qx, qy, x, y, mf), interpret=True, **TINY)
        pm, _ = port.chord_blockmin(*tx(qx, qy, x, y, mf), **TINY)
        rm, pm = np.asarray(rm), pm.numpy()
        nan = np.isnan(rm)
        assert nan.sum() == 4 * q  # blocks 0, 2, 5 and 9: every query
        np.testing.assert_array_equal(np.isnan(pm), nan)
        assert np.abs(pm[~nan] - rm[~nan]).max() <= 1e-5

    def test_bad_tiling_is_refused(self):
        qx, qy, x, y, mask = make(3000, 2)
        with pytest.raises(ValueError, match="tiling"):
            port.chord_blockmin(*tx(qx, qy, x, y, mask.astype(np.float32)), **TINY)

    def test_cuda_launch_count_only_moves_on_the_card(self):
        qx, qy, x, y, mask = make(2048, 2)
        before = port.chord_blockmin.launches
        port.chord_blockmin(*tx(qx, qy, x, y, mask.astype(np.float32)), **TINY)
        assert port.chord_blockmin.launches == before


CASES = {
    "random_mask": dict(n=6000, q=24, k=5, m_blocks=8),
    "sorted_bbox": dict(n=16384, q=12, k=5, m_blocks=8, sorted_x=True,
                        band=(-60, 60)),
    "fewer_than_k": dict(n=4096, q=8, k=6, m_blocks=8, only=[5, 99, 3000]),
    "empty": dict(n=4096, q=4, k=3, m_blocks=8, only=[]),
    "wide_k": dict(n=8192, q=10, k=16, m_blocks=16, sel=0.05),
}


def _case(spec):
    qx, qy, x, y, mask = make(spec["n"], spec["q"], sorted_x=spec.get("sorted_x", False),
                              sel=spec.get("sel", 0.4))
    if "band" in spec:
        mask = (x > spec["band"][0]) & (x < spec["band"][1])
    if "only" in spec:
        mask = np.zeros(spec["n"], bool)
        mask[spec["only"]] = True
    return qx, qy, x, y, mask


class TestKnnParity:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_fullscan(self, name):
        spec = CASES[name]
        qx, qy, x, y, mask = _case(spec)
        rd, ri = ref.knn_fullscan(*jx(qx, qy, x, y, mask), k=spec["k"],
                                  m_blocks=spec["m_blocks"], interpret=True, **TINY)
        pd, pi = port.knn_fullscan(*tx(qx, qy, x, y, mask), k=spec["k"],
                                   m_blocks=spec["m_blocks"], **TINY)
        assert_same_knn(rd, ri, pd, pi)

    @pytest.mark.parametrize("cap", [2, 8])
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_sparse(self, name, cap):
        spec = CASES[name]
        qx, qy, x, y, mask = _case(spec)
        rd, ri, rov = ref.knn_sparse_scan(
            *jx(qx, qy, x, y, mask), k=spec["k"], tile_capacity=cap,
            m_blocks=spec["m_blocks"], interpret=True, **TINY)
        pd, pi, pov = port.knn_sparse_scan(
            *tx(qx, qy, x, y, mask), k=spec["k"], tile_capacity=cap,
            m_blocks=spec["m_blocks"], **TINY)
        assert bool(rov) == bool(pov)
        assert_same_knn(rd, ri, pd, pi)

    @pytest.mark.parametrize("fn", ["knn_fullscan", "knn_sparse_scan"])
    def test_k_above_m_blocks_is_refused(self, fn):
        qx, qy, x, y, mask = make(2048, 4)
        kw = {"tile_capacity": 4} if fn == "knn_sparse_scan" else {}
        with pytest.raises(ValueError, match="m_blocks"):
            getattr(ref, fn)(*jx(qx, qy, x, y, mask), k=9, m_blocks=8,
                             interpret=True, **kw, **TINY)
        with pytest.raises(ValueError, match="m_blocks"):
            getattr(port, fn)(*tx(qx, qy, x, y, mask), k=9, m_blocks=8,
                              **kw, **TINY)

    def test_fullscan_tiled_over_query_tiles(self):
        qx, qy, x, y, mask = make(4096, 40)
        rd, ri = ref.knn_fullscan_tiled(*jx(qx, qy, x, y, mask), k=3,
                                        m_blocks=4, query_tile=16, interpret=True)
        pd, pi = port.knn_fullscan_tiled(*tx(qx, qy, x, y, mask), k=3,
                                         m_blocks=4, query_tile=16)
        assert pd.shape == (40, 3)
        assert_same_knn(rd, ri, pd, pi)


def test_sparse_dead_slots_never_duplicate_tile0():
    # capacity-padding slots alias data tile 0; with fewer real blocks
    # than m_blocks their PENALTY minima must not duplicate tile-0 lanes
    rng = np.random.default_rng(13)
    n, q, k = 8192, 6, 4
    x = np.sort(rng.uniform(-180, 180, n))
    y = rng.uniform(-90, 90, n)
    mask = np.zeros(n, bool)
    mask[:6] = True  # all matches in tile 0, fewer than k*blk
    qx = rng.uniform(-30, 30, q)
    qy = rng.uniform(-60, 60, q)
    pd, pi, ov = port.knn_sparse_scan(*tx(qx, qy, x, y, mask), k=k,
                                      tile_capacity=8, m_blocks=8, **TINY)
    assert not bool(ov)
    pd, pi = pd.numpy(), pi.numpy()
    for i in range(q):
        fin = np.isfinite(pd[i])
        assert fin.sum() == k  # 6 matches exist, k=4 all fillable
        assert len(set(pi[i][fin].tolist())) == int(fin.sum())
    rd, ri, _ = ref.knn_sparse_scan(*jx(qx, qy, x, y, mask), k=k,
                                    tile_capacity=8, m_blocks=8,
                                    interpret=True, **TINY)
    assert_same_knn(rd, ri, pd, pi)


# -- B1's schedule ------------------------------------------------------------

KERNEL_SRC = Path(port.__file__).parent / "kernels" / "chord_blockmin.cu"


def kernel_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", KERNEL_SRC.read_text())[1])


def blockmin_chunks(slots, nbt, live, grid, blk):
    """The schedule of `kernels/chord_blockmin.cu`'s kernel: chunks of cb
    <= kMaxBlocks blk-blocks and at most kChunkPts points, cpt of them a
    slot of nbt blocks; the live slots' chunks, min(live, slots) * cpt of
    them, cut into `grid` contiguous near-equal runs. Returns each block's
    chunks as (slot, first block in the slot, blocks)."""
    cb = max(1, min(kernel_constant("kMaxBlocks"), kernel_constant("kChunkPts") // blk))
    cpt = -(-nbt // cb)
    n = max(0, min(live, slots)) * cpt
    return [[(ch // cpt, ch % cpt * cb, min(cb, nbt - ch % cpt * cb))
             for ch in range(n * b // grid, n * (b + 1) // grid)]
            for b in range(grid)]


def mirror_sparse(args, tile_ids, n_sel, blk, data_tile, grid):
    """B1 as the kernel walks it: each block's chunks read their points
    from the slot's data tile and write their minima to the slot's
    columns; the dead slots' columns are set to PENALTY. Returns (out,
    points read per data tile, writes per column, chunks per block)."""
    qx, qy, x, y, maskf = args
    aug, c = port._aug_q(qx, qy)
    nbt, slots = data_tile // blk, tile_ids.shape[0]
    out = torch.full((qx.shape[0], slots * nbt), float("nan"))
    reads = torch.zeros(x.shape[0] // data_tile, dtype=torch.int64)
    writes = torch.zeros(slots * nbt, dtype=torch.int64)
    schedule = blockmin_chunks(slots, nbt, n_sel, grid, blk)
    for chunks in schedule:
        for slot, b0, nb in chunks:
            tile = int(tile_ids[slot])
            sl = slice(tile * data_tile + b0 * blk, tile * data_tile + (b0 + nb) * blk)
            col = slot * nbt + b0
            out[:, col:col + nb] = port._blockmin_plain(aug, c, x[sl], y[sl], maskf[sl], blk)
            reads[tile] += nb * blk
            writes[col:col + nb] += 1
    dead = min(n_sel, slots) * nbt
    out[:, dead:] = port.PENALTY
    writes[dead:] += 1
    return out, reads, writes, [len(ch) for ch in schedule]


@pytest.mark.parametrize("blk", [32, 128, 2048])
@pytest.mark.parametrize("n_sel", [0, 1, 5, 6, 11])
def test_sparse_schedule_mirror_equals_plain(n_sel, blk):
    """B1's schedule over C = 6 slots of 4096-point tiles (n_sel 0, 1,
    C - 1, C and the overflow C + 5, which leaves every slot live and must
    not walk past the list), shared by 5 blocks, Q = 37: every live
    column is written once with the plain version's minima (within 1e-5),
    the dead columns are exactly 1e9, and the points read are the live
    slots' tiles, once each; tile 0, which the dead slots alias, is never
    read."""
    data_tile, slots, ntiles, grid = 4096, 6, 9, 5
    qx, qy, x, y, mask = make(ntiles * data_tile, 37, seed=blk + n_sel)
    rng = np.random.default_rng(n_sel)
    ids = np.zeros(slots, np.int32)
    listed = min(n_sel, slots)
    ids[:listed] = np.sort(rng.choice(np.arange(1, ntiles), listed, replace=False))
    args = tx(qx, qy, x, y, mask.astype(np.float32))
    tile_ids = torch.from_numpy(ids)
    got, reads, writes, shares = mirror_sparse(args, tile_ids, n_sel, blk, data_tile, grid)
    exp, _ = port.chord_blockmin_sparse_plain(
        *args, tile_ids, torch.tensor([n_sel], dtype=torch.int32), blk=blk,
        data_tile=data_tile)
    assert got.shape == exp.shape == (37, slots * data_tile // blk)
    assert float((got - exp).abs().max()) <= 1e-5
    assert bool((got[:, listed * data_tile // blk:] == port.PENALTY).all())
    assert bool((writes == 1).all())
    expect = torch.zeros(ntiles, dtype=torch.int64)
    expect[ids[:listed]] = data_tile
    assert torch.equal(reads, expect) and int(reads[0]) == 0
    assert max(shares) - min(shares) <= 1


class TestCapacity:
    @pytest.mark.parametrize("hit", [0, 1, 7, 51, 52, 64, 100, 1000, 4097])
    def test_capacity_bucket(self, hit):
        assert port.capacity_bucket(hit) == ref.capacity_bucket(hit)

    @pytest.mark.parametrize("sel", [0.0, 0.0001, 0.3, 1.0])
    def test_count_match_tiles(self, sel):
        rng = np.random.default_rng(int(sel * 1e4))
        mask = rng.random(5 * 16384 + 77) < sel
        assert int(port.count_match_tiles(torch.from_numpy(mask))) == \
            int(ref.count_match_tiles(jnp.asarray(mask)))

    def test_sparse_launch_finish_overflow_falls_back(self):
        qx, qy, x, y, _ = make(40000, 6, sorted_x=True)
        mask = np.ones(40000, bool)
        args = tx(qx, qy, x, y, mask)
        fd, fi, ov, cap = port.knn_sparse_launch(*args, k=5, tile_capacity=1)
        assert cap == 1 and bool(ov)
        d, i, used, extra = port.knn_sparse_finish(
            fd, fi, ov, *args, k=5, tile_capacity=cap,
            extra=(torch.tensor(7),))
        assert used == -1 and int(extra[0]) == 7 and i.dtype == np.int32
        rd, ri = ref.knn_fullscan(*jx(qx, qy, x, y, mask), k=5, interpret=True)
        assert_same_knn(rd, ri, d, i)


class TestSelection:
    def test_topk_ties_and_padding_follow_lax_top_k(self):
        d = np.array([[3.0, 1.0, 1.0, np.inf, 1.0, 2.0],
                      [np.inf] * 6], np.float32)
        for k in (2, 4, 9):
            rv, ri = ref_knn._topk_smallest(jnp.asarray(d), k)
            pv, pi = port_knn._topk_smallest(torch.from_numpy(d), k)
            np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
            np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))

    def test_twolevel_matches_reference(self):
        rng = np.random.default_rng(2)
        d = np.round(rng.random((3, 128 * 40)), 2).astype(np.float32)  # ties
        rv, ri = ref_knn._twolevel_smallest(jnp.asarray(d), 16)
        pv, pi = port_knn._twolevel_smallest(torch.from_numpy(d), 16)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))

    def test_unit3_and_haversine(self):
        rng = np.random.default_rng(4)
        lon = rng.uniform(-180, 180, 500)
        lat = rng.uniform(-90, 90, 500)
        np.testing.assert_allclose(
            port_knn._unit3(*tx(lon, lat)).numpy(),
            np.asarray(ref_knn._unit3(*jx(lon, lat))), atol=1e-6)
        np.testing.assert_allclose(
            port_geo.haversine_m(*tx(lon[:250], lat[:250], lon[250:], lat[250:])).numpy(),
            np.asarray(ref_geo.haversine_m(*jx(lon[:250], lat[:250], lon[250:], lat[250:]))),
            rtol=1e-5)
        np.testing.assert_array_equal(
            port_geo.haversine_m_np(lon[:250], lat[:250], lon[250:], lat[250:]),
            ref_geo.haversine_m_np(lon[:250], lat[:250], lon[250:], lat[250:]))


def test_exact_refine_matches_reference():
    rng = np.random.default_rng(41)
    n, k, pad = 1 << 12, 5, 8
    x = rng.uniform(9.99, 10.01, n)
    y = rng.uniform(44.99, 45.01, n)
    qx, qy = np.array([10.0, 10.002]), np.array([45.0, 45.001])
    mask = np.ones(n, bool)
    fd, fi = port.knn_fullscan(*tx(qx, qy, x, y, mask), k=k + pad)
    got = port.knn_exact_refine(qx, qy, x, y, fd.numpy(), fi.numpy(), k)
    exp = ref.knn_exact_refine(qx, qy, x, y, fd.numpy(), fi.numpy(), k)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)
    np.testing.assert_array_equal(port.knn_f32_err_m([0.0, 1e5, 2e7]),
                                  ref.knn_f32_err_m([0.0, 1e5, 2e7]))


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [32, 128, 2048])
@pytest.mark.parametrize("tiles", [1, 16])
@pytest.mark.parametrize("q", [1, 37, 64, 256])
def test_kernels_match_plain_on_the_card(q, tiles, blk):
    """B2 (dense) and B1 (sparse, at 16 tiles, with 3 of 4 slots live, none
    and n_sel past the list) against their plain versions, within 1e-5,
    dead columns exactly 1e9: Q below, at and off the 32 queries a warp's
    lanes hold and the 256 a block holds; one data tile and 16; blk at
    both ends of what `_check_tiling` takes (a chunk of 16 blocks, of 2048
    points in one block's 8 segments). NaN rows make their blocks' minima
    NaN in both."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    n = tiles * 16384
    qx, qy, x, y, mask = make(n, q)
    args = [a.to(dev) for a in tx(qx, qy, x, y, mask.astype(np.float32))]
    got, _ = port.chord_blockmin(*args, blk=blk)
    exp, _ = port.chord_blockmin_plain(*args, blk=blk)
    assert got.shape == exp.shape == (q, n // blk)
    assert float((got - exp).abs().max()) <= 1e-5
    ids = torch.tensor([2, 5, 9, 0], dtype=torch.int32, device=dev)
    n_sel = torch.tensor([3], dtype=torch.int32, device=dev)
    # 3 live slots (the dead one aliases tile 0), none, and the overflow
    # (n_sel past the list: every slot live)
    for live in ((3, 0, len(ids) + 3) if tiles == 16 else ()):
        ns = torch.tensor([live], dtype=torch.int32, device=dev)
        got, _ = port.chord_blockmin_sparse(*args, ids, ns, blk=blk)
        exp, _ = port.chord_blockmin_sparse_plain(*args, ids, ns, blk=blk)
        assert float((got - exp).abs().max()) <= 1e-5
        dead = got[:, min(live, len(ids)) * (16384 // blk):]
        assert bool((dead == port.PENALTY).all())
    # rows with a NaN coordinate: their blocks' minima are NaN, as the
    # plain version's torch.amin (and the reference's min) take them
    x_nan = args[2].clone()
    x_nan[[i for i in (5, 300, 16384 + 77, 5 * 16384 + 128 * 3) if i < n]] = float("nan")
    nan_args = [args[0], args[1], x_nan, *args[3:]]
    checks = [(port.chord_blockmin(*nan_args, blk=blk)[0],
               port.chord_blockmin_plain(*nan_args, blk=blk)[0])]
    if tiles == 16:
        checks.append((port.chord_blockmin_sparse(*nan_args, ids, n_sel, blk=blk)[0],
                       port.chord_blockmin_sparse_plain(*nan_args, ids, n_sel, blk=blk)[0]))
    for got, exp in checks:
        nan = torch.isnan(exp)
        assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
        assert float((got[~nan] - exp[~nan]).abs().max()) <= 1e-5
