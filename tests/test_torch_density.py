"""The port's density grids and the cell-dictionary kernel (B3) against the
reference package's, on the same seeded inputs.

The reference runs its Pallas kernel in interpret mode on the CPU at
`data_tile=2048` over 64x64 grids, as tests/test_density_zsparse.py does;
the port runs the plain PyTorch version of its CUDA kernel, which is what
the wrapper takes for CPU tensors. Points sit at least 1e-3 of a cell
away from every cell edge: the reference's compiled binning multiplies
by the reciprocal of the cell size where the port divides (ROADMAP
Queue C), and the two can disagree only at an edge.

Tolerances: unit-weight grids are bit-identical; weighted grids agree
within the reference bench's per-cell bound (bench.py, config 4:
3e-7 * sqrt(count) * |cell| + 0.5) and the reference test's own
rtol=1e-5, atol=1e-3, both f32 summation-order noise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.engine import density as ref_d
from geomesa_tpu.engine import density_zsparse as ref
from geomesa_tpu_torch.engine import density as port_d
from geomesa_tpu_torch.engine import density_zsparse as port

BBOX = (-60.0, -45.0, 60.0, 45.0)
W = H = 64
DT = 2048


def _morton(x, y):
    qx = ((np.asarray(x, np.float64) + 180) / 360 * (1 << 16)).astype(np.uint64)
    qy = ((np.asarray(y, np.float64) + 90) / 180 * (1 << 16)).astype(np.uint64)

    def spread(v):
        for shift, m in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                         (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                         (1, 0x5555555555555555)):
            v = (v | (v << np.uint64(shift))) & np.uint64(m)
        return v

    return spread(qx) | (spread(qy) << np.uint64(1))


def _off_edges(v, lo, d):
    """f32 values at least 1e-3 of a cell of width d from every edge."""
    u = (np.asarray(v, np.float64) - lo) / d
    f = np.clip(u - np.floor(u), 1e-3, 1 - 1e-3)
    return ((np.floor(u) + f) * d + lo).astype(np.float32)


def make(n, seed=5, z_order=True, w_=W, h_=H):
    """x, y f32 (some outside BBOX), weights in [0.5, 2), a 70% mask."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-80, 80, n)
    y = rng.uniform(-60, 60, n)
    if z_order:
        o = np.argsort(_morton(x, y))
        x, y = x[o], y[o]
    x = _off_edges(x, BBOX[0], (BBOX[2] - BBOX[0]) / w_)
    y = _off_edges(y, BBOX[1], (BBOX[3] - BBOX[1]) / h_)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mask = rng.random(n) < 0.7
    return x, y, w, mask


def jx(*arrays):
    return [jnp.asarray(a) for a in arrays]


def tx(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def assert_weighted_close(got, exp, count):
    """The bench's per-cell bound and the reference test's tolerance."""
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    tol = 3e-7 * np.sqrt(np.maximum(count, 1.0)) * np.abs(exp) + 0.5
    assert (np.abs(got - exp) <= tol).all()
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-3)


# -- kernel B3 ----------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "weights"])
def test_kernel_plain_matches_pallas(weighted):
    x, y, w, mask = make(1 << 15, seed=7)
    if not weighted:
        w = np.ones_like(w)
    lw = np.where(mask, w, 0).astype(np.float32)
    calib = port.calibrate_density(*tx(x, y, mask), BBOX, W, H, data_tile=DT)
    assert len(calib.tile_ids) > 8
    dicts = calib.dicts.numpy()
    exp = np.asarray(ref._zsparse_call(
        *jx(x, y, lw, calib.tile_ids, dicts), capd=calib.capd, bbox=BBOX,
        width=W, height=H, data_tile=DT, chunk=1024, interpret=True))
    got = port.zsparse_counts(*tx(x, y, lw, calib.tile_ids, dicts), BBOX, W,
                              H, data_tile=DT).numpy()
    assert got.shape == exp.shape == (len(calib.tile_ids), calib.capd)
    if weighted:
        counts = port.zsparse_counts(
            *tx(x, y, mask.astype(np.float32), calib.tile_ids, dicts), BBOX,
            W, H, data_tile=DT).numpy()
        assert_weighted_close(got, exp, counts)
    else:
        np.testing.assert_array_equal(got, exp)


def test_kernel_dictionary_miss_adds_nothing():
    # cells absent from a tile's dictionary (here: every other slot
    # dropped) contribute 0, as in the reference's one-hot
    x, y, w, mask = make(1 << 14, seed=3)
    lw = np.where(mask, 1.0, 0.0).astype(np.float32)
    calib = port.calibrate_density(*tx(x, y, mask), BBOX, W, H, data_tile=DT)
    d = calib.dicts.numpy()
    thin = np.where(np.arange(d.shape[1]) % 2 == 0, d, -1)
    thin = np.sort(np.where(thin < 0, np.iinfo(np.int32).max, thin), 1)
    thin = np.where(thin == np.iinfo(np.int32).max, -1, thin).astype(np.int32)
    exp = np.asarray(ref._zsparse_call(
        *jx(x, y, lw, calib.tile_ids, thin), capd=calib.capd, bbox=BBOX,
        width=W, height=H, data_tile=DT, chunk=1024, interpret=True))
    got = port.zsparse_counts(*tx(x, y, lw, calib.tile_ids, thin), BBOX, W, H,
                              data_tile=DT).numpy()
    np.testing.assert_array_equal(got, exp)
    full = port.zsparse_counts(*tx(x, y, lw, calib.tile_ids, d), BBOX, W, H,
                               data_tile=DT).numpy()
    assert got.sum() < full.sum()
    assert (got[thin < 0] == 0).all()


def test_calibration_matches_reference():
    x, y, _, mask = make(1 << 15, seed=11)
    r = ref.calibrate_density(*jx(x, y, mask), BBOX, W, H, data_tile=DT)
    p = port.calibrate_density(*tx(x, y, mask), BBOX, W, H, data_tile=DT)
    assert (p.capd, p.n_tiles) == (r.capd, r.n_tiles)
    np.testing.assert_array_equal(p.tile_ids, r.tile_ids)
    np.testing.assert_array_equal(p.dense_ids, r.dense_ids)
    np.testing.assert_array_equal(p.dicts.numpy(), np.asarray(r.dicts))


def test_cpu_wrapper_launches_nothing():
    x, y, w, mask = make(1 << 12, seed=2)
    calib = port.calibrate_density(*tx(x, y, mask), BBOX, W, H, data_tile=DT)
    before = port.zsparse_counts.launches
    port.zsparse_counts(*tx(x, y, w, calib.tile_ids), calib.dicts, BBOX, W, H,
                        data_tile=DT)
    assert port.zsparse_counts.launches == before


# -- the driver ---------------------------------------------------------------


def run_both(x, y, w, mask, w_=W, h_=H, calib=None):
    r, rc = ref.density_zsparse(*jx(x, y, w, mask), BBOX, w_, h_,
                                data_tile=DT, interpret=True)
    p, pc = port.density_zsparse(*tx(x, y, w, mask), BBOX, w_, h_,
                                 data_tile=DT, calib=calib)
    return np.asarray(r), p.numpy(), rc, pc


CASES = {
    "z_order": dict(n=1 << 15, seed=7, z_order=True),
    "random_order": dict(n=1 << 14, seed=9, z_order=False),
    "wide_grid": dict(n=1 << 14, seed=19, z_order=True, w_=96, h_=40),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "weights"])
def test_density_zsparse_matches_reference(case, weighted):
    spec = dict(CASES[case])
    w_, h_ = spec.pop("w_", W), spec.pop("h_", H)
    x, y, w, mask = make(w_=w_, h_=h_, **spec)
    if not weighted:
        w = np.ones_like(w)
    r, p, rc, pc = run_both(x, y, w, mask, w_, h_)
    np.testing.assert_array_equal(pc.tile_ids, rc.tile_ids)
    np.testing.assert_array_equal(pc.dense_ids, rc.dense_ids)
    if case == "random_order":
        assert len(pc.dense_ids) > 0  # the scatter fallback ran
    else:
        assert len(pc.tile_ids) > 0  # the dictionary kernel ran
    if weighted:
        cnt = np.asarray(ref_d.density_grid(
            *jx(x, y, np.ones_like(w), mask), BBOX, w_, h_))
        assert_weighted_close(p, r, cnt)
    else:
        np.testing.assert_array_equal(p, r)
        # and both are the scatter path's grid
        np.testing.assert_array_equal(
            p, port_d.density_grid(*tx(x, y, w, mask), BBOX, w_, h_).numpy())


def test_calibration_reuse_and_stale_recalibration():
    x, y, _, mask = make(1 << 14, seed=13)
    ones = np.ones(len(x), np.float32)
    g1, calib = port.density_zsparse(*tx(x, y, ones, mask), BBOX, W, H,
                                     data_tile=DT)
    g2, again = port.density_zsparse(*tx(x, y, ones, mask), BBOX, W, H,
                                     calib=calib, data_tile=DT,
                                     stale_exact=True)
    np.testing.assert_array_equal(g1.numpy(), g2.numpy())
    assert again is calib  # the reused plan was still valid
    # a wider mask under the old plan: points in pruned tiles and cells
    # missing from cached dictionaries would vanish, so the mass check
    # must recalibrate and return the reference's grid
    wider = mask | (np.random.default_rng(1).random(len(x)) < 0.5)
    g3, fresh = port.density_zsparse(*tx(x, y, ones, wider), BBOX, W, H,
                                     calib=calib, data_tile=DT,
                                     stale_exact=True)
    assert fresh is not calib
    stale, _ = port.density_zsparse(*tx(x, y, ones, wider), BBOX, W, H,
                                    calib=calib, data_tile=DT,
                                    check_stale=False)
    r, _ = ref.density_zsparse(*jx(x, y, ones, wider), BBOX, W, H,
                               data_tile=DT, interpret=True)
    np.testing.assert_array_equal(g3.numpy(), np.asarray(r))
    assert stale.sum() < g3.sum()  # the stale plan really drops points


def test_empty_mask():
    x, y, w, mask = make(1 << 12, seed=15)
    r, p, rc, pc = run_both(x, y, w, np.zeros_like(mask))
    assert p.sum() == 0 and r.sum() == 0
    assert len(pc.tile_ids) == 0 and len(pc.dense_ids) == 0
    assert pc.capd == rc.capd == 8


def test_all_points_outside_bbox():
    rng = np.random.default_rng(17)
    n = 1 << 12
    x = rng.uniform(100, 170, n).astype(np.float32)
    y = rng.uniform(50, 80, n).astype(np.float32)
    r, p, _, pc = run_both(x, y, np.ones(n, np.float32), np.ones(n, bool))
    assert p.sum() == 0 and r.sum() == 0 and pc.n_tiles == 2


def test_density_grid_matches_reference():
    x, y, w, mask = make(5000, seed=21, z_order=False)
    ones = np.ones_like(w)
    np.testing.assert_array_equal(
        port_d.density_grid(*tx(x, y, ones, mask), BBOX, W, H).numpy(),
        np.asarray(ref_d.density_grid(*jx(x, y, ones, mask), BBOX, W, H)))
    assert_weighted_close(
        port_d.density_grid_auto(*tx(x, y, w, mask), BBOX, W, H).numpy(),
        np.asarray(ref_d.density_grid(*jx(x, y, w, mask), BBOX, W, H)),
        np.asarray(ref_d.density_grid(*jx(x, y, ones, mask), BBOX, W, H)))


@pytest.mark.parametrize("radius", [0, 1, 2, 5])
def test_gaussian_blur_matches_reference(radius):
    rng = np.random.default_rng(radius)
    grid = (rng.random((40, 64)) * rng.integers(0, 30, (40, 64))).astype(np.float32)
    exp = np.asarray(ref_d.gaussian_blur(jnp.asarray(grid), radius))
    got = port_d.gaussian_blur(torch.from_numpy(grid), radius).numpy()
    assert got.shape == exp.shape == grid.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.sum(dtype=np.float64),
                               exp.sum(dtype=np.float64), rtol=1e-5)


def _shuffle_within_tiles(seed, dt, *arrays):
    """The arrays with each data tile's points permuted (one permutation
    for all arrays): every tile keeps its set of cells, so its dictionary
    stays valid, but a warp's 32 points fall into as many cells as they
    can."""
    rng = np.random.default_rng(seed)
    n = len(arrays[0])
    perm = np.argsort(rng.random((n // dt, dt)), axis=1)
    perm = (perm + np.arange(0, n, dt)[:, None]).reshape(-1)
    return [np.ascontiguousarray(a[perm]) for a in arrays]


def _card_case(dev, x, y, w, mask, dt, bbox, wh, ids=None, dicts=None):
    """B3 on the card against its plain version: unit weights equal,
    weights within the per-cell bound."""
    x_, y_, w_, m_ = (t.to(dev) for t in tx(x, y, w, mask))
    if dicts is None:
        calib = port.calibrate_density(x_, y_, m_, bbox, wh, wh, data_tile=dt)
        ids, dicts = calib.tile_ids, calib.dicts
    ids = torch.from_numpy(np.asarray(ids, np.int32)).to(dev)
    dicts = dicts.to(dev)
    ones = m_.float()
    lw = torch.where(m_, w_, torch.zeros_like(w_))
    got = port.zsparse_counts(x_, y_, ones, ids, dicts, bbox, wh, wh, dt)
    exp = port.zsparse_counts_plain(x_, y_, ones, ids, dicts, bbox, wh, wh, dt)
    assert torch.equal(got, exp)
    got_w = port.zsparse_counts(x_, y_, lw, ids, dicts, bbox, wh, wh, dt)
    exp_w = port.zsparse_counts_plain(x_, y_, lw, ids, dicts, bbox, wh, wh, dt)
    assert_weighted_close(got_w.cpu().numpy(), exp_w.double().cpu().numpy(),
                          got.cpu().numpy())
    return got, ids, dicts


@pytest.mark.cuda
def test_zsparse_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    x, y, w, mask = make(1 << 18, seed=7)
    # Morton order, data_tile 4096 and 2048
    got, ids, dicts = _card_case(dev, x, y, w, mask, 4096, BBOX, 256)
    _card_case(dev, x, y, w, mask, 2048, BBOX, 256)
    # shuffled inside each tile: every lane its own group
    xs, ys, ws, ms = _shuffle_within_tiles(3, 4096, x, y, w, mask)
    shuf, _, _ = _card_case(dev, xs, ys, ws, ms, 4096, BBOX, 256, ids.cpu(), dicts)
    assert torch.equal(shuf, got)
    # a tile whose 4096 points all share one cell (inside BBOX, off its
    # cell's edges)
    x1, y1 = x.copy(), y.copy()
    x1[4096:8192], y1[4096:8192] = np.float32(0.3), np.float32(0.3)
    one_cell, ids1, dicts1 = _card_case(dev, x1, y1, w, mask, 4096, BBOX, 256)
    at = int((ids1 == 1).nonzero()[0, 0])
    assert int((dicts1[at] >= 0).sum()) == 1
    assert float(one_cell[at, 0]) == float(mask[4096:8192].sum())
    # S below and above the persistent grid (repeated tiles: the kernel
    # takes any tile list)
    blocks = port.grid_blocks(dicts.shape[1])
    _card_case(dev, x, y, w, mask, 4096, BBOX, 256, ids[:3].cpu(), dicts[:3])
    reps = blocks // len(ids) + 2
    big, _, _ = _card_case(dev, x, y, w, mask, 4096, BBOX, 256,
                           ids.repeat(reps).cpu(), dicts.repeat(reps, 1))
    assert big.shape[0] > blocks and torch.equal(big[:len(ids)], got)
    # cells missing from a dictionary add nothing
    d = dicts.cpu().numpy()
    thin = np.where(np.arange(d.shape[1]) % 2 == 0, d, -1)
    thin = np.sort(np.where(thin < 0, np.iinfo(np.int32).max, thin), 1)
    thin = np.where(thin == np.iinfo(np.int32).max, -1, thin).astype(np.int32)
    miss, _, _ = _card_case(dev, x, y, w, mask, 4096, BBOX, 256, ids.cpu(),
                            torch.from_numpy(thin))
    assert float(miss.sum()) < float(got.sum())
    # the fold's own sinks against the single-sink formula, unit weights
    grid = port._fold_counts(got, dicts, 256, 256)
    sink = torch.where(dicts < 0, torch.full_like(dicts, 256 * 256), dicts)
    one = torch.zeros(256 * 256 + 1, device=dev).index_add_(
        0, sink.reshape(-1), got.reshape(-1))[:-1].reshape(256, 256)
    assert torch.equal(grid, one)
    # rows with a NaN coordinate bin to index 0 (row 0 or column 0), as
    # the reference's int32 cast makes them, in the kernel and the plain
    # version alike
    xn, yn = x.copy(), y.copy()
    rng = np.random.default_rng(8)
    i = rng.choice(len(x), 24, replace=False)
    xn[i[:8]] = np.nan
    yn[i[8:16]] = np.nan
    xn[i[16:]] = yn[i[16:]] = np.nan
    _card_case(dev, xn, yn, w, mask, 4096, BBOX, 256)
    tn = [t.to(dev) for t in tx(xn, yn, mask)]
    ones = tn[2].float()
    grid, _ = port.density_zsparse(tn[0], tn[1], ones, tn[2], BBOX, 256, 256)
    assert float(grid.sum()) == float(
        port._expected_mass(tn[0], tn[1], ones, tn[2], BBOX, 256, 256))


@pytest.mark.cuda
def test_zsparse_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    x, y, w, mask = (t.to(dev) for t in tx(*make(1 << 13, seed=4)))
    calib = port.calibrate_density(x, y, mask, BBOX, W, H, data_tile=64)
    ids = torch.from_numpy(calib.tile_ids).to(dev)
    ones = mask.float()
    with pytest.raises(ValueError, match="multiple of 32"):
        port.zsparse_counts(x[:8160], y[:8160], ones[:8160], ids[:1] * 0,
                            calib.dicts[:1], BBOX, W, H, data_tile=48)
    xa = torch.cat([torch.zeros(1, device=dev), x])[1:]  # 4 bytes off
    with pytest.raises(ValueError, match="16 bytes"):
        port.zsparse_counts(xa, y, ones, ids, calib.dicts, BBOX, W, H, 64)
    # a capd that is not a multiple of 4 is padded for the launch
    d5 = calib.dicts[:, :5].contiguous()
    got = port.zsparse_counts(x, y, ones, ids, d5, BBOX, W, H, 64)
    assert got.shape == d5.shape and torch.equal(
        got, port.zsparse_counts_plain(x, y, ones, ids, d5, BBOX, W, H, 64))
