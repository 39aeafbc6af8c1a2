"""The port's device mesh (`geomesa_tpu_torch.parallel.mesh`) and the
engine's sharded functions against the reference's, on the CPU.

The port's mesh is four `cpu` shards (one device, repeated: every
per-shard launch and every merge runs, the shards are views); the
reference's is the first 4 of the 8 CPU devices tests/conftest.py forces
on XLA. The same seeded inputs go through both, and through the port's
single-device counterpart: neighbour indices must be identical (each
case keeps its rows apart by more than the f32 noise, except where a
case places exact ties on purpose), counts exact, grids equal. One mesh
shape (D=4) throughout, so the reference compiles each sharded program
once.
"""

import jax
import numpy as np
import pytest
import torch

from geomesa_tpu.engine import density as rdens
from geomesa_tpu.engine import density_zsparse as rdz
from geomesa_tpu.engine import knn as rknn
from geomesa_tpu.engine import knn_scan as rks
from geomesa_tpu.parallel import mesh as rmesh
from geomesa_tpu_torch.engine import density as pdens
from geomesa_tpu_torch.engine import density_zsparse as pdz
from geomesa_tpu_torch.engine import knn as pknn
from geomesa_tpu_torch.engine import knn_scan as pks
from geomesa_tpu_torch.parallel import mesh as pmesh
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

D = 4
TILE = pks.DATA_TILE
K = 5


@pytest.fixture(scope="module")
def meshes():
    return rmesh.default_mesh(jax.devices()[:D]), pmesh.default_mesh(["cpu"] * D)


def points(n, seed, frac=0.4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20, 20, n).astype(np.float32)
    y = rng.uniform(-20, 20, n).astype(np.float32)
    m = rng.random(n) < frac
    qx = rng.uniform(-10, 10, 16).astype(np.float32)
    qy = rng.uniform(-10, 10, 16).astype(np.float32)
    return x, y, m, qx, qy


def T(*a):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in a]


def idx(a):
    return np.asarray(a).astype(np.int64)


# -- the mesh itself ------------------------------------------------------------


@pytest.mark.parametrize("spec, n_dev", [
    (None, 4), ("off", 4), ("none", 4), (1, 4), ("1", 4), ("auto", 1),
    ("auto", 4), (4, 4), ("4", 4), (2, 4), (4, 2), ("eight", 4)])
def test_serve_mesh_rules_equal_the_references(spec, n_dev):
    """None/"off"/1 -> no mesh, "auto" -> a mesh only over 2+ devices,
    N -> the first N (ValueError when fewer), junk -> ValueError."""
    out = {}
    for tag, mod, devs in (("ref", rmesh, jax.devices()[:n_dev]),
                           ("port", pmesh, ["cpu"] * n_dev)):
        try:
            m = mod.serve_mesh(spec, devices=devs)
            out[tag] = None if m is None else int(m.devices.size)
        except ValueError:
            out[tag] = "ValueError"
    assert out["port"] == out["ref"]


def test_mesh_value_equality_shape_and_passthrough(meshes):
    rm, pm = meshes
    again = pmesh.default_mesh(["cpu"] * D)
    assert again == pm and hash(again) == hash(pm) and again is not pm
    assert pmesh.default_mesh(["cpu"] * 2) != pm
    assert str(tuple(pm.devices.shape)) == str(tuple(rm.devices.shape)) == "(4,)"
    assert pmesh.serve_mesh(pm) is pm
    assert pm.lead == torch.device("cpu") and not pm.spans_devices


def test_sharded_placement_and_views(meshes):
    """`shard_device_batch` cuts the feature axis into D views of the
    whole tensors (the CSR tables stay replicated), `shard_view` returns
    a shard's rows, `shard_batch_host` pads to a multiple of D."""
    from geomesa_tpu_torch.core.columnar import FeatureBatch
    from geomesa_tpu_torch.core.sft import SimpleFeatureType

    _, pm = meshes
    sft = SimpleFeatureType.from_spec("t", "v:Double,*geom:Point")
    rng = np.random.default_rng(1)
    b = FeatureBatch.from_pydict(sft, {"v": rng.uniform(0, 1, 10),
                                       "geom": rng.uniform(-5, 5, (10, 2))})
    dev = pmesh.shard_batch_host(b, pm)
    x = dev["geom__x"]
    assert isinstance(x, pmesh.Sharded) and x.shape == (12,) and x.shard_rows == 3
    whole = x.full()
    for i in range(D):
        assert torch.equal(pmesh.shard_view(x, i, 3), whole[3 * i:3 * i + 3])
        assert torch.equal(pmesh.shard_view(whole, i, 3, torch.device("cpu")),
                           x.shards[i])
    assert torch.equal(whole[:10], torch.from_numpy(
        b.columns["geom"].x.astype(np.float32)))
    assert not dev["__valid__"].full()[10:].any()
    base = torch.arange(16.0)
    views = pmesh.shards_of(pm, base)
    assert all(v.data_ptr() == base.data_ptr() + 16 * i
               for i, v in enumerate(views))  # no copy on a repeated device
    rep = pmesh.replicated(pm, base)
    assert len(rep) == D and all(r is base for r in rep)
    with pytest.raises(ValueError):
        pmesh.shards_of(pm, torch.arange(10.0))


# -- the sharded kNN programs ---------------------------------------------------


def test_knn_sparse_sharded_equals_reference_and_single(meshes):
    rm, pm = meshes
    x, y, m, qx, qy = points(D * TILE, seed=2, frac=0.002)
    rd, ri, rov = rks.knn_sparse_sharded(rm, qx, qy, x, y, m, k=K,
                                         tile_capacity=4, interpret=True)
    pd, pi, pov = pks.knn_sparse_sharded(pm, *T(qx, qy, x, y, m), k=K,
                                         tile_capacity=4)
    sd, si, _ = pks.knn_sparse_scan(*T(qx, qy, x, y, m), k=K, tile_capacity=4)
    np.testing.assert_array_equal(idx(pi), idx(ri))
    np.testing.assert_array_equal(idx(pi), idx(si))
    np.testing.assert_array_equal(pd.numpy(), sd.numpy())  # same per-pair f32
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-6)
    assert bool(pov) == bool(rov) is False


def test_serve_program_overflow_count_and_fallback(meshes):
    """The mesh serving program: the any-shard overflow flag, the summed
    fused count and the match-tile calibration as the reference's, and
    the dense sharded fallback's answers the single-device scan's."""
    rm, pm = meshes
    x, y, m, qx, qy = points(D * 2 * TILE, seed=3, frac=0.3)
    rrun = rks.make_knn_serve_sharded(rm)
    rd, ri, rov, rcnt = rrun(qx, qy, x, y, m, K, 1, 64, True, True)
    pd, pi, pov, pcnt = pks.make_knn_serve_sharded(pm)(
        *T(qx, qy, x, y, m), k=K, tile_capacity=1, want_count=True)
    assert bool(pov) == bool(rov) is True
    assert int(pcnt) == int(rcnt) == int(m.sum())
    assert int(pks.shard_match_tiles(torch.from_numpy(m), D)) == int(
        rks.shard_match_tiles(m, D)) == 2
    # the fallback against the single-device dense scan (whose plain B2
    # tests/test_torch_knn_scan.py holds to the reference's)
    pfd, pfi = pks.make_knn_fullscan_sharded(pm)(*T(qx, qy, x, y, m), k=K)
    sd, si = pks.knn_fullscan(*T(qx, qy, x, y, m), k=K)
    np.testing.assert_array_equal(idx(pfi), idx(si))
    np.testing.assert_array_equal(pfd.numpy(), sd.numpy())


@pytest.mark.parametrize("fn", ["knn_sharded", "knn_compact_sharded", "knn_ring"])
def test_knn_mesh_functions_equal_reference_and_single(meshes, fn):
    """Also the merge pool's tie order: each of four queries has its
    nearest point copied into shards 3, 1 and 2 (equal distances in
    different shards); the lower shard's copy ranks first, as in the
    reference, whose pool holds shard 0's k, then shard 1's, ... (the
    ring: the first shard its fold visits)."""
    rm, pm = meshes
    x, y, m, qx, qy = points(4096, seed=4)
    s = 4096 // D
    for q in range(4):
        for sh in (3, 1, 2):
            x[sh * s + 10 + q], y[sh * s + 10 + q] = qx[q] + 0.01, qy[q]
            m[sh * s + 10 + q] = True
    sd, si = pknn.knn(*T(qx, qy, x, y, m), k=K)
    si = idx(si)
    if fn == "knn_sharded":
        r = rknn.knn_sharded(rm, qx, qy, x, y, m, k=K, debug_check=True)
        p = pknn.knn_sharded(pm, *T(qx, qy, x, y, m), k=K, debug_check=True)
    elif fn == "knn_compact_sharded":
        r = rknn.knn_compact_sharded(rm, qx, qy, x, y, m, k=K, capacity=512)
        p = pknn.knn_compact_sharded(pm, *T(qx, qy, x, y, m), k=K, capacity=512)
        assert bool(p[2]) == bool(r[2]) is False
    else:
        r = rknn.knn_ring(rm, qx, qy, x, y, m, k=K)
        p = pknn.knn_ring(pm, *T(qx, qy, x, y, m), k=K)
        assert isinstance(p[0], pmesh.Sharded)
        p = (p[0].full(), p[1].full())
    np.testing.assert_array_equal(idx(p[1]), idx(r[1]))
    if fn == "knn_ring":
        # the ring folds the visiting shards in ring order (shard 0's
        # queries see data shards 0, 3, 2, 1), so its ties go to the
        # first shard visited, in both packages: the sets are equal
        np.testing.assert_array_equal(np.sort(idx(p[1]), 1), np.sort(si, 1))
        assert idx(p[1])[0, :3].tolist() == [3 * s + 10, 2 * s + 10, s + 10]
    else:
        np.testing.assert_array_equal(idx(p[1]), si)
        assert idx(p[1])[0, :3].tolist() == [s + 10, 2 * s + 10, 3 * s + 10]
    # the same per-pair f32 haversine on every route
    np.testing.assert_array_equal(np.asarray(p[0]), sd.numpy())
    # XLA's and PyTorch's f32 haversines differ by a few ulps
    np.testing.assert_allclose(np.asarray(p[0]), np.asarray(r[0]), rtol=1e-5,
                               atol=0.05)


def test_compact_sharded_overflow_equals_reference(meshes):
    rm, pm = meshes
    x, y, m, qx, qy = points(4096, seed=5)
    _, _, rov = rknn.knn_compact_sharded(rm, qx, qy, x, y, m, k=K, capacity=64)
    _, _, pov = pknn.knn_compact_sharded(pm, *T(qx, qy, x, y, m), k=K,
                                         capacity=64)
    assert bool(pov) == bool(rov) is True


@pytest.mark.parametrize("fn", ["knn_sharded", "knn_ring", "knn_sparse_sharded"])
def test_nan_row_in_one_shard_equals_reference(meshes, fn):
    """NaN rows (masked in) in shard 1, among fewer live rows than k:
    whatever each shard's fold returns, the reference's merge (`top_k`
    over the gathered pool) ranks a NaN distance after +inf, so the
    results hold no NaN, and the port's stable re-top-k does the same.
    (The port's single-device `knn` ranks NaN first on this input, where
    the reference's jitted fold drops it: ROADMAP Reference caveats.)"""
    rm, pm = meshes
    n = D * TILE if fn == "knn_sparse_sharded" else 4096
    s = n // D
    x, y, _, qx, qy = points(n, seed=6)
    m = np.zeros(n, bool)
    m[[3, s + 5, s + 9, 3 * s + 7]] = True  # fewer live rows than k
    x[[s + 5, s + 9]] = np.nan
    if fn == "knn_sparse_sharded":
        r = rks.knn_sparse_sharded(rm, qx, qy, x, y, m, k=K,
                                   tile_capacity=4, interpret=True)
        p = pks.knn_sparse_sharded(pm, *T(qx, qy, x, y, m), k=K,
                                   tile_capacity=4)
    elif fn == "knn_sharded":
        r = rknn.knn_sharded(rm, qx, qy, x, y, m, k=K, debug_check=True)
        p = pknn.knn_sharded(pm, *T(qx, qy, x, y, m), k=K, debug_check=True)
    else:
        r = rknn.knn_ring(rm, qx, qy, x, y, m, k=K)
        p = pknn.knn_ring(pm, *T(qx, qy, x, y, m), k=K)
        p = (p[0].full(), p[1].full())
    rd, pd = np.asarray(r[0]), np.asarray(p[0])
    assert not np.isnan(rd).any() and not np.isnan(pd).any()
    assert np.isinf(rd).any()  # fewer live rows than k: the padding shows
    np.testing.assert_array_equal(np.isinf(pd), np.isinf(rd))
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(idx(p[1])[fin], idx(r[1])[fin])


def test_merge_pool_keeps_pool_order_on_ties(meshes):
    """Within a shard's own k the pool keeps its order too: all-equal
    distances return pool positions 0, 1, 2 (shard 0's local 1 and 0,
    then shard 1's local 1 lifted by shard_n=4), not the lowest indices,
    as the reference's `top_k` over the gathered pool does."""
    _, pm = meshes
    _, gi = pks._shard_merge_topk(pm, [torch.zeros((1, 2))] * D,
                                  [torch.tensor([[1, 0]])] * D, 4, 3)
    assert gi.tolist() == [[1, 0, 5]]


# -- density ------------------------------------------------------------------


def test_density_sharded_equals_reference_and_single(meshes):
    rm, pm = meshes
    x, y, m, _, _ = points(4096, seed=8)
    w = np.random.default_rng(8).uniform(0, 3, 4096).astype(np.float32)
    bbox = (-20.0, -20.0, 20.0, 20.0)
    for weights in (np.ones_like(w), w):
        rg = np.asarray(rdens.density_sharded(rm, x, y, weights, m, bbox, 32, 16))
        pg = pdens.density_sharded(pm, *T(x, y, weights, m), bbox, 32, 16).numpy()
        sg = pdens.density_grid(*T(x, y, weights, m), bbox, 32, 16).numpy()
        if weights is w:  # the shards' sums add in another order
            np.testing.assert_allclose(pg, sg, rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(pg, rg, rtol=1e-6, atol=1e-5)
        else:  # counts: exact
            np.testing.assert_array_equal(pg, sg)
            np.testing.assert_array_equal(pg, rg)


def test_density_zsparse_sharded_equals_reference_and_single(meshes):
    """Z-ordered rows (one global calibration, B3 per shard over padded
    tile lists, the scatter for the overflow tiles): counts exact."""
    rm, pm = meshes
    n = D * pdz.DATA_TILE
    rng = np.random.default_rng(9)
    x = rng.uniform(-20, 20, n).astype(np.float32)
    y = rng.uniform(-20, 20, n).astype(np.float32)
    cell = np.floor((y + 20) / 1.25) * 32 + np.floor((x + 20) / 1.25)
    order = np.argsort(cell, kind="stable")  # store order: ~256 cells a tile
    x, y = x[order], y[order]
    x[:3000] = rng.uniform(-20, 20, 3000)  # a cell-dense tile: the scatter
    y[:3000] = rng.uniform(-20, 20, 3000)
    m = rng.random(n) < 0.7
    ones = np.ones(n, np.float32)
    bbox = (-20.0, -20.0, 20.0, 20.0)
    rg = np.asarray(rdz.density_zsparse_sharded(rm, x, y, ones, m, bbox, 32, 32,
                                                interpret=True))
    pg = pdz.density_zsparse_sharded(pm, *T(x, y, ones, m), bbox, 32, 32).numpy()
    sg, calib = pdz.density_zsparse(*T(x, y, ones, m), bbox, 32, 32)
    assert len(calib.tile_ids) and len(calib.dense_ids)
    np.testing.assert_array_equal(pg, rg)
    np.testing.assert_array_equal(pg, sg.numpy())
    assert pg.sum() == m.sum()
