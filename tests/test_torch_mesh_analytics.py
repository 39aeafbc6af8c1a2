"""The engine's other sharded analytics on the port against the
reference's, on the CPU: `knn_indexed_sharded`, `stats_sharded`,
`tube_select_sharded`, `tube_select_pruned_sharded`,
`polygon_density_sharded` and `pip_layer_sharded`.

The port's mesh is four `cpu` shards; the reference's the first 4 of the
8 CPU devices tests/conftest.py forces on XLA (its Pallas kernel in
`pip_layer_sharded` runs in interpret mode). The same seeded inputs go
through both and through the port's single-device counterpart. The
tolerances: indices, flags, hits, counts and unit-weight grids exact;
kNN meters within 4 ulp of f32 (each package's own f32 haversine);
weighted grids to f32 summation noise (1e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.engine import grid_index as rgi
from geomesa_tpu.engine import pip_sparse as rpip
from geomesa_tpu.engine import raster as rras
from geomesa_tpu.engine import stats as rstats
from geomesa_tpu.engine import tube as rtube
from geomesa_tpu.parallel import mesh as rmesh
from geomesa_tpu_torch.engine import grid_index as pgi
from geomesa_tpu_torch.engine import pip_sparse as ppip
from geomesa_tpu_torch.engine import pip_sparse_kernels as psk
from geomesa_tpu_torch.engine import raster as pras
from geomesa_tpu_torch.engine import stats as pstats
from geomesa_tpu_torch.engine import tube as ptube
from geomesa_tpu_torch.parallel import mesh as pmesh
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

D = 4
DAY = 86_400_000


@pytest.fixture(scope="module")
def meshes():
    return rmesh.default_mesh(jax.devices()[:D]), pmesh.default_mesh(["cpu"] * D)


def T(*a):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in a]


def J(*a):
    return [jnp.asarray(v) for v in a]


def test_knn_indexed_sharded(meshes):
    """Per-shard grid indices, merged: indices and uncertain flags equal
    the reference's; the certified queries equal the port's
    single-device `knn_indexed` (an exact answer)."""
    rm, pm = meshes
    rng = np.random.default_rng(1)
    n = 4096
    x = rng.uniform(-30, 30, n).astype(np.float32)
    y = rng.uniform(-30, 30, n).astype(np.float32)
    m = rng.random(n) < 0.6
    qx = rng.uniform(-25, 25, 24).astype(np.float32)
    qy = rng.uniform(-25, 25, 24).astype(np.float32)
    kw = dict(k=5, g=64, ring_radius=2, cell_slots=64)
    rd, ri, ru = rgi.knn_indexed_sharded(rm, *J(qx, qy, x, y, m), **kw)
    pd, pi, pu = pgi.knn_indexed_sharded(pm, *T(qx, qy, x, y, m), **kw)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=2 ** -21)
    sd, si = pgi.knn_indexed(*T(qx, qy, x, y, m), k=5, g=64, cell_slots=64)
    ok = ~pu.numpy()
    assert ok.sum() >= 12
    np.testing.assert_array_equal(pi.numpy()[ok], si.numpy()[ok])
    np.testing.assert_array_equal(pd.numpy()[ok], sd.numpy()[ok])


def test_stats_sharded(meshes):
    """A tuple of masked partials (count, histogram, Z3 occupancy) summed
    over shards: equal to the reference's `stats_sharded` and to the
    single-device reductions."""
    rm, pm = meshes
    rng = np.random.default_rng(2)
    n = 8192
    v = rng.uniform(-5, 5, n).astype(np.float32)
    x = rng.uniform(-180, 180, n).astype(np.float32)
    y = rng.uniform(-90, 90, n).astype(np.float32)
    tb = rng.integers(0, 4, n).astype(np.int32)
    m = rng.random(n) < 0.7

    def pfn(v, x, y, t, m):
        return (pstats.masked_count(m),
                pstats.masked_histogram(v, m, -5.0, 5.0, 16),
                {"z3": pstats.z3_histogram(x, y, t, m, 4, 8)})

    def rfn(v, x, y, t, m):
        return (rstats.masked_count(m),
                rstats.masked_histogram(v, m, -5.0, 5.0, 16),
                {"z3": rstats.z3_histogram(x, y, t, m, 4, 8)})

    got = pstats.stats_sharded(pm, pfn, *T(v, x, y, tb, m))
    ref = rstats.stats_sharded(rm, rfn, *J(v, x, y, tb, m))
    one = pfn(*T(v, x, y, tb, m))
    for a, b, c in ((got[0], ref[0], one[0]), (got[1], ref[1], one[1]),
                    (got[2]["z3"], ref[2]["z3"], one[2]["z3"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c.numpy())
    # host rows go to their shard's device
    host = pstats.stats_sharded(pm, lambda t, mm: pstats.masked_value_counts(
        t, mm, 4), tb, m)
    np.testing.assert_array_equal(host.numpy(), got[2]["z3"].numpy().sum((1, 2)))


def _tube(rng, n, z_order=True):
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(40, 70, n)
    if z_order:
        o = np.argsort(x + 1e-3 * y)
        x, y = x[o], y[o]
    t = rng.integers(0, DAY, n)
    tn = 96
    tx = np.linspace(-15, 15, tn)
    ty = np.linspace(42, 68, tn) + rng.normal(0, 0.05, tn)
    tt = np.linspace(0, DAY, tn).astype(np.int64)
    m = rng.random(n) < 0.9
    f = np.float32
    return (x.astype(f), y.astype(f), t, m, tx.astype(f), ty.astype(f), tt)


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
def test_tube_select_sharded(meshes, pruned):
    """Hits sharded like the data, equal to the reference's and to the
    single-device `tube_select`; the pruned form's overflow flag equals
    the reference's (a small capacity overflows on both)."""
    rm, pm = meshes
    rng = np.random.default_rng(3)
    arrs = _tube(rng, 16384)
    radius, win = 40_000.0, DAY // 6
    one = ptube.tube_select(*T(*arrs), radius, win).numpy()
    if pruned:
        for cap, want_ov in ((64, False), (1, True)):
            rh, rov = rtube.tube_select_pruned_sharded(
                rm, *J(*arrs), radius, win, data_tile=1024, tile_capacity=cap)
            ph, pov = ptube.tube_select_pruned_sharded(
                pm, *T(*arrs), radius, win, data_tile=1024, tile_capacity=cap)
            assert isinstance(ph, pmesh.Sharded) and len(ph) == len(arrs[0])
            assert bool(pov) == bool(rov) == want_ov
            if not want_ov:
                np.testing.assert_array_equal(ph.full().numpy(), np.asarray(rh))
                np.testing.assert_array_equal(ph.full().numpy(), one)
    else:
        rh = rtube.tube_select_sharded(rm, *J(*arrs), radius, win)
        ph = ptube.tube_select_sharded(pm, *T(*arrs), radius, win)
        assert isinstance(ph, pmesh.Sharded) and ph.shard_rows == 16384 // D
        np.testing.assert_array_equal(ph.full().numpy(), np.asarray(rh))
        np.testing.assert_array_equal(ph.full().numpy(), one)
    assert one.sum() > 100


def _ccw_ring(cx, cy, ne, rx, ry):
    th = np.linspace(0, 2 * np.pi, ne, endpoint=False)
    r = np.stack([cx + rx * np.cos(th), cy + ry * np.sin(th)], 1)
    r = np.concatenate([r, r[:1]])
    return r[:-1, 0], r[:-1, 1], r[1:, 0], r[1:, 1]


def test_polygon_density_sharded(meshes):
    """Edges sharded (one polygon's edges across shards): unit grids equal
    the reference's and the single-device `polygon_density` exactly, a
    weighted grid within f32 summation noise; the clamp runs once (a
    hole's edges on their own shard would clamp to zero per shard)."""
    rm, pm = meshes
    rng = np.random.default_rng(4)
    parts, w = [], []
    for i in range(12):
        cx, cy = rng.uniform(-30, 30, 2)
        e = _ccw_ring(cx, cy, 23 + i, rng.uniform(2, 8), rng.uniform(2, 8))
        parts.append(e)
        w.append(np.full(len(e[0]), rng.uniform(0.5, 3.0)))
        if i % 3 == 0:  # a hole: a clockwise inner ring
            h = _ccw_ring(cx, cy, 17, 1.0, 1.0)
            parts.append((h[2], h[3], h[0], h[1]))
            w.append(np.full(17, w[-1][0]))
    cols = [np.concatenate([p[k] for p in parts]).astype(np.float32)
            for k in range(4)]
    wts = np.concatenate(w).astype(np.float32)
    n = len(wts)
    pad = (-n) % D
    cols = [np.concatenate([c, np.zeros(pad, np.float32)]) for c in cols]
    wts = np.concatenate([wts, np.zeros(pad, np.float32)])
    em = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    bbox = (-40.0, -40.0, 40.0, 40.0)
    args = (bbox, 64, 48, 16)
    for weights, exact in ((np.ones_like(wts), True), (wts, False)):
        ref = np.asarray(rras.polygon_density_sharded(
            rm, *J(*cols, weights, em), *args))
        got = pras.polygon_density_sharded(pm, *T(*cols, weights, em), *args).numpy()
        one = pras.polygon_density(*T(*cols, weights, em), *args).numpy()
        assert got.sum() > 0
        if exact:
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, one)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)


def test_pip_layer_sharded(meshes, monkeypatch):
    """Point tiles sharded, the edge table replicated: B6 runs once a
    shard over its own CSR (local tile ids); `inside` and the info equal
    the reference's `pip_layer_sharded` and the single-device
    `pip_layer`."""
    rm, pm = meshes
    rng = np.random.default_rng(5)
    parts = [_ccw_ring(*rng.uniform(-40, 40, 2), 24, *rng.uniform(3, 9, 2))
             for _ in range(10)]
    x1, y1, x2, y2 = (np.concatenate([p[k] for p in parts]) for k in range(4))
    pol = np.concatenate([np.full(24, i, np.int64) for i in range(10)])
    n = 7 * 512 + 100  # 8 tiles: 2 a shard, the last one part padding
    px = rng.uniform(-50, 50, n)
    py = rng.uniform(-50, 50, n)
    o = np.argsort(px + 1e-3 * py)
    px, py = px[o], py[o]
    calls = []
    real = psk.pip_grouped

    def counting(*a, **kw):
        calls.append(kw.get("n_ptiles"))
        return real(*a, **kw)

    monkeypatch.setattr(ppip, "pip_grouped", counting)
    got, info = ppip.pip_layer_sharded(pm, px, py, x1, y1, x2, y2, pol)
    assert calls == [2] * D  # B6 once a shard
    ref, rinfo = rpip.pip_layer_sharded(rm, px, py, x1, y1, x2, y2, pol,
                                        interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert info == rinfo
    one, oinfo = ppip.pip_layer(px, py, x1, y1, x2, y2, pol, device="cpu")
    np.testing.assert_array_equal(got, one)
    assert 0 < got.sum() < n and info["pairs"] == oinfo["pairs"]
