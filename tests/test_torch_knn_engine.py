"""The port's brute-force kNN engine (geomesa_tpu_torch.engine.knn: knn,
knn_mxu, knn_compact; engine.grid_index: build_grid_index, knn_grid,
knn_indexed) against the reference package's, on the same seeded inputs.

The data is ~4,000 points with a fifth masked out, a dense cluster of
200 points within a metre (so that knn_mxu's certificate and the grid's
cell capacity fail for the queries beside it) and points beside the
antimeridian (the grid's clipped longitude edge); Q=37, k=5, with small
tiles so that the fold and the padding run. Tolerances:
- f64 knn: identical indices, distances within 1e-6 m;
- f32 routes: distances within max(1 m, 1e-4 d), the bench's recall
  rule (the packages' f32 sin/cos/asin differ in the last ulps, which
  the haversine's cancellation amplifies to ~2e-5 relative at 1 km),
  and identical indices but for swaps between neighbours whose
  distances agree within that rule;
- knn_compact: equal overflow flags; identical indices on the haversine
  route (knn_mxu's f32 key may swap the cluster's points, whose
  distances agree within the rule above);
- build_grid_index: identical sorted columns, sidx, starts and counts;
- knn_grid (fed the reference's index through grid_index_from_numpy):
  identical uncertain flags;
- after each fallback, knn_indexed and knn_mxu equal knn (knn_mxu's
  refine casts the f32 points to f64 before its radians, knn after, so
  their meters differ at the centimetre: within the rule above).
"""

import numpy as np
import pytest
import torch

import geomesa_tpu.engine.device  # noqa: F401  (the reference runs with x64 on)
import jax
import jax.numpy as jnp
from geomesa_tpu.engine import grid_index as ref_grid
from geomesa_tpu.engine import knn as ref_knn
from geomesa_tpu_torch.engine import grid_index as port_grid
from geomesa_tpu_torch.engine import knn as port_knn
from geomesa_tpu_torch.interop import grid_index_from_numpy
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

K = 5
Q = 37
N = 4000


def make(seed=3, q=Q):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20, 20, N)
    y = rng.uniform(30, 60, N)
    x[:200] = 5.0 + rng.uniform(-5e-6, 5e-6, 200)  # a cluster within ~1 m
    y[:200] = 45.0 + rng.uniform(-5e-6, 5e-6, 200)
    x[200:400] = rng.uniform(178, 180, 200)  # beside the antimeridian
    y[200:400] = rng.uniform(-5, 5, 200)
    x[400:420] = np.round(x[400:420], 1)  # a few duplicates of each other
    y[400:420] = np.round(y[400:420], 1)
    mask = rng.random(N) < 0.8
    mask[:200] = True
    qx = rng.uniform(-15, 15, q)
    qy = rng.uniform(35, 55, q)
    qx[:4] = [5.01, 5.0, 4.99, 179.5]  # beside the cluster, at the edge
    qy[:4] = [45.0, 45.01, 45.0, 0.0]
    return qx, qy, x, y, mask


def as_ref(*arrays, dtype=None):
    return [jnp.asarray(a) if a.dtype == bool or dtype is None
            else jnp.asarray(a, dtype) for a in arrays]


def as_port(*arrays, dtype=None):
    return [torch.from_numpy(a) if a.dtype == bool or dtype is None
            else torch.from_numpy(np.asarray(a, dtype)) for a in arrays]


def f32_tol(d):
    """The bench's recall rule, max(1 m, 1e-4 d)."""
    return np.maximum(1.0, 1e-4 * np.asarray(d))


def f64_tol(d):
    return np.full_like(np.asarray(d, np.float64), 1e-6)


def assert_same_knn(rd, ri, pd, pi, tol=f32_tol):
    """Distances within tol(d); identical indices but for swaps between
    members whose distances agree within tol (ties at the precision)."""
    rd, ri = np.asarray(rd, np.float64), np.asarray(ri)
    pd, pi = np.asarray(pd, np.float64), np.asarray(pi)
    assert rd.shape == pd.shape and ri.shape == pi.shape
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    assert np.all(np.abs(pd[fin] - rd[fin]) <= tol(rd[fin]))
    for i in range(len(ri)):
        if np.array_equal(ri[i], pi[i]):
            continue
        a = dict(zip(ri[i].tolist(), rd[i].tolist()))
        b = dict(zip(pi[i].tolist(), pd[i].tolist()))
        for j in a.keys() ^ b.keys():
            d = a.get(j, b.get(j))
            assert abs(d - rd[i][-1]) <= tol(d), (i, j)
        # members in both: the order may differ only between equal distances
        for j, (ra, pa) in enumerate(zip(ri[i], pi[i])):
            if ra != pa:
                assert abs(rd[i][j] - pd[i][j]) <= tol(rd[i][j]), (i, j)


class TestKnn:
    @pytest.mark.parametrize("query_tile,data_tile", [
        (16, 512), (1024, None), (8, 1000), (37, 4096)])
    def test_f64_identical(self, query_tile, data_tile):
        qx, qy, x, y, mask = make()
        rd, ri = ref_knn.knn(*as_ref(qx, qy, x, y, mask), k=K,
                             query_tile=query_tile, data_tile=data_tile)
        pd, pi = port_knn.knn(*as_port(qx, qy, x, y, mask), k=K,
                              query_tile=query_tile, data_tile=data_tile)
        assert pd.dtype == torch.float64 and pi.dtype == torch.int32
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        assert np.abs(pd.numpy() - np.asarray(rd)).max() <= 1e-6

    @pytest.mark.parametrize("data_tile", [512, None])
    def test_f32_same_neighbours(self, data_tile):
        qx, qy, x, y, mask = make(seed=5)
        rd, ri = ref_knn.knn(*as_ref(qx, qy, x, y, mask, dtype=np.float32),
                             k=K, query_tile=16, data_tile=data_tile)
        pd, pi = port_knn.knn(*as_port(qx, qy, x, y, mask, dtype=np.float32),
                              k=K, query_tile=16, data_tile=data_tile)
        assert pd.dtype == torch.float32
        assert_same_knn(rd, ri, pd.numpy(), pi.numpy())

    def test_fewer_than_k_and_padded_lanes(self):
        """Three unmasked points for k=5: +inf beyond them, indices in range
        (the padded lanes' indices clamp to n - 1, as the reference's)."""
        qx, qy, x, y, _ = make()
        mask = np.zeros(N, bool)
        mask[[7, 900, 3001]] = True
        rd, ri = ref_knn.knn(*as_ref(qx, qy, x, y, mask), k=K, query_tile=16,
                             data_tile=3000)
        pd, pi = port_knn.knn(*as_port(qx, qy, x, y, mask), k=K,
                              query_tile=16, data_tile=3000)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        assert np.isinf(pd.numpy()[:, 3:]).all()
        assert (pi.numpy() < N).all()


class TestKnnMxu:
    @pytest.mark.parametrize("q,data_tile", [(300, 1024), (300, None), (Q, None)])
    def test_flags_and_neighbours_match_reference(self, q, data_tile):
        qx, qy, x, y, mask = make(seed=7, q=q)
        f = np.float32
        rd, ri, rf = ref_knn.knn_mxu(*as_ref(qx, qy, x, y, mask, dtype=f), k=K,
                                     data_tile=data_tile, with_flags=True)
        pd, pi, pf = port_knn.knn_mxu(*as_port(qx, qy, x, y, mask, dtype=f),
                                      k=K, data_tile=data_tile, with_flags=True)
        np.testing.assert_array_equal(pf.numpy(), np.asarray(rf))
        if q >= 128:
            # the cluster's neighbours cannot be certified at f32
            assert pf.numpy()[:3].all() and not pf.numpy().all()
        ok = ~pf.numpy()
        assert_same_knn(np.asarray(rd)[ok], np.asarray(ri)[ok],
                        pd.numpy()[ok], pi.numpy()[ok])

    def test_after_fallback_equals_knn(self):
        """The process's rule: re-run the flagged queries on knn; then the
        result equals knn over all queries (f64 queries, f32 data)."""
        qx, qy, x, y, mask = make(seed=7, q=300)
        tq = as_port(qx, qy)
        td = as_port(x, y, dtype=np.float32) + as_port(mask)
        pd, pi, pf = port_knn.knn_mxu(*tq, *td, k=K, with_flags=True)
        rows = torch.nonzero(pf).flatten()
        assert len(rows)
        ed, ei = port_knn.knn(tq[0][rows], tq[1][rows], *td, k=K)
        pd, pi = pd.clone(), pi.clone()
        pd[rows], pi[rows] = ed, ei
        kd, ki = port_knn.knn(*tq, *td, k=K)
        assert_same_knn(kd.numpy(), ki.numpy(), pd.numpy(), pi.numpy())

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_morton_order_matches_reference(self, dtype):
        """As knn_mxu computes it (jitted: XLA folds the constants), on
        random points and on points at the quantization steps."""
        qx, qy, *_ = make(q=300)
        steps = np.arange(-2000, 2000) * (360.0 / 65535.0)
        qx = np.concatenate([qx, steps]).astype(dtype)
        qy = np.concatenate([qy, steps / 2]).astype(dtype)
        r = np.asarray(jax.jit(ref_knn._morton16)(*as_ref(qx, qy)))
        p = port_knn._morton16(*as_port(qx, qy)).numpy()
        np.testing.assert_array_equal(p, r.astype(np.int64))


class TestKnnCompact:
    @pytest.mark.parametrize("impl,q", [("mxu", 300), ("mxu", Q), ("haversine", Q)])
    @pytest.mark.parametrize("capacity", [4096, 1024])
    def test_matches_reference(self, impl, q, capacity):
        qx, qy, x, y, mask = make(seed=9, q=q)
        f = np.float32
        rd, ri, ro = ref_knn.knn_compact(*as_ref(qx, qy, x, y, mask, dtype=f),
                                         k=K, capacity=capacity, impl=impl)
        pd, pi, po = port_knn.knn_compact(*as_port(qx, qy, x, y, mask, dtype=f),
                                          k=K, capacity=capacity, impl=impl)
        assert bool(po) == bool(ro) == (mask.sum() > capacity)
        if impl == "haversine" or q < 128:
            np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        assert_same_knn(rd, ri, pd.numpy(), pi.numpy())

    def test_row_bound(self):
        class Big:
            shape = (1 << 31,)
        with pytest.raises(ValueError, match="2\\^31"):
            port_knn.knn_compact(None, None, Big(), None, None, k=1, capacity=1)


def ref_index(x, y, mask, g):
    return ref_grid.build_grid_index(*as_ref(x, y, mask, dtype=np.float32), g=g)


class TestGridIndex:
    @pytest.mark.parametrize("g", [64, 128])
    def test_build_identical(self, g):
        _, _, x, y, mask = make()
        r = ref_index(x, y, mask, g)
        p = port_grid.build_grid_index(*as_port(x, y, mask, dtype=np.float32), g=g)
        for name in ("sx", "sy", "sidx", "starts", "counts"):
            np.testing.assert_array_equal(getattr(p, name).numpy(),
                                          np.asarray(getattr(r, name)), name)
        assert p.g == r.g == g

    @pytest.mark.parametrize("qdtype", [np.float32, np.float64])
    @pytest.mark.parametrize("g,slots", [(64, 64), (128, 16)])
    def test_knn_grid_flags_match_reference(self, qdtype, g, slots):
        qx, qy, x, y, mask = make(seed=11)
        r = ref_index(x, y, mask, g)
        index = grid_index_from_numpy(
            *(np.asarray(getattr(r, a)) for a in ("sx", "sy", "sidx", "starts",
                                                  "counts")), g=r.g, device="cpu")
        rd, ri, ru = ref_grid.knn_grid(*as_ref(qx, qy, dtype=qdtype), r, k=K,
                                       ring_radius=2, cell_slots=slots)
        pd, pi, pu = port_grid.knn_grid(*as_port(qx, qy, dtype=qdtype), index,
                                        k=K, ring_radius=2, cell_slots=slots)
        ru, pu = np.asarray(ru), pu.numpy()
        np.testing.assert_array_equal(pu, ru)
        assert pu[:4].all() and not pu.all()  # cluster overflow, clipped edge
        assert_same_knn(np.asarray(rd), np.asarray(ri), pd.numpy(), pi.numpy())

    @pytest.mark.parametrize("g,slots", [(64, 256), (128, 16)])
    def test_knn_indexed_after_fallback_equals_knn(self, g, slots):
        qx, qy, x, y, mask = make(seed=13)
        f = np.float32
        rd, ri = ref_grid.knn_indexed(*as_ref(qx, qy, x, y, mask, dtype=f), k=K,
                                      g=g, ring_radius=2, cell_slots=slots)
        td = as_port(qx, qy, x, y, mask, dtype=f)
        pd, pi = port_grid.knn_indexed(*td, k=K, g=g, ring_radius=2,
                                       cell_slots=slots)
        assert_same_knn(np.asarray(rd), np.asarray(ri), pd.numpy(), pi.numpy())
        kd, ki = port_knn.knn(*td, k=K)
        assert_same_knn(kd.numpy(), ki.numpy(), pd.numpy(), pi.numpy(),
                        tol=lambda d: np.full_like(np.asarray(d), 1e-3))

    @pytest.mark.parametrize("count", [0, 1000, 3_100_000, 10**9])
    def test_auto_grid_params(self, count):
        assert port_grid.auto_grid_params(count) == ref_grid.auto_grid_params(count)


def nan_probe(name, dtype, q):
    """ROADMAP C1's probes: A, 4,000 rows with a NaN x in rows 0-2; B,
    5,000 rows with 15 NaN x and 15 NaN y, a tenth masked out, and 50 rows
    in the grid's corner cell (where a NaN row's cell lands) with a query
    beside them. Queries: (0, 45) or (0, 0), then seeded ones."""
    rng = np.random.default_rng({"A": 1, "B": 2}[name])
    n = 4000 if name == "A" else 5000
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(30, 60, n)
    if name == "A":
        x[:3] = np.nan
        mask = np.ones(n, bool)
    else:
        x[rng.choice(n, 15, replace=False)] = np.nan
        y[rng.choice(n, 15, replace=False)] = np.nan
        x[4000:4050] = rng.uniform(-180, -179.5, 50)
        y[4000:4050] = rng.uniform(-90, -89.5, 50)
        mask = rng.random(n) < 0.9
    qx = rng.uniform(-15, 15, q)
    qy = rng.uniform(35, 55, q)
    qx[0], qy[0] = 0.0, (45.0 if name == "A" else 0.0)
    if name == "B":
        qx[1], qy[1] = -179.9, -89.9
    return [np.asarray(a, dtype) for a in (qx, qy, x, y)] + [mask]


NAN_ROUTES = {
    "knn": lambda m, a: m.knn(*a, k=K, query_tile=16, data_tile=512),
    "knn_default_tile": lambda m, a: m.knn(*a, k=K),
    "knn_mxu": lambda m, a: m.knn_mxu(*a, k=K),
    "knn_compact": lambda m, a: m.knn_compact(*a, k=K, capacity=8192)[:2],
    "knn_compact_haversine": lambda m, a: m.knn_compact(
        *a, k=K, capacity=8192, impl="haversine")[:2],
}


def assert_same_nan_ranking(rd, ri, pd, pi, dtype):
    rd, pd = np.asarray(rd, np.float64), np.asarray(pd, np.float64)
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(ri))
    np.testing.assert_array_equal(np.isnan(pd), np.isnan(rd))
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    tol = f64_tol if dtype == np.float64 else f32_tol
    assert np.all(np.abs(pd[fin] - rd[fin]) <= tol(rd[fin]))


@pytest.mark.parametrize("q", [3, 200])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("probe", ["A", "B"])
@pytest.mark.parametrize("route", sorted(NAN_ROUTES) + ["knn_indexed"])
def test_nan_rows_rank_as_the_reference(route, probe, dtype, q):
    """C1: the haversine fold (knn, knn_mxu below 128 queries, knn_compact
    on either impl, knn_indexed's grid and fallback) ranks a masked-in NaN
    distance ahead of every finite one and returns NaN there, lower row
    first; knn_mxu's chord selection (200 queries) ranks it last, as the
    reference does. Indices identical, NaN slots identical."""
    a = nan_probe(probe, dtype, q)
    if route == "knn_indexed":
        rd, ri = ref_grid.knn_indexed(*as_ref(*a), k=K, g=32)
        pd, pi = port_grid.knn_indexed(*as_port(*a), k=K, g=32)
    else:
        rd, ri = NAN_ROUTES[route](ref_knn, as_ref(*a))
        pd, pi = NAN_ROUTES[route](port_knn, as_port(*a))
    assert_same_nan_ranking(rd, ri, pd.numpy(), pi.numpy(), dtype)
    if route.startswith("knn_compact_h") or route in ("knn", "knn_default_tile"):
        assert np.isnan(pd.numpy()).any(1).all()  # the probe reaches the rule


def test_shared_selection_still_ranks_nan_last():
    """The fused scan's primitives are unchanged: a stable ascending sort
    ranks NaN last (knn_scan.py's selections match the reference's)."""
    d = torch.tensor([[3.0, float("nan"), 1.0, 2.0]])
    vals, idx = port_knn._topk_smallest(d, 4)
    assert idx.tolist() == [[2, 3, 0, 1]] and torch.isnan(vals[0, 3])
