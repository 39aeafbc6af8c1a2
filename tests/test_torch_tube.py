"""The port's tube select (engine.tube) and TubeSelectProcess against the
reference's, on the same seeded inputs.

In f64 the masks are identical. In f32 the two packages round the
trigonometry differently (XLA's and PyTorch's CPU sin/cos), so a point
may flip only at the radius edge: every mismatch must be a sample within
the time window whose f64 haversine distance lies within 1 m of the
radius (the reference bench's rule). The pruned pass equals the dense
pass in the port, in Z order and in random order, and selects the same
number of tiles as the reference's (its overflow flag flips at the same
capacity). The process's hit sets are identical over a DataStore (both
routes) and over a FeatureBatch, for each gap fill.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.engine import tube as rtube
from geomesa_tpu.plan import DataStore as RDataStore
from geomesa_tpu.process import tube as rproc
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.engine import tube as ptube
from geomesa_tpu_torch.engine.geodesy import haversine_m_np
from geomesa_tpu_torch.plan import DataStore as PDataStore
from geomesa_tpu_torch.process import tube as pproc
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

DAY = 86_400_000


def make(n=40_000, seed=3, z_order=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(40, 70, n)
    if z_order:
        o = np.argsort(x + 1e-3 * y)  # cheap store-order proxy
        x, y = x[o], y[o]
    t = rng.integers(0, DAY, n)
    T = 192
    tx = np.linspace(-15, 15, T)
    ty = np.linspace(42, 68, T) + rng.normal(0, 0.05, T)
    tt = np.linspace(0, DAY, T).astype(np.int64)
    return x, y, t, tx, ty, tt


def both_args(x, y, t, mask, tx, ty, tt, radius, win, f64=False):
    """The same inputs for the reference (jax) and the port (torch, CPU)."""
    jd, nd = (jnp.float64, np.float64) if f64 else (jnp.float32, np.float32)
    ref = (jnp.asarray(x, jd), jnp.asarray(y, jd), jnp.asarray(t, jnp.int64),
           jnp.asarray(mask), jnp.asarray(tx, jd), jnp.asarray(ty, jd),
           jnp.asarray(tt, jnp.int64), jnp.float32(radius), jnp.int64(win))
    c = lambda a, d: torch.from_numpy(np.ascontiguousarray(a, d))  # noqa: E731
    port = (c(x, nd), c(y, nd), c(t, np.int64), c(mask, bool), c(tx, nd),
            c(ty, nd), c(tt, np.int64), torch.tensor(radius, dtype=torch.float32),
            torch.tensor(win, dtype=torch.int64))
    return ref, port


def assert_radius_edge_only(got, exp, x, y, t, tx, ty, tt, radius, win):
    """Every mismatch: a sample within the window, at radius +- 1 m."""
    for i in np.nonzero(got != exp)[0]:
        d = haversine_m_np(x[i], y[i], tx, ty)
        near = (np.abs(t[i] - tt) <= win) & (np.abs(d - radius) <= 1.0)
        assert near.any(), f"row {i} differs away from the radius edge"


def oracle(x, y, t, tx, ty, tt, radius, win):
    hit = np.zeros(len(x), bool)
    for i in range(len(tx)):
        d = haversine_m_np(tx[i], ty[i], x, y)
        hit |= (d <= radius) & (np.abs(t - tt[i]) <= win)
    return hit


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("z_order", [True, False], ids=["z", "random"])
def test_tube_select_matches_reference(f64, z_order):
    x, y, t, tx, ty, tt = make(z_order=z_order)
    mask = np.random.default_rng(5).random(len(x)) < 0.8
    ref, port = both_args(x, y, t, mask, tx, ty, tt, 30_000.0, 3_600_000, f64)
    exp = np.asarray(rtube.tube_select(*ref, data_tile=2048))
    got = ptube.tube_select(*port, data_tile=4096, tube_tile=64).numpy()
    assert exp.sum() > 0
    if f64:
        np.testing.assert_array_equal(got, exp)
    else:
        assert_radius_edge_only(got, exp, x, y, t, tx, ty, tt, 30_000.0, 3_600_000)
    # and both against the f64 haversine oracle, under the same rule
    assert_radius_edge_only(got, oracle(x, y, t, tx, ty, tt, 30_000.0, 3_600_000)
                            & mask, x, y, t, tx, ty, tt, 30_000.0, 3_600_000)


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("z_order", [True, False], ids=["z", "random"])
def test_pruned_matches_dense_and_reference(f64, z_order):
    x, y, t, tx, ty, tt = make(z_order=z_order)
    mask = np.random.default_rng(5).random(len(x)) < 0.8
    ref, port = both_args(x, y, t, mask, tx, ty, tt, 30_000.0, 3_600_000, f64)
    dense = ptube.tube_select(*port).numpy()
    pruned, cap = ptube.tube_select_pruned(*port, data_tile=2048)
    rpruned, rcap = rtube.tube_select_pruned(*ref, data_tile=2048)
    np.testing.assert_array_equal(pruned.numpy(), dense)
    assert cap == rcap != 0
    if f64:
        np.testing.assert_array_equal(pruned.numpy(), np.asarray(rpruned))
    else:
        assert_radius_edge_only(pruned.numpy(), np.asarray(rpruned), x, y, t,
                                tx, ty, tt, 30_000.0, 3_600_000)
    assert dense.sum() > 0


def tiles_selected(port, margins, data_tile):
    x, y, t, _, tx, ty, tt, _, win = port
    return int(ptube.tube_tile_hits(x, y, t, tx, ty, tt, win, *margins,
                                    data_tile=data_tile).sum())


def ref_overflows(ref, margins, data_tile, cap):
    x, y, t, m, tx, ty, tt, r, w = ref
    T = tx.shape[0]
    _, ov = rtube._tube_pruned_call(
        x, y, t, m, tx, ty, tt, jnp.broadcast_to(r, (T,)),
        jnp.broadcast_to(w, (T,)), *margins, data_tile=data_tile,
        tile_capacity=cap)
    return bool(np.asarray(ov))


@pytest.mark.parametrize("z_order", [True, False], ids=["z", "random"])
def test_tiles_selected_as_the_reference(z_order):
    # the reference's overflow flag flips exactly at the port's tile count
    x, y, t, tx, ty, tt = make(z_order=z_order)
    mask = np.ones(len(x), bool)
    ref, port = both_args(x, y, t, mask, tx, ty, tt, 30_000.0, 3_600_000)
    margins = ptube.tube_margins(ty, 30_000.0)
    assert margins == rtube.tube_margins(ty, 30_000.0)
    k = tiles_selected(port, margins, 1024)
    nt = -(-len(x) // 1024)
    # Z order prunes; random order leaves every tile within reach
    assert (0 < k < nt) if z_order else k == nt
    assert not ref_overflows(ref, margins, 1024, k)
    assert ref_overflows(ref, margins, 1024, k - 1)


def test_prunes_far_tiles():
    # a corridor in a corner: a small capacity suffices without overflow
    x, y, t, tx, ty, tt = make()
    tx = np.linspace(-19, -17, len(tx))
    ty = np.linspace(41, 43, len(ty))
    mask = np.ones(len(x), bool)
    ref, port = both_args(x, y, t, mask, tx, ty, tt, 10_000.0, DAY)
    dense = ptube.tube_select(*port).numpy()
    pruned, cap = ptube.tube_select_pruned(*port, data_tile=2048, tile_capacity=8)
    _, rcap = rtube.tube_select_pruned(*ref, data_tile=2048, tile_capacity=8)
    assert cap == rcap == 8  # no overflow at a tiny capacity: real pruning
    np.testing.assert_array_equal(pruned.numpy(), dense)
    assert dense.any()


def test_overflow_falls_back_exactly():
    x, y, t, tx, ty, tt = make(n=20_000)
    mask = np.ones(len(x), bool)
    # a 100 km corridor across everything at capacity 1 must overflow
    ref, port = both_args(x, y, t, mask, tx, ty, tt, 100_000.0, DAY)
    dense = ptube.tube_select(*port).numpy()
    pruned, cap = ptube.tube_select_pruned(*port, data_tile=1024, tile_capacity=1)
    rpruned, rcap = rtube.tube_select_pruned(*ref, data_tile=1024, tile_capacity=1)
    assert cap == rcap == -1  # the dense pass ran
    np.testing.assert_array_equal(pruned.numpy(), dense)
    assert_radius_edge_only(pruned.numpy(), np.asarray(rpruned), x, y, t,
                            tx, ty, tt, 100_000.0, DAY)


def test_time_pruning():
    # a spatially overlapping corridor 200 days later: nothing matches,
    # and the time envelopes keep the capacity at 1
    x, y, t, tx, ty, tt = make(n=10_000)
    tt = tt + 200 * DAY
    mask = np.ones(len(x), bool)
    ref, port = both_args(x, y, t, mask, tx, ty, tt, 30_000.0, 60_000)
    pruned, cap = ptube.tube_select_pruned(*port, data_tile=1024, tile_capacity=1)
    _, rcap = rtube.tube_select_pruned(*ref, data_tile=1024, tile_capacity=1)
    assert cap == rcap == 1 and not pruned.any()
    assert tiles_selected(port, ptube.tube_margins(ty, 30_000.0), 1024) == 0


def test_polar_corridor_spans_all_longitudes():
    # a corridor whose radius reaches the pole matches points at any
    # longitude
    n = 5000
    x = np.full(n, 100.0)
    y = np.full(n, 89.8)
    t = np.zeros(n, np.int64)
    mask = np.ones(n, bool)
    ref, port = both_args(x, y, t, mask, np.array([0.0]), np.array([89.8]),
                          np.array([0], np.int64), 50_000.0, 1_000_000)
    dense = ptube.tube_select(*port).numpy()
    pruned, _ = ptube.tube_select_pruned(*port, data_tile=1024)
    np.testing.assert_array_equal(pruned.numpy(), dense)
    np.testing.assert_array_equal(dense, np.asarray(rtube.tube_select(*ref)))
    assert dense.all()  # 34 km away: every point matches


@pytest.mark.parametrize("lat,radius", [(0.0, 1_000.0), (45.0, 20_000.0),
                                        (80.0, 300_000.0), (89.8, 50_000.0),
                                        (-89.0, 200_000.0)])
def test_tube_margins_match_reference(lat, radius):
    ty = np.array([lat - 0.1, lat])
    assert ptube.tube_margins(ty, radius) == rtube.tube_margins(ty, radius)


def test_f64_radius_passes_through_f32():
    # the process path: f64 coordinates, a Python radius and window; the
    # radius goes through f32 before the f64 test, as in the reference
    x, y, t, tx, ty, tt = make(n=8_000)
    mask = np.ones(len(x), bool)
    radius = 30_000.3  # not an f32 value
    ref, port = both_args(x, y, t, mask, tx, ty, tt, radius, 3_600_000, f64=True)
    got, _ = ptube.tube_select_pruned(*port[:7], radius, 3_600_000, data_tile=1024)
    exp, _ = rtube.tube_select_pruned(*ref[:7], radius, 3_600_000, data_tile=1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    dense = ptube.tube_select(*port[:7], np.float32(radius), 3_600_000).numpy()
    np.testing.assert_array_equal(got.numpy(), dense)


def test_small_radius_f32_exact():
    # the difference form finds every point 50 m from a sample at a 500 m
    # radius in f32 (the dot-product form would lose them), and no point
    # 500 m away at a 100 m radius
    rng = np.random.default_rng(41)
    T = 8
    tx = np.linspace(10.0, 10.01, T)
    ty = np.linspace(45.0, 45.01, T)
    tt = np.zeros(T, np.int64)
    n = 2000
    pick = rng.integers(0, T, n)
    px = tx[pick] + 50.0 / 78_847.0  # 1 degree of longitude ~ 78.8 km at 45N
    py = ty[pick]
    pt = np.zeros(n, np.int64)
    ones = np.ones(n, bool)
    _, port = both_args(px, py, pt, ones, tx, ty, tt, 500.0, 1000)
    assert ptube.tube_select(*port).numpy().all()
    _, port = both_args(tx[pick] + 500.0 / 78_847.0, py, pt, ones, tx, ty, tt,
                        100.0, 1000)
    assert not ptube.tube_select(*port).numpy().any()


# -- TubeSelectProcess --------------------------------------------------------

SPEC = "vessel:String,dtg:Date,*geom:Point"
T0 = 1_600_000_000_000


@pytest.fixture(scope="module")
def tube_store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_tube"))
    rng = np.random.default_rng(13)
    n = 12_000
    x = rng.uniform(-10, 10, n)
    y = rng.uniform(50, 60, n)
    o = np.argsort(np.floor((x + 10) / 0.5) * 64 + np.floor((y - 50) / 0.5),
                   kind="stable")
    x, y = x[o], y[o]
    t = T0 + rng.integers(0, DAY, n)
    vessels = [f"v{i}" for i in rng.integers(0, 50, n)]
    fids = [f"p{i}" for i in range(n)]
    data = {"vessel": vessels, "dtg": t, "geom": np.stack([x, y], 1)}
    ref_ds = RDataStore(root, use_device_cache=True)
    src = ref_ds.create_schema(RSFT.from_spec("pts", SPEC))
    src.write(RFB.from_pydict(src.sft, data, fids=fids))
    # a track of 24 fixes across the region over the day
    T = 24
    track = {"vessel": ["track"] * T,
             "dtg": T0 + np.linspace(0, DAY, T).astype(np.int64)[::-1],
             "geom": np.stack([np.linspace(-8, 8, T),
                               np.linspace(51, 59, T) + rng.normal(0, 0.05, T)], 1)}
    return dict(
        x=x, y=y, t=t, fids=np.array(fids),
        rtrack=RFB.from_pydict(RSFT.from_spec("trk", SPEC), track),
        ptrack=PFB.from_pydict(PSFT.from_spec("trk", SPEC), track),
        rbatch=RFB.from_pydict(RSFT.from_spec("pts", SPEC), data, fids=fids),
        pbatch=PFB.from_pydict(PSFT.from_spec("pts", SPEC), data, fids=fids),
        ref={"cached": ref_ds.get_feature_source("pts"),
             "scan": RDataStore(root).get_feature_source("pts")},
        port={"cached": PDataStore(root, use_device_cache=True, device="cpu")
              .get_feature_source("pts"),
              "scan": PDataStore(root, device="cpu").get_feature_source("pts")})


FILLS = {
    "none": (rproc.NoGapFill, pproc.NoGapFill, ()),
    "line": (rproc.LineGapFill, pproc.LineGapFill, (10_000.0,)),
    "interpolated": (rproc.InterpolatedGapFill, pproc.InterpolatedGapFill, (25_000.0,)),
}


def _fids(batch):
    return sorted(batch.fids.decode()) if len(batch) else []


@pytest.mark.parametrize("data", ["cached", "scan", "batch"])
@pytest.mark.parametrize("fill", sorted(FILLS))
def test_process_hit_sets_match_reference(tube_store, data, fill):
    s = tube_store
    rf, pf, args = FILLS[fill]
    rdata = s["rbatch"] if data == "batch" else s["ref"][data]
    pdata = s["pbatch"] if data == "batch" else s["port"][data]
    kw = dict(buffer_m=20_000.0, max_time_window_ms=3_600_000)
    r = rproc.TubeSelectProcess().execute(s["rtrack"], rdata, rf(*args), **kw)
    p = pproc.TubeSelectProcess().execute(s["ptrack"], pdata, pf(*args),
                                          device="cpu", **kw)
    assert _fids(p) == _fids(r)
    assert len(p) > 20
    # against the f64 haversine oracle over the written rows
    tube = pf(*args).build(s["ptrack"], 20_000.0, 3_600_000)
    exp = oracle(s["x"], s["y"], s["t"], tube.x, tube.y, tube.t, 20_000.0, 3_600_000)
    assert _fids(p) == sorted(s["fids"][exp].tolist())


def test_process_filter_applies_on_both_paths(tube_store):
    s = tube_store
    kw = dict(buffer_m=30_000.0, max_time_window_ms=7_200_000,
              cql_filter="vessel IN ('v1', 'v2', 'v3')")
    for data in ("cached", "batch"):
        rdata = s["rbatch"] if data == "batch" else s["ref"][data]
        pdata = s["pbatch"] if data == "batch" else s["port"][data]
        r = rproc.TubeSelectProcess().execute(s["rtrack"], rdata, **kw)
        p = pproc.TubeSelectProcess().execute(s["ptrack"], pdata, device="cpu", **kw)
        assert _fids(p) == _fids(r)
        assert len(p) > 0
        assert set(p.columns["vessel"].decode()) <= {"v1", "v2", "v3"}


def test_process_empty_window(tube_store):
    # a track far from every row: an empty batch of the track's schema
    s = tube_store
    track = {"vessel": ["t"] * 2, "dtg": [T0, T0 + 3_600_000],
             "geom": np.array([[100.0, -30.0], [100.5, -30.2]])}
    r = rproc.TubeSelectProcess().execute(
        RFB.from_pydict(RSFT.from_spec("trk", SPEC), track), s["ref"]["cached"])
    p = pproc.TubeSelectProcess().execute(
        PFB.from_pydict(PSFT.from_spec("trk", SPEC), track), s["port"]["cached"])
    assert len(p) == len(r) == 0
    assert p.sft.name == r.sft.name == "trk"
