"""The port's point-in-polygon kernels (B4, B5) and polygon CQL against the
reference package's, on the same seeded inputs.

The reference runs its Pallas kernels in interpret mode on the CPU; the
port runs the plain PyTorch versions of its CUDA kernels, which are what
its wrappers take for CPU tensors. Both compute in f32 with the same
arithmetic, so crossing parities and band flags are identical, also for
points on vertices and a few ulps from edges. The compiled filters
differ by design: on the CPU the reference's dense fallback promotes to
its f64 edge table while the port stays in f32, so raw masks agree
outside the 1e-4 degree band, and after the f64 band refine the masks
and counts are identical (and equal to the f64 oracle).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.core.columnar import FeatureBatch as RFB
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu.cql import compile_filter as ref_compile, parse_cql as ref_parse
from geomesa_tpu.cql.hosteval import eval_filter_host as ref_host
from geomesa_tpu.engine import pip as ref_pip
from geomesa_tpu.engine.device import to_device as ref_to_device
from geomesa_tpu.engine.pip_pallas import (
    points_in_polygon_band_pallas, points_in_polygon_np_edges as ref_np_edges,
    points_in_polygon_pallas)
from geomesa_tpu_torch.core.columnar import FeatureBatch as PFB
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT
from geomesa_tpu_torch.core.wkt import parse_wkt
from geomesa_tpu_torch.cql import compile_filter as port_compile, parse_cql as port_parse
from geomesa_tpu_torch.cql.hosteval import eval_filter_host as port_host
from geomesa_tpu_torch.engine import pip as port_pip
from geomesa_tpu_torch.engine import pip_kernels as pk
from geomesa_tpu_torch.engine.device import to_device as port_to_device

SPEC = "fare:Double,dtg:Date,*geom:Point"
T0 = 1_451_606_400_000  # 2016-01-01


def star_ring(rng, cx, cy, rx, ry, n, lo=0.55):
    """A closed star-shaped ring: n vertices at increasing angles, radii
    drawn in [lo, 1] of (rx, ry)."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(lo, 1.0, n)
    pts = np.stack([cx + rx * r * np.cos(ang), cy + ry * r * np.sin(ang)], 1)
    return np.concatenate([pts, pts[:1]])


def ring_wkt(r):
    return "(" + ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in r) + ")"


def star_polygon_wkt(seed=3, n_shell=480, n_hole=64, cx=-74.0, cy=40.75,
                     rx=0.2, ry=0.16):
    """A star-shaped polygon with one star-shaped hole (E = n_shell +
    n_hole edges)."""
    rng = np.random.default_rng(seed)
    shell = star_ring(rng, cx, cy, rx, ry, n_shell)
    hole = star_ring(rng, cx + 0.02, cy - 0.01, 0.2 * rx, 0.2 * ry, n_hole)
    return f"POLYGON({ring_wkt(shell)}, {ring_wkt(hole)})"


POLY = star_polygon_wkt()
MULTI = ("MULTIPOLYGON(((-74.25 40.55, -74.1 40.55, -74.1 40.7, -74.25 40.55)), "
         f"{POLY[len('POLYGON'):]})")


def edges_of(wkt):
    return port_pip.polygon_edges(parse_wkt(wkt))


def points(seed, n, wkt, on_vertices=True):
    """n points: a third uniform over the polygon's envelope, the rest on
    its edges (and vertices, with `on_vertices`), and within a few f64 or
    f32 ulps of them."""
    rng = np.random.default_rng(seed)
    x1, y1, x2, y2 = edges_of(wkt)
    k = n // 3
    x = rng.uniform(-74.3, -73.7, n)
    y = rng.uniform(40.5, 41.0, n)
    e = rng.integers(0, len(x1), n - k)
    t = (rng.choice([0.0, 0.5, rng.uniform()], n - k) if on_vertices
         else rng.uniform(0.05, 0.95, n - k))
    ex = x1[e] + t * (x2[e] - x1[e])
    ey = y1[e] + t * (y2[e] - y1[e])
    ulp = rng.choice([0.0, 1.0, -1.0, 3.0, -3.0], (2, n - k))
    scale = rng.choice([np.spacing(74.0), float(np.spacing(np.float32(74.0))),
                        2e-5], n - k)
    x[k:] = ex + ulp[0] * scale
    y[k:] = ey + ulp[1] * scale
    return x, y


def eps_boundary_points(edges, eps, seed=0, n_edges=64):
    """f32 points whose y is exactly an edge end +- eps (in f32) or 1-2 f32
    ulps either side of it, x across the edge's eps-inflated x-span and on
    its f32 lower bound, for the n_edges flattest edges (near-flat needs
    both ends within eps), sorted by y so that small blocks of them are
    thin in y."""
    x1, y1, x2, y2 = (np.asarray(a, np.float32) for a in edges)
    rng = np.random.default_rng(seed)
    e32 = np.float32(eps)
    xs, ys = [], []
    for j in np.argsort(np.abs(y2 - y1), kind="stable")[:n_edges]:
        xlo = np.minimum(x1[j], x2[j]) - e32
        xhi = np.maximum(x1[j], x2[j]) + e32
        for yend in (y1[j], y2[j]):
            for c in (yend + e32, yend - e32):
                for u in (-2, -1, 0, 1, 2):
                    v = c
                    for _ in range(abs(u)):
                        v = np.nextafter(v, np.float32(np.inf if u > 0 else -np.inf))
                    xs += [rng.uniform(xlo - e32, xhi + e32), xlo]
                    ys += [v, v]
    x = np.asarray(xs, np.float32)
    y = np.asarray(ys, np.float32)
    o = np.argsort(y, kind="stable")
    return x[o], y[o]


def morton_sorted(x, y):
    """The points in Z2-Morton order, as chip_smoke.py writes them."""
    from test_torch_density import _morton

    o = np.argsort(_morton(x, y), kind="stable")
    return np.asarray(x)[o], np.asarray(y)[o]


@pytest.fixture(scope="module")
def pts():
    x, y = points(5, 4096, POLY)
    return x, y


def _f32(*arrays):
    return [np.asarray(a, np.float32) for a in arrays]


@pytest.mark.parametrize("wkt", [POLY, MULTI], ids=["polygon", "multipolygon"])
def test_crossing_plain_matches_pallas(wkt, pts):
    x, y = pts
    e = _f32(*edges_of(wkt))
    assert len(e[0]) <= 600
    px, py = _f32(x, y)
    ref = np.asarray(points_in_polygon_pallas(
        *[jnp.asarray(a) for a in (px, py, *e)], interpret=True))
    got = pk.pip_crossing(*[torch.from_numpy(a) for a in (px, py, *e)]).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("wkt", [POLY, MULTI], ids=["polygon", "multipolygon"])
def test_band_plain_matches_pallas(wkt, pts):
    x, y = pts
    e = _f32(*edges_of(wkt))
    px, py = _f32(x, y)
    ref = np.asarray(points_in_polygon_band_pallas(
        *[jnp.asarray(a) for a in (px, py, *e)], eps=port_pip.BAND_EPS,
        interpret=True))
    got = pk.pip_band(*[torch.from_numpy(a) for a in (px, py, *e)],
                      eps=port_pip.BAND_EPS).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > len(got) // 3  # the edge points are flagged


def test_empty_edge_table():
    z = torch.zeros(0)
    p = torch.ones(5)
    assert not pk.pip_crossing(p, p, z, z, z, z).any()
    assert not pk.pip_band(p, p, z, z, z, z, eps=1e-4).any()


def test_f64_oracles_agree(pts):
    x, y = pts
    np.testing.assert_array_equal(
        port_pip.points_in_polygon_np(x, y, parse_wkt(POLY)),
        ref_np_edges(x, y, *edges_of(POLY)))
    np.testing.assert_array_equal(pk.points_in_polygon_np_edges(x, y, *edges_of(POLY)),
                                  ref_np_edges(x, y, *edges_of(POLY)))


def test_polygon_edges_copy():
    from geomesa_tpu.core.wkt import parse_wkt as ref_parse_wkt

    for wkt in (POLY, MULTI, "POLYGON((0 0, 1 0, 1 1))"):
        for a, b in zip(port_pip.polygon_edges(parse_wkt(wkt)),
                        ref_pip.polygon_edges(ref_parse_wkt(wkt))):
            np.testing.assert_array_equal(a, b)


def test_cpu_wrappers_launch_nothing(pts):
    x, y = pts
    args = [torch.from_numpy(a) for a in _f32(x, y, *edges_of(POLY))]
    before = (pk.pip_crossing.launches, pk.pip_band.launches)
    pk.pip_crossing(*args)
    pk.pip_band(*args, eps=1e-4)
    assert (pk.pip_crossing.launches, pk.pip_band.launches) == before


# -- the compiled polygon predicates ------------------------------------------


@pytest.fixture(scope="module")
def batches():
    # no point within a few ulps of a vertex: there a local y-extreme
    # vertex and a point rounded to its f32 height can flip the parity
    # outside the band, in both packages (ROADMAP Queue C)
    x, y = points(6, 4096, POLY, on_vertices=False)
    rng = np.random.default_rng(9)
    n = len(x)
    cols = {"fare": rng.uniform(0, 5, n),
            "dtg": rng.integers(T0, T0 + 10 * 86400_000, n),
            "geom": np.stack([x, y], 1)}
    rb = RFB.from_pydict(RSFT.from_spec("t", SPEC), cols).pad_to(8192)
    pb = PFB.from_pydict(PSFT.from_spec("t", SPEC), cols).pad_to(8192)
    return rb, ref_to_device(rb), pb, port_to_device(pb, torch.device("cpu"))


def _iso(ms):
    return str(np.datetime64(ms, "ms")) + "Z"


CQLS = {
    "intersects": f"INTERSECTS(geom, {POLY})",
    "within": f"WITHIN(geom, {POLY})",
    "disjoint": f"DISJOINT(geom, {POLY})",
    "multipolygon": f"INTERSECTS(geom, {MULTI})",
    "and_time_fare": (f"INTERSECTS(geom, {POLY}) AND dtg > {_iso(T0 + 86400_000)} "
                      "AND fare < 4.0"),
    "not_or_bbox": f"NOT (WITHIN(geom, {POLY}) OR BBOX(geom, -74.3, 40.5, -74.0, 40.6))",
}


def _corrected(compiled, dev, batch, mask):
    bidx, bexact = compiled.band_corrections(dev, batch)
    mask = np.array(mask)
    if len(bidx):
        mask[bidx] = bexact & batch.valid[bidx]
    return mask, bidx


@pytest.mark.parametrize("name", sorted(CQLS))
def test_polygon_filter_matches_reference(batches, name):
    rb, rdev, pb, pdev = batches
    cql = CQLS[name]
    rf = ref_compile(ref_parse(cql), rb.sft)
    pf = port_compile(port_parse(cql), pb.sft)
    assert pf.has_band and rf.has_band
    rmask = np.asarray(rf.mask(rdev, rb))
    pmask = pf.mask(pdev, pb).numpy()
    pband = pf.band(pdev, pb).numpy()
    # raw f32 masks agree with the reference's (f64-edge) masks outside
    # the band; the band is where the test put most of its points
    np.testing.assert_array_equal(pmask[~pband], rmask[~pband])
    assert pband.sum() > 1000
    rfix, _ = _corrected(rf, rdev, rb, rmask)
    pfix, _ = _corrected(pf, pdev, pb, pmask)
    np.testing.assert_array_equal(pfix, rfix)
    np.testing.assert_array_equal(pfix, ref_host(ref_parse(cql), rb))
    assert int(pfix.sum()) == int(rfix.sum()) > 0


@pytest.mark.parametrize("name", sorted(CQLS))
def test_polygon_hosteval_matches_reference(batches, name):
    rb, _, pb, _ = batches
    cql = CQLS[name]
    np.testing.assert_array_equal(port_host(port_parse(cql), pb),
                                  ref_host(ref_parse(cql), rb))


def test_band_refine_changes_some_rows(batches):
    # the data does exercise the refine: the raw f32 mask alone is wrong
    # on some rows that the f64 oracle decides
    rb, _, pb, pdev = batches
    pf = port_compile(port_parse(CQLS["intersects"]), pb.sft)
    raw = pf.mask(pdev, pb).numpy()
    assert (raw != ref_host(ref_parse(CQLS["intersects"]), rb)).any()


@pytest.mark.cuda
def test_pip_kernels_match_plain_on_the_card(pts):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    x, y = pts
    rng = np.random.default_rng(4)
    x = np.concatenate([x, rng.uniform(-74.3, -73.7, 1 << 18)])
    y = np.concatenate([y, rng.uniform(40.5, 41.0, 1 << 18)])
    e = edges_of(POLY)
    mx, my = morton_sorted(x, y)
    nx, ny = _f32(mx, my)
    nx[5::37] = np.nan
    ny[11::41] = np.nan
    ny[23::97] = np.inf
    nx, ny = (np.concatenate([a, np.zeros(700, np.float32)]) for a in (nx, ny))
    sets = {"shuffled": (x, y), "morton": (mx, my),
            "eps_boundary": eps_boundary_points(e, port_pip.BAND_EPS, n_edges=600),
            "nan_pad": (nx, ny)}
    # NaN edge ends (x of a flat edge, y), E around the kernels' chunk, and
    # more edges than a block tests in one group of chunks
    nan_e = [np.array(a, np.float64) for a in e]
    flat = int(np.argmin(np.abs(nan_e[3] - nan_e[1])))
    nan_e[0][flat] = np.nan
    nan_e[1][7] = nan_e[2][11] = np.nan
    c = pk.CHUNK
    tables = {"polygon": e, "nan_edges": nan_e,
              **{f"E={k}": [a[:k] for a in e] for k in (0, 1, c - 1, c, c + 1)},
              "E=9000": edges_of(star_polygon_wkt(seed=4, n_shell=8936))}
    for name, (sx, sy) in sets.items():
        for tname, te in tables.items():
            if tname != "polygon" and name == "shuffled":
                continue  # the skip rule is what these cases exercise
            args = [torch.from_numpy(a).to(dev) for a in _f32(sx, sy, *te)]
            assert torch.equal(pk.pip_crossing(*args),
                               pk.pip_crossing_plain(*args)), (name, tname)
            for eps in (port_pip.BAND_EPS, 1e-3):
                assert torch.equal(pk.pip_band(*args, eps=eps),
                                   pk.pip_band_plain(*args, eps=eps)), (name, tname)
