"""The skip rule of the port's PIP kernels (B4, B5) on the CPU.

The CUDA kernels (`engine/kernels/pip_crossing.cu`) skip, for each block
of consecutive points, every chunk of edges and every edge whose y-span
cannot reach the block's y-range. The kernels cannot run here, so this
file mirrors their structure in PyTorch from the module's own statement
of the rule (`block_y_range`, `kept_edge_mask` over `edge_chunk_bounds`
and `out_of_reach`): each block is evaluated by the plain version over
only the edges it keeps.
The mirror must equal the plain version, which tests every pair, and the
reference's Pallas kernels in interpret mode, bit for bit, for
Morton-sorted and shuffled points, points at exactly y +- eps of
near-flat edges and 1-2 f32 ulps either side, points on vertices, NaN
and infinite coordinates and zero pad rows, and E in {0, 1, C-1, C,
C+1, 1088} (with NaN edge ends too).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.engine.pip_pallas import (
    points_in_polygon_band_pallas, points_in_polygon_pallas)
from geomesa_tpu_torch.engine import pip_kernels as pk
from geomesa_tpu_torch.engine.pip import BAND_EPS

from test_torch_pip import eps_boundary_points, morton_sorted
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

C = pk.CHUNK


def ring_edges(rng, n, cx=-74.0, cy=40.75, rx=0.2, ry=0.16):
    """n edges of a closed star-shaped ring, every other edge made
    near-flat (dy in {0, 3e-5, 9e-5, 1.5e-4}, so within and beyond the
    band's eps), f64 (x1, y1, x2, y2)."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(0.55, 1.0, n)
    x = cx + rx * r * np.cos(ang)
    y = cy + ry * r * np.sin(ang)
    y[1::2] = y[0:-1:2][: len(y[1::2])] + rng.choice([0.0, 3e-5, 9e-5, 1.5e-4],
                                                     len(y[1::2]))
    return x, y, np.roll(x, -1), np.roll(y, -1)


def edge_table(name):
    """The edge tables of the cases, f32 numpy (x1, y1, x2, y2)."""
    rng = np.random.default_rng(17)
    if name == "0":
        z = np.zeros(0, np.float32)
        return z, z, z, z
    if name == "1":
        e = ([-74.1], [40.7], [-73.9], [40.70005])
    elif name == "1088":  # the zone polygon's size: 1024 shell + 64 hole
        shell = ring_edges(rng, 1024)
        hole = ring_edges(rng, 64, cx=-73.98, cy=40.74, rx=0.03, ry=0.025)
        e = [np.concatenate([a, b]) for a, b in zip(shell, hole)]
    else:
        e = list(ring_edges(rng, int(name.rstrip("nan"))))
        if name.endswith("nan"):  # NaN ends: x only, y only, both
            e[0][3] = np.nan
            e[1][7] = np.nan
            e[3][11] = e[1][11] = np.nan
            e[2][20] = e[3][20] = np.nan
    return tuple(np.asarray(a, np.float32) for a in e)


def point_set(name, edges, n=2048):
    """f32 points of one case, over the edges' envelope."""
    x1, y1, x2, y2 = (a.astype(np.float64) for a in edges)
    rng = np.random.default_rng(23)
    fin = lambda a: a[np.isfinite(a)]  # noqa: E731
    xs = np.concatenate([fin(x1), fin(x2), [-74.2, -73.8]])
    ys = np.concatenate([fin(y1), fin(y2), [40.6, 40.9]])
    x = rng.uniform(xs.min() - 0.02, xs.max() + 0.02, n)
    y = rng.uniform(ys.min() - 0.02, ys.max() + 0.02, n)
    ok = np.isfinite(x1) & np.isfinite(y1) & np.isfinite(x2) & np.isfinite(y2)
    good = np.nonzero(ok)[0]
    if name == "eps_boundary" and len(good):
        return eps_boundary_points([a[good] for a in edges], BAND_EPS, n_edges=48)
    if name == "vertices" and len(good):
        vx = np.concatenate([x1[good], x2[good]]).astype(np.float32)
        vy = np.concatenate([y1[good], y2[good]]).astype(np.float32)
        up = np.nextafter(vy, np.float32(np.inf))
        dn = np.nextafter(vy, np.float32(-np.inf))
        x = np.concatenate([vx, vx, vx, np.nextafter(vx, np.float32(np.inf))])
        y = np.concatenate([vy, up, dn, vy])
        o = np.argsort(y, kind="stable")
        return x[o].astype(np.float32), y[o].astype(np.float32)
    if len(good):  # two thirds on the edges and within a few ulps of them
        k = n // 3
        e = rng.choice(good, n - k)
        t = rng.choice([0.0, 0.5, 0.25, rng.uniform()], n - k)
        ulp = rng.choice([0.0, 1.0, -1.0, 3.0], (2, n - k)) * float(
            np.spacing(np.float32(74.0)))
        x[k:] = x1[e] + t * (x2[e] - x1[e]) + ulp[0]
        y[k:] = y1[e] + t * (y2[e] - y1[e]) + ulp[1]
    x, y = morton_sorted(x, y)
    x, y = x.astype(np.float32), y.astype(np.float32)
    if name == "shuffled":
        p = rng.permutation(n)
        return x[p], y[p]
    if name == "nan_pad":  # NaN and infinite coordinates, then pow2 pad rows
        x[5::37] = np.nan
        y[11::41] = np.nan
        x[17::53] = y[17::53] = np.nan
        y[23::97] = np.inf
        y[29::101] = -np.inf
        z = np.zeros(700, np.float32)
        return np.concatenate([x, z]), np.concatenate([y, z])
    return x, y


def pruned(kind, px, py, edges, block, chunk, eps=BAND_EPS):
    """The kernels' structure in PyTorch: per block of `block` points, the
    plain version over only the edges of the chunks (of `chunk` edges)
    that reach the block's y-range and that reach it themselves. Returns
    (bool [N], kept [blocks, E])."""
    n = px.shape[0]
    ymin, ymax = pk.block_y_range(py, block)
    _, keep = pk.kept_edge_mask(ymin, ymax, edges[1], edges[3],
                                None if kind == "crossing" else eps, chunk)
    out = torch.zeros(n, dtype=torch.bool)
    for b in range(keep.shape[0]):
        sl = slice(b * block, min(n, (b + 1) * block))
        idx = torch.nonzero(keep[b]).flatten()
        sub = [a[idx] for a in edges]
        out[sl] = (pk.pip_crossing_plain(px[sl], py[sl], *sub) if kind == "crossing"
                   else pk.pip_band_plain(px[sl], py[sl], *sub, eps))
    return out, keep


EDGES = ["0", "1", str(C - 1), str(C), str(C + 1), f"{C + 1}nan", "1088"]
SETS = ["morton", "shuffled", "eps_boundary", "vertices", "nan_pad"]


@pytest.mark.parametrize("kind", ["crossing", "band"])
@pytest.mark.parametrize("pset", SETS)
@pytest.mark.parametrize("ename", EDGES)
def test_skip_rule_keeps_every_result(ename, pset, kind):
    edges = edge_table(ename)
    px, py = point_set(pset, edges)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (px, py, *edges)]
    if kind == "crossing":
        plain = pk.pip_crossing_plain(*t)
        ref = points_in_polygon_pallas(*[jnp.asarray(a) for a in (px, py, *edges)],
                                       interpret=True)
    else:
        plain = pk.pip_band_plain(*t, BAND_EPS)
        ref = points_in_polygon_band_pallas(
            *[jnp.asarray(a) for a in (px, py, *edges)], eps=BAND_EPS,
            interpret=True)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(ref))
    # the kernels' own sizes, and smaller blocks and chunks, which skip more
    for block, chunk in ((pk.BLOCK_POINTS, C), (32, C), (16, 1)):
        got, keep = pruned(kind, t[0], t[1], t[2:], block, chunk)
        assert torch.equal(got, plain), (block, chunk)
        if block == pk.BLOCK_POINTS:
            own = keep
    if ename == "1088" and pset in ("morton", "eps_boundary", "vertices"):
        # thin blocks of 16 points keep a small share of the edges
        assert keep.float().mean() < 0.25
    if pset == "nan_pad":
        assert not got[-700:].any()  # pad rows at (0, 0) are far outside
    # the counting helper agrees with the mirror's kept edges
    by_chunk, by_edge = pk.kept_edges(t[1], t[3], t[5],
                                      None if kind == "crossing" else BAND_EPS)
    assert torch.equal(by_edge, own.sum(1)) and (by_edge <= by_chunk).all()


@pytest.mark.parametrize("kind", ["crossing", "band"])
@pytest.mark.parametrize("pset", SETS)
@pytest.mark.parametrize("ename", ["1", f"{C + 1}nan", "1088"])
def test_every_deciding_pair_is_in_reach(ename, pset, kind):
    """Pair by pair: every (point, edge) that adds a crossing (B4) or
    band-flags the point (B5) is kept by the rule for a block of that one
    point. (An edge with one NaN y-end can pass the half-open test but
    never crosses: its x at py is NaN.)"""
    edges = [torch.from_numpy(a) for a in edge_table(ename)]
    px, py = (torch.from_numpy(np.ascontiguousarray(a))
              for a in point_set(pset, edge_table(ename)))
    x1, y1, x2, y2 = (a[None, :] for a in edges)
    e32 = torch.tensor(BAND_EPS, dtype=torch.float32)
    cross, band = pk.crossing_and_band(px[:, None], py[:, None], x1, y1, x2, y2, e32)
    decides = cross if kind == "crossing" else band
    oor = pk.out_of_reach(torch.fmin(y1, y2), torch.fmax(y1, y2), py[:, None],
                          py[:, None], None if kind == "crossing" else BAND_EPS)
    assert not (decides & oor).any()
    if ename == "1088":  # neither side is vacuous: pairs decide, the rule skips
        assert decides.any() and oor.float().mean() > 0.5


@pytest.mark.parametrize("kind", ["crossing", "band"])
def test_kept_edges_counts(kind):
    edges = edge_table("1088")
    px, py = point_set("morton", edges)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (px, py, *edges)]
    eps = None if kind == "crossing" else BAND_EPS
    _, keep = pruned(kind, t[0], t[1], t[2:], pk.BLOCK_POINTS, C)
    by_chunk, by_edge = pk.kept_edges(t[1], t[3], t[5], eps)
    assert torch.equal(by_edge, keep.sum(1))
    ymin, ymax = pk.block_y_range(t[1])
    lo, hi = pk.edge_chunk_bounds(t[3], t[5])
    ck = ~pk.out_of_reach(lo[None, :], hi[None, :], ymin[:, None], ymax[:, None], eps)
    sizes = torch.tensor([min(C, len(edges[0]) - c * C) for c in range(len(lo))])
    assert torch.equal(by_chunk, (ck.long() * sizes).sum(1))
    assert (by_edge <= by_chunk).all() and (by_chunk < len(edges[0])).any()


@pytest.mark.parametrize("pset", SETS)
@pytest.mark.parametrize("ename", [f"{C + 1}nan", "1088"])
def test_near_flat_needs_a_flat_edge(ename, pset):
    """B5 tests its near-flat term only on edges with |y2 - y1| <= 4 eps
    (in f64): every pair where the term holds has such an edge."""
    x1, y1, x2, y2 = (torch.from_numpy(a)[None, :] for a in edge_table(ename))
    px, py = (torch.from_numpy(np.ascontiguousarray(a))[:, None]
              for a in point_set(pset, edge_table(ename)))
    e32 = torch.tensor(BAND_EPS, dtype=torch.float32)
    near_flat = ((torch.abs(py - y1) <= e32) & (torch.abs(py - y2) <= e32)
                 & (px >= torch.minimum(x1, x2) - e32)
                 & (px <= torch.maximum(x1, x2) + e32))
    flat = (y2.double() - y1.double()).abs() <= 4.0 * float(np.float32(BAND_EPS))
    assert not (near_flat & ~flat).any()
    if pset == "eps_boundary":
        assert near_flat.any()


def test_margin_is_needed_and_enough():
    """A point exactly eps above both ends of a flat edge is flagged; the
    B5 rule keeps that edge for it, the B4 rule (no margin) does not."""
    y = np.float32(40.7)
    py = np.float32(y + np.float32(BAND_EPS))
    edges = [torch.tensor([v], dtype=torch.float32) for v in (-74.1, y, -73.9, y)]
    p = [torch.tensor([v], dtype=torch.float32) for v in (-74.0, py)]
    assert bool(pk.pip_band_plain(*p, *edges, BAND_EPS)[0])
    lo, hi = edges[1], edges[3]
    assert not pk.out_of_reach(lo, hi, p[1], p[1], BAND_EPS).any()
    assert pk.out_of_reach(lo, hi, p[1], p[1]).all()


def test_chunk_bounds_and_block_range():
    rng = np.random.default_rng(3)
    y1 = rng.uniform(0, 1, 70).astype(np.float32)
    y2 = rng.uniform(0, 1, 70).astype(np.float32)
    y1[5] = np.nan
    y1[40:64] = y2[40:64] = np.nan  # one whole chunk of NaN edges (32..63 partly)
    y1[32:40] = y2[32:40] = np.nan
    lo, hi = pk.edge_chunk_bounds(torch.from_numpy(y1), torch.from_numpy(y2), 32)
    assert lo.shape == (3,)
    for c in range(3):
        a = np.concatenate([y1[c * 32:(c + 1) * 32], y2[c * 32:(c + 1) * 32]])
        a = a[~np.isnan(a)]
        assert lo[c] == (a.min() if len(a) else np.inf)
        assert hi[c] == (a.max() if len(a) else -np.inf)
    py = torch.tensor([3.0, np.nan, -1.0, 2.0, np.nan, np.nan, np.nan])
    ymin, ymax = pk.block_y_range(py, 2)
    assert ymin.tolist() == [3.0, -1.0, float("inf"), float("inf")]
    assert ymax.tolist() == [3.0, 2.0, -float("inf"), -float("inf")]
    # a block of NaN points is out of reach of every finite chunk
    assert pk.out_of_reach(lo[:1], hi[:1], ymin[2:3], ymax[2:3], BAND_EPS).all()


def test_constants_match_the_cuda_source():
    src = (Path(pk.__file__).parent / "kernels" / "pip_crossing.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kChunk"] == pk.CHUNK
    assert const["kThreads"] * const["kPerThread"] == pk.BLOCK_POINTS
