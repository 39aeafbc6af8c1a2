"""The port's polygon-layer spatial join (kernels B6-B9 and the entry points of
`engine/pip_sparse.py`) against the reference package's, on the same
seeded inputs.

The reference runs its Pallas kernels in interpret mode on the CPU; the
port runs the plain PyTorch versions of its CUDA kernels, which are what
its wrappers take for CPU tensors. The tolerance is zero: host structures
(prep, pair list, keys, `.npz`) are equal array for array, band-flag
counts are identical, and every entry point's result (inside, ids, counts,
join pairs) is identical after the f64 refine. Raw crossing counts are
identical except on band-flagged points: XLA's CPU backend contracts the
reference's `x1 + t*(x2-x1)` into a fused multiply-add, while the port
rounds the multiply and the add separately (as its CUDA kernels do and a
NumPy f32 evaluation does; ROADMAP Queue C). A point whose count that
one rounding flips lies within the band, so the refine decides it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomesa_tpu.engine import pip_sparse as R
from geomesa_tpu_torch.engine import pip_sparse as P
from geomesa_tpu_torch.engine import pip_sparse_kernels as psk
from geomesa_tpu_torch.errors import CudaUnavailableError

from test_pip_assign import assign_oracle
from test_pip_sparse import make_layer, make_points, oracle
from test_torch_threads import torch_cpu_share  # noqa: F401 (autouse)

EPS = 1e-4
T = P.POINT_TILE


def ring(cx, cy, ne, rx, ry):
    th = np.linspace(0, 2 * np.pi, ne, endpoint=False)
    r = np.stack([cx + rx * np.cos(th), cy + ry * np.sin(th)], 1)
    r = np.concatenate([r, r[:1]])
    return r[:-1, 0], r[:-1, 1], r[1:, 0], r[1:, 1]


def concat(parts, pids):
    cols = [np.concatenate([p[i] for p in parts]) for i in range(4)]
    pol = np.concatenate([np.full(len(p[0]), k, np.int64)
                          for p, k in zip(parts, pids)])
    return (*cols, pol)


def sparse_ids(pol, rng):
    """Polygon ids remapped to sparse int64 values above 2^32."""
    uids = np.unique(pol)
    big = 3_000_000_000_017 + np.sort(rng.choice(10**9, len(uids), replace=False)) * 7919
    return big[np.searchsorted(uids, pol)]


# -- layers (module scope: the reference's interpret-mode compiles are the
# cost of this file) ------------------------------------------------------


@pytest.fixture(scope="module")
def holes():
    """18 polygons with holes, 8192 points, 300 of them within 1e-6 of
    an edge."""
    rng = np.random.default_rng(2)
    x1, y1, x2, y2, pol = make_layer(rng)
    px, py = make_points(rng, x1, y1, x2, y2, n=8192, na=300)
    prep = R.prepare_layer(px, py, x1, y1, x2, y2, pol)
    return dict(pts=(px, py), layer=(x1, y1, x2, y2, pol), prep=prep)


def vertex_aligned():
    rng = np.random.default_rng(7)
    x1, y1, x2, y2, pol = make_layer(rng)
    k = 4096
    py = y1[rng.integers(0, len(x1), k)] + rng.choice([0.0, 1e-7, -1e-7], k)
    px = rng.uniform(-60, 60, k)
    o = np.argsort(px + 1e-3 * py)
    return (px[o], py[o]), (x1, y1, x2, y2, pol)


def near_horizontal():
    h = 2.5e-5
    r = np.array([[-40.0, 10.0], [40.0, 10.0 + h], [40.0, 30.0],
                  [-40.0, 30.0], [-40.0, 10.0]])
    layer = (r[:-1, 0], r[:-1, 1], r[1:, 0], r[1:, 1], np.zeros(4, np.int64))
    rng = np.random.default_rng(9)
    px = rng.uniform(-39, 39, 2048)
    py = 10.0 + (px + 40.0) / 80.0 * h + rng.uniform(-1e-6, 1e-6, 2048)
    o = np.argsort(px)
    return (px[o], py[o]), layer


def multi_tile():
    """Rings of 2000 and 700 edges (several edge tiles per polygon)."""
    layer = concat([ring(0.0, 0.0, 2000, 30.0, 20.0),
                    ring(45.0, 10.0, 700, 10.0, 15.0)], [0, 1])
    rng = np.random.default_rng(3)
    return make_points(rng, *layer[:4], n=8192, na=64), layer


def overlapping():
    """Two overlapping squares: points in the overlap have count 2."""
    sq = np.array([[0, 0], [10, 0], [10, 10], [0, 10], [0, 0]], float)
    parts = [(s[:-1, 0], s[:-1, 1], s[1:, 0], s[1:, 1]) for s in (sq, sq + 5.0)]
    rng = np.random.default_rng(5)
    return (np.sort(rng.uniform(-2, 18, 4000)), rng.uniform(-2, 18, 4000)), \
        concat(parts, [0, 1])


def empty_region():
    rng = np.random.default_rng(5)
    layer = make_layer(rng, npoly=4, grid=2)
    return (np.sort(rng.uniform(100, 170, 2000)), rng.uniform(-80, 80, 2000)), layer


def large_ids():
    a = ring(-20.0, 0.0, 32, 8.0, 8.0)
    b = ring(20.0, 0.0, 32, 8.0, 8.0)
    layer = concat([a, b], [3_000_000_000_017, 9_000_000_000_001])
    rng = np.random.default_rng(13)
    return (np.sort(rng.uniform(-35, 35, 4096)), rng.uniform(-12, 12, 4096)), layer


def holes_case():
    rng = np.random.default_rng(2)
    layer = make_layer(rng)
    return make_points(rng, *layer[:4], n=8192, na=300), layer


# -- host structures -------------------------------------------------------


def assert_prep_equal(a, b):
    for x, y in zip(a[:6], b[:6]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.pairs, b.pairs):
        np.testing.assert_array_equal(x, y)
    assert (a.n_ptiles, a.n_etiles) == (b.n_ptiles, b.n_etiles)


def test_prepare_layer_equal_with_holes_and_sparse_large_ids():
    rng = np.random.default_rng(21)
    x1, y1, x2, y2, pol = make_layer(rng, hole_p=0.6)
    pol = sparse_ids(pol, rng)
    assert pol.min() > 2**32
    # edges in a shuffled order: _group_ids takes its sorting path
    o = rng.permutation(len(pol))
    x1, y1, x2, y2, pol = x1[o], y1[o], x2[o], y2[o], pol[o]
    px, py = make_points(rng, x1, y1, x2, y2, n=6000, na=200)
    ref = R.prepare_layer(px, py, x1, y1, x2, y2, pol)
    got = P.prepare_layer(px, py, x1, y1, x2, y2, pol)
    assert_prep_equal(got, ref)
    assert len(got.pairs.pair_pt) > 10 and got.pairs.covered.any()
    for a, b in zip(P._poly_of_tile_from(got, pol), R._poly_of_tile_from(ref, pol)):
        np.testing.assert_array_equal(a, b)


def test_pad_and_build_pairs_edge_cases():
    # a polygon bbox outside the lon/lat domain still pairs (both ends
    # of the bucket range are clamped into the grid)
    args = (np.array([[190.0, 10.0, 191.0, 11.0]]),
            np.array([[189.0, 9.0, 196.0, 20.0]]), np.array([0]),
            np.array([[189.0, 9.0, 196.0, 20.0]]))
    for a, b in zip(P.build_pairs(*args), R.build_pairs(*args)):
        np.testing.assert_array_equal(a, b)
    assert len(P.build_pairs(*args).pair_pt) == 1
    x1, y1, x2, y2, pol = large_ids()[1]
    for a, b in zip(P.pad_polygon_edges(x1, y1, x2, y2, pol),
                    R.pad_polygon_edges(x1, y1, x2, y2, pol)):
        np.testing.assert_array_equal(a, b)
    pt = np.array([0, 0, 0, 0, 0, 1, 2], np.int32)
    for cap in (1, 2, 3, 7):
        assert P.chunk_pairs(pt, pt, cap=cap) == R.chunk_pairs(pt, pt, cap=cap)
    assert P.chunk_pairs(pt, pt) == [(0, 7)]


def test_prep_key_and_npz_load_across_packages(holes, tmp_path):
    px, py = holes["pts"]
    layer = holes["layer"]
    key = P.layer_prep_key(px, py, *layer)
    assert key == R.layer_prep_key(px, py, *layer)
    assert P.layer_prep_key(px, py, *layer, margin=2e-3) == R.layer_prep_key(
        px, py, *layer, margin=2e-3) != key
    ref = holes["prep"]
    R.save_layer_prep(ref, str(tmp_path / "ref.npz"))
    got = P.load_layer_prep(str(tmp_path / "ref.npz"))
    assert_prep_equal(got, ref)
    P.save_layer_prep(got, str(tmp_path / "port.npz"))
    assert_prep_equal(R.load_layer_prep(str(tmp_path / "port.npz")), ref)
    # a prep the port wrote and the reference loaded gives equal results
    i_ref, _ = R.pip_layer(px, py, *layer, interpret=True,
                           prep=R.load_layer_prep(str(tmp_path / "port.npz")))
    i_got, _ = P.pip_layer(px, py, *layer, device="cpu", prep=got)
    np.testing.assert_array_equal(i_got, i_ref)


def test_prepare_layer_cached_reads_the_reference_cache(holes, tmp_path, monkeypatch):
    px, py = holes["pts"]
    layer = holes["layer"]
    R._PREP_MEM_CACHE.clear()
    R.prepare_layer_cached(px, py, *layer, cache_dir=str(tmp_path))
    key = P.layer_prep_key(px, py, *layer)
    assert (tmp_path / f"layerprep_{key}.npz").exists()
    P._PREP_MEM_CACHE.clear()
    calls = []
    monkeypatch.setattr(P, "prepare_layer", lambda *a, **k: calls.append(1))
    # the directory through the system property, as in the reference
    monkeypatch.setenv("GEOMESA_TPU_SPATIAL_PREP_CACHE_DIR", str(tmp_path))
    got = P.prepare_layer_async(px, py, *layer)()
    assert not calls  # loaded from the reference's file, not rebuilt
    assert_prep_equal(got, holes["prep"])
    assert P.prepare_layer_cached(px, py, *layer, key=key) is got  # LRU hit
    P._PREP_MEM_CACHE.clear()


def test_prep_lru_byte_cap(monkeypatch):
    P._PREP_MEM_CACHE.clear()
    monkeypatch.setattr(P, "_PREP_MEM_MAX_BYTES", 1)
    preps = [P.prepare_layer(*large_ids()[0], *large_ids()[1]) for _ in range(2)]
    P._prep_cache_put("a", preps[0])
    P._prep_cache_put("b", preps[1])
    assert list(P._PREP_MEM_CACHE) == ["b"]  # the new entry is kept
    P._PREP_MEM_CACHE.clear()


# -- the plain kernels against the reference's Pallas calls ----------------


def np_pair_counts(prep, pt, et, eps=EPS):
    """NumPy f32 evaluation of the predicate with every step rounded
    (no fused multiply-add): (crossings, band) int32 [M, 512]."""
    f = np.float32
    e = f(eps)
    P_ = [np.asarray(a, f).reshape(-1, T) for a in (prep.pxp, prep.pyp)]
    E_ = [np.asarray(a, f).reshape(-1, T) for a in (prep.ex1, prep.ey1, prep.ex2, prep.ey2)]
    out_c, out_b = [], []
    for p, q in zip(pt, et):
        qx, qy = P_[0][p][:, None], P_[1][p][:, None]
        x1, y1, x2, y2 = (a[q][None, :] for a in E_)
        cond = (y1 <= qy) != (y2 <= qy)
        t = (qy - y1) / np.where(y2 == y1, f(1), y2 - y1)
        xc = x1 + t * (x2 - x1)
        near_flat = ((np.abs(qy - y1) <= e) & (np.abs(qy - y2) <= e)
                     & (qx >= np.minimum(x1, x2) - e) & (qx <= np.maximum(x1, x2) + e))
        err = e * (f(1) + np.abs(x2 - x1) / np.maximum(np.abs(y2 - y1), e))
        out_c.append((cond & (xc > qx)).sum(1))
        out_b.append((near_flat | (cond & (np.abs(xc - qx) <= err))).sum(1))
    return np.asarray(out_c, np.int32), np.asarray(out_b, np.int32)


def ref_edges(prep, dummy=True):
    """The reference's f32 edge operands, with its all-BIG dummy tile."""
    out = []
    for a, fill in zip((prep.ex1, prep.ey1, prep.ex2, prep.ey2), (0.0, R.BIG, 0.0, R.BIG)):
        a = np.asarray(a, np.float32)
        out.append(jnp.asarray(np.concatenate([a, np.full(T, fill, np.float32)])
                               if dummy else a))
    return out


def port_args(prep):
    return [torch.from_numpy(np.asarray(a, np.float32))
            for a in (prep.pxp, prep.pyp, prep.ex1, prep.ey1, prep.ex2, prep.ey2)]


def rows_of(prep):
    pl = prep.pairs
    tiles, counts = np.unique(pl.pair_pt, return_counts=True)
    return tiles, counts, np.concatenate([[0], np.cumsum(counts)[:-1]])


def assert_counts(got, ref, band, what):
    """Identical outside band-flagged points (module docstring)."""
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(got[band == 0], ref[band == 0], err_msg=what)


def test_pair_csr_rows(holes):
    prep = holes["prep"]
    pl = prep.pairs
    tiles, counts, starts = rows_of(prep)
    csr = psk.pair_csr(pl.pair_pt, pl.pair_et)
    np.testing.assert_array_equal(csr.rows, tiles)
    np.testing.assert_array_equal(csr.row_ptr, np.r_[starts, len(pl.pair_pt)])
    np.testing.assert_array_equal(csr.ets, pl.pair_et)
    assert csr.pinfo is None
    # the CUDA wrappers refuse tile ids the kernels would read past
    ets = torch.from_numpy(csr.ets)
    top, low = int(ets.max()), int(ets.min())
    psk._in_range((ets, prep.n_etiles), (ets[:0], 0))
    with pytest.raises(ValueError, match="out of range"):
        psk._in_range((ets, prep.n_etiles), (ets, top))
    with pytest.raises(ValueError, match="out of range"):
        psk._in_range((ets - (low + 1), prep.n_etiles))


def test_plain_grouped_matches_reference(holes):
    """B6: `_pip_grouped_call` over every covered tile at one capacity."""
    prep = holes["prep"]
    pl = prep.pairs
    tiles, counts, starts = rows_of(prep)
    cap = max(2, 1 << int(np.ceil(np.log2(counts.max()))))
    etab = np.full((len(tiles), cap), prep.n_etiles, np.int32)
    for k, (s, c) in enumerate(zip(starts, counts)):
        etab[k, :c] = pl.pair_et[s:s + c]
    pxt = jnp.asarray(np.asarray(prep.pxp, np.float32).reshape(-1, T)[tiles])
    pyt = jnp.asarray(np.asarray(prep.pyp, np.float32).reshape(-1, T)[tiles])
    rc, rb = R._pip_grouped_call(pxt, pyt, *ref_edges(prep), jnp.asarray(etab),
                                 cap=cap, n_etiles=prep.n_etiles, eps=EPS,
                                 interpret=True)
    csr = psk.pair_csr(pl.pair_pt, pl.pair_et)
    gc, gb = psk.pip_grouped(*port_args(prep), *[torch.from_numpy(a) for a in csr[:3]],
                             n_ptiles=prep.n_ptiles, eps=EPS)
    gc, gb = gc.numpy(), gb.numpy()
    np.testing.assert_array_equal(gb[tiles], np.asarray(rb))
    assert_counts(gc[tiles], np.asarray(rc), gb[tiles], "B6 crossings")
    assert gb.sum() > 0 and gc[tiles].sum() > 0
    uncovered = np.setdiff1d(np.arange(prep.n_ptiles), tiles)
    assert not gc[uncovered].any() and not gb[uncovered].any()
    # exact against the NumPy f32 evaluation, summed per tile
    nc, nb = np_pair_counts(prep, pl.pair_pt, pl.pair_et)
    ec = np.zeros_like(gc)
    eb = np.zeros_like(gb)
    np.add.at(ec, pl.pair_pt, nc)
    np.add.at(eb, pl.pair_pt, nb)
    np.testing.assert_array_equal(gc, ec)
    np.testing.assert_array_equal(gb, eb)


def ref_assign_tables(prep, rank_of_tile):
    """The reference's etab/pinfo for one capacity class, built as its
    `pip_layer_assign` builds them."""
    pl = prep.pairs
    pt = np.asarray(pl.pair_pt, np.int64)
    et = np.asarray(pl.pair_et, np.int64)
    pid = rank_of_tile[et]
    o = np.lexsort((pid, pt))
    pt, et, pid = pt[o], et[o], pid[o]
    last = np.ones(len(pt), bool)
    last[:-1] = (pt[1:] != pt[:-1]) | (pid[1:] != pid[:-1])
    pinfo = np.where(last, -(pid + 1), pid + 1).astype(np.int32)
    tiles, counts = np.unique(pt, return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cap = max(2, 1 << int(np.ceil(np.log2(counts.max()))))
    etab = np.full((len(tiles), cap), prep.n_etiles, np.int32)
    pin = np.zeros((len(tiles), cap), np.int32)
    for k, (s, c) in enumerate(zip(starts, counts)):
        etab[k, :c] = et[s:s + c]
        pin[k, :c] = pinfo[s:s + c]
    return tiles, etab, pin, cap


@pytest.mark.parametrize("case", [holes_case, multi_tile, overlapping],
                         ids=["holes", "multi_tile", "overlapping"])
def test_plain_assign_matches_reference(case):
    """B7: `_pip_assign_call` with the reference's flush markers."""
    (px, py), layer = case()
    prep = R.prepare_layer(px, py, *layer)
    rank, _ = R._poly_of_tile_from(prep, layer[4])
    tiles, etab, pin, cap = ref_assign_tables(prep, rank)
    pxt = jnp.asarray(np.asarray(prep.pxp, np.float32).reshape(-1, T)[tiles])
    pyt = jnp.asarray(np.asarray(prep.pyp, np.float32).reshape(-1, T)[tiles])
    ra, rn, rb = (np.asarray(a) for a in R._pip_assign_call(
        pxt, pyt, *ref_edges(prep), jnp.asarray(etab), jnp.asarray(pin),
        cap=cap, n_etiles=prep.n_etiles, eps=EPS, interpret=True))
    pl = prep.pairs
    csr = psk.pair_csr(pl.pair_pt, pl.pair_et,
                       poly_of_tile=P._poly_of_tile_from(prep, layer[4])[0])
    ga, gn, gb = (a.numpy() for a in psk.pip_assign(
        *port_args(prep), *[torch.from_numpy(a) for a in csr],
        n_ptiles=prep.n_ptiles, eps=EPS))
    np.testing.assert_array_equal(gb[tiles], rb)
    assert_counts(ga[tiles], ra, rb, "B7 assign")
    assert_counts(gn[tiles], rn, rb, "B7 count")
    assert gn.sum() > 100


def test_plain_pairs_match_reference(holes):
    """B8/B9: `_pip_sparse_call` over the whole pair list, one call."""
    prep = holes["prep"]
    pl = prep.pairs
    rc, rb = R._pip_sparse_call(
        jnp.asarray(prep.pxp), jnp.asarray(prep.pyp), *ref_edges(prep, dummy=False),
        jnp.asarray(pl.pair_pt), jnp.asarray(pl.pair_et),
        n_ptiles=prep.n_ptiles, n_etiles=prep.n_etiles, eps=EPS, interpret=True)
    rc = np.asarray(rc).reshape(-1, T)
    rb = np.asarray(rb).reshape(-1, T)
    args = port_args(prep)
    ids = [torch.from_numpy(np.asarray(a)) for a in (pl.pair_pt, pl.pair_et)]
    gc = psk.pip_pairs_count(*args, *ids, prep.n_ptiles).numpy()
    gb = psk.pip_pairs_band(*args, *ids, prep.n_ptiles, EPS).numpy()
    assert gc.shape == gb.shape == (prep.n_ptiles + 1, T)
    cov = np.nonzero(pl.covered)[0]
    np.testing.assert_array_equal(gb[cov], rb[cov])
    assert_counts(gc[cov], rc[cov], rb[cov], "B8 crossings")
    assert not gc[-1].any() and not gb[-1].any()
    gg = psk.pip_grouped(*args, *[torch.from_numpy(a) for a in psk.pair_csr(
        pl.pair_pt, pl.pair_et)[:3]],
        n_ptiles=prep.n_ptiles, eps=EPS)
    np.testing.assert_array_equal(gc[:-1], gg[0].numpy())
    np.testing.assert_array_equal(gb[:-1], gg[1].numpy())


def test_reference_cpu_run_differs_only_on_flagged_points(holes):
    """The one difference the module docstring names, shown: the
    reference's interpret-mode crossings differ from the separately
    rounded f32 evaluation (port and NumPy alike) at some point, and
    every such point is band-flagged."""
    prep = holes["prep"]
    pl = prep.pairs
    rc, _ = R.pip_layer_grouped(
        jnp.asarray(prep.pxp), jnp.asarray(prep.pyp), *ref_edges(prep, dummy=False),
        pl.pair_pt, pl.pair_et, n_ptiles=prep.n_ptiles, n_etiles=prep.n_etiles,
        interpret=True)
    gc, gb = P.pip_layer_grouped(
        prep.pxp, prep.pyp, prep.ex1, prep.ey1, prep.ex2, prep.ey2, pl.pair_pt,
        pl.pair_et, n_ptiles=prep.n_ptiles, n_etiles=prep.n_etiles, device="cpu")
    diff = np.nonzero(np.asarray(rc) != gc.numpy())[0]
    assert len(diff) and (gb.numpy()[diff] > 0).all()


def test_cpu_wrappers_launch_nothing(holes):
    prep = holes["prep"]
    pl = prep.pairs
    ws = (psk.pip_grouped, psk.pip_assign, psk.pip_pairs_count, psk.pip_pairs_band)
    before = [w.launches for w in ws]
    P.pip_layer(*holes["pts"], *holes["layer"], device="cpu", prep=prep)
    P.pip_layer_join(*holes["pts"], *holes["layer"], device="cpu", prep=prep)
    P.pip_layer_sparse(prep.pxp, prep.pyp, prep.ex1, prep.ey1, prep.ex2, prep.ey2,
                       pl.pair_pt, pl.pair_et, n_ptiles=prep.n_ptiles,
                       n_etiles=prep.n_etiles, device="cpu")
    assert [w.launches for w in ws] == before


# -- the entry points against the reference's -------------------------------


@pytest.mark.parametrize("case", [holes_case, vertex_aligned, near_horizontal,
                                  multi_tile, empty_region],
                         ids=["holes_adversarial", "vertex_aligned", "near_horizontal",
                              "multi_tile", "empty_region"])
def test_pip_layer_matches_reference(case):
    (px, py), layer = case()
    ri, rinfo = R.pip_layer(px, py, *layer, interpret=True)
    gi, ginfo = P.pip_layer(px, py, *layer, device="cpu")
    np.testing.assert_array_equal(gi, ri)
    # pairs, flagged, refined, tiles (refine_s is a wall time)
    assert ginfo.pop("refine_s") >= 0 and rinfo.pop("refine_s") >= 0
    assert ginfo == rinfo
    np.testing.assert_array_equal(gi, oracle(px, py, *layer[:4]))


def test_pip_layer_info_and_uploads(holes):
    px, py = holes["pts"]
    layer = holes["layer"]
    prep = P.prepare_layer(px, py, *layer)
    pts = P.upload_points(px, py, device="cpu")
    edges = P.upload_edges(prep, device="cpu")
    np.testing.assert_array_equal(pts[0].numpy(), prep.pxp.astype(np.float32))
    a, ia = P.pip_layer(px, py, *layer, device="cpu", prep=prep,
                        points_device=pts, edges_device=edges)
    b, ib = P.pip_layer(px, py, *layer, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert set(ia) == {"pairs", "refined", "n_ptiles", "n_etiles", "flagged", "refine_s"}
    assert ia["refined"] == ia["flagged"] > 0
    raw, _ = P.pip_layer(px, py, *layer, device="cpu", prep=prep, refine_f64=False)
    assert (raw != a).sum() <= ia["flagged"]


@pytest.mark.parametrize("case", [holes_case, multi_tile, overlapping, empty_region,
                                  large_ids],
                         ids=["disjoint", "multi_tile", "overlapping", "empty_region",
                              "large_ids"])
def test_pip_layer_assign_matches_reference(case):
    (px, py), layer = case()
    rid, rcnt, rinfo = R.pip_layer_assign(px, py, *layer, interpret=True)
    gid, gcnt, ginfo = P.pip_layer_assign(px, py, *layer, device="cpu")
    np.testing.assert_array_equal(gid, rid)
    np.testing.assert_array_equal(gcnt, rcnt)
    assert gid.dtype == rid.dtype and gcnt.dtype == rcnt.dtype
    assert ginfo == rinfo
    exp_id, exp_n = assign_oracle(px, py, *layer)
    np.testing.assert_array_equal(gid, exp_id)
    np.testing.assert_array_equal(gcnt, exp_n)


@pytest.mark.parametrize("case", [holes_case, overlapping, large_ids],
                         ids=["disjoint", "overlapping", "large_ids"])
def test_pip_layer_join_matches_reference(case):
    (px, py), layer = case()
    rp, rpoly = R.pip_layer_join(px, py, *layer, interpret=True)
    gp, gpoly = P.pip_layer_join(px, py, *layer, device="cpu")
    ro = np.lexsort((rpoly, rp))
    go = np.lexsort((gpoly, gp))
    np.testing.assert_array_equal(gp[go], rp[ro])
    np.testing.assert_array_equal(gpoly[go], rpoly[ro])
    exp_id, exp_n = assign_oracle(px, py, *layer)
    assert len(gp) == int(exp_n.sum()) > 0  # overlap multiplicity kept


def test_pip_layer_sparse_matches_reference_and_chunking(holes):
    prep = holes["prep"]
    pl = prep.pairs
    arrays = (prep.pxp, prep.pyp, prep.ex1, prep.ey1, prep.ex2, prep.ey2)
    kw = dict(n_ptiles=prep.n_ptiles, n_etiles=prep.n_etiles)
    rc, rb = R.pip_layer_sparse(*[jnp.asarray(a) for a in arrays], pl.pair_pt,
                                pl.pair_et, interpret=True, **kw)
    c1, b1 = P.pip_layer_sparse(*arrays, pl.pair_pt, pl.pair_et, device="cpu", **kw)
    c2, b2 = P.pip_layer_sparse(*arrays, pl.pair_pt, pl.pair_et, device="cpu",
                                max_pairs_per_call=2, **kw)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(b1, b2)
    cov = np.repeat(pl.covered, T)
    np.testing.assert_array_equal(b1[cov], np.asarray(rb)[cov])
    assert_counts(c1[cov], np.asarray(rc)[cov], b1[cov], "sparse crossings")
    assert not c1[~cov].any() and not b1[~cov].any()  # zeros, not garbage
    gc, gb = P.pip_layer_grouped(*arrays, pl.pair_pt, pl.pair_et, device="cpu", **kw)
    np.testing.assert_array_equal(c1, gc.numpy())
    np.testing.assert_array_equal(b1, gb.numpy())


@pytest.mark.parametrize("entry", ["pip_layer", "pip_layer_assign", "pip_layer_join",
                                    "pip_layer_grouped", "pip_layer_sparse",
                                    "upload_points"])
def test_default_device_is_the_card(holes, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    prep = holes["prep"]
    pl = prep.pairs
    arrays = (prep.pxp, prep.pyp, prep.ex1, prep.ey1, prep.ex2, prep.ey2)
    calls = {
        "pip_layer": lambda: P.pip_layer(*holes["pts"], *holes["layer"], prep=prep),
        "pip_layer_assign": lambda: P.pip_layer_assign(*holes["pts"], *holes["layer"]),
        "pip_layer_join": lambda: P.pip_layer_join(*holes["pts"], *holes["layer"]),
        "pip_layer_grouped": lambda: P.pip_layer_grouped(
            *arrays, pl.pair_pt, pl.pair_et, n_ptiles=prep.n_ptiles,
            n_etiles=prep.n_etiles),
        "pip_layer_sparse": lambda: P.pip_layer_sparse(
            *arrays, pl.pair_pt, pl.pair_et, n_ptiles=prep.n_ptiles,
            n_etiles=prep.n_etiles),
        "upload_points": lambda: P.upload_points(*holes["pts"]),
    }
    with pytest.raises(CudaUnavailableError):
        calls[entry]()


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_layer_kernels_match_plain_on_the_card(holes):
    """B6-B9 against their plain versions on the card, bit for bit: the
    config-2-shaped layer with holes, and near-flat edges with one NaN
    x-end beside points within eps of their finite end (the x-span must
    propagate NaN, as the plain versions' torch.minimum/maximum do); B8
    and B9 also over the pairs shuffled with a tenth of them twice, and
    over that list cut into two launches whose outputs add."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from test_torch_pip_layer_prune import make_case, shuffled_pairs

    dev = torch.device("cuda")
    prep = holes["prep"]
    nan = make_case("nan_edges")
    cases = [(port_args(prep), prep.pairs.pair_pt, prep.pairs.pair_et,
              P._poly_of_tile_from(prep, holes["layer"][4])[0], prep.n_ptiles),
             ([torch.from_numpy(a) for a in (nan.px, nan.py, *nan.edges)],
              nan.pt, nan.et, nan.rank, nan.n_ptiles)]
    for args, pair_pt, pair_et, rank, n in cases:
        args = [a.to(dev) for a in args]
        g = [torch.from_numpy(a).to(dev) for a in psk.pair_csr(pair_pt, pair_et)[:3]]
        a = [torch.from_numpy(x).to(dev) for x in psk.pair_csr(
            pair_pt, pair_et, poly_of_tile=rank)]
        ids = [torch.from_numpy(np.asarray(x)).to(dev) for x in (pair_pt, pair_et)]
        pairs = [
            (psk.pip_grouped(*args, *g, n, EPS), psk.pip_grouped_plain(*args, *g, n, EPS)),
            (psk.pip_assign(*args, *a, n, EPS), psk.pip_assign_plain(*args, *a, n, EPS)),
            ((psk.pip_pairs_count(*args, *ids, n),),
             (psk.pip_pairs_count_plain(*args, *ids, n),)),
            ((psk.pip_pairs_band(*args, *ids, n, EPS),),
             (psk.pip_pairs_band_plain(*args, *ids, n, EPS),)),
        ]
        sp = [torch.from_numpy(x).to(dev) for x in shuffled_pairs(
            np.asarray(pair_pt), np.asarray(pair_et), np.random.default_rng(3))]
        h = sp[0].shape[0] // 2
        band_sp = psk.pip_pairs_band_plain(*args, *sp, n, EPS)
        count_sp = psk.pip_pairs_count_plain(*args, *sp, n)
        pairs += [
            ((psk.pip_pairs_count(*args, *sp, n),), (count_sp,)),
            ((psk.pip_pairs_count(*args, sp[0][:h], sp[1][:h], n)
              + psk.pip_pairs_count(*args, sp[0][h:], sp[1][h:], n),), (count_sp,)),
            ((psk.pip_pairs_band(*args, *sp, n, EPS),), (band_sp,)),
            ((psk.pip_pairs_band(*args, sp[0][:h], sp[1][:h], n, EPS)
              + psk.pip_pairs_band(*args, sp[0][h:], sp[1][h:], n, EPS),), (band_sp,)),
        ]
        torch.cuda.synchronize()
        for got, exp in pairs:
            for x, y in zip(got, exp):
                assert torch.equal(x, y)
