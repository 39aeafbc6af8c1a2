#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (geomesa_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full size: 2^26 rows in each store
    python3 chip_smoke.py --rows N   # smaller stores, for a quick check

Needs a CUDA card and the CUDA toolkit (nvcc); without a card it exits 1
and prints no result. Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build of every CUDA kernel source in the checkout, one nvcc each, all
   started together;
3. kernel check: each kernel against its plain PyTorch version on the card
   (B1/B2 at Q=256, N=2^22, dead sparse slots exactly 1e9; B3 over 2^22
   Z-ordered points on a 512x512 grid: counts equal, weights within the
   per-cell bound, dictionary misses add nothing; B4/B5 at N=2^22 against
   a ~1100-edge zone polygon: identical booleans);
4. the kNN path at full size: DataStore on the card -> write -> get_count
   and knn (sparse, fullscan, forced overflow) for the north-star CQL
   (BBOX + time + attribute, bench config 3's data shape), with launch
   counts reset before and read after, checked against an f64 NumPy
   oracle (exact count, recall on 16 queries, identical neighbour sets
   across the three routes), and a torch.profiler breakdown of one warm
   call of each route;
5. the density path at full size (bench config 4: a 512x512 heatmap of
   NYC-taxi-shaped pickups, monthly partitions): get_features density
   (weighted, unweighted, scatter route), a zone-polygon get_count and
   density, and DensityProcess with radius 2, each timed cold and warm,
   with launch counts reset before and read after, checked against
   independent oracles (NumPy binning, an f64 crossing count on the card,
   the scatter route, the exact fallback on a shuffled copy), and a
   torch.profiler breakdown of one warm density call;
6. each kernel timed at its path's shapes beside its plain version and
   its bound, printed as one {"kernels": [...]} line.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

Q = 256
K = 10
KERNEL_CHECK_N = 1 << 22
PIP_CHECK_N = 1 << 22
TOL = 1e-5  # |key| <= 12, so a few f32 ulps of association-order noise
BBOX = (-60.0, 20.0, 60.0, 70.0)
T0, T1 = 1_592_000_000_000, 1_598_000_000_000
OVERFLOW_CAP = 64  # seeded sparse capacity, below the query's match tiles
# NVIDIA H100 SXM data sheet: HBM3 rate and FP32 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def iso(ms: int) -> str:
    return str(np.datetime64(ms, "ms")) + "Z"


def timed_ms(torch, fn, reps: int) -> float:
    """Median device time of fn over `reps` runs (CUDA events), warm."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(keys: int, nbytes: int):
    """Least time for the work: the larger of HBM bytes and FP32 operations
    (4 FMAs = 8 FLOP plus one min per key) over the data-sheet peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = keys * 9 / FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def morton_order(torch, x, y):
    """Store order: argsort of the Z2 Morton key (31 bits per dimension,
    lon/lat normalised over the WGS84 envelope), computed on the card."""
    def norm(v, lo, hi):
        s = torch.floor((v - lo) / (hi - lo) * float(1 << 31))
        return torch.clamp(s, 0, (1 << 31) - 1).to(torch.int64)

    def split(v):
        for shift, m in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                         (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                         (1, 0x5555555555555555)):
            v = (v | (v << shift)) & m
        return v

    z = split(norm(x, -180.0, 180.0)) | (split(norm(y, -90.0, 90.0)) << 1)
    return torch.argsort(z).cpu().numpy()


def profile_calls(torch, name, fn, card_s: str, calls: int = 3) -> None:
    """Where one warm call's time goes: torch.profiler over `calls` calls,
    device busy time (sum of kernel self times) against the host wall,
    and the top device operations. The profiler's own overhead inflates
    the wall it reports, so the latency lines above stay the metric."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0.0))
    # kernel rows only: an operator row repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / calls
    log(f"profile {name}: wall {wall_ms:.3f} ms/call under the profiler, "
        f"device busy {busy_ms:.3f} ms/call, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f} [{card_s}]")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        log(f"  device {dev_us(e) / 1e3 / calls:9.3f} ms/call  "
            f"x{e.count / calls:g}  {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]:
        log(f"  host   {e.self_cpu_time_total / 1e3 / calls:9.3f} ms/call  "
            f"x{e.count / calls:g}  {e.key[:90]}")


def kernel_check(torch, ks, dev):
    """Each kernel against its plain version at Q=256, N=2^22."""
    rng = np.random.default_rng(7)
    n = KERNEL_CHECK_N
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    x = t(rng.uniform(-180, 180, n))
    y = t(rng.uniform(-90, 90, n))
    m = (rng.random(n) < 0.5).astype(np.float32)
    m[: 3 * ks.DATA_TILE] = 0.0  # whole tiles with no match
    maskf = t(m)
    qx = t(rng.uniform(-30, 30, Q))
    qy = t(rng.uniform(30, 60, Q))

    got, _ = ks.chord_blockmin(qx, qy, x, y, maskf)
    exp, _ = ks.chord_blockmin_plain(qx, qy, x, y, maskf)
    err_d = float((got - exp).abs().max())
    ntiles = n // ks.DATA_TILE
    ids = np.sort(rng.choice(ntiles, 96, replace=False)).astype(np.int32)
    tile_ids = torch.from_numpy(ids).to(dev)
    n_sel = torch.tensor([80], dtype=torch.int32, device=dev)
    got_s, _ = ks.chord_blockmin_sparse(qx, qy, x, y, maskf, tile_ids, n_sel)
    exp_s, _ = ks.chord_blockmin_sparse_plain(qx, qy, x, y, maskf, tile_ids, n_sel)
    err_s = float((got_s - exp_s).abs().max())
    dead = got_s[:, 80 * (ks.DATA_TILE // ks.BLK):]
    log(f"kernel check Q={Q} N={n}: dense max_abs_err={err_d:.3g}, "
        f"sparse max_abs_err={err_s:.3g}, dead slots all 1e9: "
        f"{bool((dead == ks.PENALTY).all())}")
    assert err_d <= TOL and err_s <= TOL, (err_d, err_s)
    assert bool((dead == ks.PENALTY).all()), "dead sparse slots must be exactly 1e9"
    # the dense pass sees every tile; exact 1e9 on the all-masked ones
    assert bool((got[:, : 3 * (ks.DATA_TILE // ks.BLK)] == ks.PENALTY).all())


def oracle_knn(x, y, mask, qx, qy, k):
    """f64 brute force over the masked rows: [Q, k] sorted meters."""
    from geomesa_tpu_torch.engine.geodesy import haversine_m_np

    cx, cy = x[mask], y[mask]
    out = np.empty((len(qx), k))
    for i in range(len(qx)):
        d = haversine_m_np(qx[i], qy[i], cx, cy)
        out[i] = np.sort(d[np.argpartition(d, k - 1)[:k]])
    return out


def same_neighbours(a_idx, a_d, b_idx, b_d) -> bool:
    """Identical neighbour sets per query, equal-distance swaps allowed."""
    for ia, da, ib, db in zip(a_idx, a_d, b_idx, b_d):
        if set(ia.tolist()) == set(ib.tolist()):
            continue
        if not np.array_equal(np.sort(da), np.sort(db)):
            return False
    return True


def main_path(torch, ks, dev, rows: int, card_s: str):
    from geomesa_tpu_torch import DataStore, FeatureBatch, Query, SimpleFeatureType

    rng = np.random.default_rng(42)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    qx = rng.uniform(-30, 30, Q)
    qy = rng.uniform(30, 60, Q)
    order = morton_order(torch, torch.from_numpy(x).to(dev),
                         torch.from_numpy(y).to(dev))
    x, y = x[order], y[order]
    t = rng.integers(1_590_000_000_000, 1_600_000_000_000, rows)
    speed = rng.uniform(0, 30, rows)
    cql = (f"BBOX(geom, {BBOX[0]}, {BBOX[1]}, {BBOX[2]}, {BBOX[3]}) "
           f"AND dtg > {iso(T0)} AND dtg < {iso(T1)} AND speed > 5.0")

    with tempfile.TemporaryDirectory() as tmp:
        ds = DataStore(tmp, use_device_cache=True, device=dev)
        sft = SimpleFeatureType.from_spec("gdelt", "speed:Double,dtg:Date,*geom:Point")
        src = ds.create_schema(sft)
        t0 = time.perf_counter()
        src.write(FeatureBatch.from_pydict(
            sft, {"speed": speed, "dtg": t, "geom": np.stack([x, y], 1)}))
        ingest_s = time.perf_counter() - t0
        log(f"ingest: {rows} rows in {ingest_s:.3f} s [{card_s}]")

        kernels = (ks.chord_blockmin, ks.chord_blockmin_sparse)
        for w in kernels:
            w.launches = 0
        t0 = time.perf_counter()
        count = src.get_count(cql)
        upload_s = time.perf_counter() - t0
        planner = src.planner
        sb = planner.cache.superbatch()
        resident = len(sb.batch)
        log(f"upload + first count: {upload_s:.3f} s, {resident} padded rows "
            f"resident in {len(sb.ids)} partitions [{card_s}]")

        runs = {}
        lat = {}
        for impl in ("sparse", "fullscan"):
            src.knn(cql, qx, qy, k=K, impl=impl)  # cold: calibration
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                runs[impl] = src.knn(cql, qx, qy, k=K, impl=impl)
                times.append(time.perf_counter() - t0)
            lat[impl] = statistics.median(times)
        for impl in ("sparse", "fullscan"):
            profile_calls(torch, f"knn {impl}",
                          lambda: src.knn(cql, qx, qy, k=K, impl=impl), card_s)
        key = next(k for k in planner._knn_caps if k[1] == K)
        planner._knn_caps[key] = OVERFLOW_CAP  # force the capacity to overflow
        runs["overflow"] = src.knn(cql, qx, qy, k=K, impl="sparse")
        assert key not in planner._knn_caps, "forced overflow did not fall back"
        launches = {w.__name__: w.launches for w in kernels}
        log(f"main-path launches: {launches} over 10 sparse, 10 fullscan, "
            "1 overflow knn calls and 1 count")
        assert all(launches.values()), "a kernel of the path never launched"

        # correctness against the f64 NumPy oracle
        m = ((x >= BBOX[0]) & (x <= BBOX[2]) & (y >= BBOX[1]) & (y <= BBOX[3])
             & (t > T0) & (t < T1) & (speed > 5.0))
        assert count == int(m.sum()), (count, int(m.sum()))
        exp = oracle_knn(x, y, m, qx[:16], qy[:16], K)
        for name, (d, i, _) in runs.items():
            assert d.shape == (Q, K) and np.isfinite(d).all(), name
            got = np.sort(d[:16], 1)
            assert np.all(np.abs(got - exp) <= np.maximum(1.0, 1e-4 * exp)), name
        base_d, base_i, _ = runs["sparse"]
        for name in ("fullscan", "overflow"):
            d, i, _ = runs[name]
            assert same_neighbours(base_i, base_d, i, d), f"{name} differs from sparse"
        log(f"correct: count {count} == f64 oracle; recall@{K} within the "
            "bench tolerance on 16 queries; sparse, fullscan and overflow "
            "return the same neighbour sets")
        for impl in ("sparse", "fullscan"):
            log(f"knn {impl}: warm p50 {lat[impl] * 1e3:.3f} ms per call "
                f"(Q={Q}, k={K}), {rows / lat[impl]:.1f} points/sec [{card_s}]")

        # the main path's kernel inputs, for timing at its shapes
        plan = planner.plan(Query("gdelt", cql))
        _, _, dv, mask, _ = planner._knn_mask_setup(plan, plan.query)
        cap = ks.capacity_bucket(int(ks.count_match_tiles(mask)))
        pad = lambda v: torch.nn.functional.pad(v, (0, (-len(v)) % ks.DATA_TILE))  # noqa: E731
        inputs = dict(
            qx=torch.from_numpy(qx.astype(np.float32)).to(dev),
            qy=torch.from_numpy(qy.astype(np.float32)).to(dev),
            x=pad(dv["geom__x"]), y=pad(dv["geom__y"]), maskf=pad(mask.float()),
            cap=cap)
        return launches, inputs


def kernel_rows(torch, ks, launches, inp, card_s: str):
    """Each kernel at the main path's shapes: time, plain time, error, bound."""
    qx, qy, x, y, maskf = (inp[k] for k in ("qx", "qy", "x", "y", "maskf"))
    n = x.shape[0]
    tile_ids, n_sel = ks.select_match_tiles(maskf, inp["cap"])
    live = int(n_sel[0])
    slots = tile_ids.shape[0]
    cases = [
        ("chord_blockmin", "geomesa_tpu/engine/knn_scan.py:120",
         lambda: ks.chord_blockmin(qx, qy, x, y, maskf)[0],
         lambda: ks.chord_blockmin_plain(qx, qy, x, y, maskf)[0],
         Q * n, 12 * n + 16 * Q + 4 * Q * (n // ks.BLK)),
        ("chord_blockmin_sparse", "geomesa_tpu/engine/knn_scan.py:198",
         lambda: ks.chord_blockmin_sparse(qx, qy, x, y, maskf, tile_ids, n_sel)[0],
         lambda: ks.chord_blockmin_sparse_plain(qx, qy, x, y, maskf, tile_ids, n_sel)[0],
         Q * live * ks.DATA_TILE,
         12 * live * ks.DATA_TILE + 16 * Q + 4 * slots
         + 4 * Q * slots * (ks.DATA_TILE // ks.BLK)),
    ]
    rows = []
    for name, replaces, kern, plain, keys, nbytes in cases:
        err = float((kern() - plain()).abs().max())
        assert err <= TOL, (name, err)
        ms = timed_ms(torch, kern, 10)
        plain_ms = timed_ms(torch, plain, 3)
        b, by = bound_ms(keys, nbytes)
        rows.append({
            "name": name, "route": "cuda",
            "source": "geomesa_tpu_torch/engine/kernels/chord_blockmin.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None,
        })
        log(f"{name}: N={n} Q={Q} slots={slots if 'sparse' in name else n // ks.DATA_TILE} "
            f"live_tiles={live if 'sparse' in name else n // ks.DATA_TILE}: "
            f"{ms:.3f} ms (plain {plain_ms:.3f} ms, bound {b:.3f} ms by {by}) "
            f"[{card_s}]")
    return rows


# -- density and polygon path (bench config 4) ----------------------------------

ENV = (-74.3, 40.5, -73.7, 41.0)  # the bench's config-4 envelope (NYC)
GRID = 512
D_T0, D_T1 = 1_451_606_400_000, 1_467_331_200_000  # 2016-01-01 .. 2016-07-01
P_T0, P_T1 = 1_454_284_800_000, 1_462_060_800_000  # 2016-02-01 .. 2016-05-01
# FP32 operations per point of B3 as written: 2 subtracts, 2 divides,
# 2 floors, 1 add
ZS_OPS = 7
# FP32 operations per (point, edge) pair of B4/B5 as written. Every pair
# pays the two compares of the half-open test (B4) and, in B5, the 12 of
# the near-flat term; pairs whose edge straddles the point's y also pay
# t, xc and the crossing compare (B4: 8 more; B5: 18 more, with the
# slope-inflated error).
PIP_ALL, PIP_COND = 2, 8
BAND_ALL, BAND_COND = 14, 18


def zone_polygon(seed: int = 11):
    """A seeded stand-in for a taxi-zone polygon: a smooth star-shaped
    shell of 1024 vertices and one 64-vertex hole, ~20% of the envelope.
    Returns its WKT."""
    rng = np.random.default_rng(seed)

    def ring(n, cx, cy, rx, ry, amp):
        th = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = (1 + amp * np.sin(5 * th + rng.uniform(0, 2 * np.pi))
             + 0.002 * rng.standard_normal(n))
        pts = np.stack([cx + rx * r * np.cos(th), cy + ry * r * np.sin(th)], 1)
        pts = np.concatenate([pts, pts[:1]])
        return "(" + ", ".join(f"{float(a)!r} {float(b)!r}" for a, b in pts) + ")"

    return (f"POLYGON({ring(1024, -74.0, 40.75, 0.165, 0.135, 0.25)}, "
            f"{ring(64, -73.98, 40.74, 0.03, 0.025, 0.1)})")


def cell_bound(got, exp, cnt):
    """The reference bench's per-cell bound for weighted grids (f32
    atomics in no fixed order against an f64 sum)."""
    tol = 3e-7 * np.sqrt(np.maximum(cnt, 1.0)) * np.abs(exp) + 0.5
    return bool((np.abs(np.asarray(got, np.float64) - exp) <= tol).all())


def pip_pairs(torch, py, y1, y2) -> int:
    """Pairs (point, edge) whose edge straddles the point's y (half-open):
    the pairs that need the crossing arithmetic, counted from sorted edge
    ends (an f32 count on these inputs, for the data-dependent bound)."""
    lo, _ = torch.sort(torch.minimum(y1, y2))
    hi, _ = torch.sort(torch.maximum(y1, y2))
    n = (torch.searchsorted(lo, py, right=True)
         - torch.searchsorted(hi, py, right=True))
    return int(n.sum())


def pip_inputs(torch, dev, n: int, wkt: str, seed: int):
    """n f32 points over the envelope, a quarter of them on or within a
    few ulps of the polygon's edges, and the f32 edge table."""
    from geomesa_tpu_torch.core.wkt import parse_wkt
    from geomesa_tpu_torch.engine.pip import polygon_edges

    rng = np.random.default_rng(seed)
    e64 = polygon_edges(parse_wkt(wkt))
    x = rng.uniform(ENV[0], ENV[2], n)
    y = rng.uniform(ENV[1], ENV[3], n)
    k = n // 4
    e = rng.integers(0, len(e64[0]), k)
    t = rng.choice([0.0, 0.5, 0.25], k)
    x[:k] = e64[0][e] + t * (e64[2][e] - e64[0][e]) + rng.normal(0, 1e-5, k)
    y[:k] = e64[1][e] + t * (e64[3][e] - e64[1][e]) + rng.normal(0, 1e-5, k)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    return f(x), f(y), [f(a) for a in e64]


def density_kernel_check(torch, dev, wkt: str) -> None:
    """B3 against its plain version over 2^22 Z-ordered points (512x512):
    unit weights equal, weights within the per-cell bound, cells missing
    from a dictionary add nothing; B4/B5 at N=2^22: identical booleans."""
    from geomesa_tpu_torch.engine import density_zsparse as dz
    from geomesa_tpu_torch.engine import pip_kernels as pk
    from geomesa_tpu_torch.engine.pip import BAND_EPS

    rng = np.random.default_rng(5)
    n = KERNEL_CHECK_N
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    xd = t(rng.uniform(ENV[0], ENV[2], n).astype(np.float32))
    yd = t(rng.uniform(ENV[1], ENV[3], n).astype(np.float32))
    order = morton_order(torch, xd.double(), yd.double())
    x, y = xd[t(order)].contiguous(), yd[t(order)].contiguous()
    mask = t(rng.random(n) < 0.7)
    w = t(rng.uniform(0, 5, n).astype(np.float32))
    calib = dz.calibrate_density(x, y, mask, ENV, GRID, GRID)
    ids = torch.from_numpy(calib.tile_ids).to(dev)
    ones = mask.float()
    lw = torch.where(mask, w, torch.zeros_like(w))
    cnt = dz.zsparse_counts(x, y, ones, ids, calib.dicts, ENV, GRID, GRID)
    cnt_p = dz.zsparse_counts_plain(x, y, ones, ids, calib.dicts, ENV, GRID, GRID)
    wt = dz.zsparse_counts(x, y, lw, ids, calib.dicts, ENV, GRID, GRID)
    wt_p = dz.zsparse_counts_plain(x, y, lw, ids, calib.dicts, ENV, GRID, GRID)
    d = calib.dicts
    big = torch.full_like(d, np.iinfo(np.int32).max)
    thin = torch.sort(torch.where(
        (torch.arange(d.shape[1], device=dev) % 2 == 0) & (d >= 0), d, big),
        dim=1).values
    thin = torch.where(thin == big, torch.full_like(thin, -1), thin).contiguous()
    miss = dz.zsparse_counts(x, y, ones, ids, thin, ENV, GRID, GRID)
    miss_p = dz.zsparse_counts_plain(x, y, ones, ids, thin, ENV, GRID, GRID)
    ok_w = cell_bound(wt.cpu().numpy(), wt_p.double().cpu().numpy(),
                      cnt.cpu().numpy())
    log(f"kernel check B3 N={n} tiles={len(calib.tile_ids)} capd={calib.capd}: "
        f"counts equal {bool(torch.equal(cnt, cnt_p))}, weighted max_abs_err "
        f"{float((wt - wt_p).abs().max()):.3g} within bound {ok_w}, "
        f"dictionary misses equal {bool(torch.equal(miss, miss_p))} "
        f"(mass {float(miss.sum()):.0f} of {float(cnt.sum()):.0f})")
    assert len(calib.tile_ids) > 0 and torch.equal(cnt, cnt_p)
    assert ok_w and torch.equal(miss, miss_p)
    assert float(miss.sum()) < float(cnt.sum()) and bool((miss[thin < 0] == 0).all())

    n = PIP_CHECK_N
    px, py, e = pip_inputs(torch, dev, n, wkt, seed=6)
    inside = pk.pip_crossing(px, py, *e)
    band = pk.pip_band(px, py, *e, eps=BAND_EPS)
    same_c = bool(torch.equal(inside, pk.pip_crossing_plain(px, py, *e)))
    same_b = bool(torch.equal(band, pk.pip_band_plain(px, py, *e, BAND_EPS)))
    log(f"kernel check B4/B5 N={n} E={e[0].shape[0]}: crossings identical "
        f"{same_c} ({int(inside.sum())} inside), band flags identical {same_b} "
        f"({int(band.sum())} flagged)")
    assert same_c and same_b and 0 < int(inside.sum()) < n and int(band.sum()) > 0


def f64_polygon_count(torch, dev, x, y, wkt: str, chunk: int = 1 << 15) -> int:
    """Exact f64 crossing-number count on the card (the oracle): points
    outside the polygon's envelope cross no edge or an even number."""
    from geomesa_tpu_torch.core.wkt import parse_wkt
    from geomesa_tpu_torch.engine.pip import polygon_edges

    e = [torch.from_numpy(a).to(dev)[None, :] for a in polygon_edges(parse_wkt(wkt))]
    x1, y1, x2, y2 = e
    xt = torch.from_numpy(x).to(dev)
    yt = torch.from_numpy(y).to(dev)
    keep = ((xt >= x1.min()) & (xt <= x1.max()) & (yt >= y1.min()) & (yt <= y1.max()))
    xt, yt = xt[keep], yt[keep]
    den = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, xt.shape[0], chunk):
        px = xt[s:s + chunk, None]
        py = yt[s:s + chunk, None]
        cond = (y1 <= py) != (y2 <= py)
        xc = x1 + (py - y1) / den * (x2 - x1)
        total += ((cond & (xc > px)).sum(1) % 2).sum()
    return int(total)


def density_path(torch, dev, rows: int, card_s: str, wkt: str):
    """The density and polygon path at full size (module docstring, 5)."""
    from geomesa_tpu_torch import DataStore, FeatureBatch, Query, QueryHints, SimpleFeatureType
    from geomesa_tpu_torch.engine import density_zsparse as dz
    from geomesa_tpu_torch.engine import pip_kernels as pk
    from geomesa_tpu_torch.engine.density import density_grid, grid_consts
    from geomesa_tpu_torch.process import DensityProcess
    from geomesa_tpu_torch.store.partition import DateTimeScheme

    rng = np.random.default_rng(11)
    x = rng.uniform(ENV[0], ENV[2], rows)
    y = rng.uniform(ENV[1], ENV[3], rows)
    fare = rng.uniform(0, 5, rows)
    t = rng.integers(D_T0, D_T1, rows)
    order = morton_order(torch, torch.from_numpy(x).to(dev),
                         torch.from_numpy(y).to(dev))
    x, y, fare, t = x[order], y[order], fare[order], t[order]
    iv6 = f"dtg > {iso(D_T0 - 3600_000)} AND dtg < {iso(D_T1)}"
    iv3 = f"dtg > {iso(P_T0)} AND dtg < {iso(P_T1)}"
    cql6 = f"BBOX(geom, {ENV[0]}, {ENV[1]}, {ENV[2]}, {ENV[3]}) AND {iv6}"
    cqlp = f"INTERSECTS(geom, {wkt}) AND {iv3}"

    def dq(cql, weight=None, zsparse=None):
        return Query("taxi", cql, hints=QueryHints(
            density_bbox=ENV, density_width=GRID, density_height=GRID,
            density_weight=weight, density_zsparse=zsparse))

    with tempfile.TemporaryDirectory() as tmp:
        ds = DataStore(tmp, use_device_cache=True, device=dev)
        sft = SimpleFeatureType.from_spec("taxi", "fare:Double,dtg:Date,*geom:Point")
        src = ds.create_schema(sft, DateTimeScheme("yyyy/MM", "dtg"))
        t0 = time.perf_counter()
        src.write(FeatureBatch.from_pydict(
            sft, {"fare": fare, "dtg": t, "geom": np.stack([x, y], 1)}))
        log(f"ingest: {rows} rows in {time.perf_counter() - t0:.3f} s [{card_s}]")

        kernels = (dz.zsparse_counts, pk.pip_crossing, pk.pip_band)
        for w in kernels:
            w.launches = 0
        calls = {
            "density unweighted": lambda: src.get_features(dq(cql6)),
            "density fare": lambda: src.get_features(dq(cql6, "fare")),
            "density scatter": lambda: src.get_features(dq(cql6, zsparse=False)),
            "polygon count": lambda: src.get_count(cqlp),
            "polygon density": lambda: src.get_features(dq(cqlp)),
            "DensityProcess r=2": lambda: DensityProcess().execute(
                src, ENV, GRID, GRID, cqlp, radius_pixels=2),
        }
        out, lat = {}, {}
        for name, fn in calls.items():
            t0 = time.perf_counter()
            out[name] = fn()
            cold = time.perf_counter() - t0
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                out[name] = fn()
                times.append(time.perf_counter() - t0)
            lat[name] = (cold, statistics.median(times))
            if name == "density unweighted":
                sb = src.planner.cache.superbatch()
                log(f"upload + first density: {cold:.3f} s, {len(sb.batch)} "
                    f"padded rows resident in {len(sb.ids)} partitions [{card_s}]")
        launches = {w.__name__: w.launches for w in kernels}
        log(f"density-path launches: {launches} over 6 calls of each of "
            f"{len(calls)} call types")
        assert all(launches.values()), "a kernel of the density path never launched"
        for name, (cold, warm) in lat.items():
            log(f"{name}: cold {cold * 1e3:.3f} ms, warm p50 {warm * 1e3:.3f} ms, "
                f"{rows / warm:.1f} points/sec [{card_s}]")
        profile_calls(torch, "density unweighted", calls["density unweighted"], card_s)

        # -- oracles -------------------------------------------------------
        x32, y32 = x.astype(np.float32), y.astype(np.float32)
        xmin, dx, ymin, dy = grid_consts(ENV, GRID, GRID)
        f32 = np.float32
        m6 = ((x32 >= f32(ENV[0])) & (x32 <= f32(ENV[2])) & (y32 >= f32(ENV[1]))
              & (y32 <= f32(ENV[3])) & (t > D_T0 - 3600_000) & (t < D_T1))
        col = np.floor((x32 - xmin) / dx)
        row = np.floor((y32 - ymin) / dy)
        inb = m6 & (col >= 0) & (col < GRID) & (row >= 0) & (row < GRID)
        cell = (row[inb].astype(np.int64) * GRID + col[inb].astype(np.int64))
        exp_cnt = np.bincount(cell, minlength=GRID * GRID).reshape(GRID, GRID)
        exp_w = np.bincount(cell, weights=fare[inb].astype(np.float32),
                            minlength=GRID * GRID).reshape(GRID, GRID)
        g_cnt = out["density unweighted"].grid
        assert g_cnt.shape == (GRID, GRID) and np.isfinite(g_cnt).all()
        assert np.array_equal(g_cnt, exp_cnt), "unweighted grid != NumPy binning"
        assert out["density unweighted"].count == int(m6.sum())
        assert cell_bound(out["density fare"].grid, exp_w, exp_cnt), "weighted grid"
        assert np.array_equal(out["density scatter"].grid, g_cnt), "zsparse != scatter"
        tm3 = (t > P_T0) & (t < P_T1)
        exp_poly = f64_polygon_count(torch, dev, x[tm3], y[tm3], wkt)
        assert out["polygon count"] == exp_poly, (out["polygon count"], exp_poly)
        # the cached route grids the raw f32 mask: it may differ from the
        # f64 count only by rows at the polygon's boundary
        pg = out["polygon density"]
        flips = abs(pg.count - exp_poly)
        assert float(pg.grid.sum()) == pg.count and flips <= 1e-3 * exp_poly
        blur = out["DensityProcess r=2"]
        assert blur.shape == (GRID, GRID) and np.isfinite(blur).all()
        assert abs(float(blur.sum(dtype=np.float64)) - pg.count) <= 1e-4 * pg.count

        # the exact scatter fallback inside density_zsparse: a shuffled
        # copy of the resident arrays overflows the dictionaries
        sb = src.planner.cache.superbatch()
        dv = sb.dev
        gen = torch.Generator(device=dev)
        gen.manual_seed(12)
        perm = torch.randperm(dv["geom__x"].shape[0], device=dev, generator=gen)
        xs, ys, ms = (dv["geom__x"][perm], dv["geom__y"][perm],
                      dv["__valid__"][perm])
        ones = torch.ones_like(xs)
        fb, fcal = dz.density_zsparse(xs, ys, ones, ms, ENV, GRID, GRID)
        sc = density_grid(xs, ys, ones, ms, ENV, GRID, GRID)
        assert len(fcal.dense_ids) > 0 and torch.equal(fb, sc), "fallback grid"
        log(f"correct: unweighted grid == NumPy binning cell for cell "
            f"({int(m6.sum())} points); weighted grid within the per-cell "
            f"bound; zsparse == scatter; polygon count {out['polygon count']} "
            f"== f64 crossing count; polygon density {pg.count} (raw f32 mask, "
            f"{flips} boundary rows off the f64 count); blur conserves mass; shuffled "
            f"fallback ({len(fcal.dense_ids)} of {fcal.n_tiles} tiles "
            f"overflow) == scatter")

        # the path's kernel inputs, for timing at its shapes
        planner = src.planner
        mask6 = planner.plan(Query("taxi", cql6)).compiled.mask(sb.dev, sb.batch)
        calib = dz.calibrate_density(dv["geom__x"], dv["geom__y"], mask6, ENV,
                                     GRID, GRID)
        inputs = dict(x=dv["geom__x"], y=dv["geom__y"], lw=mask6.float(),
                      calib=calib, wkt=wkt)
        return launches, inputs


def density_rows(torch, launches, inp, card_s: str):
    """B3, B4 and B5 at the density path's shapes: time, plain time,
    error, bound, and the library call where one exists."""
    from geomesa_tpu_torch.core.wkt import parse_wkt
    from geomesa_tpu_torch.engine import density_zsparse as dz
    from geomesa_tpu_torch.engine import pip_kernels as pk
    from geomesa_tpu_torch.engine.density import density_grid
    from geomesa_tpu_torch.engine.pip import BAND_EPS, polygon_edges

    x, y, lw, calib = inp["x"], inp["y"], inp["lw"], inp["calib"]
    dev = x.device
    ids = torch.from_numpy(calib.tile_ids).to(dev)
    s, capd = calib.dicts.shape
    live = lambda a: a.reshape(-1, dz.DATA_TILE)[ids.long()].reshape(-1)  # noqa: E731
    gx, gy, gw = live(x), live(y), live(lw)
    gm = gw > 0
    edges = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
             for a in polygon_edges(parse_wkt(inp["wkt"]))]
    n, e = x.shape[0], edges[0].shape[0]
    cond = pip_pairs(torch, y, edges[1], edges[3])
    src_pip = "geomesa_tpu_torch/engine/kernels/pip_crossing.cu"
    cases = [
        ("zsparse_counts", "geomesa_tpu/engine/density_zsparse.py:203",
         "geomesa_tpu_torch/engine/kernels/density_zsparse.cu",
         lambda: dz.zsparse_counts(x, y, lw, ids, calib.dicts, ENV, GRID, GRID),
         lambda: dz.zsparse_counts_plain(x, y, lw, ids, calib.dicts, ENV, GRID, GRID),
         lambda: density_grid(gx, gy, gw, gm, ENV, GRID, GRID),
         ZS_OPS * s * dz.DATA_TILE, 12 * s * dz.DATA_TILE + 8 * s * capd, 5,
         f"S={s} live tiles of {n // dz.DATA_TILE}, capd={capd}"),
        ("pip_crossing", "geomesa_tpu/engine/pip_pallas.py:70", src_pip,
         lambda: pk.pip_crossing(x, y, *edges),
         lambda: pk.pip_crossing_plain(x, y, *edges), None,
         PIP_ALL * n * e + PIP_COND * cond, 8 * n + 16 * e + n, 1,
         f"N={n} E={e}, {cond} straddling pairs of {n * e}"),
        ("pip_band", "geomesa_tpu/engine/pip_pallas.py:148", src_pip,
         lambda: pk.pip_band(x, y, *edges, eps=BAND_EPS),
         lambda: pk.pip_band_plain(x, y, *edges, BAND_EPS), None,
         BAND_ALL * n * e + BAND_COND * cond, 8 * n + 16 * e + n, 1,
         f"N={n} E={e}, {cond} straddling pairs of {n * e}"),
    ]
    rows = []
    for name, replaces, source, kern, plain, lib, ops, nbytes, preps, shape in cases:
        err = float((kern().float() - plain().float()).abs().max())
        assert err == 0.0, (name, err)  # unit weights and booleans: exact
        ms = timed_ms(torch, kern, 10)
        plain_ms = timed_ms(torch, plain, preps)
        library_ms = timed_ms(torch, lib, 5) if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        b, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms,
        })
        lib_s = (f", library {library_ms:.3f} ms (density_grid index_add_)"
                 if library_ms is not None else
                 ", library null (no PyTorch call computes a crossing count)")
        log(f"{name}: {shape}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
            f"{b:.3f} ms by {by}{lib_s}) [{card_s}]")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 26,
                    help="rows written to the store (default 2^26)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from geomesa_tpu_torch.engine import knn_scan as ks
        from geomesa_tpu_torch.engine.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1

    card_s = card()
    log(card_s)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {', '.join(n + '.cu' for n in build.sources())} in "
        f"{time.perf_counter() - t0:.2f} s (in parallel)")
    for name in build.sources():
        for line in build.build_log[name]["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    dev = torch.device("cuda")
    wkt = zone_polygon()
    kernel_check(torch, ks, dev)
    density_kernel_check(torch, dev, wkt)
    if args.rows != 1 << 26:
        log(f"both paths cut to {args.rows} rows by --rows")
    launches, inputs = main_path(torch, ks, dev, args.rows, card_s)
    rows = kernel_rows(torch, ks, launches, inputs, card_s)
    del inputs
    torch.cuda.empty_cache()
    launches, inputs = density_path(torch, dev, args.rows, card_s, wkt)
    rows += density_rows(torch, launches, inputs, card_s)
    print(json.dumps({"kernels": rows}))
    print(card_s)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
