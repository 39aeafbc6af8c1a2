#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (geomesa_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full size: 2^26 rows, 256 queries
    python3 chip_smoke.py --rows N   # a smaller store, for a quick check

Needs a CUDA card and the CUDA toolkit (nvcc); without a card it exits 1
and prints no result. Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build of every CUDA kernel from the sources in the checkout;
3. kernel check: each kernel against its plain PyTorch version on the card
   (Q=256, N=2^22, dead sparse slots exactly 1e9);
4. the main path at full size: DataStore on the card -> write -> get_count
   and knn (sparse, fullscan, forced overflow) for the north-star CQL
   (BBOX + time + attribute, bench config 3's data shape), with launch
   counts reset before and read after, checked against an f64 NumPy
   oracle (exact count, recall on 16 queries, identical neighbour sets
   across the three routes), and a torch.profiler breakdown of one warm
   call of each route;
5. each kernel timed at the main path's shapes beside its plain version
   and its bound, printed as one {"kernels": [...]} line.

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


def kernel_rows(torch, ks, launches, inp):
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
            f"{ms:.3f} ms (plain {plain_ms:.3f} ms, bound {b:.3f} ms by {by})")
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
    build.build("chord_blockmin")
    log(f"build: chord_blockmin.cu in {time.perf_counter() - t0:.2f} s")
    for line in build.build_log["chord_blockmin"]["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda")
    kernel_check(torch, ks, dev)
    if args.rows != 1 << 26:
        log(f"main path cut to {args.rows} rows by --rows")
    launches, inputs = main_path(torch, ks, dev, args.rows, card_s)
    rows = kernel_rows(torch, ks, launches, inputs)
    print(json.dumps({"kernels": rows}))
    print(card_s)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
