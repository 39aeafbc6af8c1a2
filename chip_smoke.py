#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (geomesa_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full size: 2^26 rows in the kNN and
                                     # density stores, 2^22 points in the
                                     # config-2 join and the tube engine,
                                     # 2^24 rows in the TubeSelect store
    python3 chip_smoke.py --rows N   # smaller stores (at most N config-2
                                     # points, N/4 TubeSelect rows), for
                                     # a quick check

Needs a CUDA card and the CUDA toolkit (nvcc); without a card it exits 1
and prints no result. Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build of every CUDA kernel source in the checkout, one nvcc each, all
   started together;
3. kernel check: each kernel against its plain PyTorch version on the card
   (B1/B2 at Q=256, N=2^22, B1 with 80 of 96 slots live, none, n_sel past
   the list and at Q=37, dead sparse slots exactly 1e9; B3 over 2^22
   Z-ordered points on a 512x512 grid: counts equal and weights within
   the per-cell bound on the Morton rows (more tiles than the persistent
   grid has blocks), 5 of their tiles, a copy shuffled inside each tile,
   a tile whose points share one cell, data_tile 2048, dictionaries with
   every other cell dropped (misses add nothing), and 192 NaN-coordinate
   rows binned to row or column 0 as the reference bins them (no
   matching row lost); the fold's per-slot sinks equal to the single
   sink for unit weights; B4/B5 against a
   ~1100-edge zone polygon at N=2^22 in random and Morton order and on
   the eps-boundary set, points at an edge end's y +- eps and 1-2 ulps
   either side, and against a ~9000-edge zone at N=2^18: identical
   booleans; B1/B2 again with 64 NaN rows: NaN block minima where the
   plain version has them);
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
   the scatter route, the exact fallback on a shuffled copy), and
   torch.profiler breakdowns of warm density, polygon density and
   polygon count calls;
6. the polygon-layer spatial join (bench config 2: the reference bench's
   seeded 10,000-polygon admin-style layer x 2^22 Z-ordered points, 1/64
   of them within 1e-6 degrees of an edge): a kernel check of B6-B9
   against their plain versions (200 polygons, 2^18 points, and near-flat
   edges with one NaN x-end beside points within eps of them, and B8/B9
   over each set's pairs shuffled with a tenth of them twice, also in
   two launches: identical int32 outputs), then, with launch counts
   reset before and read after,
   the host prep and a first query end to end, the warm p50 of
   pip_layer_grouped (the device pass), pip_layer, pip_layer_assign,
   pip_layer_join and pip_layer_sparse, torch.profiler breakdowns of
   warm pip_layer and pip_layer_sparse calls, and the gates: zero mismatches against an
   independent all-edges f64 oracle over 256 sampled covered tiles plus
   every adversarial point, assignment ids equal to its per-polygon
   oracle, join pairs == the points inside, pip_layer_sparse ==
   pip_layer_grouped on covered tiles;
7. the feature route (inside phases 4 and 5, on their stores): on the
   kNN store, BBOX(geom, 10, 40, 12, 42) AND the 69-day window (DURING)
   AND speed > 5.0 as features projected to speed, dtg, geom, sorted by
   dtg descending, with max_features 10,000 and without, on the cached
   route and the scan route; on the density store the zone polygon AND
   March 2016 as features, with B4/B5's launches reset before and read
   after; each cold and warm, with the mask fetch, the f64 refine and
   the select split out of one synchronised call, gated: rows equal an
   f64 NumPy evaluation (polygon: the f64 crossing oracle) of the
   written rows, the order holds, the count equals get_count;
8. TubeSelect (bench config 5): tube_select_pruned (capacity calibrated
   once) and the dense tube_select over 2^22 Morton-ordered f32 points
   against the bench's 256-sample, 20 km, 1 h track, with the dense
   chunk and the pruning tile timed at three sizes each; then
   TubeSelectProcess over a cached 2^24-row vessel:String,dtg:Date,
   *geom:Point store (one day, 10,000 vessels) with NoGapFill (cold and
   warm) and LineGapFill(10 km), its split (window_query, f64 upload,
   device pass) and a torch.profiler breakdown; gated: pruned == dense,
   and every hit set equals an f64 haversine oracle over the written
   rows but for samples at the radius +- 1 m within the window (the
   bench's rule); the passes' times and bounds print as one
   {"device_ops": [...]} line and phases 7-8's numbers as one
   {"phases": {...}} line;
9. KNearestNeighborSearchProcess (bench config 3, inside phase 4, on its
   store and arrays), with B1's and B2's launch counts reset before and
   read after: over the 2^26 rows as a materialized FeatureBatch with
   impl sparse, fullscan and auto (which resolves to sparse), over the
   store with impl auto from a 1 km estimate (the widen loop: its rounds,
   radii and the kernel the stats sketches chose, and the sketch's
   estimate of the north-star window beside its true count), over a
   2^19-row store (the window path and the f64 knn), and the engine
   routes knn, knn_mxu, knn_compact and knn_indexed at the bench's
   config-3 shape (f32, the north-star mask, Q=256, k=10; the queries
   each certificate flags; knn's data tile at 2^25 and 2^27 lanes); each
   cold once and warm p50 of 5; gated: every route within the bench rule
   of the f64 oracle on 16 queries, the batch routes' neighbour rows ==
   src.knn's, the haversine route == an f64 NumPy haversine over its
   candidates within 1e-6 m, the store route's k-th neighbours within its
   final radius and no partial recall; the ingest's stats-update seconds;
10. each kernel timed at its path's shapes beside its plain version and
   its bound, printed as one {"kernels": [...]} line; before it, B3's
   registers, the cell groups a warp meets on the path's live tiles
   (counted in torch) against the old kernel's one atomic a point, and
   B3's time on a copy shuffled inside each tile; B1/B2's
   registers and spills (one kernel) and each route without its keys
   beside its launch (the prelude's share), B4/B5's registers and
   spills, and, for the resident
   rows in Morton order (as
   written), in time order and shuffled, what their skip rule leaves per
   block and their times. B4/B5's "ms" is the Morton-order time: their
   speed depends on the rows' spatial order, which the caller gives.
   Before it too, B6-B9's registers and spills, the chunk-tests the warps
   of B6/B7/B9 (reach 2 eps) and B8 (reach 0) keep and the heaviest row's
   share, and B6 on its longest row alone; B6-B9's bound counts the tests
   within reach, their all-pairs bound stands beside it;
11. config 2 as users write it (at phase 6's width: its 10,000 polygons
   and 2^22 points): a fresh catalog on the card holds regions
   (name:String,*geom:Polygon, the polygons with their holes as rings,
   under the default XZ2 scheme) and events (val:Double,dtg:Date,
   *geom:Point, phase 6's points in one day), the WKT encode on write,
   the WKT parse on read and edge_table() timed apart; then SqlContext
   runs SELECT r.name AS region, COUNT(*) AS n FROM events e JOIN
   regions r ON st_contains(r.geom, e.geom) GROUP BY r.name ORDER BY
   region once cold and as a warm p50 of 3, with B6-B9's launch counts
   reset before and read after (B7 must launch), and two calls split
   into the store reads, the WKT parse, edge_table(), the layer prep,
   the join (B7 plus the f64 refine) and the grouped aggregate; gated:
   the per-region counts equal the bincount of phase 6's gated
   pip_layer_assign ids. On the events store, a stats query
   (Count();MinMax(dtg);Histogram(val,32,0,10);DescriptiveStats(val);
   Cardinality(val)) under the north-star BBOX and a DURING window and
   StatsProcess with the same expression, each cold and warm p50 of 5,
   gated against a NumPy evaluation of the written rows (the HLL
   registers against torch's over the matching values); and the points
   under Z2Scheme, whose north-star BBOX count must equal the date-
   partitioned store's. grouped_*, hll_registers and z3_histogram (plain
   PyTorch) are timed at the path's shapes into the {"device_ops"} line;
12. the serve stack (inside phase 4, on its store), through
   geomesa_tpu_torch.serve's QueryService on the serial route
   (max_batch 64, max_wait_ms 2, max_queue 1024 so that the 320 requests
   can queue), built after the kernels are loaded, with
   B1's, B2's and B3's launches reset before and read after: 256
   single-point kNN requests of the north-star filter (k=10, seed 0) and
   64 impl="fullscan" ones, queued and then released (exactly 4 B1
   launches, one a window of 64, and 1 B2 launch; calibration adds no B1
   launch), each gated against src.knn on its own point (neighbour
   rows, equal-distance swaps allowed, meters bit-identical); 64 identical
   counts (one dispatch, == src.count == the f64 count) and phase 7's
   feature query 8 times (one dispatch, phase 7's rows); the JSON-lines
   wire (serve_lines) with a count, an 8-point kNN, a 100-row query, a
   512x512 density over the filter's BBOX (B3 must launch; the grid ==
   a NumPy binning) and a kNN with timeoutMs 1 (must answer timeout),
   each == the direct call; then run_closed_loop with 8 clients and
   run_sustained with 64 outstanding, 5 s each, reporting served qps,
   p50/p99, windows, mean window size, B1 launches per request, the
   device's idle share (torch.profiler over 1 s more of each) and points/s
   (resident rows x served qps); serve.oom.halved, serve.oom.hosteval,
   serve.oom.failed and the services' failed counts must stay 0. Then an
   injected OOM (knn_launch raising torch.OutOfMemoryError for a window of
   8) must halve 7 times and fail all 8 with a typed DeviceOOM, with
   serve.oom.hosteval at 0. Printed as one {"serve": ...}
   line before the kernels line; B1's, B2's and B3's rows carry the phase's
   launches under "launches_by_phase".
13. the serve stack's device half (inside phase 4, on its store, after
   phase 12), with B1's and B2's launches reset before each part and
   read after: 1,024 single-point kNN requests of the north-star filter
   (k=10, seed 0: 16 windows of 64) and 64 impl="fullscan" ones, queued
   and then released through three services over the store: serial
   (pipeline=False, ring=False), pipelined (ring=False) and ring (the
   defaults); gated: the answers bit-identical across the routes
   (indices and meters), 64 of them == src.knn on their own point,
   exactly 16 B1 and 1 B2 window launches on each route (on the ring
   counted per graph replay; the arm's warm-up run and captures are
   printed apart), the ring with 2 programs armed (the sparse and the
   fullscan class, their captures over one frozen mask; the bytes the
   captures hold are printed) and no fallback. 64 counts released with a pipelined
   kNN window resolve from its mask (one dispatch, == src.count). The
   ring service records a warm-up manifest over its traffic; with the
   captures dropped, a new service built with warmup_manifest replays it
   and warmup(check=True) must report ok with no new build or capture,
   and its first window no stall (compile_ms 0). On phase 9's
   small_store shape (2^20 rows) a write moves manifest_version: the
   next ring window falls back "stale", sees the new rows and equals
   src.knn, the one after re-arms. Then run_closed_loop with 8 clients
   and run_sustained with 64 outstanding, 5 s each, on the pipelined and
   the ring route: served qps, p50/p99, windows, mean window size, B1
   launches a request, device ops a window, windows in flight at most,
   the dispatch thread's and the completer's host ms a window, the idle
   share over 1 s more (torch.profiler on the pipelined route; on the
   ring, CUDA events around each graph replay, since a replay under the
   profiler can segfault) and points/s, beside phase 12's
   serial numbers. serve.oom.* and the services' failed counts stay 0;
   an injected OOM on the pipelined route halves 7 times and fails all 8
   typed with DeviceOOM (hosteval 0). Printed as one {"serve_device":
   ...} line before the kernels line; B1's and B2's rows carry the
   phase's launches under "launches_by_phase" "13".
14. geometry predicates, non-point density and codecs, with B4's and
   B5's launches reset before each part and read after, each query cold
   once and as a warm p50 of 5: (a) inside phase 4, on its store,
   DWITHIN and BEYOND of POINT(10 45), 500 km with phase 4's window,
   DWITHIN of the config-5 track (256 samples, 20 km) and of phase 5's
   zone polygon (10 km; B4 must launch), each as get_count and
   features, gated against an f64 oracle of the written rows (haversine,
   the equirectangular segment distance, crossing parity): exact but for
   rows within max(1 m, 1e-5 d) of d, which print; (b) inside phase 11,
   on its regions store, BBOX, INTERSECTS, WITHIN and DISJOINT of a
   seeded 1,024-vertex star of radius 8-12 degrees at (10, 45),
   CONTAINS(geom, POINT(10 45)) and DWITHIN(geom, POINT(10 45), 300 km):
   the card's masks identical to the CPU path's over the regions near
   the literal and 64 others, eval_filter_host (f64) on 16 of them with
   mismatches only on regions with a vertex in the literal's f32 band
   (printed), B4 on INTERSECTS, and a torch.profiler breakdown of one
   warm INTERSECTS count; the regions' 512x512 cell-centre coverage
   through DensityProcess, equal to the CPU path and to an f64 parity
   oracle on 4,096 sampled cells (profiled); a new XZ2 line layer
   (vessel:String,sog:Double,dtg:Date,*geom:LineString: 65,536 seeded
   AIS-shaped tracks of 128 vertices), its 512x512 line density unit and
   sog-weighted, equal to the CPU path within f32 summation noise and
   totalling each track's inside fraction; (c) inside phase 8, on its
   store, a BBOX + dtg query as BIN records (with and without a label)
   and Arrow IPC (sorted by dtg and not), BinConversionProcess and
   ArrowConversionProcess, gated: decoded records == the f64-selected
   written rows, read_ipc of each payload == get_features' rows in
   order. Numbers under "geometry" in the {"phases"} line; the plain
   PyTorch operations (point_to_segments_m, edge_crossings,
   literal_vertex_parity, polygon_density, line_density, bin_pack) with
   their bounds in the {"device_ops"} line; B4's and B5's rows gain
   "14" under "launches_by_phase".
15. A4 (b), with B1-B5's launches reset before each part and read after
   (their rows gain "15" under "launches_by_phase"): (a) inside phase 4,
   on its store, a count of BBOX(geom, -60, 20, 60, 70) AND the 69-day
   window with "tolerance": 0.3 over the wire (the sketch build's
   seconds over the pruned partitions, then a fresh planner over the
   catalog answering from the sidecar with no build) and its warm p50
   beside the exact count's, gated: approx with |count - exact| <= bound;
   "topkCells": 10 with no tolerance (the exact fallback on B3 or the
   scatter route, printed), gated equal to a NumPy 64x64 world binning
   of the written rows; the columnar wire (hello ["json", "columnar"],
   phase 7's feature query as an Arrow frame == its JSON rows, a topk
   frame, a 256-query kNN as x/y sections == its JSON request on B1,
   op=ingest of a 2^20-row Arrow IPC frame into a scratch store whose
   count then sees the rows), with bytes and encode seconds; phase 7's
   features with crs 3857 (== the closed-form mercator) and the UTM zone
   of (10, 45), bit for bit the CPU transform; geomesa.force.count (the
   INCLUDE count runs on the card, == the manifest count); a second
   DataStore under geomesa.coord.dtype=float64 (its north-star count and
   sparse kNN == the f32 store's, its resident bytes printed); (b)
   inside phase 5, the 512x512 density as one columnar f64 frame ==
   the direct grid, and density_grid_slotted timed beside density_grid
   and equal to it over a tile-aligned envelope;
   (c) inside phase 8, distinct vessels with tolerance 0.1 (HLL) and
   without (exact), under INCLUDE and a filter, gated against NumPy;
   (d) after phase 11, a 2^24-row store of vis:String,speed:Double:
   visibility=admin,dtg:Date,*geom:Point with geomesa.vis.attr=vis
   (phase 4's shapes, Morton order; six expressions and null): under
   auths ("user",) and ("admin", "user") the north-star count and the
   zone-polygon count (B4/B5) f64-exact against the oracle AND the
   written truth table, sparse and fullscan kNN (Q=256, k=10) within the
   bench rule of the oracle over visible rows, speed redacted without
   admin, a stats query and a density weighted by speed (the cached
   route) refused with PermissionError, a density under auths, the
   allow table's gather timed, and one ring serving both auths classes
   of one CQL (2 programs, each window == its serial answer, the classes
   differ); then on its catalog the geomesa.scan.block.full.table guard
   (an INCLUDE count, exact or with a tolerance, answers a typed error
   on the wire, a sampled one passes) and a rewrite interceptor ANDing
   a 7-day window (count and kNN == the rewritten query's oracle,
   ring_arm refuses "interceptors", served kNN on the pipelined route ==
   direct). Numbers under "a4b" in the {"phases"} line, the new device
   operations in the {"device_ops"} line.
16. A5 (a) and (b), last in phase 4 on its store, with B1-B5's launches
   reset before and read after (B1, B2, B4 and B5 must launch; their
   rows gain "16" under "launches_by_phase"): (a) under an armed ring,
   age_off of the store's first day, delete_features of a 1-degree BBOX
   AND speed < 1.0, then a small write that gives several partitions a
   second file and compact: after each, the rows deleted == a NumPy
   oracle, the north-star count == the f64 oracle over the rows left,
   sparse (B1) and fullscan (B2) kNN give the same neighbours by
   coordinates, the next served window falls back "stale" and the one
   after re-arms, both == src.knn bit for bit; compact leaves count and
   kNN bit-identical and reports the files it removed; (b) a seeded
   FaultPlan failing device.transfer and fs.read_partition on a schedule
   over 64 kNN requests on each of the serial, pipelined and ring routes
   (a small write first, so the first window reloads residency): every
   answer == the fault-free answer, the ServeEvents' summed retries and
   fault_injected == the harness's fire log; then device.transfer
   failing every time opens the "device" breaker, the wire answers
   {"error": "unavailable", "retryAfterS": ...}, and after the reset
   time one half-open probe closes it; (c) 8 seeded GDELT 1.0 TSV files
   (57 columns, 2^15 rows each) through jobs.ingest_files with
   GDELT_CONVERTER on 8 workers (a second, resumed call skips all 8):
   count and kNN (B1) == a store written directly from the same values;
   export_partitions with a polygon filter (B4, B5 through mask_refined)
   == an f64 oracle row for row; (d) the same rows as an Arrow IPC file
   through ArrowDataStore: count and kNN == the converted store's; (e)
   geomesa.scan.batch.size at 2^18: a scan-route feature query yields
   no larger batch and the same rows; then remove_schema and a service
   close bring torch.cuda.memory_allocated() back to its level before
   the converted stores existed. Numbers in a {"lifecycle"} line.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
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
# what phases 7 and 8 measured, printed as one JSON line at the end
PHASES: dict = {}


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


def roofline_ms(ops: int, nbytes: int):
    """Least time for the work, (ms, "operations" | "bytes"): the larger of
    HBM bytes and FP32 operations over the data-sheet peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def morton_order(torch, x, y):
    """The order this script writes rows in, as the reference bench does
    (the store keeps write order): argsort of the Z2 Morton key (31 bits
    per dimension, lon/lat normalised over the WGS84 envelope), on the
    card."""
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


def profile_calls(torch, name, fn, card_s: str, calls: int = 3,
                  watch=()) -> None:
    """Where one warm call's time goes: torch.profiler over `calls` calls,
    device busy time (sum of kernel self times) against the host wall,
    the top device operations, and any other kernel whose name holds one
    of the `watch` strings. The profiler's own overhead inflates the wall
    it reports, so the latency lines above stay the metric."""
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
    ranked = sorted(events, key=dev_us, reverse=True)
    for i, e in enumerate(ranked):
        if i < 8 or any(w in e.key for w in watch):
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
    # B1 with 80 of 96 slots live, none, every slot live with n_sel past
    # the list (the overflow), and at a Q that leaves lanes empty
    sparse = []
    for live, nq in ((80, Q), (0, Q), (96 + 7, Q), (80, 37)):
        ns = torch.tensor([live], dtype=torch.int32, device=dev)
        got_s, _ = ks.chord_blockmin_sparse(qx[:nq], qy[:nq], x, y, maskf, tile_ids, ns)
        exp_s, _ = ks.chord_blockmin_sparse_plain(qx[:nq], qy[:nq], x, y, maskf,
                                                  tile_ids, ns)
        err_s = float((got_s - exp_s).abs().max())
        dead = bool((got_s[:, min(live, 96) * (ks.DATA_TILE // ks.BLK):]
                     == ks.PENALTY).all())
        sparse.append(f"n_sel={live} Q={nq} max_abs_err={err_s:.3g} dead all 1e9 {dead}")
        assert err_s <= TOL, (live, nq, err_s)
        assert dead, "dead sparse slots must be exactly 1e9"
    log(f"kernel check Q={Q} N={n}: dense max_abs_err={err_d:.3g}; sparse over "
        f"96 slots: {'; '.join(sparse)}")
    assert err_d <= TOL, err_d
    # the dense pass sees every tile; exact 1e9 on the all-masked ones
    assert bool((got[:, : 3 * (ks.DATA_TILE // ks.BLK)] == ks.PENALTY).all())
    # rows with a NaN coordinate make their blocks' minima NaN, as the
    # plain version's amin (and the reference's min) do
    xn = x.clone()
    xn[torch.from_numpy(rng.choice(n, 64, replace=False)).to(dev)] = float("nan")
    nan_pairs = ((ks.chord_blockmin(qx, qy, xn, y, maskf)[0],
                  ks.chord_blockmin_plain(qx, qy, xn, y, maskf)[0]),
                 (ks.chord_blockmin_sparse(qx, qy, xn, y, maskf, tile_ids, n_sel)[0],
                  ks.chord_blockmin_sparse_plain(qx, qy, xn, y, maskf, tile_ids, n_sel)[0]))
    for g, e in nan_pairs:
        nan = torch.isnan(e)
        assert bool(nan.any()) and torch.equal(torch.isnan(g), nan), "NaN minima"
        assert float((g[~nan] - e[~nan]).abs().max()) <= TOL
    log(f"kernel check B1/B2 with 64 NaN rows: NaN minima where the plain "
        f"version's are ({int(torch.isnan(nan_pairs[0][1]).sum())} dense, "
        f"{int(torch.isnan(nan_pairs[1][1]).sum())} sparse), the rest within {TOL}")


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
        with Spans(torch, [(src.planner, "update_stats", "stats")]) as st:
            src.write(FeatureBatch.from_pydict(
                sft, {"speed": speed, "dtg": t, "geom": np.stack([x, y], 1)}))
        ingest_s = time.perf_counter() - t0
        stats_s = st.seconds["stats"]
        log(f"ingest: {rows} rows in {ingest_s:.3f} s, of which the stats "
            f"sketches' update {stats_s:.3f} s ({ingest_s - stats_s:.3f} s "
            f"without it) [{card_s}]")

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

        PHASES["features knn store"] = feature_phase_knn(
            torch, src, tmp, dev, x, y, t, speed, card_s)
        knn_ops = knn_process_phase(
            torch, ks, dev, src, tmp, dict(x=x, y=y, t=t, speed=speed, qx=qx,
                                           qy=qy, cql=cql, mask=m, exp=exp),
            runs["sparse"], dict(ingest_s=ingest_s, stats_s=stats_s), card_s)
        serve = serve_phase(torch, ks, dev, ds, src, dict(
            x=x, y=y, t=t, speed=speed, cql=cql), card_s)
        serve_dev = serve_device_phase(torch, ks, dev, ds, src, dict(cql=cql),
                                       serve["load"], tmp, card_s)

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
        # phase 14 last: its queries without a window make every partition
        # resident, which would change the kernels' shapes above
        geometry_points_phase(torch, dev, src, dict(x=x, y=y, t=t, speed=speed),
                              card_s)
        a4b_knn_store(torch, dev, ds, src, tmp, dict(
            x=x, y=y, t=t, speed=speed, qx=qx, qy=qy, cql=cql), card_s)
        # phase 16 last: its deletes change nothing an earlier phase times
        lifecycle_phase(torch, dev, ds, src, tmp, dict(
            x=x, y=y, t=t, speed=speed, qx=qx, qy=qy, cql=cql), card_s)
        return launches, inputs, knn_ops, serve, serve_dev


def chord_lines(torch, ks, inp, tile_ids, n_sel, card_s: str) -> dict:
    """Earlier lines of B1/B2's rows: their kernel's registers and spills
    (one kernel: B1 walks a tile list), and each route's split: the
    variant that skips the keys (prelude, barriers and output only)
    beside the full launch, at the main path's shapes (B1: the live slots
    of the capacity). Returns the variants' times by kernel name."""
    from geomesa_tpu_torch.engine.kernels import build

    names = {"blockmin_kernelILb1E": "B1/B2",
             "blockmin_kernelILb0E": "B1/B2 without its keys"}
    for name, res in ptxas_resources(build.build_log["chord_blockmin"]["ptxas"]).items():
        kind = [k for n, k in names.items() if n in name]
        if kind:
            log(f"ptxas chord_blockmin.cu {kind[0]}: {res.get('registers')} "
                f"registers, spill stores/loads {res.get('spill')}")
    aug, c = ks._aug_q(inp["qx"], inp["qy"])
    x, y, maskf = inp["x"], inp["y"], inp["maskf"]
    launches = {
        "chord_blockmin": (f"B2 at N={x.shape[0]}", lambda pre: ks._launch_dense(
            aug, c, x, y, maskf, ks.BLK, prelude_only=pre)),
        "chord_blockmin_sparse": (
            f"B1 at {int(n_sel[0])} live of {tile_ids.shape[0]} slots",
            lambda pre: ks._launch_sparse(aug, c, x, y, maskf, tile_ids, n_sel,
                                          ks.BLK, ks.DATA_TILE, prelude_only=pre)),
    }
    out = {}
    for name, (what, launch) in launches.items():
        full_ms = timed_ms(torch, lambda: launch(False), 10)
        out[name] = pre_ms = timed_ms(torch, lambda: launch(True), 10)
        log(f"chord_blockmin ({what}, Q={aug.shape[0]}) split: the launch "
            f"{full_ms:.3f} ms, without its keys (prelude, barriers, output) "
            f"{pre_ms:.3f} ms, share {pre_ms / full_ms:.3f} [{card_s}]")
    return out


def kernel_rows(torch, ks, launches, inp, card_s: str):
    """Each kernel at the main path's shapes: time, plain time, error,
    bound. A key is 3 multiply-adds and a min, 7 FP32 operations
    (aug_q[q][3] == 1 adds ndm as it is)."""
    qx, qy, x, y, maskf = (inp[k] for k in ("qx", "qy", "x", "y", "maskf"))
    n = x.shape[0]
    tile_ids, n_sel = ks.select_match_tiles(maskf, inp["cap"])
    live = int(n_sel[0])
    slots = tile_ids.shape[0]
    prelude_ms = chord_lines(torch, ks, inp, tile_ids, n_sel, card_s)
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
        b, by = roofline_ms(7 * keys, nbytes)
        rows.append({
            "name": name, "route": "cuda",
            "source": "geomesa_tpu_torch/engine/kernels/chord_blockmin.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None,
        })
        rows[-1]["prelude_only_ms"] = prelude_ms[name]
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
# FP32 operations per point that B3's function needs: 2 subtracts, 2
# divides, 2 floors and 1 add (n weights sum in n - 1 adds in any order;
# the extra adds of the kernel's segmented scan are its own choice, not
# the work). The bound is by bytes either way.
ZS_OPS = 7
# FP32 operations per (point, edge) pair of B4/B5 as written. Every pair
# pays the two compares of the half-open test (B4) and, in B5, the 12 of
# the near-flat term; pairs whose edge straddles the point's y also pay
# t, xc and the crossing compare (B4: 8 more; B5: 18 more, with the
# slope-inflated error). The dense algorithm tests every pair; what the
# data needs is the straddling pairs (B4) and the pairs within eps of an
# edge's y-span (B5), whose bound density_rows reports.
PIP_ALL, PIP_COND = 2, 8
BAND_ALL, BAND_COND = 14, 18


def zone_polygon(seed: int = 11, shell: int = 1024):
    """A seeded stand-in for a taxi-zone polygon: a smooth star-shaped
    shell of `shell` vertices and one 64-vertex hole, ~20% of the
    envelope. Returns its WKT."""
    rng = np.random.default_rng(seed)

    def ring(n, cx, cy, rx, ry, amp):
        th = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = (1 + amp * np.sin(5 * th + rng.uniform(0, 2 * np.pi))
             + 0.002 * rng.standard_normal(n))
        pts = np.stack([cx + rx * r * np.cos(th), cy + ry * r * np.sin(th)], 1)
        pts = np.concatenate([pts, pts[:1]])
        return "(" + ", ".join(f"{float(a)!r} {float(b)!r}" for a, b in pts) + ")"

    return (f"POLYGON({ring(shell, -74.0, 40.75, 0.165, 0.135, 0.25)}, "
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


def reach_pairs(torch, py, y1, y2, eps: float, step: int = 1 << 24) -> int:
    """Pairs (point, edge) whose edge's y-span meets [py - eps, py + eps]:
    the pairs that can band-flag a point (B5's data-dependent work),
    counted in f64 from sorted edge ends."""
    lo, _ = torch.sort(torch.minimum(y1, y2).double())
    hi, _ = torch.sort(torch.maximum(y1, y2).double())
    total = 0
    for s in range(0, py.shape[0], step):
        q = py[s:s + step].double()
        total += int((torch.searchsorted(lo, q + eps, right=True)
                      - torch.searchsorted(hi, q - eps)).sum())
    return total


def ptxas_resources(log_text: str) -> dict:
    """{entry kernel (mangled): {"registers": r, "spill": (stores, loads)}}
    from an `nvcc -Xptxas -v` report."""
    import re

    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([^'\s]+)", line)
        if m:
            cur = m.group(1)
            continue
        r = re.search(r"Used (\d+) registers", line)
        if cur and r:
            out.setdefault(cur, {})["registers"] = int(r.group(1))
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if cur and s:
            out.setdefault(cur, {})["spill"] = (int(s.group(1)), int(s.group(2)))
    return out


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


def eps_boundary_points(torch, edges, eps: float, seed: int = 8):
    """f32 points whose y is exactly an edge end +- eps (in f32) or 1-2 f32
    ulps either side of it, x across the edge's eps-inflated x-span and on
    its f32 lower bound, for every edge, sorted by y (the boundary of B5's
    near-flat term and of the kernels' 2 eps skip margin)."""
    x1, y1, x2, y2 = (a.cpu().numpy() for a in edges)
    rng = np.random.default_rng(seed)
    e32 = np.float32(eps)
    xlo = np.tile(np.minimum(x1, x2) - e32, 4)
    xhi = np.tile(np.maximum(x1, x2) + e32, 4)
    ends = np.concatenate([y1, y2])
    base = np.concatenate([ends + e32, ends - e32])  # f32 arithmetic
    xs, ys = [], []
    for u in (-2, -1, 0, 1, 2):
        v = base
        for _ in range(abs(u)):
            v = np.nextafter(v, np.float32(np.inf if u > 0 else -np.inf))
        xs += [rng.uniform(xlo - e32, xhi + e32).astype(np.float32), xlo]
        ys += [v, v]
    x, y = np.concatenate(xs), np.concatenate(ys)
    o = np.argsort(y, kind="stable")
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(edges[0].device)  # noqa: E731
    return f(x[o]), f(y[o])


def within_tile_perm(torch, n: int, data_tile: int, seed: int, dev):
    """A permutation of n rows that shuffles each data tile's rows among
    themselves: every tile keeps its set of cells (its dictionary stays
    valid), but a warp's 32 points fall into as many cells as they can."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    keys = torch.rand((n // data_tile, data_tile), device=dev, generator=gen)
    perm = torch.argsort(keys, dim=1)
    perm += torch.arange(0, n, data_tile, device=dev)[:, None]
    return perm.reshape(-1)


def zsparse_case(torch, dz, name, x, y, mask, w, ids, dicts,
                 data_tile: int = 4096):
    """B3 against its plain version on one input: unit weights equal,
    weights within the per-cell bound. Returns the counts."""
    ones = mask.float()
    lw = torch.where(mask, w, torch.zeros_like(w))
    args = (ENV, GRID, GRID, data_tile)
    cnt = dz.zsparse_counts(x, y, ones, ids, dicts, *args)
    cnt_p = dz.zsparse_counts_plain(x, y, ones, ids, dicts, *args)
    wt = dz.zsparse_counts(x, y, lw, ids, dicts, *args)
    wt_p = dz.zsparse_counts_plain(x, y, lw, ids, dicts, *args)
    same = bool(torch.equal(cnt, cnt_p))
    ok_w = cell_bound(wt.cpu().numpy(), wt_p.double().cpu().numpy(),
                      cnt.cpu().numpy())
    log(f"kernel check B3 {name}: S={ids.shape[0]} capd={dicts.shape[1]} "
        f"data_tile={data_tile}: counts equal {same}, weighted max_abs_err "
        f"{float((wt - wt_p).abs().max()):.3g} within bound {ok_w}")
    assert same and ok_w, name
    return cnt


def density_kernel_check(torch, dev, wkt: str) -> None:
    """B3 against its plain version over 2^22 Z-ordered points (512x512):
    unit weights equal and weights within the per-cell bound on the
    Morton rows, a within-tile shuffled copy, a tile of one cell,
    data_tile 2048, S below and above the persistent grid, dictionary
    misses and NaN coordinates; the fold against the single-sink formula;
    B4/B5 at N=2^22 in random and Morton order and on the eps-boundary
    set: identical booleans."""
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
    blocks = dz.grid_blocks(calib.capd)
    assert 5 < blocks < len(calib.tile_ids), (blocks, len(calib.tile_ids))
    log(f"kernel check B3: persistent grid {blocks} blocks at capd={calib.capd}")
    cnt = zsparse_case(torch, dz, "Morton (S above the grid)", x, y, mask, w,
                       ids, calib.dicts)
    zsparse_case(torch, dz, "Morton, S=5 (below the grid)", x, y, mask, w,
                 ids[:5].contiguous(), calib.dicts[:5].contiguous())
    perm = within_tile_perm(torch, n, dz.DATA_TILE, 21, dev)
    shuf = zsparse_case(torch, dz, "within-tile shuffled", x[perm], y[perm],
                        mask[perm], w[perm], ids, calib.dicts)
    assert torch.equal(shuf, cnt), "shuffled counts != Morton counts"
    # one tile's 4096 points all in the centre of one cell
    x1, y1 = x.clone(), y.clone()
    t0 = int(calib.tile_ids[len(calib.tile_ids) // 2])
    rows = slice(t0 * dz.DATA_TILE, (t0 + 1) * dz.DATA_TILE)
    x1[rows] = ENV[0] + 100.5 * (ENV[2] - ENV[0]) / GRID
    y1[rows] = ENV[1] + 200.5 * (ENV[3] - ENV[1]) / GRID
    calib1 = dz.calibrate_density(x1, y1, mask, ENV, GRID, GRID)
    ids1 = torch.from_numpy(calib1.tile_ids).to(dev)
    one = zsparse_case(torch, dz, "a tile of one cell", x1, y1, mask, w, ids1,
                       calib1.dicts)
    at = int(np.nonzero(calib1.tile_ids == t0)[0][0])
    assert int((calib1.dicts[at] >= 0).sum()) == 1
    assert float(one[at, 0]) == float(mask[rows].sum())
    calib2 = dz.calibrate_density(x, y, mask, ENV, GRID, GRID, data_tile=2048)
    zsparse_case(torch, dz, "data_tile 2048", x, y, mask, w,
                 torch.from_numpy(calib2.tile_ids).to(dev), calib2.dicts, 2048)
    d = calib.dicts
    big = torch.full_like(d, np.iinfo(np.int32).max)
    thin = torch.sort(torch.where(
        (torch.arange(d.shape[1], device=dev) % 2 == 0) & (d >= 0), d, big),
        dim=1).values
    thin = torch.where(thin == big, torch.full_like(thin, -1), thin).contiguous()
    miss = zsparse_case(torch, dz, "dictionary misses", x, y, mask, w, ids, thin)
    log(f"kernel check B3 dictionary misses: mass {float(miss.sum()):.0f} of "
        f"{float(cnt.sum()):.0f}")
    assert float(miss.sum()) < float(cnt.sum()) and bool((miss[thin < 0] == 0).all())
    # the fold's per-slot sinks against the reference's single sink
    cells = GRID * GRID
    sink = torch.where(d < 0, torch.full_like(d, cells), d)
    single = torch.zeros(cells + 1, device=dev).index_add_(
        0, sink.reshape(-1), cnt.reshape(-1))[:cells].reshape(GRID, GRID)
    folded = dz._fold_counts(cnt, d, GRID, GRID)
    log(f"kernel check fold: per-slot sinks == single sink "
        f"{bool(torch.equal(folded, single))} (unit weights)")
    assert torch.equal(folded, single)
    # rows with a NaN coordinate bin to index 0 (row 0 or column 0), as
    # the reference's int32 cast makes them
    ones = mask.float()
    xn, yn = x.clone(), y.clone()
    at = t(rng.choice(n, 192, replace=False))
    xn[at[:64]] = float("nan")
    yn[at[64:128]] = float("nan")
    xn[at[128:]] = yn[at[128:]] = float("nan")
    calib_n = dz.calibrate_density(xn, yn, mask, ENV, GRID, GRID)
    ids_n = torch.from_numpy(calib_n.tile_ids).to(dev)
    zsparse_case(torch, dz, "192 NaN-coordinate rows", xn, yn, mask, w, ids_n,
                 calib_n.dicts)
    grid_n, _ = dz.density_zsparse(xn, yn, ones, mask, ENV, GRID, GRID)
    mass_n = float(dz._expected_mass(xn, yn, ones, mask, ENV, GRID, GRID))
    nan_in = int((mask[at] & (torch.isnan(xn[at]) | torch.isnan(yn[at]))).sum())
    log(f"kernel check B3 with 192 NaN-coordinate rows ({nan_in} of them "
        f"matching): grid mass {float(grid_n.sum()):.0f} == expected "
        f"{mass_n:.0f} (masked rows, NaN ones binned to row or column 0)")
    # a NaN coordinate replaces one that may have been out of bounds by an
    # in-bounds index, so no matching row drops out (dropping them would
    # lose ~nan_in rows)
    assert float(grid_n.sum()) == mass_n
    assert nan_in > 0 and mass_n >= float(dz._expected_mass(x, y, ones, mask, ENV,
                                                            GRID, GRID))

    n = PIP_CHECK_N
    px, py, e = pip_inputs(torch, dev, n, wkt, seed=6)
    zo = t(morton_order(torch, px.double(), py.double()))
    # a 9,000-vertex zone: more edges than one block tests in one group
    big = pip_inputs(torch, dev, 1 << 18, zone_polygon(seed=12, shell=9000), seed=7)
    zb = t(morton_order(torch, big[0].double(), big[1].double()))
    sets = {"random": (px, py, e),
            "Morton": (px[zo].contiguous(), py[zo].contiguous(), e),
            "eps-boundary": (*eps_boundary_points(torch, e, BAND_EPS), e),
            "Morton, 9k-edge zone": (big[0][zb].contiguous(), big[1][zb].contiguous(),
                               big[2])}
    for name, (qx, qy, e) in sets.items():
        inside = pk.pip_crossing(qx, qy, *e)
        band = pk.pip_band(qx, qy, *e, eps=BAND_EPS)
        same_c = bool(torch.equal(inside, pk.pip_crossing_plain(qx, qy, *e)))
        same_b = bool(torch.equal(band, pk.pip_band_plain(qx, qy, *e, BAND_EPS)))
        log(f"kernel check B4/B5 {name} N={qx.shape[0]} E={e[0].shape[0]}: "
            f"crossings identical {same_c} ({int(inside.sum())} inside), band "
            f"flags identical {same_b} ({int(band.sum())} flagged)")
        assert same_c and same_b and int(band.sum()) > 0, name
        assert 0 < int(inside.sum()) < qx.shape[0], name


def f64_polygon_count(torch, dev, x, y, wkt: str) -> int:
    """Exact f64 crossing-number count on the card (the oracle)."""
    return int(f64_polygon_mask(torch, dev, x, y, wkt).sum())


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
        # B3 and the fold's scatter (index_add_) by name, wherever they rank
        watch = ("zsparse_kernel", "indexFunc")
        profile_calls(torch, "density unweighted", calls["density unweighted"], card_s,
                      watch=watch)
        profile_calls(torch, "polygon density", calls["polygon density"], card_s,
                      watch=watch)
        profile_calls(torch, "polygon count", calls["polygon count"], card_s, calls=1)

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

        PHASES["features density store"] = feature_phase_density(
            torch, src, dev, x, y, t, fare, wkt, card_s)
        a4b_density_store(torch, dev, ds, src, cql6, dq, card_s)

        # the path's kernel inputs, for timing at its shapes
        planner = src.planner
        mask6 = planner.plan(Query("taxi", cql6)).compiled.mask(sb.dev, sb.batch)
        calib = dz.calibrate_density(dv["geom__x"], dv["geom__y"], mask6, ENV,
                                     GRID, GRID)
        inputs = dict(x=dv["geom__x"], y=dv["geom__y"], lw=mask6.float(),
                      fare=torch.where(mask6, dv["fare"].float(),
                                       torch.zeros_like(dv["geom__x"])),
                      calib=calib, wkt=wkt, dtg=dv["dtg"], valid=dv["__valid__"])
        return launches, inputs


def pip_skip_lines(torch, pk, x, y, dtg, valid, edges, eps, card_s: str):
    """Earlier lines of B4/B5's rows: the kernels' registers and spills,
    and for the resident rows in three orders what the skip rule leaves
    per block (counted in torch from the data) and both kernels' times.
    The orders: Morton (the path's own: chip_smoke sorts before it
    writes, and the store keeps write order within a partition); time
    order, pad rows last (what a store holds when events are written as
    they arrive); shuffled. The other orders' outputs must be the Morton
    ones, permuted. Returns {order: {kernel: ms}} for the other two."""
    from geomesa_tpu_torch.engine.kernels import build

    for name, res in ptxas_resources(build.build_log["pip_crossing"]["ptxas"]).items():
        if "pip_kernel" in name:
            kind = "B4" if "ILb0E" in name else "B5"
            log(f"ptxas pip_crossing.cu {kind}: {res.get('registers')} registers, "
                f"spill stores/loads {res.get('spill')}")
    gen = torch.Generator(device=x.device)
    gen.manual_seed(13)
    last = torch.iinfo(torch.int64).max
    orders = {
        "time-ordered": torch.sort(torch.where(valid, dtg, last), stable=True)[1],
        "shuffled": torch.randperm(x.shape[0], device=x.device, generator=gen),
    }
    for order, perm in [("Morton", None), *orders.items()]:
        qy = y if perm is None else y[perm]
        for kind, rule in (("B4", None), ("B5", eps)):
            by_chunk, by_edge = pk.kept_edges(qy, edges[1], edges[3], rule)
            log(f"{kind} skip rule over {by_chunk.shape[0]} blocks of "
                f"{pk.BLOCK_POINTS} {order} rows, chunks of {pk.CHUNK} of "
                f"{edges[0].shape[0]} edges: {float(by_chunk.double().mean()):.3f} "
                f"edges of kept chunks and {float(by_edge.double().mean()):.3f} "
                f"staged edges a block; {float((by_chunk == 0).double().mean()):.4f} "
                f"of blocks keep no chunk, {float((by_edge == 0).double().mean()):.4f} "
                f"stage no edge")
    times = {}
    for order, perm in orders.items():
        xs, ys = x[perm].contiguous(), y[perm].contiguous()
        calls = {"pip_crossing": (lambda: pk.pip_crossing(x, y, *edges),
                                  lambda: pk.pip_crossing(xs, ys, *edges)),
                 "pip_band": (lambda: pk.pip_band(x, y, *edges, eps=eps),
                              lambda: pk.pip_band(xs, ys, *edges, eps=eps))}
        times[order] = {}
        for name, (morton, other) in calls.items():
            assert torch.equal(other(), morton()[perm]), f"{name} {order}"
            times[order][name] = ms = timed_ms(torch, other, 10)
            log(f"{name} on a {order} copy of the N={x.shape[0]} rows: {ms:.3f} ms, "
                f"outputs == the Morton-order outputs permuted [{card_s}]")
    return times


def warp_groups(torch, dz, x, y, lw, ids) -> dict:
    """What B3's warps meet on the selected tiles, counted in torch: per
    32 consecutive points, the cell groups (one search and one atomic
    each), the runs of equal keys, and the points in bounds with a
    nonzero weight (the old kernel's one search and atomic a point). A
    lane out of bounds or of weight 0 takes the kernel's sentinel key."""
    from geomesa_tpu_torch.engine.density import bin_cells

    live = lambda a: a.reshape(-1, dz.DATA_TILE)[ids.long()].reshape(-1, 32)  # noqa: E731
    cells, ok = bin_cells(live(x), live(y), True, ENV, GRID, GRID)
    w = live(lw)
    key = torch.where(ok & (w != 0), cells, torch.full_like(cells, -2))
    srt = torch.sort(key, dim=1).values
    groups = 1 + (srt[:, 1:] != srt[:, :-1]).sum(1) - (srt[:, 0] < 0).long()
    runs = 1 + (key[:, 1:] != key[:, :-1]).sum(1)
    points = (key >= 0).sum(1)
    q = lambda v: float(torch.quantile(v.double()[:1 << 24], 0.99))  # noqa: E731
    return {"groups": float(groups.double().mean()), "groups_p99": q(groups),
            "runs": float(runs.double().mean()),
            "points": float(points.double().mean()), "warps": key.shape[0]}


def zsparse_lines(torch, dz, x, y, lw, fare, ids, dicts, card_s: str) -> dict:
    """Earlier lines of B3's row: its registers and spills, the cell
    groups per warp of the path's live tiles in Morton order and on a
    within-tile shuffled copy, B3's time on that copy (its counts must
    equal the Morton ones) and with the path's fare weights (the weighted
    grid's call, within the per-cell bound of the plain version). Returns
    those times."""
    from geomesa_tpu_torch.engine.kernels import build

    for name, res in ptxas_resources(build.build_log["density_zsparse"]["ptxas"]).items():
        if "zsparse_kernel" in name:
            log(f"ptxas density_zsparse.cu B3: {res.get('registers')} registers, "
                f"spill stores/loads {res.get('spill')}; persistent grid "
                f"{dz.grid_blocks(dicts.shape[1])} blocks at capd={dicts.shape[1]}")
    perm = within_tile_perm(torch, x.shape[0], dz.DATA_TILE, 23, x.device)
    xs, ys, ws = x[perm], y[perm], lw[perm]
    for order, (a, b, c) in (("Morton", (x, y, lw)), ("within-tile shuffled", (xs, ys, ws))):
        g = warp_groups(torch, dz, a, b, c, ids)
        log(f"B3 warps over {g['warps']} steps of 32 {order} points: "
            f"{g['groups']:.3f} cell groups a warp (p99 {g['groups_p99']:.0f}; one "
            f"lookup and one atomic each), {g['runs']:.3f} runs, against "
            f"{g['points']:.3f} in-bounds weighted points (the old kernel's one "
            f"search and atomic a point)")
    kern = lambda: dz.zsparse_counts(x, y, lw, ids, dicts, ENV, GRID, GRID)  # noqa: E731
    shuf = lambda: dz.zsparse_counts(xs, ys, ws, ids, dicts, ENV, GRID, GRID)  # noqa: E731
    fared = lambda: dz.zsparse_counts(x, y, fare, ids, dicts, ENV, GRID, GRID)  # noqa: E731
    assert torch.equal(shuf(), kern()), "B3 within-tile shuffled != Morton"
    plain_w = dz.zsparse_counts_plain(x, y, fare, ids, dicts, ENV, GRID, GRID)
    assert cell_bound(fared().cpu().numpy(), plain_w.double().cpu().numpy(),
                      kern().cpu().numpy()), "B3 weighted"
    out = {"within_tile_shuffled_ms": timed_ms(torch, shuf, 10),
           "weighted_ms": timed_ms(torch, fared, 10)}
    log(f"zsparse_counts on a within-tile shuffled copy: "
        f"{out['within_tile_shuffled_ms']:.3f} ms, counts == the Morton counts; "
        f"with the fare weights: {out['weighted_ms']:.3f} ms, within the per-cell "
        f"bound [{card_s}]")
    return out


def density_rows(torch, launches, inp, card_s: str):
    """B3, B4 and B5 at the density path's shapes: time, plain time,
    error, bound, and the library call where one exists. B4/B5's bound
    counts the pairs that this run's data needs (straddling pairs, pairs
    within eps of an edge's y-span) and the all-pairs bound of the dense
    algorithm stands beside it."""
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
    reach = reach_pairs(torch, y, edges[1], edges[3], BAND_EPS)
    other = pip_skip_lines(torch, pk, x, y, inp["dtg"], inp["valid"], edges,
                           BAND_EPS, card_s)
    zs_more = zsparse_lines(torch, dz, x, y, lw, inp["fare"], ids, calib.dicts,
                            card_s)
    src_pip = "geomesa_tpu_torch/engine/kernels/pip_crossing.cu"
    pip_bytes = 8 * n + 16 * e + n
    # (name, replaces, source, kernel, plain, library call, operations,
    #  bytes, all-pairs operations, plain reps, shape)
    cases = [
        ("zsparse_counts", "geomesa_tpu/engine/density_zsparse.py:203",
         "geomesa_tpu_torch/engine/kernels/density_zsparse.cu",
         lambda: dz.zsparse_counts(x, y, lw, ids, calib.dicts, ENV, GRID, GRID),
         lambda: dz.zsparse_counts_plain(x, y, lw, ids, calib.dicts, ENV, GRID, GRID),
         lambda: density_grid(gx, gy, gw, gm, ENV, GRID, GRID),
         ZS_OPS * s * dz.DATA_TILE, 12 * s * dz.DATA_TILE + 8 * s * capd, None, 5,
         f"S={s} live tiles of {n // dz.DATA_TILE}, capd={capd}"),
        ("pip_crossing", "geomesa_tpu/engine/pip_pallas.py:70", src_pip,
         lambda: pk.pip_crossing(x, y, *edges),
         lambda: pk.pip_crossing_plain(x, y, *edges), None,
         PIP_COND * cond, pip_bytes, PIP_ALL * n * e + PIP_COND * cond, 1,
         f"N={n} E={e}, {cond} straddling pairs of {n * e}"),
        ("pip_band", "geomesa_tpu/engine/pip_pallas.py:148", src_pip,
         lambda: pk.pip_band(x, y, *edges, eps=BAND_EPS),
         lambda: pk.pip_band_plain(x, y, *edges, BAND_EPS), None,
         (BAND_ALL + BAND_COND) * reach, pip_bytes,
         BAND_ALL * n * e + BAND_COND * cond, 1,
         f"N={n} E={e}, {reach} pairs within eps of an edge's y-span "
         f"({cond} straddling) of {n * e}"),
    ]

    rows = []
    for name, replaces, source, kern, plain, lib, ops, nbytes, ops_all, preps, shape in cases:
        err = float((kern().float() - plain().float()).abs().max())
        assert err == 0.0, (name, err)  # unit weights and booleans: exact
        ms = timed_ms(torch, kern, 10)
        plain_ms = timed_ms(torch, plain, preps)
        library_ms = timed_ms(torch, lib, 5) if lib is not None else None
        b, by = roofline_ms(ops, nbytes)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms,
        })
        lib_s = (f", library {library_ms:.3f} ms (density_grid index_add_)"
                 if library_ms is not None else
                 ", library null (no PyTorch call computes a crossing count)")
        extra = ""
        if name == "zsparse_counts":
            rows[-1].update(zs_more)
            extra = (f"; within-tile shuffled {zs_more['within_tile_shuffled_ms']:.3f} "
                     f"ms, fare-weighted {zs_more['weighted_ms']:.3f} ms")
        if ops_all is not None:
            b_all, by_all = roofline_ms(ops_all, nbytes)
            rows[-1]["bound_all_pairs_ms"] = b_all
            rows[-1]["time_ordered_ms"] = other["time-ordered"][name]
            rows[-1]["shuffled_ms"] = other["shuffled"][name]
            extra = (f"; all-pairs bound {b_all:.3f} ms by {by_all}; Morton-ordered "
                     f"rows {ms:.3f} ms, time-ordered {other['time-ordered'][name]:.3f} "
                     f"ms, shuffled {other['shuffled'][name]:.3f} ms")
        log(f"{name}: {shape}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
            f"{b:.3f} ms by {by}{lib_s}{extra}) [{card_s}]")
    return rows


# -- polygon-layer spatial join (bench config 2) ------------------------------

LAYER_POLYS = 10_000  # the bench's config-2 layer
LAYER_POINTS = 1 << 22  # the bench's config-2 default
LAYER_CHECK_POLYS = 200
LAYER_CHECK_N = 1 << 18
LAYER_SAMPLE_TILES = 256
LAYER_EPS = 1e-4
# FP32 operations per (point, edge slot) test, as for B4/B5 above: every
# test pays the half-open compares (and, with the band, the near-flat
# term); tests whose edge straddles the point's y also pay the crossing
# arithmetic. B6/B7 compute the crossing and the band from one xc, B8 the
# crossing alone, B9 the band alone. They skip what cannot decide a
# point, so their data-dependent bound counts only the tests whose edge's
# y-span lies within the reach margin, 2 eps in f64, of the point's y,
# with eps what the wrapper passes (`LAYER_REACH_EPS`: B8's 0 leaves the
# spans that hold the point); the all-pairs bound counts every test.
LAYER_REPLACES = {"pip_grouped": "geomesa_tpu/engine/pip_sparse.py:395",
                  "pip_assign": "geomesa_tpu/engine/pip_sparse.py:610",
                  "pip_pairs_count": "geomesa_tpu/engine/pip_sparse.py:994",
                  "pip_pairs_band": "geomesa_tpu/engine/pip_sparse.py:1006"}
LAYER_OPS = {"pip_grouped": (BAND_ALL, BAND_COND + 1),
             "pip_assign": (BAND_ALL, BAND_COND + 1),
             "pip_pairs_count": (PIP_ALL, PIP_COND),
             "pip_pairs_band": (BAND_ALL, BAND_COND)}
LAYER_REACH_EPS = {"pip_grouped": LAYER_EPS, "pip_assign": LAYER_EPS,
                   "pip_pairs_count": 0.0, "pip_pairs_band": LAYER_EPS}


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def gen_admin_layer(rng, npoly: int):
    """The reference bench's OSM-admin-style disjoint layer: one polygon
    per jittered grid cell over the globe, log-mixed edge counts
    (10..10k), ~10% with a hole. Returns (x1, y1, x2, y2, pol, holes,
    rings): rings[pid] lists polygon pid's closed rings, shell first (the
    bench's keep_rings)."""
    side = int(np.ceil(np.sqrt(npoly)))
    cw, ch = 360.0 / side, 180.0 / side
    x1l, y1l, x2l, y2l, pol = [], [], [], [], []
    rings = []
    n_holes = 0
    ecounts = np.clip(
        np.round(10 ** rng.uniform(1, 4, npoly)).astype(int), 10, 10_000)
    pid = 0
    for gy in range(side):
        for gx in range(side):
            if pid >= npoly:
                break
            cx = -180 + (gx + 0.5) * cw + rng.uniform(-0.1, 0.1) * cw
            cy = -90 + (gy + 0.5) * ch + rng.uniform(-0.1, 0.1) * ch
            ne = int(ecounts[pid])
            th = np.sort(rng.uniform(0, 2 * np.pi, ne))
            # max lobe 0.375 cell < 0.4 cell, half the worst-case centre
            # separation after the jitter: the layer is disjoint
            rad = (0.3 * min(cw, ch)
                   * (1 + 0.25 * np.sin(3 * th + rng.uniform(0, 6))))
            ring = np.stack([cx + rad * np.cos(th), cy + rad * np.sin(th)], 1)
            ring = np.concatenate([ring, ring[:1]])
            x1l.append(ring[:-1, 0]); y1l.append(ring[:-1, 1])  # noqa: E702
            x2l.append(ring[1:, 0]); y2l.append(ring[1:, 1])  # noqa: E702
            pol.append(np.full(ne, pid))
            rings.append([ring])
            if rng.random() < 0.1:  # hole: reversed inner ring
                n_holes += 1
                nh = max(8, ne // 8)
                thh = np.sort(rng.uniform(0, 2 * np.pi, nh))[::-1]
                rh = rad.min() * 0.4
                hr = np.stack([cx + rh * np.cos(thh), cy + rh * np.sin(thh)], 1)
                hr = np.concatenate([hr, hr[:1]])
                x1l.append(hr[:-1, 0]); y1l.append(hr[:-1, 1])  # noqa: E702
                x2l.append(hr[1:, 0]); y2l.append(hr[1:, 1])  # noqa: E702
                pol.append(np.full(nh, pid))
                rings[-1].append(hr)
            pid += 1
    return (np.concatenate(x1l), np.concatenate(y1l), np.concatenate(x2l),
            np.concatenate(y2l), np.concatenate(pol), n_holes, rings)


def layer_points(torch, dev, rng, n: int, layer):
    """The bench's config-2 points: n uniform over the globe, the first
    min(n // 64, 100000) within 1e-6 degrees of random edges
    (adversarial), in Z2-Morton order. Returns (px, py, adv)."""
    x1, y1, x2, y2 = layer[:4]
    px = rng.uniform(-180, 180, n)
    py = rng.uniform(-90, 90, n)
    na = min(n // 64, 100_000)
    ei = rng.integers(0, len(x1), na)
    tt = rng.uniform(0, 1, na)
    px[:na] = x1[ei] + tt * (x2[ei] - x1[ei]) + rng.uniform(-1e-6, 1e-6, na)
    py[:na] = y1[ei] + tt * (y2[ei] - y1[ei]) + rng.uniform(-1e-6, 1e-6, na)
    py[:na] = np.clip(py[:na], -90, 90)
    px[:na] = np.clip(px[:na], -180, 180)
    adv = np.zeros(n, bool)
    adv[:na] = True
    zo = morton_order(torch, torch.from_numpy(px).to(dev),
                      torch.from_numpy(py).to(dev))
    return px[zo], py[zo], adv[zo]


def layer_kernel_inputs(torch, dev, prep, pol):
    """Device inputs of B6-B9 for a prep: points, edges, the B6 CSR, the
    B7 CSR with its flush markers, and the pair list."""
    from geomesa_tpu_torch.engine import pip_sparse as ps
    from geomesa_tpu_torch.engine.pip_sparse_kernels import pair_csr

    pl = prep.pairs
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
    rank = ps._poly_of_tile_from(prep, pol)[0]
    return dict(
        pts=ps.upload_points(prep.pxp, prep.pyp, dev),
        edges=ps.upload_edges(prep, dev),
        grouped=[i32(a) for a in pair_csr(pl.pair_pt, pl.pair_et)[:3]],
        assign=[i32(a) for a in pair_csr(pl.pair_pt, pl.pair_et, poly_of_tile=rank)],
        pairs=[i32(pl.pair_pt), i32(pl.pair_et)],
        n_ptiles=prep.n_ptiles)


def layer_kernel_calls(inp):
    """(name, kernel call, plain call) for B6-B9 on the given inputs."""
    from geomesa_tpu_torch.engine import pip_sparse_kernels as k

    a = (*inp["pts"], *inp["edges"])
    n, e = inp["n_ptiles"], LAYER_EPS
    g, s, p = inp["grouped"], inp["assign"], inp["pairs"]
    return [
        ("pip_grouped", lambda: k.pip_grouped(*a, *g, n, e),
         lambda: k.pip_grouped_plain(*a, *g, n, e)),
        ("pip_assign", lambda: k.pip_assign(*a, *s, n, e),
         lambda: k.pip_assign_plain(*a, *s, n, e)),
        ("pip_pairs_count", lambda: (k.pip_pairs_count(*a, *p, n),),
         lambda: (k.pip_pairs_count_plain(*a, *p, n),)),
        ("pip_pairs_band", lambda: (k.pip_pairs_band(*a, *p, n, e),),
         lambda: (k.pip_pairs_band_plain(*a, *p, n, e),)),
    ]


def max_int_err(got, exp) -> float:
    return max(float((g.long() - x.long()).abs().max()) for g, x in zip(got, exp))


def nan_layer_inputs(torch, dev):
    """Device inputs of B6-B9 (as `layer_kernel_inputs`) for three
    star-shaped rings whose every other edge is near-flat (dy in {0,
    3e-5, 9e-5, 1.5e-4}), a third of those with one NaN x-end, and 2048
    points within eps of the finite ends of those edges or on the rings,
    every point tile paired with every edge tile. A near-flat x-span
    that dropped the NaN end would flag points the plain versions do
    not."""
    from geomesa_tpu_torch.engine import pip_sparse as ps
    from geomesa_tpu_torch.engine.pip_sparse_kernels import pair_csr

    rng = np.random.default_rng(43)
    cols, pol = [[], [], [], []], []
    for k, (ne, cx) in enumerate(((900, 0.0), (600, 3.0), (40, 6.0))):
        th = np.sort(rng.uniform(0, 2 * np.pi, ne))
        x = cx + rng.uniform(0.5, 1.0, ne) * np.cos(th)
        y = rng.uniform(0.5, 1.0, ne) * np.sin(th)
        y[1::2] = y[0:-1:2][: len(y[1::2])] + rng.choice(
            [0.0, 3e-5, 9e-5, 1.5e-4], len(y[1::2]))
        for c, a in zip(cols, (x, y, np.roll(x, -1), np.roll(y, -1))):
            c.append(a)
        pol.append(np.full(ne, k))
    x1, y1, x2, y2 = (np.concatenate(c).astype(np.float32) for c in cols)
    flat = np.nonzero(np.abs(y2 - y1) <= 2 * LAYER_EPS)[0][::3]
    x2[flat[0::2]] = np.nan
    x1[flat[1::2]] = np.nan
    xf = np.where(np.isnan(x1[flat]), x2[flat], x1[flat])
    e = np.float32(LAYER_EPS)
    j = rng.integers(0, len(flat), 1536)
    px = (xf[j] + rng.uniform(-1.5, 1.5, 1536).astype(np.float32) * e).astype(np.float32)
    py = (y1[flat][j] + rng.choice([0.0, 0.5, -0.5, 1.0, -1.0], 1536).astype(np.float32)
          * e).astype(np.float32)
    k = rng.integers(0, len(x1), 512)
    px = np.concatenate([px, np.nan_to_num(x1[k], nan=0.0)])
    py = np.concatenate([py, y1[k]])
    *edges, poly = ps.pad_polygon_edges(x1, y1, x2, y2, np.concatenate(pol))
    n_pt, n_et = len(px) // ps.POINT_TILE, len(poly)
    pt = np.repeat(np.arange(n_pt), n_et).astype(np.int32)
    et = np.tile(np.arange(n_et), n_pt).astype(np.int32)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
    return dict(pts=(f(px), f(py)), edges=tuple(f(a) for a in edges),
                grouped=[i32(a) for a in pair_csr(pt, et)[:3]],
                assign=[i32(a) for a in pair_csr(pt, et, poly_of_tile=poly)],
                pairs=[i32(pt), i32(et)], n_ptiles=n_pt)


def shuffled_pairs(rng, pt, et):
    """A pair list in random order with a tenth of its pairs twice (B8 and
    B9 take pairs in any order and count a duplicate pair twice)."""
    dup = rng.choice(len(pt), max(1, len(pt) // 10), replace=False)
    o = rng.permutation(len(pt) + len(dup))
    return np.concatenate([pt, pt[dup]])[o], np.concatenate([et, et[dup]])[o]


def layer_kernel_check(torch, dev) -> None:
    """B6-B9 against their plain versions at a 200-polygon layer and
    2^18 points, and on the NaN x-end set (`nan_layer_inputs`):
    identical int32 outputs; B8/B9 also over each set's pairs shuffled
    with a tenth of them twice, and over that list in two launches."""
    from geomesa_tpu_torch.engine import pip_sparse as ps
    from geomesa_tpu_torch.engine import pip_sparse_kernels as k

    rng = np.random.default_rng(31)
    layer = gen_admin_layer(rng, LAYER_CHECK_POLYS)
    px, py, _ = layer_points(torch, dev, rng, LAYER_CHECK_N, layer)
    prep = ps.prepare_layer(px, py, *layer[:5])
    sets = [(f"{LAYER_CHECK_POLYS} polygons, {len(layer[0])} edges, "
             f"N={LAYER_CHECK_N}, {len(prep.pairs.pair_pt)} pairs",
             layer_kernel_inputs(torch, dev, prep, layer[4])),
            ("NaN x-ends of near-flat edges", nan_layer_inputs(torch, dev))]
    for what, inp in sets:
        out = []
        for name, kern, plain in layer_kernel_calls(inp):
            got = kern()
            sync(torch, dev)
            exp = plain()
            same = all(torch.equal(g, x) for g, x in zip(got, exp))
            out.append(f"{name} identical {same}")
            assert same, (name, what, max_int_err(got, exp))
            assert int(got[-1].sum()) > 0, name  # the band (or count) is not all zero
        a, n = (*inp["pts"], *inp["edges"]), inp["n_ptiles"]
        sp = [torch.from_numpy(x).to(dev) for x in shuffled_pairs(
            rng, *(t.cpu().numpy() for t in inp["pairs"]))]
        h = sp[0].shape[0] // 2
        band = k.pip_pairs_band_plain(*a, *sp, n, LAYER_EPS)
        count = k.pip_pairs_count_plain(*a, *sp, n)
        for name, got, exp in (
                ("pip_pairs_count", k.pip_pairs_count(*a, *sp, n), count),
                ("pip_pairs_count in two launches",
                 k.pip_pairs_count(*a, sp[0][:h], sp[1][:h], n)
                 + k.pip_pairs_count(*a, sp[0][h:], sp[1][h:], n), count),
                ("pip_pairs_band", k.pip_pairs_band(*a, *sp, n, LAYER_EPS), band),
                ("pip_pairs_band in two launches",
                 k.pip_pairs_band(*a, sp[0][:h], sp[1][:h], n, LAYER_EPS)
                 + k.pip_pairs_band(*a, sp[0][h:], sp[1][h:], n, LAYER_EPS), band)):
            same = bool(torch.equal(got, exp))
            out.append(f"{name} over {sp[0].shape[0]} shuffled pairs with "
                       f"duplicates identical {same}")
            assert same, (name, what, max_int_err((got,), (exp,)))
        log(f"kernel check B6-B9, {what}: {', '.join(out)}")


def oracle_all_edges(px, py, layer, ii):
    """The reference bench's independent f64 oracle: per-polygon crossing
    parity over the ORIGINAL unpadded edges of every polygon whose raw
    bbox holds the point (nothing shared with the pair build). Returns
    (inside the union [len(ii)], containing polygon id or -1, count)."""
    x1, y1, x2, y2, pol = layer[:5]
    op = np.argsort(pol, kind="stable")
    xs1, ys1, xs2, ys2 = x1[op], y1[op], x2[op], y2[op]
    uids, counts_o = np.unique(pol, return_counts=True)
    starts_o = np.concatenate([[0], np.cumsum(counts_o)[:-1]])
    pbx0 = np.minimum.reduceat(np.minimum(xs1, xs2), starts_o)
    pby0 = np.minimum.reduceat(np.minimum(ys1, ys2), starts_o)
    pbx1 = np.maximum.reduceat(np.maximum(xs1, xs2), starts_o)
    pby1 = np.maximum.reduceat(np.maximum(ys1, ys2), starts_o)
    inside = np.zeros(len(ii), bool)
    ids = np.full(len(ii), -1, np.int64)
    cnt = np.zeros(len(ii), np.int64)
    pxi, pyi = px[ii], py[ii]
    for c0 in range(0, len(ii), 4096):
        pc, qc = pxi[c0:c0 + 4096], pyi[c0:c0 + 4096]
        hitm = ((pc[:, None] >= pbx0[None]) & (pc[:, None] <= pbx1[None])
                & (qc[:, None] >= pby0[None]) & (qc[:, None] <= pby1[None]))
        pt_k, po_k = np.nonzero(hitm)
        for k in np.unique(po_k):
            es = slice(starts_o[k], starts_o[k] + counts_o[k])
            a1, b1, a2, b2 = xs1[es], ys1[es], xs2[es], ys2[es]
            pts = pt_k[po_k == k]
            pp, qq = pc[pts][:, None], qc[pts][:, None]
            condx = (b1[None] <= qq) != (b2[None] <= qq)
            ttt = (qq - b1[None]) / np.where(b2 == b1, 1.0, b2 - b1)[None]
            xc = a1[None] + ttt * (a2 - a1)[None]
            ins = (np.sum(condx & (xc > pp), 1) % 2) == 1
            # XOR of per-polygon parities == total crossing parity
            inside[c0 + pts] ^= ins
            ids[c0 + pts[ins]] = uids[k]
            cnt[c0 + pts] += ins
    return inside, np.where(cnt == 1, ids, -1), cnt


def pair_tests(torch, inp, margin=None) -> int:
    """(point, edge slot) tests of the pair list whose edge straddles the
    point's y (half-open; margin None) or whose y-span meets [py -
    margin, py + margin] (in f64), counted per pair from the edge tile's
    sorted y-extents (for the data-dependent bounds)."""
    from geomesa_tpu_torch.engine.pip_sparse_kernels import TILE

    qy = inp["pts"][1].reshape(-1, TILE)
    x1, y1, x2, y2 = (a.reshape(-1, TILE) for a in inp["edges"])
    lo = torch.sort(torch.minimum(y1, y2), dim=1).values
    hi = torch.sort(torch.maximum(y1, y2), dim=1).values
    if margin is not None:
        qy, lo, hi = qy.double(), lo.double(), hi.double()
    pt, et = (a.long() for a in inp["pairs"])
    total = 0
    for s in range(0, pt.shape[0], 1 << 14):
        q = qy[pt[s:s + (1 << 14)]].contiguous()
        e = et[s:s + (1 << 14)]
        if margin is None:
            n = (torch.searchsorted(lo[e], q, right=True)
                 - torch.searchsorted(hi[e], q, right=True))
        else:
            n = (torch.searchsorted(lo[e], q + margin, right=True)
                 - torch.searchsorted(hi[e], q - margin))
        total += int(n.sum())
    return total


def reached_edge_slots(torch, inp, margin: float):
    """bool [n_etiles, 512]: the edge slots whose y-span meets [py -
    margin, py + margin] (in f64, as `pair_tests`) for a point py of some
    tile paired with their tile: the only edges whose x-ends B6/B7 must
    read; the y-ends rule out every other, and an edge with a NaN y-end
    decides nothing (for the bytes of their data-dependent bound)."""
    from geomesa_tpu_torch.engine.pip_sparse_kernels import TILE

    inf = float("inf")
    q = torch.sort(inp["pts"][1].reshape(-1, TILE).double(), dim=1).values
    q = torch.where(torch.isnan(q), inf, q)  # NaN points reach nothing
    _, y1, _, y2 = (a.reshape(-1, TILE) for a in inp["edges"])
    lo, hi = torch.minimum(y1, y2).double(), torch.maximum(y1, y2).double()
    lo, hi = torch.where(torch.isnan(lo), inf, lo), torch.where(torch.isnan(hi), -inf, hi)
    hits = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
    pt, et = (a.long() for a in inp["pairs"])
    for s in range(0, pt.shape[0], 1 << 14):
        qs = q[pt[s:s + (1 << 14)]]
        e = et[s:s + (1 << 14)]
        # the points with q + margin >= lo and q - margin <= hi, an interval of qs
        first = torch.searchsorted(qs + margin, lo[e])
        end = torch.searchsorted(qs - margin, hi[e], right=True)
        hits.index_add_(0, e, (end > first).to(torch.int32))
    return hits > 0


def layer_path(torch, dev, n: int, card_s: str):
    """The config-2 join at full width (module docstring, 6)."""
    from geomesa_tpu_torch.engine import pip_sparse as ps
    from geomesa_tpu_torch.engine import pip_sparse_kernels as k

    rng = np.random.default_rng(29)
    t0 = time.perf_counter()
    layer = gen_admin_layer(rng, LAYER_POLYS)
    px, py, adv = layer_points(torch, dev, rng, n, layer)
    x1, y1, x2, y2, pol, n_holes, _ = layer
    lay = layer[:5]
    log(f"config 2 layer: {LAYER_POLYS} polygons, {len(x1)} edges, {n_holes} "
        f"holes; {n} points ({int(adv.sum())} adversarial) in "
        f"{time.perf_counter() - t0:.3f} s")

    kernels = (k.pip_grouped, k.pip_assign, k.pip_pairs_count, k.pip_pairs_band)
    for w in kernels:
        w.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # first query end to end: host prep, uploads, the join, the refine
    t0 = time.perf_counter()
    prep = ps.prepare_layer(px, py, *lay)
    prep_s = time.perf_counter() - t0
    pts = ps.upload_points(px, py, dev)
    edges = ps.upload_edges(prep, dev)
    inside, info = ps.pip_layer(px, py, *lay, device=dev, prep=prep,
                                points_device=pts, edges_device=edges)
    first_s = time.perf_counter() - t0
    pl = prep.pairs
    per_tile = np.bincount(pl.pair_pt, minlength=prep.n_ptiles)[pl.covered]
    log(f"config 2 prep: {prep_s:.3f} s on the host; {prep.n_etiles} edge tiles "
        f"({prep.n_etiles * ps.EDGE_TILE} slots), {len(pl.pair_pt)} pairs over "
        f"{int(pl.covered.sum())} of {prep.n_ptiles} point tiles (per tile: median "
        f"{int(np.median(per_tile))}, max {int(per_tile.max())}), "
        f"{len(pl.pair_pt) * ps.POINT_TILE * ps.EDGE_TILE:.4g} point-edge tests")
    peak = (f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
            if dev.type == "cuda" else "not measured")
    log(f"config 2 first query e2e (prep + upload + pip_layer): {first_s:.3f} s; "
        f"flagged {info['flagged']}, refined {info['refined']}, refine "
        f"{info['refine_s']:.3f} s; peak device memory {peak} [{card_s}]")

    kw = dict(device=dev, prep=prep, points_device=pts, edges_device=edges)
    arrays = (*pts, *edges)
    sk = dict(n_ptiles=prep.n_ptiles, n_etiles=prep.n_etiles, device=dev)
    out = {}
    calls = {
        "pip_layer_grouped (device pass)": lambda: ps.fetch(*ps.pip_layer_grouped(
            *arrays, pl.pair_pt, pl.pair_et, **sk)),
        "pip_layer": lambda: ps.pip_layer(px, py, *lay, **kw),
        "pip_layer_assign": lambda: ps.pip_layer_assign(px, py, *lay, **kw),
        "pip_layer_join": lambda: ps.pip_layer_join(px, py, *lay, **kw),
        "pip_layer_sparse": lambda: ps.pip_layer_sparse(
            *arrays, pl.pair_pt, pl.pair_et, **sk),
    }
    lat = {}
    for name, fn in calls.items():
        out[name] = fn()  # warm
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out[name] = fn()
            times.append(time.perf_counter() - t0)
        lat[name] = statistics.median(times)
    launches = {w.__name__: w.launches for w in kernels}
    log(f"config-2 launches: {launches} over 1 first query and 4 calls of each "
        f"of {len(calls)} call types")
    assert all(launches.values()), "a kernel of the config-2 path never launched"
    for name, t in lat.items():
        log(f"{name}: warm p50 {t * 1e3:.3f} ms, {n / t:.1f} points/sec, "
            f"{n * LAYER_POLYS / t:.4g} point*polys/sec [{card_s}]")
    _, jinfo = out["pip_layer"]
    _, _, ainfo = out["pip_layer_assign"]
    log(f"pip_layer warm: flagged {jinfo['flagged']}, refined {jinfo['refined']}, "
        f"refine_s {jinfo['refine_s']:.3f}; pip_layer_assign: flagged "
        f"{ainfo['flagged']}, refined {ainfo['refined']}, host_rows "
        f"{ainfo['host_rows']}")
    profile_calls(torch, "pip_layer", calls["pip_layer"], card_s, calls=1)
    profile_calls(torch, "pip_layer_sparse", calls["pip_layer_sparse"], card_s)

    # -- gates -------------------------------------------------------------
    cov_tiles = np.nonzero(pl.covered)[0]
    sub = np.random.default_rng(30).choice(
        cov_tiles, min(LAYER_SAMPLE_TILES, len(cov_tiles)), replace=False)
    check = np.unique(np.concatenate(
        [np.arange(t * ps.POINT_TILE, min((t + 1) * ps.POINT_TILE, n)) for t in sub]
        + [np.nonzero(adv)[0]]))
    t0 = time.perf_counter()
    exp_in, exp_id, exp_n = oracle_all_edges(px, py, lay, check)
    oracle_s = time.perf_counter() - t0
    inside, _ = out["pip_layer"]
    mism = int((inside[check] != exp_in).sum())
    assert mism == 0, f"{mism} mismatches against the all-edges f64 oracle"
    ids, count, _ = out["pip_layer_assign"]
    bad_ids = int((ids[check] != exp_id).sum())
    assert bad_ids == 0 and np.array_equal(count[check], exp_n), bad_ids
    rows, polys = out["pip_layer_join"]
    assert len(rows) == int((count == 1).sum()), (len(rows), int((count == 1).sum()))
    assert np.array_equal(np.sort(rows), np.nonzero(inside)[0]), "join rows != inside"
    assert np.array_equal(polys[np.argsort(rows)], ids[np.sort(rows)])
    g_c, g_b = out["pip_layer_grouped (device pass)"]
    s_c, s_b = out["pip_layer_sparse"]
    cov = np.repeat(pl.covered, ps.POINT_TILE)
    assert np.array_equal(s_c[cov], g_c[cov]) and np.array_equal(s_b[cov], g_b[cov])
    log(f"correct: pip_layer == all-edges f64 oracle on {len(check)} points "
        f"({len(sub)} sampled covered tiles + {int(adv.sum())} adversarial; "
        f"{int(exp_in.sum())} inside; oracle {oracle_s:.1f} s); pip_layer_assign "
        f"ids == per-polygon oracle; pip_layer_join emits {len(rows)} pairs == "
        f"(count == 1).sum(), rows == pip_layer inside; pip_layer_sparse == "
        f"pip_layer_grouped on covered tiles")
    # phase 11 holds the SQL join's per-region counts to these gated ids
    counts = np.bincount(ids[ids >= 0], minlength=LAYER_POLYS)
    return launches, layer_kernel_inputs(torch, dev, prep, pol), counts


def layer_skip_lines(torch, psk, inp, card_s: str) -> float:
    """Earlier lines of B6-B9's rows: the kernels' registers and spills,
    what their skip leaves (chunk-tests kept by each warp of y-sorted
    points, counted in torch from the data; B6/B7/B9 at the reach margin
    2 eps, B8 at 0) and the heaviest row's share, and the longest row
    alone in one block. Returns that time."""
    from geomesa_tpu_torch.engine.kernels import build

    names = {"grouped_kernelILb0ELb1ELb1E": "B6", "grouped_kernelILb1ELb1ELb1E": "B7",
             "grouped_kernelILb0ELb1ELb0E": "B8", "grouped_kernelILb0ELb0ELb1E": "B9"}
    for name, res in ptxas_resources(build.build_log["pip_layer"]["ptxas"]).items():
        kind = [k for n, k in names.items() if n in name]
        if kind:
            log(f"ptxas pip_layer.cu {kind[0]}: {res.get('registers')} registers, "
                f"spill stores/loads {res.get('spill')}")
    g, (pt, et) = inp["grouped"], inp["pairs"]
    m, tests = int(pt.shape[0]), int(pt.shape[0]) * psk.TILE * psk.TILE
    wp, warps = psk.WARP_POINTS, psk.TILE // psk.WARP_POINTS
    for what, eps in (("B6/B7/B9 skip (B9 walks the same pairs, one row a point "
                       "tile)", LAYER_EPS), ("B8 skip (reach margin 0)", 0.0)):
        chunks, edges = psk.kept_counts(inp["pts"][1], inp["edges"][1],
                                        inp["edges"][3], pt, et, eps)
        in_chunks, kept = int(chunks.sum()) * psk.CHUNK * wp, int(edges.sum()) * wp
        row = torch.zeros(inp["n_ptiles"], dtype=torch.int64, device=pt.device)
        row.index_add_(0, pt.long(), edges)
        log(f"{what} over {m} pairs, warps of {wp} y-sorted points, chunks of "
            f"{psk.CHUNK} edges: {float(chunks.double().mean()) / warps:.3f} of "
            f"{psk.TILE // psk.CHUNK} chunks and {float(edges.double().mean()) / warps:.3f} "
            f"edges a warp a pair kept; tests in kept chunks {in_chunks} "
            f"({in_chunks / tests:.4f} of {tests}), of kept edges {kept} "
            f"({kept / tests:.4f}); heaviest row {int(row.max()) * wp / psk.TILE ** 2:.3f} "
            f"pair-equivalents of kept edge-tests, of {kept / psk.TILE ** 2:.1f} in all "
            f"({int(row.max()) * wp / max(1, kept):.4f})")
    # the load-balance tail: the longest row alone, in one block
    a = (*inp["pts"], *inp["edges"])
    lens = g[1][1:] - g[1][:-1]
    j = int(torch.argmax(lens))
    s0, s1 = int(g[1][j]), int(g[1][j + 1])
    one = (g[0][j:j + 1], g[1][j:j + 2] - s0, g[2][s0:s1])
    tail_ms = timed_ms(torch, lambda: psk.pip_grouped(*a, *one, inp["n_ptiles"],
                                                      LAYER_EPS), 10)
    ty = inp["pts"][1].reshape(-1, psk.TILE)[int(g[0][j])]
    gap = float(torch.diff(torch.sort(ty).values).max())
    log(f"pip_grouped, the longest row alone ({s1 - s0} edge tiles; its points' "
        f"y from {float(ty.min()):.4f} to {float(ty.max()):.4f}, largest gap "
        f"{gap:.4f}): {tail_ms:.3f} ms [{card_s}]")
    return tail_ms


def layer_rows(torch, launches, inp, card_s: str):
    """B6-B9 at the config-2 path's shapes: time, plain time, error,
    bound (bytes from the tiles the pairs name; operations counted from
    this run's data). The bound counts the tests within reach (the edge's
    y-span within the kernel's reach margin of the point's y,
    `LAYER_REACH_EPS`: the most its skip can keep and still be exact) and,
    of the named edge tiles, every y-end but only the x-ends of edges
    within reach of a paired point; the all-pairs bound stands beside
    it."""
    from geomesa_tpu_torch.engine import pip_sparse_kernels as psk
    from geomesa_tpu_torch.engine.pip_sparse_kernels import TILE

    g, p = inp["grouped"], inp["pairs"]
    m, k = int(p[0].shape[0]), int(g[0].shape[0])
    tests = m * TILE * TILE
    cond = pair_tests(torch, inp)
    # per eps, the tests within reach (2 eps in f64 of the f32 eps, as the
    # kernels take it) and the edge slots whose x-ends must be read
    reach, x_read = {}, {}
    for e in set(LAYER_REACH_EPS.values()):
        reach[e] = pair_tests(torch, inp, 2.0 * float(np.float32(e)))
        x_read[e] = int(reached_edge_slots(torch, inp, 2.0 * float(np.float32(e))).sum())
    n_pt = inp["n_ptiles"]
    etiles = int(torch.unique(p[1]).shape[0])
    # points of covered tiles, the named edge tiles' y-ends, x-ends in reach
    read = {name: 8 * TILE * k + 8 * TILE * etiles + 8 * x_read[e]
            for name, e in LAYER_REACH_EPS.items()}
    nbytes = {"pip_grouped": read["pip_grouped"] + 4 * (k + 1 + k + m) + 8 * TILE * n_pt,
              "pip_assign": read["pip_assign"] + 4 * (k + 1 + k + 2 * m) + 12 * TILE * n_pt,
              "pip_pairs_count": read["pip_pairs_count"] + 8 * m + 4 * TILE * (n_pt + 1),
              "pip_pairs_band": read["pip_pairs_band"] + 8 * m + 4 * TILE * (n_pt + 1)}
    tail_ms = layer_skip_lines(torch, psk, inp, card_s)
    rows = []
    for name, kern, plain in layer_kernel_calls(inp):
        got = kern()
        exp = plain()
        err = max_int_err(got, exp)
        assert err == 0.0, (name, err)  # int32 counts: exact
        del got, exp
        ms = timed_ms(torch, kern, 10)
        plain_ms = timed_ms(torch, plain, 1)
        n_all, n_cond = LAYER_OPS[name]
        e = LAYER_REACH_EPS[name]
        b_all, by_all = roofline_ms(n_all * tests + n_cond * cond, nbytes[name]
                                    + 8 * (TILE * etiles - x_read[e]))
        b, by = roofline_ms(n_all * reach[e] + n_cond * cond, nbytes[name])
        extra = (f"; {reach[e]} tests whose edge's y-span is within 2 eps = "
                 f"{2 * e:g} of the point, {nbytes[name]} bytes with the x-ends of "
                 f"{x_read[e]} of {TILE * etiles} named edge slots; all-pairs "
                 f"bound {b_all:.3f} ms by {by_all}")
        rows.append({
            "name": name, "route": "cuda",
            "source": "geomesa_tpu_torch/engine/kernels/pip_layer.cu",
            "replaces": LAYER_REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None,
        })
        rows[-1]["bound_all_pairs_ms"] = b_all
        if name == "pip_grouped":
            rows[-1]["longest_row_ms"] = tail_ms
        log(f"{name}: {k} covered tiles, {m} pairs, {tests:.4g} tests of which "
            f"{cond} straddle: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
            f"{b:.3f} ms by {by}{extra}; library null: no PyTorch call "
            f"computes a crossing count) [{card_s}]")
    return rows


# -- feature route (phase 7) and TubeSelect (phase 8, bench config 5) ---------

FEATURE_BBOX = (10.0, 40.0, 12.0, 42.0)
FEATURE_LIMIT = 10_000
M_T0, M_T1 = 1_456_790_400_000, 1_459_468_800_000  # 2016-03-01 .. 2016-04-01
# NVIDIA H100 SXM data sheet: FP64 (non-tensor) peak
FP64_OPS_PER_S = 34e12
# FP32 operations per (point, sample) pair of the tube test: 3 subtracts,
# 3 multiplies, 2 adds and 1 compare for the chord, 2 compares for the
# time window and 1 AND
TUBE_OPS = 12
TUBE_N = 1 << 22  # the reference bench's config-5 size
TUBE_STORE_N = 1 << 24
TUBE_T = 256
TUBE_RADIUS = 20_000.0
TUBE_WIN = 3_600_000
TUBE_DAY0 = 1_600_041_600_000  # 2020-09-14T00:00:00Z
DAY_MS = 86_400_000


def time_calls(calls: dict, warm: int = 5):
    """Each call once cold and `warm` times more: (results, {name: (cold
    s, warm p50 s)})."""
    out, lat = {}, {}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        out[name] = fn()
        cold = time.perf_counter() - t0
        times = []
        for _ in range(warm):
            t0 = time.perf_counter()
            out[name] = fn()
            times.append(time.perf_counter() - t0)
        lat[name] = (cold, statistics.median(times))
    return out, lat


class Spans:
    """Seconds spent in named functions of the port during one call, and
    the calls made: each wrapper synchronises the card before it starts
    and before it stops its clock, so a span holds its own device work.
    Used for one instrumented call beside the uninstrumented latencies."""

    def __init__(self, torch, targets):
        self.torch = torch
        self.targets = targets  # [(owner, attribute, label)]
        self.seconds = {label: 0.0 for _, _, label in targets}
        self.calls = {label: 0 for _, _, label in targets}
        self.results = {}
        self._saved = []

    def __enter__(self):
        for owner, attr, label in self.targets:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, label))
        return self

    def _wrap(self, fn, label):
        def wrapped(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds[label] += time.perf_counter() - t0
            self.calls[label] += 1
            self.results[label] = out
            return out
        return wrapped

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        return False


def rows_equal(feats, t, x, y, cols=()) -> bool:
    """The returned rows, as a set, against the expected rows: both sides
    ordered by (dtg, x), then dtg, x, y and any (name, values) in `cols`
    compared exactly (the written f64 values survive the store)."""
    if feats is None:
        return len(t) == 0
    ft = np.asarray(feats.columns["dtg"])
    fx = np.asarray(feats.columns["geom"].x)
    fy = np.asarray(feats.columns["geom"].y)
    if len(ft) != len(t):
        return False
    a, b = np.lexsort((fx, ft)), np.lexsort((x, t))
    ok = (np.array_equal(ft[a], t[b]) and np.array_equal(fx[a], x[b])
          and np.array_equal(fy[a], y[b]))
    for name, vals in cols:
        ok = ok and np.array_equal(np.asarray(feats.columns[name])[a], vals[b])
    return bool(ok)


def feature_spans(torch, card_s: str, what: str, fn) -> dict:
    """One instrumented warm call: the mask fetch, the f64 refine and the
    select-sort-project tail, in seconds."""
    import geomesa_tpu_torch.plan.planner as planner_mod
    from geomesa_tpu_torch.cql.compile import CompiledFilter

    with Spans(torch, [(planner_mod, "fetch", "mask fetch"),
                       (CompiledFilter, "refine", "refine"),
                       (planner_mod, "aggregate", "select + finish")]) as sp:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    log(f"{what} split: mask fetch {sp.seconds['mask fetch'] * 1e3:.3f} ms, "
        f"refine {sp.seconds['refine'] * 1e3:.3f} ms, select + sort + "
        f"project {sp.seconds['select + finish'] * 1e3:.3f} ms of "
        f"{wall * 1e3:.3f} ms (synchronised spans) [{card_s}]")
    return dict(sp.seconds, wall=wall)


def feature_phase_knn(torch, src, tmp: str, dev, x, y, t, speed, card_s: str):
    """Phase 7 on the kNN store: a BBOX + 69-day DURING + attribute query
    as features, with projection, sort and limit, on the cached route
    (with and without the limit) and the scan route."""
    from geomesa_tpu_torch import DataStore, Query

    bx = FEATURE_BBOX
    cql = (f"BBOX(geom, {bx[0]}, {bx[1]}, {bx[2]}, {bx[3]}) AND dtg DURING "
           f"{iso(T0)}/{iso(T1)} AND speed > 5.0")
    attrs = ["speed", "dtg", "geom"]
    order = [("dtg", False)]
    q_lim = Query("gdelt", cql, attributes=attrs, sort_by=order,
                  max_features=FEATURE_LIMIT)
    q_all = Query("gdelt", cql, attributes=attrs, sort_by=order)
    scan = DataStore(tmp, device=dev).get_feature_source("gdelt")
    calls = {"features cached, limit": lambda: src.get_features(q_lim),
             "features cached": lambda: src.get_features(q_all),
             "features scan": lambda: scan.get_features(q_all)}
    out, lat = time_calls(calls)
    count = src.get_count(cql)
    m = ((x >= bx[0]) & (x <= bx[2]) & (y >= bx[1]) & (y <= bx[3])
         & (t > T0) & (t < T1) & (speed > 5.0))
    for name, r in out.items():
        assert r.kind == "features" and r.features is not None, name
        f = r.features
        assert f.sft.attribute_names == attrs, name
        d = np.asarray(f.columns["dtg"])
        assert np.all(d[:-1] >= d[1:]), f"{name}: not sorted by dtg descending"
        if name.endswith("limit"):
            assert len(f) == r.count == min(FEATURE_LIMIT, int(m.sum())), name
            full = out["features cached"].features
            assert np.array_equal(d, np.asarray(full.columns["dtg"])[:len(f)])
        else:
            assert r.count == count == int(m.sum()), (name, r.count, count)
            assert rows_equal(f, t[m], x[m], y[m], [("speed", speed[m])]), name
    log(f"correct: feature rows == f64 NumPy evaluation of the written rows "
        f"({int(m.sum())} rows, cached and scan), sorted by dtg descending, "
        f"projected to {attrs}, limit {FEATURE_LIMIT} keeps the first "
        f"{len(out['features cached, limit'].features)}; count == get_count")
    for name, (cold, warm) in lat.items():
        log(f"{name}: cold {cold * 1e3:.3f} ms, warm p50 {warm * 1e3:.3f} ms, "
            f"{out[name].count} rows returned [{card_s}]")
    res = {name: {"cold_s": c, "warm_p50_s": w, "rows": out[name].count}
           for name, (c, w) in lat.items()}
    res["features cached"]["split"] = feature_spans(
        torch, card_s, "features cached", calls["features cached"])
    res["features scan"]["split"] = feature_spans(
        torch, card_s, "features scan", calls["features scan"])
    profile_calls(torch, "features cached", calls["features cached"], card_s,
                  calls=1)
    return res


def f64_polygon_mask(torch, dev, x, y, wkt: str, chunk: int = 1 << 15):
    """Exact f64 crossing-number membership on the card (the oracle), as a
    host bool mask: points outside the polygon's envelope cross no edge
    or an even number."""
    from geomesa_tpu_torch.core.wkt import parse_wkt
    from geomesa_tpu_torch.engine.pip import polygon_edges

    e = [torch.from_numpy(a).to(dev)[None, :] for a in polygon_edges(parse_wkt(wkt))]
    x1, y1, x2, y2 = e
    xt = torch.from_numpy(x).to(dev)
    yt = torch.from_numpy(y).to(dev)
    keep = ((xt >= x1.min()) & (xt <= x1.max()) & (yt >= y1.min()) & (yt <= y1.max()))
    at = torch.nonzero(keep).flatten()
    xt, yt = xt[at], yt[at]
    den = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
    inside = torch.zeros(xt.shape[0], dtype=torch.bool, device=dev)
    for s in range(0, xt.shape[0], chunk):
        px = xt[s:s + chunk, None]
        py = yt[s:s + chunk, None]
        cond = (y1 <= py) != (y2 <= py)
        xc = x1 + (py - y1) / den * (x2 - x1)
        inside[s:s + chunk] = ((cond & (xc > px)).sum(1) % 2) == 1
    out = torch.zeros(len(x), dtype=torch.bool, device=dev)
    out[at] = inside
    return out.cpu().numpy()


def feature_phase_density(torch, src, dev, x, y, t, fare, wkt: str,
                          card_s: str):
    """Phase 7 on the density store: the zone polygon AND one month as
    features (B4 and B5 on the cached route), against the f64 crossing
    oracle restricted to the month."""
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.engine import pip_kernels as pk

    cql = f"INTERSECTS(geom, {wkt}) AND dtg > {iso(M_T0)} AND dtg < {iso(M_T1)}"
    q = Query("taxi", cql)
    for w in (pk.pip_crossing, pk.pip_band):
        w.launches = 0
    out, lat = time_calls({"polygon features": lambda: src.get_features(q)}, warm=3)
    launches = {w.__name__: w.launches for w in (pk.pip_crossing, pk.pip_band)}
    log(f"feature-route launches: {launches} over 4 polygon feature calls")
    assert all(launches.values()), "B4 or B5 never launched on the feature route"
    r = out["polygon features"]
    tm = (t > M_T0) & (t < M_T1)
    exp = np.zeros(len(x), bool)
    exp[tm] = f64_polygon_mask(torch, dev, x[tm], y[tm], wkt)
    assert r.kind == "features" and r.count == int(exp.sum()), (r.count, int(exp.sum()))
    assert rows_equal(r.features, t[exp], x[exp], y[exp], [("fare", fare[exp])])
    cold, warm = lat["polygon features"]
    log(f"correct: polygon feature rows == the f64 crossing oracle over the "
        f"month ({r.count} rows)")
    log(f"polygon features: cold {cold * 1e3:.3f} ms, warm p50 "
        f"{warm * 1e3:.3f} ms, {r.count} rows returned [{card_s}]")
    split = feature_spans(torch, card_s, "polygon features",
                          lambda: src.get_features(q))
    return {"cold_s": cold, "warm_p50_s": warm, "rows": r.count,
            "launches": launches, "split": split}


def tube_track(rng):
    """The reference bench's 256-sample track over one day (config 5)."""
    tx = np.linspace(-8, 8, TUBE_T)
    ty = np.linspace(51, 59, TUBE_T) + rng.normal(0, 0.05, TUBE_T)
    tt = np.linspace(0, DAY_MS, TUBE_T).astype(np.int64)
    return tx, ty, tt


def tube_points(torch, dev, rng, n: int):
    """The bench's config-5 points: x U(-10, 10), y U(50, 60) in Morton
    order, t U(0, 1 day)."""
    x = rng.uniform(-10, 10, n)
    y = rng.uniform(50, 60, n)
    o = morton_order(torch, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    x, y = x[o], y[o]
    t = rng.integers(0, DAY_MS, n)
    return x, y, t


def tube_oracle(torch, dev, x, y, t, tx, ty, tt, radius, win,
                chunk: int = 1 << 14) -> np.ndarray:
    """f64 haversine membership on the card: within `radius` metres and
    `win` ms of any sample (written here, apart from the port)."""
    R = 6_371_008.8
    f = lambda a: torch.from_numpy(np.asarray(a, np.float64)).to(dev)  # noqa: E731
    plon, plat = torch.deg2rad(f(x)), torch.deg2rad(f(y))
    slon, slat = torch.deg2rad(f(tx))[None], torch.deg2rad(f(ty))[None]
    pc, sc = torch.cos(plat), torch.cos(slat)
    pt = torch.from_numpy(np.asarray(t, np.int64)).to(dev)
    st = torch.from_numpy(np.asarray(tt, np.int64)).to(dev)[None]
    out = torch.zeros(len(x), dtype=torch.bool, device=dev)
    for s in range(0, len(x), chunk):
        e = slice(s, s + chunk)
        a = (torch.sin((slat - plat[e, None]) / 2) ** 2
             + pc[e, None] * sc * torch.sin((slon - plon[e, None]) / 2) ** 2)
        d = 2.0 * R * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
        hit = (d <= radius) & ((pt[e, None] - st).abs() <= win)
        out[e] = hit.any(1)
    return out.cpu().numpy()


def off_radius_edge(got, exp, x, y, t, tx, ty, tt, radius, win) -> int:
    """Mismatches that are NOT a sample within the window at the radius
    +- 1 m (the reference bench's rule): the count that must be 0."""
    from geomesa_tpu_torch.engine.geodesy import haversine_m_np

    bad = 0
    for i in np.nonzero(got != exp)[0]:
        d = haversine_m_np(x[i], y[i], tx, ty)
        if not ((np.abs(t[i] - tt) <= win) & (np.abs(d - radius) <= 1.0)).any():
            bad += 1
    return bad


def tube_engine(torch, dev, card_s: str):
    """Phase 8, engine: tube_select_pruned (capacity calibrated once) and
    the dense tube_select at the bench's config-5 shape, in f32; the
    chunk and tile sizes timed; gated pruned == dense and against the
    f64 oracle under the 1 m rule."""
    import geomesa_tpu_torch.engine.tube as tb

    rng = np.random.default_rng(13)
    x, y, t = tube_points(torch, dev, rng, TUBE_N)
    tx, ty, tt = tube_track(rng)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    i64 = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)  # noqa: E731
    args = (f32(x), f32(y), i64(t), torch.ones(TUBE_N, dtype=torch.bool, device=dev),
            f32(tx), f32(ty), i64(tt),
            torch.tensor(TUBE_RADIUS, dtype=torch.float32, device=dev),
            torch.tensor(TUBE_WIN, dtype=torch.int64, device=dev))
    margins = tb.tube_margins(ty, TUBE_RADIUS)
    with Spans(torch, [(tb, "tube_select", "tube_select"),
                       (tb, "_tube_pruned_call", "_tube_pruned_call")]) as sp:
        _, cap = tb.tube_select_pruned(*args)  # calibration: one scalar read
        pruned = tb.tube_select_pruned(*args, tile_capacity=cap)[0]
        dense = tb.tube_select(*args)
    launches = dict(sp.calls)
    log(f"tube engine launches: {launches} over 1 calibration, 1 pruned and "
        "1 dense call (plain PyTorch; a launch is a call of the function)")
    got = pruned.cpu().numpy()
    assert np.array_equal(got, dense.cpu().numpy()), "pruned != dense"
    exp = tube_oracle(torch, dev, x, y, t, tx, ty, tt, TUBE_RADIUS, TUBE_WIN)
    mism = int((got != exp).sum())
    bad = off_radius_edge(got, exp, x, y, t, tx, ty, tt, TUBE_RADIUS, TUBE_WIN)
    assert bad == 0, f"{bad} tube mismatches away from the radius edge"
    assert cap > 0, "the calibrated capacity overflowed"
    tiles = (512, tb.PRUNE_TILE, 2048, 8192)
    sel = {}
    for dt in tiles:
        sel[dt] = int(tb.tube_tile_hits(args[0], args[1], args[2], args[4], args[5],
                                        args[6], args[8], *margins, data_tile=dt).sum())
    log(f"correct: tube pruned == dense ({int(got.sum())} hits of {TUBE_N}); "
        f"{mism} mismatches against the f64 haversine oracle, all within 1 m "
        f"of the radius")
    # sizes: the dense pass's chunk, and the pruning tile
    dense_ms = {}
    for dc in (16384, tb.DATA_CHUNK, 262144):
        dense_ms[dc] = timed_ms(torch, lambda: tb.tube_select(*args, data_tile=dc), 5)
    pruned_ms, caps = {}, {}
    for dt in tiles:
        _, caps[dt] = tb.tube_select_pruned(*args, data_tile=dt)
        pruned_ms[dt] = timed_ms(torch, lambda: tb.tube_select_pruned(
            *args, data_tile=dt, tile_capacity=caps[dt]), 10)
    for dc, ms in dense_ms.items():
        log(f"tube_select dense, chunk {dc} x {tb.TUBE_CHUNK}: {ms:.3f} ms [{card_s}]")
    for dt, ms in pruned_ms.items():
        log(f"tube_select_pruned, data_tile {dt}: {ms:.3f} ms, {sel[dt]} of "
            f"{-(-TUBE_N // dt)} tiles selected, capacity {caps[dt]} [{card_s}]")
    d_ms = timed_ms(torch, lambda: tb.tube_select(*args), 10)
    p_ms = timed_ms(torch, lambda: tb.tube_select_pruned(*args, tile_capacity=cap), 10)
    nbytes = TUBE_N * (4 + 4 + 8 + 1 + 1)
    pairs_dense = TUBE_N * TUBE_T
    pt_ = tb.PRUNE_TILE
    pairs_pruned = sel[pt_] * pt_ * TUBE_T
    bd, byd = roofline_ms(TUBE_OPS * pairs_dense, nbytes)
    bp, byp = roofline_ms(TUBE_OPS * pairs_pruned, nbytes)
    log(f"tube_select dense: warm p50 {d_ms:.3f} ms, {TUBE_N / d_ms * 1e3:.1f} "
        f"points/sec, {pairs_dense} pairs, bound {bd:.3f} ms by {byd} [{card_s}]")
    log(f"tube_select_pruned: warm p50 {p_ms:.3f} ms, {TUBE_N / p_ms * 1e3:.1f} "
        f"points/sec, {sel[pt_]} of {-(-TUBE_N // pt_)} tiles selected, capacity "
        f"{cap}, {pairs_pruned} pairs tested, bound {bp:.3f} ms by {byp} [{card_s}]")
    return [
        {"name": "tube_select", "replaces": "geomesa_tpu/engine/tube.py:31",
         "source": "geomesa_tpu_torch/engine/tube.py", "route": "torch",
         "launches": launches["tube_select"], "ms": d_ms, "bound_ms": bd,
         "bound_by": byd, "pairs": pairs_dense, "chunk_ms": dense_ms},
        {"name": "_tube_pruned_call", "replaces": "geomesa_tpu/engine/tube.py:142",
         "source": "geomesa_tpu_torch/engine/tube.py", "route": "torch",
         "launches": launches["_tube_pruned_call"], "ms": p_ms, "bound_ms": bp,
         "bound_by": byp, "pairs": pairs_pruned, "tiles": sel[pt_],
         "capacity": cap, "data_tile_ms": pruned_ms},
    ]


def hit_rows(feats, x, y, t, by_x):
    """The written rows a result batch holds, as a bool mask over them
    (found by their f64 x through `by_x`, an argsort of x, and checked on
    y and dtg); None if a returned row is not a written one."""
    fx = np.asarray(feats.geometry.x)
    pos = np.minimum(np.searchsorted(x[by_x], fx), len(x) - 1)
    idx = by_x[pos]
    if not (np.array_equal(x[idx], fx) and np.array_equal(y[idx], feats.geometry.y)
            and np.array_equal(t[idx], np.asarray(feats.dtg))):
        return None
    got = np.zeros(len(x), bool)
    got[idx] = True
    return got if int(got.sum()) == len(feats) else None


def tube_process(torch, dev, rows: int, card_s: str):
    """Phase 8, process: TubeSelectProcess over a cached DataStore of
    `rows` AIS-shaped rows (vessel, dtg, geom; one day, Morton order,
    10,000 vessel names), cold, warm and with LineGapFill; gated against
    the f64 haversine oracle over the written rows under the 1 m rule."""
    import geomesa_tpu_torch.process.tube as pt
    from geomesa_tpu_torch import DataStore, FeatureBatch, SimpleFeatureType
    from geomesa_tpu_torch.core.columnar import DictColumn, GeometryColumn
    from geomesa_tpu_torch.process import LineGapFill, NoGapFill, TubeSelectProcess

    rng = np.random.default_rng(14)
    x, y, t = tube_points(torch, dev, rng, rows)
    t = t + TUBE_DAY0
    codes = rng.integers(0, 10_000, rows).astype(np.int32)
    vocab = [f"vessel{i:05d}" for i in range(10_000)]
    tx, ty, tt = tube_track(np.random.default_rng(13))
    tt = tt + TUBE_DAY0
    with tempfile.TemporaryDirectory() as tmp:
        ds = DataStore(tmp, use_device_cache=True, device=dev)
        sft = SimpleFeatureType.from_spec("ais", "vessel:String,dtg:Date,*geom:Point")
        src = ds.create_schema(sft)
        t0 = time.perf_counter()
        src.write(FeatureBatch(sft, {"vessel": DictColumn(codes, vocab), "dtg": t,
                                     "geom": GeometryColumn.from_points(x, y)}))
        log(f"ingest: {rows} rows in {time.perf_counter() - t0:.3f} s [{card_s}]")
        track = FeatureBatch(sft, {
            "vessel": DictColumn(np.zeros(TUBE_T, np.int32), ["track"]), "dtg": tt,
            "geom": GeometryColumn.from_points(tx, ty)})
        kw = dict(buffer_m=TUBE_RADIUS, max_time_window_ms=TUBE_WIN)
        fills = {"TubeSelectProcess": NoGapFill(),
                 "TubeSelectProcess LineGapFill(10 km)": LineGapFill(10_000.0)}
        calls = {name: (lambda f=f: TubeSelectProcess().execute(track, src, f, **kw))
                 for name, f in fills.items()}
        import geomesa_tpu_torch.engine.tube as tb
        with Spans(torch, [(tb, "tube_select", "tube_select"),
                           (tb, "_tube_pruned_call", "_tube_pruned_call")]) as cnt:
            out, lat = time_calls(calls, warm=3)
        launches = dict(cnt.calls)
        log(f"tube process launches: {launches} over 4 calls of each of "
            f"{len(calls)} call types")
        assert launches["_tube_pruned_call"] > 0, "the pruned pass never ran"
        with Spans(torch, [(pt, "candidates_for", "window_query"),
                           (pt, "to_device", "f64 upload"),
                           (pt, "tube_select_pruned", "device pass")]) as sp:
            t0 = time.perf_counter()
            calls["TubeSelectProcess"]()
            wall = time.perf_counter() - t0
        n_cand = len(sp.results["window_query"])
        cap = sp.results["device pass"][1]
        log(f"TubeSelectProcess split: window_query {sp.seconds['window_query'] * 1e3:.3f} "
            f"ms ({n_cand} candidates fetched), f64 upload "
            f"{sp.seconds['f64 upload'] * 1e3:.3f} ms, device pass "
            f"{sp.seconds['device pass'] * 1e3:.3f} ms (capacity {cap}) of "
            f"{wall * 1e3:.3f} ms (synchronised spans) [{card_s}]")
        profile_calls(torch, "TubeSelectProcess", calls["TubeSelectProcess"],
                      card_s, calls=1)
        by_x = np.argsort(x, kind="stable")
        for name, r in out.items():
            # the oracle over the fill's own samples (LineGapFill adds
            # samples on the track's longer segments)
            tube = fills[name].build(track, TUBE_RADIUS, TUBE_WIN)
            sx, sy, st = tube.x, tube.y, tube.t
            exp = tube_oracle(torch, dev, x, y, t, sx, sy, st, TUBE_RADIUS, TUBE_WIN)
            got = hit_rows(r, x, y, t, by_x)
            assert got is not None, f"{name}: a hit is not a written row"
            bad = off_radius_edge(got, exp, x, y, t, sx, sy, st, TUBE_RADIUS, TUBE_WIN)
            assert bad == 0, f"{name}: {bad} mismatches away from the radius edge"
            log(f"correct: {name} hits ({len(r)}) == the f64 haversine oracle "
                f"over its {len(sx)} samples ({int(exp.sum())}) within the 1 m "
                f"rule ({int((got != exp).sum())} at the radius edge)")
        for name, (cold, warm) in lat.items():
            log(f"{name}: cold {cold * 1e3:.3f} ms, warm p50 {warm * 1e3:.3f} ms, "
                f"{rows / warm:.1f} points/sec, {len(out[name])} hits [{card_s}]")
        codec_phase(torch, dev, src, x, y, t, codes, vocab, card_s)
        a4b_distinct(torch, src, x, y, t, codes, card_s)
        # the f64 pass alone at the process's shapes, for its bound
        g = sp.results["window_query"]
        dv = pt.to_device(g, dev, coord_dtype=torch.float64)
        pargs = (dv["geom__x"], dv["geom__y"], dv["dtg"], dv["__valid__"],
                 torch.from_numpy(tx).to(dev), torch.from_numpy(ty).to(dev),
                 torch.from_numpy(tt).to(dev), TUBE_RADIUS, TUBE_WIN)
        f64_ms = timed_ms(torch, lambda: tb.tube_select_pruned(
            *pargs, tile_capacity=cap if cap > 0 else None), 5)
        margins = tb.tube_margins(ty, TUBE_RADIUS)
        nsel = int(tb.tube_tile_hits(pargs[0], pargs[1], pargs[2], pargs[4], pargs[5],
                                     pargs[6], pargs[8], *margins,
                                     data_tile=tb.PRUNE_TILE).sum())
        pairs = nsel * tb.PRUNE_TILE * TUBE_T
        t_ops = TUBE_OPS * pairs / FP64_OPS_PER_S * 1e3
        t_bytes = n_cand * (8 + 8 + 8 + 1 + 1) / HBM_BYTES_PER_S * 1e3
        b, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        log(f"tube_select_pruned f64 (process shapes): {f64_ms:.3f} ms over "
            f"{n_cand} candidates, {nsel} tiles selected, {pairs} pairs, bound "
            f"{b:.3f} ms by {by} (FP64) [{card_s}]")
        return {"name": "tube_select_pruned f64 (process)",
                "replaces": "geomesa_tpu/engine/tube.py:260",
                "source": "geomesa_tpu_torch/engine/tube.py", "route": "torch",
                "launches": launches["_tube_pruned_call"], "ms": f64_ms,
                "bound_ms": b, "bound_by": by, "pairs": pairs,
                "candidates": n_cand,
                "process_ms": {k: v[1] * 1e3 for k, v in lat.items()}}


# -- KNearestNeighborSearchProcess (phase 9, bench config 3) -------------------

# Operations a (query, point) pair costs, each transcendental counted as
# one (so the bound is a lower bound): the haversine as written
# (engine/geodesy.py) takes 2 subtracts, 2 halvings, 2 sines, 2 squares,
# 2 multiplies (cos * cos * sin^2), 1 add, 2 clamp compares, 1 sqrt, 1 asin
# and 1 scale = 16; knn_mxu's ranking key takes the [Q,4]x[4,N] product's
# 4 multiplies and 3 adds and the block-minimum compare = 8.
KNN_HAV_OPS = 16
KNN_KEY_OPS = 8
KNN_SMALL_STORE = 1 << 19  # below the process's 2^20 planner threshold
KNN_EST_M = 1000.0  # the store route's estimated distance: the loop widens


def neighbour_keys(batch, idx):
    """Each neighbour row's (x, y) as one complex key (row identity that
    does not depend on the batch's row order)."""
    col = batch.columns[batch.sft.default_geometry.name]
    return np.asarray(col.x)[idx] + 1j * np.asarray(col.y)[idx]


def same_rows(ka, kb, qx, qy, tol) -> bool:
    """Identical neighbour rows per query, swaps allowed between rows whose
    f64 distances agree within tol(d) meters."""
    from geomesa_tpu_torch.engine.geodesy import haversine_m_np

    for i in range(len(ka)):
        if set(ka[i].tolist()) == set(kb[i].tolist()):
            continue
        da = np.sort(haversine_m_np(qx[i], qy[i], ka[i].real, ka[i].imag))
        db = np.sort(haversine_m_np(qx[i], qy[i], kb[i].real, kb[i].imag))
        if not np.all(np.abs(da - db) <= tol(np.maximum(da, db))):
            return False
    return True


def within_oracle(d, exp) -> bool:
    """The first queries' sorted distances against the f64 oracle's, under
    the bench's recall rule max(1 m, 1e-4 d64)."""
    got = np.sort(d[:len(exp)], 1)
    return bool(np.all(np.abs(got - exp) <= np.maximum(1.0, 1e-4 * exp)))


def gathered_lanes(torch, gi, index, qx, qy, ring: int, slots: int) -> int:
    """Candidates knn_grid tests over all queries: min(count, slots) of
    every in-grid cell of each query's (2 ring + 1)^2 neighbourhood."""
    g = index.g
    cx, cy = gi._cells(qx, qy, g)
    offs = torch.arange(-ring, ring + 1, device=qx.device)
    ccx = cx[:, None, None] + offs[None, None, :]
    ccy = cy[:, None, None] + offs[None, :, None]
    inside = (ccx >= 0) & (ccx < g) & (ccy >= 0) & (ccy < g)
    cells = torch.where(inside, ccy * g + ccx, torch.zeros_like(ccx)).long()
    cnt = torch.where(inside, index.counts[cells], torch.zeros_like(cells))
    return int(torch.clamp(cnt, max=slots).sum())


def knn_store_route(proc, qb, src, cql, dev):
    """The process over a FeatureSource with impl="auto" from a 1 km
    estimate: (results, latencies, rounds a call, the impls the stats
    chose, the searched radii), with a spy on the planner."""
    planner = src.planner
    chosen, windows = [], []
    choose, pknn = planner._knn_impl_from_stats, planner.knn

    def spy_choose(plan):
        chosen.append(choose(plan))
        return chosen[-1]

    def spy_knn(query, qx, qy, k=10, impl="sparse"):
        windows.append(query)
        return pknn(query, qx, qy, k=k, impl=impl)

    planner._knn_impl_from_stats, planner.knn = spy_choose, spy_knn
    try:
        out, lat = time_calls({"process store auto": lambda: proc.execute(
            qb, src, num_desired=K, estimated_distance_m=KNN_EST_M,
            cql_filter=cql, impl="auto", device=dev)})
    finally:
        del planner._knn_impl_from_stats, planner.knn
    rounds = len(windows) // 6  # 6 calls (1 cold, 5 warm), one knn a round
    radii = [min(KNN_EST_M * 2 ** i, 1e6) for i in range(rounds)]
    return out["process store auto"], lat, rounds, chosen[-rounds:], radii


def knn_engine_routes(torch, dev, x, y, mask, qx, qy, exp, card_s: str):
    """knn, knn_mxu, knn_compact and knn_indexed at the reference bench's
    config-3 shape (f32 coordinates, the north-star mask, Q queries),
    each cold once and warm p50 of 5 (host wall of a synchronised call),
    gated against the f64 oracle; rows for the device_ops line."""
    import geomesa_tpu_torch.engine.grid_index as gi
    import geomesa_tpu_torch.engine.knn as pk
    from geomesa_tpu_torch.utils.padding import next_pow2

    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    dx, dy, tqx, tqy = f32(x), f32(y), f32(qx), f32(qy)
    dm = torch.from_numpy(mask).to(dev)
    n, count = len(x), int(mask.sum())
    cap = max(next_pow2(max(count, 1)), 1024)
    g_edge, slots = gi.auto_grid_params(count)
    res, launches = {}, {}

    def call(name, fn):
        def run():
            out = fn()
            torch.cuda.synchronize()
            res[name] = out
            launches[name] = launches.get(name, 0) + 1
            return out
        return run

    calls = {
        "knn": call("knn", lambda: pk.knn(tqx, tqy, dx, dy, dm, k=K, query_tile=Q)),
        "knn_mxu": call("knn_mxu", lambda: pk.knn_mxu(tqx, tqy, dx, dy, dm, k=K,
                                                      with_flags=True)),
        "knn_compact": call("knn_compact", lambda: pk.knn_compact(
            tqx, tqy, dx, dy, dm, k=K, capacity=cap)),
        "knn_indexed": call("knn_indexed", lambda: gi.knn_indexed(
            tqx, tqy, dx, dy, dm, k=K, g=g_edge, ring_radius=2, cell_slots=slots)),
    }
    _, lat = time_calls(calls)
    index = gi.build_grid_index(dx, dy, dm, g=g_edge)
    grid_flags = int(gi.knn_grid(tqx, tqy, index, K, 2, slots)[2].sum())
    mxu_flags = int(res["knn_mxu"][2].sum())
    overflow = bool(res["knn_compact"][2])
    assert not overflow, "knn_compact overflowed a capacity above the count"
    for name, r in res.items():
        d = r[0].cpu().numpy().astype(np.float64)
        assert d.shape == (Q, K) and np.isfinite(d).all(), name
        assert within_oracle(d, exp), f"{name}: recall outside the bench rule"
    # knn's data tile: the port's block of 2^25 lanes against the
    # reference's 2^27 (sized for a TPU)
    tile_ms = {lanes: timed_ms(torch, lambda: pk.knn(
        tqx, tqy, dx, dy, dm, k=K, query_tile=Q, data_tile=lanes // Q), 1)
        for lanes in (pk.KNN_BLOCK_LANES, 1 << 27)}
    launches["knn"] += 2 * len(tile_ms)  # timed_ms: a warm-up and one run
    lanes_g = gathered_lanes(torch, gi, index, tqx, tqy, 2, slots)
    pairs = {"knn": Q * n, "knn_mxu": Q * n, "knn_compact": Q * count,
             "knn_indexed": lanes_g + grid_flags * n}
    ops = {"knn": KNN_HAV_OPS * pairs["knn"], "knn_mxu": KNN_KEY_OPS * pairs["knn_mxu"],
           "knn_compact": KNN_KEY_OPS * pairs["knn_compact"],
           "knn_indexed": KNN_HAV_OPS * pairs["knn_indexed"]}
    nbytes = {"knn": n * 9, "knn_mxu": n * 9, "knn_compact": n + count * 8,
              "knn_indexed": n * (9 + 12)}
    replaces = {"knn": "geomesa_tpu/engine/knn.py:93",
                "knn_mxu": "geomesa_tpu/engine/knn.py:202",
                "knn_compact": "geomesa_tpu/engine/knn.py:408",
                "knn_indexed": "geomesa_tpu/engine/grid_index.py:264"}
    log(f"correct: knn, knn_mxu, knn_compact and knn_indexed (f32, N={n}, "
        f"{count} matches, Q={Q}, k={K}) within the bench rule of the f64 "
        f"oracle on 16 queries; knn_mxu flagged {mxu_flags} of {Q} queries "
        f"uncertain, knn_grid {grid_flags} (g={g_edge}, {slots} slots, ring 2, "
        f"{lanes_g} candidates gathered); knn_compact capacity {cap}, no overflow")
    for lanes, ms in tile_ms.items():
        log(f"knn data tile {lanes // Q} ({lanes} lanes a block): {ms:.3f} ms "
            f"[{card_s}]")
    rows = []
    for name, (cold, warm) in lat.items():
        b, by = roofline_ms(ops[name], nbytes[name])
        log(f"{name}: cold {cold * 1e3:.3f} ms, warm p50 {warm * 1e3:.3f} ms, "
            f"{n / warm:.1f} points/sec, {pairs[name]} pairs, bound {b:.3f} ms "
            f"by {by} [{card_s}]")
        src = ("geomesa_tpu_torch/engine/grid_index.py" if name == "knn_indexed"
               else "geomesa_tpu_torch/engine/knn.py")
        rows.append({"name": name, "replaces": replaces[name], "source": src,
                     "route": "torch", "launches": launches[name], "ms": warm * 1e3,
                     "cold_ms": cold * 1e3, "bound_ms": b, "bound_by": by,
                     "pairs": pairs[name]})
    rows[0]["data_tile_ms"] = {str(k // Q): v for k, v in tile_ms.items()}
    rows[1]["flagged"] = mxu_flags
    rows[3]["flagged"] = grid_flags
    return rows


def small_store(torch, dev, tmp: str, rows: int, seed: int):
    """A cached store of `rows` rows from phase 4's distributions."""
    from geomesa_tpu_torch import DataStore, FeatureBatch, SimpleFeatureType

    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    order = morton_order(torch, torch.from_numpy(x).to(dev),
                         torch.from_numpy(y).to(dev))
    x, y = x[order], y[order]
    t = rng.integers(1_590_000_000_000, 1_600_000_000_000, rows)
    speed = rng.uniform(0, 30, rows)
    ds = DataStore(tmp, use_device_cache=True, device=dev)
    sft = SimpleFeatureType.from_spec("gdelt", "speed:Double,dtg:Date,*geom:Point")
    src = ds.create_schema(sft)
    src.write(FeatureBatch.from_pydict(
        sft, {"speed": speed, "dtg": t, "geom": np.stack([x, y], 1)}))
    return src, x, y, t, speed


def knn_process_phase(torch, ks, dev, src, tmp: str, a: dict, planner_run,
                      ingest: dict, card_s: str):
    """Phase 9: KNearestNeighborSearchProcess over phase 4's arrays as a
    materialized batch (sparse, fullscan, auto) and over phase 4's store
    (auto, widening from 1 km), the haversine route over a 2^19-row store,
    and the engine routes; gated; returns the engine rows."""
    import geomesa_tpu_torch.process.knn as pknn
    from geomesa_tpu_torch import FeatureBatch, Query, SimpleFeatureType
    from geomesa_tpu_torch.engine.geodesy import haversine_m_np
    from geomesa_tpu_torch.process import KNearestNeighborSearchProcess

    x, y, qx, qy, cql, exp = a["x"], a["y"], a["qx"], a["qy"], a["cql"], a["exp"]
    rows = len(x)
    kernels = (ks.chord_blockmin, ks.chord_blockmin_sparse)
    for w in kernels:
        w.launches = 0
    sft = SimpleFeatureType.from_spec("gdelt", "speed:Double,dtg:Date,*geom:Point")
    batch = FeatureBatch.from_pydict(
        sft, {"speed": a["speed"], "dtg": a["t"], "geom": np.stack([x, y], 1)})
    qb = FeatureBatch.from_pydict(SimpleFeatureType.from_spec("q", "*geom:Point"),
                                  {"geom": np.stack([qx, qy], 1)})
    proc = KNearestNeighborSearchProcess()
    calls = {f"process batch {impl}": (lambda impl=impl: proc.execute(
        qb, batch, num_desired=K, cql_filter=cql, impl=impl, device=dev))
        for impl in ("sparse", "fullscan", "auto")}
    with Spans(torch, [(pknn, "knn_sparse_auto", "sparse"),
                       (pknn, "knn_fullscan_tiled", "fullscan")]) as sp:
        out, lat = time_calls(calls)
    assert sp.calls == {"sparse": 12, "fullscan": 6}, (
        f"auto did not resolve to sparse: {sp.calls}")
    pd, pi, pbatch = planner_run
    pkeys = neighbour_keys(pbatch, pi)
    for name, r in out.items():
        d = r.distances_m
        assert d.shape == (Q, K) and np.isfinite(d).all(), name
        assert not r.partial_recall, name
        assert within_oracle(d, exp), f"{name}: recall outside the bench rule"
        assert same_rows(neighbour_keys(r.features, r.indices), pkeys, qx, qy,
                         ks.knn_f32_err_m), f"{name}: rows differ from src.knn"

    # the store route: the widen loop over phase 4's store, auto
    res, slat, rounds, chosen, radii = knn_store_route(proc, qb, src, cql, dev)
    out["process store auto"] = res
    lat.update(slat)
    kth = res.distances_m[:, -1]
    assert not res.partial_recall, "the store route flagged partial recall"
    assert np.all(kth <= radii[-1]), "a k-th neighbour beyond the final radius"
    assert within_oracle(res.distances_m, exp), "store route: recall"
    assert same_rows(neighbour_keys(res.features, res.indices), pkeys, qx, qy,
                     lambda d: np.full_like(d, 1e-6)), "store route rows differ"
    plan = src.planner.plan(Query("gdelt", cql))
    est = src.planner._stats_estimate(plan.bbox, plan.interval)
    bx = BBOX
    true_win = int(((x >= bx[0]) & (x <= bx[2]) & (y >= bx[1]) & (y <= bx[3])
                    & (a["t"] > T0) & (a["t"] < T1)).sum())
    assert est is not None and est >= true_win, (est, true_win)
    launches = {w.__name__: w.launches for w in kernels}
    log(f"knn process launches: {launches} over 6 calls of each batch route "
        "and 6 store-route calls")
    assert all(launches.values()), "B1 or B2 never launched in phase 9"
    log(f"knn process store route: {rounds} rounds a call, radii "
        f"{[f'{r:.0f}' for r in radii]} m, the stats chose {chosen}; "
        f"north-star window: sketch estimate {est} >= true count {true_win}")

    # the haversine route: a 2^19-row store takes the window path, f64 knn
    small, sx, sy, st, sspeed = small_store(torch, dev, tmp + "/small",
                                            KNN_SMALL_STORE, 43)
    with Spans(torch, [(pknn, "window_query", "window_query"),
                       (pknn, "knn", "knn")]) as hs:
        hout, hlat = time_calls({"process store haversine": lambda: proc.execute(
            qb, small, num_desired=K, cql_filter=cql, impl="auto", device=dev)})
    hres = hout["process store haversine"]
    out.update(hout)
    lat.update(hlat)
    assert hs.calls["knn"] >= 6, f"the f64 knn did not run: {hs.calls}"
    feats = hres.features
    fx = np.asarray(feats.geometry.x)
    fy = np.asarray(feats.geometry.y)
    for i in range(Q):
        d64 = haversine_m_np(qx[i], qy[i], fx, fy)
        top = np.argsort(d64, kind="stable")[:K]
        assert np.all(np.abs(hres.distances_m[i] - d64[top]) <= 1e-6), i
        assert set(hres.indices[i].tolist()) == set(top.tolist()), i
    sm = ((sx >= bx[0]) & (sx <= bx[2]) & (sy >= bx[1]) & (sy <= bx[3])
          & (st > T0) & (st < T1) & (sspeed > 5.0))
    assert within_oracle(hres.distances_m, oracle_knn(sx, sy, sm, qx[:16],
                                                      qy[:16], K)), "haversine"
    log(f"correct: process batch sparse, fullscan and auto (-> sparse) and the "
        f"store route return src.knn's neighbour rows, all within the bench "
        f"rule on 16 queries; the haversine route ({hs.calls['window_query'] // 6} "
        f"rounds a call, {len(feats)} candidates in the last window) equals an "
        f"f64 NumPy haversine over its candidates within 1e-6 m, same rows")

    for name, (cold, warm) in lat.items():
        n = KNN_SMALL_STORE if name.endswith("haversine") else rows
        log(f"{name}: cold {cold * 1e3:.3f} ms, warm p50 {warm * 1e3:.3f} ms, "
            f"{n / warm:.1f} points/sec (Q={Q}, k={K}) [{card_s}]")
    profile_calls(torch, "process batch sparse", calls["process batch sparse"],
                  card_s)
    profile_calls(torch, "process store auto", lambda: proc.execute(
        qb, src, num_desired=K, estimated_distance_m=KNN_EST_M, cql_filter=cql,
        impl="auto", device=dev), card_s, calls=1)
    engine = knn_engine_routes(torch, dev, x, y, a["mask"], qx, qy, exp, card_s)
    PHASES["knn process"] = {
        "calls": {name: {"cold_s": c, "warm_p50_s": w,
                         "points_per_s": (KNN_SMALL_STORE if name.endswith(
                             "haversine") else rows) / w}
                  for name, (c, w) in lat.items()},
        "ingest_s": ingest["ingest_s"], "stats_update_s": ingest["stats_s"],
        "store_rounds": rounds, "store_radii_m": radii, "stats_chose": chosen,
        "sketch_estimate": est, "window_true_count": true_win,
        "launches": launches,
        "engine_ms": {r["name"]: r["ms"] for r in engine}}
    return engine


# -- the serve stack (phase 12) -----------------------------------------------

SERVE_KNN = 256  # deterministic single-point kNN requests (4 windows of 64)
SERVE_FULL = 64  # impl="fullscan" requests (one window)
# B1 launches a (filter, k) spends on calibration: a key with no cached
# sparse capacity counts its match tiles in torch (count_match_tiles)
# before its first launch, so calibration adds no B1 launch. The phase
# counts the keys it calibrated (phase 4 has already cached this one).
CALIBRATION_B1 = 0
SERVE_OOM = 8  # requests of the injected-OOM window (halved down to 1 each)
SERVE_LOAD_S = 5.0
SERVE_PROFILE_S = 1.0
OOM_COUNTERS = ("serve.oom.halved", "serve.oom.hosteval", "serve.oom.failed")


def serve_requests(make, n, impl="sparse"):
    reqs = [make(i) for i in range(n)]
    for r in reqs:
        r.impl = impl
    return reqs


def device_busy(torch, fn):
    """(wall ms, device busy ms) of one call of fn under torch.profiler:
    the kernels' device self times summed (phase 4's idle-share rule)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0.0))
    busy_us = sum(dev_us(e) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall_ms, busy_us / 1e3


def serve_phase(torch, ks, dev, ds, src, a: dict, card_s: str) -> dict:
    """Phase 12: the serve stack over phase 4's store (module docstring,
    12). Returns the {"serve": ...} numbers; B1's, B2's and B3's launches
    in the phase ride along under "launches"."""
    from geomesa_tpu_torch import Query, QueryHints
    from geomesa_tpu_torch.engine import density_zsparse as dz
    from geomesa_tpu_torch.engine.density import grid_consts
    from geomesa_tpu_torch.serve import (
        QueryService, ServeConfig, ServeRequest, knn_request_factory,
        run_closed_loop, run_sustained, serve_lines)
    from geomesa_tpu_torch.serve.protocol import _rows_json
    from geomesa_tpu_torch.utils.metrics import metrics

    x, y, t, speed, cql = a["x"], a["y"], a["t"], a["speed"], a["cql"]
    kernels = {"chord_blockmin_sparse": ks.chord_blockmin_sparse,
               "chord_blockmin": ks.chord_blockmin,
               "zsparse_counts": dz.zsparse_counts}
    used = {n: 0 for n in kernels}

    def reset():
        for w in kernels.values():
            w.launches = 0

    def read():
        got = {n: w.launches for n, w in kernels.items()}
        for n, v in got.items():
            used[n] += v
        return got

    def oom():
        with metrics._lock:
            return {k: metrics.counters.get(k, 0) for k in OOM_COUNTERS}

    oom0 = oom()
    # max_queue holds the 320 requests queued before the first release
    cfg = dict(pipeline=False, ring=False, max_batch=64, max_wait_ms=2.0,
               max_queue=1024)
    services = []

    def service():
        svc = QueryService(ds, ServeConfig(**cfg), autostart=False)
        services.append(svc)
        return svc

    make = knn_request_factory("gdelt", cql, extent=(20.0, 60.0), k=K, seed=0)
    resident = len(src.planner.cache.superbatch().batch)
    out = {"card": card_s, "resident_rows": resident}
    try:
        # -- deterministic windows: queued, then released ------------------
        svc = service()
        reqs = serve_requests(make, SERVE_KNN) + serve_requests(
            make, SERVE_FULL, "fullscan")
        reset()
        audit0 = len(ds.audit.events)
        caps0 = set(src.planner._knn_caps)
        futs = [svc.submit(r) for r in reqs]
        t0 = time.perf_counter()
        svc.start()
        served = [f.result(timeout=300) for f in futs]
        torch.cuda.synchronize()
        win_s = time.perf_counter() - t0
        wl = read()
        calibrated = len(set(src.planner._knn_caps) - caps0)
        st = svc.stats()
        n = len(reqs)
        log(f"serve windows: {n} kNN requests ({SERVE_KNN} sparse, {SERVE_FULL} "
            f"fullscan) in {st['dispatches']} dispatches, {win_s * 1e3:.3f} ms; "
            f"launches {wl}; {calibrated} (filter, k) calibrated [{card_s}]")
        assert st["dispatches"] == SERVE_KNN // 64 + SERVE_FULL // 64, st
        # one B1 launch a sparse window of 64 and one B2 launch for the
        # fullscan window: an overflow's fallback would add a B2 launch
        assert wl["chord_blockmin_sparse"] == (
            SERVE_KNN // 64 + CALIBRATION_B1 * calibrated), wl
        assert wl["chord_blockmin"] == SERVE_FULL // 64, wl
        spans = sorted({e.exec_ms for e in ds.audit.events[audit0:]
                        if type(e).__name__ == "ServeEvent"})
        # serial == served: each request against src.knn on its own point
        t0 = time.perf_counter()
        for r, (d, i, batch) in zip(reqs, served):
            sd, si, _ = src.knn(cql, r.qx, r.qy, k=K, impl=r.impl)
            assert d.shape == (1, K) and np.isfinite(d).all()
            assert same_neighbours(i, d, si, sd), "served kNN != src.knn"
            assert np.array_equal(np.sort(d, 1), np.sort(sd, 1)), "meters differ"
        serial_s = time.perf_counter() - t0
        log(f"correct: {n} served kNN results == src.knn on the same point "
            f"(neighbour rows, meters bit-identical); {n} serial calls took "
            f"{serial_s * 1e3:.3f} ms, the served windows {win_s * 1e3:.3f} ms "
            f"[{card_s}]")
        out["windows"] = {"requests": n, "dispatches": st["dispatches"],
                          "wall_ms": win_s * 1e3, "serial_wall_ms": serial_s * 1e3,
                          "dispatch_span_ms": spans, "launches": wl,
                          "calibrated": calibrated}

        # -- dedup: 64 identical counts, 8 identical feature executes -------
        m = ((x >= BBOX[0]) & (x <= BBOX[2]) & (y >= BBOX[1]) & (y <= BBOX[3])
             & (t > T0) & (t < T1) & (speed > 5.0))
        exp_count = int(m.sum())
        bx = FEATURE_BBOX
        fcql = (f"BBOX(geom, {bx[0]}, {bx[1]}, {bx[2]}, {bx[3]}) AND dtg DURING "
                f"{iso(T0)}/{iso(T1)} AND speed > 5.0")
        q_lim = Query("gdelt", fcql, attributes=["speed", "dtg", "geom"],
                      sort_by=[("dtg", False)], max_features=FEATURE_LIMIT)
        svc = service()
        cf = [svc.count("gdelt", cql) for _ in range(64)]
        ef = [svc.submit(ServeRequest(kind="execute", query=q_lim))
              for _ in range(8)]
        svc.start()
        counts = [f.result(timeout=300) for f in cf]
        execs = [f.result(timeout=300) for f in ef]
        st = svc.stats()
        assert st["dispatches"] == 2, st
        assert counts == [src.get_count(cql)] * 64 == [exp_count] * 64, counts[:2]
        direct = src.get_features(q_lim).features
        for r in execs:
            assert r is execs[0]
            f = r.features
            for col in ("speed", "dtg"):
                assert np.array_equal(np.asarray(f.columns[col]),
                                      np.asarray(direct.columns[col])), col
            assert np.array_equal(f.geometry.x, direct.geometry.x)
        log(f"correct: 64 counts in one dispatch == src.count == f64 count "
            f"{exp_count}; 8 feature executes in one dispatch == phase 7's "
            f"{len(direct)} rows")

        # -- the JSON-lines wire ------------------------------------------
        pts = np.random.default_rng(12).uniform(20.0, 60.0, (8, 2))
        dens = {"bbox": list(BBOX), "width": GRID, "height": GRID}
        docs = [{"id": "c", "op": "count", "typeName": "gdelt", "cql": cql},
                {"id": "k", "op": "knn", "typeName": "gdelt", "cql": cql,
                 "x": pts[:, 0].tolist(), "y": pts[:, 1].tolist(), "k": K},
                {"id": "q", "op": "query", "typeName": "gdelt", "cql": fcql,
                 "maxFeatures": 100},
                {"id": "d", "op": "query", "typeName": "gdelt", "cql": cql,
                 "density": dens},
                {"id": "t", "op": "knn", "typeName": "gdelt", "cql": cql,
                 "x": [30.0], "y": [40.0], "k": K, "timeoutMs": 1}]
        wsvc = service()

        def lines():
            for d in docs:
                yield json.dumps(d)
            time.sleep(0.01)  # the 1 ms budget expires while queued
            wsvc.start()

        reset()
        wire_out = []
        t0 = time.perf_counter()
        serve_lines(ds, lines(), wire_out.append, service=wsvc)
        wire_s = time.perf_counter() - t0
        wwl = read()
        resp = {d["id"]: d for d in map(json.loads, wire_out)}
        assert wwl["zsparse_counts"] >= 1, f"the wire's density never launched B3: {wwl}"
        assert resp["c"]["count"] == exp_count
        kd, ki, _ = src.knn(cql, pts[:, 0], pts[:, 1], k=K)
        assert resp["k"]["dists"] == kd.tolist() and resp["k"]["indices"] == ki.tolist()
        qd = src.get_features(Query("gdelt", fcql, max_features=100)).features
        assert resp["q"]["features"] == _rows_json(qd, 100)
        assert resp["t"]["error"] == "timeout", resp["t"]
        gq = Query("gdelt", cql, hints=QueryHints(
            density_bbox=BBOX, density_width=GRID, density_height=GRID))
        grid = src.get_features(gq).grid
        x32, y32 = x.astype(np.float32), y.astype(np.float32)
        f32 = np.float32
        m32 = ((x32 >= f32(BBOX[0])) & (x32 <= f32(BBOX[2])) & (y32 >= f32(BBOX[1]))
               & (y32 <= f32(BBOX[3])) & (t > T0) & (t < T1) & (speed > 5.0))
        xmin, dx, ymin, dy = grid_consts(BBOX, GRID, GRID)
        col = np.floor((x32 - xmin) / dx)
        row = np.floor((y32 - ymin) / dy)
        inb = m32 & (col >= 0) & (col < GRID) & (row >= 0) & (row < GRID)
        exp_grid = np.bincount(row[inb].astype(np.int64) * GRID
                               + col[inb].astype(np.int64),
                               minlength=GRID * GRID).reshape(GRID, GRID)
        assert np.array_equal(grid, exp_grid), "density grid != NumPy binning"
        assert resp["d"]["shape"] == [GRID, GRID]
        assert resp["d"]["total"] == float(grid.sum())
        assert resp["d"]["count"] == int(m32.sum())
        log(f"correct: the wire's count, kNN (8 points), query (100 rows) and "
            f"density ({GRID}x{GRID}, B3 launched {wwl['zsparse_counts']}x; grid "
            f"== NumPy binning) answers == the direct calls; timeoutMs 1 "
            f"answered {resp['t']['error']} ({resp['t']['phase']}); "
            f"{len(docs)} lines in {wire_s * 1e3:.3f} ms [{card_s}]")
        out["wire"] = {"lines": len(docs), "wall_ms": wire_s * 1e3,
                       "timeout_phase": resp["t"]["phase"], "launches": wwl}

        # -- load: closed loop (8 clients), then 64 outstanding -------------
        lsvc = service()
        lsvc.start()
        reset()
        audit0 = len(ds.audit.events)
        load = {}
        for mode, run in (
                ("closed_8", lambda: run_closed_loop(
                    lsvc, make, concurrency=8, duration_s=SERVE_LOAD_S)),
                ("sustained_64", lambda: run_sustained(
                    lsvc, make, duration_s=SERVE_LOAD_S, max_outstanding=64,
                    points_per_query=resident))):
            b1 = ks.chord_blockmin_sparse.launches
            rep = run()
            b1 = ks.chord_blockmin_sparse.launches - b1
            assert rep.ok > 0 and rep.errors == 0 and rep.timeouts == 0, rep
            assert rep.dispatches < rep.ok, rep
            win = (rep.coalesced + rep.dispatches) / rep.dispatches
            load[mode] = {
                "served_qps": rep.throughput_qps, "ok": rep.ok,
                "p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms, "max_ms": rep.max_ms,
                "windows": rep.dispatches, "mean_window": win,
                "b1_launches_per_request": b1 / rep.ok,
                "points_per_s": resident * rep.throughput_qps,
                # serve.device.ops a window (run_sustained counts it)
                "device_ops_per_window": (rep.dispatches_per_window
                                          if mode == "sustained_64" else None)}
            log(f"serve {mode}: {rep.throughput_qps:.1f} served qps, p50 "
                f"{rep.p50_ms:.3f} ms, p99 {rep.p99_ms:.3f} ms, {rep.dispatches} "
                f"windows of {win:.2f} on average, {b1 / rep.ok:.4f} B1 launches "
                f"a request, {resident * rep.throughput_qps:.4g} points/s "
                f"({resident} resident rows x served qps) [{card_s}]")
        for mode, outstanding in (("closed_8", None), ("sustained_64", 64)):
            if outstanding is None:
                fn = lambda: run_closed_loop(  # noqa: E731
                    lsvc, make, concurrency=8, duration_s=SERVE_PROFILE_S)
            else:
                fn = lambda: run_sustained(  # noqa: E731
                    lsvc, make, duration_s=SERVE_PROFILE_S,
                    max_outstanding=outstanding)
            wall_ms, busy_ms = device_busy(torch, fn)
            load[mode]["idle_share"] = max(0.0, 1 - busy_ms / wall_ms)
            log(f"serve {mode} under torch.profiler ({SERVE_PROFILE_S:g} s): "
                f"device busy {busy_ms:.3f} of {wall_ms:.3f} ms, idle share "
                f"{load[mode]['idle_share']:.3f} [{card_s}]")
        out["load"] = load
        read()
    finally:
        for svc in services:  # each has answered all it admitted
            svc.close(drain=False, timeout_s=5.0)
    failed = sum(svc.stats().get("failed", 0) for svc in services)
    oom1 = oom()
    delta = {k: oom1[k] - oom0[k] for k in oom0}
    out["oom"] = delta
    out["failed"] = failed
    assert failed == 0 and not any(delta.values()), (failed, delta)
    out["launches"] = used
    log(f"serve phase: launches {used}, serve.oom.* {delta}, errors {failed}")
    out["oom_injected"] = injected_oom(torch, ds, src, make, oom, card_s)
    return out


def injected_oom(torch, ds, src, make, oom, card_s: str,
                 pipelined: bool = False) -> dict:
    """An OOM on the card, injected: the planner's knn_launch raises
    torch.OutOfMemoryError for one window of SERVE_OOM requests, on the
    serial route or the pipelined one. The ladder halves it down to
    single requests, and each then fails with a typed DeviceOOM: no
    request is evaluated on the host."""
    from geomesa_tpu_torch.faults import DeviceOOM, classify
    from geomesa_tpu_torch.serve import QueryService, ServeConfig

    def launch_oom(*a, **kw):
        raise torch.OutOfMemoryError("injected: CUDA out of memory")

    svc = QueryService(ds, ServeConfig(max_batch=64, max_wait_ms=2.0,
                                       pipeline=pipelined, ring=False),
                       autostart=False)
    before = oom()
    src.planner.knn_launch = launch_oom  # the instance's, over the class's
    try:
        futs = [svc.submit(r) for r in serve_requests(make, SERVE_OOM)]
        svc.start()
        typed = sum(isinstance(e, DeviceOOM) and classify(e) == "oom"
                    for e in (f.exception(timeout=60) for f in futs))
    finally:
        del src.planner.knn_launch
        svc.close(drain=False, timeout_s=5.0)
    after = oom()
    got = {k: after[k] - before[k] for k in before}
    route = "pipelined" if pipelined else "serial"
    log(f"serve injected OOM ({route}): {SERVE_OOM} requests, {typed} failed "
        f"with a typed DeviceOOM; serve.oom.* {got} [{card_s}]")
    assert typed == SERVE_OOM, typed
    assert got == {"serve.oom.halved": SERVE_OOM - 1, "serve.oom.hosteval": 0,
                   "serve.oom.failed": SERVE_OOM}, got
    # the failed futures' tracebacks hold the store in a reference cycle:
    # collect it now, so that phase 4's store does not outlive its phase
    del futs
    gc.collect()
    return dict(got, requests=SERVE_OOM, device_oom=typed)


# -- the serve stack's device half (phase 13) ---------------------------------

DEV_KNN = 1024  # single-point kNN requests of the north-star filter (16 windows)
DEV_FULL = 64  # impl="fullscan" requests (one window)
DEV_COUNTS = 64  # counts fused onto one pipelined kNN window
DEV_WINDOW = 64
DEV_STALE_ROWS = 1 << 20  # rows of the staleness store (phase 9's small_store)
DEV_STALE_WRITE = 4096  # rows the write adds
DEV_LOAD_S = 5.0
DEV_ROUTES = {"serial": dict(pipeline=False, ring=False),
              "pipelined": dict(ring=False), "ring": {}}


def serve_device_phase(torch, ks, dev, ds, src, a: dict, serial_load: dict,
                       tmp: str, card_s: str) -> dict:
    """Phase 13: the serve stack's device half over phase 4's store (module
    docstring, 13). Returns the {"serve_device": ...} numbers; B1's and
    B2's window launches in the phase ride along under "launches"."""
    from geomesa_tpu_torch.compilecache.manifest import QueryEntry, WarmupManifest
    from geomesa_tpu_torch.compilecache.registry import registry
    from geomesa_tpu_torch.compilecache.warmup import compile_counts
    from geomesa_tpu_torch.plan.audit import ServeEvent
    from geomesa_tpu_torch.serve import (
        QueryService, ServeConfig, knn_request_factory, run_closed_loop,
        run_sustained)
    from geomesa_tpu_torch.serve.loadgen import device_ops_count
    from geomesa_tpu_torch.utils.metrics import metrics

    cql = a["cql"]
    kernels = {"chord_blockmin_sparse": ks.chord_blockmin_sparse,
               "chord_blockmin": ks.chord_blockmin}
    used = {n: 0 for n in kernels}

    def reset():
        for w in kernels.values():
            w.launches = 0

    def read():
        got = {n: w.launches for n, w in kernels.items()}
        for n, v in got.items():
            used[n] += v
        return got

    def oom():
        with metrics._lock:
            return {k: metrics.counters.get(k, 0) for k in OOM_COUNTERS}

    oom0 = oom()
    base = dict(max_batch=DEV_WINDOW, max_wait_ms=2.0, max_queue=2048)
    services = []

    def service(**cfg):
        svc = QueryService(ds, ServeConfig(**{**base, **cfg}), autostart=False)
        services.append(svc)
        return svc

    make = knn_request_factory("gdelt", cql, extent=(20.0, 60.0), k=K, seed=0)
    resident = len(src.planner.cache.superbatch().batch)
    out = {"card": card_s, "resident_rows": resident}
    t_phase = time.perf_counter()
    try:
        # -- the three routes over 16 windows of 64, then one fullscan -----
        routes, answers, rec = {}, {}, None
        for route, cfg in DEV_ROUTES.items():
            svc = service(**cfg)
            if route == "ring":
                rec = svc.record_warmup()
            arm0 = dict(registry.stats()["arm_launches"])
            got, wl = {}, {}
            for impl, n in (("sparse", DEV_KNN), ("fullscan", DEV_FULL)):
                reqs = serve_requests(make, n, impl)
                reset()
                audit0 = len(ds.audit.events)
                futs = [svc.submit(r) for r in reqs]
                t0 = time.perf_counter()
                if not svc._worker:
                    svc.start()
                got[impl] = (reqs, [f.result(timeout=300) for f in futs])
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                wl[impl] = read()
                ev = [e for e in ds.audit.events[audit0:]
                      if isinstance(e, ServeEvent)]
                # a window's span (its members share it): first and median
                spans = list(dict.fromkeys(e.exec_ms for e in ev))
                routes.setdefault(route, {})[impl] = {
                    "requests": n, "wall_ms": wall_ms, "launches": wl[impl],
                    "window_exec_ms_first": spans[0],
                    "window_exec_ms_p50": statistics.median(spans),
                    "compile_ms": max(e.compile_ms for e in ev)}
            st = svc.stats()
            arm = {k: v - arm0.get(k, 0)
                   for k, v in registry.stats()["arm_launches"].items()}
            routes[route]["dispatches"] = st["dispatches"]
            routes[route]["arm_launches"] = arm
            routes[route]["pipeline"] = st.get("pipeline")
            sp = routes[route]["sparse"]
            log(f"serve route {route}: {DEV_KNN} sparse + {DEV_FULL} fullscan "
                f"kNN requests in {st['dispatches']} windows "
                f"({sp['wall_ms']:.3f} + {routes[route]['fullscan']['wall_ms']:.3f} "
                f"ms; a sparse window's span first {sp['window_exec_ms_first']:.3f}, "
                f"p50 {sp['window_exec_ms_p50']:.3f} ms, stall {sp['compile_ms']:.3f} "
                f"ms); window launches {wl}; arm launches {arm} [{card_s}]")
            assert st["dispatches"] == DEV_KNN // DEV_WINDOW + DEV_FULL // DEV_WINDOW, st
            # exactly one B1 launch a sparse window and one B2 launch for
            # the fullscan window: counted per replay on the ring, and the
            # ring's arm (warm-up run and captures) counted apart
            assert wl["sparse"] == {"chord_blockmin_sparse": DEV_KNN // DEV_WINDOW,
                                    "chord_blockmin": 0}, wl
            assert wl["fullscan"] == {"chord_blockmin_sparse": 0,
                                      "chord_blockmin": DEV_FULL // DEV_WINDOW}, wl
            if route == "ring":
                ring = st["pipeline"]["ring"]
                assert ring["armed"] == 2 and ring["programs"] == 2, ring
                assert ring["fallbacks"] == {}, ring
                assert ring["windows"] == st["dispatches"], ring
                # the sparse and the fullscan class of one filter share one
                # frozen mask and its padded columns
                mine = [c for c in registry.held()
                        if c.owner_id == id(src.planner)]
                assert len(mine) == 2, [c.name for c in mine]
                assert len({id(c.frozen) for c in mine}) == 1
                routes[route]["held_bytes"] = registry.stats()["held_bytes"]
                log(f"ring captures held: {len(mine)} over one frozen mask, "
                    f"{routes[route]['held_bytes']} bytes held [{card_s}]")
            answers[route] = got
        # bit-identical across the three routes (indices and meters)
        for impl in ("sparse", "fullscan"):
            base_res = answers["serial"][impl][1]
            for route in ("pipelined", "ring"):
                for (d, i, _), (sd, si, _) in zip(answers[route][impl][1], base_res):
                    assert np.array_equal(i, si) and np.array_equal(d, sd), (route, impl)
        # every 16th request against src.knn on its own point
        reqs, res = answers["ring"]["sparse"]
        for j in range(0, DEV_KNN, DEV_KNN // 64):
            d, i, _ = res[j]
            sd, si, _ = src.knn(cql, reqs[j].qx, reqs[j].qy, k=K)
            assert d.shape == (1, K) and np.isfinite(d).all()
            assert same_neighbours(i, d, si, sd), "served kNN != src.knn"
            assert np.array_equal(np.sort(d, 1), np.sort(sd, 1)), "meters differ"
        log(f"correct: {DEV_KNN + DEV_FULL} kNN answers bit-identical over the "
            f"serial, pipelined and ring routes; 64 == src.knn on their own "
            f"point (neighbour rows, meters bit-identical); ring: 2 programs "
            f"armed, 0 fallbacks [{card_s}]")
        out["routes"] = routes

        # -- counts fused onto a pipelined kNN window ----------------------
        svc = service(ring=False)
        kf = [svc.submit(r) for r in serve_requests(make, DEV_WINDOW)]
        cf = [svc.count("gdelt", cql) for _ in range(DEV_COUNTS)]
        svc.start()
        for f in kf:
            f.result(timeout=300)
        counts = [f.result(timeout=300) for f in cf]
        st = svc.stats()
        exp_count = src.get_count(cql)
        assert counts == [exp_count] * DEV_COUNTS, counts[:2]
        assert st["pipeline"]["fused_counts"] == DEV_COUNTS, st["pipeline"]
        assert st["dispatches"] == 1, st
        log(f"correct: {DEV_COUNTS} counts fused onto one pipelined kNN window "
            f"== src.count {exp_count}, no dispatch of their own")
        out["fused"] = {"counts": DEV_COUNTS, "dispatches": st["dispatches"],
                        "count": exp_count}

        # -- warm-up: record, save, replay on a new service, check ---------
        path = f"{tmp}/serve_warmup.json"
        manifest = rec.manifest()
        manifest.save(path)
        kinds = {}
        for e in manifest.kernel_entries:
            kinds[e.kind_of] = kinds.get(e.kind_of, 0) + 1
        registry.clear()  # a fresh process holds no capture
        b0, c0 = compile_counts()
        t0 = time.perf_counter()
        wsvc = service(warmup_manifest=path)
        replay_s = time.perf_counter() - t0
        b1, c1 = compile_counts()
        report = wsvc.warmup(path, check=True)
        assert report.ok and report.residual_recompiles == 0, report
        audit0 = len(ds.audit.events)
        first = [wsvc.submit(r) for r in serve_requests(make, DEV_WINDOW)]
        wsvc.start()
        for f in first:
            f.result(timeout=300)
        ev = [e for e in ds.audit.events[audit0:] if isinstance(e, ServeEvent)]
        assert ev and all(e.compile_ms == 0 and not e.compiled for e in ev), [
            (e.compiled, e.compile_ms) for e in ev[:2]]
        log(f"warm-up: manifest of {len(manifest)} entries ({kinds} kernel, "
            f"{len(manifest.query_entries)} query); replay on a new service "
            f"{replay_s:.3f} s ({b1 - b0} builds, {c1 - c0} captures); "
            f"check: ok, {report.residual_recompiles} new builds + captures; "
            f"first window after it compiled={ev[0].compiled!r} "
            f"compile_ms={ev[0].compile_ms} [{card_s}]")
        out["warmup"] = {"entries": len(manifest), "kernel_entries": kinds,
                         "replay_s": replay_s, "replay_builds": b1 - b0,
                         "replay_captures": c1 - c0,
                         "residual": report.residual_recompiles,
                         "first_window_compile_ms": ev[0].compile_ms}

        # -- staleness on a small store --------------------------------------
        small_store(torch, dev, f"{tmp}/stale", DEV_STALE_ROWS, seed=13)
        out["stale"] = stale_check(dev, f"{tmp}/stale", cql, base, card_s)

        # -- load: pipelined and ring, closed loop and sustained ----------
        load = {}
        # every Q bucket a load window can pad to, warmed through the
        # warm-up contract: no capture runs under load (or the profiler)
        buckets = WarmupManifest([
            QueryEntry("knn", "gdelt", cql, q=q, k=K, impl="sparse")
            for q in (8, 16, 32, 64)])
        for route in ("pipelined", "ring"):
            lsvc = service(**DEV_ROUTES[route])
            assert lsvc.warmup(buckets).ok
            captures0 = registry.stats()["captures"]
            lsvc.start()
            for mode in ("closed_8", "sustained_64"):
                pipe = lsvc.pipeline
                pipe.reset_max_inflight()
                st0 = lsvc.stats()
                ops0 = device_ops_count()
                b1 = ks.chord_blockmin_sparse.launches
                if mode == "closed_8":
                    rep = run_closed_loop(lsvc, make, concurrency=8,
                                          duration_s=DEV_LOAD_S)
                else:
                    rep = run_sustained(lsvc, make, duration_s=DEV_LOAD_S,
                                        max_outstanding=64,
                                        points_per_query=resident)
                b1 = ks.chord_blockmin_sparse.launches - b1
                st1 = lsvc.stats()
                assert rep.ok > 0 and rep.errors == 0 and rep.timeouts == 0, rep
                windows = (st1.get("pipelined_windows", 0)
                           - st0.get("pipelined_windows", 0))
                p0, p1 = st0["pipeline"], st1["pipeline"]
                ring0 = (p0.get("ring") or {}).get("windows", 0)
                ring1 = (p1.get("ring") or {}).get("windows", 0)
                row = {
                    "served_qps": rep.throughput_qps, "ok": rep.ok,
                    "p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms,
                    "max_ms": rep.max_ms, "windows": windows,
                    "mean_window": rep.ok / max(windows, 1),
                    "ring_windows": ring1 - ring0,
                    "b1_launches_per_request": b1 / rep.ok,
                    "dispatches_per_window": (device_ops_count() - ops0) / max(windows, 1),
                    "windows_in_flight_max": p1["max_inflight"],
                    "dispatch_ms_per_window": (p1["dispatch_ms"] - p0["dispatch_ms"]) / max(windows, 1),
                    "complete_ms_per_window": (p1["complete_ms"] - p0["complete_ms"]) / max(windows, 1),
                    "points_per_s": resident * rep.throughput_qps}
                if route == "ring":
                    assert row["ring_windows"] == windows, row
                load[f"{route}_{mode}"] = row
                log(f"serve {route} {mode}: {rep.throughput_qps:.1f} served qps, "
                    f"p50 {rep.p50_ms:.3f} ms, p99 {rep.p99_ms:.3f} ms, {windows} "
                    f"windows of {row['mean_window']:.2f}, {row['b1_launches_per_request']:.4f} "
                    f"B1 launches a request, {row['dispatches_per_window']:.3f} "
                    f"device ops a window, {p1['max_inflight']} windows in flight "
                    f"at most, host {row['dispatch_ms_per_window']:.3f} ms dispatch + "
                    f"{row['complete_ms_per_window']:.3f} ms completer a window, "
                    f"{row['points_per_s']:.4g} points/s [{card_s}]")
            assert registry.stats()["captures"] == captures0, registry.stats()
            # the ring's busy time comes from CUDA events around each graph
            # replay: under torch.profiler a replay segfaulted in three of
            # four full runs (with 2 windows in flight)
            busy_of = replay_busy if route == "ring" else device_busy
            how = "CUDA events around each replay" if route == "ring" else "torch.profiler"
            for mode in ("closed_8", "sustained_64"):
                if mode == "closed_8":
                    fn = lambda: run_closed_loop(  # noqa: E731
                        lsvc, make, concurrency=8, duration_s=SERVE_PROFILE_S)
                else:
                    fn = lambda: run_sustained(  # noqa: E731
                        lsvc, make, duration_s=SERVE_PROFILE_S, max_outstanding=64)
                wall_ms, busy_ms = busy_of(torch, fn)
                load[f"{route}_{mode}"]["idle_share"] = max(0.0, 1 - busy_ms / wall_ms)
                load[f"{route}_{mode}"]["idle_share_by"] = how
                log(f"serve {route} {mode}, busy by {how} ({SERVE_PROFILE_S:g} s): "
                    f"device busy {busy_ms:.3f} of {wall_ms:.3f} ms, idle share "
                    f"{load[f'{route}_{mode}']['idle_share']:.3f} [{card_s}]")
        for mode in ("closed_8", "sustained_64"):
            load[f"serial_{mode}"] = serial_load[mode]  # phase 12, this run
        out["load"] = load
        read()
    finally:
        for svc in services:
            svc.close(drain=False, timeout_s=5.0)
    failed = sum(svc.stats().get("failed", 0) for svc in services)
    oom1 = oom()
    delta = {k: oom1[k] - oom0[k] for k in oom0}
    out["oom"] = delta
    out["failed"] = failed
    assert failed == 0 and not any(delta.values()), (failed, delta)
    out["launches"] = used
    out["oom_injected"] = injected_oom(torch, ds, src, make, oom, card_s,
                                       pipelined=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serve device phase: window launches {used}, serve.oom.* {delta}, "
        f"errors {failed}, {out['seconds']:.3f} s")
    return out


def replay_busy(torch, fn):
    """(wall ms, device busy ms) of one call of fn on the ring route: the
    device time between CUDA events recorded on the replaying stream just
    before and just after each graph replay, summed (replays serialise on
    that stream; the slot copies and readbacks of a few KB are left out,
    as the profiler's kernel sum leaves copies out)."""
    from geomesa_tpu_torch.compilecache.registry import RingCapture

    real = RingCapture.replay
    marks = []

    def timed(self, slot):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(self, slot)
        b.record()
        marks.append((a, b))
        return out

    RingCapture.replay = timed
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        RingCapture.replay = real
    return wall_ms, sum(a.elapsed_time(b) for a, b in marks)


def stale_check(dev, path: str, cql: str, cfg: dict, card_s: str) -> dict:
    """A write moves the manifest version under an armed ring program: the
    next window falls back (stale) to the pipelined route and sees the new
    rows, the window after re-arms; each answer == src.knn after the
    write, bit for bit."""
    from geomesa_tpu_torch import DataStore, FeatureBatch
    from geomesa_tpu_torch.serve import QueryService, ServeConfig

    ds = DataStore(path, use_device_cache=True, device=dev)
    src = ds.get_feature_source("gdelt")
    rng = np.random.default_rng(17)
    n = DEV_STALE_WRITE
    nx = rng.uniform(BBOX[0], BBOX[2], n)
    ny = rng.uniform(BBOX[1], BBOX[3], n)
    svc = QueryService(ds, ServeConfig(**cfg))
    try:
        for i in range(2):
            svc.knn("gdelt", cql, [nx[i]], [ny[i]], k=K).result(timeout=300)
        st0 = svc.stats()["pipeline"]["ring"]
        v0 = src.storage.manifest_version()
        src.write(FeatureBatch.from_pydict(src.sft, {
            "speed": np.full(n, 10.0),
            "dtg": rng.integers(T0 + 1, T1, n),
            "geom": np.stack([nx, ny], 1)}))
        v1 = src.storage.manifest_version()
        got, stats = [], []
        for i in range(2, 4):
            got.append(svc.knn("gdelt", cql, [nx[i]], [ny[i]], k=K).result(timeout=300))
            stats.append(svc.stats()["pipeline"]["ring"])
    finally:
        svc.close(drain=True)
    assert v1 > v0 and st0["windows"] == 2 and st0["armed"] == 1, st0
    assert stats[0]["fallbacks"] == {"stale": 1} and stats[0]["windows"] == 2, stats[0]
    assert stats[1]["armed"] == 2 and stats[1]["windows"] == 3, stats[1]
    for j, i in enumerate(range(2, 4)):
        d, ix, _ = got[j]
        sd, six, _ = src.knn(cql, [nx[i]], [ny[i]], k=K)
        assert np.array_equal(d, sd) and np.array_equal(ix, six)
        assert d[0, 0] == 0.0, "the written row is not the nearest"
    log(f"staleness: a write moved the manifest version {v0} -> {v1}; the next "
        f"window fell back {stats[0]['fallbacks']} and saw the new rows, the one "
        f"after re-armed (armed {stats[1]['armed']}); both == src.knn [{card_s}]")
    return {"version": [v0, v1], "fallbacks": stats[0]["fallbacks"],
            "armed_after": stats[1]["armed"]}


# -- config 2 as users write it (phase 11) -------------------------------------

SQL_JOIN = ("SELECT r.name AS region, COUNT(*) AS n FROM events e JOIN regions r "
            "ON st_contains(r.geom, e.geom) GROUP BY r.name ORDER BY region")
SQL_WARM = 3  # warm calls of the join (~16 s each on the card)
STATS_EXPR = ("Count();MinMax(dtg);Histogram(val,32,0,10);DescriptiveStats(val);"
              "Cardinality(val)")
EVENTS_DAY0 = TUBE_DAY0  # one day of events: one partition keeps Morton order
STATS_WIN = (EVENTS_DAY0 + 2 * 3_600_000, EVENTS_DAY0 + 20 * 3_600_000)
# 32-bit operations a row (counted against the FP32 peak: the card's INT32
# rate is not above it, so the bound is a lower one): the HLL hash is
# 2 fmix32 (5 operations each) + 2 xors + 2 shifts for h1, the same for
# h2, then the index, the two halves' shifts and ors, two bit lengths
# (convert, shift, and) and the rank selects: ~40; the Z3 cell is 2 x
# (add, multiply, floor, clamp) + 2 multiply-adds for the flat index: 12;
# a grouped reduction is the select and the scatter: 2
HLL_OPS = 40
Z3_OPS = 12
GROUPED_OPS = 2


def region_name(pid: int) -> str:
    return f"region-{pid:05d}"


def stats_oracle(torch, dev, px, py, val, dtg):
    """The stats expression over the written rows in NumPy f64 (the HLL
    registers in torch on the card): count, dtg min/max, the 32-bin
    histogram (f32 binning, as the Histogram stat), the f64 sum, and the
    registers of the matching values."""
    from geomesa_tpu_torch.engine import stats as est

    x0, y0, x1, y1 = BBOX
    m = ((px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
         & (dtg > STATS_WIN[0]) & (dtg < STATS_WIN[1]))
    v = val[m]
    w = np.float32(10.0 / 32)
    h = np.clip(np.floor((v.astype(np.float32) - np.float32(0.0)) / w), 0, 31)
    regs = est.hll_registers(torch.from_numpy(v).to(dev),
                             torch.ones(len(v), dtype=torch.bool, device=dev), 12)
    return dict(count=int(m.sum()), dtg=(int(dtg[m].min()), int(dtg[m].max())),
                hist=np.bincount(h.astype(np.int64), minlength=32),
                sum=float(v.sum()), regs=regs.cpu().numpy())


def check_stats(seq, exp) -> None:
    """The stats against `stats_oracle`: exact but the f64 sum (its order
    differs: 1e-9 relative) and the HLL estimate (from the registers)."""
    from geomesa_tpu_torch.stats.sketches import Cardinality

    count, minmax, hist, desc, card = seq.stats
    assert count.result()["count"] == exp["count"] > 0, count.result()
    assert tuple(int(t) for t in minmax.result()) == exp["dtg"], minmax.result()
    assert np.array_equal(np.asarray(hist.counts), exp["hist"]), "histogram"
    d = desc.to_json()
    assert d["count"] == exp["count"] and abs(d["sum"] - exp["sum"]) <= 1e-9 * abs(exp["sum"])
    assert np.array_equal(np.asarray(card.registers), exp["regs"]), "HLL registers"
    ref = Cardinality("val")
    ref.observe_registers(exp["regs"])
    assert card.result() == ref.result() > 0


def config2_sql(torch, dev, n: int, card_s: str, exp_counts):
    """Phase 11 (module docstring): config 2 as users write it, through
    SqlContext over two stores of a fresh catalog, the stats query and
    StatsProcess on the events store, and a Z2-partitioned copy. Returns
    (phase numbers, B7 launches, device-op rows)."""
    from geomesa_tpu_torch import DataStore, FeatureBatch, Query, SimpleFeatureType
    from geomesa_tpu_torch.core.columnar import GeometryColumn
    from geomesa_tpu_torch.core.wkt import Geometry
    from geomesa_tpu_torch.curve.binned_time import TimePeriod, to_binned_time
    from geomesa_tpu_torch.engine import pip_sparse as ps
    from geomesa_tpu_torch.engine import pip_sparse_kernels as k
    from geomesa_tpu_torch.engine import stats as est
    from geomesa_tpu_torch.plan.hints import QueryHints
    from geomesa_tpu_torch.process import StatsProcess
    from geomesa_tpu_torch.sql import SqlContext
    from geomesa_tpu_torch.store import fs
    from geomesa_tpu_torch.store.partition import Z2Scheme
    from geomesa_tpu_torch.utils.padding import next_pow2

    out = {}
    rng = np.random.default_rng(29)  # phase 6's layer and points
    layer = gen_admin_layer(rng, LAYER_POLYS)
    px, py, _ = layer_points(torch, dev, rng, n, layer)
    val = rng.uniform(0, 10, n)
    dtg = EVENTS_DAY0 + rng.integers(0, DAY_MS, n)
    rsft = SimpleFeatureType.from_spec("regions", "name:String,*geom:Polygon")
    espec = "val:Double,dtg:Date,*geom:Point"
    esft = SimpleFeatureType.from_spec("events", espec)
    rb = FeatureBatch.from_pydict(rsft, {
        "name": [region_name(i) for i in range(LAYER_POLYS)],
        "geom": [Geometry("Polygon", rings) for rings in layer[6]]})
    t0 = time.perf_counter()
    et = rb.columns["geom"].edge_table()
    out["edge_table_s"] = time.perf_counter() - t0
    # the stored layer is phase 6's: its edge table gives the same edges
    assert all(np.array_equal(a, b) for a, b in zip(
        (et.x1, et.y1, et.x2, et.y2, et.efeat), layer[:5]))
    eb = FeatureBatch.from_pydict(esft, {"val": val, "dtg": dtg,
                                         "geom": np.stack([px, py], 1)})
    with tempfile.TemporaryDirectory() as tmp:
        ds = DataStore(tmp, use_device_cache=True, device=dev)
        regions = ds.create_schema(rsft)  # no dtg: the default XZ2 scheme
        events = ds.create_schema(esft)   # the dtg's days
        assert regions.storage.scheme.to_config()["scheme"] == "xz2"
        with Spans(torch, [(fs, "to_wkt", "wkt encode")]) as sp:
            t0 = time.perf_counter()
            regions.write(rb)
            out["regions_write_s"] = time.perf_counter() - t0
        out["wkt_encode_s"] = sp.seconds["wkt encode"]
        t0 = time.perf_counter()
        events.write(eb)
        out["events_write_s"] = time.perf_counter() - t0
        log(f"config-2 stores: regions ({LAYER_POLYS} polygons, {len(et.x1)} "
            f"edges, {len(regions.storage.partitions())} XZ2 partitions) written in "
            f"{out['regions_write_s']:.3f} s, of which WKT encode "
            f"{out['wkt_encode_s']:.3f} s; events ({n} points, one day) in "
            f"{out['events_write_s']:.3f} s; edge_table() of the layer "
            f"{out['edge_table_s']:.3f} s")

        # -- the SQL join: cold with its split, warm p50 of SQL_WARM, then one split;
        # the plain PyTorch reductions' calls are counted through the stats
        op_names = ("grouped_count", "grouped_sum", "grouped_min",
                    "grouped_max", "hll_registers", "z3_histogram")
        exp = stats_oracle(torch, dev, px, py, val, dtg)  # before the count
        op_calls = Spans(torch, [(est, name, name) for name in op_names])
        op_calls.__enter__()
        ctx = SqlContext(ds)
        kernels = (k.pip_grouped, k.pip_assign, k.pip_pairs_count, k.pip_pairs_band)
        for w in kernels:
            w.launches = 0
        split = [(regions, "get_features", "read regions"),
                 (events, "get_features", "read events"),
                 (fs, "parse_wkt", "wkt parse"),
                 (GeometryColumn, "edge_table", "edge table"),
                 (ps, "prepare_layer_cached", "layer prep"),
                 (ps, "pip_layer_join", "join (B7 + f64 refine)"),
                 (SqlContext, "_aggregate", "grouped aggregate")]
        splits = {}
        results = []
        for what in ("cold", "warm"):
            with Spans(torch, split) as sp:
                t0 = time.perf_counter()
                results.append(ctx.sql(SQL_JOIN))
                wall = time.perf_counter() - t0
            splits[what] = dict(sp.seconds, wall=wall)
            if what == "cold":
                times = []
                for _ in range(SQL_WARM):
                    t0 = time.perf_counter()
                    results.append(ctx.sql(SQL_JOIN))
                    times.append(time.perf_counter() - t0)
                out["sql_warm_p50_s"] = statistics.median(times)
        launches = {w.__name__: w.launches for w in kernels}
        out["launches"] = launches
        out["sql_cold_s"] = splits["cold"]["wall"]
        out["split_cold_s"] = splits["cold"]
        out["split_warm_s"] = splits["warm"]
        log(f"config-2 SQL join: cold {out['sql_cold_s']:.3f} s, warm p50 "
            f"{out['sql_warm_p50_s'] * 1e3:.3f} ms over {SQL_WARM}, "
            f"{n / out['sql_warm_p50_s']:.1f} points/sec; launches over "
            f"{SQL_WARM + 2} queries {launches} [{card_s}]")
        for what, sp in splits.items():
            log(f"config-2 SQL {what} split (synchronised spans): " + ", ".join(
                f"{name} {sec:.3f} s" for name, sec in sp.items()))
        assert launches["pip_assign"] > 0, "the SQL join never launched B7"
        # -- gate: the per-region counts == phase 6's gated assignment ids
        feats = results[0].features
        got = dict(zip(feats.columns["region"].decode(),
                       np.asarray(feats.columns["n"]).tolist()))
        bad = [pid for pid in range(LAYER_POLYS)
               if got.get(region_name(pid), 0) != int(exp_counts[pid])]
        assert not bad, f"{len(bad)} regions differ from phase 6, e.g. {bad[:5]}"
        for r in results[1:]:
            assert np.array_equal(np.asarray(r.features.columns["n"]),
                                  np.asarray(feats.columns["n"]))
        out["regions_matched"] = len(got)
        out["pairs"] = int(sum(got.values()))
        log(f"correct: per-region counts of {len(got)} regions ({out['pairs']} "
            f"pairs) == phase 6's pip_layer_assign bincount; {len(results)} "
            f"results equal")

        # -- stats query and StatsProcess on the events store
        cql = (f"BBOX(geom, {BBOX[0]}, {BBOX[1]}, {BBOX[2]}, {BBOX[3]}) AND dtg "
               f"DURING {iso(STATS_WIN[0])}/{iso(STATS_WIN[1])}")
        q = Query("events", cql, hints=QueryHints(stats_string=STATS_EXPR))
        res, lat = time_calls({
            "stats query": lambda: events.get_features(q).stats,
            "StatsProcess": lambda: StatsProcess().execute(events, STATS_EXPR, cql)})
        for name, seq in res.items():
            check_stats(seq, exp)
            out[f"{name} cold_s"], out[f"{name} warm_p50_s"] = lat[name]
            log(f"{name}: cold {lat[name][0] * 1e3:.3f} ms, warm p50 "
                f"{lat[name][1] * 1e3:.3f} ms over {exp['count']} matching of {n} "
                f"rows [{card_s}]")
        op_calls.__exit__(None, None, None)
        log(f"correct: stats == NumPy over the written rows (count "
            f"{exp['count']}, dtg min/max, 32-bin histogram, f64 sum within "
            f"1e-9), HLL registers == torch's; StatsProcess the same")

        # -- the same points under Z2Scheme against the date scheme
        z2 = ds.create_schema(SimpleFeatureType.from_spec("events_z2", espec),
                              scheme=Z2Scheme())
        t0 = time.perf_counter()
        z2.write(FeatureBatch.from_pydict(z2.sft, {"val": val, "dtg": dtg,
                                                   "geom": np.stack([px, py], 1)}))
        out["z2_write_s"] = time.perf_counter() - t0
        bbox_cql = f"BBOX(geom, {BBOX[0]}, {BBOX[1]}, {BBOX[2]}, {BBOX[3]})"
        counts, lat = time_calls({"z2": lambda: z2.get_count(bbox_cql),
                                  "datetime": lambda: events.get_count(bbox_cql)})
        exp_n = int(((px >= BBOX[0]) & (px <= BBOX[2]) & (py >= BBOX[1])
                     & (py <= BBOX[3])).sum())
        assert counts["z2"] == counts["datetime"] == exp_n, (counts, exp_n)
        out["z2_partitions"] = len(z2.storage.partitions())
        out["z2_count_warm_p50_s"] = lat["z2"][1]
        out["datetime_count_warm_p50_s"] = lat["datetime"][1]
        log(f"Z2Scheme store: {out['z2_partitions']} partitions written in "
            f"{out['z2_write_s']:.3f} s; north-star BBOX count {counts['z2']} == "
            f"the date-partitioned store's == f64 NumPy; warm p50 "
            f"{lat['z2'][1] * 1e3:.3f} ms (date scheme {lat['datetime'][1] * 1e3:.3f} "
            f"ms) [{card_s}]")
        geometry_layer_phase(torch, dev, ds, regions, layer[6], card_s)

    # -- the non-Pallas device operations at this path's shapes
    ops = []
    line = {"grouped_count": 196, "grouped_sum": 203, "grouped_min": 211,
            "grouped_max": 219, "hll_registers": 137, "z3_histogram": 227}

    def op_row(name, ms, b, by, **kw):
        return dict({"name": name, "replaces": f"geomesa_tpu/engine/stats.py:{line[name]}",
                     "source": "geomesa_tpu_torch/engine/stats.py", "route": "torch",
                     "launches": op_calls.calls[name], "ms": ms, "bound_ms": b,
                     "bound_by": by}, **kw)

    m_rows = out["pairs"]
    mr = next_pow2(max(m_rows, 1))
    G = next_pow2(max(out["regions_matched"], 1))
    g = torch.from_numpy(rng.integers(0, out["regions_matched"], mr)).to(
        torch.int32).to(dev)
    gm = torch.arange(mr, device=dev) < m_rows
    gv = torch.from_numpy(rng.uniform(0, 10, mr)).to(dev)
    calls = {"grouped_count": lambda: est.grouped_count(g, gm, G),
             "grouped_sum": lambda: est.grouped_sum(gv, g, gm, G),
             "grouped_min": lambda: est.grouped_min(gv, g, gm, G),
             "grouped_max": lambda: est.grouped_max(gv, g, gm, G)}
    for name, fn in calls.items():
        ms = timed_ms(torch, fn, 10)
        nb = 5 * mr + 8 * G + (0 if name == "grouped_count" else 8 * mr)
        b, by = roofline_ms(GROUPED_OPS * mr, nb)
        ops.append(op_row(name, ms, b, by, rows=mr, groups=G))
    vt = torch.from_numpy(val).to(dev)
    mt = torch.ones(n, dtype=torch.bool, device=dev)
    ms = timed_ms(torch, lambda: est.hll_registers(vt, mt, 12), 10)
    b, by = roofline_ms(HLL_OPS * n, 9 * n + 4 * 4096)
    ops.append(op_row("hll_registers", ms, b, by, rows=n))
    bins, _ = to_binned_time(dtg, TimePeriod.parse("week"))
    tb = torch.from_numpy((bins - bins.min()).astype(np.int32)).to(dev)
    xf = torch.from_numpy(px.astype(np.float32)).to(dev)
    yf = torch.from_numpy(py.astype(np.float32)).to(dev)
    nt = next_pow2(int(bins.max() - bins.min()) + 1)
    ms = timed_ms(torch, lambda: est.z3_histogram(xf, yf, tb, mt, nt, 16), 10)
    b, by = roofline_ms(Z3_OPS * n, 13 * n + 4 * nt * 256)
    ops.append(op_row("z3_histogram", ms, b, by, rows=n))
    for o in ops:
        log(f"{o['name']} ({o['rows']} rows): {o['ms']:.3f} ms, bound "
            f"{o['bound_ms']:.3f} ms by {o['bound_by']}, {o['launches']} calls "
            f"on the path [{card_s}]")
    return out, launches["pip_assign"], ops



# -- geometry predicates, non-point density and codecs (phase 14) -------------

GEO_WARM = 5
GEO_CENTER = (10.0, 45.0)
# FP64 operations per (row, segment) pair of point_to_segments_m as written:
# 4 subtracts and 6 scalings (ax, ay, bx, by), 2 differences, 2 squares and
# an add (the squared length), 2 products, an add, a negation, a clamp and a
# divide (t), a clamp, 2 multiply-adds (cx, cy), 2 squares, an add and the
# running minimum
SEG_OPS = 30
# per (data edge, literal edge) pair of edge_crossings: four orientations
# of 7 each, 4 sign tests, 2 inequalities and an AND
CROSS_OPS = 35
# per (data edge, literal vertex) pair of literal_vertex_parity: the
# straddle test (3), t (3), xc (3), the compare, the AND and the count's add
PARITY_OPS = 12
# FP32 operations per (segment, slot) of line_density: the crossing's t
# (4), the clamp (2), the sort's share (log2 of the row, ~5), dt, the
# midpoint (2), its x and y (4), the cell (4), the bounds (5) and the
# weight; per (edge, row) of polygon_density: the row's centre (2), t (2),
# xc (2), the column (3), the bounds (3), the signed weight and the add
LINE_OPS = 30
POLY_OPS = 14
LINE_TRACKS = 65_536
LINE_VERTS = 128
LINE_ENV = (-12.0, 33.0, 32.0, 67.0)
LAYER_DENSITY_ENV = (-180.0, -90.0, 180.0, 90.0)
GEO_HOST_FEATURES = 16  # regions re-evaluated by eval_filter_host (f64)
GEO_OTHER_FEATURES = 64  # far regions beside the candidates in the CPU check
GEO_ORACLE_CELLS = 4096
CODEC_BBOX = (-2.0, 54.0, 2.0, 56.0)
CODEC_WIN = (TUBE_DAY0 + 6 * 3_600_000, TUBE_DAY0 + 18 * 3_600_000)
# what phase 14 measured: its device-op rows and B4's and B5's launches
GEO_OPS: list = []
GEO_LAUNCHES = {"pip_crossing": 0, "pip_band": 0}


def geo_record(part: str, res: dict, ops, launches=None) -> None:
    PHASES.setdefault("geometry", {})[part] = res
    GEO_OPS.extend(ops)
    for k, v in (launches or {}).items():
        GEO_LAUNCHES[k] += v


class Calls:
    """Calls made to named functions of the port during a block: a count
    only, no synchronisation (the timings around it stay undisturbed)."""

    def __init__(self, targets):
        self.targets = targets  # [(owner, attribute, label)]
        self.calls = {label: 0 for _, _, label in targets}
        self._saved = []

    def __enter__(self):
        for owner, attr, label in self.targets:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))

            def wrapped(*args, _fn=fn, _label=label, **kwargs):
                self.calls[_label] += 1
                return _fn(*args, **kwargs)
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        return False


class Laps:
    """Wall seconds of a phase's consecutive sections: `lap(name)` closes
    the section that ran since the previous lap (or since creation)."""

    def __init__(self):
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def geo_wkt_ring(pts) -> str:
    return "(" + ", ".join(f"{float(a)!r} {float(b)!r}" for a, b in pts) + ")"


def star_literal(seed: int = 41, n: int = 1024) -> str:
    """The seeded 1,024-vertex star polygon of radius 8-12 degrees centred
    at (10, 45)."""
    rng = np.random.default_rng(seed)
    th = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(8.0, 12.0, n)
    pts = np.stack([GEO_CENTER[0] + r * np.cos(th), GEO_CENTER[1] + r * np.sin(th)], 1)
    return f"POLYGON({geo_wkt_ring(np.concatenate([pts, pts[:1]]))})"


def geo_oracle(torch, dev, kind: str, lit, x, y, d: float, chunk: int = 1 << 15):
    """(f64 distance, f64 inside) of written rows on the card, written here
    apart from the port: the haversine to a point literal, else the
    reference's equirectangular distance to the literal's segments (rows
    farther than 2 d in latitude from every segment are set to +inf), and
    for a polygon the f64 crossing parity."""
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(dev)  # noqa: E731
    xt, yt = f(x), f(y)
    if kind == "point":
        R = 6_371_008.8
        px, py = (np.radians(v) for v in lit)
        rlat = torch.deg2rad(yt)
        a = (torch.sin((py - rlat) / 2) ** 2 + torch.cos(rlat) * np.cos(py)
             * torch.sin((px - torch.deg2rad(xt)) / 2) ** 2)
        dist = 2.0 * R * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
        return dist.cpu().numpy(), np.zeros(len(x), bool)
    from geomesa_tpu_torch.core.wkt import parse_wkt
    from geomesa_tpu_torch.engine.pip import polygon_edges

    g = parse_wkt(lit)
    s = [f(a)[None, :] for a in polygon_edges(g)]
    deg = 111_194.9
    dist = torch.full((len(x),), float("inf"), dtype=torch.float64, device=dev)
    lo = min(float(s[1].min()), float(s[3].min())) - 2 * d / deg
    hi = max(float(s[1].max()), float(s[3].max())) + 2 * d / deg
    rows = torch.nonzero((yt >= lo) & (yt <= hi)).flatten()
    for i in range(0, rows.shape[0], chunk):
        r = rows[i:i + chunk]
        px, py = xt[r][:, None], yt[r][:, None]
        c = torch.cos(torch.deg2rad(py))
        ax, ay = (s[0] - px) * deg * c, (s[1] - py) * deg
        bx, by = (s[2] - px) * deg * c, (s[3] - py) * deg
        dx, dy = bx - ax, by - ay
        tt = torch.clamp(-(ax * dx + ay * dy) / torch.clamp(dx * dx + dy * dy, min=1e-12),
                         0.0, 1.0)
        cx, cy = ax + tt * dx, ay + tt * dy
        dist[r] = torch.sqrt((cx * cx + cy * cy).min(1).values)
    inside = (f64_polygon_mask(torch, dev, np.asarray(x, np.float64),
                               np.asarray(y, np.float64), lit)
              if "Polygon" in g.kind else np.zeros(len(x), bool))
    return dist.cpu().numpy(), inside


def geometry_points_phase(torch, dev, src, a: dict, card_s: str) -> None:
    """Phase 14, point stores (inside phase 4, on its store): DWITHIN and
    BEYOND of a point with the north-star window, DWITHIN of the config-5
    track and of phase 5's zone polygon, each as get_count and features,
    cold and warm p50; gated against the f64 oracle of the written rows,
    exact outside the ring max(1 m, 1e-5 d)."""
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.core.wkt import parse_wkt
    from geomesa_tpu_torch.engine import geodesy
    from geomesa_tpu_torch.engine import pip_kernels as pk
    from geomesa_tpu_torch.engine.pip import polygon_edges

    x, y, t, speed = a["x"], a["y"], a["t"], a["speed"]
    win = f"dtg > {iso(T0)} AND dtg < {iso(T1)} AND speed > 5.0"
    tx, ty, _ = tube_track(np.random.default_rng(13))
    track = f"LINESTRING{geo_wkt_ring(np.stack([tx, ty], 1))}"
    zone = zone_polygon()
    cases = {  # name: (cql, oracle kind, literal, distance m, windowed, beyond)
        "dwithin point": (f"DWITHIN(geom, POINT(10 45), 500, kilometers) AND {win}",
                          "point", GEO_CENTER, 500e3, True, False),
        "beyond point": (f"BEYOND(geom, POINT(10 45), 500, kilometers) AND {win}",
                         "point", GEO_CENTER, 500e3, True, True),
        "dwithin track": (f"DWITHIN(geom, {track}, 20, kilometers)", "segments",
                          track, 20e3, False, False),
        "dwithin zone": (f"DWITHIN(geom, {zone}, 10, kilometers)", "segments",
                         zone, 10e3, False, False),
    }

    def window(tt, ss):
        return (tt > T0) & (tt < T1) & (ss > 5.0)

    def truth(case, xs, ys, tt, ss):
        _, kind, lit, d, windowed, beyond = case
        dist, inside = geo_oracle(torch, dev, kind, lit, xs, ys, d)
        near = (dist <= d) | inside
        ring = (np.abs(dist - d) <= max(1.0, 1e-5 * d)) & ~inside
        m = ~near if beyond else near
        if windowed:
            w = window(tt, ss)
            m, ring = m & w, ring & w
        return m, ring

    lap = Laps()
    kernels = (pk.pip_crossing, pk.pip_band)
    res, b45 = {}, {}
    for w in kernels:
        w.launches = 0
    with Calls([(geodesy, "point_to_segments_m", "point_to_segments_m")]) as cnt:
        for name, case in cases.items():
            q = Query("gdelt", case[0])
            out, lat = time_calls({"count": lambda: src.get_count(q),
                                   "features": lambda: src.get_features(q)},
                                  warm=GEO_WARM)
            exp, ring = truth(case, x, y, t, speed)
            n_exact, n_ring = int((exp & ~ring).sum()), int(ring.sum())
            count, r = out["count"], out["features"]
            assert n_exact <= count <= n_exact + n_ring, (name, count, n_exact, n_ring)
            f = r.features
            assert len(f) == count == r.count, (name, len(f), count)
            fx, fy = np.asarray(f.geometry.x), np.asarray(f.geometry.y)
            fm, fring = truth(case, fx, fy, np.asarray(f.dtg), np.asarray(f.columns["speed"]))
            bad = int((~fm & ~fring).sum())
            assert bad == 0, f"{name}: {bad} returned rows fail the f64 oracle"
            res[name] = {"count": count, "exact": n_exact, "ring_rows": n_ring,
                         "count_cold_s": lat["count"][0],
                         "count_warm_p50_s": lat["count"][1],
                         "features_cold_s": lat["features"][0],
                         "features_warm_p50_s": lat["features"][1]}
            log(f"correct: {name} count {count} == the f64 oracle over the "
                f"written rows ({n_exact} outside the ring, {n_ring} within "
                f"max(1 m, 1e-5 d) of d); {len(f)} feature rows all pass it")
            log(f"{name}: count cold {lat['count'][0] * 1e3:.3f} ms, warm p50 "
                f"{lat['count'][1] * 1e3:.3f} ms; features cold "
                f"{lat['features'][0] * 1e3:.3f} ms, warm p50 "
                f"{lat['features'][1] * 1e3:.3f} ms [{card_s}]")
    b45 = {w.__name__: w.launches for w in kernels}
    log(f"phase-14 point launches: {b45}; point_to_segments_m calls {cnt.calls}")
    assert b45["pip_crossing"] > 0, "the zone DWITHIN never launched B4"

    lap("queries and gates")
    # point_to_segments_m at the track query's shapes (the rows of its band)
    sb = src.planner.cache.superbatch()
    segs = [torch.from_numpy(e).to(dev) for e in polygon_edges(parse_wkt(track))]
    reach = 20e3 / geodesy.DEG_M_LAT * (1 + 1e-6) + 1e-9
    gy = sb.dev["geom__y"].double()
    band = torch.nonzero((gy >= float(min(segs[1].min(), segs[3].min())) - reach)
                         & (gy <= float(max(segs[1].max(), segs[3].max())) + reach)).flatten()
    bx, by = sb.dev["geom__x"][band], sb.dev["geom__y"][band]
    ms = timed_ms(torch, lambda: geodesy.point_to_segments_m(bx, by, *segs), 5)
    nb, ns = int(band.shape[0]), int(segs[0].shape[0])
    t_ops = SEG_OPS * nb * ns / FP64_OPS_PER_S * 1e3
    t_bytes = (nb * (4 + 4 + 8) + ns * 32) / HBM_BYTES_PER_S * 1e3
    b, by_ = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    log(f"point_to_segments_m (track band: {nb} rows x {ns} segments, f64): "
        f"{ms:.3f} ms, bound {b:.3f} ms by {by_} (FP64) [{card_s}]")
    op = {"name": "point_to_segments_m", "replaces": "geomesa_tpu/engine/geodesy.py:49",
          "source": "geomesa_tpu_torch/engine/geodesy.py", "route": "torch",
          "launches": cnt.calls["point_to_segments_m"], "ms": ms, "bound_ms": b,
          "bound_by": by_, "pairs": nb * ns, "rows": nb}
    lap("point_to_segments_m timed")
    log("phase 14 points split: " + ", ".join(
        f"{n} {s:.3f} s" for n, s in lap.seconds.items()) + f" [{card_s}]")
    geo_record("points", dict(res, launches=b45, split_s=lap.seconds), [op], b45)


def layer_oracle_cells(rings_of, grid, env, n_cells: int, seed: int = 43):
    """(bad cells, sampled) of a cell-centre coverage grid against an f64
    crossing-parity oracle over the layer's rings (each sampled centre
    tested against the polygons whose envelope holds it). A mismatch
    counts as bad unless the centre lies within 1e-4 degrees of an edge."""
    h, w = grid.shape
    rng = np.random.default_rng(seed)
    cells = rng.choice(h * w, n_cells, replace=False)
    rr, cc = cells // w, cells % w
    dx, dy = (env[2] - env[0]) / w, (env[3] - env[1]) / h
    cx, cy = env[0] + (cc + 0.5) * dx, env[1] + (rr + 0.5) * dy
    boxes = np.array([[min(r[:, 0].min() for r in rs), min(r[:, 1].min() for r in rs),
                       max(r[:, 0].max() for r in rs), max(r[:, 1].max() for r in rs)]
                      for rs in rings_of])
    bad = 0
    for k in range(n_cells):
        hold = np.nonzero((boxes[:, 0] <= cx[k]) & (boxes[:, 2] >= cx[k])
                          & (boxes[:, 1] <= cy[k]) & (boxes[:, 3] >= cy[k]))[0]
        exp, near = 0, False
        for pid in hold:
            cross = 0
            for r in rings_of[pid]:
                x1, y1, x2, y2 = r[:-1, 0], r[:-1, 1], r[1:, 0], r[1:, 1]
                cond = (y1 <= cy[k]) != (y2 <= cy[k])
                xc = x1 + (cy[k] - y1) / np.where(y2 == y1, 1.0, y2 - y1) * (x2 - x1)
                cross += int((cond & (xc > cx[k])).sum())
                near = near or bool((cond & (np.abs(xc - cx[k]) <= 1e-4)).any())
            exp += cross % 2
        if grid[rr[k], cc[k]] != exp and not near:
            bad += 1
    return bad, n_cells


def geometry_layer_phase(torch, dev, ds, regions, rings_of, card_s: str) -> None:
    """Phase 14, the polygon layer (inside phase 11, on its regions store)
    and density over non-point layers (the regions and a new AIS-shaped
    line layer)."""
    from geomesa_tpu_torch import FeatureBatch, Query, QueryHints, SimpleFeatureType
    from geomesa_tpu_torch.core.wkt import Geometry, parse_wkt
    from geomesa_tpu_torch.cql import compile_filter, parse_cql
    from geomesa_tpu_torch.cql.hosteval import eval_filter_host
    from geomesa_tpu_torch.engine import geometry as eg
    from geomesa_tpu_torch.engine import pip_kernels as pk
    from geomesa_tpu_torch.engine import raster
    from geomesa_tpu_torch.engine.device import VALID, DeviceTables, to_device
    from geomesa_tpu_torch.engine.pip import points_in_polygon_band, polygon_edges
    from geomesa_tpu_torch.plan.runner import CalibCache, density_device_grid
    from geomesa_tpu_torch.process import DensityProcess
    from geomesa_tpu_torch.store.partition import XZ2Scheme

    lap = Laps()
    cpu = torch.device("cpu")
    out = {}
    star = star_literal()
    g = parse_wkt(star)
    x0, y0, x1, y1 = g.bbox
    cases = {
        "BBOX": f"BBOX(geom, {x0!r}, {y0!r}, {x1!r}, {y1!r})",
        "INTERSECTS": f"INTERSECTS(geom, {star})",
        "WITHIN": f"WITHIN(geom, {star})",
        "DISJOINT": f"DISJOINT(geom, {star})",
        "CONTAINS point": "CONTAINS(geom, POINT(10 45))",
        "DWITHIN point": "DWITHIN(geom, POINT(10 45), 300, kilometers)",
    }
    kernels = (pk.pip_crossing, pk.pip_band)
    b45 = {w.__name__: 0 for w in kernels}
    counts = {}
    targets = [(eg, "edge_crossings", "edge_crossings"),
               (eg, "literal_vertex_parity", "literal_vertex_parity")]
    with Calls(targets) as cnt:
        for name, cql in cases.items():
            for w in kernels:
                w.launches = 0
            q = Query("regions", cql)
            res, lat = time_calls({"count": lambda: regions.get_count(q),
                                   "features": lambda: regions.get_features(q)},
                                  warm=GEO_WARM)
            launched = {w.__name__: w.launches for w in kernels}
            for k, v in launched.items():
                b45[k] += v
            fcount = 0 if res["features"].features is None else len(res["features"].features)
            assert fcount == res["count"], (name, fcount, res["count"])
            counts[name] = res["count"]
            out[name] = {"count": res["count"], "count_cold_s": lat["count"][0],
                         "count_warm_p50_s": lat["count"][1],
                         "features_cold_s": lat["features"][0],
                         "features_warm_p50_s": lat["features"][1],
                         "launches": launched}
            log(f"regions {name}: {res['count']} of {LAYER_POLYS}; count cold "
                f"{lat['count'][0] * 1e3:.3f} ms, warm p50 {lat['count'][1] * 1e3:.3f} "
                f"ms; features cold {lat['features'][0] * 1e3:.3f} ms, warm p50 "
                f"{lat['features'][1] * 1e3:.3f} ms; launches {launched} [{card_s}]")
            if name == "INTERSECTS":
                assert launched["pip_crossing"] > 0, "INTERSECTS never launched B4"
    geo_calls = dict(cnt.calls)
    assert counts["INTERSECTS"] + counts["DISJOINT"] == LAYER_POLYS
    assert 0 < counts["WITHIN"] < counts["INTERSECTS"] <= counts["BBOX"]
    profile_calls(torch, "regions INTERSECTS count",
                  lambda: regions.get_count(Query("regions", cases["INTERSECTS"])),
                  card_s, calls=1)

    lap("predicates, counts and features")
    # -- gates: the card's masks == the CPU path's over the candidate regions
    # (envelopes within 3 degrees of the literal's, which holds the 300 km
    # DWITHIN's reach) and GEO_OTHER_FEATURES others; eval_filter_host (f64)
    # on GEO_HOST_FEATURES of them: mismatches only on regions with a vertex
    # in the literal's f32 band
    sb = regions.planner.cache.superbatch()
    batch = sb.batch
    col = batch.columns["geom"]
    bb = col.bbox
    valid = batch.valid if batch.valid is not None else np.ones(len(batch), bool)
    cand = np.nonzero(valid & (bb[:, 0] <= x1 + 3) & (bb[:, 2] >= x0 - 3)
                      & (bb[:, 1] <= y1 + 3) & (bb[:, 3] >= y0 - 3))[0]
    rng = np.random.default_rng(44)
    others = np.setdiff1d(np.nonzero(valid)[0], cand)
    idx = np.sort(np.concatenate([cand, rng.choice(others, min(
        GEO_OTHER_FEATURES, len(others)), replace=False)]))
    sub = batch.select(idx)
    sub_dev = to_device(sub, cpu)
    sft = regions.sft
    masks = {}
    for name, cql in cases.items():
        cf = compile_filter(parse_cql(cql), sft)
        card = cf.mask(sb.dev, batch).cpu().numpy()
        masks[name] = card
        host = cf.mask(sub_dev, sub).numpy()
        assert np.array_equal(card[idx], host), f"{name}: card != CPU path"
    # the regions whose vertices sit in the literal's f32 band
    lit_e = [torch.from_numpy(e.astype(np.float32)).to(dev) for e in polygon_edges(g)]
    verts = sb.dev["geom__verts"]
    vband = points_in_polygon_band(verts[:, 0], verts[:, 1], *lit_e).cpu().numpy()
    flagged = np.zeros(len(batch), bool)
    flagged[col.edge_table().vfeat[vband]] = True
    straddle = np.nonzero(masks["INTERSECTS"] & ~masks["WITHIN"])[0]
    pick = np.concatenate([straddle[:GEO_HOST_FEATURES // 2],
                           np.nonzero(masks["WITHIN"])[0][:GEO_HOST_FEATURES // 4],
                           cand[~masks["INTERSECTS"][cand]][:GEO_HOST_FEATURES // 4]])
    hsub = batch.select(pick)
    mism = 0
    for name, cql in cases.items():
        exact = eval_filter_host(parse_cql(cql), hsub)
        diff = exact != masks[name][pick]
        if name == "DWITHIN point":
            assert not diff.any(), f"{name}: card != f64 host evaluation"
        assert not (diff & ~flagged[pick]).any(), f"{name}: a mismatch off the band"
        mism += int(diff.sum())
    out["cpu_checked"] = int(len(idx))
    out["host_checked"] = int(len(pick))
    out["host_mismatches"] = mism
    out["band_regions"] = int(flagged.sum())
    out["geometry_calls"] = geo_calls
    log(f"correct: the card's masks == the CPU path's on {len(idx)} regions "
        f"({len(cand)} near the literal) for {len(cases)} predicates; "
        f"eval_filter_host (f64) on {len(pick)} regions: {mism} mismatches, all "
        f"on regions with a vertex in the literal's f32 band ({int(flagged.sum())} "
        f"such regions); B4 on INTERSECTS")

    lap("masks on the CPU and in f64")
    # -- the geometry passes at INTERSECTS' shapes
    n = len(batch)
    ed = [sb.dev[f"geom__{k}"] for k in ("ex1", "ey1", "ex2", "ey2")]
    ef = sb.dev["geom__efeat"]
    (e1, e2, e3, e4), vx_, vy_ = eg._literal_arrays(g)
    lx1, ly1, lx2, ly2, lvx, lvy = DeviceTables((e1, e2, e3, e4, vx_, vy_)).on(dev)
    ops = []
    ms = timed_ms(torch, lambda: eg.edge_crossings(*ed, ef, n, (lx1, ly1, lx2, ly2)), 3)
    f64 = torch.float64
    kept = int((((torch.maximum(ed[0], ed[2]).to(f64) >= x0 - eg.PRUNE_PAD)
                 & (torch.minimum(ed[0], ed[2]).to(f64) <= x1 + eg.PRUNE_PAD)
                 & (torch.maximum(ed[1], ed[3]).to(f64) >= y0 - eg.PRUNE_PAD)
                 & (torch.minimum(ed[1], ed[3]).to(f64) <= y1 + eg.PRUNE_PAD))).sum())
    L = int(lx1.shape[0])
    E = int(ed[0].shape[0])
    for nm, ms_, pairs, per in (("edge_crossings", ms, kept * L, CROSS_OPS),):
        t_ops = per * pairs / FP64_OPS_PER_S * 1e3
        t_bytes = (E * 20 + n * 4 + L * 32) / HBM_BYTES_PER_S * 1e3
        b, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        ops.append({"name": nm, "replaces": "geomesa_tpu/engine/geometry.py:119",
                    "source": "geomesa_tpu_torch/engine/geometry.py", "route": "torch",
                    "launches": geo_calls[nm], "ms": ms_, "bound_ms": b,
                    "bound_by": by, "pairs": pairs, "edges_kept": kept, "edges": E})
    ms = timed_ms(torch, lambda: eg.literal_vertex_parity(*ed, ef, n, lvx, lvy, False), 3)
    lo = torch.minimum(ed[1], ed[3]).to(f64)
    hi = torch.maximum(ed[1], ed[3]).to(f64)
    pkept = int(((hi > lvy.min()) & (lo <= lvy.max())
                 & (torch.maximum(ed[0], ed[2]).to(f64) >= float(lvx.min()) - eg.PRUNE_PAD)).sum())
    Lv = int(lvx.shape[0])
    t_ops = PARITY_OPS * pkept * Lv / FP64_OPS_PER_S * 1e3
    t_bytes = (E * 20 + n * Lv * 4 * 2 + Lv * 16) / HBM_BYTES_PER_S * 1e3
    b, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    ops.append({"name": "literal_vertex_parity", "replaces": "geomesa_tpu/engine/geometry.py:101",
                "source": "geomesa_tpu_torch/engine/geometry.py", "route": "torch",
                "launches": geo_calls["literal_vertex_parity"], "ms": ms, "bound_ms": b,
                "bound_by": by, "pairs": pkept * Lv, "edges_kept": pkept, "edges": E})
    for o in ops:
        log(f"{o['name']} (regions x the star: {o['edges_kept']} of {o['edges']} "
            f"edges kept, {o['pairs']} pairs, f64): {o['ms']:.3f} ms, bound "
            f"{o['bound_ms']:.3f} ms by {o['bound_by']} (FP64), {o['launches']} "
            f"calls on the path [{card_s}]")

    lap("geometry passes timed")
    # -- density over the regions (cell-centre coverage, unit weight)
    dens, dlat = {}, {}
    with Calls([(raster, "polygon_density", "polygon_density"),
                (raster, "line_density", "line_density")]) as rc:
        dres, dl = time_calls({"regions DensityProcess": lambda: DensityProcess().execute(
            regions, LAYER_DENSITY_ENV, GRID, GRID)}, warm=GEO_WARM)
        dens.update(dres)
        dlat.update(dl)
        hints = QueryHints(density_bbox=LAYER_DENSITY_ENV, density_width=GRID,
                           density_height=GRID)
        lap("regions density")
        cdev = to_device(batch, cpu)
        cpu_grid = density_device_grid(sft, batch, cdev, cdev[VALID], hints,
                                       CalibCache()).numpy()
        grid = dens["regions DensityProcess"]
        assert np.array_equal(grid, cpu_grid), "regions density: card != CPU path"
        lap("regions density CPU path")
        bad, sampled = layer_oracle_cells(rings_of, grid, LAYER_DENSITY_ENV,
                                          GEO_ORACLE_CELLS)
        assert bad == 0, f"regions density: {bad} of {sampled} cells off the f64 oracle"
        out["regions_density"] = {"cold_s": dlat["regions DensityProcess"][0],
                                  "warm_p50_s": dlat["regions DensityProcess"][1],
                                  "covered_cells": int((grid > 0).sum())}
        log(f"correct: regions 512x512 coverage == the CPU path cell for cell and "
            f"== the f64 parity oracle on {sampled} sampled cells; "
            f"{int((grid > 0).sum())} cells covered")
        log(f"regions DensityProcess: cold {dlat['regions DensityProcess'][0] * 1e3:.3f} "
            f"ms, warm p50 {dlat['regions DensityProcess'][1] * 1e3:.3f} ms [{card_s}]")
        profile_calls(torch, "regions polygon density", lambda: DensityProcess().execute(
            regions, LAYER_DENSITY_ENV, GRID, GRID), card_s, calls=1)

        lap("regions density oracle and profile")
        # -- the AIS-shaped line layer, written as users write it
        lrng = np.random.default_rng(45)
        start = np.stack([lrng.uniform(LINE_ENV[0] - 2, LINE_ENV[2] + 2, LINE_TRACKS),
                          lrng.uniform(LINE_ENV[1] - 2, LINE_ENV[3] + 2, LINE_TRACKS)], 1)
        steps = lrng.normal(0, 0.02, (LINE_TRACKS, LINE_VERTS - 1, 2))
        paths = start[:, None, :] + np.concatenate(
            [np.zeros((LINE_TRACKS, 1, 2)), np.cumsum(steps, 1)], 1)
        sog = lrng.uniform(0.5, 20.0, LINE_TRACKS)
        lsft = SimpleFeatureType.from_spec(
            "tracks", "vessel:String,sog:Double,dtg:Date,*geom:LineString")
        lines = ds.create_schema(lsft, scheme=XZ2Scheme())
        t0 = time.perf_counter()
        lines.write(FeatureBatch.from_pydict(lsft, {
            "vessel": [f"vessel{i:05d}" for i in range(LINE_TRACKS)], "sog": sog,
            "dtg": TUBE_DAY0 + lrng.integers(0, DAY_MS, LINE_TRACKS),
            "geom": [Geometry("LineString", [p]) for p in paths]}))
        out["lines_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines.get_count("INCLUDE")
        out["lines_resident_s"] = time.perf_counter() - t0
        log(f"line layer: {LINE_TRACKS} tracks of {LINE_VERTS} vertices written "
            f"(XZ2, {len(lines.storage.partitions())} partitions) in "
            f"{out['lines_write_s']:.3f} s, resident (read, WKT parse, upload) in "
            f"{out['lines_resident_s']:.3f} s")
        lres, ll = time_calls({
            "lines DensityProcess": lambda: DensityProcess().execute(
                lines, LINE_ENV, GRID, GRID),
            "lines DensityProcess sog": lambda: DensityProcess().execute(
                lines, LINE_ENV, GRID, GRID, weight_attr="sog")}, warm=GEO_WARM)
    lap("line layer write, residency and density")
    rcalls = dict(rc.calls)
    lsb = lines.planner.cache.superbatch()
    lbatch = lsb.batch
    lhints = QueryHints(density_bbox=LINE_ENV, density_width=GRID, density_height=GRID)
    ldev = to_device(lbatch, cpu)
    lcpu = density_device_grid(lsft, lbatch, ldev, ldev[VALID], lhints, CalibCache()).numpy()
    unit, wgt = lres["lines DensityProcess"], lres["lines DensityProcess sog"]
    np.testing.assert_allclose(unit, lcpu, rtol=1e-5, atol=1e-5 * float(lcpu.max()))
    # each track's inside fraction: its length clipped to the envelope over
    # its length, f64 on the written vertices
    a_, b_ = paths[:, :-1], paths[:, 1:]
    t0_, t1_, ok = raster._clip_np(a_[..., 0].ravel(), a_[..., 1].ravel(),
                                   b_[..., 0].ravel(), b_[..., 1].ravel(), LINE_ENV)
    seg = np.hypot(*(b_ - a_).reshape(-1, 2).T)
    inside = (np.where(ok, t1_ - t0_, 0.0) * seg).reshape(LINE_TRACKS, -1).sum(1)
    frac = inside / seg.reshape(LINE_TRACKS, -1).sum(1)
    for grid_, w_ in ((unit, np.ones(LINE_TRACKS)), (wgt, sog)):
        exp = float((w_ * frac).sum())
        got = float(grid_.sum(dtype=np.float64))
        assert abs(got - exp) <= 1e-5 * exp, (got, exp)
    out["lines_density"] = {k: {"cold_s": v[0], "warm_p50_s": v[1]} for k, v in ll.items()}
    out["lines_inside_weight"] = float(frac.sum())
    log(f"correct: line density unit grid == the CPU path within f32 summation "
        f"noise; totals == sum of inside fractions ({float(frac.sum()):.3f} "
        f"unweighted, {float((sog * frac).sum()):.3f} by sog) within 1e-5")
    for k, (cold, warm) in ll.items():
        log(f"{k}: cold {cold * 1e3:.3f} ms, warm p50 {warm * 1e3:.3f} ms "
            f"({LINE_TRACKS * (LINE_VERTS - 1)} segments) [{card_s}]")

    lap("line density CPU path and fractions")
    # -- the rasterizers at the path's shapes
    et = col.edge_table()
    k = raster._pow2(raster.polygon_rowspan_bound(et.y1, et.y2, LAYER_DENSITY_ENV, GRID) + 1)
    w1 = torch.ones(len(batch), dtype=torch.float32, device=dev)
    eff = ef.long()
    wedge, medge = w1[eff], sb.dev[VALID][eff]
    ms = timed_ms(torch, lambda: raster.polygon_density(
        *ed, wedge, medge, LAYER_DENSITY_ENV, GRID, GRID, k,
        seg_tile=raster._seg_tile(k)), 3)
    b, by = roofline_ms(POLY_OPS * E * k, E * 21 + 4 * GRID * (GRID + 1))
    ops.append({"name": "polygon_density", "replaces": "geomesa_tpu/engine/raster.py:240",
                "source": "geomesa_tpu_torch/engine/raster.py", "route": "torch",
                "launches": rcalls["polygon_density"], "ms": ms, "bound_ms": b,
                "bound_by": by, "edges": E, "k": k})
    let = lbatch.columns["geom"].edge_table()
    kx, ky = raster.line_crossing_bounds(let.x1, let.y1, let.x2, let.y2, LINE_ENV,
                                         GRID, GRID)
    kx, ky = raster._pow2(kx + 1), raster._pow2(ky + 1)
    led = [lsb.dev[f"geom__{k_}"] for k_ in ("ex1", "ey1", "ex2", "ey2")]
    Ls = int(led[0].shape[0])
    wseg = torch.ones(Ls, dtype=torch.float32, device=dev)
    mseg = torch.ones(Ls, dtype=torch.bool, device=dev)
    ms = timed_ms(torch, lambda: raster.line_density(
        *led, wseg, mseg, LINE_ENV, GRID, GRID, kx, ky,
        seg_tile=raster._seg_tile(kx + ky + 2)), 3)
    b, by = roofline_ms(LINE_OPS * Ls * (kx + ky + 2), Ls * 21 + 4 * GRID * GRID)
    ops.append({"name": "line_density", "replaces": "geomesa_tpu/engine/raster.py:129",
                "source": "geomesa_tpu_torch/engine/raster.py", "route": "torch",
                "launches": rcalls["line_density"], "ms": ms, "bound_ms": b,
                "bound_by": by, "segments": Ls, "kx": kx, "ky": ky})
    for o in ops[-2:]:
        log(f"{o['name']}: {o['ms']:.3f} ms, bound {o['bound_ms']:.3f} ms by "
            f"{o['bound_by']}, {o['launches']} calls on the path [{card_s}]")
    lap("rasterizers timed")
    out["split_s"] = lap.seconds
    log("phase 14 layer split: " + ", ".join(
        f"{n} {s:.3f} s" for n, s in lap.seconds.items()) + f" [{card_s}]")
    geo_record("layer", dict(out, launches=b45), ops, b45)


def codec_phase(torch, dev, src, x, y, t, codes, vocab, card_s: str) -> None:
    """Phase 14, codecs (inside phase 8, on its TubeSelect store): a BBOX +
    dtg query as BIN records (with and without a label) and Arrow IPC
    (sorted by dtg and not), and the two conversion processes; gated
    against the f64-selected written rows and get_features' rows."""
    import os

    from geomesa_tpu_torch import Query, QueryHints
    from geomesa_tpu_torch.core.arrow_io import read_ipc
    from geomesa_tpu_torch.engine import bin as eb
    from geomesa_tpu_torch.process import ArrowConversionProcess, BinConversionProcess

    bx = CODEC_BBOX
    cql = (f"BBOX(geom, {bx[0]}, {bx[1]}, {bx[2]}, {bx[3]}) AND dtg DURING "
           f"{iso(CODEC_WIN[0])}/{iso(CODEC_WIN[1])}")
    m = ((x >= bx[0]) & (x <= bx[2]) & (y >= bx[1]) & (y <= bx[3])
         & (t > CODEC_WIN[0]) & (t < CODEC_WIN[1]))
    names = np.asarray(vocab, dtype=object)

    def q(**h):
        return Query("ais", cql, hints=QueryHints(**h))

    calls = {
        "bin": lambda: src.get_features(q(bin_track="vessel")),
        "bin labelled": lambda: src.get_features(q(bin_track="vessel", bin_label="vessel")),
        "arrow": lambda: src.get_features(q(arrow_encode=True)),
        "arrow sorted dtg": lambda: src.get_features(q(arrow_encode=True,
                                                       arrow_sort_field="dtg")),
        "BinConversionProcess": lambda: BinConversionProcess().execute(src, "vessel", cql),
        "ArrowConversionProcess": lambda: ArrowConversionProcess().execute(src, cql),
        "features": lambda: src.get_features(Query("ais", cql)),
    }
    lap = Laps()
    with Calls([(eb, "bin_pack", "bin_pack")]) as cnt:
        out, lat = time_calls(calls, warm=GEO_WARM)
    lap("queries")
    sb = src.planner.cache.superbatch()
    svocab = np.asarray(sb.batch.columns["vessel"].vocab, dtype=object)
    exp = np.sort(np.rec.fromarrays([
        names[codes[m]].astype(str), np.floor_divide(t[m], 1000).astype(np.int32),
        y[m].astype(np.float32).view(np.int32), x[m].astype(np.float32).view(np.int32)]))

    def bin_rows(buf, labeled):
        d = eb.decode_bin(buf, labeled=labeled)
        if labeled:
            assert np.array_equal(d["label"], d["track"].astype(np.int64))
        return np.sort(np.rec.fromarrays([
            svocab[d["track"]].astype(str), d["dtg_s"], d["lat"].view(np.int32),
            d["lon"].view(np.int32)]))

    for name, labeled in (("bin", False), ("bin labelled", True)):
        r = out[name]
        assert r.kind == "bin" and r.count == int(m.sum()), (name, r.count)
        assert np.array_equal(bin_rows(r.bin_bytes, labeled), exp), name
    assert out["BinConversionProcess"] == out["bin"].bin_bytes
    feats = out["features"].features
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("arrow", "arrow sorted dtg", "ArrowConversionProcess"):
            buf = out[name] if isinstance(out[name], bytes) else out[name].arrow_bytes
            path = os.path.join(tmp, f"{name}.arrow")
            with open(path, "wb") as fh:
                fh.write(buf)
            (back,) = read_ipc(path)
            ref = feats
            if name == "arrow sorted dtg":
                ref = feats.select(np.argsort(np.asarray(feats.dtg), kind="stable"))
            assert len(back) == len(ref) == int(m.sum()), name
            assert back.columns["vessel"].decode() == ref.columns["vessel"].decode(), name
            for a_, b_ in ((back.dtg, ref.dtg), (back.geometry.x, ref.geometry.x),
                           (back.geometry.y, ref.geometry.y)):
                assert np.array_equal(np.asarray(a_), np.asarray(b_)), name
    log(f"correct: BIN records (16 and 24 bytes) == the f64-selected written rows "
        f"({int(m.sum())}: vessel, dtg seconds, f32 lat/lon); BinConversionProcess "
        f"== the bin query; read_ipc of each Arrow payload == get_features' rows in "
        f"order (sorted by dtg where asked)")
    lap("gates")
    res = {name: {"cold_s": c, "warm_p50_s": w} for name, (c, w) in lat.items()}
    for name, (c, w) in lat.items():
        log(f"{name}: cold {c * 1e3:.3f} ms, warm p50 {w * 1e3:.3f} ms, "
            f"{int(m.sum())} rows [{card_s}]")
    # bin_pack at the path's shapes (every resident row)
    dv = sb.dev
    tc = torch.from_numpy(np.asarray(sb.batch.columns["vessel"].codes)).to(dev)
    ms = timed_ms(torch, lambda: eb.bin_pack(tc, dv["dtg"], dv["geom__y"], dv["geom__x"]), 10)
    n = int(tc.shape[0])
    b, by = roofline_ms(4 * n, n * (4 + 8 + 4 + 4) + n * 16)
    log(f"bin_pack ({n} rows): {ms:.3f} ms, bound {b:.3f} ms by {by}, "
        f"{cnt.calls['bin_pack']} calls on the path [{card_s}]")
    op = {"name": "bin_pack", "replaces": "geomesa_tpu/engine/bin.py:24",
          "source": "geomesa_tpu_torch/engine/bin.py", "route": "torch",
          "launches": cnt.calls["bin_pack"], "ms": ms, "bound_ms": b, "bound_by": by,
          "rows": n}
    lap("bin_pack timed")
    log("phase 14 codecs split: " + ", ".join(
        f"{n} {s:.3f} s" for n, s in lap.seconds.items()) + f" [{card_s}]")
    geo_record("codecs", dict(res, split_s=lap.seconds), [op])


# -- phase 15: A4 (b) -------------------------------------------------------------

A4B_WARM = 5
A4B_TOL = 0.3  # the approximate count's tolerance
A4B_TOPK = 10
A4B_KERNELS = ("chord_blockmin", "chord_blockmin_sparse", "zsparse_counts",
               "pip_crossing", "pip_band")
A4B_LAUNCHES = {name: 0 for name in A4B_KERNELS}
A4B_OPS: list = []
VIS_ROWS = 1 << 24  # the visibility store (cut from 2^26 for time)
VIS_VOCAB = ["", "user", "admin", "admin&user", "admin|ops", "(admin|ops)&user",
             None]
VIS_AUTHS = (("user",), ("admin", "user"))
# each expression's truth under VIS_AUTHS, written out (null is public)
VIS_TRUTH = {"": (True, True), "user": (True, True), "admin": (False, True),
             "admin&user": (False, True), "admin|ops": (False, True),
             "(admin|ops)&user": (False, True), None: (True, True)}
VIS_SPEC = ("vis:String,speed:Double:visibility=admin,dtg:Date,*geom:Point;"
            "geomesa.vis.attr=vis")
VIS_RING_WINDOWS = 4  # single-point windows a class through the ring
INGEST_ROWS = 1 << 20
WEEK_MS = 7 * 86_400_000


class Launches:
    """B1-B5's launch counts over a block: each reset on entry and read on
    exit into `counts`, which the phase's totals (`into`: phase 15's by
    default) gather. Blocks nest: an inner block hands its launches back
    to the outer one's counters, and only the outermost adds to the
    totals."""

    depth = 0

    def __init__(self, into=None):
        self.into = A4B_LAUNCHES if into is None else into

    def __enter__(self):
        from geomesa_tpu_torch.engine import density_zsparse as dz
        from geomesa_tpu_torch.engine import knn_scan as ks
        from geomesa_tpu_torch.engine import pip_kernels as pk

        self.fns = (ks.chord_blockmin, ks.chord_blockmin_sparse,
                    dz.zsparse_counts, pk.pip_crossing, pk.pip_band)
        self.saved = [f.launches for f in self.fns]
        for f in self.fns:
            f.launches = 0
        Launches.depth += 1
        return self

    def __exit__(self, *exc):
        Launches.depth -= 1
        self.counts = {f.__name__: f.launches for f in self.fns}
        for f, before in zip(self.fns, self.saved):
            f.launches += before
        if Launches.depth == 0:
            for k, v in self.counts.items():
                self.into[k] += v
        return False


def a4b_record(part: str, res: dict) -> None:
    PHASES.setdefault("a4b", {})[part] = res


def wire_drive(svc_store, requests, payloads=None, binary=True, config=None):
    """One conversation through the protocol over a MemoryWire and a fresh
    QueryService (drained before the output is parsed): {id: (doc,
    payload)}, and the response stream's bytes."""
    from geomesa_tpu_torch.serve import QueryService, ServeConfig
    from geomesa_tpu_torch.serve import columnar as colwire
    from geomesa_tpu_torch.serve.protocol import serve_connection

    svc = QueryService(svc_store, config or ServeConfig(max_wait_ms=0.0))
    mem = colwire.MemoryWire()
    for doc in requests:
        mem.add(doc, (payloads or {}).get(doc.get("id")))
    out = bytearray()
    kw = dict(write_bytes=out.extend, read_bytes=mem.read_exact) if binary else {}
    try:
        serve_connection(svc_store, svc, mem.lines(),
                         lambda s: out.extend(s.encode()), **kw)
    finally:
        svc.close(drain=True)
    return ({d.get("id"): (d, p) for d, p in colwire.parse_stream(bytes(out))},
            len(out))


def world_topk(x, y, m, k: int, b: int = 64):
    """The top-k cells of a NumPy b x b world binning of the rows in `m`,
    binned as the card bins f32 coordinates (f32 constants, IEEE
    division), ranked by (-count, row, col)."""
    x32, y32 = x[m].astype(np.float32), y[m].astype(np.float32)
    col = np.floor((x32 - np.float32(-180.0)) / np.float32(360.0 / b)).astype(np.int64)
    row = np.floor((y32 - np.float32(-90.0)) / np.float32(180.0 / b)).astype(np.int64)
    ok = (col >= 0) & (col < b) & (row >= 0) & (row < b)
    grid = np.bincount(row[ok] * b + col[ok], minlength=b * b)
    cells = sorted((-int(c), int(i // b), int(i % b))
                   for i, c in enumerate(grid) if c)
    return [(r, c, -n) for n, r, c in cells[:k]]


def a4b_knn_store(torch, dev, ds, src, tmp: str, a: dict, card_s: str) -> None:
    """Phase 15 on phase 4's store: approximate answers (1), the columnar
    wire's feature, topk, kNN and ingest frames (4), reprojection and the
    two properties (5)."""
    from geomesa_tpu_torch import DataStore, Query, QueryHints, SimpleFeatureType
    from geomesa_tpu_torch.approx import ApproxCount
    from geomesa_tpu_torch.core import crs
    from geomesa_tpu_torch.core.arrow_io import to_ipc_bytes
    from geomesa_tpu_torch.core.columnar import FeatureBatch
    from geomesa_tpu_torch.serve import columnar as colwire
    from geomesa_tpu_torch.utils.config import SystemProperties

    x, y, t, speed = a["x"], a["y"], a["t"], a["speed"]
    lap = Laps()
    cql = (f"BBOX(geom, {BBOX[0]}, {BBOX[1]}, {BBOX[2]}, {BBOX[3]}) "
           f"AND dtg > {iso(T0)} AND dtg < {iso(T1)}")
    m = ((x >= BBOX[0]) & (x <= BBOX[2]) & (y >= BBOX[1]) & (y <= BBOX[3])
         & (t > T0) & (t < T1))
    qa = Query("gdelt", cql, hints=QueryHints(tolerance=A4B_TOL))

    # (1) approximate answers
    res = {}
    with Launches() as ln:
        eng = src.planner.approx_engine()
        t0 = time.perf_counter()
        first = src.get_count(qa)
        res["sketch_build_s"] = time.perf_counter() - t0
        built = eng.store.stats()["partitions"]
        exact = src.get_count(cql)
        assert exact == int(m.sum()), (exact, int(m.sum()))
        assert isinstance(first, ApproxCount), "no sketch answer"
        assert abs(int(first) - exact) <= first.bound, (int(first), first.bound, exact)
        log(f"approx count: {int(first)} +- {first.bound} (exact {exact}); "
            f"first answer built {built} partition sketches in "
            f"{res['sketch_build_s']:.3f} s (host scan) [{card_s}]")
        fresh = DataStore(tmp, use_device_cache=True, device=dev).get_feature_source("gdelt")
        feng = fresh.planner.approx_engine()
        st = feng.store.stats()
        feng.allow_build = False  # a build would now raise: the sidecar must serve
        t0 = time.perf_counter()
        again = fresh.get_count(qa)
        res["sidecar_answer_s"] = time.perf_counter() - t0
        assert isinstance(again, ApproxCount) and int(again) == int(first), again
        assert again.bound == first.bound and st["sidecar_loaded"] == built, st
        log(f"a fresh planner over the catalog loaded {st['sidecar_loaded']} "
            f"sketches from the sidecar and answered with 0 builds in "
            f"{res['sidecar_answer_s'] * 1e3:.3f} ms")
        docs, _ = wire_drive(ds, [
            {"id": "a", "op": "count", "typeName": "gdelt", "cql": cql,
             "tolerance": A4B_TOL},
            {"id": "e", "op": "count", "typeName": "gdelt", "cql": cql}])
        wa, we = docs["a"][0], docs["e"][0]
        assert wa["approx"] is True and abs(wa["count"] - exact) <= wa["bound"], wa
        assert wa["lo"] <= exact <= wa["hi"] and we["count"] == exact, (wa, we)
        _, lat = time_calls({"approx": lambda: src.get_count(qa),
                             "exact": lambda: src.get_count(cql)}, warm=A4B_WARM)
    res.update(count=int(first), bound=int(first.bound), exact=exact,
               sketches=built, approx_warm_p50_s=lat["approx"][1],
               exact_warm_p50_s=lat["exact"][1], launches=ln.counts)
    log(f"count warm p50: approx {lat['approx'][1] * 1e3:.3f} ms, exact "
        f"{lat['exact'][1] * 1e3:.3f} ms; wire answer approx with lo/hi "
        f"around the exact count [{card_s}]")
    lap("approx count")

    with Launches() as ln:
        tq = Query("gdelt", cql, hints=QueryHints(topk_cells=A4B_TOPK))
        top, tlat = time_calls({"topk": lambda: src.get_features(tq)}, warm=3)
    top = top["topk"]
    route = "dictionary (B3)" if ln.counts["zsparse_counts"] else "scatter"
    got = [(c["row"], c["col"], c["count"]) for c in top.stats]
    exp = world_topk(x, y, m, A4B_TOPK)
    # the device grid bins the raw f32 mask: rows whose f32 BBOX test
    # differs from the f64 one would move a cell (counted, none expected)
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    m32 = ((x32 >= BBOX[0]) & (x32 <= BBOX[2]) & (y32 >= BBOX[1])
           & (y32 <= BBOX[3]) & (t > T0) & (t < T1))
    flips = int((m32 != m).sum())
    assert got == (exp if flips == 0 else world_topk(x, y, m32, A4B_TOPK)), (got, exp)
    assert all(c["bound"] == 0 for c in top.stats) and not top.approx
    res["topk"] = {"route": route, "cells": got, "f32_band_rows": flips,
                   "cold_s": tlat["topk"][0], "warm_p50_s": tlat["topk"][1],
                   "launches": ln.counts}
    log(f"topkCells {A4B_TOPK}: exact fallback on the {route} route == a NumPy "
        f"64x64 world binning of the written rows ({flips} f32 band rows); "
        f"cold {tlat['topk'][0] * 1e3:.3f} ms, warm p50 "
        f"{tlat['topk'][1] * 1e3:.3f} ms [{card_s}]")
    a4b_record("approx", res)
    lap("topk")

    # (4) the columnar wire on this store
    bx = FEATURE_BBOX
    fcql = (f"BBOX(geom, {bx[0]}, {bx[1]}, {bx[2]}, {bx[3]}) AND dtg DURING "
            f"{iso(T0)}/{iso(T1)} AND speed > 5.0")
    qx, qy = a["qx"], a["qy"]
    desc, kpay = colwire.knn_sections(qx, qy)
    col = {}
    with Launches() as ln:
        docs, nbytes = wire_drive(ds, [
            {"id": "h", "op": "hello", "wire": "columnar"},
            {"id": "fc", "op": "query", "typeName": "gdelt", "cql": fcql,
             "maxFeatures": FEATURE_LIMIT},
            {"id": "fj", "op": "query", "typeName": "gdelt", "cql": fcql,
             "maxFeatures": FEATURE_LIMIT, "wire": "json"},
            {"id": "tc", "op": "query", "typeName": "gdelt", "cql": cql,
             "topkCells": A4B_TOPK},
            {"id": "kc", "op": "knn", "typeName": "gdelt", "cql": a["cql"],
             "k": K, "frame": {"sections": desc}},
            {"id": "kj", "op": "knn", "typeName": "gdelt", "cql": a["cql"],
             "k": K, "x": qx.tolist(), "y": qy.tolist(), "wire": "json"}],
            payloads={"kc": kpay})
    hello = docs["h"][0]
    assert hello["wire"] == ["json", "columnar"] and hello["wireMode"] == "columnar"
    (fc, fpay), (fj, _) = docs["fc"], docs["fj"]
    rows = colwire.decode_execute_payload(fpay)
    assert rows == fj["features"] and fc["count"] == fj["count"], "feature frame"
    tc, tpay = docs["tc"]
    assert [(c["row"], c["col"], c["count"]) for c in colwire.decode_topk_payload(
        tc["frame"], tpay)] == got, "topk frame"
    assert docs["kc"][0]["dists"] == docs["kj"][0]["dists"], "kNN sections"
    assert docs["kc"][0]["indices"] == docs["kj"][0]["indices"], "kNN sections"
    assert ln.counts["chord_blockmin_sparse"] > 0, "the kNN frames never launched B1"
    feats = src.get_features(Query("gdelt", fcql, max_features=FEATURE_LIMIT)).features
    t0 = time.perf_counter()
    _, fp2 = colwire.encode_execute_frame(feats, FEATURE_LIMIT)
    enc_s = time.perf_counter() - t0
    from geomesa_tpu_torch.serve.protocol import _rows_json
    t0 = time.perf_counter()
    jbytes = len(json.dumps(_rows_json(feats, FEATURE_LIMIT)))
    json_s = time.perf_counter() - t0
    col["features"] = {"rows": len(rows), "frame_bytes": len(fpay), "json_bytes": jbytes,
                       "encode_s": enc_s, "json_encode_s": json_s}
    col["topk"] = {"frame_bytes": len(tpay),
                   "json_bytes": len(json.dumps(docs["tc"][0]))}
    col["knn"] = {"request_bytes": len(kpay),
                  "json_request_bytes": len(json.dumps({"x": qx.tolist(),
                                                        "y": qy.tolist()})),
                  "launches": ln.counts}
    log(f"columnar wire: hello {hello['wire']}; {len(rows)} feature rows in a "
        f"{len(fpay)}-byte Arrow frame (encode {enc_s * 1e3:.3f} ms) == the "
        f"JSON rows ({jbytes} bytes, encode {json_s * 1e3:.3f} ms); topk frame "
        f"{len(tpay)} bytes; a {Q}-query kNN as x/y sections ({len(kpay)} bytes) "
        f"== its JSON request; B1/B2 {ln.counts} [{card_s}]")
    lap("columnar frames")

    # op=ingest of a 2^20-row Arrow IPC frame into a scratch store
    rng = np.random.default_rng(15)
    sft = ds.create_schema(SimpleFeatureType.from_spec(
        "scratch", "speed:Double,dtg:Date,*geom:Point")).sft
    batch = FeatureBatch.from_pydict(sft, {
        "speed": rng.uniform(0, 30, INGEST_ROWS),
        "dtg": rng.integers(T0, T1, INGEST_ROWS),
        "geom": np.stack([rng.uniform(-180, 180, INGEST_ROWS),
                          rng.uniform(-90, 90, INGEST_ROWS)], 1)})
    t0 = time.perf_counter()
    ipc = to_ipc_bytes(batch)
    ipc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    docs, _ = wire_drive(ds, [
        {"id": "w", "op": "ingest", "typeName": "scratch", "frame": {"kind": "ingest"}},
        {"id": "n", "op": "count", "typeName": "scratch", "cql": "speed >= 0"}],
        payloads={"w": ipc})
    ingest_s = time.perf_counter() - t0
    assert docs["w"][0] == {"id": "w", "ok": True, "rows": INGEST_ROWS,
                            "batches": 1}, docs["w"][0]
    assert docs["n"][0]["count"] == INGEST_ROWS, docs["n"][0]
    col["ingest"] = {"rows": INGEST_ROWS, "frame_bytes": len(ipc),
                     "encode_s": ipc_s, "ingest_and_count_s": ingest_s}
    log(f"op=ingest: {INGEST_ROWS} rows in a {len(ipc)}-byte Arrow IPC frame "
        f"(encode {ipc_s:.3f} s), written and counted in {ingest_s:.3f} s "
        f"[{card_s}]")
    a4b_record("columnar", col)
    lap("ingest")

    # (5) reprojection and the two properties
    proj = {}
    base = src.get_features(Query("gdelt", fcql, max_features=FEATURE_LIMIT,
                                  sort_by=[("dtg", False)])).features
    bxs, bys = np.asarray(base.columns["geom"].x), np.asarray(base.columns["geom"].y)
    utm = crs.utm_zone_srid(10.0, 45.0)
    for to in (3857, utm):
        q = Query("gdelt", fcql, max_features=FEATURE_LIMIT, crs=to,
                  sort_by=[("dtg", False)])
        r, plat = time_calls({"f": lambda: src.get_features(q)}, warm=3)
        g = r["f"].features.columns["geom"]
        ex, ey = crs.transform(bxs, bys, 4326, to)
        assert np.array_equal(g.x, ex) and np.array_equal(g.y, ey), to
        if to == 3857:
            mx = np.radians(bxs) * crs.R_MAJOR
            my = crs.R_MAJOR * np.log(np.tan(np.pi / 4 + np.radians(bys) / 2))
            assert np.allclose(g.x, mx, rtol=1e-12, atol=0)
            assert np.allclose(g.y, my, rtol=1e-12, atol=0)
        proj[f"EPSG:{to}"] = {"rows": len(g.x), "cold_s": plat["f"][0],
                              "warm_p50_s": plat["f"][1]}
    log(f"reprojection: {len(bxs)} feature rows to EPSG:3857 and EPSG:{utm} "
        f"== the CPU transform bit for bit (3857 == the closed-form mercator); "
        + ", ".join(f"{k} warm p50 {v['warm_p50_s'] * 1e3:.3f} ms"
                    for k, v in proj.items()) + f" [{card_s}]")
    lap("reprojection")

    SystemProperties.set("geomesa.force.count", True)
    try:
        before = len(ds.audit.snapshot())
        t0 = time.perf_counter()
        n_all = src.get_count(Query("gdelt", "INCLUDE",
                                    hints=QueryHints(exact_count=False)))
        force_s = time.perf_counter() - t0
        ran = len(ds.audit.snapshot()) - before
    finally:
        SystemProperties.clear("geomesa.force.count")
    snap = src.storage.manifest_snapshot()
    manifest_n = sum(int(e["count"]) for files in snap.values() for e in files)
    assert n_all == manifest_n == len(x) and ran == 1, (n_all, manifest_n, ran)
    proj["force_count"] = {"count": n_all, "s": force_s}
    log(f"geomesa.force.count: the INCLUDE count ran on the card ({ran} query "
        f"event) in {force_s:.3f} s and == the manifest count {manifest_n}")

    SystemProperties.set("geomesa.coord.dtype", "float64")
    try:
        f64 = DataStore(tmp, use_device_cache=True, device=dev).get_feature_source("gdelt")
    finally:
        SystemProperties.clear("geomesa.coord.dtype")
    assert f64.planner.coord_dtype == torch.float64
    with Launches() as ln:
        t0 = time.perf_counter()
        n64 = f64.get_count(a["cql"])
        up_s = time.perf_counter() - t0
        d64, i64, _ = f64.knn(a["cql"], qx, qy, k=K)
    d32, i32, _ = src.knn(a["cql"], qx, qy, k=K)
    assert n64 == src.get_count(a["cql"]), n64
    assert same_neighbours(i64, d64, i32, d32) and np.array_equal(d64, d32), "f64 kNN"
    sb = f64.planner.cache.superbatch()
    assert sb.dev["geom__x"].dtype == torch.float64
    rbytes = sum(v.numel() * v.element_size() for v in sb.dev.values())
    cbytes = sb.dev["geom__x"].numel() * 16
    proj["coord_f64"] = {"count": n64, "upload_and_count_s": up_s,
                         "resident_bytes": rbytes, "coordinate_bytes": cbytes,
                         "resident_rows": len(sb.batch), "launches": ln.counts}
    log(f"geomesa.coord.dtype=float64: a second DataStore over the kNN catalog "
        f"holds {len(sb.batch)} rows in {rbytes} bytes ({cbytes} of f64 "
        f"coordinates), upload + count {up_s:.3f} s; north-star count {n64} and "
        f"sparse kNN (neighbour sets, meters bit-identical) == the f32 store's "
        f"[{card_s}]")
    del f64, sb
    torch.cuda.empty_cache()
    a4b_record("reprojection and properties", dict(proj, split_s=lap.seconds))


def a4b_density_store(torch, dev, ds, src, cql: str, dq, card_s: str) -> None:
    """Phase 15 on phase 5's store: the 512x512 density as one columnar
    f64 frame, equal to the direct grid and to the JSON answer's total;
    density_grid_slotted timed beside density_grid at the path's shapes,
    and equal to it bit for bit over a tile-aligned envelope."""
    from geomesa_tpu_torch.engine.density import density_grid, density_grid_slotted
    from geomesa_tpu_torch.serve import columnar as colwire

    dens = {"bbox": list(ENV), "width": GRID, "height": GRID}
    with Launches() as ln:
        docs, _ = wire_drive(ds, [
            {"id": "c", "op": "query", "typeName": "taxi", "cql": cql,
             "density": dens, "wire": "columnar"},
            {"id": "j", "op": "query", "typeName": "taxi", "cql": cql,
             "density": dens}], config=None)
    (cd, pay), (jd, _) = docs["c"], docs["j"]
    grid = colwire.decode_density_payload(cd["frame"], pay)
    direct = src.get_features(dq(cql)).grid
    assert np.array_equal(grid, np.asarray(direct, np.float64)), "density frame"
    # the answers' total is the f32 grid's own sum, as in the reference
    assert cd["total"] == jd["total"] == float(direct.sum()), (cd["total"], jd["total"])
    assert cd["shape"] == jd["shape"] == list(grid.shape)
    t0 = time.perf_counter()
    colwire.encode_density_frame(direct)
    enc_s = time.perf_counter() - t0
    res = {"frame_bytes": len(pay), "json_bytes": len(json.dumps(jd)),
           "encode_s": enc_s, "launches": ln.counts}
    log(f"columnar density: a {GRID}x{GRID} grid in one {len(pay)}-byte f64 frame "
        f"(encode {enc_s * 1e3:.3f} ms) == the direct grid and the JSON total "
        f"(the JSON answer, {len(json.dumps(jd))} bytes, carries no cells); "
        f"launches {ln.counts} [{card_s}]")
    # density_grid_slotted at the path's shapes (plain PyTorch: the envelope
    # as a device tensor), beside density_grid on the same inputs
    sb = src.planner.cache.superbatch()
    x, y, v = sb.dev["geom__x"], sb.dev["geom__y"], sb.dev["__valid__"]
    ones = torch.ones_like(x)
    slot = torch.tensor(ENV, dtype=torch.float32, device=dev)
    a = density_grid_slotted(x, y, ones, v, slot, GRID, GRID)
    b = density_grid(x, y, ones, v, ENV, GRID, GRID)
    agree = int((a == b).all())
    # over an envelope whose cell sizes round-trip f32 (0.5 / 512 = 2^-10)
    # the two binnings are the same arithmetic, so the grids are equal
    aligned = (-74.25, 40.5, -73.75, 41.0)
    a = density_grid_slotted(x, y, ones, v, torch.tensor(
        aligned, dtype=torch.float32, device=dev), GRID, GRID)
    b = density_grid(x, y, ones, v, aligned, GRID, GRID)
    assert torch.equal(a, b), "density_grid_slotted != density_grid (aligned)"
    del a, b
    ms = timed_ms(torch, lambda: density_grid_slotted(x, y, ones, v, slot, GRID, GRID), 5)
    plain = timed_ms(torch, lambda: density_grid(x, y, ones, v, ENV, GRID, GRID), 5)
    n = x.shape[0]
    bound = (n * (4 + 4 + 4 + 1) + GRID * GRID * 4) / HBM_BYTES_PER_S * 1e3
    log(f"density_grid_slotted: {ms:.3f} ms over {n} points (density_grid "
        f"{plain:.3f} ms on the same inputs, grids equal over the NYC envelope: "
        f"{bool(agree)}, over the aligned one: True), bound {bound:.3f} ms by "
        f"bytes [{card_s}]")
    A4B_OPS.append({"name": "density_grid_slotted",
                    "replaces": "geomesa_tpu/engine/density.py:221",
                    "source": "geomesa_tpu_torch/engine/density.py",
                    "route": "torch", "launches": 0, "ms": ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": "bytes", "rows": n,
                    "equal_to_density_grid": bool(agree),
                    "equal_on_aligned_envelope": True})
    a4b_record("columnar density", res)


def a4b_distinct(torch, src, x, y, t, codes, card_s: str) -> None:
    """Phase 15 on phase 8's TubeSelect store: distinct vessels with a
    tolerance (the HyperLogLog tier under INCLUDE) and without (exact),
    under INCLUDE and a BBOX + window filter."""
    from geomesa_tpu_torch import Query, QueryHints
    from geomesa_tpu_torch.approx import ApproxCount

    bb, win = CODEC_BBOX, CODEC_WIN
    fcql = (f"BBOX(geom, {bb[0]}, {bb[1]}, {bb[2]}, {bb[3]}) AND dtg > "
            f"{iso(win[0])} AND dtg < {iso(win[1])}")
    fm = ((x >= bb[0]) & (x <= bb[2]) & (y >= bb[1]) & (y <= bb[3])
          & (t > win[0]) & (t < win[1]))
    exp = {"INCLUDE": len(np.unique(codes)), fcql: len(np.unique(codes[fm]))}
    res = {}
    with Launches() as ln:
        for cql, label in (("INCLUDE", "include"), (fcql, "filtered")):
            for tol in (0.1, None):
                q = Query("ais", cql, hints=QueryHints(distinct="vessel",
                                                       tolerance=tol))
                t0 = time.perf_counter()
                n = src.get_count(q)
                s = time.perf_counter() - t0
                approx = isinstance(n, ApproxCount)
                assert approx == (tol is not None and cql == "INCLUDE"), (label, tol)
                if approx:
                    assert abs(int(n) - exp[cql]) <= n.bound, (int(n), n.bound, exp[cql])
                else:
                    assert int(n) == exp[cql], (label, int(n), exp[cql])
                key = (f"{label} {'hll' if approx else 'exact'}"
                       + (f" (tolerance {tol})" if tol and not approx else ""))
                res[key] = {"count": int(n), "bound": int(getattr(n, "bound", 0)),
                            "exact": exp[cql], "s": s}
                log(f"distinct vessels {key}: {int(n)}"
                    + (f" +- {n.bound}" if approx else "")
                    + f" (NumPy {exp[cql]}) in {s:.3f} s [{card_s}]")
    res["launches"] = ln.counts
    a4b_record("distinct", res)


def vis_rows(torch, dev, n: int):
    """The visibility store's rows: phase 4's shapes (world-uniform
    points in Morton order, its 115 days) from a seed, with `vis` codes
    over VIS_VOCAB (the last is null) and speed."""
    rng = np.random.default_rng(16)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    order = morton_order(torch, torch.from_numpy(x).to(dev),
                         torch.from_numpy(y).to(dev))
    x, y = x[order], y[order]
    t = rng.integers(1_590_000_000_000, 1_600_000_000_000, n)
    speed = rng.uniform(0, 30, n)
    codes = rng.integers(0, len(VIS_VOCAB), n).astype(np.int32)
    return x, y, t, speed, codes


class WeekWindow:
    """A rewrite interceptor: ANDs a seven-day window onto every query."""

    def __init__(self, start_ms: int):
        self.start, self.calls = start_ms, 0

    def cql(self) -> str:
        return f"dtg DURING {iso(self.start)}/{iso(self.start + WEEK_MS)}"

    def __call__(self, query):
        import dataclasses

        from geomesa_tpu_torch.cql import ast

        self.calls += 1
        return dataclasses.replace(
            query, filter=f"({ast.to_cql(query.filter_ast)}) AND {self.cql()}")


def a4b_visibility(torch, dev, card_s: str) -> None:
    """Phase 15, parts 2 and 3: a 2^24-row store with feature-level
    visibility and a protected attribute; counts, kNN, features, the
    attribute refusal, a density and one ring serving two auths classes;
    then the interceptors on its catalog."""
    from geomesa_tpu_torch import DataStore, FeatureBatch, Query, QueryHints, SimpleFeatureType
    from geomesa_tpu_torch.core.columnar import DictColumn, GeometryColumn
    from geomesa_tpu_torch.plan.interceptor import QueryGuardException
    from geomesa_tpu_torch.plan.planner import RingIneligible
    from geomesa_tpu_torch.plan.runner import allow_table, gather_allow
    from geomesa_tpu_torch.serve import QueryService, ServeConfig
    from geomesa_tpu_torch.serve.scheduler import ServeRequest
    from geomesa_tpu_torch.utils.config import SystemProperties

    lap = Laps()
    x, y, t, speed, codes = vis_rows(torch, dev, VIS_ROWS)
    cql = (f"BBOX(geom, {BBOX[0]}, {BBOX[1]}, {BBOX[2]}, {BBOX[3]}) "
           f"AND dtg > {iso(T0)} AND dtg < {iso(T1)} AND speed > 5.0")
    zone = zone_polygon()
    pcql = f"INTERSECTS(geom, {zone}) AND speed > 5.0"
    m = ((x >= BBOX[0]) & (x <= BBOX[2]) & (y >= BBOX[1]) & (y <= BBOX[3])
         & (t > T0) & (t < T1) & (speed > 5.0))
    pm = f64_polygon_mask(torch, dev, x, y, zone) & (speed > 5.0)
    truth = {a: np.array([VIS_TRUTH[v][i] for v in VIS_VOCAB])[codes]
             for i, a in enumerate(VIS_AUTHS)}
    rng = np.random.default_rng(17)
    qx, qy = rng.uniform(-30, 30, Q), rng.uniform(30, 60, Q)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = DataStore(tmp, use_device_cache=True, device=dev)
        sft = SimpleFeatureType.from_spec("sec", VIS_SPEC)
        src = ds.create_schema(sft)
        t0 = time.perf_counter()
        src.write(FeatureBatch(sft, {
            "vis": DictColumn(np.where(codes == len(VIS_VOCAB) - 1, -1, codes)
                              .astype(np.int32), VIS_VOCAB[:-1]),
            "speed": speed, "dtg": t, "geom": GeometryColumn.from_points(x, y)}))
        res["ingest_s"] = time.perf_counter() - t0
        log(f"ingest: {VIS_ROWS} rows with visibility in {res['ingest_s']:.3f} s "
            f"[{card_s}]")
        lap("ingest")

        def q(c, auths, **kw):
            return Query("sec", c, hints=QueryHints(auths=auths, **kw))

        with Launches() as ln:
            for auths in VIS_AUTHS:
                vm = truth[auths]
                got, lat = time_calls({
                    "count": lambda: src.get_count(q(cql, auths)),
                    "polygon count": lambda: src.get_count(q(pcql, auths)),
                    "knn sparse": lambda: src.knn(q(cql, auths), qx, qy, k=K),
                    "knn fullscan": lambda: src.knn(q(cql, auths), qx, qy, k=K,
                                                    impl="fullscan")}, warm=3)
                assert got["count"] == int((m & vm).sum()), (auths, got["count"])
                assert got["polygon count"] == int((pm & vm).sum()), auths
                exp = oracle_knn(x, y, m & vm, qx[:16], qy[:16], K)
                for impl in ("knn sparse", "knn fullscan"):
                    d, i, b = got[impl]
                    ok = np.all(np.abs(np.sort(d[:16], 1) - exp)
                                <= np.maximum(1.0, 1e-4 * exp))
                    assert ok, (auths, impl)
                    vcol = b.columns["vis"]
                    seen = {vcol.vocab[c] if c >= 0 else None
                            for c in np.asarray(vcol.codes)[i.ravel()]}
                    assert all(VIS_TRUTH[v][VIS_AUTHS.index(auths)]
                               for v in seen), (impl, seen)
                assert same_neighbours(got["knn sparse"][1], got["knn sparse"][0],
                                       got["knn fullscan"][1], got["knn fullscan"][0])
                feats = src.get_features(Query(
                    "sec", cql, max_features=1000,
                    hints=QueryHints(auths=auths))).features
                sp = np.asarray(feats.columns["speed"])
                assert np.isnan(sp).all() == ("admin" not in auths), auths
                assert ("admin" in auths) == bool(np.isfinite(sp).all())
                res[",".join(auths)] = {
                    "count": got["count"], "polygon_count": got["polygon count"],
                    **{f"{k} warm_p50_s": v[1] for k, v in lat.items()}}
                log(f"auths {auths}: count {got['count']} and polygon count "
                    f"{got['polygon count']} == the f64 oracle AND the written "
                    f"visibility; sparse/fullscan kNN within the bench rule of "
                    f"the oracle over visible rows; speed "
                    f"{'returned' if 'admin' in auths else 'redacted'}; warm p50 "
                    + ", ".join(f"{k} {v[1] * 1e3:.3f} ms" for k, v in lat.items())
                    + f" [{card_s}]")
            try:
                src.get_features(q(cql, ("user",), stats_string="MinMax(speed)"))
                raise AssertionError("stats over a protected attribute ran")
            except PermissionError as e:
                log(f"stats on speed without admin refused typed: {e}")
            dh = dict(density_bbox=BBOX, density_width=GRID, density_height=GRID)
            try:
                # the cached route, the one the card takes by default
                src.get_features(q(cql, ("user",), density_weight="speed", **dh))
                raise AssertionError("a density weighted by speed ran")
            except PermissionError as e:
                log(f"density weighted by speed without admin refused typed on "
                    f"the cached route: {e}")
            with Launches() as dl:
                dgrid = src.get_features(q(cql, ("user",), **dh)).grid
            # the grid bins the raw f32 mask: rows whose f32 BBOX test
            # differs from the f64 one may move (counted)
            x32, y32 = x.astype(np.float32), y.astype(np.float32)
            flips = int(((x32 >= BBOX[0]) & (x32 <= BBOX[2]) & (y32 >= BBOX[1])
                         & (y32 <= BBOX[3]) != (x >= BBOX[0]) & (x <= BBOX[2])
                         & (y >= BBOX[1]) & (y <= BBOX[3])).sum())
            mass = int(round(float(dgrid.sum())))
            assert abs(mass - int((m & truth[("user",)]).sum())) <= flips, mass
            res["density"] = {"mass": mass, "f32_band_rows": flips,
                              "route": "dictionary (B3)" if dl.counts[
                                  "zsparse_counts"] else "scatter"}
            log(f"density under auths ('user',): mass {mass} == the visible "
                f"matching rows on the {res['density']['route']} route")
        res["launches"] = ln.counts
        assert ln.counts["pip_crossing"] and ln.counts["pip_band"], ln.counts
        assert ln.counts["chord_blockmin"] and ln.counts["chord_blockmin_sparse"]
        lap("queries and gates")

        # the allow table's gather at the store's shapes
        sb = src.planner.cache.superbatch()
        vcodes = sb.dev["vis"]
        table = allow_table(sb.batch.columns["vis"].vocab, ("user",))
        ms = timed_ms(torch, lambda: gather_allow(table, vcodes), 5)
        n = vcodes.shape[0]
        bound = n * (4 + 1) / HBM_BYTES_PER_S * 1e3
        A4B_OPS.append({"name": "gather_allow", "replaces":
                        "geomesa_tpu/security/visibility.py:149 (host allow_mask)",
                        "source": "geomesa_tpu_torch/plan/runner.py",
                        "route": "torch", "launches": 0, "ms": ms,
                        "bound_ms": bound, "bound_by": "bytes", "rows": n})
        log(f"gather_allow: {ms:.3f} ms over {n} codes, bound {bound:.3f} ms "
            f"by bytes [{card_s}]")

        # one ring, two auths classes with one CQL
        with Launches() as ln:
            svc = QueryService(ds, ServeConfig(max_wait_ms=1.0))
            answers = {}
            try:
                for i in range(VIS_RING_WINDOWS):
                    for auths in VIS_AUTHS:
                        req = ServeRequest(kind="knn", query=q(cql, auths),
                                           qx=qx[i:i + 1], qy=qy[i:i + 1], k=K)
                        served = svc.submit(req).result(timeout=600)
                        serial = src.knn(q(cql, auths), qx[i:i + 1], qy[i:i + 1], k=K)
                        assert np.array_equal(served[0], serial[0]), auths
                        assert np.array_equal(served[1], serial[1]), auths
                        answers[(i, auths)] = served[1]
                ring = svc.stats()["pipeline"]["ring"]
            finally:
                svc.close(drain=True)
        assert ring["programs"] == 2 and ring["fallbacks"] == {}, ring
        assert ring["windows"] == VIS_RING_WINDOWS * len(VIS_AUTHS), ring
        differ = sum(not np.array_equal(answers[(i, VIS_AUTHS[0])],
                                        answers[(i, VIS_AUTHS[1])])
                     for i in range(VIS_RING_WINDOWS))
        assert differ > 0, "the two auths classes answered alike"
        res["ring"] = {"programs": ring["programs"], "windows": ring["windows"],
                       "classes_differ": differ, "launches": ln.counts}
        log(f"ring: {ring['programs']} programs for the two auths classes of one "
            f"CQL, {ring['windows']} windows, each == its serial answer, "
            f"{differ} of {VIS_RING_WINDOWS} points answered differently")
        lap("ring")
        a4b_record("visibility", dict(res, split_s=dict(lap.seconds)))

        # (3) interceptors on this catalog
        ic = {}
        SystemProperties.set("geomesa.scan.block.full.table", True)
        try:
            docs, _ = wire_drive(ds, [
                {"id": "c", "op": "count", "typeName": "sec", "cql": "INCLUDE"},
                {"id": "a", "op": "count", "typeName": "sec", "cql": "INCLUDE",
                 "tolerance": 0.5}])
            guard = docs["c"][0]
            for d, _ in docs.values():
                assert d["ok"] is False and "full-table scan blocked" in d["message"], d
            n_s = src.get_count(Query("sec", "INCLUDE", hints=QueryHints(
                sampling=1024, auths=VIS_AUTHS[1])))
            assert n_s == -(-len(x) // 1024), n_s
            try:
                src.get_count(Query("sec", "INCLUDE"))
                raise AssertionError("the guard let an INCLUDE count through")
            except QueryGuardException:
                pass
        finally:
            SystemProperties.clear("geomesa.scan.block.full.table")
        ic["guard"] = {"wire": guard["message"], "sampled_count": n_s}
        log(f"geomesa.scan.block.full.table: INCLUDE counts, exact and with a "
            f"tolerance, answered on the wire {guard['error']!r} "
            f"({guard['message'][:60]}...); a sampled INCLUDE counted {n_s}")
        w0 = T0 + 10 * 86_400_000
        rw = WeekWindow(w0)
        src.planner.interceptors.append(rw)
        auths = VIS_AUTHS[1]
        wm = m & (t > w0) & (t < w0 + WEEK_MS)
        try:
            with Launches() as ln:
                n_rw = src.get_count(q(cql, auths))
                assert rw.calls == 1 and n_rw == int(wm.sum()), (n_rw, int(wm.sum()))
                d, i, _ = src.knn(q(cql, auths), qx, qy, k=K)
                exp = oracle_knn(x, y, wm, qx[:16], qy[:16], K)
                assert np.all(np.abs(np.sort(d[:16], 1) - exp)
                              <= np.maximum(1.0, 1e-4 * exp)), "rewritten kNN"
                try:
                    src.planner.ring_arm(q(cql, auths), q_padded=8, k=K)
                    raise AssertionError("ring armed over interceptors")
                except RingIneligible as e:
                    assert e.reason == "interceptors", e.reason
                svc = QueryService(ds, ServeConfig(max_wait_ms=1.0))
                try:
                    for j in range(3):
                        served = svc.submit(ServeRequest(
                            kind="knn", query=q(cql, auths), qx=qx[j:j + 1],
                            qy=qy[j:j + 1], k=K)).result(timeout=600)
                        direct = src.knn(q(cql, auths), qx[j:j + 1], qy[j:j + 1], k=K)
                        assert np.array_equal(served[0], direct[0])
                        assert np.array_equal(served[1], direct[1])
                    ring = svc.stats()["pipeline"].get("ring", {})
                finally:
                    svc.close(drain=True)
        finally:
            src.planner.interceptors.remove(rw)
        assert ring.get("windows", 0) == 0 and ring["fallbacks"].get("interceptors"), ring
        ic["rewrite"] = {"count": n_rw, "ring_fallbacks": ring["fallbacks"],
                         "launches": ln.counts}
        log(f"rewrite interceptor (a 7-day window): count {n_rw} and kNN == the "
            f"oracle of the rewritten query; ring_arm refused 'interceptors'; "
            f"served kNN on the pipelined route == direct ({ring['fallbacks']})")
        lap("interceptors")
        a4b_record("interceptors", dict(ic, split_s=dict(lap.seconds)))


# -- A5 (a) and (b): lifecycle, faults, converters, jobs, Arrow (phase 16) ------

LIFE_KERNELS = A4B_KERNELS
LIFE_LAUNCHES = {name: 0 for name in LIFE_KERNELS}
LIFE_DELETE_BBOX = (10.0, 40.0, 11.0, 41.0)  # 1 degree: ~a third of the days
LIFE_WRITE = 4096  # rows of the write that gives partitions a second file
LIFE_WRITE_DAYS = 4
LIFE_SERVED = 64  # kNN requests a route under the fault plan
LIFE_FILES = 8  # GDELT 1.0 TSV files
# rows a file: 2^18 in all, ~1.3 days of GDELT 1.0. Cut from 2^17 a file
# (2^20 rows, ~5 days) for time: the converter runs per record on the host
# and the converted store's host work grows with its unique event ids; at
# 2^20 rows this section took 213 s of phase 16's 268 s (16,440 rows/s
# converted; NVIDIA H100 80GB HBM3 at 700 W and its host)
LIFE_FILE_ROWS = 1 << 15
LIFE_WORKERS = 8
LIFE_SCAN_BATCH = 1 << 18
LIFE_SCAN_SMALL = 512  # below a data file's matching rows: it cuts batches
LIFE_RESET_S = 1.0  # the device breaker's reset timeout in (b)
LIFE_MEM_SLACK = 16 << 20  # bytes allowed to stay after remove_schema
LIFE_POLY = ("POLYGON((-5 38, 12 36, 21 44, 16 55, 2 58, -8 50, -5 38))")
LIFE_DAY0 = 20200601  # the converted events' first day


def life_record(part: str, res: dict) -> None:
    PHASES.setdefault("lifecycle", {})[part] = res


def coord_sets(batch, idx):
    """Each query's neighbours as a set of (x, y): row identity that a
    delete (which shifts row indices) leaves alone."""
    keys = neighbour_keys(batch, np.asarray(idx))
    return [set(k.tolist()) for k in keys]


def same_coord_sets(a, b) -> bool:
    """Identical neighbour coordinates per query, swaps allowed between
    rows at an equal distance."""
    (da, ia, ba), (db, ib, bb) = a, b
    ka, kb = coord_sets(ba, ia), coord_sets(bb, ib)
    return all(sa == sb or np.array_equal(np.sort(x), np.sort(y))
               for sa, sb, x, y in zip(ka, kb, np.asarray(da), np.asarray(db)))


def lifecycle_phase(torch, dev, ds, src, tmp: str, a: dict, card_s: str) -> None:
    """Phase 16 (module docstring): A5 (a) and (b) on phase 4's store and
    on converted, direct and Arrow stores of GDELT events."""
    import os

    lap = Laps()
    with Launches(LIFE_LAUNCHES) as ln:
        life_served_lifecycle(torch, ds, src, a, card_s)
        lap("lifecycle")
        life_faults(torch, ds, src, a, card_s)
        lap("faults")
        life_convert(torch, dev, os.path.join(tmp, "life"), card_s)
        lap("converters, jobs, Arrow")
    life_record("laps_s", dict(lap.seconds, launches=ln.counts))
    log(f"phase 16 laps: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                       lap.seconds.items()) + f" [{card_s}]")


def life_served_lifecycle(torch, ds, src, a: dict, card_s: str) -> None:
    """(a): age-off, delete, write + compact under an armed ring."""
    from geomesa_tpu_torch import FeatureBatch
    from geomesa_tpu_torch.serve import QueryService, ServeConfig

    x, y, t, speed = a["x"], a["y"], a["t"], a["speed"]
    qx, qy, cql = a["qx"], a["qy"], a["cql"]
    cols = {"x": x, "y": y, "t": t, "speed": speed}
    keep = np.ones(len(x), bool)

    def in_query(c):
        return ((c["x"] >= BBOX[0]) & (c["x"] <= BBOX[2]) & (c["y"] >= BBOX[1])
                & (c["y"] <= BBOX[3]) & (c["t"] > T0) & (c["t"] < T1)
                & (c["speed"] > 5.0))

    svc = QueryService(ds, ServeConfig(max_wait_ms=0.0))
    served_i = [0]

    def served():
        i = served_i[0] % Q
        served_i[0] += 1
        got = svc.knn("gdelt", cql, qx[i:i + 1], qy[i:i + 1], k=K).result(timeout=600)
        return i, got

    def ring():
        return svc.stats()["pipeline"]["ring"]

    res = {}
    try:
        served()
        served()
        assert ring()["armed"] >= 1, ring()

        def check(step, deleted, exp_deleted, mutate_s):
            assert deleted == exp_deleted, (step, deleted, exp_deleted)
            t0 = time.perf_counter()
            n = src.get_count(cql)
            count_s = time.perf_counter() - t0
            exp = int((in_query(cols) & keep).sum())
            assert n == exp, (step, n, exp)
            sp = src.knn(cql, qx, qy, k=K, impl="sparse")
            fs = src.knn(cql, qx, qy, k=K, impl="fullscan")
            assert same_coord_sets(sp, fs), f"{step}: sparse and fullscan differ"
            before = ring()
            got = [served(), served()]
            after = ring()
            stale = after["fallbacks"].get("stale", 0) - before["fallbacks"].get("stale", 0)
            assert stale == 1 and after["armed"] == before["armed"] + 1, (step, before, after)
            for i, (d, ix, _) in got:
                sd, six, _ = src.knn(cql, qx[i:i + 1], qy[i:i + 1], k=K)
                assert np.array_equal(d, sd) and np.array_equal(ix, six), step
            res[step] = {"deleted": int(deleted), "mutate_s": mutate_s,
                         "count": n, "first_count_s": count_s,
                         "version": src.storage.manifest_version(),
                         "resident_partitions": len(src.planner.cache.resident())}
            log(f"{step}: {deleted} rows in {mutate_s:.3f} s (== the NumPy "
                f"oracle); count {n} == f64 oracle (first count {count_s:.3f} s, "
                f"residency reloaded); sparse == fullscan neighbours; served "
                f"window fell back stale then re-armed, both == src.knn [{card_s}]")
            return sp

        # 1. age off the store's first day
        first = np.datetime64(int(t.min()), "ms").astype("datetime64[D]")
        cut = int((first + 1).astype("datetime64[ms]").astype(np.int64))
        exp = int((keep & (t < cut)).sum())
        t0 = time.perf_counter()
        n = src.age_off(cut)
        age_s = time.perf_counter() - t0
        keep &= t >= cut
        check("age_off", n, exp, age_s)

        # 2. delete a 1-degree BBOX AND speed < 1.0
        b = LIFE_DELETE_BBOX
        hit = (keep & (x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3])
               & (speed < 1.0))
        files0 = sum(len(v) for v in src.storage.manifest_snapshot().values())
        t0 = time.perf_counter()
        n = src.delete_features(f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) "
                                "AND speed < 1.0")
        del_s = time.perf_counter() - t0
        keep &= ~hit
        check("delete_features", n, int(hit.sum()), del_s)
        res["delete_features"]["files_read"] = files0

        # 3. a small write, then compact the partitions it gave two files
        rng = np.random.default_rng(161)
        w = LIFE_WRITE
        wc = {"x": rng.uniform(-30, 30, w), "y": rng.uniform(30, 60, w),
              "t": T0 + 1 + rng.integers(0, LIFE_WRITE_DAYS * 86_400_000, w),
              "speed": rng.uniform(0, 30, w)}
        t0 = time.perf_counter()
        src.write(FeatureBatch.from_pydict(src.sft, {
            "speed": wc["speed"], "dtg": wc["t"],
            "geom": np.stack([wc["x"], wc["y"]], 1)}))
        write_s = time.perf_counter() - t0
        cols = {k: np.concatenate([cols[k], wc[k]]) for k in cols}
        keep = np.concatenate([keep, np.ones(w, bool)])
        n_w = src.get_count(cql)
        assert n_w == int((in_query(cols) & keep).sum()), n_w
        pre = src.knn(cql, qx, qy, k=K)
        snap = src.storage.manifest_snapshot()
        two = {p: len(v) for p, v in snap.items() if len(v) > 1}
        assert len(two) >= 2, two
        t0 = time.perf_counter()
        removed = src.storage.compact()
        compact_s = time.perf_counter() - t0
        assert removed == sum(two.values()), (removed, two)
        assert all(len(v) == 1 for v in src.storage.manifest_snapshot().values())
        post_count = src.get_count(cql)
        post = src.knn(cql, qx, qy, k=K)
        assert post_count == n_w, (post_count, n_w)
        assert np.array_equal(pre[0], post[0]) and np.array_equal(pre[1], post[1]), \
            "compact changed the kNN answer"
        sp = check("compact", 0, 0, compact_s)
        res["compact"].update(files_removed=removed, partitions=len(two),
                              write_rows=w, write_s=write_s)
        d = np.asarray(sp[0])
        m = in_query(cols) & keep
        exp16 = oracle_knn(cols["x"], cols["y"], m, qx[:16], qy[:16], K)
        assert within_oracle(d, exp16), "kNN after the lifecycle vs the f64 oracle"
        res["ring"] = ring()
    finally:
        svc.close(drain=True)
    life_record("served lifecycle", res)


def fabric_cost(n: int = 100_000) -> dict:
    """Host microseconds the recovery fabric adds with no fault plan
    installed and every breaker closed: one transfer's retried-call wrapper
    (over a no-op), and one window's attribution (recovery token and read,
    breaker states), each net of the bare loop."""
    import threading

    from geomesa_tpu_torch import faults
    from geomesa_tpu_torch.engine import device

    assert faults.current() is None and all(
        st == "closed" for st in faults.BREAKERS.states().values())
    ident = threading.get_ident()

    def noop():
        return None

    def attribution():
        tok = faults.RECOVERY.token()
        faults.RECOVERY.since(tok, thread_ident=ident)
        faults.BREAKERS.states()

    def per_call(fn, wrap):
        t0 = time.perf_counter()
        for _ in range(n):
            wrap(fn)
        return (time.perf_counter() - t0) / n * 1e6

    bare = per_call(noop, lambda fn: fn())
    return {"retried_call": per_call(noop, device._device_retry) - bare,
            "window_attribution": per_call(attribution, lambda fn: fn()) - bare,
            "calls": n}


def life_faults(torch, ds, src, a: dict, card_s: str) -> None:
    """(b): a seeded fault plan under the three routes, then an outage that
    opens the device breaker, the wire's answer, and the probe."""
    from geomesa_tpu_torch import FeatureBatch, faults
    from geomesa_tpu_torch.plan.audit import ServeEvent
    from geomesa_tpu_torch.serve import QueryService, ServeConfig
    from geomesa_tpu_torch.utils.metrics import metrics

    qx, qy, cql = a["qx"], a["qy"], a["cql"]
    rng = np.random.default_rng(162)
    res = {"routes": {}, "fabric_us": fabric_cost()}
    log(f"recovery fabric with no plan installed and every breaker closed: "
        f"{res['fabric_us']['retried_call']:.3f} us a retried-call wrapper, "
        f"{res['fabric_us']['window_attribution']:.3f} us a window's "
        f"attribution (host) [{card_s}]")
    for r, route in enumerate(("serial", "pipelined", "ring")):
        day = T0 + (10 + r) * 86_400_000
        src.write(FeatureBatch.from_pydict(src.sft, {
            "speed": np.full(64, 10.0), "dtg": day + rng.integers(0, 3_600_000, 64),
            "geom": np.stack([rng.uniform(-30, 30, 64), rng.uniform(30, 60, 64)], 1)}))
        svc = QueryService(ds, ServeConfig(max_wait_ms=0.0, **DEV_ROUTES[route]))
        plan = faults.FaultPlan(rules=[
            faults.FaultRule(site="device.transfer", error="io", every=3),
            faults.FaultRule(site="fs.read_partition", error="io", every=2)],
            seed=16 + r)
        n0 = len(ds.audit.snapshot())
        try:
            with faults.active(plan) as h:
                got = [svc.knn("gdelt", cql, qx[i:i + 1], qy[i:i + 1], k=K
                               ).result(timeout=600) for i in range(LIFE_SERVED)]
                log_ = h.fire_log()
        finally:
            svc.close(drain=True)
        events = [e for e in ds.audit.snapshot()[n0:] if isinstance(e, ServeEvent)]
        retries = sum(e.retries for e in events)
        fired = sum(e.fault_injected for e in events)
        assert len(events) == LIFE_SERVED, len(events)
        assert log_ and retries == fired == len(log_), (route, retries, fired, len(log_))
        assert all(e.status == "ok" and e.breaker_state == "" for e in events), route
        for i, (d, ix, _) in enumerate(got):
            sd, six, _ = src.knn(cql, qx[i:i + 1], qy[i:i + 1], k=K)
            assert np.array_equal(d, sd) and np.array_equal(ix, six), (route, i)
        # a retried window against a clean one of the same route: the
        # routes' windows differ, so only a gap within a route is a retry's
        retried_ms = [e.exec_ms for e in events if e.retries]
        clean_ms = [e.exec_ms for e in events if not e.retries]
        p50 = lambda v: statistics.median(v) if v else None  # noqa: E731
        sites = {}
        for site, _, _ in log_:
            sites[site] = sites.get(site, 0) + 1
        res["routes"][route] = {"requests": LIFE_SERVED, "retries": retries,
                                "faults": fired, "fire_log": len(log_),
                                "by_site": sites,
                                "retried_window_p50_ms": p50(retried_ms),
                                "retried_windows": len(retried_ms),
                                "clean_window_p50_ms": p50(clean_ms),
                                "clean_windows": len(clean_ms)}
        log(f"faults on the {route} route: {LIFE_SERVED} kNN answers == the "
            f"fault-free answers; ServeEvents carry {retries} retries and "
            f"{fired} injected faults == the fire log ({sites}); window exec "
            f"p50 retried {p50(retried_ms)} ms over {len(retried_ms)}, clean "
            f"{p50(clean_ms)} ms over {len(clean_ms)} [{card_s}]")

    # an outage: device.transfer fails every time
    names = ("open", "half_open", "close")
    before = {n: metrics.counters.get(f"fault.breaker.device.{n}", 0.0) for n in names}
    faults.BREAKERS.configure("device", failure_threshold=5,
                              reset_timeout_s=LIFE_RESET_S)
    try:
        svc = QueryService(ds, ServeConfig(max_wait_ms=0.0))
        outage = faults.FaultPlan(rules=[faults.FaultRule(
            site="device.transfer", error="io", every=1)])
        errors = []
        try:
            with faults.active(outage):
                for i in range(3):
                    try:
                        svc.knn("gdelt", cql, qx[i:i + 1], qy[i:i + 1],
                                k=K).result(timeout=600)
                        errors.append(None)
                    except Exception as e:  # noqa: BLE001 — typed, checked below
                        assert faults.is_typed(e), repr(e)
                        errors.append(type(e).__name__)
                state = faults.BREAKERS.states()["device"]
                knn = {"id": "u", "op": "knn", "typeName": "gdelt", "cql": cql,
                       "x": [float(qx[0])], "y": [float(qy[0])], "k": K}
                docs, _ = wire_drive(ds, [knn], binary=False)
        finally:
            svc.close(drain=True)
        down = docs["u"][0]
        assert state == "open" and errors[-1] == "BreakerOpen", (state, errors)
        assert down["error"] == "unavailable" and not down["ok"], down
        assert 0 < down["retryAfterS"] <= LIFE_RESET_S, down
        time.sleep(LIFE_RESET_S + 0.1)
        docs, _ = wire_drive(ds, [dict(knn, id="p")], binary=False)
        up = docs["p"][0]
        sd, six, _ = src.knn(cql, qx[:1], qy[:1], k=K)
        assert up["ok"] and faults.BREAKERS.states()["device"] == "closed", up
        assert np.array_equal(np.asarray(up["indices"]), six), "probe answer"
    finally:
        faults.BREAKERS.restore_config("device")
    moved = {n: metrics.counters.get(f"fault.breaker.device.{n}", 0.0) - before[n]
             for n in names}
    assert moved["open"] >= 1 and moved["half_open"] >= 1 and moved["close"] >= 1, moved
    res["outage"] = {"errors": errors, "state": state, "wire": {
        k: down[k] for k in ("error", "reason", "retryAfterS")},
        "transitions": moved, "probe_ok": True}
    log(f"outage: device.transfer failing every time gave {errors}; the device "
        f"breaker opened, the wire answered {res['outage']['wire']}; after "
        f"{LIFE_RESET_S} s a half-open probe closed it and answered "
        f"(transitions {moved}) [{card_s}]")
    life_record("faults", res)


def gdelt_tsv(path: str, n: int, seed: int):
    """A GDELT 1.0 events TSV (57 columns) of `n` seeded events and the
    values the converter must read from it."""
    rng = np.random.default_rng(seed)
    eid = np.char.mod("%d", 700_000_000 + seed * n + np.arange(n))
    day = np.char.mod("%d", LIFE_DAY0 + rng.integers(0, 5, n))
    a1 = np.array(["USA", "", "CHN", "RUS", "FRA", "GOV"])[rng.integers(0, 6, n)]
    a2 = np.array(["", "MIL", "BUS", "UNITED NATIONS"])[rng.integers(0, 4, n)]
    code = np.char.mod("%03d", rng.integers(10, 200, n))
    gold = np.char.mod("%.1f", rng.uniform(-10, 10, n))
    ment = np.char.mod("%d", rng.integers(1, 80, n))
    lat = np.char.mod("%.4f", rng.uniform(-60, 70, n))
    lon = np.char.mod("%.4f", rng.uniform(-180, 180, n))
    gap = lambda k: "\t" * k  # noqa: E731
    fmt = ("{}\t{}" + gap(5) + "{}" + gap(10) + "{}" + gap(10) + "{}" + gap(4)
           + "{}\t{}" + gap(22) + "{}\t{}" + gap(2) + "\n")
    with open(path, "w") as f:
        f.writelines(fmt.format(*v) for v in zip(
            eid, day, a1, a2, code, gold, ment, lat, lon))
    dmap = {d: int(np.datetime64(f"{d[:4]}-{d[4:6]}-{d[6:]}", "ms").astype(np.int64))
            for d in np.unique(day).tolist()}
    return {"GlobalEventID": eid.tolist(), "EventCode": code.tolist(),
            "Actor1Name": np.where(a1 == "", "UNKNOWN", a1).tolist(),
            "Actor2Name": np.where(a2 == "", "UNKNOWN", a2).tolist(),
            "GoldsteinScale": gold.astype(np.float64),
            "NumMentions": ment.astype(np.int32),
            "dtg": np.array([dmap[d] for d in day.tolist()], np.int64),
            "geom": np.stack([lon.astype(np.float64), lat.astype(np.float64)], 1)}


def life_convert(torch, dev, root: str, card_s: str) -> None:
    """(c)-(e): converter job, export, Arrow store, scan batch size, then
    the stores' removal."""
    import os
    import threading

    from geomesa_tpu_torch import DataStore, FeatureBatch, Query
    from geomesa_tpu_torch.convert import converter_from_config
    from geomesa_tpu_torch.convert.schemas import GDELT_CONVERTER, GDELT_SFT
    from geomesa_tpu_torch.core.arrow_io import write_ipc
    from geomesa_tpu_torch.jobs import export_partitions, ingest_files
    from geomesa_tpu_torch.serve import QueryService, ServeConfig
    from geomesa_tpu_torch.store.arrow_store import ArrowDataStore
    from geomesa_tpu_torch.utils.config import SystemProperties

    os.makedirs(root, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    res = {}
    lap = Laps()
    t0 = time.perf_counter()
    files, parts = [], []
    for i in range(LIFE_FILES):
        p = os.path.join(root, f"events-{i}.tsv")
        parts.append(gdelt_tsv(p, LIFE_FILE_ROWS, i))
        files.append(p)
    gen_s = time.perf_counter() - t0
    vals = {k: (sum((p[k] for p in parts), []) if isinstance(parts[0][k], list)
                else np.concatenate([p[k] for p in parts])) for k in parts[0]}
    n = len(vals["GlobalEventID"])
    x, y = vals["geom"][:, 0], vals["geom"][:, 1]
    fids = np.asarray(vals["GlobalEventID"])
    lap("tsv")

    conv = DataStore(os.path.join(root, "converted"), use_device_cache=True, device=dev)
    csrc = conv.create_schema(GDELT_SFT)
    factory = lambda: converter_from_config(GDELT_SFT, GDELT_CONVERTER)  # noqa: E731
    t0 = time.perf_counter()
    rep = ingest_files(csrc, factory, files, workers=LIFE_WORKERS)
    ingest_s = time.perf_counter() - t0
    lap("ingest")
    again = ingest_files(csrc, factory, files, workers=LIFE_WORKERS)
    lap("resume")
    assert len(rep.files_ok) == LIFE_FILES and not rep.files_failed, rep.files_failed
    assert rep.features == n and rep.records_failed == 0, (rep.features, n)
    assert sorted(again.skipped) == sorted(files) and again.features == 0, again
    res["ingest"] = {"files": LIFE_FILES, "rows": n, "seconds": ingest_s,
                     "rows_per_s": n / ingest_s, "tsv_write_s": gen_s,
                     "workers": LIFE_WORKERS, "resume_skipped": len(again.skipped)}
    log(f"converter job: {LIFE_FILES} GDELT 1.0 TSV files, {n} rows, through "
        f"GDELT_CONVERTER on {LIFE_WORKERS} workers in {ingest_s:.3f} s "
        f"({n / ingest_s:.1f} rows/s; the files written in {gen_s:.3f} s); a "
        f"resumed run skipped all {len(again.skipped)} [{card_s}]")

    direct = DataStore(os.path.join(root, "direct"), use_device_cache=True, device=dev)
    dsrc = direct.create_schema(GDELT_SFT)
    batch = FeatureBatch.from_pydict(GDELT_SFT, {k: v for k, v in vals.items()},
                                     fids=vals["GlobalEventID"])
    dsrc.write(batch)
    lap("direct write")
    gq = "BBOX(geom, -30, 20, 40, 60) AND GoldsteinScale > 0.0"
    gm = (x >= -30) & (x <= 40) & (y >= 20) & (y <= 60) & (vals["GoldsteinScale"] > 0)
    rq = np.random.default_rng(163)
    gx, gy = rq.uniform(-20, 30, Q), rq.uniform(25, 55, Q)
    with Launches() as lk:
        c_count, d_count = csrc.get_count(gq), dsrc.get_count(gq)
        c_knn, d_knn = csrc.knn(gq, gx, gy, k=K), dsrc.knn(gq, gx, gy, k=K)
    assert c_count == d_count == int(gm.sum()), (c_count, d_count, int(gm.sum()))
    assert same_coord_sets(c_knn, d_knn), "converted vs direct kNN"
    assert np.array_equal(np.sort(c_knn[0], 1), np.sort(d_knn[0], 1))
    assert within_oracle(np.asarray(c_knn[0]), oracle_knn(x, y, gm, gx[:16], gy[:16], K))
    assert lk.counts["chord_blockmin_sparse"] > 0, lk.counts
    res["stores_agree"] = {"count": c_count, "launches": lk.counts}
    lap("stores agree")
    log(f"converted == direct: count {c_count} == f64 oracle, kNN (B1, Q={Q}, "
        f"k={K}) neighbour sets equal and within the bench rule [{card_s}]")

    # export with a polygon filter through mask_refined
    wkt = LIFE_POLY
    exported, lock = {}, threading.Lock()

    def writer(name, b):
        got = sorted(b.fids.vocab[c] for c in b.fids.codes)
        with lock:
            exported[name] = got

    with Launches() as le:
        t0 = time.perf_counter()
        names = export_partitions(csrc, writer, f"INTERSECTS(geom, {wkt})",
                                  workers=LIFE_WORKERS)
        export_s = time.perf_counter() - t0
    inside = f64_polygon_mask(torch, dev, x, y, wkt)
    day = np.datetime_as_string(vals["dtg"].astype("datetime64[ms]"), unit="D")
    oracle = {}
    for d in np.unique(day[inside]):
        oracle[d.replace("-", "/")] = sorted(fids[inside & (day == d)].tolist())
    lap("export")
    assert exported == oracle and sorted(names) == sorted(oracle), "export vs f64 oracle"
    assert le.counts["pip_crossing"] > 0 and le.counts["pip_band"] > 0, le.counts
    res["export"] = {"partitions": len(names), "rows": int(inside.sum()),
                     "seconds": export_s, "launches": le.counts}
    log(f"export_partitions: {len(names)} partitions, {int(inside.sum())} rows in "
        f"the polygon in {export_s:.3f} s (B4 {le.counts['pip_crossing']}, B5 "
        f"{le.counts['pip_band']} launches from {LIFE_WORKERS} threads) == the f64 "
        f"oracle row for row [{card_s}]")

    # served kNN on the converted store, so its ring captures exist
    svc = QueryService(conv, ServeConfig(max_wait_ms=0.0))
    try:
        for i in range(3):
            d, ix, b = svc.knn("gdelt", gq, gx[i:i + 1], gy[i:i + 1], k=K).result(timeout=600)
            sd, six, _ = csrc.knn(gq, gx[i:i + 1], gy[i:i + 1], k=K)
            assert np.array_equal(d, sd) and np.array_equal(ix, six)
        armed = svc.stats()["pipeline"]["ring"]["armed"]
    finally:
        svc.close(drain=True)
    lap("export oracle, served")

    # (d) the same rows as an Arrow IPC file
    path = os.path.join(root, "events.arrow")
    t0 = time.perf_counter()
    write_ipc(path, [batch])
    asrc = ArrowDataStore(path, device=dev).get_feature_source()
    open_s = time.perf_counter() - t0
    with Launches() as la:
        a_count = asrc.get_count(gq)
        a_knn = asrc.knn(gq, gx, gy, k=K)
    assert a_count == c_count and same_coord_sets(a_knn, c_knn), "Arrow store"
    assert la.counts["chord_blockmin_sparse"] > 0, la.counts
    lap("arrow")
    res["arrow"] = {"rows": len(asrc), "write_and_open_s": open_s, "count": a_count,
                    "launches": la.counts}
    log(f"ArrowDataStore: {len(asrc)} rows written and opened in {open_s:.3f} s; "
        f"count and kNN (B1) == the converted store's [{card_s}]")

    # (e) geomesa.scan.batch.size on the scan route
    scan_ds = DataStore(os.path.join(root, "converted"), device=dev)
    ssrc = scan_ds.get_feature_source("gdelt")
    sizes = []
    real = ssrc.storage.scan

    def counted(*args, **kw):
        for b in real(*args, **kw):
            sizes.append(len(b))
            yield b

    fq = Query("gdelt", "BBOX(geom, -60, -50, 60, 65) AND GoldsteinScale > -5.0")

    def fids_of(r):
        f = r.features
        return sorted(f.fids.vocab[c] for c in f.fids.codes)

    ssrc.storage.scan = counted
    try:
        base = fids_of(ssrc.get_features(fq))
        by_size = {"default": list(sizes)}
        for size in (LIFE_SCAN_BATCH, LIFE_SCAN_SMALL):
            sizes.clear()
            SystemProperties.set("geomesa.scan.batch.size", size)
            try:
                assert fids_of(ssrc.get_features(fq)) == base, size
            finally:
                SystemProperties.clear("geomesa.scan.batch.size")
            assert sizes and max(sizes) <= size, (size, max(sizes))
            by_size[size] = list(sizes)
    finally:
        ssrc.storage.scan = real
    # the small size cuts the row groups' batches; the default does not
    assert len(by_size[LIFE_SCAN_SMALL]) > len(by_size["default"]), by_size
    lap("scan batch")
    res["scan_batch"] = {str(k): {"batches": len(v), "largest": max(v)}
                         for k, v in by_size.items()}
    res["scan_batch"]["rows"] = len(base)
    log("geomesa.scan.batch.size: the scan route's " + "; ".join(
        f"{k}: {len(v)} batches, the largest {max(v)} rows"
        for k, v in by_size.items()) + f"; the same {len(base)} rows each "
        f"[{card_s}]")

    # remove the stores: residency and captures leave the card
    del asrc, a_knn, c_knn, d_knn, ssrc, scan_ds, svc, batch, b, d, ix
    conv.remove_schema("gdelt")
    direct.remove_schema("gdelt")
    del csrc, dsrc, conv, direct
    gc.collect()
    torch.cuda.empty_cache()
    mem1 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    assert mem1 - mem0 <= LIFE_MEM_SLACK, (mem0, mem1)
    lap("remove")
    res["memory"] = {"before": mem0, "after": mem1, "ring_armed": armed}
    res["laps_s"] = lap.seconds
    log("converters laps: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                        lap.seconds.items()))
    log(f"remove_schema + service close: memory_allocated {mem1} bytes after, "
        f"{mem0} before the stores existed [{card_s}]")
    life_record("converters", res)


def main() -> int:
    # a crash in native code prints every thread's Python stack
    faulthandler.enable()
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
    layer_kernel_check(torch, dev)
    if args.rows != 1 << 26:
        log(f"kNN and density stores cut to {args.rows} rows by --rows")
    launches, inputs, knn_ops, serve, serve_dev = main_path(
        torch, ks, dev, args.rows, card_s)
    rows = kernel_rows(torch, ks, launches, inputs, card_s)
    del inputs
    torch.cuda.empty_cache()
    launches, inputs = density_path(torch, dev, args.rows, card_s, wkt)
    rows += density_rows(torch, launches, inputs, card_s)
    del inputs
    torch.cuda.empty_cache()
    n2 = min(args.rows, LAYER_POINTS)
    if n2 != LAYER_POINTS:
        log(f"config-2 points cut to {n2} by --rows")
    launches, inputs, region_counts = layer_path(torch, dev, n2, card_s)
    rows += layer_rows(torch, launches, inputs, card_s)
    del inputs
    torch.cuda.empty_cache()
    ops = knn_ops + tube_engine(torch, dev, card_s)
    n5 = min(TUBE_STORE_N, max(args.rows // 4, 1 << 16))
    if n5 != TUBE_STORE_N:
        log(f"TubeSelect store cut to {n5} rows by --rows")
    ops.append(tube_process(torch, dev, n5, card_s))
    torch.cuda.empty_cache()
    PHASES["config2 sql"], b7, sql_ops = config2_sql(torch, dev, n2, card_s,
                                                     region_counts)
    ops += sql_ops
    torch.cuda.empty_cache()
    a4b_visibility(torch, dev, card_s)
    for row in rows:
        if row["name"] == "pip_assign":  # phase 6's launches, then phase 11's
            row["launches_by_phase"] = {"6": row["launches"], "11": b7}
            row["launches"] += b7
        served = serve["launches"].get(row["name"])
        if served is not None:  # phase 4's or 5's launches, then 12's and 13's
            first = "5" if row["name"] == "zsparse_counts" else "4"
            row["launches_by_phase"] = {first: row["launches"], "12": served}
            row["launches"] += served
            dev_served = serve_dev["launches"].get(row["name"])
            if dev_served is not None:
                row["launches_by_phase"]["13"] = dev_served
                row["launches"] += dev_served
    ops += GEO_OPS
    for row in rows:
        if row["name"] in GEO_LAUNCHES:  # phase 5's launches, then phase 14's
            row["launches_by_phase"] = {"5": row["launches"],
                                        "14": GEO_LAUNCHES[row["name"]]}
            row["launches"] += GEO_LAUNCHES[row["name"]]
    ops += A4B_OPS
    for row in rows:
        if row["name"] in A4B_LAUNCHES:  # then phase 15's
            row["launches_by_phase"]["15"] = A4B_LAUNCHES[row["name"]]
            row["launches"] += A4B_LAUNCHES[row["name"]]
    log(f"phase-15 launches: {A4B_LAUNCHES}")
    assert all(A4B_LAUNCHES[k] for k in ("chord_blockmin", "chord_blockmin_sparse",
                                         "pip_crossing", "pip_band")), A4B_LAUNCHES
    for row in rows:
        if row["name"] in LIFE_LAUNCHES:  # then phase 16's
            row.setdefault("launches_by_phase", {"4": row["launches"]})
            row["launches_by_phase"]["16"] = LIFE_LAUNCHES[row["name"]]
            row["launches"] += LIFE_LAUNCHES[row["name"]]
    log(f"phase-16 launches: {LIFE_LAUNCHES}")
    assert all(LIFE_LAUNCHES[k] for k in ("chord_blockmin", "chord_blockmin_sparse",
                                          "pip_crossing", "pip_band")), LIFE_LAUNCHES
    print(json.dumps({"lifecycle": PHASES.pop("lifecycle")}))
    print(json.dumps({"phases": PHASES}))
    print(json.dumps({"device_ops": ops}))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"serve_device": serve_dev}))
    print(json.dumps({"kernels": rows}))
    print(card_s)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
