"""One rank of the port's multi-process tests (not collected by pytest).

Run as `python tests/torch_mp_ranks.py SCENARIO --init file://... --world
N --rank R --out DIR --devices cpu,cpu [--root PATH]`: the rank joins a
gloo group over the `file://` init, runs SCENARIO over a mesh that spans
the ranks (`global_mesh(devices)`) and writes what it saw to
`DIR/rank<R>.json` (scalars, strings) and `DIR/rank<R>.npz` (arrays),
for tests/test_torch_distributed.py and tests/test_torch_multiprocess.py
to assert from. It imports the port only. Those tests feed the seeded
inputs below to the one-process mesh and the reference too.

Scenarios:
  runtime  the coordinator gates, the dump suffix, `smoke_step` and the
           fingerprint check (one rank patched to differ).
  smoke    `smoke_step` only.
  store    a store's counts, densities, kNN, refusals, served kNN
           (pipelined and ring) and a growth write (`store_answers`),
           then the engine's sharded functions on seeded inputs
           (`run_engine`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

NAME = "meshed"
SPEC = "name:String,score:Double,dtg:Date,*geom:Point"
DAYS = ("2020-06-01", "2020-06-02", "2020-06-03", "2020-06-04")
GROW_DAY = "2020-06-05"
ROWS_PER_DAY = 256
CQL = "BBOX(geom, -170, -80, 170, 80) AND score > -5"
# prunes to day 3 = partition 2 = shard 2 alone (rank 1's on 2 x 2)
CQL_DAY3 = CQL + " AND dtg DURING 2020-06-03T00:00:00Z/2020-06-03T23:59:59Z"
# prunes to day 1 = shard 0 (rank 0's): rank 1's shards hold no match
CQL_DAY1 = CQL + " AND dtg DURING 2020-06-01T00:00:00Z/2020-06-01T23:59:59Z"
DENSITY = dict(density_bbox=(-170, -80, 170, 80), density_width=32,
               density_height=32)
K = 5
SERVED = 8
DAY = 86_400_000


def _day_millis(day: str) -> int:
    return int(np.datetime64(day, "ms").astype(np.int64))


def rows(per_day=ROWS_PER_DAY, days=DAYS, seed=11):
    rng = np.random.default_rng(seed)
    n = per_day * len(days)
    dtg = np.concatenate([_day_millis(d) + rng.integers(
        6 * 3600_000, 18 * 3600_000, per_day) for d in days])
    return {"name": rng.choice(["a", "b", "c"], n).tolist(),
            "score": rng.uniform(-10, 10, n), "dtg": dtg,
            "geom": np.stack([rng.uniform(-170, 170, n),
                              rng.uniform(-80, 80, n)], 1)}


def queries(n: int = 6, seed: int = 42):
    rng = np.random.default_rng(seed)
    return rng.uniform(-60, 60, n), rng.uniform(-40, 40, n)


def served_points(seed: int = 13):
    return np.random.default_rng(seed).uniform(-60, 60, (SERVED, 2))


# -- the engine's inputs (shared with the tests) -----------------------------


def knn_inputs(seed: int = 1, n: int = 4 * 32768):
    """Points whose first two shards (rank 0's on 2 x 2) bear many match
    tiles and the last two one each: a capacity of 1 overflows rank 0's
    shards only."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-30, 30, n).astype(np.float32)
    y = rng.uniform(-30, 30, n).astype(np.float32)
    m = rng.random(n) < 0.5
    half = n // 2
    tail = m[half:].reshape(2, 2, -1)
    tail[:, 1, :] = False  # one match tile a shard in the back half
    m[half:] = tail.reshape(-1)
    qx = rng.uniform(-25, 25, 8).astype(np.float32)
    qy = rng.uniform(-25, 25, 8).astype(np.float32)
    return qx, qy, x, y, m


def density_inputs(seed: int = 6, n: int = 4 * 4096):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-74.2, -73.8, n).astype(np.float32)
    y = rng.uniform(40.6, 40.9, n).astype(np.float32)
    o = np.argsort(np.round((x + 74.2) * 40) * 1000 + y)
    x, y = x[o], y[o]
    w = np.ones(n, np.float32)
    m = rng.random(n) < 0.8
    return x, y, w, m, (-74.2, 40.6, -73.8, 40.9), 64, 48


def stats_inputs(seed: int = 2, n: int = 8192):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-5, 5, n).astype(np.float32)
    x = rng.uniform(-180, 180, n).astype(np.float32)
    y = rng.uniform(-90, 90, n).astype(np.float32)
    tb = rng.integers(0, 4, n).astype(np.int32)
    m = rng.random(n) < 0.7
    return v, x, y, tb, m


def tube_inputs(seed: int = 3, n: int = 16384):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20, 20, n)
    y = rng.uniform(40, 70, n)
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


def _ccw_ring(cx, cy, ne, rx, ry):
    th = np.linspace(0, 2 * np.pi, ne, endpoint=False)
    r = np.stack([cx + rx * np.cos(th), cy + ry * np.sin(th)], 1)
    r = np.concatenate([r, r[:1]])
    return r[:-1, 0], r[:-1, 1], r[1:, 0], r[1:, 1]


def polygon_inputs(seed: int = 4, d: int = 4):
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(12):
        cx, cy = rng.uniform(-30, 30, 2)
        parts.append(_ccw_ring(cx, cy, 23 + i, rng.uniform(2, 8),
                               rng.uniform(2, 8)))
        if i % 3 == 0:  # a hole: a clockwise inner ring
            h = _ccw_ring(cx, cy, 17, 1.0, 1.0)
            parts.append((h[2], h[3], h[0], h[1]))
    cols = [np.concatenate([p[k] for p in parts]).astype(np.float32)
            for k in range(4)]
    n = len(cols[0])
    pad = (-n) % d
    cols = [np.concatenate([c, np.zeros(pad, np.float32)]) for c in cols]
    w = np.ones(n + pad, np.float32)
    em = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return (*cols, w, em), ((-40.0, -40.0, 40.0, 40.0), 64, 48, 16)


def layer_inputs(seed: int = 5):
    rng = np.random.default_rng(seed)
    parts = [_ccw_ring(*rng.uniform(-40, 40, 2), 24, *rng.uniform(3, 9, 2))
             for _ in range(10)]
    x1, y1, x2, y2 = (np.concatenate([p[k] for p in parts]) for k in range(4))
    pol = np.concatenate([np.full(24, i, np.int64) for i in range(10)])
    n = 7 * 512 + 100
    px = rng.uniform(-50, 50, n)
    py = rng.uniform(-50, 50, n)
    o = np.argsort(px + 1e-3 * py)
    return px[o], py[o], x1, y1, x2, y2, pol


def run_engine(mesh, out: dict, arrays: dict) -> None:
    """The engine's sharded functions over `mesh` (one process's or a
    process mesh); merged results whole, sharded results by shard."""
    import torch

    from geomesa_tpu_torch.engine import density_zsparse as dz
    from geomesa_tpu_torch.engine import grid_index as gi
    from geomesa_tpu_torch.engine import knn as kn
    from geomesa_tpu_torch.engine import knn_scan as ks
    from geomesa_tpu_torch.engine import pip_sparse as ps
    from geomesa_tpu_torch.engine import raster as ras
    from geomesa_tpu_torch.engine import stats as st
    from geomesa_tpu_torch.engine import tube as tb
    from geomesa_tpu_torch.errors import RemoteShardError
    from geomesa_tpu_torch.parallel.mesh import Sharded, shards_of

    def T(*a):
        return [torch.from_numpy(np.ascontiguousarray(v)) for v in a]

    def put(name, t):
        arrays[name] = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    def put_sharded(name, s):
        for i in mesh.local:
            arrays[f"{name}.{i}"] = s.shards[i].cpu().numpy()

    qx, qy, x, y, m = knn_inputs()
    for cap in (8, 1):
        d, i, ov = ks.knn_sparse_sharded(mesh, *T(qx, qy, x, y, m), k=K,
                                         tile_capacity=cap)
        put(f"knn_sparse.{cap}.d", d)
        put(f"knn_sparse.{cap}.i", i)
        out[f"knn_sparse.{cap}.ov"] = bool(ov)
        if ov:  # the caller's fallback: B2 on every shard
            d, i = ks.make_knn_fullscan_sharded(mesh)(*T(qx, qy, x, y, m), k=K)
            put(f"knn_fullscan.{cap}.d", d)
            put(f"knn_fullscan.{cap}.i", i)
    out["shard_match_tiles"] = int(ks.shard_match_tiles(
        Sharded(mesh, shards_of(mesh, T(m)[0])), mesh.size))
    sx, sy = qx[:4], qy[:4]
    d, i = kn.knn_sharded(mesh, *T(sx, sy, x[:8192], y[:8192], m[:8192]), k=K,
                          debug_check=True)
    put("knn_sharded.d", d)
    put("knn_sharded.i", i)
    d, i, ov = kn.knn_compact_sharded(mesh, *T(sx, sy, x[:8192], y[:8192],
                                               m[:8192]), k=K, capacity=2048)
    put("knn_compact.d", d)
    put("knn_compact.i", i)
    out["knn_compact.ov"] = bool(ov)
    try:
        kn.knn_ring(mesh, *T(x[:64], y[:64], x[:8192], y[:8192], m[:8192]), k=K)
        out["knn_ring"] = "answered"
    except RemoteShardError as e:
        out["knn_ring"] = type(e).__name__
    d, i, unc = gi.knn_indexed_sharded(mesh, *T(sx, sy, x[:8192], y[:8192],
                                                m[:8192]), k=K, g=64,
                                       ring_radius=2, cell_slots=64)
    put("knn_indexed.d", d)
    put("knn_indexed.i", i)
    put("knn_indexed.u", unc)
    dx, dy, dw, dm, bbox, w, h = density_inputs()
    put("zsparse", dz.density_zsparse_sharded(mesh, *T(dx, dy, dw, dm), bbox,
                                              w, h, data_tile=1024))
    v, sx_, sy_, stb, sm = stats_inputs()
    got = st.stats_sharded(mesh, lambda v, x, y, t, m: (
        st.masked_count(m), st.masked_histogram(v, m, -5.0, 5.0, 16),
        {"z3": st.z3_histogram(x, y, t, m, 4, 8)},
        st.masked_moments(v, m)), *T(v, sx_, sy_, stb, sm))
    put("stats.count", got[0])
    put("stats.hist", got[1])
    put("stats.z3", got[2]["z3"])
    put("stats.moments", torch.stack([t.double() for t in got[3]]))
    arrs = tube_inputs()
    put_sharded("tube", tb.tube_select_sharded(mesh, *T(*arrs), 40_000.0,
                                               DAY // 6))
    for cap in (64, 1):
        hits, ov = tb.tube_select_pruned_sharded(
            mesh, *T(*arrs), 40_000.0, DAY // 6, data_tile=1024,
            tile_capacity=cap)
        out[f"tube_pruned.{cap}.ov"] = bool(ov)
        put_sharded(f"tube_pruned.{cap}", hits)
    cols, args = polygon_inputs()
    put("polygon_density", ras.polygon_density_sharded(mesh, *T(*cols), *args))
    inside, info = ps.pip_layer_sharded(mesh, *layer_inputs())
    put("pip_layer", inside)
    out["pip_layer.info"] = info


# -- spawning the ranks (from a test) -----------------------------------------


def spawn(scenario: str, world: int, devices: str, out_dir: str,
          root=None, timeout_s: float = 240.0):
    """Run `scenario` in `world` ranks (this file, one process each, gloo
    over a `file://` init in `out_dir`) and return one (json, arrays,
    log) a rank; a rank still alive at `timeout_s` is killed. Raises
    AssertionError with the logs if any rank failed."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    init = "file://" + os.path.join(out_dir, "init")
    cmd = [sys.executable, os.path.abspath(__file__), scenario, "--init", init,
           "--world", str(world), "--out", out_dir, "--devices", devices]
    if root is not None:
        cmd += ["--root", root]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=repo, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    logs, rcs = [], []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
            log += "\n[killed at the timeout]"
        logs.append(log)
        rcs.append(p.returncode)
    if any(rcs):
        raise AssertionError(f"ranks failed (rcs {rcs}):\n" + "\n----\n".join(
            log[-4000:] for log in logs))
    got = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            doc = json.load(f)
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        got.append((doc, arrays, logs[r]))
    return got


# -- scenarios -------------------------------------------------------------------


def _mtimes(paths):
    return {k: (os.stat(p).st_mtime_ns if os.path.exists(p) else None)
            for k, p in paths.items()}


def default_meshes_seen() -> dict:
    """`global_mesh()` with no device list, and the backend `initialize`
    would choose, as this rank sees them with `torch.cuda` patched to
    report 1, 2 and 4 cards on its host (no card is touched)."""
    from unittest import mock

    import torch

    from geomesa_tpu_torch.parallel import distributed as dd

    seen = {}
    for cards in (1, 2, 4):
        with mock.patch.object(torch.cuda, "is_available", return_value=True), \
                mock.patch.object(torch.cuda, "device_count", return_value=cards):
            m = dd.global_mesh()
            seen[str(cards)] = {
                "devices": [str(d) for d in m.device_list],
                "owners": list(m.owners), "local": list(m.local),
                "lead": str(m.lead),
                "backend": dd.default_backend(dd.process_index(),
                                              dd.process_count())}
    return seen


def scenario_runtime(args, out, arrays):
    import torch.distributed as dist

    from geomesa_tpu_torch.parallel import distributed as dd
    from geomesa_tpu_torch.parallel.launch import smoke_step

    out["is_coordinator"] = dd.is_coordinator()
    out["process_suffix"] = dd.process_suffix()
    out["default_mesh"] = default_meshes_seen()
    out["fingerprint"] = dd.runtime_fingerprint()
    dd.assert_uniform_runtime()
    smoke = smoke_step(args.devices, verbose=False)
    arrays["smoke.grid"] = smoke.pop("grid")
    out["smoke"] = smoke
    if args.root is None:
        return
    # the coordinator gates: rank 1 saves first, then rank 0
    from geomesa_tpu_torch import DataStore
    from geomesa_tpu_torch.approx.sketches import PartitionSketchStore
    from geomesa_tpu_torch.compilecache.manifest import WarmupManifest
    from geomesa_tpu_torch.telemetry.recorder import FlightRecorder

    ds = DataStore(args.root, use_device_cache=True, device="cpu")
    src = ds.get_feature_source("t")
    src.get_count("INCLUDE")  # residency, for the device-cache manifest
    paths = {"metadata": os.path.join(src.storage.root, "metadata.json"),
             "cache": src.planner.cache.manifest_path,
             "sidecar": os.path.join(src.storage.root, PartitionSketchStore.SIDECAR),
             "warmup": os.path.join(args.root, "warmup.json")}

    def save_all():
        src.storage._save_metadata()
        src.planner.cache.save_manifest()
        PartitionSketchStore(src.storage).save_sidecar()
        WarmupManifest().save(paths["warmup"])

    dist.barrier()
    out["gates.before"] = _mtimes(paths)
    time.sleep(0.05)
    if dist.get_rank() == 1:
        save_all()
    dist.barrier()
    out["gates.after_rank1"] = _mtimes(paths)
    time.sleep(0.05)
    if dist.get_rank() == 0:
        save_all()
    dist.barrier()
    out["gates.after_rank0"] = _mtimes(paths)
    out["dump"] = FlightRecorder().dump(os.path.join(args.out, "flight.json"))
    # one rank's fingerprint differs: both ranks raise
    real = dd.runtime_fingerprint
    if dist.get_rank() == 1:
        dd.runtime_fingerprint = lambda: real() ^ 1
    try:
        dd.assert_uniform_runtime()
        out["divergent"] = "passed"
    except RuntimeError as e:
        out["divergent"] = str(e)
    finally:
        dd.runtime_fingerprint = real


def scenario_smoke(args, out, arrays):
    from geomesa_tpu_torch.parallel.distributed import assert_uniform_runtime
    from geomesa_tpu_torch.parallel.launch import smoke_step

    assert_uniform_runtime()
    smoke = smoke_step(args.devices, verbose=False)
    arrays["smoke.grid"] = smoke.pop("grid")
    out["smoke"] = smoke


def _knn_rows(res):
    d, idx, batch = res
    col = batch.columns["geom"]
    return d, np.stack([np.asarray(col.x)[idx], np.asarray(col.y)[idx]], -1)


def scenario_store(args, out, arrays):
    import torch.distributed as dist

    from geomesa_tpu_torch.parallel.distributed import global_mesh

    mesh = global_mesh(args.devices)
    store_answers(args.root, mesh, args.devices[0], out, arrays,
                  barrier=dist.barrier, writer=dist.get_rank() == 0)
    run_engine(mesh, out, arrays)


def store_answers(root, mesh, dev, out, arrays, barrier=lambda: None,
                  writer=True):
    """The store's answers over `mesh` (a process mesh in the ranks, the
    one-process mesh in a test): counts, densities, kNN (the whole mesh,
    one rank's shards without a match, a one-shard partition), the
    refusals, served kNN (pipelined and ring) beside serial calls, and
    a growth write by `writer` (the other processes open the store
    anew: each storage loads the manifest once)."""
    import json as _json

    from geomesa_tpu_torch import DataStore, FeatureBatch, Query, QueryHints
    from geomesa_tpu_torch.errors import RemoteShardError
    from geomesa_tpu_torch.serve import QueryService, ServeConfig
    from geomesa_tpu_torch.utils.metrics import metrics

    def counter(name):
        return _json.loads(metrics.to_json())["counters"].get(name, 0.0)

    out["mesh"] = {"size": mesh.size, "local": list(mesh.local),
                   "owners": list(mesh.owners),
                   "spans_processes": mesh.spans_processes}
    ds = DataStore(root, use_device_cache=True, device=dev)
    src = ds.get_feature_source(NAME)
    src.planner.cache.ensure()
    ds.set_mesh(mesh)
    cache = src.planner.cache
    gathers0 = counter("mesh.gathers")
    up0 = cache.upload_rows
    out["count"] = int(src.get_count(CQL))
    sb = cache.superbatch()
    out["upload_rows"] = cache.upload_rows - up0
    out["shard_rows"] = sb.shard_rows
    out["resident_bytes"] = sum(cache.resident_bytes().values())
    out["count_day3"] = int(src.get_count(CQL_DAY3))
    out["count_day1"] = int(src.get_count(CQL_DAY1))
    for name, cql in (("density", CQL), ("density_day1", CQL_DAY1)):
        arrays[name] = src.get_features(Query(NAME, cql, hints=QueryHints(
            **DENSITY))).grid
    qx, qy = queries()
    local0 = counter("knn.mesh.local_dispatches")
    for name, cql in (("knn", CQL), ("knn_day3", CQL_DAY3),
                      ("knn_day1", CQL_DAY1)):
        arrays[f"{name}.d"], arrays[f"{name}.xy"] = _knn_rows(
            src.knn(cql, qx, qy, k=K))
    out["local_dispatches"] = counter("knn.mesh.local_dispatches") - local0
    out["gathers"] = counter("mesh.gathers") - gathers0
    if mesh.spans_processes:
        for what, q in (("features", Query(NAME, CQL)),
                        ("stats", Query(NAME, CQL, hints=QueryHints(
                            stats_string="Count();MinMax(score)"))),
                        ("bin", Query(NAME, CQL, hints=QueryHints(
                            bin_track="name")))):
            try:
                src.get_features(q)
                out[f"refused.{what}"] = "answered"
            except RemoteShardError as e:
                out[f"refused.{what}"] = type(e).__name__
        out["gathers_refused"] = counter("mesh.gathers") - gathers0
    pts = served_points()
    for ring in (False, True):
        name = "ring" if ring else "pipelined"
        svc = QueryService(ds, ServeConfig(mesh=mesh, ring=ring,
                                           max_wait_ms=1.0))
        try:
            for j in range(SERVED):
                res = svc.knn(NAME, CQL, pts[j:j + 1, 0], pts[j:j + 1, 1],
                              k=K).result(timeout=120)
                arrays[f"served.{name}.{j}.d"], arrays[f"served.{name}.{j}.xy"] = (
                    _knn_rows(res))
            st = svc.stats()["pipeline"]
            out[f"served.{name}.windows"] = st.get("windows")
            out[f"served.{name}.ring_windows"] = (st.get("ring") or {}).get("windows")
        finally:
            svc.close(drain=True)
    for j in range(SERVED):
        arrays[f"serial.{j}.d"], arrays[f"serial.{j}.xy"] = _knn_rows(
            src.knn(CQL, pts[j:j + 1, 0], pts[j:j + 1, 1], k=K))
    barrier()
    if writer:
        sft = src.storage.sft
        src.write(FeatureBatch.from_pydict(sft, rows(days=(GROW_DAY,), seed=12)))
    barrier()
    if not writer:
        ds = DataStore(root, use_device_cache=True, device=dev, mesh=mesh)
        src = ds.get_feature_source(NAME)
    up0 = src.planner.cache.upload_rows
    out["grown.count"] = int(src.get_count(CQL))
    out["grown.upload_rows"] = src.planner.cache.upload_rows - up0
    arrays["grown.knn.d"], arrays["grown.knn.xy"] = _knn_rows(
        src.knn(CQL, qx, qy, k=K))
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scenario")
    ap.add_argument("--init", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--devices", default="cpu")
    ap.add_argument("--root", default=None)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)
    args.devices = args.devices.split(",")
    import torch

    torch.set_num_threads(args.threads)
    from geomesa_tpu_torch.parallel.distributed import initialize, shutdown

    out: dict = {"rank": args.rank}
    arrays: dict = {}
    initialize(args.init, args.world, args.rank, backend="gloo", timeout_s=60)
    try:
        {"runtime": scenario_runtime, "smoke": scenario_smoke,
         "store": scenario_store}[args.scenario](
            args, out, arrays)
        out["ok"] = True
    except Exception:  # noqa: BLE001 - reported to the test, then re-raised
        out["ok"] = False
        out["error"] = traceback.format_exc()
        raise
    finally:
        out["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "geomesa_tpu."))
                                for m in sys.modules)
        with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
            json.dump(out, f, default=str)
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **arrays)
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
