#!/usr/bin/env python3
"""What the stats sketches cost a query: the planner's per-plan estimate.

Every `QueryPlanner.plan` reads the write-path stats sketches for the
"Estimated matches" line (`_stats_estimate`: a file mtime check and a sum
over the Z3 sketch's cells). This script builds chip_smoke.py's density
store (config 4's NYC-shaped pickups, monthly partitions, Morton order)
on the card and times, in alternating pairs within one process, the zone
polygon count (host-bound: its f64 re-check), a BBOX kNN and `plan`
alone, with the estimate as shipped and with it stubbed out:

    python3 scripts/torch_plan_stats_cost.py [--rows N] [--pairs P]

It prints one line per comparison and, last, one JSON object of every
number, each stamped with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, reps: int) -> float:
    """Median host seconds of fn (each call ends in a host result)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_plan_stats_cost: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from geomesa_tpu_torch import DataStore, FeatureBatch, Query, SimpleFeatureType
    from geomesa_tpu_torch.engine.kernels import build
    from geomesa_tpu_torch.store.partition import DateTimeScheme

    card = cs.card()
    build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    n = args.rows
    env = cs.ENV
    x = rng.uniform(env[0], env[2], n)
    y = rng.uniform(env[1], env[3], n)
    t = rng.integers(cs.D_T0, cs.D_T1, n)
    order = cs.morton_order(torch, torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev))
    x, y, t = x[order], y[order], t[order]
    iv3 = f"dtg > {cs.iso(cs.P_T0)} AND dtg < {cs.iso(cs.P_T1)}"
    poly = f"INTERSECTS(geom, {cs.zone_polygon()}) AND {iv3}"
    bbox = f"BBOX(geom, -74.0, 40.7, -73.9, 40.8) AND {iv3}"
    qx = rng.uniform(-74.0, -73.9, 256)
    qy = rng.uniform(40.7, 40.8, 256)
    res = {"card": card, "rows": n, "pairs": args.pairs}
    with tempfile.TemporaryDirectory() as tmp:
        ds = DataStore(tmp, use_device_cache=True, device=dev)
        sft = SimpleFeatureType.from_spec("taxi", "fare:Double,dtg:Date,*geom:Point")
        src = ds.create_schema(sft, DateTimeScheme("yyyy/MM", "dtg"))
        src.write(FeatureBatch.from_pydict(sft, {
            "fare": rng.uniform(0, 5, n), "dtg": t, "geom": np.stack([x, y], 1)}))
        planner = src.planner
        calls = {"polygon count": (lambda: src.get_count(poly), 1),
                 "knn sparse": (lambda: src.knn(bbox, qx, qy, k=10), 3),
                 "plan": (lambda: planner.plan(Query("taxi", poly)), 50)}
        for fn, _ in calls.values():
            fn()  # residency, compiles, calibration
        for name, (fn, reps) in calls.items():
            on, off = [], []
            for i in range(args.pairs):
                for side in ((0, 1) if i % 2 == 0 else (1, 0)):
                    if side:
                        planner._stats_estimate = lambda bbox, interval: None
                        off.append(timed(fn, reps))
                        del planner._stats_estimate
                    else:
                        on.append(timed(fn, reps))
            res[name] = {"with_ms": [v * 1e3 for v in on],
                         "without_ms": [v * 1e3 for v in off]}
            won = sum(a < b for a, b in zip(on, off))
            print(f"{name}: with the stats estimate median "
                  f"{statistics.median(on) * 1e3:.4f} ms, without "
                  f"{statistics.median(off) * 1e3:.4f} ms; with < without in "
                  f"{won} of {args.pairs} pairs [{card}]", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
