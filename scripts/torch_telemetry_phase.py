#!/usr/bin/env python3
"""Phase 22 of `chip_smoke.py` alone (telemetry and profiling), after
phases 12 and 13 (the serve stack), on phase 4's store; and what the span
seams cost with tracing off, parent against change, in one call.

    python3 scripts/torch_telemetry_phase.py [--rows N]
    python3 scripts/torch_telemetry_phase.py --ab PARENT_DIR [--out DIR]

The first form builds the CUDA kernels of the checkout (one nvcc each, in
parallel), writes phase 4's kNN store (`--rows`, default 2^26, in phase
4's Morton order) and makes every partition resident, then runs
`chip_smoke.serve_phase` and `chip_smoke.serve_device_phase` (phases 12
and 13, with every gate) and, where the checkout has it,
`chip_smoke.telemetry_phase` (phase 22), with the launches of B1-B5 read
around each. The loads run SERVE_LOAD_S = 2 s and DEV_LOAD_S = 1.5 s in
every checkout, so two checkouts' qps compare. `--root DIR` runs that
checkout's code instead of this one's.

The second form runs the first in PARENT_DIR and in this checkout in the
order parent, change, change, parent (each a process of its own, its
output under OUT/<i>_<label>.log) and prints every "serve ...: Q served
qps, p50 X ms" line of each run side by side as one JSON line. Needs a
CUDA card; exits 1 without one.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVED = re.compile(r"^serve (?P<name>[^:]+): (?P<qps>[0-9.]+) served qps, "
                    r"p50 (?P<p50>[0-9.]+) ms")


def run_phases(root: str, rows: int) -> int:
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from geomesa_tpu_torch import DataStore, FeatureBatch, SimpleFeatureType
    from geomesa_tpu_torch.engine import knn_scan as ks
    from geomesa_tpu_torch.engine.kernels import build

    cs.SERVE_LOAD_S, cs.DEV_LOAD_S = 2.0, 1.5
    card_s = cs.card()
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"build in {time.perf_counter() - t0:.2f} s [{card_s}]")
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    order = cs.morton_order(torch, torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev))
    x, y = x[order], y[order]
    t = rng.integers(1_590_000_000_000, 1_600_000_000_000, rows)
    speed = rng.uniform(0, 30, rows)
    b = cs.BBOX
    cql = (f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND dtg > {cs.iso(cs.T0)} "
           f"AND dtg < {cs.iso(cs.T1)} AND speed > 5.0")
    with tempfile.TemporaryDirectory() as tmp:
        ds = DataStore(tmp, use_device_cache=True, device=dev)
        sft = SimpleFeatureType.from_spec("gdelt", "speed:Double,dtg:Date,*geom:Point")
        src = ds.create_schema(sft)
        t0 = time.perf_counter()
        src.write(FeatureBatch.from_pydict(
            sft, {"speed": speed, "dtg": t, "geom": np.stack([x, y], 1)}))
        src.get_count(cql)
        cs.log(f"store: {rows} rows written and resident in "
               f"{time.perf_counter() - t0:.3f} s [{card_s}]")
        t0 = time.perf_counter()
        serve = cs.serve_phase(torch, ks, dev, ds, src, dict(
            x=x, y=y, t=t, speed=speed, cql=cql), card_s)
        cs.serve_device_phase(torch, ks, dev, ds, src, dict(cql=cql),
                              serve["load"], tmp, card_s)
        cs.log(f"phases 12-13 in {time.perf_counter() - t0:.1f} s")
        if hasattr(cs, "telemetry_phase"):
            out = cs.telemetry_phase(torch, ds, src, dict(cql=cql), tmp, card_s)
            print(json.dumps({"telemetry": out}))
    print(card_s)
    return 0


def run_ab(parent: str, out_dir: str, rows: int) -> int:
    os.makedirs(out_dir, exist_ok=True)
    summary = []
    for i, (label, root) in enumerate((("parent", parent), ("change", HERE),
                                       ("change", HERE), ("parent", parent))):
        log_path = os.path.join(out_dir, f"{i}_{label}.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            rc = subprocess.run(
                [sys.executable, "-u", os.path.abspath(__file__),
                 "--root", os.path.abspath(root), "--rows", str(rows)],
                stdout=log, stderr=subprocess.STDOUT).returncode
        served = {}
        with open(log_path) as f:
            for line in f:
                m = SERVED.match(line)
                if m:
                    served[m["name"]] = [float(m["qps"]), float(m["p50"])]
        run = {"run": i, "label": label, "rc": rc,
               "seconds": round(time.perf_counter() - t0, 1), "served": served}
        summary.append(run)
        print(json.dumps(run), flush=True)
        if rc:
            break
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return max(r["rc"] for r in summary)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 26)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--ab", default=None, metavar="PARENT_DIR")
    ap.add_argument("--out", default="telemetry_ab")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_telemetry_phase: no CUDA device", file=sys.stderr)
        return 1
    if args.ab:
        return run_ab(args.ab, args.out, args.rows)
    return run_phases(args.root, args.rows)


if __name__ == "__main__":
    sys.exit(main())
