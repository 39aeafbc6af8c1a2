#!/usr/bin/env python3
"""Compare two checkouts' `chip_smoke.py` runs on one card, in the order
A, B, B, A, so that a drift of the machine over the call weighs on both.

    python3 scripts/torch_smoke_ab.py --a PARENT_DIR --b . --out OUT_DIR

Each run is `python3 -u chip_smoke.py` from the root of its checkout. Its
output goes to OUT/<i>_<label>.log, each line prefixed with the seconds
since the run started. OUT/summary.json, also printed, holds for each run
its exit code and wall seconds, the seconds at which the phases' marker
lines appeared (MARKERS: the first line that starts with the prefix), and
every "NAME: ... warm p50 X ms" line's X, each "serve ROUTE LOAD: Q served
qps, p50 X ms" line's Q and X (phases 12-13), plus the feature route's
split from the {"phases": ...} line. It stops at the first run that fails.
Needs a CUDA card, as chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

# phase -> prefix of the first log line at (or near) its start
MARKERS = {
    "3 kernel check": "  ptxas",
    "4 kNN store ingest": "ingest:",
    "7 features (kNN store)": "features cached, limit:",
    "9 kNN process": "knn process launches:",
    "12 serve": "serve windows:",
    "5 density": "density-path launches:",
    "6 config 2 layer": "config 2 layer:",
    "8 TubeSelect": "tube_select dense:",
    "11 config 2 as SQL": "config-2 stores:",
    "end": '{"ok": true',
}
P50 = re.compile(r"^(?P<name>[^:\[{]+): (?:cold [0-9.]+ m?s, )?warm p50 "
                 r"(?P<p50>[0-9.]+) ms")
SERVED = re.compile(r"^serve (?P<name>[^:]+): (?P<qps>[0-9.]+) served qps, "
                    r"p50 (?P<p50>[0-9.]+) ms")


def run_one(root: str, log_path: str, timeout_s: float) -> dict:
    t0 = time.perf_counter()
    marks, p50, served, phases = {}, {}, {}, None
    with open(log_path, "w") as log, subprocess.Popen(
            [sys.executable, "-u", "chip_smoke.py"], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) as proc:
        try:
            for line in proc.stdout:
                at = time.perf_counter() - t0
                log.write(f"{at:9.3f} {line}")
                for phase, prefix in MARKERS.items():
                    if phase not in marks and line.startswith(prefix):
                        marks[phase] = at
                m = P50.match(line)
                if m and m["name"] not in p50:
                    p50[m["name"]] = float(m["p50"])
                m = SERVED.match(line)
                if m and m["name"] not in served:
                    served[m["name"]] = {"qps": float(m["qps"]),
                                         "p50_ms": float(m["p50"])}
                if line.startswith('{"phases"'):
                    phases = json.loads(line)["phases"]
                if at > timeout_s:
                    proc.kill()
                    break
        finally:
            rc = proc.wait()
    out = {"root": root, "rc": rc, "wall_s": time.perf_counter() - t0,
           "markers_s": marks, "warm_p50_ms": p50, "served": served}
    if phases is not None:
        knn = phases.get("features knn store", {})
        out["features_split_s"] = {
            "cached": knn.get("features cached", {}).get("split"),
            "polygon": phases.get("features density store", {}).get("split")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (the parent)")
    ap.add_argument("--b", required=True, help="checkout B (the change)")
    ap.add_argument("--out", required=True,
                    help="directory for the run logs and summary.json")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds a run may take")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi"
    runs = []
    for i, label in enumerate(args.order):
        root = os.path.abspath(args.a if label == "A" else args.b)
        log_path = os.path.join(args.out, f"{i}_{label}.log")
        res = run_one(root, log_path, args.timeout)
        res["label"] = label
        runs.append(res)
        print(f"run {i} ({label}): rc {res['rc']}, {res['wall_s']:.1f} s",
              flush=True)
        if res["rc"] != 0:
            break  # a failed run's numbers compare with nothing
    summary = {"card": card, "order": args.order, "runs": runs}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
