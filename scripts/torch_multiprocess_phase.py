#!/usr/bin/env python3
"""Phase 21 of `chip_smoke.py` alone: the multi-process runtime (two
ranks x two shards of one mesh on cuda:0 over gloo) on phase 4's store,
after the one-process answers it is gated against.

    python3 scripts/torch_multiprocess_phase.py [--rows N]

Builds the CUDA kernels of the checkout first (one nvcc each, in
parallel), writes phase 4's kNN store (`--rows`, default 2^26, in phase
4's Morton order; without phases 9-18 before it) and makes every
partition resident, runs `chip_smoke.mesh_store_phase` and
`chip_smoke.mesh_ring_phase` (phases 19 (a) and 20 (a): the one-process
mesh's answers, each gated equal to the single card's), then
`chip_smoke.mp_phase` with every gate of the full smoke: the ranks are
this checkout's `chip_smoke.py --phase21-rank R`. Prints the phase's
lines, its {"multiprocess": ...} JSON line and the card's name and power
limit last. Exits 1 without a CUDA device.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 26)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_multiprocess_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from geomesa_tpu_torch import DataStore, FeatureBatch, SimpleFeatureType
    from geomesa_tpu_torch.engine.kernels import build

    card_s = cs.card()
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"build in {time.perf_counter() - t0:.2f} s [{card_s}]")
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    n = args.rows
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    qx = rng.uniform(-30, 30, cs.Q)
    qy = rng.uniform(30, 60, cs.Q)
    order = cs.morton_order(torch, torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev))
    x, y = x[order], y[order]
    t = rng.integers(1_590_000_000_000, 1_600_000_000_000, n)
    speed = rng.uniform(0, 30, n)
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
        src.get_count("INCLUDE")  # every partition resident
        src.knn(cql, qx, qy, k=cs.K)  # the capacity calibrated
        cs.log(f"store: {n} rows written and resident in "
               f"{time.perf_counter() - t0:.3f} s [{card_s}]")
        single = cs.mesh_store_phase(torch, ds, src, dict(qx=qx, qy=qy, cql=cql),
                                     card_s)
        cs.mesh_ring_phase(torch, ds, src, dict(cql=cql), single, card_s)
        cs.mp_phase(torch, ds, src, dict(qx=qx, qy=qy, cql=cql), single, tmp,
                    card_s)
    print(card_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
