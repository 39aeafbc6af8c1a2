#!/usr/bin/env python3
"""A burst of queued kNN requests through the serve stack's three routes.

    python3 scripts/torch_serve_burst.py [--rows N] [--requests R]

On one CUDA card: builds the kernels, writes chip_smoke.py's kNN store
(2^26 rows by default, Morton order, seed 42), queues R single-point kNN
requests of the north-star filter (k=10; 1,024 by default: 16 windows of
64), then releases them through a serial (pipeline=False, ring=False), a
pipelined (ring=False) and a ring service (the defaults), twice each,
under the interpreter's default GIL switch interval (5 ms), under 0.5 ms,
and under the default again. Each line gives the burst's wall, the median
window span (ServeEvent exec_ms) and the pipeline's host ms a window on
the dispatch thread and on the completer; the last line times one
window's finishing bookkeeping (`_finish_window`, 64 members) alone.
Exits 1 without a card.
"""

import argparse
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 26)
    ap.add_argument("--requests", type=int, default=1024)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_burst: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from geomesa_tpu_torch import DataStore, FeatureBatch, SimpleFeatureType
    from geomesa_tpu_torch.engine.kernels import build
    from geomesa_tpu_torch.plan.audit import ServeEvent
    from geomesa_tpu_torch.serve import (
        QueryService, ServeConfig, knn_request_factory)

    build.build_all()
    card_s = cs.card()
    cs.log(card_s)
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    n = args.rows
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    order = cs.morton_order(torch, torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev))
    x, y = x[order], y[order]
    t = rng.integers(1_590_000_000_000, 1_600_000_000_000, n)
    speed = rng.uniform(0, 30, n)
    bb = cs.BBOX
    cql = (f"BBOX(geom, {bb[0]}, {bb[1]}, {bb[2]}, {bb[3]}) "
           f"AND dtg > {cs.iso(cs.T0)} AND dtg < {cs.iso(cs.T1)} AND speed > 5.0")
    with tempfile.TemporaryDirectory() as tmp:
        ds = DataStore(tmp, use_device_cache=True, device=dev)
        sft = SimpleFeatureType.from_spec("gdelt", "speed:Double,dtg:Date,*geom:Point")
        src = ds.create_schema(sft)
        src.write(FeatureBatch.from_pydict(
            sft, {"speed": speed, "dtg": t, "geom": np.stack([x, y], 1)}))
        src.knn(cql, x[:64], y[:64], k=cs.K)  # residency and calibration
        make = knn_request_factory("gdelt", cql, extent=(20.0, 60.0), k=cs.K,
                                   seed=0)
        default = sys.getswitchinterval()
        try:
            for interval in (default, 0.0005, default):
                sys.setswitchinterval(interval)
                for route, cfg in cs.DEV_ROUTES.items():
                    for rep in range(2):
                        svc = QueryService(ds, ServeConfig(
                            max_batch=64, max_wait_ms=2.0, max_queue=2048,
                            **cfg), autostart=False)
                        a0 = len(ds.audit.events)
                        futs = [svc.submit(make(i)) for i in range(args.requests)]
                        t0 = time.perf_counter()
                        svc.start()
                        for f in futs:
                            f.result(timeout=300)
                        wall = (time.perf_counter() - t0) * 1e3
                        st = svc.stats()
                        svc.close()
                        spans = list(dict.fromkeys(
                            e.exec_ms for e in ds.audit.events[a0:]
                            if isinstance(e, ServeEvent)))
                        p = st.get("pipeline") or {}
                        w = max(st["dispatches"], 1)
                        cs.log(f"interval {interval} {route} rep {rep}: wall "
                               f"{wall:.1f} ms, span p50 {statistics.median(spans):.1f}"
                               f" ms, dispatch {p.get('dispatch_ms', 0) / w:.2f} "
                               f"ms/window, completer "
                               f"{p.get('complete_ms', 0) / w:.2f} ms/window "
                               f"[{card_s}]")
        finally:
            sys.setswitchinterval(default)
        svc = QueryService(ds, ServeConfig(pipeline=False, ring=False),
                           autostart=False)
        live = [make(i) for i in range(64)]
        for r in live:
            r.future.set_running_or_notify_cancel()
            r.future.set_result(None)
        t0 = time.perf_counter()
        for _ in range(20):
            now = time.monotonic()
            svc._finish_window(live, [], live[0], now, now, 0, [])
        cs.log(f"_finish_window for 64 members: "
               f"{(time.perf_counter() - t0) / 20 * 1e3:.3f} ms [{card_s}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
