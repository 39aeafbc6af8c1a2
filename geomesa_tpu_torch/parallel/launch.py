"""Multi-process launch harness: one mesh over several processes.

The counterpart of the reference package's `parallel/launch.py`. Each
process joins a `torch.distributed` process group (`distributed.
initialize`), checks that every process runs the same configuration
(`assert_uniform_runtime`) and runs `smoke_step`: a real sharded query
step (predicate mask -> density psum + moments psum over the global
mesh) on deterministic synthetic data, checked against a NumPy oracle
in EVERY process, so a wrong collective cannot pass.

Two entry points:

- `python -m geomesa_tpu_torch.parallel.launch --num-processes N
  [--devices cpu,cpu]` (launcher): spawns N local workers over a
  localhost coordinator and returns the number that failed. `--devices`
  is each worker's local device list (shards may repeat a device); by
  default a worker takes its own cards (`distributed.rank_devices`: its
  slice of the host's cards, or the card it shares).
- `python -m geomesa_tpu_torch.parallel.launch --process-id I
  --num-processes N --coordinator tcp://HOST:PORT [--devices ...]`
  (worker): one per process.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

WORKER_TIMEOUT_S = 300.0


def smoke_step(local_devices: Optional[Sequence] = None,
               verbose: bool = True) -> dict:
    """One sharded query step over the global mesh, oracle-checked in
    this process."""
    import numpy as np
    import torch

    from geomesa_tpu_torch.engine.density import density_sharded
    from geomesa_tpu_torch.engine.stats import masked_moments, stats_sharded
    from geomesa_tpu_torch.parallel.distributed import (
        global_mesh, process_count, process_index)
    from geomesa_tpu_torch.parallel.mesh import shards_of

    mesh = global_mesh(local_devices)
    n = mesh.size * 512
    rng = np.random.default_rng(42)  # the same seed in every process
    x = rng.uniform(-60, 60, n).astype(np.float32)
    y = rng.uniform(-45, 45, n).astype(np.float32)
    score = rng.uniform(-10, 10, n).astype(np.float32)
    mask_np = (np.abs(x) < 50) & (score > 0)

    def put(a):
        # every process holds the whole (deterministic) array and
        # contributes only its own shards
        from geomesa_tpu_torch.parallel.mesh import Sharded

        return Sharded(mesh, shards_of(mesh, torch.from_numpy(a)))

    gx, gy, gs, gm = put(x), put(y), put(score), put(mask_np)
    grid = density_sharded(mesh, gx, gy, put(np.ones(n, np.float32)), gm,
                           (-60.0, -45.0, 60.0, 45.0), 16, 16)
    c, s, _ = stats_sharded(mesh, masked_moments, gs, gm)
    want_count = int(mask_np.sum())
    got_mass = float(grid.double().sum())
    got_count = int(c)
    want_sum = float(score[mask_np].astype(np.float64).sum())
    got_sum = float(s)
    ok = (round(got_mass) == want_count and got_count == want_count
          and abs(got_sum - want_sum) < 1e-2)
    out = {"process": process_index(), "processes": process_count(),
           "shards": mesh.size, "local": list(mesh.local),
           "devices": [str(d) for d in mesh.device_list],
           "count": got_count, "grid_mass": got_mass, "sum": got_sum,
           "ok": ok}
    if verbose:
        print(f"multiprocess-smoke {out}", flush=True)
    if not ok:
        raise AssertionError(f"multi-process collective mismatch: {out}")
    out["grid"] = grid.cpu().numpy()
    return out


def run_worker(init_method: str, num_processes: int, process_id: int,
               local_devices: Optional[Sequence] = None) -> dict:
    """Join the group, check the runtime is uniform, run the smoke step,
    leave the group."""
    from geomesa_tpu_torch.parallel.distributed import (
        assert_uniform_runtime, initialize, shutdown)

    initialize(init_method, num_processes, process_id)
    try:
        # before any real kernel: every process runs the same program-
        # shaping configuration, or the first merge would deadlock; this
        # check fails loudly instead
        assert_uniform_runtime()
        return smoke_step(local_devices)
    finally:
        shutdown()


def launch_local(num_processes: int, port: int = 29511,
                 devices: Optional[Sequence[str]] = None,
                 init_method: Optional[str] = None,
                 timeout_s: float = WORKER_TIMEOUT_S) -> int:
    """Spawn N local workers (`python -m geomesa_tpu_torch.parallel.
    launch`) over `init_method` (default `tcp://127.0.0.1:<port>`), each
    with `devices` as its local device list. Returns the number of
    failed workers; a worker still alive at `timeout_s` is killed and
    counts as failed."""
    init_method = init_method or f"tcp://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "geomesa_tpu_torch.parallel.launch",
           "--coordinator", init_method, "--num-processes", str(num_processes)]
    if devices:
        cmd += ["--devices", ",".join(devices)]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for i in range(num_processes)]
    deadline = time.monotonic() + timeout_s
    failed = 0
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += f"\nworker {i} killed at the {timeout_s:.0f} s timeout\n"
            p.returncode = p.returncode or -9
        sys.stdout.write(out)
        if p.returncode != 0:
            failed += 1
            print(f"worker {i} FAILED (rc={p.returncode})", flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None,
                    help="tcp://HOST:PORT or file://PATH (workers)")
    ap.add_argument("--port", type=int, default=29511)
    ap.add_argument("--devices", default=None,
                    help="each process's local devices, comma separated "
                         "(e.g. cpu,cpu); default: its own cards")
    args = ap.parse_args(argv)
    devices = args.devices.split(",") if args.devices else None
    if args.process_id is None:
        return launch_local(args.num_processes, args.port, devices,
                            args.coordinator)
    run_worker(args.coordinator or os.environ.get("GEOMESA_TPU_COORDINATOR"),
               args.num_processes, args.process_id, devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
