#!/usr/bin/env python3
"""Time B8 (pip_pairs_count, geomesa_tpu_torch/engine/kernels/pip_layer.cu)
against an earlier source of its kernel on one CUDA card, in one process,
at the config-2 path's shape.

    python3 scripts/torch_pairs_count_ab.py --baseline CU [--points N]
                                            [--rounds R]

Inputs: chip_smoke.py's config-2 join (seed 29: the reference bench's
10,000-polygon layer and N points, default 2^22, in Z2-Morton order),
prepared by `prepare_layer`, with its pair list as prepared. CU is a copy
of pip_layer.cu from before B8 took B6's walk (e.g. `git show
9cc0a7e:geomesa_tpu_torch/engine/kernels/pip_layer.cu` saved under a
git-ignored path), whose `pip_pairs_count_launch` takes the pair list
itself: one block a pair, every pair tested in full. Timed, for each of
`--rounds` interleaved rounds, as the median of 10 single-call CUDA-event
timings (chip_smoke's `timed_ms`):

  wrapper         `pip_pairs_count` as built: the output zeroed, the range
                  check (one host sync), the CSR built on the card, the
                  chunk-bounds prologue and the kernel;
  launch          as built, the CSR, its row order and the bounds scratch
                  made once beforehand: the zeroed output, the prologue and
                  the kernel;
  old launch      the baseline's kernel over the pair list, into a zeroed
                  output.

Every output equals the plain version's (`pip_pairs_count_plain`) bit for
bit before any timing. The card's name and power limit lead the output.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def compile_baseline(build, cu: Path):
    """The baseline source built with build.py's flags: (library, ptxas
    report)."""
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libpip_layer_baseline.so"
    proc = subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    handle = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.pip_pairs_count_launch.argtypes = [p] * 9 + [i, p]
    handle.pip_pairs_count_launch.restype = ctypes.c_int
    return handle, proc.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="pip_layer.cu from before B8 took B6's walk")
    ap.add_argument("--points", type=int, default=cs.LAYER_POINTS)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_pairs_count_ab: no CUDA device", file=sys.stderr)
        return 1
    from geomesa_tpu_torch.engine import pip_sparse as ps
    from geomesa_tpu_torch.engine import pip_sparse_kernels as psk
    from geomesa_tpu_torch.engine.kernels import build

    card = cs.card()
    print(card, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(29)  # chip_smoke.layer_path's draws
    layer = cs.gen_admin_layer(rng, cs.LAYER_POLYS)
    px, py, _ = cs.layer_points(torch, dev, rng, args.points, layer)
    prep = ps.prepare_layer(px, py, *layer[:5])
    inp = cs.layer_kernel_inputs(torch, dev, prep, layer[4])
    a = (*inp["pts"], *inp["edges"])
    pt, et = inp["pairs"]
    n, m = inp["n_ptiles"], int(pt.shape[0])
    n_etiles = a[2].shape[0] // psk.TILE
    print(f"config 2: {cs.LAYER_POLYS} polygons, {args.points} points, {m} pairs "
          f"over {n} point tiles, {n_etiles} edge tiles", flush=True)

    old, report = compile_baseline(build, Path(args.baseline))
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "pairs_kernel" in line:
            print(f"  ptxas baseline: {line.strip()}", flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows, row_ptr, ets = psk.pairs_csr(pt, et, n)
    order, bounds = psk.row_order(row_ptr), psk._bounds(a[2])

    def zeros():
        return torch.zeros((n + 1, psk.TILE), dtype=torch.int32, device=dev)

    def launch():
        out = zeros()
        psk._run("pip_pairs_count", *a, bounds, order, rows, row_ptr, ets, out,
                 n, n_etiles, 0.0)
        return out

    def old_launch():
        out = zeros()
        err = old.pip_pairs_count_launch(*(t.data_ptr() for t in (*a, pt, et, out)),
                                         m, stream())
        assert err == 0, err
        return out

    calls = {"wrapper": lambda: psk.pip_pairs_count(*a, pt, et, n),
             "launch": launch, "old launch": old_launch}
    plain = psk.pip_pairs_count_plain(*a, pt, et, n)
    for name, fn in calls.items():
        assert torch.equal(fn(), plain), name
    del plain
    print("every output equals pip_pairs_count_plain bit for bit", flush=True)
    ms = {name: [] for name in calls}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            ms[name].append(cs.timed_ms(torch, fn, 10))
    for name, t in ms.items():
        print(f"{name}: {statistics.mean(t):.3f} ms (rounds "
              f"{', '.join(f'{v:.3f}' for v in t)}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
