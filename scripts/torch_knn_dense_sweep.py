#!/usr/bin/env python3
"""Sweep variants of the dense kNN block-minima kernel (B2,
geomesa_tpu_torch/engine/kernels/chord_blockmin.cu) on one CUDA card at
the kNN path's shape.

    python3 scripts/torch_knn_dense_sweep.py [--points N] [--rounds R]
                                             [--sass PATH]

Inputs: N points (default 71 * 2^20, the padded rows chip_smoke.py's kNN
store keeps resident) uniform over the globe, half of them masked, and
Q = 256 queries, all made on the card from seed 3. Each variant is a
copy of the source with one change, compiled with build.py's flags:

  as built        the source as it is;
  division        the output rows written with an integer division per
                  element (consecutive threads on consecutive
                  (query, column) pairs) instead of a half-warp a row;
  chunk 1024      1024 points a chunk, 3 blocks an SM;
  sinf/cosf       the prelude with four trigonometric calls, not two
                  sincosf;
  B1 kernel       the dense mode of chord_blockmin_kernel (B1's kernel
                  with no tile list, the design B2 had before its own
                  kernel: 64 queries a block, a warp shuffle per block
                  and query, the prelude once per query group).

For each variant: ptxas's registers and spills, every output against the
as-built kernel's (within 1e-5, and the as-built kernel against the plain
version once), and for each of `--rounds` interleaved rounds the median
of 10 single-call CUDA-event timings (chip_smoke's `timed_ms`) of the
launch and of its variant without the keys (the prelude, barriers and
output alone; not for the B1 kernel). Then the SM clock and power
(nvidia-smi) sampled while the as-built kernel runs for about two
seconds, and the as-built kernel's key loop read from `cuobjdump -sass`
(`--sass PATH` writes B2's listing there): instructions by opcode and a
key, and the keys' issue-rate floor at the sampled clock, keys x
instructions a key / 32 lanes / (4 schedulers x SMs x clock).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OLD_WRITE = '''    const long long col0 = ch * cb;
    for (int i = tid; i < kDQB * nb; i += kDThreads) {
      const int qi = i / nb, b = i - qi * nb;
      if (q0 + qi >= q) break;
      const float* row = mn + qi * kDMinStride + b * r;
      float v = row[0];
      for (int k = 1; k < r; ++k) v = min_nan(v, row[k]);
      out[(long long)(q0 + qi) * ncols + col0 + b] = v;
    }
  }
}'''


def sub(src: str, pattern: str, repl: str) -> str:
    out, k = re.subn(pattern, repl, src, flags=re.S)
    assert k == 1, pattern
    return out


def variants(src: str) -> dict:
    write = re.search(r"    const int b = tid & \(kDMaxBlocks - 1\);.*?\n  \}\n\}", src, re.S)
    assert write, "the write-out block"
    return {
        "as built": src,
        "division": src.replace(write.group(0), OLD_WRITE),
        "chunk 1024": sub(sub(src, r"constexpr int kDChunkPts = 2048;",
                              "constexpr int kDChunkPts = 1024;"),
                          r"__launch_bounds__\(kDThreads, 2\)",
                          "__launch_bounds__(kDThreads, 3)"),
        "sinf/cosf": sub(src, r"  float slon, clon, slat, clat;\n.*?sincosf\(lat \* kDeg2Rad, &slat, &clat\);",
                         "  const float slon = sinf(lon * kDeg2Rad), clon = cosf(lon * kDeg2Rad);\n"
                         "  const float slat = sinf(lat * kDeg2Rad), clat = cosf(lat * kDeg2Rad);"),
        "B1 kernel": sub(src, r"  if \(tile_ids == nullptr \|\| n_sel == nullptr\) return \(int\)cudaErrorInvalidValue;\n", ""),
    }


def compile_variant(build, src: str, tag: str):
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"chord_blockmin_{tag}.cu"
    cu.write_text(src)
    lib = out_dir / f"libchord_blockmin_{tag}.so"
    proc = subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    regs = {}
    for name, res in cs.ptxas_resources(proc.stderr).items():
        for key, kind in (("dense_kernelILb1E", "B2"), ("dense_kernelILb0E", "no keys"),
                          ("chord_blockmin_kernel", "B1 kernel")):
            if key in name:
                regs[kind] = (res.get("registers"), res.get("spill"))
    handle = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (handle.chord_blockmin_dense_launch, handle.chord_blockmin_dense_prelude_launch):
        fn.argtypes = [p] * 6 + [i, ctypes.c_longlong, i, p]
        fn.restype = ctypes.c_int
    handle.chord_blockmin_sparse_launch.argtypes = [p] * 8 + [i] * 4 + [p]
    handle.chord_blockmin_sparse_launch.restype = ctypes.c_int
    return handle, regs, lib


def sass_loop(lib: Path, dump: Path = None) -> dict:
    """B2's key loop in its SASS (cuobjdump): the shortest span from an
    instruction to a branch back to it that holds LDS.128 and FMNMX; its
    instruction counts by opcode, all of them, and the keys it computes
    (8 a broadcast LDS.128: the queries a lane holds)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    body, on = [], False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            on = "dense_kernelILb1E" in m.group(1)
        elif on:
            body.append(line)
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text("\n".join(body))
    ops, at, best = [], {}, None
    for line in body:
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not ins:
            continue
        at[int(ins.group(1), 16)] = len(ops)
        ops.append(ins.group(2))
        tgt = re.search(r"BRA\s+(?:`\()?0x([0-9a-f]+)", line)
        if tgt and int(tgt.group(1), 16) in at:  # a branch back: a loop
            span = ops[at[int(tgt.group(1), 16)]:]
            if "LDS.128" in span and any(o.startswith("FMNMX") for o in span):
                if best is None or len(span) < len(best):
                    best = list(span)
    if best is None:
        return {}
    counts = {}
    for o in best:
        key = o.split(".")[0] if not o.startswith("LDS") else o
        counts[key] = counts.get(key, 0) + 1
    return {"ops": counts, "instructions": len(best),
            "keys": 8 * best.count("LDS.128")}


def sample_clock(stop, out) -> None:
    while not stop.is_set():
        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True)
        try:
            out.append(tuple(float(v) for v in r.stdout.strip().split(",")[:2]))
        except ValueError:
            pass
        time.sleep(0.1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=71 << 20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sass", help="write B2's SASS listing to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_knn_dense_sweep: no CUDA device", file=sys.stderr)
        return 1
    from geomesa_tpu_torch.engine import knn_scan as ks
    from geomesa_tpu_torch.engine.kernels import build

    card = cs.card()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    n = args.points // ks.DATA_TILE * ks.DATA_TILE
    x = torch.rand(n, device=dev, generator=gen) * 360 - 180
    y = torch.rand(n, device=dev, generator=gen) * 180 - 90
    maskf = (torch.rand(n, device=dev, generator=gen) < 0.5).float()
    qx = torch.rand(cs.Q, device=dev, generator=gen) * 60 - 30
    qy = torch.rand(cs.Q, device=dev, generator=gen) * 30 + 30
    aug, c = ks._aug_q(qx, qy)
    q = aug.shape[0]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def dense(fn):
        def call():
            out = torch.empty((q, n // ks.BLK), dtype=torch.float32, device=dev)
            err = fn(aug.data_ptr(), c.data_ptr(), x.data_ptr(), y.data_ptr(),
                     maskf.data_ptr(), out.data_ptr(), q, n, ks.BLK, stream())
            assert err == 0, err
            return out
        return call

    def old(handle):
        def call():
            slots = n // ks.DATA_TILE
            out = torch.empty((q, n // ks.BLK), dtype=torch.float32, device=dev)
            err = handle.chord_blockmin_sparse_launch(
                aug.data_ptr(), c.data_ptr(), x.data_ptr(), y.data_ptr(),
                maskf.data_ptr(), None, None, out.data_ptr(), q, slots, ks.BLK,
                ks.DATA_TILE, stream())
            assert err == 0, err
            return out
        return call

    src = (ROOT / "geomesa_tpu_torch/engine/kernels/chord_blockmin.cu").read_text()
    calls, rows, libs = {}, {}, {}
    ref = None
    for tag, v in variants(src).items():
        handle, regs, libs[tag] = compile_variant(build, v, tag.replace(" ", "_").replace("/", "_"))
        if tag == "B1 kernel":
            calls[tag] = (old(handle), None)
        else:
            calls[tag] = (dense(handle.chord_blockmin_dense_launch),
                          dense(handle.chord_blockmin_dense_prelude_launch))
        got = calls[tag][0]()
        if ref is None:
            ref = got
            plain = ks._blockmin_plain(aug, c, x, y, maskf, ks.BLK)
            err_plain = float((got - plain).abs().max())
            del plain
            assert err_plain <= cs.TOL, err_plain
        err = float((got - ref).abs().max())
        assert err <= cs.TOL, (tag, err)
        rows[tag] = {"variant": tag, "registers_spills": regs, "err_vs_as_built": err,
                     "ms": [], "no_keys_ms": []}
        print(f"{tag}: registers/spills {regs}, max |out - as built| {err:.3g}", flush=True)
    print(f"as built vs plain: max_abs_err {err_plain:.3g}", flush=True)
    for r in range(args.rounds):
        for tag, (full, pre) in calls.items():
            rows[tag]["ms"].append(cs.timed_ms(torch, full, 10))
            if pre is not None:
                rows[tag]["no_keys_ms"].append(cs.timed_ms(torch, pre, 10))
    keys = q * n
    for tag, row in rows.items():
        ms = statistics.mean(row["ms"])
        pre = statistics.mean(row["no_keys_ms"]) if row["no_keys_ms"] else None
        pre_s = f", without keys {pre:.3f} ms (share {pre / ms:.3f})" if pre else ""
        print(f"{tag}: {ms:.3f} ms (rounds {', '.join(f'{t:.3f}' for t in row['ms'])})"
              f"{pre_s}, {keys / ms / 1e9:.2f} Gkeys/ms [{card}]", flush=True)

    # the SM clock while the as-built kernel runs, and its SASS
    stop, samples = threading.Event(), []
    th = threading.Thread(target=sample_clock, args=(stop, samples))
    full = calls["as built"][0]
    th.start()
    t0, launches = time.perf_counter(), 0
    while time.perf_counter() - t0 < 2.0:
        full()
        launches += 1
        if launches % 20 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    stop.set()
    th.join()
    clk = statistics.median(s[0] for s in samples) if samples else float("nan")
    power = statistics.median(s[1] for s in samples) if samples else float("nan")
    loop = sass_loop(libs["as built"], Path(args.sass) if args.sass else None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_key = loop["instructions"] / loop["keys"] if loop else float("nan")
    floor_ms = keys * per_key / 32 / (4 * sms * clk * 1e6) * 1e3
    print(f"as built under load: SM clock median {clk:.0f} MHz, power {power:.1f} W over "
          f"{len(samples)} samples; B2's key loop in SASS: {loop}; {per_key:.3f} "
          f"instructions a key; the keys' issue floor at that clock {floor_ms:.3f} ms "
          f"[{card}]", flush=True)
    print(json.dumps({"card": card, "rows": list(rows.values()), "sm_clock_mhz": clk,
                      "power_w": power, "key_loop": loop, "issue_floor_ms": floor_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
