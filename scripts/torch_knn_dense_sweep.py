#!/usr/bin/env python3
"""Sweep variants of the kNN block-minima kernel (B1/B2,
geomesa_tpu_torch/engine/kernels/chord_blockmin.cu) on one CUDA card at
the kNN path's shapes.

    python3 scripts/torch_knn_dense_sweep.py [--points N] [--rounds R]
                                             [--sass PATH] [--baseline CU]

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
  B2 before       with --baseline, a copy of chord_blockmin.cu from
                  before B1 took B2's kernel (e.g. `git show
                  9cc0a7e:geomesa_tpu_torch/engine/kernels/chord_blockmin.cu`
                  saved under a git-ignored path): its B2 kernel;
  B1 kernel       with --baseline, its chord_blockmin_kernel in its dense
                  mode (no tile list; the design B2 had before its own
                  kernel: 64 queries a block, a warp shuffle per block and
                  query, the prelude once per query group).

The sparse call (B1) is timed too, at the kNN path's 765 live of 1024
slots (765 data tiles drawn from seed 3, in ascending order, the other
slots naming tile 0): the as-built kernel with its tile list and its
variant without keys, and, with --baseline, the old B1 kernel on the
same call.

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


ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OLD_WRITE = '''    const long long col0 = (long long)slot * nbt + (long long)cc * cb;
    for (int i = tid; i < kQB * nb; i += kThreads) {
      const int qi = i / nb, b = i - qi * nb;
      if (qi >= nq) break;
      const float* row = mn + qi * kMinStride + b * r;
      float v = row[0];
      for (int k = 1; k < r; ++k) v = min_nan(v, row[k]);
      out[(long long)(q0 + qi) * cols + col0 + b] = v;
    }
    slot = ns;
    cc = nc;
  }
}'''


def sub(src: str, pattern: str, repl: str) -> str:
    out, k = re.subn(pattern, repl, src, flags=re.S)
    assert k == 1, pattern
    return out


def variants(src: str, baseline: str = None) -> dict:
    write = re.search(r"    const int b = tid & \(kMaxBlocks - 1\);.*?\n  \}\n\}", src, re.S)
    assert write, "the write-out block"
    out = {
        "as built": src,
        "division": src.replace(write.group(0), OLD_WRITE),
        "chunk 1024": sub(sub(src, r"constexpr int kChunkPts = 2048;",
                              "constexpr int kChunkPts = 1024;"),
                          r"__launch_bounds__\(kThreads, 2\)",
                          "__launch_bounds__(kThreads, 3)"),
        "sinf/cosf": sub(src, r"  float slon, clon, slat, clat;\n.*?sincosf\(lat \* kDeg2Rad, &slat, &clat\);",
                         "  const float slon = sinf(lon * kDeg2Rad), clon = cosf(lon * kDeg2Rad);\n"
                         "  const float slat = sinf(lat * kDeg2Rad), clat = cosf(lat * kDeg2Rad);"),
    }
    if baseline is not None:  # and the old B1 kernel, its null tile list let through
        out["B2 before"] = baseline
        out["B1 kernel"] = sub(baseline, r"  if \(tile_ids == nullptr \|\| n_sel == nullptr\) "
                               r"return \(int\)cudaErrorInvalidValue;\n", "")
    return out


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
        for key, kind in (("blockmin_kernelILb1E", "B1/B2"), ("blockmin_kernelILb0E", "no keys"),
                          ("dense_kernelILb1E", "B2 before"),
                          ("dense_kernelILb0E", "B2 before, no keys"),
                          ("chord_blockmin_kernel", "B1 kernel")):
            if key in name:
                regs[kind] = (res.get("registers"), res.get("spill"))
    handle = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (handle.chord_blockmin_dense_launch, handle.chord_blockmin_dense_prelude_launch):
        fn.argtypes = [p] * 6 + [i, ctypes.c_longlong, i, p]
        fn.restype = ctypes.c_int
    for name in ("chord_blockmin_sparse_launch", "chord_blockmin_sparse_prelude_launch"):
        fn = getattr(handle, name, None)  # the old source has no prelude variant
        if fn is not None:
            fn.argtypes = [p] * 8 + [i] * 4 + [p]
            fn.restype = ctypes.c_int
    return handle, regs, lib


def sass_loop(lib: Path, dump: Path = None) -> dict:
    """The key loop in its SASS (cuobjdump): the shortest span from an
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
            on = "blockmin_kernelILb1E" in m.group(1)
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
    ap.add_argument("--sass", help="write the kernel's SASS listing to this file")
    ap.add_argument("--baseline", help="chord_blockmin.cu from before B1 took B2's "
                    "kernel: times its B2 kernel, and its B1 kernel on the dense and "
                    "the sparse call")
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

    # the sparse call: 765 live of 1024 slots, as on the kNN path
    ntiles, slots, live = n // ks.DATA_TILE, 1024, 765
    pick = torch.randperm(ntiles, device=dev, generator=gen)[:min(live, ntiles)]
    tile_ids = torch.zeros(slots, dtype=torch.int32, device=dev)
    tile_ids[:pick.shape[0]] = torch.sort(pick).values.to(torch.int32)
    n_sel = torch.tensor([pick.shape[0]], dtype=torch.int32, device=dev)

    def sparse(fn, ids=tile_ids, sel=n_sel, nslots=slots):
        def call():
            out = torch.empty((q, nslots * (ks.DATA_TILE // ks.BLK)),
                              dtype=torch.float32, device=dev)
            err = fn(aug.data_ptr(), c.data_ptr(), x.data_ptr(), y.data_ptr(),
                     maskf.data_ptr(), None if ids is None else ids.data_ptr(),
                     None if sel is None else sel.data_ptr(), out.data_ptr(), q,
                     nslots, ks.BLK, ks.DATA_TILE, stream())
            assert err == 0, err
            return out
        return call

    src = (ROOT / "geomesa_tpu_torch/engine/kernels/chord_blockmin.cu").read_text()
    baseline = Path(args.baseline).read_text() if args.baseline else None
    calls, rows, libs = {}, {}, {}
    sparse_calls = {}
    ref = None
    for tag, v in variants(src, baseline).items():
        handle, regs, libs[tag] = compile_variant(build, v, tag.replace(" ", "_").replace("/", "_"))
        if tag == "B1 kernel":  # dense mode: no tile list, every tile a slot
            calls[tag] = (sparse(handle.chord_blockmin_sparse_launch, None, None,
                                 ntiles), None)
            sparse_calls["B1 before (old kernel)"] = (
                sparse(handle.chord_blockmin_sparse_launch), None)
        else:
            calls[tag] = (dense(handle.chord_blockmin_dense_launch),
                          dense(handle.chord_blockmin_dense_prelude_launch))
        if tag == "as built":
            sparse_calls["B1 as built"] = (
                sparse(handle.chord_blockmin_sparse_launch),
                sparse(handle.chord_blockmin_sparse_prelude_launch))
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
    plain = ks.chord_blockmin_sparse_plain(qx, qy, x, y, maskf, tile_ids, n_sel)[0]
    for tag, (full, _) in sparse_calls.items():
        got = full()
        err = float((got - plain).abs().max())
        dead = bool((got[:, int(n_sel[0]) * (ks.DATA_TILE // ks.BLK):] == ks.PENALTY).all())
        assert err <= cs.TOL and dead, (tag, err, dead)
        rows[tag] = {"variant": tag, "err_vs_plain": err, "ms": [], "no_keys_ms": []}
        print(f"{tag}: max |out - plain| {err:.3g}, dead columns all 1e9", flush=True)
    del plain
    calls.update(sparse_calls)
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
        nk = q * int(n_sel[0]) * ks.DATA_TILE if tag in sparse_calls else keys
        print(f"{tag}: {ms:.3f} ms (rounds {', '.join(f'{t:.3f}' for t in row['ms'])})"
              f"{pre_s}, {nk / ms / 1e9:.2f} Gkeys/ms [{card}]", flush=True)

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
