#!/usr/bin/env python3
"""Sweep variants of the cell-dictionary density kernel (B3,
geomesa_tpu_torch/engine/kernels/density_zsparse.cu) and the fold of its
rows on one CUDA card, at the density path's shapes.

    python3 scripts/torch_zsparse_sweep.py [--rows N] [--rounds R]
                                           [--baseline CU]

Inputs: chip_smoke.py's density store as it lies on the card: N rows
(default 2^26) drawn as chip_smoke.py draws them (seed 11, uniform over
the NYC envelope, six months of 2016), in Z2-Morton order, grouped by
month and each month padded to the next power of two with masked rows,
as the device cache holds them; the mask is the rows' validity (the
path's six-month window admits every row), the grid 512x512, and the
tiles and dictionaries are `calibrate_density`'s. Two weightings: the
mask as 0/1 (the unweighted grid: counts) and the mask times weights
uniform in [0, 5) from seed 5 (a weighted grid). Each variant is a copy
of the source with one change, compiled with build.py's flags:

  as built          the source as it is;
  copy only         the warps' work taken out: the TMA ring, the waits, the
                    barriers and the row writes alone (the practical floor
                    of the data movement; its rows are zeros);
  binning only      the warps bin their points and stop (no grouping, no
                    lookup, no atomic; its rows are zeros);
  register loads    every thread copies its share of a stage with 128-bit
                    loads through registers into the same ring instead of
                    thread 0's TMA copies (the barriers that order the ring
                    stay, the mbarrier waits go);
  binary search     the cell table replaced by the sorted dictionary and a
                    binary search over it (log2 of the table's half
                    probes);
  no count path     unit weights summed by the runs' scan too, as weights
                    are;
  warp rows         one accumulator row a warp, added to without atomics
                    (a warp's groups hold distinct cells) and summed over
                    the warps at the row write;
  4 stages, 2 stages of 2048 points
                    other rings (the shared memory they take sets the
                    blocks an SM);
  baseline          with --baseline, an earlier density_zsparse.cu (e.g.
                    `git show 6412937:geomesa_tpu_torch/engine/kernels/density_zsparse.cu`
                    saved under a git-ignored path): one block a tile, a
                    search and a shared atomic a point.

Besides them: the wrapper as built (`zsparse_counts`), the as-built launch
on a copy of the rows shuffled inside each tile (its counts must equal the
Morton ones), and the fold of the path's rows into the grid as built
(`_fold_counts`: a sink a dictionary slot) and with the single sink of
the reference (`width*height` for every pad).

For each variant: ptxas's registers and spills, its outputs against the
plain version (`zsparse_counts_plain`: counts equal, weights within
chip_smoke's per-cell bound), and for each of `--rounds` interleaved
rounds the median of 10 single-call CUDA-event timings (chip_smoke's
`timed_ms`) on both weightings. Then the SM clock and power (nvidia-smi)
sampled while the as-built kernel runs for about two seconds. The card's
name and power limit lead the output; the last line is a JSON object of
every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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

REGISTER_FILL = '''__device__ __forceinline__ void fill_stage(const Tiles& t, int c, float* ring,
                                           int* dict_ring, uint64_t* bars) {
  const int k = c / t.cpt, q = c - k * t.cpt;
  const int s = blockIdx.x + k * gridDim.x;
  const int n = min(kChunk, t.data_tile - q * kChunk);
  const long long g = (long long)t.tile_ids[s] * t.data_tile + (long long)q * kChunk;
  float4* stage = reinterpret_cast<float4*>(ring + (c % kStages) * kStageFloats);
  const float4* x = reinterpret_cast<const float4*>(t.x + g);
  const float4* y = reinterpret_cast<const float4*>(t.y + g);
  const float4* w = reinterpret_cast<const float4*>(t.lw + g);
  for (int i = threadIdx.x; i < n / 4; i += kThreads) {
    const float4 a = x[i], b = y[i], d = w[i];
    stage[i] = a;
    stage[kChunk / 4 + i] = b;
    stage[kChunk / 2 + i] = d;
  }
  if (q == 0) {
    int4* dst = reinterpret_cast<int4*>(dict_ring + (k % kStages) * t.capd);
    const int4* src = reinterpret_cast<const int4*>(t.dicts + (long long)s * t.capd);
    for (int j = threadIdx.x; j < t.capd / 4; j += kThreads) dst[j] = src[j];
  }
}  // fill_stage'''

# the sorted dictionary in the table's keys (pads and the empty tail are
# -1: +infinity unsigned), and a lower bound over its first half
SORTED_FILL = '''__device__ __forceinline__ void fill_table(const int* dict, int capd, int2* table,
                                           int tbits) {
  for (int j = threadIdx.x; j < capd; j += kThreads) table[j] = make_int2(dict[j], j);
}  // fill_table'''
SEARCH = '''__device__ __forceinline__ int find_slot(int key, const int2* table, int tbits) {
  int lo = 0;
  for (int step = 1 << (tbits - 2); step > 0; step >>= 1)
    if ((unsigned)table[lo + step - 1].x < (unsigned)key) lo += step;
  if ((unsigned)table[lo].x < (unsigned)key) ++lo;
  return table[lo].x == key ? lo : -1;
}  // find_slot'''


def sub(src: str, pattern: str, repl: str) -> str:
    out, k = re.subn(pattern, lambda _: repl, src, flags=re.S)
    assert k == 1, pattern
    return out


def warp_rows(src: str) -> str:
    """One accumulator row a warp, plain adds, summed at the row write."""
    for a, b in (
            (r"sizeof\(int\) \* \(size_t\)\(kStages \+ 1\) \* capd",
             "sizeof(int) * (size_t)(kStages + kThreads / 32) * capd"),
            (r"reinterpret_cast<int2\*>\(acc \+ capd\)",
             "reinterpret_cast<int2*>(acc + (kThreads / 32) * capd)"),
            (r"j < capd; j \+= kThreads\) acc\[j\] = 0.0f;",
             "j < (kThreads / 32) * capd; j += kThreads) acc[j] = 0.0f;"),
            (r"tbits,\n(\s+)acc, gr\);", "tbits,\n                acc + warp * capd, gr);"),
            (r"atomicAdd\(&acc\[slot\], v\);", "acc[slot] += v;"),
            (r"        row\[j\] = a\[j\];\n        a\[j\] = make_float4\(0.0f, 0.0f, 0.0f, 0.0f\);\n",
             "        float4 r = a[j];\n"
             "        a[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n"
             "        for (int v = 1; v < kThreads / 32; ++v) {\n"
             "          const float4 b = a[v * (capd / 4) + j];\n"
             "          r.x += b.x; r.y += b.y; r.z += b.z; r.w += b.w;\n"
             "          a[v * (capd / 4) + j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n"
             "        }\n"
             "        row[j] = r;\n")):
        src = sub(src, a, b)
    return src


def variants(src: str, baseline: str = None) -> dict:
    ring = lambda v, stages, chunk: sub(sub(  # noqa: E731
        v, r"constexpr int kStages = \d+;", f"constexpr int kStages = {stages};"),
        r"constexpr int kChunk = \d+;", f"constexpr int kChunk = {chunk};")
    out = {
        "as built": src,
        "copy only": sub(src, r"\n    for \(int i = warp \* 32 \+ lane; i < n; i \+= kThreads\)"
                              r"[^\n]*\n      warp_step\(.*?\);\n", "\n"),
        "binning only": sub(src, r"  const unsigned group = __match_any_sync.*?"
                                 r"  if \(slot >= 0\) atomicAdd[^\n]*\n",
                            "  if (key == 0x7ffffff) acc[0] = w;  // keeps the binning\n"),
        "register loads": sub(sub(src, r"__device__ __forceinline__ void fill_stage\(.*?\}  // fill_stage",
                                  REGISTER_FILL),
                              r"(void wait_stage\(uint64_t\* bars, int c\) \{).*?(\}  // wait_stage)",
                              "void wait_stage(uint64_t* bars, int c) {\n}  // wait_stage"),
        "binary search": sub(sub(src, r"__device__ __forceinline__ void fill_table\(.*?\}  // fill_table",
                                 SORTED_FILL),
                             r"__device__ __forceinline__ int find_slot\(.*?\}  // find_slot", SEARCH),
        "no count path": sub(src, r"if \(__all_sync\(kFull, !ok \|\| w == 1.0f\)\) \{",
                             "if (false) {"),
        "warp rows": warp_rows(src),
        "4 stages": ring(src, 4, 1024),
        "2 stages of 2048": ring(src, 2, 2048),
    }
    if baseline is not None:
        out["baseline"] = baseline
    return out


def compile_variant(build, src: str, tag: str):
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"density_zsparse_{tag}.cu"
    cu.write_text(src)
    lib = out_dir / f"libdensity_zsparse_{tag}.so"
    proc = subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    regs = [(res.get("registers"), res.get("spill"))
            for name, res in cs.ptxas_resources(proc.stderr).items()
            if "zsparse_kernel" in name]
    handle = ctypes.CDLL(str(lib))
    fn = handle.zsparse_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, regs[0] if regs else None


def store_rows(torch, dev, rows: int):
    """chip_smoke's density rows as the device cache holds them: (x, y,
    valid) on the card, Morton order within each month, each month padded
    to the next power of two."""
    rng = np.random.default_rng(11)
    x = rng.uniform(cs.ENV[0], cs.ENV[2], rows)
    y = rng.uniform(cs.ENV[1], cs.ENV[3], rows)
    rng.uniform(0, 5, rows)  # the fare column, drawn to keep the stream
    t = rng.integers(cs.D_T0, cs.D_T1, rows)
    order = cs.morton_order(torch, torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev))
    x, y, t = x[order], y[order], t[order]
    month = t.astype("datetime64[ms]").astype("datetime64[M]").astype(np.int64)
    by = np.argsort(month, kind="stable")
    x, y, month = x[by], y[by], month[by]
    xs, ys, vs = [], [], []
    for m in np.unique(month):
        sel = month == m
        k = int(sel.sum())
        pad = (1 << (k - 1).bit_length()) - k
        xs += [x[sel].astype(np.float32), np.zeros(pad, np.float32)]
        ys += [y[sel].astype(np.float32), np.zeros(pad, np.float32)]
        vs += [np.ones(k, bool), np.zeros(pad, bool)]
    f = lambda a: torch.from_numpy(np.concatenate(a)).to(dev)  # noqa: E731
    return f(xs), f(ys), f(vs)


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
    ap.add_argument("--rows", type=int, default=1 << 26)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--baseline", help="an earlier density_zsparse.cu to time "
                    "beside the source as built")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_zsparse_sweep: no CUDA device", file=sys.stderr)
        return 1
    from geomesa_tpu_torch.engine import density_zsparse as dz
    from geomesa_tpu_torch.engine.density import grid_consts
    from geomesa_tpu_torch.engine.kernels import build

    card = cs.card()
    print(card, flush=True)
    dev = torch.device("cuda")
    x, y, valid = store_rows(torch, dev, args.rows)
    calib = dz.calibrate_density(x, y, valid, cs.ENV, cs.GRID, cs.GRID)
    ids = torch.from_numpy(calib.tile_ids).to(dev)
    dicts = calib.dicts
    s, capd = dicts.shape
    lw = valid.float()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    lww = torch.where(valid, torch.rand(x.shape[0], device=dev, generator=gen) * 5,
                      torch.zeros_like(lw))
    perm = cs.within_tile_perm(torch, x.shape[0], dz.DATA_TILE, 23, dev)
    xs, ys, ws = x[perm], y[perm], lw[perm]
    del perm
    print(f"inputs: {x.shape[0]} rows resident, S={s} live tiles of "
          f"{x.shape[0] // dz.DATA_TILE}, capd={capd}, persistent grid "
          f"{dz.grid_blocks(capd)} blocks", flush=True)
    consts = [float(v) for v in grid_consts(cs.ENV, cs.GRID, cs.GRID)]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def launch(fn, a=x, b=y, c=lw):
        def call():
            out = torch.empty((s, capd), dtype=torch.float32, device=dev)
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), ids.data_ptr(),
                     dicts.data_ptr(), out.data_ptr(), s, capd, dz.DATA_TILE,
                     *consts, cs.GRID, cs.GRID, stream())
            assert err == 0, err
            return out
        return call

    plain = dz.zsparse_counts_plain(x, y, lw, ids, dicts, cs.ENV, cs.GRID, cs.GRID)
    plain_w = dz.zsparse_counts_plain(x, y, lww, ids, dicts, cs.ENV, cs.GRID,
                                      cs.GRID).double().cpu().numpy()
    cnt = plain.cpu().numpy()
    src = (ROOT / "geomesa_tpu_torch/engine/kernels/density_zsparse.cu").read_text()
    baseline = Path(args.baseline).read_text() if args.baseline else None
    calls, rows = {}, {}
    for tag, v in variants(src, baseline).items():
        fn, regs = compile_variant(build, v, tag.replace(" ", "_"))
        calls[tag] = launch(fn)
        got = calls[tag]()
        same = bool(torch.equal(got, plain))
        rows[tag] = {"variant": tag, "registers_spills": regs, "equal_to_plain": same,
                     "ms": []}
        if tag not in ("copy only", "binning only"):
            calls[tag + ", weighted"] = launch(fn, c=lww)
            ok_w = cs.cell_bound(calls[tag + ", weighted"]().cpu().numpy(), plain_w, cnt)
            assert same and ok_w, tag
            rows[tag + ", weighted"] = {"variant": tag + ", weighted",
                                        "within_cell_bound": ok_w, "ms": []}
        print(f"{tag}: registers/spills {regs}, counts equal to plain {same}", flush=True)
        if tag == "as built":
            calls["as built, within-tile shuffled"] = launch(fn, xs, ys, ws)
            assert torch.equal(calls["as built, within-tile shuffled"](), got)
            rows["as built, within-tile shuffled"] = {
                "variant": "as built, within-tile shuffled", "ms": []}
    calls["wrapper as built"] = lambda: dz.zsparse_counts(
        x, y, lw, ids, dicts, cs.ENV, cs.GRID, cs.GRID)
    rows["wrapper as built"] = {"variant": "wrapper as built", "ms": []}

    counts = plain
    cells = cs.GRID * cs.GRID
    sink = torch.where(dicts < 0, torch.full_like(dicts, cells), dicts)

    def fold_single():
        grid = torch.zeros(cells + 1, dtype=torch.float32, device=dev)
        grid.index_add_(0, sink.reshape(-1), counts.reshape(-1))
        return grid[:cells].reshape(cs.GRID, cs.GRID)

    calls["fold, a sink a slot (as built)"] = lambda: dz._fold_counts(
        counts, dicts, cs.GRID, cs.GRID)
    calls["fold, one sink (before)"] = fold_single
    assert torch.equal(calls["fold, a sink a slot (as built)"](), fold_single())
    pads = int((dicts < 0).sum())
    for tag in ("fold, a sink a slot (as built)", "fold, one sink (before)"):
        rows[tag] = {"variant": tag, "ms": []}
    print(f"fold: {s * capd} slots, {pads} of them pads ({pads / (s * capd):.3f}); "
          f"both folds give the same grid", flush=True)

    for _ in range(args.rounds):
        for tag, fn in calls.items():
            rows[tag]["ms"].append(cs.timed_ms(torch, fn, 10))
    bound, by = cs.roofline_ms(cs.ZS_OPS * s * dz.DATA_TILE,
                               12 * s * dz.DATA_TILE + 8 * s * capd)
    for tag, row in rows.items():
        row["mean_ms"] = ms = statistics.mean(row["ms"])
        share = f", {bound / ms:.3f} of the bound" if not tag.startswith("fold") else ""
        print(f"{tag}: {ms:.3f} ms (rounds {', '.join(f'{t:.3f}' for t in row['ms'])})"
              f"{share} [{card}]", flush=True)
    print(f"bound {bound:.3f} ms by {by} ({12 * s * dz.DATA_TILE + 8 * s * capd} bytes)",
          flush=True)

    stop, samples = threading.Event(), []
    th = threading.Thread(target=sample_clock, args=(stop, samples))
    full = calls["as built"]
    th.start()
    t0, launches = time.perf_counter(), 0
    while time.perf_counter() - t0 < 2.0:
        full()
        launches += 1
        if launches % 50 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    stop.set()
    th.join()
    clk = statistics.median(v[0] for v in samples) if samples else float("nan")
    power = statistics.median(v[1] for v in samples) if samples else float("nan")
    print(f"as built under load: SM clock median {clk:.0f} MHz, power {power:.1f} W "
          f"over {len(samples)} samples [{card}]", flush=True)
    print(json.dumps({"card": card, "s": s, "capd": capd, "bound_ms": bound,
                      "rows": list(rows.values()), "sm_clock_mhz": clk,
                      "power_w": power}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
