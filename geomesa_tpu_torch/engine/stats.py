"""Masked statistical reductions: the device side of a stats query.

The counterpart of the reference package's `engine/stats.py`. The
reference writes these as `jax.jit` reductions with no Pallas kernel, so
here they are plain PyTorch over tensors on any device:

- masked_count / masked_minmax / masked_moments (f64) / masked_histogram
  (f32 binning, ends clamped) / masked_value_counts (dictionary codes);
- hll_registers and cms_table: the reference's 32-bit hash family
  (2x murmur32 fmix over the value's 32-bit halves, a float through its
  f32 bit pattern) and its HyperLogLog / Count-Min folds, bit for bit, so
  their state merges with host-observed sketches (`stats/sketches.py`);
- grouped_count / grouped_sum / grouped_min / grouped_max: the SQL GROUP
  BY segment reductions, f64, empty groups at 0 / 0 / +inf / -inf;
- z3_histogram: (time bin, x cell, y cell) occupancy counts.

The hashes run in int64 tensors holding u32 values (torch has no full
uint32 arithmetic); a 32-bit product is taken in 16-bit halves so no
intermediate leaves int64. A float-to-int cast saturates and maps NaN to
0 before the clamp, as XLA's convert does. `stats_sharded` runs a
reduction on every shard of a mesh and adds its partials (`psum`, in
shard order).
"""

from __future__ import annotations

from typing import Tuple

import torch

from geomesa_tpu_torch.engine.knn import _div_mul

_U32 = 0xFFFFFFFF
_M32_1 = 0x85EBCA6B
_M32_2 = 0xC2B2AE35


def _bins(f: torch.Tensor, n: int) -> torch.Tensor:
    """floor-ed float bins -> int32 in [0, n - 1]: NaN -> 0 and the clamp
    before the cast (XLA's saturating convert, then the clip)."""
    f = torch.nan_to_num(torch.floor(f), nan=0.0)
    return torch.clamp(f, 0, n - 1).to(torch.int32)


def masked_count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int64)


def masked_minmax(v: torch.Tensor, mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    vf = v.to(torch.float64)
    inf = float("inf")
    return (torch.where(mask, vf, inf).amin(),
            torch.where(mask, vf, -inf).amax())


def masked_moments(v: torch.Tensor, mask: torch.Tensor):
    """(count, sum, sum of squares) in f64 (DescriptiveStats)."""
    vf = torch.where(mask, v.to(torch.float64), 0.0)
    return mask.sum(dtype=torch.int64), vf.sum(), (vf * vf).sum()


def masked_histogram(v: torch.Tensor, mask: torch.Tensor, lo: float,
                     hi: float, bins: int) -> torch.Tensor:
    """Fixed-width bins over [lo, hi] in f32, values outside clamped into
    the end bins (the Histogram stat). The bin width is (hi - lo) / bins
    in f64 rounded to f32, and lo is rounded to f32, as in the reference."""
    vf = v.to(torch.float32)
    lo32 = torch.tensor(lo, dtype=torch.float64).to(torch.float32)
    w32 = torch.tensor((hi - lo) / bins, dtype=torch.float64).to(torch.float32)
    idx = _bins((vf - lo32.to(vf.device)) / w32.to(vf.device), bins)
    out = torch.zeros(bins, dtype=torch.int32, device=v.device)
    return out.index_add_(0, idx, mask.to(torch.int32))


def masked_value_counts(codes: torch.Tensor, mask: torch.Tensor,
                        vocab_size: int) -> torch.Tensor:
    """Counts per dictionary code; null codes (-1) and codes past the
    vocabulary are dropped."""
    valid = mask & (codes >= 0) & (codes < vocab_size)
    idx = torch.clamp(codes, 0, max(vocab_size - 1, 0)).long()
    out = torch.zeros(max(vocab_size, 1), dtype=torch.int32, device=codes.device)
    return out.index_add_(0, idx, valid.to(torch.int32))


# -- the 32-bit hash family (HLL registers, CMS rows) ---------------------------


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for u32 values a (int64) and a u32 constant b."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M32_1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M32_2)
    return h ^ (h >> 16)


def _halves_u32(v: torch.Tensor):
    """(lo, hi) u32 halves as int64: a float's f32 bit pattern and 0, an
    integer's two's-complement halves."""
    if v.is_floating_point():
        lo = v.to(torch.float32).view(torch.int32).to(torch.int64) & _U32
        return lo, torch.zeros_like(lo)
    iv = v.to(torch.int64)
    return iv & _U32, (iv >> 32) & _U32


def _hash_pair(v: torch.Tensor, seed: int):
    s1 = (seed * 0x9E3779B9 + 0x165667B1) & _U32
    s2 = (seed * 0x85EBCA77 + 0x27D4EB2F) & _U32
    lo, hi = _halves_u32(v)
    h1 = _fmix32(lo ^ _fmix32(hi ^ s1))
    h2 = _fmix32(h1 ^ hi ^ s2)
    return h1, h2


def _bit_length_u32(x: torch.Tensor) -> torch.Tensor:
    """bit_length of u32 values (0 -> 0) through the f32 exponent field,
    rounded to nearest as the reference rounds it."""
    e = (x.to(torch.float32).view(torch.int32) >> 23) & 0xFF
    return torch.where(x > 0, e.to(torch.int64) - 126, 0)


def hll_registers(v: torch.Tensor, mask: torch.Tensor, p: int = 12
                  ) -> torch.Tensor:
    """Masked HyperLogLog fold -> [2^p] int32 ranks: idx = the top p bits
    of h1, rank = the 1-based first set bit of the remaining 64 - p bits
    of (h1, h2). Fold with Cardinality.observe_registers."""
    h1, h2 = _hash_pair(v, 0)
    idx = h1 >> (32 - p)
    rest_hi = ((h1 << p) | (h2 >> (32 - p))) & _U32
    rest_lo = (h2 << p) & _U32
    rank = torch.where(
        rest_hi > 0, 65 - (_bit_length_u32(rest_hi) + 32),
        torch.where(rest_lo > 0, 65 - _bit_length_u32(rest_lo), 64 - p + 1))
    rank = torch.where(mask, rank, 0).to(torch.int32)
    out = torch.zeros(1 << p, dtype=torch.int32, device=v.device)
    return out.scatter_reduce_(0, idx, rank, "amax")


def cms_table(v: torch.Tensor, mask: torch.Tensor, width: int = 1024,
              depth: int = 4) -> torch.Tensor:
    """Masked Count-Min observation -> [depth, width] int32, numeric keys:
    row d hashes with seed d + 1 and the column is (h1 * 2^32 + h2) mod
    width, taken modulo in int64. Fold with Frequency.observe_table."""
    w = mask.to(torch.int32)
    two32_mod = (1 << 32) % width
    rows = []
    for d in range(depth):
        h1, h2 = _hash_pair(v, d + 1)
        col = ((h1 % width) * two32_mod + h2) % width
        rows.append(torch.zeros(width, dtype=torch.int32, device=v.device)
                    .index_add_(0, col, w))
    return torch.stack(rows)


# -- grouped (segment) reductions: SQL GROUP BY -------------------------------


def grouped_count(gids: torch.Tensor, mask: torch.Tensor,
                  num_groups: int) -> torch.Tensor:
    out = torch.zeros(num_groups, dtype=torch.int64, device=gids.device)
    return out.index_add_(0, gids.long(), mask.to(torch.int64))


def grouped_sum(v: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                num_groups: int) -> torch.Tensor:
    vf = torch.where(mask, v.to(torch.float64), 0.0)
    out = torch.zeros(num_groups, dtype=torch.float64, device=v.device)
    return out.index_add_(0, gids.long(), vf)


def grouped_min(v: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                num_groups: int) -> torch.Tensor:
    inf = float("inf")
    vf = torch.where(mask, v.to(torch.float64), inf)
    out = torch.full((num_groups,), inf, dtype=torch.float64, device=v.device)
    return out.scatter_reduce_(0, gids.long(), vf, "amin")


def grouped_max(v: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                num_groups: int) -> torch.Tensor:
    inf = float("inf")
    vf = torch.where(mask, v.to(torch.float64), -inf)
    out = torch.full((num_groups,), -inf, dtype=torch.float64, device=v.device)
    return out.scatter_reduce_(0, gids.long(), vf, "amax")


def z3_histogram(x: torch.Tensor, y: torch.Tensor, t_bin: torch.Tensor,
                 mask: torch.Tensor, n_time_bins: int,
                 bins_per_dim: int = 16) -> torch.Tensor:
    """[n_time_bins, bins_per_dim, bins_per_dim] int32 occupancy (the
    Z3Histogram stat). Cells as the reference's jitted code computes
    them: (x + 180) / 360 * bins folded into one constant (`_div_mul`)."""
    cx = _bins(_div_mul(x + 180.0, 360.0, bins_per_dim), bins_per_dim)
    cy = _bins(_div_mul(y + 90.0, 180.0, bins_per_dim), bins_per_dim)
    tb = torch.clamp(t_bin.to(torch.int32), 0, n_time_bins - 1)
    flat = ((tb * bins_per_dim + cy) * bins_per_dim + cx).long()
    out = torch.zeros(n_time_bins * bins_per_dim * bins_per_dim,
                      dtype=torch.int32, device=x.device)
    out.index_add_(0, flat, mask.to(torch.int32))
    return out.reshape(n_time_bins, bins_per_dim, bins_per_dim)


def shard_partials(mesh, fn, *arrays) -> list:
    """`fn(*local_arrays)` on every local shard of `mesh` (under the
    shard's device), one result a local shard, each left on its shard's
    device. Each array is `Sharded`, a whole tensor or a host array whose
    length divides by the mesh size (a host array's rows go to their
    shard's device)."""
    import numpy as np

    from geomesa_tpu_torch.parallel.mesh import my_shards, on_shard, shards_of

    devs = mesh.device_list
    cols = []
    for a in arrays:
        if isinstance(a, np.ndarray):
            s = len(a) // len(devs)
            if s * len(devs) != len(a):
                raise ValueError(f"length {len(a)} does not divide into "
                                 f"{len(devs)} shards")
            col: list = [None] * len(devs)
            for i, d in my_shards(mesh):
                col[i] = torch.from_numpy(np.ascontiguousarray(
                    a[i * s:(i + 1) * s])).to(d)
            cols.append(col)
        else:
            cols.append(shards_of(mesh, a))
    outs = []
    for i, d in my_shards(mesh):
        with on_shard(d):
            outs.append(fn(*(c[i] for c in cols)))
    return outs


def stats_sharded(mesh, fn, *arrays):
    """Run the masked reduction `fn(*local_arrays)` on every shard of
    `mesh` (`shard_partials`) and add its partials leaf by leaf in shard
    order on the lead device (`parallel.mesh.psum`, a collective where
    the mesh spans processes): `fn` returns a tensor, a tuple/list or a
    dict of summable partials (counts, sums, histograms)."""
    from geomesa_tpu_torch.parallel.mesh import psum

    def merge(parts):
        first = parts[0]
        if isinstance(first, dict):
            return {k: merge([p[k] for p in parts]) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(merge([p[j] for p in parts])
                               for j in range(len(first)))
        return psum(mesh, parts)

    return merge(shard_partials(mesh, fn, *arrays))
