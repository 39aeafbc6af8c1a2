"""Mergeable stat sketch implementations.

A copy of the reference package's `stats/sketches.py` (pure NumPy), so
that `Stat.from_json` reads every `stats.json` the reference writes and
the port writes what the reference reads: MinMax, Cardinality (HLL),
Frequency (Count-Min), TopK (exact counts over dictionary codes),
Histogram (fixed-width bins), DescriptiveStats (count/mean/variance via
moments), EnumerationStat, GroupBy, SeqStat, Z3Histogram.

Sketches are host-side mergeable objects whose `observe_*` methods take
NumPy columns or batch-level reduction results. Each serializes to a
JSON dict (`to_json`/`from_json`); the hash family is stamped into the
hash-dependent sketches and checked on load.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325  # Python ints: seed mixing wraps manually
_SEED_MIX = 0x9E3779B97F4A7C15
_FNV_PRIME = np.uint64(0x100000001B3)
_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_U33 = np.uint64(33)

# stamped into hash-dependent sketch JSON; loading a sketch built with a
# different hash family would silently corrupt CMS counts / HLL registers,
# so deserialization rejects mismatches (StatsManager drops + warns, and
# stats-analyze regenerates — sketches are derived data).
# v2: numeric values hash through a PURE-32-BIT pipeline (2x murmur32
# fmix over the value's 32-bit halves; floats canonicalized via their f32
# bit pattern) so the DEVICE observation kernels (engine.stats) can run
# it — the TPU x64 rewriter has no rule for 64-bit bitcasts, so an
# f64-bit-pattern hash cannot compile there. Strings keep FNV-1a+fmix64
# (host-only path). f32 canonicalization merges float values closer than
# f32 resolution — irrelevant at sketch precision.
HASH_VERSION = "fnv1a-fmix64-str.m32x2-num-v2"

_M32_1 = np.uint32(0x85EBCA6B)
_M32_2 = np.uint32(0xC2B2AE35)


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * _M32_1
    h = h ^ (h >> np.uint32(13))
    h = h * _M32_2
    h = h ^ (h >> np.uint32(16))
    return h


def _halves_u32(u: np.ndarray):
    """(lo, hi) 32-bit halves of a numeric column's canonical pattern:
    floats -> their f32 bit pattern (hi = 0), ints/bools -> 64-bit wrap
    split. Mirrored exactly by engine.stats._halves_u32_dev."""
    if u.dtype.kind == "f":
        return u.astype(np.float32).view(np.uint32), np.zeros(
            len(u), np.uint32
        )
    if u.dtype.kind == "M":
        u = u.astype("datetime64[ms]").view(np.int64)
    v = u.astype(np.uint64)
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (
        v >> np.uint64(32)
    ).astype(np.uint32)


def _hash64_numeric(lo: np.ndarray, hi: np.ndarray, seed: int):
    """(h1, h2) u32 pair — the numeric hash family shared with the device
    kernels. h1 carries the HLL register index / CMS column, (h1, h2)
    together form the 64-bit rank word."""
    s1 = np.uint32((seed * 0x9E3779B9 + 0x165667B1) & 0xFFFFFFFF)
    s2 = np.uint32((seed * 0x85EBCA77 + 0x27D4EB2F) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        h1 = _fmix32(lo ^ _fmix32(hi ^ s1))
        h2 = _fmix32(h1 ^ hi ^ s2)
    return h1, h2


def _hash64(values, seed: int = 0) -> np.ndarray:
    """Vectorized 64-bit hash of each element's string form.

    NumPy unicode arrays are fixed-width UCS4, so viewing as uint32 gives a
    dense [n, width] codepoint matrix; an FNV-1a fold then loops over the
    (small) string width while staying vectorized across elements. Padding
    NULs are skipped so the result is independent of the batch's max width.
    A murmur3 fmix64 finalizer supplies the avalanche that HyperLogLog's
    top-bit index / leading-zero rank split requires.
    """
    u = np.asarray(values)
    init = np.uint64((_FNV_OFFSET ^ (seed * _SEED_MIX)) & 0xFFFFFFFFFFFFFFFF)
    if u.dtype.kind in "iubfM" and u.dtype.itemsize <= 8:
        # numeric fast path: the device-shared pure-32-bit family (no
        # string materialization). Same-value-same-hash holds because a
        # column keeps one dtype; only register-merge consistency matters.
        lo, hi = _halves_u32(u)
        h1, h2 = _hash64_numeric(lo, hi, seed)
        return (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)
    if u.dtype.kind != "U":
        u = u.astype(str)
    n = u.shape[0]
    if n == 0:
        return np.zeros(0, np.uint64)
    width = u.dtype.itemsize // 4
    h = np.full(n, init, np.uint64)
    with np.errstate(over="ignore"):
        if width:
            codes = (
                np.ascontiguousarray(u)
                .view(np.uint32)
                .reshape(n, width)
                .astype(np.uint64)
            )
            for j in range(width):
                c = codes[:, j]
                nz = c != 0
                h = np.where(nz, (h ^ c) * _FNV_PRIME, h)
        h ^= h >> _U33
        h *= _M1
        h ^= h >> _U33
        h *= _M2
        h ^= h >> _U33
    return h


def _bit_length_u64(x: np.ndarray) -> np.ndarray:
    """Vectorized bit_length of uint64 values (0 -> 0), computed from the
    value's 32-bit halves via the FLOAT32 exponent field — the exact
    formulation the device kernels use (engine.stats._bit_length_u32_dev;
    the TPU x64 rewriter cannot bitcast 64-bit), so host- and device-
    observed HLL ranks agree bit-for-bit. Round-to-nearest can overstate
    a half's length by 1 for values with >=23 consecutive 1-bits after
    the leading bit (~2^-23): deterministic and IDENTICAL on both sides,
    irrelevant at HLL precision."""
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def bl32(v):
        f = v.astype(np.float32)
        exp = (f.view(np.uint32) >> np.uint32(23)).astype(np.int64) & 0xFF
        return np.where(v > 0, exp - 126, 0)

    return np.where(hi > 0, 32 + bl32(hi), bl32(lo))


class Stat:
    """Base: observe(values, mask) ; merge(other) ; result() ; to_json().

    Subclasses carry an `attribute` field naming the observed column.
    (No default here: a class-level default would leak into the dataclass
    subclasses' field ordering.)
    """

    kind = "stat"

    def observe(self, values, mask=None):
        raise NotImplementedError

    def merge(self, other: "Stat") -> "Stat":
        raise NotImplementedError

    def result(self):
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_json(d: dict) -> "Stat":
        cls = _KINDS[d["kind"]]
        return cls._from_json(d)


def _masked(values, mask):
    values = np.asarray(values)
    if mask is not None:
        values = values[np.asarray(mask)]
    return values


@dataclasses.dataclass
class MinMax(Stat):
    attribute: str
    min: Optional[float] = None
    max: Optional[float] = None
    kind = "minmax"

    def observe(self, values, mask=None):
        v = _masked(values, mask)
        if len(v):
            lo, hi = float(np.min(v)), float(np.max(v))
            self.min = lo if self.min is None else min(self.min, lo)
            self.max = hi if self.max is None else max(self.max, hi)

    def merge(self, other):
        if other.min is not None:
            self.observe(np.array([other.min, other.max]))
        return self

    def result(self):
        return (self.min, self.max)

    def to_json(self):
        return {"kind": self.kind, "attribute": self.attribute,
                "min": self.min, "max": self.max}

    @classmethod
    def _from_json(cls, d):
        return cls(d["attribute"], d["min"], d["max"])


class Cardinality(Stat):
    """HyperLogLog distinct-count estimate (upstream: HyperLogLog via
    stream-lib). Standard HLL with 2^p registers, p=12 (~1.6% error)."""

    kind = "cardinality"

    def __init__(self, attribute: str, p: int = 12, registers=None):
        self.attribute = attribute
        self.p = p
        self.m = 1 << p
        self.registers = (
            np.zeros(self.m, np.uint8) if registers is None else np.asarray(registers, np.uint8)
        )

    # processed per chunk so the hash/rank temporaries stay cache-resident:
    # one 67M-value call measured 17.6s monolithic vs 4.6s chunked (the
    # pipeline is memory-bandwidth-bound, ~8 array passes per value)
    _CHUNK = 1 << 21

    def observe(self, values, mask=None):
        v = _masked(values, mask)
        for s in range(0, len(v), self._CHUNK):
            self._observe_chunk(v[s : s + self._CHUNK])

    def _observe_chunk(self, v):
        if not len(v):
            return
        h = _hash64(v)
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        with np.errstate(over="ignore"):
            rest = h << np.uint64(self.p)
        # rank = 1-based position of the first 1-bit in the remaining word
        rank = np.where(rest > 0, 65 - _bit_length_u64(rest), 64 - self.p + 1)
        # per-register max without ufunc.at (which is unbuffered and ~100x
        # slower): bincount the (register, rank) pairs — ranks fit in 65
        # columns — then take the highest occupied column per register
        occ = np.bincount(idx * 65 + rank, minlength=self.m * 65).reshape(
            self.m, 65
        )
        batch_max = ((occ > 0) * np.arange(65)).max(axis=1).astype(np.uint8)
        self.registers = np.maximum(self.registers, batch_max)

    def observe_registers(self, ranks: np.ndarray):
        """Fold device-computed register ranks (engine.stats.hll_registers
        — bit-identical hash family, so max-merge is lossless)."""
        ranks = np.asarray(ranks)
        if ranks.shape != (self.m,):
            raise ValueError(
                f"register fold shape {ranks.shape} != (m={self.m},)"
            )
        self.registers = np.maximum(
            self.registers, ranks.astype(np.uint8)
        )

    def merge(self, other):
        self.registers = np.maximum(self.registers, other.registers)
        return self

    def result(self) -> float:
        m = self.m
        alpha = 0.7213 / (1 + 1.079 / m)
        est = alpha * m * m / np.sum(2.0 ** -self.registers.astype(np.float64))
        zeros = int(np.sum(self.registers == 0))
        if est <= 2.5 * m and zeros:
            est = m * math.log(m / zeros)
        return float(est)

    def to_json(self):
        return {"kind": self.kind, "attribute": self.attribute, "p": self.p,
                "hash": HASH_VERSION, "registers": self.registers.tolist()}

    @classmethod
    def _from_json(cls, d):
        if d.get("hash") != HASH_VERSION:
            raise ValueError(
                f"cardinality sketch was built with hash "
                f"{d.get('hash', 'blake2b-v0')!r}, this build uses "
                f"{HASH_VERSION!r}; rerun stats-analyze"
            )
        return cls(d["attribute"], d["p"], d["registers"])


class Frequency(Stat):
    """Count-Min sketch for value frequencies (upstream: Frequency).

    Two keying modes, fixed at construction and enforced across merge and
    JSON round trips: string keys (default — values are stringified before
    hashing, matching dictionary-column feeds) or NUMERIC keys (the raw
    64-bit value pattern — what the device observation kernel
    engine.stats.cms_table produces; upstream likewise hashes primitive
    attribute values directly)."""

    kind = "frequency"

    def __init__(self, attribute: str, width: int = 1024, depth: int = 4,
                 table=None, numeric_keys: bool = False):
        self.attribute = attribute
        self.width = width
        self.depth = depth
        self.numeric_keys = numeric_keys
        self.table = (
            np.zeros((depth, width), np.int64) if table is None else np.asarray(table, np.int64)
        )

    def _cols(self, vals: np.ndarray, d: int) -> np.ndarray:
        return (_hash64(vals, seed=d + 1) % np.uint64(self.width)).astype(
            np.int64
        )

    def observe_table(self, table: np.ndarray):
        """Fold a device-computed [depth, width] observation
        (engine.stats.cms_table; numeric-keyed sketches only)."""
        if not self.numeric_keys:
            raise ValueError(
                "observe_table feeds numeric-keyed CMS observations; this "
                "sketch is string-keyed (construct with numeric_keys=True)"
            )
        table = np.asarray(table, np.int64)
        if table.shape != self.table.shape:
            raise ValueError(
                f"CMS fold shape {table.shape} != {self.table.shape}"
            )
        self.table += table

    def _add(self, vals: np.ndarray, counts: np.ndarray):
        counts = np.asarray(counts, np.int64)
        for d in range(self.depth):
            np.add.at(self.table[d], self._cols(vals, d), counts)

    def observe(self, values, mask=None):
        v = _masked(np.asarray(values), mask)
        if not len(v):
            return
        if self.numeric_keys:
            # raw 64-bit pattern keying (device-kernel-compatible)
            uniq, counts = np.unique(v, return_counts=True)
            self._add(uniq, counts)
            return
        # unique on RAW values (cheap for numeric columns), stringify only
        # the distinct values so hashing matches the string-keyed count()
        try:
            uniq, counts = np.unique(v, return_counts=True)
        except TypeError:  # unsortable mixed objects
            uniq, counts = np.unique(v.astype(str), return_counts=True)
        self._add(uniq.astype(str), counts)

    def observe_counts(self, vocab: Sequence[str], counts: np.ndarray):
        """Feed from engine.stats.masked_value_counts results."""
        if self.numeric_keys:
            raise ValueError("numeric-keyed CMS cannot fold string vocab")
        self._add(np.asarray(vocab, dtype=str), counts)

    def count(self, value) -> int:
        if self.numeric_keys:
            vals = np.asarray([value])
            if vals.dtype.kind not in "iufb":
                raise ValueError(
                    "numeric-keyed CMS lookups need a numeric value"
                )
        else:
            vals = np.asarray([str(value)])
        return int(
            min(self.table[d, self._cols(vals, d)[0]] for d in range(self.depth))
        )

    def merge(self, other):
        if self.numeric_keys != getattr(other, "numeric_keys", False):
            raise ValueError(
                "cannot merge numeric-keyed and string-keyed CMS sketches"
            )
        self.table += other.table
        return self

    def result(self):
        return self

    def to_json(self):
        return {"kind": self.kind, "attribute": self.attribute,
                "width": self.width, "depth": self.depth,
                "hash": HASH_VERSION, "numeric_keys": self.numeric_keys,
                "table": self.table.tolist()}

    @classmethod
    def _from_json(cls, d):
        if d.get("hash") != HASH_VERSION:
            raise ValueError(
                f"frequency sketch was built with hash "
                f"{d.get('hash', 'blake2b-v0')!r}, this build uses "
                f"{HASH_VERSION!r}; rerun stats-analyze"
            )
        return cls(d["attribute"], d["width"], d["depth"], d["table"],
                   numeric_keys=bool(d.get("numeric_keys", False)))


class TopK(Stat):
    """Top-k most frequent values. Upstream uses StreamSummary; dictionary
    encoding makes exact per-code counting cheap, so this is exact."""

    kind = "topk"

    def __init__(self, attribute: str, k: int = 10, counts: Optional[Dict[str, int]] = None):
        self.attribute = attribute
        self.k = k
        self.counts: Dict[str, int] = dict(counts or {})

    def observe(self, values, mask=None):
        v = _masked(np.asarray(values), mask)
        if not len(v):
            return
        if v.dtype.kind == "O":
            with np.errstate(all="ignore"):
                v = v[~np.equal(v, None)]
            if not len(v):
                return
        # unique-then-update: the residual Python loop runs over DISTINCT
        # values only (columns are dictionary-encoded upstream of this)
        try:
            uniq, counts = np.unique(v, return_counts=True)
        except TypeError:
            uniq, counts = np.unique(v.astype(str), return_counts=True)
        self.observe_counts(uniq.astype(str).tolist(), counts)

    def observe_counts(self, vocab: Sequence[str], counts: np.ndarray):
        get = self.counts.get
        for val, c in zip(vocab, np.asarray(counts).tolist()):
            if c:
                self.counts[val] = get(val, 0) + int(c)

    def merge(self, other):
        for k, c in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + c
        return self

    def result(self):
        return sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))[: self.k]

    def to_json(self):
        return {"kind": self.kind, "attribute": self.attribute, "k": self.k,
                "counts": self.counts}

    @classmethod
    def _from_json(cls, d):
        return cls(d["attribute"], d["k"], d["counts"])


@dataclasses.dataclass
class Histogram(Stat):
    attribute: str
    bins: int
    lo: float
    hi: float
    counts: Optional[np.ndarray] = None
    kind = "histogram"

    def __post_init__(self):
        if self.counts is None:
            self.counts = np.zeros(self.bins, np.int64)
        else:
            self.counts = np.asarray(self.counts, np.int64)

    def observe(self, values, mask=None):
        v = _masked(values, mask).astype(np.float64)
        idx = np.clip(
            ((v - self.lo) / ((self.hi - self.lo) / self.bins)).astype(int),
            0,
            self.bins - 1,
        )
        np.add.at(self.counts, idx, 1)

    def observe_counts(self, counts: np.ndarray):
        self.counts += np.asarray(counts, np.int64)

    def merge(self, other):
        self.counts += other.counts
        return self

    def result(self):
        return self.counts

    def to_json(self):
        return {"kind": self.kind, "attribute": self.attribute, "bins": self.bins,
                "lo": self.lo, "hi": self.hi, "counts": self.counts.tolist()}

    @classmethod
    def _from_json(cls, d):
        return cls(d["attribute"], d["bins"], d["lo"], d["hi"], d["counts"])


@dataclasses.dataclass
class DescriptiveStats(Stat):
    attribute: str
    count: int = 0
    sum: float = 0.0
    sum_sq: float = 0.0
    kind = "descriptive"

    def observe(self, values, mask=None):
        v = _masked(values, mask).astype(np.float64)
        self.count += len(v)
        self.sum += float(v.sum())
        self.sum_sq += float((v * v).sum())

    def observe_moments(self, count: int, total: float, total_sq: float):
        self.count += int(count)
        self.sum += float(total)
        self.sum_sq += float(total_sq)

    def merge(self, other):
        self.observe_moments(other.count, other.sum, other.sum_sq)
        return self

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    @property
    def variance(self) -> float:
        if self.count < 2:
            return float("nan")
        return max(
            (self.sum_sq - self.sum * self.sum / self.count) / (self.count - 1), 0.0
        )

    def result(self):
        return {"count": self.count, "mean": self.mean,
                "variance": self.variance,
                "stddev": math.sqrt(self.variance) if self.count >= 2 else float("nan")}

    def to_json(self):
        return {"kind": self.kind, "attribute": self.attribute,
                "count": self.count, "sum": self.sum, "sum_sq": self.sum_sq}

    @classmethod
    def _from_json(cls, d):
        return cls(d["attribute"], d["count"], d["sum"], d["sum_sq"])


class EnumerationStat(Stat):
    """Exact value -> count map (upstream: EnumerationStat)."""

    kind = "enumeration"

    def __init__(self, attribute: str, counts: Optional[Dict[str, int]] = None):
        self.attribute = attribute
        self.counts: Dict[str, int] = dict(counts or {})

    observe = TopK.observe
    observe_counts = TopK.observe_counts
    merge = TopK.merge

    def result(self):
        return dict(self.counts)

    def to_json(self):
        return {"kind": self.kind, "attribute": self.attribute, "counts": self.counts}

    @classmethod
    def _from_json(cls, d):
        return cls(d["attribute"], d["counts"])


class Z3HistogramStat(Stat):
    """Coarse (time-bin, x, y) occupancy counts (upstream: Z3Histogram);
    feeds planner selectivity for spatio-temporal predicates."""

    kind = "z3histogram"

    def __init__(self, geom: str, dtg: str, period: str = "week",
                 bins_per_dim: int = 16, counts: Optional[Dict[str, list]] = None):
        self.attribute = geom
        self.geom = geom
        self.dtg = dtg
        self.period = period
        self.bins_per_dim = bins_per_dim
        # per-time-bin [b,b] grids, keyed by str(bin)
        self.counts: Dict[str, np.ndarray] = {
            k: np.asarray(v, np.int64) for k, v in (counts or {}).items()
        }

    def observe_grid(self, time_bin: int, grid: np.ndarray):
        key = str(int(time_bin))
        if key in self.counts:
            self.counts[key] += np.asarray(grid, np.int64)
        else:
            self.counts[key] = np.asarray(grid, np.int64).copy()

    def observe(self, values, mask=None):
        raise TypeError("Z3HistogramStat is fed via observe_grid")

    def merge(self, other):
        for k, g in other.counts.items():
            if k in self.counts:
                self.counts[k] += g
            else:
                self.counts[k] = g.copy()
        return self

    def estimate(self, xmin, ymin, xmax, ymax, bins: Sequence[int]) -> int:
        """Upper-bound count of features in the box over the given time bins."""
        b = self.bins_per_dim
        c0 = max(0, min(b - 1, int((xmin + 180.0) / 360.0 * b)))
        c1 = max(0, min(b - 1, int((xmax + 180.0) / 360.0 * b)))
        r0 = max(0, min(b - 1, int((ymin + 90.0) / 180.0 * b)))
        r1 = max(0, min(b - 1, int((ymax + 90.0) / 180.0 * b)))
        total = 0
        for tb in bins:
            g = self.counts.get(str(int(tb)))
            if g is not None:
                total += int(g[r0 : r1 + 1, c0 : c1 + 1].sum())
        return total

    def result(self):
        return self.counts

    def to_json(self):
        return {"kind": self.kind, "geom": self.geom, "dtg": self.dtg,
                "period": self.period, "bins_per_dim": self.bins_per_dim,
                "counts": {k: v.tolist() for k, v in self.counts.items()}}

    @classmethod
    def _from_json(cls, d):
        return cls(d["geom"], d["dtg"], d["period"], d["bins_per_dim"], d["counts"])


class GroupBy(Stat):
    """Group a sub-stat by the values of an attribute (upstream: GroupBy)."""

    kind = "groupby"

    def __init__(self, attribute: str, substat_factory, groups=None):
        self.attribute = attribute
        self.factory = substat_factory
        self.groups: Dict[str, Stat] = groups or {}

    def observe_grouped(self, key: str, values, mask=None):
        if key not in self.groups:
            sub = self.factory() if self.factory else None
            if sub is None:
                raise TypeError(
                    "deserialized GroupBy is read-only for new groups "
                    "(substat factory not serialized)"
                )
            self.groups[key] = sub
        self.groups[key].observe(values, mask)

    def observe(self, values, mask=None):
        raise TypeError("GroupBy is fed via observe_grouped")

    def merge(self, other):
        for k, s in other.groups.items():
            if k in self.groups:
                self.groups[k].merge(s)
            else:
                self.groups[k] = s
        return self

    def result(self):
        return {k: s.result() for k, s in self.groups.items()}

    def to_json(self):
        return {"kind": self.kind, "attribute": self.attribute,
                "groups": {k: s.to_json() for k, s in self.groups.items()}}

    @classmethod
    def _from_json(cls, d):
        groups = {k: Stat.from_json(s) for k, s in d["groups"].items()}
        return cls(d["attribute"], lambda: None, groups)


class SeqStat(Stat):
    """A sequence of stats observed together (the ';' in the DSL)."""

    kind = "seq"

    def __init__(self, stats: List[Stat]):
        self.stats = stats

    def observe(self, values, mask=None):
        raise TypeError("observe SeqStat members individually")

    def merge(self, other):
        for a, b in zip(self.stats, other.stats):
            a.merge(b)
        return self

    def result(self):
        return [s.result() for s in self.stats]

    def to_json(self):
        return {"kind": self.kind, "stats": [s.to_json() for s in self.stats]}

    @classmethod
    def _from_json(cls, d):
        return cls([Stat.from_json(s) for s in d["stats"]])


_KINDS = {
    c.kind: c
    for c in (MinMax, Cardinality, Frequency, TopK, Histogram,
              DescriptiveStats, EnumerationStat, Z3HistogramStat, GroupBy, SeqStat)
}
