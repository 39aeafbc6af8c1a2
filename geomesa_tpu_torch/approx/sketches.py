"""Per-partition, version-exact occupancy sketches for the approximate
answer tier. A copy of the reference package's `approx/sketches.py`
(host NumPy; the sidecar's format is the reference's, so either package
loads the other's).

The stats layer's sketches (stats/sketches.py) are STORE-global and
rebuilt lazily — good enough for planner cost estimates, but unusable
as an answer path: a racing write can interleave with the lazy rebuild
and a merge over them is not pinned to any committed write version (the
torn-merge hazard). This module keeps one sketch
PER PARTITION, keyed by the partition's manifest entry list — the exact
unit `FileSystemStorage.manifest_snapshot()` versions — so a merge over
a plan's snapshot either finds a sketch for every pruned partition at
the snapshot's committed version or refuses typed (`StaleSketch`);
it can never mix sketch state from two write versions.

Sketch contents: a `bins_per_dim x bins_per_dim` spatial occupancy grid
per time bin (the Z3Histogram shape, at serving resolution — default
64x64 per week bin), binned with the SAME arithmetic the stats layer
uses, plus the partition's exact row count. Mergeable by cell-wise sum;
every answer derives a deterministic [lo, hi] interval (inner cells =
fully inside the query, outer cells = overlapping it), so reported
bounds are a-priori guarantees, not confidence heuristics.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curve.binned_time import TimePeriod, to_binned_time

# serving-resolution default: 64x64 cells per time bin. 16x (each dim)
# finer than the planner's 16x16 cost sketch — the bound scales with
# the query-edge cell mass, so resolution is what buys tolerance fits.
DEFAULT_BINS = 64

_WEEK_MS = 7 * 86400_000
_EPOCH_DOW_OFFSET_MS = 4 * 86400_000  # 1970-01-01 was a Thursday


def world_cells(x: np.ndarray, y: np.ndarray, b: int):
    """(rows, cols) world-grid cell indices of lon/lat arrays — THE
    binning arithmetic every sketch producer and consumer must share
    (partition builds, the subscribe tier's host fold, cell_ranges'
    edge classification): the bound guarantees hold only while all
    sides bin identically."""
    cols = np.clip(((np.asarray(x) + 180.0) / 360.0 * b).astype(int),
                   0, b - 1)
    rows = np.clip(((np.asarray(y) + 90.0) / 180.0 * b).astype(int),
                   0, b - 1)
    return rows, cols


class StaleSketch(RuntimeError):
    """Typed refusal: a pruned partition has no sketch at the plan
    snapshot's committed version (racing write, compaction, or a cold
    store with builds disabled). The caller falls through to the exact
    device path — never to a torn merge."""

    def __init__(self, partition: str, detail: str = ""):
        super().__init__(
            f"no version-exact sketch for partition {partition!r}"
            + (f": {detail}" if detail else ""))
        self.partition = partition


def entry_token(entries: Sequence[dict]) -> tuple:
    """The version token of one partition's manifest entry list: the
    (file, count) pairs IN ORDER. Writes append entries, compaction
    replaces them — both change the token, so equal tokens imply the
    partition's on-disk bytes are exactly what the sketch observed."""
    return tuple((e["file"], int(e["count"])) for e in entries)


def _week_bounds_ms(b: int) -> Tuple[int, int]:
    start = b * _WEEK_MS - _EPOCH_DOW_OFFSET_MS
    return start, start + _WEEK_MS


class PartitionSketch:
    """One partition's occupancy sketch at one manifest version."""

    __slots__ = ("token", "rows", "grids", "bins_per_dim", "has_time")

    def __init__(self, token: tuple, rows: int,
                 grids: Dict[int, np.ndarray], bins_per_dim: int,
                 has_time: bool):
        self.token = token
        self.rows = rows
        self.grids = grids          # time-bin -> [b, b] int64 (row=y)
        self.bins_per_dim = bins_per_dim
        self.has_time = has_time    # False: single bin 0, no dtg


class PartitionSketchStore:
    """Version-exact sketch cache over one FileSystemStorage.

    `get(name, entries)` returns the cached sketch only when its token
    matches `entries` exactly; `build(name, entries)` scans JUST those
    files (pinned — never the live manifest) and caches the result.
    Thread-safe; bounded (oldest partitions evicted past `max_parts` —
    a dropped sketch is never wrong, only rebuild-slow)."""

    def __init__(self, storage, bins_per_dim: int = DEFAULT_BINS,
                 max_parts: int = 4096):
        self.storage = storage
        self.bins_per_dim = int(bins_per_dim)
        self.max_parts = max_parts
        self._lock = threading.Lock()
        self._sketches: Dict[str, PartitionSketch] = {}
        self._sidecar_loaded = 0
        self._sidecar_stale = 0
        sft = storage.sft
        g = sft.default_geometry
        if g is None or g.type != "Point":
            raise ValueError(
                "partition sketches need a point default geometry")
        self._geom = g.name
        d = sft.default_dtg
        self._dtg = d.name if d is not None else None

    def get(self, name: str, entries: Sequence[dict]
            ) -> Optional[PartitionSketch]:
        token = entry_token(entries)
        with self._lock:
            sk = self._sketches.get(name)
        if sk is not None and sk.token == token:
            return sk
        return None

    def build(self, name: str, entries: Sequence[dict]) -> PartitionSketch:
        """Scan exactly `entries`' files and sketch them. Raises
        StaleSketch when a pinned file vanished under us (compaction
        won the race) — the caller's typed fallthrough, not a crash."""
        token = entry_token(entries)
        b = self.bins_per_dim
        grids: Dict[int, np.ndarray] = {}
        rows = 0
        try:
            batches = list(self.storage.scan_partitions(
                [name], manifest={name: list(entries)}))
        except OSError as e:
            raise StaleSketch(name, f"pinned read failed ({e})") from e
        for batch in batches:
            if batch.valid is not None and not batch.valid.all():
                batch = batch.select(batch.valid)
            n = len(batch)
            if not n:
                continue
            rows += n
            gc = batch.columns[self._geom]
            cy, cx = world_cells(gc.x, gc.y, b)
            if self._dtg is not None:
                bins, _ = to_binned_time(
                    np.asarray(batch.columns[self._dtg]), TimePeriod.WEEK)
                ubins, binv = np.unique(bins, return_inverse=True)
                cells = b * b
                flat = np.bincount(
                    binv * cells + cy * b + cx,
                    minlength=len(ubins) * cells).reshape(len(ubins), b, b)
                for i, tb in enumerate(ubins):
                    key = int(tb)
                    if key in grids:
                        grids[key] += flat[i]
                    else:
                        grids[key] = flat[i].astype(np.int64)
            else:
                g0 = np.bincount(cy * b + cx, minlength=b * b).reshape(b, b)
                if 0 in grids:
                    grids[0] += g0
                else:
                    grids[0] = g0.astype(np.int64)
        expected = sum(int(e["count"]) for e in entries)
        if rows != expected:
            # a pinned file was rewritten in place (never happens with
            # uuid file names) or partially read: refuse rather than
            # serve a sketch whose mass disagrees with the manifest
            raise StaleSketch(
                name, f"scanned {rows} rows, manifest says {expected}")
        sk = PartitionSketch(token, rows, grids, b,
                             has_time=self._dtg is not None)
        with self._lock:
            if len(self._sketches) >= self.max_parts and \
                    name not in self._sketches:
                # oldest-first eviction; a dropped sketch only costs a
                # rebuild on its next approximate query
                self._sketches.pop(next(iter(self._sketches)))
            self._sketches[name] = sk
        return sk

    def drop(self, name: Optional[str] = None) -> None:
        with self._lock:
            if name is None:
                self._sketches.clear()
            else:
                self._sketches.pop(name, None)

    def stats(self) -> dict:
        with self._lock:
            return {"partitions": len(self._sketches),
                    "bins_per_dim": self.bins_per_dim,
                    "sidecar_loaded": self._sidecar_loaded,
                    "sidecar_stale": self._sidecar_stale}

    # -- manifest-versioned sidecar (warm spin-up) --------------------------
    # The sidecar persists each partition's
    # sketch WITH its manifest entry token; a loading process installs
    # only entries whose token still matches the CURRENT committed
    # manifest, so a stale entry (racing write, compaction) is a typed
    # skip-and-rebuild, never a torn load. One atomic file (tmp +
    # os.replace), exactly like the device-cache manifest.

    SIDECAR = ".approx_sketches.json"
    SIDECAR_VERSION = 1

    @property
    def sidecar_path(self) -> Optional[str]:
        root = getattr(self.storage, "root", None)
        if not root:
            return None
        return os.path.join(root, self.SIDECAR)

    def save_sidecar(self, path: Optional[str] = None) -> Optional[str]:
        """Persist every cached sketch with its version token. Snapshot
        under the lock, serialize+write outside it (the file I/O must
        not stall concurrent merges)."""
        from geomesa_tpu_torch.parallel.distributed import is_coordinator

        if not is_coordinator():
            # multi-process: the coordinator owns the sidecar. Sketches
            # are built from the shared store, so every process holds
            # the same ones: dropping the write loses nothing
            return None
        path = path or self.sidecar_path
        if path is None:
            return None
        with self._lock:
            snapshot = dict(self._sketches)
        doc = {
            "sidecar_version": self.SIDECAR_VERSION,
            "bins_per_dim": self.bins_per_dim,
            "partitions": {
                name: {
                    "token": [[f, int(c)] for f, c in sk.token],
                    "rows": int(sk.rows),
                    "has_time": bool(sk.has_time),
                    "grids": {str(b): g.ravel().tolist()
                              for b, g in sk.grids.items()},
                }
                for name, sk in snapshot.items()
            },
        }
        import tempfile

        # unique tmp in the SAME directory (os.replace needs one
        # filesystem): two savers — fleet replicas sharing a catalog,
        # two builder threads — must never interleave writes into one
        # tmp file; the last atomic replace wins with a complete document
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path) or ".",
            prefix=os.path.basename(path) + ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def load_sidecar(self, path: Optional[str] = None
                     ) -> Tuple[int, int]:
        """Install sidecar sketches whose token matches the CURRENT
        committed manifest; returns (loaded, stale). Stale, malformed
        or schema-drifted entries are skipped typed — a rebuild on
        first use is the worst case, exactly the cold behavior."""
        path = path or self.sidecar_path
        if path is None or not os.path.exists(path):
            return 0, 0
        snap_fn = getattr(self.storage, "manifest_snapshot", None)
        if snap_fn is None:
            return 0, 0
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return 0, 0
        if doc.get("sidecar_version") != self.SIDECAR_VERSION \
                or doc.get("bins_per_dim") != self.bins_per_dim:
            return 0, 0
        snap = snap_fn()
        b = self.bins_per_dim
        loaded = stale = 0
        has_time_now = self._dtg is not None
        for name, meta in doc.get("partitions", {}).items():
            token = tuple((f, int(c)) for f, c in meta.get("token", ()))
            if token != entry_token(snap.get(name, [])) \
                    or bool(meta.get("has_time")) != has_time_now:
                stale += 1
                continue
            try:
                grids = {
                    int(bk): np.asarray(flat, np.int64).reshape(b, b)
                    for bk, flat in meta["grids"].items()
                }
                sk = PartitionSketch(token, int(meta["rows"]), grids, b,
                                     has_time=has_time_now)
            except (KeyError, TypeError, ValueError):
                stale += 1
                continue
            with self._lock:
                if len(self._sketches) >= self.max_parts and \
                        name not in self._sketches:
                    self._sketches.pop(next(iter(self._sketches)))
                self._sketches[name] = sk
            loaded += 1
        with self._lock:
            self._sidecar_loaded += loaded
            self._sidecar_stale += stale
        return loaded, stale


# -- merge + bound math ------------------------------------------------------


def cell_ranges(bbox, b: int) -> Tuple[int, int, int, int, int, int, int, int]:
    """(c0, c1, r0, r1, ci0, ci1, ri0, ri1): the outer (overlapping)
    and inner (fully contained) cell index ranges of `bbox` on a
    [b, b] world grid, computed with the SAME binning arithmetic points
    are sketched with — the edge cells holding the bbox boundary are
    always outer-only, so [inner, outer] sums bracket the true count
    regardless of float rounding at the edges."""
    c0 = max(0, min(b - 1, int((bbox.xmin + 180.0) / 360.0 * b)))
    c1 = max(0, min(b - 1, int((bbox.xmax + 180.0) / 360.0 * b)))
    r0 = max(0, min(b - 1, int((bbox.ymin + 90.0) / 180.0 * b)))
    r1 = max(0, min(b - 1, int((bbox.ymax + 90.0) / 180.0 * b)))
    ci0 = 0 if bbox.xmin <= -180.0 else c0 + 1
    ci1 = b - 1 if bbox.xmax >= 180.0 else c1 - 1
    ri0 = 0 if bbox.ymin <= -90.0 else r0 + 1
    ri1 = b - 1 if bbox.ymax >= 90.0 else r1 - 1
    return c0, c1, r0, r1, ci0, ci1, ri0, ri1


def split_time_bins(grids: Dict[int, np.ndarray], interval
                    ) -> Tuple[List[int], List[int]]:
    """(outer_bins, inner_bins) of the sketch's time bins against the
    query interval: outer = bins that may hold matching rows, inner =
    bins whose entire span lies inside the interval. Unbounded sides
    count as covered. Bin classification is conservative — a boundary
    bin is outer-only even when the interval lands exactly on its
    edge."""
    keys = sorted(grids)
    start = interval.start if interval is not None else None
    end = interval.end if interval is not None else None
    if start is None and end is None:
        return keys, keys
    outer: List[int] = []
    inner: List[int] = []
    for bkey in keys:
        b_start, b_end = _week_bounds_ms(bkey)
        if start is not None and b_end <= start:
            continue
        if end is not None and b_start > end:
            continue
        outer.append(bkey)
        # STRICT interior only: a bin whose start coincides with the
        # interval start stays outer — DURING has strict-interior
        # semantics (start < t < end), so a row at exactly t == start
        # must not be counted into the lower bound
        if (start is None or b_start > start) and \
                (end is None or b_end <= end):
            inner.append(bkey)
    return outer, inner


def merge_count_bounds(sketches: Sequence[PartitionSketch], bbox,
                       interval) -> Tuple[int, int]:
    """[lo, hi] bracketing the exact bbox+interval count over the
    merged sketches: lo sums inner cells of inner time bins (every row
    there matches), hi sums outer cells of outer bins (every matching
    row lands there). Deterministic — the interval is a guarantee, not
    a confidence statement."""
    lo = 0
    hi = 0
    for sk in sketches:
        b = sk.bins_per_dim
        c0, c1, r0, r1, ci0, ci1, ri0, ri1 = cell_ranges(bbox, b)
        t_outer, t_inner = split_time_bins(sk.grids, interval)
        inner_set = set(t_inner)
        inner_cells = ci0 <= ci1 and ri0 <= ri1
        for bkey in t_outer:
            g = sk.grids[bkey]
            hi += int(g[r0:r1 + 1, c0:c1 + 1].sum())
            if inner_cells and bkey in inner_set:
                lo += int(g[ri0:ri1 + 1, ci0:ci1 + 1].sum())
    return lo, hi


def merge_region(sketches: Sequence[PartitionSketch], interval
                 ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], int]:
    """(sure, maybe, b): the merged world grid split into mass that is
    certainly inside the time interval (`sure` — inner time bins) and
    mass that may or may not be (`maybe` — outer-minus-inner bins).
    Returns (None, None, 0) for an empty sketch set."""
    b = 0
    sure = maybe = None
    for sk in sketches:
        if b == 0:
            b = sk.bins_per_dim
            sure = np.zeros((b, b), np.int64)
            maybe = np.zeros((b, b), np.int64)
        t_outer, t_inner = split_time_bins(sk.grids, interval)
        inner_set = set(t_inner)
        for bkey in t_outer:
            (sure if bkey in inner_set else maybe)[:] += sk.grids[bkey]
    return sure, maybe, b


def resample_bounds(sure: np.ndarray, maybe: Optional[np.ndarray],
                    bbox: Tuple[float, float, float, float],
                    width: int, height: int
                    ) -> Tuple[np.ndarray, float]:
    """Resample a [b, b] world grid onto a `height x width` grid over
    `bbox`, returning (grid, bound) where `bound` is the maximum
    per-cell absolute error: |grid[r, c] - exact[r, c]| <= bound for
    every cell. A sketch cell mapping strictly inside one target cell
    with all its mass time-certain contributes exactly; straddling or
    time-uncertain cells distribute proportionally by overlap area and
    charge their full mass to every overlapped cell's uncertainty."""
    b = sure.shape[0]
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    out = np.zeros((height, width), np.float64)
    uncert = np.zeros((height, width), np.float64)
    dx = (xmax - xmin) / width
    dy = (ymax - ymin) / height
    sx = 360.0 / b
    sy = 180.0 / b
    c0 = max(0, int((xmin + 180.0) / sx) - 1)
    c1 = min(b - 1, int((xmax + 180.0) / sx) + 1)
    r0 = max(0, int((ymin + 90.0) / sy) - 1)
    r1 = min(b - 1, int((ymax + 90.0) / sy) + 1)
    for r in range(r0, r1 + 1):
        y0s = -90.0 + r * sy
        y1s = y0s + sy
        for c in range(c0, c1 + 1):
            total = float(sure[r, c]) + (
                float(maybe[r, c]) if maybe is not None else 0.0)
            if total == 0.0:
                continue
            x0s = -180.0 + c * sx
            x1s = x0s + sx
            ox0, ox1 = max(x0s, xmin), min(x1s, xmax)
            oy0, oy1 = max(y0s, ymin), min(y1s, ymax)
            if ox0 >= ox1 or oy0 >= oy1:
                continue
            tc0 = max(0, min(width - 1, int((ox0 - xmin) / dx)))
            tc1 = max(0, min(width - 1, int(np.nextafter(
                (ox1 - xmin) / dx, -np.inf))))
            tr0 = max(0, min(height - 1, int((oy0 - ymin) / dy)))
            tr1 = max(0, min(height - 1, int(np.nextafter(
                (oy1 - ymin) / dy, -np.inf))))
            certain = (maybe is None or maybe[r, c] == 0)
            if (tc0 == tc1 and tr0 == tr1 and certain
                    and x0s > xmin + tc0 * dx and x1s < xmin + (tc0 + 1) * dx
                    and y0s > ymin + tr0 * dy and y1s < ymin + (tr0 + 1) * dy):
                # strictly inside one target cell, mass time-certain:
                # exact contribution (no float-edge ambiguity possible)
                out[tr0, tc0] += total
                continue
            area = (x1s - x0s) * (y1s - y0s)
            for tr in range(tr0, tr1 + 1):
                ty0 = ymin + tr * dy
                ty1 = ty0 + dy
                for tc in range(tc0, tc1 + 1):
                    tx0 = xmin + tc * dx
                    tx1 = tx0 + dx
                    ow = max(0.0, min(x1s, tx1) - max(x0s, tx0))
                    oh = max(0.0, min(y1s, ty1) - max(y0s, ty0))
                    if ow <= 0.0 or oh <= 0.0:
                        continue
                    out[tr, tc] += total * (ow * oh) / area
                    uncert[tr, tc] += total
    return out, float(uncert.max()) if uncert.size else 0.0


def topk_cell_bounds(sure: np.ndarray, maybe: Optional[np.ndarray],
                     bbox, k: int) -> List[dict]:
    """Top-k densest world-grid cells intersecting `bbox`, each with a
    deterministic [lo, hi] count interval: inner cells (fully inside
    the bbox) hold [sure, sure+maybe]; edge cells hold [0, sure+maybe]
    (their matching mass depends on where inside the cell the rows
    sit). Ranked by the interval midpoint, ties broken densest-upper-
    bound first then (row, col) for determinism."""
    b = sure.shape[0]
    c0, c1, r0, r1, ci0, ci1, ri0, ri1 = cell_ranges(bbox, b)
    cells: List[dict] = []
    for r in range(r0, r1 + 1):
        for c in range(c0, c1 + 1):
            hi = int(sure[r, c]) + (int(maybe[r, c])
                                    if maybe is not None else 0)
            if hi == 0:
                continue
            inner = ri0 <= r <= ri1 and ci0 <= c <= ci1
            lo = int(sure[r, c]) if inner else 0
            est = (lo + hi) // 2
            cells.append({
                "row": r, "col": c,
                "bbox": [-180.0 + c * 360.0 / b, -90.0 + r * 180.0 / b,
                         -180.0 + (c + 1) * 360.0 / b,
                         -90.0 + (r + 1) * 180.0 / b],
                "count": est,
                "bound": hi - est,
            })
    cells.sort(key=lambda d: (-(d["count"]), -(d["count"] + d["bound"]),
                              d["row"], d["col"]))
    return cells[:k]
