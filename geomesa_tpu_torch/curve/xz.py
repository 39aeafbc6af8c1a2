"""XZ-ordering: index non-point geometries by enlarged quadtree/octree cells.

Parity: org.locationtech.geomesa.curve.XZ2SFC / XZ3SFC (geomesa-z3) [upstream,
unverified], implementing the XZ-ordering scheme (Boehm, Klump, Kriegel:
"XZ-Ordering: A Space-Filling Curve for Objects with Spatial Extension"): a
geometry's bounding box is assigned to the smallest quadtree cell whose
*enlarged* region (the cell doubled in each dimension, anchored at the cell's
lower corner) contains the box. Each cell has a contiguous "sequence code" so
that a cell and all of its descendants form one contiguous key range —
queries enumerate cells whose enlarged region intersects the query window.
Matches are a superset: residual filtering downstream is mandatory (same
contract as the reference's XZ indices).

XZ3 adds a time dimension with BinnedTime periods, producing per-bin codes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curve.binned_time import (
    TimePeriod,
    bins_for_interval,
    max_offset_seconds,
    to_binned_time,
)
from geomesa_tpu_torch.curve.zranges import IndexRange, _merge


class _XZSFC:
    """Shared XZ logic for arbitrary dimension count (2 or 3)."""

    def __init__(self, g: int, dim_bounds: Sequence[Tuple[float, float]]):
        self.g = g
        self.dims = len(dim_bounds)
        self.fanout = 1 << self.dims
        self.bounds = list(dim_bounds)
        # subtree_size[l] = number of sequence codes in a subtree rooted at
        # level l (inclusive of the root cell, down to level g).
        self.subtree = [
            (self.fanout ** (g - l + 1) - 1) // (self.fanout - 1) for l in range(g + 2)
        ]

    def _normalize(self, values: Sequence[float]) -> List[float]:
        out = []
        for v, (lo, hi) in zip(values, self.bounds):
            out.append(min(max((v - lo) / (hi - lo), 0.0), 1.0))
        return out

    def _sequence_code(self, mins: Sequence[float], length: int) -> int:
        """Code of the level-`length` cell containing the normalized point."""
        cs = 0
        cell_min = [0.0] * self.dims
        cell_w = 1.0
        for level in range(length):
            half = cell_w / 2.0
            quad = 0
            for d in range(self.dims):
                if mins[d] >= cell_min[d] + half:
                    quad |= 1 << d
                    cell_min[d] += half
            cs += 1 + quad * self.subtree[level + 1]
            cell_w = half
        return cs

    def index_box(self, mins: Sequence[float], maxs: Sequence[float]) -> int:
        """Sequence code for a (raw-coordinate) bounding box."""
        nmin = self._normalize(mins)
        nmax = self._normalize(maxs)
        # Width of the box in normalized space determines the max level at
        # which an enlarged (doubled) cell can still contain it.
        w = max(nmax[d] - nmin[d] for d in range(self.dims))
        if w <= 0.0:
            length = self.g
        else:
            length = min(self.g, int(np.floor(-np.log2(w))) + 1)

        def fits(l: int) -> bool:
            if l <= 0:
                return True
            cw = 0.5**l
            for d in range(self.dims):
                if nmax[d] > (np.floor(nmin[d] / cw) * cw) + 2 * cw:
                    return False
            return True

        while length > 0 and not fits(length):
            length -= 1
        return self._sequence_code(nmin, length)

    def ranges_box(
        self,
        mins: Sequence[float],
        maxs: Sequence[float],
        max_ranges: int = 2000,
    ) -> List[IndexRange]:
        """Sequence-code ranges whose cells may hold geometries intersecting
        the query box."""
        qmin = self._normalize(mins)
        qmax = self._normalize(maxs)

        ranges: List[IndexRange] = []
        # Frontier entries: (level, cell_min coords, cell width, sequence code).
        frontier = [(0, tuple(0.0 for _ in range(self.dims)), 1.0, 0)]
        # The root "cell" here is a virtual super-root: treat level 0 as the
        # whole space with code 0 covering everything; start from its children
        # semantics by processing it like any cell.
        while frontier:
            level, cmin, cw, code = frontier.pop()
            # Enlarged region: cell doubled in each dimension.
            disjoint = False
            contained = True
            for d in range(self.dims):
                e_lo, e_hi = cmin[d], cmin[d] + 2 * cw
                if e_lo > qmax[d] or e_hi < qmin[d]:
                    disjoint = True
                    break
                if e_lo < qmin[d] or e_hi > qmax[d]:
                    contained = False
            if disjoint:
                continue
            if contained:
                # Query window contains the whole enlarged cell: the cell and
                # every descendant match unconditionally.
                ranges.append(IndexRange(code, code + self.subtree[level] - 1, True))
                continue
            # Possible match at this cell; recurse into children if any.
            ranges.append(IndexRange(code, code, False))
            if level < self.g and len(ranges) + len(frontier) < max_ranges:
                half = cw / 2.0
                for quad in range(self.fanout):
                    child_min = tuple(
                        cmin[d] + (half if (quad >> d) & 1 else 0.0)
                        for d in range(self.dims)
                    )
                    child_code = code + 1 + quad * self.subtree[level + 1]
                    frontier.append((level + 1, child_min, half, child_code))
            elif level < self.g:
                # Budget exhausted: cover the whole remaining subtree.
                ranges.append(
                    IndexRange(code, code + self.subtree[level] - 1, False)
                )
        return _merge(ranges)


class XZ2SFC(_XZSFC):
    """XZ ordering over (lon, lat). Default resolution g=12 as upstream."""

    def __init__(self, g: int = 12):
        super().__init__(g, [(-180.0, 180.0), (-90.0, 90.0)])

    def index(self, xmin: float, ymin: float, xmax: float, ymax: float) -> int:
        return self.index_box((xmin, ymin), (xmax, ymax))

    def ranges(self, xmin, ymin, xmax, ymax, max_ranges: int = 2000):
        return self.ranges_box((xmin, ymin), (xmax, ymax), max_ranges)


class XZ3SFC(_XZSFC):
    """XZ ordering over (lon, lat, binned-time-offset)."""

    def __init__(self, period: "str | TimePeriod" = TimePeriod.WEEK, g: int = 12):
        self.period = TimePeriod.parse(period)
        self._max_offset = max_offset_seconds(self.period)
        super().__init__(
            g, [(-180.0, 180.0), (-90.0, 90.0), (0.0, self._max_offset)]
        )

    def index(
        self,
        xmin: float,
        ymin: float,
        xmax: float,
        ymax: float,
        t_start_millis: int,
        t_end_millis: int,
    ) -> Tuple[int, int]:
        """Returns (time bin, sequence code). A geometry whose time extent
        spans multiple bins is binned by its start (reference behavior:
        XZ3 uses the start of the interval [upstream, unverified])."""
        b, off0 = to_binned_time(np.int64(t_start_millis), self.period)
        _, off1 = to_binned_time(np.int64(t_end_millis), self.period)
        b = int(b)
        off1 = float(off1) if int(_) == b else self._max_offset
        return b, self.index_box(
            (xmin, ymin, float(off0)), (xmax, ymax, off1)
        )

    def ranges(
        self,
        xmin,
        ymin,
        xmax,
        ymax,
        t_start_millis: int,
        t_end_millis: int,
        max_ranges: int = 2000,
    ) -> Dict[int, List[IndexRange]]:
        out: Dict[int, List[IndexRange]] = {}
        bins = bins_for_interval(t_start_millis, t_end_millis, self.period)
        budget = max(1, max_ranges // max(1, len(bins)))
        for b, lo, hi in bins:
            out[b] = self.ranges_box((xmin, ymin, lo), (xmax, ymax, hi), budget)
        return out
