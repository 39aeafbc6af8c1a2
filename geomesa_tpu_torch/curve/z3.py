"""Z3 space-filling curve: (lon, lat, time-offset) -> 63-bit Morton key.

A copy of the reference package's `curve/z3.py` (host NumPy): the
key-value store's Z3 index and the attribute index's z3 tier.

Parity: org.locationtech.geomesa.curve.Z3SFC (geomesa-z3) [upstream,
unverified]: 21 bits per dimension; the time dimension is the offset within a
BinnedTime period (week by default), normalized over the period's maximum
length. A full Z3 index key in the reference is
[shard][2-byte epoch bin][8-byte z3][feature id]; here the (bin, z3) pair is
the logical key and shard/id belong to the storage layer.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from geomesa_tpu_torch.curve.binned_time import (
    TimePeriod,
    bins_for_interval,
    max_offset_seconds,
    to_binned_time,
)
from geomesa_tpu_torch.curve.normalized import (
    NormalizedLat,
    NormalizedLon,
    NormalizedTime,
)
from geomesa_tpu_torch.curve.zorder import MAX_BITS_3D, deinterleave3, interleave3
from geomesa_tpu_torch.curve.zranges import IndexRange, zranges


class Z3SFC:
    def __init__(self, period: "str | TimePeriod" = TimePeriod.WEEK, bits: int = MAX_BITS_3D):
        assert 1 <= bits <= MAX_BITS_3D
        self.bits = bits
        self.period = TimePeriod.parse(period)
        self.lon = NormalizedLon(bits)
        self.lat = NormalizedLat(bits)
        self.time = NormalizedTime(max_offset_seconds(self.period), bits)

    def index(self, lon, lat, epoch_millis) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized (lon, lat, dtg-millis) -> (bin int32, z3 int64)."""
        bins, offs = to_binned_time(epoch_millis, self.period)
        z = interleave3(
            self.lon.normalize(lon),
            self.lat.normalize(lat),
            self.time.normalize(offs),
        )
        return bins, z

    def invert(self, z) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """z3 -> (lon, lat, offset-seconds) cell centers."""
        x, y, t = deinterleave3(z)
        return self.lon.denormalize(x), self.lat.denormalize(y), self.time.denormalize(t)

    def ranges(
        self,
        xmin: float,
        ymin: float,
        xmax: float,
        ymax: float,
        t_start_millis: int,
        t_end_millis: int,
        max_ranges: int = 2000,
    ) -> Dict[int, List[IndexRange]]:
        """Covering z3-ranges per epoch bin for a lon/lat/time box."""
        nx = (int(self.lon.normalize(xmin)), int(self.lon.normalize(xmax)))
        ny = (int(self.lat.normalize(ymin)), int(self.lat.normalize(ymax)))
        out: Dict[int, List[IndexRange]] = {}
        bins = bins_for_interval(t_start_millis, t_end_millis, self.period)
        budget = max(1, max_ranges // max(1, len(bins)))
        for b, lo, hi in bins:
            nt = (int(self.time.normalize(lo)), int(self.time.normalize(hi)))
            out[b] = zranges(
                (nx[0], ny[0], nt[0]),
                (nx[1], ny[1], nt[1]),
                self.bits,
                max_ranges=budget,
            )
        return out
