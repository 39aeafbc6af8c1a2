"""Z2 space-filling curve: (lon, lat) -> 62-bit Morton key.

Parity: org.locationtech.geomesa.curve.Z2SFC (geomesa-z3) [upstream,
unverified]: 31 bits per dimension, lon/lat normalized over the full WGS84
envelope. Used for the point index without time and for Z2 partition schemes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curve.normalized import NormalizedLat, NormalizedLon
from geomesa_tpu_torch.curve.zorder import MAX_BITS_2D, deinterleave2, interleave2
from geomesa_tpu_torch.curve.zranges import IndexRange, zranges


class Z2SFC:
    def __init__(self, bits: int = MAX_BITS_2D):
        assert 1 <= bits <= MAX_BITS_2D
        self.bits = bits
        self.lon = NormalizedLon(bits)
        self.lat = NormalizedLat(bits)

    def index(self, lon, lat) -> np.ndarray:
        """Vectorized (lon, lat) -> z value (int64)."""
        return interleave2(self.lon.normalize(lon), self.lat.normalize(lat))

    def invert(self, z) -> Tuple[np.ndarray, np.ndarray]:
        """z -> (lon, lat) cell centers."""
        x, y = deinterleave2(z)
        return self.lon.denormalize(x), self.lat.denormalize(y)

    def ranges(
        self,
        xmin: float,
        ymin: float,
        xmax: float,
        ymax: float,
        max_ranges: int = 2000,
    ) -> List[IndexRange]:
        """Covering z-ranges for a lon/lat box."""
        return zranges(
            (int(self.lon.normalize(xmin)), int(self.lat.normalize(ymin))),
            (int(self.lon.normalize(xmax)), int(self.lat.normalize(ymax))),
            self.bits,
            max_ranges=max_ranges,
        )
