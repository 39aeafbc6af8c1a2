"""Space-filling-curve helpers of the port: copies of the reference
package's `curve/` modules (host NumPy). Z2 and XZ2 key the partition
schemes, the time bins key the stats sketches and XZ's time dimension,
and Z3, S2 and XZ3 key the key-value store's indices."""

from geomesa_tpu_torch.curve.normalized import NormalizedDimension, NormalizedLon, NormalizedLat
from geomesa_tpu_torch.curve.zorder import interleave2, interleave3, deinterleave2, deinterleave3
from geomesa_tpu_torch.curve.z2 import Z2SFC
from geomesa_tpu_torch.curve.z3 import Z3SFC
from geomesa_tpu_torch.curve.binned_time import BinnedTime, TimePeriod
from geomesa_tpu_torch.curve.zranges import zranges, IndexRange
from geomesa_tpu_torch.curve.xz import XZ2SFC, XZ3SFC

__all__ = [
    "NormalizedDimension", "NormalizedLon", "NormalizedLat",
    "interleave2", "interleave3", "deinterleave2", "deinterleave3",
    "Z2SFC", "Z3SFC", "BinnedTime", "TimePeriod",
    "zranges", "IndexRange", "XZ2SFC", "XZ3SFC",
]
