"""GeoTools-style processes over a FeatureSource: DensityProcess and
TubeSelectProcess with its gap fills."""

from geomesa_tpu_torch.process.density import DensityProcess
from geomesa_tpu_torch.process.tube import (
    InterpolatedGapFill, LineGapFill, NoGapFill, TubeBuilder, TubeSelectProcess)

__all__ = ["DensityProcess", "TubeSelectProcess", "TubeBuilder", "NoGapFill",
           "LineGapFill", "InterpolatedGapFill"]
