"""GeoTools-style processes over a FeatureSource or a FeatureBatch:
DensityProcess, KNearestNeighborSearchProcess and TubeSelectProcess with
its gap fills."""

from geomesa_tpu_torch.process.density import DensityProcess
from geomesa_tpu_torch.process.knn import KNearestNeighborSearchProcess, KnnResult
from geomesa_tpu_torch.process.tube import (
    InterpolatedGapFill, LineGapFill, NoGapFill, TubeBuilder, TubeSelectProcess)

__all__ = ["DensityProcess", "KNearestNeighborSearchProcess", "KnnResult",
           "TubeSelectProcess", "TubeBuilder", "NoGapFill", "LineGapFill",
           "InterpolatedGapFill"]
