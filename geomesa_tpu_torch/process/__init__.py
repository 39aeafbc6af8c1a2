"""GeoTools-style processes over a FeatureSource or a FeatureBatch:
DensityProcess, KNearestNeighborSearchProcess, TubeSelectProcess with its
gap fills, and the remaining vector processes (`process/misc.py`)."""

from geomesa_tpu_torch.process.density import DensityProcess
from geomesa_tpu_torch.process.knn import KNearestNeighborSearchProcess, KnnResult
from geomesa_tpu_torch.process.misc import (
    ArrowConversionProcess, BinConversionProcess, DateOffsetProcess,
    HashAttributeProcess, JoinProcess, Point2PointProcess,
    ProximitySearchProcess, QueryProcess, RouteSearchProcess, SamplingProcess,
    StatsProcess, UniqueProcess)
from geomesa_tpu_torch.process.tube import (
    InterpolatedGapFill, LineGapFill, NoGapFill, TubeBuilder, TubeSelectProcess)

__all__ = ["DensityProcess", "KNearestNeighborSearchProcess", "KnnResult",
           "TubeSelectProcess", "TubeBuilder", "NoGapFill", "LineGapFill",
           "InterpolatedGapFill", "ProximitySearchProcess", "QueryProcess",
           "SamplingProcess", "StatsProcess", "UniqueProcess", "JoinProcess",
           "Point2PointProcess", "DateOffsetProcess", "HashAttributeProcess",
           "RouteSearchProcess", "ArrowConversionProcess",
           "BinConversionProcess"]
