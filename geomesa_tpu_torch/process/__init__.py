"""GeoTools-style processes over a FeatureSource (DensityProcess)."""

from geomesa_tpu_torch.process.density import DensityProcess

__all__ = ["DensityProcess"]
