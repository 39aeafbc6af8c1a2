"""Host data model of the port: schemas, WKT geometry, columnar batches."""

from geomesa_tpu_torch.core.sft import AttributeDescriptor, SimpleFeatureType
from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn

__all__ = [
    "AttributeDescriptor",
    "SimpleFeatureType",
    "DictColumn",
    "FeatureBatch",
    "GeometryColumn",
]
