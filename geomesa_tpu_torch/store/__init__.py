"""Storage of the port: the Parquet filesystem store, its partition
schemes, and the single-device residency cache."""

from geomesa_tpu_torch.store.partition import (
    AttributeScheme, CompositeScheme, DateTimeScheme, PartitionScheme,
    XZ2Scheme, Z2Scheme, scheme_from_config)
from geomesa_tpu_torch.store.fs import FileSystemStorage

__all__ = ["AttributeScheme", "CompositeScheme", "DateTimeScheme",
           "PartitionScheme", "XZ2Scheme", "Z2Scheme", "scheme_from_config",
           "FileSystemStorage"]
