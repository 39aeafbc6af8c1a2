"""Storage of the port: the Parquet (or ORC) filesystem store with its
lifecycle, its partition schemes, the single-device residency cache, and
the Arrow IPC store (`arrow_store.py`, imported on use)."""

from geomesa_tpu_torch.store.partition import (
    AttributeScheme, CompositeScheme, DateTimeScheme, PartitionScheme,
    XZ2Scheme, Z2Scheme, scheme_from_config)
from geomesa_tpu_torch.store.fs import FileSystemStorage

__all__ = ["AttributeScheme", "CompositeScheme", "DateTimeScheme",
           "PartitionScheme", "XZ2Scheme", "Z2Scheme", "scheme_from_config",
           "FileSystemStorage"]
