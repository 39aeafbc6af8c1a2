"""Storage of the port: the Parquet filesystem store, its datetime
partition scheme, and the single-device residency cache."""

from geomesa_tpu_torch.store.partition import DateTimeScheme, scheme_from_config
from geomesa_tpu_torch.store.fs import FileSystemStorage

__all__ = ["DateTimeScheme", "scheme_from_config", "FileSystemStorage"]
