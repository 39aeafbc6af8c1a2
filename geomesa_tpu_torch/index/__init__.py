"""Key-value index layer: keyspaces, adapter SPI, and its two backends.

Parity: geomesa-index-api's index catalog + IndexAdapter SPI + the
TestGeoMesaDataStore in-memory reference backend (SURVEY.md C7, C9-C11, §4)
[upstream, unverified]. This is the row-key architecture the reference runs
on Accumulo/HBase/Cassandra/Redis; here one sorted-KV adapter contract backs
all index types, with two implementations proving the SPI the way the
reference's backend plurality does: the in-memory adapter (the
TestGeoMesaDataStore analog) and the durable SQLite adapter + row store
(index/durable.py), whose data survives process restarts.

A copy of the reference package's `index/__init__.py`: the stores'
residual masks and aggregations run on the port's device.
"""

from geomesa_tpu_torch.index.adapter import IndexAdapter, MemoryIndexAdapter
from geomesa_tpu_torch.index.durable import DurableKVDataStore, SqliteIndexAdapter
from geomesa_tpu_torch.index.keyspace import (
    AttributeIndex,
    IdIndex,
    IndexKeySpace,
    S2Index,
    XZ2Index,
    XZ3Index,
    Z2Index,
    Z3Index,
    default_indices,
)
from geomesa_tpu_torch.index.kvstore import KVDataStore, KVFeatureSource
from geomesa_tpu_torch.index.splitter import FilterSplitter, StrategyDecider

__all__ = [
    "IndexAdapter",
    "MemoryIndexAdapter",
    "SqliteIndexAdapter",
    "DurableKVDataStore",
    "IndexKeySpace",
    "Z3Index",
    "Z2Index",
    "S2Index",
    "XZ2Index",
    "XZ3Index",
    "IdIndex",
    "AttributeIndex",
    "default_indices",
    "FilterSplitter",
    "StrategyDecider",
    "KVDataStore",
    "KVFeatureSource",
]
