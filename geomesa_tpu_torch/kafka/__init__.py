"""Near-real-time live feature layer (the geomesa-kafka analog).

Parity: geomesa-kafka KafkaDataStore / GeoMessage / KafkaFeatureCache
[upstream, unverified]. Streaming upsert is host-side by design; TPU parity
is periodic double-buffered snapshot refresh of device-resident arrays, not
per-message device updates (SURVEY.md C12 TPU note).

A copy of the reference package's `kafka/__init__.py`; on the port, the
snapshot's queries run on the store's device (the card by default).
"""

from geomesa_tpu_torch.kafka.cache import FeatureEvent, KafkaFeatureCache
from geomesa_tpu_torch.kafka.messages import (
    Change,
    Clear,
    Delete,
    GeoMessageSerializer,
)
from geomesa_tpu_torch.kafka.store import InProcessBroker, KafkaDataStore

__all__ = [
    "Change",
    "Clear",
    "Delete",
    "FeatureEvent",
    "GeoMessageSerializer",
    "InProcessBroker",
    "KafkaDataStore",
    "KafkaFeatureCache",
]
