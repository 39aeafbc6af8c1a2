"""geomesa_tpu_torch.subscribe — standing queries over the Kafka live layer.

A client registers a long-lived predicate (CQL / BBOX / DWITHIN
geofence) or a density/heatmap window and receives incremental push
updates — enter/exit events, density folds — as Kafka batches fold in.
Every poll evaluates parametric geofences (bbox / dwithin / polygon)
as one [S]-batched lane call per class and everything else in ONE
fused device call, on the live store's device (docs/SERVING.md
"Standing queries").

    registry.py   Subscription state: matched-fid sets, decayed grids,
                  bounded outboxes, rate limits, lifecycle + TTL,
                  matched-set handoff snapshots
    lanes.py      lane classification + pow2 [S]-row parameter tables
                  (host side of engine/lanes.py; membership is a row
                  write)
    evaluator.py  delta-driven lane + fused evaluation hooked on
                  KafkaDataStore.poll (exactly-once per batch,
                  quarantine fallback)
    manager.py    admission (tenant buckets, bounds, quarantine),
                  poll/flush driving, wire-layer glue

The port of the reference package's `subscribe/`.
"""

from geomesa_tpu_torch.subscribe.evaluator import DeltaEvaluator
from geomesa_tpu_torch.subscribe.manager import (
    SubscribeConfig, SubscriptionManager)
from geomesa_tpu_torch.subscribe.registry import (
    DensityWindow, Subscription, SubscriptionRegistry)

__all__ = [
    "DeltaEvaluator",
    "DensityWindow",
    "SubscribeConfig",
    "Subscription",
    "SubscriptionManager",
    "SubscriptionRegistry",
]
