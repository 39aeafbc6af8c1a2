"""geomesa_tpu_torch.approx — the approximate-answer serving tier.

- **Sketch answer engine** (`SketchAnswerEngine`): `count` / `density`
  / `topk_cells` queries resolved from per-partition mergeable
  occupancy sketches, merged under the plan's `manifest_snapshot()`
  and returned with deterministic error bounds (`approx=True, bound,
  confidence`), only when the a-priori bound fits the client's
  `tolerance` hint; `distinct` counts from per-partition HyperLogLog
  sketches. Every miss pays the exact path on the planner's device.
- **Exact result cache** (`ResultCache`): count/execute results keyed
  on (typeName, canonical CQL, hints, manifest version).

Copies of the reference package's `approx/` modules (host NumPy).
"""

from geomesa_tpu_torch.approx.cache import ResultCache, result_key
from geomesa_tpu_torch.approx.engine import (
    ApproxCount, SketchAnswerEngine, sketch_eligible)
from geomesa_tpu_torch.approx.sketches import (
    PartitionSketch, PartitionSketchStore, StaleSketch, entry_token,
    merge_count_bounds, resample_bounds, topk_cell_bounds, world_cells)

__all__ = [
    "ApproxCount", "PartitionSketch", "PartitionSketchStore",
    "ResultCache", "SketchAnswerEngine", "StaleSketch", "entry_token",
    "merge_count_bounds", "resample_bounds", "result_key",
    "sketch_eligible", "topk_cell_bounds", "world_cells",
]
