"""geomesa_tpu_torch.faults — what the serial serve route needs of the
reference package's fault fabric.

- `errors.py`: the typed transient/permanent/OOM taxonomy (`classify`);
  a CUDA OOM is `torch.OutOfMemoryError`, and nothing else is an OOM.
- `context.py`: the per-thread request deadline (`deadline_scope`) the
  planner's entry points run inside.
- `quarantine.py`: poison-query quarantine, keyed on the coalescing
  fingerprint.
- `fallback.py`: host evaluation for a request that runs out of memory
  on a CPU store (the serve batcher's last rung there; a store on the
  card fails the request with `DeviceOOM` instead). Loaded lazily, so
  this package root stays import-light.

The injection harness and its plans, bounded retry, circuit breakers and
the recovery meter come with the slices that give them a caller (ROADMAP
A5 and A8); `chaos.py` with A8.
"""

from geomesa_tpu_torch.faults.context import current_deadline, deadline_scope
from geomesa_tpu_torch.faults.errors import (
    DeviceOOM, PermanentError, TransientError, classify)
from geomesa_tpu_torch.faults.quarantine import QuarantineRegistry

__all__ = [
    "current_deadline", "deadline_scope",
    "DeviceOOM", "PermanentError", "TransientError", "classify",
    "QuarantineRegistry",
]
