"""geomesa_tpu_torch.faults — fault injection + recovery fabric.

The port of the reference package's `faults/`, in two halves:

1. **Injection harness** (`harness.py`, `plan.py`): named sites threaded
   through the dependency boundaries (storage, device transfer, compile
   cache), driven by a declarative seeded `FaultPlan` so failures are a
   replayable INPUT. A single `is None` check when inactive.
2. **Recovery fabric** (`errors.py`, `retry.py`, `breaker.py`,
   `quarantine.py`, `context.py`): typed transient/permanent/OOM
   taxonomy (a CUDA OOM is `torch.OutOfMemoryError`, a CUDA runtime
   error is permanent), bounded deadline-aware retry with full-jitter
   backoff, per-dependency circuit breakers, poison-query quarantine,
   and the RecoveryMeter that attributes retries/faults to ServeEvents.

`fallback.py` is host evaluation for a request that runs out of memory
on a CPU store (a store on the card fails the request with `DeviceOOM`
instead); it is loaded lazily, so this package root stays import-light
and the engine and storage layers can register sites without cycles.
The reference's `chaos.py` (the chaos CLI) comes with the tooling slice
(ROADMAP A8).
"""

from geomesa_tpu_torch.faults.breaker import BREAKERS, BreakerOpen, CircuitBreaker
from geomesa_tpu_torch.faults.context import (
    RECOVERY, current_deadline, deadline_scope)
from geomesa_tpu_torch.faults.errors import (
    DeviceOOM, FaultInjected, PermanentError, TransientError, classify,
    is_typed)
from geomesa_tpu_torch.faults.harness import (
    SITES, FaultHarness, FaultSite, active, current, inject, install,
    site, uninstall)
from geomesa_tpu_torch.faults.plan import FaultPlan, FaultRule
from geomesa_tpu_torch.faults.quarantine import QuarantineRegistry
from geomesa_tpu_torch.faults.retry import RetryPolicy, retry_call

__all__ = [
    "BREAKERS", "BreakerOpen", "CircuitBreaker",
    "RECOVERY", "current_deadline", "deadline_scope",
    "DeviceOOM", "FaultInjected", "PermanentError", "TransientError",
    "classify", "is_typed",
    "SITES", "FaultHarness", "FaultSite", "active", "current", "inject",
    "install", "site", "uninstall",
    "FaultPlan", "FaultRule", "QuarantineRegistry",
    "RetryPolicy", "retry_call",
]
