"""Typed transient/permanent error taxonomy for the recovery fabric.

A copy of the reference package's `faults/errors.py`, but for where an
OOM comes from: here it is torch's `OutOfMemoryError`, where the
reference matches XLA's RESOURCE_EXHAUSTED status.

Every dependency boundary (storage, Kafka, device transfer, kvstore,
compile cache) classifies failures into three kinds:

  transient  — worth retrying: I/O hiccups, connection resets, broker
               unavailability. Bounded retry with backoff applies.
  oom        — device memory exhaustion: NOT retried as-is (the same
               program would fail the same way); the serve layer halves
               the coalesced batch bucket and ultimately falls back to
               host evaluation (cql/hosteval.py) on a CPU store; on
               the card the request fails with DeviceOOM.
  permanent  — bad input, schema drift, crashes: surfaced immediately,
               never retried, and counted toward poison-query quarantine.

The reference's injected-fault classes (`FaultInjected` and the
`Injected*` family) and `is_typed`, the chaos checker's test, come with
the injection harness and the chaos runner (ROADMAP A5 and A8).
"""

from __future__ import annotations

import torch


class TransientError(RuntimeError):
    """Explicitly-retryable dependency failure (base for wrappers)."""


class PermanentError(RuntimeError):
    """Explicitly non-retryable failure (bad input, unsupported path)."""


class DeviceOOM(MemoryError):
    """Device memory exhaustion (host->device transfer or kernel alloc).

    Real CUDA OOMs surface as `torch.OutOfMemoryError` (which
    `torch.cuda.OutOfMemoryError` names); `classify` maps those to "oom"
    too. Nothing else is an OOM: a CUDA launch error or a kernel that
    failed to build is permanent."""


def classify(exc: BaseException) -> str:
    """Map an exception to "transient" | "oom" | "permanent".

    Deadline expiry (plan.QueryTimeout subclasses TimeoutError and
    carries .phase) is permanent by definition — retrying past a blown
    deadline is the exact bug the fabric exists to prevent."""
    if isinstance(exc, (DeviceOOM, torch.OutOfMemoryError)):
        return "oom"
    if isinstance(exc, PermanentError):
        return "permanent"
    if isinstance(exc, TimeoutError) and hasattr(exc, "phase"):
        return "permanent"  # QueryTimeout: the budget is gone
    if isinstance(exc, TransientError):
        return "transient"
    if isinstance(exc, (FileNotFoundError, PermissionError,
                        IsADirectoryError, NotADirectoryError)):
        # definitive filesystem answers, not flakiness: a missing file
        # (e.g. a compaction-raced read against an older manifest
        # snapshot) will be just as missing on attempt 4 — retrying
        # burns the backoff budget AND counts toward opening the
        # storage breaker on a perfectly healthy disk
        return "permanent"
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return "transient"
    if isinstance(exc, OSError):
        return "transient"
    return "permanent"
