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

A CUDA runtime error (`torch.AcceleratorError`, or the RuntimeError a
failed launch raises) is permanent: a sticky CUDA error poisons the
context, so a retry on the same card cannot succeed.

The `FaultInjected` mixin marks exceptions raised by the injection
harness so a chaos check can tell "an injected fault escaped typed" (a
bug) from organic failures. Injected classes subclass the REAL exception
families (OSError, ConnectionError, ...) so recovery code never
special-cases injection: the fault path exercised under test is the path
a real failure takes.
"""

from __future__ import annotations

import torch


class FaultInjected:
    """Marker mixin: this exception was raised by the fault harness."""


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


class InjectedIOError(OSError, FaultInjected):
    """Injected storage/file I/O failure (transient)."""


class InjectedUnavailable(ConnectionError, FaultInjected):
    """Injected dependency-unavailable failure (transient)."""


class InjectedOOM(DeviceOOM, FaultInjected):
    """Injected device out-of-memory (oom)."""


class InjectedCrash(RuntimeError, FaultInjected):
    """Injected hard crash (permanent; feeds poison-query quarantine)."""


# FaultPlan `error` keys -> exception classes ("latency" injects delay
# only and maps to None)
ERROR_KINDS = {
    "io": InjectedIOError,
    "unavailable": InjectedUnavailable,
    "oom": InjectedOOM,
    "crash": InjectedCrash,
    "latency": None,
}

TYPED_ERRORS = (TransientError, PermanentError, DeviceOOM, OSError,
                ConnectionError)

# a CUDA runtime error: sticky, so never worth a retry on the same card
_CUDA_ERRORS = tuple(c for c in (getattr(torch, "AcceleratorError", None),)
                     if c is not None)


def classify(exc: BaseException) -> str:
    """Map an exception to "transient" | "oom" | "permanent".

    Deadline expiry (plan.QueryTimeout subclasses TimeoutError and
    carries .phase) is permanent by definition — retrying past a blown
    deadline is the exact bug the fabric exists to prevent."""
    if isinstance(exc, (DeviceOOM, torch.OutOfMemoryError)):
        return "oom"
    if isinstance(exc, PermanentError) or isinstance(exc, _CUDA_ERRORS):
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


def is_typed(exc: BaseException) -> bool:
    """True when the exception is part of the serving error contract:
    a client can act on it (retry, back off, fix the query). Used by a
    chaos check to detect un-typed escapes."""
    if isinstance(exc, TYPED_ERRORS) or isinstance(exc, FaultInjected):
        return True
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    # serve-layer typed signals, duck-typed to avoid import cycles
    if hasattr(exc, "reason"):  # QueryRejected / BreakerOpen
        return True
    if isinstance(exc, TimeoutError) and hasattr(exc, "phase"):
        return True  # QueryTimeout
    return False
