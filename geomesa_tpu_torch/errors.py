"""Typed errors of the port.

`NotPortedError` marks a reference feature that a later slice of the port
brings: it names that slice, so a caller knows the refusal is deliberate
and where the feature will land. `CudaUnavailableError` is raised when an
entry point is asked for the card (the default) and no GPU is present:
the port never falls back to the CPU on its own.

`KernelBuildError`, `KernelLaunchError` and `GraphCaptureError` are what
a card store raises when a kernel library fails to build, a launch is
refused, or a ring window class fails to capture: the serve stack fails
the window with them and never answers it from another route.

`RemoteShardError` is what a mesh that spans processes raises where a
caller would need rows that live in another process.

`ProfileRefused` is what `utils.profiling.device_trace` raises instead of
opening a torch.profiler trace while a ring program of the process holds
captured CUDA graphs (a replay under the profiler crashed on the card).
"""

from __future__ import annotations


class NotPortedError(NotImplementedError):
    """A reference feature outside this slice of the port."""

    def __init__(self, what: str, later_slice: str):
        super().__init__(f"{what} is not ported yet (comes with: {later_slice})")
        self.what = what
        self.later_slice = later_slice


class CudaUnavailableError(RuntimeError):
    """The card was asked for (device=None or 'cuda') and CUDA is absent."""


class KernelBuildError(RuntimeError):
    """nvcc could not build a kernel library."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


class GraphCaptureError(RuntimeError):
    """A ring window class could not be captured as CUDA graphs."""


class RemoteShardError(RuntimeError):
    """A whole sharded column (or a result built from one) was asked for
    on a mesh that spans processes: the other processes' shards are not
    in this one, and the port does not assemble them behind the caller's
    back. Counts, densities, kNN and the served ring merge through
    collectives instead; feature, Arrow and BIN queries refuse."""


class ProfileRefused(RuntimeError):
    """A `geomesa.profile.dir` trace was asked for while the serve ring
    holds captured CUDA graphs: torch.profiler traces the whole process,
    and a graph replay under it crashed on the card. Close the ring
    service (or serve with ring=False) to profile."""
