"""Compilation management for the port: warm-up, captures, stalls.

The counterpart of the reference package's `compilecache/`. The port
compiles no program per call; what a serving process pays inline is a
first-use build of a kernel library (nvcc, `engine/kernels/build.py`,
which keeps the output in `.torch_kernels/` keyed by a digest of source
and flags: the reference's `persist.py`) and the capture of a ring
window class as CUDA graphs. This package makes both managed and
observable:

- `registry` (registry.py): the ring tier, captured graphs keyed
  `<kernel>@ring{depth}`, with capture counts and seconds;
- warm-up manifests (manifest.py / warmup.py): the tracker records the
  libraries and ring captures a workload needs and the service records
  its query shapes; `QueryService.warmup()` replays them before traffic
  and `check()` proves a second pass builds and captures nothing;
- `STALLS` (stall.py) and the tracker (tracker.py): per-dispatch stall
  attribution feeding `ServeEvent.compile_ms`.
"""

from geomesa_tpu_torch.compilecache.manifest import (
    KernelEntry, QueryEntry, WarmupManifest, WarmupRecorder)
from geomesa_tpu_torch.compilecache.registry import (
    CaptureRegistry, RingCapture, registry)
from geomesa_tpu_torch.compilecache.stall import STALLS, StallMeter
from geomesa_tpu_torch.compilecache.tracker import (
    CompileTracker, acquire_tracker, release_tracker)
from geomesa_tpu_torch.compilecache.warmup import WarmupReport, check, replay

__all__ = [
    "KernelEntry", "QueryEntry", "WarmupManifest", "WarmupRecorder",
    "CaptureRegistry", "RingCapture", "registry", "STALLS", "StallMeter",
    "CompileTracker", "acquire_tracker", "release_tracker",
    "WarmupReport", "check", "replay",
]
