"""Deep-dive device profiling hooks: a torch.profiler trace per query.

The counterpart of the reference package's `utils/profiling.py`, which
wraps `jax.profiler.trace`. With the `geomesa.profile.dir` system property
(or `GEOMESA_TPU_PROFILE_DIR`) set, every planner `execute` writes a
Chrome/Perfetto trace to `<dir>/<label>-<seq><suffix>/trace.json`
(`suffix` is `parallel.distributed.process_suffix()`): CPU activity
always, and CUDA activity (each kernel by name, the copies) when the
store's device is a card. Unset, `device_trace` does nothing and creates
nothing. A failure to write raises.

torch.profiler traces the whole process, and a CUDA graph replay under it
crashed on the card. So `device_trace` refuses, typed (`ProfileRefused`),
while any ring program of the process holds captured graphs
(`compilecache.registry`), and the registry refuses a capture while a
trace is open (`GraphCaptureError`): no graph is replayed under a trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
from typing import Optional

import torch

from geomesa_tpu_torch.errors import ProfileRefused


def profile_dir() -> Optional[str]:
    """The configured trace directory, or None when profiling is off."""
    from geomesa_tpu_torch.utils.config import SystemProperties

    v = SystemProperties.PROFILE_DIR.get()
    return v or None


@contextlib.contextmanager
def device_trace(label: str = "query", device=None):
    """Run the block under a torch.profiler trace when `geomesa.profile.dir`
    is set, recording CUDA activity too when `device` is a card; the trace
    is exported on exit. A no-op when unset. Traces of several threads
    run one at a time (torch.profiler runs one session a process)."""
    d = profile_dir()
    if not d:
        yield
        return
    from geomesa_tpu_torch.compilecache.registry import registry

    held = len(registry.held())
    if held:
        raise ProfileRefused(
            f"geomesa.profile.dir is set while the serve ring holds {held} "
            "captured window class(es): a CUDA graph replay under "
            "torch.profiler crashed on the card; close the ring service "
            "(or serve with ring=False) to profile")
    from torch.profiler import ProfilerActivity, profile

    from geomesa_tpu_torch.parallel.distributed import process_suffix

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(d, f"{label}-{next(_COUNTER)}{process_suffix()}")
    os.makedirs(path, exist_ok=True)
    with _LOCK:
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(path, "trace.json"))


_COUNTER = itertools.count()
_LOCK = threading.RLock()
