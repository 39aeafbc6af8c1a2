"""Counting extension builds and graph captures.

The counterpart of the `JitTracker` that the reference package's
`QueryService(track_compiles=True)` installs (`analysis/runtime.py`). The
port compiles nothing per call: what a serving process pays inline is a
first-use `nvcc` build of a kernel library (`engine/kernels/build.py`)
and a CUDA graph capture of a ring window class
(`compilecache/registry.py`). Both report here:

- `note_build(library, seconds, entries)` and
  `note_capture(kernel, q, k, capacity, depth, seconds, cls)` note the stall
  into `STALLS` (so the serve window that paid it carries it in its
  ServeEvent's `compile_ms` / `compiled`) and count it in every attached
  `CompileTracker`, whose recorder (a `WarmupRecorder`) writes the
  manifest's kernel entries;
- `acquire_tracker()` / `release_tracker()` share one tracker between the
  services of a process, refcounted like the reference's
  `acquire_engine_tracker`.

The rest of the reference's `analysis/` waits for ROADMAP A8.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from geomesa_tpu_torch.compilecache.stall import STALLS


class CompileTracker:
    """Counts of the builds and captures noted while attached, and the
    recorder they feed (None = counting only)."""

    def __init__(self, recorder=None):
        self._lock = threading.Lock()
        self.recorder = recorder
        self.builds = 0
        self.captures = 0
        self._installed = False

    def _count(self, attr: str) -> None:
        with self._lock:
            setattr(self, attr, getattr(self, attr) + 1)

    def total_recompiles(self) -> int:
        """Builds plus captures since the tracker was made."""
        with self._lock:
            return self.builds + self.captures

    def is_installed(self) -> bool:
        return self._installed


_lock = threading.Lock()
_active: Optional[CompileTracker] = None
_refs = 0


def acquire_tracker(recorder=None) -> CompileTracker:
    """The process's shared tracker (made on the first acquire); pair
    every acquire with `release_tracker`. A recorder given here replaces
    the tracker's."""
    global _active, _refs
    with _lock:
        if _active is None:
            _active = CompileTracker()
            _active._installed = True
        if recorder is not None:
            _active.recorder = recorder
        _refs += 1
        return _active


def release_tracker(tracker: CompileTracker) -> None:
    """Drop one reference; the last one detaches the tracker (its counts
    stay readable)."""
    global _active, _refs
    with _lock:
        if tracker is not _active:
            return
        _refs -= 1
        if _refs <= 0:
            _active._installed = False
            _active = None
            _refs = 0


def _attached() -> Optional[CompileTracker]:
    with _lock:
        return _active


def note_build(library: str, seconds: float, entries: List[str]) -> None:
    """A kernel library was compiled with nvcc on first use."""
    STALLS.note(f"build:{library}", seconds)
    t = _attached()
    if t is not None:
        t._count("builds")
        if t.recorder is not None:
            for entry in entries:
                t.recorder.record_library(library, entry, seconds)


def note_capture(kernel: str, q: int, k: int, capacity: int, depth: int,
                 seconds: float, cls: str = "") -> None:
    """A ring window class (`cls`, the digest the planner keys it by) was
    captured (one graph per slot on a card)."""
    label = f"ring:{kernel}@ring{depth}:q{q}"
    STALLS.note(label, seconds)
    t = _attached()
    if t is not None:
        t._count("captures")
        if t.recorder is not None:
            t.recorder.record_ring(kernel, q, k, capacity, depth, seconds,
                                   cls=cls)
