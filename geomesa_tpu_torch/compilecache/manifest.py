"""Warm-up manifests: record what a serving process built, replay it first.

A copy of the reference package's `compilecache/manifest.py`, with the
version gate and the bounded recorder. The reference records jit
signatures; the port compiles no per-call programs, so its kernel entries
name what it does build ahead of traffic:

- a CUDA library and one of its entry points (`kind_of` "library":
  `library` is the source's name under `engine/kernels/`, `entry` the C
  function), built with nvcc and loaded on replay;
- a ring capture (`kind_of` "ring": `library` is the kernel wrapper the
  graph launches, with the Q bucket, k, the sparse capacity, the ring
  depth and `cls`, the digest of the window class's type, CQL and
  residual CQL), which the replay of its query entry captures again.

Query entries are unchanged: (op, type, CQL, padded Q bucket, k, impl).

Format (JSON, versioned):

    {"version": 1, "entries": [
      {"kind": "kernel", "kind_of": "library", "library": "chord_blockmin",
       "entry": "chord_blockmin_sparse_launch", "q": 0, "k": 0,
       "capacity": 0, "depth": 0, "count": 1, "compile_s": 3.1},
      {"kind": "kernel", "kind_of": "ring",
       "library": "chord_blockmin_sparse", "entry": "", "q": 64, "k": 10,
       "capacity": 1024, "depth": 4, "cls": "3f0c9a51d2e87b64",
       "count": 1, "compile_s": 0.4},
      {"kind": "query", "op": "knn", "type_name": "gdelt",
       "cql": "BBOX(geom, -60, 20, 60, 70)", "q": 64, "k": 10,
       "impl": "sparse", "count": 12}
    ]}
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Union

from geomesa_tpu_torch.faults import harness as _faults_harness

# registered for the fault catalog; save() fires it by name
_faults_harness.site(
    "compilecache.manifest.write", "warmup manifest atomic save")

MANIFEST_VERSION = 1


@dataclasses.dataclass
class KernelEntry:
    kind_of: str       # "library" | "ring"
    library: str       # kernel source (library) or kernel wrapper (ring)
    entry: str = ""    # the library's C entry point
    q: int = 0         # ring: padded Q bucket
    k: int = 0         # ring: neighbours
    capacity: int = 0  # ring: sparse tile capacity (0 = the dense scan)
    depth: int = 0     # ring: slots (one graph each)
    cls: str = ""      # ring: the window class's digest (planner.ring_class)
    count: int = 1
    compile_s: float = 0.0

    @property
    def label(self) -> str:
        if self.kind_of == "ring":
            return f"ring:{self.library}@ring{self.depth}:q{self.q}"
        return f"library:{self.library}.{self.entry}"

    def key(self) -> tuple:
        return ("kernel", self.kind_of, self.library, self.entry, self.q,
                self.k, self.capacity, self.depth, self.cls)

    def to_json(self) -> dict:
        return {"kind": "kernel", **dataclasses.asdict(self)}


@dataclasses.dataclass
class QueryEntry:
    op: str  # count | execute | knn
    type_name: str
    cql: str
    q: int = 0         # padded stacked-query bucket (knn only)
    k: int = 0         # knn only
    impl: str = ""     # knn only
    count: int = 1

    @property
    def label(self) -> str:
        return f"query:{self.op}:{self.type_name}"

    def key(self) -> tuple:
        return ("query", self.op, self.type_name, self.cql,
                self.q, self.k, self.impl)

    def to_json(self) -> dict:
        return {"kind": "query", **dataclasses.asdict(self)}


Entry = Union[KernelEntry, QueryEntry]


class WarmupManifest:
    def __init__(self, entries: Optional[List[Entry]] = None):
        self.entries: List[Entry] = list(entries or ())

    @property
    def kernel_entries(self) -> List[KernelEntry]:
        return [e for e in self.entries if isinstance(e, KernelEntry)]

    @property
    def query_entries(self) -> List[QueryEntry]:
        return [e for e in self.entries if isinstance(e, QueryEntry)]

    def __len__(self) -> int:
        return len(self.entries)

    def to_json(self) -> dict:
        return {"version": MANIFEST_VERSION,
                "entries": [e.to_json() for e in self.entries]}

    def save(self, path: str) -> None:
        """Write atomically (tmp file + rename: never a torn file); a
        transient failure retries (the `compilecache.manifest.write`
        fault site)."""
        from geomesa_tpu_torch.faults import RetryPolicy, retry_call
        from geomesa_tpu_torch.faults import harness as _faults
        from geomesa_tpu_torch.parallel.distributed import is_coordinator

        if not is_coordinator():
            # every process of a mesh arms the same window classes, so
            # the warm-up manifests would match byte for byte: one
            # writer keeps shared directories race-free
            return

        def attempt():
            _faults.inject("compilecache.manifest.write")
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.to_json(), f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)  # atomic: never a torn file

        retry_call(attempt, label="compilecache",
                   policy=RetryPolicy(max_attempts=3, base_ms=5.0,
                                      cap_ms=100.0))

    @classmethod
    def from_json(cls, doc: dict) -> "WarmupManifest":
        version = doc.get("version")
        if version != MANIFEST_VERSION:
            raise ValueError(
                f"unsupported warmup manifest version {version!r} "
                f"(this build reads version {MANIFEST_VERSION})")
        entries: List[Entry] = []
        for raw in doc.get("entries", []):
            kind = raw.get("kind")
            body = {k: v for k, v in raw.items() if k != "kind"}
            if kind == "kernel":
                entries.append(KernelEntry(**body))
            elif kind == "query":
                entries.append(QueryEntry(**body))
            else:
                raise ValueError(f"unknown manifest entry kind {kind!r}")
        return cls(entries)

    @classmethod
    def load(cls, path: str) -> "WarmupManifest":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(json.load(f))


# distinct-entry cap for a live recorder: high-cardinality CQL (per-
# request literals) must bound memory — new keys past the cap count as
# skipped, existing keys still bump their counts
MAX_RECORDED_ENTRIES = 4096


class WarmupRecorder:
    """Accumulates deduplicated manifest entries from live traffic.

    Fed by the compile tracker (library builds, ring captures) and by
    `QueryService._dispatch` (query shapes). Both callers are hot paths,
    so the entry map is bounded (`max_entries`): a recorder left attached
    under unique-filter traffic must not grow without bound."""

    def __init__(self, max_entries: int = MAX_RECORDED_ENTRIES):
        self._lock = threading.Lock()
        self._entries: Dict[tuple, Entry] = {}
        self.max_entries = max_entries
        self.skipped = 0

    def _put(self, entry: Entry) -> None:
        """Dedup-or-insert under the cap (callers hold no lock)."""
        with self._lock:
            have = self._entries.get(entry.key())
            if have is not None:
                have.count += 1
                if isinstance(have, KernelEntry):
                    have.compile_s = max(have.compile_s, entry.compile_s)
            elif len(self._entries) < self.max_entries:
                self._entries[entry.key()] = entry
            else:
                self.skipped += 1

    def record_library(self, library: str, entry: str,
                       seconds: float = 0.0) -> None:
        self._put(KernelEntry("library", library, entry=entry,
                              compile_s=float(seconds)))

    def record_ring(self, kernel: str, q: int, k: int, capacity: int,
                    depth: int, seconds: float = 0.0, cls: str = "") -> None:
        self._put(KernelEntry("ring", kernel, q=int(q), k=int(k),
                              capacity=int(capacity), depth=int(depth),
                              cls=cls, compile_s=float(seconds)))

    def record_query(self, op: str, type_name: str, cql: str,
                     q: int = 0, k: int = 0, impl: str = "") -> None:
        self._put(QueryEntry(op=op, type_name=type_name, cql=cql,
                             q=int(q), k=int(k), impl=impl))

    def manifest(self) -> WarmupManifest:
        with self._lock:
            return WarmupManifest(list(self._entries.values()))
