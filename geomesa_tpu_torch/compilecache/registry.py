"""The ring tier: captured CUDA graphs per window class.

The counterpart of the reference package's `ExecutableRegistry` ring and
serve tiers (`compilecache/registry.py` `serve_variant`, `ring_variant`).
The reference AOT-compiles one executable per window class; the port's
kernels are built once per process (`engine/kernels/build.py` keeps the
nvcc output in `.torch_kernels/`, keyed by a digest of the source and the
flags: the reference's `persist.py`), and what remains to make ahead of
time is the launch itself. A ring window class (plan, frozen mask, tile
list, capacity, Q bucket, k) is captured once as one CUDA graph per ring
slot, keyed `<kernel>@ring{depth}`; a window then costs one slot write,
one graph replay and one readback. The reference's `kernels.py` (the
sweep of engine jits) maps to `build.sources()`. No other cache exists.

`RingCapture` holds the slots (`engine.device.SlotRing`: the device query
pair each graph reads, pinned host pairs, copy events), the graphs, each
graph's static outputs, and the frozen inputs they read. A replay writes
into the same output tensors as the replay before it, so each slot has
its own graph and outputs, and a slot comes round only after `depth`
windows (the slot ring). On a CPU store a capture freezes the same body
and calls it per window, without a graph.

A capture is keyed by everything that shapes what its graphs read: the
owner (a planner), its superbatch and manifest version, the window
class (`cls`: a digest of the type, the CQL and the residual CQL, which
loose bbox makes differ), the impl, the Q bucket, k, the capacity and the
top-m width. The frozen inputs (mask, padded columns, tile lists) are
one dict per (owner, superbatch, version, class), shared by the class's
captures across Q buckets, k and impl (`frozen_for`). An owner's
captures go when the last ring loop using it closes (`retain` /
`release`), when the owner is collected, or by the LRU bound;
`stats()["held_bytes"]` counts the device bytes they keep alive (frozen
inputs, slots, outputs; not the graphs' private pools).

Launch counts: the kernels' wrappers count a launch where they launch,
which under capture is once per graph. So a capture takes the launches of
its warm-up run and of its captures back off the wrappers (they are arm
launches, `stats()["arm_launches"]`), and `replay` adds the graph's
launches per replay.

A mesh window class (`mesh_parts`: the mesh, one body a shard, the merge)
captures its shards and the merge together where the mesh repeats one
card: one graph a slot holds every shard's launches and the merge. A
CUDA graph belongs to one device, so where the mesh spans cards
(`Mesh.spans_devices`) the capture splits: per slot one graph
a card for that card's shards, reading the card's own static copy of
the slot's queries and writing static per-shard outputs, and one graph
on the lead card for the merge over static lead-side copies of those
outputs. A replay then orders the cards by events: each card waits for
the slot write, takes the queries, replays its graph; the lead waits
for every card, copies the outputs across and replays the merge. The
copies between cards stay outside the graphs. On one card the split
design runs with no copy; between cards it is untried.

Where the mesh spans processes (`Mesh.spans_processes`) each process
captures its own shards only (`mesh_parts` holds one body a local
shard), split as above, and the merge is a collective over the process
group, which no graph can hold: it runs after the replay, outside the
graphs, on the static per-shard outputs (each rank's windows must then
be the same windows, in the same order: `serve.ringloop`).

A capture under an active `torch.profiler` is refused with
GraphCaptureError (capturing while the profiler traces the card crashes
the process): warm the window classes up before profiling.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, Optional, Sequence

import torch

from geomesa_tpu_torch.compilecache.tracker import note_capture
from geomesa_tpu_torch.engine.device import SlotRing
from geomesa_tpu_torch.errors import GraphCaptureError


def profiler_active() -> bool:
    """True while a torch.profiler (or autograd profiler) session runs in
    any thread of the process (the binding's flag is the calling
    thread's; the profiler module's flag is the process's)."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
                or torch._C._autograd._profiler_enabled())


def _tensors(obj):
    """The tensors in a (nested) dict/tuple/list of frozen inputs."""
    from geomesa_tpu_torch.parallel.mesh import Sharded

    if isinstance(obj, Sharded):
        yield from obj.local_shards
    elif isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


class RingCapture:
    """One captured ring window class (module docstring)."""

    def __init__(self, name: str, slots: SlotRing, body: Optional[Callable],
                 frozen: dict, wrappers: Sequence, q: int, k: int,
                 capacity: int, owner_id: int = 0, cls: str = "",
                 mesh_parts=None):
        self.name = name
        self.slots = slots
        self.mesh_parts = mesh_parts
        self.split = None  # the split mesh capture's per-slot state
        if mesh_parts is not None:
            body = _mesh_body(*mesh_parts)
        self.body = body
        self.frozen = frozen  # what the graphs read; kept alive here
        self.wrappers = tuple(wrappers)
        self.q, self.k, self.capacity = q, k, capacity
        self.owner_id, self.cls = owner_id, cls
        self.graphs: list = []
        self.outputs: list = []
        self.per_replay: Dict[str, int] = {}
        self.arm_launches: Dict[str, int] = {}
        self.seconds = 0.0

    @property
    def lock(self):
        """Held across slot write, replay and readback by every feeder."""
        return self.slots.lock

    def capture(self, device: torch.device) -> None:
        """On a card: warm the body up on a side stream, then capture one
        graph per slot over its static query pair. Raises
        GraphCaptureError on any failure but an OOM (which stays an OOM,
        for the serve ladder), and before capturing under an active
        profiler."""
        if device.type != "cuda":
            return
        if profiler_active():
            raise GraphCaptureError(
                f"capturing {self.name} (q={self.q}) under an active "
                "torch.profiler is refused: warm the window class up first")
        before = {w.__name__: w.launches for w in self.wrappers}
        try:
            self.slots.allocate(self.q, device)
            side = torch.cuda.Stream(device=device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                s0 = self.slots.slots[0]
                self.body(s0.qx, s0.qy)
            torch.cuda.current_stream(device).wait_stream(side)
            if self._split_wanted():
                self._capture_split(device)
                return
            pool = torch.cuda.graph_pool_handle()
            for slot in self.slots.slots:
                pre = {w.__name__: w.launches for w in self.wrappers}
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=pool,
                                      capture_error_mode="thread_local"):
                    out = self.body(slot.qx, slot.qy)
                self.graphs.append(g)
                self.outputs.append(out)
                self.per_replay = {w.__name__: w.launches - pre[w.__name__]
                                   for w in self.wrappers}
        except torch.OutOfMemoryError:
            raise
        except Exception as e:  # noqa: BLE001 — typed, never a fallback
            raise GraphCaptureError(
                f"capturing {self.name} (q={self.q}) failed: "
                f"{type(e).__name__}: {e}") from e
        finally:
            for w in self.wrappers:
                n = w.launches - before[w.__name__]
                if n:
                    self.arm_launches[w.__name__] = n
                    w.launches -= n

    def _split_wanted(self) -> bool:
        return (self.mesh_parts is not None
                and (self.mesh_parts[0].spans_devices
                     or self.mesh_parts[0].spans_processes))

    def _capture_split(self, device: torch.device) -> None:
        """The split mesh capture (module docstring): per slot, one graph
        a card over that card's shards, then the lead's merge graph (none
        on a mesh that spans processes: the collective merge runs at
        replay)."""
        from geomesa_tpu_torch.parallel.mesh import on_shard

        mesh, shard_fns, merge = self.mesh_parts
        devs = [mesh.devices[i] for i in mesh.local]  # one a shard_fn
        cards = list(dict.fromkeys(devs))
        self.split = []
        for slot in self.slots.slots:
            pre = {w.__name__: w.launches for w in self.wrappers}
            per_card = []
            outs: list = [None] * len(devs)
            for card in cards:
                with on_shard(card):
                    if card == device:
                        q = (slot.qx, slot.qy)
                    else:
                        q = (torch.empty_like(slot.qx, device=card),
                             torch.empty_like(slot.qy, device=card))
                    mine = [i for i, d in enumerate(devs) if d == card]
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g, capture_error_mode="thread_local"):
                        got = [shard_fns[i](*q) for i in mine]
                    for i, o in zip(mine, got):
                        outs[i] = o
                    per_card.append((card, q, g))
            # the merge reads lead-side copies of the other cards' outputs
            lead_in = [o if devs[i] == device else
                       tuple(torch.empty_like(t, device=device) for t in o)
                       for i, o in enumerate(outs)]
            if mesh.spans_processes:
                self.graphs.append(None)
                self.outputs.append(None)
            else:
                with on_shard(device):
                    mg = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(mg, capture_error_mode="thread_local"):
                        out = merge(lead_in)
                self.graphs.append(mg)
                self.outputs.append(out)
            self.split.append((per_card, outs, lead_in))
            self.per_replay = {w.__name__: w.launches - pre[w.__name__]
                               for w in self.wrappers}

    def _replay_split(self, slot, device: torch.device) -> None:
        per_card, outs, lead_in = self.split[slot.index]
        lead_stream = torch.cuda.current_stream(device)
        written = torch.cuda.Event()
        written.record(lead_stream)
        done = []
        for card, q, g in per_card:
            with torch.cuda.device(card):
                stream = torch.cuda.current_stream(card)
                stream.wait_event(written)
                if card != device:
                    q[0].copy_(slot.qx, non_blocking=True)
                    q[1].copy_(slot.qy, non_blocking=True)
                g.replay()
                ev = torch.cuda.Event()
                ev.record(stream)
                done.append(ev)
        for ev in done:
            lead_stream.wait_event(ev)
        for dst, src in zip(lead_in, outs):
            if dst is not src:
                for a, b in zip(dst, src):
                    a.copy_(b, non_blocking=True)

    def replay(self, slot):
        """The window's outputs: the slot's graph replayed (its launches
        added to the wrappers' counts), or on the CPU the body called."""
        if not self.graphs:
            return self.body(slot.qx, slot.qy)
        if self.slots.slots[slot.index] is not slot:
            raise GraphCaptureError(f"{self.name}: slot {slot.index} is not "
                                    "one this capture was made over")
        if self.split is not None:
            self._replay_split(slot, slot.qx.device)
        for w in self.wrappers:
            w.launches += self.per_replay.get(w.__name__, 0)
        if self.graphs[slot.index] is None:
            # a mesh that spans processes: the collective merge, after the
            # shards' graphs, over their static outputs
            return self.mesh_parts[2](self.split[slot.index][2])
        self.graphs[slot.index].replay()
        return self.outputs[slot.index]


def _mesh_body(mesh, shard_fns, merge):
    """The whole mesh window as one body: every local shard's body under
    its device over its copy of the queries, then the merge."""
    from geomesa_tpu_torch.parallel.mesh import on_shard

    def body(qx, qy):
        outs = []
        for fn, d in zip(shard_fns, [mesh.devices[i] for i in mesh.local]):
            with on_shard(d):
                outs.append(fn(qx.to(d), qy.to(d)))
        return merge(outs)

    return body


class CaptureRegistry:
    """Captured ring window classes, LRU-bounded (MAX_CAPTURES), with
    capture counts and seconds in `stats()`."""

    RING_PREFIX = "@ring"
    MAX_CAPTURES = 32

    def __init__(self):
        self._lock = threading.RLock()
        self._captures: Dict[object, RingCapture] = {}
        self._made = 0
        self._graphs = 0
        self._seconds = 0.0
        self._hits = 0
        self._arm_launches: Dict[str, int] = {}
        self._users: Dict[int, int] = {}   # owner id -> open ring loops
        self._watched: set = set()         # owner ids with a finalizer

    def ring_variant(self, kernel: str, depth: int) -> str:
        """The ring tier's name of a kernel: `<kernel>@ring{depth}`."""
        return f"{kernel}{self.RING_PREFIX}{int(depth)}"

    def ring_capture(self, kernel: str, key, depth: int,
                     body: Optional[Callable], frozen: dict,
                     wrappers: Sequence, device: torch.device,
                     q: int, k: int, capacity: int, owner, cls: str,
                     stale: Optional[Callable[[RingCapture], bool]] = None,
                     mesh_parts=None) -> RingCapture:
        """The capture of (`owner`, `cls`, `key`) (made now if absent).
        `stale` drops the captures it accepts first (a residency change
        leaves a planner's older captures unreachable). `mesh_parts`
        (mesh, one body a shard, merge) makes a mesh capture in place of
        `body` (module docstring)."""
        name = self.ring_variant(kernel, depth)
        full = (name, id(owner), cls) + tuple(key)
        with self._lock:
            got = self._captures.pop(full, None)
            if got is not None:
                self._captures[full] = got  # LRU touch
                self._hits += 1
                return got
            if stale is not None:
                for kk in [kk for kk, c in self._captures.items() if stale(c)]:
                    del self._captures[kk]
            self._watch(owner)
            cap = RingCapture(name, SlotRing(depth), body, frozen, wrappers,
                              q, k, capacity, owner_id=id(owner), cls=cls,
                              mesh_parts=mesh_parts)
            t0 = time.perf_counter()
            cap.capture(device)
            cap.seconds = time.perf_counter() - t0
            self._captures[full] = cap
            while len(self._captures) > self.MAX_CAPTURES:
                self._captures.pop(next(iter(self._captures)))
            self._made += 1
            self._graphs += (sum(g is not None for g in cap.graphs)
                             or sum(len(s[0]) for s in cap.split or ()))
            self._seconds += cap.seconds
            for n, v in cap.arm_launches.items():
                self._arm_launches[n] = self._arm_launches.get(n, 0) + v
        note_capture(kernel, q, k, capacity, depth, cap.seconds, cls)
        return cap

    def frozen_for(self, owner, cls: str, sb, mversion: int
                   ) -> Optional[dict]:
        """The frozen inputs a held capture of `owner`'s class `cls` reads
        over superbatch `sb` at `mversion`, to share with a new capture of
        the same class (another Q bucket, k or impl)."""
        with self._lock:
            for c in self._captures.values():
                f = c.frozen
                if (c.owner_id == id(owner) and c.cls == cls
                        and f.get("sb") is sb
                        and f.get("mversion") == mversion):
                    return f
        return None

    def find(self, kernel: str, cls: str, q: int, k: int, capacity: int,
             depth: int, owners: Sequence) -> Optional[RingCapture]:
        """A held capture of this (kernel, class, Q, k, capacity, depth)
        made by one of `owners` (planners)."""
        name = self.ring_variant(kernel, depth)
        ids = {id(o) for o in owners}
        with self._lock:
            for c in self._captures.values():
                if ((c.name, c.cls, c.q, c.k, c.capacity)
                        == (name, cls, q, k, capacity)
                        and c.owner_id in ids):
                    return c
        return None

    # -- owners ------------------------------------------------------------

    def _watch(self, owner) -> None:
        """Drop `owner`'s captures when it is collected (caller holds the
        lock)."""
        oid = id(owner)
        if oid in self._watched:
            return
        try:
            weakref.finalize(owner, self._drop_owner, oid)
        except TypeError:  # not weakly referenceable: the LRU bounds it
            return
        self._watched.add(oid)

    def _drop_owner(self, oid: int) -> None:
        """`owner` was collected: forget it and drop its captures."""
        with self._lock:
            self._watched.discard(oid)
            self._users.pop(oid, None)
        self._drop_owner_captures(oid)

    def retain(self, owner) -> None:
        """A ring loop serves from `owner`'s captures."""
        with self._lock:
            self._users[id(owner)] = self._users.get(id(owner), 0) + 1

    def release(self, owner) -> None:
        """A ring loop closed: the last one drops `owner`'s captures."""
        with self._lock:
            left = self._users.get(id(owner), 0) - 1
            if left > 0:
                self._users[id(owner)] = left
                return
            self._users.pop(id(owner), None)
        self._drop_owner_captures(id(owner))

    def drop_owner(self, owner) -> None:
        """Drop every capture made over `owner` now (its store is gone),
        whatever ring loops still hold it."""
        self._drop_owner_captures(id(owner))

    def _drop_owner_captures(self, oid: int) -> None:
        with self._lock:
            for kk in [kk for kk, c in self._captures.items()
                       if c.owner_id == oid]:
                del self._captures[kk]

    def held(self) -> list:
        """The captures held now."""
        with self._lock:
            return list(self._captures.values())

    def clear(self) -> None:
        with self._lock:
            self._captures.clear()

    def held_bytes(self) -> int:
        """Bytes the held captures keep alive: their frozen inputs,
        slots and outputs, each storage counted once (a superbatch column
        a capture reads is counted too: the capture pins it)."""
        seen, total = set(), 0
        with self._lock:
            caps = list(self._captures.values())
        for c in caps:
            slots = [(s.qx, s.qy) for s in c.slots.slots]
            for t in _tensors((c.frozen, c.outputs, slots)):
                st = t.untyped_storage()
                if st.data_ptr() not in seen:
                    seen.add(st.data_ptr())
                    total += st.nbytes()
        return total

    def stats(self) -> dict:
        held = self.held_bytes()
        with self._lock:
            return {
                "entries": len(self._captures),
                "held_bytes": held,
                "captures": self._made,
                "graphs": self._graphs,
                "capture_s": self._seconds,
                "hits": self._hits,
                "arm_launches": dict(sorted(self._arm_launches.items())),
            }


# process-wide: the planner's ring_arm and the warm-up replay share it, so
# a replayed window class is a hit for the service that serves it
registry = CaptureRegistry()
