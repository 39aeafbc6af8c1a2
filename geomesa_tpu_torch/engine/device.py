"""Device-resident feature batches as dicts of torch tensors.

The counterpart of the reference package's `engine/device.py`: the host
FeatureBatch maps onto a flat dict of tensors on one `torch.device`, with
the reference's key names and dtypes (the reference runs JAX with x64 on,
so its Double columns live on the device as f64):

  <attr>            Double f64, Float f32, Integer i32, Long i64, Boolean
                    bool, dictionary codes i32, Date/Timestamp i64 millis
  <attr>__x/__y     point coordinates (an extended geometry's first
                    vertex), `coord_dtype` (default f32)
  <attr>__bbox      extended geometries: [N, 4] bbox, `coord_dtype`;
  <attr>__verts     [V, 2] vertices, `coord_dtype`;
  <attr>__rings     [R+1] ring offsets i32; <attr>__featr [N+1] i32;
  <attr>__vfeat     the edge table (`GeometryColumn.edge_table`): i32
  <attr>__ex1..ey2  vertex owners, edge ends in `coord_dtype` and
  <attr>__efeat     i32 edge owners
  __valid__         bool validity mask (padding-aware)

The serve pipeline's transfers live here too: `Readback` (device-to-host
copies completed by one CUDA event, which `fetch` and `KnnLaunch` wait
on instead of the whole stream), `QueryStager` (rotating staging
slots: pinned host buffers, non_blocking copies on one copy stream, an
event the compute stream waits on), `upload` (a pinned, non_blocking
host-to-device copy) and `side_stream` (work whose host reads must not
wait for the kernels already queued on the caller's stream).

Host-to-device transfers (`to_device`, `QueryStager.stage`) run under the
recovery fabric, as the reference's do: the `device.transfer` fault site
fires on the host before any copy, and a transient failure retries with
a tiny backoff against the "device" circuit breaker. An OOM
(`torch.OutOfMemoryError`) and a CUDA runtime error are never retried
and never charged to the breaker; a transfer to the card never falls
back to the host.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.errors import CudaUnavailableError
from geomesa_tpu_torch.faults import BREAKERS, RetryPolicy, retry_call
from geomesa_tpu_torch.faults import harness as _faults
from geomesa_tpu_torch.telemetry.trace import TRACER

DeviceBatch = Dict[str, torch.Tensor]

VALID = "__valid__"

# the backoff is deliberately TINY (worst case ~37 ms of sleep in all):
# the residency swaps call to_device under the device cache's lock, and
# the retry fabric must not add meaningful lock-held sleep on top of the
# upload itself
_TRANSFER_SITE = _faults.site(
    "device.transfer", "host->device batch transfer (engine.device)")
_DEVICE_RETRY = RetryPolicy(max_attempts=3, base_ms=2.0, cap_ms=25.0)


def _device_retry(fn, *args):
    return retry_call(fn, *args, policy=_DEVICE_RETRY, label="device",
                      breaker=BREAKERS.get("device"))


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """`None` means the card: entry points run on CUDA unless the caller
    names another device. No GPU raises typed instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            "no CUDA device is available; pass device='cpu' explicitly "
            "to run the port on the CPU")
    return dev


def to_device(batch: FeatureBatch, device: torch.device,
              coord_dtype: torch.dtype = torch.float32) -> DeviceBatch:
    """Transfer a FeatureBatch to tensors on `device` (module docstring).
    Coordinates are cast to `coord_dtype` on the host before the copy, as
    the reference does, so both packages see the same values (f32 by
    default; the process paths pass torch.float64). Transient transfer
    failures retry against the "device" breaker; an OOM propagates."""
    with TRACER.span("device.transfer", rows=len(batch)):
        return _device_retry(_to_device_impl, batch, device, coord_dtype)


def to_device_parts(parts, devices, coord_dtype: torch.dtype = torch.float32
                    ) -> List[DeviceBatch]:
    """`parts[i]` (host batches) onto `devices[i]`, through pinned memory
    and non_blocking: ONE transfer (one retry scope and one firing of the
    transfer fault site, as `to_device`), the parts' copies queued on
    their devices without a wait between them."""
    with TRACER.span("device.transfer", rows=sum(len(b) for b in parts)):
        return _device_retry(_to_device_parts_impl, parts, devices,
                             coord_dtype)


def _to_device_parts_impl(parts, devices, coord_dtype) -> List[DeviceBatch]:
    _TRANSFER_SITE.fire()
    return [_transfer(b, d, coord_dtype, True) for b, d in zip(parts, devices)]


def _to_device_impl(batch: FeatureBatch, device: torch.device,
                    coord_dtype: torch.dtype) -> DeviceBatch:
    _TRANSFER_SITE.fire()
    return _transfer(batch, device, coord_dtype, False)


def _transfer(batch: FeatureBatch, device: torch.device,
              coord_dtype: torch.dtype, pinned: bool) -> DeviceBatch:
    """The copies of `to_device`; `pinned` goes through pinned memory,
    non_blocking (`upload`), each tensor its own allocation."""
    out: DeviceBatch = {}
    np_coord = torch.empty(0, dtype=coord_dtype).numpy().dtype

    def put(a: np.ndarray) -> torch.Tensor:
        if pinned:
            # its own allocation on the CPU too (never a view of the host
            # batch), as on a card
            return (upload(a, device) if device.type == "cuda"
                    else torch.from_numpy(np.array(a)))
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for attr in batch.sft.attributes:
        col = batch.columns[attr.name]
        if isinstance(col, GeometryColumn):
            out[f"{attr.name}__x"] = put(col.x.astype(np_coord))
            out[f"{attr.name}__y"] = put(col.y.astype(np_coord))
            if not col.is_point:
                n = attr.name
                out[f"{n}__bbox"] = put(col.bbox.astype(np_coord))
                out[f"{n}__verts"] = put(col.vertices.astype(np_coord))
                out[f"{n}__rings"] = put(col.ring_offsets.astype(np.int32))
                out[f"{n}__featr"] = put(col.feature_rings.astype(np.int32))
                et = col.edge_table()
                out[f"{n}__vfeat"] = put(et.vfeat.astype(np.int32))
                for key, a in (("ex1", et.x1), ("ey1", et.y1),
                               ("ex2", et.x2), ("ey2", et.y2)):
                    out[f"{n}__{key}"] = put(a.astype(np_coord))
                out[f"{n}__efeat"] = put(et.efeat.astype(np.int32))
        elif isinstance(col, DictColumn):
            out[attr.name] = put(np.asarray(col.codes, np.int32))
        elif col.dtype == object:
            continue  # Bytes columns stay host-side
        elif attr.is_temporal:
            out[attr.name] = put(np.asarray(col, np.int64))
        else:
            out[attr.name] = put(np.asarray(col))
    valid = (
        batch.valid
        if batch.valid is not None
        else np.ones(len(batch), dtype=bool)
    )
    out[VALID] = put(np.asarray(valid, bool))
    return out


# batch-identity device cache: repeat analytics over one materialized batch
# (the kNN process's steady state) must not re-upload it per call. Keyed by
# object identity, then by coordinate dtype and device; an entry is dropped
# when its batch is collected (FeatureBatch is an unhashable dataclass, so
# id() keying with a weakref.finalize eviction hook).
_BATCH_CACHE: Dict[int, Dict[str, DeviceBatch]] = {}


def to_device_cached(batch: FeatureBatch, device: torch.device,
                     coord_dtype: torch.dtype = torch.float32) -> DeviceBatch:
    """`to_device` memoized on the batch OBJECT (not its value): batches
    are treated as immutable (every mutation builds a new batch)."""
    key = id(batch)
    slot = _BATCH_CACHE.get(key)
    if slot is None:
        slot = _BATCH_CACHE[key] = {}
        weakref.finalize(batch, _BATCH_CACHE.pop, key, None)
    dkey = f"{coord_dtype}|{device}"
    if dkey not in slot:
        slot[dkey] = to_device(batch, device, coord_dtype=coord_dtype)
    return slot[dkey]


class DeviceTables:
    """Host arrays (a filter literal's edge or vertex table) as tensors,
    made once per device. They keep their dtype (f64 unless `dtype` says
    otherwise, as the reference's literals are), so they promote an f32
    column's arithmetic as the reference's do."""

    def __init__(self, arrays, dtype=None):
        self.host = [np.ascontiguousarray(a, dtype) for a in arrays]
        self._by_device: Dict[torch.device, List[torch.Tensor]] = {}

    def on(self, device: torch.device) -> List[torch.Tensor]:
        got = self._by_device.get(device)
        if got is None:
            got = self._by_device[device] = [torch.from_numpy(a).to(device)
                                             for a in self.host]
        return got


class Readback:
    """Device -> host copies enqueued now and completed by ONE event.

    On CUDA tensors each copy goes asynchronously into pinned memory on
    the current stream and a CUDA event is recorded after the last one;
    `wait()` blocks on that event alone, so a thread that harvests one
    window does not also wait for kernels enqueued after it (a stream
    synchronisation would). On the CPU the tensors are the host copies."""

    __slots__ = ("host", "event", "_more")

    def __init__(self, tensors):
        tensors = tuple(tensors)
        cuda = list(dict.fromkeys(t.device for t in tensors if t.is_cuda))
        self._more = ()
        if cuda:
            self.host = tuple(t.to("cpu", non_blocking=True) for t in tensors)
            # the copies run on their tensors' cards, on each card's
            # current stream: one event a card (the first is `event`)
            events = []
            for dev in cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                events.append(ev)
            self.event = events[0]
            self._more = tuple(events[1:])
        else:
            self.host = tensors
            self.event = None

    def wait(self):
        """The host NumPy arrays, once every copy has landed."""
        if self.event is not None:
            self.event.synchronize()
            for ev in self._more:
                ev.synchronize()
        return tuple(h.numpy() for h in self.host)


def fetch(*tensors: torch.Tensor):
    """Copy device tensors to host NumPy with ONE wait: every copy is
    enqueued asynchronously (into pinned memory) and an event recorded
    after them is waited on once (`Readback`)."""
    return Readback(tensors).wait()


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """`a` on `device`. On a card the copy goes from pinned memory with
    `non_blocking`, ordered on the current stream, and the host returns
    at once (PyTorch's pinned allocator keeps the buffer until the copy
    has read it); a pageable `.to()` would wait for the whole stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


_SIDE: Dict[str, torch.cuda.Stream] = {}
_SIDE_LOCK = threading.Lock()


@contextlib.contextmanager
def side_stream(device: torch.device, after=None):
    """Run the body's device work on the side stream of `device`, ordered
    after the event `after` (not after the caller's whole stream), so a
    host read inside the body (a `fetch`, `nonzero`) waits only for the
    body's own work and not for kernels queued before it. On exit the
    caller's stream waits on the side stream, and the tensors handed to
    the yielded `keep` are marked as used by the caller's stream (their
    memory is not reused before its work is done). A no-op on the CPU."""
    if device.type != "cuda":
        yield lambda *tensors: None
        return
    name = str(device)
    with _SIDE_LOCK:
        side = _SIDE.get(name)
        if side is None:
            side = _SIDE[name] = torch.cuda.Stream(device=device)
    caller = torch.cuda.current_stream(device)
    if after is not None:
        side.wait_event(after)
    kept: list = []
    with torch.cuda.stream(side):
        yield lambda *tensors: kept.extend(tensors)
    caller.wait_stream(side)
    for t in kept:
        t.record_stream(caller)


class StagedSlot:
    """One staging slot: the device query pair a window's launch reads
    (`qx`, `qy`; iterating the slot yields them), and on a card its
    pinned host pair, the event that marks the host-to-device copy done
    (`copied`) and the event after which no launch reads the device pair
    any more (`consumed`, set by whoever launched on it)."""

    __slots__ = ("index", "qx", "qy", "hx", "hy", "copied", "consumed")

    def __init__(self, index: int):
        self.index = index
        self.qx = self.qy = self.hx = self.hy = None
        self.copied = self.consumed = None

    def __iter__(self):
        return iter((self.qx, self.qy))


def _indexed(device: torch.device) -> torch.device:
    """`cuda` as the `cuda:<current>` its tensors report (so a tensor's
    device compares equal to the device it was made on)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class SlotRing:
    """`depth` staging slots of one query shape and their rotation: the
    slot handed to window N comes round again at window N + depth.
    `lock` serialises the callers that share one ring (the ring serve
    loop holds it across slot write, launch and readback)."""

    def __init__(self, depth: int):
        self.depth = depth
        self.slots = [StagedSlot(i) for i in range(depth)]
        self.seq = 0
        self.lock = threading.Lock()

    def next(self) -> StagedSlot:
        slot = self.slots[self.seq % self.depth]
        self.seq += 1
        return slot

    def allocate(self, q: int, device: torch.device) -> None:
        """Give every slot its device pair (and, on a card, its pinned host
        pair) of `q` f32 lanes up front, once: a captured CUDA graph reads
        the same device buffers on every replay, and a slot's copy stream
        writes them while earlier windows may still read them."""
        device = _indexed(device)
        pin = device.type == "cuda"
        for s in self.slots:
            if s.qx is None or s.qx.shape[0] != q or s.qx.device != device:
                s.qx = torch.zeros(q, dtype=torch.float32, device=device)
                s.qy = torch.zeros(q, dtype=torch.float32, device=device)
                if pin:
                    s.hx = torch.empty(q, dtype=torch.float32, pin_memory=True)
                    s.hy = torch.empty(q, dtype=torch.float32, pin_memory=True)
                    # the zero fill runs on the current stream, perhaps
                    # behind queued kernels: the slot's first copy (on
                    # the copy stream) must land after it, not under it
                    s.consumed = torch.cuda.Event()
                    s.consumed.record(torch.cuda.current_stream(device))


class QueryStager:
    """Staging slots for the serve pipeline's query streams: the
    counterpart of the reference's `engine/device.py` QueryStager.

    Each pipelined window stages its stacked (padded) query points here
    before its launch. Per key the stager keeps `depth` slots rotated per
    window (a `SlotRing`); the ring serve loop passes the slots of its
    captured graphs instead (`ring=`). The dtype discipline is the serial
    route's (`np.asarray(q, np.float32)` on the host), so staged values
    are bit-identical to the planner's own upload.

    On a card a slot's host pair is pinned memory and its device pair is
    written by a `non_blocking` copy on one copy stream; the current
    (compute) stream waits on the copy's event, so the transfer overlaps
    the previous window's kernels instead of queueing behind them. The
    transfer runs under the recovery fabric, as `to_device` does. Before
    a slot is written again the stager waits for its last copy (the
    pinned buffer stays untouched until the copy has read it) and the copy
    stream waits for the slot's `consumed` event (no launch still reads
    the device pair). On the CPU a slot holds fresh tensors per window.
    Keys are LRU-bounded (MAX_KEYS)."""

    MAX_KEYS = 64

    def __init__(self, depth: int = 2, device: Optional[torch.device] = None):
        if depth < 2:
            raise ValueError("stager depth must be >= 2 (double buffer)")
        self.depth = depth
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._lock = threading.Lock()
        self._rings: Dict[object, SlotRing] = {}
        self._staged_total = 0
        self._copy_stream = None

    def ring(self, key, q: int) -> SlotRing:
        """The key's slot ring (made, and on a card allocated, on first
        use); past MAX_KEYS the least recently staged key is evicted."""
        with self._lock:
            ring = self._rings.pop(key, None)
            if ring is None:
                ring = SlotRing(self.depth)
                while len(self._rings) >= self.MAX_KEYS:
                    self._rings.pop(next(iter(self._rings)))
            self._rings[key] = ring  # re-insert = LRU touch
        if self.device.type == "cuda":
            ring.allocate(q, self.device)
        return ring

    def stage(self, key, qx, qy, ring: Optional[SlotRing] = None) -> StagedSlot:
        """Write one window's query points into the next slot of `key`'s
        ring (or of `ring`) and return the slot. `qx`/`qy` stay the
        caller's host arrays (the OOM ladder re-stages from them)."""
        from geomesa_tpu_torch.utils.metrics import note_device_op

        qx32 = np.asarray(qx, np.float32).ravel()
        qy32 = np.asarray(qy, np.float32).ravel()
        if ring is None:
            ring = self.ring(key, len(qx32))
        slot = ring.next()
        note_device_op()

        def _put():
            # the fault fires on the host before any copy: never inside a
            # graph capture, never with the slot half written
            _TRANSFER_SITE.fire()
            if self.device.type == "cuda":
                self._copy(slot, qx32, qy32)
            else:
                slot.qx = torch.from_numpy(qx32)
                slot.qy = torch.from_numpy(qy32)

        with TRACER.span("device.transfer", rows=int(len(qx32)), staged=True):
            _device_retry(_put)
        with self._lock:
            self._staged_total += 1
        return slot

    def _copy(self, slot: StagedSlot, qx32, qy32) -> None:
        if slot.qx is None or slot.qx.shape[0] != len(qx32):
            raise ValueError(f"slot of {None if slot.qx is None else slot.qx.shape[0]} "
                             f"lanes staged with {len(qx32)} queries")
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        if slot.copied is not None:
            slot.copied.synchronize()  # the pinned pair's last copy has read it
        slot.hx.numpy()[:] = qx32
        slot.hy.numpy()[:] = qy32
        stream = self._copy_stream
        if slot.consumed is not None:
            stream.wait_event(slot.consumed)
        with torch.cuda.stream(stream):
            slot.qx.copy_(slot.hx, non_blocking=True)
            slot.qy.copy_(slot.hy, non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(stream)
        torch.cuda.current_stream(self.device).wait_event(slot.copied)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"keys": len(self._rings), "staged": self._staged_total}


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches` under a lock, so launches
    from worker threads (an export's partitions) are never lost."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def check_kernel_inputs(*tensors: torch.Tensor, dtypes) -> None:
    """Refuse what a CUDA kernel does not take: tensors on several devices,
    another dtype than `dtypes` (one per tensor), or a strided layout."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"kernel inputs on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"kernel input of dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
