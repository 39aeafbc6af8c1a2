"""Span-tracing core: where a query's wall time actually goes.

A copy of the reference package's `telemetry/trace.py`, kept in the
port so that it imports nothing of the reference. The port opens the
reference's spans at the same seams: the serve layer's, and the
planner's and device layer's (plan, residency, scan, kernel.dispatch
with its `kernel` family, device.transfer, device.sync, aggregate).

The serve path is dispatch-bound (BENCH r03: 0.101s dispatch RTT vs
0.066s kernel time), and the only per-request evidence so far is the
coarse `ServeEvent` queue_ms/exec_ms split. This module gives every
query a trace — a tree of `Span`s opened at each serve phase (admit,
queue-wait, coalesce, plan, residency, transfer, kernel dispatch,
device sync, merge, respond) — so a p99 investigation reads a flame
view instead of correlating counters. The same discipline GeoMesa
inherits from its iterator timing + geomesa-metrics module, applied to
the accelerator serving stack.

Design constraints, in priority order:

1. **Off = free.** `TRACER.span()` with tracing disabled is one
   attribute read and a shared no-op object — no allocation, no clock
   read. Serving with tracing off must be indistinguishable from a
   build without telemetry (asserted in tests/test_telemetry.py).
2. **On = cheap.** A live span is two `perf_counter_ns()` reads, a
   thread-local stack push/pop, ONE object allocation (the context
   manager) and one tuple append — budgeted at <2µs per span and
   asserted in tests. Completed spans are stored as plain tuples, not
   objects: on slow hosts a slotted-class construction alone costs
   ~0.7µs, so the hot path appends `(name, id, parent, t0, t1, thread,
   attrs)` and `snapshot_spans()` materializes `Span` views lazily.
   Appends are lock-free — `list.append` is a single atomic bytecode
   under the GIL, and readers copy via `list(...)` before iterating.
   All timestamps are `perf_counter_ns` (monotonic, ns, comparable
   across threads in one process); wall-clock `time.time()` never
   measures a duration here (lint rule GT15 enforces that tree-wide).
3. **Library code stays trace-unaware of requests.** The planner and
   engine open spans by name only; whether they land in a trace is
   decided by the thread's *scope* (`TRACER.scope(trace)`), installed
   by the serve dispatch loop around each dispatch window. A direct
   planner caller with no scope pays the no-op path even when tracing
   is globally on.

Cross-thread phases (queue wait spans the submitting thread and the
dispatch thread) are recorded retroactively via `Trace.record` with
explicit timestamps.
"""

from __future__ import annotations

import itertools
import os
import threading
from time import perf_counter_ns
from typing import List, Optional

__all__ = ["Span", "Trace", "Tracer", "TRACER", "NOOP_SPAN",
           "new_span_id"]

_span_ids = itertools.count(1)
_trace_ids = itertools.count(1)

# span storage tuple layout (hot path appends these, Span wraps them)
# (name, span_id, parent_id, start_ns, end_ns, thread, attrs-or-None)


def _new_trace_id() -> str:
    # pid-qualified so dumps merged across processes (replica fleets,
    # chaos runs) never collide
    return f"{os.getpid():x}-{next(_trace_ids):x}"


def new_span_id() -> int:
    """Pre-allocate a span id from the process-wide counter. The
    pipelined dispatch path records its window span only at completion
    (the window's extent is not known until the deferred device sync),
    but its stage spans need the window as parent while it is still
    open — so the id is allocated up front and passed to `Trace.record`
    / `Tracer.scope(parent_id=...)` until the closing record."""
    return next(_span_ids)


class Span:
    """One completed span — a typed view over the storage tuple. Plain
    data: the tracer writes tuples, exporters read these."""

    __slots__ = ("name", "span_id", "parent_id", "start_ns", "end_ns",
                 "thread", "attrs")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 start_ns: int, end_ns: int, thread: int,
                 attrs: Optional[dict]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.thread = thread
        self.attrs = attrs

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def to_json(self) -> dict:
        return _tuple_json((self.name, self.span_id, self.parent_id,
                            self.start_ns, self.end_ns, self.thread,
                            self.attrs))

    @classmethod
    def from_json(cls, d: dict) -> "Span":
        return cls(d["name"], d["id"], d.get("parent"), d["t0_ns"],
                   d["t1_ns"], d.get("thread", 0), d.get("attrs"))


def _tuple_json(t: tuple) -> dict:
    name, span_id, parent_id, start_ns, end_ns, thread, attrs = t
    d = {
        "name": name,
        "id": span_id,
        "parent": parent_id,
        "t0_ns": start_ns,
        "t1_ns": end_ns,
        "thread": thread,
    }
    if attrs:
        d["attrs"] = dict(attrs)
    return d


class Trace:
    """One query's span tree. The submitting thread, the dispatch
    thread and protocol callbacks all contribute; `spans` holds raw
    storage tuples appended lock-free (GIL-atomic), and every reader
    copies the list before iterating. The root span opens at
    construction and closes at `finish()`."""

    __slots__ = ("trace_id", "name", "root", "_flock", "spans",
                 "finished")

    def __init__(self, name: str, **attrs):
        self.trace_id = _new_trace_id()
        self.name = name
        self._flock = threading.Lock()  # finish() only — never hot
        self.spans: List[tuple] = []
        self.finished = False
        self.root = Span(name, next(_span_ids), None, perf_counter_ns(), 0,
                         threading.get_ident(), dict(attrs) or None)

    def record(self, name: str, start_ns: int, end_ns: int,
               parent_id: Optional[int] = None,
               span_id: Optional[int] = None, **attrs) -> Span:
        """Record an already-measured phase (queue wait, respond): the
        caller holds both timestamps; parent defaults to the root.
        `span_id` lets a caller close a span whose id was pre-allocated
        via `new_span_id()` (the pipelined dispatch window)."""
        t = (name, span_id if span_id is not None else next(_span_ids),
             parent_id if parent_id is not None else self.root.span_id,
             start_ns, end_ns, threading.get_ident(), attrs or None)
        # gt: waive GT07
        # (deliberately outside _flock: single-bytecode list.append is
        # atomic under the GIL; readers snapshot via list(self.spans) —
        # see the module docstring. _flock guards only finish().)
        self.spans.append(t)
        return Span(*t)

    def adopt(self, spans: List[Span], clamp_start_ns: Optional[int] = None
              ) -> None:
        """Copy another trace's spans into this one (a coalesced rider
        adopting the shared dispatch-window spans from the lead trace).
        Span/parent ids are kept — they are globally unique — so the
        tree re-roots cleanly: a copied span whose parent is the OTHER
        trace's root re-parents to THIS root. `clamp_start_ns` floors
        adopted starts at this trace's root start (a rider admitted
        mid-gather would otherwise carry a child older than its root);
        clamped copies are marked with attr clamped=True."""
        other_ids = {s.span_id for s in spans}
        out = []
        for s in spans:
            parent = (s.parent_id if s.parent_id in other_ids
                      else self.root.span_id)
            attrs = dict(s.attrs) if s.attrs else None
            start = s.start_ns
            if clamp_start_ns is not None and start < clamp_start_ns:
                start = clamp_start_ns
                attrs = dict(attrs or ())
                attrs["clamped"] = True
            out.append((s.name, s.span_id, parent, start,
                        max(s.end_ns, start), s.thread, attrs))
        # gt: waive GT07
        # (GIL-atomic extend of the lock-free span list, as in record —
        # _flock guards only finish())
        self.spans.extend(out)

    def finish(self, **attrs) -> "Trace":
        """Close the root span; idempotent (the first close wins so a
        late finisher cannot stretch the recorded wall time)."""
        with self._flock:
            if not self.finished:
                self.finished = True
                self.root.end_ns = perf_counter_ns()
                if attrs:
                    merged = dict(self.root.attrs or ())
                    merged.update(attrs)
                    self.root.attrs = merged
        return self

    def snapshot_spans(self) -> List[Span]:
        return [Span(*t) for t in list(self.spans)]

    def span_count(self) -> int:
        return len(self.spans)

    def to_json(self) -> dict:
        spans = list(self.spans)
        root = self.root.to_json()
        if self.root.end_ns == 0:
            root["t1_ns"] = perf_counter_ns()  # still-open trace dump
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "root": root,
            "spans": [_tuple_json(t) for t in spans],
        }


class _NoopSpan:
    """Shared do-nothing span: the disabled/unscoped fast path returns
    this singleton, so `with TRACER.span(...)` costs one attribute read
    and two no-op calls."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _SpanHandle:
    """The per-scope span context manager — ONE shared object per
    (thread, scope), not one per span, because on slow hosts a slotted
    allocation alone eats a third of the 2µs budget.

    How it works: `Tracer.span()` pushes an *open frame*
    `[name, span_id, parent_id, start_ns, attrs]` onto the scope's
    frame stack and returns this shared handle; `__exit__` pops the top
    frame, stamps the end time and appends the completed storage tuple.
    Correct because with-blocks are strictly LIFO per thread — the
    frame `__exit__` pops is always the one the matching `span()` call
    pushed (ExitStack unwinds in reverse order, preserving LIFO). The
    GT15 lint rule enforces the contract's precondition: every
    `.span()` call is a `with` context expression (or enter_context
    argument), so frames can never leak unbalanced.

    After a `with ... as s:` block exits, `s.span_id` / `s.start_ns` /
    `s.end_ns` hold the values of the span that just closed — the
    innermost-exit-last order makes that exactly the span the with
    opened. `set()` targets the innermost OPEN span, which inside a
    with-body (and before any child opens) is the with's own span."""

    __slots__ = ("_ctx", "span_id", "start_ns", "end_ns")

    def __init__(self, ctx: tuple):
        self._ctx = ctx

    def __enter__(self) -> "_SpanHandle":
        return self

    def set(self, **attrs) -> None:
        frame = self._ctx[2][-1]
        if frame[4] is None:
            frame[4] = attrs
        else:
            frame[4].update(attrs)

    def __exit__(self, exc_type, exc, tb, _pc=perf_counter_ns) -> bool:
        end_ns = _pc()
        ctx = self._ctx
        name, span_id, parent_id, start_ns, attrs = ctx[2].pop()
        if exc_type is not None:
            if attrs is None:
                attrs = {}
            attrs["error"] = exc_type.__name__
        self.span_id = span_id
        self.start_ns = start_ns
        self.end_ns = end_ns
        # gt: waive GT12
        # (GIL-atomic append to the lock-free span list — module doc)
        ctx[0].append(
            (name, span_id, parent_id, start_ns, end_ns, ctx[3], attrs))
        return False


class _Scope:
    __slots__ = ("_tracer", "_trace", "_prev", "_parent_id")

    def __init__(self, tracer: "Tracer", trace: Optional[Trace],
                 parent_id: Optional[int] = None):
        self._tracer = tracer
        self._trace = trace
        self._parent_id = parent_id

    def __enter__(self) -> Optional[Trace]:
        tls = self._tracer._tls
        self._prev = getattr(tls, "ctx", None)
        trace = self._trace
        if trace is None:
            tls.ctx = None  # explicit silence (warmup replay)
        else:
            # the per-scope span context: (spans list, base parent id,
            # open-frame stack, thread ident, trace, shared handle) —
            # ONE tls read per span instead of separate lookups. The
            # handle closes over the ctx, so build it in two steps.
            # The base parent defaults to the root; the pipelined
            # dispatch passes its pre-allocated window span id so stage
            # spans nest under the (not-yet-recorded) window.
            handle = _SpanHandle.__new__(_SpanHandle)
            base = (self._parent_id if self._parent_id is not None
                    else trace.root.span_id)
            ctx = (trace.spans, base, [],
                   threading.get_ident(), trace, handle)
            handle._ctx = ctx
            tls.ctx = ctx
        return trace

    def __exit__(self, *exc) -> bool:
        self._tracer._tls.ctx = self._prev
        return False


class Tracer:
    """Process-wide tracing switch + per-thread scope. One instance
    (`TRACER`) serves the whole process; QueryServices, the planner and
    the engine all open spans through it."""

    __slots__ = ("enabled", "_tls")

    def __init__(self):
        self.enabled = False
        self._tls = threading.local()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def start_trace(self, name: str, **attrs) -> Optional[Trace]:
        """A new Trace (opening its root span), or None when tracing is
        off — callers thread the None through untouched and every
        downstream telemetry call no-ops."""
        if not self.enabled:
            return None
        return Trace(name, **attrs)

    def scope(self, trace: Optional[Trace],
              parent_id: Optional[int] = None) -> _Scope:
        """Bind `trace` as this thread's active trace for the duration
        (`with TRACER.scope(trace): ...`). Spans opened by ANY code on
        this thread inside the scope land in it; scoping None explicitly
        silences spans (used by warmup replay). `parent_id` re-bases the
        scope: top-level spans parent to that span instead of the root
        (the pipelined dispatch window's pre-allocated id)."""
        return _Scope(self, trace, parent_id)

    def current_trace(self) -> Optional[Trace]:
        if not self.enabled:
            return None
        ctx = getattr(self._tls, "ctx", None)
        return ctx[4] if ctx is not None else None

    def span(self, name: str, _noop=NOOP_SPAN,
             _next_id=_span_ids.__next__, _pc=perf_counter_ns, **attrs):
        """Open a span under the thread's scoped trace: pushes an open
        frame and returns the scope's shared handle (see _SpanHandle —
        the span opens HERE; `with` must close it). The no-op path
        (tracing off, or no scope installed) returns a shared no-op
        singleton: library code can call this unconditionally on hot
        paths."""
        if not self.enabled:
            return _noop
        ctx = getattr(self._tls, "ctx", None)
        if ctx is None:
            return _noop
        stack = ctx[2]
        parent_id = stack[-1][1] if stack else ctx[1]
        stack.append([name, _next_id(), parent_id, _pc(), attrs or None])
        return ctx[5]


TRACER = Tracer()
