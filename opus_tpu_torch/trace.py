"""The serving decoders' own tracer: spans at the serve loops' layer
boundaries, counters, and device phase times from inside a captured step.

Off by default.  The whole control surface:

    from opus_tpu_torch import trace
    trace.enable(range_prefix="")   # start recording (anchors the clock)
    ...serve...
    trace.spans()                   # what was recorded, oldest first
    trace.counters()                # counts (and, with steps=, a window's)
    trace.clear(); trace.disable()

* A span (`span(name)`, a context manager, opened by the program) is a
  no-op while tracing is off: no clock is read, nothing is allocated.
  While on, it records its name, its parent, the step id (the serving
  decoder's own count of steps served: every span of one step shares it)
  and its start and end from `time.perf_counter_ns()`.  `spans()` gives
  them on the clock torch.profiler stamps its host events with (the Unix
  wall clock, in ns), through one anchor pair taken at `enable()`; so a
  span lines up with a profiler trace of the same run.  While a profiler
  is active and `range_prefix` is set, each span is also a
  `torch.profiler.record_function(range_prefix + name)`, and a device
  trace's idle gaps can be put down to the innermost span open.
* Spans and device phases live in memory, in a ring of `RING` records;
  the oldest are dropped first, and counted in `spans_dropped`.
* Counters (`count(name, n)`) always count, as plain integers.  While
  tracing is on each increment is also kept with its step id, so that
  `counters(steps=(first, stop))` reads a window of steps.  `counters()`
  also reports, by reading them where they are, the kernel wrappers'
  `launches` (dsp/graphs.py `COUNTED`) and the serving decoders'
  `plan_fallbacks`.
* Device phases: while tracing is on when a step variant is captured as
  a CUDA graph (dsp/graphs.py), `mark(name)` in the step records a timing
  event at each phase boundary, which the capture turns into an event
  node.  After a replay the graph reads the events once the last has
  completed, without a sync, and hands them to `device_phases`.

Spans carry the serving loop's state in a module global: one serving
thread a process, as the decoders are driven.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
import weakref

import torch

#: Records kept: the newest spans and device phases, and as many counter
#: increments.
RING = 1 << 17

#: The tracer's own counters (always counted).
COUNTERS = ("graph_builds", "plc_steps_compact", "plc_steps_whole", "shadow_decodes",
            "upload_bytes", "device_phases_missed", "spans_dropped", "plane_a_shards",
            "band_limited_streams")

Span = collections.namedtuple("Span", "id parent name step start_ns end_ns device")
Span.__doc__ = """One record of `spans()`.  A host span: start and end on
the profiler's clock (ns), `parent` the enclosing span's id (None at the
top).  A device phase (`device` True): start and end in ns from its
replay's first event, on the device's clock; `name` "step" spans the
replay's first to last event."""

on = False
_prefix = ""
_offset_ns = 0
_ring: collections.deque = collections.deque(maxlen=RING)
_increments: collections.deque = collections.deque(maxlen=RING)
_totals = dict.fromkeys(COUNTERS, 0)
_ids = itertools.count()
_open = None  # the innermost open span
_marks = None  # (name, event) pairs while a capture records device phases
_decoders: weakref.WeakSet = weakref.WeakSet()
_NULL = contextlib.nullcontext()  # the span while tracing is off


class _Span:
    __slots__ = ("name", "step", "id", "parent", "t0", "rf")

    def __init__(self, name: str, step):
        self.name, self.step = name, step

    def __enter__(self):
        global _open
        self.parent = _open
        if self.step is None:
            self.step = _open.step if _open is not None else -1
        _open = self
        self.id = next(_ids)
        self.rf = None
        if _prefix and torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(_prefix + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _open
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open = self.parent
        parent = self.parent.id if self.parent is not None else None
        _keep(_ring, (self.id, parent, self.name, self.step, self.t0, t1, False))
        return False


def _keep(ring: collections.deque, record) -> None:
    if len(ring) == ring.maxlen:
        _totals["spans_dropped"] += 1
    ring.append(record)


def span(name: str, step=None):
    """A span of the serving loop (a context manager); `step` sets the
    step id of it and its children, which otherwise take their parent's."""
    return _Span(name, step) if on else _NULL


def current_step() -> int:
    """The step id of the innermost open span (-1 where none is)."""
    return _open.step if _open is not None else -1


def count(name: str, n: int = 1) -> None:
    """Add n to a counter; while tracing is on, keep the increment with
    the step id of the innermost open span."""
    _totals[name] += n
    if on:
        _keep(_increments, (current_step(), name, n))


def watch(decoder) -> None:
    """A serving decoder whose `plan_fallbacks` counters() reports."""
    _decoders.add(decoder)


def enable(range_prefix: str = "") -> None:
    """Start recording; spans are also profiler ranges named
    range_prefix + name while a profiler is active and the prefix is set."""
    global on, _prefix, _offset_ns
    _prefix = range_prefix
    # torch.profiler stamps host events on the Unix clock (kineto converts
    # its approximate clock to it): one pair anchors perf_counter there
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    on = True


def disable() -> None:
    """Stop recording; what was recorded stays until clear()."""
    global on, _open
    on = False
    _open = None


def clear() -> None:
    """Forget the recorded spans, phases and increments, and zero the
    tracer's own counters."""
    _ring.clear()
    _increments.clear()
    for k in _totals:
        _totals[k] = 0


def spans() -> list:
    """The recorded spans and device phases, oldest first (`Span`s)."""
    return [Span(i, p, n, s, a + _offset_ns, b + _offset_ns, d) if not d
            else Span(i, p, n, s, a, b, d) for i, p, n, s, a, b, d in _ring]


def counters(steps=None) -> dict:
    """With steps None: the tracer's counters, each kernel wrapper's
    launches (`launches.<wrapper>`) and the watched decoders'
    `plan_fallbacks`.  With steps=(first, stop): the tracer's counters
    over the increments kept for step ids first <= id < stop, and
    `spans_dropped` in all."""
    if steps is not None:
        first, stop = steps
        out = dict.fromkeys(COUNTERS, 0)
        for step, name, n in _increments:
            if first <= step < stop:
                out[name] += n
        out["spans_dropped"] = _totals["spans_dropped"]
        return out
    from .dsp.graphs import COUNTED

    out = dict(_totals)
    out.update({f"launches.{fn.__name__}": fn.launches for fn in COUNTED})
    out["plan_fallbacks"] = sum(getattr(d, "plan_fallbacks", 0) for d in _decoders)
    return out


@contextlib.contextmanager
def phases():
    """Around a CUDA graph's capture: yields the (name, event) list that
    mark() fills, with a first event ("begin") recorded here; empty, and
    no event made, while tracing is off."""
    global _marks
    if not on:
        yield []
        return
    _marks = []
    mark("begin")
    try:
        yield _marks
    finally:
        _marks = None


def mark(name: str) -> None:
    """A device phase ends here (a step's phase boundary): a timing event
    on the current stream while a capture records phases, else nothing."""
    if _marks is not None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        _marks.append((name, ev))


def device_phases(step: int, marks: list) -> None:
    """Keep a completed replay's phases: `marks` are (name, event) with
    the first event the replay's start; each phase runs from the event
    before its own."""
    begin = marks[0][1]
    at = [0.0] + [begin.elapsed_time(ev) for _, ev in marks[1:]]
    for (name, _), a, b in zip(marks[1:], at, at[1:]):
        _keep(_ring, (next(_ids), None, name, step, int(a * 1e6), int(b * 1e6), True))
    _keep(_ring, (next(_ids), None, "step", step, 0, int(at[-1] * 1e6), True))
