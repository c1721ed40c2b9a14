"""Spans and counters inside the frame loop.

A span marks one step of the work (``with telemetry.span("grid.lookup"):``);
a counter adds integers the host already holds (``telemetry.count(name, n)``).
Tracing is decided once a frame, at the entry of :func:`frame` (the scope
``transport.transport_frame`` and the driver's frame open): it is on when
:func:`enable` was called or when a torch profiler is recording on the
calling thread, and the decision holds in a module flag until that frame
ends.  So a run under ``torch.profiler`` gets its spans with no call here,
and every other frame runs with tracing off.

With tracing off, :func:`span` returns one shared, preallocated no-op object
and :func:`count` returns at once: no allocation of their own, no clock
read, no tensor op, no CUDA call.  With tracing on, a span

* under a recording profiler, opens a profiler annotation of its name
  (``_RecordFunctionFast`` where torch has it, a ``cpu_op`` in the chrome
  trace; else ``record_function``, a ``user_annotation``), so that it
  shows among the host operations on the device activity's clock; without
  a profiler nothing reads the annotation, and none is opened;
* reads the host clock at its ends (``time.perf_counter_ns``) and, where the
  frame's tensors are on a card, records a pair of CUDA events on the
  current stream (looked up once a frame and device), taken from a pool;
* on closing, adds its count, host time and self time (the host time its
  child spans do not cover) to running totals by name.

A span's stream milliseconds are the stream's time between its two events:
the device work the span queued, and the device's idle time inside it where
the host was slower than the device.  They are read without a sync: at each
traced frame's entry, the events the device has passed (``query``) are read
into the totals and go back to the pool, so events and pending spans stay
bounded by about a frame's spans; :func:`summary` and :func:`snapshot` wait
for the rest.  The record of each span (name, id, the id of the span it
opened inside, thread, the ordinal of the enclosing ``transport.frame``,
host clock at start and end, stream ms) is kept only after
``enable(records=True)``; otherwise tracing keeps the totals alone.

:func:`timed` is a span that always reads the host clock and can add its
seconds to a dict (the driver's ``frame_timing`` keys); it records a span,
host clock only, when tracing is requested.  Nothing is written out unless
a caller asks (``cli run --trace-json``).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

import torch
from torch.autograd.profiler import record_function

FRAME = "transport.frame"
_POOL_GROWTH = 64  # CUDA events made at once when the pool runs dry
# the profiler annotation a span opens: the C++ one costs ~1.8 us under a
# profiler on the card's host against record_function's ~13 us
_Annotation = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast",
                      None) or record_function

_enabled = False  # enable() was called
_keep = False  # enable(records=True): closed spans keep their records
_on = False  # tracing on for the frame being run (decided at its entry)
_cuda = False  # that frame's tensors are on a card: spans record CUDA events
_annotate = False  # a profiler records that frame: spans open annotations
_totals: dict = {}  # span name -> [count, host ns, self ns, stream ms or None]
_pending: list = []  # closed spans whose CUDA events are not read yet, in closing order
_records: list = []  # closed spans, with records=True
_counters: dict = {}
_ids = itertools.count(1)
_n_frames = 0  # transport.frame spans opened since the last reset()
_local = threading.local()
_pool: dict = {}  # CUDA device index -> free timing events
_streams: dict = {}  # CUDA device index -> the current stream, looked up once a frame


class _NoSpan:
    """The span of a frame run with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _take_events() -> tuple:
    """(device, start event, end event, the device's current stream)."""
    dev = torch.cuda.current_device()
    free = _pool.setdefault(dev, [])
    if len(free) < 2:
        free.extend(torch.cuda.Event(enable_timing=True) for _ in range(_POOL_GROWTH))
    stream = _streams.get(dev)
    if stream is None:
        stream = _streams[dev] = torch.cuda.current_stream(dev)
    return dev, free.pop(), free.pop(), stream


class Span:
    """One span; a context manager that opens and closes it."""

    __slots__ = ("name", "id", "parent", "thread", "frame", "start_ns", "end_ns", "stream_ms",
                 "_child_ns", "_outer", "_events", "_annotation")

    def __init__(self, name: str, events: bool, annotate: bool):
        self.name = name
        self.end_ns = None
        self.stream_ms = None
        self._child_ns = 0
        self._events = events  # until entered; then (device, start, end, stream) or None
        self._annotation = annotate

    def __enter__(self):
        global _n_frames
        stack = _stack()
        outer = self._outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else None
        self.thread = threading.get_ident()
        if self.name == FRAME:
            self.frame, _n_frames = _n_frames, _n_frames + 1
        else:
            self.frame = outer.frame if outer is not None else None
        self._annotation = _Annotation(self.name) if self._annotation else None
        if self._annotation is not None:
            self._annotation.__enter__()
        self._events = _take_events() if self._events else None
        if self._events is not None:
            self._events[1].record(self._events[3])
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[2].record(self._events[3])
            _pending.append(self)
        _stack().pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        ns = self.end_ns - self.start_ns
        if self._outer is not None:
            self._outer._child_ns += ns
            self._outer = None
        tot = _totals.get(self.name)
        if tot is None:
            tot = _totals[self.name] = [0, 0, 0, None]
        tot[0] += 1
        tot[1] += ns
        tot[2] += ns - self._child_ns
        if _keep:
            _records.append(self)
        return False

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) * 1e-6


def _resolve(wait: bool) -> None:
    """Read the CUDA events of closed spans into their stream ms and the
    totals, and give the events back to the pool.  Without ``wait`` only
    those the device has passed, in closing order up to the first it has
    not (no sync); with it, all (waits for each end event)."""
    n = 0
    for s in _pending:
        dev, start, end, _ = s._events
        if wait:
            end.synchronize()
        elif not end.query():
            break
        s.stream_ms = start.elapsed_time(end)
        tot = _totals.get(s.name)
        if tot is not None:
            tot[3] = (tot[3] or 0.0) + s.stream_ms
        _pool[dev].extend((start, end))
        s._events = None
        n += 1
    del _pending[:n]


def span(name: str):
    """A context manager marking one step of the frame: a recorded
    :class:`Span` while tracing is on, else the shared no-op."""
    if not _on:
        return _NO_SPAN
    return Span(name, _cuda, _annotate)


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def tracing() -> bool:
    """Tracing is on for the frame being run: a caller that gathers a
    count on the device for a counter does so only then."""
    return _on


def _profiling() -> bool:
    """A torch profiler is recording on this thread."""
    return torch.autograd._profiler_enabled()


class Timed:
    """A span that always reads the host clock (``seconds`` once closed,
    :meth:`elapsed_s` while open) and on closing adds its seconds to
    ``sink[key]`` when given a sink; it records a host-only :class:`Span`
    when :func:`enable` was called or a torch profiler records on its
    thread.  A frame scope (``device`` given) decides
    tracing for the frame and holds the decision until it closes."""

    __slots__ = ("name", "sink", "key", "device", "seconds", "_start", "_span", "_saved")

    def __init__(self, name: str, sink: Optional[dict] = None, key: Optional[str] = None,
                 device=None):
        self.name, self.sink, self.key, self.device = name, sink, key, device
        self.seconds = None
        self._span = None

    def __enter__(self):
        global _on, _cuda, _annotate
        if self.device is not None:
            self._saved = _on, _cuda, _annotate
            _annotate = _profiling()
            _on = _enabled or _annotate
            _cuda = _on and self.device.type == "cuda"
            if _on:
                if _pending:
                    _resolve(wait=False)
                _streams.clear()
                self._span = Span(self.name, _cuda, _annotate).__enter__()
        elif _enabled or _profiling():
            self._span = Span(self.name, False, _profiling()).__enter__()
        self._start = time.perf_counter_ns()
        return self

    def elapsed_s(self) -> float:
        return (time.perf_counter_ns() - self._start) * 1e-9

    def __exit__(self, *exc):
        global _on, _cuda, _annotate
        self.seconds = (time.perf_counter_ns() - self._start) * 1e-9
        if self._span is not None:
            self._span.__exit__(*exc)
        if self.device is not None:
            _on, _cuda, _annotate = self._saved
        if self.sink is not None:
            self.sink[self.key] = self.sink.get(self.key, 0) + self.seconds
        return False


def frame(name: str, device) -> Timed:
    """The scope of one frame on ``device``: decides whether tracing is on
    for it and opens its root span ``name``."""
    return Timed(name, device=torch.device(device))


def timed(name: str, sink: Optional[dict] = None, key: Optional[str] = None) -> Timed:
    """A host-clock span whose seconds ``sink[key]`` gains on closing."""
    return Timed(name, sink, key)


def enable(on: bool = True, records: bool = False) -> None:
    """Turn tracing on (or off) for the frames that start from now on;
    ``records`` keeps every closed span's record for :func:`snapshot`."""
    global _enabled, _keep
    _enabled = bool(on)
    _keep = bool(on and records)


def reset() -> None:
    """Forget every total, record and counter (pending CUDA events go back
    to the pool)."""
    global _n_frames
    for s in _pending:
        dev, start, end, _ = s._events
        _pool[dev].extend((start, end))
        s._events = None
    _pending.clear()
    _totals.clear()
    _records.clear()
    _counters.clear()
    _n_frames = 0


def snapshot() -> list:
    """Every closed span kept since ``enable(records=True)``, as a dict:
    ``name``, ``id``, ``parent``, ``thread``, ``frame``, ``start_ns``,
    ``end_ns``, ``host_ms``, ``stream_ms``."""
    _resolve(wait=True)
    return [dict(name=r.name, id=r.id, parent=r.parent, thread=r.thread, frame=r.frame,
                 start_ns=r.start_ns, end_ns=r.end_ns, host_ms=r.host_ms, stream_ms=r.stream_ms)
            for r in list(_records)]


def summary() -> dict:
    """``frames``: the ``transport.frame`` spans recorded; ``spans``: per
    name, ``count``, ``host_ms``, ``self_ms`` (host time its child spans do
    not cover) and ``stream_ms`` (the stream's time between the spans' CUDA
    events; None without events); ``counters``."""
    _resolve(wait=True)
    spans = {name: dict(count=c, host_ms=host * 1e-6, self_ms=own * 1e-6, stream_ms=stream)
             for name, (c, host, own, stream) in list(_totals.items())}
    return dict(frames=_n_frames, spans=spans, counters=dict(_counters))
