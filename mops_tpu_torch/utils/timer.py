"""The port's span recorder: the reference TimerManager singleton
(src/Utils/Timer.hpp:17-266) with its seven categories and its summary and
detailed reports, recording every timed region as a span.

A span has a name, a category (one of CATEGORIES, or None for a span that
only groups others: an API call, the step loop's phases), its start and end
in ``time.time_ns()`` (the clock torch.profiler's kineto stamps its events
with, so spans and a profile's device events share one time axis), the id
of the span it is nested in (a per-thread stack) and the id of its request:
the sequence number of the API call (``request``, opened by
``MOPSApp.run_*`` and ``active_attribute``) that contains it, None outside
one.  A request's span also keeps ``meta``, what the call ran with (the
API's precision and, for a trajectory, ``advect.LAST_RESOLVED``).

Device time.  Work on the card is asynchronous.  A span opened with a CUDA
``device`` carries a pair of CUDA events; its device (stream) milliseconds
are resolved when it is read, after the work has completed, so nothing on
the hot path waits on the device for tracing.  A span on the CPU has host
time only.

Detail.  The coarse spans (about ten a request) are always recorded.
Detail -- the step loop's per-phase spans (``Phases``) and their events,
and the counters summed lazily from device tensors -- is on while a
torch.profiler session records on the calling thread (``profiling()``),
read once per API call (``detail()``), never per step.

Totals.  Spans live in a ring of the last RING; running totals per
category keep ``category_time`` and ``total_time`` exact however long the
process runs.  A category counts leaf time only: a categorized span's time
(its device time where it has one, else its host time) less that of the
categorized spans nested in it, so nesting counts nothing twice.

Counters are named integers, process-wide (``counter``) and of the current
request (``counters``), or device tensors attached to the request and
summed when read.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

CATEGORIES = ("IO_Read", "IO_Write", "Preprocessing", "MemoryCopy",
              "GPUKernel", "CPUCompute", "Other")
RING = 65536          # spans kept
REQUESTS = 1024       # requests whose counters are kept
_PENDING = 256        # spans with device time waiting to enter the totals


def profiling() -> bool:
    """True while a torch.profiler session records on this thread."""
    return torch.autograd._profiler_enabled()


def _cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class Span:
    """One timed region (or, from ``Phases``, one phase summed over a loop's
    steps: ``host_ns`` the summed host time, ``events`` a pair a step)."""

    __slots__ = ("id", "name", "category", "parent", "request", "detail",
                 "start_ns", "end_ns", "host_ns", "events", "meta",
                 "_device_ms", "_children")

    def __init__(self, name, category, parent, request, detail, start_ns):
        self.id = next(TimerManager._ids)
        self.name, self.category, self.parent = name, category, parent
        self.request, self.detail = request, detail
        self.start_ns = self.end_ns = start_ns
        self.host_ns = 0
        self.events = None
        self.meta = None
        self._device_ms = None
        self._children = None

    @property
    def host_ms(self) -> float:
        return self.host_ns / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Stream milliseconds over the span's event pairs (waiting for the
        work if it is still running); None for a span without events."""
        if self._device_ms is None and self.events is not None:
            total = 0.0
            for a, b in self.events:
                b.synchronize()
                total += a.elapsed_time(b)
            self._device_ms, self.events = total, None
        return self._device_ms

    @property
    def ms(self) -> float:
        """Device milliseconds where the span has them, else host."""
        dev = self.device_ms
        return self.host_ms if dev is None else dev

    def leaf_ms(self) -> float:
        """``ms`` less that of the categorized spans nested in it."""
        return self.ms - sum(c.ms for c in self._children or ())

    def _deferred(self) -> bool:
        return any(s.events is not None
                   for s in [self, *(self._children or ())])


class _Request:
    __slots__ = ("id", "name", "detail", "counts", "lazy", "span")

    def __init__(self, rid, name, detail):
        self.id, self.name, self.detail = rid, name, detail
        self.counts: Dict[str, int] = {}
        self.lazy: Dict[str, list] = {}
        self.span: Optional[Span] = None


class TimerManager:
    _instance = None
    _lock = threading.Lock()
    _ids = itertools.count()

    def __init__(self):
        self._mu = threading.Lock()
        self._tl = threading.local()
        self._request_ids = itertools.count()
        self._counts: Dict[str, int] = {}
        self.reset()

    @classmethod
    def instance(cls) -> "TimerManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
        return cls._instance

    def reset(self) -> None:
        """Spans, category totals and requests cleared (the process-wide
        counters stay: ``reset_counter``)."""
        with self._mu:
            self._spans = collections.deque(maxlen=RING)
            self._totals: Dict[str, float] = dict.fromkeys(CATEGORIES, 0.0)
            self._pending: List[Span] = []
            self._requests = collections.deque(maxlen=REQUESTS)

    # -- spans ----------------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tl, "stack", None)
        if stack is None:
            stack = self._tl.stack = []
        return stack

    def _current(self) -> Optional[_Request]:
        return getattr(self._tl, "request", None)

    def _open(self, name: str, category: Optional[str], start_ns: int) -> Span:
        stack = self._stack()
        req = self._current()
        return Span(name, category, stack[-1].id if stack else None,
                    None if req is None else req.id,
                    False if req is None else req.detail, start_ns)

    def _close(self, span: Span, stack: list) -> None:
        """Keep ``span``; a categorized one enters its nearest categorized
        ancestor's children and the totals (at once, or when its device
        time is read)."""
        if span.category is not None:
            for up in reversed(stack):
                if up.category is not None:
                    if up._children is None:
                        up._children = []
                    up._children.append(span)
                    break
        with self._mu:
            self._spans.append(span)
            if span.category is None:
                return
            self._pending.append(span)
            if len(self._pending) > _PENDING:
                self._settle(len(self._pending) // 2)
            elif not span._deferred():
                self._pending.pop()
                self._add(span)

    def _add(self, span: Span) -> None:
        self._totals[span.category] = \
            self._totals.get(span.category, 0.0) + span.leaf_ms()

    def _settle(self, n: Optional[int] = None) -> None:
        """Move the first ``n`` (all) pending spans into the totals; their
        device times are read here.  Holds ``_mu``."""
        n = len(self._pending) if n is None else n
        for span in self._pending[:n]:
            self._add(span)
        del self._pending[:n]

    @contextlib.contextmanager
    def span(self, name: str, category: Optional[str] = None, device=None):
        """Time the body as a span; with a CUDA ``device`` also a pair of
        events on its current stream."""
        span = self._open(name, category, time.time_ns())
        stack = self._stack()
        stack.append(span)
        stream = None
        if _cuda(device):
            stream = torch.cuda.current_stream(device)
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record(stream)
        try:
            yield span
        finally:
            if stream is not None:
                pair[1].record(stream)
                span.events = [pair]
            span.end_ns = time.time_ns()
            span.host_ns = span.end_ns - span.start_ns
            stack.pop()
            self._close(span, stack)

    def record(self, name: str, category: Optional[str], start_ns: int,
               end_ns: int, host_ns: Optional[int] = None,
               events: Optional[list] = None) -> Span:
        """Keep a span timed elsewhere, nested in the current one: host
        time ``host_ns`` (default end - start), device time over
        ``events`` (pairs of CUDA events)."""
        span = self._open(name, category, start_ns)
        span.end_ns = end_ns
        span.host_ns = end_ns - start_ns if host_ns is None else host_ns
        span.events = events or None
        self._close(span, self._stack())
        return span

    @contextlib.contextmanager
    def request(self, name: str, **meta):
        """An API call: a span of no category whose id numbers the spans
        and counters within it, and the moment the detail state is read;
        ``meta`` (what the call ran with) is kept on its span.  A call
        made inside another joins its request."""
        if self._current() is not None:
            with self.span(name) as span:
                span.meta = meta or None
                yield
            return
        req = _Request(next(self._request_ids), name, profiling())
        with self._mu:
            self._requests.append(req)
        self._tl.request = req
        try:
            with self.span(name) as span:
                span.meta = meta or None
                req.span = span
                yield
        finally:
            self._tl.request = None

    def annotate(self, **meta) -> None:
        """Add ``meta`` to the current request's span (what the call
        resolved as it ran); nothing outside a request."""
        req = self._current()
        if req is not None and req.span is not None:
            req.span.meta = {**(req.span.meta or {}), **meta}

    def detail(self) -> bool:
        """The current request's detail state (read at its start); outside
        a request, ``profiling()`` now."""
        req = self._current()
        return profiling() if req is None else req.detail

    def spans(self) -> List[Span]:
        """The kept spans, in the order they ended."""
        with self._mu:
            return list(self._spans)

    # -- counters ---------------------------------------------------------------
    def add(self, name: str, n: int = 1) -> None:
        """Count ``n`` under ``name``, process-wide and in the current
        request."""
        req = self._current()
        with self._mu:
            self._counts[name] = self._counts.get(name, 0) + n
            if req is not None:
                req.counts[name] = req.counts.get(name, 0) + n

    def add_lazy(self, name: str, tensor: torch.Tensor) -> None:
        """Count the sum of ``tensor`` in the current request when it is
        read (no device work now); nothing outside a request."""
        req = self._current()
        if req is not None:
            with self._mu:
                req.lazy.setdefault(name, []).append(tensor)

    def counter(self, name: str) -> int:
        """The process-wide count of ``name``."""
        return self._counts.get(name, 0)

    def reset_counter(self, name: str) -> None:
        with self._mu:
            self._counts.pop(name, None)

    def counters(self) -> Dict[int, Dict[str, int]]:
        """{request id: {name: count}} of the kept requests, the lazy
        counters summed now."""
        with self._mu:
            reqs = list(self._requests)
        out = {}
        for req in reqs:
            for name, parts in list(req.lazy.items()):
                req.counts[name] = req.counts.get(name, 0) + sum(
                    int(t.sum()) for t in parts)
                del req.lazy[name]
            out[req.id] = dict(req.counts)
        return out

    # -- the reference's reports --------------------------------------------------
    def category_time(self, category: str) -> float:
        with self._mu:
            self._settle()
            return self._totals.get(category, 0.0)

    def total_time(self) -> float:
        with self._mu:
            self._settle()
            return sum(self._totals.values())

    def summary(self) -> Dict[str, float]:
        with self._mu:
            self._settle()
            return {c: t for c, t in self._totals.items() if t > 0}

    def print_summary(self) -> None:
        print("=" * 52)
        print(f"{'Category':<20}{'Total (ms)':>14}{'Share':>10}")
        print("-" * 52)
        total = self.total_time()
        for cat in CATEGORIES:
            t = self.category_time(cat)
            if t > 0:
                share = 100.0 * t / total if total else 0.0
                print(f"{cat:<20}{t:>14.3f}{share:>9.1f}%")
        print("-" * 52)
        print(f"{'Total':<20}{total:>14.3f}")
        print("=" * 52)

    def print_detailed(self) -> None:
        """The kept spans in the order they ended: request, name, category,
        host ms and device ms; under a span with ``meta``, its items."""
        print("=" * 86)
        print(f"{'Req':>5}  {'Operation':<34}{'Category':<16}"
              f"{'host ms':>14}{'device ms':>14}")
        print("-" * 86)
        for s in self.spans():
            req = "" if s.request is None else s.request
            dev = "" if s.device_ms is None else f"{s.device_ms:.3f}"
            print(f"{req:>5}  {s.name:<34}{s.category or '':<16}"
                  f"{s.host_ms:>14.3f}{dev:>14}")
            for key, value in (s.meta or {}).items():
                print(f"{'':>7}{key}: {value}")
        print("=" * 86)


class Phases:
    """Per-phase time of a loop whose every step runs ``names`` in order,
    for detail: ``start()`` before a run of steps, ``mark()`` at the end of
    each phase (host time since the last mark; with a CUDA ``device`` an
    event on its current stream, from a pool of ``marks`` made here), and
    ``close()`` keeps one span a phase, its host time and event pairs
    summed over the steps, nested in the current span."""

    def __init__(self, names, device, marks: int):
        self.names = tuple(names)
        self.host = [0] * len(self.names)
        self.pairs = [[] for _ in self.names]
        self.stream = torch.cuda.current_stream(device) if _cuda(device) \
            else None
        self.pool = [torch.cuda.Event(enable_timing=True)
                     for _ in range(marks)] if self.stream is not None else []
        self.k = self.j = 0
        self.first_ns = self.t = None
        self.prev = None

    def _event(self):
        if self.k == len(self.pool):
            self.pool.append(torch.cuda.Event(enable_timing=True))
        ev = self.pool[self.k]
        self.k += 1
        ev.record(self.stream)
        return ev

    def start(self) -> None:
        self.t = time.time_ns()
        if self.first_ns is None:
            self.first_ns = self.t
        self.j = 0
        if self.stream is not None:
            self.prev = self._event()

    def mark(self) -> None:
        t = time.time_ns()
        self.host[self.j] += t - self.t
        self.t = t
        if self.stream is not None:
            ev = self._event()
            self.pairs[self.j].append((self.prev, ev))
            self.prev = ev
        self.j = (self.j + 1) % len(self.names)

    def close(self, mgr: TimerManager) -> None:
        if self.first_ns is None:
            return
        for name, host, pairs in zip(self.names, self.host, self.pairs):
            mgr.record(name, None, self.first_ns, self.t, host, pairs)


def wait(device) -> None:
    """Wait on the host for the work queued so far on ``device``'s current
    stream (an event's synchronize; nothing on the CPU)."""
    if _cuda(device):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


def timer(name: str, category: str = "Other", device=None):
    """TimerManager.instance().span(name, category, device)."""
    return TimerManager.instance().span(name, category, device)


def timed(name: str, category: str = "Other"):
    """Decorator: each call of the function is a span of ``timer``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with timer(name, category):
                return fn(*args, **kwargs)
        return spanned
    return wrap
