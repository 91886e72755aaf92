"""The port's in-program spans: one recorder per process.

A span is one interval of work at a layer boundary: its ``name``,
``start_ns`` and ``end_ns`` on ``time.perf_counter_ns()`` (the host's
monotonic clock), the id of the span it ran inside (``parent``: the
innermost span open on the same thread), the ids of the requests it serves
(``requests``: given, or the parent's) and a few integer ``attrs``. A span
opened with the torch ``device`` its work runs on also records a pair of
``torch.cuda.Event`` on that device's current stream when the device is a
CUDA device; its ``device_ms`` (the stream's time from the first event to
the second) is read only once both have completed, when a later span opens
(``query()``, oldest first) or when the spans are read. Nothing here waits
for the device but ``Span.seconds``, a read after the work.
Without a CUDA device ``device_ms`` stays None.

Where they are (and the benchmark's readers, ``benchmark/metrics/``):
``server.queue``, ``server.collect``, ``server.run`` (``serve.py``), the
``pipeline.<stage>`` laps of ``StageClock`` (``utils/common.py``),
``model.call`` (``sampler/base.py``: every denoiser call), ``train.step``,
``train.forward``, ``train.backward``, ``train.optimizer``
(``train/stage1.py``, ``train/stage2.py``), ``train.data_wait`` and
``train.save`` (``train/loop.py`` and the trainers).

Closed spans go to a ring of the newest ``RING_SPANS`` in memory
(``snapshot()`` reads it, ``drain()`` empties it); nothing is written on
the hot path (``profile_step.py --trace`` writes them into its Chrome
trace, ``chrome_events``). On by default; ``DIFFBIR_TORCH_SPANS=0`` turns
the recorder off, after which each boundary costs one check of a module
flag. A caller that times its own work (``StageClock``, the trainers)
opens its spans whatever the switch says and keeps them itself
(``open_span``, ``span(into=)``); the ring holds them only while it is on.

``profiler_offset_ns`` maps this clock onto a ``torch.profiler`` timeline:
the offset is measured by bracketing CUDA runtime calls between two clock
reads while the profiler runs (``clock_marks``), not assumed.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

RING_SPANS = 1 << 16
_PENDING_MAX = 1 << 14   # device spans awaiting their events; older ones lose device_ms

_enabled = os.environ.get("DIFFBIR_TORCH_SPANS", "1") != "0"
_ids = itertools.count(1)
_ring: deque = deque(maxlen=RING_SPANS)
_pending: deque = deque()
_pool: List = []
_lock = threading.Lock()
_local = threading.local()


class Span:
    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "requests", "attrs",
                 "device_ms", "_events")

    def __init__(self, name, start_ns, parent, requests, attrs, events):
        self.id = next(_ids)
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.parent: Optional[int] = parent
        self.requests: Tuple[int, ...] = requests
        self.attrs: Dict[str, int] = attrs
        self.device_ms: Optional[float] = None
        self._events = events

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def seconds(self) -> Tuple[float, str]:
        """(seconds, "device"): the stream's time between the span's CUDA
        events, waiting for its end event where that has not completed (a
        read after the work, never on the hot path); else (seconds,
        "host"): its host time (no CUDA device, or the events dropped)."""
        if self._events is not None and self.end_ns is not None:
            self._events[1].synchronize()
            with _lock:
                if self._events is not None and _settle(self):
                    _pending.remove(self)
        if self.device_ms is not None:
            return self.device_ms / 1e3, "device"
        return self.host_ms / 1e3, "host"


def enabled() -> bool:
    return _enabled


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _event():
    import torch

    with _lock:
        if _pool:
            return _pool.pop()
    return torch.cuda.Event(enable_timing=True)


def _settle(sp: Span) -> bool:
    """(Under the lock) read ``sp``'s device time if its end event has
    completed, its events back to the pool."""
    start, end, _ = sp._events
    if not end.query():
        return False
    sp.device_ms = start.elapsed_time(end)
    sp._events = None
    _pool.extend((start, end))
    return True


def _resolve() -> None:
    """Read the device time of the oldest pending spans whose end event has
    completed (``query()``)."""
    if not _pending:
        return
    with _lock:
        while _pending and _settle(_pending[0]):
            _pending.popleft()


def _new(name, start_ns, requests, attrs, events) -> Span:
    """A span whose parent is this thread's innermost open span, serving
    ``requests`` or, where None, the parent's."""
    stack = _stack()
    parent = stack[-1] if stack else None
    if requests is not None:
        requests = tuple(requests)
    return Span(name, start_ns, parent.id if parent else None,
                requests if requests is not None else (parent.requests if parent else ()),
                attrs, events)


def open_span(name: Optional[str], device=None, push: bool = True,
              requests: Optional[Sequence[int]] = None, **attrs) -> Span:
    """A span started now, whether or not the recorder is on (``StageClock``
    needs its times for ``timings``); ``span`` is the switched form.
    ``device``: the torch device of the span's work; events on a CUDA one.
    ``push``: the span becomes the parent of the spans this thread opens
    until it ends."""
    _resolve()
    events = None
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch

        events = (_event(), _event(), device)
        events[0].record(torch.cuda.current_stream(device))
    sp = _new(name, time.perf_counter_ns(), requests, attrs, events)
    if push:
        _stack().append(sp)
    return sp


def close_span(sp: Span, name: Optional[str] = None) -> Span:
    """End ``sp`` now (renamed to ``name`` where given) and keep it in the
    ring while the recorder is on."""
    sp.end_ns = time.perf_counter_ns()
    if sp._events is not None:
        import torch

        sp._events[1].record(torch.cuda.current_stream(sp._events[2]))
        with _lock:
            _pending.append(sp)
            if len(_pending) > _PENDING_MAX:
                _pending.popleft()._events = None
    if name is not None:
        sp.name = name
    stack = _stack()
    if stack and stack[-1] is sp:
        stack.pop()
    elif sp in stack:
        stack.remove(sp)
    if _enabled:
        _ring.append(sp)
    return sp


def cancel(sp: Span) -> None:
    """Drop a span that was opened and never ended (its events back to the
    pool)."""
    stack = _stack()
    if sp in stack:
        stack.remove(sp)
    if sp._events is not None:
        with _lock:
            _pool.extend(sp._events[:2])
        sp._events = None


def record(name: str, start_ns: int, end_ns: int, requests: Optional[Sequence[int]] = None,
           **attrs) -> None:
    """A span measured elsewhere on this clock (host time only), as a child
    of this thread's innermost open span."""
    if not _enabled:
        return
    sp = _new(name, start_ns, requests, attrs, None)
    sp.end_ns = end_ns
    _ring.append(sp)


class _SpanContext:
    __slots__ = ("args", "into", "sp")

    def __init__(self, args, into):
        self.args, self.into = args, into
        self.sp = None

    def __enter__(self) -> Span:
        name, device, requests, attrs = self.args
        self.sp = open_span(name, device, True, requests, **attrs)
        return self.sp

    def __exit__(self, *exc) -> None:
        close_span(self.sp)
        if self.into is not None:
            self.into.append(self.sp)


_OFF = contextlib.nullcontext()


def span(name: str, device=None, requests: Optional[Sequence[int]] = None,
         into: Optional[List[Span]] = None, **attrs):
    """``with span(name[, device]) as sp:`` the block as one span (``sp`` is
    None while the recorder is off). ``into``: a list of the caller's own
    that gets the closed span, opened then whether or not the recorder is
    on."""
    if not _enabled and into is None:
        return _OFF
    return _SpanContext((name, device, requests, attrs), into)


def snapshot() -> List[Span]:
    """The ring's spans, oldest first (device times read where complete)."""
    _resolve()
    return list(_ring)


def drain() -> List[Span]:
    """``snapshot()``, then an empty ring."""
    _resolve()
    with _lock:
        out = list(_ring)
        _ring.clear()
    return out


# ---------------------------------------------------------------------------
# the recorder's clock against a torch.profiler timeline

MARK_KERNEL = "spin"
MARKS = 5


def clock_marks() -> List[Tuple[int, int]]:
    """While a ``torch.profiler`` with CUDA activity runs: ``MARKS`` launches of
    the device's sleep kernel (``torch.cuda._sleep``), each between two
    reads of this clock; [(before_ns, after_ns)] for
    ``profiler_offset_ns``."""
    import torch

    marks = []
    for _ in range(MARKS):
        t0 = time.perf_counter_ns()
        torch.cuda._sleep(1)
        t1 = time.perf_counter_ns()
        marks.append((t0, t1))
        time.sleep(0.0005)
    return marks


def profiler_offset_ns(prof, marks: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """(offset, uncertainty) in ns with ``profiler_ns = perf_counter_ns +
    offset``, on the absolute clock of the profiler's records
    (``_KinetoEvent.start_ns``, the Chrome trace's ``ts`` x 1000): the
    launches ``clock_marks`` bracketed are found by their sleep kernels'
    correlation ids with the runtime calls that launched them; each gives the
    offset of its runtime call's start within its bracket. The offset is
    the middle of the narrowest bracket of the estimates, and the
    uncertainty half that bracket. Raises where the profiler recorded no
    such launch."""
    events = prof.profiler.kineto_results.events()
    corr = {e.correlation_id() for e in events
            if MARK_KERNEL in e.name() and e.device_type().name == "CUDA"}
    launches = sorted(e.start_ns() for e in events
                      if e.device_type().name == "CPU" and e.correlation_id() in corr
                      and "Launch" in e.name())
    if len(launches) < len(marks):
        raise RuntimeError(f"the profiler recorded {len(launches)} of the {len(marks)} "
                           "marked launches")
    launches = launches[-len(marks):]
    lo = max(p - t1 for p, (_, t1) in zip(launches, marks))
    hi = min(p - t0 for p, (t0, _) in zip(launches, marks))
    if lo > hi:  # the marks disagree: the narrowest single bracket
        p, (t0, t1) = min(zip(launches, marks), key=lambda pm: pm[1][1] - pm[1][0])
        lo, hi = p - t1, p - t0
    return (lo + hi) // 2, (hi - lo + 1) // 2


def chrome_events(spans: Iterable[Span], offset_ns: int) -> List[dict]:
    """The spans as Chrome trace complete events ("ph": "X", "ts" and "dur"
    in microseconds) shifted by ``offset_ns`` onto the trace's clock, one
    row per layer (the first part of the name)."""
    out = []
    for s in spans:
        if s.end_ns is None:
            continue
        args = {"id": s.id, "parent": s.parent, "requests": list(s.requests), **s.attrs}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        out.append({"name": s.name, "ph": "X", "cat": "span", "pid": "spans", "tid": s.name.split(".")[0],
                    "ts": (s.start_ns + offset_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": args})
    return out
