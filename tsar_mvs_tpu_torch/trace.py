"""The port's tracer: spans and counters, one registry for the process.

Counters are always on. ``count(name)`` adds to a named counter (one dict
add), ``count(name, key)`` to a counter kept by key (a launch's shape);
``counter(name)`` and ``by_key(name)`` read them, ``clear(*names)`` drops
some. The names: ``launches.b1`` ... ``launches.b6`` (each kernel's
calls, B5 once a view however many CUDA launches it makes),
``launches_by_shape.b1`` ... ``launches_by_shape.b6``,
``launches_by_instance.b3``, ``halfpass.plain_calls`` (the plain
half-pass's calls: 0 on the card), ``ransac.views_without_regions``
(views that fit no region plane, so that B5 did not launch),
``launches.b7`` (B7's CUDA launches, every one counted),
``weak_texture.plain_calls`` (the plain weak-texture detection's calls: 0
on the card), ``weak_texture.segments`` (Hough segments drawn, on either
path) and, while spans record, ``host_syncs``.

Spans record only while tracing is on: between ``on()`` and ``off()``, or
while ``torch.profiler`` records, so that a profiled window carries the
program's own spans. Off, ``span()`` returns one shared no-op context
(``NOOP``): no span object, no record, no CUDA event, no
synchronisation. On, ``with span(name, **attrs):`` records the
span's name, its parent, the ``view`` span it belongs to, its attributes,
its host start and end on the profiler's clock (``now_us``) and its
seconds: once CUDA is initialised, between two CUDA events recorded on
the current stream at its ends (the device's timeline: the device work
queued inside the span and the host time the device waited for), read
after the work by ``collect()``; before that from ``perf_counter``.
Spans stay in memory until ``reset()``; nothing is written while a view
runs. ``stage(name, timer)`` is a span that calls ``timer(name)`` when it
ends without an exception (``process_view``'s stage marks).

Host synchronisations: while a span is open and CUDA is initialised,
every synchronisation of the host with the card adds to ``host_syncs``
and to the innermost open span's ``syncs``: the tensor routes
(``.cpu()``, ``.item()``, ``.tolist()``, ``bool()``, ``float()``,
``nonzero``, boolean indexing, copies to or from pageable memory,
``Stream.synchronize``, ...) through torch's sync debug mode, whose
warnings are caught here, and ``torch.cuda.synchronize`` and
``Event.synchronize``, which that mode does not see, through wrappers
installed for as long as the outermost span is open.
"""

from __future__ import annotations

import time
import warnings
from collections import Counter

import torch
import torch.autograd.profiler as _profiler

# The message of torch's sync debug mode ("warn").
SYNC_WARNING = "called a synchronizing CUDA operation"


def now_us() -> float:
    """The host's instant in the time base of the profiler's events
    (``_KinetoEvent.start_ns()``): microseconds since the epoch, the
    realtime clock that torch's profiler converts its device timestamps
    to (on the card a span around a kernel holds the kernel's profiler
    interval: tests/test_torch_trace.py)."""
    return time.time_ns() / 1e3


class _Noop:
    """The shared context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Mark:
    """A stage while tracing is off: only the timer's call at its end."""

    __slots__ = ("name", "timer")

    def __init__(self, name: str, timer):
        self.name, self.timer = name, timer

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.timer(self.name)
        return False


class _Span:
    __slots__ = ("id", "name", "attrs", "timer", "parent", "view",
                 "start_us", "end_us", "ev", "p", "syncs")

    def __init__(self, name: str, attrs: dict, timer=None):
        self.name, self.attrs, self.timer = name, attrs, timer
        self.end_us = None
        self.syncs = 0

    def __enter__(self):
        _T.open(self)
        return self

    def __exit__(self, exc_type, *exc):
        _T.close(self)
        if self.timer is not None and exc_type is None:
            self.timer(self.name)
        return False


class _Tracer:
    def __init__(self):
        self.forced = False
        self.counts: Counter = Counter()
        self.spans: list[_Span] = []
        self.stack: list[_Span] = []
        self.next_id = 0
        self.syncing = None

    def open(self, s: _Span) -> None:
        s.id = self.next_id
        self.next_id += 1
        parent = self.stack[-1] if self.stack else None
        s.parent = parent.id if parent is not None else None
        s.view = s.id if s.name == "view" else (
            parent.view if parent is not None else None)
        if not self.stack and torch.cuda.is_initialized():
            self._count_syncs()
        self.stack.append(s)
        self.spans.append(s)
        s.start_us = now_us()
        if torch.cuda.is_initialized():
            s.ev = [torch.cuda.Event(enable_timing=True), None]
            s.ev[0].record()
            s.p = None
        else:
            s.ev = None
            s.p = [time.perf_counter(), None]

    def close(self, s: _Span) -> None:
        if s.ev is not None:
            s.ev[1] = torch.cuda.Event(enable_timing=True)
            s.ev[1].record()
        else:
            s.p[1] = time.perf_counter()
        s.end_us = now_us()
        self.stack.pop()
        if not self.stack and self.syncing is not None:
            self._stop_syncs()

    # Host synchronisations, while the outermost span is open.
    def _count_syncs(self) -> None:
        caught = warnings.catch_warnings()
        caught.__enter__()
        warnings.filterwarnings("ignore", message="Synchronization debug "
                                "mode is a prototype")
        warnings.filterwarnings("always", message=SYNC_WARNING)
        show = warnings.showwarning

        def showwarning(message, category, filename, lineno, file=None,
                        line=None):
            if str(message).startswith(SYNC_WARNING):
                self.sync()
            else:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = showwarning
        sync, ev_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize

        def synchronize(*args, **kwargs):
            self.sync()
            return sync(*args, **kwargs)

        def event_synchronize(ev):
            self.sync()
            return ev_sync(ev)

        torch.cuda.synchronize = synchronize
        torch.cuda.Event.synchronize = event_synchronize
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        self.syncing = (caught, sync, ev_sync, mode)

    def _stop_syncs(self) -> None:
        caught, sync, ev_sync, mode = self.syncing
        self.syncing = None
        torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize = sync
        torch.cuda.Event.synchronize = ev_sync
        caught.__exit__(None, None, None)

    def sync(self) -> None:
        self.counts["host_syncs"] += 1
        if self.stack:
            self.stack[-1].syncs += 1


_T = _Tracer()


def on() -> None:
    """Record spans from now until `off()`."""
    _T.forced = True


def off() -> None:
    """Stop recording spans (unless torch.profiler records)."""
    _T.forced = False


def enabled() -> bool:
    """Whether spans record: after `on()`, or while torch.profiler
    records."""
    return _T.forced or _profiler._is_profiler_enabled


def span(name: str, **attrs):
    """A span named `name` with attributes `attrs` while tracing is on;
    the shared no-op context otherwise."""
    if not (_T.forced or _profiler._is_profiler_enabled):
        return NOOP
    return _Span(name, attrs)


def stage(name: str, timer=None):
    """A span that calls `timer(name)`, when given, as it ends without an
    exception, whether tracing is on or off."""
    if _T.forced or _profiler._is_profiler_enabled:
        return _Span(name, {}, timer)
    return NOOP if timer is None else _Mark(name, timer)


def count(name: str, key=None, n: int = 1) -> None:
    """Add `n` to counter `name`, or to its entry `key`."""
    _T.counts[name if key is None else (name, key)] += n


def counter(name: str) -> int:
    return _T.counts.get(name, 0)


def by_key(name: str) -> dict:
    """Counter `name`'s entries by key."""
    return {k[1]: n for k, n in _T.counts.items()
            if isinstance(k, tuple) and k[0] == name}


def clear(*names: str) -> None:
    """Drop the named counters and their entries by key."""
    drop = set(names)
    for k in [k for k in _T.counts if (k[0] if isinstance(k, tuple)
                                       else k) in drop]:
        del _T.counts[k]


def reset() -> None:
    """Drop every span and every counter."""
    _T.spans.clear()
    _T.counts.clear()


def collect() -> dict:
    """The spans that ended since the last reset, in the order they began,
    and the counters kept by name. Each span: `id`, `name`, `parent` (its
    id), `view` (the id of the view span it belongs to), `start_us` and
    `end_us` (host, the profiler's clock), `seconds` (device timeline on
    the card), `self_s` (seconds less its children's), `syncs` (host
    synchronisations in it and not in a child) and `attrs`. Waits for
    the device to finish the spans' work."""
    done = [s for s in _T.spans if s.end_us is not None]
    if any(s.ev is not None for s in done):
        torch.cuda.synchronize()
    out, child_s = [], {}
    for s in done:
        sec = (s.ev[0].elapsed_time(s.ev[1]) / 1e3 if s.ev is not None
               else s.p[1] - s.p[0])
        if s.parent is not None:
            child_s[s.parent] = child_s.get(s.parent, 0.0) + sec
        out.append({"id": s.id, "name": s.name, "parent": s.parent,
                    "view": s.view, "start_us": s.start_us,
                    "end_us": s.end_us, "seconds": sec, "syncs": s.syncs,
                    "attrs": dict(s.attrs)})
    for rec in out:
        rec["self_s"] = rec["seconds"] - child_s.get(rec["id"], 0.0)
    return {"spans": out,
            "counters": {k: n for k, n in _T.counts.items()
                         if isinstance(k, str)}}
