"""The port's spans and counters, and the render loop's paths/s meter.

The reference's observability is Instant timers and indicatif bars
(SURVEY.md section 5). The JAX package's `raytrace_tpu/utils/profiling.py`
adds wall-clock phases and a jax.profiler trace; here one recorder puts
spans at the port's layer boundaries instead, and `Throughput` keeps the
tqdm bar's Mpaths/s.

The recorder is off by default: `span()` then returns one shared no-op
context after a single flag check, and `count()` returns at once. With
`enable(True)`:

- `span(name, **attrs)` records a span: its name, its start and end in
  ns on `time.time_ns()` (the clock torch.profiler stamps its host
  events on, so spans lie directly over a device trace), the index of
  its parent span (per thread: a writer thread's spans nest on their
  own), the id of the `call` it belongs to, and its attrs;
- `call(name, **attrs)` is a span that opens a new call (one
  `Renderer.render`): it and every span opened while it is open, on any
  thread, carry its id;
- `interval(name, start, end)` records a span the caller timed itself;
- `count(name, n)` adds to a counter; `counters()` returns them (those
  of FALLBACKS at 0 before their first count) with the kernels' launch
  counts (`ops/trace_kernel.py`, `ops/mesh_kernel.py` and
  `ops/bounce_kernel.py`'s LAUNCHES, read where they are) as
  `launches.<entry>`.

Records stay in memory until `reset()`, as tuples the garbage
collector stops tracking; `records()` gives them as `Record`s and
`export(path)` writes them as Chrome trace events (chrome://tracing,
Perfetto), with the counters.
Nothing inside a captured CUDA graph is spanned: a graph keeps only
device work, so a host span there would run once, at the capture.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

_on = False
_spans: dict = {}  # id -> (name, parent id, call, thread, attrs, start ns), ids in opening order
_ends: dict = {}  # id -> end ns
_counts: dict = {}
_ids = itertools.count()
_local = threading.local()  # each thread's stack of open span ids, and its ident
_calls = itertools.count()
_call = None  # the open call's id
# counters of fallback paths, 0 rather than missing while the recorder is on: target.syncs,
# the render target's device sum brought to the host (render/target.py)
FALLBACKS = ("target.syncs",)


def enable(on: bool = True) -> None:
    """Switch the recorder on or off (records and counters are kept)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _stack() -> list:
    """This thread's stack of open span ids."""
    try:
        return _local.stack
    except AttributeError:
        _local.tid = threading.get_ident()
        stack = _local.stack = []
        return stack


class _Span:
    """The context of a span. It records a flat tuple of strings, ints
    and the attrs' keys and values, which the garbage collector stops
    tracking (a dict or a tuple of pairs inside would keep it tracked): a
    long run's records add nothing to its full collections. The open
    span's id lives on the thread's stack, so one context serves every
    span of a name without attrs."""

    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        i = next(_ids)
        _spans[i] = (self.name, stack[-1] if stack else None, _call, _local.tid,
                     sum(self.attrs.items(), ()) if self.attrs else (), time.time_ns())
        stack.append(i)
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        _ends[_local.stack.pop()] = end
        return False


class _Call(_Span):
    __slots__ = ("prev",)

    def __enter__(self):
        global _call
        self.prev, _call = _call, next(_calls)
        return super().__enter__()

    def __exit__(self, *exc):
        global _call
        super().__exit__()
        _call = self.prev
        return False


_NAMED: dict = {}  # name -> the context of its spans without attrs


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, /, **attrs):
    """A context that records the span `name` (with attrs) when the
    recorder is on, and the shared no-op context when it is off."""
    if not _on:
        return _OFF
    if attrs:
        return _Span(name, attrs)
    ctx = _NAMED.get(name)
    if ctx is None:
        ctx = _NAMED[name] = _Span(name, {})
    return ctx


def call(name: str, /, **attrs):
    """`span`, opening a new call id for itself and every span opened
    while it is open."""
    if not _on:
        return _OFF
    return _Call(name, attrs)


def interval(name: str, start: int, end: int, /, **attrs) -> None:
    """Record the finished span `name` from start to end (ns,
    time.time_ns), inside the span open on this thread, when the recorder
    is on: for a time the caller takes whether the recorder is on or not."""
    if _on:
        stack = _stack()
        i = next(_ids)
        _spans[i] = (name, stack[-1] if stack else None, _call, _local.tid,
                     sum(attrs.items(), ()), start)
        _ends[i] = end


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (only while the recorder is on)."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """The counters, and each kernel entry's launches as
    `launches.<entry>` (read from the LAUNCHES dicts of ops/, which count
    whether the recorder is on or not). While the recorder is on, the
    counters of FALLBACKS read 0 until their first count."""
    from ..ops import bounce_kernel, mesh_kernel, trace_kernel

    out = dict.fromkeys(FALLBACKS, 0) if _on else {}
    out.update(_counts)
    for mod in (trace_kernel, mesh_kernel, bounce_kernel):
        out.update((f"launches.{k}", n) for k, n in mod.LAUNCHES.items())
    return out


class Record:
    """One span as records() gives it: name, start / end (ns,
    time.time_ns; end None while it is open), parent (the index in
    records() of the span open on its thread when it began, None at a
    thread's top), call (the open call's id, None outside calls), tid
    (the thread's ident), attrs, index (its own place in records()) and
    children (the records opened directly inside it)."""

    __slots__ = ("index", "name", "start", "end", "parent", "call", "tid", "attrs", "children")

    def __init__(self, index, name, parent, call, tid, attrs, start, end):
        self.index, self.name, self.parent, self.call = index, name, parent, call
        self.tid, self.attrs, self.start, self.end = tid, attrs, start, end
        self.children = []


def records() -> list:
    """Every span recorded since the last reset(), in the order opened."""
    ids = sorted(_spans)
    pos = {i: n for n, i in enumerate(ids)}
    out = []
    for n, i in enumerate(ids):
        name, parent, call_id, tid, attrs, start = _spans[i]
        out.append(Record(n, name, pos.get(parent), call_id, tid,
                          dict(zip(attrs[::2], attrs[1::2])), start, _ends.get(i)))
    for r in out:
        if r.parent is not None:
            out[r.parent].children.append(r)
    return out


def reset() -> None:
    """Drop the records and the counters (the kernels' launch counts are
    their modules')."""
    _spans.clear()
    _ends.clear()
    _counts.clear()


def self_ns(record: Record) -> int:
    """The span's duration less the part of it that its children cover."""
    covered, last = 0, record.start
    for c in sorted(record.children, key=lambda c: c.start):
        s, e = max(c.start, last), min(c.end, record.end)
        if e > s:
            covered += e - s
            last = e
    return record.end - record.start - covered


def export(path: str) -> None:
    """Write the finished spans as Chrome trace events ("X", ts and dur in
    us on time.time_ns's scale; args: the attrs, call and parent) and the
    counters (under "counters") to the JSON file `path`."""
    pid = os.getpid()
    events = [dict(name=r.name, ph="X", ts=r.start / 1e3, dur=(r.end - r.start) / 1e3, pid=pid,
                   tid=r.tid, args=dict(r.attrs, call=r.call, parent=r.parent, index=r.index))
              for r in records() if r.end is not None]
    with open(path, "w") as f:
        json.dump(dict(traceEvents=events, displayTimeUnit="ms", counters=counters()), f)


class Throughput:
    """Paths/s meter for render loops."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.paths = 0

    def add(self, n_paths: int):
        self.paths += n_paths

    @property
    def mpaths_per_s(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.paths / dt / 1e6 if dt > 0 else 0.0
