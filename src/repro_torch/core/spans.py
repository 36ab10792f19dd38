"""Spans of the serving path, on the clock the profiler stamps the device
with.

The engine (``serve.admit``, ``serve.prefill``, ``serve.pre_step``,
``serve.step``), the compile cache's executables (``exe.call``,
``exe.replay``, ``exe.capture``) and the cyclic garbage collector
(``py.gc``) record spans through the port's tracer, ``obs.trace.TRACER``,
while it is enabled. While it is not, a site costs one attribute read
(``TRACER.enabled``) and the collector's hook returns at once.

A span's start is Unix-epoch seconds (``time.time()``), the clock
``torch.profiler`` stamps its host and device events with, so a span lies
over a device trace as recorded; its duration is read from
``perf_counter``. A span goes to the tracer's cheapest path,
``Tracer.defer`` (one tuple append, made a span dict when the ring is
read), with its id drawn at its start so the spans opened inside it name
it as their parent; one opened in no other span of its thread starts a
trace of its own.

``py.gc`` records, under the span open in the thread that collected,
every generation-2 collection and any collection of ``GC_MIN_S`` or
more; a collection in no span of this module names no part of the
serving path and is not recorded.
"""
from __future__ import annotations

import functools
import gc
import os
import threading
import time
from typing import Callable, Optional

from repro_torch.obs import trace as _trace
from repro_torch.obs.trace import TRACER

__all__ = ["begin", "end", "traced", "GC_MIN_S"]

#: the shortest collection below generation 2 that is recorded
GC_MIN_S = 0.0005


class _Local(threading.local):
    open = None             # this thread's open span (``begin``'s state)
    gc = None               # (time.time(), perf_counter) of a collection


_tls = _Local()
# the process id, read once a process: ``os.getpid`` is a system call, and
# costs microseconds where system calls are trapped
_pid = os.getpid()


def _after_fork() -> None:
    global _pid
    _pid = os.getpid()


os.register_at_fork(after_in_child=_after_fork)


def _new_id(prefix: str = "") -> str:
    """An id as ``obs.trace.new_span_id`` draws it (``prefix`` "t": as
    ``new_trace_id`` does), from the tracer's own counter."""
    return "%s%x.%x" % (prefix, _pid, next(_trace._ids))


def _parent(open_) -> tuple:
    """(trace id, parent span id) of a span opened under ``open_``."""
    if open_ is None:
        return _new_id("t"), None
    return open_[1], open_[3]


def begin(name: str) -> tuple:
    """Open a span named ``name`` in this thread; pass what it returns to
    ``end``. Call only while ``TRACER.enabled``."""
    open_ = _tls.open
    trace_id, parent_id = _parent(open_)
    st = (name, trace_id, parent_id, _new_id(), time.time(),
          time.perf_counter(), open_)
    _tls.open = st
    return st


def end(st: tuple, **attrs) -> None:
    """Close the span ``begin`` opened and record it with ``attrs``. The
    thread's open span becomes the one it was opened under, so a span left
    open by an exception inside it is closed over."""
    dur = time.perf_counter() - st[5]
    _tls.open = st[6]
    TRACER.defer(st[0], (st[1], st[2]), st[4], dur, "", attrs or None,
                 st[3])


def traced(name: str, attrs: Optional[Callable] = None):
    """Decorate a method of positional arguments: while the tracer is
    enabled, each call is a span named ``name``, with the attributes
    ``attrs(self, result)`` (called after the method returns; ``result``
    is None where it raised)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(self, *args):
            if not TRACER.enabled:
                return fn(self, *args)
            st, out = begin(name), None
            try:
                out = fn(self, *args)
                return out
            finally:
                end(st, **(attrs(self, out) if attrs is not None else {}))
        return call
    return wrap


def _on_gc(phase: str, info: dict) -> None:
    if not TRACER.enabled or _tls.open is None:
        return
    if phase == "start":
        _tls.gc = (time.time(), time.perf_counter())
        return
    t, _tls.gc = _tls.gc, None
    if t is None:                     # enabled during the collection
        return
    dur = time.perf_counter() - t[1]
    gen = info.get("generation")
    if gen == 2 or dur >= GC_MIN_S:
        open_ = _tls.open
        TRACER.defer("py.gc", (open_[1], open_[3]), t[0], dur, "",
                     {"generation": gen}, _new_id())


if _on_gc not in gc.callbacks:
    gc.callbacks.append(_on_gc)
