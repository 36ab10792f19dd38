"""Fabric-wide tracing: lightweight spans in a bounded ring buffer.

A span is a plain record — ``trace_id``/``span_id``/``parent_id``, a name,
a wall-clock start (``time.time()``, comparable across processes to clock
sync) and a duration. Spans are recorded *on finish* into a bounded ring,
so a long-running scheduler keeps the most recent forensics without
unbounded growth.

Trace context crosses the wire as a two-tuple ``(trace_id, span_id)``
under the ``"tc"`` key of SUBMIT/STAGE frame payloads. The node side
never needs a Tracer: it ships compact ``(name, t0, dur, attrs)`` tuples
back inside the RESULT frame and the scheduler parks them with
:meth:`Tracer.defer_result` — one deque append on the pump thread; the
expansion to full spans parented under the propagated span id happens at
:meth:`Tracer.spans` read time. One wave, one tree, and the
latency-critical threads never build a dict or take a lock.

Export: :meth:`Tracer.chrome_trace` produces Chrome-trace/Perfetto JSON
("traceEvents" with complete events + thread-name metadata);
:func:`flame_summary` renders the parent/child tree as indented text.
``python -m repro_torch.obs.report trace.json`` does both from a saved file.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Span", "Tracer", "TRACER", "new_span_id", "new_trace_id",
    "make_span", "flame_summary",
]

_ids = itertools.count(1)


def new_span_id() -> str:
    """Process-unique hex span id (pid salt + local counter)."""
    return "%x.%x" % (os.getpid(), next(_ids))


def new_trace_id() -> str:
    return "t%x.%x" % (os.getpid(), next(_ids))


def make_span(name: str, trace_id: str, parent_id: Optional[str],
              t0: float, dur: float, where: str = "",
              attrs: Optional[dict] = None,
              span_id: Optional[str] = None) -> dict:
    """Build a finished span dict without a Tracer (node-side helper)."""
    return {
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id or new_span_id(),
        "parent_id": parent_id,
        "t0": t0,
        "dur": dur,
        "where": where,
        "attrs": attrs or {},
    }


class Span:
    """In-flight span; finished spans live in the ring as plain dicts."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "_pc0",
                 "where", "attrs", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], where: str,
                 attrs: Optional[dict]) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.where = where
        self.attrs = dict(attrs) if attrs else {}
        self.t0 = time.time()
        self._pc0 = time.perf_counter()

    def context(self) -> Tuple[str, str]:
        """Wire form: ``(trace_id, span_id)`` — what frames carry."""
        return (self.trace_id, self.span_id)

    def finish(self, **attrs: Any) -> dict:
        if attrs:
            self.attrs.update(attrs)
        rec = make_span(self.name, self.trace_id, self.parent_id, self.t0,
                        time.perf_counter() - self._pc0, self.where,
                        self.attrs, span_id=self.span_id)
        self._tracer.record(rec)
        return rec


class _SpanCtx:
    __slots__ = ("span",)

    def __init__(self, span: Optional[Span]) -> None:
        self.span = span

    def __enter__(self) -> Optional[Span]:
        return self.span

    def __exit__(self, *exc: Any) -> None:
        if self.span is not None:
            self.span._tracer.finish(self.span)


class Tracer:
    """Ring-buffered span recorder with a per-thread current-span stack.

    ``enabled`` is a plain attribute; every instrumentation site guards on
    it before doing any work, so the disabled cost is one attribute read.
    """

    def __init__(self, capacity: int = 16384, enabled: bool = False) -> None:
        self.enabled = enabled
        self._ring: deque = deque(maxlen=capacity)
        # latency-critical threads (the frame pump, node workers' RESULT
        # path) never build span dicts: they append compact tuples here
        # and the expansion to full spans happens at read time
        self._pending: deque = deque()
        self._tls = threading.local()
        self._lock = threading.Lock()

    # -- lifecycle --------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> None:
        if capacity is not None and capacity != self._ring.maxlen:
            with self._lock:
                self._ring = deque(self._ring, maxlen=capacity)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pending.clear()

    # -- span creation ----------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def context(self) -> Optional[Tuple[str, str]]:
        """Current thread's (trace_id, span_id), or None — the value that
        goes into a frame's ``"tc"`` field."""
        cur = self.current()
        return cur.context() if cur is not None else None

    def start(self, name: str, parent: Any = None, where: str = "",
              attrs: Optional[dict] = None, push: bool = False,
              ) -> Optional[Span]:
        """Start a span. ``parent`` may be a Span, a (trace_id, span_id)
        tuple (wire context), or None (inherit this thread's current span,
        else start a new trace). Returns None when disabled."""
        if not self.enabled:
            return None
        if parent is None:
            parent = self.current()
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif parent:
            trace_id, parent_id = parent[0], parent[1]
        else:
            trace_id, parent_id = new_trace_id(), None
        span = Span(self, name, trace_id, parent_id, where, attrs)
        if push:
            self._stack().append(span)
        return span

    def finish(self, span: Optional[Span], **attrs: Any) -> None:
        if span is None:
            return
        st = getattr(self._tls, "stack", None)
        if st and st[-1] is span:
            st.pop()
        span.finish(**attrs)

    def span(self, name: str, parent: Any = None, where: str = "",
             attrs: Optional[dict] = None) -> _SpanCtx:
        """Context manager; the span becomes this thread's current span."""
        return _SpanCtx(self.start(name, parent, where, attrs, push=True)
                        if self.enabled else None)

    # -- recording / ingest ----------------------------------------------
    # deque.append/extend/popleft are atomic under the GIL: the recording
    # paths take no lock — on a thread-hosted fleet every lock round-trip
    # on the pump or a worker thread is a GIL handoff on the wave's
    # critical path, amplified far beyond its raw cost.

    def record(self, rec: dict) -> None:
        self._ring.append(rec)

    def ingest(self, recs: Iterable[dict]) -> None:
        """Merge remote (node-side) finished span dicts into the ring."""
        self._ring.extend(recs)

    def defer(self, name: str, ctx: Tuple[str, Optional[str]], t0: float,
              dur: float, where: str, attrs: Optional[dict],
              sid: Optional[str] = None) -> None:
        """Hot-path recording: one tuple append now; the span dict is
        built lazily when the ring is read. ``ctx`` is (trace_id,
        parent_id). Pass ``sid`` when the span's id was allocated up
        front (because children already reference it)."""
        self._pending.append((name, ctx, t0, dur, where, attrs, sid))

    def defer_result(self, ctx: Tuple[str, str], where: str,
                     compact: list) -> None:
        """A RESULT frame's compact node-side spans — a list of
        ``(name, t0, dur, attrs)`` — parked for lazy expansion under the
        shard's propagated context."""
        self._pending.append((ctx, where, compact))

    def _drain_pending(self) -> None:
        while True:
            try:
                item = self._pending.popleft()
            except IndexError:
                return
            if isinstance(item[0], str):
                name, ctx, t0, dur, where, attrs, sid = item
                self._ring.append(
                    make_span(name, ctx[0], ctx[1], t0, dur, where, attrs,
                              span_id=sid))
            else:
                ctx, where, compact = item
                for name, t0, dur, attrs in compact:
                    self._ring.append(
                        make_span(name, ctx[0], ctx[1], t0, dur, where,
                                  attrs))

    # -- export -----------------------------------------------------------

    def spans(self, trace_id: Optional[str] = None) -> List[dict]:
        self._drain_pending()
        out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s.get("trace_id") == trace_id]
        return out

    def chrome_trace(self, trace_id: Optional[str] = None) -> dict:
        return chrome_trace(self.spans(trace_id))

    def export_json(self, path: str,
                    trace_id: Optional[str] = None) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(trace_id), f)
        return path


#: Process-global tracer (scheduler side).
TRACER = Tracer()


# -- export helpers (module-level so report.py works on saved files) ------

def chrome_trace(spans: List[dict]) -> dict:
    """Chrome-trace JSON ("traceEvents") from finished span dicts.

    Each span becomes a complete ("ph": "X") event; ``where`` labels map
    to tids with thread_name metadata so Perfetto shows scheduler / pump /
    node lanes. span_id/parent_id ride in args for tree reconstruction.

    A parent_id is only emitted when the parent span is IN this export:
    the ring buffer overwrites oldest-first, so a long run's early roots
    are gone while their late descendants remain — exporting the dangling
    reference would leave every consumer re-deriving "orphan == root".
    Dropping it makes the wrapped survivor an explicit root instead.
    """
    tids: Dict[str, int] = {}
    events: List[dict] = []
    ids = {s.get("span_id") for s in spans if s.get("span_id")}
    for s in spans:
        where = s.get("where") or "main"
        tid = tids.setdefault(where, len(tids) + 1)
        args = dict(s.get("attrs") or {})
        args["span_id"] = s.get("span_id")
        if s.get("parent_id") in ids:
            args["parent_id"] = s["parent_id"]
        args["trace_id"] = s.get("trace_id")
        events.append({
            "name": s.get("name", "?"),
            "ph": "X",
            "ts": s.get("t0", 0.0) * 1e6,
            "dur": max(s.get("dur", 0.0), 1e-7) * 1e6,
            "pid": 1,
            "tid": tid,
            "cat": "fabric",
            "args": args,
        })
    for where, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": where}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def spans_from_chrome(doc: dict) -> List[dict]:
    """Invert chrome_trace(): recover span dicts from a saved trace file."""
    out = []
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args") or {})
        out.append({
            "name": ev.get("name", "?"),
            "trace_id": args.pop("trace_id", None),
            "span_id": args.pop("span_id", None),
            "parent_id": args.pop("parent_id", None),
            "t0": ev.get("ts", 0.0) / 1e6,
            "dur": ev.get("dur", 0.0) / 1e6,
            "where": "",
            "attrs": args,
        })
    return out


def span_tree(spans: List[dict]) -> Tuple[List[dict], Dict[str, List[dict]]]:
    """(roots, children-by-parent-span-id); orphans count as roots."""
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in spans:
        pid = s.get("parent_id")
        if pid and pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s.get("t0", 0.0))
    roots.sort(key=lambda s: s.get("t0", 0.0))
    return roots, children


def flame_summary(spans: List[dict], max_children: int = 8) -> str:
    """Indented text rendering of the span tree with durations; sibling
    spans sharing a name collapse into one aggregated line."""
    roots, children = span_tree(spans)
    lines: List[str] = []

    def emit(group: List[dict], depth: int) -> None:
        by_name: Dict[str, List[dict]] = {}
        for s in group:
            by_name.setdefault(s.get("name", "?"), []).append(s)
        shown = 0
        for name, ss in sorted(by_name.items(),
                               key=lambda kv: -sum(s.get("dur", 0.0)
                                                   for s in kv[1])):
            if shown >= max_children:
                lines.append("  " * depth + f"... {len(by_name) - shown} "
                             "more span name(s)")
                break
            shown += 1
            total = sum(s.get("dur", 0.0) for s in ss)
            label = "  " * depth + name
            if len(ss) == 1:
                lines.append(f"{label}  {total * 1e3:.3f} ms")
            else:
                mx = max(s.get("dur", 0.0) for s in ss)
                lines.append(f"{label}  x{len(ss)}  total {total * 1e3:.3f} "
                             f"ms  max {mx * 1e3:.3f} ms")
            kids: List[dict] = []
            for s in ss:
                kids.extend(children.get(s.get("span_id"), ()))
            if kids:
                emit(kids, depth + 1)

    emit(roots, 0)
    return "\n".join(lines)
