"""The program's own spans over a window, laid over its device trace.

The port records spans of its serving path through its tracer,
``repro_torch.obs.trace.TRACER``, while the tracer is enabled
(``repro_torch.core.spans``): ``serve.admit``, ``serve.prefill``,
``serve.pre_step``, ``serve.step``, ``exe.call``, ``exe.replay``,
``exe.capture`` and ``py.gc``, each starting on the clock ``torch.profiler``
stamps device events with (Unix-epoch time). A ``--trace 1`` run enables
the tracer over its window and fails where the ring fills. ``window``
reads a window's spans; the readers below make per-layer numbers of them.
Each returns None where the window has none of what it reads or the
tracer's ring was full (it may have overwritten one of the window's
spans), and a reader against the device also where there is no trace or
it holds no device operation.

A decode cycle runs from the end of one ``serve.step`` to the end of the
next, when no ``serve.prefill`` starts inside it: the step's graph and
its tokens read back, the step's bookkeeping, the next iteration's
admission and page growth. An idle stretch of the card is named by the
innermost span over it: a program span, else the benchmark's own range
(``bench.*``), else ``host``.
"""
from __future__ import annotations

from bisect import bisect_right
from collections import namedtuple
from typing import Dict, List, Optional, Tuple

Span = namedtuple("Span", "name t0 t1 sid pid attrs")    # t0, t1 in ns


class Spans:
    """A window's spans, by start; ``parent(s)`` is ``s``'s parent span
    (None where it has none in the window)."""

    def __init__(self, items: List[Span]):
        self.items = sorted(items, key=lambda s: (s.t0, -s.t1))
        self.by_id = {s.sid: s for s in self.items}

    def named(self, name: str) -> List[Span]:
        return [s for s in self.items if s.name == name]

    def parent(self, s: Span) -> Optional[Span]:
        return self.by_id.get(s.pid)

    def under(self, name: str, parent: str) -> List[Span]:
        """The spans named ``name`` whose parent is named ``parent``."""
        return [s for s in self.named(name)
                if getattr(self.parent(s), "name", None) == parent]


def window(t0_ns: int, t1_ns: int, tracer=None) -> Optional[Spans]:
    """The spans of ``tracer`` (default the program's) that start in
    [t0_ns, t1_ns]; None when its ring is full."""
    if tracer is None:
        from repro_torch.obs.trace import TRACER as tracer
    recs = tracer.spans()
    if len(recs) >= tracer._ring.maxlen:
        return None
    items = []
    for r in recs:
        s = int(round(r["t0"] * 1e9))
        if t0_ns <= s <= t1_ns:
            items.append(Span(r["name"], s,
                              s + int(round(r["dur"] * 1e9)),
                              r["span_id"], r["parent_id"],
                              r.get("attrs") or {}))
    return Spans(items)


def _mean_ms(spans: List[Span]) -> Optional[float]:
    if not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) / len(spans) / 1e6


def step_calls(sp: Spans) -> List[Span]:
    """The executable calls of the decode steps."""
    return sp.under("exe.call", "serve.step")


def exe_call_ms_step(sp: Optional[Spans]) -> Optional[float]:
    """Mean host wall of a decode step's executable call."""
    return None if sp is None else _mean_ms(step_calls(sp))


def graph_launch_ms_step(sp: Optional[Spans]) -> Optional[float]:
    """Mean host wall of the ``graph.replay()`` inside those calls."""
    if sp is None:
        return None
    ids = {s.sid for s in step_calls(sp)}
    return _mean_ms([s for s in sp.named("exe.replay") if s.pid in ids])


def prefill_group_size(sp: Optional[Spans]) -> Optional[float]:
    """Mean requests a prefill dispatch places."""
    if sp is None:
        return None
    n = [s.attrs.get("requests", 0) for s in sp.named("serve.prefill")]
    return sum(n) / len(n) if n else None


def decode_cycles(sp: Spans, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The decode cycles that lie in [lo, hi] (ns)."""
    ends = sorted(s.t1 for s in sp.named("serve.step"))
    starts = sorted(s.t0 for s in sp.named("serve.prefill"))
    out = []
    for a, b in zip(ends, ends[1:]):
        if a < lo or b > hi:
            continue
        i = bisect_right(starts, a)
        if i < len(starts) and starts[i] <= b:
            continue
        out.append((a, b))
    return out


def _cycle_split(run, sp) -> Optional[List[Tuple[int, int]]]:
    """(busy ns, wall ns) of each decode cycle in the traced span."""
    t = run.trace
    if sp is None or t is None or not t.merged:
        return None
    cycles = decode_cycles(sp, t.t0, t.t1)
    if not cycles:
        return None
    starts = [m[0] for m in t.merged]
    out = []
    for a, b in cycles:
        busy = 0
        for s, e in t.merged[max(bisect_right(starts, a) - 1, 0):]:
            if s >= b:
                break
            busy += max(0, min(e, b) - max(s, a))
        out.append((busy, b - a))
    return out


def decode_busy_ms(run, sp: Optional[Spans]) -> Optional[float]:
    """Mean device-busy time in a decode cycle."""
    c = _cycle_split(run, sp)
    return None if c is None else sum(b for b, _ in c) / len(c) / 1e6


def decode_idle_ms(run, sp: Optional[Spans]) -> Optional[float]:
    """Mean device-idle time in a decode cycle: the host work the card
    waits on."""
    c = _cycle_split(run, sp)
    return None if c is None else sum(w - b for b, w in c) / len(c) / 1e6


def decode_cycle_ms(run, sp: Optional[Spans]) -> Optional[float]:
    """Mean wall of a decode cycle in the traced span."""
    c = _cycle_split(run, sp)
    return None if c is None else sum(w for _, w in c) / len(c) / 1e6


def readings(run, sp: Optional[Spans]) -> Dict[str, Optional[float]]:
    """The per-layer numbers the spans give (the device's against
    ``run.trace``; the program's over the whole window)."""
    return {"decode_busy_ms": decode_busy_ms(run, sp),
            "decode_idle_ms": decode_idle_ms(run, sp),
            "exe_call_ms.step": exe_call_ms_step(sp),
            "graph_launch_ms.step": graph_launch_ms_step(sp),
            "prefill_group_size": prefill_group_size(sp)}


# -- idle time by innermost span ------------------------------------------

def ranges(sp: Optional[Spans], trace) -> List[Tuple[str, int, int]]:
    """(name, start, end) of every range that can name an idle stretch:
    the program's spans and the benchmark's ``bench.*`` ranges."""
    out = list(trace.host)
    if sp is not None:
        out += [(s.name, s.t0, s.t1) for s in sp.items]
    return out


def innermost(rngs, lo: int, hi: int) -> List[Tuple[int, int, str]]:
    """(start, end, name) stretches that partition [lo, hi] by the
    innermost range over each (``host`` where none is). Ranges nest (one
    thread's); one that outlasts the range it started in is cut at that
    range's end."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []          # (end, name), outer first
    t = lo

    def emit(upto: int) -> None:
        nonlocal t
        upto = min(max(upto, lo), hi)
        if upto > t:
            segs.append((t, upto, stack[-1][1] if stack else "host"))
            t = upto

    for name, s, e in sorted(rngs, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        if stack:
            e = min(e, stack[-1][0])
        if e > s:
            stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(hi)
    return segs


def idle_stretches(trace) -> List[Tuple[int, int]]:
    """The card's idle stretches in the traced span, in order."""
    edges = [trace.t0] + [x for se in trace.merged for x in se] + [trace.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by_name(trace, segs) -> Dict[str, float]:
    """Idle seconds of the traced span by the name over them."""
    out: Dict[str, float] = {}
    j = 0
    for a, b in idle_stretches(trace):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, name = segs[k]
            ov = min(e, b) - max(s, a)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov / 1e9
            k += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def named_gaps(trace, segs, n: int = 10) -> list:
    """The ``n`` longest idle stretches, each named by the stretch over its
    middle: ``Trace.idle_gaps`` with program spans."""
    gaps = sorted(idle_stretches(trace), key=lambda g: g[0] - g[1])[:n]
    starts = [s for s, _, _ in segs]
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect_right(starts, mid) - 1
        name = segs[i][2] if 0 <= i and segs[i][1] >= mid else "host"
        out.append([name, (e - s) / 1e9])
    return out


def program_share(by_name: Dict[str, float]) -> Optional[float]:
    """The share of idle time under a program span, in percent."""
    total = sum(by_name.values())
    if total <= 0:
        return None
    mine = sum(v for k, v in by_name.items()
               if k != "host" and not k.startswith("bench."))
    return 100.0 * mine / total
