"""The readers of the program's own spans (``benchkit.spans``) and the tool
that runs a cell with them (``trace_spans.py``), on the CPU.

* A hand-made trace and hand-made spans read known decode-cycle busy and
  idle times, known executable and graph-launch walls and group sizes,
  and name each idle gap by the innermost span over its middle.
* With no program spans the gaps are named exactly as the benchmark's
  own breakdown names them (``Trace.idle_gaps``).
* A tracer whose ring was full makes every reader return None.
* A smoke cell run by the tool, tracer on, reads an executable call and
  a group size above 0 (no device numbers on the CPU).
* The benchmark's ``--trace 0`` runs never enable the tracer; its
  ``--trace 1`` runs enable it over the window alone, read
  ``prefill_useful_share`` from the window's ``serve.prefill`` spans,
  leave the tracer disabled and empty, and fail where the spans do not
  cover the window.
"""
import time

import pytest

import run as R
import trace_spans as T
from benchkit import specs
from benchkit import spans as S
from benchkit.profiling import Trace
from repro_torch.obs.trace import TRACER, Tracer

MS = 1_000_000


def _span(name, t0, t1, sid, pid=None, **attrs):
    return S.Span(name, t0 * MS, t1 * MS, sid, pid, attrs)


def _synthetic():
    """Three decode steps of 10 ms, the card busy 4 ms at the start of
    each (the graph) and idle over the rest; a prefill between the second
    and the third."""
    sp = S.Spans([
        _span("serve.step", 1, 11, "s1"),
        _span("exe.call", 1, 3, "c1", "s1"),
        _span("exe.replay", 2, 3, "r1", "c1"),
        _span("serve.pre_step", 11, 12, "p2"),
        _span("serve.step", 12, 21, "s2"),
        _span("exe.call", 12, 15, "c2", "s2"),
        _span("exe.replay", 13, 14, "r2", "c2"),
        _span("py.gc", 18, 20, "g2", "s2", generation=2),
        _span("serve.admit", 22, 30, "a3", placed=2),
        _span("serve.prefill", 23, 29, "f3", "a3", requests=2),
        _span("exe.call", 23, 25, "c3", "f3"),
        _span("serve.step", 31, 40, "s3"),
        _span("exe.call", 31, 34, "c4", "s3"),
        _span("exe.replay", 32, 33, "r4", "c4"),
    ])
    device = [("k", 3 * MS, 7 * MS), ("k", 14 * MS, 18 * MS),
              ("k", 25 * MS, 28 * MS), ("k", 33 * MS, 37 * MS)]
    host = [("bench.step", 0, 11 * MS), ("bench.admit", 21 * MS, 31 * MS)]
    return sp, Trace(device, host, 0, 40 * MS)


def _run(trace):
    return type("Run", (), {"trace": trace})()


def test_readers_on_a_synthetic_trace():
    sp, tr = _synthetic()
    # one cycle (11, 21]: the next starts a prefill; busy 14-18 ms
    assert S.decode_cycles(sp, tr.t0, tr.t1) == [(11 * MS, 21 * MS)]
    got = S.readings(_run(tr), sp)
    assert got["decode_busy_ms"] == pytest.approx(4.0)
    assert got["decode_idle_ms"] == pytest.approx(6.0)
    assert S.decode_cycle_ms(_run(tr), sp) == pytest.approx(10.0)
    assert got["exe_call_ms.step"] == pytest.approx((2 + 3 + 3) / 3)
    assert got["graph_launch_ms.step"] == pytest.approx(1.0)
    assert got["prefill_group_size"] == pytest.approx(2.0)


def test_gaps_named_by_the_innermost_span():
    sp, tr = _synthetic()
    segs = S.innermost(S.ranges(sp, tr), tr.t0, tr.t1)
    # the stretches partition the span, in order
    assert segs[0][0] == tr.t0 and segs[-1][1] == tr.t1
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    by = S.idle_by_name(tr, segs)
    ms = {"serve.step": 8, "exe.call": 5, "exe.replay": 3, "py.gc": 2,
          "serve.admit": 2, "bench.admit": 2, "serve.pre_step": 1,
          "serve.prefill": 1, "bench.step": 1}
    assert by == pytest.approx({k: v / 1e3 for k, v in ms.items()})
    assert sum(by.values()) == pytest.approx(tr.window_s - tr.busy_s)
    assert S.program_share(by) == pytest.approx(100 * 22 / 25)
    # each gap by its middle: 10.5 ms inside step 1 after its call; 21.5
    # and 30.5 under the benchmark's admission range alone; 1.5 inside
    # the first call; 38.5 inside the last step
    assert S.named_gaps(tr, segs, 10) == [
        ["serve.step", 0.007], ["bench.admit", 0.007],
        ["bench.admit", 0.005], ["exe.call", 0.003], ["serve.step", 0.003]]


def test_no_program_spans_names_gaps_as_the_benchmark_does():
    _, tr = _synthetic()
    segs = S.innermost(S.ranges(None, tr), tr.t0, tr.t1)
    assert S.named_gaps(tr, segs, 10) == tr.idle_gaps(10)
    assert S.program_share(S.idle_by_name(tr, segs)) == 0.0
    assert all(v is None for v in S.readings(_run(tr), None).values())


def test_a_full_ring_reads_nothing():
    small = Tracer(capacity=4, enabled=True)
    t = time.time()
    for i in range(5):
        small.defer("serve.step", ("t", None), t + i * 1e-3, 1e-4, "", {},
                    f"s{i}")
    sp = S.window(0, 2**63, small)
    assert sp is None
    _, tr = _synthetic()
    assert all(v is None for v in S.readings(_run(tr), sp).values())
    roomy = Tracer(capacity=8, enabled=True)
    roomy.defer("serve.step", ("t", None), t, 1e-4, "", {}, "s")
    assert len(S.window(0, 2**63, roomy).items) == 1


@pytest.mark.parametrize("mode", ["traced", "on", "off"])
def test_tool_on_a_smoke_cell(smoke_root, mode):
    bench = specs.Bench(str(smoke_root))
    row = T.measure(bench, bench.cell("ssm-smoke"), 2**31 + 7, 2.0, mode,
                    "cpu")
    assert row["tokens_per_s"] > 0 and row["decode_step_ms"] > 0
    assert row["ring_full"] is False
    assert not TRACER.enabled
    if mode == "off":
        assert "exe_call_ms.step" not in row
        return
    assert row["exe_call_ms.step"] > 0
    assert row["prefill_group_size"] >= 1
    assert row["graph_launch_ms.step"] is None         # no graphs here
    assert row["decode_busy_ms"] is None               # no device trace
    assert row["span_ms"]["serve.step"][0] > 0
    if mode == "traced":
        # nothing ran on a card: the whole span is idle, and named
        assert row["busy_s"] == 0 and row["idle_under_program_pct"] > 0
        assert row["idle_gaps"][0][1] == pytest.approx(row["window_s"])


def test_benchmark_runs_record_no_span(smoke_root):
    TRACER.clear()
    bench = specs.Bench(str(smoke_root))
    res = R.run_cell(bench, bench.cell("ssm-smoke"), 2**31 + 5, 1.0, False,
                     "cpu", time.perf_counter())
    assert res["attempted"] > 0
    assert TRACER.spans() == []


@pytest.mark.parametrize("cell", ["ssm-smoke", "mla-smoke"])
def test_traced_run_reads_prefill_shapes_from_spans(smoke_root,
                                                    monkeypatch, cell):
    """A ``--trace 1`` run reads ``prefill_useful_share`` from the
    program's ``serve.prefill`` spans over its window, one a dispatch:
    these engines pad every prefill to all slots, and to a length that
    holds the group's longest prompt (SSM groups: exactly)."""
    seen = []
    window = S.window

    def spy(t0, t1, tracer=None):
        sp = window(t0, t1, tracer)
        seen.append(sp)
        return sp

    monkeypatch.setattr(S, "window", spy)
    bench = specs.Bench(str(smoke_root))
    w = bench.cell(cell)
    res = R.run_cell(bench, w, 2**31 + 6, 1.0, True, "cpu",
                     time.perf_counter())
    [sp] = seen
    pre = sp.named("serve.prefill")
    assert pre
    slots = bench.traffic(w["traffic"])["engine"]["slots"]
    for s in pre:
        B, S_, rows, n = (s.attrs[k] for k in ("B", "S", "rows", "requests"))
        assert B == slots and S_ * n >= rows > 0
        if cell == "ssm-smoke":
            assert rows == S_ * n
    assert res["metrics"]["prefill_useful_share"][0] == pytest.approx(
        100 * sum(s.attrs["rows"] for s in pre)
        / sum(s.attrs["B"] * s.attrs["S"] for s in pre))
    assert not TRACER.enabled and TRACER.spans() == []


def test_traced_run_fails_where_spans_are_missing(smoke_root, monkeypatch):
    """A traced run whose spans do not cover its window fails, and does
    not print a share read from part of it: a ring too small to hold the
    window, or prefill spans fewer than the engine's dispatches."""
    from benchkit.loops import open_loop as OL
    bench = specs.Bench(str(smoke_root))
    cell = bench.cell("ssm-smoke")
    monkeypatch.setattr(OL, "SPAN_CAPACITY", 8)
    with pytest.raises(RuntimeError, match="ring"):
        R.run_cell(bench, cell, 2**31 + 8, 1.0, True, "cpu",
                   time.perf_counter())
    monkeypatch.undo()
    window = S.window

    def drop_one(t0, t1, tracer=None):
        sp = window(t0, t1, tracer)
        first = sp.named("serve.prefill")[0]
        return S.Spans([s for s in sp.items if s is not first])

    monkeypatch.setattr(S, "window", drop_one)
    with pytest.raises(RuntimeError, match="serve.prefill spans"):
        R.run_cell(bench, cell, 2**31 + 8, 1.0, True, "cpu",
                   time.perf_counter())
    assert not TRACER.enabled and TRACER.spans() == []
