"""The goodput of a run (``open_loop.goodput_tokens_per_s``) on hand-built
records: the output tokens that every request due from the loop's start
to the window's close had received by the close, over that time.

* Requests due in the traffic warm-up count as those due in the window;
  requests due at or after the close add nothing.
* A request still waiting at the close adds 0; one half served adds what
  it received; one refused adds 0 and counts as failed.
* Of two programs that serve the same requests, the one that serves them
  sooner reads the same or higher.
* A program that drops, or cuts short, one early request reads lower.
* ``prefill_useful_share`` reads the real rows and the padded B x S of
  the window's ``serve.prefill`` spans, and fails where a span is missing
  against the engine's count of dispatches.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchkit import spans as S
from benchkit import specs
from benchkit.loops import open_loop as OL

T0 = 100.0                  # the loop's start, host clock (s)
WS, WE = T0 + 6.0, T0 + 16.0


def _req(due, out=None, done=False):
    """A request due ``due`` s after the loop's start; ``out`` the tokens
    it had received at the close (None: never enqueued)."""
    eng = None if out is None else SimpleNamespace(
        out=list(range(out)), done=done, t_first=None)
    return SimpleNamespace(due=due, engine_req=eng, t_due=0.0)


def _run(reqs):
    return SimpleNamespace(window=(WS, WE), seconds=WE - WS,
                           due=OL.due_in(reqs, T0, WS, WE),
                           offered=OL.due_in(reqs, T0, T0, WE),
                           rec=SimpleNamespace(requests=reqs, t_loop0=T0))


def test_warmup_requests_count_and_late_ones_add_nothing():
    early = [_req(1.0, 150), _req(5.99, 80)]      # due in the warm-up
    mine = [_req(6.0, 3), _req(9.0, 7)]
    late = [_req(16.0, None), _req(16.5, None)]   # due at / after the close
    run = _run(early + mine + late)
    assert [r.due for r in run.due] == [6.0, 9.0]
    assert [r.due for r in run.offered] == [1.0, 5.99, 6.0, 9.0]
    assert OL.goodput_tokens(run.offered) == 240
    assert OL.goodput_tokens(run.due) == 10
    assert OL.e2e(run, 1.0)["goodput_tokens_per_s"] == pytest.approx(
        240 / 16.0)


def test_waiting_adds_zero_and_half_served_adds_what_it_received():
    waiting = _req(7.0, 0)                  # enqueued, not yet placed
    unsent = _req(8.0, None)                # due, not yet enqueued
    half = _req(6.5, 40)                    # 40 of 128 at the close
    refused = _req(2.5, 0, done=True)       # refused in the warm-up
    run = _run([waiting, unsent, half, refused])
    assert len(run.offered) == 4
    assert OL.goodput_tokens(run.offered) == 40
    assert [OL.rejected(r) for r in run.offered] == [False, False, False,
                                                     True]


def _served(reqs, speed, drop=(), cut=()):
    """Each request's tokens at the close when a program serves them in
    arrival order one at a time: first token ``0.2 / speed`` s after it
    starts, then one every ``0.02 / speed`` s. It refuses the requests
    ``drop`` indexes and stops those ``cut`` indexes halfway."""
    t, out = T0, []
    for i, (due, n) in enumerate(reqs):
        if i in drop:
            out.append(0)
            continue
        n = n // 2 if i in cut else n
        t = max(t, T0 + due) + 0.2 / speed
        times = t + np.arange(n) * 0.02 / speed
        out.append(int((times <= WE).sum()))
        t = times[-1]
    return out


def _schedule(seed):
    """Arrivals below what the program at speed 1 keeps up with (one a
    1.5 s on average, each ~1 s of service)."""
    rng = np.random.default_rng(seed)
    due = np.cumsum(rng.exponential(1.5, size=30))
    return [(float(d), int(n)) for d, n in
            zip(due, rng.integers(16, 64, size=30))]


def _goodput(reqs, got):
    return OL.goodput_tokens_per_s(_run([_req(d, n) for (d, _), n in
                                         zip(reqs, got)]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("speed", [1.1, 1.5, 3.0])
def test_serving_sooner_reads_the_same_or_higher(seed, speed):
    reqs = _schedule(seed)
    slow = _served(reqs, 1.0)
    fast = _served(reqs, speed)
    assert all(f >= s for f, s in zip(fast, slow))
    assert _goodput(reqs, fast) >= _goodput(reqs, slow) > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("fault", ["drop", "cut"])
def test_an_early_request_dropped_or_cut_short_reads_lower(seed, fault):
    """The first request is due in the traffic warm-up and done long
    before the close; a program that refuses it, or stops it halfway,
    serves the rest no later and still reads lower."""
    reqs = _schedule(seed)
    assert reqs[0][0] < WS - T0
    sound = _served(reqs, 1.0)
    assert sound[0] == reqs[0][1]
    faulty = _served(reqs, 1.0, **{fault: (0,)})
    assert all(f >= s for f, s in zip(faulty[1:], sound[1:]))
    assert _goodput(reqs, faulty) < _goodput(reqs, sound)


def _prefill(t_ms, sid, B, S_, requests, rows):
    return S.Span("serve.prefill", t_ms * 1_000_000, (t_ms + 1) * 1_000_000,
                  sid, None, {"B": B, "S": S_, "requests": requests,
                              "rows": rows, "warm": False})


def _share_run(spans, dispatches):
    return SimpleNamespace(spans=S.Spans(spans),
                           stats0={"prefill_dispatches": 3},
                           stats1={"prefill_dispatches": 3 + dispatches})


def test_prefill_useful_share_reads_the_program_spans():
    share = specs.load_file(os.path.join(
        specs.BENCH_DIR, "metrics", "prefill_useful_share.py")).read
    pre = [_prefill(1, "a", 32, 256, 1, 256),
           _prefill(3, "b", 2, 512, 2, 1024)]
    assert share(_share_run(pre, 2)) == pytest.approx(
        100 * 1280 / (32 * 256 + 2 * 512))
    assert share(_share_run([], 0)) is None       # no dispatch: nothing
    for spans, n in ((pre[:1], 2), (pre, 3)):
        with pytest.raises(RuntimeError, match="serve.prefill spans"):
            share(_share_run(spans, n))
