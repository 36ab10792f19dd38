"""The serving path's spans (``core.spans``), on the CPU at smoke size.

* A paged engine over mamba2's smoke config, driven as an open loop drives
  it (admit, then grow pages and step), records one ``serve.step`` and
  one ``serve.pre_step`` a step, one ``serve.admit`` an admission call and
  one ``serve.prefill`` a dispatch, whose ``B``, ``S``, ``rows`` and
  ``requests`` equal the engine's own counters and the group it placed;
  each ``exe.call`` nests under its ``serve.step`` or ``serve.prefill`` by
  parent id, and each ``serve.prefill`` under its ``serve.admit``.
* With the tracer disabled a whole run, collections included, records
  nothing.
* The shared clock: under ``torch.profiler`` the ops a step runs lie
  inside its ``serve.step`` span, within 0.1 ms.
* A collection while the tracer is enabled leaves a ``py.gc`` span under
  the span open at the time, and none where no span is open.
* ``cuda``-marked: a replayed step's kernels lie inside the ``serve.step``
  that launched them, and ``exe.capture`` appears once a new shape and
  never inside a replay.

No JAX at module level: the ``cuda`` test runs on the card's machine with
``--noconftest``.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import spans
from repro_torch.core.backend import ArrayBackend
from repro_torch.core.compile_cache import CompileCache
from repro_torch.launch.serve import init_params
from repro_torch.obs.trace import TRACER
from repro_torch.serve.engine import PagedServeEngine, Request

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"
# prompt lengths: mamba2's engine groups prompts of one exact length
LENGTHS = (8, 8, 12, 8, 12, 16, 8)


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH, smoke=True)
    return cfg, init_params(cfg, "cpu")


@pytest.fixture()
def tracer():
    TRACER.disable()
    TRACER.clear()
    yield TRACER
    TRACER.disable()
    TRACER.clear()


def _engine(cfg, params, device="cpu"):
    return PagedServeEngine(
        cfg, params, slots=4, page_size=16, pages_per_slot=4, device=device,
        backend=ArrayBackend(device=device,
                             cache=CompileCache(persistent=False)))


def _requests(cfg, seed=0):
    r = np.random.default_rng(seed)
    return [Request(rid=i, prompt=r.integers(1, cfg.vocab, n).astype(
        np.int32), max_new=int(r.integers(3, 7)))
        for i, n in enumerate(LENGTHS)]


def _drive(eng, reqs, on_step=None):
    """Enqueue everything, then iterate as the benchmark's open loop does;
    returns each dispatch's (B, S, rows, requests) from the engine's own
    counters and the number of steps."""
    for r in reqs:
        eng.scheduler.enqueue(r)
    dispatches, steps = [], 0
    while eng.scheduler.has_pending() or any(
            a is not None for a in eng.active):
        n0, rows0 = (eng.stats["prefill_dispatches"],
                     eng.stats["prefill_rows"])
        placed = eng._admit()
        if eng.stats["prefill_dispatches"] > n0:
            S = max(len(a.prompt) for a in eng.active
                    if a is not None and len(a.out) == 1)
            dispatches.append((eng.slots, S,
                               eng.stats["prefill_rows"] - rows0, placed))
        if any(a is not None for a in eng.active):
            eng._pre_step()
            if on_step is not None:
                with on_step():
                    eng.step()
            else:
                eng.step()
            steps += 1
    return dispatches, steps


def _by_name(recs):
    out = {}
    for s in recs:
        out.setdefault(s["name"], []).append(s)
    return out


def test_engine_records_its_spans(model, tracer):
    cfg, params = model
    eng = _engine(cfg, params)
    tracer.enable()
    dispatches, steps = _drive(eng, _requests(cfg))
    tracer.disable()
    got = _by_name(tracer.spans())

    assert len(got["serve.step"]) == len(got["serve.pre_step"]) == steps
    assert sum(s["attrs"]["live"] for s in got["serve.step"]) == \
        eng.stats["decoded"]
    assert all(s["attrs"]["stalled"] == 0 for s in got["serve.pre_step"])
    pre = sorted(got["serve.prefill"], key=lambda s: s["t0"])
    assert len(pre) == eng.stats["prefill_dispatches"] == len(dispatches)
    assert [(s["attrs"]["B"], s["attrs"]["S"], s["attrs"]["rows"],
             s["attrs"]["requests"]) for s in pre] == dispatches
    assert not any(s["attrs"]["warm"] for s in pre)
    assert sum(s["attrs"]["placed"] for s in got["serve.admit"]) == \
        eng.stats["admitted"] == len(LENGTHS)

    ids = {k: {s["span_id"] for s in v} for k, v in got.items()}
    calls = got["exe.call"]
    assert all(s["attrs"]["source"] == "eager" for s in calls)
    assert all(s["parent_id"] in ids["serve.step"] | ids["serve.prefill"]
               for s in calls)
    assert sum(s["parent_id"] in ids["serve.step"] for s in calls) == steps
    assert sum(s["parent_id"] in ids["serve.prefill"]
               for s in calls) == len(pre)
    assert all(s["parent_id"] in ids["serve.admit"] for s in pre)
    assert "exe.replay" not in got and "exe.capture" not in got
    # a child lies inside its parent, on the same clock
    by_id = {s["span_id"]: s for s in tracer.spans()}
    for s in calls + pre:
        p = by_id[s["parent_id"]]
        assert p["t0"] <= s["t0"] + 1e-6
        assert s["t0"] + s["dur"] <= p["t0"] + p["dur"] + 1e-4


def test_disabled_records_nothing(model, tracer):
    cfg, params = model
    eng = _engine(cfg, params)
    eng.run(_requests(cfg, seed=1))
    gc.collect()
    assert eng.stats["steps"] > 0
    assert tracer.spans() == []


def test_spans_share_the_profilers_clock(model, tracer):
    """The ops run inside a step (selected by a profiler range around the
    call, on the profiler's own clock) lie inside its ``serve.step``."""
    cfg, params = model
    eng = _engine(cfg, params)
    tracer.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, steps = _drive(eng, _requests(cfg, seed=2),
                          lambda: torch.profiler.record_function(
                              "probe.step"))
    tracer.disable()
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()]
    probes = sorted((s, e) for n, s, e in ev if n == "probe.step")
    ops = [(s, e) for n, s, e in ev if n.startswith("aten::")]
    mine = sorted((int(round(s["t0"] * 1e9)),
                   int(round((s["t0"] + s["dur"]) * 1e9)))
                  for s in tracer.spans() if s["name"] == "serve.step")
    assert len(probes) == len(mine) == steps
    tol = 100_000                               # 0.1 ms
    checked = 0
    for (ps, pe), (s0, s1) in zip(probes, mine):
        inside = [(s, e) for s, e in ops if ps <= s and e <= pe]
        assert inside
        for s, e in inside:
            assert s0 - tol <= s and e <= s1 + tol
            checked += 1
    assert checked > steps


def test_gc_span_under_the_open_span(tracer):
    tracer.enable()
    gc.collect()                    # in no span: names nothing, not kept
    st = spans.begin("probe.outer")
    gc.collect()
    spans.end(st)
    tracer.disable()
    got = _by_name(tracer.spans())
    outer = got["probe.outer"][0]
    gcs = [s for s in got["py.gc"] if s["attrs"]["generation"] == 2]
    assert gcs and all(s["parent_id"] == outer["span_id"] for s in gcs)
    assert outer["t0"] <= gcs[0]["t0"] <= outer["t0"] + outer["dur"]


def test_traced_method_closes_over_an_exception(tracer):
    class Boom:
        @spans.traced("probe.boom", lambda self, out: {"out": out})
        def go(self):
            inner = spans.begin("probe.left_open")  # noqa: F841
            raise ValueError("boom")

    tracer.enable()
    with pytest.raises(ValueError):
        Boom().go()
    st = spans.begin("probe.after")
    spans.end(st)
    tracer.disable()
    got = _by_name(tracer.spans())
    assert got["probe.boom"][0]["attrs"] == {"out": None}
    assert got["probe.after"][0]["parent_id"] is None


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_step_kernels_inside_their_step(model, tracer, cuda_device):
    cfg, _ = model
    eng = _engine(cfg, init_params(cfg, cuda_device), cuda_device)
    tracer.enable()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, steps = _drive(eng, _requests(cfg, seed=3))
        torch.cuda.synchronize()
    tracer.disable()
    recs = tracer.spans()
    got = _by_name(recs)
    by_id = {s["span_id"]: s for s in recs}

    # a capture once a shape, never inside a replay
    calls = got["exe.call"]
    parents = {s["parent_id"] and by_id[s["parent_id"]]["name"]
               for s in calls}
    assert parents <= {"serve.step", "serve.prefill"}
    caps = got["exe.capture"]
    assert len(caps) == eng.backend.cache.stats["captures"]
    assert all(by_id[c["parent_id"]]["attrs"]["source"] == "capture"
               for c in caps)
    assert sum(c["attrs"]["source"] == "capture" for c in calls) == len(caps)
    replays = got["exe.replay"]
    assert all(by_id[r["parent_id"]]["attrs"]["source"] == "replay"
               for r in replays)

    # each replayed step's kernels, found by the graph launch's
    # correlation id, lie inside that step's span
    ev = list(prof.profiler.kineto_results.events())
    launches = [e for e in ev if e.name().startswith("cudaGraphLaunch")]
    kernels = {}
    for e in ev:
        if e.device_type() == torch.autograd.DeviceType.CUDA and \
                e.duration_ns() > 0:
            kernels.setdefault(e.correlation_id(), []).append(e)
    step_replays = [r for r in replays
                    if by_id[by_id[r["parent_id"]]["parent_id"]]["name"]
                    == "serve.step"]
    assert len(step_replays) >= steps - 2
    checked = 0
    for r in step_replays:
        step = by_id[by_id[r["parent_id"]]["parent_id"]]
        r0, r1 = r["t0"] * 1e9, (r["t0"] + r["dur"]) * 1e9
        s0, s1 = step["t0"] * 1e9, (step["t0"] + step["dur"]) * 1e9
        mine = [e for e in launches if r0 - 2e4 <= e.start_ns() <= r1 + 2e4]
        assert len(mine) == 1
        ks = kernels.get(mine[0].correlation_id(), [])
        assert ks
        for k in ks:
            assert s0 <= k.start_ns() and \
                k.start_ns() + k.duration_ns() <= s1
        checked += 1
    assert checked == len(step_replays)
