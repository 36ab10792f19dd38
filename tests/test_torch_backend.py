"""The port's LaunchBackend protocol (``repro_torch.core.backend``) on the
CPU: ``tests/test_backend.py`` test by test, plus parity with the
reference's backends on one seeded input set (outputs within 1e-5).

The backend list holds the distributed fabric over both wires, as the
reference's does (``repro_torch.dist.DistributedBackend`` on the CPU). Not
ported, by name: ``test_donation_disabled_on_cpu`` (PyTorch has no buffer
donation; a graph's static inputs are reused by construction).
The reference's ``test_backend_outputs_identical`` builds its cache from
``tmp_path`` under ``@given`` and fails hypothesis's function-scoped-fixture
health check; the port's counterpart makes its cache inside the test.
"""
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.backend import make_backend as j_make_backend
from repro_torch.core.backend import (ArrayBackend, LaunchBackend,
                                      PipelinedBackend, SerialBackend,
                                      WaveHandle, make_backend)
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.llmr import LLMapReduce

torch.set_num_threads(1)

CPU = "cpu"


def app(x):
    return (x * 3.0).sum(axis=-1)


@pytest.fixture()
def cache():
    return CompileCache()


def _backends(cache):
    from repro_torch.dist.backend import DistributedBackend
    return [SerialBackend(device=CPU), ArrayBackend(cache=cache, device=CPU),
            PipelinedBackend(cache=cache, device=CPU),
            ArrayBackend(cache=cache, inner_lanes=4, device=CPU),
            PipelinedBackend(cache=cache, inner_lanes=4, depth=3,
                             device=CPU),
            # the multi-host fabric speaks the same protocol end-to-end
            # over BOTH wires (generous lease: a busy CI box must not
            # false-kill nodes)
            DistributedBackend(n_nodes=2, cache=cache, device=CPU,
                               heartbeat_timeout_s=30.0),
            DistributedBackend(n_nodes=2, cache=cache, device=CPU,
                               transport="socket",
                               heartbeat_timeout_s=30.0)]


def _close_all(backends):
    for be in backends:                 # dist backends own node threads
        if hasattr(be, "close"):
            be.close()


def test_all_backends_satisfy_protocol(cache):
    backends = _backends(cache)
    try:
        for be in backends:
            assert isinstance(be, LaunchBackend)
            assert isinstance(be.name, str) and be.max_in_flight >= 1
    finally:
        _close_all(backends)


def test_factory_rejects_unknown_kind():
    with pytest.raises(ValueError):
        make_backend("slurm")


@given(n=st.integers(1, 48))
@settings(max_examples=10, deadline=None)
def test_backend_outputs_identical(n):
    """The tentpole contract: every backend computes the same launch."""
    cache = CompileCache()
    inputs = np.random.default_rng(n).standard_normal((n, 8)).astype(
        np.float32)
    expect = inputs.sum(-1) * 3.0
    backends = _backends(cache)
    try:
        for be in backends:
            out, rec = be.launch(app, inputs, n)
            got = (np.asarray([np.asarray(o) for o in out])
                   if isinstance(out, list) else np.asarray(out))
            np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-4,
                                       err_msg=be.name)
            assert rec.n_instances == n
            assert rec.t_first_result > 0.0
    finally:
        _close_all(backends)


def test_wavehandle_lifecycle(cache):
    be = PipelinedBackend(cache=cache, device=CPU)
    inputs = np.ones((8, 4), np.float32)
    h = be.dispatch(app, inputs, 8)
    assert isinstance(h, WaveHandle)
    out, rec = h.result()
    assert h.poll()
    np.testing.assert_allclose(np.asarray(out), np.full(8, 12.0))
    out2, rec2 = h.result()
    assert rec2 is rec and out2 is out


def test_pipelined_keeps_waves_in_flight(cache):
    events = []

    class Probe(PipelinedBackend):
        def dispatch(self, fn, chunk, n):
            events.append("dispatch")
            h = super().dispatch(fn, chunk, n)
            orig = h.result
            h.poll = lambda: False

            def result():
                events.append("harvest")
                return orig()
            h.result = result
            return h

    inputs = np.ones((64, 4), np.float32)
    llmr = LLMapReduce(wave_size=8, backend=Probe(cache=cache, device=CPU))
    out, report = llmr.map_reduce(app, inputs)
    assert report.waves == 8
    np.testing.assert_allclose(np.asarray(out), np.full(64, 12.0))
    assert "dispatch,dispatch" in ",".join(events)


def test_pipelined_rotates_slots(cache):
    """Each in-flight slot gets its own executable (on the card: its own
    stream, graph and memory): wave k runs in slot k % depth."""
    be = PipelinedBackend(cache=cache, depth=3, device=CPU)
    inputs = np.ones((8, 4), np.float32)
    srcs = [be.dispatch(app, inputs, 8).result()[1].extra["compile_source"]
            for _ in range(6)]
    assert srcs == ["compiled"] * 3 + ["memory"] * 3
    assert cache.stats["misses"] == 3


def test_inner_lanes_fall_back_when_indivisible(cache):
    be = ArrayBackend(cache=cache, inner_lanes=5, device=CPU)
    inputs = np.ones((12, 4), np.float32)
    with pytest.warns(RuntimeWarning, match="inner_lanes=5"):
        out, rec = be.launch(app, inputs, 12)
    assert rec.fanout == {"sched": 1, "node": 12, "core": 1}
    assert rec.extra["inner_lanes_fallback"] == {
        "requested": 5, "wave": 12, "used": (12, 1)}
    np.testing.assert_allclose(np.asarray(out), np.full(12, 12.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, rec2 = be.launch(app, inputs, 12)
    assert rec2.extra["inner_lanes_fallback"]["requested"] == 5


def test_dispatch_accepts_per_wave_inner_lanes_override(cache):
    be = ArrayBackend(cache=cache, device=CPU)
    out, rec = be.dispatch(app, np.ones((16, 4), np.float32), 16,
                           inner_lanes=4).result()
    assert rec.fanout == {"sched": 1, "node": 4, "core": 4}
    np.testing.assert_allclose(np.asarray(out), np.full(16, 12.0))


def _serial_record(device):
    be = SerialBackend(device=device)
    inputs = np.ones((6, 4), np.float32)
    _, rec = be.launch(app, inputs, 6)
    assert rec.t_schedule > 0.0
    assert rec.levels()["sched"] == rec.t_schedule
    assert rec.total == pytest.approx(
        rec.t_schedule + rec.t_stage + rec.t_spawn)
    assert rec.t_first_result > 0.0
    assert rec.t_first_result <= rec.t_spawn + 1e-9
    return rec


def test_serial_attributes_per_task_submit_to_t_schedule():
    """sched + node + core partition the wall clock. (That the per-task
    submit dwarfs the execution is a property of the card, where each
    instance pays a capture: ``tests/test_torch_graph.py::
    test_cuda_serial_submit_dwarfs_execution``;
    on the CPU the port's executable is the function itself.)"""
    _serial_record(CPU)


def test_serial_overhead_counts_as_scheduler_cost():
    be = SerialBackend(per_task_overhead_s=0.01, device=CPU)
    _, rec = be.launch(app, np.ones((3, 4), np.float32), 3)
    assert rec.t_schedule >= 3 * 0.01


def test_serve_and_launch_share_compile_cache(cache):
    """An engine's decode step compiled by one engine is a cache hit for a
    second engine over the same backend cache."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import init_params
    from repro_torch.serve.engine import PagedServeEngine, Request

    cfg = get_config("qwen3-14b", smoke=True)
    params = init_params(cfg, CPU)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=8),
                    max_new=4) for i in range(2)]

    eng1 = PagedServeEngine(cfg, params, slots=2, page_size=16,
                            pages_per_slot=4, device=CPU,
                            backend=ArrayBackend(cache=cache, device=CPU))
    eng1.run(list(reqs), max_steps=50)
    assert eng1.stats["compile_sources"]["step"] == "compiled"
    first = [list(r.out) for r in reqs]

    for r in reqs:
        r.out, r.done = [], False
    eng2 = PagedServeEngine(cfg, params, slots=2, page_size=16,
                            pages_per_slot=4, device=CPU,
                            backend=ArrayBackend(cache=cache, device=CPU))
    stats = eng2.run(list(reqs), max_steps=50)
    assert stats["compile_sources"]["step"] == "memory"
    assert all(r.done for r in reqs)
    assert [list(r.out) for r in reqs] == first


def test_launch_record_row_includes_t_first_result(cache):
    from repro_torch.core.telemetry import HEADER
    be = ArrayBackend(cache=cache, device=CPU)
    _, rec = be.launch(app, np.ones((4, 4), np.float32), 4)
    assert "t_first_result" in HEADER
    row = rec.row()
    assert len(row.split(",")) == len(HEADER.split(","))
    assert float(row.split(",")[5]) == pytest.approx(rec.t_first_result,
                                                     abs=1e-4)


def test_backends_need_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("serial", "array", "pipelined"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_backend(kind)
        assert make_backend(kind, device=CPU).device.type == "cpu"


# ---------------------------------------------------------------------------
# Parity with the reference's backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [
    ("serial", {}), ("array", {}), ("pipelined", {}),
    ("array", {"inner_lanes": 4}), ("pipelined", {"inner_lanes": 4,
                                                   "depth": 3})],
    ids=["serial", "array", "pipelined", "array-lanes", "pipelined-lanes"])
def test_launch_matches_reference(kind, kw):
    n = 24
    x = np.random.default_rng(21).standard_normal((n, 8)).astype(np.float32)
    j_out, j_rec = j_make_backend(kind, **kw).launch(
        lambda v: (v * 3.0).sum(axis=-1) + v[0], x, n)
    t_out, t_rec = make_backend(kind, device=CPU, **kw).launch(
        lambda v: (v * 3.0).sum(dim=-1) + v[0], x, n)

    def flat(o):
        return (np.asarray([np.asarray(e) for e in o])
                if isinstance(o, list) else np.asarray(o))

    np.testing.assert_allclose(flat(t_out), flat(j_out), rtol=1e-5,
                               atol=1e-5)
    assert t_rec.fanout == j_rec.fanout
    assert t_rec.n_instances == j_rec.n_instances == n
