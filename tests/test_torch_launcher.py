"""The port's LLMapReduce launcher (``repro_torch.core.llmr``) on the CPU:
``tests/test_launcher.py`` test by test, the wave-autoscaling end-to-end
cases of ``tests/test_autoscale.py``, and parity with the reference.

Parity: the same numpy inputs, drawn from a seed, through
``repro.core.llmr.LLMapReduce`` and the port's, on every backend (serial,
array, pipelined, a node/core fan-out, autoscaled waves), outputs equal
within 1e-5 (both compute in float32 on the CPU; sums may round in another
order).

Not ported, by name: ``test_compile_cache_persists_across_instances`` (the
disk tier: a CUDA graph cannot be serialized, so ``CompileCache`` has
none — ``test_fresh_cache_has_no_disk_tier`` holds that instead) and
``test_launch_rate_array_beats_serial``, which on the CPU would time a
serial baseline that captures nothing: it runs on the card
(``tests/test_torch_graph.py::test_cuda_launch_rate_array_beats_serial``,
with the backends' outputs on the card).
"""
import gc

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.llmr import LLMapReduce as JLLMapReduce
from repro_torch.core.autoscale import WaveController
from repro_torch.core.backend import (ArrayBackend, PipelinedBackend,
                                      SerialBackend, make_backend)
from repro_torch.core.compile_cache import CompileCache, fingerprint
from repro_torch.core.llmr import LLMapReduce, launch_instances
from repro_torch.core.telemetry import LaunchRecord

torch.set_num_threads(1)

BACKEND_KINDS = ("serial", "array", "pipelined")
CPU = "cpu"


def app(x):
    return (x * 2.0).sum(axis=-1)


@pytest.fixture()
def cache():
    return CompileCache()


def _llmr(kind, cache, **kw):
    if kind == "serial":
        return LLMapReduce(scheduler="serial", device=CPU, **kw)
    return LLMapReduce(scheduler=kind, cache=cache, device=CPU, **kw)


def _flat(out):
    if isinstance(out, list):
        return np.asarray([np.asarray(o) for o in out])
    return np.asarray(out)


@pytest.mark.parametrize("kind", ("array", "pipelined"))
@given(n=st.integers(1, 64), wave=st.integers(1, 17))
@settings(max_examples=15, deadline=None)
def test_every_task_exactly_once(kind, n, wave):
    inputs = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    llmr = LLMapReduce(wave_size=wave, scheduler=kind, device=CPU)
    out, report = llmr.map_reduce(app, inputs)
    np.testing.assert_allclose(_flat(out), inputs.sum(-1) * 2.0, rtol=1e-6)
    assert report.waves == -(-n // wave)
    assert report.n_instances == n


@pytest.mark.parametrize("kind", BACKEND_KINDS)
def test_backends_produce_identical_outputs(kind, cache):
    inputs = np.random.default_rng(0).standard_normal((12, 4)).astype(
        np.float32)
    expect = inputs.sum(-1) * 2.0
    out, report = _llmr(kind, cache, wave_size=5).map_reduce(app, inputs)
    np.testing.assert_allclose(_flat(out), expect, rtol=1e-6)
    assert report.n_instances == 12
    for rec in report.records:
        assert rec.t_first_result > 0.0
        assert rec.t_first_result <= rec.t_spawn + 1e-9


def test_reduce_applied():
    inputs = np.ones((8, 4), np.float32)
    llmr = LLMapReduce(wave_size=4, device=CPU)
    out, report = llmr.map_reduce(app, inputs,
                                  reduce_fn=lambda xs: np.asarray(xs).sum())
    assert float(out) == 8 * 8.0
    assert report.t_reduce >= 0


def test_serial_equals_array_results():
    inputs = np.random.default_rng(0).standard_normal((6, 4)).astype(
        np.float32)
    out_a, _ = LLMapReduce(scheduler="array", device=CPU).map_reduce(
        app, inputs)
    out_s, _ = LLMapReduce(scheduler="serial", device=CPU).map_reduce(
        app, inputs)
    np.testing.assert_allclose(np.asarray(out_a), _flat(out_s), rtol=1e-6)


def test_pipelined_equals_array_results(cache):
    inputs = np.random.default_rng(3).standard_normal((32, 4)).astype(
        np.float32)
    out_a, _ = _llmr("array", cache, wave_size=8).map_reduce(app, inputs)
    out_p, rep = _llmr("pipelined", cache, wave_size=8).map_reduce(app,
                                                                   inputs)
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(out_p),
                               rtol=1e-6)
    assert rep.waves == 4
    assert rep.records[0].strategy == "llmr-pipelined"


def test_hierarchical_fanout_preserves_results(cache):
    inputs = np.random.default_rng(1).standard_normal((16, 4)).astype(
        np.float32)
    be = ArrayBackend(cache=cache, inner_lanes=4, device=CPU)
    out, rec = be.launch(app, inputs, 16)
    np.testing.assert_allclose(np.asarray(out), inputs.sum(-1) * 2.0,
                               rtol=1e-6)
    assert rec.fanout == {"sched": 1, "node": 4, "core": 4}
    lv = rec.levels()
    assert set(lv) == {"sched", "node", "core"} and all(
        v >= 0 for v in lv.values())


def test_array_compile_cache_hits(cache):
    """The second launch of one wave shape is a memory hit. (The
    reference also holds its t_schedule below the first's: on the CPU the
    port's compile is only a fingerprint, so the two are equal within
    noise and are not compared.)"""
    sched = ArrayBackend(cache=cache, device=CPU)
    inputs = np.ones((8, 4), np.float32)
    _, rec1 = sched.launch(app, inputs, 8)
    _, rec2 = sched.launch(app, inputs, 8)
    assert not rec1.extra["compile_cached"]
    assert rec2.extra["compile_cached"]
    assert rec2.extra["compile_source"] == "memory"
    assert cache.stats["misses"] == 1 and cache.stats["mem_hits"] == 1


def test_compile_cache_key_is_content_not_id(cache):
    """CPython reuses the address of a collected function: the key of a
    NEW function must not alias the OLD one's executable."""
    sched = ArrayBackend(cache=cache, device=CPU)
    inputs = np.ones((8, 4), np.float32)

    def make(scale):
        def fn(x, _s=scale):
            return (x * _s).sum(axis=-1)
        return fn

    f1 = make(2.0)
    fp1 = fingerprint(f1, (inputs,))
    out1, _ = sched.launch(f1, inputs, 8)
    np.testing.assert_allclose(np.asarray(out1), np.full(8, 8.0))
    old_id = id(f1)
    del f1, out1
    gc.collect()
    f2 = None
    for _ in range(64):
        cand = make(10.0)
        if id(cand) == old_id:
            f2 = cand
            break
        del cand
    if f2 is None:
        f2 = make(10.0)
    assert fingerprint(f2, (inputs,)) != fp1
    out2, _ = sched.launch(f2, inputs, 8)
    np.testing.assert_allclose(np.asarray(out2), np.full(8, 40.0))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_fingerprint_hashes_closure_array_values(cache, kind):
    """Two closures over same-shaped but different-valued weights (numpy
    arrays or tensors) are different functions and must not alias."""
    sched = ArrayBackend(cache=cache, device=CPU)
    inputs = np.ones((4, 3), np.float32)
    wrap = (lambda a: a) if kind == "numpy" else torch.from_numpy

    def make(w):
        def fn(v):
            return (v * torch.as_tensor(w)).sum(axis=-1)
        return fn

    f1 = make(wrap(np.full(3, 2.0, np.float32)))
    f2 = make(wrap(np.full(3, 10.0, np.float32)))
    assert fingerprint(f1, (inputs,)) != fingerprint(f2, (inputs,))
    out1, _ = sched.launch(f1, inputs, 4)
    out2, _ = sched.launch(f2, inputs, 4)
    np.testing.assert_allclose(np.asarray(out1), np.full(4, 6.0))
    np.testing.assert_allclose(np.asarray(out2), np.full(4, 30.0))


def test_fingerprint_sees_indirect_closure_values():
    inputs = np.ones((4, 3), np.float32)

    def make(w):
        def inner(x):
            return x * w

        def outer(x):
            return inner(x).sum(axis=-1)
        return outer

    f1 = make(np.full(3, 2.0, np.float32))
    f2 = make(np.full(3, 10.0, np.float32))
    assert fingerprint(f1, (inputs,)) != fingerprint(f2, (inputs,))


def test_fingerprint_sees_arrays_inside_containers():
    inputs = np.ones((4, 64), np.float32)

    def make(params):
        def fn(x):
            return (x @ params["w"]).sum(axis=-1)
        return fn

    w1 = torch.zeros((64, 64))
    w2 = torch.zeros((64, 64))
    w2[10, 10] = 99.0              # interior change: repr() is identical
    assert (fingerprint(make({"w": w1}), (inputs,))
            != fingerprint(make({"w": w2}), (inputs,)))
    big1 = {f"w{i}": np.float32(i) for i in range(24)}
    big2 = dict(big1, w20=np.float32(999.0))
    assert (fingerprint(make(big1), (inputs,))
            != fingerprint(make(big2), (inputs,)))


_SCALE = 2.0


def test_fingerprint_tracks_global_rebinding():
    global _SCALE

    def fn(x):
        return x * _SCALE

    a = np.ones((4, 3), np.float32)
    _SCALE = 2.0
    fp1 = fingerprint(fn, (a,))
    try:
        _SCALE = 10.0
        assert fingerprint(fn, (a,)) != fp1
    finally:
        _SCALE = 2.0


def test_fingerprint_stable_and_shape_sensitive():
    a = np.ones((8, 4), np.float32)
    assert fingerprint(app, (a,)) == fingerprint(app, (a,))
    assert fingerprint(app, (a,)) != fingerprint(app, (np.ones((4, 4),
                                                             np.float32),))
    # a tensor and an array of one shape and dtype are one signature; the
    # device is part of the key
    assert fingerprint(app, (a,)) == fingerprint(app, (torch.ones(8, 4),))
    assert (fingerprint(app, (a,), device="cpu")
            != fingerprint(app, (a,), device="meta"))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_fingerprint_tracks_in_place_array_mutation(kind):
    w = np.full(3, 2.0, np.float32)
    if kind == "torch":
        w = torch.from_numpy(w)

    def fn(x):
        return (x * w).sum(axis=-1)

    a = np.ones((4, 3), np.float32)
    fp1 = fingerprint(fn, (a,))
    assert fingerprint(fn, (a,)) == fp1
    w[:] = 10.0
    assert fingerprint(fn, (a,)) != fp1


def test_fresh_cache_has_no_disk_tier():
    """In place of the reference's persistence test: a CUDA graph holds
    device addresses and cannot be serialized, so a new cache (a new
    process) compiles again; within one cache the second launch hits."""
    inputs = np.ones((8, 4), np.float32)
    _, rec1 = ArrayBackend(cache=CompileCache(), device=CPU).launch(
        app, inputs, 8)
    _, rec2 = ArrayBackend(cache=CompileCache(), device=CPU).launch(
        app, inputs, 8)
    assert rec1.extra["compile_source"] == "compiled"
    assert rec2.extra["compile_source"] == "compiled"
    import inspect
    assert "cache_dir" not in inspect.signature(CompileCache).parameters


def test_straggler_speculative_redispatch():
    inputs = np.ones((16, 4), np.float32)
    llmr = LLMapReduce(wave_size=4, straggler_factor=2.0, device=CPU)
    delays = {2: 1.0}
    out, report = llmr.map_reduce(
        app, inputs, wave_delay_hook=lambda w: delays.get(w, 0.0))
    assert report.speculative_redispatches >= 1
    np.testing.assert_allclose(np.asarray(out), np.full(16, 8.0), rtol=1e-6)


def test_straggler_accounting_keeps_both_attempts():
    inputs = np.ones((16, 4), np.float32)
    llmr = LLMapReduce(wave_size=4, straggler_factor=2.0, device=CPU)
    _, report = llmr.map_reduce(
        app, inputs, wave_delay_hook=lambda w: {2: 1.0}.get(w, 0.0))
    assert report.speculative_redispatches >= 1
    superseded = [r for r in report.records
                  if r.extra.get("superseded_by_redispatch")]
    reruns = [r for r in report.records
              if r.extra.get("straggler_redispatch")]
    assert len(superseded) == report.speculative_redispatches
    assert len(reruns) == report.speculative_redispatches
    assert len(report.records) == (report.waves
                                   + report.speculative_redispatches)
    assert report.n_instances == 16
    assert report.n_attempts == 16 + 4 * len(reruns)
    assert superseded[0].extra["t_wave"] > reruns[0].extra["t_wave"]


def test_pipelined_straggler_redispatch_without_barrier(cache):
    inputs = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)

    def mk():
        return LLMapReduce(wave_size=8, straggler_factor=3.0,
                           min_straggler_s=0.05,
                           backend=PipelinedBackend(cache=cache, depth=2,
                                                    device=CPU))

    out_ref, _ = mk().map_reduce(app, inputs)
    delay = 1.5
    out, report = mk().map_reduce(
        app, inputs, wave_delay_hook=lambda w: delay if w == 3 else 0.0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out_ref))
    assert report.speculative_redispatches >= 1
    assert report.waves == 8
    assert report.n_instances == 64
    assert report.n_attempts == 64 + 8 * report.speculative_redispatches
    assert report.t_total < delay, report.t_total
    order = [r.extra["wave"] for r in report.records if not r.superseded]
    assert order.index(3) > order.index(4)
    superseded = [r for r in report.records if r.superseded]
    winners = [r for r in report.records if r.redispatch]
    assert any(r.extra["wave"] == 3 for r in superseded)
    assert any(r.extra["wave"] == 3 for r in winners)
    assert all(r.extra["t_wave"] > 0 for r in superseded)


def test_deprecated_scheduler_shim_is_gone():
    with pytest.raises(ImportError):
        import repro_torch.core.scheduler  # noqa: F401


def test_launch_model_headline():
    from repro_torch.core.launch_model import (copy_time, headline,
                                               launch_time_azure,
                                               launch_time_llmr)
    h = headline()
    assert h["within_1p5x"], h
    for n in (16, 256, 4096, 16384):
        assert launch_time_llmr(n) < launch_time_azure(n)
    assert copy_time(16384) < 0.2 * launch_time_llmr(16384)


@given(st.integers(1, 14))
def test_launch_model_monotone(k):
    from repro_torch.core.launch_model import CURVES
    n = 2 ** k
    for fn in CURVES.values():
        assert fn(2 * n) >= fn(n) * 0.999


def test_launch_instances_entry_point():
    outs, report = launch_instances(lambda x: (x * x).sum(), 40,
                                    item_shape=(8,), wave_size=16,
                                    device=CPU)
    x = np.random.default_rng(0).standard_normal((40, 8)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(outs), (x * x).sum(-1),
                               rtol=1e-5)
    assert report.waves == 3 and report.n_instances == 40


# ---------------------------------------------------------------------------
# tests/test_autoscale.py's end-to-end cases (the controller's own cases run
# against the port in tests/test_torch_copies.py)
# ---------------------------------------------------------------------------

def test_auto_wave_size_end_to_end(cache):
    inputs = np.random.default_rng(0).standard_normal((600, 8)).astype(
        np.float32)
    llmr = LLMapReduce(wave_size="auto",
                       backend=PipelinedBackend(cache=cache, device=CPU))
    out, report = llmr.map_reduce(app, inputs)
    np.testing.assert_allclose(np.asarray(out), inputs.sum(-1) * 2.0,
                               rtol=1e-5, atol=1e-5)
    assert report.n_instances == 600
    assert report.waves >= 1
    assert len(report.autoscale) == report.waves
    originals = [r for r in report.records
                 if not r.superseded and not r.redispatch]
    assert all("autoscale" in r.extra for r in originals)
    assert sum(d.wave for d in report.autoscale) == 600


def test_auto_wave_size_with_serial_backend():
    inputs = np.ones((16, 4), np.float32)
    out, report = LLMapReduce(wave_size="auto", scheduler="serial",
                              device=CPU).map_reduce(app, inputs)
    assert report.n_instances == 16
    assert len(out) == 16


def test_make_backend_normalizes_auto_inner_lanes(cache):
    be = make_backend("pipelined", cache=cache, inner_lanes="auto",
                      device=CPU)
    assert be.inner_lanes is None
    assert be.supports_lane_override


def test_make_backend_dist_is_not_ported(monkeypatch):
    """The name predates the fabric's port: ``make_backend("dist")`` now
    resolves lazily to ``repro_torch.dist.DistributedBackend`` — on the
    card unless given the CPU, raising without one — and an unknown kind
    still raises."""
    from repro_torch.dist import DistributedBackend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_backend("dist", n_nodes=1)
    be = make_backend("dist", n_nodes=1, device=CPU)
    try:
        assert isinstance(be, DistributedBackend)
        assert be.device.type == "cpu" and be.name == "llmr-dist"
    finally:
        be.close()
    with pytest.raises(ValueError):
        make_backend("slurm", device=CPU)


def test_backend_slo_reaches_wave_controller_end_to_end(cache):
    seen = {}

    def factory(**kw):
        seen.update(kw)
        return WaveController(**kw)

    be = PipelinedBackend(cache=cache, target_first_result_s=0.123,
                          device=CPU)
    llmr = LLMapReduce(wave_size="auto", backend=be, controller=factory)
    inputs = np.ones((16, 4), np.float32)
    llmr.map_reduce(app, inputs)
    assert seen["target_first_result_s"] == 0.123
    assert seen["devices"] == 1
    seen.clear()
    LLMapReduce(wave_size="auto", backend=be, controller=factory,
                target_first_result_s=0.5).map_reduce(app, inputs)
    assert seen["target_first_result_s"] == 0.5


def test_seed_era_controller_factories_still_work(cache):
    calls = {}

    def old_factory(n_tasks, devices):
        calls["kw"] = {"n_tasks": n_tasks, "devices": devices}
        return WaveController(n_tasks=n_tasks, devices=devices)

    be = PipelinedBackend(cache=cache, target_first_result_s=1.0, device=CPU)
    out, rep = LLMapReduce(wave_size="auto", backend=be,
                           controller=old_factory).map_reduce(
        app, np.ones((16, 4), np.float32))
    assert calls["kw"]["n_tasks"] == 16
    assert rep.n_instances == 16


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

PARITY = {
    "serial": dict(scheduler="serial", wave_size=7),
    "array": dict(scheduler="array", wave_size=16),
    "pipelined": dict(scheduler="pipelined", wave_size=16),
    "array-lanes": dict(scheduler="array", wave_size=16, inner_lanes=4),
    "array-auto": dict(scheduler="array", wave_size="auto"),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_outputs_match_reference(name):
    """One seeded input set, both packages, every backend: outputs within
    1e-5 (float32 on both sides)."""
    kw = PARITY[name]
    n = 52                          # the last 16-wave is 4: lanes divide
    x = np.random.default_rng(11).standard_normal((n, 16)).astype(
        np.float32)

    def j_app(v):
        return (v * v).sum(axis=-1) - v.max(axis=-1)

    def t_app(v):
        return (v * v).sum(dim=-1) - v.amax(dim=-1)

    j_out, j_rep = JLLMapReduce(**kw).map_reduce(j_app, x)
    t_out, t_rep = LLMapReduce(device=CPU, **kw).map_reduce(t_app, x)
    np.testing.assert_allclose(_flat(t_out), _flat(j_out), rtol=1e-5,
                               atol=1e-5)
    assert t_rep.n_instances == j_rep.n_instances == n
    if not isinstance(kw["wave_size"], str):
        assert t_rep.waves == j_rep.waves


def test_reduce_matches_reference():
    x = np.random.default_rng(12).standard_normal((40, 8)).astype(np.float32)
    j, _ = JLLMapReduce(wave_size=8).map_reduce(
        lambda v: (v * 3.0).sum(axis=-1), x,
        reduce_fn=lambda o: np.asarray(o).sum())
    t, _ = LLMapReduce(wave_size=8, device=CPU).map_reduce(
        lambda v: (v * 3.0).sum(dim=-1), x, reduce_fn=lambda o: o.sum())
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def test_launch_record_matches_reference_layout():
    from repro.core.telemetry import HEADER as J_HEADER
    from repro_torch.core.telemetry import HEADER
    assert HEADER == J_HEADER
    rec = LaunchRecord("x", 4, t_schedule=0.5, t_spawn=1.0,
                       t_first_result=0.25)
    assert rec.levels() == {"sched": 0.5, "node": 0.25, "core": 0.75}
