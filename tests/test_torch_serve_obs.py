"""The serving engines' ``obs`` hooks against the reference's, on the CPU.

* With each package's metrics registry enabled, one trace through the
  port's engine and the reference's: the paged engine under preemption
  churn with prefix sharing (a seed prompt registers a prefix, batch
  fillers warm-admit onto it, interactive extensions preempt them), and
  the fixed engine. Counters (``serve.preemptions``,
  ``serve.prefix.hits`` / ``misses``, ``serve.kernel.bytes_avoided``), the
  occupancy gauge's last value and the ``serve.ttft_s`` / ``serve.tpot_s``
  histograms' and series' counts are equal. ``bytes_avoided`` is counted
  on the page-walking kernel's steps: the port's ``"paged"`` (its plain
  version on the CPU) against the reference's ``"pallas"`` in interpret
  mode, at smoke width; ``stats["kv_bytes_avoided"]`` and
  ``kv_row_bytes()`` equal the reference's too.
* With the registry disabled, nothing is recorded.
* A run under an SLO it cannot meet writes a ``slo_breach`` bundle through
  the flight recorder (armed into ``tmp_path``), and records the
  ``serve.slo_attainment`` series.
* The port's statusd ``/slo`` route summarizes the engine's
  ``serve.ttft_s`` histogram.
"""
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.backend import ArrayBackend as JArrayBackend
from repro.core.compile_cache import CompileCache as JCompileCache
from repro.models.lm import lm_init as jlm_init
from repro.obs import metrics as jmetrics
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.obs import flight as tflight
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs.statusd import StatusServer
from repro_torch.serve import engine as tengine
from repro_torch.serve.scheduler import AdmissionScheduler

torch.set_num_threads(1)

COUNTERS = ("serve.preemptions", "serve.prefix.hits", "serve.prefix.misses",
            "serve.kernel.bytes_avoided")
HISTS = ("serve.ttft_s", "serve.tpot_s")


@pytest.fixture(scope="module")
def qwen():
    jcfg = jget("qwen3-14b", smoke=True)
    jp = jlm_init(jax.random.PRNGKey(0), jcfg)
    return (jcfg, jp, get_config("qwen3-14b", smoke=True),
            params_from_jax(jax.tree.map(np.asarray, jp)))


@pytest.fixture()
def registries():
    """Both packages' registries, cleared and enabled; disabled and cleared
    again afterwards."""
    regs = (jmetrics.REGISTRY, tmetrics.REGISTRY)
    for r in regs:
        r.clear()
        r.enable()
    yield regs
    for r in regs:
        r.disable()
        r.clear()


def _serve_reads(reg) -> dict:
    snap = reg.snapshot()
    out = {k: snap.get(k, 0) for k in COUNTERS}
    out["serve.pool_occupancy"] = snap.get("serve.pool_occupancy", 0.0)
    for h in HISTS:
        out[h] = snap[h]["count"] if h in snap else 0
        out[h + " series"] = len(reg.series(h))
    return out


def _churn(mod, cfg, run):
    """The preemption churn of ``tests/test_torch_engine.py``: returns the
    requests in order. ``run(reqs, max_steps)`` drives the engine."""
    Request = mod.Request
    r = np.random.default_rng(6)
    base = r.integers(1, cfg.vocab, 11)
    seed = Request(rid=100, prompt=base.copy(), max_new=4)
    steps = run([seed], None)
    fillers = [Request(rid=110 + i, prompt=np.concatenate(
        [base, r.integers(1, cfg.vocab, 2 + i)]), max_new=12,
        priority="batch") for i in range(3)]
    steps = run(fillers, steps + 4)
    inter = [Request(rid=120 + i, prompt=np.concatenate(
        [base, r.integers(1, cfg.vocab, 1 + i % 5)]), max_new=4)
        for i in range(5)]
    run(inter, 6000)
    return [seed] + fillers + inter


def _paged(mod, cfg, params, kernel, **kw):
    extra = ({"backend": JArrayBackend(cache=JCompileCache(persistent=False))}
             if mod is jengine else {"device": "cpu"})
    return mod.PagedServeEngine(cfg, params, slots=3, page_size=4,
                                pages_per_slot=8, pool_pages=16,
                                prefix_sharing=True, prefix_min_tokens=4,
                                kernel=kernel, **extra, **kw)


def _run_paged(mod, cfg, params, kernel):
    eng = _paged(mod, cfg, params, kernel)

    def run(reqs, max_steps):
        return eng.run(reqs, max_steps=max_steps or 10_000)["steps"]

    reqs = _churn(mod, cfg, run)
    assert all(q.done for q in reqs)
    return eng


def test_paged_engine_records_what_the_reference_records(qwen, registries):
    jcfg, jp, cfg, params = qwen
    jreg, treg = registries
    jeng = _run_paged(jengine, jcfg, jp, "pallas")
    teng = _run_paged(tengine, cfg, params, "paged")
    want, got = _serve_reads(jreg), _serve_reads(treg)
    assert got == want
    # the churn really preempted, shared and skipped dense views
    assert got["serve.preemptions"] > 0 and got["serve.prefix.hits"] > 0
    assert got["serve.kernel.bytes_avoided"] > 0
    assert 0.0 <= got["serve.pool_occupancy"] <= 1.0
    n_tok = sum(1 for r in teng.records if r.n_tokens > 0)
    assert got["serve.ttft_s"] == got["serve.tpot_s"] == n_tok
    for k in ("preemptions", "prefix_hits", "prefix_misses",
              "kv_bytes_avoided"):
        assert teng.stats[k] == jeng.stats[k], k
    assert (teng.stats["kv_bytes_avoided"]
            == got["serve.kernel.bytes_avoided"])
    assert teng.kv_row_bytes() == jeng.kv_row_bytes() > 0


def test_gather_kernel_avoids_no_bytes(qwen, registries):
    _, _, cfg, params = qwen
    _run_paged(tengine, cfg, params, "gather")
    reads = _serve_reads(registries[1])
    assert reads["serve.kernel.bytes_avoided"] == 0
    assert reads["serve.prefix.hits"] > 0


def _fixed_trace(mod, cfg):
    r = np.random.default_rng(2)
    return [mod.Request(rid=i, prompt=r.integers(1, cfg.vocab, n),
                        max_new=4) for i, n in enumerate((6, 9, 12, 8, 5))]


def test_fixed_engine_records_what_the_reference_records(qwen, registries):
    jcfg, jp, cfg, params = qwen
    jreg, treg = registries
    jengine.ServeEngine(
        jcfg, jp, slots=2, capacity=48,
        backend=JArrayBackend(cache=JCompileCache(persistent=False))).run(
        _fixed_trace(jengine, jcfg))
    tengine.ServeEngine(cfg, params, slots=2, capacity=48,
                        device="cpu").run(_fixed_trace(tengine, cfg))
    want, got = _serve_reads(jreg), _serve_reads(treg)
    assert got == want
    assert got["serve.ttft_s"] == got["serve.tpot_s"] == 5
    assert got["serve.ttft_s series"] == 5


def test_disabled_registry_records_nothing(qwen):
    _, _, cfg, params = qwen
    reg = tmetrics.REGISTRY
    reg.clear()
    assert not reg.enabled
    _run_paged(tengine, cfg, params, "paged")
    tengine.ServeEngine(cfg, params, slots=2, capacity=48,
                        device="cpu").run(_fixed_trace(tengine, cfg))
    reads = _serve_reads(reg)
    assert not any(reads.values()), reads
    assert reg.series("serve.slo_attainment") == []


@pytest.mark.parametrize("engine", ["paged", "fixed"])
def test_slo_breach_writes_a_flight_bundle(qwen, registries, tmp_path,
                                           engine):
    _, _, cfg, params = qwen
    rec = tflight.RECORDER
    rec.arm(str(tmp_path), slo_min=0.5, min_interval_s=0.0)
    try:
        sched = AdmissionScheduler(target_first_result_s=1e-9)
        if engine == "paged":
            eng = tengine.PagedServeEngine(cfg, params, slots=2, page_size=4,
                                           pages_per_slot=8, scheduler=sched,
                                           device="cpu")
        else:
            eng = tengine.ServeEngine(cfg, params, slots=2, capacity=48,
                                      scheduler=sched, device="cpu")
        stats = eng.run(_fixed_trace(tengine, cfg)[:3])
    finally:
        rec.disarm()
        rec.slo_min = 0.0
    assert stats["slo_attainment"] == 0.0
    bundles = sorted(tmp_path.glob("flight-*-slo_breach.json"))
    assert len(bundles) == 1
    doc = json.loads(bundles[0].read_text())
    assert doc["reason"] == "slo_breach"
    pts = registries[1].series("serve.slo_attainment")
    assert [v for _, v in pts] == [0.0]


def test_statusd_slo_route_reads_the_engine_histograms(qwen, registries):
    _, _, cfg, params = qwen
    eng = tengine.ServeEngine(cfg, params, slots=2, capacity=48,
                              device="cpu")
    eng.run(_fixed_trace(tengine, cfg))
    ttfts = [r.ttft_s for r in eng.records]
    srv = StatusServer().start()
    try:
        with urllib.request.urlopen(srv.url + "/slo", timeout=5) as resp:
            slo = json.loads(resp.read())
    finally:
        srv.stop()
    assert slo["classes"]["all"]["n"] == 5
    assert slo["classes"]["all"]["mean_ttft_s"] == pytest.approx(
        np.mean(ttfts))
