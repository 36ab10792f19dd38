"""The compile cache's disk tier and the graphs' lifetime
(``repro_torch.core.compile_cache``), on the CPU unless marked ``cuda``.

* The reference's disk-tier cases (``tests/test_compile_cache.py``), case
  for case on the port's records: LRU by bytes, recency refreshed by a
  disk hit, records of another version dropped on sight, the
  ``REPRO_COMPILE_CACHE_MAX_BYTES`` knob, an unbounded cache that never
  evicts, and a memory tier the budget does not touch.
* Persistence, as the reference's ``tests/test_launcher.py``
  (``test_compile_cache_persists_across_instances``) and
  ``tests/test_wine.py`` (``test_wine_cache_persists_across_processes``):
  a second cache over one directory reads ``"disk"``.
* What a record holds (JSON: key, name, extras, the input signature as
  ``TensorSpec``s, ``bind_argnums``), and the lookup an engine captures
  ahead from.
* Capture ahead is harmless: the engines' capture-ahead inputs, run
  eagerly on the CPU, leave the pool, the rings and the SSM state
  bit-equal to what they were (the paged pool's sink page aside), and a
  warm engine serves a cold engine's tokens.
* The same engine step has the same key in two processes.
* The reference's ``.aotx`` spills and the port's records share a
  directory and survive each other's prunes.
* A binding's graphs go when one of its tensors goes (``_Binding``).
* A record of another slot count is not made ahead: its batch would not
  fit the engine.
* ``cuda``: engines built and dropped in a loop keep ``memory_reserved()``
  flat and the pool count restored; a warm fixed engine holds no second
  ring set while it captures ahead; a second cache over one directory
  captures ahead and makes no capture on the request path.

JAX and the reference are imported only inside the tests that use them,
so the ``cuda`` tests run on the card's machine with ``--noconftest``.
"""
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.core import compile_cache as cc
from repro_torch.core.backend import ArrayBackend
from repro_torch.core.compile_cache import (RECORD_SUFFIX, CompileCache,
                                            _version_tag, record_args)
from repro_torch.models.lm import lm_init
from repro_torch.models.spec import TensorSpec
from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _fn(salt):
    """A distinct tiny program per salt (closure const changes the key)."""
    def f(x, _s=salt):
        return x * _s + _s
    return f


X = (np.ones((4,), np.float32),)


def _records(d):
    return sorted(f for f in os.listdir(d) if f.endswith(RECORD_SUFFIX))


def _entry_size(tmp_path):
    d = str(tmp_path / "probe")
    c = CompileCache(cache_dir=d)
    c.compile(_fn(0), X, extras=("probe",), device=CPU)
    files = _records(d)
    assert files, "spill did not happen; cannot size an entry"
    return os.path.getsize(os.path.join(d, files[0]))


def _compile(cache, salt, *extras):
    return cache.compile(_fn(salt), X, extras=extras, device=CPU)


# ---------------------------------------------------------------------------
# The reference's disk-tier cases (tests/test_compile_cache.py)
# ---------------------------------------------------------------------------

def test_lru_eviction_by_bytes(tmp_path):
    size = _entry_size(tmp_path)
    d = str(tmp_path / "graphs")
    cache = CompileCache(cache_dir=d, max_bytes=int(size * 1.5))
    _compile(cache, 1, "a")
    time.sleep(0.05)                       # distinct mtimes for LRU order
    _compile(cache, 2, "b")
    # two entries > budget: the older one must have been evicted
    assert cache.stats["evictions"] >= 1
    assert len(_records(d)) == 1
    fresh = CompileCache(cache_dir=d)      # new process, same dir
    _, src_a = _compile(fresh, 1, "a")
    _, src_b = _compile(fresh, 2, "b")
    assert src_a == "compiled"             # evicted: cold again
    assert src_b == "disk"                 # survivor: warm across processes


def test_lru_recency_refreshed_by_disk_hit(tmp_path):
    size = _entry_size(tmp_path)
    d = str(tmp_path / "graphs")
    warm = CompileCache(cache_dir=d)       # unbounded writer
    _compile(warm, 1, "a")
    time.sleep(0.05)
    _compile(warm, 2, "b")
    time.sleep(0.05)
    # a disk hit on A refreshes its mtime past B's
    reader = CompileCache(cache_dir=d, max_bytes=int(size * 2.5))
    _, src = _compile(reader, 1, "a")
    assert src == "disk"
    time.sleep(0.05)
    _compile(reader, 3, "c")               # spill -> prune over budget
    assert reader.stats["evictions"] >= 1
    check = CompileCache(cache_dir=d)
    _, src_a = _compile(check, 1, "a")
    _, src_b = _compile(check, 2, "b")
    assert src_a == "disk"                 # recently used: kept
    assert src_b == "compiled"             # least recently used: evicted


def test_alien_version_records_are_dropped(tmp_path):
    d = str(tmp_path / "graphs")
    os.makedirs(d)
    stale = os.path.join(d, "0" * 64 + ".deadbeef" + RECORD_SUFFIX)
    with open(stale, "w") as f:
        f.write('{"written": "by another torch, card or source tree"}')
    cache = CompileCache(cache_dir=d)
    _compile(cache, 1, "a")
    assert not os.path.exists(stale)
    assert cache.stats["version_drops"] == 1
    # current-version records carry the version tag in their name
    assert all(f.endswith(f".{_version_tag()}{RECORD_SUFFIX}")
               for f in _records(d))


def test_max_bytes_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_COMPILE_CACHE_MAX_BYTES", "12345")
    cache = CompileCache(cache_dir=str(tmp_path / "graphs"))
    assert cache.max_bytes == 12345
    monkeypatch.delenv("REPRO_COMPILE_CACHE_MAX_BYTES")
    assert CompileCache(cache_dir=str(tmp_path / "g2")).max_bytes is None
    # explicit argument wins over the env default
    monkeypatch.setenv("REPRO_COMPILE_CACHE_MAX_BYTES", "12345")
    assert CompileCache(cache_dir=str(tmp_path / "g3"),
                        max_bytes=77).max_bytes == 77


def test_unbounded_cache_never_evicts(tmp_path):
    d = str(tmp_path / "graphs")
    cache = CompileCache(cache_dir=d)
    for s in range(3):
        _compile(cache, s + 10, "u", s)
    assert cache.stats["evictions"] == 0
    assert len(_records(d)) == 3


@pytest.mark.parametrize("persistent", [True, False])
def test_memory_tier_unaffected_by_budget(tmp_path, persistent):
    """Eviction is a DISK policy: the in-memory tier still hits."""
    cache = CompileCache(cache_dir=str(tmp_path / "graphs"),
                         persistent=persistent, max_bytes=1)
    _compile(cache, 1, "m")
    _, src = _compile(cache, 1, "m")
    assert src == "memory"


# ---------------------------------------------------------------------------
# Persistence across caches (a fresh cache over one directory = a new
# process)
# ---------------------------------------------------------------------------

def app(x):
    return (x * x).sum()


def test_compile_cache_persists_across_instances(tmp_path):
    """The reference's case: the second cache's launch reads "disk". Its
    timing assertion has no counterpart: a disk hit makes the executable
    all the same (a graph captures on its first call)."""
    d = str(tmp_path / "graphs")
    inputs = np.ones((8, 4), np.float32)
    _, rec1 = ArrayBackend(cache=CompileCache(cache_dir=d),
                           device=CPU).launch(app, inputs, 8)
    _, rec2 = ArrayBackend(cache=CompileCache(cache_dir=d),
                           device=CPU).launch(app, inputs, 8)
    assert rec1.extra["compile_source"] == "compiled"
    assert rec2.extra["compile_source"] == "disk"


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_wine_cache_persists_across_processes(tmp_path, mode):
    """The reference's case, in every mode: a fresh cache over the same
    directory loads the app from the disk tier. Only prefill captures
    ahead (its first call changes no state); on the CPU nothing is
    captured."""
    from repro_torch.core.wine import WineAdapter, WineApp
    d = str(tmp_path / "graphs")
    app_ = WineApp(arch="qwen3-14b", mode=mode,
                   shape="train_4k" if mode == "train" else "prefill_32k",
                   smoke=True)
    a1 = WineAdapter(backend=ArrayBackend(cache=CompileCache(cache_dir=d),
                                          device=CPU))
    inst1 = a1.load(app_)
    assert inst1.load_report["compile_source"] == "compiled"
    a2 = WineAdapter(backend=ArrayBackend(cache=CompileCache(cache_dir=d),
                                          device=CPU))
    inst2 = a2.load(app_, state=inst1.state)
    assert inst2.load_report["compile_source"] == "disk"
    assert inst2.load_report["compile_cached"]
    assert inst2.load_report["capture_ahead"] == (mode == "prefill")
    assert not inst2.load_report["captured_ahead"]


# ---------------------------------------------------------------------------
# What a record holds, and the lookup an engine captures ahead from
# ---------------------------------------------------------------------------

def test_record_is_json_with_what_a_later_process_needs(tmp_path):
    d = str(tmp_path / "graphs")
    w = torch.ones(3, 2)
    state = {"w": w, "layers": [torch.zeros(2, dtype=torch.bfloat16)]}
    args = (state, TensorSpec((5, 3), torch.float32))

    def fn(s, x):
        return x @ s["w"]

    cache = CompileCache(cache_dir=d)
    cache.compile(fn, args, device=CPU, bind_argnums=(0,),
                  extras=("demo", 7))
    (fname,) = _records(d)
    with open(os.path.join(d, fname)) as f:
        rec = json.load(f)
    assert fname.startswith(rec["key"])
    assert rec["name"] == fn.__qualname__
    assert rec["extras"] == ["demo", 7, [0]]
    assert rec["bind_argnums"] == [0]
    assert rec["version"] == _version_tag()
    assert cc.abstractify(record_args(rec)) == cc.abstractify(args)
    # the signature alone rebuilds the key in a later cache
    again = CompileCache(cache_dir=d)
    _, src = again.compile(fn, record_args(rec), device=CPU,
                           bind_argnums=(0,), extras=("demo", 7))
    assert src == "disk"


def test_records_lookup_by_prefix_device_and_memory(tmp_path):
    d = str(tmp_path / "graphs")
    writer = CompileCache(cache_dir=d)
    for salt, extras in ((1, ("serve", "a", 4)), (2, ("serve", "a", 8)),
                         (3, ("serve", "b", 4)), (4, ("wave", 1))):
        writer.compile(_fn(salt), X, extras=extras, device=CPU)

    def found(recs):
        return sorted(tuple(r["extras"][:-1]) for r in recs)

    reader = CompileCache(cache_dir=d)
    assert found(reader.records(("serve", "a"))) == [
        ("serve", "a", 4), ("serve", "a", 8)]
    assert found(reader.records(("serve",), device=CPU)) == [
        ("serve", "a", 4), ("serve", "a", 8), ("serve", "b", 4)]
    assert len(reader.records()) == 4
    assert reader.records(("serve", "a"), device="meta") == []
    # a key this cache holds in memory is not the disk tier's to serve
    _compile(reader, 1, "serve", "a", 4)
    assert found(reader.records(("serve", "a"))) == [("serve", "a", 8)]
    assert writer.records(("serve",)) == []
    assert CompileCache(cache_dir=d, persistent=False).records() == []


def test_unreadable_record_is_a_miss_and_recorded_again(tmp_path):
    d = str(tmp_path / "graphs")
    _compile(CompileCache(cache_dir=d), 1, "a")
    (fname,) = _records(d)
    Path(d, fname).write_text("{not json")
    cache = CompileCache(cache_dir=d)
    _, src = _compile(cache, 1, "a")
    assert src == "compiled" and cache.stats["spills"] == 1
    _, src = _compile(CompileCache(cache_dir=d), 1, "a")
    assert src == "disk"


def test_spill_failure_counts_and_never_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("a file where the directory should be")
    cache = CompileCache(cache_dir=str(blocker / "graphs"))
    exe, src = _compile(cache, 1, "a")
    assert src == "compiled" and exe(*X).shape == (4,)
    assert cache.stats["spill_errors"] == 1 and cache.stats["spills"] == 0


def test_default_directory_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_COMPILE_CACHE_DIR", str(tmp_path))
    assert CompileCache().cache_dir == str(tmp_path / "repro_torch")
    monkeypatch.delenv("REPRO_COMPILE_CACHE_DIR")
    assert CompileCache().cache_dir == os.path.join(
        os.path.expanduser("~"), ".cache", "repro-torch-graphs")


# ---------------------------------------------------------------------------
# Capture ahead is harmless
# ---------------------------------------------------------------------------

def _params(arch):
    cfg = get_config(arch, smoke=True)
    return cfg, lm_init(torch.Generator().manual_seed(0), cfg, CPU)


def _trace(cfg, ssm):
    """Prompts that meet a batched prefill, a second bucket and (dense,
    with prefix sharing) a warm suffix."""
    r = np.random.default_rng(4)
    shared = r.integers(1, cfg.vocab, 16)
    lens = (6, 6, 12) if ssm else (6, 9, 12)
    reqs = [Request(rid=i, prompt=r.integers(1, cfg.vocab, n), max_new=4)
            for i, n in enumerate(lens)]
    if not ssm:
        reqs += [Request(rid=10, prompt=shared, max_new=3),
                 Request(rid=11, prompt=np.concatenate(
                     [shared, r.integers(1, cfg.vocab, 5)]), max_new=3)]
    return reqs


def _engine(kind, cfg, params, cache, kernel="gather"):
    be = ArrayBackend(cache=cache, device=CPU)
    if kind == "fixed":
        return ServeEngine(cfg, params, slots=2, capacity=48, device=CPU,
                           backend=be)
    return PagedServeEngine(cfg, params, slots=2, page_size=4,
                            pages_per_slot=12, device=CPU, backend=be,
                            kernel=kernel, prefix_sharing=True)


def _state(eng):
    return pytree.tree_leaves(eng.caches if isinstance(eng, ServeEngine)
                              else eng.kv)


CASES = [("paged", "qwen3-14b", "gather"), ("paged", "qwen3-14b", "paged"),
         ("paged", "mamba2-1.3b", "gather"), ("fixed", "qwen3-14b", None),
         ("fixed", "mamba2-1.3b", None)]


@pytest.mark.parametrize("kind,arch,kernel", CASES)
def test_capture_ahead_inputs_change_no_state(tmp_path, kind, arch, kernel):
    """A cold engine records its executables; a second cache over the same
    directory makes them at construction (source "disk") with harmless
    inputs. Run eagerly (on the card they are the warm-up of the capture
    ahead) over a pool and rings of random values, they leave every leaf
    of the paged pool bit-equal — its sink page lies past each leaf — and
    every leaf of the fixed engine's rings, which have no sink, as
    ``cache_init`` made them (a cold engine's); and the warm engine then
    serves the cold engine's tokens."""
    cfg, params = _params(arch)
    ssm = arch == "mamba2-1.3b"
    d = str(tmp_path / "graphs")
    cold = _engine(kind, cfg, params, CompileCache(cache_dir=d), kernel)
    trace = _trace(cfg, ssm)
    cold.run(trace)
    met = set(cold.stats["compile_sources"])
    assert len(met) >= (3 if ssm or kind == "fixed" else 4)

    warm = _engine(kind, cfg, params, CompileCache(cache_dir=d), kernel)
    assert warm.stats["compile_sources"] == dict.fromkeys(met, "disk")
    calls = warm._ahead_calls()
    assert len(calls) == len(met)
    g = torch.Generator().manual_seed(1)
    for x in _state(warm):
        x.copy_(torch.randint(-3, 4, x.shape, generator=g).to(x.dtype))
    before = [x.clone() for x in _state(warm)]
    warm._run_ahead(calls)
    if kind == "fixed":
        before = _state(_engine(kind, cfg, params,
                                CompileCache(persistent=False)))
    for got, want in zip(_state(warm), before):
        assert torch.equal(got, want)

    fresh = _engine(kind, cfg, params, CompileCache(cache_dir=d), kernel)
    init = [x.clone() for x in _state(fresh)]
    fresh._run_ahead(fresh._ahead_calls())
    for got, want in zip(_state(fresh), init):
        assert torch.equal(got, want)
    again = _trace(cfg, ssm)
    fresh.run(again)
    assert [r.out for r in again] == [r.out for r in trace]


@pytest.mark.parametrize("kind", ["paged", "fixed"])
def test_records_of_another_slot_count_are_not_made_ahead(tmp_path, kind):
    """A 4-slot engine records a 4-row prefill; a 2-slot engine over the
    same directory (the paged one with the same pool, whose shape does not
    depend on the slots) makes none of its executables ahead, so every
    call it runs ahead fits it; a second 4-slot engine makes them all."""
    cfg, params = _params("qwen3-14b")
    d = str(tmp_path / "graphs")

    def build(slots):
        be = ArrayBackend(cache=CompileCache(cache_dir=d), device=CPU)
        if kind == "fixed":
            return ServeEngine(cfg, params, slots=slots, capacity=48,
                               device=CPU, backend=be)
        return PagedServeEngine(cfg, params, slots=slots, page_size=4,
                                pages_per_slot=6, pool_pages=24, device=CPU,
                                backend=be)

    r = np.random.default_rng(7)
    four = build(4)
    trace = [Request(rid=i, prompt=r.integers(1, cfg.vocab, 6), max_new=2)
             for i in range(4)]
    four.run(trace)
    met = set(four.stats["compile_sources"])
    if kind == "paged":
        assert "prefill_b4_s8" in met
    two = build(2)
    assert two.stats["compile_sources"] == {"step": "compiled"}
    calls = two._ahead_calls()
    assert calls == []
    two._run_ahead(calls)
    again = build(4)
    assert again.stats["compile_sources"] == dict.fromkeys(met, "disk")
    calls = again._ahead_calls()
    assert len(calls) == len(met)
    again._run_ahead(calls)         # each signature holds (CPU: checked)


def test_cold_engine_makes_nothing_ahead(tmp_path):
    cfg, params = _params("qwen3-14b")
    eng = _engine("paged", cfg, params,
                  CompileCache(cache_dir=str(tmp_path / "graphs")))
    assert eng._ahead_calls() == []
    assert eng.stats["compile_sources"] == {"step": "compiled"}
    assert eng.stats["captured_ahead"] == 0 and eng.stats["t_build_s"] > 0


# ---------------------------------------------------------------------------
# One key for one engine step in two processes
# ---------------------------------------------------------------------------

_KEYS = """
import sys, torch
sys.modules["jax"] = None
from repro_torch.configs import get_config
from repro_torch.core.backend import ArrayBackend
from repro_torch.core.compile_cache import CompileCache
from repro_torch.models.lm import lm_init
from repro_torch.serve.engine import PagedServeEngine
cfg = get_config("qwen3-14b", smoke=True)
params = lm_init(torch.Generator().manual_seed(int(sys.argv[1])), cfg, "cpu")
cache = CompileCache(persistent=False)
PagedServeEngine(cfg, params, slots=2, page_size=4, pages_per_slot=8,
                 device="cpu", backend=ArrayBackend(cache=cache,
                                                    device="cpu"))
print(sorted(cache._mem))
"""


def test_engine_step_key_is_stable_across_processes():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    outs = [subprocess.run([sys.executable, "-c", _KEYS, str(seed)],
                           capture_output=True, text=True, env=env,
                           timeout=120, check=True).stdout.strip()
            for seed in (0, 1)]
    keys = eval(outs[0])
    assert len(keys) == 1 and outs[0] == outs[1]   # the weights are inputs


# ---------------------------------------------------------------------------
# The reference's spills and the port's records in one directory
# ---------------------------------------------------------------------------

def test_reference_spills_and_port_records_survive_each_other(
        tmp_path, monkeypatch):
    import jax.numpy as jnp
    from repro.core.compile_cache import CompileCache as RefCache
    from repro.core.compile_cache import _version_tag as ref_tag
    base = tmp_path / "base"
    base.mkdir()
    ref_alien = base / ("1" * 64 + ".deadbeef.aotx")
    port_alien = base / ("2" * 64 + ".deadbeef" + RECORD_SUFFIX)
    for p in (ref_alien, port_alien):
        p.write_text("stale")

    def ref_fn(x):
        return jnp.sin(x) * 2

    ref = RefCache(cache_dir=str(base))
    ref.compile(ref_fn, (np.ones((4,), np.float32),))
    port = CompileCache(cache_dir=str(base))
    _compile(port, 1, "a")
    names = set(os.listdir(base))
    assert f".{ref_tag()}.aotx" in "".join(names)
    assert not ref_alien.exists() and not port_alien.exists()
    assert ref.stats["version_drops"] == 1 == port.stats["version_drops"]
    mine = _records(base)
    theirs = sorted(n for n in names if n.endswith(".aotx"))
    assert len(mine) == 1 and len(theirs) == 1
    # new caches on both sides, each pruning over a budget of one byte:
    # each evicts its own files alone
    RefCache(cache_dir=str(base), max_bytes=1).compile(
        lambda x: jnp.cos(x), (np.ones((4,), np.float32),))
    assert set(_records(base)) == set(mine)
    RefCache(cache_dir=str(base)).compile(
        lambda x: jnp.exp(x), (np.ones((4,), np.float32),))
    theirs = sorted(n for n in os.listdir(base) if n.endswith(".aotx"))
    assert len(theirs) == 1
    _compile(CompileCache(cache_dir=str(base), max_bytes=1), 2, "b")
    assert not _records(base)
    assert sorted(n for n in os.listdir(base)
                  if n.endswith(".aotx")) == theirs
    # by default the port's records sit in a folder of their own
    monkeypatch.setenv("REPRO_COMPILE_CACHE_DIR", str(base))
    _compile(CompileCache(), 3, "c")
    assert len(_records(base / "repro_torch")) == 1
    RefCache(cache_dir=str(base)).compile(
        lambda x: jnp.tan(x), (np.ones((4,), np.float32),))
    assert len(_records(base / "repro_torch")) == 1


# ---------------------------------------------------------------------------
# A binding's graphs go with its tensors
# ---------------------------------------------------------------------------

class _Holder:
    """An executable's stand-in: a map of binding -> graph."""

    def __init__(self):
        self.graphs = {}


def _bind(pools, *tensors):
    ptrs = tuple(t.data_ptr() for t in tensors)
    key = (torch.device(CPU), ptrs)
    b = pools[key] = cc._Binding(
        key, {id(s): s for s in (t.untyped_storage() for t in tensors)
              }.values(), pools)
    holders = [_Holder(), _Holder()]
    for h in holders:
        h.graphs[ptrs] = cc._Graph(None, [], None, [], bound=b)
        b.holders.add(h)
    return ptrs, holders


def test_binding_graphs_are_released_with_any_bound_tensor():
    pools = {}
    weights, pool = torch.ones(8), torch.zeros(4)
    halves = pool[:2], pool[2:]
    ptrs, holders = _bind(pools, weights, *halves)
    assert len(pools) == 1
    del pool                   # the views still hold the storage
    gc.collect()
    assert all(ptrs in h.graphs for h in holders) and len(pools) == 1
    # an engine drops its caches: every graph of the binding goes
    ptrs2, holders2 = _bind(pools, weights, torch.zeros(3))
    gc.collect()
    assert all(not h.graphs for h in holders2) and len(pools) == 1
    assert all(ptrs in h.graphs for h in holders)
    assert not cc._GRAVE


def test_graph_keeps_no_output_that_is_a_bound_tensor():
    """A train step returns its state: a graph that kept it would keep its
    own binding alive. The replay hands back the call's bound tensors."""
    state = {"w": torch.ones(3), "opt": [torch.zeros(2)]}
    bound = pytree.tree_leaves(state)
    metrics = torch.tensor(1.5)
    g = cc._Graph(None, [], (state, metrics), [], bound_leaves=bound)
    assert g.aliased and g.out is None
    assert all(x is None for x in g.out_leaves[:2])
    again = [b.view_as(b) for b in bound]          # the next call's objects
    new_state, m = g.outputs(again)
    assert new_state["w"] is again[0] and new_state["opt"][0] is again[1]
    assert m is metrics
    plain = cc._Graph(None, [], metrics * 2, [], bound_leaves=bound)
    assert not plain.aliased and plain.outputs(again) is plain.out


def test_released_graphs_wait_for_a_running_capture():
    pools = {}
    cache = torch.zeros(4)
    _, holders = _bind(pools, cache)
    cc._capturing += 1
    try:
        del cache
        assert not pools and all(not h.graphs for h in holders)
        assert len(cc._GRAVE) == 2          # unlinked, not yet destroyed
    finally:
        cc._capturing -= 1
    cc._bury()
    assert not cc._GRAVE


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_params(arch="qwen3-14b"):
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, lm_init(gen, cfg, "cuda")


def _card_engine(cfg, params, cache):
    return PagedServeEngine(cfg, params, slots=2, page_size=4,
                            pages_per_slot=12, device="cuda",
                            backend=ArrayBackend(cache=cache, device="cuda"),
                            prefix_sharing=True)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs the card")
def test_cuda_dropped_engines_free_their_graphs(tmp_path):
    cfg, params = _card_params()
    cache = CompileCache(cache_dir=str(tmp_path / "graphs"))
    pools0 = len(cache.pools)
    reserved = []
    for i in range(5):
        eng = _card_engine(cfg, params, cache)
        eng.run(_trace(cfg, False))
        assert len(cache.pools) == pools0 + 1
        del eng
        gc.collect()
        torch.cuda.synchronize()
        assert len(cache.pools) == pools0
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[-1] - reserved[0] <= 64 * 2**20, reserved
    assert not any(getattr(exe, "graphs", {}) for exe in cache._mem.values())


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs the card")
def test_cuda_warm_fixed_engine_holds_no_second_ring_set(tmp_path):
    """A fixed engine whose rings dwarf everything else, built cold and
    served one prompt, then built warm over the same directory: capturing
    ahead, the warm build peaks less than half a ring set above the cold
    engine's build and first request, which captured the same graphs (a
    copy of the rings to restore them from would add a whole set), and
    its request path then captures nothing."""
    from repro_torch.models.lm import cache_init
    cfg, params = _card_params()
    d = str(tmp_path / "graphs")
    slots, capacity = 2, 32768
    rings = sum(x.numel() * x.element_size() for x in pytree.tree_leaves(
        cache_init(cfg, slots, capacity, "cuda")))
    gc.collect()
    prompt = np.random.default_rng(3).integers(1, cfg.vocab, 24)
    peaks, outs = [], []
    for _ in range(2):
        cache = CompileCache(cache_dir=d)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eng = ServeEngine(cfg, params, slots=slots, capacity=capacity,
                          device="cuda",
                          backend=ArrayBackend(cache=cache, device="cuda"))
        ahead = cache.stats["captures"]
        if not peaks:                   # cold: its graphs captured here
            req = Request(rid=0, prompt=prompt, max_new=4)
            eng.run([req])
            outs.append(req.out)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        if len(peaks) == 2:
            assert ahead == 2 and eng.stats["captured_ahead"] == 2
            req = Request(rid=0, prompt=prompt, max_new=4)
            eng.run([req])
            outs.append(req.out)
            assert cache.stats["captures"] == ahead
        del eng
        gc.collect()
    assert peaks[1] < peaks[0] + rings // 2, (peaks, rings)
    assert outs[0] == outs[1]


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs the card")
def test_cuda_second_cache_captures_ahead(tmp_path):
    cfg, params = _card_params()
    d = str(tmp_path / "graphs")
    cold = _card_engine(cfg, params, CompileCache(cache_dir=d))
    trace = _trace(cfg, False)
    cold.run(trace)
    met = set(cold.stats["compile_sources"])
    del cold
    gc.collect()
    cache = CompileCache(cache_dir=d)
    warm = _card_engine(cfg, params, cache)
    assert warm.stats["compile_sources"] == dict.fromkeys(met, "disk")
    assert warm.stats["captured_ahead"] == len(met)
    ahead = cache.stats["captures"]
    assert ahead == len(met)
    again = _trace(cfg, False)
    warm.run(again)
    assert cache.stats["captures"] == ahead      # none on the request path
    assert [r.out for r in again] == [r.out for r in trace]
