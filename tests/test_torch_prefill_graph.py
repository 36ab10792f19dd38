"""The serving engines' compiled prefill: the batched, warm-suffix and
fixed-ring prefill executables through the compile cache.

* Nothing of a prefill is read on the host: ``paged_prefill`` (batched,
  warm with ``starts``, an SSM config's exact-length batch, on both
  kernels) and the fixed engine's ``prefill`` run end to end on ``meta``
  tensors, the tables, tokens, lengths, slot ids and ``starts`` ``meta``
  too. A host read raises there, so this is the CPU-side guard against a
  value a capture would freeze into every replay.
* The device-side SSM store (``models.lm._ssm_store``) writes and drops
  exactly the rows the host-side store it replaces did: a slot takes the
  row naming it, out-of-range ids (dummy rows) write nothing.
* On the CPU, the paged engine (qwen3-14b with prefix sharing, kernel
  "gather" and "paged"; mamba2-1.3b, exact-length groups) and the fixed
  engine (qwen3-14b, mamba2-1.3b) serve through executables: tokens equal
  the engine run eagerly (``capture_step=False``) and the reference's
  engine up to the first near-tie; every prefill key reads ``"compiled"``,
  then ``"memory"`` on a second engine over the same cache.
* The fixed engine's prefill writes the prompt's rings into its slot in
  place and returns the logits only.
* A compile-cache key names the card's index: ``cuda:0`` and ``cuda:1``
  of one card name get different keys.
* ``cuda``-marked: a prefill replayed with new tables, slot ids, lengths
  and ``starts`` is bit-equal to an eager ``paged_prefill`` (logits and
  every pool leaf); two shapes alternating in one shared pool; one pool
  an engine, whatever the number of prefill shapes; the fixed engine's
  pool does not grow by a ring set a prompt length.

No JAX at module level: the ``cuda`` tests run on the card's machine with
``--noconftest``.
"""
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.core import compile_cache as cc
from repro_torch.core.backend import ArrayBackend
from repro_torch.launch.serve import init_params
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine

torch.set_num_threads(1)

META = torch.device("meta")


# ---------------------------------------------------------------------------
# No host read: every prefill on meta tensors
# ---------------------------------------------------------------------------

def _meta_ints(*shape):
    return torch.empty(shape, dtype=torch.int32, device=META)


@pytest.mark.parametrize("arch,case,kernel", [
    ("qwen3-14b", "batched", "paged"), ("qwen3-14b", "batched", "gather"),
    ("qwen3-14b", "warm", "paged"), ("qwen3-14b", "warm", "gather"),
    ("mamba2-1.3b", "batched", "paged"), ("mamba2-1.3b", "batched", "gather"),
    ("zamba2-7b", "batched", "paged"), ("deepseek-v2-236b", "batched",
                                        "paged"),
    ("qwen3-14b", "fixed", None), ("mamba2-1.3b", "fixed", None)])
def test_prefill_runs_on_meta_tensors(arch, case, kernel):
    cfg = get_config(arch, smoke=True)
    params = tlm.lm_init(None, cfg, META)
    B, S, npps = (1, 8, 4) if case == "warm" else (2, 16, 4)
    if case == "fixed":
        logits, caches = tlm.prefill(params, {"tokens": _meta_ints(1, S)},
                                     cfg, capacity=32)
        assert all(x.device == META for x in pytree.tree_leaves(caches))
    else:
        pool = tlm.paged_cache_init(cfg, 2, 8, 4, META)
        starts = _meta_ints(B) if case == "warm" else None
        logits, _ = tlm.paged_prefill(
            params, pool, _meta_ints(B, npps), _meta_ints(B, S),
            _meta_ints(B), cfg, slot_ids=_meta_ints(B), starts=starts,
            kernel=kernel)
    assert logits.device == META
    assert tuple(logits.shape) == (1 if case == "fixed" else B, 1, cfg.vocab)


# ---------------------------------------------------------------------------
# The device-side SSM store
# ---------------------------------------------------------------------------

def _host_store(pool_sub, new_sub, slot_ids):
    """The store it replaces: in-range ids selected on the host."""
    leaf = next(iter(pool_sub.values()))
    ids = torch.as_tensor(slot_ids).reshape(-1).long()
    rows = ((ids >= 0) & (ids < leaf.shape[1])).nonzero().reshape(-1)
    for k, pl in pool_sub.items():
        pl[:, ids[rows]] = new_sub[k][:, rows].to(pl.dtype)
    return pool_sub


@pytest.mark.parametrize("ids", [
    [0, 1, 2, 3], [2, 0, 3, 1], [1, 4, 4, 4], [4, 4, 4, 4], [3, -1, 0, 7],
    [2], [5, 2, 5, 0]])
def test_ssm_store_drops_out_of_range_rows_as_the_host_store_did(ids):
    g = torch.Generator().manual_seed(len(ids) + sum(ids))
    slots, B = 4, len(ids)
    pool = {"conv": torch.randn((3, slots, 5, 6), generator=g),
            "state": torch.randn((3, slots, 2, 4, 4), generator=g).to(
                torch.bfloat16)}
    new = {k: torch.randn((3, B) + v.shape[2:], generator=g)
           for k, v in pool.items()}
    want = _host_store({k: v.clone() for k, v in pool.items()}, new, ids)
    got = {k: v.clone() for k, v in pool.items()}
    ptrs = [v.data_ptr() for v in got.values()]
    tlm._ssm_store(got, new, torch.tensor(ids, dtype=torch.int32))
    assert [v.data_ptr() for v in got.values()] == ptrs       # in place
    for k in pool:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# The engines through their executables, on the CPU
# ---------------------------------------------------------------------------

def _waves(cls, vocab, ssm):
    """A system prompt alone, then prompts that extend it (a warm suffix
    prefill where prefixes are shared) and fresh prompts of two lengths
    (two buckets)."""
    r = np.random.default_rng(11)
    system = r.integers(1, vocab, 16)
    first = [cls(rid=0, prompt=system.copy(), max_new=3)]
    second = [cls(rid=1 + i, prompt=(
        np.concatenate([system, r.integers(1, vocab, 8)]) if i % 2 == 0
        else r.integers(1, vocab, 8 if ssm or i == 1 else 12)), max_new=4)
        for i in range(4)]
    return [first, second]


def _port_engine(kind, cfg, params, cache, capture, kernel):
    be = ArrayBackend(cache=cache, device="cpu")
    if kind == "fixed":
        return ServeEngine(cfg, params, slots=2, capacity=64, backend=be,
                           device="cpu", capture_step=capture)
    return PagedServeEngine(cfg, params, slots=2, page_size=4,
                            pages_per_slot=12, kernel=kernel,
                            prefix_sharing=True, prefix_min_tokens=8,
                            backend=be, device="cpu", capture_step=capture)


def _reference_outs(kind, arch, waves):
    from repro.core.backend import ArrayBackend as JBackend
    from repro.core.compile_cache import CompileCache as JCache
    from repro.serve.engine import PagedServeEngine as JPaged
    from repro.serve.engine import ServeEngine as JFixed
    from test_torch_engine import _load
    jcfg, jp, _, _ = _load(arch)
    be = JBackend(cache=JCache(persistent=False))
    if kind == "fixed":
        eng = JFixed(jcfg, jp, slots=2, capacity=64, backend=be)
    else:
        eng = JPaged(jcfg, jp, slots=2, page_size=4, pages_per_slot=12,
                     kernel="gather", prefix_sharing=True,
                     prefix_min_tokens=8, backend=be)
    for w in waves:
        eng.run(w, max_steps=500)
    return [list(map(int, r.out)) for w in waves for r in w]


# the prefill keys of ``_waves``: the paged engine buckets to powers of two
# and prefills a prefix hit's suffix warm (qwen3-14b) or groups exact
# lengths (mamba2-1.3b: no prefix sharing); the fixed engine compiles one
# executable a prompt length
KEYS = {("paged", "qwen3-14b"): {"prefill_b2_s16", "warm_s8",
                                 "prefill_b2_s8"},
        ("paged", "mamba2-1.3b"): {"prefill_b2_s16", "prefill_b2_s24",
                                   "prefill_b2_s8"},
        ("fixed", "qwen3-14b"): {"prefill_s16", "prefill_s24", "prefill_s8",
                                 "prefill_s12"},
        ("fixed", "mamba2-1.3b"): {"prefill_s16", "prefill_s24",
                                   "prefill_s8"}}


@pytest.mark.parametrize("kind,arch,kernel", [
    ("paged", "qwen3-14b", "gather"), ("paged", "qwen3-14b", "paged"),
    ("paged", "mamba2-1.3b", "auto"), ("fixed", "qwen3-14b", None),
    ("fixed", "mamba2-1.3b", None)])
def test_engine_prefill_executables_match_eager_and_reference(kind, arch,
                                                               kernel):
    from repro.serve.engine import Request as JRequest
    from test_torch_engine import _assert_match_modulo_ties, _load
    jcfg, _, cfg, params = _load(arch)
    ssm = arch == "mamba2-1.3b"
    cache = cc.CompileCache(persistent=False)
    outs, sources = {}, {}
    for run, capture in (("eager", False), ("compiled", True),
                         ("memory", True)):
        eng = _port_engine(kind, cfg, params,
                           cache if capture
                           else cc.CompileCache(persistent=False),
                           capture, kernel)
        waves = _waves(Request, cfg.vocab, ssm)
        for w in waves:
            eng.run(w, max_steps=500)
        assert all(r.done for w in waves for r in w)
        outs[run] = [list(map(int, r.out)) for w in waves for r in w]
        sources[run] = dict(eng.stats["compile_sources"])
    keys = KEYS[kind, arch] | {"step"}
    for run in ("eager", "compiled", "memory"):
        assert sources[run] == dict.fromkeys(keys, run), (run, sources[run])
    assert cache.stats["misses"] == len(keys)
    assert outs["compiled"] == outs["eager"] == outs["memory"]
    ref = _reference_outs(kind, arch, _waves(JRequest, jcfg.vocab, ssm))
    _assert_match_modulo_ties(cfg, params,
                              [r.prompt for w in waves for r in w], ref,
                              outs["compiled"])


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b"])
def test_fixed_prefill_writes_its_slot_in_place_and_returns_logits(arch):
    """``ServeEngine._prefill`` into slot 1 of 3: the slot's row of every
    ring leaf equals ``prefill``'s one-prompt caches, the other slots keep
    what they held, the leaves stay where they were, and what comes back
    is ``prefill``'s logits alone."""
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, "cpu")
    eng = ServeEngine(cfg, params, slots=3, capacity=32, device="cpu")
    g = torch.Generator().manual_seed(3)
    for x in pytree.tree_leaves(eng.caches):
        x.copy_(torch.randint(-3, 4, x.shape, generator=g).to(x.dtype))
    before = [x.clone() for x in pytree.tree_leaves(eng.caches)]
    ptrs = [x.data_ptr() for x in pytree.tree_leaves(eng.caches)]
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (1, 16)).astype(np.int32))
    logits = eng._prefill(toks, torch.tensor([1], dtype=torch.int32))
    want, rings = tlm.prefill(params, {"tokens": toks}, cfg, capacity=32)
    assert isinstance(logits, torch.Tensor) and torch.equal(logits, want)
    leaves = pytree.tree_leaves(eng.caches)
    assert [x.data_ptr() for x in leaves] == ptrs
    for got, old, new in zip(leaves, before, pytree.tree_leaves(rings)):
        assert torch.equal(got[:, 1], new[:, 0].to(got.dtype))
        assert torch.equal(got[:, 0], old[:, 0])
        assert torch.equal(got[:, 2], old[:, 2])
    assert eng.stats["compile_sources"]["prefill_s16"] == "compiled"


# ---------------------------------------------------------------------------
# The card's index in the key
# ---------------------------------------------------------------------------

def test_device_sig_names_the_card_index(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a, **k: "NVIDIA H100 80GB HBM3")
    sig = [cc._device_sig(torch.device("cuda", i)) for i in (0, 1)]
    assert sig[0] != sig[1]
    assert all("NVIDIA H100 80GB HBM3" in s for s in sig)
    assert cc._device_sig(torch.device("cuda", 1)) == sig[1]
    assert cc._device_sig(torch.device("cpu")) not in sig


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


_PARAMS = {}


def _model(arch, device):
    if arch not in _PARAMS:
        cfg = get_config(arch, smoke=True)
        _PARAMS[arch] = cfg, init_params(cfg, device)
    return _PARAMS[arch]


def _inputs(cfg, dev, B, S, npps, P, seed, warm):
    """One prefill's tables (a permutation of the pool's pages), tokens,
    lengths, slot ids (a permutation, one dummy row past the last slot
    when B > 1) and, for a warm call, ``starts``."""
    r = np.random.default_rng(seed)
    pages = r.permutation(P)[:B * npps].reshape(B, npps).astype(np.int32)
    lens = (np.full((B,), S) if warm or cfg.groups[0].pattern[0].ssm
            else r.integers(S // 2, S + 1, B)).astype(np.int32)
    sids = r.permutation(B).astype(np.int32)
    if B > 1:
        sids[-1] = B                         # a dummy row: writes nothing
        pages[-1] = -1
    ints = [torch.from_numpy(x).to(dev) for x in (
        pages, r.integers(1, cfg.vocab, (B, S)).astype(np.int32), lens,
        sids)]
    if warm:
        ints.append(torch.from_numpy(r.integers(
            0, 3, B).astype(np.int32) * 4).to(dev))
    return ints


def _prefill_fn(cfg, warm):
    def fn(p, kv, trows, toks, lens, sids, *starts):
        return tlm.paged_prefill(p, kv, trows, toks, lens, cfg,
                                 slot_ids=sids,
                                 starts=starts[0] if warm else None,
                                 kernel="paged")[0]
    return fn


def _assert_pools_equal(a, b):
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,warm", [("qwen3-14b", False),
                                       ("qwen3-14b", True),
                                       ("mamba2-1.3b", False)])
def test_cuda_prefill_replay_with_new_inputs_is_bit_equal(cuda_device, arch,
                                                          warm):
    """Captured with one set of tables, slot ids, lengths (and starts),
    replayed with others: logits and every pool leaf bit-equal to eager
    ``paged_prefill`` on a twin pool, the launch counts those of eager
    calls."""
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    cfg, params = _model(arch, cuda_device)
    B, S, npps, P, ps = (1, 8, 4, 16, 4) if warm else (3, 16, 5, 16, 4)
    pools = [tlm.paged_cache_init(cfg, B, P, ps, cuda_device)
             for _ in range(2)]
    fn = _prefill_fn(cfg, warm)
    exe = None
    for call in range(4):
        ints = _inputs(cfg, cuda_device, B, S, npps, P, call, warm)
        before = (paged_attention.launches, ssd_scan.launches)
        eager = fn(params, pools[0], *ints)
        n_eager = (paged_attention.launches - before[0],
                   ssd_scan.launches - before[1])
        if exe is None:
            exe, _ = ArrayBackend(
                cache=cc.CompileCache(persistent=False)).compile(
                fn, (params, pools[1], *ints), bind_argnums=(0, 1))
        before = (paged_attention.launches, ssd_scan.launches)
        graph = exe(params, pools[1], *ints).clone()
        assert (paged_attention.launches - before[0],
                ssd_scan.launches - before[1]) == n_eager
        assert torch.equal(eager, graph), call
        _assert_pools_equal(pools[0], pools[1])
    assert exe.replays == 3 and len(exe.graphs) == 1


@pytest.mark.cuda
def test_cuda_two_shapes_alternate_in_one_shared_pool(cuda_device):
    """A batched and a warm prefill over one binding capture into one
    pool and alternate, each replay bit-equal to eager on a twin pool."""
    cfg, params = _model("qwen3-14b", cuda_device)
    P, ps = 24, 4
    pools = [tlm.paged_cache_init(cfg, 3, P, ps, cuda_device)
             for _ in range(2)]
    cache = cc.CompileCache(persistent=False)
    be = ArrayBackend(cache=cache)
    shapes = {False: (3, 16, 5), True: (1, 8, 5)}
    exes = {}
    for call in range(6):
        warm = bool(call % 2)
        B, S, npps = shapes[warm]
        ints = _inputs(cfg, cuda_device, B, S, npps, P, 10 + call, warm)
        fn = _prefill_fn(cfg, warm)
        eager = fn(params, pools[0], *ints)
        if warm not in exes:
            exes[warm], _ = be.compile(fn, (params, pools[1], *ints),
                                       bind_argnums=(0, 1),
                                       extras=("warm" if warm else "cold",))
        graph = exes[warm](params, pools[1], *ints).clone()
        assert torch.equal(eager, graph), call
        _assert_pools_equal(pools[0], pools[1])
    graphs = [g for exe in exes.values() for g in exe.graphs.values()]
    assert len(graphs) == 2 and len(cache.pools) == 1
    assert graphs[0].graph.pool() == graphs[1].graph.pool()
    assert cache.stats["captures"] == 2 and cache.stats["replays"] == 4


def _engine_pools(cache):
    return {g.graph.pool() for exe in cache._mem.values()
            for g in getattr(exe, "graphs", {}).values()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,arch", [("paged", "qwen3-14b"),
                                       ("paged", "mamba2-1.3b"),
                                       ("fixed", "qwen3-14b")])
def test_cuda_one_pool_an_engine_whatever_the_shapes(cuda_device, kind,
                                                     arch):
    """An engine on the card: every prefill key compiled and captured
    once, the rest replayed; its step's and its prefills' graphs in one
    pool; tokens equal the engine run eagerly."""
    cfg, params = _model(arch, cuda_device)
    outs = {}
    for capture in (False, True):
        cache = cc.CompileCache(persistent=False)
        be = ArrayBackend(cache=cache, device=cuda_device)
        if kind == "fixed":
            eng = ServeEngine(cfg, params, slots=2, capacity=64, backend=be,
                              device=cuda_device, capture_step=capture)
        else:
            eng = PagedServeEngine(cfg, params, slots=2, page_size=4,
                                   pages_per_slot=12, kernel="paged",
                                   prefix_sharing=True, prefix_min_tokens=8,
                                   backend=be, device=cuda_device,
                                   capture_step=capture)
        waves = [w for _ in range(2)
                 for w in _waves(Request, cfg.vocab, arch == "mamba2-1.3b")]
        for w in waves:
            eng.run(w, max_steps=500)
        st = eng.stats
        outs[capture] = [list(map(int, r.out)) for w in waves for r in w]
        src = st["compile_sources"]
        if not capture:
            assert set(src.values()) == {"eager"}
            continue
        n_keys = len(src) - 1
        assert n_keys >= 3 and set(src.values()) == {"compiled"}
        assert cache.stats["captures"] == 1 + n_keys
        assert cache.stats["replays"] == (
            st["steps"] - 1 + st["prefill_dispatches"] - n_keys)
        assert len(_engine_pools(cache)) == 1
    assert outs[True] == outs[False]


def _pool_bytes(cache):
    pools = _engine_pools(cache)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) in pools)


@pytest.mark.cuda
def test_cuda_fixed_engine_pool_does_not_grow_a_ring_set_a_length(
        cuda_device):
    """The fixed engine serves eight prompt lengths (the longest first, so
    the first capture needs the most temporaries): each length's graph
    writes its rings into the slot and keeps only its logits, so the
    pool grows by less than ONE length's ring set over the seven later
    lengths (a graph that kept its rings would add seven)."""
    from repro_torch.models.lm import cache_init
    cfg, params = _model("qwen3-14b", cuda_device)
    capacity = 32768
    ring = sum(x.numel() * x.element_size() for x in pytree.tree_leaves(
        cache_init(cfg, 1, capacity, cuda_device)))
    cache = cc.CompileCache(persistent=False)
    eng = ServeEngine(cfg, params, slots=2, capacity=capacity,
                      backend=ArrayBackend(cache=cache, device=cuda_device),
                      device=cuda_device)
    r = np.random.default_rng(5)
    lengths = (40, 36, 31, 27, 22, 17, 12, 9)
    grown = []
    for i, n in enumerate(lengths):
        req = Request(rid=i, prompt=r.integers(1, cfg.vocab, n), max_new=2)
        eng.run([req])
        assert req.done
        torch.cuda.synchronize()
        grown.append(_pool_bytes(cache))
    keys = {k for k in eng.stats["compile_sources"] if k != "step"}
    assert keys == {f"prefill_s{n}" for n in lengths}
    assert len(_engine_pools(cache)) == 1
    assert grown[-1] - grown[0] < ring, (grown, ring)
