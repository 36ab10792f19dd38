"""The port's paged serving engine against the reference's, on the CPU.

* The trace of ``tests/test_paged_attention.py::
  test_engine_tokens_identical_dense_gather_pallas`` through the port's
  ``PagedServeEngine`` (kernel "gather" and "paged") and the reference's
  paged engine with ``kernel="gather"``, on qwen3-14b-smoke and on
  gemma2-27b-smoke (windows and softcaps; the prompts stay under the smoke
  window of 64, since the reference's gather prefill loses rows past it). Contract: token streams are equal
  until the first near-tie — where they first differ, the port's own
  full-forward logits at that point must have a top-2 gap below the
  reference's ``_ULP_TIE`` (the two packages round bf16 activations at
  different points; see ``tests/test_torch_lm.py``).
* Prefix sharing with copy-on-write: a warm replay of a registered prompt
  gives the cold run's tokens, the pinned prefix's pool rows stay
  bit-identical under a sharer's divergent writes, and ``PagePool.check()``
  stays clean through preemption churn.
* The reference's page-pool tests, run against both ``repro.serve.kv_pool``
  and the port's copy.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.lm import lm_init as jlm_init
from repro.serve import kv_pool as j_kv_pool
from repro.serve.engine import PagedServeEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.lm import lm_hidden, lm_logits
from repro_torch.serve import kv_pool as t_kv_pool
from repro_torch.serve.engine import PagedServeEngine, Request
from test_paged_attention import _ULP_TIE

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

KERNELS = ["gather", "paged"]


_LOADED = {}


def _load(arch):
    if arch not in _LOADED:
        jcfg = jget(arch, smoke=True)
        jp = jlm_init(jax.random.PRNGKey(0), jcfg)
        _LOADED[arch] = (jcfg, jp, get_config(arch, smoke=True),
                         params_from_jax(jax.tree.map(np.asarray, jp)))
    return _LOADED[arch]


@pytest.fixture(scope="module")
def qwen():
    return _load("qwen3-14b")


def _engine(cfg, params, kernel, **kw):
    return PagedServeEngine(cfg, params, kernel=kernel, device="cpu", **kw)


def _gap_at(cfg, params, tokens) -> float:
    """Top-2 logit gap of the port's full forward after ``tokens``."""
    toks = torch.as_tensor(np.asarray(tokens, np.int32))[None]
    h, _ = lm_hidden(params, {"tokens": toks}, cfg)
    top2 = torch.topk(lm_logits(params, h[:, -1:], cfg).float()[0, 0], 2)[0]
    return float(top2[0] - top2[1])


def _assert_match_modulo_ties(cfg, params, prompts, ref_outs, outs):
    for prompt, a, b in zip(prompts, ref_outs, outs):
        assert len(a) == len(b)
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff:
            i = diff[0]
            gap = _gap_at(cfg, params, list(prompt) + list(a[:i]))
            assert gap < _ULP_TIE, (prompt.tolist(), a, b, i, gap)


def _trace(cls, vocab):
    r = np.random.default_rng(9)
    return [cls(rid=i, prompt=r.integers(1, vocab, 6 + 2 * i), max_new=3)
            for i in range(3)]


_TRACES = {}


def _reference_trace(arch):
    if arch not in _TRACES:
        jcfg, jp, _, _ = _load(arch)
        t = _trace(JRequest, jcfg.vocab)
        JEngine(jcfg, jp, slots=2, page_size=4, pages_per_slot=4,
                kernel="gather").run(t, max_steps=500)
        assert all(r.done for r in t)
        _TRACES[arch] = [r.prompt for r in t], [r.out for r in t]
    return _TRACES[arch]


# qwen3-14b's cases keep their ids from before gemma2-27b's
@pytest.mark.parametrize("arch,kernel", [
    pytest.param("qwen3-14b", k, id=k) for k in KERNELS] + [
    pytest.param("gemma2-27b", k, id=f"gemma2-27b-{k}") for k in KERNELS])
def test_engine_trace_matches_reference(arch, kernel):
    _, _, cfg, params = _load(arch)
    t = _trace(Request, cfg.vocab)
    launches = paged_attention.launches
    eng = _engine(cfg, params, kernel, slots=2, page_size=4,
                  pages_per_slot=4)
    eng.run(t, max_steps=500)
    assert all(r.done for r in t)
    assert paged_attention.launches == launches       # CPU: plain version
    assert eng.stats["compile_sources"]["step"] == "eager"
    prompts, ref_outs = _reference_trace(arch)
    _assert_match_modulo_ties(cfg, params, prompts, ref_outs,
                              [r.out for r in t])


def test_auto_kernel_is_gather_on_cpu(qwen):
    _, _, cfg, params = qwen
    assert _engine(cfg, params, "auto", slots=2).kernel == "gather"
    with pytest.raises(ValueError):
        _engine(cfg, params, "pallas", slots=2)


@pytest.mark.parametrize("kernel", KERNELS)
def test_warm_replay_matches_cold_and_cow_keeps_prefix(qwen, kernel):
    """Mid-page divergence: the sharer COWs the boundary page and writes
    its suffix into the copy; the pinned prefix's rows stay bit-identical,
    and replaying the ORIGINAL prompt warm yields the cold tokens."""
    _, _, cfg, params = qwen
    r = np.random.default_rng(3)
    p1 = r.integers(1, cfg.vocab, 18)                    # boundary mid-page
    eng = _engine(cfg, params, kernel, slots=4, page_size=4,
                  pages_per_slot=8, pool_pages=28, prefix_sharing=True)
    a = Request(rid=0, prompt=p1.copy(), max_new=4)
    eng.run([a])
    eng.pool.check()
    assert eng.stats["prefix_registered"] == 1
    (key,) = eng.pool.prefix_keys()
    pinned = eng.pool._prefix[key]["pages"]
    leaf = eng.kv[0]["0"]["attn"]
    before = {k: v[:, pinned].clone() for k, v in leaf.items()}
    p2 = np.concatenate([p1, r.integers(1, cfg.vocab, 5)])
    b = Request(rid=1, prompt=p2, max_new=4)
    eng.run([b])
    eng.pool.check()
    assert eng.stats["prefix_hits"] == 1
    assert eng.stats["cow_pages"] >= 1
    for k, v in leaf.items():                            # prefix untouched
        assert torch.equal(v[:, pinned], before[k]), k
    c = Request(rid=2, prompt=p1.copy(), max_new=4)
    eng.run([c])
    eng.pool.check()
    assert eng.stats["prefix_hits"] == 2
    _assert_match_modulo_ties(cfg, params, [p1], [a.out], [c.out])
    # and the warm continuation matches a cold engine on the same prompt
    cold = Request(rid=3, prompt=p2.copy(), max_new=4)
    _engine(cfg, params, kernel, slots=4, page_size=4,
            pages_per_slot=8).run([cold])
    _assert_match_modulo_ties(cfg, params, [p2], [cold.out], [b.out])


def test_warm_prefill_writes_only_suffix(qwen):
    _, _, cfg, params = qwen
    r = np.random.default_rng(4)
    p1 = r.integers(1, cfg.vocab, 16)                    # page-aligned
    eng = _engine(cfg, params, "paged", slots=4, page_size=4,
                  pages_per_slot=8, pool_pages=28, prefix_sharing=True)
    eng.run([Request(rid=0, prompt=p1.copy(), max_new=2)])
    cold_rows = eng.stats["prefill_rows"]
    assert cold_rows == 16
    p2 = np.concatenate([p1, r.integers(1, cfg.vocab, 6)])
    eng.run([Request(rid=1, prompt=p2, max_new=2)])
    assert eng.stats["prefill_rows"] - cold_rows == 6    # suffix only
    assert eng.stats["prefix_hits"] == 1
    eng.pool.check()


@pytest.mark.parametrize("kernel", KERNELS)
def test_preemption_churn_keeps_pool_clean(qwen, kernel):
    """The leak gate of the reference's fig_prefix bench: a seed registers
    a base prompt (unaligned, so sharers COW its boundary page), batch
    fillers warm-admit onto it and hold every slot mid-flight, then
    interactive extensions preempt them. Every request completes, the
    allocator invariants hold, and dropping the pins frees every page."""
    _, _, cfg, params = qwen
    r = np.random.default_rng(6)
    base = r.integers(1, cfg.vocab, 11)
    eng = _engine(cfg, params, kernel, slots=3, page_size=4,
                  pages_per_slot=8, pool_pages=16, prefix_sharing=True,
                  prefix_min_tokens=4)
    seed = Request(rid=100, prompt=base.copy(), max_new=4)
    eng.run([seed])
    fillers = [Request(rid=110 + i, prompt=np.concatenate(
        [base, r.integers(1, cfg.vocab, 2 + i)]), max_new=12,
        priority="batch") for i in range(3)]
    eng.run(fillers, max_steps=eng.stats["steps"] + 4)
    assert not any(q.done for q in fillers)
    inter = [Request(rid=120 + i, prompt=np.concatenate(
        [base, r.integers(1, cfg.vocab, 1 + i % 5)]), max_new=4)
        for i in range(5)]
    stats = eng.run(inter, max_steps=6000)
    assert all(q.done for q in [seed] + fillers + inter)
    assert stats["prefix_hits"] > 0 and stats["preemptions"] > 0
    assert stats["cow_pages"] > 0
    eng.pool.check()
    for k in eng.pool.prefix_keys():
        eng.pool.drop_prefix(k)
    eng.pool.check()
    assert eng.pool.used_pages == 0                     # zero leaked pages


# ---------------------------------------------------------------------------
# The reference's PagePool tests, against both copies
# ---------------------------------------------------------------------------

POOLS = pytest.mark.parametrize(
    "PagePool", [j_kv_pool.PagePool, t_kv_pool.PagePool],
    ids=["reference", "port"])


@POOLS
def test_pool_refcount_share_cow_release(PagePool):
    pool = PagePool(n_pages=16, page_size=4, slots=4, pages_per_slot=6)
    assert pool.alloc(0, 3) is not None
    pages = pool.pages_of(0)
    assert pool.register_prefix(b"k", list(range(8)), pages[:2])
    pool.check()
    assert not pool.writable(0, pages[0]) and pool.writable(0, pages[2])
    e = pool.lookup_prefix(b"k", list(range(9)))
    assert e is not None and e["pages"] == pages[:2]
    assert pool.lookup_prefix(b"k", [0, 1, 99]) is None  # token-verified
    assert pool.share(1, e["pages"]) and pool.alloc(1, 1) is not None
    pool.check()
    assert int(pool.refcount[pages[0]]) == 3             # slot0+slot1+registry
    src, dst = pool.cow_page(1, 1)
    assert src == pages[1] and pool.writable(1, dst)
    pool.check()
    assert pool.free_slot(0) == [pages[2]]
    freed = pool.free_slot(1)
    assert pages[0] not in freed and dst in freed
    pool.check()
    assert int(pool.refcount[pages[0]]) == 1             # registry pin only
    assert set(pool.drop_prefix(b"k")) == set(pages[:2])
    pool.check()
    assert pool.free_pages == pool.n_pages


@POOLS
def test_pool_prefix_eviction_lru(PagePool):
    pool = PagePool(n_pages=8, page_size=4, slots=4, pages_per_slot=4)
    for s, key in enumerate([b"a", b"b"]):
        pool.alloc(s, 2)
        pool.register_prefix(key, [s] * 8, pool.pages_of(s))
        pool.free_slot(s)
    pool.check()
    assert pool.free_pages == 4
    pool.lookup_prefix(b"a", [0] * 8)                    # touch a: b is LRU
    pool.evict_prefixes(6)
    assert pool.prefix_keys() == [b"a"]
    pool.check()
    pool.evict_prefixes(pool.n_pages)
    assert pool.free_pages == pool.n_pages
    pool.check()


@POOLS
def test_pool_check_catches_refcount_leak(PagePool):
    pool = PagePool(n_pages=8, page_size=4, slots=2, pages_per_slot=4)
    pool.alloc(0, 2)
    pool.refcount[pool.pages_of(0)[0]] += 1              # corrupt on purpose
    with pytest.raises(AssertionError):
        pool.check()
