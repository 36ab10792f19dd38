"""The port's SSM family (mamba2, zamba2) against the reference, at smoke
width on the CPU (the SSD scan runs its plain version here).

* ``ssm_apply``, prefill (one chunk and several) and decode, against EAGER
  JAX in bf16: the conv caches are bit-equal (projections, the bf16 causal
  conv, silu and the f32-summed decode conv window round at the same
  points); the f32 state agrees to 1e-6 relative (the scan's f32 sums run
  in another order); the block's bf16 output is bit-equal on more than 99%
  of its elements and elsewhere within one bf16 ulp of its scale (an f32
  difference of the scan can flip a bf16 rounding of y).
* mamba2-1.3b-smoke and zamba2-7b-smoke: ``paged_prefill`` into permuted
  slots (plus a dummy row) and 4 ``paged_decode_step`` against the
  reference's, logits at atol 3e-2 and greedy tokens equal up to the first
  near-tie (the contract of ``tests/test_torch_lm.py``: the reference runs
  its layers in ``lax.scan``, where XLA skips some bf16 roundings).
* The engine's token trace against the reference's ``PagedServeEngine``:
  exact-length prefill groups, prefix sharing asked for and forced off.
* The chunked scan against the decode recurrence (prefill vs the same
  prompt fed token by token): in bf16 within the reference's duality
  contract and with the reference's own gap; in f32 equal to 1e-5.
* The port of ``tests/test_serve.py::test_stall_is_value_neutral_for_ssm_
  state``: page-starved zamba2 slots stall and retry, and their tokens equal
  an unpressured run's — the ``live`` mask keeps a stalled slot's SSM state.
* ``convert`` carries the f32 SSM leaves and the slot-dense pool leaves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve.engine import PagedServeEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, pool_from_jax
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import lm as tlm
from repro_torch.models.blocks import tree_map
from repro_torch.models import ssm as tssm
from repro_torch.serve.engine import PagedServeEngine, Request
from test_paged_attention import (_ULP_TIE,
                                  _assert_tokens_match_modulo_ties)
from test_torch_engine import _assert_match_modulo_ties

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

LOGIT_ATOL = 3e-2
ARCHS = ["mamba2-1.3b", "zamba2-7b"]
KERNELS = ["gather", "paged"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        cfg = jget(arch, smoke=True)
        jp = jlm.lm_init(jax.random.PRNGKey(0), cfg)
        out[arch] = (cfg, jp, tget(arch, smoke=True),
                     params_from_jax(_np(jp)))
    return out


# ---------------------------------------------------------------------------
# ssm_apply against eager JAX
# ---------------------------------------------------------------------------

def _bf16(a):
    return params_from_jax(np.asarray(a))


@pytest.mark.parametrize("S,chunk", [(12, 256), (16, 8)],
                         ids=["one_chunk", "three_chunks_carry"])
def test_ssm_apply_matches_eager_jax(S, chunk):
    cfg = jget("mamba2-1.3b", smoke=True)
    tcfg = tget("mamba2-1.3b", smoke=True)
    spec = dataclasses.replace(cfg.groups[0].pattern[0].ssm, chunk=chunk)
    jp = jssm.ssm_init(jax.random.PRNGKey(1), cfg.d_model, spec, cfg)
    tp = params_from_jax(_np(jp))
    x = jnp.asarray(np.random.default_rng(S).standard_normal(
        (2, S + 1, cfg.d_model)), jnp.bfloat16)
    jc = jssm.ssm_cache_init(2, cfg.d_model, spec)
    tc = tssm.ssm_cache_init(2, cfg.d_model, spec, "cpu")
    # prefill, then decode one token from the prefilled cache
    for xs in (x[:, :S], x[:, S:]):
        jy, jc = jssm.ssm_apply(jp, xs, spec, cfg, None, cache=jc)
        ty = tssm.ssm_apply(tp, _bf16(xs), spec, tcfg, None, cache=tc)
        assert ty.dtype == torch.bfloat16
        a, b = ty.float().numpy(), np.asarray(jy, np.float32)
        # bit-equal but where the scan's f32 sums, run in another order,
        # flip a bf16 rounding of y (1 element of 3072 at S=12)
        assert (a != b).mean() < 1e-2
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2 ** -8 * np.abs(b).max())
        for k in ("conv_x", "conv_B", "conv_C"):
            assert torch.equal(tc[k], _bf16(jc[k])), k
        np.testing.assert_allclose(tc["state"].numpy(),
                                   np.asarray(jc["state"]), rtol=1e-6,
                                   atol=1e-6 * float(jnp.abs(
                                       jc["state"]).max()))


def test_ssm_init_leaves_match_reference():
    cfg = jget("mamba2-1.3b", smoke=True)
    spec = cfg.groups[0].pattern[0].ssm
    jp = jssm.ssm_init(jax.random.PRNGKey(0), cfg.d_model, spec, cfg)
    tp = tssm.ssm_init(None, cfg.d_model, spec, tget("mamba2-1.3b", True),
                       "meta")
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(v.dtype), k
    jc = jssm.ssm_cache_init(3, cfg.d_model, spec)
    tc = tssm.ssm_cache_init(3, cfg.d_model, spec, "cpu")
    for k, v in jc.items():
        assert torch.equal(tc[k], params_from_jax(np.asarray(v))), k


# ---------------------------------------------------------------------------
# paged_prefill + paged_decode_step against the reference
# ---------------------------------------------------------------------------

_j_prefill = jax.jit(jlm.paged_prefill, static_argnames=("cfg", "kernel"))
_j_decode = jax.jit(jlm.paged_decode_step, static_argnames=("cfg", "kernel"))


def _problem(seed, slots=3, ps=4, npps=6, S=10, vocab=512):
    """Fragmented page tables per slot; equal-length prompts (SSM prefill
    groups have one length) in rows that land in permuted slots, plus one
    dummy row (slot id out of range, table -1, length 0)."""
    r = np.random.default_rng(seed)
    P = slots * npps
    perm = r.permutation(P)
    tables = np.full((slots, npps), -1, np.int32)
    for s in range(slots):
        tables[s, :npps - 1] = perm[s * (npps - 1):(s + 1) * (npps - 1)]
    sids = np.append(r.permutation(slots), slots).astype(np.int32)
    trows = np.full((slots + 1, npps), -1, np.int32)
    trows[:slots] = tables[sids[:slots]]
    toks = r.integers(1, vocab, (slots + 1, S)).astype(np.int32)
    toks[slots] = 0
    lens = np.full((slots + 1,), S, np.int32)
    lens[slots] = 0
    return P, ps, tables, trows, sids, toks, lens


def _run_jax(cfg, params, prob, steps=4):
    P, ps, tables, trows, sids, toks, lens = prob
    slots = tables.shape[0]
    pool = jlm.paged_cache_init(cfg, slots, P, ps)
    lg, pool = _j_prefill(params, pool, jnp.asarray(trows),
                          jnp.asarray(toks), jnp.asarray(lens),
                          jnp.asarray(sids), cfg=cfg, kernel="gather")
    by_slot = np.empty((slots,), int)
    by_slot[sids[:slots]] = np.arange(slots)          # slot -> prefill row
    logits = [np.asarray(lg[by_slot, 0], np.float32)]
    pos = jnp.full((slots, 1), toks.shape[1], jnp.int32)
    for _ in range(steps):
        t = jnp.asarray(logits[-1].argmax(-1)[:, None].astype(np.int32))
        lg, pool = _j_decode(params, pool, jnp.asarray(tables), t, pos,
                             cfg=cfg, kernel="gather")
        logits.append(np.asarray(lg[:, 0], np.float32))
        pos = pos + 1
    return np.stack(logits), by_slot, pool


def _run_torch(cfg, params, prob, kernel, feed, by_slot, steps=4):
    P, ps, tables, trows, sids, toks, lens = prob
    slots = tables.shape[0]
    pool = tlm.paged_cache_init(cfg, slots, P, ps, "cpu")
    lg, pool = tlm.paged_prefill(params, pool, torch.from_numpy(trows),
                                 torch.from_numpy(toks),
                                 torch.from_numpy(lens), cfg,
                                 slot_ids=sids, kernel=kernel)
    logits = [lg[by_slot, 0].float().numpy()]
    pos = torch.full((slots, 1), toks.shape[1], dtype=torch.int32)
    for s in range(steps):
        t = torch.from_numpy(np.ascontiguousarray(feed[s][:, None],
                                                  np.int32))
        lg, pool = tlm.paged_decode_step(params, pool,
                                         torch.from_numpy(tables), t, pos,
                                         cfg, kernel=kernel)
        logits.append(lg[:, 0].float().numpy())
        pos = pos + 1
    return np.stack(logits), pool


def _gaps(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serving_path_matches_reference(models, arch):
    cfg, jp, tcfg, tp = models[arch]
    prob = _problem(5)
    j_logits, by_slot, j_pool = _run_jax(cfg, jp, prob)
    feed = j_logits[:-1].argmax(-1)                    # reference greedy
    j_pool = pool_from_jax(_np(j_pool))
    for kernel in KERNELS:
        t_logits, t_pool = _run_torch(tcfg, tp, prob, kernel, feed, by_slot)
        np.testing.assert_allclose(t_logits, j_logits, atol=LOGIT_ATOL,
                                   rtol=0, err_msg=kernel)
        _assert_tokens_match_modulo_ties(
            j_logits.argmax(-1), _gaps(j_logits), t_logits.argmax(-1),
            (arch, kernel))
        js, ts = j_pool[0]["0"]["ssm"], t_pool[0]["0"]["ssm"]
        assert ts["state"].shape == js["state"].shape   # (R, slots, H, P, N)
        scale = float(js["state"].abs().max())
        np.testing.assert_allclose(ts["state"].numpy(), js["state"].numpy(),
                                   atol=2e-2 * scale, rtol=0, err_msg=kernel)


def test_prefill_writes_only_the_named_slots(models):
    """Out-of-range slot ids are dropped; slots no row names keep their
    state; the SSD scan's wrapper ran its plain version (no launch)."""
    _, _, cfg, params = models["mamba2-1.3b"]
    pool = tlm.paged_cache_init(cfg, 3, 4, 4, "cpu")
    for leaf in pool[0]["0"]["ssm"].values():
        leaf.fill_(7)
    launches = ssd_scan.launches
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 8)).astype(np.int32))
    tlm.paged_prefill(params, pool, torch.full((2, 1), -1, dtype=torch.int32),
                      toks, torch.full((2,), 8), cfg, slot_ids=[2, 9],
                      kernel="paged")
    assert ssd_scan.launches == launches
    st = pool[0]["0"]["ssm"]["state"]
    assert bool((st[:, :2] == 7).all()) and not bool((st[:, 2] == 7).all())


@pytest.mark.parametrize("kernel", KERNELS)
def test_decode_live_mask_keeps_stalled_state(models, kernel):
    _, _, cfg, params = models["zamba2-7b"]
    prob = _problem(6)
    P, ps, tables, trows, sids, toks, lens = prob
    pool = tlm.paged_cache_init(cfg, 3, P, ps, "cpu")
    tlm.paged_prefill(params, pool, torch.from_numpy(trows),
                      torch.from_numpy(toks), torch.from_numpy(lens), cfg,
                      slot_ids=sids, kernel=kernel)
    before = {k: v.clone() for k, v in pool[0]["0"]["ssm"].items()}
    t = torch.ones((3, 1), dtype=torch.int32)
    pos = torch.full((3, 1), toks.shape[1], dtype=torch.int32)
    live = torch.tensor([True, False, True])
    tlm.paged_decode_step(params, pool, torch.from_numpy(tables), t, pos,
                          cfg, live=live, kernel=kernel)
    for k, v in pool[0]["0"]["ssm"].items():
        assert torch.equal(v[:, 1], before[k][:, 1]), k
        if k == "state":
            assert not torch.equal(v[:, 0], before[k][:, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_vs_recurrence_gap_matches_reference(models, arch):
    """A prompt prefilled through the chunked scan and the same prompt fed
    token by token through the decode recurrence round bf16 at different
    points (bf16 conv taps vs an f32-summed window, other product shapes),
    in both packages. The port keeps the reference's duality contract
    (tests/test_consistency.py: logits within 5% of their scale), and its
    gap is the reference's own (measured ratio 0.96-1.13 at S=16 and 64)."""
    cfg, jp, tcfg, tp = models[arch]
    B, S, ps = 3, 16, 4
    r = np.random.default_rng(8)
    toks = r.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    tables = np.arange(B * 6, dtype=np.int32).reshape(B, 6)
    gaps = {}
    pool = jlm.paged_cache_init(cfg, B, B * 6, ps)
    scan, _ = _j_prefill(jp, pool, jnp.asarray(tables), jnp.asarray(toks),
                         jnp.full((B,), S), jnp.arange(B), cfg=cfg,
                         kernel="gather")
    pool = jlm.paged_cache_init(cfg, B, B * 6, ps)
    for i in range(S):
        rec, pool = _j_decode(jp, pool, jnp.asarray(tables),
                              jnp.asarray(toks[:, i:i + 1]),
                              jnp.full((B, 1), i, jnp.int32), cfg=cfg,
                              kernel="gather")
    gaps["reference"] = (np.asarray(scan, np.float32),
                         np.asarray(rec, np.float32))
    tt = torch.from_numpy(tables)
    pool = tlm.paged_cache_init(tcfg, B, B * 6, ps, "cpu")
    scan, _ = tlm.paged_prefill(tp, pool, tt, torch.from_numpy(toks),
                                torch.full((B,), S), tcfg, kernel="paged")
    pool = tlm.paged_cache_init(tcfg, B, B * 6, ps, "cpu")
    for i in range(S):
        rec, pool = tlm.paged_decode_step(
            tp, pool, tt, torch.from_numpy(toks[:, i:i + 1].copy()),
            torch.full((B, 1), i, dtype=torch.int32), tcfg, kernel="paged")
    gaps["port"] = (scan.float().numpy(), rec.float().numpy())
    rel = {k: float(np.abs(a - b).max() / np.abs(a).max())
           for k, (a, b) in gaps.items()}
    assert rel["reference"] < 0.05 and rel["port"] < 0.05, rel
    assert 0.5 < rel["port"] / rel["reference"] < 2.0, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_equals_recurrence_in_f32(models, arch):
    """With weights, activations and caches in f32 the chunked scan and the
    recurrence compute one function: the bf16 gap above is rounding, not a
    difference in what the paths compute (measured 4e-7 relative)."""
    _, _, cfg, params = models[arch]
    params = tree_map(lambda a: a.float(), params)
    B, S, ps = 3, 16, 4
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        1, cfg.vocab, (B, S)).astype(np.int32))
    tables = torch.arange(B * 6, dtype=torch.int32).reshape(B, 6)

    def pool():
        return tree_map(lambda a: a.float() if a.is_floating_point() else a,
                        tlm.paged_cache_init(cfg, B, B * 6, ps, "cpu"))

    scan_pool = pool()
    scan, _ = tlm.paged_prefill(params, scan_pool, tables, toks,
                                torch.full((B,), S), cfg, kernel="paged")
    rec_pool = pool()
    for i in range(S):
        rec, _ = tlm.paged_decode_step(
            params, rec_pool, tables, toks[:, i:i + 1].contiguous(),
            torch.full((B, 1), i, dtype=torch.int32), cfg, kernel="paged")
    assert float((rec - scan).abs().max() / scan.abs().max()) < 1e-5
    a = scan_pool[0]["0"]["ssm"]["state"]
    b = rec_pool[0]["0"]["ssm"]["state"]
    assert float((a - b).abs().max() / b.abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# The engine against the reference's
# ---------------------------------------------------------------------------

def _trace(cls, vocab, lens=(6, 9, 6, 9, 7), max_new=4, seed=11):
    r = np.random.default_rng(seed)
    return [cls(rid=i, prompt=r.integers(1, vocab, n), max_new=max_new)
            for i, n in enumerate(lens)]


@pytest.fixture(scope="module")
def reference_traces(models):
    out = {}
    for arch in ARCHS:
        cfg, jp, _, _ = models[arch]
        t = _trace(JRequest, cfg.vocab)
        eng = JEngine(cfg, jp, slots=3, page_size=4, pages_per_slot=4,
                      kernel="gather", prefix_sharing=True)
        eng.run(t, max_steps=500)
        assert all(r.done for r in t)
        out[arch] = ([r.prompt for r in t], [r.out for r in t],
                     eng.stats["prefill_dispatches"])
    return out


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_trace_matches_reference(models, reference_traces, arch,
                                        kernel):
    _, _, cfg, params = models[arch]
    t = _trace(Request, cfg.vocab)
    eng = PagedServeEngine(cfg, params, slots=3, page_size=4,
                           pages_per_slot=4, kernel=kernel,
                           prefix_sharing=True, device="cpu")
    assert not eng._prefix_ok and not eng._pad_safe
    assert eng._bucket(6) == 6 and eng._bucket(9) == 9
    eng.run(t, max_steps=500)
    assert all(r.done for r in t)
    prompts, ref_outs, dispatches = reference_traces[arch]
    assert eng.stats["prefix_hits"] == 0
    assert eng.stats["prefill_dispatches"] == dispatches
    _assert_match_modulo_ties(cfg, params, prompts, ref_outs,
                              [r.out for r in t])
    eng.pool.check()


@pytest.mark.parametrize("kernel", KERNELS)
def test_stall_is_value_neutral_for_ssm_state(models, kernel):
    """A stalled (page-less) slot's retry must be IDENTICAL: its attention
    write drops on the missing page and the ``live`` mask keeps its SSM
    state — without it the recurrence absorbs the stalled token twice and
    the hybrid model's tokens diverge from an unpressured run."""
    jcfg, jp, cfg, params = models["zamba2-7b"]
    mk = lambda cls: _trace(cls, cfg.vocab, lens=(6, 9, 6, 9),  # noqa: E731
                            max_new=6, seed=13)
    calm, pressed = mk(Request), mk(Request)
    PagedServeEngine(cfg, params, slots=2, page_size=2, pages_per_slot=8,
                     batched_prefill=False, kernel=kernel,
                     device="cpu").run(calm, max_steps=300)
    eng = PagedServeEngine(cfg, params, slots=2, page_size=2,
                           pages_per_slot=8, pool_pages=8,
                           batched_prefill=False, kernel=kernel,
                           device="cpu")
    stats = eng.run(pressed, max_steps=600)
    assert stats["stall_steps"] > 0          # pressure actually happened
    assert stats["pool_exhausted"] == 0
    assert all(r.done for r in calm + pressed)
    for a, b in zip(calm, pressed):
        assert a.out == b.out, (a.rid, a.out, b.out)
    # and the reference's engine under the same pressure
    ref = mk(JRequest)
    JEngine(jcfg, jp, slots=2, page_size=2, pages_per_slot=8, pool_pages=8,
            batched_prefill=False, kernel="gather").run(ref, max_steps=600)
    _assert_match_modulo_ties(cfg, params, [r.prompt for r in ref],
                              [r.out for r in ref], [r.out for r in pressed])


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def test_convert_carries_ssm_params_and_slot_dense_pool(models):
    cfg, jp, tcfg, tp = models["zamba2-7b"]
    jssm_p = _np(jp["groups"][0]["stacked"]["0"]["ssm"])
    tssm_p = tp["groups"][0]["stacked"]["0"]["ssm"]
    for k in ("dt_bias", "A_log", "D"):
        assert tssm_p[k].dtype == torch.float32
        np.testing.assert_array_equal(tssm_p[k].numpy(), jssm_p[k])
    assert torch.equal(tssm_p["w_x"].view(torch.int16),
                       torch.from_numpy(jssm_p["w_x"].view(np.int16).copy()))
    P, ps, tables, trows, sids, toks, lens = _problem(7)
    pool = jlm.paged_cache_init(cfg, 3, P, ps)
    _, pool = _j_prefill(jp, pool, jnp.asarray(trows), jnp.asarray(toks),
                         jnp.asarray(lens), jnp.asarray(sids), cfg=cfg,
                         kernel="gather")
    tpool = pool_from_jax(_np(pool))
    mine = tlm.paged_cache_init(tcfg, 3, P, ps, "cpu")
    jpool = _np(pool)
    for bi in ("0", "1", "2"):
        for k, v in jpool[0][bi]["ssm"].items():
            t = tpool[0][bi]["ssm"][k]
            assert t.shape == mine[0][bi]["ssm"][k].shape == v.shape
            assert t.dtype == mine[0][bi]["ssm"][k].dtype
            assert np.array_equal(t.view(torch.int16).numpy() if
                                  t.dtype == torch.bfloat16 else t.numpy(),
                                  v.view(np.int16) if t.dtype ==
                                  torch.bfloat16 else v), (bi, k)
    assert _ULP_TIE > LOGIT_ATOL
