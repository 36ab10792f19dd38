"""The port's LM paged serving path against the reference's, at smoke width.

Converted smoke params run ``paged_prefill`` + ``paged_decode_step`` over a
fragmented pool in both packages, the port on both its kernels ("gather",
and "paged" — the kernel's plain version on the CPU): qwen3-14b with the
reference on ``kernel="gather"``; the windowed family (gemma2-27b,
gemma3-12b) and stablelm-12b with prompts of 40-80 tokens past the smoke
window of 64 and the reference on ``kernel="pallas"`` (its Pallas kernel in
interpret mode), since the reference's gather prefill loses rows of
windowed layers in a ragged batch
(``test_windowed_gather_prefill_keeps_every_row``); olmoe-1b-7b (MoE) with
each port path against the reference path of the same rounding (gather
against gather, paged against the Pallas kernel).

MoE configs are held against the reference run eagerly
(``jax.disable_jit()``: its ``lax.scan`` becomes a Python loop). Inside the
scan, XLA's fusion moves the router's bf16 input by an ulp here and there,
which flips the top-k choice of a near-tied token and, through the
capacity drop, the queue places of others: on olmoe-1b-7b-smoke the
reference's own scan and eager forwards differ by 1.43 in the final hidden
states. The port is held to the eager one, as every layer test holds it
to eager JAX.

Tolerances and why: every layer of the port is bit-equal to the eager
reference (``tests/test_torch_layers.py``), but the reference runs its
layers inside ``lax.scan``, where XLA fuses elementwise chains and skips
some intermediate bf16 roundings that the port (like eager JAX) performs.
Activations therefore differ by about one bf16 ulp per layer:
  * logits: atol 3e-2 at logit scale ~1 (a few bf16 ulps);
  * written pool rows: k/v within rtol 2**-6 and atol 2**-4 — two bf16
    ulps of the rows' largest entries (|x| < 4 after qk-norm and rope),
    since an entry near zero inherits the error of its whole row — on the
    first block (every repeat of it); positions exactly on every block;
  * greedy tokens: equal until the first near-tie (the reference's
    ``_ULP_TIE`` contract from ``tests/test_paged_attention.py``).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, pool_from_jax
from repro_torch.models import lm as tlm
from test_paged_attention import (_ULP_TIE,
                                  _assert_tokens_match_modulo_ties)

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

LOGIT_ATOL = 3e-2
ROW_TOL = dict(rtol=2 ** -6, atol=2 ** -4)
ARCH = "qwen3-14b"
WINDOWED = ("gemma2-27b", "gemma3-12b")
_LOADED = {}


def _load(arch):
    """(reference cfg, reference params, port cfg, converted params) of
    ``arch``'s smoke config, drawn once per module."""
    if arch not in _LOADED:
        cfg = get_config(arch, smoke=True)
        jp = jlm.lm_init(jax.random.PRNGKey(0), cfg)
        _LOADED[arch] = (cfg, jp, tget(arch, smoke=True),
                         params_from_jax(jax.tree.map(np.asarray, jp)))
    return _LOADED[arch]


@pytest.fixture(scope="module")
def models():
    return _load(ARCH)


def _problem(seed, slots=3, ps=4, npps=8, S=8, vocab=512, lo=2):
    """Fragmented page tables (one spare page slot per slot for decode)
    and right-padded prompts of ``lo``..``S`` tokens, as numpy."""
    r = np.random.default_rng(seed)
    P = slots * npps
    perm = r.permutation(P)
    tables = np.full((slots, npps), -1, np.int32)
    for b in range(slots):
        tables[b, :npps - 1] = perm[b * (npps - 1):(b + 1) * (npps - 1)]
    toks = r.integers(1, vocab, (slots, S)).astype(np.int32)
    lens = r.integers(lo, S + 1, (slots,)).astype(np.int32)
    return P, ps, tables, toks, lens


# compiled once per module (cfg is static), shared by every problem
_j_prefill = jax.jit(jlm.paged_prefill, static_argnames=("cfg", "kernel"))
_j_decode = jax.jit(jlm.paged_decode_step, static_argnames=("cfg", "kernel"))


def _is_moe(cfg):
    return any(b.moe is not None for g in cfg.groups for b in g.pattern)


def _reference_mode(cfg):
    """Eager JAX for MoE configs (see the module docstring), else as is."""
    return jax.disable_jit() if _is_moe(cfg) else contextlib.nullcontext()


def _run_jax(cfg, params, prob, steps=4, kernel="gather"):
    with _reference_mode(cfg):
        return _run_jax_steps(cfg, params, prob, steps, kernel)


def _run_jax_steps(cfg, params, prob, steps, kernel):
    P, ps, tables, toks, lens = prob
    slots = len(lens)
    tables = jnp.asarray(tables)
    pool = jlm.paged_cache_init(cfg, slots, P, ps)
    lg, pool = _j_prefill(params, pool, tables, jnp.asarray(toks),
                          jnp.asarray(lens), jnp.arange(slots, dtype=jnp.int32),
                          cfg=cfg, kernel=kernel)
    logits = [np.asarray(lg[:, 0], np.float32)]
    pos = jnp.asarray(lens[:, None])
    for _ in range(steps):
        t = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        lg, pool = _j_decode(params, pool, tables, t, pos, cfg=cfg,
                             kernel=kernel)
        logits.append(np.asarray(lg[:, 0], np.float32))
        pos = pos + 1
    return np.stack(logits), pool


def _run_torch(cfg, params, prob, kernel, feed, steps=4):
    """``feed`` (steps, slots): the tokens fed back at each decode step —
    the reference's greedy picks, so both runs see the same histories."""
    P, ps, tables, toks, lens = prob
    slots = len(lens)
    tbl = torch.from_numpy(tables)
    pool = tlm.paged_cache_init(cfg, slots, P, ps, "cpu")
    lg, pool = tlm.paged_prefill(params, pool, tbl, torch.from_numpy(toks),
                                 torch.from_numpy(lens), cfg, kernel=kernel)
    logits = [lg[:, 0].float().numpy()]
    pos = torch.from_numpy(lens[:, None].copy())
    for s in range(steps):
        t = torch.from_numpy(np.ascontiguousarray(feed[s][:, None],
                                                  np.int32))
        lg, pool = tlm.paged_decode_step(params, pool, tbl, t, pos, cfg,
                                         kernel=kernel)
        logits.append(lg[:, 0].float().numpy())
        pos = pos + 1
    return np.stack(logits), pool


def _gaps(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _attn_leaves(pool):
    """Every attention sub-cache of a pool tree, in order."""
    return [btree["attn"] for gtree in pool for btree in gtree.values()
            if "attn" in btree]


# (arch, seed); the first two keep their ids from before the other archs
SERVING = ([pytest.param(ARCH, s, id=str(s)) for s in (1, 2)]
           + [pytest.param(a, 1, id=a) for a in
              WINDOWED + ("stablelm-12b", "olmoe-1b-7b")])
# prompts of 40-80 tokens past the smoke window of 64, 16-row pages, and
# decode past the window; the reference on its Pallas kernel (interpret)
PAST_WINDOW = ("gemma2-27b", "gemma3-12b", "stablelm-12b")


@pytest.mark.parametrize("arch,seed", SERVING)
def test_paged_serving_path_matches_reference(arch, seed):
    cfg, jp, tcfg, tp = _load(arch)
    if arch in PAST_WINDOW:
        prob, steps = _problem(seed, ps=16, S=80, lo=40), 6
        ref_kernel = dict.fromkeys(("gather", "paged"), "pallas")
    elif _is_moe(cfg):
        # each path against the reference's path of the same rounding: the
        # paged kernel scales f32 scores where gather folds the scale into
        # q in bf16, and that ulp moves a near-tied token's experts
        prob, steps = _problem(seed), 4
        ref_kernel = {"gather": "gather", "paged": "pallas"}
    else:
        prob, steps = _problem(seed), 4
        ref_kernel = dict.fromkeys(("gather", "paged"), "gather")
    refs = {}
    for kernel in ("gather", "paged"):
        rk = ref_kernel[kernel]
        if rk not in refs:
            j_logits, j_pool = _run_jax(cfg, jp, prob, steps, rk)
            refs[rk] = (j_logits, j_logits[:-1].argmax(-1),  # greedy feed
                        pool_from_jax(jax.tree.map(np.asarray, j_pool)))
        j_logits, feed, j_pool = refs[rk]
        t_logits, t_pool = _run_torch(tcfg, tp, prob, kernel, feed, steps)
        np.testing.assert_allclose(t_logits, j_logits, atol=LOGIT_ATOL,
                                   rtol=0, err_msg=kernel)
        _assert_tokens_match_modulo_ties(
            j_logits.argmax(-1), _gaps(j_logits), t_logits.argmax(-1),
            (kernel, seed))
        # positions on every attention leaf; rows on the first block's
        # (every repeat of it), as before the other archs: the drift of
        # about one bf16 ulp a layer compounds past ROW_TOL deeper down
        # (gemma3-12b-smoke's sixth layer: 0.076), where the logits hold it
        for ja, ta in zip(_attn_leaves(j_pool), _attn_leaves(t_pool)):
            assert torch.equal(ja["pos"], ta["pos"]), kernel
        ja, ta = j_pool[0]["0"]["attn"], t_pool[0]["0"]["attn"]
        written = (ja["pos"] >= 0).numpy()
        for leaf in ("k", "v"):
            np.testing.assert_allclose(
                ta[leaf].float().numpy()[written],
                ja[leaf].float().numpy()[written], **ROW_TOL, err_msg=leaf)


def test_paged_equals_gather_on_the_port(models):
    """The port's two kernels on the same fed tokens: the paged path's
    scores are scaled in f32 while the gather path folds the scale into q
    in bf16 — the same sub-ulp split as the reference's, so logits agree
    to the same contract."""
    _, _, tcfg, tp = models
    prob = _problem(3)
    feed = np.random.default_rng(0).integers(1, 512, (4, 3))
    a, _ = _run_torch(tcfg, tp, prob, "gather", feed)
    b, _ = _run_torch(tcfg, tp, prob, "paged", feed)
    np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0)
    _assert_tokens_match_modulo_ties(a.argmax(-1), _gaps(a), b.argmax(-1),
                                     "paged-vs-gather")
    assert _ULP_TIE > LOGIT_ATOL


def test_decode_matches_full_forward(models):
    """Torch mirror of tests/test_consistency.py::test_decode_matches_full_
    forward for qwen3: a prefill + ring decode reproduces the full forward's
    logits (rel 0.05, the reference test's bound)."""
    _, _, cfg, params = models
    B, S, TAIL = 2, 16, 4
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    h, _ = tlm.lm_hidden(params, {"tokens": toks}, cfg)
    full = tlm.lm_logits(params, h, cfg).float()
    sp = S - TAIL
    lg, caches = tlm.prefill_batched(params, {"tokens": toks[:, :sp]}, cfg,
                                     torch.full((B,), sp), capacity=S)
    outs = [lg]
    for i in range(sp, S):
        lg, caches = tlm.decode_step(params, caches, toks[:, i:i + 1],
                                     torch.full((B, 1), i,
                                                dtype=torch.int32), cfg)
        outs.append(lg)
    dec = torch.cat(outs[:-1], dim=1).float()
    ref = full[:, sp - 1:S - 1]
    err = float((dec - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 0.05, f"decode/full mismatch rel={err:.3e}"


@pytest.mark.parametrize("arch", ["gemma2-27b", "stablelm-12b", "gemma3-12b",
                                  "olmoe-1b-7b"])
def test_full_forward_matches_reference_other_dense(arch):
    """The block variants the serving path does not reach on qwen3 —
    sliding windows, attention and final softcaps, sandwich norms, embed
    scaling, GeGLU (gemma2); LayerNorm with bias-free scale, partial rope,
    parallel residual (stablelm); a 5:1 local/global pattern with two rope
    thetas and qk-norm (gemma3); MoE blocks (olmoe) — through ``lm_hidden``
    + ``lm_logits``."""
    cfg = get_config(arch, smoke=True)
    jp = jlm.lm_init(jax.random.PRNGKey(1), cfg)
    tcfg, tp = tget(arch, smoke=True), params_from_jax(
        jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 80))
    toks = toks.astype(np.int32)           # 80 > the smoke window of 64
    with _reference_mode(cfg):
        h, _, aux = jlm.lm_hidden(jp, {"tokens": jnp.asarray(toks)}, cfg)
        a = np.asarray(jlm.lm_logits(jp, h, cfg), np.float32)
    h, t_aux = tlm.lm_hidden(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    b = tlm.lm_logits(tp, h, tcfg).float().numpy()
    np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0)
    # the MoE load-balance loss summed over layers (0 without MoE), within
    # the f32 tolerance of tests/test_torch_layers.py
    np.testing.assert_allclose(float(t_aux), float(aux), atol=1e-5,
                               rtol=1e-5)
    assert (float(aux) > 0) == _is_moe(cfg)


@pytest.mark.parametrize("S", [1, 5, 8, 12], ids=lambda s: f"S{s}")
def test_ring_update_matches_reference(S):
    """Ring writes, including a prefill longer than the ring (the roll)."""
    from repro.models.attention import _ring_update as j_ring
    from repro_torch.models.attention import _ring_update as t_ring
    r = np.random.default_rng(S)
    B, cap = 2, 8
    cache = dict(k=r.standard_normal((B, cap, 2, 4)).astype(np.float32),
                 v=r.standard_normal((B, cap, 2, 4)).astype(np.float32),
                 pos=np.full((B, cap), -1, np.int32))
    new = dict(k=r.standard_normal((B, S, 2, 4)).astype(np.float32),
               v=r.standard_normal((B, S, 2, 4)).astype(np.float32))
    start = np.array([[3], [13]]) if S == 1 else np.zeros((B, 1), int)
    pos = (start + np.arange(S)[None]).astype(np.int32)
    a = j_ring({k: jnp.asarray(x) for k, x in cache.items()},
               {k: jnp.asarray(x) for k, x in new.items()}, jnp.asarray(pos))
    b = t_ring({k: torch.from_numpy(x.copy()) for k, x in cache.items()},
               {k: torch.from_numpy(x) for k, x in new.items()},
               torch.from_numpy(pos))
    for k in cache:
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


def test_pool_ops_match_reference(models):
    """paged_gather, then paged_copy and paged_clear (in place on the
    port's pool, chained on the reference's) on a filled pool."""
    cfg, jp, tcfg, tp = models
    P, ps, tables, toks, lens = _problem(4)
    jpool = jlm.paged_cache_init(cfg, 3, P, ps)
    _, jpool = _j_prefill(jp, jpool, jnp.asarray(tables), jnp.asarray(toks),
                          jnp.asarray(lens), jnp.arange(3, dtype=jnp.int32),
                          cfg=cfg, kernel="gather")
    tpool = pool_from_jax(jax.tree.map(np.asarray, jpool))

    def same(j_tree, t_tree):
        j_tree = pool_from_jax(jax.tree.map(np.asarray, j_tree))
        for leaf in ("k", "v", "pos"):
            assert torch.equal(t_tree[0]["0"]["attn"][leaf],
                               j_tree[0]["0"]["attn"][leaf]), leaf

    same(jlm.paged_gather(jpool, jnp.asarray(tables)),
         tlm.paged_gather(tpool, torch.from_numpy(tables)))
    src, dst = [int(tables[0, 0]), 1], [5, P + 3]       # 2nd pair drops
    jpool = jlm.paged_copy(jpool, src, dst)
    same(jpool, tlm.paged_copy(tpool, src, dst))
    ids = [int(tables[1, 1]), P + 1]                    # P + 1 drops
    jpool = jlm.paged_clear(jpool, ids)
    same(jpool, tlm.paged_clear(tpool, ids))


@pytest.mark.parametrize("arch", WINDOWED)
def test_windowed_gather_prefill_keeps_every_row(arch):
    """A ragged batch padded past a windowed layer's window (prompts of 80,
    73 and 40 tokens, smoke window 64, 16-row pages) then 6 decode steps:
    the port's gather and paged paths each give every slot's own full
    forward (``lm_hidden`` + ``lm_logits``, one slot at a time) within
    LOGIT_ATOL, and after prefill both pools hold equal positions.

    The dense prefill of the gather path once sized windowed rings at the
    window, so the pad rows of the 73- and 40-token slots pushed their own
    earliest real rows out before the pool was written; the reference's
    gather path still does, and is off by 0.11-0.65 at logit scale ~1 on
    this problem (its ``kernel="pallas"`` path is not)."""
    _, _, cfg, params = _load(arch)
    lens = np.array([80, 73, 40], np.int32)
    B, S, ps, npps, steps = 3, 80, 16, 8, 6
    r = np.random.default_rng(7)
    tables = r.permutation(B * npps).astype(np.int32).reshape(B, npps)
    toks = r.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    feed = r.integers(1, cfg.vocab, (steps, B)).astype(np.int32)
    prob = (B * npps, ps, tables, toks, lens)
    runs = {k: _run_torch(cfg, params, prob, k, feed, steps)
            for k in ("gather", "paged")}

    for b in range(B):
        seq = np.concatenate([toks[b, :lens[b]], feed[:, b]])[None]
        h, _ = tlm.lm_hidden(params, {"tokens": torch.from_numpy(seq)}, cfg)
        full = tlm.lm_logits(params, h, cfg).float().numpy()[0]
        want = full[lens[b] - 1:lens[b] + steps]        # (steps + 1, V)
        for kernel, (logits, _) in runs.items():
            np.testing.assert_allclose(logits[:, b], want, atol=LOGIT_ATOL,
                                       rtol=0, err_msg=f"{kernel} slot {b}")

    pools = {}
    for kernel in ("gather", "paged"):
        pool = tlm.paged_cache_init(cfg, B, B * npps, ps, "cpu")
        tlm.paged_prefill(params, pool, torch.from_numpy(tables),
                          torch.from_numpy(toks), torch.from_numpy(lens), cfg,
                          kernel=kernel)
        pools[kernel] = pool
    for a, b in zip(*(_attn_leaves(pools[k]) for k in ("gather", "paged"))):
        assert torch.equal(a["pos"], b["pos"])
        # every real row of every repeat, none of the pads
        assert int((a["pos"] >= 0).sum()) == lens.sum() * a["pos"].shape[0]
