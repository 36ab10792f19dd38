"""The port's int8 KV cache against the reference's, on the CPU.

* ``_kv_quantize`` / ``_kv_dequantize`` bit for bit against eager JAX, on
  seeded bf16 rows, rows whose values land exactly on .5 quantization steps
  (round half to even in both) and all-zero rows; the reference's
  round-trip bound (``tests/test_kv_quant.py``) on the port.
* ``paged_prefill`` + 4 ``paged_decode_step`` of ``kv_quant=True`` variants
  of qwen3-14b-smoke and zamba2-7b-smoke (built on both sides with the
  reference test's ``_quantized``) against the reference's int8 path: logits
  within LOGIT_ATOL, positions equal, and the int8 codes and bf16 scales
  equal bit for bit on qwen3's first layer, whose k/v both packages compute
  alike. Deeper (and behind zamba2's Mamba2 layers) k/v drift by about a
  bf16 ulp a layer (``tests/test_torch_lm.py``), and a drifting value that
  crosses a rounding boundary moves its code by a step: there the
  dequantized rows are held within the bf16 rows' ROW_TOL plus 1.5
  quantization steps of the row (one step for the boundary, half a step for
  the scale's own bf16 ulp over 127 steps), and every layer's codes and
  scales are held free of systematic drift (``_drift``), a limit that a
  scale of max/128 in place of max/127 fails.
* The reference's own bound against the bf16 full forward (relative error
  < 0.08, ``tests/test_kv_quant.py``) on the port's ring and paged paths.
* The pool operations and the engine's copy-on-write carry the scales.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.common import dense_lm as j_dense_lm
from repro.models import attention as jatt
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.configs.common import dense_lm as t_dense_lm
from repro_torch.convert import params_from_jax, pool_from_jax
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import attention as tatt
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import PagedServeEngine, Request
from test_kv_quant import _quantized
from test_paged_attention import _assert_tokens_match_modulo_ties
from test_torch_engine import _assert_match_modulo_ties
from test_torch_lm import (LOGIT_ATOL, ROW_TOL, _attn_leaves, _gaps,
                           _problem, _run_jax, _run_torch)

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)


def _quant_rows(seed):
    """(2, 6, 4, 16) bf16 rows: seeded normals, then rows whose max is 127
    or 254 (scale exactly 1 or 2 in f32, the 1e-8 below half an ulp) with
    entries on .5 steps, and all-zero rows."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, 6, 4, 16)).astype(np.float32) * 3
    half = r.integers(-126, 126, (4, 16)) + 0.5          # k + 0.5 steps
    x[0, 0] = half
    x[0, 0, :, 0] = 127.0
    x[1, 1] = half * 2
    x[1, 1, :, 0] = -254.0
    x[0, 2] = 0.0
    x[1, 3, 2] = 0.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_dequantize_bit_equal_to_eager_jax(seed):
    xj = jnp.asarray(_quant_rows(seed), jnp.bfloat16)
    xt = tensor_from_numpy(np.asarray(xj))
    qj, sj = jatt._kv_quantize(xj)
    qt, st = tatt._kv_quantize(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert torch.equal(st, tensor_from_numpy(np.asarray(sj)))
    # the .5 steps really are ties, and they round to even
    assert np.all(np.abs(_quant_rows(seed)[0, 0, :, 1:] % 1) == 0.5)
    assert np.all(qt.numpy()[0, 0, :, 1:] % 2 == 0)
    assert not qt[0, 2].any()
    yj = jatt._kv_dequantize(qj, sj)
    yt = tatt._kv_dequantize(qt, st)
    assert yt.dtype == torch.bfloat16
    assert torch.equal(yt, tensor_from_numpy(np.asarray(yj)))


def test_quantize_roundtrip_bounds():
    """tests/test_kv_quant.py::test_quantize_roundtrip_bounds on the port."""
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 8, 4, 16), jnp.bfloat16)
    xt = tensor_from_numpy(np.asarray(x))
    q, s = tatt._kv_quantize(xt)
    y = tatt._kv_dequantize(q, s)
    err = (y.float() - xt.float()).abs().numpy()
    bound = (s.float().numpy()[..., None] * 0.51
             + 0.01 * np.abs(xt.float().numpy()) + 1e-3)
    assert (err <= bound).all()


# ---------------------------------------------------------------------------
# The int8 serving path
# ---------------------------------------------------------------------------

_LOADED = {}


def _load(arch):
    if arch not in _LOADED:
        cfg = _quantized(get_config(arch, smoke=True))
        jp = jlm.lm_init(jax.random.PRNGKey(0), cfg)
        _LOADED[arch] = (cfg, jp, _quantized(tget(arch, smoke=True)),
                         params_from_jax(jax.tree.map(np.asarray, jp)))
    return _LOADED[arch]


def _deq(leaf, name):
    return tatt._kv_dequantize(leaf[name], leaf[name + "_scale"]).float()


# Limits on one layer's systematic drift between the packages' int8 leaves
# (``_drift``): the slope of the port's codes on the reference's, less 1; the
# mean signed code difference; the mean relative scale difference. At these
# seeds the drift reaches 9.5e-4, 0.022 and 1.2e-3 (up to 59% of the deeper
# layers' codes differ, by at most 6 steps, and each way alike). The control
# below, the port's deepest k rows quantized with a scale of max/128, moves
# the slope by 4.4e-3 to 6.0e-3 and the scale mean by 7.0e-3 to 8.1e-3;
# rounding down would move the mean code by about 0.5.
DRIFT_LIMITS = (3e-3, 0.1, 3e-3)


def _drift(a, sa, b, sb):
    """Systematic drift of codes ``b`` / scales ``sb`` from ``a`` / ``sa``
    over the written entries (see DRIFT_LIMITS)."""
    a, b, sa, sb = (t.double() for t in (a, b, sa, sb))
    return (float((a * b).sum() / (a * a).sum()) - 1,
            float((b - a).mean()), float((sb / sa - 1).mean()))


def _assert_no_drift(drift, what):
    assert all(abs(d) <= lim for d, lim in zip(drift, DRIFT_LIMITS)), \
        (what, drift, DRIFT_LIMITS)


# (port kernel, reference kernel): the reference's "pallas" runs its leaf
# path, where quantized leaves take the gather route as the port's do
PATHS = [("gather", "gather"), ("paged", "pallas")]


@pytest.mark.parametrize("kernel,ref_kernel", PATHS,
                         ids=[p[0] for p in PATHS])
@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-7b"])
def test_int8_serving_path_matches_reference(arch, kernel, ref_kernel):
    cfg, jp, tcfg, tp = _load(arch)
    P, ps, tables, toks, lens = _problem(1)
    if arch == "zamba2-7b":
        lens[:] = toks.shape[1]      # SSM prefill: one exact length
    prob = (P, ps, tables, toks, lens)
    j_logits, j_pool = _run_jax(cfg, jp, prob, 4, ref_kernel)
    feed = j_logits[:-1].argmax(-1)
    j_pool = pool_from_jax(jax.tree.map(np.asarray, j_pool))
    t_logits, t_pool = _run_torch(tcfg, tp, prob, kernel, feed, 4)
    np.testing.assert_allclose(t_logits, j_logits, atol=LOGIT_ATOL, rtol=0)
    _assert_tokens_match_modulo_ties(j_logits.argmax(-1), _gaps(j_logits),
                                     t_logits.argmax(-1), (arch, kernel))
    for ja, ta in zip(_attn_leaves(j_pool), _attn_leaves(t_pool)):
        assert torch.equal(ja["pos"], ta["pos"])
        assert ta["k"].dtype == ta["v"].dtype == torch.int8
        assert ta["k_scale"].dtype == torch.bfloat16
        written = (ja["pos"] >= 0).numpy()
        assert written.sum() > 0
        for name in ("k", "v"):
            a, b = _deq(ja, name).numpy(), _deq(ta, name).numpy()
            step = ja[name + "_scale"].float().numpy()[..., None]
            lim = (ROW_TOL["atol"] + ROW_TOL["rtol"] * np.abs(a)
                   + 1.5 * step)
            assert (np.abs(b - a) <= lim)[written].all(), name
            for li in range(ja["pos"].shape[0]):
                w = ja["pos"][li] >= 0
                _assert_no_drift(
                    _drift(ja[name][li][w], ja[name + "_scale"][li][w],
                           ta[name][li][w], ta[name + "_scale"][li][w]),
                    (name, li))
        # control: the port's deepest k rows quantized with max/128 drift
        w = ja["pos"][-1] >= 0
        rows = _deq({n: x[-1] for n, x in ta.items()}, "k")[w]
        scale = (rows.abs().amax(-1) / 128 + 1e-8).to(torch.bfloat16)
        codes = torch.round(rows / scale.float()[..., None]).clamp(-127, 127)
        with pytest.raises(AssertionError):
            _assert_no_drift(_drift(ja["k"][-1][w], ja["k_scale"][-1][w],
                                    codes, scale), "control")
    if arch == "qwen3-14b":
        # the first layer: codes and scales bit for bit where written
        ja, ta = j_pool[0]["0"]["attn"], t_pool[0]["0"]["attn"]
        written = ja["pos"][0] >= 0
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(ta[name][0][written], ja[name][0][written]), \
                name


@pytest.mark.parametrize("path", ["ring", "paged"])
def test_int8_decode_close_to_fp(path):
    """tests/test_kv_quant.py::test_int8_kv_decode_close_to_fp on the port:
    int8 decode within 8% (relative) of the bf16 full forward, through the
    ring caches and through the page pool (kernel "paged")."""
    args = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
                d_ff=128, vocab=256)
    jcfg = _quantized(j_dense_lm("kvq", **args))
    cfg = _quantized(t_dense_lm("kvq", **args))
    params = params_from_jax(jax.tree.map(
        np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jcfg)))
    B, S = 2, 24
    toks = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(1), (B, S), 0, cfg.vocab), np.int32))
    h, _ = tlm.lm_hidden(params, {"tokens": toks}, cfg)
    full = tlm.lm_logits(params, h, cfg).float()
    sp = S - 4
    if path == "ring":
        lg, caches = tlm.prefill_batched(params, {"tokens": toks[:, :sp]},
                                         cfg, torch.full((B,), sp),
                                         capacity=S)
        assert caches[0]["0"]["attn"]["k"].dtype == torch.int8
    else:
        tables = torch.arange(B * 8, dtype=torch.int32).reshape(B, 8)
        pool = tlm.paged_cache_init(cfg, B, B * 8, 4, "cpu")
        lg, pool = tlm.paged_prefill(params, pool, tables, toks[:, :sp],
                                     torch.full((B,), sp), cfg,
                                     kernel="paged")
        assert pool[0]["0"]["attn"]["k"].dtype == torch.int8
    outs = [lg]
    for i in range(sp, S):
        pos = torch.full((B, 1), i, dtype=torch.int32)
        if path == "ring":
            lg, caches = tlm.decode_step(params, caches, toks[:, i:i + 1],
                                         pos, cfg)
        else:
            lg, pool = tlm.paged_decode_step(params, pool, tables,
                                             toks[:, i:i + 1], pos, cfg,
                                             kernel="paged")
        outs.append(lg)
    dec = torch.cat(outs[:-1], dim=1).float()
    ref = full[:, sp - 1:S - 1]
    err = float((dec - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 0.08, f"int8 kv decode err {err:.3e}"


def test_full_width_zamba2_pool_is_int8():
    """zamba2-7b's published config (kv_quant) builds int8 pool leaves with
    bf16 scales (on the meta device: no memory)."""
    cfg = tget("zamba2-7b")
    pool = tlm.paged_cache_init(cfg, 4, 256, 16, "meta")
    leaf = pool[0]["3"]["attn"]
    assert leaf["k"].dtype == leaf["v"].dtype == torch.int8
    assert leaf["k"].shape == (27, 256, 16, 32, 112)
    assert leaf["k_scale"].shape == (27, 256, 16, 32)
    assert leaf["v_scale"].dtype == torch.bfloat16


def test_pool_ops_carry_scales():
    """paged_gather and paged_copy move the scale leaves with the rows, as
    the reference's do."""
    cfg, jp, tcfg, tp = _load("qwen3-14b")
    P, ps, tables, toks, lens = _problem(4)
    _, jpool = _run_jax(cfg, jp, (P, ps, tables, toks, lens), 0)
    tpool = pool_from_jax(jax.tree.map(np.asarray, jpool))
    names = ("k", "v", "k_scale", "v_scale", "pos")

    def same(j_tree, t_tree):
        j_tree = pool_from_jax(jax.tree.map(np.asarray, j_tree))
        for n in names:
            assert torch.equal(t_tree[0]["0"]["attn"][n],
                               j_tree[0]["0"]["attn"][n]), n

    same(jlm.paged_gather(jpool, jnp.asarray(tables)),
         tlm.paged_gather(tpool, torch.from_numpy(tables)))
    src, dst = [int(tables[0, 0]), int(tables[1, 0])], [5, 6]
    same(jlm.paged_copy(jpool, src, dst), tlm.paged_copy(tpool, src, dst))


def test_engine_cow_copies_scales():
    """A sharer's copy-on-write of a registered int8 prefix: the copy holds
    the source page's codes and scales, the pinned page stays bit-equal,
    and the warm tokens match a cold run up to a near-tie."""
    _, _, cfg, params = _load("qwen3-14b")
    r = np.random.default_rng(3)
    p1 = r.integers(1, cfg.vocab, 18)                    # boundary mid-page
    eng = PagedServeEngine(cfg, params, slots=4, page_size=4,
                           pages_per_slot=8, pool_pages=28,
                           prefix_sharing=True, kernel="paged", device="cpu")
    eng.run([Request(rid=0, prompt=p1.copy(), max_new=4)])
    (key,) = eng.pool.prefix_keys()
    pinned = eng.pool._prefix[key]["pages"]
    leaf = eng.kv[0]["0"]["attn"]
    before = {k: v[:, pinned].clone() for k, v in leaf.items()}
    copies = []
    cow = eng.pool.cow_page

    def watched(slot, idx):
        res = cow(slot, idx)
        if res is not None:
            copies.append(res)
        return res

    eng.pool.cow_page = watched
    p2 = np.concatenate([p1, r.integers(1, cfg.vocab, 5)])
    b = Request(rid=1, prompt=p2, max_new=4)
    eng.run([b])
    eng.pool.check()
    assert eng.stats["prefix_hits"] == 1 and copies
    for k, v in leaf.items():
        assert torch.equal(v[:, pinned], before[k]), k
    src, dst = copies[0]
    rows = len(p1) % 4                    # the shared rows of the page
    for n in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(leaf[n][:, dst, :rows], leaf[n][:, src, :rows]), n
    cold = Request(rid=2, prompt=p2.copy(), max_new=4)
    PagedServeEngine(cfg, params, slots=4, page_size=4, pages_per_slot=8,
                     kernel="paged", device="cpu").run([cold])
    _assert_match_modulo_ties(cfg, params, [p2], [cold.out], [b.out])
