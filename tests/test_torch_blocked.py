"""The port's blocked (online-softmax) attention path against the reference's.

``attn_core`` takes ``_attn_blocked`` for Q > 1 over more than
``BLOCKED_THRESHOLD`` keys (``KV_BLOCK`` with ``prefer_blocked``): keys in
1,024-blocks, the last one padded with k_pos = -1, the softmax scale folded
into q, no second mask after the exp, p in v's dtype before the value
product, the output in v's dtype. The port mirrors all of that, so a query
row that sees no key (a pad row, q_pos = -1) gives the reference's value —
v summed over the keys, divided by the padded length — and not zeros.

Tolerances are the reference kernels' own (``tests/test_kernels.py``):
f32 atol = rtol = 2e-5 (the same math summed in another order), bf16 2e-2
(one bf16 rounding of p and of the output on each side). The smoke-width
prefill holds logits and written pool rows to ``tests/test_torch_lm.py``'s
contract (the reference runs its layers in ``lax.scan``, where XLA skips
some bf16 roundings).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as jatt
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, pool_from_jax
from repro_torch.models import attention as tatt
from repro_torch.models import lm as tlm

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

TOL = {"f32": 2e-5, "bf16": 2e-2}
LOGIT_ATOL = 3e-2                         # tests/test_torch_lm.py
ROW_TOL = dict(rtol=2 ** -6, atol=2 ** -4)

# name: (B, Q, S, K, G, D, Dv), problem options, attention options
CASES = {
    "prefer_blocked_1300": ((1, 64, 1300, 2, 2, 16, 16), {},
                            dict(prefer_blocked=True)),
    "ring_empty_slots": ((2, 16, 1300, 2, 3, 16, 16), dict(ring=True),
                         dict(prefer_blocked=True)),
    "window_softcap": ((1, 48, 1300, 1, 4, 32, 16), {},
                       dict(window=300, cap=30.0, prefer_blocked=True)),
    "pad_query_rows": ((2, 32, 1300, 2, 2, 16, 16), dict(pad_rows=5),
                       dict(prefer_blocked=True)),
    "threshold_8200": ((1, 2, 8200, 2, 2, 16, 16), {}, {}),
}


def _problem(shape, dtype, seed=0, ring=False, pad_rows=0):
    """q (B,Q,H,D), k (B,S,K,D), v (B,S,K,Dv), q_pos (B,Q), k_pos (B,S) as
    numpy, rounded to ``dtype`` once. Queries sit at the last Q positions of
    the history; a ``ring`` cache holds its positions rotated by a random
    shift with ~20% of the slots empty (-1); ``pad_rows`` trailing query
    rows are pads (-1)."""
    B, Q, S, K, G, D, Dv = shape
    r = np.random.default_rng(seed)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    q, k, v = (np.asarray(jnp.asarray(r.standard_normal(s, np.float32), jd))
               for s in ((B, Q, K * G, D), (B, S, K, D), (B, S, K, Dv)))
    base = 500 if ring else 0
    k_pos = np.tile(base + np.arange(S, dtype=np.int32), (B, 1))
    if ring:
        for b in range(B):
            k_pos[b] = np.roll(k_pos[b], int(r.integers(S)))
        k_pos[r.random((B, S)) < 0.2] = -1
    q_pos = np.tile(base + S - Q + np.arange(Q, dtype=np.int32), (B, 1))
    if pad_rows:
        q_pos[:, Q - pad_rows:] = -1
    return q, k, v, q_pos, k_pos


def _both(arrays):
    from repro_torch.convert import tensor_from_numpy
    return ([jnp.asarray(a) for a in arrays],
            [tensor_from_numpy(a) for a in arrays])


def _scale(shape):
    return 1.0 / np.sqrt(shape[5])


def _spy(monkeypatch, module, name):
    """Count calls of ``module.name`` (trace-time calls for the reference)."""
    calls = []
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(a[0].shape)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_attn_core_matches_reference(monkeypatch, dtype, name):
    shape, prob, kw = CASES[name]
    B, Q, S, K, G, D, Dv = shape
    j, t = _both(_problem(shape, dtype, **prob))
    opts = dict(scale=_scale(shape), causal=True, window=kw.get("window"),
                cap=kw.get("cap"), n_kv=K,
                prefer_blocked=kw.get("prefer_blocked", False))
    j_calls = _spy(monkeypatch, jatt, "_attn_blocked")
    t_calls = _spy(monkeypatch, tatt, "_attn_blocked")
    ref = np.asarray(jatt.attn_core(*j, **opts), np.float32)
    out = tatt.attn_core(*t, **opts)
    assert len(j_calls) == len(t_calls) == 1          # both took the path
    assert out.dtype == t[2].dtype and out.shape == (B, Q, K * G, Dv)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype],
                               rtol=TOL[dtype])
    if prob.get("pad_rows"):
        # the reference's value for a row that sees no key, not zeros
        pads = out[:, Q - prob["pad_rows"]:].float()
        assert bool((pads != 0).any())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_attn_blocked_matches_reference(dtype, name):
    """``_attn_blocked`` itself, in the grouped (B,Q,K,G,D) layout."""
    shape, prob, kw = CASES[name]
    B, Q, S, K, G, D, Dv = shape
    arrs = list(_problem(shape, dtype, seed=1, **prob))
    arrs[0] = arrs[0].reshape(B, Q, K, G, D)
    j, t = _both(arrs)
    opts = dict(scale=_scale(shape), causal=True, window=kw.get("window"),
                cap=kw.get("cap"))
    ref = np.asarray(jatt._attn_blocked(*j, **opts), np.float32)
    out = tatt._attn_blocked(*t, **opts)
    assert out.dtype == t[2].dtype and out.shape == (B, Q, K, G, Dv)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["prefer_blocked_1300", "ring_empty_slots",
                                  "window_softcap"])
def test_blocked_equals_flat_on_the_port(dtype, name):
    """Both paths compute one function where every row sees a key: in f32
    to summation order, in bf16 to one rounding of p (the flat path rounds
    the normalized p, the blocked path exp(s - m))."""
    shape, prob, kw = CASES[name]
    B, Q, S, K, G, D, Dv = shape
    q, k, v, q_pos, k_pos = _both(_problem(shape, dtype, seed=2, **prob))[1]
    q5 = q.reshape(B, Q, K, G, D)
    opts = dict(scale=_scale(shape), causal=True, window=kw.get("window"),
                cap=kw.get("cap"))
    flat = tatt._attn_flat(q5, k, v, q_pos, k_pos, **opts)
    blocked = tatt._attn_blocked(q5, k, v, q_pos, k_pos, **opts)
    torch.testing.assert_close(blocked.float(), flat.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("Q,S,prefer,blocked", [
    (1, 8200, False, False),            # decode always takes the flat path
    (2, 8192, False, False),
    (2, 8193, False, True),
    (2, 1024, True, False),
    (2, 1025, True, True),
])
def test_path_rule_matches_reference(monkeypatch, Q, S, prefer, blocked):
    shape = (1, Q, S, 1, 2, 8, 8)
    j, t = _both(_problem(shape, "f32"))
    opts = dict(scale=_scale(shape), causal=True, window=None, cap=None,
                n_kv=1, prefer_blocked=prefer)
    j_calls = _spy(monkeypatch, jatt, "_attn_blocked")
    t_calls = _spy(monkeypatch, tatt, "_attn_blocked")
    jatt.attn_core(*j, **opts)
    tatt.attn_core(*t, **opts)
    assert len(j_calls) == len(t_calls) == int(blocked)


def test_gather_prefill_through_blocked_path_matches_reference(monkeypatch):
    """qwen3-14b at smoke width, two prompts of 1,300 and 1,150 tokens
    prefilled cold with ``kernel="gather"``: ``BLOCKED_THRESHOLD`` is set to
    1,024 in both packages for this test, so every layer's prefill attention
    takes the blocked path (two blocks, the second padded)."""
    for mod in (jatt, tatt):
        monkeypatch.setattr(mod, "BLOCKED_THRESHOLD", 1024)
    j_calls = _spy(monkeypatch, jatt, "_attn_blocked")
    t_calls = _spy(monkeypatch, tatt, "_attn_blocked")
    cfg = get_config("qwen3-14b", smoke=True)
    jp = jlm.lm_init(jax.random.PRNGKey(0), cfg)
    tcfg = tget("qwen3-14b", smoke=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    r = np.random.default_rng(5)
    slots, ps, npps, S = 2, 16, 82, 1300
    P = slots * npps + 4
    tables = r.permutation(P)[:slots * npps].reshape(slots, npps).astype(
        np.int32)
    toks = r.integers(1, cfg.vocab, (slots, S)).astype(np.int32)
    lens = np.array([1300, 1150], np.int32)

    # a fresh function object, traced now, under the patched threshold
    prefill = jax.jit(lambda *a: jlm.paged_prefill(*a, cfg, kernel="gather"))
    jl, jpool = prefill(jp, jlm.paged_cache_init(cfg, slots, P, ps),
                        jnp.asarray(tables), jnp.asarray(toks),
                        jnp.asarray(lens), jnp.arange(slots, dtype=jnp.int32))
    tl, tpool = tlm.paged_prefill(
        tp, tlm.paged_cache_init(tcfg, slots, P, ps, "cpu"),
        torch.from_numpy(tables), torch.from_numpy(toks),
        torch.from_numpy(lens), tcfg, kernel="gather")
    assert j_calls and len(t_calls) == cfg.n_layers
    assert all(c[1] == S for c in t_calls)          # Q = 1,300 queries
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               atol=LOGIT_ATOL, rtol=0)
    jpool = pool_from_jax(jax.tree.map(np.asarray, jpool))
    a, b = jpool[0]["0"]["attn"], tpool[0]["0"]["attn"]
    assert torch.equal(a["pos"], b["pos"])
    written = (a["pos"] >= 0).numpy()
    assert written.sum() == lens.sum() * (written.size // (P * ps))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(b[leaf].float().numpy()[written],
                                   a[leaf].float().numpy()[written],
                                   **ROW_TOL, err_msg=leaf)
