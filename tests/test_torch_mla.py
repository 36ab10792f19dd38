"""The port's MLA (DeepSeek-V2 multi-head latent attention) against the
reference's, on the CPU at smoke width, and its paged kernel on the card.

* ``mla_apply`` in its three branches — the decompressed prefill into a
  ring, the absorbed ring decode, and the absorbed form over a pool leaf
  (the port's ``gather`` and ``paged`` kernels against the reference's
  ``gather`` and ``pallas``, its Pallas kernel in interpret mode) — with
  converted params, the reference run eagerly (``jax.disable_jit()``).
  f32: atol = rtol = 2e-5 (the outputs agree to ~1e-6: the same math,
  summed in another order). bf16: one bf16 ulp (rtol 2^-7, atol 1e-6, the
  layers' tolerance of ``tests/test_torch_layers.py``; the outputs are
  bit-equal on this machine). Written positions are equal, and the
  written ckv / kr rows within the tolerance of their dtype.
* The paged MLA call through the port's plain version against the
  reference's kernel (``q2``/``k2``, interpret mode): f32 atol 2e-5; and a
  scale control: the kernel's default scale, 1/sqrt(Dk + Dk2) (1/sqrt(576)
  at deepseek-v2's widths), is not MLA's 1/sqrt(dn + dr) (1/sqrt(192)).
* deepseek-v2-smoke served through ``paged_prefill`` / ``paged_decode_step``
  against the reference's paged path, each port path against the reference
  path of the same rounding (gather against gather, paged against the
  Pallas kernel), the MoE reference run eagerly (ROADMAP §3): tokens equal
  up to the first near-tie; logits within 3e-2 but where a MoE layer
  routed a token otherwise, each such route a near tie of the router.
* The paged engine with prefix sharing on deepseek-v2-smoke ends with a
  clean pool.

The ``cuda`` test holds the paged kernel at deepseek-v2's full head counts
(H 128 over one latent head, Dk 512 + Dk2 64, Dv 512, 16-row pages): bf16
on the ``mla`` route within one bf16 rounding of the f32 answer, f32 on
the ``general`` route within 2e-5 of the plain version. JAX is
imported in the functions that need it, so that the file also runs where
JAX is absent: ``python -m pytest --noconftest -m cuda
tests/test_torch_mla.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)
from repro_torch.models import attention as ta
from test_torch_paged_attention import (ONE_ROUNDING, _call, _f32_answer,
                                        _mk, _torch_args, cuda_device)

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

ARCH = "deepseek-v2-236b"
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=1e-6, rtol=2 ** -7)}
DTYPES = ["float32", "bfloat16"]


def _spec(cfg):
    return cfg.groups[0].pattern[0].attn


def _setup(dtype):
    """(reference cfg, spec, params; port cfg, spec, params) of the smoke
    config's MLA layer, params cast to ``dtype``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import attention as ja
    cfg = get_config(ARCH, smoke=True)
    spec = _spec(cfg)
    p = ja.mla_init(jax.random.PRNGKey(0), cfg.d_model, spec, cfg)
    p = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), p)
    tcfg = tget(ARCH, smoke=True)
    return (cfg, spec, p, tcfg, _spec(tcfg),
            params_from_jax(jax.tree.map(np.asarray, p)))


def _close(t, j, dtype, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               err_msg=what, **TOL[dtype])


def _same_rows(t_cache, j_cache):
    """Positions equal; ckv / kr rows within the tolerance of their own
    dtype (an f32 ring, or a bf16 ring or pool)."""
    np.testing.assert_array_equal(t_cache["pos"].numpy(),
                                  np.asarray(j_cache["pos"]))
    for k in ("ckv", "kr"):
        dtype = str(t_cache[k].dtype)[6:]
        _close(t_cache[k], j_cache[k], dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_ring_prefill_and_decode_match_reference(dtype):
    """The decompressed prefill of 6 tokens into a 10-row ring (written
    from row 0), then two absorbed decode steps over the ring; and the
    decompressed form without a cache (the full forward)."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as ja
    cfg, spec, p, tcfg, tspec, tp = _setup(dtype)
    jdt = getattr(jnp, dtype)
    r = np.random.default_rng(0)
    B, S, cap = 2, 6, 10
    # the reference writes a bf16 ring with f32 rows only through its
    # decode path, so in f32 both rings are f32
    cache = {k: (v if k == "pos" else v.astype(jdt))
             for k, v in ja.mla_cache_init(B, cap, spec).items()}
    tcache = {k: tensor_from_numpy(np.asarray(v)) for k, v in cache.items()}
    x = jnp.asarray(r.standard_normal((B, S, cfg.d_model)), jdt)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    with jax.disable_jit():
        y, cache = ja.mla_apply(p, x, spec, cfg, jnp.asarray(pos),
                                cache=cache)
        y_full, _ = ja.mla_apply(p, x, spec, cfg, jnp.asarray(pos))
    xt = tensor_from_numpy(np.asarray(x))
    _close(ta.mla_apply(tp, xt, tspec, tcfg, torch.from_numpy(pos),
                        cache=tcache), y, dtype, "prefill")
    _same_rows(tcache, cache)
    _close(ta.mla_apply(tp, xt, tspec, tcfg, torch.from_numpy(pos)), y_full,
           dtype, "no cache")
    for step in range(2):
        x1 = jnp.asarray(r.standard_normal((B, 1, cfg.d_model)), jdt)
        p1 = np.full((B, 1), S + step, np.int32)
        with jax.disable_jit():
            y1, cache = ja.mla_apply(p, x1, spec, cfg, jnp.asarray(p1),
                                     cache=cache)
        _close(ta.mla_apply(tp, tensor_from_numpy(np.asarray(x1)), tspec,
                            tcfg, torch.from_numpy(p1), cache=tcache), y1,
               dtype, f"decode {step}")
        _same_rows(tcache, cache)


def _pool_leaf(r, spec, B=3, P=12, ps=4, npps=4, starts=(5, 9, 0)):
    """An MLA pool leaf over a permuted pool: slot b holds rows
    [0, starts[b]) in its first npps - 1 pages (random bf16 ckv / kr), the
    last table entry dead."""
    tables = np.full((B, npps), -1, np.int32)
    kpos = np.full((P, ps), -1, np.int32)
    perm, n = r.permutation(P), 0
    for b in range(B):
        for j in range(npps - 1):
            tables[b, j] = perm[n]
            n += 1
            rows = j * ps + np.arange(ps)
            kpos[tables[b, j]] = np.where(rows < starts[b], rows, -1)
    return dict(
        ckv=r.standard_normal((P, ps, spec.kv_lora_rank)),
        kr=r.standard_normal((P, ps, spec.qk_rope_head_dim)),
        pos=kpos, table=tables)


@pytest.mark.parametrize("S", [1, 5], ids=["decode", "prefill"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel,ref_kernel", [("gather", "gather"),
                                               ("paged", "pallas")])
def test_mla_paged_leaf_matches_reference(kernel, ref_kernel, dtype, S):
    """The absorbed form over a pool leaf for S = 1 and a 5-row suffix
    continuing earlier rows (a warm prefix), one pad row (position -1, no
    write) in slot 1; the pool stays bf16 as the model's does."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as ja
    cfg, spec, p, tcfg, tspec, tp = _setup(dtype)
    r = np.random.default_rng(S)
    starts = np.array([5, 9, 0])
    leaf = _pool_leaf(r, spec, starts=tuple(starts))
    jleaf = {k: jnp.asarray(v, jnp.bfloat16 if k in ("ckv", "kr") else
                            jnp.int32) for k, v in leaf.items()}
    tleaf = {k: tensor_from_numpy(np.asarray(v)) for k, v in jleaf.items()}
    x = jnp.asarray(r.standard_normal((3, S, cfg.d_model)),
                    getattr(jnp, dtype))
    pos = (starts[:, None] + np.arange(S)[None]).astype(np.int32)
    if S > 1:
        pos[1, -1] = -1
    with jax.disable_jit():
        y, jleaf = ja.mla_apply(p, x, spec,
                                cfg.replace(paged_kernel=ref_kernel),
                                jnp.asarray(pos), cache=jleaf)
    yt = ta.mla_apply(tp, tensor_from_numpy(np.asarray(x)), tspec,
                      tcfg.replace(paged_kernel=kernel),
                      torch.from_numpy(pos), cache=tleaf)
    _close(yt, y, dtype, kernel)
    _same_rows(tleaf, jleaf)


def _mla_problem(seed, B=2, S=1, H=4, Dk=32, Dk2=64, P=16, ps=4, npps=6,
                 filled=None, q_from_zero=False):
    """A paged MLA problem: one latent head, k = v = the ckv pool (Dv =
    Dk), k2 the rope keys."""
    a = _mk(seed, B=B, S=S, H=H, K=1, Dk=Dk, Dv=Dk, P=P, ps=ps, npps=npps,
            filled=filled, q2dim=Dk2, q_from_zero=q_from_zero)
    a["v"] = a["k"]
    return a


MLA_KERNEL_CASES = [
    ("decode", dict(S=1)),
    ("prefill", dict(S=6, filled=[5, 3], q_from_zero=True)),
    ("wide", dict(S=2, Dk=512, Dk2=64, H=4, P=6, ps=16, npps=3)),
]


@pytest.mark.parametrize("name,kw", MLA_KERNEL_CASES,
                         ids=[c[0] for c in MLA_KERNEL_CASES])
def test_paged_mla_plain_matches_reference_kernel(name, kw):
    """The port's paged call in the absorbed form (its plain version on
    the CPU) against the reference's Pallas kernel in interpret mode, with
    MLA's explicit scale: f32 atol 2e-5. The kernel's default scale,
    1/sqrt(Dk + Dk2), differs."""
    import jax.numpy as jnp
    from repro.kernels.paged_attention import paged_attention as jpa
    a = _mla_problem(11, **kw)
    scale = 1.0 / math.sqrt(128 + 64)              # 1/sqrt(dn + dr)
    j = np.asarray(jpa(*(jnp.asarray(a[n]) for n in (
        "q", "k", "v", "kpos", "tables", "q_pos")), q2=jnp.asarray(a["q2"]),
        k2=jnp.asarray(a["k2"]), scale=scale, block_q=8, interpret=True))
    t = _call(paged_attention, _torch_args(a), scale=scale)
    np.testing.assert_allclose(t.numpy(), j, atol=2e-5, rtol=2e-5)
    default = _call(paged_attention, _torch_args(a))
    assert not np.allclose(default.numpy(), j, atol=2e-5, rtol=2e-5)


def test_mla_scale_control_in_the_model(monkeypatch):
    """The absorbed form with the kernel's default scale (1/sqrt(kl + dr))
    in place of MLA's is caught at the layer: its output leaves the f32
    tolerance of the reference's."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as ja
    cfg, spec, p, tcfg, tspec, tp = _setup("float32")
    r = np.random.default_rng(1)
    leaf = _pool_leaf(r, spec)
    jleaf = {k: jnp.asarray(v, jnp.bfloat16 if k in ("ckv", "kr") else
                            jnp.int32) for k, v in leaf.items()}
    x = jnp.asarray(r.standard_normal((3, 1, cfg.d_model)), jnp.float32)
    pos = np.array([[5], [9], [0]], np.int32)
    with jax.disable_jit():
        y, _ = ja.mla_apply(p, x, spec, cfg.replace(paged_kernel="pallas"),
                            jnp.asarray(pos), cache=dict(jleaf))
    def default_scale(*args, scale=None, **kw):
        return paged_attention(*args, **kw)

    monkeypatch.setattr(ta, "paged_attention", default_scale)
    tleaf = {k: tensor_from_numpy(np.asarray(v)) for k, v in jleaf.items()}
    yt = ta.mla_apply(tp, tensor_from_numpy(np.asarray(x)), tspec,
                      tcfg.replace(paged_kernel="paged"),
                      torch.from_numpy(pos), cache=tleaf)
    assert not np.allclose(yt.numpy(), np.asarray(y), **TOL["float32"])


ROUTE_TIE = 1e-3     # router probabilities this close are a near tie


def _moe_layers(cfg) -> int:
    return sum(g.repeats for g in cfg.groups for b in g.pattern
               if b.moe is not None)


def _flipped_rows(j_sel, t_routes, cfg, S):
    """The (step, slot) rows at which a MoE layer chose other experts in
    the port than in the reference, each asserted to be a near tie: the
    port's k-th and (k+1)-th router probabilities within ROUTE_TIE. Calls
    come in order, ``_moe_layers`` a forward: the prefill (S tokens a
    slot), then one a decode step (one token a slot)."""
    rows = set()
    n = _moe_layers(cfg)
    assert len(j_sel) == len(t_routes)
    for i, (sj, (probs, st)) in enumerate(zip(j_sel, t_routes)):
        step, k = i // n, st.shape[-1]
        sj = sj.reshape(st.shape)
        for g, t in zip(*np.nonzero((np.sort(sj, -1)
                                     != np.sort(st, -1)).any(-1))):
            p = np.sort(probs[g, t])[::-1]
            assert p[k - 1] - p[k] < ROUTE_TIE, (i, t, p[:k + 1])
            rows.add((step, (g * st.shape[1] + t) // (S if step == 0
                                                       else 1)))
    return rows


@pytest.mark.parametrize("seed", [1, 2])
def test_deepseek_paged_serving_matches_reference(monkeypatch, seed):
    """paged_prefill + 4 paged_decode_steps of deepseek-v2-smoke (one dense
    MLA layer, two MoE MLA layers) over a fragmented pool, the port on both
    its kernels: tokens equal up to the first near-tie; logits within 3e-2
    of the reference path of the same rounding at every (step, slot) row
    but those where a MoE layer routed a token otherwise, and each such
    route is a near tie of the router (ROADMAP §3: one bf16 ulp of the
    attention output moves a near-tied choice; seed 2, step 1, slot 1:
    probabilities 0.16974 and 0.16972, logits 0.156 apart); positions equal
    on every leaf and the first layer's written ckv / kr rows within two
    bf16 ulps of their largest entries."""
    import jax
    from repro_torch.convert import pool_from_jax
    from repro_torch.models import moe as tmoe
    from test_paged_attention import _assert_tokens_match_modulo_ties
    from test_torch_lm import (LOGIT_ATOL, ROW_TOL, _attn_leaves, _gaps,
                               _load, _problem, _run_jax, _run_torch)
    cfg, jp, tcfg, tp = _load(ARCH)
    prob = _problem(seed)
    one_hot, route = jax.nn.one_hot, tmoe.route
    for kernel, ref_kernel in (("gather", "gather"), ("paged", "pallas")):
        j_sel, t_routes = [], []

        def j_one_hot(a, *args, **kw):          # sel, then kept, a call
            j_sel.append(np.asarray(a))
            return one_hot(a, *args, **kw)

        def t_route(*args, **kw):
            out = route(*args, **kw)
            t_routes.append((out[0].numpy(), out[2].numpy()))
            return out

        monkeypatch.setattr(jax.nn, "one_hot", j_one_hot)
        j_logits, j_pool = _run_jax(cfg, jp, prob, 4, ref_kernel)
        monkeypatch.setattr(jax.nn, "one_hot", one_hot)
        j_pool = pool_from_jax(jax.tree.map(np.asarray, j_pool))
        monkeypatch.setattr(tmoe, "route", t_route)
        t_logits, t_pool = _run_torch(tcfg, tp, prob, kernel,
                                      j_logits[:-1].argmax(-1))
        monkeypatch.setattr(tmoe, "route", route)
        _assert_tokens_match_modulo_ties(j_logits.argmax(-1), _gaps(j_logits),
                                         t_logits.argmax(-1), (kernel, seed))
        flipped = _flipped_rows(j_sel[0::2], t_routes, cfg,
                                prob[3].shape[1])
        for step in range(t_logits.shape[0]):
            for slot in range(t_logits.shape[1]):
                if (step, slot) not in flipped:
                    np.testing.assert_allclose(
                        t_logits[step, slot], j_logits[step, slot],
                        atol=LOGIT_ATOL, rtol=0,
                        err_msg=f"{kernel} step {step} slot {slot}")
        for ja_, ta_ in zip(_attn_leaves(j_pool), _attn_leaves(t_pool)):
            assert sorted(ta_) == ["ckv", "kr", "pos"]
            assert torch.equal(ja_["pos"], ta_["pos"]), kernel
        ja_, ta_ = j_pool[0]["0"]["attn"], t_pool[0]["0"]["attn"]
        written = (ja_["pos"] >= 0).numpy()
        for leaf in ("ckv", "kr"):
            np.testing.assert_allclose(
                ta_[leaf].float().numpy()[written],
                ja_[leaf].float().numpy()[written], **ROW_TOL, err_msg=leaf)


def test_deepseek_engine_shares_prefixes_and_keeps_the_pool_clean(capsys):
    """``launch.serve.serve`` on deepseek-v2-smoke, on the CPU with the
    paged kernel's plain version: a system prompt registered by a first
    wave, two warm admissions in the second (their suffix prefill in the
    absorbed form over shared pages), every request finished, the pool's
    invariants clean."""
    from repro_torch.launch.serve import init_params, serve
    from repro_torch.serve.engine import Request
    cfg = tget(ARCH, smoke=True)
    params = init_params(cfg, "cpu")
    r = np.random.default_rng(0)
    system = r.integers(1, cfg.vocab, 16)
    wave = [Request(rid=1 + i, prompt=np.concatenate(
        [system, r.integers(1, cfg.vocab, 16)]) if i < 2
        else r.integers(1, cfg.vocab, 32), max_new=4) for i in range(4)]
    eng = serve(cfg, params, [[Request(rid=0, prompt=system, max_new=4)],
                              wave], device="cpu", slots=2, capacity=64,
                kernel="paged", prefix_sharing=True)
    assert all(q.done and len(q.out) == 4 for q in wave)
    assert eng.stats["prefix_hits"] == 2
    leaf = eng.kv[0]["0"]["attn"]
    assert sorted(leaf) == ["ckv", "kr", "pos"]
    eng.pool.check()
    assert "prefix_hits=2" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# On the card: deepseek-v2's paged shapes at full head counts
# ---------------------------------------------------------------------------

# (name, problem keywords): 4 slots, H 128 over one latent head, Dk 512 +
# Dk2 64, Dv 512, 16-row pages; decode over 9 live pages, a 128-token
# prefill over 8, a long decode over 256
FULL_MLA = [
    ("decode", dict(B=4, S=1, H=128, Dk=512, Dk2=64, P=128, ps=16, npps=32,
                    filled=[9] * 4)),
    ("prefill", dict(B=4, S=128, H=128, Dk=512, Dk2=64, P=128, ps=16,
                     npps=32, filled=[8] * 4, q_from_zero=True)),
    ("long_decode", dict(B=4, S=1, H=128, Dk=512, Dk2=64, P=1024, ps=16,
                         npps=256, filled=[256] * 4)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", FULL_MLA, ids=[c[0] for c in FULL_MLA])
def test_cuda_mla_full_head_counts_mla_route_in_bf16_general_in_f32(
        cuda_device, name, kw):
    """Every MLA shape takes its route by dtype (R = S * 128 >= 64 rows
    and q2/k2 leave split and tile out): bf16 the mla route, within one
    bf16 rounding of the f32 answer; f32 the general route, within 2e-5 of
    the plain version."""
    scale = 1.0 / math.sqrt(128 + 64)
    a = _mla_problem(19, **kw)
    for dtype, route in ((torch.float32, "general"),
                         (torch.bfloat16, "mla")):
        t = _torch_args(a, cuda_device, dtype)
        t["v"] = t["k"]
        routes = dict(paged_attention.routes)
        out = _call(paged_attention, t, scale=scale)
        torch.cuda.synchronize()
        assert paged_attention.routes == {**routes,
                                          route: routes[route] + 1}
        if dtype == torch.float32:
            ref = _call(paged_attention_ref, t, scale=scale)
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
        else:
            torch.testing.assert_close(out.float(),
                                       _f32_answer(t, scale=scale),
                                       **ONE_ROUNDING)
        del t, out
        torch.cuda.empty_cache()
