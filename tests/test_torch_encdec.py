"""The port's enc-dec (whisper-base) and patch-frontend (internvl2-76b)
paths against the reference's, and the decode-against-full-forward checks
of ``tests/test_consistency.py`` re-run in the port alone, on the CPU at
smoke width.

* Params converted from the reference's ``lm_init`` fill the port's own
  tree: the same leaves (the encoder, its positions, the decoder's learned
  positions, the cross-attention blocks), shapes and dtypes.
* ``encoder_apply`` (whisper's stubbed frames), ``lm_hidden`` with
  ``enc_out`` or patch ``embeds``, ``prefill`` and two ``decode_step``s
  (internvl2's positions offset by the frontend's length) against the
  reference. Tolerances, as ``tests/test_torch_lm.py`` states them: every
  layer is bit-equal to eager JAX (the encoder's blocks here too), but the
  reference runs its layers inside ``lax.scan``, where XLA skips some bf16
  roundings, so logits agree within 3e-2 at logit scale ~1 and the
  encoder's output (LayerNorm, entries up to ~4) within two bf16 ulps of
  its largest entries (rtol 2^-6, atol 2^-4).
* The reference's own consistency bound, relative error < 0.05 of the
  decode logits against the full forward's (MoE capacity lifted, as
  ``_uncapped`` does), for the nine decoder architectures and whisper.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import lm as tlm

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

LOGIT_ATOL = 3e-2
ENC_TOL = dict(rtol=2 ** -6, atol=2 ** -4)
FAMILIES = ("whisper-base", "internvl2-76b")
S, B, TAIL = 24, 2, 4                       # tests/test_consistency.py
_LOADED = {}


def _load(arch):
    if arch not in _LOADED:
        cfg = get_config(arch, smoke=True)
        jp = jlm.lm_init(jax.random.PRNGKey(0), cfg)
        _LOADED[arch] = (cfg, jp, tget(arch, smoke=True),
                         params_from_jax(jax.tree.map(np.asarray, jp)))
    return _LOADED[arch]


def _inputs(cfg, seed, n=S):
    """Tokens, and whisper's frames or internvl2's patch embeddings
    (0.02 x normal, bf16, as tests/test_consistency.py draws them), in
    both packages."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    j, t = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    frames = None
    if cfg.frontend == "vlm_patch":
        emb = jnp.asarray(0.02 * r.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)), jnp.bfloat16)
        j["embeds"], t["embeds"] = emb, tensor_from_numpy(np.asarray(emb))
    if cfg.encoder is not None:
        frames = jnp.asarray(0.02 * r.standard_normal(
            (B, cfg.encoder.seq_len, cfg.d_model)), jnp.bfloat16)
    return toks, j, t, frames


def _enc(cfg, jp, tp, tcfg, frames):
    """(reference enc_out, port enc_out), or (None, None)."""
    if frames is None:
        return None, None
    return (jlm.encoder_apply(jp, frames, cfg),
            tlm.encoder_apply(tp, tensor_from_numpy(np.asarray(frames)),
                              tcfg))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tuple(tree.shape), tree.dtype


@pytest.mark.parametrize("arch", FAMILIES)
def test_converted_params_fill_the_ports_tree(arch):
    _, _, tcfg, tp = _load(arch)
    own = tlm.lm_init(None, tcfg, "meta")
    assert list(_leaves(tp)) == list(_leaves(own))
    assert ("encoder" in tp) == (arch == "whisper-base")
    assert ("pos" in tp) == (arch == "whisper-base")
    if arch == "whisper-base":
        blk = tp["groups"][0]["stacked"]["0"]
        assert {"cross", "norm_cross"} <= set(blk)
        assert tp["encoder"]["pos"]["pos_embed"].shape == (
            tcfg.encoder.seq_len, tcfg.d_model)


def test_encoder_apply_matches_reference():
    cfg, jp, tcfg, tp = _load("whisper-base")
    _, _, _, frames = _inputs(cfg, 0)
    enc, tenc = _enc(cfg, jp, tp, tcfg, frames)
    assert tenc.shape == (B, cfg.encoder.seq_len, cfg.d_model)
    np.testing.assert_allclose(tenc.float().numpy(),
                               np.asarray(enc, np.float32), **ENC_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_hidden_matches_reference(arch):
    """The full forward: whisper's decoder over its encoder output (cross
    attention, learned positions), internvl2's over patch embeddings
    placed before the tokens."""
    cfg, jp, tcfg, tp = _load(arch)
    _, j_in, t_in, frames = _inputs(cfg, 1)
    enc, tenc = _enc(cfg, jp, tp, tcfg, frames)
    h, _, _ = jlm.lm_hidden(jp, j_in, cfg, enc_out=enc)
    a = np.asarray(jlm.lm_logits(jp, h, cfg), np.float32)
    h, _ = tlm.lm_hidden(tp, t_in, tcfg, enc_out=tenc)
    b = tlm.lm_logits(tp, h, tcfg).float().numpy()
    patches = cfg.frontend_len if cfg.frontend == "vlm_patch" else 0
    assert b.shape == (B, S + patches, cfg.vocab)
    np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` of 20 tokens (internvl2: after 16 patch embeddings) into
    rings of S (+ 16) rows, then the 4 remaining tokens through
    ``decode_step`` at positions offset by the frontend's length: logits
    and ring positions against the reference's."""
    cfg, jp, tcfg, tp = _load(arch)
    toks, j_in, t_in, frames = _inputs(cfg, 2)
    enc, tenc = _enc(cfg, jp, tp, tcfg, frames)
    off = cfg.frontend_len if cfg.frontend == "vlm_patch" else 0
    sp, cap = S - TAIL, S + off
    lg, caches = jlm.prefill(jp, dict(j_in, tokens=j_in["tokens"][:, :sp]),
                             cfg, enc_out=enc, capacity=cap)
    tlg, tcaches = tlm.prefill(tp, dict(t_in, tokens=t_in["tokens"][:, :sp]),
                               tcfg, enc_out=tenc, capacity=cap)
    outs, touts = [lg], [tlg]
    for i in range(sp, S):
        p = np.full((B, 1), i + off, np.int32)
        lg, caches = jlm.decode_step(jp, caches, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.asarray(p), cfg, enc_out=enc)
        tlg, tcaches = tlm.decode_step(tp, tcaches,
                                       torch.from_numpy(toks[:, i:i + 1]),
                                       torch.from_numpy(p), tcfg,
                                       enc_out=tenc)
        outs.append(lg)
        touts.append(tlg)
    a = np.concatenate([np.asarray(o, np.float32) for o in outs], axis=1)
    b = torch.cat(touts, dim=1).float().numpy()
    np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0)
    for gj, gt in zip(caches, tcaches):
        for bi in gt:
            assert np.array_equal(gt[bi]["attn"]["pos"].numpy(),
                                  np.asarray(gj[bi]["attn"]["pos"]))
    j_pos = np.asarray(caches[0]["0"]["attn"]["pos"])
    assert j_pos.max() == S - 1 + off


def _uncapped(cfg):
    """MoE capacity lifted (tests/test_consistency.py::_uncapped): a full
    forward drops overflow tokens, a one-token decode cannot."""
    groups = []
    for g in cfg.groups:
        pat = tuple(dataclasses.replace(b, moe=dataclasses.replace(
            b.moe, capacity_factor=float(b.moe.n_experts)))
            if b.moe is not None else b for b in g.pattern)
        groups.append(dataclasses.replace(g, pattern=pat))
    return dataclasses.replace(cfg, groups=tuple(groups))


def _port_params(cfg):
    gen = torch.Generator().manual_seed(0)
    return tlm.lm_init(gen, cfg, "cpu")


def _rel_err(outs, full, sp, off):
    dec = torch.cat(outs[:-1], dim=1).float()
    ref = full[:, sp - 1 + off:S - 1 + off]
    return float((dec - ref).abs().max() / (ref.abs().max() + 1e-9))


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "whisper-base"])
def test_decode_matches_full_forward_in_the_port(arch):
    """tests/test_consistency.py::test_decode_matches_full_forward on the
    port alone, with its own seeded weights: ``prefill`` of 20 tokens and
    4 ``decode_step``s reproduce the full forward's logits (rel < 0.05)."""
    cfg = _uncapped(tget(arch, smoke=True))
    params = _port_params(cfg)
    r = np.random.default_rng(1)
    toks = torch.from_numpy(r.integers(0, cfg.vocab, (B, S)).astype(
        np.int32))
    inputs = {"tokens": toks}
    off = 0
    if cfg.frontend == "vlm_patch":
        off = cfg.frontend_len
        inputs["embeds"] = (0.02 * torch.from_numpy(r.standard_normal(
            (B, off, cfg.d_model)))).to(torch.bfloat16)
    h, _ = tlm.lm_hidden(params, inputs, cfg)
    full = tlm.lm_logits(params, h, cfg).float()
    sp = S - TAIL
    lg, caches = tlm.prefill(params, dict(inputs, tokens=toks[:, :sp]), cfg,
                             capacity=S + off)
    outs = [lg]
    for i in range(sp, S):
        lg, caches = tlm.decode_step(params, caches, toks[:, i:i + 1],
                                     torch.full((B, 1), i + off,
                                                dtype=torch.int32), cfg)
        outs.append(lg)
    err = _rel_err(outs, full, sp, off)
    assert err < 0.05, f"{arch}: decode/full mismatch rel={err:.3e}"


def test_whisper_decode_matches_full_forward_in_the_port():
    """tests/test_consistency.py::test_whisper_decode_consistency on the
    port alone: the decoder over the encoder's output, prefill + decode
    against the full forward (rel < 0.05)."""
    cfg = tget("whisper-base", smoke=True)
    params = _port_params(cfg)
    r = np.random.default_rng(1)
    frames = (0.02 * torch.from_numpy(r.standard_normal(
        (B, cfg.encoder.seq_len, cfg.d_model)))).to(torch.bfloat16)
    enc = tlm.encoder_apply(params, frames, cfg)
    toks = torch.from_numpy(r.integers(0, cfg.vocab, (B, S)).astype(
        np.int32))
    h, _ = tlm.lm_hidden(params, {"tokens": toks}, cfg, enc_out=enc)
    full = tlm.lm_logits(params, h, cfg).float()
    sp = S - TAIL
    lg, caches = tlm.prefill(params, {"tokens": toks[:, :sp]}, cfg,
                             enc_out=enc, capacity=S)
    outs = [lg]
    for i in range(sp, S):
        lg, caches = tlm.decode_step(params, caches, toks[:, i:i + 1],
                                     torch.full((B, 1), i, dtype=torch.int32),
                                     cfg, enc_out=enc)
        outs.append(lg)
    err = _rel_err(outs, full, sp, 0)
    assert err < 0.05, f"whisper decode mismatch rel={err:.3e}"


def test_cross_attention_needs_the_encoder_output():
    cfg, _, tcfg, tp = _load("whisper-base")
    with pytest.raises(ValueError, match="enc_out"):
        tlm.lm_hidden(tp, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                      tcfg)
