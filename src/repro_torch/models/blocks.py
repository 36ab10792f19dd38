"""Residual blocks and scan groups. Port of ``repro.models.blocks``.

A group's repeated pattern keeps the reference's STACKED parameter layout
(every leaf has a leading repeats axis), so converted reference params map
1:1; ``group_apply`` walks the repeats in a Python loop and indexes the
stacked leaves (PyTorch runs eagerly, so there is no scan to compile).
Blocks marked ``shared`` keep one un-stacked parameter set reused by every
repeat. Caches are updated in place (see ``models.attention`` and
``models.ssm``).

``block_apply`` and ``group_apply`` return the MoE load-balance loss beside
the hidden states, summed over layers as the reference's scan sums it.
Cross-attention blocks (enc-dec decoders) take the encoder output
``enc_out`` and recompute its k/v on every call, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import (attn_apply, attn_cache_init,
                                          attn_init, gqa_encoder_kv)
from repro_torch.models.layers import norm_apply, norm_init
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.spec import BlockSpec, ModelConfig, ScanGroup
from repro_torch.models.ssm import ssm_apply, ssm_cache_init, ssm_init

# cache entries one value serves for every repeat of a group (a paged
# leaf's page table and sink flag, an SSM cache's stall mask): never
# indexed by repeat
_PER_CALL = ("table", "sink", "live")


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts/lists of tensors."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def block_init(gen, cfg: ModelConfig, b: BlockSpec, device) -> dict:
    dt = torch.bfloat16
    p: dict = {}
    if b.attn is not None:
        p["norm_attn"] = norm_init(cfg.d_model, cfg.norm, cfg.use_bias, dt,
                                   device)
        p["attn"] = attn_init(gen, cfg.d_model, b.attn, cfg, device)
        if b.post_norms:
            p["post_attn"] = norm_init(cfg.d_model, cfg.norm, cfg.use_bias,
                                       dt, device)
    if b.ssm is not None:
        p["norm_ssm"] = norm_init(cfg.d_model, cfg.norm, cfg.use_bias, dt,
                                  device)
        p["ssm"] = ssm_init(gen, cfg.d_model, b.ssm, cfg, device)
    if b.cross_attn is not None:
        p["norm_cross"] = norm_init(cfg.d_model, cfg.norm, cfg.use_bias, dt,
                                    device)
        p["cross"] = attn_init(gen, cfg.d_model, b.cross_attn, cfg, device)
    if b.mlp is not None:
        if not b.parallel_residual:
            p["norm_mlp"] = norm_init(cfg.d_model, cfg.norm, cfg.use_bias,
                                      dt, device)
        p["mlp"] = mlp_init(gen, cfg.d_model, b.mlp, cfg, device)
        if b.post_norms:
            p["post_mlp"] = norm_init(cfg.d_model, cfg.norm, cfg.use_bias,
                                      dt, device)
    if b.moe is not None:
        p["norm_moe"] = norm_init(cfg.d_model, cfg.norm, cfg.use_bias, dt,
                                  device)
        p["moe"] = moe_init(gen, cfg.d_model, b.moe, cfg, device)
    return p


def block_apply(p: dict, x: torch.Tensor, b: BlockSpec, cfg: ModelConfig,
                positions: torch.Tensor, cache: Optional[dict] = None,
                enc_out: Optional[torch.Tensor] = None):
    """Returns (the block's output, its MoE aux loss: 0.0 without MoE);
    the cache is updated in place. A cross-attention block needs
    ``enc_out`` (B, S_enc, D)."""
    aux = 0.0
    nk, ne = cfg.norm, cfg.norm_eps
    c_attn = cache.get("attn") if cache else None
    c_ssm = cache.get("ssm") if cache else None

    if b.parallel_residual:
        h = norm_apply(p["norm_attn"], x, nk, ne)
        a = attn_apply(p["attn"], h, b.attn, cfg, positions, cache=c_attn)
        return x + a + mlp_apply(p["mlp"], h, b.mlp), aux

    if b.attn is not None:
        h = norm_apply(p["norm_attn"], x, nk, ne)
        a = attn_apply(p["attn"], h, b.attn, cfg, positions, cache=c_attn)
        if b.post_norms:
            a = norm_apply(p["post_attn"], a, nk, ne)
        x = x + a

    if b.ssm is not None:
        h = norm_apply(p["norm_ssm"], x, nk, ne)
        x = x + ssm_apply(p["ssm"], h, b.ssm, cfg, positions, cache=c_ssm)

    if b.cross_attn is not None:
        if enc_out is None:
            raise ValueError(f"{cfg.name}: a cross-attention block needs "
                             "the encoder output (enc_out)")
        h = norm_apply(p["norm_cross"], x, nk, ne)
        kv = gqa_encoder_kv(p["cross"], enc_out, b.cross_attn)
        x = x + attn_apply(p["cross"], h, b.cross_attn, cfg, positions,
                           encoder_out=kv)

    if b.mlp is not None:
        h = norm_apply(p["norm_mlp"], x, nk, ne)
        m = mlp_apply(p["mlp"], h, b.mlp)
        if b.post_norms:
            m = norm_apply(p["post_mlp"], m, nk, ne)
        x = x + m

    if b.moe is not None:
        h = norm_apply(p["norm_moe"], x, nk, ne)
        m, aux = moe_apply(p["moe"], h, b.moe)
        x = x + m
    return x, aux


def block_cache_init(cfg: ModelConfig, b: BlockSpec, batch: int,
                     capacity: int, device) -> dict:
    c: dict = {}
    if b.attn is not None:
        c["attn"] = attn_cache_init(batch, capacity, b.attn, device)
    if b.ssm is not None:
        c["ssm"] = ssm_cache_init(batch, cfg.d_model, b.ssm, device)
    return c


# ---------------------------------------------------------------------------
# Scan group
# ---------------------------------------------------------------------------

def group_init(gen, cfg: ModelConfig, g: ScanGroup, device) -> dict:
    """Stacked params: each repeat is drawn separately and copied into its
    row of the stacked leaf, so no stacked f32 temporary is ever built."""
    stacked, shared = {}, {}
    for i, b in enumerate(g.pattern):
        if b.shared:
            shared[str(i)] = block_init(gen, cfg, b, device)
            continue
        first = block_init(gen, cfg, b, device)
        st = tree_map(lambda a: a.new_empty((g.repeats,) + a.shape), first)
        tree_map(lambda s, a: s[0].copy_(a), st, first)
        del first
        for r in range(1, g.repeats):
            tree_map(lambda s, a: s[r].copy_(a), st,
                     block_init(gen, cfg, b, device))
        stacked[str(i)] = st
    return {"stacked": stacked, "shared": shared}


def group_cache_init(cfg: ModelConfig, g: ScanGroup, batch: int,
                     capacity: int, device) -> dict:
    per_block = {str(i): block_cache_init(cfg, b, batch, capacity, device)
                 for i, b in enumerate(g.pattern)}
    return tree_map(
        lambda a: a[None].expand((g.repeats,) + a.shape).clone(), per_block)


def _repeat(tree: dict, r: int) -> dict:
    """Repeat ``r`` of a stacked tree: every leaf indexed at r (a view, so
    in-place cache writes land in the stack), except the per-call entries
    (``_PER_CALL``), which one tensor serves for every repeat."""
    return {k: (v if k in _PER_CALL else
                _repeat(v, r) if isinstance(v, dict) else v[r])
            for k, v in tree.items()}


def group_apply(gp: dict, x: torch.Tensor, g: ScanGroup, cfg: ModelConfig,
                positions: torch.Tensor, caches: Optional[dict] = None,
                enc_out: Optional[torch.Tensor] = None):
    """Walk the pattern over repeats; the caches are updated in place.
    Returns (x, the summed MoE aux loss)."""
    shared = gp["shared"]
    aux = 0.0
    for r in range(g.repeats):
        for i, b in enumerate(g.pattern):
            pi = shared[str(i)] if b.shared else _repeat(gp["stacked"][str(i)],
                                                          r)
            ci = _repeat(caches[str(i)], r) if caches is not None else None
            x, a = block_apply(pi, x, b, cfg, positions, cache=ci,
                               enc_out=enc_out)
            aux = aux + a
    return x, aux
