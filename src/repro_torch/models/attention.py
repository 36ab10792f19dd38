"""Attention: GQA (qk-norm / softcap / sliding window / cross) and MLA.
Port of ``repro.models.attention``.

One flat-head core serves every variant: kv heads are never repeated up
to H; queries are grouped (B,Q,K,G,D) against (B,S,K,D) keys.

Caches are fixed-capacity ring buffers ``{k, v, pos}`` where ``pos`` holds
the absolute position stored in each slot (-1 = empty). Softmax is
permutation invariant, so ring order never matters; masks derive from
``pos`` alone.

Where the reference returns updated caches functionally, the port updates
the cache tensors IN PLACE: at full width a copy of the pool per step would
double its memory. Callers that need the old state clone it first.

Two execution paths, chosen by shape as in the reference: ``_attn_flat``
materializes the (B,K,G,Q,S) logits; ``_attn_blocked`` walks 1,024-key
blocks with an online softmax (Q > 1 over more than ``BLOCKED_THRESHOLD``
keys, or ``KV_BLOCK`` with ``prefer_blocked``). The hand-written kernel of
the same algorithm is ``kernels.flash_attention``; as in the reference, no
model calls it.

int8 KV caches (``spec.kv_quant``) hold per-(token, head) symmetric int8
rows with bf16 scales (``k_scale`` / ``v_scale``), in rings and in pool
leaves alike; quantized pool leaves always take the gather route (the
paged kernel reads raw pool leaves and does not dequantize), as in the
reference.

Cross-attention (enc-dec decoders) attends encoder keys/values without a
mask or rope; its k/v come from ``gqa_encoder_kv`` on every call.

On a mesh of ranks (DTensors, ``sharding.spmd``) the products, the
softmax and the ring writes go through that module's ops: each rank
computes on its shards and writes its own shard of a ring; on plain
tensors they are the plain ops. The paged kernel takes no DTensor.

MLA (DeepSeek-V2) keeps a compressed cache ``{ckv, kr, pos}``: a prefill
without a pool runs the decompressed form; a ring decode and every call on
a pool leaf run the weight-absorbed form, which is MQA against the
compressed rows (K = 1; scores q_abs.ckv + q_rope.kr, values ckv). On a
pool leaf that form goes to the paged kernel with k = v = the ckv pool and
the second score term q2/k2 = q_rope/kr.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.layers import (apply_rope, fan_in_init, head_rmsnorm,
                                       softcap)
from repro_torch.models.spec import AttentionSpec, ModelConfig
from repro_torch.sharding.partition import constrain
from repro_torch.sharding.spmd import (einsum, is_sharded, pad, reshape,
                                       softmax, write_rows)

BLOCKED_THRESHOLD = 8192
KV_BLOCK = 1024            # key-block width for the blocked path

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Core (flat heads, asymmetric qk/v dims)
# ---------------------------------------------------------------------------

def _mask(q_pos, k_pos, causal, window):
    """q_pos: (B,Q), k_pos: (B,S) -> bool (B,Q,S). Empty slots have pos=-1."""
    valid = (k_pos >= 0)[:, None, :]
    if causal:
        valid = valid & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        valid = valid & ((q_pos[:, :, None] - k_pos[:, None, :]) < window)
    return valid


def attn_core(q, k, v, q_pos, k_pos, *, scale, causal, window, cap,
              n_kv: int, prefer_blocked: bool = False):
    """Grouped GQA core — kv is NEVER repeated to H.

    q: (B,Q,H,Dk) with H = n_kv*G;  k: (B,S,K,Dk);  v: (B,S,K,Dv).
    Returns (B,Q,H,Dv). Decode (Q == 1) always takes the flat path."""
    B, Q, H, Dk = q.shape
    G = H // n_kv
    q5 = reshape(q, (B, Q, n_kv, G, Dk))
    # batch follows the cache's batch sharding, as in the reference
    q5 = constrain(q5, "cache_batch", "seq", "kv_heads", "q_group",
                   "head_dim")
    limit = KV_BLOCK if prefer_blocked else BLOCKED_THRESHOLD
    blocked = Q > 1 and k.shape[1] > limit
    path = _attn_blocked if blocked else _attn_flat
    out = path(q5, k, v, q_pos, k_pos, scale=scale, causal=causal,
               window=window, cap=cap)
    # the output keeps q5's layout
    out = constrain(out, "cache_batch", "seq", "kv_heads", "q_group",
                    "head_dim")
    return reshape(out, (B, Q, H, v.shape[-1]))


def _attn_flat(q, k, v, q_pos, k_pos, *, scale, causal, window, cap):
    """q: (B,Q,K,G,Dk), k: (B,S,K,Dk), v: (B,S,K,Dv) -> (B,Q,K,G,Dv).

    Mirrors the reference exactly: the scale is folded into q in q's dtype
    (the paged kernel instead scales f32 scores), scores accumulate in f32,
    and p is cast to v's dtype before the value product."""
    q = (q.float() * scale).to(q.dtype)
    s = einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    if cap is not None:
        s = softcap(s, cap)
    m = _mask(q_pos, k_pos, causal, window)[:, None, None]   # (B,1,1,Q,S)
    s = torch.where(m, s, NEG_INF)
    p = softmax(s, dim=-1)
    # fully-masked rows (e.g. empty ring slots only) -> zeros, not NaN
    p = torch.where(m.any(-1, keepdim=True), p, 0.0)
    out = einsum("bkgqs,bskv->bqkgv", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _attn_blocked(q, k, v, q_pos, k_pos, *, scale, causal, window, cap):
    """Online softmax over KV_BLOCK-key blocks; O(Q x block) logits.

    q: (B,Q,K,G,Dk); k/v stay at K kv-heads throughout -> (B,Q,K,G,Dv).
    Mirrors the reference exactly: keys padded to whole blocks (k_pos = -1),
    the scale folded into q in q's dtype, scores in f32, m from NEG_INF, no
    second mask after the exp (a row with no valid key thus sums v over the
    keys and divides by the padded length, as the reference's does), p cast
    to v's dtype before the value product, and the output in v's dtype.
    The blocks are views of k and v; only the last one, if short, is padded
    (a copy of one block, not of the cache)."""
    B, Q, K, G, Dk = q.shape
    S = k.shape[1]
    q = (q.float() * scale).to(q.dtype).float()
    m_run = torch.full((B, K, G, Q), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros((B, K, G, Q, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, S, KV_BLOCK):
        kc, vc = k[:, lo:lo + KV_BLOCK], v[:, lo:lo + KV_BLOCK]
        pc = k_pos[:, lo:lo + KV_BLOCK]
        short = KV_BLOCK - kc.shape[1]
        if short:
            kc = pad(kc, (0, 0, 0, 0, 0, short))
            vc = pad(vc, (0, 0, 0, 0, 0, short))
            pc = pad(pc, (0, short), value=-1)
        s = einsum("bqkgd,bskd->bkgqs", q, kc.float())
        if cap is not None:
            s = softcap(s, cap)
        msk = _mask(q_pos, pc, causal, window)[:, None, None]
        s = s.masked_fill_(~msk, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1))
        alpha = torch.exp(m_run - m_new)
        # exp(NEG_INF - m_new) is exactly 0 for any real m_new; in place
        # (a block's scores are the largest temporary) unless autograd
        # needs s: amax saved it for the backward pass
        p = (s.sub_(m_new[..., None]).exp_() if not s.requires_grad
             else torch.exp(s - m_new[..., None]))
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + einsum(
            "bkgqs,bskv->bkgqv", p.to(v.dtype).float(), vc.float())
        m_run = m_new
    l_safe = torch.where(l_run > 0, l_run, 1.0)
    out = acc / l_safe[..., None]
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_init(gen, d_model: int, spec: AttentionSpec, cfg: ModelConfig,
             device) -> dict:
    H, K, Dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    dt = torch.bfloat16
    p = {
        "wq": fan_in_init(gen, (d_model, H, Dh), d_model, dt, device),
        "wk": fan_in_init(gen, (d_model, K, Dh), d_model, dt, device),
        "wv": fan_in_init(gen, (d_model, K, Dh), d_model, dt, device),
        "wo": fan_in_init(gen, (H, Dh, d_model), H * Dh, dt, device),
    }
    if cfg.use_bias:
        p["bq"] = torch.zeros((H, Dh), dtype=dt, device=device)
        p["bk"] = torch.zeros((K, Dh), dtype=dt, device=device)
        p["bv"] = torch.zeros((K, Dh), dtype=dt, device=device)
        p["bo"] = torch.zeros((d_model,), dtype=dt, device=device)
    if spec.qk_norm:
        p["q_norm"] = torch.ones((Dh,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((Dh,), dtype=dt, device=device)
    return p


def _kv_quantize(x: torch.Tensor):
    """Per-(token, head) symmetric int8. x: (B,S,K,D) -> (int8, scale bf16).
    Op for op as the reference: the scale in f32, round half to even."""
    xf = x.float()
    scale = xf.abs().amax(-1) / 127.0 + 1e-8
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A bf16 x bf16 product, as the reference's."""
    return q.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def _kv_entries(k: torch.Tensor, v: torch.Tensor, quant: bool) -> dict:
    """The rows a cache stores for fresh k/v: as they are, or int8 with
    their scales."""
    if not quant:
        return {"k": k, "v": v}
    kq, ks = _kv_quantize(k)
    vq, vs = _kv_quantize(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _kv_read(cache: dict):
    """A cache's k and v in bf16: dequantized where the rows are int8."""
    if "k_scale" not in cache:
        return cache["k"], cache["v"]
    return (_kv_dequantize(cache["k"], cache["k_scale"]),
            _kv_dequantize(cache["v"], cache["v_scale"]))


_CACHE_AXES = {
    "k": ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
    "k_scale": ("cache_batch", "cache_seq", "kv_heads"),
    "v_scale": ("cache_batch", "cache_seq", "kv_heads"),
    "pos": ("cache_batch", "cache_seq"),
    "ckv": ("cache_batch", "cache_seq", "kv_lora"),
    "kr": ("cache_batch", "cache_seq", "head_dim"),
}


def constrain_cache(cache: dict) -> dict:
    """Pin ring-cache tensors to their layout (in place; returns ``cache``)."""
    for k in cache:
        if k in _CACHE_AXES:
            cache[k] = constrain(cache[k], *_CACHE_AXES[k])
    return cache


def _ring_update(cache: dict, new: dict, positions: torch.Tensor) -> dict:
    """Write new entries into ring slots pos % capacity, in place.

    Handles: decode (one token), prefill shorter than capacity (contiguous
    block starting at slot 0), and prefill LONGER than a windowed layer's
    capacity (keep the trailing window; a full-coverage write realized as a
    roll so every row lands on its pos%cap slot)."""
    cap = cache["pos"].shape[1]
    B, S = positions.shape
    entries = dict(new)
    entries["pos"] = positions
    if is_sharded(cache["pos"]):
        first = positions[:, -cap] if S >= cap else positions[:, 0]
        start = first % cap if S >= cap else (first % cap).clamp(max=cap - S)
        for k, v in entries.items():
            write_rows(cache[k], v, start)
        return cache
    rows = torch.arange(B, device=positions.device)[:, None]
    if S >= cap:
        shift = positions[:, -cap] % cap                         # (B,)
        cols = (torch.arange(cap, device=positions.device)[None]
                + shift[:, None]) % cap                          # roll by shift
        for k, v in entries.items():
            cache[k][rows, cols] = v[:, -cap:].to(cache[k].dtype)
        return constrain_cache(cache)
    # dynamic_update_slice semantics: the start clamps so the block fits
    start = (positions[:, 0] % cap).clamp(max=cap - S)           # (B,)
    cols = start[:, None] + torch.arange(S, device=positions.device)[None]
    for k in cache:
        cache[k][rows, cols] = entries[k].to(cache[k].dtype)
    return constrain_cache(cache)


# ---------------------------------------------------------------------------
# Paged leaf path (pool-resident caches; serve engine)
# ---------------------------------------------------------------------------
#
# A paged cache leaf is the POOL's leaf for one scan repeat plus the slots'
# page table: {"k": (P, ps, K, D), "v": ..., "pos": (P, ps),
# "table": (B, npps)}. Fresh rows are written straight into their pages (no
# dense intermediate) and attention reads the pool THROUGH the table —
# either by materializing this one leaf's dense view (cfg.paged_kernel ==
# "gather") or by walking the table inside the paged-attention kernel
# ("paged"). Row -> page mapping matches ``models.lm.paged_scatter``:
# virtual row v = pos % vcap lives in page table[v // ps] at offset v % ps.
# A -1 table entry (stalled/dead slot) or -1 position (pad row) drops the
# write with no host sync, so a decode step can be captured in a CUDA
# graph: a dropped row is sent to the leaf's SINK page, one page past its
# last, which no table maps. Dropped rows may collide with each other
# there, never with a kept row, so a real page only ever receives kept rows
# — and a clamped page 0 is never written. Pool leaves carry their sink
# page from ``models.lm.paged_cache_init`` (``sink`` set in the leaf);
# a leaf made elsewhere gets one in place on its first write.

def with_sink(leaf: torch.Tensor, axis: int = 0,
              known: bool = False) -> torch.Tensor:
    """``leaf``, pages on ``axis`` (0: one leaf; 1: a stack of repeats),
    seen with one page more on that axis — its sink page — in the same
    storage. Unless ``known``, a leaf without room for one is first moved,
    in place (``Tensor.set_``: the same tensor object, new storage), into
    storage that has it; never inside a CUDA graph capture, where that
    would allocate from the graph's memory."""
    P = leaf.shape[axis]
    shape = list(leaf.shape)
    shape[axis] = P + 1
    if not known and not _has_sink(leaf, axis):
        if leaf.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged leaf without a sink page inside a "
                               "capture: build pools with paged_cache_init")
        full = torch.empty(shape, dtype=leaf.dtype, device=leaf.device)
        full.narrow(axis, P, 1).zero_()
        view = full.narrow(axis, 0, P).copy_(leaf)
        leaf.set_(full.untyped_storage(), view.storage_offset(), view.shape,
                  view.stride())
    return leaf.as_strided(shape, leaf.stride(), leaf.storage_offset())


def _has_sink(leaf: torch.Tensor, axis: int) -> bool:
    """Whether the page past ``leaf``'s last on ``axis`` is its own: the
    pages are dense, a stack's repeats are P + 1 pages apart, and the
    storage holds the last repeat's extra page."""
    page = leaf.stride(axis)
    P = leaf.shape[axis]
    inner = leaf.select(axis, 0).select(0, 0) if axis else leaf[0]
    if page != inner.numel() or not inner.is_contiguous():
        return False
    span = (P + 1) * page
    if axis == 1:
        if leaf.stride(0) != span:
            return False
        span += (leaf.shape[0] - 1) * leaf.stride(0)
    return (leaf.device.type == "meta"
            or (leaf.storage_offset() + span) * leaf.element_size()
            <= leaf.untyped_storage().nbytes())


def _paged_leaf_update(cache: dict, entries: dict,
                       positions: torch.Tensor) -> dict:
    """Scatter fresh (B,S) rows into the pool pages mapped by the table,
    in place; dropped rows land in the sink page."""
    table = cache["table"]                                    # (B, npps)
    P, ps = cache["pos"].shape
    vcap = table.shape[1] * ps
    valid = positions >= 0
    v = torch.where(valid, positions % vcap, 0)
    page = torch.gather(table, 1, (v // ps).long())           # (B, S)
    keep = valid & (page >= 0)
    pg = torch.where(keep, page, P).long()                    # P: the sink
    off = torch.where(keep, v % ps, 0).long()
    known = bool(cache.get("sink"))
    for k, rows in (*entries.items(), ("pos", positions)):
        with_sink(cache[k], known=known)[pg, off] = rows.to(cache[k].dtype)
    return cache


def _paged_leaf_gather(cache: dict):
    """Dense per-slot view of ONE pool leaf: ({k: (B,vcap,...)}, kpos)."""
    table = cache["table"]
    ps = cache["pos"].shape[-1]
    B, npps = table.shape
    cl = table.clamp(min=0).long()

    def g(leaf):
        return leaf[cl].reshape(B, npps * ps, *leaf.shape[2:])

    dense = {k: g(v) for k, v in cache.items()
             if k not in ("table", "sink", "pos")}
    kpos = torch.where((table >= 0).repeat_interleave(ps, dim=1),
                       g(cache["pos"]), -1)
    return dense, kpos


def _paged_gqa(cache: dict, q, k, v, spec: AttentionSpec, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    """GQA over a paged leaf: write fresh rows, attend through the table.

    int8-quantized leaves always take the gather route (the kernel reads
    raw pool leaves and does not dequantize), as the reference's do."""
    quant = "k_scale" in cache
    cache = _paged_leaf_update(cache, _kv_entries(k, v, quant), positions)
    scale = 1.0 / (spec.head_dim ** 0.5)
    if cfg.paged_kernel == "paged" and not quant:
        return paged_attention(
            q.contiguous(), cache["k"], cache["v"], cache["pos"],
            cache["table"], positions, scale=scale, causal=spec.causal,
            window=spec.window, softcap=spec.logit_softcap)
    dense, kpos = _paged_leaf_gather(cache)
    kd, vd = _kv_read(dense)
    return attn_core(q, kd, vd, positions, kpos, scale=scale,
                     causal=spec.causal, window=spec.window,
                     cap=spec.logit_softcap, n_kv=kd.shape[2])


def gqa_apply(params: dict, x: torch.Tensor, spec: AttentionSpec,
              cfg: ModelConfig, positions: torch.Tensor,
              cache: Optional[dict] = None,
              encoder_out: Optional[dict] = None) -> torch.Tensor:
    """x: (B,S,D) -> y (B,S,D); ``cache`` (ring or paged leaf) is updated
    in place. With ``encoder_out`` ({k, v} from ``gqa_encoder_kv``) this is
    cross-attention: static keys, no rope, no mask, no cache."""
    Dh = spec.head_dim
    S = x.shape[1]

    q = einsum("bsd,dhk->bshk", x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]

    if encoder_out is not None:                  # cross-attention
        k, v = encoder_out["k"], encoder_out["v"]
        if spec.qk_norm:
            q = head_rmsnorm(params["q_norm"], q)
        out = attn_core(q, k, v, positions,
                        torch.zeros(k.shape[:2], dtype=torch.int32,
                                    device=k.device),
                        scale=1.0 / (Dh ** 0.5), causal=False, window=None,
                        cap=spec.logit_softcap, n_kv=k.shape[2])
        return _out_proj(params, out)

    k = einsum("bsd,dhk->bshk", x, params["wk"])
    v = einsum("bsd,dhk->bshk", x, params["wv"])
    if "bk" in params:
        k, v = k + params["bk"], v + params["bv"]
    if spec.qk_norm:
        q = head_rmsnorm(params["q_norm"], q)
        k = head_rmsnorm(params["k_norm"], k)
    if spec.rope_theta:
        q = apply_rope(q, positions, spec.rope_theta, spec.rope_pct)
        k = apply_rope(k, positions, spec.rope_theta, spec.rope_pct)

    if cache is not None and "table" in cache:       # paged pool leaf
        out = _paged_gqa(cache, q, k, v, spec, cfg, positions)
    else:
        k_pos = positions
        if cache is not None:
            cache = _ring_update(cache, _kv_entries(k, v, "k_scale" in cache),
                                 positions)
            if S == 1:
                # decode: attend the ring contents
                (k, v), k_pos = _kv_read(cache), cache["pos"]
            # prefill: attend the fresh full-sequence k/v — early queries
            # need history a windowed ring no longer holds
        out = attn_core(q, k, v, positions, k_pos, scale=1.0 / (Dh ** 0.5),
                        causal=spec.causal, window=spec.window,
                        cap=spec.logit_softcap, n_kv=k.shape[2])
    return _out_proj(params, out)


def _out_proj(params: dict, out: torch.Tensor) -> torch.Tensor:
    y = einsum("bshk,hkd->bsd", out, params["wo"])
    if "bo" in params:
        y = y + params["bo"]
    return y


def gqa_encoder_kv(params: dict, enc: torch.Tensor,
                   spec: AttentionSpec) -> dict:
    """Cross-attention k/v from encoder output (no rope)."""
    k = einsum("bsd,dhk->bshk", enc, params["wk"])
    v = einsum("bsd,dhk->bshk", enc, params["wv"])
    if "bk" in params:
        k, v = k + params["bk"], v + params["bv"]
    return {"k": k, "v": v}


def gqa_cache_init(batch: int, capacity: int, spec: AttentionSpec,
                   device) -> dict:
    K, Dh = spec.n_kv_heads, spec.head_dim
    cap = capacity if spec.window is None else min(capacity, spec.window)
    kv_dt = torch.int8 if spec.kv_quant else torch.bfloat16
    c = {
        "k": torch.zeros((batch, cap, K, Dh), dtype=kv_dt, device=device),
        "v": torch.zeros((batch, cap, K, Dh), dtype=kv_dt, device=device),
        "pos": torch.full((batch, cap), -1, dtype=torch.int32, device=device),
    }
    if spec.kv_quant:
        for n in ("k_scale", "v_scale"):
            c[n] = torch.zeros((batch, cap, K), dtype=torch.bfloat16,
                               device=device)
    return c


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(gen, d_model: int, spec: AttentionSpec, cfg: ModelConfig,
             device) -> dict:
    H = spec.n_heads
    ql, kl = spec.q_lora_rank, spec.kv_lora_rank
    dn, dr, dv = spec.qk_nope_head_dim, spec.qk_rope_head_dim, spec.v_head_dim
    dt = torch.bfloat16
    return {
        "w_dq": fan_in_init(gen, (d_model, ql), d_model, dt, device),
        "q_norm": torch.ones((ql,), dtype=dt, device=device),
        "w_uq": fan_in_init(gen, (ql, H, dn + dr), ql, dt, device),
        "w_dkv": fan_in_init(gen, (d_model, kl + dr), d_model, dt, device),
        "kv_norm": torch.ones((kl,), dtype=dt, device=device),
        "w_uk": fan_in_init(gen, (kl, H, dn), kl, dt, device),
        "w_uv": fan_in_init(gen, (kl, H, dv), kl, dt, device),
        "wo": fan_in_init(gen, (H, dv, d_model), H * dv, dt, device),
    }


def mla_cache_init(batch: int, capacity: int, spec: AttentionSpec,
                   device) -> dict:
    dt = torch.bfloat16
    return {
        "ckv": torch.zeros((batch, capacity, spec.kv_lora_rank), dtype=dt,
                           device=device),
        "kr": torch.zeros((batch, capacity, spec.qk_rope_head_dim),
                          dtype=dt, device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                          device=device),
    }


def _mla_compress(params, x, spec, positions):
    """x -> (ckv (B,S,kl) normalized, kr (B,S,dr) roped)."""
    kl = spec.kv_lora_rank
    dkv = einsum("bsd,dr->bsr", x, params["w_dkv"])
    ckv = head_rmsnorm(params["kv_norm"], dkv[..., :kl])
    kr = apply_rope(dkv[..., kl:], positions, spec.rope_theta)
    return ckv, kr


def _mla_queries(params, x, spec, positions):
    dn = spec.qk_nope_head_dim
    cq = head_rmsnorm(params["q_norm"],
                      einsum("bsd,dq->bsq", x, params["w_dq"]))
    q = einsum("bsq,qhk->bshk", cq, params["w_uq"])
    return q[..., :dn], apply_rope(q[..., dn:], positions, spec.rope_theta)


def _mla_mqa(q_abs, q_rope, ckv, kr, q_pos, k_pos, scale):
    """The absorbed form through ``attn_core``: q and k concatenated to
    kl + dr columns over one kv head, values the ckv rows."""
    q_cat = torch.cat([q_abs, q_rope], dim=-1)
    k_cat = torch.cat([ckv, kr], dim=-1)[:, :, None, :].to(q_cat.dtype)
    return attn_core(q_cat, k_cat, ckv[:, :, None, :].to(q_cat.dtype),
                     q_pos, k_pos, scale=scale, causal=True, window=None,
                     cap=None, n_kv=1)


def _paged_mla(cache: dict, q_abs, q_rope, cfg: ModelConfig, positions,
               scale) -> torch.Tensor:
    """The absorbed form over a pool leaf (fresh rows already written):
    the paged kernel with k = v = the ckv pool (one tensor, twice, no copy
    in the model's bf16) and q2/k2 = q_rope/kr, or a dense gather."""
    if cfg.paged_kernel == "paged":
        ckv = cache["ckv"][:, :, None, :].to(q_abs.dtype)
        return paged_attention(
            q_abs.contiguous(), ckv, ckv, cache["pos"], cache["table"],
            positions, q2=q_rope.contiguous(),
            k2=cache["kr"][:, :, None, :].to(q_abs.dtype), scale=scale,
            causal=True)
    dense, kpos = _paged_leaf_gather(cache)
    return _mla_mqa(q_abs, q_rope, dense["ckv"], dense["kr"], positions,
                    kpos, scale)


def mla_apply(params: dict, x: torch.Tensor, spec: AttentionSpec,
              cfg: ModelConfig, positions: torch.Tensor,
              cache: Optional[dict] = None) -> torch.Tensor:
    """x: (B,S,D) -> y (B,S,D); ``cache`` is updated in place. The scale is
    1/sqrt(dn + dr), the decompressed head's: not the paged kernel's
    default over the absorbed widths (kl + dr)."""
    B, S, _ = x.shape
    H = spec.n_heads
    dn, dr = spec.qk_nope_head_dim, spec.qk_rope_head_dim
    scale = 1.0 / ((dn + dr) ** 0.5)

    q_nope, q_rope = _mla_queries(params, x, spec, positions)
    ckv, kr = _mla_compress(params, x, spec, positions)

    if cache is not None and ("table" in cache or S == 1):
        # weight-absorbed form: exact, and for ANY S on a pool leaf, so a
        # warm-prefix suffix prefill attends shared pages directly
        q_abs = einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
        if "table" in cache:                         # paged pool leaf
            cache = _paged_leaf_update(cache, {"ckv": ckv, "kr": kr},
                                       positions)
            ctx = _paged_mla(cache, q_abs, q_rope, cfg, positions, scale)
        else:                                        # ring decode
            cache = _ring_update(cache, {"ckv": ckv, "kr": kr}, positions)
            ctx = _mla_mqa(q_abs, q_rope, cache["ckv"], cache["kr"],
                           positions, cache["pos"], scale)
        out = einsum("bshr,rhv->bshv", ctx, params["w_uv"])
        return einsum("bshv,hvd->bsd", out, params["wo"])

    # train / prefill: the full (decompressed) form; a ring is written from
    # row 0, as the reference's dynamic_update_slice at offset 0
    if cache is not None:
        for name, rows in (("ckv", ckv), ("kr", kr), ("pos", positions)):
            if is_sharded(cache[name]):
                write_rows(cache[name], rows)
            else:
                cache[name][:, :S] = rows.to(cache[name].dtype)
    k_nope = einsum("bsr,rhk->bshk", ckv, params["w_uk"])
    v = einsum("bsr,rhv->bshv", ckv, params["w_uv"])
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, dr).to(
        k_nope.dtype)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attn_core(q, k, v, positions, positions, scale=scale, causal=True,
                    window=None, cap=spec.logit_softcap, n_kv=H,
                    prefer_blocked=spec.prefer_blocked)
    return einsum("bshv,hvd->bsd", out, params["wo"])


# ---------------------------------------------------------------------------

def attn_init(gen, d_model, spec, cfg, device):
    init = mla_init if spec.kind == "mla" else gqa_init
    return init(gen, d_model, spec, cfg, device)


def attn_apply(params, x, spec, cfg, positions, cache=None,
               encoder_out=None):
    if spec.kind == "mla":
        return mla_apply(params, x, spec, cfg, positions, cache=cache)
    return gqa_apply(params, x, spec, cfg, positions, cache=cache,
                     encoder_out=encoder_out)


def attn_cache_init(batch, capacity, spec, device):
    init = mla_cache_init if spec.kind == "mla" else gqa_cache_init
    return init(batch, capacity, spec, device)
