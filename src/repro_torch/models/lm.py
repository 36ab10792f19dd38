"""Full models: decoder-only LM (dense/MoE/SSM/hybrid/VLM) and enc-dec, and
the paged serving path. Port of ``repro.models.lm``.

Public surface (plain functions on tensors; ``gen`` is a torch.Generator):
  lm_init(gen, cfg, device)                          -> params
  encoder_apply(params, frames, cfg)                 -> enc_out
  lm_hidden(params, inputs, cfg, caches=None, ...)   -> (hidden, aux)
  lm_logits(params, hidden, cfg)                     -> logits
  prefill(params, inputs, cfg, enc_out, capacity)    -> (last_logits, caches)
  prefill_batched(params, inputs, cfg, lengths, ...) -> (last_logits, caches)
  decode_step(params, caches, tokens, pos, cfg)      -> (logits, caches)
  cache_init(cfg, batch, capacity, device)           -> caches

``inputs`` holds ``tokens`` (B, S) and optionally ``positions`` (B, S) and,
for the ``vlm_patch`` frontend, ``embeds`` (B, frontend_len, D): patch
embeddings placed before the token embeddings, so positions count them
and decode positions are offset by ``frontend_len``. Enc-dec configs
(whisper) run ``encoder_apply`` on stubbed frame embeddings and pass its
output as ``enc_out`` to every decoder call.

Paged KV (the shared-pool serving path — ``repro_torch.serve``):
  paged_cache_init(cfg, slots, n_pages, page_size, device) -> pool caches
  paged_gather(pool, tables)                         -> dense per-slot caches
  paged_scatter(pool, dense, tables, claim, ...)     -> pool caches
  paged_clear(pool, page_ids)                        -> pool caches
  paged_copy(pool, src, dst)                         -> pool caches
  paged_prefill(params, pool, tables, tokens, ...)   -> (logits, pool)
  paged_decode_step(params, pool, tables, t, p, cfg) -> (logits, pool)
  count_params(cfg)                                  -> int

Caches and the pool are updated IN PLACE; the functions return the same
tree so call sites read like the reference's functional ones. At full width
a copied pool per step would double its memory, and a captured decode step
(``core.compile_cache``) reads and writes the pool at the addresses it was
captured with. Every attention leaf of a pool has one extra SINK page past
its P pages (the tree shows the P pages; ``_paged_view`` flags the leaves
``sink`` for the model's writes): a write that must be dropped — a pad row,
a stalled slot, an unallocated page — lands there instead of being
filtered out on the host, so no pool write needs a host sync.

SSM state (conv windows and the recurrent state) is O(1) per slot and stays
slot-dense in the pool: leaves of shape (repeats, slots, ...). A prefill
writes it at ``slot_ids``; a decode step advances every slot but the
stalled ones (``live`` False). The paged path serves decoder-only
configs (the engine takes no encoder output).

Not ported yet: ``lm_loss``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch

from repro_torch.models.attention import attn_cache_init, with_sink
from repro_torch.models.blocks import (group_apply, group_cache_init,
                                       group_init, tree_map)
from repro_torch.models.layers import (embed_init, embed_logits, embed_lookup,
                                       norm_apply, norm_init, normal_init,
                                       softcap)
from repro_torch.models.spec import ModelConfig, ScanGroup
from repro_torch.models.ssm import ssm_cache_init

SlotIds = Union[Sequence[int], torch.Tensor]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def lm_init(gen: Optional[torch.Generator], cfg: ModelConfig,
            device) -> dict:
    dt = torch.bfloat16
    p: dict = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dt, device),
        "final_norm": norm_init(cfg.d_model, cfg.norm, cfg.use_bias, dt,
                                device),
        "groups": [group_init(gen, cfg, g, device) for g in cfg.groups],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"lm_head": normal_init(
            gen, (cfg.d_model, cfg.vocab), 0.02, dt, device)}
    if cfg.learned_pos:
        p["pos"] = {"pos_embed": normal_init(
            gen, (cfg.max_pos, cfg.d_model), 0.02, dt, device)}
    if cfg.encoder is not None:
        enc = cfg.encoder
        p["encoder"] = {
            "groups": [group_init(gen, cfg, g, device) for g in enc.groups],
            "final_norm": norm_init(cfg.d_model, cfg.norm, cfg.use_bias, dt,
                                    device),
            "pos": {"pos_embed": normal_init(
                gen, (enc.seq_len, cfg.d_model), 0.02, dt, device)},
        }
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def encoder_apply(params: dict, frames: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, D) stubbed frontend embeddings -> enc_out."""
    enc = params["encoder"]
    x = frames + enc["pos"]["pos_embed"][None, :frames.shape[1]]
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=frames.device)[None].expand(frames.shape[:2])
    for gi, g in enumerate(cfg.encoder.groups):
        x, _ = group_apply(enc["groups"][gi], x, g, cfg, pos)
    return norm_apply(enc["final_norm"], x, cfg.norm, cfg.norm_eps)


def _embed_inputs(params, inputs, cfg):
    tokens = inputs["tokens"]
    x = embed_lookup(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if cfg.frontend == "vlm_patch" and "embeds" in inputs:
        x = torch.cat([inputs["embeds"].to(x.dtype), x], dim=1)
    positions = inputs.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None].expand(x.shape[:2])
    if cfg.learned_pos:
        x = x + params["pos"]["pos_embed"][positions.long()]
    return x, positions


def lm_hidden(params: dict, inputs: dict, cfg: ModelConfig,
              caches: Optional[list] = None,
              enc_out: Optional[torch.Tensor] = None):
    """(final hidden states, the MoE load-balance loss summed over layers:
    0.0 without MoE), as the reference's hidden and aux; caches are updated
    in place. Serving ignores the aux."""
    x, positions = _embed_inputs(params, inputs, cfg)
    aux = 0.0
    for gi, g in enumerate(cfg.groups):
        c = caches[gi] if caches is not None else None
        x, a = group_apply(params["groups"][gi], x, g, cfg, positions,
                           caches=c, enc_out=enc_out)
        aux = aux + a
    h = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return h, aux


def lm_logits(params: dict, hidden: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = embed_logits(params["embed"], hidden)
    else:
        logits = hidden @ params["lm_head"]["lm_head"]
    if cfg.final_logit_softcap:
        logits = softcap(logits.float(), cfg.final_logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def cache_init(cfg: ModelConfig, batch: int, capacity: int, device) -> list:
    return [group_cache_init(cfg, g, batch, capacity, device)
            for g in cfg.groups]


def prefill(params: dict, inputs: dict, cfg: ModelConfig,
            enc_out: Optional[torch.Tensor] = None,
            capacity: Optional[int] = None):
    """Full-sequence forward; returns (last-token logits, filled caches).

    ``capacity`` sizes the KV rings (>= prompt + planned decode length;
    with a ``vlm_patch`` frontend the prompt counts its embeds); defaults
    to the prompt length. Windowed layers keep rings of min(capacity,
    window) rows, as the reference's do: one prompt has no pad rows."""
    x, positions = _embed_inputs(params, inputs, cfg)
    B, S = x.shape[:2]
    capacity = max(capacity or S, S)
    caches = []
    for gi, g in enumerate(cfg.groups):
        c = group_cache_init(cfg, g, B, capacity, x.device)
        x, _ = group_apply(params["groups"][gi], x, g, cfg, positions,
                           caches=c, enc_out=enc_out)
        caches.append(c)
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return lm_logits(params, x[:, -1:], cfg), caches


def decode_step(params: dict, caches: list, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig,
                enc_out: Optional[torch.Tensor] = None):
    """tokens: (B,1) int32, pos: (B,1) absolute position. One new token."""
    h, _ = lm_hidden(params, {"tokens": tokens, "positions": pos}, cfg,
                     caches=caches, enc_out=enc_out)
    return lm_logits(params, h, cfg), caches


def _map_attn_subs(caches: list, attn_fn, ssm_fn=None) -> list:
    """Walk a cache tree (list of group trees of block dicts) applying
    ``attn_fn`` to every attention sub-cache and ``ssm_fn`` (identity when
    None) to every SSM sub-cache. Preserves structure."""
    out = []
    for gtree in caches:
        ng = {}
        for bi, btree in gtree.items():
            nb = {}
            for kind, sub in btree.items():
                if kind == "attn":
                    nb[kind] = attn_fn(sub)
                else:
                    nb[kind] = ssm_fn(sub) if ssm_fn is not None else sub
            ng[bi] = nb
        out.append(ng)
    return out


def _zip_attn_subs(pool: list, dense: list, attn_fn, ssm_fn) -> list:
    """Two-tree variant of ``_map_attn_subs`` (pool and dense in lockstep)."""
    out = []
    for gpool, gdense in zip(pool, dense):
        ng = {}
        for bi in gpool:
            nb = {}
            for kind in gpool[bi]:
                fn = attn_fn if kind == "attn" else ssm_fn
                nb[kind] = fn(gpool[bi][kind], gdense[bi][kind])
            ng[bi] = nb
        out.append(ng)
    return out


def _unwindowed(g: ScanGroup) -> ScanGroup:
    """``g`` with every attention spec's window dropped: for sizing caches
    only (windows are enforced by the pos mask, not by ring truncation)."""
    return dataclasses.replace(g, pattern=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(b.attn, window=None))
        if b.attn is not None and b.attn.window is not None else b
        for b in g.pattern))


def prefill_batched(params: dict, inputs: dict, cfg: ModelConfig,
                    lengths: torch.Tensor,
                    enc_out: Optional[torch.Tensor] = None,
                    capacity: Optional[int] = None):
    """Multi-slot prefill of right-padded prompts in ONE forward.

    ``inputs["tokens"]`` is (B, S) with row b's real prompt in columns
    ``[0, lengths[b])`` and arbitrary padding after. Causality means pad
    columns never influence real tokens. Returns (per-row last-REAL-token
    logits (B, 1, V), caches with every pad entry neutralized — ``pos``
    forced to -1 — so a later decode can never attend padding). Every row
    starts from fresh zero SSM state. (MoE layers excepted from the
    causality argument: pad rows take expert queue places, as in the
    reference.)

    Windowed layers get rings of the full ``capacity`` rows too (the mask
    keeps the window): a ring of ``window`` rows would let the pad rows of
    a shorter prompt in a batch padded past the window push that prompt's
    own earliest real rows out before they are read back — a loss the
    reference's ``prefill_batched`` still has.

    Only valid for attention-cached models: SSM/conv state is a recurrence
    over ALL processed tokens, pads included, so callers batching prompts
    for an SSM-bearing config group them by exact length (no pads)."""
    x, positions = _embed_inputs(params, inputs, cfg)
    B, S = x.shape[:2]
    capacity = max(capacity or S, S)
    caches = []
    for gi, g in enumerate(cfg.groups):
        c = group_cache_init(cfg, _unwindowed(g), B, capacity, x.device)
        x, _ = group_apply(params["groups"][gi], x, g, cfg, positions,
                           caches=c, enc_out=enc_out)
        caches.append(c)
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    idx = (lengths.long() - 1).clamp(0, S - 1)
    last = x[torch.arange(B, device=x.device), idx][:, None]      # (B,1,D)
    logits = lm_logits(params, last, cfg)
    lim = lengths.to(torch.int32)[None, :, None]                  # (1,B,1)

    def neutralize(sub):
        p = sub["pos"]
        p.masked_fill_(~((p >= 0) & (p < lim)), -1)
        return sub

    return logits, _map_attn_subs(caches, neutralize)


# ---------------------------------------------------------------------------
# Paged KV: one shared pool, per-slot page tables
# ---------------------------------------------------------------------------
#
# Attention cache leaves carry a PAGE axis of ``n_pages`` fixed-size pages —
# (repeats, n_pages, page_size, ...) — and each slot owns an ordered page
# list (its page table). Slot b's virtual cache row v lives in page
# ``tables[b, v // page_size]`` at offset ``v % page_size``; -1 table entries
# read as empty (pos = -1). ``tables`` is a (slots, pages_per_slot) int32
# tensor argument of every call, so page traffic changes data, never shapes.

def paged_cache_init(cfg: ModelConfig, slots: int, n_pages: int,
                     page_size: int, device) -> list:
    """Pool caches: attention leaves paged over ``n_pages`` x ``page_size``
    (windowed layers use full pages too — windows are enforced by the pos
    mask, not by ring truncation), each with its sink page behind it; SSM
    state stays per-slot dense."""
    caches = []
    for g in cfg.groups:
        per_block = {}
        for i, b in enumerate(_unwindowed(g).pattern):
            c: dict = {}
            if b.attn is not None:
                c["attn"] = attn_cache_init(n_pages + 1, page_size, b.attn,
                                            device)
            if b.ssm is not None:
                c["ssm"] = ssm_cache_init(slots, cfg.d_model, b.ssm, device)
            per_block[str(i)] = c
        tree = tree_map(
            lambda a: a[None].expand((g.repeats,) + a.shape).clone(),
            per_block)
        caches.append({bi: {kind: ({k: v[:, :n_pages] for k, v in
                                    sub.items()} if kind == "attn" else sub)
                            for kind, sub in btree.items()}
                       for bi, btree in tree.items()})
    return caches


def pool_page_size(pool: list) -> Optional[int]:
    """Page size of a paged cache tree (None when the model has no
    attention caches to page — pure-SSM state is slot-dense)."""
    for gtree in pool:
        for btree in gtree.values():
            sub = btree.get("attn")
            if sub:
                return sub["pos"].shape[-1]
    return None


def _rows_at(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """leaf: (R, B, C, ...), idx: (B, W) -> rows (R, B, W, ...)."""
    b = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return leaf[:, b, idx.long()]


def paged_gather(pool: list, tables: torch.Tensor) -> list:
    """Materialize the dense per-slot view of a paged pool (a copy).

    tables: (B, pages_per_slot) int32 page ids, -1 = unallocated. Returns
    caches shaped exactly like ``cache_init(cfg, B, vcap)`` output with
    ``vcap = pages_per_slot * page_size``: ``decode_step`` runs on it
    unchanged. SSM leaves are copied as they are (the dense batch is the
    slot axis)."""
    clamped = tables.clamp(min=0).long()
    B, n_per = tables.shape

    def attn_fn(sub):
        ps = sub["pos"].shape[-1]
        valid = (tables >= 0).repeat_interleave(ps, dim=1)       # (B, vcap)
        out = {}
        for k, leaf in sub.items():
            g = leaf[:, clamped]                       # (R, B, n_per, ps, …)
            g = g.reshape(g.shape[0], B, n_per * ps, *g.shape[4:])
            if k == "pos":
                g = torch.where(valid[None], g, -1)
            out[k] = g
        return out

    return _map_attn_subs(pool, attn_fn,
                          lambda sub: {k: v.clone() for k, v in sub.items()})


def _ssm_store(pool_sub: dict, new_sub: dict, slot_ids: SlotIds) -> dict:
    """Write a batch's SSM leaves into the pool's slot rows, in place.
    Out-of-range slot ids (dummy batch rows) are dropped on the host, so
    the write needs no device sync."""
    leaf = next(iter(pool_sub.values()))
    ids = torch.as_tensor(slot_ids).reshape(-1).long().cpu()
    rows = ((ids >= 0) & (ids < leaf.shape[1])).nonzero().reshape(-1)
    rows, slots = rows.to(leaf.device), ids[rows].to(leaf.device)
    for k, pl in pool_sub.items():
        pl[:, slots] = new_sub[k][:, rows].to(pl.dtype)
    return pool_sub


def paged_scatter(pool: list, dense: list, tables: torch.Tensor,
                  claim: torch.Tensor, *,
                  slot_ids: Optional[SlotIds] = None,
                  live: Optional[torch.Tensor] = None) -> list:
    """Commit dense cache rows holding absolute positions ``claim`` (B, W)
    back into the pool pages mapped by ``tables`` (B, pages_per_slot), in
    place.

    A row is written only when the dense cache actually HOLDS its claimed
    position (``dense pos == claim`` — ring wrap and pad neutralization
    both make this false) and the target page is allocated; every other
    row goes to the leaf's sink page. SSM state is slot-dense, not
    paged: it is written at the ``slot_ids`` (B,) rows of the pool's slot
    axis (host ids; out-of-range ids drop, which is how dummy batch rows
    are discarded), or, when ``slot_ids`` is None (the decode path, where
    the dense batch IS the slot axis), replaces the pool's state gated per
    slot by ``live`` (B,) bool: a stalled slot keeps its OLD state."""

    def attn_fn(pool_sub, dense_sub):
        ps = pool_sub["pos"].shape[-1]
        vcap = tables.shape[1] * ps
        v = torch.where(claim >= 0, claim % vcap, 0)
        page = torch.gather(tables, 1, (v // ps).long())         # (B, W)
        cap_leaf = dense_sub["pos"].shape[2]
        j = torch.where(claim >= 0, claim % cap_leaf, 0)
        held = _rows_at(dense_sub["pos"], j)[0]                   # (B, W)
        ok = (claim >= 0) & (held == claim) & (page >= 0)
        # filtered rows go to the sink page (no host sync)
        sink = pool_sub["pos"].shape[1]
        pg = torch.where(ok, page, sink).long()
        of = torch.where(ok, v % ps, 0).long()
        for k, leaf in pool_sub.items():
            rows = _rows_at(dense_sub[k], j)                      # (R,B,W,…)
            with_sink(leaf, axis=1)[:, pg, of] = rows.to(leaf.dtype)
        return pool_sub

    def ssm_fn(pool_sub, dense_sub):
        if slot_ids is not None:
            return _ssm_store(pool_sub, dense_sub, slot_ids)
        for k, pl in pool_sub.items():
            new = dense_sub[k].to(pl.dtype)
            if live is not None:
                new = torch.where(
                    live.reshape((1, -1) + (1,) * (pl.ndim - 2)), new, pl)
            pl.copy_(new)
        return pool_sub

    return _zip_attn_subs(pool, dense, attn_fn, ssm_fn)


def _page_ids(ids, n_pages: int, device) -> torch.Tensor:
    """Page ids as a tensor, out-of-range ids dropped."""
    t = torch.as_tensor(ids, dtype=torch.long).reshape(-1)
    return t[(t >= 0) & (t < n_pages)].to(device)


def paged_clear(pool: list, page_ids) -> list:
    """Mark the given pages empty (pos = -1), in place, so a later owner
    never sees a previous request's keys. k/v payloads are left in place —
    pos = -1 masks them everywhere."""

    def attn_fn(sub):
        pos = sub["pos"]
        pos[:, _page_ids(page_ids, pos.shape[1], pos.device)] = -1
        return sub

    return _map_attn_subs(pool, attn_fn)


def paged_copy(pool: list, src, dst) -> list:
    """Copy page payloads ``src`` -> ``dst`` on every attention leaf, in
    place (the copy-on-write break: a shared page is duplicated into a
    private page before its first divergent write). src/dst: page ids,
    scalar or (n,); pairs with an out-of-range dst are dropped."""

    def attn_fn(sub):
        n_pages = sub["pos"].shape[1]
        s = torch.as_tensor(src, dtype=torch.long).reshape(-1)
        d = torch.as_tensor(dst, dtype=torch.long).reshape(-1)
        keep = (d >= 0) & (d < n_pages)
        s, d = s[keep], d[keep]
        for leaf in sub.values():
            leaf[:, d.to(leaf.device)] = leaf[:, s.to(leaf.device)]
        return sub

    return _map_attn_subs(pool, attn_fn)


def _paged_view(pool: list, tables: torch.Tensor,
                fresh_ssm: Optional[int] = None,
                live: Optional[torch.Tensor] = None) -> list:
    """Cache tree for the leaf-level paged path: every attention leaf
    carries the pool pages (their sink page behind them: ``sink``) plus
    ``table`` — one (B, npps) tensor that every
    repeat reads (``blocks.group_apply`` does not index it by repeat). SSM
    leaves pass through slot-dense (decode; with ``live``, stalled slots
    keep their state) or are replaced with fresh zero state for a
    ``fresh_ssm``-row prefill batch (stored to slots by the caller)."""
    def ssm_fn(sub):
        if fresh_ssm is not None:
            return {k: v.new_zeros((v.shape[0], fresh_ssm) + v.shape[2:])
                    for k, v in sub.items()}
        return sub if live is None else {**sub, "live": live}

    def attn_fn(sub):
        for v in sub.values():
            with_sink(v, axis=1)            # the pool's leaves have one
        return {**sub, "table": tables, "sink": True}

    return _map_attn_subs(pool, attn_fn, ssm_fn)


def paged_prefill(params: dict, pool: list, tables: torch.Tensor,
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  cfg: ModelConfig, *,
                  slot_ids: Optional[SlotIds] = None,
                  starts: Optional[torch.Tensor] = None,
                  kernel: str = "gather"):
    """Batched multi-slot prefill straight into the page pool (in place).

    tokens: (B, S) right-padded prompts; lengths: (B,) real lengths;
    tables: (B, pages_per_slot) page tables of the destination slots;
    slot_ids: (B,) destination slots for the SSM state, a host sequence or
    CPU tensor (out-of-range = dummy row, dropped; None = slots 0..B-1).
    Returns (last-real-token logits (B,1,V), pool).

    ``kernel="gather"`` with no ``starts`` keeps the dense path
    (``prefill_batched`` + ``paged_scatter``). ``kernel="paged"`` — or any
    call with ``starts`` — runs the leaf-level paged path: fresh rows are
    written page by page inside each layer and queries attend the pool
    THROUGH the page table (with the kernel for "paged", a per-leaf dense
    gather for "gather"), so row b may continue from absolute position
    ``starts[b]`` with its earlier pages (a shared prefix) already
    resident. tokens then holds only the suffix and lengths its length."""
    if slot_ids is None:
        slot_ids = list(range(tokens.shape[0]))
    if kernel == "gather" and starts is None:
        ps = pool_page_size(pool)
        vcap = tables.shape[1] * ps if ps else None
        logits, dense = prefill_batched(params, {"tokens": tokens}, cfg,
                                        lengths, capacity=vcap)
        claim = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)[None].expand(tokens.shape)
        return logits, paged_scatter(pool, dense, tables, claim,
                                     slot_ids=slot_ids)

    B, S = tokens.shape
    dev = tokens.device
    st = (torch.zeros((B,), dtype=torch.int32, device=dev) if starts is None
          else starts.to(torch.int32))
    cols = torch.arange(S, dtype=torch.int32, device=dev)[None]
    positions = torch.where(cols < lengths.to(torch.int32)[:, None],
                            st[:, None] + cols, -1)     # pad rows never write
    view = _paged_view(pool, tables, fresh_ssm=B)
    h, _ = lm_hidden(params, {"tokens": tokens, "positions": positions},
                     cfg.replace(paged_kernel=kernel), caches=view)
    idx = (lengths.long() - 1).clamp(0, S - 1)
    last = h[torch.arange(B, device=dev), idx][:, None]
    _zip_attn_subs(pool, view, lambda p, v: p,
                   lambda p, v: _ssm_store(p, v, slot_ids))
    return lm_logits(params, last, cfg), pool


def paged_decode_step(params: dict, pool: list, tables: torch.Tensor,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      cfg: ModelConfig, *,
                      live: Optional[torch.Tensor] = None,
                      kernel: str = "gather"):
    """One batched decode step over the paged pool (in place).
    tokens/pos: (B, 1).

    kernel="gather": materialize each slot's dense view (``paged_gather``),
    run the ordinary ``decode_step``, scatter the one new row per slot back
    to its page — the dense baseline. kernel="paged": no dense view is ever
    built — each attention leaf writes its one fresh row into the pool and
    the kernel walks the page table (``kernels.paged_attention``).

    ``live`` (B,) bool marks slots whose state may advance; a stalled
    slot's attention write already drops on its missing (or blanked, -1)
    page, and ``live=False`` keeps its SSM state too, so the step can be
    retried identically once a page frees. None means every slot."""
    if kernel == "gather":
        dense = paged_gather(pool, tables)
        logits, dense = decode_step(params, dense, tokens, pos, cfg)
        return logits, paged_scatter(pool, dense, tables, pos, live=live)
    h, _ = lm_hidden(params, {"tokens": tokens, "positions": pos},
                     cfg.replace(paged_kernel=kernel),
                     caches=_paged_view(pool, tables, live=live))
    return lm_logits(params, h, cfg), pool


# ---------------------------------------------------------------------------
# Parameter counting (init on the meta device — no allocation, no formulas)
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig) -> int:
    total = 0

    def add(a):
        nonlocal total
        total += a.numel()

    tree_map(add, lm_init(None, cfg, "meta"))
    return total
