"""DeepSeek-V2 (arXiv:2405.04434) in float32, as the configuration file
states it.

Attention is multi-head latent attention in its decompressed form: q from
a normed low-rank projection (q_lora), keys and values from a normed latent
row (kv_lora) per token, a 64-wide rotary part of the key shared by the
heads, softmax scale 1/sqrt(dn + dr). The first layer's channel mixer is a
dense SwiGLU; every later layer's is a mixture of experts: a float32 router
softmax over the routed experts, the top-k kept with their gates
renormalised, plus the shared experts on every token.

Departures from the published model that the file states and this mirrors:
plain interleaved rotary at theta 10000 with no yarn scaling, no
group-limited routing and no routed scaling factor. One it does not mirror:
the program's capacity drop (GShard: a token's choice past its expert's
capacity in the call's group is dropped). The published model drops no
token, and neither does this.
"""
from __future__ import annotations

from typing import List

import torch

from benchkit.reference.common import exact_f32, mm, rms, rope, silu, stacked


def attention(p: dict, x: torch.Tensor, cfg: dict, fp8: bool):
    L = x.shape[0]
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    kl, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    pos = torch.arange(L, device=x.device)
    cq = rms(mm(x, p["w_dq"], fp8=fp8), p["q_norm"], eps)
    q = mm(cq, p["w_uq"], fp8=fp8)                             # (L,H,dn+dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, cfg["rope_theta"])],
                  -1)
    dkv = mm(x, p["w_dkv"], fp8=fp8)
    ckv = rms(dkv[:, :kl], p["kv_norm"], eps)
    kr = rope(dkv[:, kl:], pos, cfg["rope_theta"])             # (L,dr)
    k = torch.cat([mm(ckv, p["w_uk"], fp8=fp8),
                   kr[:, None, :].expand(L, H, dr)], -1)
    v = mm(ckv, p["w_uv"], fp8=fp8)                            # (L,H,dv)
    s = torch.einsum("qhd,khd->hqk", q, k) / (dn + dr) ** 0.5
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("hqk,khd->qhd", a, v)
    return mm(o, p["wo"], n_in=2, fp8=fp8)


def swiglu(x, w_gate, w_up, w_down, fp8):
    return mm(silu(mm(x, w_gate, fp8=fp8)) * mm(x, w_up, fp8=fp8), w_down,
              fp8=fp8)


def moe(p: dict, x: torch.Tensor, cfg: dict, fp8: bool):
    """Every token's top-k routed experts (no capacity) and the shared
    experts."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(x, p["router"], fp8=fp8), -1)
    gate, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, sel = gate[:, :k], sel[:, :k]
    gate = gate / gate.sum(-1, keepdim=True)
    y = swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"], fp8)
    for e in torch.unique(sel).tolist():
        t, j = torch.nonzero(sel == e, as_tuple=True)
        out = swiglu(x[t], p["we_gate"][e], p["we_up"][e], p["we_down"][e],
                     fp8)
        y.index_add_(0, t, out * gate[t, j, None])
    return y


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: torch.Tensor,
           rows: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """The logits (len(rows), V) at positions ``rows`` of one sequence
    ``tokens`` (L,), in float32."""
    return batch_logits(params, cfg, [tokens], [rows], fp8)[0]


@torch.no_grad()
def batch_logits(params: dict, cfg: dict, seqs: List[torch.Tensor],
                 rows: List[torch.Tensor], fp8: bool = False):
    """``logits`` of several sequences, layer by layer: attention a
    sequence at a time, the channel mixers over all their tokens at once
    (each token's routing is its own), so each expert's weights are read
    once."""
    eps = cfg["rms_norm_eps"]
    lens = [len(s) for s in seqs]
    with exact_f32():
        x = params["embed"]["embedding"][torch.cat(seqs).long()].float()
        layers = [(gi, r) for gi, g in enumerate(params["groups"])
                  for r in range(next(iter(
                      g["stacked"]["0"]["norm_attn"].values())).shape[0])]
        for gi, r in layers:
            p = stacked(params["groups"][gi]["stacked"]["0"], r)
            h = rms(x, p["norm_attn"]["scale"], eps)
            x = x + torch.cat([attention(p["attn"], hs, cfg, fp8)
                               for hs in torch.split(h, lens)])
            if "mlp" in p:
                h = rms(x, p["norm_mlp"]["scale"], eps)
                m = p["mlp"]
                x = x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"], fp8)
            else:
                h = rms(x, p["norm_moe"]["scale"], eps)
                x = x + moe(p["moe"], h, cfg, fp8)
        starts = torch.tensor([0] + lens[:-1]).cumsum(0).tolist()
        out = []
        for s0, rw in zip(starts, rows):
            h = rms(x[s0 + rw], params["final_norm"]["scale"], eps)
            out.append(mm(h, params["lm_head"]["lm_head"], fp8=fp8))
        return out
