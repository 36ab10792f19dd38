"""Mixture-of-Experts with dense one-hot dispatch. Port of
``repro.models.moe``.

Tokens are routed through a dispatch tensor built from one-hot products
(Shazeer-style), in groups of ``min(group_size, T)`` tokens: top-k experts
per token with renormalized gates, each (token, choice) ranked in its
expert's queue token-major, and a choice past the expert's ``capacity``
dropped (Switch/GShard). The expert products are plain ``einsum``s, as the
reference's are; the router product runs in float32. On the CPU a bf16
product is summed in float32 and rounded once (``_einsum``), as XLA's CPU
dot does: torch's own CPU bf16 GEMM sums in an order that depends on the
host's ISA (AVX512-BF16 or not), so its roundings differ between machines.

Two details the reference gets from JAX and the port must state:
  * ``jax.lax.top_k`` puts the lower index first on ties; ``torch.topk``
    promises no order, so ``_top_k`` takes a stable descending sort;
  * ``jax.nn.one_hot(kept, C)`` gives a zero row for the dropped index C;
    ``F.one_hot`` raises there, so C + 1 classes are built and the last
    dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import fan_in_init
from repro_torch.models.mlp import _act
from repro_torch.models.spec import ModelConfig, MoeSpec
from repro_torch.sharding.partition import constrain
from repro_torch.sharding.spmd import einsum, reshape


def _einsum(sub: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; on the CPU, low-precision operands are summed in
    float32 and the result rounded once to their dtype. On the card the
    product stays in the operands' dtype (float32 accumulation there)."""
    dt = ops[0].dtype
    if ops[0].device.type != "cpu" or dt == torch.float32:
        return einsum(sub, *ops)
    return einsum(sub, *(o.float() for o in ops)).to(dt)


def moe_init(gen, d_model: int, spec: MoeSpec, cfg: ModelConfig,
             device) -> dict:
    E, Fd = spec.n_experts, spec.d_ff
    dt = torch.bfloat16
    p = {
        "router": fan_in_init(gen, (d_model, E), d_model, torch.float32,
                              device),
        "we_gate": fan_in_init(gen, (E, d_model, Fd), d_model, dt, device),
        "we_up": fan_in_init(gen, (E, d_model, Fd), d_model, dt, device),
        "we_down": fan_in_init(gen, (E, Fd, d_model), Fd, dt, device),
    }
    if spec.n_shared:
        Fs = spec.d_ff * spec.n_shared
        p["ws_gate"] = fan_in_init(gen, (d_model, Fs), d_model, dt, device)
        p["ws_up"] = fan_in_init(gen, (d_model, Fs), d_model, dt, device)
        p["ws_down"] = fan_in_init(gen, (Fs, d_model), Fs, dt, device)
    return p


def capacity(spec: MoeSpec, group_tokens: int) -> int:
    c = int(group_tokens * spec.top_k / spec.n_experts * spec.capacity_factor)
    return max(4, -(-c // 4) * 4)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, the lower index first on ties
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: dict, xg: torch.Tensor, spec: MoeSpec):
    """The router's decisions for (G, gs, D) token groups: probs (G,gs,E),
    gates (G,gs,k), the chosen experts (G,gs,k), each choice's kept queue
    slot (G,gs,k; C = dropped) and the f32 one-hot of the choices
    (G,gs,k,E)."""
    E, k = spec.n_experts, spec.top_k
    C = capacity(spec, xg.shape[1])
    logits = einsum("gtd,de->gte", xg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_w, sel = _top_k(probs, k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)
    # rank of each (token, choice) in its expert's queue, token-major
    onehot = F.one_hot(sel, E).float()                           # (G,gs,k,E)
    G, gs = xg.shape[:2]
    flat = onehot.reshape(G, gs * k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, gs, k, E)
    kept = torch.where((pos < C) & (onehot > 0), pos,
                       float(C)).to(torch.int32).amin(-1)        # (G,gs,k)
    return probs, gate_w, sel, kept, onehot


def dispatch_tensors(onehot: torch.Tensor, gate_w: torch.Tensor,
                     kept: torch.Tensor, C: int, dtype):
    """dispatch and combine (G,gs,E,C) in ``dtype``, contracted over the
    choice axis (the 5-d one-hot product is never built)."""
    slot_oh = F.one_hot(kept.long(), C + 1)[..., :C].to(dtype)  # (G,gs,k,C)
    sel_oh = onehot.to(dtype)
    dispatch = _einsum("gtke,gtkc->gtec", sel_oh, slot_oh)
    combine = _einsum("gtke,gtkc->gtec",
                      sel_oh * gate_w[..., None].to(dtype), slot_oh)
    return dispatch, combine


def moe_apply(params: dict, x: torch.Tensor, spec: MoeSpec):
    """x: (B,S,D) -> (y, aux_loss). Dense one-hot dispatch, capacity drop.
    Pad rows route like any token and take queue places, as in the
    reference."""
    B, S, D = x.shape
    T = B * S
    gs = min(spec.group_size, T)
    if T % gs:
        raise ValueError(f"token count {T} not divisible by group {gs}")
    G = T // gs
    E = spec.n_experts
    C = capacity(spec, gs)

    xg = reshape(x, (G, gs, D))
    probs, gate_w, _, kept, onehot = route(params, xg, spec)
    dispatch, combine = dispatch_tensors(onehot, gate_w, kept, C, xg.dtype)

    xe = _einsum("gtec,gtd->gecd", dispatch, xg)                 # (G,E,C,D)
    xe = constrain(xe, "moe_group", "experts", None, "act_d")
    h = _einsum("gecd,edf->gecf", xe, params["we_up"])
    g = _einsum("gecd,edf->gecf", xe, params["we_gate"])
    h = _act(spec.activation)(g) * h
    h = constrain(h, "moe_group", "experts", None, "ff")
    ye = _einsum("gecf,efd->gecd", h, params["we_down"])
    ye = constrain(ye, "moe_group", "experts", None, "act_d")
    y = _einsum("gtec,gecd->gtd", combine.to(ye.dtype), ye)

    if spec.n_shared:
        hs = _einsum("gtd,df->gtf", xg, params["ws_up"])
        gsh = _einsum("gtd,df->gtf", xg, params["ws_gate"])
        hsh = constrain(_act(spec.activation)(gsh) * hs,
                        "moe_group", "seq", "ff")
        y = y + _einsum("gtf,fd->gtd", hsh, params["ws_down"])

    # load-balance auxiliary loss (Switch-style)
    frac_tokens = onehot.sum(2).mean(1)                          # (G,E)
    frac_probs = probs.mean(1)                                   # (G,E)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return reshape(y, (B, S, D)), spec.router_aux_weight * aux
