"""Primitive layers: norms, embeddings, rotary embeddings, init helpers.

Port of ``repro.models.layers``. Functional style on plain tensors:
``*_init(gen, ..., device) -> params`` (nested dicts of tensors, drawn from
an explicit ``torch.Generator``; the draws are not JAX's, only their
distributions match) and ``*_apply(params, x, ...)``. Norms compute in f32
and cast back to the input dtype, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.sharding.spmd import embedding, matmul


def normal_init(gen: Optional[torch.Generator], shape, std: float, dtype,
                device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (std * x).to(dtype)


def fan_in_init(gen, shape, fan_in: int, dtype, device) -> torch.Tensor:
    return normal_init(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype,
                       device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str, use_bias: bool, dtype, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm" and use_bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(params: dict, x: torch.Tensor, kind: str,
               eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the trailing head_dim (qk-norm). scale: (head_dim,)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d: int, dtype, device) -> dict:
    return {"embedding": normal_init(gen, (vocab, d), 0.02, dtype, device)}


def embed_lookup(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return embedding(tokens.long(), params["embedding"])


def embed_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return matmul(x, params["embedding"].T)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, rope_pct: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotating fraction of head_dim."""
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) int32.

    Rotates INTERLEAVED pairs (x[..., 0::2], x[..., 1::2]) of the leading
    ``rope_pct`` of head_dim, as the reference does — not the half-split
    rotation of most PyTorch code."""
    d = x.shape[-1]
    rot = int(d * rope_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = rope_freqs(d, theta, rope_pct, device=x.device)      # (rot/2,)
    ang = positions.float()[..., None] * inv                   # (..., S, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == positions.ndim + 2:                           # head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(x1.shape[:-1] + (rot,))
    yr = yr.to(x.dtype)
    return torch.cat([yr, xp], dim=-1) if rot < d else yr


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)
