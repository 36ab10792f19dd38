"""Pieces the references share."""
from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 on the card, for the block inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) rounded to float8 e4m3 with one scale per slice
    along ``dim`` (the slice's largest magnitude maps to 448), returned in
    float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


def mm(x: torch.Tensor, w: torch.Tensor, n_in: int = 1,
       fp8: bool = False) -> torch.Tensor:
    """x @ w in float32 (rounded through float8 where ``fp8``): the first
    ``n_in`` axes of ``w`` are the input and match the last ``n_in`` of
    ``x``; the rest of ``w`` is the output."""
    k = math.prod(w.shape[:n_in])
    lead = x.shape[:x.ndim - n_in]
    w2 = w.float().reshape(k, math.prod(w.shape[n_in:]))
    x2 = x.float().reshape(*lead, k)
    if fp8:
        w2 = fp8_round(w2, 0)
        x2 = fp8_round(x2, -1)
    return (x2 @ w2).reshape(*lead, *w.shape[n_in:])


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of INTERLEAVED pairs (x[..., 0::2], x[..., 1::2]):
    x (L, ..., d), pos (L,)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.float()[:, None] * inv                        # (L, d/2)
    ang = ang.reshape(ang.shape[0], *([1] * (x.ndim - 2)), ang.shape[-1])
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def stacked(tree: dict, r: int) -> dict:
    """Layer ``r`` of a tree of stacked leaves (a leading layer axis)."""
    return {k: (stacked(v, r) if isinstance(v, dict) else v[r])
            for k, v in tree.items()}
