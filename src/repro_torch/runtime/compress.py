"""Gradient compression for a cross-host all-reduce. Port of
``repro.runtime.compress``.

int8 symmetric quantization with error feedback (residual carried in f32).
The hook is applied to the gradient tree inside train_step
(``grad_transform``); on a multi-host deployment the same transform
brackets the all-reduce so bytes on the wire drop 4x (bf16 -> int8). Error
feedback keeps the update unbiased over time (Seide et al. / Karimireddy et
al.). The scale stays a 0-d device tensor: no host sync.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.blocks import tree_map


def ef_init(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Returns (decompressed grads as seen post-allreduce, new error state)."""
    residuals = []

    def one(g, e):
        corrected = g.float() + e
        q, s = quantize(corrected)
        deq = dequantize(q, s)
        residuals.append(corrected - deq)
        return deq

    out = tree_map(one, grads, error)
    it = iter(residuals)                 # tree_map visits leaves in order
    return out, tree_map(lambda _: next(it), out)
