"""Channel mixers: (gated) MLP. Port of ``repro.models.mlp``.

The large products stay ``@`` (cuBLAS on the card), as the reference leaves
them to XLA: bf16 operands, f32 accumulation, one rounding to bf16.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import fan_in_init
from repro_torch.models.spec import MlpSpec, ModelConfig
from repro_torch.sharding.partition import constrain
from repro_torch.sharding.spmd import matmul


def _silu(x):
    # op for op as jax.nn.silu lowers (x * (1 / (1 + exp(-x))), each op
    # rounded in x's dtype): bit-equal to the reference in bf16
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _gelu(x):
    # op for op as jax.nn.gelu(approximate=True) lowers: its constants and
    # every intermediate rounded to x's dtype
    k0, k1 = (float(torch.tensor(c, dtype=x.dtype))
              for c in (math.sqrt(2 / math.pi), 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(k0 * (x + k1 * (x * x * x)))))


def _act(name: str):
    return {"silu": _silu, "gelu": _gelu}[name]


def mlp_init(gen, d_model: int, spec: MlpSpec, cfg: ModelConfig,
             device) -> dict:
    dt = torch.bfloat16
    p = {
        "w_up": fan_in_init(gen, (d_model, spec.d_ff), d_model, dt, device),
        "w_down": fan_in_init(gen, (spec.d_ff, d_model), spec.d_ff, dt,
                              device),
    }
    if spec.gated:
        p["w_gate"] = fan_in_init(gen, (d_model, spec.d_ff), d_model, dt,
                                  device)
    if cfg.use_bias:
        p["b_up"] = torch.zeros((spec.d_ff,), dtype=dt, device=device)
        p["b_down"] = torch.zeros((d_model,), dtype=dt, device=device)
    return p


def mlp_apply(params: dict, x: torch.Tensor, spec: MlpSpec) -> torch.Tensor:
    h = matmul(x, params["w_up"])
    if "b_up" in params:
        h = h + params["b_up"]
    if spec.gated:
        g = matmul(x, params["w_gate"])
        h = _act(spec.activation)(g) * h
    else:
        h = _act(spec.activation)(h)
    # Megatron-style: the hidden pinned to ff->model
    h = constrain(h, "batch", "seq", "ff")
    y = matmul(h, params["w_down"])
    if "b_down" in params:
        y = y + params["b_down"]
    return y
