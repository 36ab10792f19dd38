"""Helpers shared by architecture config files."""
from __future__ import annotations

from repro_torch.models.spec import (AttentionSpec, BlockSpec, EncoderSpec,
                                     MlpSpec, MoeSpec, ModelConfig, ScanGroup,
                                     SsmSpec)

__all__ = ["AttentionSpec", "BlockSpec", "EncoderSpec", "MlpSpec", "MoeSpec",
           "ModelConfig", "ScanGroup", "SsmSpec", "dense_lm"]


def dense_lm(name: str, *, n_layers: int, d_model: int, n_heads: int,
             n_kv: int, head_dim: int, d_ff: int, vocab: int,
             rope_theta: float = 10_000.0, rope_pct: float = 1.0,
             qk_norm: bool = False, activation: str = "silu",
             norm: str = "rmsnorm", tie: bool = True,
             parallel_residual: bool = False, use_bias: bool = False,
             kv_quant: bool = False, **kw) -> ModelConfig:
    attn = AttentionSpec(n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim,
                         rope_theta=rope_theta, rope_pct=rope_pct,
                         qk_norm=qk_norm, kv_quant=kv_quant)
    block = BlockSpec(attn=attn, mlp=MlpSpec(d_ff, activation=activation),
                      parallel_residual=parallel_residual)
    return ModelConfig(name=name, d_model=d_model, vocab=vocab,
                       groups=(ScanGroup((block,), n_layers),), norm=norm,
                       tie_embeddings=tie, use_bias=use_bias, **kw)
