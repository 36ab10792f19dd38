"""zamba2-7b [hybrid]: 81 Mamba2 layers + ONE weight-shared attention block
applied after every 3rd mamba layer (27 applications). Upstream alternates
TWO shared blocks; we model one (the weight-sharing memory/roofline behavior
is what matters — DESIGN.md §5). [arXiv:2411.15242]"""
from repro_torch.configs.common import (AttentionSpec, BlockSpec, MlpSpec,
                                        ModelConfig, ScanGroup, SsmSpec)


def _build(d_model, n_heads, d_ff, vocab, repeats, ssm_state, name,
           kv_quant=False):
    head_dim = d_model // n_heads
    mamba = BlockSpec(ssm=SsmSpec(d_state=ssm_state, head_dim=64, expand=2))
    shared = BlockSpec(
        attn=AttentionSpec(n_heads=n_heads, n_kv_heads=n_heads,
                           head_dim=head_dim, rope_theta=10_000.0,
                           kv_quant=kv_quant),
        mlp=MlpSpec(d_ff), shared=True)
    return ModelConfig(
        name=name, d_model=d_model, vocab=vocab,
        groups=(ScanGroup((mamba, mamba, mamba, shared), repeats),),
        tie_embeddings=True)


# int8 KV: 27 shared-attn applications x 32 MHA heads make the bf16 cache
# 812 GB at decode_32k; int8 halves cache bytes and read traffic
CONFIG = _build(3584, 32, 14336, 32000, 27, 64, "zamba2-7b", kv_quant=True)
SMOKE = _build(128, 4, 256, 512, 2, 16, "zamba2-7b-smoke")
