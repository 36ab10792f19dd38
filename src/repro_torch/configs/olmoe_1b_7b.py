"""olmoe-1b-7b [moe]: 64 experts top-8, qk-norm. [arXiv:2409.02060]"""
from repro_torch.configs.common import (AttentionSpec, BlockSpec, MoeSpec,
                                        ModelConfig, ScanGroup)


def _build(d_model, n_heads, d_ff, vocab, n_layers, n_experts, top_k, name):
    hd = d_model // n_heads
    block = BlockSpec(
        attn=AttentionSpec(n_heads=n_heads, n_kv_heads=n_heads, head_dim=hd,
                           qk_norm=True),
        moe=MoeSpec(n_experts=n_experts, top_k=top_k, d_ff=d_ff))
    return ModelConfig(name=name, d_model=d_model, vocab=vocab,
                       groups=(ScanGroup((block,), n_layers),),
                       tie_embeddings=False)


CONFIG = _build(2048, 16, 1024, 50304, 16, 64, 8, "olmoe-1b-7b")
SMOKE = _build(128, 4, 64, 512, 2, 8, 2, "olmoe-1b-7b-smoke")
