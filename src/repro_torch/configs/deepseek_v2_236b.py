"""deepseek-v2-236b [moe]: MLA (kv_lora=512, rope 64), first layer dense
MLP(12288), 59 layers of 2-shared + 160-routed top-6 MoE. [arXiv:2405.04434]"""
from repro_torch.configs.common import (AttentionSpec, BlockSpec, MlpSpec,
                                        MoeSpec, ModelConfig, ScanGroup)


def _build(d_model, n_heads, vocab, moe_layers, n_experts, top_k, d_ff_e,
           d_ff_dense, q_lora, kv_lora, name):
    mla = AttentionSpec(n_heads=n_heads, n_kv_heads=n_heads, head_dim=128,
                        kind="mla", q_lora_rank=q_lora, kv_lora_rank=kv_lora,
                        qk_nope_head_dim=128, qk_rope_head_dim=64,
                        v_head_dim=128, prefer_blocked=True)
    dense = BlockSpec(attn=mla, mlp=MlpSpec(d_ff_dense))
    moe = BlockSpec(attn=mla,
                    moe=MoeSpec(n_experts=n_experts, top_k=top_k, d_ff=d_ff_e,
                                n_shared=2))
    return ModelConfig(name=name, d_model=d_model, vocab=vocab,
                       groups=(ScanGroup((dense,), 1),
                               ScanGroup((moe,), moe_layers)),
                       tie_embeddings=False)


CONFIG = _build(5120, 128, 102400, 59, 160, 6, 1536, 12288, 1536, 512,
                "deepseek-v2-236b")
SMOKE = _build(128, 4, 512, 2, 8, 2, 64, 256, 48, 32, "deepseek-v2-236b-smoke")
