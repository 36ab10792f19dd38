"""gemma2-27b [dense]: 1:1 local(4096):global alternation, attn softcap 50,
final logit softcap 30, GeGLU, sandwich norms. [arXiv:2408.00118]"""
from repro_torch.configs.common import (AttentionSpec, BlockSpec, MlpSpec,
                                        ModelConfig, ScanGroup)


def _build(d_model, n_heads, n_kv, head_dim, d_ff, vocab, repeats, window, name):
    def attn(local):
        return AttentionSpec(n_heads=n_heads, n_kv_heads=n_kv,
                             head_dim=head_dim, rope_theta=10_000.0,
                             logit_softcap=50.0,
                             window=window if local else None)

    def block(local):
        return BlockSpec(attn=attn(local),
                         mlp=MlpSpec(d_ff, activation="gelu"),
                         post_norms=True)

    return ModelConfig(name=name, d_model=d_model, vocab=vocab,
                       groups=(ScanGroup((block(True), block(False)), repeats),),
                       embed_scale=True, tie_embeddings=True,
                       final_logit_softcap=30.0)


CONFIG = _build(4608, 32, 16, 128, 36864, 256000, 23, 4096, "gemma2-27b")
SMOKE = _build(128, 4, 2, 32, 256, 512, 1, 64, "gemma2-27b-smoke")
