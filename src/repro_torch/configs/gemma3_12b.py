"""gemma3-12b [dense]: 5:1 local(1024):global attention, qk-norm, GeGLU,
sandwich norms, 256k vocab. [hf:google/gemma-3-*]"""
from repro_torch.configs.common import (AttentionSpec, BlockSpec, MlpSpec,
                                        ModelConfig, ScanGroup)


def _build(d_model, n_heads, n_kv, head_dim, d_ff, vocab, repeats, window, name):
    def attn(local):
        return AttentionSpec(
            n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim,
            rope_theta=10_000.0 if local else 1_000_000.0,
            qk_norm=True, window=window if local else None)

    def block(local):
        return BlockSpec(attn=attn(local),
                         mlp=MlpSpec(d_ff, activation="gelu"),
                         post_norms=True)

    pattern = tuple([block(True)] * 5 + [block(False)])
    return ModelConfig(name=name, d_model=d_model, vocab=vocab,
                       groups=(ScanGroup(pattern, repeats),),
                       embed_scale=True, tie_embeddings=True)


CONFIG = _build(3840, 16, 8, 256, 15360, 262144, 8, 1024, "gemma3-12b")
SMOKE = _build(128, 4, 2, 32, 256, 512, 1, 64, "gemma3-12b-smoke")
