"""whisper-base [audio]: enc-dec backbone; conv frontend STUBBED —
``input_specs`` provides 1500 precomputed frame embeddings. Decoder context
extended to 32k for the decode_32k cell (a backbone exercise; upstream is
448). [arXiv:2212.04356]"""
from repro_torch.configs.common import (AttentionSpec, BlockSpec, EncoderSpec,
                                        MlpSpec, ModelConfig, ScanGroup)


def _build(d_model, n_heads, d_ff, vocab, n_layers, enc_len, max_pos, name):
    hd = d_model // n_heads
    enc_attn = AttentionSpec(n_heads=n_heads, n_kv_heads=n_heads, head_dim=hd,
                             rope_theta=0.0, causal=False)
    dec_attn = AttentionSpec(n_heads=n_heads, n_kv_heads=n_heads, head_dim=hd,
                             rope_theta=0.0, causal=True)
    cross = AttentionSpec(n_heads=n_heads, n_kv_heads=n_heads, head_dim=hd,
                          rope_theta=0.0, causal=False)
    mlp = MlpSpec(d_ff, activation="gelu", gated=False)
    enc_block = BlockSpec(attn=enc_attn, mlp=mlp)
    dec_block = BlockSpec(attn=dec_attn, cross_attn=cross, mlp=mlp)
    return ModelConfig(
        name=name, d_model=d_model, vocab=vocab,
        groups=(ScanGroup((dec_block,), n_layers),),
        encoder=EncoderSpec(groups=(ScanGroup((enc_block,), n_layers),),
                            seq_len=enc_len),
        norm="layernorm", norm_eps=1e-5, use_bias=True,
        learned_pos=True, max_pos=max_pos,
        frontend="audio_frames", frontend_len=enc_len,
        tie_embeddings=True)


CONFIG = _build(512, 8, 2048, 51865, 6, 1500, 32768, "whisper-base")
SMOKE = _build(64, 4, 128, 512, 2, 32, 128, "whisper-base-smoke")
