"""internvl2-76b [vlm]: InternViT frontend (STUB) + Llama3-70B-class backbone.
``input_specs`` supplies precomputed patch embeddings. [arXiv:2404.16821]"""
from repro_torch.configs.common import dense_lm

CONFIG = dense_lm("internvl2-76b", n_layers=80, d_model=8192, n_heads=64,
                  n_kv=8, head_dim=128, d_ff=28672, vocab=128256,
                  rope_theta=500_000.0, tie=False, norm_eps=1e-5, kv_quant=True,
                  frontend="vlm_patch", frontend_len=256)
SMOKE = dense_lm("internvl2-76b-smoke", n_layers=2, d_model=128, n_heads=8,
                 n_kv=2, head_dim=16, d_ff=256, vocab=512, tie=False,
                 frontend="vlm_patch", frontend_len=16)
