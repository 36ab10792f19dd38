"""qwen3-14b [dense]: GQA kv=8, per-head qk-norm. [hf:Qwen/Qwen3-14B]"""
from repro_torch.configs.common import dense_lm

CONFIG = dense_lm("qwen3-14b", n_layers=40, d_model=5120, n_heads=40,
                  n_kv=8, head_dim=128, d_ff=17408, vocab=151936,
                  rope_theta=1_000_000.0, qk_norm=True, tie=False)
SMOKE = dense_lm("qwen3-14b-smoke", n_layers=2, d_model=128, n_heads=10,
                 n_kv=2, head_dim=16, d_ff=256, vocab=512, qk_norm=True,
                 tie=False)
