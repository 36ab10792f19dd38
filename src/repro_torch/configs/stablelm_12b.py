"""stablelm-12b [dense]: parallel attn/MLP residual, partial rotary (25%),
LayerNorm. [hf:stabilityai/stablelm-2-12b]"""
from repro_torch.configs.common import dense_lm

CONFIG = dense_lm("stablelm-12b", n_layers=40, d_model=5120, n_heads=32,
                  n_kv=8, head_dim=160, d_ff=13824, vocab=100352,
                  rope_pct=0.25, norm="layernorm", norm_eps=1e-5,
                  parallel_residual=True, tie=False)
SMOKE = dense_lm("stablelm-12b-smoke", n_layers=2, d_model=128, n_heads=4,
                 n_kv=2, head_dim=32, d_ff=256, vocab=512, rope_pct=0.25,
                 norm="layernorm", parallel_residual=True, tie=False)
