"""deepseek_v2: multi-head latent attention (MLA), a dense first layer,
then mixture-of-experts layers with shared experts."""
from __future__ import annotations

import dataclasses

REFERENCE = "deepseek_v2"

# The rotary and routing the program runs: plain rotary at rope_theta with
# the softmax scale 1/sqrt(dn + dr), and a softmax over every routed expert
# with plain top-k and its gates renormalised. A file that states another
# (the published model's YaRN, group-limited routing, a routed scaling)
# names a model the program cannot run.
RUNS = {"rope_scaling": None, "n_group": 1, "topk_group": 1,
        "topk_method": "greedy", "routed_scaling_factor": 1,
        "norm_topk_prob": True, "scoring_func": "softmax"}


def build(cfg: dict):
    """The program's ``ModelConfig`` for ``cfg``: its registry entry with
    the MoE group cut to the file's depth, every width held against the
    file, and a rotary or routing the program does not run refused."""
    cannot = {k: cfg[k] for k, v in RUNS.items() if k in cfg and cfg[k] != v}
    if cannot:
        raise ValueError(f"{cfg['_name']}: the program cannot run {cannot}")
    from repro_torch.configs import get_config
    base = get_config(cfg.get("arch", "deepseek-v2-236b"), smoke=cfg.get("smoke", False))
    dense, moe = base.groups
    a = dense.pattern[0].attn
    m = moe.pattern[0].moe
    want = {
        "hidden_size": (base.d_model, cfg["hidden_size"]),
        "vocab_size": (base.vocab, cfg["vocab_size"]),
        "num_attention_heads": (a.n_heads, cfg["num_attention_heads"]),
        "q_lora_rank": (a.q_lora_rank, cfg["q_lora_rank"]),
        "kv_lora_rank": (a.kv_lora_rank, cfg["kv_lora_rank"]),
        "qk_nope_head_dim": (a.qk_nope_head_dim, cfg["qk_nope_head_dim"]),
        "qk_rope_head_dim": (a.qk_rope_head_dim, cfg["qk_rope_head_dim"]),
        "v_head_dim": (a.v_head_dim, cfg["v_head_dim"]),
        "rope_theta": (a.rope_theta, cfg["rope_theta"]),
        "intermediate_size": (dense.pattern[0].mlp.d_ff,
                              cfg["intermediate_size"]),
        "moe_intermediate_size": (m.d_ff, cfg["moe_intermediate_size"]),
        "n_routed_experts": (m.n_experts, cfg["n_routed_experts"]),
        "num_experts_per_tok": (m.top_k, cfg["num_experts_per_tok"]),
        "n_shared_experts": (m.n_shared, cfg["n_shared_experts"]),
        "first_k_dense_replace": (dense.n_layers,
                                  cfg["first_k_dense_replace"]),
        "tie_word_embeddings": (base.tie_embeddings,
                                cfg["tie_word_embeddings"]),
        "rms_norm_eps": (base.norm_eps, cfg["rms_norm_eps"]),
    }
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad:
        raise ValueError(f"{cfg['_name']}: the program's config differs "
                         f"(program, file): {bad}")
    n_moe = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    return base.replace(groups=(dense, dataclasses.replace(
        moe, repeats=n_moe)))


class Counts:
    """FLOPs and bytes the inputs need. A multiply-add counts 2 FLOPs.
    Attention is counted in its decompressed form: each token's keys and
    values are made once from its latent row, and a (query, key) pair costs
    2·H·(dn + dr) for the score and 2·H·dv for the value."""

    def __init__(self, cfg: dict):
        self.D = D = cfg["hidden_size"]
        self.V = cfg["vocab_size"]
        self.H = H = cfg["num_attention_heads"]
        self.ql = ql = cfg["q_lora_rank"]
        self.kl = kl = cfg["kv_lora_rank"]
        self.dn = dn = cfg["qk_nope_head_dim"]
        self.dr = dr = cfg["qk_rope_head_dim"]
        self.dv = dv = cfg["v_head_dim"]
        self.E = E = cfg["n_routed_experts"]
        self.k = k = cfg["num_experts_per_tok"]
        F = cfg["moe_intermediate_size"]
        Fs = F * cfg["n_shared_experts"]
        Fd = cfg["intermediate_size"]
        self.n_dense = cfg["first_k_dense_replace"]
        self.n_moe = cfg["num_hidden_layers"] - self.n_dense
        self.attn_params = (D * ql + ql * H * (dn + dr) + D * (kl + dr)
                            + kl * H * (dn + dv) + H * dv * D)
        self.dense_params = 3 * D * Fd
        self.routed_params = E * 3 * D * F
        self.moe_active_params = D * E + k * 3 * D * F + 3 * D * Fs
        self.moe_params = D * E + self.routed_params + 3 * D * Fs
        self.head_params = self.V * D
        self.pair_flops = 2 * H * (dn + dr) + 2 * H * dv

    def token_flops(self) -> int:
        """One token through the body (no output head, no attention
        pairs)."""
        layers = self.n_dense + self.n_moe
        return 2 * (layers * self.attn_params
                    + self.n_dense * self.dense_params
                    + self.n_moe * self.moe_active_params)

    def layers(self) -> int:
        return self.n_dense + self.n_moe

    def prefill_flops(self, lengths) -> int:
        """Real prompt tokens through the body, their causal pairs in every
        layer, and one row of logits a prompt."""
        return sum(n * self.token_flops()
                   + self.layers() * self.pair_flops * n * (n + 1) // 2
                   + 2 * self.head_params for n in lengths)

    def decode_flops(self, keys) -> int:
        """One token a live slot over its ``keys`` live rows, with its row
        of logits."""
        return sum(self.token_flops() + self.layers() * self.pair_flops * L
                   + 2 * self.head_params for L in keys)

    def params(self) -> int:
        D = self.D
        norms = (self.n_dense + self.n_moe) * (2 * D + self.ql + self.kl)
        return ((self.n_dense + self.n_moe) * self.attn_params
                + self.n_dense * self.dense_params
                + self.n_moe * self.moe_params
                + 2 * self.head_params + norms + D)

    # -- kernels -------------------------------------------------------------
    def ssd_launch(self, lengths):
        return None

    def paged_attention_launch(self, q_rows: int, keys: int, pairs: int):
        """(flops, bytes) one paged MLA launch needs in its absorbed form:
        ``keys`` live [ckv | kr] rows read once (k and v are one tensor)
        with their positions, ``q_rows`` rows of q (kl), q2 (dr) and the
        output (kl) in bf16; 2·H·(kl + dr + kl) FLOPs a (query, key)
        pair."""
        H, kl, dr = self.H, self.kl, self.dr
        flops = pairs * 2 * H * (kl + dr + kl)
        bytes_ = keys * ((kl + dr) * 2 + 4) + q_rows * H * (kl + dr + kl) * 2
        return flops, bytes_
