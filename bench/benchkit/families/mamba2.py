"""mamba2: an attention-free stack of Mamba2 (SSD) mixers."""
from __future__ import annotations

import dataclasses

REFERENCE = "mamba2"


def build(cfg: dict):
    """The program's ``ModelConfig`` for ``cfg``: its registry entry, at
    the file's depth, vocabulary rows, norm epsilon and chunk, every width
    held against the file."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch"] if "arch" in cfg else "mamba2-1.3b",
                      smoke=cfg.get("smoke", False))
    group = base.groups[0]
    ssm = group.pattern[0].ssm
    s = cfg["ssm_cfg"]
    if cfg.get("smoke"):
        # a test configuration sets its own state size: at the registry's
        # smoke width the scan's share of the logits is too small to test
        ssm = dataclasses.replace(ssm, d_state=s["d_state"])
    want = {"d_model": (base.d_model, cfg["d_model"]),
            "d_state": (ssm.d_state, s["d_state"]),
            "d_conv": (ssm.d_conv, s["d_conv"]),
            "expand": (ssm.expand, s["expand"]),
            "headdim": (ssm.head_dim, s["headdim"]),
            "ngroups": (ssm.n_groups, s["ngroups"]),
            "tie_embeddings": (base.tie_embeddings, cfg["tie_embeddings"])}
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad:
        raise ValueError(f"{cfg['_name']}: the program's config differs "
                         f"(program, file): {bad}")
    block = dataclasses.replace(group.pattern[0], ssm=dataclasses.replace(
        ssm, chunk=s["chunk_size"]))
    return base.replace(
        vocab=vocab_rows(cfg), norm_eps=cfg["norm_epsilon"],
        groups=(dataclasses.replace(group, pattern=(block,),
                                    repeats=cfg["n_layer"]),))


def vocab_rows(cfg: dict) -> int:
    """The embedding's rows: ``vocab_size`` rounded up to
    ``pad_vocab_size_multiple``, as mamba_ssm lays it out."""
    m = cfg.get("pad_vocab_size_multiple", 1)
    return -(-cfg["vocab_size"] // m) * m


class Counts:
    """FLOPs and bytes the inputs need. A multiply-add counts 2 FLOPs."""

    def __init__(self, cfg: dict):
        s = cfg["ssm_cfg"]
        self.D = cfg["d_model"]
        self.L = cfg["n_layer"]
        self.V = vocab_rows(cfg)
        self.N = s["d_state"]
        self.P = s["headdim"]
        self.K = s["d_conv"]
        self.Di = s["expand"] * self.D
        self.H = self.Di // self.P
        D, Di, N, H, K = self.D, self.Di, self.N, self.H, self.K
        # per layer: x, z, B, C, dt projections; the out projection; the
        # three depthwise convs
        self.layer_params = D * (2 * Di + 2 * N + H) + Di * D \
            + K * (Di + 2 * N)
        self.head_params = self.V * D

    # -- model FLOPs ---------------------------------------------------------
    def scan_flops_per_token(self) -> int:
        """The recurrence a token needs in one layer: h * decay (PN),
        h += dt x (x) B (2PN), y = C . h (2PN), a head each."""
        return 5 * self.H * self.P * self.N

    def token_flops(self) -> int:
        """One token through the body (no output head)."""
        return self.L * (2 * self.layer_params + self.scan_flops_per_token())

    def prefill_flops(self, lengths) -> int:
        """Real prompt tokens through the body, and one row of logits a
        prompt."""
        return sum(n * self.token_flops() + 2 * self.head_params
                   for n in lengths)

    def decode_flops(self, keys) -> int:
        """One token a live slot, with its row of logits (``keys``, the
        slots' context lengths, cost nothing more: the state is O(1))."""
        return len(keys) * (self.token_flops() + 2 * self.head_params)

    def params(self) -> int:
        """Every parameter: per layer the projections and convs, the conv
        biases, dt_bias / A_log / D, the gated norm and the block's norm;
        the tied embedding once; the final norm."""
        Di, N, H, D = self.Di, self.N, self.H, self.D
        per_layer = self.layer_params + (Di + 2 * N) + 3 * H + Di + D
        return self.L * per_layer + self.head_params + D

    # -- kernels -------------------------------------------------------------
    def ssd_launch(self, lengths):
        """(flops, bytes) one SSD launch needs over real rows of
        ``lengths``: x (bf16), dt (f32), B and C (bf16) read once, y (f32)
        and the final state (f32) written once, A read once."""
        H, P, N = self.H, self.P, self.N
        flops = sum(lengths) * self.scan_flops_per_token()
        rows = sum(lengths)
        bytes_ = (rows * (H * P * 2 + H * 4 + 2 * N * 2 + H * P * 4)
                  + len(lengths) * H * P * N * 4 + H * 4)
        return flops, bytes_

    def paged_attention_launch(self, q_rows, keys, pairs):
        return None

    def layers(self) -> int:
        return self.L
