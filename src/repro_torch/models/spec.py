"""Architecture specification system (port of ``repro.models.spec``).

Every architecture (dense / MoE / SSM / hybrid / enc-dec / VLM) is described
by the same small set of frozen dataclasses; the config files under
``repro_torch.configs`` are pure data built from them.

A model is a sequence of *scan groups*: a repeated pattern of blocks whose
parameters are stacked over repeats. The port keeps that stacked layout (so
converted reference params map 1:1) and walks the repeats in a Python loop.
Blocks marked ``shared=True`` keep ONE set of weights reused across every
repeat (Zamba2's shared attention block).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    kind: str = "gqa"                 # "gqa" | "mla"
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0             # fraction of head_dim that rotates
    qk_norm: bool = False             # per-head RMSNorm on q and k
    logit_softcap: Optional[float] = None
    window: Optional[int] = None      # sliding-window size; None = global
    causal: bool = True               # False for encoder self-attention
    # MLA (DeepSeek-V2) parameters -- used when kind == "mla"
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # big-head archs (MLA's 128 heads) materialize multi-GB flat logits even
    # at 4k — force the online-softmax path (measured: -9s mem, -18s coll on
    # deepseek train_4k vs flat)
    prefer_blocked: bool = False
    # int8 KV cache (per-token-per-head symmetric scales): halves cache
    # bytes and decode read traffic; opt-in per architecture
    kv_quant: bool = False

    @property
    def q_dim(self) -> int:
        if self.kind == "mla":
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim


@dataclass(frozen=True)
class MlpSpec:
    d_ff: int
    activation: str = "silu"          # "silu" | "gelu"
    gated: bool = True                # SwiGLU/GeGLU vs plain 2-matrix MLP


@dataclass(frozen=True)
class MoeSpec:
    n_experts: int
    top_k: int
    d_ff: int                         # per-expert hidden width
    n_shared: int = 0                 # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    group_size: int = 4096            # tokens per dispatch group
    router_aux_weight: float = 0.01
    activation: str = "silu"


@dataclass(frozen=True)
class SsmSpec:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class BlockSpec:
    """One residual block: at most one mixer (attn | ssm) + one channel mixer."""
    attn: Optional[AttentionSpec] = None
    mlp: Optional[MlpSpec] = None
    moe: Optional[MoeSpec] = None
    ssm: Optional[SsmSpec] = None
    cross_attn: Optional[AttentionSpec] = None  # enc-dec decoder blocks
    shared: bool = False              # weights shared across scan repeats
    parallel_residual: bool = False   # attn and mlp read the same norm(x)
    post_norms: bool = False          # gemma sandwich norms

    def mixers(self) -> Tuple[str, ...]:
        out = []
        if self.attn is not None:
            out.append("attn")
        if self.ssm is not None:
            out.append("ssm")
        if self.cross_attn is not None:
            out.append("cross")
        if self.mlp is not None:
            out.append("mlp")
        if self.moe is not None:
            out.append("moe")
        return tuple(out)


@dataclass(frozen=True)
class ScanGroup:
    pattern: Tuple[BlockSpec, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class EncoderSpec:
    groups: Tuple[ScanGroup, ...]
    seq_len: int                      # fixed encoder length (e.g. 1500 frames)
    learned_pos: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    groups: Tuple[ScanGroup, ...]
    norm: str = "rmsnorm"             # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    use_bias: bool = False
    tie_embeddings: bool = True
    final_logit_softcap: Optional[float] = None
    embed_scale: bool = False         # multiply embeddings by sqrt(d_model)
    learned_pos: bool = False         # learned absolute positions (whisper dec)
    max_pos: int = 0                  # size of learned-pos table if used
    encoder: Optional[EncoderSpec] = None
    frontend: Optional[str] = None    # None | "vlm_patch" | "audio_frames"
    frontend_len: int = 0             # frontend embedding length (stubbed)
    # Paged-serving attention impl for pool-resident caches ("table" in the
    # cache leaf): "gather" materializes the slot's dense view per leaf;
    # "paged" walks the page table inside ``kernels.paged_attention`` (the
    # CUDA kernel on the card, its plain PyTorch version on the CPU). The
    # serve engine sets it per call via ``cfg.replace``.
    paged_kernel: str = "gather"

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.groups)

    def param_count(self) -> int:
        """Parameter count (for 6ND roofline math)."""
        from repro_torch.models.lm import count_params  # avoids an import cycle
        return count_params(self)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shape cells assigned to this paper (seq_len, global_batch, mode)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str                         # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class TensorSpec:
    """A (shape, dtype) stand-in for a tensor that is not allocated: the
    port's ``jax.ShapeDtypeStruct``. ``configs.input_specs`` returns them,
    and ``core.compile_cache`` keys executables on them."""
    shape: Tuple[int, ...]
    dtype: object                     # a torch.dtype
