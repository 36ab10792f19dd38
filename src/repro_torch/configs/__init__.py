"""Architecture registry + input specs (port of ``repro.configs``).

``get_config(arch, smoke=False)`` returns the exact published config (or its
reduced smoke variant). The config files are copies of the reference's,
pinned to them by ``tests/test_torch_package.py``. ``input_specs(cfg,
cell)`` returns ``TensorSpec`` stand-ins (shape, dtype) for every model
input of a shape cell, allocation-free.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.models.spec import (SHAPES, SHAPES_BY_NAME, ModelConfig,
                                     ShapeCell, TensorSpec)

_MODULES = {
    "zamba2-7b": "zamba2_7b",
    "internvl2-76b": "internvl2_76b",
    "mamba2-1.3b": "mamba2_1_3b",
    "gemma3-12b": "gemma3_12b",
    "qwen3-14b": "qwen3_14b",
    "gemma2-27b": "gemma2_27b",
    "stablelm-12b": "stablelm_12b",
    "whisper-base": "whisper_base",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}

ARCHS = tuple(_MODULES)

# archs with bounded-state or windowed attention run the 500k decode cell;
# pure full-attention archs skip it
LONG_CONTEXT_OK = ("zamba2-7b", "mamba2-1.3b", "gemma3-12b", "gemma2-27b")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def cell_applicable(arch: str, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason-if-not) for an (arch x shape) pair."""
    if cell.name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: 500k decode skipped"
    return True, ""


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """TensorSpec stand-ins for the data inputs of a shape cell."""
    B, S = cell.global_batch, cell.seq_len
    i32, bf16, sd = torch.int32, torch.bfloat16, TensorSpec

    if cell.mode == "decode":
        specs = {"tokens": sd((B, 1), i32), "positions": sd((B, 1), i32)}
        if cfg.encoder is not None:
            specs["enc_out"] = sd((B, cfg.encoder.seq_len, cfg.d_model), bf16)
        return specs

    specs = {}
    s_text = S
    if cfg.frontend == "vlm_patch":
        s_text = S - cfg.frontend_len
        specs["embeds"] = sd((B, cfg.frontend_len, cfg.d_model), bf16)
    if cfg.frontend == "audio_frames":
        specs["frames"] = sd((B, cfg.encoder.seq_len, cfg.d_model), bf16)
    specs["tokens"] = sd((B, s_text), i32)
    if cell.mode == "train":
        specs["labels"] = sd((B, s_text), i32)
    return specs


__all__ = ["ARCHS", "SHAPES", "SHAPES_BY_NAME", "LONG_CONTEXT_OK",
           "get_config", "input_specs", "cell_applicable"]
