"""Architecture registry (port of ``repro.configs``).

``get_config(arch, smoke=False)`` returns the exact published config (or its
reduced smoke variant). The config files are copies of the reference's,
pinned to them by ``tests/test_torch_package.py``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.spec import ModelConfig

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


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "get_config"]
