"""Device queries for the kernel dispatch (port of ``repro.kernels.ops``).

``on_cuda()`` takes the place of the reference's ``on_tpu()``.
``resolve_device`` is the one rule every entry point follows: the card
unless the caller asks for the CPU, and never a quiet fall back to the CPU
(an engine on the card then picks the paged kernel for ``kernel="auto"``).
The flash-attention and SSD dispatch of the reference wait for their kernels.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def on_cuda() -> bool:
    return torch.cuda.is_available()


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev
