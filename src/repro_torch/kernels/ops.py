"""Kernel dispatch and device queries (port of ``repro.kernels.ops``).

``on_cuda()`` takes the place of the reference's ``on_tpu()``.
``resolve_device`` is the one rule every entry point follows: the card
unless the caller asks for the CPU, and never a quiet fall back to the CPU
(an engine on the card then picks the paged kernel for ``kernel="auto"``).
``attention`` dispatches flash attention and ``ssd`` the SSD scan: each
runs its CUDA kernel on CUDA tensors and its plain version on CPU tensors,
or the oracle with ``impl="ref"``. The reference's other impls
(``"pallas"``, ``"interpret"``) name TPU modes and raise here.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd


def on_cuda() -> bool:
    return torch.cuda.is_available()


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev


def attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
              impl: str = "auto"):
    """q: (B,H,Sq,D), k/v: (B,K,Sk,D/Dv) -> (B,H,Sq,Dv) in q.dtype.

    ``impl="auto"``: ``flash_attention`` (the kernel on CUDA tensors, its
    plain version on CPU tensors); ``"ref"``: the oracle ``attention_ref``."""
    if impl == "auto":
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if impl == "ref":
        return _fa.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    raise ValueError(f"impl must be auto|ref: {impl!r}")


def ssd(x, dt, A, B, C, *, chunk: int = 128, impl: str = "auto"):
    """x: (Bz,S,H,P), dt: (Bz,S,H), A: (H,), B/C: (Bz,S,N) -> y (Bz,S,H,P).

    ``impl="auto"``: ``ssd_scan`` (the kernel on CUDA tensors, its plain
    version on CPU tensors), y in x.dtype; ``"ref"``: the sequential
    recurrence ``ssd_ref``, y in float32."""
    if impl == "auto":
        return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    if impl == "ref":
        return _ssd.ssd_ref(x, dt, A, B, C)[0]
    raise ValueError(f"impl must be auto|ref: {impl!r}")
