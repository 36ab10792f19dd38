"""Flash attention: blocked online-softmax attention over implicit positions.

``flash_attention`` computes attention of q (B,H,Sq,D) against k (B,K,Sk,D)
and v (B,K,Sk,Dv) inside a hand-written CUDA kernel
(``csrc/flash_attention.cu``, the Hopper port of the reference's Pallas
``flash_attention``): one thread block per (query tile, head, batch row)
walks the key tiles with the running max, sum and output accumulator kept on
chip, and skips the tiles that the causal mask or the window hides. In bf16
both products run on the tensor cores (wgmma) over tiles loaded by TMA, p
split in two bf16 terms so that the output keeps one bf16 rounding; in f32
they run on the CUDA cores.

``attention_ref`` is the plain PyTorch version of the same function, line for
line the reference oracle (``repro.kernels.ref.attention_ref``): kv heads
repeated up to H, the full (Sq, Sk) score matrix in f32, softmax, fully
masked rows zeroed. The wrapper takes it only for tensors on the CPU (or
``meta``: shapes alone); on a CUDA tensor it launches the kernel or raises. ``flash_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import PLAIN_DEVICES, _build

_FLOATS = (torch.float32, torch.bfloat16)
MAX_DIM = 256                     # D and Dv the kernel's tiles hold


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None):
    """q: (B,H,Sq,D), k/v: (B,K,Sk,D/Dv). Naive materialized attention;
    returns (B,H,Sq,Dv) in q.dtype."""
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=1)
        v = v.repeat_interleave(H // K, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[None, None, :, None], p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _check(q, k, v):
    """Raise where the reference asserts, and on mismatched tensors."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q (B,H,Sq,D), k (B,K,Sk,D), "
                         "v (B,K,Sk,Dv)")
    B, H, Sq, D = q.shape
    K = k.shape[1]
    if (k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]
            or K < 1 or H % K):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; H % K == 0")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {t.device} and "
                             f"{q.device}")
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v share one dtype of "
                        f"{_FLOATS}, got {q.dtype}, {k.dtype}, {v.dtype}")


def _check_kernel(q, k, v):
    """Raise on anything the CUDA kernel does not take."""
    D, Dv = q.shape[-1], v.shape[-1]
    if not all(8 <= d <= MAX_DIM and d % 8 == 0 for d in (D, Dv)):
        raise ValueError(f"flash_attention kernel takes D and Dv multiples "
                         f"of 8 up to {MAX_DIM}: D={D}, Dv={Dv}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash_attention takes tensors that start on a "
                             "16-byte boundary")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 4 + [i] * 7 + [f, i, i, i, i, f, i, p]
    fn.restype = ctypes.c_int
    return fn


def _refuse_sharded(*ts) -> None:
    """flash_attention is on no sharded path (no model calls it, in the reference as here): a DTensor raises rather than
    take the plain version on a gathered copy."""
    from repro_torch.sharding.spmd import is_sharded
    if any(t is not None and is_sharded(t) for t in ts):
        raise NotImplementedError(
            "flash_attention: sharded (DTensor) inputs are not taken: no model calls it, in the reference as here")


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None, scale=None):
    """Blocked online-softmax attention.

    q: (B, H, Sq, D), k: (B, K, Sk, D), v: (B, K, Sk, Dv), H % K == 0
    (query head h reads kv head h // (H // K)); one dtype, float32 or
    bfloat16. Positions are 0..Sq-1 and 0..Sk-1 for queries and keys alike.
    ``scale`` defaults to 1/sqrt(D); ``window`` keeps keys with
    q_pos - k_pos < window; ``softcap`` applies cap * tanh(s / cap).

    Returns (B, H, Sq, Dv) in q.dtype; a row that sees no key is exact
    zeros. CPU (and ``meta``) tensors take ``attention_ref``; CUDA tensors launch the
    kernel (D and Dv multiples of 8 up to 256, contiguous tensors).
    """
    _refuse_sharded(q, k, v)
    _check(q, k, v)
    if q.device.type in PLAIN_DEVICES:
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu, meta or cuda, not "
                         f"{q.device}")
    _check_kernel(q, k, v)
    B, H, Sq, D = q.shape
    K, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    # any window outside [-Sk, Sq] masks as one at that end of the range
    win = 0 if window is None else int(min(max(window, -Sk), Sq))
    out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, K, Sq, Sk, D, Dv, float(scale), int(causal),
        int(window is not None), win, int(softcap is not None),
        float(softcap) if softcap is not None else 0.0,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
