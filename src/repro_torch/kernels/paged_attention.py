"""Paged attention: attention over pool-resident KV through the page table.

The serving engine keeps KV state in one shared pool of fixed-size pages;
each slot owns an ordered page list (its page table, -1 = unallocated).
``paged_attention`` walks that table inside a hand-written CUDA kernel
(``csrc/paged_attention.cu``, the Hopper port of the reference's Pallas
``_kernel``) and never materializes a dense per-slot view: each live K/V
page is read once per (slot, kv head, query chunk) and shared by the G query
heads of that kv head, with online softmax carried across pages.

``paged_attention_ref`` is the plain PyTorch version of the same function,
line for line the reference oracle (``repro.kernels.ref``): gather each
slot's pages into a dense view, then naive masked attention. The wrapper
takes it only for tensors on the CPU; on a CUDA tensor it launches the
kernel or raises. ``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

_FLOATS = (torch.float32, torch.bfloat16)


def paged_attention_ref(q, k, v, kpos, tables, q_pos, *, q2=None, k2=None,
                        scale=None, causal=True, window=None, softcap=None):
    """Dense plain version of ``paged_attention``: materialize each slot's
    page list into a per-slot view, then run naive masked attention.

    q: (B,S,H,Dk), k/v: (P,ps,K,Dk/Dv), kpos: (P,ps), tables: (B,npps),
    q_pos: (B,S). Optional q2/k2 add a second score component (MLA
    absorbed form). Returns (B,S,H,Dv) in v.dtype.
    """
    B, S, H, Dk = q.shape
    P, ps, K, _ = k.shape
    npps = tables.shape[1]
    vcap = npps * ps
    if scale is None:
        scale = 1.0 / math.sqrt(Dk + (q2.shape[-1] if q2 is not None else 0))

    cl = tables.clamp(min=0).long()
    kd = k[cl].reshape(B, vcap, K, -1)
    vd = v[cl].reshape(B, vcap, K, -1)
    kp = kpos[cl].reshape(B, vcap)
    kp = torch.where((tables >= 0).repeat_interleave(ps, dim=1), kp, -1)

    if K != H:
        kd = kd.repeat_interleave(H // K, dim=2)
        vd = vd.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kd.float())
    if q2 is not None:
        k2d = k2[cl].reshape(B, vcap, K, -1)
        if K != H:
            k2d = k2d.repeat_interleave(H // K, dim=2)
        s = s + torch.einsum("bqhd,bshd->bhqs", q2.float(), k2d.float())
    s = s * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = (kp >= 0)[:, None, :]                              # (B,1,S)
    if causal:
        mask = mask & (kp[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & ((q_pos[:, :, None] - kp[:, None, :]) < window)
    mask = mask[:, None]                                      # (B,1,Q,S)
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqs,bshd->bqhd", p, vd.float()).to(v.dtype)


def _check(q, k, v, kpos, tables, q_pos, q2, k2):
    """Raise on anything the kernel does not take."""
    if (q2 is None) != (k2 is None):
        raise ValueError("q2 and k2 come together")
    floats = [q, k, v] + ([q2, k2] if q2 is not None else [])
    ints = [kpos, tables, q_pos]
    dev = q.device
    for t in floats + ints:
        if t.device != dev:
            raise ValueError(f"paged_attention: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("paged_attention takes contiguous tensors")
    if q.dtype not in _FLOATS or any(t.dtype != q.dtype for t in floats):
        raise TypeError("paged_attention: q, k, v (and q2, k2) must share "
                        f"one dtype of {_FLOATS}, got "
                        f"{[t.dtype for t in floats]}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("paged_attention: kpos, tables and q_pos are int32")
    B, S, H, Dk = q.shape
    P, ps, K, Dk_ = k.shape
    if H % K or Dk_ != Dk or v.shape[:3] != (P, ps, K):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if (tuple(kpos.shape) != (P, ps) or tables.ndim != 2
            or tables.shape[0] != B or tuple(q_pos.shape) != (B, S)):
        raise ValueError("paged_attention: kpos (P,ps), tables (B,npps), "
                         "q_pos (B,S)")
    if q2 is not None and (q2.shape[:3] != q.shape[:3]
                           or k2.shape[:3] != k.shape[:3]
                           or q2.shape[3] != k2.shape[3]):
        raise ValueError("paged_attention: q2 (B,S,H,Dk2), k2 (P,ps,K,Dk2)")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("paged_attention").paged_attention_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 9 + [i] * 10 + [f, i, i, i, i, f, i, p]
    fn.restype = ctypes.c_int
    return fn


def paged_attention(q, k, v, kpos, tables, q_pos, *, q2=None, k2=None,
                    scale=None, causal: bool = True, window=None,
                    softcap=None):
    """Attention over pool-resident KV via an in-kernel page-table walk.

    q:      (B, S, H, Dk)   queries (decode: S == 1)
    k:      (P, ps, K, Dk)  pooled keys   — P pages of ps rows, H % K == 0
    v:      (P, ps, K, Dv)  pooled values
    kpos:   (P, ps) int32   absolute position per pool row (-1 = empty)
    tables: (B, npps) int32 page table per slot (-1 = unallocated)
    q_pos:  (B, S) int32    absolute query positions (-1 = pad row)
    q2/k2:  optional second score component (MLA absorbed form);
            q2: (B, S, H, Dk2), k2: (P, ps, K, Dk2)

    All float inputs share one dtype (float32 or bfloat16); every tensor is
    contiguous and on one device. Returns (B, S, H, Dv) in v.dtype. A slot
    whose table is all -1 (or a pad query row) gets exact zeros. CPU tensors
    take ``paged_attention_ref``; CUDA tensors launch the kernel.
    """
    _check(q, k, v, kpos, tables, q_pos, q2, k2)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k, v, kpos, tables, q_pos, q2=q2, k2=k2,
                                   scale=scale, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    B, S, H, Dk = q.shape
    P, ps, K, _ = k.shape
    Dv = v.shape[-1]
    Dk2 = q2.shape[-1] if q2 is not None else 0
    if scale is None:
        scale = 1.0 / math.sqrt(Dk + Dk2)
    out = torch.empty((B, S, H, Dv), dtype=v.dtype, device=q.device)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
        tables.data_ptr(), q_pos.data_ptr(),
        q2.data_ptr() if q2 is not None else None,
        k2.data_ptr() if k2 is not None else None, out.data_ptr(),
        B, S, H, K, Dk, Dk2, Dv, P, ps, tables.shape[1], float(scale),
        int(causal), int(window is not None),
        int(window) if window is not None else 0,
        int(softcap is not None),
        float(softcap) if softcap is not None else 0.0,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
