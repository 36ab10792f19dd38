"""Paged attention: attention over pool-resident KV through the page table.

The serving engine keeps KV state in one shared pool of fixed-size pages;
each slot owns an ordered page list (its page table, -1 = unallocated).
``paged_attention`` walks that table inside hand-written CUDA kernels
(``csrc/paged_attention.cu``, the Hopper port of the reference's Pallas
``_kernel``) and never materializes a dense per-slot view: each live K/V
page is read once per (slot, kv head, block) and shared by the G query
heads of that kv head.

Four routes, chosen by ``_route`` from shapes, dtype, the SM count and
the routes' shared memory alone (never from the contents of ``tables``,
``kpos`` or ``q_pos``, so no host sync; worked out once a shape by
``_plan``): ``split`` (S*G < 64: decode; the table split across blocks,
then a combine kernel), ``tile`` (bf16 prefill: tensor-core tiles gathered
from pages), ``mla`` (bf16, S*G >= 64, MLA's absorbed form with ``v`` the
same tensor as ``k``: deepseek-v2's 128 heads over one latent head; one
staged [ckv | kr] tile is both K and V of wgmma products, and a decode's
table is split across blocks and joined by the split route's combine
kernel) and ``general`` (the rest). A route is never a fallback: a failed
launch raises.

``paged_attention_ref`` is the plain PyTorch version of the same function,
line for line the reference oracle (``repro.kernels.ref``): gather each
slot's pages into a dense view, then naive masked attention. The wrapper
takes it only for tensors on the CPU (or ``meta``: shapes alone); on a CUDA
tensor it launches a kernel or raises. ``paged_attention.launches`` counts wrapper calls that launched,
``paged_attention.routes`` the same calls by route.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from repro_torch.kernels import PLAIN_DEVICES, _build

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


ROUTES = ("split", "tile", "mla", "general")
TILE_ROWS = 64                   # (query, group) rows of a tile or mla block
MLA_KEYS = 32                    # keys a tile of the mla route (kMlaBK)

# A route's shared memory a block, as the CUDA source lays it out:
# ``split(R, ps, Dt, Dv, elem, per)``, ``tile(Dk, Dv, npps, ps)`` and
# ``mla(Dk, npps, ps)`` in bytes, and the most a block may take. On the
# card these are the library's own functions (``_library_smem``), so the
# layout is known in one place only.
Smem = collections.namedtuple("Smem", "split tile mla limit")


@functools.lru_cache(maxsize=None)
def _library_smem() -> Smem:
    lib = _build.load("paged_attention")
    split = lib.paged_attention_split_smem_bytes
    tile = lib.paged_attention_tile_smem_bytes
    mla = lib.paged_attention_mla_smem_bytes
    limit = lib.paged_attention_max_smem_bytes
    split.argtypes, tile.argtypes = [ctypes.c_int] * 6, [ctypes.c_int] * 4
    mla.argtypes = [ctypes.c_int] * 3
    for fn in (split, tile, mla, limit):
        fn.restype = ctypes.c_longlong
    # ctypes functions do not hash; ``_plan``'s cache key needs them to
    return Smem(lambda *a: split(*a), lambda *a: tile(*a),
                lambda *a: mla(*a), limit())


def _splits(B: int, K: int, npps: int, n_sm: int) -> int:
    """How many ranges of table entries the split route cuts each slot's
    table into: about four blocks an SM over B*K (slot, kv head) pairs,
    each range ``-(-npps // splits)`` entries, none empty."""
    want = max(1, min(npps, -(-4 * n_sm // max(1, B * K))))
    per = max(1, -(-npps // want))
    return max(1, -(-npps // per))


def _shared(k, v) -> bool:
    """``v`` is ``k``: one tensor for keys and values (MLA's ckv pool). A
    fact about the arguments (their storage and shape), not their
    contents."""
    return (v.data_ptr() == k.data_ptr() and v.shape == k.shape
            and v.dtype == k.dtype)


def _mla_splits(blocks: int, tiles: int, n_sm: int) -> int:
    """How many ranges of whole key tiles the mla route cuts each slot's
    table into: about one block an SM over ``blocks`` unsplit blocks (one
    block an SM fits its shared memory), none empty; 1 where the row tiles
    alone fill the card."""
    want = max(1, min(tiles, -(-n_sm // max(1, blocks))))
    per = -(-tiles // want)
    return -(-tiles // per)


def _shape(q, k, v, q2, tables) -> tuple:
    """All that a route depends on: shapes and dtype, never contents."""
    return (*q.shape, *k.shape[1:3], v.shape[-1],
            q2.shape[-1] if q2 is not None else 0, tables.shape[1], q.dtype,
            _shared(k, v))


@functools.lru_cache(maxsize=4096)
def _plan(shape: tuple, n_sm: int, smem: Smem):
    """``(route, splits, per, workspace floats)`` for one ``_shape``:
    worked out once a shape, so a call's host work stays a lookup."""
    B, S, H, Dk, ps, K, Dv, Dk2, npps, dtype, shared = shape
    R, elem = S * (H // K), 2 if dtype == torch.bfloat16 else 4
    if R < TILE_ROWS:
        splits = _splits(B, K, npps, n_sm)
        per = -(-npps // splits)
        if (all(d * elem % 16 == 0 for d in (Dk, Dk2, Dv))
                and smem.split(R, ps, Dk + Dk2, Dv, elem, per) <= smem.limit):
            return "split", splits, per, B * K * splits * R * (Dv + 2)
        return "general", 0, 0, 0
    if (dtype == torch.bfloat16 and shared and 0 < Dk2 <= 64
            and Dk2 % 8 == 0 and Dk % 64 == 0 and Dk <= 512
            and ps >= 8 and ps & (ps - 1) == 0
            and smem.mla(Dk, npps, ps) <= smem.limit):
        tiles = -(-npps * ps // MLA_KEYS)
        splits = _mla_splits(B * K * -(-R // TILE_ROWS), tiles, n_sm)
        per = -(-tiles // splits)
        ws = B * K * splits * R * (Dv + 2) if splits > 1 else 0
        return "mla", splits, per, ws
    if (dtype == torch.bfloat16 and Dk2 == 0
            and all(d % 8 == 0 and 8 <= d <= 256 for d in (Dk, Dv))
            and 64 % ps == 0 and smem.tile(Dk, Dv, npps, ps) <= smem.limit):
        return "tile", 0, 0, 0
    return "general", 0, 0, 0


def _route(q, k, v, q2, tables, n_sm: int, smem: Smem) -> str:
    """``"split"``, ``"tile"``, ``"mla"`` or ``"general"``, from shapes,
    dtype, the SM count and the routes' shared memory alone."""
    return _plan(_shape(q, k, v, q2, tables), n_sm, smem)[0]


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher(route: str):
    lib = _build.load("paged_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if route == "general":
        fn = lib.paged_attention_launch
        fn.argtypes = [p] * 9 + [i] * 10 + [f, i, i, i, i, f, i, p]
    elif route == "split":
        fn = lib.paged_attention_split_launch
        fn.argtypes = [p] * 10 + [i] * 12 + [f, i, i, i, i, f, i, p]
    elif route == "mla":
        fn = lib.paged_attention_mla_launch
        fn.argtypes = [p] * 9 + [i] * 11 + [f, i, i, i, i, f, p]
    else:
        fn = lib.paged_attention_tile_launch
        fn.argtypes = [p] * 7 + [i] * 9 + [f, i, i, i, i, f, p]
    fn.restype = ctypes.c_int
    return fn


def _refuse_sharded(*ts) -> None:
    """paged_attention is on no sharded path (the paged engine serves on one device, in the reference as here): a DTensor raises rather than
    take the plain version on a gathered copy."""
    from repro_torch.sharding.spmd import is_sharded
    if any(t is not None and is_sharded(t) for t in ts):
        raise NotImplementedError(
            "paged_attention: sharded (DTensor) inputs are not taken: the paged engine serves on one device, in the reference as here")


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
    whose table is all -1 (or a pad query row) gets exact zeros. CPU (and
    ``meta``) tensors take ``paged_attention_ref``; CUDA tensors launch the kernels of the
    route ``_route`` picks (the split, tile and mla routes take 16-byte
    aligned tensors and raise on others).
    """
    _refuse_sharded(q, k, v, kpos, tables, q_pos, q2, k2)
    _check(q, k, v, kpos, tables, q_pos, q2, k2)
    if q.device.type in PLAIN_DEVICES:
        return paged_attention_ref(q, k, v, kpos, tables, q_pos, q2=q2, k2=k2,
                                   scale=scale, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu, meta or cuda, not "
                         f"{q.device}")
    shape = _shape(q, k, v, q2, tables)
    B, S, H, Dk, ps, K, Dv, Dk2, npps = shape[:9]
    P = k.shape[0]
    if scale is None:
        scale = 1.0 / math.sqrt(Dk + Dk2)
    n_sm = _n_sm(q.device.index if q.device.index is not None
                 else torch.cuda.current_device())
    route, splits, per, ws_floats = _plan(shape, n_sm, _library_smem())
    ptr = [t.data_ptr() for t in (q, k, v, kpos, tables, q_pos)]
    opt = [q2.data_ptr() if q2 is not None else None,
           k2.data_ptr() if k2 is not None else None]
    if route != "general" and any(x % 16 for x in ptr[:3] + opt if x):
        raise ValueError(f"paged_attention ({route} route) takes tensors "
                         "that start on 16-byte boundaries")
    out = torch.empty((B, S, H, Dv), dtype=v.dtype, device=q.device)
    mask = [float(scale), int(causal), int(window is not None),
            int(window) if window is not None else 0,
            int(softcap is not None),
            float(softcap) if softcap is not None else 0.0]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bf16 = int(q.dtype == torch.bfloat16)
    if route == "split":
        ws = torch.empty(ws_floats, dtype=torch.float32, device=q.device)
        err = _launcher(route)(*ptr, *opt, out.data_ptr(), ws.data_ptr(),
                               B, S, H, K, Dk, Dk2, Dv, P, ps, npps, splits,
                               per, *mask, bf16, stream)
    elif route == "mla":
        ws = (torch.empty(ws_floats, dtype=torch.float32, device=q.device)
              if splits > 1 else None)
        err = _launcher(route)(ptr[0], ptr[1], *ptr[3:], *opt,
                               out.data_ptr(),
                               ws.data_ptr() if ws is not None else None,
                               B, S, H, K, Dk, Dk2, P, ps, npps, splits, per,
                               *mask, stream)
    elif route == "tile":
        err = _launcher(route)(*ptr, out.data_ptr(), B, S, H, K, Dk, Dv, P,
                               ps, npps, *mask, stream)
    else:
        err = _launcher(route)(*ptr, *opt, out.data_ptr(), B, S, H, K, Dk,
                               Dk2, Dv, P, ps, npps, *mask, bf16, stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    paged_attention.launches += 1
    paged_attention.routes[route] += 1
    return out


paged_attention.launches = 0
paged_attention.routes = dict.fromkeys(ROUTES, 0)
