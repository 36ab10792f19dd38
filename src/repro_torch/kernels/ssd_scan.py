"""Mamba2 SSD (state-space duality) chunked scan.

``ssd_scan`` computes the chunked SSD scan inside hand-written CUDA kernels
(``csrc/ssd_scan.cu``, the Hopper port of the reference's Pallas ``ssd_scan``
kernel). A block walks the chunks of its batch row in order and carries
the (P x N) f32 state on chip, so the state never travels through device
memory between chunks. Two routes, chosen by ``_plan`` from shapes, dtype
and the SM count alone (never from tensor contents, so no host sync):
``tc`` (bf16 x/B/C, P = 64, N = 64 or 128: the products on the tensor
cores, G heads a block sharing each C.B^T tile, R blocks splitting a
chunk's query tiles) and ``simt`` (the first design, f32 products on the
CUDA cores: f32 inputs and every other shape). A route is never a
fallback: a failed launch raises.

``ssd_chunked_ref`` is the plain PyTorch version of the same function, line
for line the reference's XLA path (``repro.models.ssm.ssd_chunked``), but
for the intra-chunk decay, masked before its exp so that its gradient stays
finite where the reference's is NaN (ROADMAP.md section 3); the
wrapper takes it only for tensors on the CPU (or ``meta``: shapes alone), and
on a CUDA tensor launches the kernel or raises. ``ssd_ref`` is the sequential recurrence, the semantic
ground truth (``repro.kernels.ref.ssd_ref``). ``ssd_scan.launches`` counts
kernel launches, ``ssd_scan.routes`` the same launches by route.

Gradients: the kernel writes fresh tensors through ctypes, which autograd
cannot see. Where autograd records (grad enabled and an input that requires
grad), a CUDA call goes through ``_SsdScanFn``: its forward launches the
kernel, its backward recomputes ``ssd_chunked_ref`` from the saved inputs
and returns the plain version's gradients for x, dt, A, B and C — the
reference's own gradient, which is autodiff of its plain ``ssd_chunked``
(it has no backward kernel). The counters count forward launches only;
a recompute under remat launches the forward again and counts. The
backward runs inside a profiler range, ``ssd_scan_backward``.

Sharded inputs (DTensors of the SPMD runtime, ``sharding.spmd``): the scan
is independent across batch rows and across heads, so each rank runs the
wrapper above — the kernel on the card — on its own shard through
``local_map``. A batch cut stays (dt, B and C cut alike); a head cut stays
(dt and A cut alike; B and C, shared by the heads, whole); a sequence or
head-dim cut, or a partial sum, is first redistributed to whole, and the
runtime's count shows it.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import PLAIN_DEVICES, _build

_FLOATS = (torch.float32, torch.bfloat16)
MAX_P, MAX_N, MAX_Q = 64, 128, 1024        # what the kernels' tiles hold
ROUTES = ("tc", "simt")
TC_P, TC_N = 64, (64, 128)                 # the shapes the tc route takes


def ssd_chunked_ref(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan, plain PyTorch.

    xh: (B,S,H,P)  dt: (B,S,H)  A: (H,)  Bm/Cm: (B,S,N) (n_groups=1).
    Returns y: (B,S,H,P) f32, final_state: (B,H,P,N) f32.
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0
    nc = S // Q

    xc = xh.reshape(Bsz, nc, Q, H, P).float()
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()

    dA = dtc * A                                               # (B,nc,Q,H)
    cum = torch.cumsum(dA, dim=2)                              # decay to chunk start
    # intra-chunk dual: scores[q,p] = C_q.B_p * exp(cum_q - cum_p) * dt_p, q>=p
    CB = torch.einsum("bcqn,bcpn->bcqp", Cc, Bc)               # (B,nc,Q,Q)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,nc,Q,Q,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))
    # masked before the exp: the same values as the reference's
    # where(causal, exp(seg), 0), but exp(seg) of a masked entry overflows
    # once a chunk's decay passes e^88, and its gradient (0 * inf) is NaN
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                              float("-inf")))
    scores = CB[..., None] * L * dtc[:, :, None, :, :]         # (B,nc,Qq,Qp,H)
    y_diag = torch.einsum("bcqph,bcphv->bcqhv", scores, xc)

    # chunk-boundary states
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)             # (B,nc,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqhv->bchvn",
                          Bc, decay_out * dtc, xc)             # (B,nc,H,P,N)
    chunk_decay = torch.exp(torch.sum(dA, dim=2))              # (B,nc,H)

    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    starts = []
    for c in range(nc):                                        # emit state at chunk START
        starts.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_starts = torch.stack(starts, dim=1)                      # (B,nc,H,P,N)

    y_off = torch.einsum("bcqn,bcqh,bchvn->bcqhv",
                         Cc, torch.exp(cum), h_starts)
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y, h


def ssd_ref(x, dt, A, B, C):
    """Sequential SSM recurrence (the semantic ground truth for SSD).

    x: (Bz,S,H,P), dt: (Bz,S,H), A: (H,), B/C: (Bz,S,N).
    Returns y: (Bz,S,H,P) f32, final state (Bz,H,P,N) f32.
    """
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)                       # (Bz,H)
        h = h * decay[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1), h


def _check(x, dt, A, B, C, chunk):
    """Raise where the reference asserts, and on anything the kernel does
    not take."""
    if x.ndim != 4:
        raise ValueError("ssd_scan: x is (Bz,S,H,P)")
    Bz, S, H, P = x.shape
    if (tuple(dt.shape) != (Bz, S, H) or tuple(A.shape) != (H,)
            or B.ndim != 3 or B.shape[:2] != (Bz, S) or C.shape != B.shape):
        raise ValueError(f"ssd_scan: n_groups must be 1 and shapes agree: "
                         f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    q = min(chunk, S)
    if q < 1 or S % q:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of the chunk "
                         f"{q}")
    for t in (x, dt, A, B, C):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: tensors on {t.device} and "
                             f"{x.device}")
    if x.dtype not in _FLOATS or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("ssd_scan: x, B and C share one dtype of "
                        f"{_FLOATS}, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype not in _FLOATS or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt in {_FLOATS} and A in float32, got "
                        f"{dt.dtype}, {A.dtype}")


Plan = collections.namedtuple("Plan", "route G R blocks")


@functools.lru_cache(maxsize=4096)
def _plan(shape: tuple, n_sm: int) -> Plan:
    """Route, heads a block (G), blocks a head group (R) and the block count
    for ``shape`` = (Bz, S, H, P, N, Q, dtype) on a card of ``n_sm`` SMs:
    shapes alone, worked out once a shape. The tc route takes two heads a
    block where that still leaves about one block an SM (3/4 of the SMs or
    more), and splits each chunk's query tiles over two blocks a head where
    one block a head would leave more than half the card idle."""
    Bz, S, H, P, N, Q, dtype = shape
    if dtype != torch.bfloat16 or P != TC_P or N not in TC_N:
        return Plan("simt", 1, 1, Bz * H)
    G = 2 if H % 2 == 0 and 4 * (Bz * H // 2) >= 3 * n_sm else 1
    blocks = Bz * H // G
    R = 2 if -(-Q // 64) >= 2 and 2 * blocks <= n_sm + n_sm // 8 else 1
    return Plan("tc", G, R, blocks * R)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher(route: str):
    lib = _build.load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    if route == "tc":
        fn = lib.ssd_scan_tc_launch
        fn.argtypes = [p] * 7 + [i] * 9 + [p]
    else:
        fn = lib.ssd_scan_simt_launch
        fn.argtypes = [p] * 7 + [i] * 6 + [i, i, p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, out_dtype=None,
             return_state: bool = False, route=None):
    """Mamba2 SSD chunked scan.

    x: (Bz,S,H,P), dt: (Bz,S,H), A: (H,) float32, B/C: (Bz,S,N) with
    n_groups = 1; x, B and C share one dtype (float32 or bfloat16); dt is
    float32 or bfloat16. Chunks are Q = min(chunk, S) long and S % Q == 0.

    Returns y (Bz,S,H,P) in ``out_dtype`` (default x.dtype) and, with
    ``return_state``, also the final state (Bz,H,P,N) in float32. CPU (and
    ``meta``) tensors take ``ssd_chunked_ref``; CUDA tensors launch the kernel of the
    route ``_plan`` picks, or of ``route`` ("tc" or "simt") where the caller
    forces one (raising if that route does not take the shape).
    """
    from repro_torch.sharding.spmd import is_sharded
    if any(is_sharded(t) for t in (x, dt, A, B, C)):
        return _sharded(x, dt, A, B, C, chunk, out_dtype, return_state, route)
    _check(x, dt, A, B, C, chunk)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if route is not None and route not in ROUTES:
        raise ValueError(f"ssd_scan: route is one of {ROUTES}, not {route!r}")
    if x.device.type in PLAIN_DEVICES:
        y, h = ssd_chunked_ref(x, dt, A, B, C, chunk)
        y = y.to(out_dtype)
        return (y, h) if return_state else y
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu, meta or cuda, not "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        y, h = _SsdScanFn.apply(x, dt, A, B, C, chunk, out_dtype, route)
        return (y, h) if return_state else y
    return _launch(x, dt, A, B, C, chunk, out_dtype, return_state, route)


def _sharded(x, dt, A, B, C, chunk, out_dtype, return_state, route):
    """``ssd_scan`` on each rank's batch rows or heads (see the module
    docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.spmd import as_sharded
    like = next(t for t in (x, dt, A, B, C) if hasattr(t, "placements"))
    x, dt, A, B, C = (as_sharded(t, like) for t in (x, dt, A, B, C))
    R, S = Replicate(), Partial()
    # per mesh dim: the (x, dt, A, B, C) placements, their gradients' (an
    # input whole on each rank of a cut gets a partial sum: a rank's rows
    # or heads contribute only their share), and the (y, state) ones
    ins, grads, outs = [[] for _ in range(5)], [[] for _ in range(5)], [[], []]
    for p in x.placements:
        if isinstance(p, Shard) and p.dim == 0:        # batch rows
            pi, po = (p, Shard(0), R, Shard(0), Shard(0)), (p, Shard(0))
            pg = (p, Shard(0), S, Shard(0), Shard(0))
        elif isinstance(p, Shard) and p.dim == 2:      # heads
            pi, po = (p, Shard(2), Shard(0), R, R), (p, Shard(1))
            pg = (p, Shard(2), Shard(0), S, S)
        else:                                          # made whole first
            pi, po, pg = (R,) * 5, (R, R), (R,) * 5
        for acc, q in zip(ins, pi):
            acc.append(q)
        for acc, q in zip(grads, pg):
            acc.append(q)
        for acc, q in zip(outs, po):
            acc.append(q)

    def run(x, dt, A, B, C):
        return ssd_scan(x, dt, A, B, C, chunk=chunk, out_dtype=out_dtype,
                        return_state=True, route=route)

    y, h = local_map(run, out_placements=tuple(outs),
                     in_placements=tuple(ins),
                     in_grad_placements=tuple(grads),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, dt, A, B, C)
    return (y, h) if return_state else y


class _SsdScanFn(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient (see the
    module docstring). Returns (y, final state)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, out_dtype, route):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk, ctx.out_dtype = chunk, out_dtype
        return _launch(x.detach(), dt.detach(), A.detach(), B.detach(),
                       C.detach(), chunk, out_dtype, True, route)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        ins = [t.detach().requires_grad_(n) for t, n in
               zip(saved, ctx.needs_input_grad[:5])]
        want = [t for t in ins if t.requires_grad]
        with torch.enable_grad(), \
                torch.profiler.record_function("ssd_scan_backward"):
            y, h = ssd_chunked_ref(*ins, ctx.chunk)
            got = iter(torch.autograd.grad((y.to(ctx.out_dtype), h), want,
                                           (gy, gh), allow_unused=True))
        return (*(next(got) if t.requires_grad else None for t in ins),
                None, None, None)


def _launch(x, dt, A, B, C, chunk, out_dtype, return_state, route):
    """Launch the kernel of the planned (or forced) route on CUDA tensors;
    no autograd. Counts the launch."""
    if out_dtype not in _FLOATS:
        raise TypeError(f"ssd_scan: out_dtype must be one of {_FLOATS}")
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    if P > MAX_P or N > MAX_N or Q > MAX_Q:
        raise ValueError(f"ssd_scan kernel takes P <= {MAX_P}, N <= {MAX_N} "
                         f"and chunks <= {MAX_Q}: P={P}, N={N}, Q={Q}")
    n_sm = _n_sm(x.device.index if x.device.index is not None
                 else torch.cuda.current_device())
    plan = _plan((Bz, S, H, P, N, Q, x.dtype), n_sm)
    if route == "simt" and plan.route != "simt":
        plan = Plan("simt", 1, 1, Bz * H)
    elif route == "tc" and plan.route != "tc":
        raise ValueError(f"ssd_scan: the tc route takes bf16 x/B/C with "
                         f"P = {TC_P} and N in {TC_N}, not {x.dtype}, P={P}, "
                         f"N={N}")
    x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    dt = dt.float().contiguous()
    A = A.contiguous()
    if plan.route == "tc" and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan (tc route) takes x, B and C that start on "
                         "16-byte boundaries")
    y = torch.empty((Bz, S, H, P), dtype=out_dtype, device=x.device)
    h = (torch.empty((Bz, H, P, N), dtype=torch.float32, device=x.device)
         if return_state else None)
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), h.data_ptr() if h is not None else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out_bf16 = int(out_dtype == torch.bfloat16)
    if plan.route == "tc":
        err = _launcher("tc")(*ptrs, Bz, S, H, P, N, Q, plan.G, plan.R,
                              out_bf16, stream)
    else:
        err = _launcher("simt")(*ptrs, Bz, S, H, P, N, Q,
                                int(x.dtype == torch.bfloat16), out_bf16,
                                stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed ({plan.route} "
                           f"route): CUDA error {err}")
    ssd_scan.launches += 1
    ssd_scan.routes[plan.route] += 1
    return (y, h) if return_state else y


ssd_scan.launches = 0
ssd_scan.routes = dict.fromkeys(ROUTES, 0)
