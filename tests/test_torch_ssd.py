"""The port's SSD scan against the reference's.

On the CPU the port's wrapper ``ssd_scan`` runs its plain version
``ssd_chunked_ref``, which must agree with the reference's XLA path
(``repro.models.ssm.ssd_chunked``), with the reference's Pallas kernel in
interpret mode (``ssd_scan(..., interpret=True)``, as the reference's own
tests run it) and with the sequential oracle ``ssd_ref``, over the sweep of
``tests/test_kernels.py::test_ssd_scan_sweep``. Tolerances are the
reference's own: relative error (max |a - b| / max |b|) 3e-4 in f32 and
6e-2 in bf16 — the same math summed in another order, and in bf16 one
rounding of y on each side.

``_emulate_tc`` repeats the tensor-core route's rounding points in plain
PyTorch (C.B^T exact; the scores, the weighted inputs x w of the state
update and the carried state each as two bf16 terms; the state stored as
three): it must hold the f32 contract, and each of three controls that
round one of those operands once to bf16 must fail it. ``_plan`` is held by
shape alone: the route, the heads a block (G), the blocks a head group (R)
and the block count.

The ``cuda`` tests hold the CUDA kernels against the plain version on the
card: every route in bf16 over the sweep, f32 on the simt route, the
model's own shapes (bf16 x/B/C, f32 dt, y in f32 with the final state) on
the tc route at 3e-4, a batch-1 and a 4,096-token scan, and a strong decay
(dt x 10), and the autograd wrapper's gradients (x, dt, A, B and C: the
plain version's gradient, recomputed in the backward pass) against the
plain version's own at the same bounds. On the CPU the wrapper's backward
is held to native autograd with a counting stand-in for the launch, and
the plain gradient is held finite and equal to the sequential oracle's
where the reference's is NaN (a chunk whose decay passes e^88). JAX is
imported in fixtures and tests, not at module level, so that the file
also runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_ssd.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (_plan, ssd_chunked_ref, ssd_ref,
                                          ssd_scan)

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

SWEEP = [(1, 128, 2, 64, 32, 64),            # tests/test_kernels.py:60-64
         (2, 256, 4, 64, 64, 128),
         (1, 192, 2, 32, 16, 64)]
TOL = {"f32": 3e-4, "bf16": 6e-2}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _inputs(Bz, S, H, P, N, dtype, seed=0, dt_dtype=None):
    """The sweep's inputs (x, dt, B, C in ``dtype``, A in f32), made with
    numpy and rounded to bf16 once, as numpy arrays (bf16 via ml_dtypes)."""
    import jax.numpy as jnp
    r = np.random.default_rng(seed)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    dd = jd if dt_dtype is None else {"f32": jnp.float32,
                                      "bf16": jnp.bfloat16}[dt_dtype]
    x = r.standard_normal((Bz, S, H, P), np.float32)
    dt = np.logaddexp(r.standard_normal((Bz, S, H), np.float32), 0)
    A = -np.exp(0.3 * r.standard_normal((H,), np.float32))
    B = r.standard_normal((Bz, S, N), np.float32)
    C = r.standard_normal((Bz, S, N), np.float32)
    return [np.asarray(jnp.asarray(a, t)) for a, t in
            ((x, jd), (dt, dd), (A, jnp.float32), (B, jd), (C, jd))]


def _np_inputs(Bz, S, H, P, N, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((Bz, S, H, P), np.float32),
            np.logaddexp(r.standard_normal((Bz, S, H), np.float32), 0),
            -np.exp(0.3 * r.standard_normal((H,), np.float32)),
            r.standard_normal((Bz, S, N), np.float32),
            r.standard_normal((Bz, S, N), np.float32))


def _model_inputs(dev, Bz, S, H, P, N, seed=0, dtype=torch.bfloat16,
                  dt_scale=1.0):
    """The model path's types: x, B, C in ``dtype`` (bf16), dt and A f32."""
    x, dt, A, B, C = (torch.from_numpy(a).to(dev)
                      for a in _np_inputs(Bz, S, H, P, N, seed))
    return x.to(dtype), dt * dt_scale, A, B.to(dtype), C.to(dtype)


def _torch(arrays, device="cpu"):
    from repro_torch.convert import tensor_from_numpy
    return [tensor_from_numpy(a, device) for a in arrays]


@pytest.fixture(scope="module")
def jax_ssd():
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels.ref import ssd_ref as j_ssd_ref
    from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
    from repro.models.ssm import ssd_chunked as j_ssd_chunked
    return dict(
        chunked=jax.jit(j_ssd_chunked, static_argnames=("chunk",)),
        kernel=jax.jit(lambda *a, chunk: j_ssd_scan(*a, chunk=chunk,
                                                    interpret=True),
                       static_argnames=("chunk",)),
        oracle=jax.jit(j_ssd_ref), ops=jops, asarray=jnp.asarray)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Bz,S,H,P,N,chunk", SWEEP)
def test_plain_matches_reference_path_and_kernel(jax_ssd, dtype, Bz, S, H, P,
                                                 N, chunk):
    arrs = _inputs(Bz, S, H, P, N, dtype)
    ja = [jax_ssd["asarray"](a) for a in arrs]
    jy, jh = jax_ssd["chunked"](*ja, chunk=chunk)
    jk = jax_ssd["kernel"](*ja, chunk=chunk)             # y in x.dtype
    ty, th = ssd_chunked_ref(*_torch(arrs), chunk)
    assert ty.dtype == th.dtype == torch.float32
    assert _rel(ty.numpy(), jy) < TOL[dtype]
    assert _rel(th.numpy(), jh) < TOL[dtype]
    assert _rel(ty.numpy(), jk) < TOL[dtype]
    # the wrapper on CPU tensors: the plain version, y in x.dtype
    wy = ssd_scan(*_torch(arrs), chunk=chunk)
    assert wy.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    assert _rel(wy.float().numpy(), np.asarray(jk, np.float32)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Bz,S,H,P,N,chunk", SWEEP)
def test_final_state_matches_sequential_oracle(jax_ssd, dtype, Bz, S, H, P,
                                               N, chunk):
    arrs = _inputs(Bz, S, H, P, N, dtype, seed=1)
    jy, jh = jax_ssd["oracle"](*(jax_ssd["asarray"](a) for a in arrs))
    y, h = ssd_scan(*_torch(arrs), chunk=chunk, out_dtype=torch.float32,
                    return_state=True)
    assert h.shape == (Bz, H, P, N) and h.dtype == torch.float32
    assert _rel(h.numpy(), jh) < TOL[dtype]
    assert _rel(y.numpy(), jy) < TOL[dtype]
    # the port's own oracle is the reference's, step for step
    oy, oh = ssd_ref(*_torch(arrs))
    assert _rel(oy.numpy(), jy) < 1e-5 and _rel(oh.numpy(), jh) < 1e-5


@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_ops_ssd_on_cpu(jax_ssd, impl):
    """``ops.ssd``: "ref" against ``repro.kernels.ops.ssd(impl="ref")``,
    the sequential oracle on both sides; "auto" runs the plain version on
    CPU tensors, held against the reference's Pallas kernel in interpret
    mode (called directly: the reference's ``ops.ssd`` cannot reach it —
    inside ``def ssd`` the name ``ssd`` is the function, not the kernel
    module, so impl="interpret" raises AttributeError there)."""
    arrs = _inputs(1, 128, 2, 64, 32, "f32", seed=2)
    ja = [jax_ssd["asarray"](a) for a in arrs]
    ref = (jax_ssd["ops"].ssd(*ja, chunk=64, impl="ref") if impl == "ref"
           else jax_ssd["kernel"](*ja, chunk=64))
    out = ops.ssd(*_torch(arrs), chunk=64, impl=impl)
    assert out.dtype == torch.float32
    assert _rel(out.numpy(), ref) < TOL["f32"]
    with pytest.raises(ValueError, match="impl"):
        ops.ssd(*_torch(arrs), chunk=64, impl="interpret")


def test_raises_where_the_reference_asserts():
    x, dt, A, B, C = _torch(_inputs(1, 96, 2, 16, 8, "f32"))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(x, dt, A, B, C, chunk=64)           # 96 % 64 != 0
    assert ssd_scan(x, dt, A, B, C, chunk=32).shape == x.shape
    assert ssd_scan(x, dt, A, B, C, chunk=256).shape == x.shape   # Q = S
    with pytest.raises(ValueError, match="n_groups"):
        ssd_scan(x, dt, A, B[:, :, None].expand(1, 96, 2, 8),
                 C[:, :, None].expand(1, 96, 2, 8), chunk=32)
    with pytest.raises(TypeError):
        ssd_scan(x, dt, A, B.to(torch.bfloat16), C, chunk=32)


def test_model_dtypes_on_cpu():
    """The model path's types: bf16 x/B/C, f32 dt, y in f32 with the final
    state, against the same call in f32 (the bf16 inputs upcast once)."""
    x, dt, A, B, C = _torch(_inputs(2, 64, 4, 64, 16, "bf16", seed=3,
                                    dt_dtype="f32"))
    y, h = ssd_scan(x, dt, A, B, C, chunk=32, out_dtype=torch.float32,
                    return_state=True)
    y32, h32 = ssd_chunked_ref(x.float(), dt, A, B.float(), C.float(), 32)
    assert y.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(h, h32)


def test_route_must_be_known():
    x, dt, A, B, C = _torch(_inputs(1, 64, 2, 16, 8, "f32"))
    with pytest.raises(ValueError, match="route"):
        ssd_scan(x, dt, A, B, C, chunk=32, route="wgmma")


# ---------------------------------------------------------------------------
# What the tc route computes, emulated on the CPU
# ---------------------------------------------------------------------------

def _bf(t):
    return t.to(torch.bfloat16).float()


def _terms(t, two: bool):
    hi = _bf(t)
    return (hi, _bf(t - hi)) if two else (hi,)


def _emulate_tc(x, dt, A, B, C, chunk, *, scores2=True, update2=True,
                state2=True):
    """The tc kernel's rounding points: C.B^T from bf16 operands with f32
    sums (exact products); the scores C.B^T exp(cum_q - cum_p) dt_p, the
    update's x_p w_p and the carried state each split into bf16 hi + lo
    (``*2=False``: rounded once to bf16 instead); the state kept between
    chunks as hi + lo + lo2. Returns y and the final state, f32."""
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    xf, Bf, Cf = x.float(), B.float(), C.float()
    h = torch.zeros(Bz, H, P, N)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    ys = []
    for c0 in range(0, S, Q):
        xc, Bc, Cc = xf[:, c0:c0 + Q], Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]
        dc = dt[:, c0:c0 + Q].float()
        cum = torch.cumsum(dc * A, dim=1)                       # (Bz,Q,H)
        CB = torch.einsum("bqn,bpn->bqp", Cc, Bc)
        L = torch.where(causal[None, :, :, None],
                        torch.exp(cum[:, :, None] - cum[:, None]), 0.0)
        sc = CB[..., None] * L * dc[:, None]                    # (Bz,Qq,Qp,H)
        y = sum(torch.einsum("bqph,bphv->bqhv", s, xc)
                for s in _terms(sc, scores2))
        y = y + torch.exp(cum)[..., None] * sum(
            torch.einsum("bqn,bhvn->bqhv", Cc, t) for t in _terms(h, state2))
        xw = xc * (torch.exp(cum[:, -1:] - cum) * dc)[..., None]
        h = torch.exp(cum[:, -1])[..., None, None] * h + sum(
            torch.einsum("bqhv,bqn->bhvn", t, Bc)
            for t in _terms(xw, update2))
        if c0 + Q < S:                                          # stored
            hi = _bf(h)
            lo = _bf(h - hi)
            h = (hi + lo) + _bf(h - hi - lo)
        ys.append(y)
    return torch.cat(ys, 1), h


@pytest.mark.parametrize("single", [None, "scores2", "update2", "state2"])
def test_tc_rounding_emulation(single):
    """At (1, 512, 16, 64, 128, 256), two chunks: the two-term operands hold
    the f32 contract (3e-4) on y and h against ``ssd_chunked_ref``; rounding
    any one of the three f32 operands once to bf16 breaks it (y errors
    ~3e-3 / 8e-4 / 5e-4, and h ~2e-3 for the update)."""
    args = _model_inputs("cpu", 1, 512, 16, 64, 128, seed=0)
    ry, rh = ssd_chunked_ref(*args, 256)
    y, h = _emulate_tc(*args, 256, **({single: False} if single else {}))
    ey, eh = _rel(y, ry), _rel(h, rh)
    if single is None:
        assert ey < 3e-5 and eh < 3e-5, (ey, eh)
    else:
        assert max(ey, eh) > TOL["f32"], (single, ey, eh)


# (Bz, S, H, P, N, chunk), dtype -> (route, G, R, blocks) on 132 SMs
PLANS = [
    ((4, 512, 64, 64, 128, 256), "bf16", ("tc", 2, 1, 128)),   # mamba2-1.3b
    ((4, 192, 64, 64, 128, 256), "bf16", ("tc", 2, 1, 128)),   # Q = S = 192
    ((1, 512, 64, 64, 128, 256), "bf16", ("tc", 1, 2, 128)),   # batch 1
    ((1, 4096, 64, 64, 128, 256), "bf16", ("tc", 1, 2, 128)),
    ((2, 512, 64, 64, 128, 256), "bf16", ("tc", 1, 1, 128)),
    ((4, 512, 112, 64, 64, 256), "bf16", ("tc", 2, 1, 224)),   # zamba2-7b
    ((1, 200, 3, 64, 128, 100), "bf16", ("tc", 1, 2, 6)),      # H odd
    ((1, 40, 2, 64, 64, 256), "bf16", ("tc", 1, 1, 2)),        # one tile
    ((2, 256, 4, 64, 64, 128), "bf16", ("tc", 1, 2, 16)),      # the sweep
    ((4, 512, 64, 64, 128, 256), "f32", ("simt", 1, 1, 256)),  # f32
    ((1, 128, 2, 64, 32, 64), "bf16", ("simt", 1, 1, 2)),      # N 32
    ((1, 192, 2, 32, 16, 64), "bf16", ("simt", 1, 1, 2)),      # P 32, N 16
    ((1, 192, 2, 32, 16, 192), "bf16", ("simt", 1, 1, 2)),     # Q 192
]


@pytest.mark.parametrize("shape,dtype,want", PLANS)
def test_plan_goes_by_shapes_alone(shape, dtype, want):
    """The plan reads shapes, dtype and the SM count, never a tensor: two
    heads a block where that leaves about one block an SM, two blocks a
    head where one would leave half the card idle."""
    Bz, S, H, P, N, chunk = shape
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    plan = _plan((Bz, S, H, P, N, min(chunk, S), dt), 132)
    assert tuple(plan) == want


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the sweep's shapes and the edges each route masks itself (Q = S < 64, a
# ragged last tile, an odd head count), with the routes that take each
CUDA_SHAPES = SWEEP + [(1, 7, 2, 8, 4, 256),           # Q = S, ragged tile
                       (1, 200, 3, 16, 24, 100),
                       (1, 40, 2, 64, 64, 256),         # tc: one short tile
                       (1, 200, 3, 64, 128, 100)]       # tc: ragged, H odd
ROUTE_CASES = [(shape, route) for shape in CUDA_SHAPES
               for route in ("tc", "simt")
               if route == "simt" or _plan((*shape[:5], min(shape[5], shape[1]),
                                            torch.bfloat16), 132).route == "tc"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Bz,S,H,P,N,chunk", CUDA_SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, dtype, Bz, S, H, P, N,
                                   chunk):
    x, dt, A, B, C = (torch.from_numpy(a).to(cuda_device)
                      for a in _np_inputs(Bz, S, H, P, N))
    x, dt, B, C = (t.to(dtype) for t in (x, dt, B, C))
    launches = ssd_scan.launches
    y, h = ssd_scan(x, dt, A, B, C, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == launches + 1
    ry, rh = ssd_chunked_ref(x, dt, A, B, C, chunk)
    tol = 3e-4 if dtype == torch.float32 else 6e-2
    assert y.dtype == dtype
    assert _rel(y.float().cpu(), ry.to(dtype).float().cpu()) < tol
    assert _rel(h.cpu(), rh.cpu()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", ROUTE_CASES,
                         ids=[f"{r}-{'x'.join(map(str, s))}"
                              for s, r in ROUTE_CASES])
def test_cuda_every_route_bf16(cuda_device, shape, route):
    """Every route, forced through the wrapper, in bf16 over the sweep and
    the edges (6e-2, y in bf16); the route's count moves by one."""
    Bz, S, H, P, N, chunk = shape
    args = _model_inputs(cuda_device, Bz, S, H, P, N, seed=5)
    before = dict(ssd_scan.routes)
    y, h = ssd_scan(*args, chunk=chunk, return_state=True, route=route)
    torch.cuda.synchronize()
    assert ssd_scan.routes[route] == before[route] + 1
    ry, rh = ssd_chunked_ref(*args, chunk)
    assert _rel(y.float().cpu(), ry.to(y.dtype).float().cpu()) < 6e-2
    assert _rel(h.cpu(), rh.cpu()) < 6e-2


def _model_check(dev, shape, seed, dt_scale=1.0):
    """The model path's call on the tc route: y f32 and h within 3e-4 of
    the plain version, all finite."""
    Bz, S, H, P, N, chunk = shape
    args = _model_inputs(dev, Bz, S, H, P, N, seed=seed, dt_scale=dt_scale)
    tc = ssd_scan.routes["tc"]
    y, h = ssd_scan(*args, chunk=chunk, out_dtype=torch.float32,
                    return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.routes["tc"] == tc + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    ry, rh = ssd_chunked_ref(*args, chunk)
    assert _rel(y.cpu(), ry.cpu()) < 3e-4 and _rel(h.cpu(), rh.cpu()) < 3e-4


@pytest.mark.cuda
@pytest.mark.parametrize("S", [512, 192])
def test_cuda_kernel_model_shapes(cuda_device, S):
    """mamba2-1.3b's scan: H=64, P=64, N=128, chunk 256, bf16 x/B/C, f32
    dt, y in f32 plus the final state, on the tc route."""
    _model_check(cuda_device, (4, S, 64, 64, 128, 256), seed=S)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 512, 64, 64, 128, 256),
                                   (1, 4096, 64, 64, 128, 256),
                                   (4, 512, 112, 64, 64, 256)],
                         ids=["batch1", "long4096", "zamba2"])
def test_cuda_tc_batch1_long_and_zamba2(cuda_device, shape):
    """Batch 1 (two blocks a head), 16 chunks carried, and zamba2-7b's
    width (H 112, N 64), at the f32 contract."""
    _model_check(cuda_device, shape, seed=7)


@pytest.mark.cuda
def test_cuda_tc_strong_decay(cuda_device):
    """dt x 10: exp(cum) underflows along the chunk; no NaN or inf, and
    the f32 contract holds."""
    _model_check(cuda_device, (4, 512, 64, 64, 128, 256), seed=9,
                 dt_scale=10.0)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

def _grads(fn, args, gy, gh):
    ins = [a.detach().clone().requires_grad_() for a in args]
    y, h = fn(*ins)
    return y, torch.autograd.grad((y, h), ins, (gy.to(y.dtype), gh))


def test_plain_gradient_is_finite_where_the_reference_is_nan():
    """One 256-step chunk with dt = 0.7 and A = -1 (mamba2's own init): the
    masked entries' exp(seg) passes e^88. The reference's gradient for dt
    and A is NaN there; the port's plain version masks before the exp and
    its gradient equals the sequential oracle's (3e-4)."""
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked as j_ssd_chunked
    r = np.random.default_rng(0)
    x = r.standard_normal((1, 256, 2, 4)).astype(np.float32)
    dt = np.full((1, 256, 2), 0.7, np.float32)
    A = np.array([-1.0, -0.5], np.float32)
    B = (r.standard_normal((1, 256, 4)) * 0.3).astype(np.float32)
    C = (r.standard_normal((1, 256, 4)) * 0.3).astype(np.float32)
    jg = jax.grad(lambda *a: j_ssd_chunked(*a, 256)[0].sum(),
                  argnums=(1, 2))(*map(jnp.asarray, (x, dt, A, B, C)))
    assert all(bool(jnp.isnan(g).any()) for g in jg)          # the fault
    args = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    gy, gh = torch.ones(1, 256, 2, 4), torch.zeros(1, 2, 4, 4)
    _, got = _grads(lambda *a: ssd_chunked_ref(*a, 256), args, gy, gh)
    _, want = _grads(ssd_ref, args, gy, gh)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) < TOL["f32"]


def test_autograd_wrapper_backward_is_the_plain_gradient(monkeypatch):
    """``_SsdScanFn`` with the launch replaced by a counting stand-in (the
    plain version): its gradients equal native autograd's through the plain
    version, and it launches once, in the forward pass."""
    import repro_torch.kernels.ssd_scan as mod
    calls = []

    def fake_launch(x, dt, A, B, C, chunk, out_dtype, return_state, route):
        calls.append(1)
        y, h = ssd_chunked_ref(x, dt, A, B, C, chunk)
        return y.to(out_dtype), h

    monkeypatch.setattr(mod, "_launch", fake_launch)
    args = _model_inputs("cpu", 2, 128, 2, 64, 32, dtype=torch.float32)
    gy = torch.randn(2, 128, 2, 64, generator=torch.Generator().manual_seed(1))
    gh = torch.randn(2, 2, 64, 32, generator=torch.Generator().manual_seed(2))
    fn = lambda *a: mod._SsdScanFn.apply(*a, 64, torch.float32, None)
    y, got = _grads(fn, args, gy, gh)
    assert calls == [1] and y.grad_fn is not None
    _, want = _grads(lambda *a: ssd_chunked_ref(*a, 64), args, gy, gh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Bz,S,H,P,N,chunk", CUDA_SHAPES)
def test_cuda_autograd_gradients_match_plain(cuda_device, dtype, Bz, S, H,
                                             P, N, chunk):
    """Through the kernel's autograd wrapper: y and the gradients of x, dt,
    A, B and C within the SSD bounds (3e-4 f32, 6e-2 bf16) of the plain
    version's on the card; one forward launch each. Control: the raw
    launch returns y without a grad_fn."""
    from repro_torch.kernels.ssd_scan import _launch
    args = _model_inputs(cuda_device, Bz, S, H, P, N, seed=3, dtype=dtype)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    gy = torch.randn(Bz, S, H, P, device=cuda_device, generator=g)
    gh = torch.randn(Bz, H, P, N, device=cuda_device, generator=g)
    launches = ssd_scan.launches
    y, got = _grads(lambda *a: ssd_scan(*a, chunk=chunk, return_state=True,
                                        out_dtype=torch.float32),
                    args, gy, gh)
    torch.cuda.synchronize()
    assert ssd_scan.launches == launches + 1 and y.grad_fn is not None
    ry, want = _grads(lambda *a: ssd_chunked_ref(*a, chunk), args, gy, gh)
    tol = TOL["f32"] if dtype == torch.float32 else TOL["bf16"]
    assert _rel(y.detach().cpu(), ry.detach().cpu()) < tol
    for name, a, b in zip("x dt A B C".split(), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a.float().cpu(), b.float().cpu()) < tol, name
    raw, _ = _launch(*(a.detach().requires_grad_() for a in args), chunk,
                     torch.float32, True, None)
    assert raw.grad_fn is None and not raw.requires_grad


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype,out_dtype", [("f32", None),
                                             ("bf16", torch.float32)])
def test_meta_call_takes_the_plain_version(dtype, out_dtype, state):
    """On ``meta`` tensors (the dry run's) the wrapper returns the plain
    version's shapes and dtypes and launches nothing."""
    args = _torch(_inputs(2, 128, 4, 64, 16, dtype, dt_dtype="f32"))
    want = ssd_scan(*args, chunk=64, out_dtype=out_dtype,
                    return_state=state)
    launches, routes = ssd_scan.launches, dict(ssd_scan.routes)
    got = ssd_scan(*(t.to("meta") for t in args), chunk=64,
                   out_dtype=out_dtype, return_state=state)
    want, got = (want, got) if state else ((want,), (got,))
    for w, g in zip(want, got):
        assert g.device.type == "meta"
        assert g.shape == w.shape and g.dtype == w.dtype
    assert ssd_scan.launches == launches and ssd_scan.routes == routes
