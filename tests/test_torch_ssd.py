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

The ``cuda`` tests hold the CUDA kernel against the plain version on the
card, at the sweep and at the model's own shapes (bf16 x/B/C, f32 dt, y in
f32 with the final state). JAX is imported in fixtures, not at module
level, so that the file also runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_ssd.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_chunked_ref, ssd_ref, ssd_scan

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


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _np_inputs(Bz, S, H, P, N, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((Bz, S, H, P), np.float32),
            np.logaddexp(r.standard_normal((Bz, S, H), np.float32), 0),
            -np.exp(0.3 * r.standard_normal((H,), np.float32)),
            r.standard_normal((Bz, S, N), np.float32),
            r.standard_normal((Bz, S, N), np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Bz,S,H,P,N,chunk",
                         SWEEP + [(1, 7, 2, 8, 4, 256),   # Q = S, ragged tile
                                  (1, 200, 3, 16, 24, 100)])
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
@pytest.mark.parametrize("S", [512, 192])
def test_cuda_kernel_model_shapes(cuda_device, S):
    """mamba2-1.3b's scan: H=64, P=64, N=128, chunk 256, bf16 x/B/C, f32
    dt, y in f32 plus the final state."""
    x, dt, A, B, C = (torch.from_numpy(a).to(cuda_device)
                      for a in _np_inputs(4, S, 64, 64, 128, seed=S))
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    y, h = ssd_scan(x, dt, A, B, C, chunk=256, out_dtype=torch.float32,
                    return_state=True)
    torch.cuda.synchronize()
    ry, rh = ssd_chunked_ref(x, dt, A, B, C, 256)
    assert _rel(y.cpu(), ry.cpu()) < 3e-4 and _rel(h.cpu(), rh.cpu()) < 3e-4
