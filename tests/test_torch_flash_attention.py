"""The port's flash attention against the reference's.

On the CPU the port's wrapper ``flash_attention`` (and ``ops.attention``
with ``impl="auto"``) runs its plain version ``attention_ref``, which must
agree with the reference's Pallas kernel in interpret mode
(``flash_attention(..., interpret=True, bq=64, bk=64)``, as the reference's
own tests run it), with the reference's entry point
``repro.kernels.ops.attention(impl="interpret")``, and with the reference
oracle ``repro.kernels.ref.attention_ref``. Cases: the grid of
``tests/test_kernels.py`` (the causal sweep, the window / softcap /
non-causal variants, Dv = 32) and the edges the CUDA kernel masks itself:
Sq > Sk with a window (rows that see no key are exact zeros), Sq < Sk
(positions top-left aligned), B > 1, MQA, and every head dim of the
supported configs. Tolerances are the reference's own
(``tests/test_kernels.py``): f32 atol = rtol = 2e-5 (the same math summed in
another order), bf16 2e-2 (one bf16 rounding of the output on each side).

``_emulate_kernel`` repeats the bf16 CUDA kernel's rounding points in plain
PyTorch (bf16 q.k summed in f32, an f32 online softmax over 64-key tiles,
p split into two bf16 terms before the f32 p @ v, the output rounded once to
bf16): on the CPU it must stay within one bf16 rounding of the f32 answer
(``attention_ref`` on the bf16 inputs widened to f32; atol 1e-5, rtol
2^-8, the limit ``chip_smoke.py`` holds the kernel to), and the same
emulation with p rounded once to bf16 must not.

The ``cuda`` tests hold the CUDA kernel against the plain version on the
card, and the bf16 kernel within that one rounding of the f32 answer. JAX
is imported in fixtures, not at module level, so that the file also runs
where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

TOL = {"f32": 2e-5, "bf16": 2e-2}

# (B, H, K, Sq, Sk, D, Dv), keyword arguments
SWEEP = [(1, 4, 4, 128, 128, 64, 64),        # tests/test_kernels.py:23-28
         (2, 8, 2, 256, 256, 64, 64),
         (1, 4, 1, 128, 384, 128, 128),
         (1, 2, 2, 96, 160, 64, 64)]
VARIANTS = [dict(window=32), dict(softcap=25.0),  # tests/test_kernels.py:42
            dict(window=64, softcap=50.0), dict(causal=False)]
EDGES = [
    ("sq_gt_sk_window", (1, 2, 1, 96, 40, 64, 64), dict(window=8)),
    ("sq_lt_sk_causal", (1, 2, 2, 40, 96, 64, 64), {}),
    ("batch3", (3, 4, 2, 64, 80, 32, 32), {}),
    ("mqa", (2, 6, 1, 72, 72, 64, 64), {}),
] + [(f"D{D}", (1, 2, 1, 72, 72, D, 128 if D == 192 else D),
      dict(scale=1.0 / math.sqrt(D)) if D == 192 else {})
     for D in (64, 112, 128, 160, 192, 256)]
CASES = ([(f"sweep{i}", shape, {}) for i, shape in enumerate(SWEEP)]
         + [(f"variant{i}", (1, 4, 2, 128, 128, 64, 64), kw)
            for i, kw in enumerate(VARIANTS)]
         + [("dv32", (1, 4, 4, 128, 128, 64, 32), {})] + EDGES)
IDS = [c[0] for c in CASES]


def _arrays(shape, seed=0):
    B, H, K, Sq, Sk, D, Dv = shape
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, Sq, D), np.float32),
            r.standard_normal((B, K, Sk, D), np.float32),
            r.standard_normal((B, K, Sk, Dv), np.float32))


def _inputs(shape, dtype, seed=0):
    """q, k, v made with numpy and rounded to ``dtype`` once (bf16 via
    ml_dtypes), as numpy arrays both packages read."""
    import jax.numpy as jnp
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    return [np.asarray(jnp.asarray(a, jd)) for a in _arrays(shape, seed)]


def _torch(arrays, device="cpu"):
    from repro_torch.convert import tensor_from_numpy
    return [tensor_from_numpy(a, device) for a in arrays]


def _zero_rows(Sq, Sk, kw):
    """Rows that see no key: with a window, q >= Sk + window - 1."""
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if kw.get("causal", True):
        mask &= kp <= qp
    if kw.get("window") is not None:
        mask &= (qp - kp) < kw["window"]
    return ~mask.any(-1)


# one bf16 rounding of the output (half an ulp, 2^-9 relative, with 2x
# room) and f32 summation noise; chip_smoke.py's FLASH_RTOL, FLASH_ATOL
ONE_ROUNDING = dict(atol=1e-5, rtol=2.0 ** -8)


def _emulate_kernel(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, split=True, bk=64):
    """The bf16 kernel's rounding points in plain PyTorch: q.k of bf16
    inputs in f32 (each product exact), scale, softcap and mask in f32, an
    online softmax over ``bk``-key tiles with m, l and acc in f32, l summed
    from the f32 p, and p @ v as P_hi @ v + P_lo @ v with P_hi = bf16(p),
    P_lo = bf16(p - P_hi) (``split``; else bf16(p) @ v alone), the output
    rounded to bf16 once."""
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(H // K, dim=1)
    v = v.float().repeat_interleave(H // K, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qp = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, v.shape[-1]))
    for k0 in range(0, Sk, bk):
        kt, vt = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kt) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kp = torch.arange(k0, k0 + kt.shape[2])[None, :]
        vis = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            vis &= kp <= qp
        if window is not None:
            vis &= (qp - kp) < window
        s = torch.where(vis, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.where(l > 0, l, 1.0)).to(torch.bfloat16)


def _bf16(shape):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in _arrays(shape)]


@pytest.mark.parametrize("name,shape,kw", CASES, ids=IDS)
def test_split_p_rounding_within_one_bf16_rounding(name, shape, kw):
    """The kernel's rounding design keeps the bf16 output within one bf16
    rounding of the f32 answer; rows that see no key are exact zeros."""
    q, k, v = _bf16(shape)
    out = _emulate_kernel(q, k, v, **kw)
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(out.float(), exact, **ONE_ROUNDING)
    zero = torch.from_numpy(_zero_rows(shape[3], shape[4], kw))
    assert bool((out[:, :, zero] == 0).all())


def test_single_bf16_p_fails_one_rounding():
    """The control: p rounded once to bf16 before p @ v does not hold that
    limit where rows see hundreds of keys (sweep2: Sk 384)."""
    name, shape, kw = CASES[IDS.index("sweep2")]
    q, k, v = _bf16(shape)
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    single = _emulate_kernel(q, k, v, split=False, **kw).float()
    assert int((~torch.isclose(single, exact, **ONE_ROUNDING)).sum()) > 0


@pytest.fixture(scope="module")
def jax_fa():
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels.flash_attention import flash_attention as j_fa
    from repro.kernels.ref import attention_ref as j_ref
    static = ("causal", "window", "softcap", "scale")
    return dict(
        kernel=jax.jit(lambda q, k, v, **kw: j_fa(q, k, v, interpret=True,
                                                  bq=64, bk=64, **kw),
                       static_argnames=static),
        oracle=jax.jit(j_ref, static_argnames=static),
        ops=jops, asarray=jnp.asarray)


def _np32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=IDS)
def test_ops_attention_matches_reference_kernel(jax_fa, dtype, name, shape,
                                                kw):
    """``ops.attention`` (the plain version on CPU tensors) against the
    reference's Pallas kernel in interpret mode; rows that see no key are
    exact zeros on both sides."""
    arrs = _inputs(shape, dtype)
    ref = _np32(jax_fa["kernel"](*(jax_fa["asarray"](a) for a in arrs),
                                 **kw))
    launches = flash_attention.launches
    out = ops.attention(*_torch(arrs), **kw)
    assert flash_attention.launches == launches      # no kernel on the CPU
    assert out.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    assert out.shape == (shape[0], shape[1], shape[3], shape[6])
    got = out.float().numpy()
    np.testing.assert_allclose(got, ref, atol=TOL[dtype], rtol=TOL[dtype])
    zero = _zero_rows(shape[3], shape[4], kw)
    assert (got[:, :, zero] == 0).all() and (ref[:, :, zero] == 0).all()
    if name == "sq_gt_sk_window":
        assert zero.nonzero()[0].tolist() == list(range(47, 96))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=IDS)
def test_attention_ref_matches_reference_oracle(jax_fa, dtype, name, shape,
                                                kw):
    """The port's ``attention_ref`` is the reference's, line for line."""
    arrs = _inputs(shape, dtype, seed=1)
    ref = _np32(jax_fa["oracle"](*(jax_fa["asarray"](a) for a in arrs),
                                 **kw))
    out = attention_ref(*_torch(arrs), **kw)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SWEEP, ids=[f"sweep{i}"
                                              for i in range(len(SWEEP))])
def test_ops_attention_matches_reference_entry_point(jax_fa, dtype, shape):
    """Against ``repro.kernels.ops.attention(impl="interpret")``, the
    reference's own entry point (its Pallas kernel at bq = bk = 128)."""
    arrs = _inputs(shape, dtype, seed=2)
    ref = _np32(jax_fa["ops"].attention(
        *(jax_fa["asarray"](a) for a in arrs), impl="interpret"))
    out = ops.attention(*_torch(arrs))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_ops_attention_dispatch(jax_fa):
    """``"ref"`` is the oracle (against the reference's ``impl="ref"``),
    ``"auto"`` the wrapper; the reference's TPU impls raise here."""
    arrs = _inputs((1, 4, 2, 128, 128, 64, 64), "f32", seed=3)
    t = _torch(arrs)
    ref = _np32(jax_fa["ops"].attention(
        *(jax_fa["asarray"](a) for a in arrs), window=32, impl="ref"))
    out = ops.attention(*t, window=32, impl="ref")
    assert torch.equal(out, attention_ref(*t, window=32))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL["f32"],
                               rtol=TOL["f32"])
    assert torch.equal(ops.attention(*t, window=32),
                       flash_attention(*t, window=32))
    for impl in ("pallas", "interpret", "cuda"):
        with pytest.raises(ValueError, match="impl"):
            ops.attention(*t, impl=impl)


def test_raises_where_the_reference_asserts():
    q, k, v = (torch.from_numpy(a) for a in
               _arrays((1, 4, 2, 16, 16, 8, 8)))
    with pytest.raises(ValueError, match="H % K"):
        flash_attention(q, k[:, :1].expand(1, 3, 16, 8), v[:, :1].expand(
            1, 3, 16, 8))
    with pytest.raises(ValueError):
        flash_attention(q, k[..., :4], v)                  # D mismatch
    with pytest.raises(ValueError):
        flash_attention(q[0], k, v)                        # not 4-d
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=IDS)
def test_cuda_kernel_matches_plain(cuda_device, dtype, name, shape, kw):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _arrays(shape))
    launches = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    ref = attention_ref(q, k, v, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    zero = torch.from_numpy(_zero_rows(shape[3], shape[4], kw))
    assert bool((out[:, :, zero.to(cuda_device)] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,kw", CASES, ids=IDS)
def test_cuda_bf16_kernel_within_one_rounding(cuda_device, name, shape, kw):
    """The bf16 kernel (tensor-core products, p split in two bf16 terms)
    within one bf16 rounding of attention_ref's f32 answer for the same
    bf16 inputs, at every case of the grid."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _arrays(shape))
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(out.float(), exact, **ONE_ROUNDING)


@pytest.mark.cuda
def test_cuda_kernel_raises_on_what_it_does_not_take(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _arrays((1, 2, 2, 16, 16, 12, 12)))
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _arrays((1, 2, 2, 16, 16, 8, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=IDS)
def test_meta_call_takes_the_plain_version(dtype, name, shape, kw):
    """On ``meta`` tensors (the dry run's) the wrapper returns the plain
    version's shape and dtype and launches nothing."""
    q, k, v = _torch(_inputs(shape, dtype))
    want = attention_ref(q, k, v, **kw)
    launches = flash_attention.launches
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), **kw)
    assert out.device.type == "meta"
    assert out.shape == want.shape and out.dtype == want.dtype
    assert flash_attention.launches == launches
