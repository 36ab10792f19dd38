"""The port's paged attention against the reference's.

On the CPU the port's wrapper runs its plain version, which must agree with
the reference's Pallas kernel (interpret mode, ``block_q=8``, as the
reference's own tests run it) and with the reference oracle
``paged_attention_ref`` over the case grid of
``tests/test_paged_attention.py``. Tolerance: f32 atol = rtol = 2e-5, the
reference's own contract — the same math, summed in another order.

The ``cuda`` tests hold the CUDA kernel against the plain version on the
card (f32 2e-5; bf16 atol 2e-2, rtol 1e-2: one bf16 rounding of the output
on each side). JAX is imported in a fixture, not at module level, so that
the file also runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_paged_attention.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

ATOL = RTOL = 2e-5


def _mk(seed, B=2, S=1, H=4, K=2, Dk=16, Dv=16, P=12, ps=4, npps=4,
        filled=None, permute=True, q2dim=None):
    """Random paged-attention problem with a fragmented, permuted pool
    (numpy; the same generator as the reference test's ``_mk``)."""
    r = np.random.default_rng(seed)
    k = r.standard_normal((P, ps, K, Dk), np.float32)
    v = r.standard_normal((P, ps, K, Dv), np.float32)
    order = r.permutation(P) if permute else np.arange(P)
    tables = np.full((B, npps), -1, np.int32)
    kpos = np.full((P, ps), -1, np.int32)
    filled = [npps] * B if filled is None else filled
    n = 0
    for b in range(B):
        for j in range(filled[b]):
            pg = order[n]
            n += 1
            tables[b, j] = pg
            kpos[pg] = j * ps + np.arange(ps)
    hist = np.asarray([f * ps for f in filled])
    q_pos = (hist[:, None] - 1 + np.arange(S)[None]).astype(np.int32)
    q = r.standard_normal((B, S, H, Dk), np.float32)
    q2 = k2 = None
    if q2dim:
        q2 = r.standard_normal((B, S, H, q2dim), np.float32)
        k2 = r.standard_normal((P, ps, K, q2dim), np.float32)
    return dict(q=q, k=k, v=v, kpos=kpos, tables=tables, q_pos=q_pos,
                q2=q2, k2=k2)


def _ragged():
    a = _mk(4, B=3, S=8, filled=[4, 2, 3])
    a["q_pos"][1, 5:] = -1                       # row 1: 5 real query rows
    return a


# (name, problem, keyword args) — the grid of tests/test_paged_attention.py
CASES = [
    *[(f"ps{ps}", lambda ps=ps, n=n: _mk(0, P=16, ps=ps, npps=n), {})
      for ps, n in [(2, 6), (4, 4), (8, 2)]],
    *[(f"H{H}K{K}", lambda H=H, K=K: _mk(1, H=H, K=K), {})
      for H, K in [(4, 4), (4, 2), (4, 1)]],
    ("window_softcap", lambda: _mk(2), dict(window=6, softcap=30.0)),
    ("mla_two_component", lambda: _mk(3, K=1, H=4, q2dim=8),
     dict(scale=1.0 / math.sqrt(16 + 8))),
    ("prefill_ragged_padded", _ragged, {}),
    ("partial_tables_full_pool",
     lambda: _mk(5, B=4, P=12, npps=4, filled=[4, 0, 3, 4]), {}),
]
IDS = [c[0] for c in CASES]


def _torch_args(a, device="cpu", dtype=torch.float32):
    out = {}
    for name, x in a.items():
        if x is None:
            out[name] = None
        elif x.dtype == np.int32:
            out[name] = torch.from_numpy(x).to(device)
        else:
            out[name] = torch.from_numpy(x).to(device=device, dtype=dtype)
    return out


def _call(fn, a, **kw):
    return fn(a["q"], a["k"], a["v"], a["kpos"], a["tables"], a["q_pos"],
              q2=a["q2"], k2=a["k2"], **kw)


@pytest.fixture(scope="module")
def jax_paged():
    """The reference kernel (interpret mode) and oracle, imported here so
    the module itself imports without JAX."""
    import jax.numpy as jnp
    from repro.kernels.paged_attention import paged_attention as jpa
    from repro.kernels.ref import paged_attention_ref as jref

    def run(a, **kw):
        j = {k: (jnp.asarray(x) if x is not None else None)
             for k, x in a.items()}
        kern = _call(jpa, j, interpret=True, block_q=8, **kw)
        ref = _call(jref, j, **kw)
        return np.asarray(kern), np.asarray(ref)

    return run


@pytest.mark.parametrize("name,make,kw", CASES, ids=IDS)
def test_plain_matches_reference_kernel_and_oracle(jax_paged, name, make, kw):
    a = make()
    j_kern, j_ref = jax_paged(a, **kw)
    launches = paged_attention.launches
    out = _call(paged_attention, _torch_args(a), **kw).numpy()
    assert paged_attention.launches == launches    # the CPU never launches
    np.testing.assert_allclose(out, j_kern, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, j_ref, atol=ATOL, rtol=RTOL)
    if name == "prefill_ragged_padded":
        assert np.all(out[1, 5:] == 0.0)          # pad query rows -> zeros
    if name == "partial_tables_full_pool":
        assert np.all(out[1] == 0.0)              # dead slot -> zeros


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = _torch_args(_mk(0))
    with pytest.raises(TypeError):                # mixed float dtypes
        paged_attention(a["q"].double(), a["k"], a["v"], a["kpos"],
                        a["tables"], a["q_pos"])
    with pytest.raises(TypeError):                # int64 table
        paged_attention(a["q"], a["k"], a["v"], a["kpos"],
                        a["tables"].long(), a["q_pos"])
    with pytest.raises(ValueError):               # non-contiguous q
        paged_attention(a["q"].transpose(1, 2), a["k"], a["v"], a["kpos"],
                        a["tables"], a["q_pos"])
    with pytest.raises(ValueError):               # H % K != 0
        paged_attention(a["q"][:, :, :3].contiguous(), a["k"], a["v"],
                        a["kpos"], a["tables"], a["q_pos"])
    with pytest.raises(ValueError):               # q2 without k2
        paged_attention(a["q"], a["k"], a["v"], a["kpos"], a["tables"],
                        a["q_pos"], q2=a["q"])


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
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 2e-2, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,make,kw", CASES, ids=IDS)
def test_cuda_kernel_matches_plain(cuda_device, dtype, atol, rtol, name,
                                   make, kw):
    a = _torch_args(make(), cuda_device, dtype)
    launches = paged_attention.launches
    out = _call(paged_attention, a, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == launches + 1
    ref = _call(paged_attention_ref, a, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    if name == "prefill_ragged_padded":
        assert bool((out[1, 5:] == 0).all())
    if name == "partial_tables_full_pool":
        assert bool((out[1] == 0).all())
