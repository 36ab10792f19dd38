"""The port's primitive layers and MLP against the reference's.

Same inputs (numpy, seeded) through the reference function (eager JAX on the
CPU) and its port. Tolerances: f32 atol = rtol = 1e-5 — XLA and ATen
evaluate rsqrt, sin, cos, tanh and exp to within a few f32 ulps of each
other, not bit for bit. bf16 rtol 2**-7 (one bf16 ulp), atol 1e-6: every
op rounds to bf16 at the same points in both, so at most one rounding may
fall the other way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import mlp as jm
from repro.models.spec import MlpSpec as JMlpSpec
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import mlp as tm
from repro_torch.models.spec import MlpSpec as TMlpSpec

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-6, rtol=2 ** -7)}
DTYPES = ["float32", "bfloat16"]


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x, getattr(jnp, dtype))
    return j, tensor_from_numpy(np.asarray(j))


def _close(j, t, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("kind,eps", [("rmsnorm", 1e-6),
                                      ("layernorm", 1e-5)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_apply(kind, eps, dtype):
    r = np.random.default_rng(0)
    xj, xt = _pair(3 * r.standard_normal((2, 5, 64)), dtype)
    sj, st = _pair(1 + 0.1 * r.standard_normal(64), dtype)
    bj, bt = _pair(0.1 * r.standard_normal(64), dtype)
    out_j = jl.norm_apply({"scale": sj, "bias": bj}, xj, kind, eps)
    out_t = tl.norm_apply({"scale": st, "bias": bt}, xt, kind, eps)
    assert out_t.dtype == xt.dtype
    _close(out_j, out_t, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_rmsnorm(dtype):
    r = np.random.default_rng(1)
    xj, xt = _pair(r.standard_normal((2, 5, 4, 16)), dtype)
    sj, st = _pair(1 + 0.1 * r.standard_normal(16), dtype)
    _close(jl.head_rmsnorm(sj, xj), tl.head_rmsnorm(st, xt), dtype)


@pytest.mark.parametrize("rope_pct,theta", [(1.0, 1_000_000.0),
                                            (0.25, 10_000.0),
                                            (0.5, 10_000.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_interleaved_pairs_and_partial(rope_pct, theta, dtype):
    r = np.random.default_rng(2)
    xj, xt = _pair(r.standard_normal((2, 6, 4, 32)), dtype)
    pos = np.stack([np.arange(6), 1000 + np.arange(6)]).astype(np.int32)
    pos[1, -1] = -1                                     # a pad row's position
    out_j = jl.apply_rope(xj, jnp.asarray(pos), theta, rope_pct)
    out_t = tl.apply_rope(xt, torch.from_numpy(pos), theta, rope_pct)
    _close(out_j, out_t, dtype)
    rot = int(32 * rope_pct)
    # the non-rotating tail passes through untouched
    assert torch.equal(out_t[..., rot:], xt[..., rot:])


def test_apply_rope_without_head_axis():
    r = np.random.default_rng(3)
    xj, xt = _pair(r.standard_normal((2, 6, 8)), "float32")
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    _close(jl.apply_rope(xj, jnp.asarray(pos), 10_000.0),
           tl.apply_rope(xt, torch.from_numpy(pos), 10_000.0), "float32")


@pytest.mark.parametrize("gated,activation,bias",
                         [(True, "silu", False), (True, "gelu", False),
                          (False, "gelu", True)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_apply(gated, activation, bias, dtype):
    r = np.random.default_rng(4)
    d, f = 32, 64
    xj, xt = _pair(r.standard_normal((2, 5, d)), dtype)
    names = ["w_up", "w_down"] + (["w_gate"] if gated else [])
    shapes = {"w_up": (d, f), "w_gate": (d, f), "w_down": (f, d),
              "b_up": (f,), "b_down": (d,)}
    names += ["b_up", "b_down"] if bias else []
    pj, pt = {}, {}
    for n in names:
        pj[n], pt[n] = _pair(r.standard_normal(shapes[n])
                             / np.sqrt(shapes[n][0]), dtype)
    out_j = jm.mlp_apply(pj, xj, JMlpSpec(f, activation, gated))
    out_t = tm.mlp_apply(pt, xt, TMlpSpec(f, activation, gated))
    _close(out_j, out_t, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_lookup_logits_softcap(dtype):
    r = np.random.default_rng(5)
    ej, et = _pair(0.02 * r.standard_normal((50, 16)), dtype)
    toks = r.integers(0, 50, (2, 7)).astype(np.int32)
    hj = jl.embed_lookup({"embedding": ej}, jnp.asarray(toks))
    ht = tl.embed_lookup({"embedding": et}, torch.from_numpy(toks))
    assert torch.equal(ht.float(),
                       torch.from_numpy(np.array(hj, np.float32)))
    hj, ht = _pair(r.standard_normal((2, 7, 16)), dtype)
    _close(jl.embed_logits({"embedding": ej}, hj),
           tl.embed_logits({"embedding": et}, ht), dtype)
    xj, xt = _pair(40 * r.standard_normal((3, 9)), "float32")
    _close(jl.softcap(xj, 30.0), tl.softcap(xt, 30.0), "float32")


def test_init_draws_are_seeded_and_shaped():
    gen = torch.Generator().manual_seed(7)
    a = tl.fan_in_init(gen, (256, 64), 256, torch.bfloat16, "cpu")
    gen = torch.Generator().manual_seed(7)
    b = tl.fan_in_init(gen, (256, 64), 256, torch.bfloat16, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.bfloat16
    # the reference's std (draws differ: torch.Generator is not jax.random)
    ref = jl.fan_in_init(jax.random.PRNGKey(0), (256, 64), 256, jnp.float32)
    assert abs(float(a.float().std()) - float(np.std(ref))) < 0.01
