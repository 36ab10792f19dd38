"""The port's GPipe schedule (``repro_torch.runtime.pipeline``) on the CPU:
``pipeline_apply`` over a mesh listing the CPU once a stage against the
port's ``reference_apply`` and the reference's (``repro.runtime.pipeline``),
in f32 (atol 1e-6), with gradients through autograd against the sequential
oracle's and ``jax.grad`` of the reference's; and the model's own blocks as
stages (two of a smoke config's layers a stage, dense and SSM), as the card
runs them in ``chip_smoke.py``'s ``[pipeline]``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.pipeline import pipeline_apply as j_pipeline_apply
from repro.runtime.pipeline import reference_apply as j_reference_apply
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models.blocks import block_apply, tree_map
from repro_torch.runtime.pipeline import pipeline_apply, reference_apply

torch.set_num_threads(1)

ATOL = 1e-6
CPU = torch.device("cpu")


def stage_fn(p, x):
    return torch.tanh(x @ p["w"]) + x


def j_stage_fn(p, x):
    return jnp.tanh(x @ p["w"]) + x


def stages(n, axis="pod"):
    return Mesh([CPU] * n, (axis,))


def problem(S, D=16, B=8, seed=0):
    r = np.random.default_rng(seed)
    w = (0.3 * r.standard_normal((S, D, D))).astype(np.float32)
    x = r.standard_normal((B, D)).astype(np.float32)
    return w, x


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("M", [1, 2, 4, 8])
def test_pipeline_matches_sequential_and_the_reference(S, M):
    w, x = problem(S)
    params = {"w": torch.from_numpy(w)}
    out = pipeline_apply(stage_fn, params, torch.from_numpy(x), stages(S),
                         axis="pod", microbatches=M)
    ref = reference_apply(stage_fn, params, torch.from_numpy(x))
    jref = j_reference_apply(j_stage_fn, {"w": jnp.asarray(w)},
                             jnp.asarray(x))
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), rtol=0,
                               atol=ATOL)


def test_one_stage_pipeline_equals_the_references_spmd_schedule():
    """On one device the reference's shard_map schedule runs too."""
    w, x = problem(1)
    jmesh = jax.make_mesh((1,), ("pod",))
    jout = j_pipeline_apply(j_stage_fn, {"w": jnp.asarray(w)},
                            jnp.asarray(x), jmesh, axis="pod",
                            microbatches=4)
    out = pipeline_apply(stage_fn, {"w": torch.from_numpy(w)},
                         torch.from_numpy(x), stages(1), microbatches=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)


def test_schedule_takes_m_plus_s_minus_1_ticks_and_skips_the_bubble():
    """Each stage sees each microbatch once, in order; stage 0 takes
    microbatch t at tick t and the last stage emits t - (S-1)."""
    S, M = 3, 4
    calls = []

    def traced(p, x):
        calls.append((int(p["id"]), int(x[0, 0])))
        return x + 100

    params = {"id": torch.arange(S)}
    x = torch.arange(M, dtype=torch.float32).repeat_interleave(2)[:, None]
    out = pipeline_apply(traced, params, x, stages(S), microbatches=M)
    assert torch.equal(out, x + 100 * S)
    assert len(calls) == S * M                  # no call on a bubble
    # tick by tick: (stage, microbatch) pairs with stage + microbatch = t
    ticks = {}
    for s, v in calls:
        mb = int(v) % 100
        ticks.setdefault(s + mb, []).append(s)
    assert sorted(ticks) == list(range(M + S - 1))


@pytest.mark.parametrize("S,M", [(2, 2), (4, 4)])
def test_gradients_flow_and_match(S, M):
    w, x = problem(S, D=8, B=2 * M, seed=1)
    jgrad = jax.grad(lambda p: jnp.sum(j_reference_apply(
        j_stage_fn, p, jnp.asarray(x)) ** 2))({"w": jnp.asarray(w)})["w"]
    grads = []
    for run in (lambda p: pipeline_apply(stage_fn, p, torch.from_numpy(x),
                                         stages(S), microbatches=M),
                lambda p: reference_apply(stage_fn, p, torch.from_numpy(x))):
        p = {"w": torch.from_numpy(w).requires_grad_()}
        (run(p) ** 2).sum().backward()
        grads.append(p["w"].grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(grads[0], np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(grads[0]).sum() > 0


def model_stages(arch, S, per=2):
    """S stages of ``per`` of a smoke config's layers each: the first group's
    stacked params, restacked (S, per, ...), in f32."""
    cfg = get_config(arch, smoke=True)
    g = cfg.groups[0]
    per = min(per, g.repeats // S) or 1
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    stacked = params["groups"][0]["stacked"]
    pat = g.pattern

    def restack(a):
        a = a[:S * per].float()
        return a.reshape((S, per) + tuple(a.shape[1:]))
    params = tree_map(restack, stacked)

    def fn(p, x):
        pos = torch.arange(x.shape[1], dtype=torch.int32)[None].expand(
            x.shape[:2])
        for r in range(per):
            for i, b in enumerate(pat):
                lp = tree_map(lambda a: a[r], p[str(i)])
                x, _ = block_apply(lp, x, b, cfg, pos)
        return x
    return cfg, params, fn


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b"])
def test_model_blocks_as_stages(arch):
    cfg, params, fn = model_stages(arch, S=2, per=1)
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.standard_normal((4, 64, cfg.d_model)).astype(
        np.float32))
    out = pipeline_apply(fn, params, x, stages(2), microbatches=4)
    ref = reference_apply(fn, params, x)
    scale = float(ref.abs().max())
    assert out.shape == x.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * scale)
