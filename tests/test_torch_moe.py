"""The port's MoE layer against the reference's (eager JAX), on the CPU.

The router's decisions are held EQUAL to the reference's: the chosen
experts, each choice's kept queue slot (C = dropped) and the dispatch mask,
read out of the reference's own ``moe_apply`` (its ``jax.nn.one_hot`` and
``jnp.einsum`` calls are recorded while it runs eagerly). Drops are forced
with a small ``capacity_factor``, over one token group and several, with
shared experts on (deepseek-v2-smoke's ``MoeSpec``) and off
(olmoe-1b-7b-smoke's). ``y`` and ``aux`` are held within the tolerances of
``tests/test_torch_layers.py``: f32 inputs to f32 TOL, and bf16 inputs to
the bf16 TOL where every expert product rounds once in both packages.
Ties: ``jax.lax.top_k`` puts the lower index first, and so must the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import moe as jm
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import moe as tm
from test_torch_layers import TOL

# one intra-op thread: the suite runs many test processes side by side
torch.set_num_threads(1)


def _spec(arch, pkg_get):
    cfg = pkg_get(arch, smoke=True)
    return cfg, next(b.moe for g in cfg.groups for b in g.pattern
                     if b.moe is not None)


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0])
@pytest.mark.parametrize("E,k", [(8, 2), (64, 8), (160, 6)])
@pytest.mark.parametrize("tokens", [1, 3, 24, 160, 512, 4096])
def test_capacity_matches_reference(tokens, E, k, factor):
    from repro.models.spec import MoeSpec as JSpec
    from repro_torch.models.spec import MoeSpec as TSpec
    kw = dict(n_experts=E, top_k=k, d_ff=8, capacity_factor=factor)
    assert tm.capacity(TSpec(**kw), tokens) == jm.capacity(JSpec(**kw),
                                                           tokens)


def _reference_decisions(monkeypatch, params, x, spec):
    """Run the reference's moe_apply eagerly and read its decisions: the
    chosen experts (first one_hot's input), the kept slots (second one_hot's
    input) and the dispatch mask (first 'gtke,gtkc->gtec' product)."""
    seen = {"one_hot": [], "einsum": []}
    one_hot, einsum = jax.nn.one_hot, jnp.einsum

    def rec_one_hot(a, *args, **kw):
        seen["one_hot"].append(a)
        return one_hot(a, *args, **kw)

    def rec_einsum(sub, *ops, **kw):
        out = einsum(sub, *ops, **kw)
        seen["einsum"].append((sub, out))
        return out

    monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)
    monkeypatch.setattr(jnp, "einsum", rec_einsum)
    y, aux = jm.moe_apply(params, x, spec)
    monkeypatch.undo()
    dispatch = next(o for s, o in seen["einsum"] if s == "gtke,gtkc->gtec")
    sel, kept = seen["one_hot"][:2]
    return (np.asarray(y, np.float32), float(aux), np.asarray(sel),
            np.asarray(kept), np.asarray(dispatch, np.float32))


CASES = [  # (arch, capacity_factor, group_size, id)
    ("olmoe-1b-7b", 1.25, 4096, "olmoe"),
    ("olmoe-1b-7b", 0.5, 4096, "olmoe-drops"),
    ("olmoe-1b-7b", 0.5, 32, "olmoe-drops-groups"),
    ("deepseek-v2-236b", 1.25, 4096, "deepseek-shared"),
    ("deepseek-v2-236b", 0.5, 32, "deepseek-shared-drops-groups"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,factor,gs", [c[:3] for c in CASES],
                         ids=[c[3] for c in CASES])
def test_moe_apply_matches_reference(monkeypatch, arch, factor, gs, dtype):
    jcfg, jspec = _spec(arch, get_config)
    _, tspec = _spec(arch, tget)
    jspec = dataclasses.replace(jspec, capacity_factor=factor, group_size=gs)
    tspec = dataclasses.replace(tspec, capacity_factor=factor, group_size=gs)
    p = jm.moe_init(jax.random.PRNGKey(3), jcfg.d_model, jspec, jcfg)
    if dtype == "float32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    assert tp["router"].dtype == torch.float32           # f32 leaf as is
    x = jnp.asarray(np.random.default_rng(4).standard_normal(
        (2, 32, jcfg.d_model)), getattr(jnp, dtype))
    y, aux, sel, kept, dispatch = _reference_decisions(monkeypatch, p, x,
                                                       jspec)
    xt = tensor_from_numpy(np.asarray(x))
    T = xt.shape[0] * xt.shape[1]
    G = T // min(gs, T)
    xg = xt.reshape(G, -1, xt.shape[-1])
    C = tm.capacity(tspec, xg.shape[1])
    _, gate_w, t_sel, t_kept, onehot = tm.route(tp, xg, tspec)
    t_dispatch, _ = tm.dispatch_tensors(onehot, gate_w, t_kept, C, xt.dtype)
    np.testing.assert_array_equal(t_sel.numpy(), sel)
    np.testing.assert_array_equal(t_kept.numpy(), kept)
    np.testing.assert_array_equal(t_dispatch.float().numpy(), dispatch)
    if factor < 1:
        assert (kept == C).any(), "no drop forced"
    t_y, t_aux = tm.moe_apply(tp, xt, tspec)
    assert t_y.dtype == xt.dtype
    np.testing.assert_allclose(t_y.float().numpy(), y, **TOL[dtype])
    np.testing.assert_allclose(float(t_aux), aux, **TOL["float32"])


def test_top_k_puts_the_lower_index_first_on_ties():
    r = np.random.default_rng(5)
    probs = r.choice([0.125, 0.25, 0.5], size=(3, 7, 16)).astype(np.float32)
    probs[0, 0] = 0.0625                                  # all tied
    vj, ij = jax.lax.top_k(jnp.asarray(probs), 6)
    vt, it = tm._top_k(torch.from_numpy(probs), 6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert it[0, 0].tolist() == list(range(6))


def test_tied_router_routes_like_reference(monkeypatch):
    """A zero router ties every expert: both packages pick experts 0..k-1,
    and the queues of those experts overflow alike."""
    jcfg, jspec = _spec("olmoe-1b-7b", get_config)
    _, tspec = _spec("olmoe-1b-7b", tget)
    p = jm.moe_init(jax.random.PRNGKey(0), jcfg.d_model, jspec, jcfg)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    x = jnp.asarray(np.random.default_rng(6).standard_normal(
        (1, 16, jcfg.d_model)), jnp.float32)
    _, _, sel, kept, _ = _reference_decisions(monkeypatch, p, x, jspec)
    _, _, t_sel, t_kept, _ = tm.route(tp, tensor_from_numpy(np.asarray(x)),
                                      tspec)
    assert (sel == np.arange(tspec.top_k)).all()
    np.testing.assert_array_equal(t_sel.numpy(), sel)
    np.testing.assert_array_equal(t_kept.numpy(), kept)
    assert (kept == tm.capacity(tspec, 16)).any()


def test_token_count_must_fill_groups():
    """Past one group, the tokens must fill whole groups (the reference
    asserts; the port raises)."""
    jcfg, jspec = _spec("olmoe-1b-7b", get_config)
    _, tspec = _spec("olmoe-1b-7b", tget)
    tspec = dataclasses.replace(tspec, group_size=32)
    tp = params_from_jax(jax.tree.map(np.asarray, jm.moe_init(
        jax.random.PRNGKey(0), jcfg.d_model, jspec, jcfg)))
    with pytest.raises(ValueError, match="not divisible"):
        tm.moe_apply(tp, torch.zeros((3, 16, 128), dtype=torch.bfloat16),
                     tspec)
