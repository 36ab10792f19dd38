"""The plain references against the program at the smoke sizes, on the
CPU, in float32: the same weights (the benchmark's draw), the same
tokens."""
import dataclasses
import json
import os

import pytest
import torch

from benchkit import specs, weights
from benchkit.reference import mamba2 as ref_mamba2

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata",
                    "configs")


def _cfg(name):
    cfg = json.load(open(os.path.join(DATA, name)))
    cfg["_name"] = name
    return cfg


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


def _no_drop(model_cfg):
    """The program's MoE with room for every choice (capacity = tokens),
    so that its dispatch drops nothing: the published model's."""
    groups = []
    for g in model_cfg.groups:
        pat = tuple(dataclasses.replace(b, moe=dataclasses.replace(
            b.moe, capacity_factor=b.moe.n_experts / b.moe.top_k))
            if b.moe is not None else b for b in g.pattern)
        groups.append(dataclasses.replace(g, pattern=pat))
    return model_cfg.replace(groups=tuple(groups))


@pytest.mark.parametrize("name,length", [("mamba2-smoke.json", 48),
                                         ("deepseek-v2-smoke.json", 23)])
def test_reference_matches_program_f32(name, length):
    from repro_torch.models.lm import lm_hidden, lm_init, lm_logits
    cfg = _cfg(name)
    fam = specs.family(cfg)
    mc = _no_drop(fam.build(cfg))
    params = _f32(weights.draw(lm_init(None, mc, "meta"), 5, "cpu"))
    tokens = torch.randint(0, mc.vocab, (length,),
                           generator=torch.Generator().manual_seed(1))
    h, _ = lm_hidden(params, {"tokens": tokens[None]}, mc)
    want = lm_logits(params, h, mc)[0]
    ref = __import__(f"benchkit.reference.{fam.REFERENCE}",
                     fromlist=["x"])
    rows = torch.arange(length)
    got = ref.batch_logits(params, cfg, [tokens], [rows])[0]
    scale = want.abs().max()
    assert (got - want).abs().max() <= 2e-5 * scale


def test_chunked_scan_equals_recurrence():
    g = torch.Generator().manual_seed(3)
    L, H, P, N = 150, 3, 4, 5
    x = torch.randn(L, H, P, generator=g)
    dt = torch.rand(L, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) - 0.1
    B, C = torch.randn(L, N, generator=g), torch.randn(L, N, generator=g)
    h = torch.zeros(H, P, N)
    ys = []
    for t in range(L):
        h = torch.exp(dt[t] * A)[:, None, None] * h + \
            (dt[t][:, None] * x[t])[..., None] * B[t]
        ys.append(torch.einsum("n,hpn->hp", C[t], h))
    want = torch.stack(ys)
    got = ref_mamba2.ssd(x, dt, A, B, C)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-4)


def test_weights_repeat_and_follow_the_init_rules():
    from repro_torch.models.lm import lm_init
    cfg = _cfg("deepseek-v2-smoke.json")
    mc = specs.family(cfg).build(cfg)
    meta = lm_init(None, mc, "meta")
    a, b = weights.draw(meta, 9, "cpu"), weights.draw(meta, 9, "cpu")
    c = weights.draw(meta, 10, "cpu")
    la, lb = weights.leaf_paths(a), weights.leaf_paths(b)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not torch.equal(la[0][1], weights.leaf_paths(c)[0][1])
    for path, t in la:
        kind, v = weights.init_rule(path, tuple(t.shape))
        if kind == "const":
            assert torch.all(t == v)
        assert t.data_ptr() % 16 == 0
