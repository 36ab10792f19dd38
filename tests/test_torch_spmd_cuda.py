"""The SPMD runtime across cards: ``tests/test_torch_spmd.py``'s numerics
and counts with NCCL ranks, one a card, on a mesh of every card (up to
four) along ``model``. Needs two cards or more (it skips on fewer); no
JAX here, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_spmd_cuda.py

The unsharded runs are the port's own, on the CPU, in f32: each sharded
output within 2e-5 of its scale, as on the CPU's gloo ranks."""
import pickle

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import spmd_ranks as R
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.sharding.spmd import spawn

TOL = 2e-5
B, S = 4, 64


def _data():
    """Seeded f32 params (the port's own draw), tokens and rings."""
    data = {}
    for i, arch in enumerate(R.ARCHS):
        cfg = get_config(arch, smoke=True)
        p = lm.lm_init(torch.Generator().manual_seed(i), cfg, "cpu")
        p = pytree.tree_map(lambda t: t.float(), p)
        r = np.random.default_rng(10 + i)
        tok = r.integers(1, cfg.vocab, (B, S)).astype(np.int32)
        _, rings = lm.prefill(p, {"tokens": torch.from_numpy(tok)}, cfg,
                              capacity=S + 4)
        data[arch] = {
            "params": pytree.tree_map(lambda t: t.numpy(), p),
            "tokens": tok,
            "labels": r.integers(1, cfg.vocab, (B, S)).astype(np.int32),
            "step_tokens": r.integers(1, cfg.vocab, (B, 1)).astype(np.int32),
            "step_pos": np.full((B, 1), S, np.int32),
            "caches": pytree.tree_map(
                lambda t: (t.float() if t.is_floating_point() else t).numpy(),
                rings)}
    return data


def _err(got, want):
    if "logits" in want:
        return float(np.abs(got["logits"] - want["logits"]).max()
                     / np.abs(want["logits"]).max())
    w = pytree.tree_leaves(want["params"])
    scale = max(float(np.abs(x).max()) for x in w)
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(pytree.tree_leaves(got["params"]), w))
    rel = [abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
           for k in ("loss", "grad_norm")]
    return max(*rel, diff / scale)


@pytest.mark.cuda
def test_cuda_nccl_ranks_match_the_unsharded_port(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    n = min(torch.cuda.device_count(), 4)
    data = _data()
    with open(tmp_path / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    spawn(R.cuda_rank_main, n, str(tmp_path / "data.pkl"), str(tmp_path))
    ranks = [pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
             for r in range(n)]
    for arch in R.ARCHS:
        for mode in R.MODES:
            want, _ = R.run(arch, mode, data, None)
            for r, res in enumerate(ranks):
                assert (res["live"][arch, mode]
                        == res["counted"][arch, mode]), (arch, mode, r)
                err = _err(res["out"][arch, mode], want)
                assert err <= TOL, (arch, mode, r, err)
