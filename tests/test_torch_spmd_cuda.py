"""The SPMD runtime across cards: ``tests/test_torch_spmd.py``'s numerics
and counts with NCCL ranks, one a card, on a mesh of every card (up to
four) along ``model``, eagerly and with each step captured as one CUDA
graph a rank (its NCCL collectives inside) and replayed; and, on one
card, a one-rank mesh's captured steps against its eager ones. The
several-card cases need two cards or more (they skip on fewer); no JAX
here, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_spmd_cuda.py

The unsharded runs are the port's own, on the CPU, in f32: each sharded
output, eager or replayed, within 2e-5 of its scale, as on the CPU's gloo
ranks."""
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


@pytest.fixture(scope="module")
def nccl_ranks(tmp_path_factory):
    """The spawned NCCL ranks' results (``spmd_ranks.cuda_rank_main``) and
    the data they ran on."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    tmp = tmp_path_factory.mktemp("spmd-cuda")
    n = min(torch.cuda.device_count(), 4)
    data = _data()
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    spawn(R.cuda_rank_main, n, str(tmp / "data.pkl"), str(tmp))
    return data, [pickle.load(open(tmp / f"rank{r}.pkl", "rb"))
                  for r in range(n)]


@pytest.mark.cuda
def test_cuda_nccl_ranks_match_the_unsharded_port(nccl_ranks):
    data, ranks = nccl_ranks
    for arch in R.ARCHS:
        for mode in R.MODES:
            want, _ = R.run(arch, mode, data, None)
            for r, res in enumerate(ranks):
                assert (res["live"][arch, mode]
                        == res["counted"][arch, mode]), (arch, mode, r)
                err = _err(res["out"][arch, mode], want)
                assert err <= TOL, (arch, mode, r, err)


@pytest.mark.cuda
def test_cuda_nccl_ranks_replay_within_the_unsharded_port(nccl_ranks):
    """Each step captured as one CUDA graph a rank and replayed: the
    replay's outputs (a train state or decode caches two steps on) within
    TOL of the
    unsharded port's, and its collectives (``exe.collectives``, added by
    the replay) equal to those counted on ``meta``."""
    data, ranks = nccl_ranks
    for arch in R.ARCHS:
        for mode in R.MODES:
            want, _ = R.run(arch, mode, data, None,
                            steps=1 if mode == "prefill" else 2)
            for r, res in enumerate(ranks):
                assert (res["graph_live"][arch, mode]
                        == res["counted"][arch, mode]), (arch, mode, r)
                err = _err(res["graph"][arch, mode], want)
                assert err <= TOL, (arch, mode, r, err)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", R.ARCHS)
def test_cuda_one_rank_sharded_steps_replay_their_eager_run(arch):
    """A mesh of one rank (NCCL, this process): each step of ``arch``
    through the compile cache is captured once and replayed, bit-equal to
    the same step run eagerly on the mesh (a train state or decode caches
    two steps on),
    with no collective, and the SSD kernel's launches inside the replay
    counted as the eager run's."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.sharding.spmd import shutdown, spmd_mesh
    if not torch.cuda.is_available():
        pytest.skip("needs a card")
    data = _data()
    mesh = spmd_mesh((1,), ("model",))
    dev = str(mesh.local_device)
    try:
        for mode in R.MODES:
            n0 = ssd_scan.launches
            calls = 2 if mode == "prefill" else 1
            want, _ = R.run(arch, mode, data, mesh, device=dev,
                            steps=3 - calls)
            n1 = ssd_scan.launches
            got, st = R.run(arch, mode, data, mesh, device=dev, graph=True)
            n2 = ssd_scan.launches
            assert n2 - n1 == calls * (n1 - n0), (mode, n0, n1, n2)
            # an SSM's prefill and train forward run the SSD scan; its
            # decode step, the recurrence
            assert (n1 > n0) == (arch == "mamba2-1.3b"
                                 and mode != "decode"), mode
            assert st.table() == {}, mode
            for a, b in zip(pytree.tree_leaves(got),
                            pytree.tree_leaves(want)):
                assert np.array_equal(a, b), mode
    finally:
        shutdown()


@pytest.mark.cuda
def test_cuda_one_rank_wine_prefill_captures_ahead_from_disk(tmp_path):
    """``WineAdapter(mesh=spmd_mesh(...))`` on a mesh of one rank: the
    mamba2-1.3b prefill app compiles ("compiled"), and a second adapter
    over the same record directory loads it from "disk" and captures it
    at load, so its first run is a replay, bit-equal to the first
    adapter's."""
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.wine import WineAdapter
    from repro_torch.sharding.spmd import shutdown, spmd_mesh
    if not torch.cuda.is_available():
        pytest.skip("needs a card")
    mesh = spmd_mesh((1,), ("model",))
    try:
        app = R.wine_app("mamba2-1.3b", "prefill")
        got = []
        for source in ("compiled", "disk"):
            adapter = WineAdapter(mesh=mesh, cache=CompileCache(
                cache_dir=str(tmp_path)))
            inst = adapter.load(app)
            assert inst.load_report["compile_source"] == source
            assert inst.load_report["captured_ahead"] == (source == "disk")
            specs = adapter.input_specs(app)
            r = np.random.default_rng(3)
            logits, _ = inst.run({k: torch.from_numpy(
                r.integers(1, 64, v.shape).astype(np.int32))
                for k, v in specs.items()})
            assert inst.step_fn.replays == (source == "disk")
            got.append(logits.full_tensor())
        assert torch.equal(got[0], got[1])
    finally:
        shutdown()
