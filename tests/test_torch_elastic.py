"""The port's elastic restore and its sharding constraint on the CPU:
``runtime.elastic`` (``state_sharding``, ``reshard_state``),
``ckpt.checkpoint.restore(..., sharding=)`` and
``sharding.partition.constrain`` / ``place``.

The port has no SPMD runtime: on a mesh of one distinct device (the CPU,
listed once or twice) ``constrain`` returns its input object and placing is
``.to(device)``; a mesh of two distinct devices raises. The constraint
moves no token, logit or loss: a model run under ``sharding_ctx`` equals
the run without it bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.runtime.elastic import reshard_state as j_reshard_state
from repro.runtime.elastic import state_sharding as j_state_sharding
from repro.train.step import init_state as j_init_state
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import lm
from repro_torch.models.blocks import tree_map
from repro_torch.runtime.elastic import reshard_state, state_sharding
from repro_torch.sharding.partition import (NamedSharding, PartitionSpec,
                                            constrain, current_mesh,
                                            current_mode, place,
                                            sharding_ctx)
from repro_torch.train.optimizer import AdamWConfig, leaves_with_path
from repro_torch.train.step import init_state, make_train_step

torch.set_num_threads(1)

CPU = torch.device("cpu")
TWO = Mesh([[torch.device("cuda", 0)], [torch.device("cuda", 1)]],
           ("data", "model"))


def one_device_meshes():
    return [make_host_mesh("cpu"),
            Mesh([["cpu"], ["cpu"]], ("data", "model")),      # listed twice
            Mesh.abstract((16, 16), ("data", "model"))]


def _state(arch="mamba2-1.3b", seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init_state(gen, tget(arch, smoke=True), "cpu")


def _flat(tree):
    return {"/".join(map(str, p)): x for p, x in leaves_with_path(tree)}


# --- constrain / place -----------------------------------------------------

def test_constrain_returns_its_input_object():
    x = torch.randn(4, 8, 16)
    assert constrain(x, "batch", "seq", "act_d") is x        # no context
    for mesh in one_device_meshes():
        for mode in ("train", "prefill", "serve"):
            with sharding_ctx(mesh, mode):
                assert current_mesh() is mesh and current_mode() == mode
                assert constrain(x, "batch", "seq", "act_d") is x
    assert current_mesh() is None and current_mode() == "train"


def test_constrain_raises_on_a_two_device_mesh():
    x = torch.randn(4, 8, 16)
    assert len(TWO.distinct_devices) == 2
    with sharding_ctx(TWO, "train"):
        with pytest.raises(NotImplementedError, match="no SPMD runtime"):
            constrain(x, "batch", "seq", "act_d")
    with pytest.raises(NotImplementedError, match="no SPMD runtime"):
        place(x, NamedSharding(TWO, PartitionSpec()))
    with pytest.raises(NotImplementedError, match="no SPMD runtime"):
        reshard_state(_state(), TWO)


def test_constrain_checks_the_rank_of_its_names():
    with sharding_ctx(make_host_mesh("cpu"), "train"):
        with pytest.raises(AssertionError):
            constrain(torch.randn(4, 8), "batch", "seq", "act_d")


def test_place_on_an_abstract_mesh_raises():
    with pytest.raises(ValueError, match="abstract"):
        place(torch.ones(2), NamedSharding(
            Mesh.abstract((2,), ("data",)), PartitionSpec(None)))


# --- reshard ----------------------------------------------------------------

@pytest.mark.parametrize("mesh", one_device_meshes()[:2],
                         ids=["host", "cpu-twice"])
def test_reshard_preserves_values_and_tensors(mesh):
    state = _state()
    before = {k: v.clone() for k, v in _flat(state).items()}
    out = reshard_state(state, mesh)
    got = _flat(out)
    assert set(got) == set(before)
    for k, v in _flat(state).items():
        assert got[k] is v                  # already on the mesh's device
        assert torch.equal(got[k], before[k]) and got[k].device == CPU
    shard = state_sharding(state, mesh)
    assert all(isinstance(s, NamedSharding) and s.mesh is mesh
               for s in _flat(shard).values())


def test_reshard_matches_the_reference():
    """The reference reshards its state onto its one-device mesh, the port
    onto its host mesh: the same values, leaf for leaf."""
    cfg = jget("olmoe-1b-7b", smoke=True)
    js = j_init_state(jax.random.PRNGKey(0), cfg)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jout = j_reshard_state(js, jmesh)
    ts = {"params": params_from_jax(jax.tree.map(np.asarray, js["params"])),
          "opt": {"m": params_from_jax(jax.tree.map(np.asarray,
                                                    js["opt"]["m"])),
                  "v": params_from_jax(jax.tree.map(np.asarray,
                                                    js["opt"]["v"])),
                  "step": torch.tensor(0, dtype=torch.int32)}}
    tout = reshard_state(ts, make_host_mesh("cpu"))
    jflat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path): np.asarray(x)
             for path, x in jax.tree_util.tree_flatten_with_path(jout)[0]}
    tflat = _flat(tout)
    assert set(jflat) == set(tflat)
    for k, v in tflat.items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      jflat[k].astype(np.float32))
    # the reference's sharding tree for its mesh has one spec a leaf too
    assert len(jax.tree_util.tree_leaves(
        j_state_sharding(js, jmesh),
        is_leaf=lambda x: hasattr(x, "spec"))) == len(tflat)


# --- restore(sharding=) ----------------------------------------------------

def test_restore_with_sharding_round_trips(tmp_path):
    mesh = make_host_mesh("cpu")
    state = _state(seed=1)
    tree_map(lambda x: x.normal_(generator=torch.Generator().manual_seed(2))
             if x.is_floating_point() else x, state["opt"]["m"])
    state["opt"]["step"].fill_(9)
    want = {k: v.clone() for k, v in _flat(state).items()}
    tckpt.save(str(tmp_path), 9, state, blocking=True)
    like = _state(seed=3)
    objs = _flat(like)
    out, step = tckpt.restore(str(tmp_path), like,
                              sharding=state_sharding(like, mesh))
    assert step == 9
    for k, v in _flat(out).items():
        assert v is objs[k]                 # copied in place, kept there
        assert torch.equal(v, want[k]), k


def test_restore_with_sharding_reads_the_references_checkpoint(tmp_path):
    """A checkpoint the reference wrote, restored by both packages onto
    their one-device meshes through ``sharding=``: equal leaf for leaf."""
    cfg = jget("mamba2-1.3b", smoke=True)
    js = j_init_state(jax.random.PRNGKey(4), cfg)
    jckpt.save(str(tmp_path), 3, js, blocking=True)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jout, _ = jckpt.restore(str(tmp_path), like=js,
                            sharding=j_state_sharding(js, jmesh))
    like = _state()
    tout, step = tckpt.restore(str(tmp_path), like, sharding=state_sharding(
        like, make_host_mesh("cpu")))
    assert step == 3
    jflat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path): np.asarray(x)
             for path, x in jax.tree_util.tree_flatten_with_path(jout)[0]}
    for k, v in _flat(tout).items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      jflat[k].astype(np.float32))


# --- the constraint moves nothing -----------------------------------------

def _decode_run(cfg, params, toks, steps=3):
    lg, caches = lm.prefill(params, {"tokens": toks}, cfg,
                            capacity=toks.shape[1] + steps)
    out = [lg]
    for i in range(steps):
        t = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
        pos = torch.full_like(t, toks.shape[1] + i)
        lg, caches = lm.decode_step(params, caches, t, pos, cfg)
        out.append(lg)
    return out


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b", "olmoe-1b-7b",
                                  "deepseek-v2-236b"])
def test_sharding_ctx_moves_no_logit_or_loss(arch):
    """Prefill + decode under ``sharding_ctx`` on the host mesh, and a
    train step with two microbatches, equal the runs without it bit for
    bit."""
    cfg = tget(arch, smoke=True)
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 32)).astype(np.int32))
    plain = _decode_run(cfg, params, toks)
    mesh = make_host_mesh("cpu")
    with sharding_ctx(mesh, "serve"):
        sharded = _decode_run(cfg, params, toks)
    for a, b in zip(plain, sharded):
        assert torch.equal(a, b)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    step = make_train_step(cfg, AdamWConfig(), microbatches=2)
    losses = []
    for ctx in (None, mesh):
        state = init_state(torch.Generator().manual_seed(1), cfg, "cpu")
        with sharding_ctx(ctx, "train"):
            _, m = step(state, batch)
        losses.append((m["loss"], m["grad_norm"]))
    assert torch.equal(losses[0][0], losses[1][0])
    assert torch.equal(losses[0][1], losses[1][1])
