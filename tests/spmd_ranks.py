"""Rank programs of ``tests/test_torch_spmd.py``: the port's steps run
unsharded, sharded on a mesh of gloo ranks, and counted on ``meta`` under
``sharding.spmd.counting``. Kept apart from the test module so that the
spawned ranks import torch and the port alone (no JAX)."""
import os
import pickle

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.staging import delivered_bytes, stage_parallel_pull
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.runtime.elastic import reshard_state, state_sharding
from repro_torch.sharding.partition import (P, NamedSharding,
                                            batch_sharding, cache_sharding,
                                            param_sharding, place,
                                            sharding_ctx)
from repro_torch.sharding.spmd import (CollectiveCounter, counting,
                                       is_sharded, spmd_mesh)
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step

ARCHS = ("qwen3-14b", "mamba2-1.3b", "olmoe-1b-7b")
SIZES, NAMES = (2, 2), ("data", "model")
MODES = ("prefill", "decode", "train")


def _tensors(tree, device):
    """numpy leaves -> tensors on ``device`` (``meta``: shapes alone)."""
    if device == "meta":
        return pytree.tree_map(
            lambda a: torch.empty(a.shape, device="meta",
                                  dtype=params_from_jax(a).dtype), tree)
    return params_from_jax(tree, device)


def _numpy(x):
    if is_sharded(x):
        x = x.full_tensor()
    return x.detach().float().cpu().numpy()


def _put(tree, mesh, shardings, mode):
    """``tree`` laid out by ``shardings(tree, mesh, mode)`` (None: as it
    is)."""
    if mesh is None:
        return tree
    return pytree.tree_map(place, tree, shardings(tree, mesh, mode))


def run(arch: str, mode: str, data: dict, mesh, device="cpu"):
    """(outputs as numpy or None on ``meta``, the step's CollectiveStats):
    one ``mode`` step of ``arch`` from ``data`` (the test module's numpy
    params, tokens, labels and decode caches), laid out on ``mesh``
    (None: unsharded)."""
    cfg = get_config(arch, smoke=True)
    d = data[arch]
    params = _tensors(d["params"], device)
    if mode == "prefill":
        params = _put(params, mesh, param_sharding, "prefill")
        inputs = {"tokens": _tensors(d["tokens"], device)}
        inputs = _put(inputs, mesh, batch_sharding, "prefill")
        with CollectiveCounter() as cc, sharding_ctx(mesh, "prefill"):
            logits, _ = lm.prefill(params, inputs, cfg)
        out = {"logits": logits}
    elif mode == "decode":
        params = _put(params, mesh, param_sharding, "serve")
        caches = _tensors(d["caches"], device)
        caches = _put(caches, mesh, cache_sharding, "serve")
        inputs = {"tokens": _tensors(d["step_tokens"], device),
                  "positions": _tensors(d["step_pos"], device)}
        inputs = _put(inputs, mesh, batch_sharding, "serve")
        with CollectiveCounter() as cc, sharding_ctx(mesh, "serve"):
            logits, _ = lm.decode_step(params, caches, inputs["tokens"],
                                       inputs["positions"], cfg)
        out = {"logits": logits}
    else:
        state = {"params": params, "opt": adamw_init(params)}
        if mesh is not None:
            state = reshard_state(state, mesh)
        batch = {"tokens": _tensors(d["tokens"], device),
                 "labels": _tensors(d["labels"], device)}
        batch = _put(batch, mesh, batch_sharding, "train")
        step = make_train_step(cfg, AdamWConfig())
        with CollectiveCounter() as cc, sharding_ctx(mesh, "train"):
            state, metrics = step(state, batch)
        out = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
               "params": state["params"]}
    if device == "meta":
        return None, cc.stats
    return pytree.tree_map(_numpy, out), cc.stats


def _continue(arch, data, mesh, ckpt_dir):
    """The losses of the step after a 1-rank checkpoint, restored onto
    ``mesh`` two ways: ``restore(sharding=)`` into ``meta`` shapes, and a
    whole restore then ``reshard_state``."""
    cfg = get_config(arch, smoke=True)
    d = data[arch]
    meta = _tensors(d["params"], "meta")
    like = {"params": meta, "opt": adamw_init(meta)}
    step = make_train_step(cfg, AdamWConfig())
    losses = []
    for how in ("restore", "reshard"):
        if how == "restore":
            state, _ = ckpt.restore(ckpt_dir, like,
                                    sharding=state_sharding(like, mesh))
        else:
            whole = _tensors(d["params"], "cpu")
            whole = {"params": whole, "opt": adamw_init(whole)}
            whole, _ = ckpt.restore(ckpt_dir, whole)
            state = reshard_state(whole, mesh)
        batch = {"tokens": _tensors(d["tokens"], "cpu"),
                 "labels": _tensors(d["labels"], "cpu")}
        batch = pytree.tree_map(place, batch,
                                batch_sharding(batch, mesh, "train"))
        with sharding_ctx(mesh, "train"):
            _, metrics = step(state, batch)
        losses.append(float(metrics["loss"].full_tensor()))
    return losses


def _pull(mesh):
    """(delivered_bytes of a sharded pull, the sum of every rank's shard
    bytes, the pull's bytes_total)."""
    host = {"w": torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8),
            "b": torch.ones(8, dtype=torch.bfloat16)}
    sh = {"w": NamedSharding(mesh, P("data", "model")),
          "b": NamedSharding(mesh, P(None))}
    placed, rec = stage_parallel_pull(host, sharding=sh)
    mine = sum(t.to_local().numel() * t.to_local().element_size()
               for t in placed.values())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return delivered_bytes(placed), sum(every), rec.extra["bytes_total"]


def _counted_and_live(rank, n, store_path, device, data, sizes, names):
    """Every (arch, mode) counted under ``counting`` on ``meta``, then run
    live on the mesh of ranks; returns the results and the mesh."""
    res = {"counted": {}, "live": {}, "out": {}}
    with counting(Mesh.abstract(sizes, names), rank=rank) as cm:
        for arch in ARCHS:
            for mode in MODES:
                _, st = run(arch, mode, data, cm, device="meta")
                res["counted"][arch, mode] = st.table()
    mesh = spmd_mesh(sizes, names, device=device, rank=rank,
                     store_path=store_path)
    for arch in ARCHS:
        for mode in MODES:
            out, st = run(arch, mode, data, mesh,
                          device=str(mesh.local_device))
            res["live"][arch, mode] = st.table()
            res["out"][arch, mode] = out
    return res, mesh


def cuda_rank_main(rank, n, store_path, device, data_path, out_dir):
    """One NCCL rank of the ``cuda`` test: as ``rank_main`` on a mesh of
    ``n`` ranks along ``model``, without the checkpoint and pull cases."""
    with open(data_path, "rb") as f:
        data = pickle.load(f)
    res, _ = _counted_and_live(rank, n, store_path, device, data, (n,),
                               ("model",))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def rank_main(rank, n, store_path, device, data_path, out_dir):
    """One rank: every (arch, mode) counted under ``counting`` on ``meta``,
    then run live on the gloo mesh; the checkpoint continuations and the
    sharded pull. Writes ``rank{r}.pkl``."""
    with open(data_path, "rb") as f:
        data = pickle.load(f)
    res, mesh = _counted_and_live(rank, n, store_path, device, data, SIZES,
                                  NAMES)
    res["continue"] = _continue("qwen3-14b", data, mesh, data["ckpt_dir"])
    res["pull"] = _pull(mesh)
    res["threads"] = torch.get_num_threads()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
