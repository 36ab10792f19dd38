"""Rank programs of ``tests/test_torch_spmd.py`` and
``tests/test_torch_spmd_graph.py``: the port's steps run unsharded, sharded
on a mesh of gloo ranks, and counted on ``meta`` under
``sharding.spmd.counting``; the Wine apps compiled on a mesh of ranks
beside the same steps run eagerly. Kept apart from the test modules so that
the spawned ranks import torch and the port alone (no JAX)."""
import os
import pickle

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.compile_cache import (CompileCache, _signature,
                                            record_args)
from repro_torch.core.staging import delivered_bytes, stage_parallel_pull
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.runtime.elastic import reshard_state, state_sharding
from repro_torch.sharding.partition import (P, NamedSharding,
                                            batch_sharding, cache_sharding,
                                            param_sharding, place,
                                            sharding_ctx)
from repro_torch.sharding.spmd import (CollectiveCounter, ShardedSpec,
                                       counting, is_sharded, settle,
                                       spmd_mesh)
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


def run(arch: str, mode: str, data: dict, mesh, device="cpu", graph=False,
        steps=1):
    """(outputs as numpy or None on ``meta``, the step's CollectiveStats):
    one ``mode`` step of ``arch`` from ``data`` (the test module's numpy
    params, tokens, labels and decode caches), laid out on ``mesh``
    (None: unsharded); a train state or decode caches advance ``steps``
    steps (the same token again: an SSM's state moves each time). With
    ``graph``, the step goes through a compile cache with its state bound
    and is called twice (on the card: captured, then replayed): the
    outputs are the second call's and the stats its collectives
    (``exe.collectives``); a train state or decode caches then advance two
    steps."""
    if graph:
        return _run_graph(arch, mode, data, mesh, device)
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
            for _ in range(steps):
                logits, caches = lm.decode_step(params, caches,
                                                inputs["tokens"],
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
            for _ in range(steps):
                state, metrics = step(state, batch)
        out = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
               "params": state["params"]}
    if device == "meta":
        return None, cc.stats
    return pytree.tree_map(_numpy, out), cc.stats


def _run_graph(arch, mode, data, mesh, device):
    """``run(..., graph=True)``: the step as ``run`` lays it out, through a
    fresh compile cache on ``device``."""
    from repro_torch.launch.roofline import CollectiveStats
    cfg = get_config(arch, smoke=True)
    d = data[arch]
    params = _tensors(d["params"], device)
    sm = {"decode": "serve"}.get(mode, mode)
    if mode == "train":
        state = reshard_state({"params": params,
                               "opt": adamw_init(params)}, mesh)
        inputs = {"tokens": _tensors(d["tokens"], device),
                  "labels": _tensors(d["labels"], device)}
        step = make_train_step(cfg, AdamWConfig())

        def fn(state, batch):
            with sharding_ctx(mesh, "train"):
                return step(state, batch)
    elif mode == "decode":
        state = (_put(params, mesh, param_sharding, sm),
                 _put(_tensors(d["caches"], device), mesh, cache_sharding,
                      sm))
        inputs = {"tokens": _tensors(d["step_tokens"], device),
                  "positions": _tensors(d["step_pos"], device)}

        def fn(state, inp):
            with sharding_ctx(mesh, sm):
                return lm.decode_step(state[0], state[1], inp["tokens"],
                                      inp["positions"], cfg)[0]
    else:
        state = _put(params, mesh, param_sharding, sm)
        inputs = {"tokens": _tensors(d["tokens"], device)}

        def fn(params, inp):
            with sharding_ctx(mesh, sm):
                return lm.prefill(params, inp, cfg)[0]
    inputs = _put(inputs, mesh, batch_sharding, sm)
    exe, _ = CompileCache(persistent=False).compile(
        fn, (state, inputs), device=device, bind_argnums=(0,))
    exe(state, inputs)
    before = CollectiveStats()
    before.merge(exe.collectives)
    got = exe(state, inputs)
    stats = CollectiveStats()
    stats.merge(exe.collectives)
    stats.merge(before, sign=-1)
    if mode == "train":
        got = {"loss": got[1]["loss"], "grad_norm": got[1]["grad_norm"],
               "params": got[0]["params"]}
    else:
        got = {"logits": got}
    return pytree.tree_map(_numpy, got), stats


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
    ``n`` ranks along ``model``, without the checkpoint and pull cases;
    then every step again through the compile cache (captured on the
    card, then replayed: ``run(..., graph=True)``)."""
    with open(data_path, "rb") as f:
        data = pickle.load(f)
    res, mesh = _counted_and_live(rank, n, store_path, device, data, (n,),
                                  ("model",))
    res["graph"], res["graph_live"] = {}, {}
    for arch in ARCHS:
        for mode in MODES:
            out, st = run(arch, mode, data, mesh,
                          device=str(mesh.local_device), graph=True)
            res["graph"][arch, mode] = out
            res["graph_live"][arch, mode] = st.table()
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


# --- the Wine apps on a mesh of ranks (tests/test_torch_spmd_graph.py) -------

WINE_ARCHS = ("qwen3-14b", "mamba2-1.3b")
WINE_SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
               "decode": "decode_32k"}


def wine_app(arch, mode):
    from repro_torch.core.wine import WineApp
    return WineApp(arch, mode=mode, shape=WINE_SHAPES[mode], smoke=True)


def wine_state(arch, mode, data, device="cpu"):
    """The state a Wine app of ``arch`` starts from: the reference's params
    (``data``), with AdamW's zero state (train) or zero rings of the smoke
    cell (decode)."""
    from repro_torch.core.wine import WineAdapter
    params = params_from_jax(data[arch]["params"], device)
    if mode == "train":
        return {"params": params, "opt": adamw_init(params)}
    if mode == "decode":
        cell = WineAdapter._cell(wine_app(arch, mode))
        return (params, lm.cache_init(get_config(arch, smoke=True),
                                      cell.global_batch, cell.seq_len,
                                      device))
    return params


def _eager_wine(arch, mode, data, mesh, batch):
    """The app's step run eagerly on the SPMD runtime, called directly:
    the state and the whole batch laid out on ``mesh`` as the adapter lays
    them out, the step under the mode's sharding context. -> (outputs as
    ``Instance.run`` returns them, the state after)."""
    cfg = get_config(arch, smoke=True)
    state = wine_state(arch, mode, data)
    if mode == "train":
        state = reshard_state(state, mesh)
        batch = _put(batch, mesh, batch_sharding, "train")
        with sharding_ctx(mesh, "train"):
            state, out = make_train_step(cfg, AdamWConfig())(state, batch)
        return out, state
    sm = "serve" if mode == "decode" else "prefill"
    if mode == "decode":
        params, caches = state
        params = _put(params, mesh, param_sharding, sm)
        caches = _put(caches, mesh, cache_sharding, sm)
        inputs = _put(batch, mesh, batch_sharding, sm)
        with sharding_ctx(mesh, sm):
            logits, caches = lm.decode_step(params, caches, inputs["tokens"],
                                            inputs["positions"], cfg)
        return logits, (params, caches)
    params = _put(state, mesh, param_sharding, sm)
    inputs = _put(batch, mesh, batch_sharding, sm)
    with sharding_ctx(mesh, sm):
        return lm.prefill(params, inputs, cfg), params


def _full(tree):
    """Every leaf whole, on the CPU (a collective for each DTensor)."""
    return pytree.tree_map(
        lambda x: (x.full_tensor() if is_sharded(x) else x).detach().cpu()
        if isinstance(x, torch.Tensor) else x, tree)


def _bit_equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(_full(a)), pytree.tree_leaves(_full(b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb)
        if isinstance(x, torch.Tensor))


def wine_rank_main(rank, n, store_path, device, data_path, out_dir):
    """One gloo rank of a (2, 2) mesh: every Wine app of ``WINE_ARCHS``
    loaded through ``WineAdapter(mesh=...)`` (the compile cache, a record
    directory of the rank's own) and run once on the whole batch, beside
    the same step run eagerly on the runtime (``_eager_wine``) under a
    ``CollectiveCounter``; then a second adapter over the same directory
    loads every app again (the disk tier), and one prefill record is read
    back (``record_args``). Writes ``wine-rank{r}.pkl``."""
    from repro_torch.core.wine import WineAdapter
    with open(data_path, "rb") as f:
        data = pickle.load(f)
    mesh = spmd_mesh(SIZES, NAMES, device=device, rank=rank,
                     store_path=store_path)
    cache_dir = os.path.join(out_dir, f"records-rank{rank}")
    adapter = WineAdapter(mesh=mesh, device=device,
                          cache=CompileCache(cache_dir=cache_dir))
    res = {"apps": {}, "threads": torch.get_num_threads()}
    for arch in WINE_ARCHS:
        for mode in MODES:
            batch = {k: torch.from_numpy(v)
                     for k, v in data[arch]["batches"][mode].items()}
            inst = adapter.load(wine_app(arch, mode),
                                state=wine_state(arch, mode, data))
            got = inst.run(batch)
            with CollectiveCounter() as cc:
                want, state = _eager_wine(arch, mode, data, mesh, batch)
            exe = inst.step_fn
            if mode == "train":
                # the state the app advanced against the eager step's
                equal = _bit_equal((got, inst.state["params"]),
                                   (want, state["params"]))
                out = {k: float(_full(got[k])) for k in ("loss",
                                                         "grad_norm")}
            else:
                equal = _bit_equal((got, inst.state), (want, state))
                logits = got[0] if mode == "prefill" else got
                out = {"logits": _full(logits).float().numpy()}
            res["apps"][arch, mode] = {
                "source": inst.load_report["compile_source"],
                "sharded": exe.sharded, "calls": exe.calls,
                "collectives": exe.collectives.table(),
                "eager_collectives": cc.stats.table(),
                "bit_equal": equal, "out": out}
    again = WineAdapter(mesh=mesh, device=device,
                        cache=CompileCache(cache_dir=cache_dir))
    res["disk"] = {(arch, mode): again.load(
        wine_app(arch, mode), state=wine_state(arch, mode, data)
    ).load_report["compile_source"]
        for arch in WINE_ARCHS for mode in MODES}
    arch = "mamba2-1.3b"
    inst = again.load(wine_app(arch, "prefill"),
                      state=wine_state(arch, "prefill", data))
    rec, = CompileCache(cache_dir=cache_dir).records(
        ("wine", arch, "prefill"))
    args = record_args(rec)
    specs = [x for x in pytree.tree_leaves(args)
             if isinstance(x, ShardedSpec)]
    res["record"] = {
        "signature_equal": _signature(args) == inst.step_fn.signature,
        "sharded_leaves": len(specs),
        "cut_leaves": sum(any(type(p).__name__ == "Shard"
                              for p in s.placements) for s in specs),
        "mesh": sorted({(s.mesh_sizes, s.axis_names) for s in specs})}
    # an asynchronous redistribution's local tensor is a pending collective
    # until it is waited
    from torch.distributed.tensor import Replicate
    x = place(torch.arange(16.0).reshape(4, 4),
              NamedSharding(mesh, P("data", None)))
    y = x.redistribute(mesh.device_mesh, [Replicate()] * 2, async_op=True)
    z = settle({"y": y})["y"]
    res["settle"] = (type(y._local_tensor).__name__,
                     type(z._local_tensor).__name__,
                     bool(torch.equal(z.to_local(),
                                      torch.arange(16.0).reshape(4, 4))))
    with open(os.path.join(out_dir, f"wine-rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
