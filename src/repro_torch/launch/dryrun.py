"""The dry run: every (architecture x shape) cell at full size, on an
abstract production mesh, without a card. Port of ``repro.launch.dryrun``.

``python -m repro_torch.launch.dryrun [--arch A,B] [--shape S,T]
[--multi-pod | --both-meshes] [--smoke] [--out rows.jsonl]`` prints one
JSON row a cell. For each cell (``cell_applicable`` skips as the
reference does) it

  * builds the params, the caches (decode) or the train state on ``meta``
    (shapes and dtypes, no memory) at full size;
  * computes ``static_bytes_per_device`` through the sharding trees of
    ``sharding.partition`` on the (16, 16) or (2, 16, 16) mesh, the
    reference's ``_tree_device_bytes``; ``model_flops``, ``params`` and
    ``params_active``;
  * runs one step on ``meta`` under the SPMD runtime: the mesh brought up
    on a fake process group, one rank of it in this process
    (``sharding.spmd.counting``), the params, caches and batch placed as
    ``param_sharding`` / ``cache_sharding`` / ``batch_sharding`` lay them
    out, under ``sharding_ctx`` — the train step (with the reference's
    ``MICROBATCHES`` and ``ACCUM_DTYPE``), a prefill or a ``decode_step``
    — under the op counter (``launch.op_analysis``) and the collective
    counter (``sharding.spmd.CollectiveCounter``);
  * emits the Hopper roofline row (``launch.roofline``): flops a chip are
    the counted flops over the chips (an even split of the logical step's
    flops, which the op counter sees whole: a train step's include remat's
    recompute, which it executes; ``model_flops`` is 6ND beside them); the
    bytes that must move are the static bytes a device, less, in a forward
    step (prefill, decode), the rows of an untied input embedding that no
    token gathers (``embed_rows_not_read``); the counted eager traffic is
    printed beside them as ``op_bytes_per_chip``. A decode cell's caches
    count whole: at ``decode_32k`` every row is context. The collective
    term is the operand bytes of the collectives rank 0 of the sharded
    step issues (``collectives``: ``{kind: [count, bytes]}``,
    ``collective_bytes_per_chip``), over ``LINK_BW``; one chip sends
    nothing (0). A step the runtime cannot run is a ``fail`` row with its
    error.

The kernels' wrappers take their plain versions on ``meta``, so the flops
are the plain versions': the SSD scan's chunked dual form (the same
products the ``tc`` kernel issues), the paged kernel's gathered view.
The reference compiles each cell for its 512 fake host devices and reads
the collectives XLA's partitioner put in its HLO; the port counts those
DTensor issues, a rank's, as they run.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import (ARCHS, SHAPES, SHAPES_BY_NAME,
                                 cell_applicable, get_config, input_specs)
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.op_analysis import count
from repro_torch.launch.roofline import Roofline
from repro_torch.models import lm as lm_mod
from repro_torch.models.spec import ShapeCell
from repro_torch.sharding.partition import (batch_sharding, cache_sharding,
                                            param_sharding, place,
                                            sharding_ctx)
from repro_torch.sharding.spmd import CollectiveCounter, counting
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_state, make_train_step

META = "meta"

# microbatch count for train_4k (a copy of the reference's table)
MICROBATCHES = {
    "internvl2-76b": 8, "deepseek-v2-236b": 8, "gemma2-27b": 4,
    "qwen3-14b": 2, "stablelm-12b": 2, "gemma3-12b": 4, "zamba2-7b": 4,
}
# bf16 gradient accumulation where fp32 accumulators would not fit on chip
ACCUM_DTYPE = {"deepseek-v2-236b": torch.bfloat16}


def _tree_device_bytes(shapes, shardings) -> int:
    """Analytic bytes-per-device of a sharded tree."""
    total = 0
    for sh, sp in zip(pytree.tree_leaves(shapes),
                      pytree.tree_leaves(shardings)):
        n = 1
        for d in sh.shape:
            n *= d
        total += n * sh.dtype.itemsize // sp.shards()
    return total


def model_flops(cfg, cell: ShapeCell) -> float:
    n_active = lm_mod.count_params(cfg, active_only=True)
    if cell.mode == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.mode == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch  # decode: one token per seq


def _meta_inputs(cfg, cell: ShapeCell) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device=META)
            for k, v in input_specs(cfg, cell).items()}


def build_cell(arch: str, cell: ShapeCell, mesh: Mesh, smoke: bool = False):
    """Returns (step function, its arguments on ``meta``, static bytes a
    device)."""
    cfg = get_config(arch, smoke=smoke)
    data = _meta_inputs(cfg, cell)

    if cell.mode == "train":
        mb = MICROBATCHES.get(arch, 1) if not smoke else 1
        step = make_train_step(
            cfg, AdamWConfig(), microbatches=mb,
            accum_dtype=ACCUM_DTYPE.get(arch, torch.float32))

        def fn(state, batch):
            with sharding_ctx(mesh, "train"):
                return step(state, batch)

        state = init_state(None, cfg, META)
        static = _tree_device_bytes(state, param_sharding(state, mesh))
        return fn, (state, data), static

    params = lm_mod.lm_init(None, cfg, META)
    if cell.mode == "prefill":
        def fn(params, inputs):
            with sharding_ctx(mesh, "prefill"):
                enc = None
                if cfg.encoder is not None:
                    enc = lm_mod.encoder_apply(params, inputs["frames"], cfg)
                    inputs = {k: v for k, v in inputs.items()
                              if k != "frames"}
                return lm_mod.prefill(params, inputs, cfg, enc_out=enc)

        static = _tree_device_bytes(
            params, param_sharding(params, mesh, mode="prefill"))
        return fn, (params, data), static

    def fn(params, caches, inputs):
        with sharding_ctx(mesh, "serve"):
            return lm_mod.decode_step(
                params, caches, inputs["tokens"], inputs["positions"], cfg,
                enc_out=inputs.get("enc_out"))

    caches = lm_mod.cache_init(cfg, cell.global_batch, cell.seq_len, META)
    static = (_tree_device_bytes(params, param_sharding(params, mesh,
                                                        mode="serve"))
              + _tree_device_bytes(caches, cache_sharding(caches, mesh,
                                                          "serve")))
    return fn, (params, caches, data), static


def place_args(cell: ShapeCell, mesh: Mesh, args: tuple) -> tuple:
    """``build_cell``'s arguments laid out on a mesh of ranks as the
    reference's ``in_shardings`` lay them out."""
    def put(tree, shardings):
        return pytree.tree_map(place, tree, shardings)

    data = args[-1]
    if cell.mode == "train":
        state = args[0]
        return (put(state, param_sharding(state, mesh)),
                put(data, batch_sharding(data, mesh, "train")))
    mode = "prefill" if cell.mode == "prefill" else "serve"
    params = put(args[0], param_sharding(args[0], mesh, mode=mode))
    data = put(data, batch_sharding(data, mesh, mode))
    if cell.mode == "prefill":
        return params, data
    return params, put(args[1], cache_sharding(args[1], mesh, "serve")), data


def count_cell(arch: str, cell: ShapeCell, mesh: Mesh, smoke: bool = False):
    """(the op counter's ``OpCost``, the ``CollectiveStats`` of rank 0,
    the static bytes a device, the cell's arguments on ``meta``) of one
    step of ``cell`` on ``mesh`` (abstract) under the SPMD runtime."""
    with counting(mesh) as spmd:
        fn, args, static = build_cell(arch, cell, spmd, smoke=smoke)
        with CollectiveCounter() as cc:
            _, cost = count(fn, *place_args(cell, spmd, args))
    return cost, cc.stats, static, args


def embed_rows_not_read(cfg, params, tokens: int, shards: int = 1) -> int:
    """Bytes a device holds of an untied input embedding that a forward
    step gathering ``tokens`` rows need not read: all but those rows (a
    device's even share where the table is cut into ``shards``). A tied
    table is read whole by the logits: 0."""
    if cfg.tie_embeddings:
        return 0
    e = params["embed"]["embedding"]
    held = e.numel() * e.element_size() // shards
    return held * (cfg.vocab - min(tokens, cfg.vocab)) // cfg.vocab


def must_move_bytes(cfg, cell: ShapeCell, mesh: Mesh, args: tuple,
                    static: int) -> int:
    """The bytes a device must move at least once in ``cell``'s step:
    ``static`` less, in a forward step, the input embedding's rows that
    no token gathers."""
    if cell.mode == "train":
        return static
    params, data = args[0], args[-1]
    mode = "prefill" if cell.mode == "prefill" else "serve"
    shards = param_sharding({"embed": params["embed"]}, mesh,
                            mode=mode)["embed"]["embedding"].shards()
    return static - embed_rows_not_read(cfg, params, data["tokens"].numel(),
                                        shards)


def roofline_row(cost, must_move: float, mflops: float, chips: int,
                 coll=None) -> dict:
    """The roofline row of one counted step (``cost``: an ``OpCost``) on
    ``chips`` chips: counted flops split evenly, ``must_move`` bytes a chip
    as the bytes that must move (a lower bound: see the module docstring),
    the eager traffic beside them, and the collectives a chip issues
    (``coll``: a ``CollectiveStats``; None or empty: none)."""
    total = float(coll.total_bytes) if coll is not None else 0.0
    roof = Roofline(flops=cost.flops / chips, hbm_bytes=must_move,
                    collective_bytes=total, model_flops=mflops, chips=chips)
    return dict(roof.row(), op_bytes_per_chip=cost.hbm_bytes / chips,
                ops=cost.ops,
                collectives=coll.table() if coll is not None else {})


def run_cell(arch: str, shape: str, multi_pod: bool,
             smoke: bool = False) -> dict:
    cell = SHAPES_BY_NAME[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    rec = {"arch": arch, "shape": shape,
           "mesh": "x".join(str(s) for s in mesh.sizes),
           "chips": chips, "status": "ok"}
    ok, reason = cell_applicable(arch, cell)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    t0 = time.perf_counter()
    try:
        cost, coll, static, args = count_cell(arch, cell, mesh, smoke=smoke)
        rec["t_count_s"] = round(time.perf_counter() - t0, 2)
        rec["static_bytes_per_device"] = int(static)
        rec["static_gb_per_device"] = round(static / 1e9, 3)
        cfg = get_config(arch, smoke=smoke)
        must = must_move_bytes(cfg, cell, mesh, args, static)
        rec.update(roofline_row(cost, must, model_flops(cfg, cell), chips,
                                coll))
        rec["counted"] = ("plain versions of the kernels, eager traffic, "
                          "collectives of rank 0 under the SPMD runtime")
        rec["params"] = lm_mod.count_params(cfg)
        rec["params_active"] = lm_mod.count_params(cfg, active_only=True)
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="count every (arch x shape) cell on meta tensors and "
                    "print its H100 roofline row")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in SHAPES] if args.shape == "all"
              else args.shape.split(","))
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    out_f = open(args.out, "a") if args.out else None
    n_fail = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mp, smoke=args.smoke)
                print(json.dumps(rec), flush=True)
                if out_f:
                    trace = rec.pop("trace", None)
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
                    if trace:
                        print(trace)
                n_fail += rec["status"] == "fail"
    if out_f:
        out_f.close()
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
