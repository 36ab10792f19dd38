"""GPipe-style pipeline parallelism over a mesh axis. Port of
``repro.runtime.pipeline``.

Stages are laid out along a mesh axis: stage s holds its slice of the
stacked parameters on the device at position s of the axis. Microbatches
fill the pipe: M microbatches take M + S - 1 ticks for S stages (bubble
fraction (S-1)/(M+S-1)). At tick t stage 0 takes microbatch t, every other
stage takes what its predecessor produced at tick t - 1 — handed to its
device with ``.to()``, in place of the reference's ``ppermute`` — and the
last stage emits microbatch t - (S - 1).

The reference runs this schedule SPMD under ``shard_map``: every stage
computes at every tick, the fill and drain ticks on zeros whose results
are discarded. The port has one controller: it issues the ticks' stage
calls in order, skips the calls whose result the schedule discards, and
returns the same outputs. Work on different devices overlaps through each
device's own stream; on one device the stages run one after another.
Gradients flow through plain autograd: every hand-off is differentiable.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import Mesh


def _stage_params(params_stacked, s: int, device=None):
    return pytree.tree_map(
        lambda a: a[s] if device is None else a[s].to(device),
        params_stacked)


def pipeline_apply(stage_fn: Callable, params_stacked, x: torch.Tensor,
                   mesh: Mesh, axis: str = "pod",
                   microbatches: int = 4) -> torch.Tensor:
    """Run ``stage_fn(stage_params, x)`` as a pipeline along ``axis``.

    params_stacked: tree with leading axis == the number of stages (stage s
    holds its own slice). x: (B, ...) global batch; microbatches must
    divide B. Returns the last stage's outputs of the microbatches in order,
    concatenated on ``x``'s device: (B, ...)."""
    devs = mesh.devices_along(axis)
    n_stages = len(devs)
    B = x.shape[0]
    assert B % microbatches == 0, (B, microbatches)
    params = [_stage_params(params_stacked, s, devs[s])
              for s in range(n_stages)]
    xs = x.chunk(microbatches, dim=0)
    outs = [None] * microbatches
    buf = [None] * n_stages                  # what each stage received
    for t in range(microbatches + n_stages - 1):
        nxt = [None] * n_stages
        for s in range(n_stages):
            inp = (xs[t].to(devs[0]) if t < microbatches else None) \
                if s == 0 else buf[s]
            if inp is None:                  # fill / drain: discarded
                continue
            y = stage_fn(params[s], inp)
            if s == n_stages - 1:            # emits microbatch t - (S-1)
                outs[t - (n_stages - 1)] = y
            else:                            # the ppermute to stage s+1
                nxt[s + 1] = y.to(devs[s + 1])
        buf = nxt
    return torch.cat([o.to(x.device) for o in outs], dim=0)


def reference_apply(stage_fn: Callable, params_stacked, x):
    """Sequential reference: apply every stage in order (no pipeline)."""
    n_stages = pytree.tree_leaves(params_stacked)[0].shape[0]
    for s in range(n_stages):
        x = stage_fn(_stage_params(params_stacked, s), x)
    return x
