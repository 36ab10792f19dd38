"""The train step. Port of ``repro.train.step``.

``make_train_step(cfg, opt)`` returns ``train_step(state, batch) -> (state,
metrics)``. ``state`` is ``{"params", "opt"}`` and is updated IN PLACE
(``train.optimizer``): the step returns the same object, and ``metrics``
holds ``loss``, ``ce``, ``aux``, ``tokens``, ``grad_norm`` and ``lr`` as 0-d
tensors on the device. Nothing is read back to the host, so on the card the
whole step — forward, backward and AdamW — is captured as one CUDA graph
by ``core.compile_cache`` and replayed with the state bound at its
addresses (``launch/train.py``, ``core/wine.py``).

Gradients come from ``torch.autograd.grad`` over detached aliases of the
parameters: the state's own tensors never require grad, so the in-place
update needs no special care and serving code can share the weights.
Microbatches accumulate gradients in ``accum_dtype`` (f32 by default);
each microbatch is pinned batch-sharded (``sharding.partition.constrain``),
as in the reference.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.blocks import tree_map
from repro_torch.models.lm import lm_init, lm_loss
from repro_torch.models.spec import ModelConfig
from repro_torch.sharding.partition import constrain
from repro_torch.sharding.spmd import like, reshape
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


def init_state(gen: Optional[torch.Generator], cfg: ModelConfig,
               device) -> dict:
    params = lm_init(gen, cfg, device)
    return {"params": params, "opt": adamw_init(params)}


def _grads(cfg: ModelConfig, params: dict, batch: dict, remat: bool):
    """(loss, metrics, gradients of the loss w.r.t. ``params``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = []
    tree_map(flat.append, live)
    with torch.enable_grad():
        loss, metrics = lm_loss(live, batch, cfg, remat=remat)
        grads = torch.autograd.grad(loss, flat)
    # on a mesh of ranks each gradient takes its parameter's layout (a
    # partial sum over the batch's ranks is reduced), as the reference's
    # jit gives gradients their parameters' shardings
    it = iter(like(g, p) for g, p in zip(grads, flat))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), live))


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    microbatches: int = 1,
                    grad_transform: Optional[Callable] = None,
                    remat: bool = True,
                    accum_dtype=torch.float32) -> Callable:
    """Build train_step(state, batch) -> (state, metrics).

    ``accum_dtype``: dtype of the microbatch gradient accumulator (f32 by
    default; bf16 halves its memory). The batch's leading axis is split
    into ``microbatches`` equal parts; their gradients and losses are
    averaged, and ``ce``/``aux``/``tokens`` are the last microbatch's, as
    in the reference."""

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = _grads(cfg, params, batch, remat)
        else:
            n = microbatches
            mbs = [{k: reshape(v, (n, v.shape[0] // n) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(n)]
            # laid out as the params (DTensors on a mesh of ranks)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=accum_dtype),
                             params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state["opt"]["step"].device)
            for mb in mbs:
                mb = {k: constrain(v, "batch", *([None] * (v.ndim - 1)))
                      for k, v in mb.items()}
                l, metrics, g = _grads(cfg, params, mb, remat)
                tree_map(lambda a, b: a.add_(b.to(accum_dtype)), grads, g)
                loss = loss + l
                del g
            tree_map(lambda g: g.div_(n), grads)
            loss = loss / n

        _, _, om = adamw_update(opt, params, grads, state["opt"],
                                grad_transform=grad_transform)
        return state, dict(metrics, loss=loss, **om)

    return train_step
