"""AdamW from scratch. Port of ``repro.train.optimizer``.

Parameters are stored bf16; moments are f32. The update is computed in f32
and cast back, op for op as the reference computes it.

Everything is updated IN PLACE: the parameters, ``m``, ``v`` and the int32
``step`` of the state. The clip factor, the bias corrections and the
learning rate are 0-d tensors on the parameters' device, computed from the
device ``step``: the update reads nothing back to the host, so a train step
built on it can be captured as one CUDA graph (``core.compile_cache``)
and replayed at the same addresses.

Trees are nested dicts and lists of tensors, with the reference's keys
(``convert.params_from_jax`` maps one onto the other), so ``_decay_mask``
reads the same key paths.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

from repro_torch.models.blocks import tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; f32, on
    ``step``'s device."""
    s = torch.as_tensor(step).float()
    warm = s / max(cfg.warmup_steps, 1)
    t = (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


_NO_DECAY = ("norm", "scale", "bias", "b_", "post_", "dt_bias", "A_log", "D",
             "q_norm", "k_norm", "kv_norm", "final_norm", "conv_bias")


def _decay_mask(path: Tuple) -> bool:
    """Apply weight decay only to matrices (not norms/biases/scalars): the
    last dict key on the path decides."""
    name = next((str(p) for p in reversed(path) if isinstance(p, str)), "")
    return not name.startswith(_NO_DECAY)


def leaves_with_path(tree: Any, path: Tuple = ()) -> Iterator[tuple]:
    """(path, leaf) for every leaf of nested dicts/lists, dict keys in
    sorted order (JAX's order of a dict's leaves)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def adamw_init(params: Any) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    leaf = next(leaves_with_path(params))[1]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for _, leaf in leaves_with_path(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                 grad_transform: Optional[Callable] = None):
    """One AdamW step, in place. Returns (params, state, metrics): the same
    ``params`` and ``state`` objects, updated, and ``grad_norm`` and ``lr``
    as 0-d f32 tensors on the device."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state["step"].add_(1)
    sf = state["step"].float()
    lr = schedule(cfg, state["step"])
    b1c = 1 - torch.pow(cfg.b1, sf)
    b2c = 1 - torch.pow(cfg.b2, sf)

    if grad_transform is not None:
        grads = grad_transform(grads)

    m_leaves = dict(leaves_with_path(state["m"]))
    v_leaves = dict(leaves_with_path(state["v"]))
    g_leaves = dict(leaves_with_path(grads))
    for path, p in leaves_with_path(params):
        m, v = m_leaves[path], v_leaves[path]
        # each line rounds where the reference's expression does
        g = g_leaves[path].float() * clip
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        if _decay_mask(path):
            delta.add_(p.float() * cfg.weight_decay)
        p.copy_(p.float() - delta.mul_(lr))
    return params, state, {"grad_norm": gnorm, "lr": lr}
