"""Seeded weights, drawn on the device in a few large calls.

The program's parameter tree is taken from its own initialiser on the
``meta`` device (shapes and dtypes only, nothing allocated). Every leaf of
one dtype then becomes a view into one flat buffer, drawn with a
``torch.Generator`` on the device in chunks of at most 2**30 values and
scaled in place: the same seed gives the same weights, bit for bit, on the
same device. Norm scales, biases and the SSM's ``D`` take the constants
the program's initialiser gives them, and every drawn leaf the spread it
gives (0.02 for embeddings and the output head, 1/sqrt(fan-in) for
projections). The SSM's conv taps take nn.Conv1d's default spread over 4
taps (std 0.289), and its ``A_log`` and ``dt_bias`` follow Mamba2's
published initialiser (mamba_ssm's ``Mamba2``): A uniform in [1, 16],
and dt log-uniform in [1e-3, 1e-1] (floored at 1e-4) with ``dt_bias`` its
inverse softplus, so a head keeps its state over a span from a few tokens
to a few hundred. The plain reference reads these same tensors.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 30
ALIGN = 128                   # elements: every leaf starts 256-byte aligned

# leaves the program's initialiser fills with one value
CONSTANT = {"scale": 1.0, "q_norm": 1.0, "kv_norm": 1.0, "norm": 1.0,
            "D": 1.0, "conv_bias_x": 0.0,
            "conv_bias_B": 0.0, "conv_bias_C": 0.0, "bias": 0.0,
            "b_up": 0.0, "b_down": 0.0}
# leaves drawn with a fixed spread
FIXED_STD = {"embedding": 0.02, "lm_head": 0.02, "pos_embed": 0.02,
             "conv_x": 0.2887, "conv_B": 0.2887, "conv_C": 0.2887}
# leaves drawn uniform (through the normal draw's CDF) and mapped
SSM_INIT = ("A_log", "dt_bias")
A_RANGE = (1.0, 16.0)
DT_RANGE, DT_FLOOR = (1e-3, 1e-1), 1e-4
# fan-in axes (counted from the end) where they are not the second to last
FAN_IN_AXES = {"w_uq": (-3,), "w_uk": (-3,), "w_uv": (-3,), "wo": (-3, -2)}


def leaf_paths(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += leaf_paths(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaf_paths(v, path + (i,))
        return out
    return [(path, tree)]


def init_rule(path: tuple, shape: tuple):
    """("const", value), ("normal", std) or (the SSM rule, None) for a leaf
    of the program's tree, by its key."""
    key = path[-1]
    if key in SSM_INIT:
        return key, None
    if key in CONSTANT:
        return "const", CONSTANT[key]
    if key in FIXED_STD:
        return "normal", FIXED_STD[key]
    if key.startswith("w") or key == "router":
        axes = FAN_IN_AXES.get(key, (-2,))
        fan_in = math.prod(shape[a] for a in axes)
        return "normal", 1.0 / math.sqrt(max(fan_in, 1))
    raise KeyError(f"no init rule for parameter {'/'.join(map(str, path))}")


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def draw(meta_tree, seed: int, device) -> dict:
    """A tree shaped like ``meta_tree`` (the program's parameters on the
    meta device), every leaf a view into one buffer per dtype on
    ``device``, drawn from ``seed``."""
    leaves = leaf_paths(meta_tree)
    by_dtype: Dict[torch.dtype, List] = {}
    for path, t in leaves:
        by_dtype.setdefault(t.dtype, []).append((path, t))
    out = copy.deepcopy(_skeleton(meta_tree))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for dtype, items in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        offsets, n = [], 0
        for path, t in items:
            offsets.append(n)
            n += -(-t.numel() // ALIGN) * ALIGN
        flat = torch.empty((n,), dtype=dtype, device=device)
        for lo in range(0, n, CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=gen)
        for (path, t), off in zip(items, offsets):
            leaf = flat[off:off + t.numel()].view(t.shape)
            kind, v = init_rule(path, tuple(t.shape))
            if kind == "const":
                leaf.fill_(v)
            elif kind == "normal":
                leaf.mul_(v)
            else:
                ssm_init(leaf, kind)
            _set(out, path, leaf)
    return out


def ssm_init(leaf: torch.Tensor, kind: str) -> None:
    """Map a leaf of standard normal draws, in place, to Mamba2's
    ``A_log`` (log of A ~ U[1, 16]) or ``dt_bias`` (softplus^-1 of dt,
    log-uniform in [1e-3, 1e-1], floored at 1e-4)."""
    u = leaf.mul_(1.0 / math.sqrt(2.0)).erf_().add_(1.0).mul_(0.5)
    if kind == "A_log":
        lo, hi = A_RANGE
        u.mul_(hi - lo).add_(lo).log_()
        return
    lo, hi = (math.log(x) for x in DT_RANGE)
    dt = u.mul_(hi - lo).add_(lo).exp_().clamp_(min=DT_FLOOR)
    # softplus^-1(dt) = dt + log(1 - exp(-dt))
    dt.add_(torch.log(-torch.expm1(-dt)))


def as_dtype(meta_tree, name):
    """``meta_tree`` with its bfloat16 leaves in the dtype ``name`` (a
    test configuration's ``param_dtype``, such as "float32"), or as it is
    where ``name`` is None."""
    if name is None:
        return meta_tree
    dtype = getattr(torch, name)
    out = copy.deepcopy(_skeleton(meta_tree))
    for path, t in leaf_paths(meta_tree):
        _set(out, path, t.to(dtype) if t.dtype == torch.bfloat16 else t)
    return out


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def numel(tree) -> int:
    return sum(t.numel() for _, t in leaf_paths(tree))

