"""Op-level cost counting: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference reads flops and HBM bytes from XLA's post-optimization HLO
text, correcting ``cost_analysis()`` for the trip counts of scanned layers.
PyTorch has no compiled module to read: ``OpCounter`` is a
``TorchDispatchMode`` that sees every aten op a step executes (forward,
backward and the optimizer alike, on any device; on ``meta`` tensors a
full-size step is counted without running it) and counts, per op:

  * flops, through ``torch.utils.flop_counter``'s formula registry (mm,
    bmm, addmm, baddbmm — what matmul and einsum decompose into —, the
    scaled-dot-product attention ops, convolutions); other ops count none,
    as the reference counts only ``dot``s;
  * bytes: what its tensor inputs and outputs occupy. Views and
    allocations move nothing and count none; an in-place op reads and
    writes its target.

Eager PyTorch materializes every op's output, so these bytes are the eager
traffic. XLA's count is of FUSED traffic — a fusion's internals never touch
HBM — and is a different, smaller number; neither is a lower bound on what
a step must move (``launch.dryrun`` takes that from the sharded state).
There is no trip-count problem to correct: every layer executes, so every
layer's ops are seen.

A kernel wrapper given ``meta`` (or CPU) tensors runs its plain version
(``kernels.PLAIN_DEVICES``), so the counts are the plain versions' — the
SSD scan's chunked dual form, the paged kernel's gathered view — not the
hand-written kernels'.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# allocations: no byte is read or written
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh"}


@dataclass
class OpCost:
    """What a counted call executed: flops, bytes, ops, and each by op."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    ops: int = 0
    by_op: Dict[str, List[float]] = field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        self.ops += 1
        row = self.by_op.setdefault(name, [0.0, 0.0, 0])
        row[0] += flops
        row[1] += nbytes
        row[2] += 1

    def top(self, k: int = 15, by: str = "bytes") -> list:
        """The ``k`` ops that count most ``by`` "bytes" or "flops":
        (name, flops, bytes, calls)."""
        i = {"flops": 0, "bytes": 1}[by]
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][i])[:k]
        return [(n, f, b, int(c)) for n, (f, b, c) in rows]


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: step(...)`` then ``c.cost`` (an ``OpCost``)."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__
        nbytes = 0 if (_is_view(func) or name in _NO_TRAFFIC) else (
            _nbytes((args, kwargs)) + _nbytes(out))
        self.cost.add(name, flops, nbytes)
        return out


def count(fn, *args, **kwargs) -> tuple:
    """(``fn(*args, **kwargs)``, the ``OpCost`` of the call)."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.cost
