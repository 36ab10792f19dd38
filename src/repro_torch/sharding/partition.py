"""Logical-axis sharding: one rule table, every architecture, every mesh.
Port of ``repro.sharding.partition``.

Parameters get ONE layout shared by train and serve (2D: `d_model`->data,
heads/ff/experts/d_inner->model) so checkpoints are layout-compatible across
modes. Activations get mode-specific rules:

  train/prefill : batch -> (pod, data); sequence-parallel residual stream
                  (seq -> model); heads/ff -> model inside the mixers.
  serve (decode): weight-stationary 2D TP — activations are D-sharded over
                  `data`; caches shard batch over `data` and sequence over
                  `model` (falling back to more axes when batch=1, e.g.
                  long_500k).

Resolution is *shape-aware and greedy*: each logical dim tries its candidate
mesh axes in priority order, taking an axis only if (a) it is present in the
mesh, (b) unused by this tensor so far, and (c) the dim size stays divisible.
This is what lets qwen3 (40 heads, 16-way model axis) fall back to
sequence-sharded attention, whisper (8 heads) to replicated attention, and
long_500k (batch=1) to sequence-sharded caches — no per-arch special cases.

The rule tables (``PARAM_RULES``, ``ACT_RULES``, ``PRIORITY``,
``PARAM_LOGICAL``, ``CACHE_LOGICAL``, ``SERVE_PARAM_RULES``) are copies of
the reference's, pinned by ``tests/test_torch_sharding.py``. A
``PartitionSpec`` is a tuple with one entry a dim: an axis name, a tuple of
names, or None (replicated). Trees are walked with
``torch.utils._pytree.tree_flatten_with_path``; its ``MappingKey.key``
names a leaf as jax's ``DictKey.key`` does.

On a mesh of ranks (``sharding.spmd.spmd_mesh``, or the dry run's
``spmd.counting``) this is the SPMD runtime: ``constrain`` redistributes a
``DTensor`` to the resolved spec (a plain tensor, which every rank holds
whole, is cut to it), ``place`` is ``distribute_tensor`` (each rank keeps
its own shard; nothing is sent), and ``sharding_ctx`` enters DTensor's
``implicit_replication``, so aranges and masks made inside the step count
as replicated. Everywhere else ``constrain`` returns its input itself: no
mesh, an abstract mesh (shapes only), or a mesh that lists one distinct
device (the card, however many times); a single-controller mesh of more
than one distinct device raises ``NotImplementedError`` and names
``spmd_mesh``, rather than replicate silently. Under a context it asserts
one logical name a dim. ``place`` follows the same rule for a tensor and
its ``NamedSharding``.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import Mesh

# ---------------------------------------------------------------------------
# Rule tables: logical axis -> candidate mesh axes (tried in order)
# ---------------------------------------------------------------------------

PARAM_RULES = {
    "vocab": ("model",),
    # cross-pod ZeRO: parameters/optimizer shard over `pod` as well — at 2
    # pods this halves per-chip state; single-pod meshes have no `pod` axis
    # and are unaffected
    "d_model": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "d_inner": ("model",),
    "ssm_heads": ("model",),
    "head_dim": (),
    "state": (),
    "q_lora": (),
    "kv_lora": (),
}

ACT_RULES = {
    "train": {
        "batch": ("pod", "data"),
        "moe_group": ("pod", "data"),
        "seq": ("model",),
        "_": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "q_group": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "act_d": (),
        "vocab": ("model",),
        "d_inner": ("model",),
        "cache_batch": ("pod", "data"),
        "cache_seq": ("model",),
        "ssm_heads": ("model",),
        "head_dim": (),
    },
    "serve": {
        "batch": ("pod",),
        "moe_group": ("pod",),
        "seq": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "q_group": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "act_d": ("data",),
        "vocab": ("model",),
        "d_inner": ("model",),
        "cache_batch": ("data",),
        "cache_seq": ("pod", "data", "model"),
        "ssm_heads": ("model",),
        "head_dim": (),
    },
}
ACT_RULES["prefill"] = dict(ACT_RULES["train"])

# lower value resolves first (gets first claim on mesh axes)
PRIORITY = {
    "experts": 0, "heads": 1, "kv_heads": 2, "q_group": 3, "ff": 4,
    "vocab": 5, "d_inner": 6, "ssm_heads": 7, "d_model": 8, "batch": 9,
    "moe_group": 9,
    "cache_batch": 10, "cache_seq": 11, "seq": 12, "act_d": 13,
    "head_dim": 20, "state": 20, "q_lora": 20, "kv_lora": 20, None: 99,
}

# ---------------------------------------------------------------------------
# Logical axes by leaf name
# ---------------------------------------------------------------------------

PARAM_LOGICAL = {
    "embedding": ("vocab", "d_model"),
    "lm_head": ("d_model", "vocab"),
    "pos_embed": (None, "d_model"),
    "wq": ("d_model", "heads", "head_dim"),
    "wk": ("d_model", "kv_heads", "head_dim"),
    "wv": ("d_model", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "d_model"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "bo": ("d_model",),
    "q_norm": (None,), "k_norm": (None,), "kv_norm": (None,),
    "w_dq": ("d_model", "q_lora"),
    "w_uq": ("q_lora", "heads", "head_dim"),
    "w_dkv": ("d_model", "kv_lora"),
    "w_uk": ("kv_lora", "heads", "head_dim"),
    "w_uv": ("kv_lora", "heads", "head_dim"),
    "w_up": ("d_model", "ff"), "w_gate": ("d_model", "ff"),
    "w_down": ("ff", "d_model"),
    "b_up": ("ff",), "b_down": ("d_model",),
    "router": ("d_model", "experts"),
    "we_gate": ("experts", "d_model", "ff"),
    "we_up": ("experts", "d_model", "ff"),
    "we_down": ("experts", "ff", "d_model"),
    "ws_gate": ("d_model", "ff"), "ws_up": ("d_model", "ff"),
    "ws_down": ("ff", "d_model"),
    "w_x": ("d_model", "d_inner"), "w_z": ("d_model", "d_inner"),
    "w_B": ("d_model", "state"), "w_C": ("d_model", "state"),
    "w_dt": ("d_model", "ssm_heads"),
    "conv_x": (None, "d_inner"), "conv_B": (None, "state"),
    "conv_C": (None, "state"),
    "conv_bias_x": ("d_inner",), "conv_bias_B": ("state",),
    "conv_bias_C": ("state",),
    "dt_bias": ("ssm_heads",), "A_log": ("ssm_heads",), "D": ("ssm_heads",),
    "norm": ("d_inner",),
    "w_out": ("d_inner", "d_model"),
    "scale": (None,), "bias": (None,),
}

CACHE_LOGICAL = {
    "k": ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
    "k_scale": ("cache_batch", "cache_seq", "kv_heads"),
    "v_scale": ("cache_batch", "cache_seq", "kv_heads"),
    "pos": ("cache_batch", "cache_seq"),
    "ckv": ("cache_batch", "cache_seq", "kv_lora"),
    "kr": ("cache_batch", "cache_seq", "head_dim"),
    "conv_x": ("cache_batch", None, "d_inner"),
    "conv_B": ("cache_batch", None, "state"),
    "conv_C": ("cache_batch", None, "state"),
    "state": ("cache_batch", "ssm_heads", "head_dim", "state"),
}

SERVE_PARAM_RULES = dict(PARAM_RULES, d_model=("data",))


# ---------------------------------------------------------------------------
# Specs and shardings
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry a dim: a mesh axis name, a tuple of names, or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and a ``PartitionSpec``: where each dim of a tensor lies."""
    mesh: Mesh
    spec: PartitionSpec

    def shards(self) -> int:
        """How many pieces the spec cuts a tensor into (1: replicated)."""
        n = 1
        for axes in self.spec:
            if axes is None:
                continue
            for ax in (axes if isinstance(axes, tuple) else (axes,)):
                n *= self.mesh.shape[ax]
        return n


# ---------------------------------------------------------------------------
# Context + resolution
# ---------------------------------------------------------------------------

class _Ctx(threading.local):
    mesh: Optional[Mesh] = None
    mode: str = "train"


_ctx = _Ctx()


@contextmanager
def sharding_ctx(mesh: Optional[Mesh], mode: str = "train"):
    prev = (_ctx.mesh, _ctx.mode)
    _ctx.mesh, _ctx.mode = mesh, mode
    try:
        if mesh is not None and mesh.is_spmd:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _ctx.mesh, _ctx.mode = prev


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute of a
    checkpointed block runs under the sharding context its forward ran
    under. The context is thread-local, and on the card autograd runs the
    backward pass, recompute included, in a thread of its own."""
    return nullcontext(), sharding_ctx(_ctx.mesh, _ctx.mode)


def current_mesh() -> Optional[Mesh]:
    return _ctx.mesh


def current_mode() -> str:
    return _ctx.mode


def resolve_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh: Mesh, rules: dict) -> PartitionSpec:
    """Greedy shape-aware assignment of mesh axes to logical dims."""
    assert len(shape) == len(logical), (shape, logical)
    order = sorted(range(len(shape)), key=lambda i: PRIORITY.get(logical[i], 99))
    used: set = set()
    assign: list = [[] for _ in shape]
    for i in order:
        name = logical[i]
        if name is None:
            continue
        prod = 1
        for ax in rules.get(name, ()):
            if ax in used or ax not in mesh.shape:
                continue
            sz = mesh.shape[ax]
            if shape[i] % (prod * sz) == 0:
                assign[i].append(ax)
                used.add(ax)
                prod *= sz
    parts = tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                  for a in assign)
    return PartitionSpec(*parts)


def _one_device(mesh: Mesh, what: str) -> Optional[torch.device]:
    """The mesh's one distinct device (None for an abstract mesh); raises
    for more: one process drives such a mesh, and sharding across devices
    takes a process a device."""
    devs = mesh.distinct_devices
    if len(devs) > 1:
        raise NotImplementedError(
            f"{what} on a single-controller mesh of {len(devs)} distinct "
            f"devices ({mesh}) has no SPMD runtime: shard across devices on "
            "a mesh of ranks, one process a device "
            "(repro_torch.sharding.spmd.spmd_mesh)")
    return devs[0] if devs else None


def _to_spec(x: torch.Tensor, mesh: Mesh, spec: PartitionSpec):
    """``x`` as a DTensor laid out as ``spec`` on a mesh of ranks: a DTensor
    redistributed (collectives where its layout differs); a plain tensor,
    which every rank holds whole (on the host or on its device), cut to
    this rank's shard before it is copied to the rank's device, so a host
    tensor sends only that shard."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.spmd import placements, shard_of
    pl = placements(spec, mesh)
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == pl else x.redistribute(
            mesh.device_mesh, pl)
    return shard_of(x, mesh.device_mesh, pl, mesh.local_device)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The sharding constraint of logical axis names (see the module
    docstring): on a mesh of ranks ``x`` laid out as the resolved spec,
    elsewhere ``x`` itself."""
    mesh = _ctx.mesh
    if mesh is None:
        return x
    assert len(logical) == x.ndim, (x.shape, logical)
    if mesh.is_spmd:
        spec = resolve_spec(tuple(x.shape), logical, mesh,
                            ACT_RULES[_ctx.mode])
        return _to_spec(x, mesh, spec)
    _one_device(mesh, "constrain")
    return x


def place(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``x`` laid out as its sharding says: on a mesh of ranks a DTensor of
    which this rank keeps its shard (``distribute_tensor``; nothing is
    sent); on a mesh of one distinct device ``x.to(device)`` (``x`` itself
    when it is there already)."""
    mesh = sharding.mesh
    if mesh.is_spmd:
        return _to_spec(x, mesh, sharding.spec)
    dev = _one_device(mesh, "place")
    if dev is None:
        raise ValueError("an abstract mesh has no device to place a tensor on")
    return x.to(dev)


# ---------------------------------------------------------------------------
# Sharding trees for params / caches / optimizer state
# ---------------------------------------------------------------------------

def _leaf_name(path) -> str:
    for p in reversed(path):
        if hasattr(p, "key"):
            return str(p.key)
    return ""


def _is_stacked(path) -> bool:
    return any(getattr(p, "key", None) == "stacked" for p in path)


def _spec_for_leaf(path, leaf, table, mesh, rules) -> NamedSharding:
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    logical = table.get(name)
    if logical is None:
        return NamedSharding(mesh, P())          # unknown -> replicate
    extra = len(shape) - len(logical)            # leading scan-stack axes
    if extra < 0:
        return NamedSharding(mesh, P())          # rank mismatch -> replicate
    logical = (None,) * extra + tuple(logical)
    return NamedSharding(mesh, resolve_spec(shape, logical, mesh, rules))


def _map_with_path(fn, tree):
    leaves, spec = pytree.tree_flatten_with_path(tree)
    return pytree.tree_unflatten([fn(p, l) for p, l in leaves], spec)


def param_sharding(tree, mesh: Mesh, mode: str = "train"):
    """NamedSharding tree for a parameter tree (tensors, ``meta`` tensors or
    ``TensorSpec`` stand-ins).

    Train uses cross-pod ZeRO (d_model over (pod,data)); serve/prefill keep
    parameters pod-replicated: gathering weights across pods a decode step
    is never right."""
    rules = PARAM_RULES if mode == "train" else SERVE_PARAM_RULES
    return _map_with_path(
        lambda p, l: _spec_for_leaf(p, l, PARAM_LOGICAL, mesh, rules), tree)


def cache_sharding(tree, mesh: Mesh, mode: str = "serve"):
    return _map_with_path(
        lambda p, l: _spec_for_leaf(p, l, CACHE_LOGICAL, mesh,
                                    ACT_RULES[mode]), tree)


def batch_sharding(tree, mesh: Mesh, mode: str = "train"):
    """Input batches: dim0 = batch, trailing dims replicated."""
    rules = ACT_RULES[mode]

    def leaf(path, l):
        logical = ("batch",) + (None,) * (len(l.shape) - 1)
        return NamedSharding(mesh, resolve_spec(tuple(l.shape), logical,
                                                mesh, rules))
    return _map_with_path(leaf, tree)


def replicated(tree, mesh: Mesh):
    return pytree.tree_map(lambda _: NamedSharding(mesh, P()), tree)
