"""Elastic scaling: restore any checkpoint onto a different mesh. Port of
``repro.runtime.elastic``.

A job checkpointed on mesh A restarts on mesh B: ``reshard_state``
recomputes the ``NamedSharding`` tree for the new mesh from the same logical
rules and places the state's tensors. No layout metadata is stored in the
checkpoint — the logical-axis rules ARE the layout, so any mesh the rules
can resolve against is a valid restore target (``ckpt.restore(...,
sharding=state_sharding(state, mesh))``).

Placing follows ``sharding.partition.place``: on a mesh of ranks
(``sharding.spmd.spmd_mesh``) each rank keeps only its shard of each leaf
(a DTensor; the state, whole on every rank, is cut where it lies and
nothing is sent between ranks); on a mesh of one distinct device every
tensor moves to it (``.to``: a tensor already there is kept as it is, at
its address); a single-controller mesh of more than one distinct device
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.partition import param_sharding, place


def state_sharding(state: Any, mesh: Mesh) -> Any:
    """Sharding tree for a full train state (params + adam moments)."""
    return param_sharding(state, mesh)


def reshard_state(state: Any, mesh: Mesh) -> Any:
    """Place a state tree onto ``mesh``."""
    return pytree.tree_map(place, state, state_sharding(state, mesh))
