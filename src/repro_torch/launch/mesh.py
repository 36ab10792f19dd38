"""Meshes: named axes over device positions. Port of ``repro.launch.mesh``.

A ``Mesh`` has axis names, a ``shape`` mapping (name -> size), a ``size``
and, unless it is abstract, the ``torch.device`` at each position. A mesh
may list one device at several positions: torch has one CPU device and a
machine may have one card, so a mesh over "the card twice" stands in for
the reference's fake host devices (``--xla_force_host_platform_device_count``).
An abstract mesh has no devices: the dry run (``launch.dryrun``) resolves
shardings against the production meshes without a card, and runs their
step on ``meta`` with every one of their 256 or 512 positions a rank of a
fake process group in one process (``sharding.spmd.counting``).

A mesh of ranks (``sharding.spmd.spmd_mesh``) carries the
``torch.distributed`` ``DeviceMesh`` of its process group
(``device_mesh``) and this rank's device (``local_device``): one process a
position, each holding its shard. Every other mesh is single-controller:
one process drives all of its positions.

Axis semantics, as in the reference: ``pod`` = cross-pod axis, ``data`` =
batch/FSDP axis, ``model`` = tensor/expert-parallel axis. Functions, not
module-level constants, so importing never touches the card.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device


class Mesh:
    """Named axes over device positions (see the module docstring).

    ``Mesh(devices, axis_names)``: ``devices`` a nested sequence (or numpy
    object array) of devices whose rank is the number of axes.
    ``Mesh.abstract(sizes, axis_names)``: the same axes without devices."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = np.asarray(devices, dtype=object)
        arr = np.empty(flat.shape, dtype=object)
        for idx, d in np.ndenumerate(flat):
            arr[idx] = torch.device(d)
        self._init(arr.shape, axis_names, arr)

    @classmethod
    def abstract(cls, sizes: Sequence[int],
                 axis_names: Sequence[str]) -> "Mesh":
        mesh = cls.__new__(cls)
        mesh._init(tuple(sizes), axis_names, None)
        return mesh

    def _init(self, sizes, axis_names, devices) -> None:
        if len(sizes) != len(axis_names):
            raise ValueError(f"mesh of shape {tuple(sizes)} needs "
                             f"{len(sizes)} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name: {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.sizes: Tuple[int, ...] = tuple(int(s) for s in sizes)
        self.shape = dict(zip(self.axis_names, self.sizes))
        self.devices: Optional[np.ndarray] = devices
        self.device_mesh = None          # set by sharding.spmd
        self.local_device: Optional[torch.device] = None

    @property
    def is_spmd(self) -> bool:
        """A mesh of ranks: one process a position (``sharding.spmd``)."""
        return self.device_mesh is not None

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes, dtype=np.int64))

    @property
    def is_abstract(self) -> bool:
        return self.devices is None

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the mesh, each once, in position order (empty for
        an abstract mesh)."""
        if self.devices is None:
            return ()
        return tuple(dict.fromkeys(self.devices.flat))

    def devices_along(self, axis: str) -> list:
        """The devices at the positions of ``axis``, every other axis at
        position 0."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        i = self.axis_names.index(axis)
        idx = [0] * len(self.sizes)
        out = []
        for j in range(self.sizes[i]):
            idx[i] = j
            out.append(self.devices[tuple(idx)])
        return out

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        devs = ("abstract" if self.devices is None else
                ", ".join(map(str, self.distinct_devices)))
        if self.is_spmd:
            devs = f"{self.size} ranks; this one on {self.local_device}"
        return f"Mesh({axes}; {devs})"


def mesh_device(mesh: Optional[Mesh]) -> Optional[torch.device]:
    """The device a one-device consumer of ``mesh`` runs on: its first
    device, this rank's on a mesh of ranks (None without a mesh or for an
    abstract one)."""
    if mesh is None or mesh.is_abstract:
        return None
    if mesh.is_spmd:
        return mesh.local_device
    return mesh.distinct_devices[0]


def make_production_mesh(*, multi_pod: bool = False,
                         pods: int = 2, data: int = 16, model: int = 16
                         ) -> Mesh:
    """The production mesh, abstract: (data, model) = (16, 16), or (pod,
    data, model) = (2, 16, 16) with ``multi_pod``. Shapes are configurable
    so the same rules drive larger deployments."""
    shape = (pods, data, model) if multi_pod else (data, model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.abstract(shape, axes)


def make_host_mesh(device=None) -> Mesh:
    """Whatever devices exist locally, as a D x 1 (data, model) mesh: the
    ``torch.cuda.device_count()`` cards (``device=None``: the card unless
    there is none, and then it raises), or ``device`` alone (``"cpu"``)."""
    dev = resolve_device(device)
    if device is None and dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    return Mesh([[d] for d in devs], ("data", "model"))
