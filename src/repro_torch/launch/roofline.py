"""Roofline bounds of a step on NVIDIA H100s. Port of
``repro.launch.roofline``, as a Hopper instrument.

Three terms per (arch x shape x mesh), in seconds per step:

  compute    = flops a chip / PEAK_FLOPS
  memory     = bytes a chip must move / HBM_BW
  collective = collective bytes a chip / LINK_BW

The roofline step time is the largest term (perfect overlap). The caller
supplies each count: ``launch.dryrun`` takes the flops from the op counter
(``launch.op_analysis``: the flops the step executes, remat's recompute
included), the bytes that must move at least once from the sharded state
(static bytes per device, less a forward step's input-embedding rows that
no token gathers: a lower bound, so a share of a measured step over this
bound never reads above 100% while the counts are right), and the
collective bytes from nothing yet: PyTorch has no HLO, so
the reference's ``parse_collectives`` has no input, and a mesh of more than
one device gets ``collective_bytes=None`` (term 0, not counted).

Constants: the H100 SXM data sheet, each for the card every measurement of
this repository ran on, as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints it: ``NVIDIA H100 80GB HBM3, 700.00 W``.
A card whose power limit is set lower runs slower under load than these.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

PEAK_FLOPS = 989e12      # bf16 dense tensor-core FLOP/s; NVIDIA H100 80GB HBM3, 700.00 W
HBM_BW = 3.35e12         # HBM3 bytes/s; NVIDIA H100 80GB HBM3, 700.00 W
LINK_BW = 450e9          # NVLink bytes/s a direction; NVIDIA H100 80GB HBM3, 700.00 W


@dataclass
class CollectiveStats:
    """Collectives by kind (the reference's HLO names: ``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-broadcast``): how many, and their operand bytes a rank."""
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int):
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def merge(self, other: "CollectiveStats", sign: int = 1):
        """Add (``sign=-1``: take out) ``other``'s collectives; a kind
        that falls to none leaves the table."""
        for k, v in other.bytes_by_kind.items():
            n = self.count_by_kind.get(k, 0) + sign * other.count_by_kind[k]
            if n:
                self.count_by_kind[k] = n
                self.bytes_by_kind[k] = self.bytes_by_kind.get(k, 0) + sign * v
            else:
                self.count_by_kind.pop(k, None)
                self.bytes_by_kind.pop(k, None)

    def table(self) -> dict:
        """``{kind: [count, bytes]}``, the dry run row's ``collectives``."""
        return {k: [self.count_by_kind[k], int(v)]
                for k, v in self.bytes_by_kind.items()}


@dataclass
class Roofline:
    flops: float                          # a chip's
    hbm_bytes: float                      # a chip's, that must move
    collective_bytes: Optional[float]     # a chip's; None: not counted
    model_flops: float = 0.0              # the whole step's
    chips: int = 1

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return (self.collective_bytes or 0.0) / LINK_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        """No-overlap upper bound is sum; perfectly-overlapped bound is max.
        We report max (the roofline)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        """model flops / counted flops (per-chip-normalized)."""
        if self.flops <= 0:
            return 0.0
        return self.model_flops / self.chips / self.flops

    @property
    def mfu_bound(self) -> float:
        """Model-flops utilization at the roofline step time."""
        if self.t_step <= 0:
            return 0.0
        return (self.model_flops / self.chips / self.t_step) / PEAK_FLOPS

    def row(self) -> dict:
        return {
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bound": self.bound,
            "t_step": self.t_step, "useful_flops_frac": self.useful_flops_frac,
            "mfu_bound": self.mfu_bound,
            "flops_per_chip": self.flops, "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
        }
