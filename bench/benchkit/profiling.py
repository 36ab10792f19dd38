"""The reduction of a ``torch.profiler`` trace to what the metrics read.

Device time is the union of the intervals in which an operation (a kernel,
a copy, a fill) ran on the card; a kernel's time is the sum of its
launches' durations; an idle gap is a stretch between device operations,
named by the benchmark's host span (``bench.admit`` / ``bench.step``)
that covers its middle, or ``host`` where none does.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple


class Trace:
    def __init__(self, device: List[Tuple[str, int, int]],
                 host: List[Tuple[str, int, int]], t0_ns: int, t1_ns: int):
        self.device = device          # (name, start ns, end ns)
        self.host = host              # (span name, start ns, end ns)
        self.t0, self.t1 = t0_ns, t1_ns
        merged = []
        for _, s, e in sorted(device, key=lambda x: x[1]):
            s, e = max(s, t0_ns), min(e, t1_ns)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.merged = merged

    @classmethod
    def from_profiler(cls, prof, t0_ns: int, t1_ns: int) -> "Trace":
        import torch
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a host span's mirror on the device timeline is no device
                # work
                if e.duration_ns() > 0 and not _annotation(e.name()):
                    device.append((e.name(), e.start_ns(),
                                   e.start_ns() + e.duration_ns()))
            elif e.name().startswith("bench."):
                host.append((e.name(), e.start_ns(),
                             e.start_ns() + e.duration_ns()))
        # the stamps bracket the traced iterations on the host's clock; the
        # trace's own first and last operations bound them where they differ
        if device:
            t0_ns = min(t0_ns, min(s for _, s, _ in device))
            t1_ns = max(t1_ns, max(e for _, _, e in device))
        return cls(device, host, t0_ns, t1_ns)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged) / 1e9

    def kernel_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device if rx.search(n)) / 1e9

    def top_ops(self, n: int = 10) -> list:
        tot = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list:
        edges = [self.t0] + [x for se in self.merged for x in se] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((s + e) // 2), (e - s) / 1e9]
                for s, e in gaps[:n]]

    def _host_at(self, t: int) -> str:
        for name, s, e in self.host:
            if s <= t <= e:
                return name
        return "host"


def _annotation(name: str) -> bool:
    return name.startswith("bench.")


def _short(name: str, limit: int = 120) -> str:
    name = re.sub(r"\s+", " ", name)
    return name if len(name) <= limit else name[:limit - 3] + "..."


def roofline_share(bound_s: float, device_s: float) -> Optional[float]:
    """A kernel's share of its roofline in percent, or None where the trace
    holds none of its launches."""
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
