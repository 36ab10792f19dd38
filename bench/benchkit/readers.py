"""What the per-layer metric files share: the records of a window, and a
kernel's bounds over the traced iterations."""
from __future__ import annotations

from typing import Optional

import numpy as np


def in_window(run, items):
    ws, we = run.window
    return [x for x in items if ws <= x.t0 and x.t1 <= we]


def traced(items):
    return [x for x in items if x.traced]


def wall_ms(items) -> Optional[float]:
    if not items:
        return None
    return 1e3 * sum(x.t1 - x.t0 for x in items) / len(items)


def step_flops(run, dispatches, steps) -> float:
    c = run.counts
    return (sum(c.prefill_flops(d.lengths) for d in dispatches)
            + sum(c.decode_flops(s.keys) for s in steps))


def share_of_peak(run, flops: float, seconds: float) -> Optional[float]:
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (seconds * run.peak_flops)


def bound_s(run, flops: float, bytes_: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / run.peak_flops, bytes_ / run.peak_bytes)


def device_idle(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def percentile_ms(values, q) -> Optional[float]:
    return 1e3 * float(np.percentile(values, q)) if values else None
