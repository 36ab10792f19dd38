"""Bounded ring time-series: fixed capacity, O(1) hot append, and
resolution that COARSENS instead of forgetting.

The tracer's deferred-write discipline (one lock-free append on the hot
thread, all expansion at read time) is kept: ``RingSeries.append`` is a
handful of attribute ops and one list append — no lock, no allocation
beyond the point itself. When the ring fills it does not drop history;
it merges adjacent points pairwise (mean value, bucket-end timestamp)
and doubles its aggregation stride, so a series that has run for hours
still spans its whole life at progressively coarser resolution — the
shape an operator needs ("when did busy_frac start climbing?"), not the
last 4096 samples of it.

``Sampler`` is the continuous half of the plane: a background thread
that snapshots the metrics registry every ``interval_s`` and derives
per-instrument series — counter RATES (``<name>.rate``, events/s over
the sample window), gauge values, histogram WINDOW means
(``<name>.mean``), plus a ``<prefix>.hit_rate`` for every
``hits``/``misses`` counter pair (the chunk caches). It reads
``snapshot()`` like any other consumer; the instrumented hot paths
never know it exists, which is what keeps the fig_health on/off
throughput gate honest.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["RingSeries", "Sampler", "DEFAULT_CAPACITY"]

#: default point budget per series — at the Sampler's 2 Hz this holds
#: ~4 minutes at full resolution, a day at stride 512
DEFAULT_CAPACITY = 512


class RingSeries:
    """Fixed-capacity (t, v) series with pairwise downsampling on
    overflow.

    ``stride`` is how many raw appends one stored point aggregates
    (mean). It starts at 1; every time the store reaches ``capacity``
    the points merge pairwise and the stride doubles — append stays
    O(1) amortized and the memory bound is ``capacity`` points forever.
    """

    __slots__ = ("capacity", "stride", "n_appended",
                 "_points", "_acc_v", "_acc_n", "_acc_t")

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 8:
            raise ValueError(f"capacity must be >= 8, got {capacity}")
        # even capacity so the pairwise merge halves exactly
        self.capacity = capacity + (capacity % 2)
        self.stride = 1
        self.n_appended = 0
        self._points: List[Tuple[float, float]] = []
        self._acc_v = 0.0       # current bucket: sum / count / last t
        self._acc_n = 0
        self._acc_t = 0.0

    # -- hot path ---------------------------------------------------------
    def append(self, t: float, v: float) -> None:
        """One sample. Lock-free: list.append is GIL-atomic and readers
        only ever see a fully-built points list (compaction swaps in a
        new list object)."""
        self.n_appended += 1
        self._acc_v += v
        self._acc_n += 1
        self._acc_t = t
        if self._acc_n < self.stride:
            return
        pts = self._points
        pts.append((self._acc_t, self._acc_v / self._acc_n))
        self._acc_v, self._acc_n = 0.0, 0
        if len(pts) >= self.capacity:
            # pairwise merge: keep the later timestamp (bucket end),
            # mean the values; resolution halves, extent is kept
            self._points = [
                (pts[i + 1][0], 0.5 * (pts[i][1] + pts[i + 1][1]))
                for i in range(0, len(pts) - 1, 2)]
            self.stride *= 2

    # -- reads ------------------------------------------------------------
    def points(self) -> List[Tuple[float, float]]:
        """Stored points plus the live partial bucket (so the newest
        sample is always visible)."""
        out = list(self._points)
        n = self._acc_n
        if n:
            out.append((self._acc_t, self._acc_v / n))
        return out

    def tail(self, n: int) -> List[Tuple[float, float]]:
        return self.points()[-max(0, int(n)):]

    def last(self) -> Optional[Tuple[float, float]]:
        pts = self.points()
        return pts[-1] if pts else None

    def __len__(self) -> int:
        return len(self._points) + (1 if self._acc_n else 0)

    def summary(self) -> dict:
        pts = self.points()
        vs = [v for _, v in pts]
        return {
            "n_points": len(pts), "n_appended": self.n_appended,
            "stride": self.stride,
            "t0": pts[0][0] if pts else None,
            "t1": pts[-1][0] if pts else None,
            "min": min(vs) if vs else None,
            "max": max(vs) if vs else None,
            "mean": sum(vs) / len(vs) if vs else None,
        }


class Sampler:
    """Background instrument sampler: every ``interval_s`` it reads one
    registry ``snapshot()`` and appends derived series points —
    completely off every hot path (its cost is one snapshot under the
    registry lock per tick).

    Derived series, per instrument kind:

    - counter ``name``      -> ``name.rate``   (delta / dt, events/s)
    - gauge ``name``        -> ``name``        (the value)
    - histogram ``name``    -> ``name.mean``   (window sum / window count;
                                               no point when the window
                                               saw no observations)
    - counters ``p.hits`` + ``p.misses`` -> ``p.hit_rate`` (window ratio)
    """

    def __init__(self, registry=None, interval_s: float = 0.5,
                 capacity: int = DEFAULT_CAPACITY) -> None:
        if registry is None:
            from repro_torch.obs.metrics import REGISTRY as registry
        self.registry = registry
        self.interval_s = max(0.05, float(interval_s))
        self.capacity = capacity
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev: Optional[dict] = None
        self._prev_t = 0.0
        self.ticks = 0

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "Sampler":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-sampler")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
        self._thread = None

    # -- one tick ---------------------------------------------------------
    def sample_once(self, now: Optional[float] = None) -> int:
        """Take one sample; returns the number of series points written.
        Public so tests (and the flight recorder) can drive it without
        the thread."""
        now = time.time() if now is None else now
        snap = self.registry.snapshot()
        prev, prev_t = self._prev, self._prev_t
        self._prev, self._prev_t = snap, now
        if prev is None:
            return 0
        dt = max(now - prev_t, 1e-9)
        gauges = self.registry.gauge_names()
        wrote = 0

        def put(name: str, v: float) -> None:
            nonlocal wrote
            self.registry.series_append(name, now, float(v),
                                        maxlen=self.capacity)
            wrote += 1

        window: Dict[str, float] = {}
        for name, v in snap.items():
            p = prev.get(name)
            if isinstance(v, dict):          # histogram: window mean
                if isinstance(p, dict):
                    dc = v.get("count", 0) - p.get("count", 0)
                    if dc > 0:
                        put(f"{name}.mean",
                            (v.get("sum", 0.0) - p.get("sum", 0.0)) / dc)
            elif name in gauges:
                put(name, v)
            elif isinstance(p, (int, float)):
                d = v - p
                window[name] = d
                put(f"{name}.rate", d / dt)
        # hit-rate pairs (chunk caches, anything sharing the idiom)
        for name, d_hits in window.items():
            if not name.endswith(".hits"):
                continue
            d_miss = window.get(name[:-5] + ".misses")
            if d_miss is None or d_hits + d_miss <= 0:
                continue
            put(name[:-5] + ".hit_rate", d_hits / (d_hits + d_miss))
        self.ticks += 1
        return wrote

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                # a sampler crash must never take anything else down;
                # next tick retries
                self._prev = None
