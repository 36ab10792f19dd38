"""Process-local metrics registry: counters, gauges, fixed-bucket
histograms.

Design constraints (from the fig_obs ≤3% overhead gate):

- Hot-path writes are a single attribute add/assign under the GIL — no
  locks, no allocation. Counts are best-effort under concurrent writers
  (two racing ``+=`` may drop an increment); for launch forensics that is
  the right trade.
- Instruments are created once (registry lookup under a lock) and cached
  by the instrumented object; the per-event path never touches the
  registry dict.
- Reads are snapshot/delta: ``snapshot()`` returns plain dicts safe to
  serialize; ``delta(prev)`` subtracts counter-like values so a benchmark
  can attribute activity to one measured window.

Node-side worker loops keep their own :class:`MetricsRegistry` and ship
``snapshot()`` dicts home piggybacked on HEARTBEAT frames; the scheduler
stores them per node via :meth:`MetricsRegistry.ingest_node`.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.timeseries import DEFAULT_CAPACITY, RingSeries

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "StatsDict", "counter", "gauge", "histogram",
]


class Counter:
    """Monotonic event count. ``inc()`` is one int add."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-write-wins instantaneous value (queue depth, occupancy)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def max(self, v: float) -> None:
        if v > self.value:
            self.value = v

    def reset(self) -> None:
        self.value = 0.0


# Default bounds suit sub-second launch-path latencies (seconds).
DEFAULT_BOUNDS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """Fixed-bucket histogram: counts[i] is observations <= bounds[i];
    the final bucket is the +inf overflow. No per-observation allocation."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS) -> None:
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = 0
        bounds = self.bounds
        n = len(bounds)
        while i < n and v > bounds[i]:
            i += 1
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile (0..1)."""
        if not self.count:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.bounds[i] if i < len(self.bounds) else float("inf")
        return float("inf")

    def as_dict(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0


class MetricsRegistry:
    """Named instruments plus per-node ingested snapshots.

    ``enabled`` is a plain attribute so hot paths can guard with a single
    attribute read; instruments themselves never check it — the call site
    decides (per-frame sites guard, per-wave sites record unconditionally).
    """

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._series: Dict[str, RingSeries] = {}
        self._node: Dict[str, dict] = {}
        # cross-incarnation node accounting: a dead incarnation's final
        # snapshot folds into _node_base (so rollups keep its totals);
        # _node_inc remembers which incarnation the live snapshot came
        # from so a zombie that never actually restarted can be unfolded
        self._node_base: Dict[str, dict] = {}
        self._node_inc: Dict[str, Optional[str]] = {}
        self._node_tomb: Dict[str, Tuple[Optional[str], dict]] = {}

    # -- lifecycle --------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Zero every instrument IN PLACE. Long-lived components (the
        frame pump, node worker loops) cache direct references to their
        instruments at construction; a clear that dropped the objects
        would silently orphan those references from every later
        snapshot."""
        with self._lock:
            for c in self._counters.values():
                c.reset()
            for g in self._gauges.values():
                g.reset()
            for h in self._hists.values():
                h.reset()
            self._series.clear()
            self._node.clear()
            self._node_base.clear()
            self._node_inc.clear()
            self._node_tomb.clear()

    # -- instrument factories (memoized by name) --------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BOUNDS) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(bounds)
            return h

    # -- time series ------------------------------------------------------

    def series_append(self, name: str, t: float, v: float,
                      maxlen: int = DEFAULT_CAPACITY) -> None:
        """Append one (t, v) point to a bounded ring series. The ring
        (``repro_torch.obs.timeseries.RingSeries``) downsamples pairwise on
        overflow instead of dropping history; the hot path is one
        lock-free append (the registry lock is taken only on first
        creation of a series)."""
        s = self._series.get(name)
        if s is None:
            with self._lock:
                s = self._series.setdefault(name, RingSeries(maxlen))
        s.append(t, v)

    def series(self, name: str) -> List[Tuple[float, float]]:
        s = self._series.get(name)
        return s.points() if s is not None else []

    def series_tail(self, name: str, n: int) -> List[Tuple[float, float]]:
        s = self._series.get(name)
        return s.tail(n) if s is not None else []

    def series_names(self) -> List[str]:
        with self._lock:
            return list(self._series)

    def gauge_names(self) -> set:
        with self._lock:
            return set(self._gauges)

    # -- reads ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Flat name -> value dict (histograms expand to bucket dicts)."""
        with self._lock:
            out: dict = {}
            for name, c in self._counters.items():
                out[name] = c.value
            for name, g in self._gauges.items():
                out[name] = g.value
            for name, h in self._hists.items():
                out[name] = h.as_dict()
            return out

    def delta(self, prev: Optional[dict]) -> dict:
        """Current snapshot minus ``prev``: counters and histogram
        counts/sums subtract; gauges report their latest value."""
        cur = self.snapshot()
        if not prev:
            return cur
        out: dict = {}
        gauges = set(self._gauges)
        for name, v in cur.items():
            p = prev.get(name)
            if isinstance(v, dict):  # histogram
                if isinstance(p, dict) and p.get("bounds") == v["bounds"]:
                    out[name] = {
                        "bounds": v["bounds"],
                        "counts": [a - b for a, b in
                                   zip(v["counts"], p["counts"])],
                        "sum": v["sum"] - p["sum"],
                        "count": v["count"] - p["count"],
                    }
                else:
                    out[name] = v
            elif name in gauges or not isinstance(p, (int, float)):
                out[name] = v
            else:
                out[name] = v - p
        return out

    # -- node piggyback ---------------------------------------------------

    def ingest_node(self, node_id: str, snap: dict,
                    incarnation: Optional[str] = None) -> None:
        """Store a node's piggybacked snapshot (latest wins: node-side
        counters are cumulative, so the newest snapshot is the truth).

        ``incarnation`` is the worker loop's per-boot nonce. When a node
        the scheduler condemned re-registers under the same id, its dead
        incarnation's final snapshot was folded into a retained baseline
        (:meth:`retire_node`); a snapshot arriving with the SAME
        incarnation proves the worker never actually restarted (a zombie
        revived by re-register), so the fold is reversed — its cumulative
        counters already contain the "dead" totals and keeping the
        baseline would double-count them."""
        with self._lock:
            tomb = self._node_tomb.get(node_id)
            if (tomb is not None and incarnation is not None
                    and tomb[0] == incarnation):
                _merge_snap(self._node_base.setdefault(node_id, {}),
                            tomb[1], sign=-1)
                del self._node_tomb[node_id]
            self._node[node_id] = snap
            self._node_inc[node_id] = incarnation

    def retire_node(self, node_id: str) -> None:
        """A node's lease expired (or its id is being revived after
        death): fold its last snapshot into the retained per-node
        baseline so rollups keep the dead incarnation's totals while the
        fresh incarnation's counters restart from zero. Idempotent — a
        second retire with no new snapshot is a no-op."""
        with self._lock:
            snap = self._node.pop(node_id, None)
            if snap is None:
                return
            _merge_snap(self._node_base.setdefault(node_id, {}), snap)
            self._node_tomb[node_id] = (self._node_inc.pop(node_id, None),
                                        snap)

    def node_snapshots(self) -> Dict[str, dict]:
        """Live (current-incarnation) snapshots per node."""
        with self._lock:
            return dict(self._node)

    def nodes_rollup(self) -> dict:
        """Sum counter-like values across per-node snapshots — live
        incarnations plus retained dead-incarnation baselines; histograms
        merge bucket-wise when bounds agree."""
        with self._lock:
            per_node: Dict[str, dict] = {}
            for nid, base in self._node_base.items():
                _merge_snap(per_node.setdefault(nid, {}), base)
            for nid, snap in self._node.items():
                _merge_snap(per_node.setdefault(nid, {}), snap)
        out: dict = {}
        for snap in per_node.values():
            _merge_snap(out, snap)
        return out


def _merge_snap(out: dict, snap: dict, sign: int = 1) -> dict:
    """Accumulate one snapshot dict into ``out`` in place: numbers add,
    histograms merge bucket-wise when bounds agree (else the newcomer
    replaces). ``sign=-1`` subtracts — used to reverse a baseline fold
    when a condemned node turns out to have been a zombie."""
    for name, v in snap.items():
        if isinstance(v, dict) and "counts" in v:
            h = out.get(name)
            if h is None or h.get("bounds") != list(v.get("bounds", ())):
                out[name] = {"bounds": list(v.get("bounds", ())),
                             "counts": [sign * c for c in v["counts"]],
                             "sum": sign * v.get("sum", 0.0),
                             "count": sign * v.get("count", 0)}
            else:
                h["counts"] = [a + sign * b for a, b in
                               zip(h["counts"], v["counts"])]
                h["sum"] += sign * v.get("sum", 0.0)
                h["count"] += sign * v.get("count", 0)
        elif isinstance(v, (int, float)):
            out[name] = out.get(name, 0) + sign * v
    return out


#: Process-global registry. Scheduler-side instrumentation records here;
#: worker loops use their own instance (see the reference's repro.dist.node._worker_loop).
REGISTRY = MetricsRegistry()


class StatsDict(dict):
    """A dict-shaped stats table whose increments also land in the
    global registry as ``<prefix>.<key>`` counters while it is enabled.

    Existing modules keep their ``self.stats["hits"] += 1`` idiom (and
    tests keep reading the dict); the registry gets the same numbers,
    aggregated across every instance sharing a prefix (e.g. all node
    chunk caches of a thread-hosted fleet)."""

    __slots__ = ("_prefix", "_counters")

    def __init__(self, prefix: str, init: dict) -> None:
        super().__init__(init)
        self._prefix = prefix
        self._counters: Dict[str, Counter] = {}

    def __setitem__(self, key: str, value) -> None:
        if REGISTRY.enabled and isinstance(value, (int, float)):
            old = self.get(key, 0)
            if isinstance(old, (int, float)) and value > old:
                c = self._counters.get(key)
                if c is None:
                    c = self._counters[key] = REGISTRY.counter(
                        f"{self._prefix}.{key}")
                c.inc(value - old)
        super().__setitem__(key, value)


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, bounds: Sequence[float] = DEFAULT_BOUNDS) -> Histogram:
    return REGISTRY.histogram(name, bounds)
