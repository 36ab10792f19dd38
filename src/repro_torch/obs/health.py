"""Per-node health scoring: robust outlier detection over shard walls
and heartbeat gaps.

The registry's three-state lease health (alive/suspect/dead) answers
"is the node THERE"; this module answers "is the node WELL". A node can
hold its lease perfectly while running every shard 50x slower than its
peers — at fleet width that one node sets the wave wall, and post-hoc
log reading does not find it. The scorer keeps a short window of
per-node samples (seconds-per-instance from ``observe_shard``,
beat-to-beat gaps from ``heartbeat``) and, on each ``evaluate``, runs a
cross-node robust z-test:

    z = (node_recent - fleet_median) / max(1.4826*MAD,
                                           rel_floor*median, abs_floor)

Median/MAD instead of mean/stddev so one sick node cannot drag the
baseline toward itself; ``rel_floor`` keeps a homogeneous fleet (MAD ~0)
from flagging ordinary jitter; only the slow side (z > 0) is anomalous.

Verdicts are ``healthy`` / ``degraded`` / ``outlier`` with a hysteresis
band: a node enters ``outlier`` at ``enter_z`` but only returns to
``healthy`` below ``exit_z`` (< enter_z), and the per-node "recent"
statistic is the median of its last ``window`` samples — so one GIL
hiccup (a single slow sample) can never flip a verdict, and a flagged
node cannot flap on the boundary.

The scorer owns its own tiny deques (one append per completed shard /
heartbeat — negligible against either event), so verdicts work even
with the metrics registry disabled; mirrored time-series for the status
endpoint ride the registry only while it is enabled.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["HEALTHY", "DEGRADED", "OUTLIER", "HealthScorer",
           "robust_zscores"]

HEALTHY = "healthy"
DEGRADED = "degraded"
OUTLIER = "outlier"


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    m = n // 2
    return s[m] if n % 2 else 0.5 * (s[m - 1] + s[m])


def robust_zscores(values: Dict[str, float], rel_floor: float = 0.5,
                   abs_floor: float = 1e-4) -> Dict[str, float]:
    """Median/MAD z-scores across a {node: value} dict. The scale is
    floored at ``rel_floor * |median|`` and ``abs_floor`` so a
    homogeneous fleet (MAD ~ 0) never divides by noise."""
    if len(values) < 2:
        return {k: 0.0 for k in values}
    vs = list(values.values())
    med = _median(vs)
    mad = _median([abs(v - med) for v in vs])
    scale = max(1.4826 * mad, rel_floor * abs(med), abs_floor)
    return {k: (v - med) / scale for k, v in values.items()}


class HealthScorer:
    """Windowed per-node samples -> hysteresis-banded verdicts."""

    def __init__(self, enter_z: float = 6.0, exit_z: float = 3.0,
                 degraded_z: float = 3.0, window: int = 8,
                 min_peers: int = 3, rel_floor: float = 0.5,
                 abs_floor: float = 1e-4) -> None:
        if not exit_z <= degraded_z <= enter_z:
            raise ValueError(
                f"need exit_z <= degraded_z <= enter_z, got "
                f"{exit_z}/{degraded_z}/{enter_z}")
        self.enter_z = enter_z
        self.exit_z = exit_z
        self.degraded_z = degraded_z
        self.window = max(1, int(window))
        self.min_peers = max(2, int(min_peers))
        self.rel_floor = rel_floor
        self.abs_floor = abs_floor
        self._wall: Dict[str, deque] = {}
        self._gap: Dict[str, deque] = {}
        self._verdict: Dict[str, str] = {}
        self._z: Dict[str, float] = {}
        self._lock = threading.Lock()

    # -- feeds (hot-ish: one deque append, per shard / per beat) ----------
    def observe_wall(self, node_id: str, wall_per_instance: float) -> None:
        if wall_per_instance <= 0:
            return
        d = self._wall.get(node_id)
        if d is None:
            with self._lock:
                d = self._wall.setdefault(
                    node_id, deque(maxlen=self.window))
        d.append(wall_per_instance)

    def observe_gap(self, node_id: str, gap_s: float) -> None:
        if gap_s <= 0:
            return
        d = self._gap.get(node_id)
        if d is None:
            with self._lock:
                d = self._gap.setdefault(
                    node_id, deque(maxlen=self.window))
        d.append(gap_s)

    def forget(self, node_id: str) -> None:
        """A node re-registered (new incarnation): its history — and any
        verdict earned by the dead incarnation — no longer applies."""
        with self._lock:
            self._wall.pop(node_id, None)
            self._gap.pop(node_id, None)
            self._verdict.pop(node_id, None)
            self._z.pop(node_id, None)

    # -- evaluation -------------------------------------------------------
    def _recent(self, series: Dict[str, deque]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for nid, d in list(series.items()):
            if d:
                out[nid] = _median(list(d))
        return out

    def evaluate(self) -> Dict[str, str]:
        """Recompute every node's verdict; returns {node_id: verdict}.
        Called per wave (and by the status endpoint) — O(nodes log
        nodes), never on a per-frame path."""
        with self._lock:
            zs: Dict[str, float] = {}
            for series in (self._wall, self._gap):
                recent = self._recent(series)
                if len(recent) < self.min_peers:
                    continue
                for nid, z in robust_zscores(
                        recent, self.rel_floor, self.abs_floor).items():
                    zs[nid] = max(zs.get(nid, 0.0), z)
            seen = set(self._wall) | set(self._gap)
            for nid in seen:
                z = zs.get(nid, 0.0)
                self._z[nid] = z
                cur = self._verdict.get(nid, HEALTHY)
                if cur == OUTLIER:
                    # hysteresis: flagged stays flagged until well clear
                    if z < self.exit_z:
                        cur = HEALTHY
                elif z >= self.enter_z:
                    cur = OUTLIER
                elif z >= self.degraded_z:
                    cur = DEGRADED
                elif z < self.exit_z:
                    cur = HEALTHY
                # degraded_z > z >= exit_z from DEGRADED: hold the band
                self._verdict[nid] = cur
            return dict(self._verdict)

    # -- reads ------------------------------------------------------------
    def verdicts(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._verdict)

    def verdict(self, node_id: str) -> str:
        with self._lock:
            return self._verdict.get(node_id, HEALTHY)

    def zscore(self, node_id: str) -> float:
        with self._lock:
            return self._z.get(node_id, 0.0)

    def detail(self) -> Dict[str, dict]:
        """Per-node verdict + score + recent stats (the /fleet payload)."""
        with self._lock:
            walls = self._recent(self._wall)
            gaps = self._recent(self._gap)
            out: Dict[str, dict] = {}
            for nid in set(walls) | set(gaps) | set(self._verdict):
                out[nid] = {
                    "verdict": self._verdict.get(nid, HEALTHY),
                    "z": round(self._z.get(nid, 0.0), 3),
                    "wall_per_instance_s": walls.get(nid),
                    "beat_gap_s": gaps.get(nid),
                }
            return out
