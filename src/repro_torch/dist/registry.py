"""Node registry: membership, heartbeat leases, and health state.

The paper's launch tree assumes the scheduler KNOWS its nodes: an array
job is fanned over the nodes the scheduler believes are up, and a node
that stops answering is drained and its work re-queued. ``NodeRegistry``
is that knowledge for the distributed backend:

  * ``register`` admits a node with a capacity weight (its share of every
    wave); registering an existing id revives it — elastic join is just
    register-at-any-time, and the very next wave includes the newcomer;
  * ``heartbeat`` renews the node's lease. Staleness is computed by the
    SAME ``HeartbeatDetector`` that drives ``resilient_train`` restarts
    (``repro_torch.runtime.fault``) — one liveness clock for the whole repo.
    Heartbeats ARRIVE AS FRAMES now (``repro_torch.dist.transport``): the
    scheduler's frame pump routes HEARTBEAT frames here, and a dropped
    connection is condemned immediately via ``expire`` — lease expiry
    and a dead connection are one signal;
  * ``observe_shard`` feeds each completed shard's measured wall clock
    into a per-node cost-per-instance EWMA (``repro_torch.core.autoscale.Ewma``
    — the same smoothing the wave controller runs). The backend turns it
    into capacity re-weighting: a measured-slow node receives smaller
    shards on the very next wave;
  * health is three-state: ``alive`` -> ``suspect`` (no beat for
    ``suspect_frac * heartbeat_timeout_s``; excluded from NEW waves but
    not yet condemned) -> ``dead`` (lease expired; in-flight waves on it
    are failed and re-dispatched by the backend/policy layers). A suspect
    node that beats again recovers to alive; a dead node must re-register
    (its lease is gone — late beats from a zombie are ignored);
  * ``deregister`` is the graceful leave: the node drains and stops
    receiving waves without ever counting as a failure.

Scaling shape (the fleet refactor): the node table is SHARDED — each
shard owns a slice of the ids under its own lock with its own
``HeartbeatDetector``, so heartbeat/lease/observe_shard updates for
different nodes never contend on one global lock. Membership-changing
transitions bump a version counter, and the read-side snapshots
(``alive``/``usable``/``states``) are served from version-keyed caches:
at steady state (thousands of beats/s, zero membership churn) a dispatch
poll is a dict read, not an O(nodes) scan under a global lock.

The registry is pure bookkeeping — it never touches work queues. Who gets
which shard is the ``DistributedBackend``'s job; what happens to a dead
node's shard is the policy layer's (``LLMapReduce``) job.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.autoscale import Ewma
from repro_torch.obs import flight as _flight
from repro_torch.obs import metrics as _obs
from repro_torch.obs.health import HEALTHY, HealthScorer
from repro_torch.runtime.fault import HeartbeatDetector

#: relay-gap histogram buckets (seconds between successive beats from
#: one node, as seen scheduler-side — gaps approaching the lease mean
#: the relay path, not the node, is the risk)
_GAP_BOUNDS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
LEFT = "left"

#: default lock-shard count — plenty for hundreds of pump/worker threads
#: hammering leases, tiny enough that full scans stay cheap
DEFAULT_SHARDS = 8


@dataclass
class NodeInfo:
    """One registered node's lease + accounting."""
    node_id: str
    capacity: int = 1                 # weight in the wave shard split
    registered_at: float = 0.0
    state: str = ALIVE
    waves: int = 0                    # shards dispatched to this node
    instances: int = 0                # tasks dispatched to this node
    failures: int = 0                 # times this id's lease expired
    cost: Optional[Ewma] = None       # measured seconds/instance EWMA
    extra: dict = field(default_factory=dict)


class _Shard:
    """One lock-shard of the node table: its slice of the ids, their
    lease detector, and the lock both live under."""

    __slots__ = ("lock", "nodes", "detector", "last_beat")

    def __init__(self, heartbeat_timeout_s: float, clock):
        self.lock = threading.RLock()
        self.nodes: Dict[str, NodeInfo] = {}
        self.detector = HeartbeatDetector(timeout_s=heartbeat_timeout_s,
                                          clock=clock)
        # per-node previous-beat clock, feeding the relay-gap histogram
        # (only maintained while the metrics registry is enabled)
        self.last_beat: Dict[str, float] = {}


class NodeRegistry:
    """Register/heartbeat/lease-expiry with alive/suspect/dead health."""

    def __init__(self, heartbeat_timeout_s: float = 0.5,
                 suspect_frac: float = 0.5,
                 clock: Callable[[], float] = time.monotonic,
                 shards: int = DEFAULT_SHARDS):
        if not 0.0 < suspect_frac <= 1.0:
            raise ValueError(f"suspect_frac must be in (0, 1], "
                             f"got {suspect_frac}")
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.suspect_after_s = suspect_frac * heartbeat_timeout_s
        self.clock = clock
        self._shards = tuple(_Shard(heartbeat_timeout_s, clock)
                             for _ in range(max(1, int(shards))))
        # membership/health version: bumped on any transition that can
        # change what alive()/usable()/states() return; snapshot caches
        # below are keyed by it so steady-state reads are lock-free
        self._version = 0
        self._vlock = threading.Lock()
        self._alive_cache = (-1, [])
        self._usable_cache = (-1, [])
        self._states_cache = (-1, {})
        # rate limit: pollers call sweep() thousands of times a second,
        # but health can only change at heartbeat granularity — a sweep
        # within 1/20 of the lease of the previous one is a no-op (the
        # added detection latency is negligible against the lease itself)
        self._sweep_interval_s = heartbeat_timeout_s / 20.0
        self._last_sweep = float("-inf")
        self._m_registrations = _obs.counter("registry.registrations")
        self._m_renewals = _obs.counter("registry.renewals")
        self._m_expiries = _obs.counter("registry.expiries")
        self._m_relay_gap = _obs.histogram("registry.relay_gap_s",
                                           bounds=_GAP_BOUNDS)
        # per-node anomaly scoring (healthy/degraded/outlier) over shard
        # walls and beat gaps — orthogonal to the lease states above: a
        # node can hold its lease perfectly while running 50x slow
        self.health = HealthScorer()

    def _shard(self, node_id: str) -> _Shard:
        return self._shards[hash(node_id) % len(self._shards)]

    def _bump(self) -> None:
        with self._vlock:
            self._version += 1

    # -- membership --------------------------------------------------------
    def register(self, node_id: str, capacity: int = 1) -> NodeInfo:
        """Admit (or revive) a node. Idempotent: a re-register refreshes
        the lease and capacity — this IS the elastic-join path."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        now = self.clock()
        sh = self._shard(node_id)
        revived = False
        with sh.lock:
            info = sh.nodes.get(node_id)
            if info is None:
                info = NodeInfo(node_id, capacity, registered_at=now)
                sh.nodes[node_id] = info
            else:
                revived = info.state in (DEAD, LEFT)
            info.capacity = capacity
            info.state = ALIVE
            sh.detector.beat(node_id, now=now)
        if revived:
            # a dead/left id coming back is a NEW incarnation as far as
            # accounting goes: retire the old piggybacked metrics into
            # the per-node baseline (ingest_node unfolds it again if the
            # "new" node turns out to be the same incarnation — a zombie
            # whose beats were merely delayed) and drop health history
            # earned by the previous life
            _obs.REGISTRY.retire_node(node_id)
            self.health.forget(node_id)
        self._m_registrations.inc()
        self._bump()
        return info

    def deregister(self, node_id: str) -> None:
        """Graceful leave: the node stops receiving waves; not a failure."""
        sh = self._shard(node_id)
        with sh.lock:
            info = sh.nodes.get(node_id)
            if info is not None:
                info.state = LEFT
            sh.detector.forget(node_id)
            sh.last_beat.pop(node_id, None)
        self._bump()

    def heartbeat(self, node_id: str) -> bool:
        """Renew the lease. Returns False (beat ignored) for unknown,
        left, or already-condemned nodes — a zombie whose lease expired
        must ``register`` again, it cannot quietly resurrect while the
        fabric is re-dispatching its work."""
        sh = self._shard(node_id)
        recovered = False
        m_on = _obs.REGISTRY.enabled
        with sh.lock:
            info = sh.nodes.get(node_id)
            if info is None or info.state in (DEAD, LEFT):
                return False
            sh.detector.beat(node_id)
            if m_on:
                now = self.clock()
                prev = sh.last_beat.get(node_id)
                sh.last_beat[node_id] = now
                if prev is not None:
                    self._m_relay_gap.observe(now - prev)
                    self.health.observe_gap(node_id, now - prev)
            if info.state == SUSPECT:
                info.state = ALIVE
                recovered = True
        if m_on:
            self._m_renewals.inc()
        if recovered:
            self._bump()
        return True

    def expire(self, node_id: str) -> None:
        """Condemn a node NOW: its transport connection dropped, which is
        the same fact a lease expiry asserts (nobody will deliver its
        results) learned faster. A LEFT node stays left — a graceful
        leave's connection close is not a failure."""
        sh = self._shard(node_id)
        with sh.lock:
            info = sh.nodes.get(node_id)
            if info is None or info.state in (DEAD, LEFT):
                return
            info.state = DEAD
            info.failures += 1
            sh.detector.forget(node_id)
            sh.last_beat.pop(node_id, None)
        self._m_expiries.inc()
        # preserve the dead incarnation's piggybacked totals (it will
        # never heartbeat an update again) and freeze the moment for the
        # postmortem — both no-ops unless obs / the recorder are on
        _obs.REGISTRY.retire_node(node_id)
        _flight.RECORDER.trigger("node_death", node=node_id, via="expire")
        self._bump()

    # -- lookups -----------------------------------------------------------
    @property
    def nodes(self) -> Dict[str, NodeInfo]:
        """Merged snapshot of the whole node table (the pre-shard dict
        shape, kept for callers and tests; the ``NodeInfo`` objects are
        the live ones). Hot paths use ``info()`` — O(1), one shard lock."""
        out: Dict[str, NodeInfo] = {}
        for sh in self._shards:
            with sh.lock:
                out.update(sh.nodes)
        return out

    def info(self, node_id: str) -> Optional[NodeInfo]:
        """One node's live ``NodeInfo`` (or None) — O(1), one shard lock."""
        sh = self._shard(node_id)
        with sh.lock:
            return sh.nodes.get(node_id)

    # -- health ------------------------------------------------------------
    def sweep(self, now: Optional[float] = None) -> Dict[str, str]:
        """Advance health states from heartbeat ages; returns the
        transitions applied ({node_id: new_state}). Rate-limited: calls
        within ``_sweep_interval_s`` of the previous sweep return {}
        without touching the node table."""
        now = self.clock() if now is None else now
        if now - self._last_sweep < self._sweep_interval_s:
            return {}
        self._last_sweep = now
        moved: Dict[str, str] = {}
        for sh in self._shards:
            with sh.lock:
                for info in sh.nodes.values():
                    if info.state in (DEAD, LEFT):
                        continue
                    age = sh.detector.age(info.node_id, now=now)
                    if age > self.heartbeat_timeout_s:
                        info.state = DEAD
                        info.failures += 1
                        sh.detector.forget(info.node_id)
                        sh.last_beat.pop(info.node_id, None)
                        self._m_expiries.inc()
                        moved[info.node_id] = DEAD
                    elif age > self.suspect_after_s:
                        if info.state != SUSPECT:
                            moved[info.node_id] = SUSPECT
                        info.state = SUSPECT
                    elif info.state != ALIVE:
                        info.state = ALIVE
                        moved[info.node_id] = ALIVE
        if moved:
            for nid, st in moved.items():
                if st == DEAD:
                    _obs.REGISTRY.retire_node(nid)
                    _flight.RECORDER.trigger("node_death", node=nid,
                                             via="lease_expiry")
            self._bump()
        return moved

    def state(self, node_id: str) -> str:
        """Current health of a node; unknown ids read as dead."""
        self.sweep()
        info = self.info(node_id)
        return DEAD if info is None else info.state

    def states(self) -> Dict[str, str]:
        """One sweep, one snapshot of every node's health — the cheap
        form for callers checking many nodes per poll tick. Served from
        the version cache when membership/health has not moved."""
        self.sweep()
        version, cached = self._states_cache
        if version == self._version:
            return cached
        # read the version BEFORE building: a transition landing mid-build
        # leaves the cache stamped stale, never wrong
        version = self._version
        snap: Dict[str, str] = {}
        for sh in self._shards:
            with sh.lock:
                for nid, i in sh.nodes.items():
                    snap[nid] = i.state
        self._states_cache = (version, snap)
        return snap

    def is_dead(self, node_id: str) -> bool:
        return self.state(node_id) == DEAD

    def alive(self, now: Optional[float] = None) -> List[NodeInfo]:
        """Nodes eligible for NEW waves (strictly alive — suspects keep
        their in-flight work but receive nothing new until they beat).
        Steady-state calls are a cache read — callers must not mutate
        the returned list."""
        self.sweep(now)
        version, cached = self._alive_cache
        if version == self._version:
            return cached
        version = self._version
        snap = [i for sh in self._shards
                for i in self._locked_values(sh) if i.state == ALIVE]
        self._alive_cache = (version, snap)
        return snap

    def usable(self, now: Optional[float] = None) -> List[NodeInfo]:
        """Alive AND suspect nodes: the dispatch fallback pool. A suspect
        has merely missed a beat (scheduling hiccup, load) — only a DEAD
        node's lease is actually gone, so when no node is strictly alive
        the fabric places waves on suspects rather than failing a launch
        that could still complete."""
        self.sweep(now)
        version, cached = self._usable_cache
        if version == self._version:
            return cached
        version = self._version
        snap = [i for sh in self._shards
                for i in self._locked_values(sh)
                if i.state in (ALIVE, SUSPECT)]
        self._usable_cache = (version, snap)
        return snap

    @staticmethod
    def _locked_values(sh: _Shard) -> List[NodeInfo]:
        with sh.lock:
            return list(sh.nodes.values())

    # -- accounting ---------------------------------------------------------
    def record_dispatch(self, node_id: str, n_instances: int) -> None:
        sh = self._shard(node_id)
        with sh.lock:
            info = sh.nodes.get(node_id)
            if info is not None:
                info.waves += 1
                info.instances += n_instances

    def observe_shard(self, node_id: str, n: int, wall_s: float) -> None:
        """Feed one completed shard's measured wall into the node's
        cost-per-instance EWMA — the capacity re-weighting signal."""
        if n <= 0 or wall_s <= 0:
            return
        sh = self._shard(node_id)
        with sh.lock:
            info = sh.nodes.get(node_id)
            if info is None:
                return
            if info.cost is None:
                info.cost = Ewma(alpha=0.5)
            info.cost.update(wall_s / n)
        self.health.observe_wall(node_id, wall_s / n)

    def cost_per_instance(self, node_id: str) -> Optional[float]:
        sh = self._shard(node_id)
        with sh.lock:
            info = sh.nodes.get(node_id)
            return (info.cost.value
                    if info is not None and info.cost is not None else None)

    def health_eval(self) -> Dict[str, str]:
        """Recompute anomaly verdicts and stamp them onto the node table
        (``NodeInfo.extra["health"]``, read back by ``rollup``). Called
        once per completed wave by the backend — never per frame."""
        verdicts = self.health.evaluate()
        for nid, v in verdicts.items():
            info = self.info(nid)
            if info is not None:
                info.extra["health"] = v
        return verdicts

    def health_verdicts(self) -> Dict[str, str]:
        """Last computed {node_id: healthy|degraded|outlier}."""
        return self.health.verdicts()

    def rollup(self) -> Dict[str, dict]:
        """Per-node summary (state, capacity, dispatched work, failures,
        measured cost, anomaly verdict)."""
        self.sweep()
        out: Dict[str, dict] = {}
        for sh in self._shards:
            with sh.lock:
                for i in sh.nodes.values():
                    out[i.node_id] = {
                        "state": i.state, "capacity": i.capacity,
                        "waves": i.waves, "instances": i.instances,
                        "failures": i.failures,
                        "health": i.extra.get("health", HEALTHY),
                        "cost_per_instance":
                            i.cost.value if i.cost else None}
        return out
