"""DistributedBackend: the ``LaunchBackend`` protocol over many nodes.
Port of ``repro.dist.backend``.

This is the paper's Fig-4 architecture made real at the top level of the
launch tree: ONE ``dispatch()`` is one scheduler interaction that fans a
wave out across every alive node (weighted by capacity), each node fans
out locally through its own backend (node -> core), and the composite
``DistWaveHandle`` harvests per-node sub-results as they land — a
partial-wave harvest, no node ever waits on a sibling.

Failure is a first-class path, layered twice:

  * the HANDLE detects a shard stranded on a node whose heartbeat lease
    expired (``failed()`` turns True) and, when the caller hard-blocks in
    ``result()``, fails over just that shard to a surviving node — the
    completed shards keep their results;
  * the POLICY layer (``LLMapReduce``) sees ``failed()`` during its
    non-blocking sweep and feeds the whole wave back through its existing
    barrier-free speculative re-dispatch — first-ready-wins, the dead
    attempt's record kept under ``superseded_by_redispatch``. Results
    stay exactly-once either way: a dead node reports nothing.

Because ``DistributedBackend`` speaks the same protocol as every other
backend, ``LLMapReduce``, ``WaveController(wave_size="auto")``,
telemetry, and ``ServeEngine`` run over the fabric with zero API change.

Under the LaunchBackend protocol sit two more measured mechanisms:

  * **overlapped per-node staging** — each shard's payload travels in a
    STAGE frame through the agent's async outbox ahead of its (tiny)
    SUBMIT, and the node's receiver thread materializes it through a
    ``core.staging.Stager`` while the worker executes the previous wave;
    the per-shard stage wall and its hidden fraction come back in the
    RESULT record, aggregate into the wave's ``t_stage`` (visible stage
    only — the hidden part is, by definition, not on the critical path)
    and ``extra["stage"]``;
  * **content-addressed dedup staging** (``stage_dedup=True``, the
    default) — stage payloads are chunked and keyed by content digest in
    a scheduler-side ``ChunkDirectory``; each node keeps an LRU chunk
    cache, the scheduler sends only chunks a node does not already hold,
    and hot chunks fan out node-to-node through scheduler-coordinated
    peer hints, making bytes-on-wire sub-linear in fleet size for
    replicated payloads. The wave's ``extra["stage"]`` grows
    ``bytes_on_wire`` vs ``bytes_delivered`` plus a dedup rollup;
  * **measured capacity re-weighting** — each completed shard's wall
    feeds ``NodeRegistry.observe_shard`` (a per-node cost-per-instance
    EWMA, the same smoothing shape the wave controller runs), and
    ``dispatch`` scales every node's declared capacity by its measured
    speed, so a slow node automatically receives smaller shards on the
    very next wave. ``transport="socket"`` swaps the queue carrier for
    length-prefixed frames over localhost TCP with one switch.

On one card every node's backend runs on the fabric's ``device`` (the
card unless ``device="cpu"``; without a card the constructor raises). A
wave's parts come back as tensors on that device (shards that crossed
the wire arrive as host numpy and are moved there) before they are
concatenated.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from torch.utils import _pytree as pytree

from repro_torch.core.telemetry import LaunchRecord, Timer
from repro_torch.core.backend import WaveHandle, concat_outputs
from repro_torch.dist.chunks import (DEFAULT_CHUNK_BYTES,
                               DEFAULT_CHUNK_CACHE_BYTES, ChunkDirectory)
from repro_torch.dist.node import (NodeAgent, ShardTask, from_wire,
                                   spawn_local_nodes)
from repro_torch.dist.registry import DEAD, LEFT, NodeInfo, NodeRegistry
from repro_torch.dist.transport import make_transport
from repro_torch.kernels.ops import resolve_device
from repro_torch.obs.trace import TRACER


class NoAliveNodesError(RuntimeError):
    """Every node of the fabric is dead or gone: a wave cannot be placed.
    Raised instead of hanging — the caller decides whether to wait for an
    elastic join or give up."""


def _slice_tree(chunk: Any, lo: int, hi: int) -> Any:
    return pytree.tree_map(lambda x: x[lo:hi], chunk)


def split_by_capacity(n: int, capacities: List[float]) -> List[int]:
    """Largest-remainder split of ``n`` tasks over capacity weights —
    sizes sum to exactly ``n``; zero-sized shards are legal (a wave
    smaller than the fleet skips the lightest nodes). Weights may be
    fractional: measured re-weighting scales declared capacities by
    observed per-node speed."""
    total = sum(capacities)
    if total <= 0:
        raise ValueError("total capacity must be positive")
    exact = [n * c / total for c in capacities]
    sizes = [int(e) for e in exact]
    # hand out the remainder by largest fractional part (stable on ties)
    order = sorted(range(len(exact)), key=lambda i: exact[i] - sizes[i],
                   reverse=True)
    for i in order[:n - sum(sizes)]:
        sizes[i] += 1
    return sizes


def _dedup_rollup(node_records: List[dict]) -> Optional[dict]:
    """Aggregate per-shard chunk-dedup detail into the wave's view:
    additive chunk counters across shards, plus each node's LATEST
    cumulative cache snapshot (the snapshots are not additive). Returns
    None when no shard staged content-addressed."""
    dedups = [nr for nr in node_records if nr.get("stage_dedup")]
    if not dedups:
        return None
    agg = {"chunks": 0, "from_cache": 0, "from_wire": 0,
           "from_peer": 0, "requested": 0}
    latest: Dict[str, dict] = {}
    peer_bytes: Dict[str, int] = {}
    for nr in dedups:                    # node_records are shard-ordered;
        d = nr["stage_dedup"]            # the last entry per node wins
        for k in agg:
            agg[k] += int(d.get(k, 0))
        latest[nr["node"]] = d.get("node_cache") or {}
        peer_bytes[nr["node"]] = int(d.get("node_peer_bytes", 0))
    hits = sum(c.get("hits", 0) for c in latest.values())
    misses = sum(c.get("misses", 0) for c in latest.values())
    agg["cache_hits"] = hits
    agg["cache_misses"] = misses
    agg["cache_hit_rate"] = hits / (hits + misses) if hits + misses else 0.0
    agg["cache_evictions"] = sum(c.get("evictions", 0)
                                 for c in latest.values())
    agg["peer_bytes"] = sum(peer_bytes.values())
    return agg


@dataclass
class _Shard:
    """One node's slice of one wave."""
    node_id: str
    lo: int
    hi: int
    chunk: Any
    task: ShardTask
    t_submit: float
    attempts: int = 1
    done: bool = False
    failed: bool = False
    out: Any = None
    rec: Optional[LaunchRecord] = None
    t_done: float = 0.0
    history: List[str] = field(default_factory=list)  # nodes tried


class DistWaveHandle(WaveHandle):
    """Composite handle over per-node shards: partial-wave harvest,
    dead-node detection (``failed()``), shard-level failover in
    ``result()``.

    Harvesting is PUSH-driven: every shard task carries a done callback
    (fired by the transport's frame pump the instant its RESULT frame
    lands) that appends to this handle's completion queue, so a poll
    drains O(completed-since-last-poll) instead of scanning every
    in-flight future — the property that keeps the driver loop flat at
    fleet width. Only dead-NODE detection still scans (throttled: node
    health changes at heartbeat cadence, not poll cadence)."""

    can_fail = True          # the policy layer may see failed() turn True

    def __init__(self, fabric: "DistributedBackend", fn: Callable,
                 shards: List[_Shard], rec: LaunchRecord, t0: float,
                 inner_lanes: Optional[int] = None):
        super().__init__(out=None, rec=rec, t0=t0)
        self.fabric = fabric
        self.fn = fn
        self.shards = shards
        self.inner_lanes = inner_lanes
        self._last_refresh = 0.0
        self._done_q: deque = deque()
        self._n_done = 0
        self._task_err: Optional[BaseException] = None
        for s in shards:
            self._watch(s)

    def _watch(self, shard: _Shard) -> None:
        """Subscribe to a shard task's completion (re-called with the new
        task after failover; a stale task's late callback is recognised
        by identity and dropped at drain time)."""
        task = shard.task

        def _on_done(t, shard=shard):
            self._done_q.append((shard, t))
            self.fabric.wave_event.set()

        task.add_done_callback(_on_done)

    # -- liveness ----------------------------------------------------------
    def _refresh(self) -> None:
        """Drain the completion queue (partial-wave harvest) and mark
        shards stranded on dead nodes. A shard error (the task itself
        raised) propagates — re-running a broken program elsewhere would
        only fail again."""
        if self._task_err is not None:
            raise self._task_err
        while True:
            try:
                shard, task = self._done_q.popleft()
            except IndexError:
                break
            # identity check: after a failover the shard's CURRENT task
            # is what counts — a cancelled predecessor resolving late
            # (zombie compute) must not double-deliver; likewise a shard
            # already failed over keeps its re-dispatch
            if shard.task is not task or shard.done or shard.failed:
                continue
            if task.err is not None:
                self._task_err = task.err
                raise task.err
            shard.out, shard.rec = task.out, task.rec
            shard.done = True
            shard.t_done = time.perf_counter()
            self._n_done += 1
            if self._t_first is None:
                self._t_first = shard.t_done - self.t0
        if self._n_done >= len(self.shards):
            return
        # throttle the dead-node scan: the driver polls, failure-checks,
        # and live-checks the same handle within one sub-millisecond
        # tick, but node health only changes at heartbeat cadence
        now = time.perf_counter()
        if now - self._last_refresh < 1e-3:
            return
        self._last_refresh = now
        states: Optional[Dict[str, str]] = None
        for s in self.shards:
            if s.done or s.failed:
                continue
            if states is None:        # ONE sweep per refresh, not per shard
                states = self.fabric.registry.states()
            # DEAD = lease expired; LEFT with an undelivered shard means
            # the node crashed mid-drain — either way, nobody will deliver
            if states.get(s.node_id, DEAD) in (DEAD, LEFT):
                s.failed = True
                self.rec.extra["node_failure"] = True
                self.rec.extra.setdefault("failed_nodes", []).append(
                    s.node_id)

    def failed(self) -> bool:
        if self._harvested:
            return False
        self._refresh()
        return any(s.failed for s in self.shards if not s.done)

    # -- harvest -----------------------------------------------------------
    def poll(self) -> bool:
        if self._harvested:
            return True
        self._refresh()
        if self._n_done >= len(self.shards):
            self._finalize()
            return True
        return False

    def _finalize(self) -> None:
        dev = self.fabric.device
        self.out = concat_outputs(
            [from_wire(s.out, device=dev)
             for s in sorted(self.shards, key=lambda s: s.lo)])
        now = time.perf_counter()
        wall = now - self.t0
        self.rec.t_first_result = (self._t_first if self._t_first is not None
                                   else wall)
        self.rec.extra["node_records"] = [
            {"node": s.node_id, "n": s.hi - s.lo, "lo": s.lo, "hi": s.hi,
             "t_wave": s.t_done - s.t_submit, "attempts": s.attempts,
             "t_schedule": s.rec.t_schedule if s.rec else 0.0,
             "t_stage": s.rec.t_stage if s.rec else 0.0,
             "stage_hidden_s": (s.rec.extra.get("stage", {}).get("hidden_s",
                                                                 0.0)
                                if s.rec else 0.0),
             "stage_bytes": (s.rec.extra.get("stage", {}).get("bytes", 0)
                             if s.rec else 0),
             "stage_bytes_on_wire": (s.rec.extra.get("stage", {}).get(
                 "bytes_on_wire", 0) if s.rec else 0),
             "stage_dedup": (s.rec.extra.get("stage", {}).get("dedup")
                             if s.rec else None),
             "compile_source": (s.rec.extra.get("compile_source")
                                if s.rec else None),
             "device": s.rec.extra.get("device") if s.rec else None}
            for s in self.shards]
        # staging telemetry: the wave's t_stage is the VISIBLE stage only
        # (stage wall not hidden under execution — the hidden part is, by
        # definition, off the critical path); nodes stage in parallel, so
        # visible stage is a max, totals go to extra. t_spawn is the
        # execution remainder, keeping total == measured wall.
        stage_wall = sum(nr["t_stage"]
                         for nr in self.rec.extra["node_records"])
        stage_hidden = sum(nr["stage_hidden_s"]
                           for nr in self.rec.extra["node_records"])
        visible = max((nr["t_stage"] - nr["stage_hidden_s"]
                       for nr in self.rec.extra["node_records"]),
                      default=0.0)
        self.rec.t_stage = max(visible, 0.0)
        self.rec.t_spawn = max(wall - self.rec.t_stage, 0.0)
        if stage_wall > 0:
            nrs = self.rec.extra["node_records"]
            wire = sum(nr["stage_bytes_on_wire"] for nr in nrs)
            delivered = sum(nr["stage_bytes"] for nr in nrs)
            self.rec.extra["stage"] = {
                "wall_s": stage_wall, "hidden_s": stage_hidden,
                "hidden_frac": stage_hidden / stage_wall,
                "bytes_on_wire": wire, "bytes_delivered": delivered}
            dedup = _dedup_rollup(nrs)
            if dedup is not None:
                self.rec.extra["stage"]["dedup"] = dedup
        # measured capacity re-weighting: feed clean shards' walls into
        # the registry's per-node cost EWMA (failed-over shards carry
        # detection + requeue latency, not node speed)
        for s in self.shards:
            if s.attempts == 1 and s.rec is not None:
                self.fabric.registry.observe_shard(
                    s.node_id, s.hi - s.lo, s.t_done - s.t_submit)
        # with the wave's walls banked, refresh per-node anomaly
        # verdicts (healthy/degraded/outlier) and keep them on the record
        self.rec.extra["health"] = self.fabric.registry.health_eval()
        # wave-level compile source = the slowest tier any node paid
        sources = {nr["compile_source"]
                   for nr in self.rec.extra["node_records"]}
        for tier in ("compiled", "disk", "memory"):
            if tier in sources:
                self.rec.extra["compile_source"] = tier
                break
        self._harvested = True

    def failover(self) -> int:
        """Resubmit every failed shard to a surviving node; completed
        shards keep their results. Returns the number of shards moved;
        raises ``NoAliveNodesError`` when nobody is left to take them."""
        moved = 0
        for s in self.shards:
            if s.done or not s.failed:
                continue
            s.history.append(s.node_id)
            target = self.fabric.pick_node(exclude=s.history)
            s.task.cancel()
            s.task = self.fabric.submit_shard(
                target, self.fn, s.chunk, s.hi - s.lo, self.inner_lanes,
                row_offset=s.lo)
            s.node_id = target.node_id
            s.t_submit = time.perf_counter()
            s.failed = False
            s.attempts += 1
            self._watch(s)            # subscribe to the re-dispatched task
            moved += 1
            self.rec.extra.setdefault("failover", []).append(
                {"span": (s.lo, s.hi), "from": s.history[-1],
                 "to": target.node_id, "attempt": s.attempts})
        return moved

    def result(self) -> tuple:
        """Block until the wave completes, failing stranded shards over to
        surviving nodes as leases expire (standalone callers get recovery
        even without the policy layer's re-dispatch)."""
        wake = self.fabric.wave_event
        while not self.poll():
            if self.failed():
                self.failover()
            # push-driven: the pump's RESULT callback sets the event, so
            # the common case wakes in microseconds; the timeout is only
            # the dead-node detection cadence
            wake.wait(timeout=2e-3)
            wake.clear()
        return self.out, self.rec

    def abandon(self):
        for s in self.shards:
            if not s.done:
                s.task.cancel()
        return super().abandon()


class DistributedBackend:
    """Capacity-weighted wave sharding across registry-tracked nodes."""

    name = "llmr-dist"
    supports_lane_override = True

    def __init__(self,
                 nodes: Optional[List[Any]] = None,
                 n_nodes: Optional[int] = None,
                 registry: Optional[NodeRegistry] = None,
                 cache: Optional[Any] = None,
                 node_backend: str = "array",
                 node_mode: str = "thread",
                 transport: Any = "inproc",
                 transport_options: Optional[dict] = None,
                 capacities: Optional[List[int]] = None,
                 depth: int = 2,
                 heartbeat_timeout_s: float = 0.5,
                 heartbeat_s: Optional[float] = None,
                 inner_lanes: Optional[int] = None,
                 overlap_staging: bool = True,
                 stage_dedup: bool = True,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 chunk_cache_bytes: int = DEFAULT_CHUNK_CACHE_BYTES,
                 reweight: bool = True,
                 min_weight_frac: float = 0.05,
                 reweight_deadband: float = 0.15,
                 split_hysteresis: float = 0.3,
                 target_first_result_s: Optional[float] = None,
                 device=None):
        """Pass ready ``nodes`` (agents already registered with
        ``registry``) or let the backend spawn ``n_nodes`` local agents
        (thread mode by default; ``node_mode="process"`` for real
        multiprocessing workers). ``transport`` is the wire the fabric
        speaks: ``"inproc"`` (queue pairs), ``"socket"`` (length-prefixed
        frames over TCP, one connection per node), or a ready
        transport instance shared with externally-built agents.
        ``transport_options`` forwards kwargs to the transport factory —
        for ``"socket"``: ``bind_host``/``port`` (listen address,
        ``"0.0.0.0"`` to accept remote nodes), ``advertise_host`` (what
        remote peers dial), ``secret`` (shared HMAC key; every joining
        node must answer the challenge or its connection is dropped
        before a single frame is processed).
        ``cache=None`` gives every spawned node its OWN ``CompileCache``
        over a directory of its own (the paper's node-local staging
        disk); an explicit cache is the driver's, and on the CPU it is
        shared by all thread nodes. On the card each node keeps a cache
        object of its own all the same (a graph replays from its static
        buffers, so two nodes replaying one graph at once would overwrite
        each other's inputs), and process nodes keep their own (no object
        crosses the spawn boundary); both point their cache at the
        caller's directory, whose disk tier is multi-process safe.
        ``overlap_staging=False`` disables the STAGE-ahead path (payloads
        ride inside SUBMIT and stage on the worker's critical path — the
        unoverlapped baseline the ``fig_dist`` benchmark contrasts).
        ``stage_dedup`` (default on;
        requires the overlapped path) makes staging content-addressed:
        payloads split into ``chunk_bytes`` chunks keyed by digest, each
        node keeps an LRU ``chunk_cache_bytes`` chunk cache, the shared
        ``ChunkDirectory`` plans per-chunk sends (nothing / peer hint /
        bytes), and the ``fig_stage_dedup`` benchmark gates bytes-on-
        wire sub-linearity. ``reweight=False`` freezes the
        shard split at declared capacities; on, each node's weight is
        scaled by its measured speed, floored at ``min_weight_frac`` of
        its declared share (a slow node shrinks, it is never starved);
        ``reweight_deadband`` keeps a node at its declared capacity while
        its measured speed sits within that fraction of the fastest —
        EWMA noise in a homogeneous fleet must not churn shard splits
        (stable splits keep content-addressed chunk digests stable, so
        repeat waves re-send nothing). ``split_hysteresis`` is the same
        idea one level up: a re-split that would move less than that
        fraction of the average shard keeps the PREVIOUS wave's split —
        a few rows of rebalance never pays for the chunk-digest and
        AOT-shape churn it causes; a genuinely slow node moves the split
        far past the threshold and re-splits immediately.
        ``target_first_result_s`` rides along to any wave controller
        built over this backend (the serve-side SLO knob). ``device``: the
        card unless ``"cpu"``; the engine and the nodes read it."""
        from repro_torch.core.compile_cache import default_cache
        self.device = resolve_device(device)
        # driver-side cache: serve engines (and anything else calling
        # backend.compile) compile and execute locally on the driver —
        # only WAVES are distributed
        self.cache = cache if cache is not None else default_cache()
        self.registry = registry if registry is not None else NodeRegistry(
            heartbeat_timeout_s=heartbeat_timeout_s)
        self.transport, self._owned_transport = make_transport(
            transport, **(transport_options or {}))
        # set by the frame pump whenever ANY shard completes: wave
        # handles (and the driver's drain loop) block on this instead of
        # sleep-polling, so result latency is wakeup latency
        self.wave_event = threading.Event()
        self.inner_lanes = inner_lanes
        self.overlap_staging = overlap_staging
        self.stage_dedup = bool(stage_dedup) and overlap_staging
        self.chunk_bytes = chunk_bytes
        self.chunk_cache_bytes = chunk_cache_bytes
        self.directory = (ChunkDirectory(self.registry,
                                         node_cache_bytes=chunk_cache_bytes)
                          if self.stage_dedup else None)
        self.reweight = reweight
        self.min_weight_frac = min_weight_frac
        self.reweight_deadband = reweight_deadband
        self.split_hysteresis = split_hysteresis
        self._split_memo: Optional[tuple] = None
        self.target_first_result_s = target_first_result_s
        self.max_in_flight = max(1, depth)
        self._owned: List[Any] = []
        self._rr = 0
        if nodes is None:
            kw: dict = {"backend_kind": node_backend,
                        "overlap_staging": overlap_staging,
                        "device": self.device}
            if self.stage_dedup:
                kw.update(stage_dedup=True, chunk_bytes=chunk_bytes,
                          chunk_cache_bytes=chunk_cache_bytes,
                          directory=self.directory)
            if heartbeat_s is not None:
                kw["heartbeat_s"] = heartbeat_s
            if cache is not None:
                if node_mode == "thread" and self.device.type == "cpu":
                    kw["cache"] = cache      # shared in-process cache
                else:
                    # a node that cannot share the caller's cache object
                    # (another process, or a thread replaying on the
                    # card) shares its DISK tier: every node points at
                    # the caller's directory (max_bytes stays a
                    # driver-side policy)
                    kw["cache_dir"] = cache.cache_dir
            nodes = spawn_local_nodes(n_nodes or 2, self.registry,
                                      mode=node_mode, capacities=capacities,
                                      transport=self.transport, **kw)
            self._owned = list(nodes)
        self.agents: Dict[str, Any] = {a.node_id: a for a in nodes}
        # elastic remote join: a socket transport hands connections it
        # was not told to expect to this hook — each becomes a
        # host="remote" agent (scheduler-side bookkeeping only; the
        # worker loop runs in the remote process)
        if hasattr(self.transport, "on_unclaimed"):
            self.transport.on_unclaimed = self._admit_remote

    def _admit_remote(self, node_id: str, capacity: Any, channel: Any):
        """Admit a self-registered remote node (``python -m
        repro_torch.dist.node --connect``): build the scheduler-side agent over
        the already-authenticated channel and enter the elastic-join
        path."""
        agent = NodeAgent(node_id, self.registry,
                          capacity=int(capacity or 1),
                          transport=self.transport, host="remote",
                          channel=channel,
                          overlap_staging=self.overlap_staging,
                          stage_dedup=self.stage_dedup,
                          chunk_bytes=self.chunk_bytes,
                          chunk_cache_bytes=self.chunk_cache_bytes,
                          directory=self.directory)
        self.add_node(agent)
        return agent

    # -- fleet -------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        """Alive-node count (the wave controller's node-level width)."""
        return max(1, len(self._alive()))

    def add_node(self, agent: Any) -> None:
        """Elastic join: an agent that registered itself starts receiving
        waves at the very next ``dispatch``."""
        self.agents[agent.node_id] = agent

    def health_verdicts(self) -> Dict[str, str]:
        """Last per-node anomaly verdicts ({node_id: healthy|degraded|
        outlier}); surfaces on ``MapReduceReport.health``."""
        return self.registry.health_verdicts()

    def _alive(self) -> List[NodeInfo]:
        """Dispatch pool: strictly-alive nodes, falling back to suspects
        when none are (a beat missed under load is not a dead node; only
        an expired lease removes a node from placement)."""
        pool = [i for i in self.registry.alive()
                if i.node_id in self.agents]
        if not pool:
            pool = [i for i in self.registry.usable()
                    if i.node_id in self.agents]
        return pool

    def pick_node(self, exclude: Optional[List[str]] = None) -> NodeInfo:
        """Round-robin over alive nodes (failover placement), preferring
        nodes that have not already failed this shard."""
        alive = self._alive()
        if not alive:
            raise NoAliveNodesError(
                "no alive nodes in the fabric "
                f"(registry: {self.registry.rollup()})")
        fresh = [i for i in alive if i.node_id not in (exclude or ())]
        pool = fresh or alive
        self._rr += 1
        return pool[self._rr % len(pool)]

    def submit_shard(self, info: NodeInfo, fn: Callable, chunk: Any,
                     n: int, inner_lanes: Optional[int],
                     row_offset: int = 0) -> ShardTask:
        self.registry.record_dispatch(info.node_id, n)
        return self.agents[info.node_id].submit(fn, chunk, n,
                                                inner_lanes=inner_lanes,
                                                row_offset=row_offset)

    # -- LaunchBackend -----------------------------------------------------
    def compile(self, fn: Callable, example_args: tuple,
                extras: tuple = (), bind_argnums: tuple = ()) -> tuple:
        """(executable, source) through the driver-side cache on the
        fabric's device — the same entry point ``ArrayBackend`` exposes,
        so ``PagedServeEngine`` (which compiles and steps locally, a CUDA
        graph on the card) runs over the fabric unchanged."""
        return self.cache.compile(fn, example_args, device=self.device,
                                  bind_argnums=bind_argnums, extras=extras)

    def _weights(self, infos: List[NodeInfo]) -> List[float]:
        """Effective shard weights: declared capacity scaled by measured
        speed (fastest node's cost EWMA = 1.0), floored at
        ``min_weight_frac`` of the declared share so a slow node shrinks
        without being starved of the measurements it needs to recover."""
        if not self.reweight:
            return [float(i.capacity) for i in infos]
        costs = [i.cost.value if i.cost is not None else None
                 for i in infos]
        known = [c for c in costs if c]
        if not known:
            return [float(i.capacity) for i in infos]
        fastest = min(known)
        weights = []
        for i, c in zip(infos, costs):
            ratio = fastest / c if c else 1.0
            if ratio >= 1.0 - self.reweight_deadband:
                ratio = 1.0      # noise-level spread: keep splits stable
            weights.append(max(i.capacity * ratio,
                               self.min_weight_frac * i.capacity))
        return weights

    def _stable_split(self, n: int, ids: List[str],
                      weights: List[float]) -> List[int]:
        """Capacity split with hysteresis: if a fresh split would move at
        most ``split_hysteresis`` of the average shard on any node, keep
        the previous wave's split — identical shard boundaries keep
        chunk digests (and compiled shapes) identical across waves."""
        sizes = split_by_capacity(n, weights)
        memo = self._split_memo
        if memo is not None and memo[0] == n and memo[1] == ids:
            threshold = max(1, int(self.split_hysteresis * n / len(sizes)))
            if max(abs(s - m) for s, m in zip(sizes, memo[2])) <= threshold:
                return memo[2]
        self._split_memo = (n, ids, sizes)
        return sizes

    def dispatch(self, fn: Callable, chunk: Any, n: int,
                 inner_lanes: Optional[int] = None) -> DistWaveHandle:
        """ONE scheduler interaction: shard the wave over every alive node
        weighted by (measured) capacity and enqueue all shards; returns
        immediately with a composite handle (sub-results are futures on
        their nodes; payloads stream to the nodes through each agent's
        async outbox while earlier waves execute)."""
        lanes = self.inner_lanes if inner_lanes is None else inner_lanes
        rec = LaunchRecord(self.name, n)
        t = Timer()
        infos = self._alive()
        if not infos:
            raise NoAliveNodesError(
                "dispatch with no alive nodes "
                f"(registry: {self.registry.rollup()})")
        # the wave's dispatch span: pushed as the thread's current span,
        # so every shard span NodeAgent.submit opens parents to it
        span = TRACER.start("dispatch", where="driver",
                            attrs={"n": n, "nodes": len(infos)}, push=True)
        shards: List[_Shard] = []
        try:
            weights = self._weights(infos)
            sizes = self._stable_split(n, [i.node_id for i in infos],
                                       weights)
            lo = 0
            for info, w in zip(infos, sizes):
                if w == 0:
                    continue
                sub = _slice_tree(chunk, lo, lo + w)
                task = self.submit_shard(info, fn, sub, w, lanes,
                                         row_offset=lo)
                shards.append(_Shard(info.node_id, lo, lo + w, sub, task,
                                     time.perf_counter()))
                lo += w
        finally:
            TRACER.finish(span, shards=len(shards))
        rec.t_schedule = t.lap()
        rec.fanout = {"sched": 1, "node": len(shards), "core": lanes or 1}
        rec.extra["n_nodes"] = len(shards)
        rec.extra["shards"] = [{"node": s.node_id, "lo": s.lo, "hi": s.hi}
                               for s in shards]
        if any(abs(w - i.capacity) > 1e-9 for i, w in zip(infos, weights)):
            rec.extra["shard_weights"] = {      # measured re-weighting hit
                i.node_id: round(w, 4) for i, w in zip(infos, weights)}
        return DistWaveHandle(self, fn, shards, rec, time.perf_counter(),
                              inner_lanes=lanes)

    def launch(self, fn: Callable, inputs: Any, n: int) -> tuple:
        return self.dispatch(fn, inputs, n).result()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Gracefully stop every agent this backend spawned (externally
        provided nodes are the caller's to stop), then the transport it
        owns (an externally shared transport outlives the backend)."""
        for agent in self._owned:
            if agent.alive:
                agent.stop()
        if self._owned_transport:
            self.transport.close()

    def __enter__(self) -> "DistributedBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
