"""NodeAgent: one node of the launch fabric, speaking ONLY the wire
protocol (``repro_torch.dist.transport``) to its worker. Port of
``repro.dist.node``.

ONE agent class covers the whole host x transport matrix. The scheduler
side (this class) is event-driven: every agent of a fabric registers its
channel with the transport's shared ``FramePump`` (``repro_torch.dist.pump``)
— ONE selector thread owning all node connections. SUBMIT/STAGE frames
go out as pump jobs whose payloads serialize on the pump thread (so
``dispatch`` returns before payloads serialize — the transfer overlaps
the previous wave's execution), HEARTBEAT frames renew the registry
lease, RESULT frames resolve ``ShardTask`` futures (firing their done
callbacks), LEAVE frames deregister. At 1,000 nodes the scheduler side
costs 1 thread + O(fds), not 2,000 outbox/receiver threads. The node
side (``_worker_loop``) is the same function everywhere: a receiver
thread drains the channel — staging STAGE payloads through a
``core.staging.Stager`` WHILE the worker thread executes the previous
shard (overlapped per-node staging, with the hidden/visible split
measured against the worker's busy clock) — and a heartbeat thread
beats until the queue drains.

With ``stage_dedup`` on, the STAGE path is content-addressed
(``repro_torch.dist.chunks``): the send loop pickles the shard payload once,
splits it into fixed-size chunks, and consults the fabric's
``ChunkDirectory`` per chunk — already held by the node means send
nothing, held by a healthy peer means send a hint (the node pulls it
node-to-node), otherwise the bytes ride a CHUNK frame and the node
becomes a holder. The node side reassembles against the manifest,
verifying every chunk's digest (a mismatch fails exactly that shard
with ``ProtocolError``), caching chunks in an LRU-by-bytes
``ChunkCache``, and falling back to a scheduler ``CHUNK_REQ`` whenever
its cache or a peer cannot produce a promised chunk — eviction and dead
relays degrade to direct send, never a hang or a silent corrupt stage.

  host="thread"    worker threads in this process (the CI default):
                   multi-host is SIMULATED — nodes share the machine and
                   the card but nothing else (own backend, own compile
                   cache and so own CUDA graphs, own channel, own lease).
  host="process"   real ``multiprocessing`` spawn workers: a separate
                   Python process with its own CUDA context on the card
                   (or the CPU, when the fabric was built with
                   ``device="cpu"``); ``kill()`` is a hard SIGTERM, so a
                   lost node is indistinguishable from a crashed host.
  host="remote"    a worker THIS process did not spawn: the node dialled
                   the fabric's ``SocketTransport`` itself (``python -m
                   repro_torch.dist.node --connect host:port``), authenticated
                   via the HMAC handshake, and self-registered through
                   the elastic-join path — the agent owns only the
                   scheduler-side channel.

Tensors never cross the wire as pickled ``torch.Tensor``s (a CUDA tensor
would pickle through a device-to-host copy, and its bytes are not
promised stable): ``to_wire`` turns every tensor leaf into host numpy —
bf16, which numpy lacks, as its 16 bits under the structured dtype
``BF16_WIRE`` — so shard payloads chunk into byte-stable row groups, and
``from_wire`` restores the tensors bit-exact on the other side. A node's
backend runs on the fabric's device (the card unless ``device="cpu"``),
or on its own subset of devices (``devices=``: more than one makes a
``("data",)`` mesh over them, and the node's waves split across it, see
``core.backend``), and every result record names it
(``rec.extra["device"]``).

  transport=InprocTransport   queue pairs (by-reference in one process,
                              mp queues across the spawn boundary).
  transport=SocketTransport   length-prefixed frames over localhost TCP,
                              one connection per node; everything
                              crossing the channel is serialized and a
                              dead peer is a dropped connection
                              (condemned via ``registry.expire``).

Death semantics are the point: ``kill()`` models a crashed node — the
heartbeat stops, queued shards never run, and a shard computed but not
yet reported is dropped (the fabric must recover it via re-dispatch, and
does: results stay exactly-once because a dead node reports nothing).
``stop()`` is the graceful leave — drain, send LEAVE, deregister.
"""
from __future__ import annotations

import itertools
import os
import pickle
import queue
import socket as _socket
import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.dist.chunks import (DEFAULT_CHUNK_BYTES,
                               DEFAULT_CHUNK_CACHE_BYTES, ChunkDirectory,
                               chunk_digest, chunk_split)
from repro_torch.dist.registry import LEFT, NodeRegistry
from repro_torch.dist.transport import (CHUNK, CHUNK_REQ, HEARTBEAT, LEAVE, PEER,
                                  RESULT, STAGE, SUBMIT, InprocTransport,
                                  PayloadTooLarge, ProtocolError,
                                  TransportError, open_worker_channel)
from repro_torch.obs import metrics as _obs
from repro_torch.obs.trace import TRACER, new_span_id, new_trace_id


def _node_cache_dir(node_id: str) -> str:
    """Per-node compile-cache directory: each node keeps its own record
    tier (on a real cluster this is node-local disk), under the port's
    base directory so hermetic test environments stay hermetic."""
    from repro_torch.core.compile_cache import default_cache_dir
    return os.path.join(default_cache_dir(), "nodes", node_id)


#: the wire form of a bf16 tensor: its 16 bits, tagged by the field name
BF16_WIRE = np.dtype([("bfloat16", "<u2")])


def to_wire(tree: Any) -> Any:
    """Tensor leaves -> host numpy (bf16 as ``BF16_WIRE``); numpy and
    other leaves pass through."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16).view(
                BF16_WIRE)
        return x.numpy()
    return pytree.tree_map(leaf, tree)


def from_wire(tree: Any, device=None) -> Any:
    """Undo ``to_wire``: ``BF16_WIRE`` arrays -> bf16 tensors, bit-exact.
    With ``device``, every array leaf becomes a tensor there (tensors
    move); without, other numpy leaves stay numpy."""
    def leaf(x):
        if isinstance(x, np.ndarray) and x.dtype == BF16_WIRE:
            x = torch.from_numpy(np.ascontiguousarray(x).view(
                np.int16)).view(torch.bfloat16)
        elif isinstance(x, np.ndarray) and device is not None:
            x = torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor) and device is not None:
            x = x.to(device)
        return x
    return pytree.tree_map(leaf, tree)


def device_label(device: torch.device) -> str:
    """What a result record says of the device a shard ran on."""
    if device.type == "cuda":
        return f"{device} {torch.cuda.get_device_name(device)}"
    return str(device)


class ShardTask:
    """One shard of one wave, in flight on one node (a scheduler-side
    future resolved by the node's RESULT frame)."""

    _ids = itertools.count()

    def __init__(self, fn: Callable, chunk: Any, n: int,
                 inner_lanes: Optional[int] = None):
        self.task_id = next(self._ids)
        self.fn = fn
        self.chunk = chunk
        self.n = n
        self.inner_lanes = inner_lanes
        self.cancelled = False
        self.out: Any = None
        self.rec: Any = None
        self.err: Optional[BaseException] = None
        self.wire_bytes = 0           # bytes this shard put on the wire
        self._done = threading.Event()
        self._cb_lock = threading.Lock()
        self._callbacks: List[Callable] = []

    @property
    def ready(self) -> bool:
        return self._done.is_set()

    def add_done_callback(self, cb: Callable[["ShardTask"], None]) -> None:
        """Run ``cb(task)`` when the shard resolves (result OR error) —
        the pump's completion push: wave handles subscribe here instead
        of polling every in-flight future. Fires immediately if already
        resolved; callbacks run on whatever thread resolves the task
        (usually the pump thread), so keep them O(1)."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def _fire_callbacks(self) -> None:
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a late watcher, never fatal
                pass

    def set_result(self, out: Any, rec: Any) -> None:
        if self._done.is_set():
            return
        self.out, self.rec = out, rec
        self._done.set()
        self._fire_callbacks()

    def set_error(self, err: BaseException) -> None:
        if self._done.is_set():
            return
        self.err = err
        self._done.set()
        self._fire_callbacks()

    def cancel(self) -> None:
        """Best-effort: a shard not yet on the wire is never sent; an
        in-process host skips it at execution time; a remote process may
        still compute a result nobody reads (tasks are idempotent)."""
        self.cancelled = True
        cb = self._on_cancel
        if cb is not None:
            cb(self.task_id)

    _on_cancel: Optional[Callable] = None
    #: shard span wire context (tracing on): the (trace_id, span_id)
    #: tuple SUBMIT/STAGE frames carry as "tc". The span's id exists from
    #: submit time (children parent to it) but the dict is only built at
    #: trace-read time — obs_parent/obs_t0/obs_pc0 hold what's needed.
    obs_ctx = None
    obs_parent = None
    obs_t0 = 0.0
    obs_pc0 = 0.0


def _lane_kwargs(backend, n: int, inner_lanes: Optional[int]) -> dict:
    """Pass the wave's lane plan through to the node's backend only when
    it supports the override and the shard divides — an indivisible shard
    silently running the flat plan beats a warning per shard."""
    if (inner_lanes and inner_lanes > 1 and n % inner_lanes == 0
            and getattr(backend, "supports_lane_override", False)):
        return {"inner_lanes": inner_lanes}
    return {}


class _WorkerCtl:
    """Worker-side switchboard: kill/stop/pause flags plus the busy clock
    the ``Stager`` attributes staging overlap against. Thread-hosted
    agents SHARE this object with their worker (the kill flag is how a
    thread 'crashes'); a process host's ctl lives in the child, where
    kill is a real SIGTERM instead."""

    def __init__(self):
        self.killed = threading.Event()
        self.stopping = threading.Event()
        self.paused = threading.Event()
        self.throttle_s = 0.0    # test/bench affordance: per-shard slowdown
        # task ids cancelled scheduler-side: an in-process worker (thread
        # hosts share this object over BOTH wires) skips them before
        # executing — a process host's child has its own empty set, so
        # remote cancellation stays best-effort
        self.cancelled: set = set()
        # the worker's chunk cache, when content-addressed staging is on
        # (thread hosts share this object, so tests can apply memory
        # pressure by clearing it)
        self.chunk_cache: Optional[Any] = None
        self._busy_lock = threading.Lock()
        self._busy_total = 0.0
        self._busy_since: Optional[float] = None

    def busy_begin(self) -> None:
        with self._busy_lock:
            self._busy_since = time.perf_counter()

    def busy_end(self) -> None:
        with self._busy_lock:
            if self._busy_since is not None:
                self._busy_total += time.perf_counter() - self._busy_since
                self._busy_since = None

    def busy_clock(self) -> float:
        """Cumulative seconds the worker has spent executing shards."""
        with self._busy_lock:
            total = self._busy_total
            if self._busy_since is not None:
                total += time.perf_counter() - self._busy_since
            return total


class _ChunkAssembler:
    """Node-side manifest assembly for content-addressed staging.

    ``begin`` (receiver thread) resolves a STAGE manifest: cache hits
    fill immediately, peer-hinted chunks are pulled on a fetch thread,
    chunks the scheduler believed cached but the node evicted go back as
    one CHUNK_REQ. ``on_chunk`` (receiver thread) lands scheduler-sent
    bytes, verifying every chunk against its manifest digest — a
    mismatch fails exactly the shards waiting on that digest
    (``Stager.fail`` -> loud ``ProtocolError`` at ``take``), never a
    silent corrupt stage. When a shard's last chunk lands, the blob is
    deserialized into the stager off the worker's critical path (that
    deserialization IS the node-local copy)."""

    #: how long a shard may sit waiting for promised chunks before its
    #: ``take`` fails — a backstop; designed failure paths (lost chunk,
    #: digest mismatch, dead peer) resolve much sooner and loudly
    TAKE_TIMEOUT_S = 120.0

    _rank = {"w": 2, "p": 1, "c": 0}

    def __init__(self, node_id: str, channel, stager, cache):
        self.node_id = node_id
        self._ch = channel
        self._stager = stager
        self._cache = cache
        self._lock = threading.Lock()
        self._tasks: dict = {}        # task_id -> assembly entry
        self._want: dict = {}         # digest  -> task_ids waiting on it
        self.stats = {"manifests": 0, "cache_hits": 0, "from_wire": 0,
                      "from_peer": 0, "peer_bytes": 0, "requested": 0,
                      "peer_fallbacks": 0, "mismatches": 0}

    def begin(self, payload: dict) -> None:
        task_id = payload["task_id"]
        order = [(e[0], int(e[1])) for e in payload["chunks"]]
        # a digest repeated in one manifest resolves once; the strongest
        # source wins: wire (bytes already in flight) > peer > cached
        srcs: dict = {}
        for d, _, src in payload["chunks"]:
            kind = src if isinstance(src, str) else "p"
            if d not in srcs or self._rank[kind] > self._rank[srcs[d][0]]:
                srcs[d] = (kind, None if isinstance(src, str) else src[1])
        self._stager.promise(task_id)
        entry = {"order": order, "parts": {}, "n_distinct": len(srcs),
                 "mode": payload.get("mode", "blob"),
                 "counts": {"cache": 0, "wire": 0, "peer": 0,
                            "requested": 0}}
        fetch, request = [], []
        with self._lock:
            self._tasks[task_id] = entry
            for d, (kind, spec) in srcs.items():
                data = self._cache.get(d)
                if data is not None:
                    entry["parts"][d] = data
                    entry["counts"]["cache"] += 1
                    continue
                self._want.setdefault(d, set()).add(task_id)
                if kind == "p":
                    fetch.append((d, spec))
                elif kind == "c":
                    request.append(d)   # evicted since the plan: re-pull
            done = len(entry["parts"]) == entry["n_distinct"]
            entry["counts"]["requested"] += len(request)
        self.stats["manifests"] += 1
        self.stats["cache_hits"] += entry["counts"]["cache"]
        if request:
            self.stats["requested"] += len(request)
            self._request(task_id, request)
        if fetch:
            threading.Thread(target=self._fetch, args=(task_id, fetch),
                             daemon=True,
                             name=f"node-{self.node_id}-fetch").start()
        if done:
            self._finish(task_id)

    def _request(self, task_id, digests) -> None:
        try:
            self._ch.send(CHUNK_REQ, {"node": self.node_id,
                                      "task_id": task_id,
                                      "digests": list(digests)})
        except TransportError:
            pass                       # peer gone: the node is tearing down

    def _fetch(self, task_id, jobs) -> None:
        """Pull peer-hinted chunks; any failure (dead peer, timeout,
        digest mismatch) falls back to one scheduler CHUNK_REQ — a bad
        relay costs latency, never a wedged wave."""
        from repro_torch.dist.chunks import peer_fetch
        fallback = []
        for d, spec in jobs:
            with self._lock:
                wanted = task_id in self._want.get(d, ())
            if not wanted:
                continue
            data = peer_fetch(spec, d)
            if data is None:
                fallback.append(d)
                continue
            self.stats["from_peer"] += 1
            self.stats["peer_bytes"] += len(data)
            self._deliver(d, data, "peer")
        if fallback:
            with self._lock:
                fallback = [d for d in fallback
                            if task_id in self._want.get(d, ())]
                entry = self._tasks.get(task_id)
                if entry is not None:
                    entry["counts"]["requested"] += len(fallback)
            if fallback:
                self.stats["peer_fallbacks"] += len(fallback)
                self.stats["requested"] += len(fallback)
                self._request(task_id, fallback)

    def on_chunk(self, payload: dict) -> None:
        """A scheduler-sent CHUNK frame: verify, cache, deliver."""
        d = payload["d"]
        data = payload.get("data")
        if data is None:
            # the scheduler could not re-send (store lost it): the chunk
            # is gone — fail the waiting shards loudly, not by timeout
            self._fail_digest(d, ProtocolError(
                f"chunk {d} lost: the scheduler could not re-send it"))
            return
        if chunk_digest(data) != d:
            self.stats["mismatches"] += 1
            self._fail_digest(d, ProtocolError(
                f"chunk digest mismatch on {self.node_id}: manifest "
                f"promised {d}, received bytes hash to "
                f"{chunk_digest(data)} — corrupt transfer, shard dropped"))
            return
        self.stats["from_wire"] += 1
        self._deliver(d, data, "wire")

    def _deliver(self, d: str, data: bytes, source: str) -> None:
        self._cache.put(d, data)
        finished = []
        with self._lock:
            for task_id in self._want.pop(d, ()):
                entry = self._tasks.get(task_id)
                if entry is None or d in entry["parts"]:
                    continue
                entry["parts"][d] = data
                entry["counts"][source] += 1
                if len(entry["parts"]) == entry["n_distinct"]:
                    finished.append(task_id)
        for task_id in finished:
            self._finish(task_id)

    def _fail_digest(self, d: str, err: BaseException) -> None:
        with self._lock:
            tasks = self._want.pop(d, set())
            for task_id in tasks:
                entry = self._tasks.pop(task_id, None)
                if entry is None:
                    continue
                for other, _ in entry["order"]:
                    waiters = self._want.get(other)
                    if waiters is not None:
                        waiters.discard(task_id)
                        if not waiters:
                            self._want.pop(other, None)
        for task_id in tasks:
            self._stager.fail(task_id, err)

    def _finish(self, task_id) -> None:
        with self._lock:
            entry = self._tasks.pop(task_id, None)
        if entry is None:
            return
        parts, order, counts = entry["parts"], entry["order"], entry["counts"]

        def produce():
            buf = [parts[d] for d, _ in order]
            if entry["mode"] == "rows":
                # row-group mode: every part is an independently pickled
                # slice along axis 0 — concatenation IS the reassembly
                groups = [pickle.loads(b) for b in buf]
                return (groups[0] if len(groups) == 1
                        else np.concatenate(groups))
            return pickle.loads(b"".join(buf))

        self._stager.stage_assembled(task_id, produce, extra={"dedup": {
            "chunks": len(order), "distinct": entry["n_distinct"],
            "from_cache": counts["cache"], "from_wire": counts["wire"],
            "from_peer": counts["peer"], "requested": counts["requested"],
            # cumulative node-side snapshots (NOT additive per shard):
            # aggregators take the latest per node
            "node_cache": dict(self._cache.stats),
            "node_peer_bytes": self.stats["peer_bytes"],
        }})

    def discard(self, task_id) -> None:
        """Forget a shard (cancelled before its SUBMIT ran here)."""
        with self._lock:
            entry = self._tasks.pop(task_id, None)
            if entry is not None:
                for d, _ in entry["order"]:
                    waiters = self._want.get(d)
                    if waiters is not None:
                        waiters.discard(task_id)
                        if not waiters:
                            self._want.pop(d, None)
        self._stager.discard(task_id)


def _run_shard(node_id: str, backend, stager, ctl: _WorkerCtl, channel,
               item: dict, numpy_out: bool,
               assembler: Optional[_ChunkAssembler] = None,
               node_metrics: Optional[Any] = None) -> None:
    """Execute one SUBMIT frame's shard and report its RESULT frame."""
    task_id = item["task_id"]
    # trace context propagated in the SUBMIT frame: (trace_id, span_id)
    # of the scheduler's shard span — node-side spans parent to it and
    # ride home inside the RESULT frame
    tc = item.get("tc")
    try:
        if task_id in ctl.cancelled:
            # cancelled scheduler-side (failover / abandoned race loser):
            # skip the compute, but consume the staged payload so the
            # stager never leaks an orphaned chunk
            if item.get("staged"):
                if assembler is not None:
                    assembler.discard(task_id)
                stager.discard(task_id)
            return
        if item.get("staged"):
            chunk, sinfo = stager.take(
                task_id,
                timeout=(_ChunkAssembler.TAKE_TIMEOUT_S
                         if assembler is not None else None))
        else:
            chunk, sinfo = stager.stage_inline(item["chunk"])
        chunk = from_wire(chunk)
        t_exec0 = time.time()
        pc0 = time.perf_counter()
        ctl.busy_begin()
        try:
            if ctl.throttle_s:
                time.sleep(ctl.throttle_s)
            kw = _lane_kwargs(backend, item["n"], item.get("inner_lanes"))
            out, rec = backend.dispatch(item["fn"], chunk, item["n"],
                                        **kw).result()
        finally:
            ctl.busy_end()
        t_exec = time.perf_counter() - pc0
        if ctl.killed.is_set():       # died mid-compute: result is lost
            return
        rec.extra["node_id"] = node_id
        rec.extra["device"] = device_label(backend.device)
        rec.t_stage = sinfo["t_stage"]
        rec.extra["stage"] = sinfo
        if node_metrics is not None and node_metrics.enabled:
            node_metrics.counter("node.shards").inc()
            node_metrics.histogram("node.stage_s").observe(sinfo["t_stage"])
            node_metrics.histogram("node.exec_s").observe(t_exec)
        if numpy_out:
            out = to_wire(out)
        result = {"task_id": task_id, "ok": True, "out": out, "rec": rec}
        if tc:
            # compact span tuples (name, t0, dur, attrs): the worker
            # thread ships timings only — ids and full span dicts are
            # built scheduler-side at trace-read time, off every hot path
            spans = []
            if "t0_wall" in sinfo:
                # the stage interval as it actually happened — an
                # overlapped stage renders UNDER the previous shard's exec
                spans.append(
                    ("node.stage", sinfo["t0_wall"],
                     max(sinfo["t1_wall"] - sinfo["t0_wall"], 0.0),
                     {"hidden_s": sinfo.get("hidden_s", 0.0),
                      "wait_s": sinfo.get("t_wait_s", 0.0),
                      "bytes": sinfo.get("bytes", 0),
                      "overlapped": sinfo.get("overlapped", False)}))
            spans.append(("node.exec", t_exec0, t_exec,
                          {"n": item["n"]}))
            result["spans"] = spans
        channel.send(RESULT, result)
    except (PayloadTooLarge, ProtocolError) as e:
        # PayloadTooLarge: the RESULT itself is too big for the wire;
        # ProtocolError: chunk assembly failed loudly (digest mismatch,
        # lost chunk). Either way the scheduler must still hear
        # SOMETHING, or the shard future hangs forever — send the
        # (tiny) error form. ProtocolError MUST precede the bare
        # TransportError clause below: it subclasses it, and a swallowed
        # mismatch would be exactly the silent corrupt stage the digest
        # check exists to prevent.
        try:
            channel.send(RESULT, {"task_id": task_id, "ok": False,
                                  "err": repr(e)})
        except TransportError:
            pass
    except TransportError:
        return
    except BaseException as e:  # noqa: BLE001 — reported to the scheduler
        if ctl.killed.is_set():
            return
        try:
            channel.send(RESULT, {"task_id": task_id, "ok": False,
                                  "err": repr(e)})
        except TransportError:
            pass


def _worker_loop(node_id: str, channel, ctl: _WorkerCtl,
                 heartbeat_s: float,
                 backend: Optional[Any] = None,
                 backend_kind: str = "array",
                 cache: Optional[Any] = None,
                 cache_dir: Optional[str] = None,
                 device: Optional[str] = None,
                 numpy_out: bool = False,
                 stage_dedup: bool = False,
                 chunk_cache_bytes: int = DEFAULT_CHUNK_CACHE_BYTES,
                 peer_mode: Optional[str] = None,
                 peer_bind_host: str = "127.0.0.1",
                 peer_advertise_host: Optional[str] = None,
                 obs_metrics: Optional[bool] = None) -> None:
    """The node side, identical for every host x transport combination:
    heartbeat thread (beats BEFORE the backend is built — booting, the
    CUDA context included, is not being dead), receiver thread (stages STAGE payloads overlapped with
    execution, queues SUBMITs, honours LEAVE), worker loop (execute +
    report). With ``stage_dedup``, the node keeps an LRU chunk cache,
    serves it to peers (``peer_mode``: "tcp" | "inproc" | None), and
    announces its serving endpoint in a PEER frame before anything
    heavy imports."""
    workq: "queue.Queue" = queue.Queue()

    # the node's own metrics registry (NOT the process-global one: a
    # thread-hosted fleet shares the process, and per-node numbers must
    # stay per-node). Enablement inherits the global flag, so a thread
    # fleet spawned after enable_observability() reports automatically;
    # process/remote hosts pass the flag explicitly.
    node_metrics = _obs.MetricsRegistry(
        enabled=_obs.REGISTRY.enabled if obs_metrics is None
        else obs_metrics)
    # incarnation nonce: rides every metrics piggyback so the scheduler
    # can tell "this id re-registered with fresh counters" (new nonce)
    # from "the same worker loop kept counting through a lease blip"
    # (same nonce) — the rejoin double-count fix lives on this bit
    incarnation = new_span_id()
    # filled in below as the heavy setup completes; the heartbeat thread
    # starts before any of it exists
    obs_src = {"cache": None, "stager": None, "assembler": None}

    def hb_payload():
        """Metrics piggyback: a HEARTBEAT that carries the node's latest
        cumulative snapshot home (latest-wins scheduler-side)."""
        m = node_metrics.snapshot()
        cc = obs_src["cache"]
        if cc is not None:
            for k, v in cc.stats.items():
                m[f"node.cache.{k}"] = v
        st = obs_src["stager"]
        if st is not None:
            for k, v in st.stats.items():
                m[f"node.stage.{k}"] = v
        asm = obs_src["assembler"]
        if asm is not None:
            for k, v in asm.stats.items():
                m[f"node.assembler.{k}"] = v
        return {"node": node_id, "m": m, "i": incarnation}

    def hb_loop() -> None:
        # metrics ride at most one beat per interval — a beat is ~tens of
        # bytes, a snapshot can be a few hundred; the lease must stay cheap
        m_interval = max(heartbeat_s * 4.0, 0.25)
        m_next = 0.0
        while not ctl.killed.is_set():
            # a graceful leave keeps beating until the worker has DRAINED
            # (unfinished_tasks covers the item the worker already popped:
            # a long final shard must not expire the lease — deregister
            # is never a failure)
            if ctl.stopping.is_set() and workq.unfinished_tasks == 0:
                return
            if obs_metrics is None:
                # inherited enablement tracks the global toggle live, so
                # a thread fleet follows enable/disable_observability()
                # mid-run (the fig_obs on/off interleave relies on it)
                node_metrics.enabled = _obs.REGISTRY.enabled
            payload: Any = node_id
            if node_metrics.enabled:
                now = time.monotonic()
                if now >= m_next:
                    m_next = now + m_interval
                    payload = hb_payload()
            try:
                channel.send(HEARTBEAT, payload)
            except TransportError:
                return
            time.sleep(heartbeat_s)

    threading.Thread(target=hb_loop, daemon=True,
                     name=f"node-{node_id}-hb").start()

    chunk_cache = peer_server = peer_spec = None
    if stage_dedup:
        from repro_torch.dist.chunks import (ChunkCache, PeerChunkServer,
                                       register_inproc_peer)
        chunk_cache = ChunkCache(max_bytes=chunk_cache_bytes)
        ctl.chunk_cache = chunk_cache
        if peer_mode == "tcp":
            try:
                peer_server = PeerChunkServer(
                    chunk_cache, bind_host=peer_bind_host,
                    advertise_host=peer_advertise_host)
                peer_spec = peer_server.spec
            except OSError:
                peer_spec = None       # can't serve peers; still dedups
        elif peer_mode == "inproc":
            peer_spec = register_inproc_peer(chunk_cache)
        try:
            channel.send(PEER, {"node": node_id,
                                "peer": list(peer_spec)
                                if peer_spec else None})
        except TransportError:
            pass

    # the backend after heartbeats start: in a process-hosted node this
    # is where the CUDA context comes up
    from repro_torch.core.staging import Stager
    if backend is None:
        backend = _node_backend(
            backend_kind, device, cache,
            cache_dir=cache_dir or _node_cache_dir(node_id))
    stager = Stager(busy_clock=ctl.busy_clock)
    assembler = (_ChunkAssembler(node_id, channel, stager, chunk_cache)
                 if stage_dedup else None)
    obs_src.update(cache=chunk_cache, stager=stager, assembler=assembler)

    def recv_loop() -> None:
        while not ctl.killed.is_set():
            try:
                frame = channel.recv(timeout=heartbeat_s)
            except TransportError:
                # peer gone: nothing more will arrive — drain and exit
                ctl.stopping.set()
                workq.put(None)
                return
            except Exception:  # noqa: BLE001 — poisoned frame
                # a frame that fails to DECODE (e.g. a fn that pickled on
                # the scheduler but has no importable home here) means a
                # SUBMIT this node can never run: dying loudly — stop
                # beating, let the lease expire — hands the shard to a
                # surviving node; wedging alive would hang it forever
                ctl.killed.set()
                return
            if frame is None:
                continue
            if frame.kind == STAGE:
                # staged HERE, in the receiver thread, while the worker
                # thread executes the previous shard: this is the overlap
                p = frame.payload
                if "chunks" in p:
                    if assembler is None:
                        # a manifest this node cannot assemble is a
                        # SUBMIT it can never run: die loudly (same
                        # contract as an undecodable frame below)
                        ctl.killed.set()
                        return
                    assembler.begin(p)
                else:
                    stager.stage(p["task_id"], p["chunk"])
            elif frame.kind == CHUNK:
                if assembler is not None:
                    assembler.on_chunk(frame.payload)
            elif frame.kind == SUBMIT:
                workq.put(frame.payload)
            elif frame.kind == LEAVE:
                ctl.stopping.set()
                workq.put(None)
                return

    threading.Thread(target=recv_loop, daemon=True,
                     name=f"node-{node_id}-recv").start()

    while not ctl.killed.is_set():
        if ctl.paused.is_set():
            time.sleep(heartbeat_s / 2)
            continue
        try:
            item = workq.get(timeout=heartbeat_s)
        except queue.Empty:
            continue
        try:
            if item is None:          # drained past the LEAVE sentinel
                break
            _run_shard(node_id, backend, stager, ctl, channel, item,
                       numpy_out, assembler, node_metrics)
        finally:
            workq.task_done()
    if peer_server is not None:
        peer_server.close()           # a dead/left node serves nobody
    if peer_spec is not None and peer_spec[0] == "inproc":
        from repro_torch.dist.chunks import unregister_inproc_peer
        unregister_inproc_peer(peer_spec)
    if ctl.stopping.is_set() and not ctl.killed.is_set():
        try:
            channel.send(LEAVE, node_id)
        except TransportError:
            pass
        channel.close()


def _node_backend(kind: str, device: Optional[str],
                  cache: Optional[Any] = None,
                  devices: Optional[list] = None,
                  cache_dir: Optional[str] = None):
    """A node's own launch backend on ``device`` (the card unless "cpu";
    without a card it raises — a node never falls back to the CPU), with
    ``cache`` or a compile cache of its own over ``cache_dir``. A
    ``devices`` subset takes the place of ``device``: one device runs the
    node, more make a ``("data",)`` mesh over them, as the reference's
    nodes do."""
    from repro_torch.core.backend import make_backend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.launch.mesh import Mesh
    mesh = None
    if devices:
        device = devices[0]
        if len(devices) > 1:
            mesh = Mesh(list(devices), ("data",))
    return make_backend(kind, mesh=mesh, device=device,
                        cache=cache if cache is not None
                        else CompileCache(cache_dir=cache_dir))


def _process_main(node_id: str, endpoint: tuple, heartbeat_s: float,
                  backend_kind: str, device: str, cache_dir: str,
                  stage_dedup: bool = False,
                  chunk_cache_bytes: int = DEFAULT_CHUNK_CACHE_BYTES,
                  obs_metrics: bool = False) -> None:
    """Entry point of a process-hosted node: connect first (cheap), beat
    while the CUDA context comes up, then serve shards until LEAVE or
    SIGTERM."""
    channel = open_worker_channel(endpoint)
    if device == "cpu":
        # one thread per node process, as the reference's single-threaded
        # XLA CPU flag: local nodes share the machine's cores
        torch.set_num_threads(1)
    # peers can only reach a process-hosted node over TCP; an inproc
    # cache token would not resolve across the spawn boundary
    peer_mode = "tcp" if endpoint[0] == "socket" else None
    spec = endpoint[1] if isinstance(endpoint[1], dict) else {}
    _worker_loop(node_id, channel, _WorkerCtl(), heartbeat_s,
                 backend_kind=backend_kind, device=device,
                 cache_dir=cache_dir, numpy_out=True,
                 stage_dedup=stage_dedup,
                 chunk_cache_bytes=chunk_cache_bytes, peer_mode=peer_mode,
                 peer_bind_host=spec.get("peer_bind_host", "127.0.0.1"),
                 peer_advertise_host=spec.get("peer_advertise_host"),
                 obs_metrics=obs_metrics)


class NodeAgent:
    """Scheduler-side handle of one node: owns the channel, the pending
    shard futures, and the node's lifecycle. ``host`` picks where the
    worker runs ("thread" | "process" | "remote" — a self-registered
    worker whose ``channel`` arrives via the transport's unclaimed-node
    callback); ``transport`` how frames travel (an ``InprocTransport``/
    ``SocketTransport`` instance — every agent of a fabric may share one
    transport; each gets its own channel, all channels share the
    transport's single ``FramePump`` thread). ``device`` is where a thread
    or process host runs its backend: the card unless ``"cpu"``; without
    a card it raises. ``devices`` gives a thread host its own subset of
    devices in its place (``_node_backend``). ``alive_s`` is the seconds from ``start`` to the
    node's first heartbeat (a process host: from its spawn)."""

    def __init__(self, node_id: str, registry: NodeRegistry,
                 capacity: int = 1,
                 transport: Optional[Any] = None,
                 host: str = "thread",
                 backend: Optional[Any] = None,
                 backend_kind: str = "array",
                 cache: Optional[Any] = None,
                 cache_dir: Optional[str] = None,
                 device=None,
                 devices: Optional[list] = None,
                 heartbeat_s: Optional[float] = None,
                 overlap_staging: bool = True,
                 stage_dedup: bool = False,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 chunk_cache_bytes: int = DEFAULT_CHUNK_CACHE_BYTES,
                 directory: Optional[ChunkDirectory] = None,
                 channel: Optional[Any] = None,
                 start: bool = True):
        if host not in ("thread", "process", "remote"):
            raise ValueError(f"unknown node host {host!r}; "
                             f"choose 'thread', 'process' or 'remote'")
        if host == "remote" and channel is None:
            raise ValueError("host='remote' needs the worker's channel "
                             "(the transport's unclaimed-node callback "
                             "provides it)")
        self.node_id = node_id
        self.registry = registry
        self.capacity = capacity
        self.transport = transport if transport is not None \
            else InprocTransport()
        self.host = host
        self.heartbeat_s = heartbeat_s if heartbeat_s is not None \
            else (0.02 if host == "thread" else 0.05)
        self.overlap_staging = overlap_staging
        # content-addressed staging rides the overlapped STAGE path; the
        # inline (overlap_staging=False) baseline stays point-to-point
        self.stage_dedup = bool(stage_dedup) and overlap_staging
        self.chunk_bytes = chunk_bytes
        self.chunk_cache_bytes = chunk_cache_bytes
        if self.stage_dedup and directory is None:
            directory = ChunkDirectory(registry,
                                       node_cache_bytes=chunk_cache_bytes)
        self.directory = directory
        self._peer_ready = threading.Event()
        self.devices = devices
        self._killed = False
        self._stopping = False
        self._booted = host != "process"
        self._pending: dict = {}
        # task ids whose STAGE was skipped at send time (resolved or
        # cancelled first): their paired SUBMIT must be skipped too.
        # Pump-thread-only state — prepare closures run serialized there.
        self._skipped: set = set()
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._ch = channel
        self._proc = None
        self._port = None
        self.pump = None
        self._ctl: Optional[_WorkerCtl] = None
        self._t_start: Optional[float] = None
        self.alive_s: Optional[float] = None
        # everything crossing a socket (or a process/host boundary) must
        # be serialized; thread+inproc passes by reference
        self._numpy_out = (host in ("process", "remote")
                           or getattr(self.transport, "name", "") == "socket")
        if host == "thread":
            if backend is None:
                backend = _node_backend(
                    backend_kind, device, cache, devices,
                    cache_dir=cache_dir or _node_cache_dir(node_id))
            self.backend = backend
            self._ctl = _WorkerCtl()
            self._port = self.transport.create(node_id)
        elif host == "process":
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            self._port = self.transport.create(
                node_id,
                ctx=ctx if isinstance(self.transport, InprocTransport)
                else None)
            # resolved here, so a fabric without a card raises before it
            # spawns; the child's compile cache is its own (no object is
            # shared across the spawn boundary)
            from repro_torch.kernels.ops import resolve_device
            if cache_dir is None:
                cache_dir = (cache.cache_dir if cache is not None
                             else _node_cache_dir(node_id))
            self._proc = ctx.Process(
                target=_process_main,
                args=(node_id, self._port.endpoint, self.heartbeat_s,
                      backend_kind, str(resolve_device(device)), cache_dir,
                      self.stage_dedup,
                      self.chunk_cache_bytes,
                      # obs enablement snapshotted at spawn: the child
                      # has its own registry and cannot see ours
                      _obs.REGISTRY.enabled),
                daemon=True)
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "NodeAgent":
        self._t_start = time.perf_counter()
        self.registry.register(self.node_id, self.capacity)
        if self.host == "thread":
            endpoint = self._port.endpoint
            peer_mode = ("tcp" if getattr(self.transport, "name", "")
                         == "socket" else "inproc")
            peer_bind = getattr(self.transport, "bind_host", "127.0.0.1")
            peer_adv = getattr(self.transport, "advertise_host", None)

            def thread_main():
                channel = open_worker_channel(endpoint)
                _worker_loop(self.node_id, channel, self._ctl,
                             self.heartbeat_s, backend=self.backend,
                             numpy_out=self._numpy_out,
                             stage_dedup=self.stage_dedup,
                             chunk_cache_bytes=self.chunk_cache_bytes,
                             peer_mode=peer_mode,
                             peer_bind_host=peer_bind,
                             peer_advertise_host=peer_adv)

            t = threading.Thread(target=thread_main, daemon=True,
                                 name=f"node-{self.node_id}-worker")
            t.start()
            self._threads.append(t)
        elif self.host == "process":
            self._proc.start()
        if self._ch is None:
            # blocks, for sockets, until the worker has dialled in
            self._ch = self._port.driver_channel()
        # hand the connection to the transport's shared selector pump:
        # from here on every frame this node sends arrives via _on_frame
        # and its death (EOF) via _on_eof — no per-node threads
        self.pump = self.transport.pump
        self.pump.register(
            self.node_id, self._ch,
            on_frame=self._on_frame, on_eof=self._on_eof,
            tick=self._boot_tick if self.host == "process" else None,
            tick_interval=self.heartbeat_s)
        if self.stage_dedup:
            # the node's PEER frame is its first post-handshake message;
            # waiting for it lets the very first wave fan out peer-to-
            # peer (missing it degrades to direct send, never an error)
            self._peer_ready.wait(timeout=2.0)
        return self

    def kill(self) -> None:
        """Abrupt node death: heartbeats stop NOW, queued shards never
        run, an in-flight shard's result is dropped. Detection is the
        registry's job (lease expiry — or, over sockets, the dropped
        connection), not ours: dead nodes don't announce themselves."""
        self._killed = True
        if self._proc is not None:
            if self._proc.is_alive():
                self._proc.terminate()
        elif self._ctl is not None:
            self._ctl.killed.set()
        if self.directory is not None:
            with self._lock:
                pending = list(self._pending)
            for task_id in pending:
                self._unpin(task_id)
            self.directory.drop_node(self.node_id)
        # the pump forgets the node first (a deliberate kill is not an
        # EOF event), then the host's connection goes with it (over TCP
        # the FIN is physical reality, not an announcement)
        if self.pump is not None:
            self.pump.unregister(self.node_id)
        if self._ch is not None:
            self._ch.close()

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful leave: drain the queue, send LEAVE, deregister."""
        self._stopping = True
        if self.pump is not None:
            self.pump.send(self.node_id, LEAVE, self.node_id)
        deadline = time.monotonic() + timeout
        if self._proc is not None:
            self._proc.join(timeout)

        def _left() -> bool:
            info = self.registry.info(self.node_id)
            return info is None or info.state == LEFT

        while time.monotonic() < deadline and not _left():
            time.sleep(self.heartbeat_s / 2)
        # belt and braces: a leave must never read as a failure, even if
        # the LEAVE frame raced a teardown
        if not _left():
            self.registry.deregister(self.node_id)
        if self.pump is not None:
            self.pump.unregister(self.node_id)
        if self._ch is not None:
            self._ch.close()
        for t in self._threads:
            t.join(min(timeout, 2.0))

    def pause(self) -> None:
        """Stop taking work while still heartbeating — a wedged-but-alive
        node (test/bench affordance: makes kill-mid-wave deterministic).
        Thread hosts only."""
        if self._ctl is not None:
            self._ctl.paused.set()

    def resume(self) -> None:
        if self._ctl is not None:
            self._ctl.paused.clear()

    def throttle(self, seconds_per_shard: float) -> None:
        """Inject per-shard slowness (test/bench affordance: the measured
        capacity re-weighting's deliberately slow node). Thread hosts."""
        if self._ctl is None:
            raise RuntimeError("throttle() is a thread-host affordance")
        self._ctl.throttle_s = seconds_per_shard

    @property
    def alive(self) -> bool:
        ok = not self._killed and not self._stopping
        if self.host == "process":
            ok = ok and self._proc.is_alive()
        return ok

    # -- scheduler-side protocol (runs on the transport's pump thread) ------
    def submit(self, fn: Callable, chunk: Any, n: int,
               inner_lanes: Optional[int] = None,
               row_offset: int = 0) -> ShardTask:
        """Enqueue one shard. Returns immediately: the payload travels
        as pump jobs (a STAGE frame ahead of a tiny SUBMIT when staging
        overlap is on) whose serialization happens on the pump thread,
        so transfer overlaps earlier waves' execution. ``row_offset`` is
        the shard's global position in its wave — content-addressed
        staging aligns its chunk boundaries to it, so the same rows
        yield the same digests however the wave was split."""
        task = ShardTask(fn, chunk, n, inner_lanes)
        task._on_cancel = self._cancel_hook
        if TRACER.enabled:
            # the per-shard span: its id is allocated now (the context
            # rides in the frames so node-side spans land in the same
            # tree), closed by the RESULT frame; the span dict itself is
            # deferred off this per-shard dispatch path
            parent = TRACER.context()
            tid = parent[0] if parent is not None else new_trace_id()
            task.obs_ctx = (tid, new_span_id())
            task.obs_parent = parent[1] if parent is not None else None
            task.obs_t0 = time.time()
            task.obs_pc0 = time.perf_counter()
        with self._lock:
            self._pending[task.task_id] = task
        if self._numpy_out or self.stage_dedup:
            # host numpy for the wire; for dedup also byte-stable, so
            # identical shard content yields identical chunk digests
            chunk = to_wire(chunk)
        sub = {"task_id": task.task_id, "fn": fn, "n": n,
               "inner_lanes": inner_lanes}
        if task.obs_ctx is not None:
            sub["tc"] = task.obs_ctx
        on_error = lambda e, t=task: self._send_error(t, e)  # noqa: E731
        if self.overlap_staging:
            payload = {"task_id": task.task_id, "chunk": chunk,
                       "off": row_offset}
            if task.obs_ctx is not None:
                payload["tc"] = task.obs_ctx
            sub["staged"] = True
            self.pump.submit_job(
                self.node_id,
                lambda: self._prepare_stage(payload, task),
                task=task, on_error=on_error)
        else:
            sub["chunk"] = chunk
        self.pump.submit_job(
            self.node_id,
            lambda: self._prepare_submit(sub, task),
            task=task, on_error=on_error)
        return task

    def _prepare_stage(self, payload: dict, task: ShardTask):
        """Pump-side send decision for a STAGE job: a poisoned pair
        (payload already errored) or a shard cancelled BEFORE its bytes
        hit the wire is skipped whole — its paired SUBMIT follows suit
        via ``_skipped``. Once the STAGE is out, its SUBMIT must follow
        so the node's stager entry is consumed."""
        if self._killed:
            return None
        if task.ready or task.cancelled:
            self._skipped.add(task.task_id)
            return None
        if self.stage_dedup:
            return self._prepare_stage_dedup(payload, task)
        return ((STAGE, payload),)

    def _prepare_submit(self, sub: dict, task: ShardTask):
        if self._killed or task.ready:
            return None
        if task.task_id in self._skipped:
            self._skipped.discard(task.task_id)
            return None
        if task.cancelled and not sub.get("staged"):
            return None
        return ((SUBMIT, sub),)

    def _send_error(self, task: ShardTask, err: BaseException) -> None:
        """A per-task send failure (oversized/unpicklable payload):
        encode failed BEFORE any bytes hit the stream, so the channel is
        intact — fail just this shard, keep the connection."""
        task.set_error(err)
        ctx, task.obs_ctx = task.obs_ctx, None
        if ctx is not None:
            TRACER.defer("shard", (ctx[0], task.obs_parent), task.obs_t0,
                         time.perf_counter() - task.obs_pc0, "driver",
                         {"node": self.node_id, "task_id": task.task_id,
                          "ok": False, "send_error": repr(err)},
                         sid=ctx[1])
        self._unpin(task.task_id)

    def _cancel_hook(self, task_id) -> None:
        if self._ctl is not None:
            # thread hosts share the ctl object with their worker: a
            # scheduler-side cancel reaches the execution loop directly
            self._ctl.cancelled.add(task_id)
        self._unpin(task_id)

    def _unpin(self, task_id) -> None:
        if self.directory is not None:
            self.directory.unpin_task((self.node_id, task_id))

    @staticmethod
    def _stage_parts(chunk: Any, eff: int, off: int = 0) -> tuple:
        """-> (mode, parts): the shard payload serialized for
        content-addressed staging. An ndarray payload is pickled as
        fixed-size ROW GROUPS along axis 0, with group boundaries
        aligned to the shard's GLOBAL row offset in its wave: the same
        rows produce the same digests whatever slice boundaries the
        capacity-weighted split chose, so measured re-weighting shifting
        every shard between waves invalidates at most the two boundary
        groups per shard, and a repeat wave re-sends (almost) nothing.
        Anything else falls back to one pickle byte-split at ``eff``."""
        if (isinstance(chunk, np.ndarray) and chunk.ndim >= 1
                and chunk.shape[0] > 1 and chunk.nbytes > 0):
            stride = max(chunk.nbytes // chunk.shape[0], 1)
            rows = max(1, eff // stride)
            if rows < chunk.shape[0]:
                # first boundary at the next global multiple of ``rows``
                first = (rows - off % rows) % rows or rows
                starts = list(range(first, chunk.shape[0], rows))
                return "rows", [
                    pickle.dumps(np.ascontiguousarray(chunk[i:j]),
                                 protocol=pickle.HIGHEST_PROTOCOL)
                    for i, j in zip([0] + starts,
                                    starts + [chunk.shape[0]])]
        blob = pickle.dumps(chunk, protocol=pickle.HIGHEST_PROTOCOL)
        return "blob", chunk_split(blob, eff)

    def _prepare_stage_dedup(self, payload: dict, task: ShardTask):
        """Content-addressed STAGE: serialize the shard payload into
        digest-keyed chunks and emit per the directory's plan — nothing
        for chunks the node holds, a peer hint for chunks a healthy
        holder can serve, bytes otherwise. Returns the frames to send.
        An over-cap payload raises ``PayloadTooLarge`` before ANY frame
        goes out (the cap bounds the shard, not just a frame — chunking
        must not smuggle oversized waves past it)."""
        task_id = payload["task_id"]
        cap = self._ch.max_frame_bytes
        # keep every CHUNK frame (body + framing overhead) under the cap
        eff = max(1, min(self.chunk_bytes, cap - 4096))
        mode, parts = self._stage_parts(payload["chunk"], eff,
                                        payload.get("off", 0))
        total = sum(len(p) for p in parts)
        if total > cap:
            raise PayloadTooLarge(
                f"STAGE payload {total} bytes exceeds the frame cap "
                f"{cap}")
        manifest, to_wire, seen = [], [], {}
        for data in parts:
            d = chunk_digest(data)
            if d not in seen:
                self.directory.store_put(d, data)
                plan = self.directory.plan(self.node_id, d, len(data))
                if plan == "wire":
                    to_wire.append((d, data))
                    seen[d] = "w"
                elif plan == "cached":
                    seen[d] = "c"
                else:
                    seen[d] = ["p", list(plan[1])]
            manifest.append([d, len(data), seen[d]])
        # pinned until the shard resolves: a CHUNK_REQ for an evicted or
        # relay-failed chunk must always be answerable from the store
        self.directory.pin_task((self.node_id, task_id), seen)
        stage_payload = {"task_id": task_id,
                         "chunks": manifest, "mode": mode}
        if "tc" in payload:
            stage_payload["tc"] = payload["tc"]
        frames = [(STAGE, stage_payload)]
        frames.extend((CHUNK, {"d": d, "data": data}) for d, data in to_wire)
        return frames

    def _on_result(self, payload: dict) -> None:
        with self._lock:
            task = self._pending.pop(payload["task_id"], None)
        if task is None or self._killed:
            return
        self._unpin(payload["task_id"])
        ctx, task.obs_ctx = task.obs_ctx, None
        spans = payload.get("spans")
        if spans and ctx is not None:
            # node-side compact spans (stage/exec) arrive in the RESULT
            # frame; park them for lazy expansion under this shard's
            # span — one deque append on the pump thread, nothing more
            TRACER.defer_result(ctx, f"node:{self.node_id}", spans)
        if payload.get("ok"):
            rec = payload["rec"]
            if rec is not None and task.wire_bytes:
                # the scheduler-side half of the dedup split: the node
                # reported bytes DELIVERED, this is what the wire carried
                rec.extra.setdefault("stage", {})[
                    "bytes_on_wire"] = task.wire_bytes
            task.set_result(payload["out"], rec)
        else:
            task.set_error(RuntimeError(
                f"node {self.node_id} shard failed: {payload['err']}"))
        if ctx is not None:
            TRACER.defer("shard", (ctx[0], task.obs_parent), task.obs_t0,
                         time.perf_counter() - task.obs_pc0, "driver",
                         {"node": self.node_id, "task_id": task.task_id,
                          "n": task.n, "ok": bool(payload.get("ok")),
                          "wire_bytes": task.wire_bytes},
                         sid=ctx[1])

    def _on_chunk_req(self, payload: dict) -> None:
        """The node cannot produce chunks its manifest promised (evicted
        under memory pressure, or a peer relay failed): correct the
        directory's model and re-send from the authoritative store. A
        chunk the store ALSO lost goes out as an explicit tombstone so
        the shard fails loudly instead of timing out."""
        if self.directory is None:
            return
        digests = list(payload.get("digests") or ())
        self.directory.forget(self.node_id, digests)
        with self._lock:
            task = self._pending.get(payload.get("task_id"))
        for d in digests:
            data = self.directory.store_get(d)
            if data is not None:
                self.directory.record(self.node_id, d, len(data))
            self.pump.submit_job(
                self.node_id,
                lambda p={"d": d, "data": data}: ((CHUNK, p),),
                task=task,
                on_error=(None if task is None else
                          (lambda e, t=task: self._send_error(t, e))))

    def _on_frame(self, frame) -> None:
        """Scheduler-side frame router (pump thread): heartbeats renew
        the lease, results resolve futures, LEAVE deregisters."""
        if frame.kind == HEARTBEAT:
            self._booted = True
            if self.alive_s is None and self._t_start is not None:
                self.alive_s = time.perf_counter() - self._t_start
            if not self._killed:
                self.registry.heartbeat(self.node_id)
                p = frame.payload
                if isinstance(p, dict) and "m" in p:
                    # metrics piggyback: the node's cumulative snapshot
                    # flew home on the beat — latest wins per node
                    _obs.REGISTRY.ingest_node(p.get("node") or self.node_id,
                                              p["m"],
                                              incarnation=p.get("i"))
        elif frame.kind == RESULT:
            self._on_result(frame.payload)
        elif frame.kind == CHUNK_REQ:
            self._on_chunk_req(frame.payload)
        elif frame.kind == PEER:
            if self.directory is not None:
                self.directory.set_peer(self.node_id,
                                        frame.payload.get("peer"))
            self._peer_ready.set()
        elif frame.kind == LEAVE:
            if self.directory is not None:
                self.directory.drop_node(self.node_id)
            self.registry.deregister(self.node_id)
            self.pump.unregister(self.node_id)

    def _on_eof(self, err) -> None:
        """Connection death without a LEAVE: condemned as node death
        (dead connection ≡ lease expiry), unless WE initiated the
        teardown (kill/stop close the channel deliberately)."""
        if not self._killed and not self._stopping:
            self.registry.expire(self.node_id)
        if self.directory is not None:
            self.directory.drop_node(self.node_id)

    def _boot_tick(self) -> None:
        """Boot grace (process hosts, pump tick): the spawn bootstrap
        (python + torch import in the child) outlives short leases — the
        parent vouches for a LIVE process it can see until the child's
        own beats start flowing."""
        if (not self._booted and not self._killed
                and self._proc is not None and self._proc.is_alive()):
            self.registry.heartbeat(self.node_id)


class ProcessNodeAgent(NodeAgent):
    """A node hosted in its own Python process (``multiprocessing``
    spawn): its own CUDA context, whose death is a real process death.
    Same interface as ``NodeAgent``; shard functions must be picklable
    (module-level), as anything crossing host boundaries must be."""

    def __init__(self, node_id: str, registry: NodeRegistry, **kwargs):
        kwargs.setdefault("host", "process")
        super().__init__(node_id, registry, **kwargs)


def spawn_local_nodes(n_nodes: int, registry: NodeRegistry,
                      mode: str = "thread",
                      capacities: Optional[List[int]] = None,
                      name_prefix: str = "node",
                      transport: Optional[Any] = None,
                      **agent_kwargs) -> List[Any]:
    """Spin up ``n_nodes`` local node agents (simulated multi-host).
    ``mode`` is "thread" (default; shared process, isolated state) or
    "process" (real ``multiprocessing`` workers); ``transport`` is shared
    by the fleet (one ``SocketTransport`` listener serves every node).
    Thread nodes partition the fabric's devices round-robin (the cards,
    by default; ``agent_kwargs["device"]`` names another) so each node
    owns a distinct subset, as the reference's do; with fewer devices than
    nodes — one card, or the CPU — every node runs on the fabric's device
    (on one card a node's subset is that card)."""
    caps = capacities or [1] * n_nodes
    if len(caps) != n_nodes:
        raise ValueError(f"capacities has {len(caps)} entries "
                         f"for {n_nodes} nodes")
    transport = transport if transport is not None else InprocTransport()
    if mode == "process":
        return [NodeAgent(f"{name_prefix}{i}", registry, capacity=caps[i],
                          host="process", transport=transport,
                          **agent_kwargs)
                for i in range(n_nodes)]
    if mode != "thread":
        raise ValueError(f"unknown node mode {mode!r}; "
                         f"choose 'thread' or 'process'")
    from repro_torch.kernels.ops import resolve_device
    dev = resolve_device(agent_kwargs.get("device"))
    devs = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" and dev.index is None else [dev])
    return [NodeAgent(f"{name_prefix}{i}", registry, capacity=caps[i],
                      transport=transport,
                      devices=devs[i::n_nodes] if len(devs) >= n_nodes
                      else None, **agent_kwargs)
            for i in range(n_nodes)]


def _connect_main(argv: Optional[List[str]] = None) -> None:
    """``python -m repro_torch.dist.node --connect HOST:PORT [--secret-file F]``

    Bootstrap of a REMOTE node: dial the fabric's ``SocketTransport``,
    answer its HMAC challenge (when the fleet is secret-armed), and
    self-register through the elastic-join path — the scheduler's
    unclaimed-connection callback builds the matching agent, and from
    then on this process is a node like any other (shards in, results
    out, LEAVE on drain). Blocks until the scheduler sends LEAVE or the
    connection drops."""
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.dist.node",
        description="join a running launch fabric as a worker node")
    parser.add_argument("--connect", required=True, metavar="HOST:PORT",
                        help="the scheduler transport's advertise address")
    parser.add_argument("--node-id", default=None,
                        help="node id (default: remote-<host>-<pid>)")
    parser.add_argument("--capacity", type=int, default=1,
                        help="capacity weight in the wave shard split")
    parser.add_argument("--secret-file", default=None,
                        help="file holding the fleet's shared secret "
                             "(required when the scheduler is armed)")
    parser.add_argument("--backend", default="array",
                        help="node-local launch backend kind")
    parser.add_argument("--heartbeat-s", type=float, default=0.25)
    parser.add_argument("--device", default=None,
                        help="where the node runs: the card unless 'cpu'")
    parser.add_argument("--cache-dir", default=None,
                        help="node-local compile-cache record directory")
    parser.add_argument("--chunk-cache-bytes", type=int,
                        default=DEFAULT_CHUNK_CACHE_BYTES)
    parser.add_argument("--peer-bind-host", default="0.0.0.0",
                        help="bind host for the node's peer chunk server")
    parser.add_argument("--peer-advertise-host", default=None,
                        help="address peers should dial for chunks "
                             "(default: this host's name)")
    parser.add_argument("--obs-metrics", action="store_true",
                        help="collect node-side metrics and piggyback "
                             "them on HEARTBEAT frames")
    args = parser.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    if not host or not port.isdigit():
        parser.error(f"--connect wants HOST:PORT, got {args.connect!r}")
    # a node never falls back to the CPU: without a card, fail before
    # dialling in
    from repro_torch.kernels.ops import resolve_device
    device = str(resolve_device(args.device))
    node_id = args.node_id or f"remote-{_socket.gethostname()}-{os.getpid()}"
    secret = None
    if args.secret_file:
        with open(args.secret_file, "rb") as f:
            secret = f.read().strip()
    from repro_torch.dist.transport import SocketTransport
    channel = SocketTransport.connect((host, int(port)), node_id,
                                      secret=secret,
                                      capacity=args.capacity)
    if device == "cpu":
        torch.set_num_threads(1)
    _worker_loop(node_id, channel, _WorkerCtl(), args.heartbeat_s,
                 backend_kind=args.backend, device=device,
                 cache_dir=args.cache_dir, numpy_out=True, stage_dedup=True,
                 chunk_cache_bytes=args.chunk_cache_bytes,
                 peer_mode="tcp",
                 peer_bind_host=args.peer_bind_host,
                 peer_advertise_host=(args.peer_advertise_host
                                      or _socket.gethostname()),
                 obs_metrics=args.obs_metrics)


if __name__ == "__main__":
    _connect_main()
