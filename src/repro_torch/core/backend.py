"""LaunchBackend: one protocol for every way this repo starts instances.
Port of ``repro.core.backend``.

The paper's launch tree is scheduler -> node -> core: ONE scheduler
interaction fans an array job out to nodes, each node fans out to cores,
and staging overlaps with dispatch so no level ever waits on a level it
does not depend on. This module is that tree on one card:

  SerialBackend     the heavyweight-VM baseline — every instance pays its
                    own trace + capture + run (Fig 6's serial curve): a new
                    executable per instance, never cached.
  ArrayBackend      the LLMapReduce array job — ONE captured graph of
                    ``torch.func.vmap(fn)`` over the wave's task axis; the
                    per-instance marginal cost is a vmap lane. Captures
                    through the ``CompileCache``, so a repeat launch of the
                    same wave shape replays.
  PipelinedBackend  ArrayBackend with ``depth`` waves in flight, each on
                    its own CUDA stream with its own graph: wave k+1's
                    input goes host-to-device from pinned memory
                    (``non_blocking``) and its graph replays while wave k
                    still runs; results are harvested by non-blocking
                    ``Event.query()`` polls instead of a per-wave barrier.

Hierarchy: a wave of W tasks optionally splits into (W // inner_lanes)
outer tasks x ``inner_lanes`` inner vmap lanes (``vmap(vmap(fn))``) — the
outer axis is the "node" level, the inner axis the "core" level. Per-level
counts land in ``LaunchRecord.fanout`` and per-level timings in
``LaunchRecord.levels()``. The reference's mesh and ``task_axis`` (sharding
the outer axis over devices) are not ported: there is one card.

``dispatch()`` is the one verb: it returns a ``WaveHandle`` whose result
may still be computing. A wave's outputs are copied out of the graph's
memory on the wave's stream right after its replay, so the next replay of
the same graph cannot overwrite a wave nobody harvested yet. Synchronous
backends advertise ``max_in_flight = 1``; ``PipelinedBackend`` advertises
its depth. Backends run on the card unless built with ``device="cpu"``.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.compile_cache import (CompileCache, default_cache,
                                            make_executable)
from repro_torch.core.telemetry import LaunchRecord, Timer
from repro_torch.kernels.ops import resolve_device


def as_tensors(tree: Any) -> Any:
    """Numpy leaves -> torch tensors on the host (no copy where numpy
    allows); tensors stay where they are."""
    return pytree.tree_map(
        lambda x: torch.as_tensor(x) if isinstance(x, np.ndarray) else x,
        tree)


def concat_outputs(parts: list) -> Any:
    """Concatenate per-wave outputs along the task axis — the ONE merge
    semantics of the policy driver's wave concat."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], list):   # serial scheduler: per-task out lists
        return [o for p in parts for o in p]
    return pytree.tree_map(lambda *xs: torch.cat(list(xs), dim=0), *parts)


def _copy_out(tree: Any) -> Any:
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


class WaveHandle:
    """One in-flight wave: outputs may still be computing on the card.
    ``event`` (recorded on the wave's stream after its outputs were copied
    out) tells readiness; a wave without one completed synchronously.

    Failure-aware subclasses set ``can_fail = True`` and may return True
    from ``failed()`` once the wave can no longer complete on its own: the
    distributed fabric's ``DistWaveHandle`` (``repro_torch.dist``)."""

    can_fail = False

    def __init__(self, out: Any, rec: LaunchRecord, t0: float,
                 event: Optional["torch.cuda.Event"] = None,
                 keep: Any = None):
        self.out = out
        self.rec = rec
        self.t0 = t0                      # perf_counter at dispatch
        self.event = event
        self._keep = keep                 # pinned inputs in flight
        self._t_first: Optional[float] = None
        self._harvested = False

    @classmethod
    def done(cls, out: Any, rec: LaunchRecord, t0: float) -> "WaveHandle":
        """A wave that completed synchronously (rec timings already set)."""
        h = cls(out, rec, t0)
        h._t_first = rec.t_first_result or None
        h._harvested = True
        return h

    def failed(self) -> bool:
        return False

    def _ready(self) -> bool:
        return self.event is None or self.event.query()

    def poll(self) -> bool:
        """Non-blocking readiness check; notes time-to-first-result."""
        if self._harvested:
            return True
        ready = self._ready()
        if ready and self._t_first is None:
            self._t_first = time.perf_counter() - self.t0
        return ready

    def result(self) -> tuple:
        """Block until the wave completes; returns (out, LaunchRecord)."""
        if not self._harvested:
            if self.event is not None:
                self.event.synchronize()
            if self._t_first is None:
                self._t_first = time.perf_counter() - self.t0
            self.rec.t_spawn = time.perf_counter() - self.t0
            self.rec.t_first_result = self._t_first
            self._keep = None
            self._harvested = True
        return self.out, self.rec

    def abandon(self):
        """Finalize this attempt's record WITHOUT blocking on the card (a
        speculative re-dispatch won the race; its cost stays visible)."""
        if not self._harvested:
            now = time.perf_counter()
            self.rec.t_spawn = now - self.t0
            self.rec.t_first_result = (self._t_first
                                       if self._t_first is not None
                                       else self.rec.t_spawn)
            self.rec.extra["abandoned"] = True
        return self.rec


@runtime_checkable
class LaunchBackend(Protocol):
    """What the policy layer (``core.llmr``) needs from a launcher."""

    name: str
    max_in_flight: int

    def dispatch(self, fn: Callable, chunk: Any, n: int) -> WaveHandle: ...

    def launch(self, fn: Callable, inputs: Any, n: int) -> tuple: ...

    # Backends whose waves have a node/core hierarchy additionally set
    # ``supports_lane_override = True`` and accept a per-dispatch
    # ``inner_lanes=`` keyword (used by wave autoscaling).


def _item(tree: Any, i: int) -> Any:
    return pytree.tree_map(lambda x: x[i], tree)


# ----------------------------------------------------------------------
# Serial (VM baseline)
# ----------------------------------------------------------------------

class SerialBackend:
    """Per-instance capture + run (VM-style baseline).

    Every instance gets a NEW executable, outside any cache — each
    submission pays its own trace and capture, as each VM boot is a fresh
    environment; the reference defeats jax's compile cache per instance
    the same way (a salted ``jax.jit(...).lower().compile()``)."""

    name = "serial-vm"
    max_in_flight = 1

    def __init__(self, per_task_overhead_s: float = 0.0, device=None):
        self.per_task_overhead_s = per_task_overhead_s
        self.device = resolve_device(device)

    def launch(self, fn: Callable, inputs: Any, n: int,
               per_task_overhead_s: Optional[float] = None) -> tuple:
        overhead = (self.per_task_overhead_s if per_task_overhead_s is None
                    else per_task_overhead_s)
        rec = LaunchRecord(self.name, n)
        rec.fanout = {"sched": n, "node": 1, "core": 1}
        t = Timer()
        t0 = time.perf_counter()
        inputs = as_tensors(inputs)
        cuda = self.device.type == "cuda"
        outs = []
        for i in range(n):
            item = pytree.tree_map(lambda x: x.to(self.device),
                                   _item(inputs, i))
            # the per-task scheduler interaction — a fresh executable and,
            # on the card, its warm-up and capture, plus any modeled submit
            # latency — is exactly the cost the paper's ONE array
            # submission eliminates; it must show up in t_schedule
            ts = time.perf_counter()
            exe = make_executable(fn, (item,), device=self.device)
            out = exe(item)
            if cuda:
                torch.cuda.synchronize(self.device)
            rec.t_schedule += time.perf_counter() - ts
            outs.append(out)
            if i == 0:
                # execution-side time to the first result (its submit cost
                # is under t_schedule), so sched/node/core partition the
                # wall clock exactly
                rec.t_first_result = max(time.perf_counter() - t0
                                         - rec.t_schedule, 1e-9)
            if overhead:
                time.sleep(overhead)
                rec.t_schedule += overhead
        # t_spawn is the execution remainder so `total` (= t_schedule +
        # t_stage + t_spawn) stays the measured wall clock of the loop
        rec.t_spawn = max(t.lap() - rec.t_schedule, rec.t_first_result)
        return outs, rec

    def dispatch(self, fn: Callable, chunk: Any, n: int) -> WaveHandle:
        t0 = time.perf_counter()
        outs, rec = self.launch(fn, chunk, n)
        return WaveHandle.done(outs, rec, t0)


# ----------------------------------------------------------------------
# Array job (capture once, one replay covers the wave)
# ----------------------------------------------------------------------

class ArrayBackend:
    """One array job per wave: one graph of the vmapped function (cached),
    all N lanes in one replay; optional two-level node/core fan-out."""

    name = "llmr-array"
    max_in_flight = 1
    # the policy layer (autoscaling controller) may pick a fan-out per wave
    supports_lane_override = True

    def __init__(self, inner_lanes: Optional[int] = None,
                 cache: Optional[CompileCache] = None,
                 target_first_result_s: Optional[float] = None,
                 device=None):
        self.inner_lanes = inner_lanes
        self.cache = cache if cache is not None else default_cache()
        self.device = resolve_device(device)
        # the user-facing interactivity SLO: a wave controller built over
        # this backend adopts it as its t_first ceiling, so ONE knob gates
        # serve-side admission preemption AND launch-side wave sizing
        self.target_first_result_s = target_first_result_s
        self._warned_lane_fallback = False

    # -- general-purpose compile through the shared cache -----------------
    def compile(self, fn: Callable, example_args: tuple,
                extras: tuple = (), bind_argnums: tuple = ()) -> tuple:
        """(executable, source): serve + launch share this entry point."""
        return self.cache.compile(fn, example_args, device=self.device,
                                  bind_argnums=bind_argnums, extras=extras)

    # -- wave planning ----------------------------------------------------
    def _plan(self, n: int, inner_lanes: Optional[int] = None) -> tuple:
        """-> (outer, inner, fell_back): node x core fan-out of a wave.

        ``fell_back`` is True when a requested ``inner_lanes`` does not
        divide the wave and the plan degrades to a flat ``(n, 1)`` vmap —
        the caller records the dropped fan-out config instead of silently
        discarding it."""
        inner = self.inner_lanes if inner_lanes is None else inner_lanes
        if inner and inner > 1:
            if n % inner == 0:
                return n // inner, inner, False
            return n, 1, True
        return n, 1, False

    def _compile_wave(self, fn: Callable, chunk: Any, n: int,
                      inner_lanes: Optional[int] = None,
                      stream=None, slot: int = 0) -> tuple:
        outer, inner, fell_back = self._plan(n, inner_lanes)
        requested = self.inner_lanes if inner_lanes is None else inner_lanes
        if fell_back and not self._warned_lane_fallback:
            warnings.warn(
                f"inner_lanes={requested} does not divide wave size {n}; "
                f"falling back to flat ({n}, 1) fan-out — the node/core "
                f"hierarchy you configured is NOT in effect for such waves",
                RuntimeWarning, stacklevel=3)
            self._warned_lane_fallback = True
        if inner > 1:
            mapped = torch.func.vmap(torch.func.vmap(fn))
            chunk = pytree.tree_map(
                lambda x: x.reshape((outer, inner) + tuple(x.shape[1:])),
                chunk)
        else:
            mapped = torch.func.vmap(fn)
        exe, source = self.cache.compile(
            mapped, (chunk,), key_fn=fn, device=self.device, stream=stream,
            extras=("wave", outer, inner, "slot", slot))
        return exe, source, chunk, (outer, inner, fell_back, requested)

    def _stage(self, chunk: Any) -> tuple:
        """(the wave's input as tensors, what must stay alive until its
        copy to the card lands): host inputs bound for the card go through
        pinned memory so the copy into the graph's buffers is async."""
        chunk = as_tensors(chunk)
        if self.device.type != "cuda":
            return chunk, None
        chunk = pytree.tree_map(
            lambda x: x.pin_memory() if isinstance(x, torch.Tensor)
            and x.device.type == "cpu" else x, chunk)
        return chunk, chunk

    # -- LaunchBackend ----------------------------------------------------
    def _dispatch_on(self, fn, chunk, n, inner_lanes, stream, slot):
        rec = LaunchRecord(self.name, n)
        t = Timer()
        staged, keep = self._stage(chunk)
        exe, source, staged, plan = self._compile_wave(
            fn, staged, n, inner_lanes, stream=stream, slot=slot)
        outer, inner, fell_back, requested = plan
        rec.t_schedule = t.lap()      # the ONE scheduler interaction
        rec.extra["compile_source"] = source
        rec.extra["compile_cached"] = source != "compiled"
        if fell_back:
            rec.extra["inner_lanes_fallback"] = {
                "requested": requested, "wave": n, "used": (outer, inner)}
        rec.fanout = {"sched": 1, "node": outer, "core": inner}
        t0 = time.perf_counter()
        event = None
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            s = stream if stream is not None else cur
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                # copied out on the wave's stream, before anything can
                # replay this graph again
                out = _copy_out(exe(staged))
                event = torch.cuda.Event()
                event.record(s)
        else:
            out = exe(staged)
        if inner > 1:                 # un-nest node/core axes
            out = pytree.tree_map(
                lambda x: x.reshape((n,) + tuple(x.shape[2:])), out)
        rec.t_dispatch = time.perf_counter() - t0
        return WaveHandle(out, rec, t0, event=event, keep=keep)

    def dispatch(self, fn: Callable, chunk: Any, n: int,
                 inner_lanes: Optional[int] = None) -> WaveHandle:
        """Enqueue one wave; returns as soon as its replay is queued. The
        WaveHandle's outputs are ready when its event is. ``inner_lanes``
        overrides the backend default for THIS wave (the autoscaling
        controller re-plans the node/core fan-out per wave)."""
        return self._dispatch_on(fn, chunk, n, inner_lanes, None, 0)

    def launch(self, fn: Callable, inputs: Any, n: int) -> tuple:
        return self.dispatch(fn, inputs, n).result()


# ----------------------------------------------------------------------
# Pipelined (waves in flight on their own streams)
# ----------------------------------------------------------------------

class PipelinedBackend(ArrayBackend):
    """ArrayBackend + overlap: advertises ``depth`` waves in flight, so the
    policy driver slices, stages and enqueues wave k+1 while wave k still
    runs, and harvests by readiness polling instead of a per-wave barrier.

    Wave k runs in slot ``k % depth``: the slot's own CUDA stream and its
    own graph (captured on that stream, with its own memory pool and static
    inputs), so two waves in flight never replay one graph at once, never
    share a graph's memory, and a slot's static inputs are only rewritten
    after its previous replay (stream order). On the CPU waves complete
    synchronously."""

    name = "llmr-pipelined"

    def __init__(self, inner_lanes: Optional[int] = None,
                 cache: Optional[CompileCache] = None,
                 depth: int = 2,
                 target_first_result_s: Optional[float] = None,
                 device=None):
        super().__init__(inner_lanes=inner_lanes, cache=cache,
                         target_first_result_s=target_first_result_s,
                         device=device)
        self.max_in_flight = max(1, depth)
        self._streams = ([torch.cuda.Stream(self.device)
                          for _ in range(self.max_in_flight)]
                         if self.device.type == "cuda" else None)
        self._next = 0

    def dispatch(self, fn: Callable, chunk: Any, n: int,
                 inner_lanes: Optional[int] = None) -> WaveHandle:
        slot = self._next
        self._next = (self._next + 1) % self.max_in_flight
        stream = self._streams[slot] if self._streams else None
        return self._dispatch_on(fn, chunk, n, inner_lanes, stream, slot)


# ----------------------------------------------------------------------
# Factory
# ----------------------------------------------------------------------

BACKENDS = {"serial": SerialBackend, "array": ArrayBackend,
            "pipelined": PipelinedBackend, "dist": None}  # dist: lazy


def make_backend(kind: str, cache: Optional[CompileCache] = None,
                 **kwargs) -> LaunchBackend:
    """'serial' | 'array' | 'pipelined' | 'dist' -> a ready LaunchBackend.

    For 'serial', ``cache`` is accepted but meaningless (the per-instance
    VM baseline uses none); any other kwargs (``device=`` among them) are
    passed through, so unsupported options fail loudly instead of being
    dropped. ``inner_lanes="auto"`` defers the node/core fan-out to the
    policy layer's ``WaveController``. 'dist' resolves lazily to the
    distributed fabric (``repro_torch.dist.DistributedBackend``; pass
    ``n_nodes=`` / ``nodes=``, ``node_backend=``, ``transport=``)."""
    if kind == "serial":
        return SerialBackend(**kwargs)
    if kwargs.get("inner_lanes") == "auto":
        kwargs["inner_lanes"] = None     # per-wave override drives fan-out
    if kind == "dist":
        from repro_torch.dist.backend import DistributedBackend
        return DistributedBackend(cache=cache, **kwargs)
    cls = BACKENDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown backend {kind!r}; "
                         f"choose from {sorted(BACKENDS)}")
    return cls(cache=cache, **kwargs)
