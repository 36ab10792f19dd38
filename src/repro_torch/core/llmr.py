"""LLMapReduce: multi-level map-reduce launch (the paper's contribution C1).
Port of ``repro.core.llmr``.

The paper's pipeline (Fig 2): scan an input set -> generate ONE scheduler
array job covering all tasks -> hierarchical fan-out (scheduler -> node ->
core) -> on completion of all tasks, run a reduce step. The win is that the
per-task scheduler interaction (the dominant cost of serial submission) is
paid ONCE for the whole array.

On the card: the "array job" is one captured CUDA graph whose task axis is
vmapped; levels are (graph replay -> outer vmap axis -> inner vmap lanes).
Tasks too numerous for one replay are split into WAVES.

This class is pure POLICY: wave slicing (fixed-size or autoscaled by the
``WaveController``), in-flight depth, straggler mitigation, and the reduce
step. All mechanism lives behind the ``LaunchBackend`` protocol
(``repro_torch.core.backend``).

The driver is ONE poll/harvest loop for every backend. A synchronous
backend (serial, array) advertises ``max_in_flight == 1`` and behaves
wave-at-a-time; ``PipelinedBackend`` advertises its depth and the driver
keeps that many waves in flight, slicing and enqueueing wave k+1 while
wave k executes, harvesting by non-blocking readiness polls — in ANY
completion order, so no wave ever waits on a wave it does not depend on.

Straggler mitigation is barrier-free (LLMapReduce re-dispatches outliers
without pausing the array job, per Byun et al.): when an in-flight wave's
wall clock is an outlier versus the rolling median of completed waves, a
speculative duplicate is enqueued as a SECOND in-flight attempt of the
same wave. First attempt to become ready wins; the loser is abandoned
without blocking and its record is kept (``superseded_by_redispatch``),
so the report still shows both attempts' cost while counting the work
once. Other in-flight waves keep harvesting the whole time — the old
driver's synchronous re-run inside the harvest barrier stalled every
other wave for the full straggler delay.

NODE failure rides the same path: a failure-aware backend (the
distributed fabric, ``repro_torch.dist``) turns a handle's ``failed()``
True once a node's heartbeat lease expires under an in-flight wave. The driver treats that
as an immediate outlier — no threshold, heartbeat expiry IS the signal —
and enqueues the same speculative duplicate (over the surviving nodes),
counted in ``MapReduceReport.node_failures`` and marked
``redispatch_cause="node_failure"``; the dead attempt keeps its record
under ``superseded_by_redispatch`` exactly like a lost straggler race.
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Union

import numpy as np
from torch.utils import _pytree as pytree

from repro_torch.core.autoscale import WaveController, WaveDecision
from repro_torch.core.backend import (LaunchBackend, concat_outputs,
                                      make_backend)
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.telemetry import LaunchRecord, Timer
from repro_torch.launch.mesh import Mesh
from repro_torch.obs import flight as _flight
from repro_torch.obs import metrics as _obs
from repro_torch.obs.trace import TRACER


@dataclass
class MapReduceReport:
    records: List[LaunchRecord] = field(default_factory=list)
    waves: int = 0
    speculative_redispatches: int = 0
    node_failures: int = 0            # waves re-dispatched off dead nodes
    t_reduce: float = 0.0
    t_total: float = 0.0
    autoscale: List[WaveDecision] = field(default_factory=list)
    metrics: dict = field(default_factory=dict)  # registry delta for this call
    health: dict = field(default_factory=dict)   # {node: verdict} at finish

    @property
    def n_instances(self) -> int:
        # a superseded straggler attempt covers the same tasks as its
        # re-dispatch: count the work once, keep both records' cost
        return sum(r.n_instances for r in self.records
                   if not r.extra.get("superseded_by_redispatch"))

    @property
    def n_attempts(self) -> int:
        return sum(r.n_instances for r in self.records)

    @property
    def rate(self) -> float:
        return self.n_instances / self.t_total if self.t_total else float("inf")


class _DelayedHandle:
    """Test-only straggler injection: defers the READINESS of a dispatched
    wave by ``delay`` seconds without blocking the driver — the injected
    analogue of a slow node (a real cluster gets the same signal from wave
    wall clock). Wraps the backend's real ``WaveHandle``."""

    def __init__(self, inner, delay: float):
        self._inner = inner
        self._delay = delay
        self.rec = inner.rec
        self.t0 = inner.t0
        self.can_fail = getattr(inner, "can_fail", False)

    def _elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def poll(self) -> bool:
        if self._elapsed() < self._delay:
            return False
        return self._inner.poll()

    def failed(self) -> bool:
        return getattr(self._inner, "failed", lambda: False)()

    def result(self) -> tuple:
        remaining = self._delay - self._elapsed()
        if remaining > 0:
            time.sleep(remaining)
        return self._inner.result()

    def abandon(self):
        return self._inner.abandon()


def _accepted_kwargs(factory: Callable, **optional) -> dict:
    """The subset of ``optional`` (None values dropped) that ``factory``
    can accept — seed-era controller factories predate ``nodes`` and
    ``target_first_result_s`` and must keep working unchanged."""
    optional = {k: v for k, v in optional.items() if v is not None}
    if not optional:
        return {}
    try:
        params = inspect.signature(factory).parameters.values()
    except (TypeError, ValueError):
        return optional
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params):
        return optional
    names = {p.name for p in params}
    return {k: v for k, v in optional.items() if k in names}


@dataclass
class _Slot:
    """One logical wave in flight; may carry a speculative second attempt."""
    wi: int
    span: tuple                       # (lo, hi) into the input set
    t_start: float
    attempts: list                    # WaveHandle-likes; [orig, dup?]
    t_attempt: list                   # dispatch perf_counter per attempt
    lanes: Optional[int] = None       # inner_lanes the wave ran with


class LLMapReduce:
    """``out = reduce(map(fn, inputs))`` with array-job launch semantics."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 wave_size: Optional[Union[int, str]] = None,
                 straggler_factor: float = 3.0,
                 min_straggler_s: float = 0.25,
                 scheduler: str = "array",
                 backend: Optional[LaunchBackend] = None,
                 cache: Optional[CompileCache] = None,
                 inner_lanes: Optional[Union[int, str]] = None,
                 controller: Optional[Callable[..., WaveController]] = None,
                 target_first_result_s: Optional[float] = None,
                 device=None):
        """``wave_size`` is an int (fixed waves), ``None`` (one wave), or
        ``"auto"`` — a fresh ``WaveController`` per ``map_reduce`` call
        sizes every wave (and its ``inner_lanes`` fan-out) from measured
        telemetry. ``controller`` overrides the controller factory
        (signature ``controller(n_tasks=..., devices=...)``; keyword
        arguments the factory does not accept — ``nodes``,
        ``target_first_result_s`` — are not forced on it).

        ``straggler_factor`` and ``min_straggler_s`` gate speculative
        re-dispatch: an in-flight wave is an outlier once its wall clock
        exceeds ``max(straggler_factor * median, min_straggler_s)``.

        ``target_first_result_s`` is the interactivity SLO handed to the
        wave controller; left ``None``, it is inherited from the backend
        (``backend.target_first_result_s``), which is how the serving
        CLI's one SLO knob reaches wave sizing end-to-end.

        ``device`` is where a backend built here runs: the card unless
        ``"cpu"`` is passed (a given ``backend`` brings its own); ``mesh``
        (a ``launch.mesh.Mesh``) is handed to a backend built here, which
        splits waves across its ``data`` axis and runs on its first device
        where no ``device`` is passed, and the wave controller sizes waves
        for its positions."""
        self.mesh = mesh
        self.wave_size = wave_size
        self.straggler_factor = straggler_factor
        self.min_straggler_s = min_straggler_s
        self.controller_factory = controller
        if backend is None:
            kwargs = {"device": device} if scheduler == "serial" else {
                "cache": cache, "inner_lanes": inner_lanes,
                "device": device}
            backend = make_backend(scheduler, mesh=mesh, **kwargs)
        self.backend = backend
        self.target_first_result_s = (
            target_first_result_s if target_first_result_s is not None
            else getattr(backend, "target_first_result_s", None))
        self.sched = backend                 # seed-era alias
        self.scheduler_kind = getattr(backend, "name", scheduler)

    # ------------------------------------------------------------------
    def map_reduce(self, map_fn: Callable, inputs: Any,
                   reduce_fn: Optional[Callable] = None,
                   wave_delay_hook: Optional[Callable[[int], float]] = None,
                   n_tasks: Optional[int] = None) -> tuple:
        """inputs: pytree with leading task axis N, OR a wave loader
        ``inputs(lo, hi) -> chunk`` (the paper's input-set scan: per-wave
        host-side materialization/staging; requires ``n_tasks``). With a
        pipelined backend, wave k+1's loader call overlaps wave k's device
        execution. Returns (out, report).

        wave_delay_hook(wave_idx) -> extra seconds of injected wave
        latency (test-only straggler injection, applied to the wave's
        readiness, not the driver). Loaders must be pure: a straggler's
        chunk is re-materialized for the speculative duplicate.
        """
        if callable(inputs):
            if n_tasks is None:
                raise ValueError("a wave-loader `inputs` needs n_tasks")
            n = n_tasks
            load = inputs
        else:
            n = pytree.tree_leaves(inputs)[0].shape[0]

            def load(lo, hi):
                return pytree.tree_map(lambda x: x[lo:hi], inputs)

        controller: Optional[WaveController] = None
        if self.wave_size == "auto":
            factory = self.controller_factory or WaveController
            controller = factory(
                n_tasks=n,
                devices=self.mesh.size if self.mesh is not None else 1,
                **_accepted_kwargs(
                    factory,
                    nodes=int(getattr(self.backend, "n_nodes", 1) or 1),
                    target_first_result_s=self.target_first_result_s))
        wave = n if controller else (self.wave_size or n)
        depth = max(1, getattr(self.backend, "max_in_flight", 1))
        lanes_ok = getattr(self.backend, "supports_lane_override", False)
        report = MapReduceReport()
        t_all = Timer()
        wave_times: List[float] = []
        outs: dict = {}
        slots: List[_Slot] = []
        state = {"lo": 0, "wi": 0}
        m_prev = _obs.REGISTRY.snapshot() if _obs.REGISTRY.enabled else None
        # root of this call's span tree; pushed as the thread's current
        # span so backend dispatch spans (and their shard/pump/node
        # descendants) parent to it
        root = TRACER.start("llmr.map_reduce", where="driver",
                            attrs={"n": n, "backend": self.scheduler_kind},
                            push=True)

        # -- the unified poll/harvest loop's moves ----------------------
        def threshold() -> Optional[float]:
            """Outlier bar: None until a median baseline exists."""
            if len(wave_times) < 2:
                return None
            med = float(np.median(wave_times))
            if med <= 0:
                return None
            return max(self.straggler_factor * med, self.min_straggler_s)

        def dispatch_next() -> None:
            lo, wi = state["lo"], state["wi"]
            lanes = None
            if controller is not None:
                decision = controller.next_wave(n - lo)
                w, lanes = decision.wave, decision.inner_lanes
                report.autoscale.append(decision)
            else:
                w = wave
            hi = min(lo + w, n)
            chunk = load(lo, hi)
            lanes = lanes if (lanes and lanes_ok) else None
            kw = {"inner_lanes": lanes} if lanes else {}
            t0 = time.perf_counter()
            handle = self.backend.dispatch(map_fn, chunk, hi - lo, **kw)
            if wave_delay_hook is not None:
                d = wave_delay_hook(wi)
                if d:
                    handle = _DelayedHandle(handle, d)
            handle.rec.extra["wave"] = wi
            if controller is not None:
                handle.rec.extra["autoscale"] = decision.as_extra()
            slots.append(_Slot(wi, (lo, hi), t0, [handle], [t0],
                               lanes=lanes))
            state["lo"], state["wi"] = hi, wi + 1

        def redispatch(slot: _Slot):
            """Re-dispatch a slot's wave with the SAME plan (inner_lanes)
            as the attempt it races — same compiled program, warm cache."""
            lo, hi = slot.span
            kw = {"inner_lanes": slot.lanes} if slot.lanes else {}
            h = self.backend.dispatch(map_fn, load(lo, hi), hi - lo, **kw)
            h.rec.extra["wave"] = slot.wi
            return h

        def speculate(slot: _Slot, cause: Optional[str] = None) -> None:
            """Enqueue a speculative duplicate as a second in-flight
            attempt — no barrier, first-ready-wins (idempotent tasks)."""
            t0 = time.perf_counter()
            dup = redispatch(slot)
            if cause is not None:
                dup.rec.extra["redispatch_cause"] = cause
            slot.attempts.append(dup)
            slot.t_attempt.append(t0)
            report.speculative_redispatches += 1

        def live_attempts(slot: _Slot) -> List[int]:
            """Attempt indices that can still become ready (not stranded
            on a dead node)."""
            return [j for j, h in enumerate(slot.attempts)
                    if not h.failed()]

        def check_failures() -> None:
            """A wave whose every attempt sits on a dead node can never
            complete: feed it straight back through the speculative
            re-dispatch path — no outlier threshold, the heartbeat expiry
            IS the signal. The dead attempts stay in the race only as
            records (they will lose and be kept under
            ``superseded_by_redispatch``)."""
            for slot in slots:
                if not all(h.can_fail for h in slot.attempts):
                    continue
                if live_attempts(slot):
                    continue
                report.node_failures += 1
                _flight.RECORDER.trigger("wave_failure", wave=slot.wi,
                                         span=list(slot.span))
                speculate(slot, cause="node_failure")

        def check_stragglers() -> None:
            thr = threshold()
            if thr is None:
                return
            now = time.perf_counter()
            for slot in slots:
                if len(slot.attempts) == 1 and now - slot.t_start > thr:
                    speculate(slot)

        def harvest(slot: _Slot, winner: int) -> None:
            hs = TRACER.start("harvest", parent=root, where="driver",
                              attrs={"wave": slot.wi})
            out, rec = slot.attempts[winner].result()
            now = time.perf_counter()
            dt = now - slot.t_attempt[winner]
            for j, h in enumerate(slot.attempts):
                if j == winner:
                    continue
                lrec = h.abandon()
                lrec.extra["superseded_by_redispatch"] = True
                lrec.extra["t_wave"] = now - slot.t_attempt[j]
                report.records.append(lrec)
            if winner > 0:
                rec.extra["straggler_redispatch"] = True
            thr = threshold()
            if (depth == 1 and winner == 0 and len(slot.attempts) == 1
                    and thr is not None and dt > thr):
                # post-hoc outlier on a DEPTH-1 backend, whose dispatch
                # blocks and never gets polled in flight: fall back to
                # the synchronous re-run — with the only slot already
                # harvested there is nothing in flight to stall. Pipelined
                # backends never take this path: a wave that merely
                # finished a bit late (e.g. its dt includes a cold compile
                # of a new wave shape) has a perfectly good result, and
                # re-running it would resurrect the harvest barrier.
                rec.extra["superseded_by_redispatch"] = True
                rec.extra["t_wave"] = dt
                report.records.append(rec)
                t0 = time.perf_counter()
                out, rec = redispatch(slot).result()
                dt = time.perf_counter() - t0
                rec.extra["straggler_redispatch"] = True
                report.speculative_redispatches += 1
            wave_times.append(dt)
            if _obs.REGISTRY.enabled:
                _obs.REGISTRY.series_append("llmr.wave_s", time.time(), dt)
            rec.extra["t_wave"] = dt
            report.records.append(rec)
            outs[slot.wi] = out
            slots.remove(slot)
            TRACER.finish(hs, attempts=len(slot.attempts),
                          n=slot.span[1] - slot.span[0])
            if controller is not None:
                controller.observe(rec, dt,
                                   straggler=len(slot.attempts) > 1
                                   or rec.extra.get("straggler_redispatch",
                                                    False),
                                   tasks_left=n - state["lo"])

        def sweep() -> bool:
            """Non-blocking pass: harvest every ready attempt (any wave
            order, first-ready-wins within a slot), then arm speculative
            duplicates for outliers. True if anything was harvested."""
            progressed = False
            for slot in list(slots):
                for j, h in enumerate(slot.attempts):
                    if h.poll():
                        harvest(slot, j)
                        progressed = True
                        break
            check_failures()
            check_stragglers()
            return progressed

        def drain_one() -> None:
            """Make progress when the pipeline is full (or input is
            exhausted): poll-wait until SOME attempt is ready, escalating
            an overdue wave to a speculative duplicate instead of ever
            barriering on it. While a duplicate races its original, BOTH
            keep being polled (first-ready-wins); only once the duplicate
            itself is overdue — or no baseline exists yet — does the
            driver hard-block, so readiness polling that never comes true
            (a poll-less handle) still terminates."""
            # push-aware wait: a distributed backend exposes a
            # wave_event its transport pump sets the instant a shard
            # RESULT lands — waiting on it turns the poll tick into a
            # wakeup; backends without one degrade to the plain sleep
            wake = getattr(self.backend, "wave_event", None)

            def _pause(seconds: float) -> None:
                if wake is not None:
                    wake.wait(timeout=seconds)
                    wake.clear()
                else:
                    time.sleep(seconds)

            tick = 1e-4            # adaptive poll tick: tight while the
            while slots:           # wave is fresh, backing off toward 2ms
                if sweep():
                    return
                oldest = slots[0]
                thr = threshold()
                if thr is None:
                    # no baseline: plain barrier — but NEVER hard-block a
                    # failure-aware wave (its node may die under the
                    # barrier; keep polling so sweep() can detect the
                    # lease expiry and re-dispatch instead)
                    if any(h.can_fail for h in oldest.attempts):
                        _pause(min(tick, 1e-3))
                        tick = min(tick * 2, 2e-3)
                        continue
                    harvest(oldest, 0)
                    return
                now = time.perf_counter()
                # computed ONCE: a lease can expire between two calls,
                # and the harvest index below must match this guard
                live = live_attempts(oldest)
                if not live:
                    pass                     # sweep() is re-dispatching it
                elif len(oldest.attempts) == 1:
                    if now - oldest.t_start > thr:
                        speculate(oldest)    # start the race, keep polling
                elif now - oldest.t_attempt[-1] > thr:
                    # the duplicate is overdue too: polling cannot decide
                    # this slot — settle on the newest attempt that can
                    # still complete
                    harvest(oldest, live[-1])
                    return
                # wait the shorter of a poll tick or the time left until
                # the slot's next escalation point
                _pause(min(tick, 1e-3))
                tick = min(tick * 2, 2e-3)

        # -- drive -------------------------------------------------------
        try:
            while state["lo"] < n or slots:
                while state["lo"] < n and len(slots) < depth:
                    dispatch_next()
                    sweep()  # opportunistic harvest keeps the pipe hot
                if slots and (len(slots) >= depth or state["lo"] >= n):
                    drain_one()
            report.waves = state["wi"]

            result = [outs[i] for i in range(report.waves)]
            if reduce_fn is not None:
                t = Timer()
                flat = _concat_waves(result)
                result = reduce_fn(flat)
                report.t_reduce = t.lap()
            else:
                result = _concat_waves(result)
        finally:
            # finish (and pop) the root even on failure so the thread's
            # current-span stack never leaks into the caller's next call
            TRACER.finish(
                root, waves=state["wi"],
                redispatches=report.speculative_redispatches)
        report.t_total = t_all.lap()
        if m_prev is not None:
            report.metrics = _obs.REGISTRY.delta(m_prev)
        hv = getattr(self.backend, "health_verdicts", None)
        if hv is not None:
            report.health = dict(hv() or {})
        return result, report


_concat_waves = concat_outputs


# ----------------------------------------------------------------------
# The paper's experiment: launch N instances of an application
# ----------------------------------------------------------------------

def launch_instances(app_fn: Callable, n: int, item_shape: tuple = (64,),
                     scheduler: str = "array",
                     wave_size: Optional[Union[int, str]] = None,
                     seed: int = 0,
                     backend: Optional[LaunchBackend] = None,
                     cache: Optional[CompileCache] = None,
                     device=None) -> tuple:
    """Launch ``n`` instances of ``app_fn`` (one input item each); returns
    (outputs, MapReduceReport). This is the measured analogue of the
    paper's 1..16,384 instance sweep. ``wave_size="auto"`` engages the
    measured-telemetry wave controller."""
    rng = np.random.default_rng(seed)
    inputs = rng.standard_normal((n,) + item_shape).astype(np.float32)
    llmr = LLMapReduce(scheduler=scheduler, wave_size=wave_size,
                       backend=backend, cache=cache, device=device)
    outs, report = llmr.map_reduce(app_fn, inputs)
    return outs, report
