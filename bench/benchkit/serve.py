"""The open loop around the program's ``PagedServeEngine``.

The engine's own ``run`` blocks until its batch finishes, and the engine
has no public entry for one iteration. So this loop makes the calls
``_EngineBase.run`` makes, in its order: admit from the scheduler, then,
while a slot is busy, grow pages (``_pre_step``) and step. Each request is
enqueued when it falls due, stamped with its due time (so a stall shows in
the wait of every request behind it), and the loop keeps its own record of
every admission that dispatched a prefill and of every decode step: their
host-clock walls, the real prompt lengths of a dispatch, and each live
slot's context length at a step. The per-layer metrics and the kernels'
bounds are worked out from these records; the padded (B, S) a dispatch
ran at is the program's to report (its ``serve.prefill`` span).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from benchkit.traffic import Req


@dataclass
class Dispatch:
    t0: float
    t1: float
    lengths: List[int]
    traced: bool = False


@dataclass
class Step:
    t0: float
    t1: float
    keys: List[int]          # each live slot's context rows after the step
    traced: bool = False


@dataclass
class Record:
    dispatches: List[Dispatch] = field(default_factory=list)
    steps: List[Step] = field(default_factory=list)
    requests: List[Req] = field(default_factory=list)
    t_loop0: float = 0.0


def engine_for(model_cfg, params, mix: dict, device, cache_dir: str):
    """The program's paged engine over the mix's geometry, its executables
    through a compile cache whose records live in ``cache_dir``."""
    from repro_torch.core.backend import ArrayBackend
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.serve.engine import PagedServeEngine
    from repro_torch.serve.scheduler import AdmissionScheduler
    e = mix["engine"]
    backend = ArrayBackend(device=device,
                           cache=CompileCache(cache_dir=cache_dir))
    return PagedServeEngine(model_cfg, params, slots=e["slots"],
                            page_size=e["page_size"],
                            pages_per_slot=e["pages_per_slot"],
                            scheduler=AdmissionScheduler(),
                            device=device, backend=backend)


def warm(eng, prompt_lengths: List[int]) -> List[tuple]:
    """Make each executable the traffic will use — the decode step, and
    the prefill of (slots, S) for every padded length S the prompts can
    take — and run once each one that the engine did not already run at
    construction (a shape of its compile cache's disk records is captured
    there), with inputs that change no state (blank tables, live all
    False, lengths 0, slot ids out of range: every write lands in the
    pool's sink page). Returns the (B, S) shapes."""
    shapes = sorted({(eng.slots, eng._bucket(n)) for n in prompt_lengths})
    ran = eng.stats["compile_sources"]
    fresh = lambda name: not (ran.get(name) == "disk"
                              and eng.stats["captured_ahead"])
    blank = np.full((eng.slots, eng.pool.pages_per_slot), -1)
    if fresh("step"):
        eng._step(eng.params, eng.kv, eng._ints(blank), eng.tokens, eng.pos,
                  torch.zeros_like(eng._live))
    for B, S in shapes:
        exe = eng._prefill_exec(B, S)
        if fresh(f"prefill_b{B}_s{S}"):
            exe(eng.params, eng.kv, eng._ints(blank[:B]),
                eng._ints(np.zeros((B, S))), eng._ints(np.zeros((B,))),
                eng._ints(np.full((B,), eng.slots)))
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return shapes


class OpenLoop:
    """Offers ``reqs`` at their due times and drives ``eng``."""

    def __init__(self, eng, reqs: List[Req]):
        from repro_torch.serve.engine import Request
        self.eng, self.reqs = eng, reqs
        self._Request = Request
        self.rec = Record(requests=reqs)
        self._next = 0                   # next request to enqueue
        self._waiting: List[Req] = []    # enqueued, not yet placed
        self._tracing = False
        self.trace_ns = None

    def tokens(self) -> int:
        """Output tokens the engine has produced: first tokens (one an
        admission) and decoded tokens."""
        s = self.eng.stats
        return s["admitted"] + s["decoded"]

    def _enqueue_due(self, now: float) -> None:
        while (self._next < len(self.reqs)
               and self.rec.t_loop0 + self.reqs[self._next].due <= now):
            r = self.reqs[self._next]
            r.t_due = self.rec.t_loop0 + r.due
            r.engine_req = self._Request(rid=r.rid, prompt=r.prompt,
                                         max_new=r.max_new)
            self.eng.scheduler.enqueue(r.engine_req, now=r.t_due)
            self._waiting.append(r)
            self._next += 1

    def _iteration(self, now: float) -> None:
        eng = self.eng
        busy = any(a is not None for a in eng.active)
        if not busy and not eng.scheduler.has_pending():
            nxt = (self.rec.t_loop0 + self.reqs[self._next].due
                   if self._next < len(self.reqs) else now + 0.01)
            time.sleep(max(0.0, min(nxt, self._until) - now))
            return
        n_disp = eng.stats["prefill_dispatches"]
        t0 = time.perf_counter()
        with _span("bench.admit"):
            admitted = eng._admit()
        t1 = time.perf_counter()
        placed = [r for r in self._waiting if r.engine_req.out
                  or r.engine_req.done]
        if placed:
            gone = {id(r) for r in placed}
            self._waiting = [r for r in self._waiting if id(r) not in gone]
            for r in placed:
                if r.engine_req.out:
                    r.t_placed = t0
        if eng.stats["prefill_dispatches"] > n_disp:
            lengths = [len(r.prompt) for r in placed if r.engine_req.out]
            self.rec.dispatches.append(Dispatch(
                t0, t1, lengths, self._tracing))
        if any(a is not None for a in eng.active):
            t2 = time.perf_counter()
            with _span("bench.step"):
                eng._pre_step()
                # each slot that advances: its rows once this step's row
                # is written
                keys = [len(a.prompt) + len(a.out)
                        for i, a in enumerate(eng.active)
                        if a is not None and i not in eng._stalled]
                eng.step()
            t3 = time.perf_counter()
            self.rec.steps.append(Step(t2, t3, keys, self._tracing))
        elif not admitted and eng.scheduler.has_pending():
            # an idle engine that cannot place the head request fails it,
            # as the engine's own run does
            req = eng.scheduler.pop_next()
            req.done, req.finish_reason = True, "pool_exhausted"
            req.t_done = time.perf_counter()
            eng.stats["pool_exhausted"] += 1

    def run_until(self, t_end: float, profiler=None,
                  trace_from: Optional[float] = None,
                  trace_to: Optional[float] = None) -> float:
        """Iterate until an iteration ends at or past ``t_end``; returns
        the time it ended. With a profiler, the iterations that start in
        [trace_from, trace_to) run under it (started and stopped between
        iterations, the device synchronized at both ends)."""
        self._until = t_end
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return now
            if profiler is not None:
                # start at the first iteration from ``trace_from`` on and
                # stop at the first from ``trace_to`` on: at least one
                # whole iteration runs under the profiler
                if not self._tracing and now >= trace_from:
                    self._sync()
                    profiler.start()
                    self.trace_ns = [time.time_ns(), None]
                    self._tracing = True
                elif self._tracing and now >= trace_to:
                    self.stop_trace(profiler)
                    profiler = None
            self._enqueue_due(now)
            self._iteration(now)

    def _sync(self) -> None:
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize(self.eng.device)

    def stop_trace(self, profiler) -> None:
        self._sync()
        self.trace_ns[1] = time.time_ns()
        profiler.stop()
        self._tracing = False

    def start(self) -> None:
        self.rec.t_loop0 = time.perf_counter()


def _span(name: str):
    return torch.profiler.record_function(name)
