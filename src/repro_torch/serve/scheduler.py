"""Continuous-batching admission scheduler with priority classes.

A copy of ``repro.serve.scheduler`` (the port imports nothing of ``repro``).

The companion interactive-HPC papers (Reuther et al.) sustain interactivity
under mixed load the same way every shared facility does: an on-demand
class that preempts a throughput class. This module is that policy for the
serving engine:

  * two strict-priority FIFO classes — ``interactive`` (latency SLO) ahead
    of ``batch`` (throughput filler) — with per-request enqueue stamps so
    TTFT includes queue wait;
  * **bucketed prefill grouping**: ``pop_group`` pops the head-of-line
    request plus every same-length-bucket request behind it (scanning in
    priority order, leaving others queued), which is what lets the engine
    prefill many slots in ONE length-bucketed executable instead of the
    one-slot admit loop;
  * **SLO-gated preemption**: ``should_preempt`` answers "may an
    interactive admission evict batch work right now?" — always, unless a
    ``target_first_result_s`` SLO is set (the SAME knob the launch-side
    ``WaveController`` consumes), in which case batch work is left alone
    until the head interactive request's queue wait approaches the SLO.
    Preempted requests are requeued at the FRONT of their class with their
    original enqueue stamp (their telemetry keeps paying the wait).

The scheduler owns ordering only; slots, pages, and executables belong to
the engine (``repro_torch.serve.engine``).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

PRIORITIES = ("interactive", "batch")

# fraction of the TTFT SLO an interactive request may wait in queue before
# admission starts evicting batch work for it
SLO_PREEMPT_FRAC = 0.5


def bucket_len(n: int, minimum: int = 8) -> int:
    """Next power of two >= max(n, minimum): the padded prompt length of a
    prefill executable. Pow2 buckets keep the executable count logarithmic
    in prompt length, the same ladder the wave autoscaler walks."""
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


class AdmissionScheduler:
    """Strict-priority FIFO queues + bucketed group pop + SLO preemption."""

    def __init__(self, target_first_result_s: Optional[float] = None,
                 preemptible: tuple = ("batch",)):
        self.target_first_result_s = target_first_result_s
        self.preemptible = tuple(preemptible)
        self.queues: Dict[str, Deque] = {p: deque() for p in PRIORITIES}
        self.stats = {"enqueued": 0, "requeued": 0}

    # -- queue ops ---------------------------------------------------------
    def enqueue(self, req, now: Optional[float] = None) -> None:
        if req.priority not in self.queues:
            raise ValueError(f"unknown priority {req.priority!r}; "
                             f"choose from {PRIORITIES}")
        if not req.t_enqueue:
            req.t_enqueue = time.perf_counter() if now is None else now
        self.queues[req.priority].append(req)
        self.stats["enqueued"] += 1

    def requeue_front(self, req) -> None:
        """Put a preempted (or deferred) request back at the head of its
        class, keeping its original enqueue stamp."""
        self.queues[req.priority].appendleft(req)
        self.stats["requeued"] += 1

    def peek_next(self):
        for p in PRIORITIES:
            if self.queues[p]:
                return self.queues[p][0]
        return None

    def pop_next(self):
        for p in PRIORITIES:
            if self.queues[p]:
                return self.queues[p].popleft()
        return None

    def pop_group(self, max_n: int,
                  match: Optional[Callable] = None) -> List:
        """Pop the head-of-line request plus up to ``max_n - 1`` further
        requests for which ``match(req)`` is true, scanning the queues in
        priority order and leaving non-matching requests queued in place.
        ``match`` defaults to same-``bucket_len`` as the head — one padded
        prefill executable covers the whole group."""
        head = self.pop_next()
        if head is None:
            return []
        if match is None:
            b = bucket_len(len(head.prompt))
            match = lambda r: bucket_len(len(r.prompt)) == b  # noqa: E731
        group = [head]
        for p in PRIORITIES:
            if len(group) >= max_n:
                break
            kept = deque()
            q = self.queues[p]
            while q and len(group) < max_n:
                r = q.popleft()
                (group if match(r) else kept).append(r)
            q.extendleft(reversed(kept))
        return group

    # -- queries -----------------------------------------------------------
    def pending(self, priority: Optional[str] = None) -> int:
        if priority is not None:
            return len(self.queues[priority])
        return sum(len(q) for q in self.queues.values())

    def has_pending(self) -> bool:
        return any(self.queues.values())

    def should_preempt(self, now: Optional[float] = None) -> bool:
        """May an interactive admission evict batch work right now?

        Without an SLO: yes whenever interactive work is waiting (strict
        priority). With one: only once the head interactive request's
        queue wait exceeds ``SLO_PREEMPT_FRAC * target_first_result_s`` —
        below that, batch work keeps its slots and pages (the paper's
        facilities run batch as filler precisely because on-demand jobs
        usually fit without eviction)."""
        head = self.queues["interactive"][0] if self.queues["interactive"] \
            else None
        if head is None:
            return False
        if self.target_first_result_s is None:
            return True
        now = time.perf_counter() if now is None else now
        return (now - head.t_enqueue) >= (SLO_PREEMPT_FRAC
                                          * self.target_first_result_s)
