"""Checkpoint/restart fault tolerance, and pluggable failure detection.
Port of ``repro.runtime.fault``.

``resilient_train`` wraps any step function in a restart loop: periodic
(optionally async) checkpoints, and on a worker failure the loop restores
the last COMMITTED checkpoint and replays the deterministic data stream
from that step. Because the data pipeline is keyed by (seed, step),
recovery is bit-exact with respect to an uninterrupted run.

Failure DETECTION is pluggable: anything with ``check(step)`` that raises
``WorkerFailure`` is a detector. Two implementations ship here:

  ``HookDetector``       the seed-era injection hook (tests inject a loss
                         at a chosen step) wrapped as a detector;
  ``HeartbeatDetector``  lease-style liveness: workers ``beat()``, the
                         detector raises once any tracked worker's last
                         beat is older than ``timeout_s``. This is the SAME
                         detector the reference's distributed launch
                         fabric builds its alive/suspect/dead health
                         states on — one staleness clock for training
                         restarts and launch re-dispatch.

``check()`` reports a dead worker exactly once (the stale entry is
dropped as it is reported): after a restart replaces the worker, a fresh
``beat()`` re-registers it.

The train state is updated in place (``train.step``): before a checkpoint
the loop synchronizes the device (the reference's ``block_until_ready``),
``ckpt.save`` copies the state to the host before it returns, and a
restore copies the checkpoint back INTO the state's tensors, so a step
captured as a CUDA graph over them keeps replaying after a restart.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, \
    runtime_checkable

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.train.optimizer import leaves_with_path


class WorkerFailure(RuntimeError):
    """Raised by a failure detector (injection hook or heartbeat expiry)."""


@runtime_checkable
class FailureDetector(Protocol):
    """What the restart loop needs from a detector."""

    def check(self, step: Optional[int] = None) -> None: ...


class HookDetector:
    """Failure-injection hook as a detector: ``hook(step)`` may raise
    ``WorkerFailure`` to simulate a node loss at a chosen step."""

    def __init__(self, hook: Callable[[int], None]):
        self.hook = hook

    def check(self, step: Optional[int] = None) -> None:
        self.hook(step if step is not None else 0)


class HeartbeatDetector:
    """Heartbeat-timeout failure detection (cluster-side liveness).

    Workers (or the node agents of a launch fabric) call ``beat(worker)``
    periodically; any tracked worker whose last beat is older than
    ``timeout_s`` is stale. ``check()`` raises ``WorkerFailure`` naming
    the stale workers and forgets them (exactly-once reporting — a
    replacement worker re-registers itself with its first beat).

    Thread-safe: beats arrive from per-worker threads while the training loop
    reads staleness. ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.last_seen: Dict[Any, float] = {}
        self._lock = threading.Lock()

    def beat(self, worker: Any, now: Optional[float] = None) -> None:
        with self._lock:
            self.last_seen[worker] = self.clock() if now is None else now

    def forget(self, worker: Any) -> None:
        with self._lock:
            self.last_seen.pop(worker, None)

    def age(self, worker: Any, now: Optional[float] = None) -> float:
        """Seconds since the worker's last beat; +inf if never seen."""
        now = self.clock() if now is None else now
        with self._lock:
            seen = self.last_seen.get(worker)
        return float("inf") if seen is None else now - seen

    def stale(self, now: Optional[float] = None) -> List[Any]:
        now = self.clock() if now is None else now
        with self._lock:
            return [w for w, t in self.last_seen.items()
                    if now - t > self.timeout_s]

    def check(self, step: Optional[int] = None) -> None:
        dead = self.stale()
        if dead:
            for w in dead:
                self.forget(w)
            raise WorkerFailure(
                f"heartbeat timeout ({self.timeout_s}s) for worker(s) "
                f"{sorted(map(str, dead))}"
                + (f" at step {step}" if step is not None else ""))


@dataclass
class FaultConfig:
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 25
    async_save: bool = True
    max_restarts: int = 10


@dataclass
class RunReport:
    steps_run: int = 0
    restarts: int = 0
    restore_steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)


def resilient_train(step_fn: Callable, state: Any, batch_fn: Callable,
                    n_steps: int, cfg: FaultConfig,
                    failure_hook: Optional[Callable[[int], None]] = None,
                    detector: Optional[FailureDetector] = None,
                    start_step: int = 0) -> tuple:
    """Run ``n_steps`` of ``step_fn`` with checkpoint/restart.

    batch_fn(step) -> batch  (deterministic; replayable after restore).
    ``failure_hook(step)`` (the seed-era injection hook, kept as one
    detector implementation) and/or ``detector.check(step)`` may raise
    ``WorkerFailure`` to trigger a restore — pass a ``HeartbeatDetector``
    fed by real workers for cluster-side detection.
    Returns (state, RunReport).
    """
    detectors: List[FailureDetector] = []
    if failure_hook is not None:
        detectors.append(HookDetector(failure_hook))
    if detector is not None:
        detectors.append(detector)
    report = RunReport()
    step = start_step
    pending = None
    ckpt.save(cfg.ckpt_dir, step, state, blocking=True)
    while step < n_steps:
        try:
            for d in detectors:
                d.check(step)
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            step += 1
            report.steps_run += 1
            if "loss" in metrics:
                report.losses.append(float(metrics["loss"]))
            if step % cfg.ckpt_every == 0 or step == n_steps:
                if pending is not None:
                    pending.join()
                _block_until_ready(state)
                pending = ckpt.save(cfg.ckpt_dir, step, state,
                                    blocking=not cfg.async_save)
        except WorkerFailure:
            report.restarts += 1
            if report.restarts > cfg.max_restarts:
                raise
            if pending is not None:
                pending.join()
                pending = None
            state, step = ckpt.restore(cfg.ckpt_dir, like=state)
            report.restore_steps.append(step)
    if pending is not None:
        pending.join()
    return state, report


def _block_until_ready(state: Any) -> None:
    """Wait for the device work on ``state``'s tensors (the reference's
    ``jax.block_until_ready``)."""
    for _, leaf in leaves_with_path(state):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.current_stream(leaf.device).synchronize()
            return


def heartbeat_monitor(last_seen: dict, timeout_s: float = 60.0) -> list:
    """Return worker ids whose heartbeat is stale (seed-era helper; the
    class-shaped version of this logic is ``HeartbeatDetector``)."""
    now = time.time()
    return [w for w, t in last_seen.items() if now - t > timeout_s]
