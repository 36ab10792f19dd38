"""Weight/environment staging: the paper's Fig-5 'copy time'. Port of
``repro.core.staging``.

Paper: stage the executable + environment from central Lustre to node-local
disk, pull-initiated from every target node in parallel, so copy time stays
nearly flat in N — and OVERLAPPED with execution, so the user never waits
on it. Here: stage parameters/inputs from host memory onto the card.

Two layers:

  * ``Stager`` — the node-side staging buffer (threads): payloads arriving
    ahead of their SUBMIT are materialized (the node-local copy) WHILE the
    worker executes the previous wave, and the stage wall is split into
    hidden (elapsed while the worker computed) vs visible seconds via the
    worker's busy clock. A copy of the reference's.
  * module functions — the standalone Fig-5 measurement, both strategies
    really executed as pinned-host-to-device copies on a side stream:
      point_to_point  -- one full replica pushed per device, sequentially
                         (the naive central push a VM image distribution
                         does)
      parallel_pull   -- every device's copy enqueued at once, each on its
                         own side stream, then one wait
    On one card both are one copy: degenerate, but real.

``bytes_total`` counts bytes DELIVERED to devices (every replica), and the
effective rate is surfaced as ``extra["gb_per_s"]``.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.telemetry import LaunchRecord
from repro_torch.kernels.ops import resolve_device


def tree_bytes(tree: Any) -> int:
    return sum(int(l.numel()) * l.element_size() if isinstance(
        l, torch.Tensor) else l.size * l.dtype.itemsize
        for l in pytree.tree_leaves(tree))


class Stager:
    """Node-side staging buffer with overlap accounting.

    ``stage(task_id, chunk)`` materializes a shard's payload into
    node-local memory (one real copy — the Fig-5 'copy' for this node)
    and parks it for the matching SUBMIT; ``take(task_id)`` hands it to
    the worker. ``busy_clock`` is a callable returning the cumulative
    seconds the node's worker has spent executing: staging seconds that
    elapse while that clock advances are HIDDEN stage wall (overlapped
    with compute), the remainder is visible. ``stage_inline`` is the
    unoverlapped path (payload arrived inside SUBMIT; staging runs on
    the worker's critical path, so nothing is hidden by construction).
    """

    def __init__(self, busy_clock: Optional[Callable[[], float]] = None):
        self._busy_clock = busy_clock
        self._staged: Dict[Any, tuple] = {}
        self._pending: Dict[Any, threading.Event] = {}
        self._errors: Dict[Any, BaseException] = {}
        self._lock = threading.Lock()
        self.stats = {"shards": 0, "bytes": 0,
                      "t_stage": 0.0, "t_hidden": 0.0}

    def _materialize(self, produce: Callable[[], Any],
                     overlapped: bool) -> tuple:
        t0 = time.perf_counter()
        t0_wall = time.time()
        b0 = (self._busy_clock() if overlapped and self._busy_clock
              else None)
        staged = produce()
        dt = time.perf_counter() - t0
        hidden = 0.0
        if b0 is not None:
            hidden = min(max(self._busy_clock() - b0, 0.0), dt)
        nbytes = tree_bytes(staged)
        # wall-clock endpoints (time.time(), comparable across processes)
        # let tracing place this stage interval on the fabric timeline —
        # an overlapped stage visibly runs UNDER the previous shard's exec
        info = {"t_stage": dt, "hidden_s": hidden, "bytes": nbytes,
                "gb_per_s": (nbytes / dt / 1e9) if dt > 0 else 0.0,
                "overlapped": overlapped,
                "t0_wall": t0_wall, "t1_wall": t0_wall + dt}
        self.stats["shards"] += 1
        self.stats["bytes"] += nbytes
        self.stats["t_stage"] += dt
        self.stats["t_hidden"] += hidden
        return staged, info

    @staticmethod
    def _copy_tree(chunk: Any) -> Callable[[], Any]:
        return lambda: pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor)
            else np.array(x, copy=True), chunk)

    def _park(self, task_id: Any, staged: Any, info: dict) -> None:
        with self._lock:
            self._staged[task_id] = (staged, info)
            ev = self._pending.get(task_id)
            if ev is not None:
                ev.set()

    def stage(self, task_id: Any, chunk: Any) -> dict:
        """Stage a shard ahead of its SUBMIT (the overlapped path — the
        caller is the node's receiver thread, not its worker)."""
        staged, info = self._materialize(self._copy_tree(chunk),
                                         overlapped=True)
        self._park(task_id, staged, info)
        return info

    def promise(self, task_id: Any) -> None:
        """Declare a shard whose payload is still assembling (its STAGE
        frame was a chunk manifest): ``take`` for it blocks until
        ``stage_assembled`` or ``fail`` resolves it, instead of reading
        the absence as a protocol bug."""
        with self._lock:
            self._pending.setdefault(task_id, threading.Event())

    def stage_assembled(self, task_id: Any, produce: Callable[[], Any],
                        extra: Optional[dict] = None) -> dict:
        """Resolve a promised shard: ``produce`` builds the staged tree
        (for content-addressed staging, deserializing the reassembled
        chunks IS the node-local copy — no second pass). ``extra`` keys
        (dedup counters) are folded into the stage info."""
        staged, info = self._materialize(produce, overlapped=True)
        if extra:
            info.update(extra)
        self._park(task_id, staged, info)
        return info

    def fail(self, task_id: Any, err: BaseException) -> None:
        """Resolve a promised shard with an error (digest mismatch, chunk
        lost): its ``take`` raises ``err`` loudly — only that shard dies,
        never a silent corrupt stage."""
        with self._lock:
            self._errors[task_id] = err
            ev = self._pending.get(task_id)
            if ev is not None:
                ev.set()

    def take(self, task_id: Any, timeout: Optional[float] = None) -> tuple:
        """-> (chunk, stage_info). The per-channel FIFO guarantees the
        STAGE frame was processed before its SUBMIT was enqueued, so a
        missing, unpromised id is a protocol bug, not a race — raise
        loudly (KeyError). A promised id blocks until assembly resolves;
        the wait is charged to the shard's visible stage wall."""
        with self._lock:
            if task_id in self._errors:
                self._pending.pop(task_id, None)
                raise self._errors.pop(task_id)
            if task_id in self._staged:
                self._pending.pop(task_id, None)
                return self._staged.pop(task_id)
            ev = self._pending.get(task_id)
        if ev is None:
            raise KeyError(task_id)
        t0 = time.perf_counter()
        resolved = ev.wait(timeout)
        waited = time.perf_counter() - t0
        with self._lock:
            self._pending.pop(task_id, None)
            if task_id in self._errors:
                raise self._errors.pop(task_id)
            if not resolved or task_id not in self._staged:
                raise TimeoutError(
                    f"shard {task_id!r}: chunk assembly never completed "
                    f"({waited:.1f}s)")
            staged, info = self._staged.pop(task_id)
        # the worker stood idle for this long: visible stage wall
        info["t_wait_s"] = waited
        info["t_stage"] += waited
        self.stats["t_stage"] += waited
        return staged, info

    def discard(self, task_id: Any) -> None:
        """Forget a shard quietly (its SUBMIT was cancelled)."""
        with self._lock:
            self._staged.pop(task_id, None)
            self._errors.pop(task_id, None)
            ev = self._pending.pop(task_id, None)
            if ev is not None:
                ev.set()

    def stage_inline(self, chunk: Any) -> tuple:
        """Unoverlapped staging on the worker's critical path."""
        return self._materialize(self._copy_tree(chunk), overlapped=False)


def _pinned(host_tree: Any) -> Any:
    return pytree.tree_map(
        lambda x: torch.as_tensor(x).pin_memory()
        if torch.cuda.is_available() else torch.as_tensor(x), host_tree)


def _put(pinned: Any, device: torch.device) -> Any:
    """Enqueue one replica's host-to-device copy on a side stream; returns
    (replica, the stream)."""
    if device.type != "cuda":
        return pytree.tree_map(lambda x: x.clone(), pinned), None
    s = torch.cuda.Stream(device)
    with torch.cuda.stream(s):
        out = pytree.tree_map(
            lambda x: x.to(device, non_blocking=True), pinned)
    return out, s


def _rate(rec: LaunchRecord, placed: Any) -> None:
    rec.extra["bytes_total"] = tree_bytes(placed)
    rec.extra["gb_per_s"] = (rec.extra["bytes_total"] / rec.t_stage / 1e9
                             if rec.t_stage > 0 else 0.0)


def stage_point_to_point(host_tree: Any,
                         devices: Optional[Sequence] = None) -> tuple:
    """Sequentially push a full replica to each device (VM-image style),
    waiting for each before the next."""
    devices = [resolve_device(d) for d in (devices or [None])]
    pinned = _pinned(host_tree)
    rec = LaunchRecord("stage-p2p", len(devices))
    t0 = time.perf_counter()
    replicas = []
    for d in devices:
        out, s = _put(pinned, d)
        if s is not None:
            s.synchronize()
        replicas.append(out)
    rec.t_stage = time.perf_counter() - t0
    _rate(rec, replicas)
    return replicas, rec


def stage_parallel_pull(host_tree: Any, devices: Optional[Sequence] = None,
                        n_instances: Optional[int] = None) -> tuple:
    """Every device's copy enqueued at once, each on its own side stream,
    then one wait: the pull-initiated parallel copy. Returns the first
    device's placement."""
    devices = [resolve_device(d) for d in (devices or [None])]
    pinned = _pinned(host_tree)
    rec = LaunchRecord("stage-pull", n_instances or len(devices))
    t0 = time.perf_counter()
    puts = [_put(pinned, d) for d in devices]
    for _, s in puts:
        if s is not None:
            s.synchronize()
    rec.t_stage = time.perf_counter() - t0
    _rate(rec, [p for p, _ in puts])
    return puts[0][0], rec


def synth_env(mb: float = 4.0, seed: int = 0) -> dict:
    """A synthetic 'application environment' blob (the paper's ~several MB
    Windows executable + libraries + config)."""
    rng = np.random.default_rng(seed)
    n = int(mb * 1e6 / 4)
    return {"exe": rng.standard_normal(n).astype(np.float32)}
