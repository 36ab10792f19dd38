"""FramePump — ONE selector-based event loop for every scheduler-side
node connection.

Before this module the scheduler spent two threads per node (an outbox
sender + a blocking receiver); at 1,000 nodes that is 2,000 threads of
stack and context-switch overhead before a single shard runs.  The pump
collapses the whole scheduler side of the wire onto a single daemon
thread:

* socket channels are switched to non-blocking mode and registered with
  a ``selectors.DefaultSelector``; reads go through the channel's
  incremental ``_parse_one`` reassembly, writes drain per-connection
  send buffers and toggle WRITE interest only while bytes are pending —
  so 1,000 nodes cost 1 thread + O(fds), not 2,000 threads;
* in-process (queue-pair) channels have no file descriptor, so the pump
  bounds its select timeout and drains them with ``recv_nowait`` each
  tick — the ``NodePort`` contract is identical over both carriers;
* sends are submitted as *jobs*: a ``prepare()`` closure runs on the
  pump thread and returns the frames to emit (or ``None`` to skip), so
  skip/cancel decisions happen at send time exactly like the old outbox
  loop, and per-connection frame order is preserved end to end;
* HEARTBEAT frames are coalesced per drain batch — at fleet width a
  scheduler stall can queue hundreds of beats per node, and only the
  latest one carries information (satellite: 500 simultaneous beats
  must renew every lease without starving RESULT frames);
* the loop keeps a busy/wall clock so ``busy_frac()`` reports how close
  the pump thread is to saturation — the fig_fleet benchmark hard-fails
  if the pump saturates before the fleet does.  ``busy_s`` counts CPU
  seconds on the pump thread (``time.thread_time``), not wall time of
  the busy section: when hundreds of worker threads share this
  process's GIL (thread-hosted benchmark fleets), wall time mostly
  measures *their* pressure, and would report a near-idle pump as
  saturated.

Callbacks (``on_frame``, ``on_eof``, ``tick``) run ON the pump thread:
keep them short (registry updates, future resolution, queue pushes) and
never block in them.
"""

from __future__ import annotations

import selectors
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Optional, Tuple

from repro_torch.dist.transport import (HEARTBEAT, ChannelClosed, Frame,
                                  PayloadTooLarge, SocketChannel,
                                  TransportError)
from repro_torch.obs import metrics as _obs
from repro_torch.obs.trace import TRACER

#: fixed buckets for the drain-batch-size histogram (frames per drain)
_BATCH_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

#: how often (pump wall seconds) a busy_frac sample lands in the series
_BUSY_SAMPLE_S = 0.25

#: poll cadence for queue-backed (inproc) channels — no fd to select on,
#: so the pump bounds its sleep while any are registered
QUEUE_POLL_S = 0.002

#: bytes pulled off a readable socket per recv call
RECV_CHUNK = 1 << 18


class _Conn:
    """Per-connection pump state: channel + callbacks + send buffer."""

    __slots__ = ("node_id", "channel", "on_frame", "on_eof", "tick",
                 "tick_interval", "next_tick", "sock", "outbuf",
                 "want_write", "dead")

    def __init__(self, node_id, channel, on_frame, on_eof, tick,
                 tick_interval):
        self.node_id = node_id
        self.channel = channel
        self.on_frame = on_frame
        self.on_eof = on_eof
        self.tick = tick
        self.tick_interval = tick_interval
        self.next_tick = (time.perf_counter() + tick_interval
                          if tick is not None and tick_interval else None)
        # socket-backed channels expose a raw socket for the selector;
        # anything else is drained via recv_nowait each tick
        self.sock = channel._sock if isinstance(channel, SocketChannel) else None
        self.outbuf = bytearray()
        self.want_write = False
        self.dead = False


class FramePump:
    """Single-threaded selector event loop owning all node connections.

    ``register()`` adds a connection; frames the node sends arrive via
    ``on_frame(frame)``, connection death via ``on_eof(err)`` (exactly
    once).  ``send()``/``submit_job()`` enqueue outbound work executed
    on the pump thread in FIFO order per connection.
    """

    def __init__(self, name: str = "frame-pump",
                 queue_poll_s: float = QUEUE_POLL_S):
        self.name = name
        self.queue_poll_s = queue_poll_s
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._conns: dict = {}      # node_id -> _Conn
        self._qconns: dict = {}     # queue-backed subset of _conns
        # ticking subset of _conns — kept separate so the hot loop's
        # timeout/tick scans are O(ticking conns), not O(fleet): only
        # process-host boot probes tick, a 1,000-node thread fleet
        # must not pay a 1,000-entry scan per wakeup
        self._tconns: dict = {}
        self._jobs: deque = deque()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closing = False
        self.stats = {"frames_in": 0, "frames_out": 0, "beats_coalesced": 0,
                      "jobs": 0, "ticks": 0, "callback_errors": 0,
                      "busy_s": 0.0, "wall_s": 0.0}
        # observability: registry instruments, touched only when the
        # global metrics registry is enabled (checked once per loop
        # wakeup into _m_on, so the disabled hot path pays one attribute
        # read). Per-kind counters are created lazily on first use.
        self._m_on = False
        self._m_bytes_in = _obs.counter("pump.bytes_in")
        self._m_bytes_out = _obs.counter("pump.bytes_out")
        self._m_frames_in = _obs.counter("pump.frames_in")
        self._m_frames_out = _obs.counter("pump.frames_out")
        self._m_outbuf_hwm = _obs.gauge("pump.outbuf_hwm")
        self._m_drain_batch = _obs.histogram("pump.drain_batch",
                                             bounds=_BATCH_BOUNDS)
        self._m_kind_in: dict = {}
        self._m_kind_out: dict = {}
        self._next_busy_sample = _BUSY_SAMPLE_S

    # -- registration --------------------------------------------------

    @property
    def alive(self) -> bool:
        return not self._closing

    def register(self, node_id: str, channel, on_frame: Callable,
                 on_eof: Optional[Callable] = None,
                 tick: Optional[Callable] = None,
                 tick_interval: Optional[float] = None) -> None:
        """Own ``channel`` for ``node_id``.  ``on_frame(frame)`` runs on
        the pump thread for every inbound frame; ``on_eof(err)`` fires
        exactly once when the connection dies; ``tick()`` (optional)
        fires every ``tick_interval`` seconds while the connection
        lives."""
        conn = _Conn(node_id, channel, on_frame, on_eof, tick, tick_interval)
        with self._lock:
            if self._closing:
                raise RuntimeError("pump is closed")
            self._conns[node_id] = conn
            if conn.sock is not None:
                conn.sock.setblocking(False)
                # route channel.send into this conn's pump buffer so
                # send() stays the one choke point on every carrier
                channel._sink = conn.outbuf.extend
                self._sel.register(conn.sock, selectors.EVENT_READ, conn)
            else:
                self._qconns[node_id] = conn
            if conn.tick is not None:
                self._tconns[node_id] = conn
            if self._thread is None:
                self._thread = threading.Thread(target=self._run,
                                                name=self.name, daemon=True)
                self._thread.start()
        self._wakeup()

    def unregister(self, node_id: str) -> None:
        """Forget a connection without firing ``on_eof`` (the caller is
        tearing the node down deliberately).  Idempotent; safe from the
        pump thread itself (e.g. inside a LEAVE handler)."""
        with self._lock:
            conn = self._conns.pop(node_id, None)
            self._qconns.pop(node_id, None)
            self._tconns.pop(node_id, None)
        if conn is not None:
            conn.dead = True
            self._drop_fd(conn)
        self._wakeup()

    # -- sending -------------------------------------------------------

    def submit_job(self, node_id: str,
                   prepare: Callable[[], Optional[Iterable[Tuple[str, Any]]]],
                   task=None, on_error: Optional[Callable] = None) -> None:
        """Enqueue outbound work.  ``prepare()`` runs on the pump thread
        and returns an iterable of ``(kind, payload)`` frames to emit —
        or ``None`` to skip (the task was cancelled/superseded between
        enqueue and send, same semantics as the old outbox loop).  Wire
        bytes are charged to ``task.wire_bytes``; ``on_error(exc)``
        receives per-task failures (``PayloadTooLarge``, encode errors)
        that poison the task but not the connection."""
        self._jobs.append((node_id, prepare, task, on_error))
        self._wakeup()

    def send(self, node_id: str, kind: str, payload: Any = None,
             task=None, on_error: Optional[Callable] = None) -> None:
        """One-frame sugar over ``submit_job``."""
        self.submit_job(node_id, lambda: ((kind, payload),),
                        task=task, on_error=on_error)

    # -- stats ---------------------------------------------------------

    def busy_frac(self) -> float:
        """Pump-thread CPU seconds over loop wall seconds.  ~1.0 means
        the pump thread is the bottleneck (a full core spent parsing,
        serializing and flushing frames)."""
        wall = self.stats["wall_s"]
        return (self.stats["busy_s"] / wall) if wall > 0 else 0.0

    def snapshot(self) -> dict:
        out = dict(self.stats)
        out["busy_frac"] = self.busy_frac()
        out["conns"] = len(self._conns)
        return out

    def close(self) -> None:
        self._closing = True
        self._wakeup()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except Exception:
            pass

    # -- event loop ----------------------------------------------------

    def _run(self):
        t_prev = time.perf_counter()
        while not self._closing:
            try:
                events = self._sel.select(self._timeout())
            except OSError:
                if self._closing:
                    break
                events = []
            c0 = time.thread_time()
            for key, mask in events:
                if key.fileobj is self._wake_r:
                    self._drain_wake()
                    continue
                conn = key.data
                if conn is None or conn.dead:
                    continue
                if mask & selectors.EVENT_READ:
                    self._on_readable(conn)
                if (mask & selectors.EVENT_WRITE) and not conn.dead:
                    self._flush(conn)
            if self._jobs:
                self._run_jobs()
            if self._qconns:
                self._poll_queues()
            self._run_ticks()
            t1 = time.perf_counter()
            self.stats["busy_s"] += time.thread_time() - c0
            self.stats["wall_s"] += t1 - t_prev
            t_prev = t1
            self._m_on = _obs.REGISTRY.enabled
            if self._m_on and self.stats["wall_s"] >= self._next_busy_sample:
                self._next_busy_sample = self.stats["wall_s"] + _BUSY_SAMPLE_S
                _obs.REGISTRY.series_append(f"{self.name}.busy_frac",
                                            self.stats["wall_s"],
                                            self.busy_frac())

    def _timeout(self):
        t = None
        if self._jobs:
            return 0.0
        if self._qconns:
            t = self.queue_poll_s
        if self._tconns:
            now = time.perf_counter()
            for conn in list(self._tconns.values()):
                dt = max(0.0, conn.next_tick - now)
                t = dt if t is None else min(t, dt)
        return t

    def _wakeup(self):
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass

    def _drain_wake(self):
        try:
            while self._wake_r.recv(4096):
                pass
        except OSError:
            pass

    # -- reads ---------------------------------------------------------

    def _on_readable(self, conn):
        ch = conn.channel
        try:
            data = conn.sock.recv(RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self._condemn(conn, ChannelClosed(f"connection dropped: {e!r}"))
            return
        if not data:
            ch.closed = True
            self._condemn(conn, ChannelClosed("peer closed the connection"))
            return
        if self._m_on:
            self._m_bytes_in.inc(len(data))
        ch._buf += data
        self._drain_channel(conn)

    def _drain_channel(self, conn):
        """Parse every complete frame buffered on ``conn`` and deliver.

        HEARTBEATs are coalesced: within one drain batch only the latest
        beat is delivered (a beat carries no ordering semantics — only
        freshness), so a node that queued 500 beats during a stall costs
        one lease renewal, and RESULT frames behind the flood are never
        starved."""
        last_beat = None
        frames = []
        err = None
        while not conn.dead:
            try:
                frame = self._next_frame(conn)
            except TransportError as e:       # incl. ProtocolError poisoning
                err = e
                break
            if frame is None:
                break
            if frame.kind == HEARTBEAT:
                if last_beat is not None:
                    self.stats["beats_coalesced"] += 1
                last_beat = frame             # latest beat wins per tick
                continue
            frames.append(frame)
        if self._m_on:
            batch = len(frames) + (1 if last_beat is not None else 0)
            if batch:
                self._m_drain_batch.observe(batch)
        if last_beat is not None:
            self._deliver(conn, last_beat)
        for f in frames:
            if conn.dead:
                break
            self._deliver(conn, f)
        if err is not None:
            self._condemn(conn, err)

    def _next_frame(self, conn) -> Optional[Frame]:
        if conn.sock is not None:
            return conn.channel._parse_one()
        return conn.channel.recv_nowait()

    def _kind_counter(self, cache: dict, direction: str, kind: str):
        c = cache.get(kind)
        if c is None:
            c = cache[kind] = _obs.counter(f"pump.frames_{direction}.{kind}")
        return c

    def _deliver(self, conn, frame):
        self.stats["frames_in"] += 1
        if self._m_on:
            self._m_frames_in.inc()
            self._kind_counter(self._m_kind_in, "in", frame.kind).inc()
        try:
            conn.on_frame(frame)
        except Exception:
            # a broken handler must not take down the shared pump
            self.stats["callback_errors"] += 1

    def _poll_queues(self):
        for conn in list(self._qconns.values()):
            if not conn.dead:
                self._drain_channel(conn)

    # -- writes --------------------------------------------------------

    def _run_jobs(self):
        for _ in range(len(self._jobs)):
            try:
                node_id, prepare, task, on_error = self._jobs.popleft()
            except IndexError:
                break
            conn = self._conns.get(node_id)
            if conn is None or conn.dead:
                # connection already torn down: the task (if any) is
                # resolved by the death path, same as the old send loop
                continue
            self.stats["jobs"] += 1
            # the per-shard "pump send" span: serialization + buffering
            # of this job's frames, parented to the shard span whose
            # context the submitter stashed on the task. The pump thread
            # is every wave's critical path, so it only takes the two
            # clock readings and defers the span-dict build to read time.
            ctx = pc0 = t0_wall = None
            if TRACER.enabled and task is not None:
                ctx = getattr(task, "obs_ctx", None)
                if ctx is not None:
                    t0_wall = time.time()
                    pc0 = time.perf_counter()
            try:
                frames = prepare()
                sent_bytes = 0
                if frames is not None:
                    for kind, payload in frames:
                        n = self._push(conn, kind, payload)
                        if task is not None:
                            task.wire_bytes += n
                        self.stats["frames_out"] += 1
                        sent_bytes += n
                        if self._m_on:
                            self._m_frames_out.inc()
                            self._m_bytes_out.inc(n)
                            self._kind_counter(self._m_kind_out, "out",
                                               kind).inc()
                if pc0 is not None:
                    TRACER.defer("pump.send", ctx, t0_wall,
                                 time.perf_counter() - pc0, "pump",
                                 {"node": node_id, "bytes": sent_bytes,
                                  "skipped": frames is None})
                    pc0 = None
            except PayloadTooLarge as e:
                self._job_error(on_error, e)
            except (ChannelClosed, OSError) as e:
                err = e if isinstance(e, TransportError) else \
                    ChannelClosed(f"send failed: {e!r}")
                self._condemn(conn, err)
            except Exception as e:
                self._job_error(on_error, e)
            if pc0 is not None:           # job died mid-send
                TRACER.defer("pump.send", ctx, t0_wall,
                             time.perf_counter() - pc0, "pump",
                             {"node": node_id, "error": True})
            if conn.outbuf and not conn.dead:
                if self._m_on:
                    self._m_outbuf_hwm.max(len(conn.outbuf))
                self._flush(conn)

    def _job_error(self, on_error, e):
        if on_error is None:
            self.stats["callback_errors"] += 1
            return
        try:
            on_error(e)
        except Exception:
            self.stats["callback_errors"] += 1

    def _push(self, conn, kind, payload) -> int:
        # queue channels put directly; socket channels serialize into
        # conn.outbuf via the _sink installed at register() — either
        # way, channel.send stays the monkeypatchable choke point
        return conn.channel.send(kind, payload)

    def _flush(self, conn):
        try:
            while conn.outbuf:
                n = conn.sock.send(conn.outbuf)
                if n <= 0:
                    break
                del conn.outbuf[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as e:
            self._condemn(conn, ChannelClosed(f"peer gone mid-send: {e!r}"))
            return
        self._set_write_interest(conn, bool(conn.outbuf))

    def _set_write_interest(self, conn, want: bool):
        if want == conn.want_write or conn.sock is None:
            return
        conn.want_write = want
        mask = selectors.EVENT_READ | (selectors.EVENT_WRITE if want else 0)
        try:
            self._sel.modify(conn.sock, mask, conn)
        except (KeyError, ValueError):
            pass

    # -- ticks & death -------------------------------------------------

    def _run_ticks(self):
        if not self._tconns:
            return
        now = time.perf_counter()
        for conn in list(self._tconns.values()):
            if conn.dead or now < conn.next_tick:
                continue
            conn.next_tick = now + conn.tick_interval
            self.stats["ticks"] += 1
            try:
                conn.tick()
            except Exception:
                self.stats["callback_errors"] += 1

    def _condemn(self, conn, err):
        """Connection is dead: unregister, close, fire on_eof once."""
        if conn.dead:
            return
        conn.dead = True
        with self._lock:
            if self._conns.get(conn.node_id) is conn:
                del self._conns[conn.node_id]
            self._qconns.pop(conn.node_id, None)
            self._tconns.pop(conn.node_id, None)
        self._drop_fd(conn)
        try:
            conn.channel.close()
        except Exception:
            pass
        if conn.on_eof is not None:
            try:
                conn.on_eof(err)
            except Exception:
                self.stats["callback_errors"] += 1

    def _drop_fd(self, conn):
        if conn.sock is None:
            return
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
