"""Transport: the launch fabric's wire protocol, pluggable per fabric.

The paper's scheduler talks to its nodes over a real interconnect; what
makes LLMapReduce-style launch portable is that the SCHEDULER POLICY
never sees the interconnect — only a small message protocol. This module
is that separation for ``repro_torch.dist``: eight frame kinds

  ``SUBMIT``     scheduler -> node: run one wave shard (tiny — when
                 staging overlap is on, the payload travelled ahead in a
                 STAGE frame and SUBMIT only references it)
  ``RESULT``     node -> scheduler: one shard's output + LaunchRecord
                 (or its error), matched to the SUBMIT by ``task_id``
  ``HEARTBEAT``  node -> scheduler: lease renewal; ALSO the connection
                 handshake — the first thing a node says on a fresh
                 socket is "I'm alive" with its node id
  ``STAGE``      scheduler -> node: a shard's input payload, streamed
                 ahead of its SUBMIT so node-side staging overlaps with
                 the previous wave's execution (Fig 5's copy time hidden
                 under compute). With content-addressed staging on, the
                 payload is a MANIFEST — an ordered list of
                 ``[digest, size, source]`` chunk entries — and the
                 bytes themselves ride CHUNK frames only when the node
                 does not already hold them
  ``CHUNK``      scheduler -> node: one content-addressed chunk
                 (``{"d": digest, "data": bytes}``); nodes verify the
                 digest on receipt — a mismatch fails exactly the shards
                 waiting on it (``ProtocolError``), never a silent
                 corrupt stage
  ``CHUNK_REQ``  node -> scheduler: digests a manifest promised from the
                 node's cache (or a peer) that it cannot produce — the
                 scheduler re-sends them as CHUNK frames, so eviction
                 and dead peers degrade to direct send, never a hang
  ``PEER``       node -> scheduler: the node's chunk-serving endpoint;
                 the scheduler's chunk directory uses it to point other
                 nodes at this one for hot chunks (the fan-out tree)
  ``LEAVE``      either direction: graceful-leave request (scheduler ->
                 node: please drain) or announcement (node -> scheduler:
                 drained, deregister me — never a failure)

over two interchangeable carriers:

  ``InprocTransport``  queue pairs (``queue.Queue`` in one process,
                       ``multiprocessing`` queues across processes) —
                       the CI default, today's queues refactored behind
                       the interface; payloads pass by reference.
  ``SocketTransport``  length-prefixed frames over localhost TCP, one
                       connection per node — agents are genuinely
                       host-spanning-shaped: everything crossing the
                       channel is serialized, a dead peer is a dropped
                       connection, and the scheduler reads EOF as lease
                       expiry (``NodeRegistry.expire``).

Payload codec: msgpack when available and the payload is plain data
(control frames), pickle otherwise (shard functions, numpy trees) — the
codec byte travels in the frame so either end can be msgpack-less.
Frames carry an explicit size cap (``max_frame_bytes``): oversized sends
raise ``PayloadTooLarge`` before touching the wire, and a received
length prefix past the cap poisons the connection (``ProtocolError``)
instead of allocating unbounded memory.
"""
from __future__ import annotations

import hashlib
import hmac
import pickle
import queue
import secrets
import select
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Union

try:  # optional wire codec for control frames; pickle is the fallback
    import msgpack as _msgpack
except ImportError:  # pragma: no cover - container-dependent
    _msgpack = None

SUBMIT = "SUBMIT"
RESULT = "RESULT"
HEARTBEAT = "HEARTBEAT"
STAGE = "STAGE"
CHUNK = "CHUNK"
CHUNK_REQ = "CHUNK_REQ"
PEER = "PEER"
LEAVE = "LEAVE"
_CLOSE = "_CLOSE"                     # inproc-internal EOF sentinel

_KIND_CODE = {SUBMIT: b"S", RESULT: b"R", HEARTBEAT: b"H",
              STAGE: b"G", CHUNK: b"C", CHUNK_REQ: b"Q",
              PEER: b"P", LEAVE: b"L"}
_CODE_KIND = {v: k for k, v in _KIND_CODE.items()}

#: default frame cap — far above any sane wave shard, far below "the
#: driver pickled the whole input set into one frame by accident"
DEFAULT_MAX_FRAME_BYTES = 256 << 20


def _wait_readable(sock: socket.socket, timeout: Optional[float]) -> bool:
    """Block until ``sock`` is readable (or ``timeout`` elapses).

    ``select.select`` silently caps out at FD_SETSIZE (1024): in a
    500+-node fleet every fd past that raises ``ValueError``, which
    reads as a dead connection. ``poll`` has no fd-number limit."""
    if hasattr(select, "poll"):
        p = select.poll()
        p.register(sock.fileno(), select.POLLIN)
        ms = None if timeout is None else max(0, int(timeout * 1000 + 0.999))
        return bool(p.poll(ms))
    readable, _, _ = select.select([sock], [], [], timeout)
    return bool(readable)


class TransportError(RuntimeError):
    """Base class for every fault the transport layer can raise."""


class ChannelClosed(TransportError):
    """The peer is gone (EOF / closed channel): nothing more will arrive
    and nothing more can be sent. The scheduler side reads this as node
    death (lease expiry ≡ dead connection)."""


class PayloadTooLarge(TransportError):
    """A frame exceeded ``max_frame_bytes``; rejected before the wire."""


class ProtocolError(TransportError):
    """The byte stream violated the framing (oversized length prefix,
    unknown frame kind) — the connection is poisoned and closed."""


@dataclass
class Frame:
    """One decoded protocol message."""
    kind: str
    payload: Any = None


# ----------------------------------------------------------------------
# codec
# ----------------------------------------------------------------------

def _encode(payload: Any) -> Tuple[bytes, bytes]:
    """-> (codec_byte, body). Control payloads ride msgpack when it is
    importable; anything msgpack cannot express (functions, arrays,
    records) falls back to pickle — the codec byte tells the peer."""
    if payload is None:
        return b"0", b""
    if _msgpack is not None:
        try:
            return b"M", _msgpack.packb(payload, use_bin_type=True)
        except (TypeError, ValueError, OverflowError):
            pass
    return b"P", pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)


def _decode(codec: bytes, body: bytes) -> Any:
    if codec == b"0":
        return None
    if codec == b"M":
        if _msgpack is None:
            raise ProtocolError("peer sent a msgpack frame but msgpack "
                                "is not importable here")
        return _msgpack.unpackb(body, raw=False)
    if codec == b"P":
        return pickle.loads(body)
    raise ProtocolError(f"unknown payload codec {codec!r}")


def encode_frame(kind: str, payload: Any,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> bytes:
    """Serialize one frame to its wire form (length prefix + kind byte +
    codec byte + body). Shared by the blocking ``SocketChannel.send``
    and the pump's non-blocking buffered writer."""
    codec, body = _encode(payload)
    if len(body) > max_frame_bytes:
        raise PayloadTooLarge(
            f"{kind} payload {len(body)} bytes exceeds the frame cap "
            f"{max_frame_bytes}")
    return struct.pack("!I", len(body) + 2) + _KIND_CODE[kind] + codec + body


def handshake_mac(secret: bytes, nonce: bytes, node_id: str) -> str:
    """The HMAC a connecting node must present: SHA-256 over the server
    nonce + its claimed node id, keyed by the fleet's shared secret."""
    return hmac.new(secret, nonce + node_id.encode("utf-8"),
                    hashlib.sha256).hexdigest()


def _approx_payload_bytes(payload: Any) -> int:
    """Cheap size estimate for by-reference (inproc) sends: array leaves
    dominate any realistic oversize, so count their buffers plus a small
    per-object constant — no serialization pass just to enforce a cap."""
    seen = 0
    stack = [payload]
    while stack:
        x = stack.pop()
        nbytes = getattr(x, "nbytes", None)
        if nbytes is not None:
            seen += int(nbytes)
        elif isinstance(x, (bytes, bytearray, str)):
            seen += len(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
            seen += 64
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
            seen += 64
        else:
            seen += 64
    return seen


# ----------------------------------------------------------------------
# channels
# ----------------------------------------------------------------------

class InprocChannel:
    """One endpoint of a queue-pair channel. Queue objects come from
    ``queue`` (thread nodes) or a ``multiprocessing`` context (process
    nodes) — the protocol on top is identical. Deliberately lock-free
    and picklable (a process node's endpoint crosses the spawn boundary
    inside the ``Process`` args)."""

    def __init__(self, send_q, recv_q,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self._send_q = send_q
        self._recv_q = recv_q
        self.max_frame_bytes = max_frame_bytes
        self.closed = False

    def send(self, kind: str, payload: Any = None) -> int:
        """Enqueue one frame; returns the frame's approximate size in
        bytes (payloads pass by reference, so the estimate is what the
        fabric's bytes-on-wire accounting charges this send)."""
        if self.closed:
            raise ChannelClosed("send on a closed channel")
        size = _approx_payload_bytes(payload)
        if size > self.max_frame_bytes:
            raise PayloadTooLarge(
                f"{kind} payload ~{size} bytes exceeds the frame cap "
                f"{self.max_frame_bytes}")
        self._send_q.put(Frame(kind, payload))
        return size + 8

    def recv(self, timeout: Optional[float] = None) -> Optional[Frame]:
        if self.closed:
            raise ChannelClosed("recv on a closed channel")
        try:
            frame = self._recv_q.get(timeout=timeout)
        except queue.Empty:
            return None
        if frame.kind == _CLOSE:
            self.closed = True
            raise ChannelClosed("peer closed the channel")
        return frame

    def recv_nowait(self) -> Optional[Frame]:
        """Non-blocking recv for the frame pump's queue-poll path: one
        buffered frame, ``None`` if the queue is momentarily empty."""
        if self.closed:
            raise ChannelClosed("recv on a closed channel")
        try:
            frame = self._recv_q.get_nowait()
        except queue.Empty:
            return None
        if frame.kind == _CLOSE:
            self.closed = True
            raise ChannelClosed("peer closed the channel")
        return frame

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self._send_q.put(Frame(_CLOSE))
        except Exception:  # noqa: BLE001 — peer queue may already be gone
            pass


class SocketChannel:
    """Length-prefixed frames over one TCP connection: ``!I`` body length,
    then 1 kind byte + 1 codec byte + payload. Sends are serialized under
    a lock (the agent's outbox and heartbeat threads share the socket);
    recv is single-reader with an incremental reassembly buffer, so a
    timeout mid-frame loses nothing."""

    def __init__(self, sock: socket.socket,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        try:
            # tiny frames (heartbeats, submits) must not sit in Nagle's
            # buffer; best-effort — unix socketpairs have no Nagle at all
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._sock = sock
        self.max_frame_bytes = max_frame_bytes
        self._slock = threading.Lock()
        self._buf = bytearray()
        self.closed = False
        # a FramePump that owns this channel installs a sink here:
        # send() then serializes into the pump's per-connection buffer
        # (non-blocking flush on the pump thread) instead of sendall —
        # keeping send() the single choke point on every carrier
        self._sink: Optional[Callable[[bytes], None]] = None

    def send(self, kind: str, payload: Any = None) -> int:
        """Write one frame; returns the exact bytes put on the wire
        (length prefix + kind + codec + body) for the fabric's
        bytes-on-wire accounting."""
        frame = encode_frame(kind, payload, self.max_frame_bytes)
        if self.closed:
            raise ChannelClosed("send on a closed channel")
        sink = self._sink
        if sink is not None:          # pump-owned: buffered, non-blocking
            sink(frame)
            return len(frame)
        with self._slock:
            if self.closed:
                raise ChannelClosed("send on a closed channel")
            try:
                self._sock.sendall(frame)
            except OSError as e:
                self.closed = True
                raise ChannelClosed(f"peer gone mid-send: {e}") from e
        return len(frame)

    def _parse_one(self) -> Optional[Frame]:
        if len(self._buf) < 4:
            return None
        (length,) = struct.unpack("!I", self._buf[:4])
        if length > self.max_frame_bytes + 64:
            self.close()
            raise ProtocolError(
                f"length prefix {length} past the frame cap "
                f"{self.max_frame_bytes}: connection poisoned")
        if len(self._buf) < 4 + length:
            return None
        body = bytes(self._buf[4:4 + length])
        del self._buf[:4 + length]
        kind = _CODE_KIND.get(body[0:1])
        if kind is None:
            self.close()
            raise ProtocolError(f"unknown frame kind byte {body[0:1]!r}")
        return Frame(kind, _decode(body[1:2], body[2:]))

    def recv(self, timeout: Optional[float] = None) -> Optional[Frame]:
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            frame = self._parse_one()
            if frame is not None:
                return frame
            if self.closed:
                raise ChannelClosed("recv on a closed channel")
            remaining = None
            if deadline is not None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return None
            # wait via poll/select, NOT settimeout: the socket timeout
            # is socket-wide, so a recv-side timeout would also abort a
            # concurrent blocking sendall mid-frame in another thread
            # (poisoning the channel and falsely condemning a healthy
            # node); polling leaves the socket blocking for writers
            try:
                readable = _wait_readable(self._sock, remaining)
            except (OSError, ValueError) as e:   # fd closed under us
                self.closed = True
                raise ChannelClosed(f"connection dropped: {e}") from e
            if not readable:
                return None
            try:
                data = self._sock.recv(1 << 16)
            except OSError as e:
                self.closed = True
                raise ChannelClosed(f"connection dropped: {e}") from e
            if not data:
                self.closed = True
                raise ChannelClosed("peer closed the connection")
            self._buf += data

    def close(self) -> None:
        self.closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# ----------------------------------------------------------------------
# transports
# ----------------------------------------------------------------------

@dataclass
class NodePort:
    """What ``Transport.create(node_id)`` hands the agent: a picklable
    ``endpoint`` spec the worker turns into its channel (via
    ``open_worker_channel``, possibly in another process), and a
    ``driver_channel()`` call that yields the scheduler-side endpoint —
    blocking, for sockets, until the worker has dialled in."""
    endpoint: tuple
    driver_channel: Callable[..., Any]


class _PumpOwner:
    """Mixin: a transport owns ONE FramePump shared by every agent built
    on it — the whole fleet's scheduler side is one event-loop thread."""

    def _init_pump(self):
        self._pump = None
        self._pump_lock = threading.Lock()

    @property
    def pump(self):
        from repro_torch.dist.pump import FramePump  # local: pump imports us
        with self._pump_lock:
            if self._pump is None or not self._pump.alive:
                self._pump = FramePump(name=f"{self.name}-pump")
            return self._pump

    def _close_pump(self):
        with self._pump_lock:
            pump, self._pump = self._pump, None
        if pump is not None:
            pump.close()


class InprocTransport(_PumpOwner):
    """Today's queues, behind the interface: a fresh queue pair per node.
    Pass a ``multiprocessing`` context as ``ctx`` to get queues that
    cross a spawn boundary (process-hosted nodes)."""

    name = "inproc"

    def __init__(self, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self.max_frame_bytes = max_frame_bytes
        self._init_pump()

    def create(self, node_id: str, ctx=None) -> NodePort:
        qf = ctx.Queue if ctx is not None else queue.Queue
        to_node, to_driver = qf(), qf()
        driver = InprocChannel(to_node, to_driver, self.max_frame_bytes)
        worker = InprocChannel(to_driver, to_node, self.max_frame_bytes)
        return NodePort(("inproc", worker),
                        lambda timeout=None: driver)

    def close(self) -> None:
        self._close_pump()


#: bind hosts that listen on every interface — they need a distinct
#: advertise host, since peers cannot dial "0.0.0.0"
_WILDCARD_HOSTS = ("0.0.0.0", "::", "")


class SocketTransport(_PumpOwner):
    """TCP, one connection per node. The scheduler side listens; a
    connecting worker's first frame is a ``HEARTBEAT`` carrying its node
    id — the handshake IS a lease renewal. ``create(node_id)`` may be
    called before or after the worker dials in; ``driver_channel()``
    blocks until the matching connection lands (or times out).

    Defaults keep the old localhost-only behavior; ``bind_host`` /
    ``port`` / ``advertise_host`` open the fabric to remote nodes (bind
    ``0.0.0.0`` and advertise a routable name), and ``secret`` arms a
    shared-secret HMAC challenge folded into the handshake: the server
    sends a nonce in a HEARTBEAT, the node answers with
    ``HMAC-SHA256(secret, nonce + node_id)``, and a bad (or missing) MAC
    closes the connection before ANY frame of it is processed.

    A node that authenticates but was never ``create()``-ed locally is a
    *remote self-registration*: it is handed to ``on_unclaimed(node_id,
    capacity, channel)`` when set (the backend wires this to its elastic
    join path) instead of waiting for a claim that will never come."""

    name = "socket"

    def __init__(self, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 accept_timeout_s: float = 30.0,
                 bind_host: str = "127.0.0.1", port: int = 0,
                 advertise_host: Optional[str] = None,
                 secret: Optional[Union[str, bytes]] = None):
        self.max_frame_bytes = max_frame_bytes
        self.accept_timeout_s = accept_timeout_s
        self._init_pump()
        self.secret = secret.encode("utf-8") if isinstance(secret, str) \
            else secret
        self._srv = socket.create_server((bind_host, port))
        self._srv.settimeout(0.2)
        self.bind_host = bind_host
        bound = self._srv.getsockname()
        if advertise_host is not None:
            adv = advertise_host
        elif bind_host in _WILDCARD_HOSTS:
            adv = socket.gethostname()  # best effort; pass advertise_host
        else:
            adv = bind_host
        self.advertise_host = adv
        self.address = (adv, bound[1])
        self.on_unclaimed: Optional[Callable] = None
        self._expected: set = set()
        self._waiting: dict = {}
        self._wlock = threading.Lock()
        self._closing = False
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="transport-accept").start()

    def _waiter(self, node_id: str) -> "queue.Queue":
        with self._wlock:
            return self._waiting.setdefault(node_id, queue.Queue())

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            # handshake off-thread: one slow dialler must not block the
            # accept loop (every node connects through it)
            threading.Thread(target=self._handshake, args=(conn,),
                             daemon=True).start()

    def _handshake(self, conn: socket.socket) -> None:
        ch = SocketChannel(conn, self.max_frame_bytes)
        nonce = None
        try:
            if self.secret is not None:
                nonce = secrets.token_bytes(16)
                ch.send(HEARTBEAT, {"challenge": nonce.hex()})
            frame = ch.recv(timeout=10.0)
        except TransportError:
            ch.close()
            return
        if frame is None or frame.kind != HEARTBEAT:
            ch.close()
            return
        payload = frame.payload
        if isinstance(payload, dict):
            node_id = str(payload.get("node"))
            capacity = payload.get("capacity")
            mac = payload.get("mac")
        else:
            node_id, capacity, mac = str(payload), None, None
        if self.secret is not None:
            expect = handshake_mac(self.secret, nonce, node_id)
            if not (isinstance(mac, str) and hmac.compare_digest(mac, expect)):
                ch.close()   # bad MAC: poisoned before any frame lands
                return
        with self._wlock:
            claimed = node_id in self._expected
        cb = self.on_unclaimed
        if not claimed and cb is not None:
            try:
                cb(node_id, capacity, ch)
            except Exception:
                ch.close()
            return
        self._waiter(node_id).put(ch)

    def create(self, node_id: str, ctx=None) -> NodePort:
        with self._wlock:
            self._expected.add(node_id)
        waiter = self._waiter(node_id)
        endpoint = ("socket", {"address": tuple(self.address),
                               "node_id": node_id,
                               "max_frame_bytes": self.max_frame_bytes,
                               "secret": self.secret,
                               "peer_bind_host": self.bind_host,
                               "peer_advertise_host": self.advertise_host})

        def driver_channel(timeout: Optional[float] = None):
            try:
                return waiter.get(timeout=timeout or self.accept_timeout_s)
            except queue.Empty:
                raise TransportError(
                    f"node {node_id!r} never connected to "
                    f"{self.address}") from None
        return NodePort(endpoint, driver_channel)

    @staticmethod
    def connect(address, node_id: str,
                max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                secret: Optional[Union[str, bytes]] = None,
                capacity: Optional[int] = None,
                timeout: float = 10.0) -> SocketChannel:
        """Worker-side dial-in (runs on the node, possibly on another
        host): open the connection, answer the HMAC challenge when a
        ``secret`` is armed, and announce liveness (+ capacity, for
        remote self-registration)."""
        if isinstance(secret, str):
            secret = secret.encode("utf-8")
        sock = socket.create_connection(tuple(address), timeout=timeout)
        sock.settimeout(None)
        ch = SocketChannel(sock, max_frame_bytes)
        if secret is not None:
            frame = ch.recv(timeout=timeout)
            if (frame is None or frame.kind != HEARTBEAT
                    or not isinstance(frame.payload, dict)
                    or "challenge" not in frame.payload):
                ch.close()
                raise TransportError(
                    "expected an auth challenge from the scheduler — is "
                    "its transport armed with the same secret?")
            nonce = bytes.fromhex(frame.payload["challenge"])
            hello = {"node": node_id,
                     "mac": handshake_mac(secret, nonce, node_id)}
            if capacity is not None:
                hello["capacity"] = int(capacity)
            ch.send(HEARTBEAT, hello)
        elif capacity is not None:
            ch.send(HEARTBEAT, {"node": node_id, "capacity": int(capacity)})
        else:
            ch.send(HEARTBEAT, node_id)
        return ch

    def close(self) -> None:
        self._closing = True
        self._close_pump()
        try:
            self._srv.close()
        except OSError:
            pass


def open_worker_channel(endpoint: tuple):
    """Turn a ``NodePort.endpoint`` into the worker-side channel. The
    spec is picklable, so this works after a ``multiprocessing`` spawn as
    well as in a worker thread."""
    kind, spec = endpoint
    if kind == "inproc":
        return spec
    if kind == "socket":
        if isinstance(spec, dict):
            return SocketTransport.connect(
                spec["address"], spec["node_id"],
                spec.get("max_frame_bytes", DEFAULT_MAX_FRAME_BYTES),
                secret=spec.get("secret"))
        address, node_id, cap = spec     # pre-auth tuple spec
        return SocketTransport.connect(address, node_id, cap)
    raise ValueError(f"unknown worker endpoint kind {kind!r}")


def make_transport(transport, **kwargs):
    """'inproc' | 'socket' | a ready transport instance -> (transport,
    owned): ``owned`` tells the caller whether closing it is its job."""
    if isinstance(transport, str):
        if transport == "inproc":
            return InprocTransport(**kwargs), True
        if transport == "socket":
            return SocketTransport(**kwargs), True
        raise ValueError(f"unknown transport {transport!r}; "
                         f"choose 'inproc' or 'socket'")
    return transport, False
