"""Content-addressed staging: chunk store, dedup directory, peer fan-out.

The paper's dominant launch cost is copy time (Fig 5): the same Wine
prefix and application image travel to thousands of nodes, and the
LLMapReduce lineage answers with hierarchical distribution instead of N
scheduler-to-node copies. This module is that answer for the fabric's
STAGE path. Shard payloads are split into fixed-size chunks keyed by
content digest, so identical bytes — across shards of one wave, across
repeated waves, across configs sharing model params — are moved at most
once:

  * ``ChunkCache`` — an in-memory LRU-by-bytes chunk store (the same
    eviction shape as ``CompileCache``'s disk tier: a hit refreshes
    recency, an insert prunes least-recently-used entries over budget).
    Every node runs one as its dedup cache; the scheduler runs one as
    the authoritative store that answers CHUNK_REQ re-sends. Pinning
    keeps chunks referenced by in-flight shards immune to eviction —
    a re-request must always be answerable.
  * ``ChunkDirectory`` — the scheduler-side dedup plan: which node is
    believed to hold which chunk (an LRU mirror of each node's cache
    budget, so the model evicts roughly when the node does), and which
    nodes can serve chunks to peers. ``plan`` is one atomic decision
    per (node, chunk): already held -> send nothing; a healthy peer
    holds it -> send a peer hint (the fan-out tree grows one edge);
    otherwise -> send the bytes and record this node as a holder.
    Health comes from the ``NodeRegistry`` — a suspect or dead holder
    is never hinted, so a failed relay degrades to direct send instead
    of wedging a wave.
  * ``PeerChunkServer`` / ``peer_fetch`` — node-to-node chunk transfer,
    the ``stage_parallel_pull`` pattern promoted into the fabric. Over
    sockets it is a tiny length-prefixed TCP protocol on a per-node
    ephemeral port; over inproc channels peers share the process, so a
    "fetch" is a registry lookup into the holder's ``ChunkCache``.
    A fetched chunk failing its digest check reads as a miss (suspect
    relay) — the node falls back to a scheduler CHUNK_REQ, which is
    always authoritative.

Everything here is bookkeeping and byte movement; WHO stages WHAT stays
with ``DistributedBackend`` and the node agent.
"""
from __future__ import annotations

import hashlib
import itertools
import socket
import struct
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import metrics as _obs

#: staging chunk size — small enough that one hot byte-range dedups
#: across shards, large enough that per-chunk framing stays negligible
DEFAULT_CHUNK_BYTES = 256 << 10

#: per-node chunk cache budget (and the directory's mirror of it)
DEFAULT_CHUNK_CACHE_BYTES = 64 << 20

#: scheduler-side authoritative store budget (pins override LRU)
DEFAULT_STORE_BYTES = 256 << 20


def chunk_digest(data: bytes) -> str:
    """Content key for one chunk (hex). blake2b-128: collision-safe for
    dedup at any plausible fleet scale, half the key bytes of sha256."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def chunk_split(blob: bytes, chunk_bytes: int = DEFAULT_CHUNK_BYTES
                ) -> List[bytes]:
    """Fixed-size split; the last chunk may be short. Empty blobs still
    produce one (empty) chunk so every manifest has at least one entry."""
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    if not blob:
        return [b""]
    return [bytes(blob[i:i + chunk_bytes])
            for i in range(0, len(blob), chunk_bytes)]


class ChunkCache:
    """Thread-safe in-memory chunk store with LRU-by-bytes eviction and
    pin counts (pinned chunks are skipped by the pruner)."""

    def __init__(self, max_bytes: int = DEFAULT_CHUNK_CACHE_BYTES):
        self.max_bytes = max_bytes
        self._data: "OrderedDict[str, bytes]" = OrderedDict()
        self._pins: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.total_bytes = 0
        self.stats = _obs.StatsDict("chunks.cache", {
            "hits": 0, "misses": 0, "puts": 0,
            "evictions": 0, "evicted_bytes": 0})

    def get(self, digest: str) -> Optional[bytes]:
        """Staging lookup: refreshes recency and counts toward the
        node's hit rate."""
        with self._lock:
            data = self._data.get(digest)
            if data is None:
                self.stats["misses"] += 1
                return None
            self._data.move_to_end(digest)
            self.stats["hits"] += 1
            return data

    def peek(self, digest: str) -> Optional[bytes]:
        """Serving lookup (peer requests, re-sends): refreshes recency —
        a chunk hot enough that peers want it should stay resident — but
        does not skew the owner's hit-rate stats."""
        with self._lock:
            data = self._data.get(digest)
            if data is not None:
                self._data.move_to_end(digest)
            return data

    def holds(self, digest: str) -> bool:
        with self._lock:
            return digest in self._data

    def put(self, digest: str, data: bytes) -> None:
        with self._lock:
            if digest in self._data:
                self._data.move_to_end(digest)
                return
            self._data[digest] = data
            self.total_bytes += len(data)
            self.stats["puts"] += 1
            self._prune_locked()

    def _prune_locked(self) -> None:
        """LRU-by-bytes: evict least-recently-used UNPINNED chunks until
        under budget (pins win over budget — an in-flight shard's chunks
        must survive until it resolves)."""
        if self.total_bytes <= self.max_bytes:
            return
        for digest in list(self._data):
            if self.total_bytes <= self.max_bytes:
                return
            if self._pins.get(digest, 0) > 0:
                continue
            data = self._data.pop(digest)
            self.total_bytes -= len(data)
            self.stats["evictions"] += 1
            self.stats["evicted_bytes"] += len(data)

    def pin(self, digests) -> None:
        with self._lock:
            for d in digests:
                self._pins[d] = self._pins.get(d, 0) + 1

    def unpin(self, digests) -> None:
        with self._lock:
            for d in digests:
                n = self._pins.get(d, 0) - 1
                if n <= 0:
                    self._pins.pop(d, None)
                else:
                    self._pins[d] = n
            self._prune_locked()

    def clear(self) -> None:
        """Drop everything (tests simulate memory pressure with this)."""
        with self._lock:
            self._data.clear()
            self._pins.clear()
            self.total_bytes = 0


class ChunkDirectory:
    """Scheduler-side dedup plan + authoritative chunk store.

    The per-node held model is an LRU mirror bounded by the node's cache
    budget: when the model says a chunk fell off the node's LRU, the
    scheduler re-sends instead of hinting. The model is optimistic — a
    chunk is recorded as held the moment the scheduler decides to send
    it (or hint a peer at it); if the node disagrees (evicted early,
    failed relay), its CHUNK_REQ corrects the model via ``forget``.
    """

    def __init__(self, registry=None,
                 node_cache_bytes: int = DEFAULT_CHUNK_CACHE_BYTES,
                 store_bytes: int = DEFAULT_STORE_BYTES):
        self.registry = registry
        self.node_cache_bytes = node_cache_bytes
        self.store = ChunkCache(max_bytes=store_bytes)
        self._held: Dict[str, "OrderedDict[str, int]"] = {}
        self._held_bytes: Dict[str, int] = {}
        self._holders: Dict[str, set] = {}
        self._peers: Dict[str, tuple] = {}
        self._hints: Dict[Tuple[str, str], int] = {}
        self._pinned: Dict[str, List[str]] = {}
        self._lock = threading.Lock()
        self.stats = _obs.StatsDict("chunks.dir", {
            "planned": 0, "deduped": 0, "peer_hints": 0, "resends": 0})

    # -- peer endpoints ---------------------------------------------------
    def set_peer(self, node_id: str, spec) -> None:
        """Record the node's chunk-serving endpoint (from its PEER
        frame); until it lands, the node is send-to only."""
        with self._lock:
            self._peers[node_id] = tuple(spec) if spec else None

    def peer_of(self, node_id: str) -> Optional[tuple]:
        with self._lock:
            return self._peers.get(node_id)

    # -- the dedup decision ----------------------------------------------
    def plan(self, node_id: str, digest: str, size: int):
        """One atomic decision for (node, chunk): returns ``"cached"``
        (send nothing), ``("peer", spec)`` (send a hint), or ``"wire"``
        (send the bytes). Atomicity is what turns concurrent identical
        shards into a tree: the first planner becomes the holder, every
        later one is pointed at a holder instead of the scheduler."""
        with self._lock:
            self.stats["planned"] += 1
            held = self._held.setdefault(node_id, OrderedDict())
            if digest in held:
                held.move_to_end(digest)
                self.stats["deduped"] += 1
                return "cached"
            peer = self._pick_peer_locked(node_id, digest)
            self._record_locked(node_id, digest, size)
            if peer is not None:
                self.stats["peer_hints"] += 1
                return ("peer", peer)
            return "wire"

    def _alive_locked(self, node_id: str) -> bool:
        if self.registry is None:
            return True
        # info() is the O(1) sharded lookup: plan() runs per (node,
        # chunk), so at fleet width a full-table read here would melt
        info = self.registry.info(node_id)
        return info is not None and info.state == "alive"

    def _pick_peer_locked(self, node_id: str, digest: str):
        holders = self._holders.get(digest)
        if not holders:
            return None
        best, best_load = None, None
        for h in holders:
            if h == node_id:
                continue
            spec = self._peers.get(h)
            if spec is None or not self._alive_locked(h):
                continue
            load = self._hints.get((digest, h), 0)
            if best_load is None or load < best_load:
                best, best_load = h, load
        if best is None:
            return None
        self._hints[(digest, best)] = best_load + 1
        return self._peers[best]

    def _record_locked(self, node_id: str, digest: str, size: int) -> None:
        held = self._held.setdefault(node_id, OrderedDict())
        if digest in held:
            held.move_to_end(digest)
            return
        held[digest] = size
        self._held_bytes[node_id] = self._held_bytes.get(node_id, 0) + size
        self._holders.setdefault(digest, set()).add(node_id)
        # mirror the node's own LRU budget so the model evicts when the
        # node (approximately) does
        while self._held_bytes[node_id] > self.node_cache_bytes and held:
            old, old_size = next(iter(held.items()))
            if old == digest:
                break                    # never evict the chunk just sent
            del held[old]
            self._held_bytes[node_id] -= old_size
            self._drop_holder_locked(old, node_id)

    def _drop_holder_locked(self, digest: str, node_id: str) -> None:
        holders = self._holders.get(digest)
        if holders is not None:
            holders.discard(node_id)
            if not holders:
                self._holders.pop(digest, None)
        self._hints.pop((digest, node_id), None)

    def record(self, node_id: str, digest: str, size: int) -> None:
        with self._lock:
            self._record_locked(node_id, digest, size)

    def forget(self, node_id: str, digests) -> None:
        """The node told us it does NOT hold these (CHUNK_REQ): correct
        the optimistic model so the coming re-send is planned honestly."""
        with self._lock:
            held = self._held.get(node_id)
            if held is None:
                return
            for d in digests:
                size = held.pop(d, None)
                if size is not None:
                    self._held_bytes[node_id] -= size
                self._drop_holder_locked(d, node_id)

    def drop_node(self, node_id: str) -> None:
        """A node left or died: it holds nothing and serves nobody."""
        with self._lock:
            held = self._held.pop(node_id, None)
            self._held_bytes.pop(node_id, None)
            self._peers.pop(node_id, None)
            if held:
                for d in held:
                    self._drop_holder_locked(d, node_id)

    # -- authoritative store ---------------------------------------------
    def store_put(self, digest: str, data: bytes) -> None:
        self.store.put(digest, data)

    def store_get(self, digest: str) -> Optional[bytes]:
        with self._lock:
            self.stats["resends"] += 1
        return self.store.peek(digest)

    def pin_task(self, task_key, digests) -> None:
        """Pin a shard's chunks in the store while it is in flight —
        a CHUNK_REQ for them must always be answerable."""
        digests = list(digests)
        with self._lock:
            self._pinned[task_key] = digests
        self.store.pin(digests)

    def unpin_task(self, task_key) -> None:
        with self._lock:
            digests = self._pinned.pop(task_key, None)
        if digests:
            self.store.unpin(digests)


# ----------------------------------------------------------------------
# peer fan-out
# ----------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        data = sock.recv(n - len(buf))
        if not data:
            raise OSError("peer closed mid-message")
        buf += data
    return bytes(buf)


class PeerChunkServer:
    """Node-side chunk server: one ephemeral port, request =
    ``!H``-prefixed digest hex, reply = ``!I``-prefixed chunk bytes
    (length 0 = miss). A requested chunk that has not landed yet is
    waited for briefly — the peer was hinted here by the scheduler, so
    the bytes are normally already in flight to us. ``bind_host`` /
    ``advertise_host`` mirror the transport's: the spec the scheduler
    hands other nodes must be an address THEY can dial, which on a real
    multi-host fleet is not ``127.0.0.1``."""

    def __init__(self, cache: ChunkCache, wait_s: float = 2.0,
                 bind_host: str = "127.0.0.1",
                 advertise_host: Optional[str] = None):
        self._cache = cache
        self._wait_s = wait_s
        self._srv = socket.create_server((bind_host, 0))
        self._srv.settimeout(0.2)
        bound = self._srv.getsockname()
        if advertise_host is None:
            advertise_host = (socket.gethostname()
                              if bind_host in ("0.0.0.0", "::", "")
                              else bind_host)
        self.spec = ("tcp", (advertise_host, bound[1]))
        self._closing = False
        self.served_bytes = 0
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="peer-chunks").start()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(10.0)
            (n,) = struct.unpack("!H", _recv_exact(conn, 2))
            digest = _recv_exact(conn, n).decode("ascii")
            deadline = time.perf_counter() + self._wait_s
            data = self._cache.peek(digest)
            while data is None and time.perf_counter() < deadline:
                time.sleep(0.005)
                data = self._cache.peek(digest)
            if data is None:
                conn.sendall(struct.pack("!I", 0))
            else:
                conn.sendall(struct.pack("!I", len(data)) + data)
                self.served_bytes += len(data)
        except (OSError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass


# inproc peers share the process: a "fetch" is a registry lookup into
# the holder's cache. Process-hosted inproc nodes won't find the token
# across the spawn boundary — peer_fetch returns None and the node falls
# back to a scheduler CHUNK_REQ, which is always correct.
_INPROC_PEERS: Dict[str, ChunkCache] = {}
_INPROC_LOCK = threading.Lock()
_inproc_ids = itertools.count()


def register_inproc_peer(cache: ChunkCache) -> tuple:
    token = f"inproc-peer-{next(_inproc_ids)}"
    with _INPROC_LOCK:
        _INPROC_PEERS[token] = cache
    return ("inproc", token)


def unregister_inproc_peer(spec) -> None:
    if spec and spec[0] == "inproc":
        with _INPROC_LOCK:
            _INPROC_PEERS.pop(spec[1], None)


def peer_fetch(spec, digest: str, timeout_s: float = 3.0
               ) -> Optional[bytes]:
    """Pull one chunk from a peer; ``None`` on ANY failure (dead peer,
    timeout, miss, digest mismatch) — the caller falls back to the
    scheduler, so a bad relay costs latency, never correctness."""
    if not spec:
        return None
    kind, addr = spec[0], spec[1]
    data = None
    try:
        if kind == "inproc":
            with _INPROC_LOCK:
                cache = _INPROC_PEERS.get(addr)
            if cache is None:
                return None
            deadline = time.perf_counter() + timeout_s
            data = cache.peek(digest)
            while data is None and time.perf_counter() < deadline:
                time.sleep(0.005)
                data = cache.peek(digest)
        elif kind == "tcp":
            with socket.create_connection(tuple(addr),
                                          timeout=timeout_s) as sock:
                sock.settimeout(timeout_s)
                d = digest.encode("ascii")
                sock.sendall(struct.pack("!H", len(d)) + d)
                (n,) = struct.unpack("!I", _recv_exact(sock, 4))
                data = _recv_exact(sock, n) if n else None
        else:
            return None
    except (OSError, struct.error):
        return None
    if data is not None and chunk_digest(data) != digest:
        return None                      # suspect relay: treat as a miss
    return data
