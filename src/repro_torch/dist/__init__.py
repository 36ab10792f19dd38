"""Distributed launch fabric: the paper's scheduler -> node level. Port
of ``repro.dist``.

``repro_torch.dist`` adds the top level of the launch tree that
``repro_torch.core.backend`` reproduces inside one process: ONE dispatch
fans a wave out across many NODES (each owning its own local backend and
compile cache; on one card every node runs there, thread nodes in this
process and process / remote nodes each with a CUDA context of its own),
nodes report liveness to a registry, and a node lost mid-wave feeds its
work back through the policy layer's barrier-free speculative
re-dispatch.

``transport``, ``pump``, ``chunks`` and ``registry`` are copies of the
reference's modules (only imports renamed); ``node`` and ``backend`` are
ports: tensors travel as host numpy (``node.to_wire`` / ``from_wire``,
bf16 bit-exact) and every entry point runs on the card unless given
``device="cpu"``.

  ``transport``  the wire protocol (SUBMIT/RESULT/HEARTBEAT/STAGE/
                 CHUNK/CHUNK_REQ/PEER/LEAVE frames, msgpack-or-pickle
                 payloads, explicit size caps) over two carriers:
                 ``InprocTransport`` (queue pairs) and
                 ``SocketTransport`` (length-prefixed frames over TCP,
                 one connection per node, configurable bind/advertise
                 addresses, optional shared-secret HMAC handshake).
  ``pump``       FramePump: ONE selector-driven event-loop thread owning
                 every scheduler-side node connection — non-blocking
                 writes, per-connection send queues, incremental frame
                 reassembly, HEARTBEAT coalescing. 1,000 nodes cost one
                 thread and O(fds), not 2,000 threads.
  ``chunks``     content-addressed staging: digest-keyed chunking, the
                 node-side LRU ``ChunkCache``, the scheduler-side
                 ``ChunkDirectory`` (dedup planning + peer hints), and
                 the node-to-node peer chunk fan-out.
  ``registry``   NodeRegistry: membership, heartbeat leases,
                 alive/suspect/dead health, elastic join/leave, and the
                 per-node measured-cost EWMA behind capacity
                 re-weighting. A dropped connection is condemned via
                 ``expire`` (dead connection ≡ lease expiry).
  ``node``       NodeAgent: one agent class across the host x transport
                 matrix (worker threads by default, real
                 ``multiprocessing`` workers via ``host="process"``,
                 ``python -m repro_torch.dist.node --connect`` remote
                 workers),
                 speaking only the protocol; shard payloads stream ahead
                 in STAGE frames and stage node-side OVERLAPPED with the
                 previous wave's execution.
  ``backend``    DistributedBackend: the ``LaunchBackend`` protocol over
                 the fabric — measured-capacity wave sharding, composite
                 wave handles with partial-wave harvest, failover.
"""
from repro_torch.dist.backend import DistributedBackend, NoAliveNodesError
from repro_torch.dist.chunks import (DEFAULT_CHUNK_BYTES,
                               DEFAULT_CHUNK_CACHE_BYTES, ChunkCache,
                               ChunkDirectory, chunk_digest, chunk_split)
from repro_torch.dist.node import NodeAgent, ProcessNodeAgent, spawn_local_nodes
from repro_torch.dist.pump import FramePump
from repro_torch.dist.registry import (ALIVE, DEAD, LEFT, SUSPECT, NodeInfo,
                                 NodeRegistry)
from repro_torch.dist.transport import (ChannelClosed, Frame, InprocTransport,
                                  PayloadTooLarge, ProtocolError,
                                  SocketTransport, TransportError,
                                  encode_frame, handshake_mac,
                                  make_transport)

__all__ = [
    "DistributedBackend", "NoAliveNodesError",
    "ChunkCache", "ChunkDirectory", "chunk_digest", "chunk_split",
    "DEFAULT_CHUNK_BYTES", "DEFAULT_CHUNK_CACHE_BYTES",
    "NodeAgent", "ProcessNodeAgent", "spawn_local_nodes",
    "FramePump",
    "NodeRegistry", "NodeInfo", "ALIVE", "SUSPECT", "DEAD", "LEFT",
    "Frame", "InprocTransport", "SocketTransport", "make_transport",
    "encode_frame", "handshake_mac",
    "TransportError", "ChannelClosed", "PayloadTooLarge", "ProtocolError",
]
