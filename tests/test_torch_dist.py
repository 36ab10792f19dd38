"""The port's distributed launch fabric (``repro_torch.dist``) on the CPU.

* The reference's own fabric cases (``tests/test_dist.py``) run against the
  port through ``test_torch_cases._port_cases``: registry lifecycle,
  capacity split, the LaunchBackend contract over nodes, node death
  mid-wave, join mid-run, all nodes dead, graceful leave, measured
  re-weighting, staging overlap and process nodes — every fabric built
  with ``device="cpu"``. ``app_heavy`` is written in torch (the
  reference's is ``jax.numpy``), and ``test_dist_backend_compiles_for_
  local_callers`` is re-stated below with a torch input and the port's
  ``compile`` signature; their assertions are the reference's.
* Parity with ``repro.dist`` on the same seeded numpy inputs (JAX on the
  CPU): wave outputs (rtol 1e-5, atol 1e-4, the reference's tolerances),
  the shard split, ``split_by_capacity`` on a grid, ``encode_frame``'s
  bytes for every frame kind and ``_stage_parts``' chunk digests.
* bf16 crosses the wire bit-exact, and the fabric's entry points need the
  card unless given ``device="cpu"``.
"""
import io
import pickle
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_cases import _port_cases

torch.set_num_threads(1)


def app_heavy(x):
    """Enough per-instance compute that a wave's execution dwarfs its
    staging — the regime where staging overlap is measurable."""
    w = torch.full((x.shape[-1], x.shape[-1]), 0.01, dtype=x.dtype)
    for _ in range(2):
        x = torch.tanh(x @ w) + x * 0.1
    return x.sum(-1)


DIST = (
    "test_registry_health_lifecycle", "test_capacity_weighted_split",
    "test_dist_matches_single_host_and_records_nodes",
    "test_dist_through_llmr_with_autoscale_nodes_input",
    "test_node_dies_mid_wave_exactly_once",
    "test_node_joins_mid_run_receives_waves",
    "test_all_nodes_dead_raises_cleanly",
    "test_graceful_leave_is_not_a_failure",
    "test_slow_node_gets_smaller_shards_within_3_waves",
    "test_staging_overlap_hides_stage_wall",
    "test_unoverlapped_staging_is_all_visible",
    "test_process_nodes_compute_and_fail_over",
)

globals().update(_port_cases("test_dist.py", DIST, "dist", module=__name__,
                             overrides={"app_heavy": app_heavy}))


def test_dist__dist_backend_compiles_for_local_callers(cache):
    """Serve engines call ``backend.compile`` and execute locally; the
    fabric must expose the same entry point over its driver-side cache
    (the reference's case with a torch input)."""
    be = _fabric(cache, n_nodes=2)                        # noqa: F821
    x = torch.ones((4, 4), dtype=torch.float32)

    def double(a):
        return a * 2.0

    compiled, source = be.compile(double, (x,))
    assert source == "compiled"
    np.testing.assert_allclose(np.asarray(compiled(x)), np.full((4, 4), 2.0))
    _, source2 = be.compile(double, (x,))
    assert source2 == "memory"              # same driver-side cache
    be.close()


# ---------------------------------------------------------------------------
# Parity with the reference's fabric
# ---------------------------------------------------------------------------

def _fabrics(tmp_path, transport, **kw):
    """The reference's fabric (JAX on the CPU) and the port's, alike."""
    from repro.core.compile_cache import CompileCache as JCache
    from repro.dist import DistributedBackend as JFabric
    from repro_torch.dist import DistributedBackend
    common = dict(transport=transport, heartbeat_s=0.02,
                  heartbeat_timeout_s=10.0, **kw)
    ref = JFabric(cache=JCache(cache_dir=str(tmp_path / "aot")), **common)
    port = DistributedBackend(device="cpu", **common)
    return ref, port


@pytest.mark.parametrize("transport", ["inproc", "socket"])
def test_wave_outputs_and_split_match_the_reference(tmp_path, transport):
    """The same seeded wave through both fabrics: equal outputs and the
    same shards, for declared capacities and for equal ones."""
    inputs = np.random.default_rng(11).standard_normal((37, 8)).astype(
        np.float32)
    for caps in ([2, 1, 1], [1, 1, 1]):
        ref, port = _fabrics(tmp_path, transport, n_nodes=3,
                             capacities=caps)
        try:
            a, ra = ref.launch(app, inputs, 37)                # noqa: F821
            b, rb = port.launch(app, inputs, 37)               # noqa: F821
        finally:
            ref.close()
            port.close()
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-4)
        assert rb.extra["shards"] == ra.extra["shards"]
        assert rb.fanout == ra.fanout and rb.n_nodes == ra.n_nodes == 3
        assert {nr["device"] for nr in rb.extra["node_records"]} == {"cpu"}


def test_split_by_capacity_matches_the_reference_on_a_grid():
    from repro.dist.backend import split_by_capacity as jsplit
    from repro_torch.dist.backend import split_by_capacity
    rng = np.random.default_rng(5)
    grids = [[1.0] * k for k in (1, 2, 3, 7, 16)]
    grids += [list(rng.uniform(0.05, 8.0, size=k)) for k in (2, 5, 33)]
    grids += [[2, 1, 1], [0.05, 1.0, 1.0, 0.3], [1e-3, 5.0]]
    for w in grids:
        for n in (0, 1, 2, 5, 17, 64, 1000, 16384):
            assert split_by_capacity(n, w) == jsplit(n, w), (n, w)


def _frames():
    """One representative payload per frame kind, as the fabric sends
    them (``app`` pickles by reference: it is this module's)."""
    from repro_torch.dist import transport as t
    rows = np.arange(24, dtype=np.float32).reshape(6, 4)
    return [
        (t.SUBMIT, {"task_id": 3, "fn": app, "n": 6,           # noqa: F821
                    "inner_lanes": None, "staged": True,
                    "tc": ("ab" * 8, "cd" * 4)}),
        (t.SUBMIT, {"task_id": 4, "fn": app, "n": 6,           # noqa: F821
                    "inner_lanes": 2, "chunk": rows}),
        (t.RESULT, {"task_id": 3, "ok": True, "out": rows.sum(-1),
                    "rec": None}),
        (t.RESULT, {"task_id": 5, "ok": False, "err": "RuntimeError('x')"}),
        (t.HEARTBEAT, "node0"),
        (t.HEARTBEAT, {"node": "node1", "m": {"node.shards": 3},
                       "i": "0123456789abcdef"}),
        (t.STAGE, {"task_id": 3, "chunk": rows, "off": 12}),
        (t.STAGE, {"task_id": 6, "chunks": [["d" * 32, 96, "w"],
                                            ["e" * 32, 96, "c"]],
                   "mode": "rows"}),
        (t.CHUNK, {"d": "d" * 32, "data": bytes(range(96))}),
        (t.CHUNK, {"d": "f" * 32, "data": None}),
        (t.CHUNK_REQ, {"node": "node0", "task_id": 6,
                       "digests": ["e" * 32]}),
        (t.PEER, {"node": "node0", "peer": ["tcp", ["127.0.0.1", 4242]]}),
        (t.PEER, {"node": "node1", "peer": None}),
        (t.LEAVE, "node0"),
    ]


def test_encode_frame_bytes_match_the_reference_for_every_kind():
    from repro.dist import transport as jt
    from repro_torch.dist import transport as t
    frames = _frames()
    assert {k for k, _ in frames} == {
        t.SUBMIT, t.RESULT, t.HEARTBEAT, t.STAGE, t.CHUNK, t.CHUNK_REQ,
        t.PEER, t.LEAVE}
    for kind, payload in frames:
        got = t.encode_frame(kind, payload)
        assert got == jt.encode_frame(kind, payload), kind
        # and the port reads its own bytes back as a payload that
        # encodes to them again
        back = t._decode(got[5:6], got[6:])
        assert t.encode_frame(kind, back) == got, kind


@pytest.mark.parametrize("off", [0, 3, 8])
def test_stage_parts_digests_match_the_reference(off):
    from repro.dist.chunks import chunk_digest as jdigest
    from repro.dist.node import NodeAgent as JAgent
    from repro_torch.dist.chunks import chunk_digest
    from repro_torch.dist.node import NodeAgent
    arr = np.random.default_rng(off).standard_normal((24, 64)).astype(
        np.float32)
    for chunk, eff in ((arr, 4 * arr[0].nbytes), (arr[5:19], 1000),
                       ({"x": arr[:4], "y": 3}, 512)):
        mode, parts = NodeAgent._stage_parts(chunk, eff, off)
        jmode, jparts = JAgent._stage_parts(chunk, eff, off)
        assert mode == jmode
        assert [chunk_digest(p) for p in parts] == [jdigest(p)
                                                   for p in jparts]


# ---------------------------------------------------------------------------
# Tensors on the wire
# ---------------------------------------------------------------------------

def _bf16(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _bits(t):
    return t.view(torch.int16).numpy()


def test_bf16_survives_the_wire_bit_exact():
    """bf16 travels as its 16 bits under ``BF16_WIRE``: through the codec,
    a frame's pickle, and ``_stage_parts``' row groups reassembled the way
    a node reassembles them."""
    from repro_torch.dist.node import (BF16_WIRE, NodeAgent, from_wire,
                                       to_wire)
    from repro_torch.dist.transport import STAGE, encode_frame
    x = _bf16((16, 24))
    x[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"),
                             -0.0], dtype=torch.bfloat16)
    tree = {"x": x, "f": torch.arange(5.0), "i": torch.arange(3),
            "n": np.ones(2, np.float16), "s": 7}
    wire = to_wire(tree)
    assert wire["x"].dtype == BF16_WIRE and wire["x"].shape == (16, 24)
    assert isinstance(wire["f"], np.ndarray) and wire["s"] == 7
    body = encode_frame(STAGE, {"task_id": 1, "chunk": wire})
    assert len(body) > x.numel() * 2
    back = from_wire(pickle.loads(pickle.dumps(wire)))
    assert back["x"].dtype == torch.bfloat16
    assert np.array_equal(_bits(back["x"]), _bits(x))
    assert np.array_equal(back["i"], np.arange(3))
    on = from_wire(wire, device="cpu")
    assert all(isinstance(on[k], torch.Tensor) for k in ("x", "f", "i", "n"))
    assert on["n"].dtype == torch.float16 and on["i"].dtype == torch.int64
    mode, parts = NodeAgent._stage_parts(wire["x"], 4 * 24 * 2, off=2)
    assert mode == "rows" and len(parts) > 2
    rows = np.concatenate([pickle.loads(p) for p in parts])
    assert rows.dtype == BF16_WIRE
    assert np.array_equal(_bits(from_wire(rows)), _bits(x))


@pytest.mark.parametrize("transport", ["inproc", "socket"])
def test_bf16_wave_crosses_the_fabric_bit_exact(transport):
    """A bf16 wave sharded over three nodes comes back bit-equal to the
    same function run in one piece."""
    from repro_torch.dist import DistributedBackend
    x = _bf16((30, 16), seed=1)
    want = torch.func.vmap(bf16_app)(x)
    be = DistributedBackend(n_nodes=3, device="cpu", transport=transport,
                            heartbeat_s=0.02, heartbeat_timeout_s=10.0)
    try:
        out, rec = be.launch(bf16_app, x, 30)
    finally:
        be.close()
    assert out.dtype == torch.bfloat16 and rec.n_nodes == 3
    assert np.array_equal(_bits(out), _bits(want))


def bf16_app(x):
    return (x * 1.5 - 0.25).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# The card unless asked for the CPU
# ---------------------------------------------------------------------------

def test_fabric_entry_points_need_the_card_unless_asked_for_cpu(
        monkeypatch):
    from repro_torch.core.backend import make_backend
    from repro_torch.dist import (DistributedBackend, NodeAgent, NodeRegistry,
                                  ProcessNodeAgent, spawn_local_nodes)
    from repro_torch.dist.node import _connect_main
    from repro_torch.examples import massive_launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = NodeRegistry(heartbeat_timeout_s=10.0)
    for make in (lambda: DistributedBackend(n_nodes=1),
                 lambda: make_backend("dist", n_nodes=1),
                 lambda: NodeAgent("t0", reg, start=False),
                 lambda: ProcessNodeAgent("p0", reg, start=False),
                 lambda: spawn_local_nodes(1, reg),
                 lambda: _connect_main(["--connect", "127.0.0.1:9"]),
                 lambda: massive_launch.main(["--n", "8", "--nodes", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    be = make_backend("dist", n_nodes=2, device="cpu")
    try:
        assert be.device.type == "cpu" and be.n_nodes == 2
        out, _ = be.launch(app, np.ones((6, 2), np.float32), 6)  # noqa: F821
        assert out.tolist() == [6.0] * 6
    finally:
        be.close()


def test_massive_launch_example_over_socket_nodes():
    from repro_torch.examples import massive_launch
    buf = io.StringIO()
    with redirect_stdout(buf):
        massive_launch.main(["--device", "cpu", "--n", "512", "--wave",
                             "128", "--nodes", "3", "--transport",
                             "socket"])
    text = buf.getvalue()
    assert "launched 512 instances" in text and "4 waves" in text
    assert "per-node split across the fabric over socket" in text
    assert all(f"  node{i}: " in text for i in range(3))
    assert "staging bytes:" in text and "launch model" in text
