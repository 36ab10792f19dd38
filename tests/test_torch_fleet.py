"""The reference's fleet cases (``tests/test_fleet.py``) against the port's
fabric on the CPU, through ``test_torch_cases._port_cases``: the capacity
split's properties at 1,000 nodes, the weight floor, the sharded
registry under parallel load, the pump coalescing 500 beats, the HMAC
handshake, and ``transport_options`` reaching the listener and the peer
chunk servers. The remote-node case is re-stated below for the port's
CLI — ``python -m repro_torch.dist.node ... --device cpu``, without the
reference's ``--cache-dir`` (the port's compile cache has no disk tier);
its assertions are the reference's.
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch

from test_torch_cases import _port_cases

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLEET = (
    "test_split_by_capacity_properties_at_1000_nodes",
    "test_split_equal_capacity_never_starves_when_wave_covers_fleet",
    "test_weights_floor_keeps_slow_nodes_measurable",
    "test_sharded_registry_parallel_no_lost_updates",
    "test_pump_coalesces_500_beats_without_starving_results",
    "test_hmac_handshake_admits_good_secret_rejects_bad",
    "test_handshake_mac_binds_node_id",
    "test_transport_options_thread_bind_and_advertise",
)

globals().update(_port_cases("test_fleet.py", FLEET, "fleet",
                             module=__name__))


def test_fleet__remote_cli_node_joins_and_takes_shards(tmp_path):
    """A REAL second process dials in via ``python -m repro_torch.dist.node
    --connect``, answers the HMAC challenge from its --secret-file,
    self-registers through the elastic-join path, and the very next
    waves shard onto it — results exactly once."""
    from repro_torch.dist import DistributedBackend
    secret_file = tmp_path / "secret"
    secret_file.write_bytes(b"s3cret-tok3n\n")
    be = DistributedBackend(
        n_nodes=1, device="cpu",
        transport="socket",
        transport_options={"secret": "s3cret-tok3n"},
        heartbeat_timeout_s=5.0)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
         env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.dist.node",
         "--connect", f"127.0.0.1:{be.transport.address[1]}",
         "--node-id", "remote1", "--capacity", "2",
         "--secret-file", str(secret_file),
         "--heartbeat-s", "0.1",
         "--device", "cpu",
         "--peer-bind-host", "127.0.0.1",
         "--peer-advertise-host", "127.0.0.1"],
        env=env, cwd=ROOT)
    try:
        deadline = time.perf_counter() + 30.0
        while "remote1" not in be.agents:
            assert proc.poll() is None, "remote node process died"
            assert time.perf_counter() < deadline, \
                "remote node never joined"
            time.sleep(0.05)
        assert be.registry.info("remote1").capacity == 2
        x = np.arange(48 * 8, dtype=np.float32).reshape(48, 8)
        expect = app(x)                                       # noqa: F821
        shard_nodes = set()
        for _ in range(3):
            out, rec = be.launch(app, x, 48)                  # noqa: F821
            np.testing.assert_allclose(np.asarray(out), expect,
                                       rtol=1e-5)
            assert rec.n_instances == 48
            shard_nodes |= {s["node"] for s in rec.extra["shards"]}
        # capacity 2 vs the local node's 1: the remote holds real shards
        assert "remote1" in shard_nodes
        # and it reported where it ran
        assert all(nr["device"] == "cpu"
                   for nr in rec.extra["node_records"])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        be.close()
