"""The reference's transport cases (``tests/test_transport.py``) against
the port's fabric on the CPU, through ``test_torch_cases._port_cases``:
the codec, socket framing and caps, loud failures (unpicklable shard
function, oversized result or shard), out-of-order and zombie RESULT
frames, a dropped connection read as node death, process-node SIGTERM
over both wires and the stager's overlap accounting. ``app_big_out`` is
written in torch (the reference's is ``jax.numpy``); every assertion is
the reference's.
"""
import torch

from test_torch_cases import _port_cases

torch.set_num_threads(1)


def app_big_out(x):
    """Output ~50x the input: blows a small frame cap on the RESULT."""
    return torch.zeros((x.shape[0], 50_000), dtype=torch.float32)


TRANSPORT = (
    "test_codec_picks_msgpack_for_control_pickle_for_data",
    "test_socket_frames_roundtrip_and_interleave",
    "test_oversized_payload_rejected_at_send_socket",
    "test_oversized_length_prefix_poisons_the_connection",
    "test_oversized_payload_rejected_inproc",
    "test_unpicklable_fn_over_socket_fails_loudly",
    "test_oversized_result_reports_error_not_hang",
    "test_oversized_shard_fails_the_wave_loudly",
    "test_out_of_order_and_zombie_result_frames",
    "test_connection_dropped_mid_shard_reads_as_node_death",
    "test_process_agent_sigterm_identical_over_both_transports",
    "test_stager_attributes_overlap_to_the_busy_clock",
)

globals().update(_port_cases("test_transport.py", TRANSPORT, "transport",
                             module=__name__,
                             overrides={"app_big_out": app_big_out}))
