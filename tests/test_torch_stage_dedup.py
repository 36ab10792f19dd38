"""The reference's content-addressed staging cases
(``tests/test_stage_dedup.py``) against the port's fabric on the CPU,
through ``test_torch_cases._port_cases``: chunk split and digests, the LRU
chunk cache, row-group digests invariant to shard boundaries, the
directory's plan, a repeat wave that re-sends almost nothing, a corrupt
chunk failing loudly, evicted chunks re-requested, a dead peer and a dead
node falling back to the scheduler, and dedup off as the baseline. Every
case and assertion is the reference's.
"""
import torch

from test_torch_cases import _port_cases

torch.set_num_threads(1)

DEDUP = (
    "test_chunk_split_roundtrip_and_digest_stability",
    "test_chunk_cache_lru_eviction_spares_pins",
    "test_chunk_cache_hit_refreshes_recency",
    "test_stage_parts_digests_invariant_to_shard_boundaries",
    "test_stage_parts_blob_fallback_for_pytrees",
    "test_directory_plan_wire_then_peer_then_cached",
    "test_directory_forget_and_drop_node_correct_the_model",
    "test_directory_held_model_mirrors_node_budget",
    "test_repeat_wave_resends_almost_nothing",
    "test_corrupt_chunk_is_a_loud_protocol_error",
    "test_evicted_chunk_is_rerequested_transparently",
    "test_dead_peer_falls_back_to_scheduler",
    "test_node_death_mid_wave_restages_from_scheduler",
    "test_stage_dedup_off_is_a_clean_baseline",
)

globals().update(_port_cases("test_stage_dedup.py", DEDUP, "stage_dedup",
                             module=__name__))
