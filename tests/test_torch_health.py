"""The reference's live health plane cases (``tests/test_health.py``)
against the port on the CPU, through ``test_torch_cases._port_cases``:
ring series and the sampler, the robust z-scores and the ``HealthScorer``
verdicts with hysteresis, the flight recorder, ``obs.statusd``'s routes,
``obs.report``'s metric tables, and a throttled node of the port's fabric
flagged ``outlier`` on the report. Every case and assertion is the
reference's.
"""
import torch

from test_torch_cases import _port_cases

torch.set_num_threads(1)

HEALTH = (
    "test_ring_series_bounded_and_extent_preserved",
    "test_ring_series_merge_means_values",
    "test_ring_series_summary_and_validation",
    "test_sampler_derives_rates_gauges_and_hit_rates",
    "test_sampler_thread_lifecycle",
    "test_enable_observability_sampling_flag",
    "test_robust_zscores_homogeneous_fleet_stays_flat",
    "test_robust_zscores_flags_the_slow_side",
    "test_scorer_flags_outlier_with_hysteresis_and_recovery",
    "test_scorer_single_hiccup_never_flips_a_verdict",
    "test_scorer_needs_min_peers",
    "test_scorer_forget_drops_history_and_verdict",
    "test_scorer_parameter_validation",
    "test_flight_bundle_schema_and_cli",
    "test_flight_trigger_disarmed_is_noop_and_armed_rate_limits",
    "test_flight_atomic_write_leaves_no_tmp",
    "test_statusd_routes",
    "test_statusd_slo_fallback_reads_serve_histograms",
    "test_report_metrics_table",
    "test_report_metrics_quantiles",
    "test_fleet_slow_node_flagged_outlier_on_report",
)

globals().update(_port_cases("test_health.py", HEALTH, "health",
                             module=__name__))
