"""The port's verbatim copies — ``core.autoscale``, ``core.launch_model``,
``core.telemetry`` (the launch half) and ``obs.trace`` / ``obs.metrics`` /
``obs.timeseries`` / ``obs.flight``, ``data.pipeline`` — held to the
reference's own tests (``data.pipeline``: its batches, byte for byte).

Each case below is the reference test's code, taken from its file in
``tests/`` with every ``repro.`` import renamed to ``repro_torch.``, so the
same assertions run against the port's copy (the reference's file runs
them against the reference). Cases that need a module the port does not
have yet are left out by name: the distributed fabric (``repro.dist``:
``test_fleet_wave_exports_linked_span_tree``,
``test_rejoin_same_id_keeps_metrics_baseline``,
``test_observability_off_adds_no_spans_or_metrics``) and the trace report
CLI (``repro.obs.report``: ``test_chrome_trace_roundtrip_and_flame``,
``test_report_renders_wrapped_ring_trace``); ``tests/test_autoscale.py``'s
end-to-end cases build backends and run in ``tests/test_torch_launcher.py``
on the CPU. The copies are also compared to the reference's sources.
"""
import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"


class _Rename(ast.NodeTransformer):
    """``repro`` / ``repro.x`` imports -> ``repro_torch`` / ``repro_torch.x``."""

    @staticmethod
    def _name(mod):
        if mod == "repro" or (mod or "").startswith("repro."):
            return "repro_torch" + mod[len("repro"):]
        return mod

    def visit_Import(self, node):
        for a in node.names:
            a.name = self._name(a.name)
        return node

    def visit_ImportFrom(self, node):
        if node.level == 0:
            node.module = self._name(node.module)
        return node


def _port_cases(ref: str, names: tuple, prefix: str) -> dict:
    """The test functions ``names`` of ``tests/<ref>`` (and its helpers and
    fixtures) compiled against the port, keyed ``test_<prefix>__<name>``
    (fixtures and helpers under their own names). Top-level imports of a
    module the port lacks are dropped; the cases chosen do not use them."""
    tree = _Rename().visit(ast.parse((TESTS / ref).read_text()))
    ns = {"__name__": f"ported_{ref[:-3]}"}
    for node in tree.body:
        if (isinstance(node, ast.FunctionDef)
                and node.name.startswith("test_")
                and node.name not in names):
            continue
        code = compile(ast.Module(body=[node], type_ignores=[]),
                       str(TESTS / ref), "exec")
        try:
            exec(code, ns)
        except ImportError:
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                raise
    missing = set(names) - set(ns)
    assert not missing, missing
    out = {}
    for k, v in ns.items():
        if k in names:
            out[f"test_{prefix}__{k[len('test_'):]}"] = v
        elif hasattr(v, "_fixture_function_marker"):     # a fixture
            out[k] = v
    return out


AUTOSCALE = (
    "test_small_jobs_run_as_one_wave", "test_wave_bounds_respected",
    "test_grows_while_dispatch_amortization_dominates",
    "test_grow_is_debounced_at_the_boundary",
    "test_straggler_shrinks_immediately",
    "test_drain_shrink_needs_two_consecutive_signals",
    "test_probe_down_adopts_cheaper_size_and_returns_otherwise",
    "test_probe_gated_by_remaining_tasks",
    "test_cost_regression_reverts_and_caps_growth",
    "test_lanes_flat_on_single_device_hierarchical_on_many",
    "test_nodes_widen_the_parallel_width",
    "test_slo_changes_wave_size_decisions",
    "test_tail_waves_do_not_steer_the_ladder",
)
TELEMETRY = (
    "test_stage_rollup_sums_each_nodes_latest_snapshot",
    "test_stage_rollup_node_leaving_fleet_keeps_its_last_counters",
    "test_stage_rollup_falls_back_to_wave_dedup_without_node_detail",
    "test_stage_rollup_without_dedup_has_no_hit_rate",
    "test_zero_cost_record_rate_is_zero_and_row_parseable",
    "test_rollups_on_empty_report", "test_rollups_on_all_superseded_report",
    "test_rollups_tolerate_records_missing_optional_extra",
    "test_class_summary_with_unserved_requests",
)
OBS = (
    "test_counter_gauge_histogram_basics",
    "test_snapshot_and_delta_attribute_one_window",
    "test_clear_keeps_cached_instruments_attached",
    "test_stats_dict_mirrors_increments_only_while_enabled",
    "test_retire_node_preserves_dead_incarnation_totals",
    "test_zombie_same_incarnation_never_double_counts",
    "test_node_ingest_latest_wins_and_rollup_sums",
    "test_tracer_disabled_is_noop",
    "test_span_parenting_follows_the_thread_stack",
    "test_wire_context_tuple_reparents_across_threads",
    "test_ring_is_bounded",
    "test_wrapped_ring_exports_no_orphan_parent_refs",
)

globals().update(_port_cases("test_autoscale.py", AUTOSCALE, "autoscale"))
globals().update(_port_cases("test_telemetry.py", TELEMETRY, "telemetry"))
globals().update(_port_cases("test_obs.py", OBS, "obs"))


# ---------------------------------------------------------------------------
# The copies against the reference's sources
# ---------------------------------------------------------------------------

COPIES = ("core/autoscale.py", "core/launch_model.py", "core/telemetry.py",
          "obs/trace.py", "obs/metrics.py", "obs/timeseries.py",
          "obs/flight.py", "data/pipeline.py")


def _code(path: Path) -> str:
    """A module's code with docstrings and comments dropped and the package
    name unified: what the copy must keep equal."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], "value", None), ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return re.sub(r"\brepro_torch\b", "repro", ast.unparse(tree))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_keeps_the_reference_code(rel):
    assert (_code(ROOT / "src" / "repro_torch" / rel)
            == _code(ROOT / "src" / "repro" / rel))


def test_llmr_records_a_span_tree_and_wave_series():
    """With observability on, one ``map_reduce`` call is one span tree
    (``llmr.map_reduce`` -> a ``harvest`` per wave) and each wave's wall
    lands in the ``llmr.wave_s`` series; with it off, none."""
    from repro_torch.core.llmr import LLMapReduce
    from repro_torch.obs import (REGISTRY, TRACER, disable_observability,
                                 enable_observability)
    REGISTRY.clear()
    TRACER.clear()
    enable_observability()
    try:
        _, rep = LLMapReduce(wave_size=4, device="cpu").map_reduce(
            lambda v: v.sum(), np.ones((12, 3), np.float32))
        spans = TRACER.spans()
        root = [s for s in spans if s["name"] == "llmr.map_reduce"]
        harvests = [s for s in spans if s["name"] == "harvest"]
        assert len(root) == 1 and len(harvests) == rep.waves == 3
        assert all(h["parent_id"] == root[0]["span_id"] for h in harvests)
        assert len(REGISTRY.series_tail("llmr.wave_s", 16)) == 3
    finally:
        disable_observability()
        REGISTRY.clear()
        TRACER.clear()
    LLMapReduce(wave_size=4, device="cpu").map_reduce(
        lambda v: v.sum(), np.ones((12, 3), np.float32))
    assert TRACER.spans() == []


@pytest.mark.parametrize("arch", [None, *__import__(
    "repro.configs", fromlist=["ARCHS"]).ARCHS])
def test_synth_batch_equals_the_reference_byte_for_byte(arch):
    """The data copy draws the reference's batches: the same keys, dtypes,
    shapes and bytes for every architecture's frontend (and none), over
    steps, hosts and seeds."""
    from repro.configs import get_config
    from repro.data import pipeline as ref
    from repro_torch.configs import get_config as tget
    from repro_torch.data import pipeline as port
    model = get_config(arch, smoke=True) if arch else None
    tmodel = tget(arch, smoke=True) if arch else None
    for seed, step, host in ((0, 0, 0), (3, 7, 1)):
        kw = dict(seq_len=64, global_batch=4, seed=seed, host_id=host,
                  n_hosts=2, vocab=1000)
        a = ref.synth_batch(ref.DataConfig(**kw), step, model)
        b = port.synth_batch(port.DataConfig(**kw), step, tmodel)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (arch, k)
