"""Launch telemetry: the measurement harness behind Figs 5-7.

A ``LaunchRecord`` carries one wave's cost split along the paper's launch
tree: the scheduler interaction (``t_schedule``), environment staging
(``t_stage``), program enqueue (``t_dispatch``), time to the first
completed task (``t_first_result`` — the interactivity metric), and time
to the last (``t_spawn``). ``fanout`` holds the per-level width of the
scheduler -> node -> core tree and ``levels()`` maps each level onto its
measured cost.

Straggler accounting rides in ``extra`` and is surfaced as CSV columns:
``superseded`` marks an attempt that lost a speculative re-dispatch race
(its cost stays in the report, its instances are not double-counted) and
``redispatch`` marks the duplicate attempt that won. Wave autoscaling
decisions (``repro_torch.core.autoscale.WaveController``) land in
``extra["autoscale"]`` per wave.

Distributed waves (``repro_torch.dist``) add the top of the tree: ``n_nodes``
counts the hosts a wave was sharded over and ``node_failure`` marks an
attempt stranded by a heartbeat-expired node. Per-shard detail lands in
``extra["node_records"]`` and rolls up via ``LaunchRecord.nodes()`` (one
wave) and ``nodes_rollup()`` (a whole report). A distributed wave's
``t_stage`` is its VISIBLE staging only — node-side staging overlapped
with the previous wave's execution is hidden by design, and the full
wall/hidden split rides in ``extra["stage"]`` (per wave) and
``stage_rollup()`` (a whole report).
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class LaunchRecord:
    strategy: str
    n_instances: int
    t_schedule: float = 0.0      # scheduler interaction (submit) time
    t_stage: float = 0.0         # weight/environment staging ("copy time")
    t_dispatch: float = 0.0      # program enqueue (async submit) time
    t_spawn: float = 0.0         # instance start ("launch time" proper)
    t_first_result: float = 0.0  # time to first completed task
    fanout: Dict[str, int] = field(default_factory=dict)  # sched/node/core
    extra: dict = field(default_factory=dict)

    @property
    def superseded(self) -> bool:
        """This attempt lost a speculative straggler re-dispatch race."""
        return bool(self.extra.get("superseded_by_redispatch"))

    @property
    def redispatch(self) -> bool:
        """This attempt IS the speculative duplicate (the re-dispatch)."""
        return bool(self.extra.get("straggler_redispatch"))

    @property
    def n_nodes(self) -> int:
        """Hosts this wave was sharded over (1 for single-host backends)."""
        return int(self.extra.get("n_nodes", 1) or 1)

    @property
    def node_failure(self) -> bool:
        """A node lease expired under this attempt (its shard was lost)."""
        return bool(self.extra.get("node_failure"))

    @property
    def total(self) -> float:
        return self.t_schedule + self.t_stage + self.t_spawn

    @property
    def rate(self) -> float:
        # a record with no measured cost has no meaningful rate; 0.0 keeps
        # the CSV row parseable (inf breaks float columns downstream)
        return self.n_instances / self.total if self.total > 0 else 0.0

    def levels(self) -> Dict[str, float]:
        """Per-level timings of the launch tree: the scheduler level is the
        one submit, the node level ends at the first completed result, the
        core level is the drain of the remaining lanes."""
        return {
            "sched": self.t_schedule,
            "node": self.t_first_result,
            "core": max(self.t_spawn - self.t_first_result, 0.0),
        }

    def nodes(self) -> Dict[str, dict]:
        """Per-node rollup of this wave's shards ({} for single-host
        records): node id -> instances, shard span, wall, attempts."""
        out: Dict[str, dict] = {}
        for nr in self.extra.get("node_records", []):
            out[nr["node"]] = {"n": nr.get("n", 0),
                               "span": (nr.get("lo"), nr.get("hi")),
                               "t_wave": nr.get("t_wave", 0.0),
                               "t_stage": nr.get("t_stage", 0.0),
                               "stage_hidden_s": nr.get("stage_hidden_s",
                                                        0.0),
                               "attempts": nr.get("attempts", 1),
                               "compile_source": nr.get("compile_source")}
        return out

    def row(self) -> str:
        return (f"{self.strategy},{self.n_instances},{self.t_schedule:.4f},"
                f"{self.t_stage:.4f},{self.t_spawn:.4f},"
                f"{self.t_first_result:.4f},{self.total:.4f},"
                f"{self.rate:.2f},{int(self.superseded)},"
                f"{int(self.redispatch)},{self.n_nodes},"
                f"{int(self.node_failure)}")


HEADER = ("strategy,n,t_schedule,t_stage,t_spawn,t_first_result,"
          "t_total,rate_per_s,superseded,redispatch,n_nodes,node_failure")


def nodes_rollup(records: List[LaunchRecord]) -> Dict[str, dict]:
    """Aggregate the per-node shard detail of many wave records: node id
    -> waves served, instances, busy seconds, staging wall + hidden
    seconds — the fabric-level view the ``fig_dist`` benchmark and
    ``examples/massive_launch.py`` print."""
    out: Dict[str, dict] = {}
    for r in records:
        for nid, d in r.nodes().items():
            agg = out.setdefault(nid, {"waves": 0, "instances": 0,
                                       "t_busy": 0.0, "t_stage": 0.0,
                                       "t_stage_hidden": 0.0})
            agg["waves"] += 1
            agg["instances"] += d["n"]
            agg["t_busy"] += d["t_wave"]
            agg["t_stage"] += d.get("t_stage", 0.0)
            agg["t_stage_hidden"] += d.get("stage_hidden_s", 0.0)
    return out


def stage_rollup(records: List[LaunchRecord]) -> Dict[str, Any]:
    """Whole-report staging overlap: total node-side stage wall, the
    part hidden under execution, and the hidden fraction (the measured
    form of the paper's 'copy time overlapped with launch'). When the
    fabric staged content-addressed, the rollup also carries the byte
    split — ``bytes_on_wire`` (scheduler->node frames actually sent) vs
    ``bytes_delivered`` (staged onto every node) — and an aggregate
    chunk-cache hit rate."""
    wall = hidden = 0.0
    wire = delivered = 0
    hits = misses = 0
    saw_dedup = False
    latest_cache: Dict[str, dict] = {}
    for r in records:
        st = r.extra.get("stage")
        if st:
            wall += st.get("wall_s", 0.0)
            hidden += st.get("hidden_s", 0.0)
            wire += st.get("bytes_on_wire", 0)
            delivered += st.get("bytes_delivered", 0)
            dd = st.get("dedup")
            if dd:
                saw_dedup = True
                # fallback for reports without per-node detail; a wave's
                # cache_hits is already a SUM over nodes, so max() across
                # waves is only safe when the node set never changes
                hits = max(hits, dd.get("cache_hits", 0))
                misses = max(misses, dd.get("cache_misses", 0))
        # node cache counters are cumulative: keep each node's LATEST
        # snapshot (records are wave-ordered), then sum across nodes —
        # max() over per-wave sums conflates different nodes' counters
        for nr in r.extra.get("node_records", []):
            nc = (nr.get("stage_dedup") or {}).get("node_cache")
            if nc:
                latest_cache[nr["node"]] = nc
    out: Dict[str, Any] = {
        "wall_s": wall, "hidden_s": hidden,
        "hidden_frac": hidden / wall if wall > 0 else 0.0,
        "bytes_on_wire": wire, "bytes_delivered": delivered}
    if latest_cache:
        saw_dedup = True
        hits = sum(c.get("hits", 0) for c in latest_cache.values())
        misses = sum(c.get("misses", 0) for c in latest_cache.values())
    if saw_dedup:
        out["cache_hit_rate"] = (hits / (hits + misses)
                                 if hits + misses else 0.0)
    return out


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt


def table(records: List[LaunchRecord], title: Optional[str] = None) -> str:
    lines = ([f"# {title}"] if title else []) + [HEADER]
    lines += [r.row() for r in records]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Serving telemetry: per-request latency records, per-class summaries
# ---------------------------------------------------------------------------
#
# The serving-side analogue of ``LaunchRecord``: one finished request's cost
# split. TTFT (time to first token, from ENQUEUE — queue wait included, the
# user feels the queue) is the serving face of the launch tree's
# ``t_first_result``; TPOT (time per output token after the first) is the
# steady-state decode rate. ``class_summary``/``slo_attainment`` aggregate
# per priority class against the same ``target_first_result_s`` SLO the
# ``WaveController`` consumes on the launch side.

@dataclass
class RequestRecord:
    rid: int
    priority: str
    ttft_s: float                # enqueue -> first token (queue wait incl.)
    tpot_s: float                # mean per-token latency after the first
    n_tokens: int
    preemptions: int = 0
    finish: str = "length"       # length | capacity | pool_exhausted |
    #                              rejected_over_capacity

    def row(self) -> str:
        return (f"{self.rid},{self.priority},{self.ttft_s:.4f},"
                f"{self.tpot_s:.5f},{self.n_tokens},{self.preemptions},"
                f"{self.finish}")


SERVE_HEADER = "rid,class,ttft_s,tpot_s,tokens,preemptions,finish"


def serve_table(records: List[RequestRecord],
                title: Optional[str] = None) -> str:
    lines = ([f"# {title}"] if title else []) + [SERVE_HEADER]
    lines += [r.row() for r in records]
    return "\n".join(lines)


def _median(xs: List[float]) -> float:
    return float(statistics.median(xs)) if xs else 0.0


def class_summary(records: List[RequestRecord]) -> Dict[str, dict]:
    """Per-priority-class TTFT/TPOT aggregates over finished requests."""
    out: Dict[str, dict] = {}
    for p in sorted({r.priority for r in records}):
        rs = [r for r in records if r.priority == p]
        served = [r for r in rs if r.n_tokens > 0]
        out[p] = {
            "n": len(rs),
            "p50_ttft_s": _median([r.ttft_s for r in served]),
            "mean_ttft_s": (sum(r.ttft_s for r in served) / len(served)
                            if served else 0.0),
            "p50_tpot_s": _median([r.tpot_s for r in served]),
            "preemptions": sum(r.preemptions for r in rs),
        }
    return out


def slo_attainment(records: List[RequestRecord],
                   target_first_result_s: float) -> float:
    """Fraction of served requests whose TTFT met the interactivity SLO
    (the serving-side reading of ``WaveController.target_first_result_s``)."""
    served = [r for r in records if r.n_tokens > 0]
    if not served:
        return 1.0
    return sum(r.ttft_s <= target_first_result_s for r in served) / len(served)
