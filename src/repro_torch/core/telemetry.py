"""Serving telemetry (the request half of ``repro.core.telemetry``).

One finished request's cost split (``RequestRecord``), its CSV table, and the
per-class TTFT/TPOT aggregates the serve engine reports.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional


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
