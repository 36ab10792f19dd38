"""Render saved obs captures: ``python -m repro_torch.obs.report``.

Two modes:

- ``python -m repro_torch.obs.report trace.json`` — text flame summary of the
  span tree plus per-name aggregate stats. The input is the Chrome-trace
  JSON written by ``Tracer.export_json`` (the same file opens directly
  in Perfetto at https://ui.perfetto.dev).
- ``python -m repro_torch.obs.report --metrics metrics.json`` — table render
  of a metrics snapshot or delta (scalars, then histograms with
  count/mean/p50/p99 read off the bucket CDF). Flight-recorder bundles
  (``repro_torch.obs.flight``) are detected and their ``metrics`` section is
  rendered, so a postmortem reads with the same tool.

Both modes together: the trace renders first, then the metrics table.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from .trace import flame_summary, spans_from_chrome


def name_stats(spans: List[dict]) -> List[tuple]:
    agg: Dict[str, List[float]] = {}
    for s in spans:
        agg.setdefault(s.get("name", "?"), []).append(s.get("dur", 0.0))
    rows = []
    for name, durs in agg.items():
        durs.sort()
        rows.append((name, len(durs), sum(durs),
                     durs[len(durs) // 2], durs[-1]))
    rows.sort(key=lambda r: -r[2])
    return rows


def _bucket_quantile(h: dict, q: float) -> Optional[float]:
    """Quantile estimate off a fixed-bucket histogram snapshot: the
    upper bound of the bucket where the CDF crosses ``q`` (None for the
    overflow bucket — unbounded above)."""
    total = h.get("count", 0)
    if total <= 0:
        return None
    target = q * total
    bounds = h.get("bounds", [])
    seen = 0
    for i, c in enumerate(h.get("counts", [])):
        seen += c
        if seen >= target:
            return bounds[i] if i < len(bounds) else None
    return None


def metrics_table(snap: dict) -> str:
    """Text table of one registry snapshot/delta: scalars first
    (counters and gauges are indistinguishable in a snapshot), then
    histograms with distribution columns."""
    scalars = {k: v for k, v in snap.items() if isinstance(v, (int, float))}
    hists = {k: v for k, v in snap.items()
             if isinstance(v, dict) and "counts" in v}
    lines: List[str] = []
    if scalars:
        w = max(len(k) for k in scalars)
        lines.append("== scalars ==")
        for k in sorted(scalars):
            v = scalars[k]
            vs = f"{v:.6g}" if isinstance(v, float) else str(v)
            lines.append(f"{k:<{w}}  {vs}")
    if hists:
        if scalars:
            lines.append("")
        lines.append("== histograms ==")
        w = max(len(k) for k in hists)
        lines.append(f"{'name':<{w}} {'count':>8} {'mean':>12} "
                     f"{'p50<=':>12} {'p99<=':>12}")
        for k in sorted(hists):
            h = hists[k]
            n = h.get("count", 0)
            mean = (h.get("sum", 0.0) / n) if n else 0.0

            def fq(q, h=h):
                b = _bucket_quantile(h, q)
                return "inf" if b is None else f"{b:.6g}"

            lines.append(f"{k:<{w}} {n:>8} {mean:>12.6g} "
                         f"{fq(0.5):>12} {fq(0.99):>12}")
    if not lines:
        lines.append("(empty snapshot)")
    return "\n".join(lines)


def _load_metrics(path: str) -> dict:
    """A metrics file is either a bare snapshot/delta dict or a flight
    bundle (detected by its version+metrics envelope)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "version" in doc and "metrics" in doc:
        return doc.get("metrics") or {}
    return doc if isinstance(doc, dict) else {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Text render of captured fabric traces and metrics.")
    ap.add_argument("trace", nargs="?", default=None,
                    help="Chrome-trace JSON file (Tracer.export_json "
                    "output)")
    ap.add_argument("--trace-id", default=None,
                    help="restrict to one trace id (default: all)")
    ap.add_argument("--metrics", default=None, metavar="FILE",
                    help="metrics snapshot/delta JSON (or a flight "
                    "bundle) to render as a table")
    args = ap.parse_args(argv)
    if args.trace is None and args.metrics is None:
        ap.error("give a trace file, --metrics FILE, or both")

    if args.trace is not None:
        with open(args.trace) as f:
            doc = json.load(f)
        spans = spans_from_chrome(doc)
        if args.trace_id:
            spans = [s for s in spans if s.get("trace_id") == args.trace_id]
        if not spans:
            print("no spans found", file=sys.stderr)
            return 1

        print(f"{len(spans)} spans, "
              f"{len({s.get('trace_id') for s in spans})} trace(s)\n")
        print("== span tree ==")
        print(flame_summary(spans))
        print("\n== by name ==")
        print(f"{'name':<28} {'n':>6} {'total_ms':>10} {'p50_ms':>9} "
              f"{'max_ms':>9}")
        for name, n, tot, p50, mx in name_stats(spans):
            print(f"{name:<28} {n:>6} {tot * 1e3:>10.3f} "
                  f"{p50 * 1e3:>9.3f} {mx * 1e3:>9.3f}")

    if args.metrics is not None:
        if args.trace is not None:
            print()
        print(metrics_table(_load_metrics(args.metrics)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
