"""Flight recorder: one-call postmortem bundles of the whole obs plane.

When something goes wrong at fleet scale the evidence is spread across
four stores — the span ring, the metrics registry, the time-series
bank, and the node registry — and each of them is a RING: wait too long
and the moment is overwritten. The flight recorder's job is to freeze
all four into a single JSON bundle the instant a trigger fires, written
ATOMICALLY (tmp + rename) so a crash mid-dump never leaves a torn file.

Bundle schema (version 1)::

    {
      "version": 1,
      "reason":  "node_death" | "wave_failure" | "slo_breach" | "...",
      "attrs":   {...trigger-specific context...},
      "t_wall":  <time.time() at capture>,
      "spans":   [last-N finished span dicts],
      "metrics": {scheduler registry snapshot},
      "metrics_delta": {snapshot minus the arm-time baseline} | null,
      "series":  {name: [[t, v], ...tail]},
      "node_metrics": {node_id: last piggybacked snapshot},
      "registry": {node_id: rollup row (state/health/capacity/...)} | null,
      "health":  {node_id: verdict} | null
    }

The module-level :data:`RECORDER` is DISARMED by default — every
trigger call is one attribute read and a return, so instrumented sites
(node death in the registry, wave failure in the llmr driver, SLO
breach in the serve engines) cost nothing until someone arms it.
Triggers are rate-limited (``min_interval_s``) so a dying fleet writes
a few bundles, not thousands.

CLI: ``python -m repro_torch.obs.flight dump [-o PATH]`` writes a bundle of
the CURRENT process's obs state (reason ``"explicit"``).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER

__all__ = ["BUNDLE_VERSION", "FlightRecorder", "RECORDER",
           "snapshot_bundle", "dump"]

BUNDLE_VERSION = 1

#: span/series tail sizes — enough forensics to read, small enough that
#: a bundle stays a few hundred KB even on a wide fleet
DEFAULT_LAST_SPANS = 512
DEFAULT_SERIES_TAIL = 128


def snapshot_bundle(reason: str = "explicit",
                    attrs: Optional[dict] = None,
                    registry: Any = None,
                    metrics_base: Optional[dict] = None,
                    last_spans: int = DEFAULT_LAST_SPANS,
                    series_tail: int = DEFAULT_SERIES_TAIL) -> dict:
    """Freeze the obs plane into one plain-JSON dict. ``registry`` is an
    optional ``NodeRegistry`` (duck-typed: ``rollup()`` +
    ``health_verdicts()``); everything else comes from the process
    globals."""
    series = {name: [[t, v] for t, v in REGISTRY.series_tail(
        name, series_tail)] for name in REGISTRY.series_names()}
    bundle: Dict[str, Any] = {
        "version": BUNDLE_VERSION,
        "reason": reason,
        "attrs": dict(attrs) if attrs else {},
        "t_wall": time.time(),
        "spans": TRACER.spans()[-max(0, int(last_spans)):],
        "metrics": REGISTRY.snapshot(),
        "metrics_delta": (REGISTRY.delta(metrics_base)
                          if metrics_base is not None else None),
        "series": series,
        "node_metrics": REGISTRY.node_snapshots(),
        "registry": None,
        "health": None,
    }
    if registry is not None:
        try:
            bundle["registry"] = registry.rollup()
            hv = getattr(registry, "health_verdicts", None)
            if hv is not None:
                bundle["health"] = hv()
        except Exception:
            pass          # a postmortem of a broken fleet must not raise
    return bundle


def _atomic_write_json(path: str, doc: dict) -> str:
    """tmp-in-same-dir + fsync + rename: the bundle either exists whole
    or not at all."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".flight-", suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


class FlightRecorder:
    """Armed/disarmed trigger sink. Disarmed (the default), ``trigger``
    is one attribute read; armed, each distinct event writes one bundle
    under ``out_dir`` (rate-limited)."""

    def __init__(self) -> None:
        self.armed = False
        self.out_dir = "."
        self.registry: Any = None
        self.last_spans = DEFAULT_LAST_SPANS
        self.min_interval_s = 5.0
        #: serve SLO floor: ``engine.run`` triggers ``slo_breach`` when
        #: attainment lands below this (0.0 = never)
        self.slo_min = 0.0
        self.bundles: List[str] = []
        self._base: Optional[dict] = None
        self._last_dump = float("-inf")
        self._seq = 0
        self._lock = threading.Lock()

    def arm(self, out_dir: str = ".", registry: Any = None,
            last_spans: int = DEFAULT_LAST_SPANS,
            min_interval_s: float = 5.0,
            slo_min: float = 0.0) -> "FlightRecorder":
        """Start watching: record the metrics baseline (so bundles carry
        a since-armed delta) and accept triggers."""
        with self._lock:
            self.out_dir = out_dir
            self.registry = registry
            self.last_spans = last_spans
            self.min_interval_s = min_interval_s
            self.slo_min = slo_min
            self._base = REGISTRY.snapshot()
            self._last_dump = float("-inf")
            self.armed = True
        return self

    def disarm(self) -> None:
        with self._lock:
            self.armed = False
            self.registry = None
            self._base = None

    def trigger(self, reason: str, **attrs: Any) -> Optional[str]:
        """Fire from an instrumented site. No-op unless armed; returns
        the bundle path when one was written."""
        if not self.armed:
            return None
        with self._lock:
            if not self.armed:
                return None
            now = time.monotonic()
            if now - self._last_dump < self.min_interval_s:
                return None
            self._last_dump = now
            self._seq += 1
            path = os.path.join(
                self.out_dir, f"flight-{self._seq:03d}-{reason}.json")
            registry, base, last = self.registry, self._base, self.last_spans
        try:
            out = _atomic_write_json(path, snapshot_bundle(
                reason, attrs, registry, base, last))
        except Exception:
            return None       # a trigger site must never inherit a crash
        self.bundles.append(out)
        return out

    def dump(self, path: str, reason: str = "explicit",
             registry: Any = None, **attrs: Any) -> str:
        """Unconditional bundle (works disarmed — the CLI / CI path)."""
        with self._lock:
            registry = registry if registry is not None else self.registry
            base = self._base
        return _atomic_write_json(path, snapshot_bundle(
            reason, attrs, registry, base, self.last_spans))


#: Process-global recorder — the instance every trigger site fires at.
RECORDER = FlightRecorder()


def dump(path: str, reason: str = "explicit", registry: Any = None,
         **attrs: Any) -> str:
    """Module-level convenience: one bundle of the current process."""
    return RECORDER.dump(path, reason=reason, registry=registry, **attrs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.flight",
        description="Flight-recorder postmortem bundles.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump", help="write one bundle of this process's "
                       "obs state")
    d.add_argument("-o", "--out", default="flight_bundle.json",
                   help="output path (default: flight_bundle.json)")
    d.add_argument("--reason", default="explicit")
    args = ap.parse_args(argv)
    if args.cmd == "dump":
        path = dump(args.out, reason=args.reason)
        doc = snapshot_bundle(args.reason)
        print(f"wrote {path}: {len(doc['spans'])} spans, "
              f"{len(doc['metrics'])} metrics, "
              f"{len(doc['series'])} series")
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
