"""Observability: tracing, a process-local metrics registry, time series,
the flight recorder and the live health plane. Copies of ``repro.obs``
(only imports renamed).

- ``repro_torch.obs.trace``: lightweight spans in a bounded ring buffer;
  one ``llmr.map_reduce`` call renders as one span tree. Export as
  Chrome-trace JSON (open in Perfetto) or a text flame summary.
- ``repro_torch.obs.metrics``: counters / gauges / fixed-bucket histograms
  with cheap hot-path increments and snapshot/delta reads.
- ``repro_torch.obs.timeseries``: bounded ring time-series plus the
  background ``Sampler``.
- ``repro_torch.obs.flight``: the flight recorder — atomic JSON postmortem
  bundles on node death / wave failure / explicit trigger.
- ``repro_torch.obs.health``: per-node median/MAD anomaly scoring over
  shard walls and heartbeat gaps -> ``healthy``/``degraded``/``outlier``
  verdicts with hysteresis (in ``NodeRegistry`` rollups and
  ``MapReduceReport.health``).
- ``repro_torch.obs.statusd``: opt-in stdlib HTTP status endpoint
  (``/healthz`` ``/fleet`` ``/slo`` ``/series`` + one HTML fleet page).
- ``python -m repro_torch.obs.report trace.json`` renders a captured trace
  (``--metrics`` a metrics snapshot).

Enable the pillars with :func:`enable_observability` (pass
``sampling=True`` to also start the background sampler).
"""
from typing import Optional

from .health import HealthScorer
from .metrics import REGISTRY, MetricsRegistry, counter, gauge, histogram
from .timeseries import RingSeries, Sampler
from .trace import TRACER, Tracer, new_span_id

__all__ = [
    "REGISTRY", "MetricsRegistry", "counter", "gauge", "histogram",
    "TRACER", "Tracer", "new_span_id",
    "RingSeries", "Sampler", "HealthScorer",
    "enable_observability", "disable_observability", "sampler",
]

#: the process-global background sampler (created on first use; running
#: only between enable_observability(sampling=True) and
#: disable_observability())
_SAMPLER: Optional[Sampler] = None


def sampler() -> Optional[Sampler]:
    """The global background sampler, or None if never started."""
    return _SAMPLER


def enable_observability(tracing: bool = True, metrics: bool = True,
                         sampling: bool = False,
                         sample_interval_s: float = 0.5) -> None:
    """Turn on the global tracer and/or metrics registry for this
    process; ``sampling=True`` also starts the background time-series
    sampler (one snapshot read per ``sample_interval_s`` — off every
    hot path)."""
    global _SAMPLER
    if tracing:
        TRACER.enable()
    if metrics:
        REGISTRY.enable()
    if sampling:
        if _SAMPLER is None:
            _SAMPLER = Sampler(REGISTRY, interval_s=sample_interval_s)
        _SAMPLER.interval_s = max(0.05, sample_interval_s)
        _SAMPLER.start()


def disable_observability() -> None:
    """Turn both pillars off and stop the sampler (buffers are kept;
    use .clear() to drop them)."""
    TRACER.disable()
    REGISTRY.disable()
    if _SAMPLER is not None:
        _SAMPLER.stop()
