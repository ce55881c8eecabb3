"""Unified observability: metrics registry, request lifecycle tracing,
pipeline span export, and perfmodel drift detection (the port's copy of
repro.obs).

One :class:`Observability` object per ``ServingEngine`` bundles the
four surfaces; everything is off by default and cheap when off (the
engine holds ``obs = None`` and every hook is a single ``is None``
test).  Enable with ``ServingEngine(..., observability=True)`` or pass
an :class:`ObsConfig` to tune the parts individually.

    eng = ServingEngine(params, cfg, batch=8, cache_len=256,
                        backend="hetero", observability=True)
    ...
    eng.metrics()                  # one flat schema-conformant snapshot
    eng.export_trace("trace.json") # Perfetto-loadable pipeline spans
    print(eng.drift_report())      # measured vs perfmodel-predicted
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs.schema import (LEGACY_ALIASES, StatsDict,
                                    assert_conforms, check_key, normalize)
from repro_torch.obs.spans import SpanTracer
from repro_torch.obs.drift import DriftMonitor, DriftRecord, DriftReport
from repro_torch.obs import timeline

__all__ = [
    "ObsConfig", "Observability", "MetricsRegistry", "Counter", "Gauge",
    "Histogram", "SpanTracer", "DriftMonitor", "DriftRecord", "DriftReport",
    "StatsDict", "assert_conforms", "check_key", "normalize",
    "LEGACY_ALIASES", "timeline", "coerce_obs_config",
]


@dataclass
class ObsConfig:
    timeline: bool = True            # per-request lifecycle events
    spans: bool = True               # pipeline span tracer
    drift: bool = True               # perfmodel drift monitor
    span_ring: int = 65536           # max retained spans
    drift_warmup_steps: int = 2      # graph-capture steps excluded outright
    drift_calibration_steps: int = 20
    drift_tolerance: float = 0.5     # |rel residual| that flags a key


def coerce_obs_config(
        observability: Union[bool, ObsConfig, None]) -> Optional[ObsConfig]:
    """``False``/``None`` -> None (off); ``True`` -> defaults;
    an ObsConfig passes through."""
    if not observability:
        return None
    if observability is True:
        return ObsConfig()
    if isinstance(observability, ObsConfig):
        return observability
    raise TypeError("observability must be bool or ObsConfig, got "
                    f"{type(observability).__name__}")


class Observability:
    """Registry + tracer + drift monitor + the pre-bound serving
    histograms the engine's hot path observes into."""

    def __init__(self, cfg: Optional[ObsConfig] = None):
        self.cfg = cfg or ObsConfig()
        self.registry = MetricsRegistry()
        self.tracer: Optional[SpanTracer] = (
            SpanTracer(ring=self.cfg.span_ring) if self.cfg.spans else None)
        self.drift: Optional[DriftMonitor] = None   # engine wires this
        r = self.registry
        # serving-level latency histograms (seconds)
        self.ttft = r.histogram("ttft_s")
        self.queue_wait = r.histogram("queue_wait_s")
        self.inter_token = r.histogram("inter_token_s")
        self.e2e = r.histogram("e2e_s")
        # lifecycle counters
        self.submitted = r.counter("submitted_count")
        self.admitted = r.counter("admitted_count")
        self.finished = r.counter("finished_count")
        self.preempted = r.counter("preempted_count")
        self.migrated = r.counter("migrated_count")
        self.generated = r.counter("generated_tokens")
        self.prefix_hits = r.counter("prefix_hit_count")
        self.restores = r.counter("restored_count")
        # self-healing: faults detected / recoveries completed by the
        # step supervisor, plus time-to-recover per fault burst
        self.faults = r.counter("fault_count")
        self.recovered = r.counter("recovered_count")
        self.mttr = r.histogram("mttr_s")
        # speculative decoding: tokens the drafter proposed vs draft
        # tokens the verifier committed (their ratio is the measured
        # acceptance rate the perfmodel's spec_alpha should match)
        self.spec_drafted = r.counter("spec_drafted_tokens")
        self.spec_accepted = r.counter("spec_accepted_tokens")
