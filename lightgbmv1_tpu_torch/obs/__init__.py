"""Observability: span tracing, one metrics registry, the event ring, the
crash-dump recorder and model-quality telemetry; the port's copy of
lightgbmv1_tpu/obs/.

* :mod:`~lightgbmv1_tpu_torch.obs.trace` — a nested-span tracer (off by
  default) with Chrome trace-event export; serving requests carry a
  trace id end to end.
* :mod:`~lightgbmv1_tpu_torch.obs.metrics` — counters, gauges and
  histograms with labels in one registry; JSON snapshots and Prometheus
  text.
* :mod:`~lightgbmv1_tpu_torch.obs.events` — an always-on bounded ring of
  structured events (warnings, fatals, fault injections, the serving
  failure domains).
* :mod:`~lightgbmv1_tpu_torch.obs.dump` — the crash-dump flight
  recorder: one validated forensic bundle a failure, under
  ``crash_dir``.
* :mod:`~lightgbmv1_tpu_torch.obs.model` — the training reference
  (bin occupancy, NaN rates, score distribution) and the trainer's
  quality telemetry.
* :mod:`~lightgbmv1_tpu_torch.obs.drift` — train/serve skew detection
  on sampled serving rows (``GET /drift``).

The JAX package's ``obs/agg.py`` (merging artifacts across processes)
and ``obs/xla.py`` (compile and device-memory accounting) are ROADMAP
queue 1 item 12's remaining part.
"""

from . import drift, dump, events, metrics, model, trace
from .metrics import Registry, default_registry
from .trace import span

__all__ = ["drift", "dump", "events", "metrics", "model", "trace",
           "Registry", "default_registry", "span"]
