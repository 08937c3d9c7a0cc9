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
* :mod:`~lightgbmv1_tpu_torch.obs.agg` — per-process artifacts
  (``obs_dir`` / ``LGBMV1_OBS_DIR``) and crash bundles merged into one
  Perfetto trace with pid lanes, one snapshot and one event log, with a
  ``torch.profiler`` capture as the device lane.
* :mod:`~lightgbmv1_tpu_torch.obs.device` — the card's counterpart of
  the JAX ``obs/xla.py``: the ``profile_dir`` capture with its
  wall-clock anchor, device-memory gauges, and the kernels' launch and
  build gauges.
"""

from . import agg, device, drift, dump, events, metrics, model, trace
from .metrics import Registry, default_registry
from .trace import span

__all__ = ["agg", "device", "drift", "dump", "events", "metrics", "model",
           "trace", "Registry", "default_registry", "span"]
