"""Serve metrics over the one obs registry; the port's copy of
lightgbmv1_tpu/serve/metrics.py.

Every serving counter and gauge and the latency histogram are metrics of
an :class:`lightgbmv1_tpu_torch.obs.metrics.Registry`, so ``GET
/metrics`` serves Prometheus text from the same store (serve/http.py)
while ``snapshot()`` keeps the JAX package's JSON keys.  Latency
quantiles are exact over the most recent ``window`` completions (the
histogram's raw-sample window, nearest rank: ``sorted[min(int(q * n),
n - 1)]``).  Each ``ServeMetrics`` has its own registry unless one is
passed (one registry a replica is the Prometheus model, and concurrent
test servers stay apart).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..obs.metrics import DEFAULT_MS_BUCKETS, Registry

_COUNTERS = (
    ("submitted", "serve_submitted_total", "Requests admitted to the queue"),
    ("completed", "serve_completed_total", "Requests answered"),
    ("shed", "serve_shed_total", "Requests shed by admission control"),
    ("timeouts", "serve_timeouts_total", "Requests expired in queue"),
    ("errors", "serve_errors_total", "Requests failed by batch errors"),
    ("degraded", "serve_degraded_total",
     "Requests answered by the truncated-tree overload predictor"),
    ("swaps", "serve_swaps_total", "Model version swaps (incl. rollbacks)"),
    ("rollbacks", "serve_rollbacks_total", "Registry rollbacks"),
    ("retries", "serve_retries_total", "Transient batch errors retried"),
    ("breaker_trips", "serve_breaker_trips_total",
     "Circuit-breaker auto-rollbacks"),
    ("watchdog_failures", "serve_watchdog_failures_total",
     "Requests failed by the stalled-batch watchdog"),
    ("dispatcher_restarts", "serve_dispatcher_restarts_total",
     "Dead dispatcher threads restarted"),
    ("publish_rejects", "serve_publish_rejects_total",
     "Candidate versions refused by publish validation"),
    ("batches", "serve_batches_total", "Device batches dispatched"),
    ("batch_rows", "serve_batch_rows_total",
     "Real rows across dispatched batches"),
    ("batch_capacity", "serve_batch_capacity_total",
     "Bucket capacity across dispatched batches"),
)


def _quantile(child, q: float) -> Optional[float]:
    return child.quantile(q)


class ServeMetrics:
    """Thread-safe serving telemetry over one obs Registry;
    ``snapshot()`` is the one JSON read surface (everything else is
    write-only on the hot path) and ``registry.prometheus_text()`` the
    exposition surface."""

    def __init__(self, window: int = 8192,
                 registry: Optional[Registry] = None):
        self.window = max(int(window), 16)
        self.registry = registry if registry is not None else Registry()
        self._c = {attr: self.registry.counter(name, help_text)
                   for attr, name, help_text in _COUNTERS}
        self._queue_depth = self.registry.gauge(
            "serve_queue_depth", "Backlogged rows at last submit/batch")
        self._queue_depth_max = self.registry.gauge(
            "serve_queue_depth_max", "High-water backlog (rows)")
        self._latency = self.registry.histogram(
            "serve_latency_ms", "End-to-end request latency (ms)",
            buckets=DEFAULT_MS_BUCKETS, sample_window=self.window)
        self._lock = threading.Lock()   # guards only the QPS timestamps
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- hot-path writers ------------------------------------------------
    def on_submit(self, n_rows: int, queue_depth: int) -> None:
        with self._lock:
            if self._t0 is None:
                self._t0 = time.monotonic()
        self._c["submitted"].inc()
        self._queue_depth.set(queue_depth)
        self._queue_depth_max.set_max(queue_depth)

    def on_shed(self) -> None:
        self._c["shed"].inc()

    def on_timeout(self) -> None:
        self._c["timeouts"].inc()

    def on_error(self) -> None:
        self._c["errors"].inc()

    def on_swap(self, rollback: bool = False) -> None:
        self._c["swaps"].inc()
        if rollback:
            self._c["rollbacks"].inc()

    def on_retry(self) -> None:
        self._c["retries"].inc()

    def on_breaker(self) -> None:
        self._c["breaker_trips"].inc()

    def on_watchdog(self, n: int = 1) -> None:
        self._c["watchdog_failures"].inc(n)

    def on_dispatcher_restart(self) -> None:
        self._c["dispatcher_restarts"].inc()

    def on_publish_reject(self) -> None:
        self._c["publish_rejects"].inc()

    def on_batch(self, rows: int, bucket: int, queue_depth: int) -> None:
        """One dispatched device batch: ``rows`` real rows padded into a
        ``bucket``-row launch (occupancy = rows / bucket)."""
        self._c["batches"].inc()
        self._c["batch_rows"].inc(rows)
        self._c["batch_capacity"].inc(max(bucket, 1))
        self._queue_depth.set(queue_depth)

    def on_complete(self, latency_ms: float, degraded: bool = False,
                    trace_id: str = "") -> None:
        with self._lock:
            self._t_last = time.monotonic()
        self._c["completed"].inc()
        if degraded:
            self._c["degraded"].inc()
        # the trace id rides as the bucket's worst-tail exemplar: the
        # slowest request in every latency bucket stays greppable from
        # the exposition and GET /slo
        self._latency.observe(
            latency_ms,
            exemplar={"trace_id": trace_id} if trace_id else None)

    def exemplars(self):
        """``[(le, exemplar_dict)]`` of the latency histogram's
        per-bucket worst-tail trace ids."""
        return self._latency.exemplars()

    def value(self, attr: str) -> int:
        """Point read of one counter (``dispatcher_restarts`` for
        /healthz) without building the whole snapshot."""
        return int(self._c[attr].get())

    # -- read surface ----------------------------------------------------
    def prometheus_text(self, exemplars: bool = False) -> str:
        return self.registry.prometheus_text(exemplars=exemplars)

    def snapshot(self) -> Dict[str, object]:
        """One JSON-able dict, with the JAX package's keys and value
        semantics."""
        v = {attr: int(c.get()) for attr, c in self._c.items()}
        lat = self._latency._solo()
        with self._lock:
            span = ((self._t_last - self._t0)
                    if self._t0 is not None and self._t_last is not None
                    and self._t_last > self._t0 else None)
        total = v["submitted"] + v["shed"]
        return {
            "submitted": v["submitted"],
            "completed": v["completed"],
            "shed": v["shed"],
            "timeouts": v["timeouts"],
            "errors": v["errors"],
            "degraded": v["degraded"],
            "swaps": v["swaps"],
            "rollbacks": v["rollbacks"],
            "retries": v["retries"],
            "breaker_trips": v["breaker_trips"],
            "watchdog_failures": v["watchdog_failures"],
            "dispatcher_restarts": v["dispatcher_restarts"],
            "publish_rejects": v["publish_rejects"],
            "batches": v["batches"],
            "qps": (round(v["completed"] / span, 2) if span else None),
            "p50_ms": _quantile(lat, 0.50),
            "p99_ms": _quantile(lat, 0.99),
            "p999_ms": _quantile(lat, 0.999),
            "batch_occupancy": (round(v["batch_rows"]
                                      / v["batch_capacity"], 4)
                                if v["batch_capacity"] else None),
            "mean_batch_rows": (round(v["batch_rows"] / v["batches"], 1)
                                if v["batches"] else None),
            "queue_depth": int(self._queue_depth.get()),
            "queue_depth_max": int(self._queue_depth_max.get()),
            "shed_frac": (round(v["shed"] / total, 4) if total else 0.0),
            "latency_window": lat.window_len(),
        }
