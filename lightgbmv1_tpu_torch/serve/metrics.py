"""Serve metrics: the counters and latency quantiles ``Server`` records.

Port of lightgbmv1_tpu/serve/metrics.py's ``ServeMetrics`` without the
Prometheus registry behind it (the obs layer comes with a later slice):
plain counters under one lock, and exact latency quantiles over the most
recent ``window`` completions (the JAX package's nearest-rank rule:
``sorted[min(int(q * n), n - 1)]``).  ``snapshot()`` keeps the JAX
package's key names for what it reports.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

_COUNTERS = ("submitted", "completed", "shed", "timeouts", "errors",
             "swaps", "rollbacks", "retries", "publish_rejects", "batches",
             "batch_rows", "batch_capacity")


class ServeMetrics:
    """Thread-safe serving telemetry; ``snapshot()`` is the read surface."""

    def __init__(self, window: int = 8192):
        self.window = max(int(window), 16)
        self._lock = threading.Lock()
        self._c = dict.fromkeys(_COUNTERS, 0)
        self._latency: deque = deque(maxlen=self.window)
        self._queue_depth = 0
        self._queue_depth_max = 0
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None

    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    # -- hot-path writers ------------------------------------------------
    def on_submit(self, n_rows: int, queue_depth: int) -> None:
        with self._lock:
            if self._t0 is None:
                self._t0 = time.monotonic()
            self._c["submitted"] += 1
            self._queue_depth = queue_depth
            self._queue_depth_max = max(self._queue_depth_max, queue_depth)

    def on_shed(self) -> None:
        self._inc("shed")

    def on_timeout(self) -> None:
        self._inc("timeouts")

    def on_error(self) -> None:
        self._inc("errors")

    def on_swap(self, rollback: bool = False) -> None:
        self._inc("swaps")
        if rollback:
            self._inc("rollbacks")

    def on_retry(self) -> None:
        self._inc("retries")

    def on_publish_reject(self) -> None:
        self._inc("publish_rejects")

    def on_batch(self, rows: int, bucket: int, queue_depth: int) -> None:
        """One dispatched device batch: ``rows`` real rows padded into a
        ``bucket``-row launch (occupancy = rows / bucket)."""
        with self._lock:
            self._c["batches"] += 1
            self._c["batch_rows"] += rows
            self._c["batch_capacity"] += max(bucket, 1)
            self._queue_depth = queue_depth

    def on_complete(self, latency_ms: float) -> None:
        with self._lock:
            self._t_last = time.monotonic()
            self._c["completed"] += 1
            self._latency.append(float(latency_ms))

    # -- read surface ----------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            v = dict(self._c)
            lat = sorted(self._latency)
            span = ((self._t_last - self._t0)
                    if self._t0 is not None and self._t_last is not None
                    and self._t_last > self._t0 else None)
            depth, depth_max = self._queue_depth, self._queue_depth_max

        def quantile(q):
            if not lat:
                return None
            return lat[min(int(q * len(lat)), len(lat) - 1)]

        total = v["submitted"] + v["shed"]
        return {
            "submitted": v["submitted"],
            "completed": v["completed"],
            "shed": v["shed"],
            "timeouts": v["timeouts"],
            "errors": v["errors"],
            "swaps": v["swaps"],
            "rollbacks": v["rollbacks"],
            "retries": v["retries"],
            "publish_rejects": v["publish_rejects"],
            "batches": v["batches"],
            "qps": (round(v["completed"] / span, 2) if span else None),
            "p50_ms": quantile(0.50),
            "p99_ms": quantile(0.99),
            "p999_ms": quantile(0.999),
            "batch_occupancy": (round(v["batch_rows"] / v["batch_capacity"],
                                      4) if v["batch_capacity"] else None),
            "mean_batch_rows": (round(v["batch_rows"] / v["batches"], 1)
                                if v["batches"] else None),
            "queue_depth": depth,
            "queue_depth_max": depth_max,
            "shed_frac": (round(v["shed"] / total, 4) if total else 0.0),
            "latency_window": len(lat),
        }
