"""Deadline-aware micro-batching server over the batched inference engine.

Port of lightgbmv1_tpu/serve/server.py's single-model core.  Requests
arrive one at a time from many threads, and the device engine
(models/predict.py) earns its keep only on batches, so a micro-batcher
sits in between with one explicit policy: a batch dispatches when it
FILLS ``max_batch_rows`` (device occupancy wins) or when its OLDEST
request has waited ``max_batch_delay_ms`` (p99 latency wins).

Admission control is a bounded queue priced in ROWS: a submit that would
push the backlog past ``queue_depth_rows`` is shed at once with
:class:`ServerOverloaded`.  All device work happens on the one
dispatcher thread; ``submit()`` is thread-safe and blocks its caller
until the rows come back, tagged with the model version that computed
them (registry.py holds the hot-swap contract).

Tenants, SLOs, drift detection, the watchdog, the circuit breaker,
tracing, HTTP, fleets and the router come with later slices.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..device import DeviceLike
from ..utils.log import log_info, log_warning
from .metrics import ServeMetrics
from .registry import ModelRegistry, ModelVersion


class ServeError(RuntimeError):
    """Base class of the serving-path failures."""


class ServerOverloaded(ServeError):
    """Admission control shed this request (bounded queue was full)."""


class RequestTimeout(ServeError):
    """The request's deadline expired while it sat in the queue."""


class ServerClosed(ServeError):
    """The server is shut down; no further requests are accepted."""


@dataclass
class ServeConfig:
    """Serving policy knobs (the ``serve_*`` names in config.py map onto
    them through :func:`serve_config_from`; defaults match)."""

    max_batch_rows: int = 1024          # bucket to fill before dispatch
    max_batch_delay_ms: float = 2.0     # oldest-request deadline budget
    queue_depth_rows: int = 4096        # admission bound (rows, not reqs)
    timeout_ms: float = 0.0             # per-request timeout; 0 = off
    f64_scores: bool = False            # exact f64 reconstruction per batch
    metrics_window: int = 8192
    retry_max: int = 2                  # transient batch errors retried
    retry_backoff_ms: float = 5.0       # exponential base between attempts
    probe_rows: int = 64                # publish golden-probe batch size
    keep_versions: int = 4              # registry history (rollback depth)
    predictor_kwargs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.max_batch_rows = max(int(self.max_batch_rows), 1)
        self.max_batch_delay_ms = max(float(self.max_batch_delay_ms), 0.0)
        self.queue_depth_rows = max(int(self.queue_depth_rows),
                                    self.max_batch_rows)
        self.timeout_ms = max(float(self.timeout_ms), 0.0)
        self.retry_max = max(int(self.retry_max), 0)
        self.retry_backoff_ms = max(float(self.retry_backoff_ms), 0.0)
        self.probe_rows = max(int(self.probe_rows), 0)
        self.keep_versions = max(int(self.keep_versions), 1)


@dataclass
class ServeResult:
    """One completed request: raw scores plus the serving provenance."""

    values: np.ndarray          # (n, K) raw scores
    version: str                # model-version tag that computed them
    latency_ms: float
    batch_rows: int = 0         # rows in the device batch that carried it
    queue_ms: float = 0.0       # enqueue -> batch collected
    walk_ms: float = 0.0        # device predict leg of the carrying batch


class _Request:
    __slots__ = ("rows", "n", "t_enq", "deadline", "event", "result",
                 "error")

    def __init__(self, rows: np.ndarray, deadline: Optional[float]):
        self.rows = rows
        self.n = rows.shape[0]
        self.t_enq = time.monotonic()
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Optional[ServeResult] = None
        self.error: Optional[BaseException] = None


class Server:
    """In-process serving front-end: thread-safe ``submit()``, versioned
    ``publish()``/``rollback()``, bounded queue, one dispatcher thread.
    Its predictors run on ``device`` (default: the card; raises when
    there is none)."""

    def __init__(self, model=None, config: Optional[ServeConfig] = None,
                 device: DeviceLike = None):
        self.config = config or ServeConfig()
        self.metrics = ServeMetrics(window=self.config.metrics_window)
        self.registry = ModelRegistry(
            metrics=self.metrics,
            predictor_kwargs=self.config.predictor_kwargs,
            history=self.config.keep_versions, device=device)
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._queue_rows = 0
        self._closed = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatcher", daemon=True)
        if model is not None:
            self.publish(model)
        self._dispatcher.start()

    # -- model lifecycle -------------------------------------------------
    def publish(self, model, **meta) -> str:
        """Build, warm and VALIDATE the new ensemble OFF the serving path,
        then atomically swap it in (registry.py).  A candidate that fails
        validation raises ``PublishValidationError`` and never serves."""
        return self.registry.publish(
            model, max_batch_rows=self.config.max_batch_rows,
            meta=meta or None, probe_rows=self.config.probe_rows)

    def rollback(self) -> str:
        return self.registry.rollback()

    def version(self) -> Optional[str]:
        return self.registry.current_tag()

    # -- request path ----------------------------------------------------
    def submit(self, rows, timeout_ms: Optional[float] = None) -> ServeResult:
        """Block until the rows are scored; raises
        :class:`ServerOverloaded` (queue full), :class:`RequestTimeout`
        (deadline expired in queue) or :class:`ServerClosed`."""
        mv = self.registry.current()          # raises before queueing when
        X = np.asarray(rows, np.float64)      # nothing is published yet
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.ndim != 2 or X.shape[1] != mv.num_features:
            raise ValueError(
                f"submit() rows have {X.shape[-1] if X.ndim else 0} "
                f"features; the serving model has {mv.num_features}")
        t_ms = self.config.timeout_ms if timeout_ms is None else timeout_ms
        deadline = (time.monotonic() + t_ms / 1e3) if t_ms > 0 else None
        req = _Request(X, deadline)
        with self._cond:
            if self._closed:
                raise ServerClosed("server is shut down")
            if self._queue_rows + req.n > self.config.queue_depth_rows:
                self.metrics.on_shed()
                raise ServerOverloaded(
                    f"queue full ({self._queue_rows} rows backlogged, "
                    f"depth {self.config.queue_depth_rows})")
            self._queue.append(req)
            self._queue_rows += req.n
            self.metrics.on_submit(req.n, self._queue_rows)
            self._cond.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def metrics_snapshot(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()
        snap["version"] = self.registry.current_tag()
        snap["versions"] = self.registry.versions()
        return snap

    def close(self) -> None:
        """Stop the dispatcher; pending requests fail with ServerClosed."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
            self._queue_rows = 0
            self._cond.notify_all()
        for req in pending:
            req.error = ServerClosed("server shut down with request queued")
            req.event.set()
        self._dispatcher.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher ------------------------------------------------------
    def _collect_batch(self) -> Optional[List[_Request]]:
        """Deadline-aware collection: return a batch when the pending rows
        fill ``max_batch_rows`` or the oldest request's delay budget is
        spent; otherwise keep waiting on the condition.

        The oldest request always rides; a later request that does not
        fit the batch keeps its queue order for the next collection while
        smaller requests behind it still fill the batch."""
        cfg = self.config
        delay_s = cfg.max_batch_delay_ms / 1e3
        with self._cond:
            while True:
                if self._closed:
                    return None
                if self._queue:
                    now = time.monotonic()
                    dispatch_at = self._queue[0].t_enq + delay_s
                    if (self._queue_rows >= cfg.max_batch_rows
                            or now >= dispatch_at):
                        batch: List[_Request] = []
                        keep: deque = deque()
                        rows = 0
                        while self._queue:
                            r = self._queue.popleft()
                            if not batch or rows + r.n <= cfg.max_batch_rows:
                                batch.append(r)
                                rows += r.n
                            else:
                                keep.append(r)
                        self._queue = keep
                        self._queue_rows -= rows
                        return batch
                    self._cond.wait(dispatch_at - now)
                else:
                    self._cond.wait(0.1)

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._collect_batch()
            if batch is None:
                return
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 — a poisoned batch must
                self._fail_batch(batch, e)     # fail ITS requests, never
                log_warning(f"serve: batch failed after retries "  # kill
                            f"({type(e).__name__}: {e})")  # the dispatcher

    def _fail_batch(self, batch: List[_Request], err: Exception) -> None:
        for req in batch:
            if not req.event.is_set():
                self.metrics.on_error()
                req.error = err
                req.event.set()

    def _predict_with_retry(self, bp, X: np.ndarray) -> np.ndarray:
        """Bounded retry with exponential backoff around the device batch:
        transient errors are retried ``retry_max`` times before the batch
        is failed."""
        cfg = self.config
        attempt = 0
        while True:
            try:
                return np.asarray(bp.predict_raw(X, f64_exact=cfg.f64_scores))
            except Exception as e:  # noqa: BLE001
                if attempt >= cfg.retry_max:
                    raise
                attempt += 1
                self.metrics.on_retry()
                log_warning(f"serve: batch attempt {attempt} failed "
                            f"({type(e).__name__}: {e}); retrying")
                time.sleep(cfg.retry_backoff_ms * (2 ** (attempt - 1)) / 1e3)

    def _run_batch(self, batch: List[_Request]) -> None:
        now = time.monotonic()
        live: List[_Request] = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                self.metrics.on_timeout()
                req.error = RequestTimeout(
                    f"deadline expired after "
                    f"{(now - req.t_enq) * 1e3:.1f} ms in queue")
                req.event.set()
            else:
                live.append(req)
        if not live:
            return
        mv: ModelVersion = self.registry.current()
        with self._cond:
            backlog = self._queue_rows
        X = (live[0].rows if len(live) == 1
             else np.concatenate([r.rows for r in live], axis=0))
        n = X.shape[0]
        t_collect = time.monotonic()
        out = self._predict_with_retry(mv.predictor, X)
        self.metrics.on_batch(n, mv.predictor.bucket_for(n), backlog)
        done = time.monotonic()
        walk_ms = (done - t_collect) * 1e3
        lo = 0
        for req in live:
            vals = out[lo: lo + req.n]
            lo += req.n
            lat_ms = (done - req.t_enq) * 1e3
            req.result = ServeResult(
                values=vals, version=mv.tag, latency_ms=lat_ms, batch_rows=n,
                queue_ms=max((t_collect - req.t_enq) * 1e3, 0.0),
                walk_ms=walk_ms)
            self.metrics.on_complete(lat_ms)
            req.event.set()


def serve_config_from(config) -> ServeConfig:
    """Map the global Config's ``serve_*``/``predict_*`` knobs onto a
    :class:`ServeConfig`."""
    return ServeConfig(
        max_batch_rows=config.serve_max_batch_rows,
        max_batch_delay_ms=config.serve_max_batch_delay_ms,
        queue_depth_rows=config.serve_queue_depth,
        timeout_ms=config.serve_timeout_ms,
        f64_scores=config.predict_f64_scores,
        retry_max=config.serve_retry_max,
        retry_backoff_ms=config.serve_retry_backoff_ms,
        probe_rows=config.serve_probe_rows,
        keep_versions=config.registry_keep_versions,
        predictor_kwargs={
            "bucket_min": config.predict_bucket_min,
            **({"method": config.predict_method}
               if config.predict_method in ("depthwise", "pallas", "fused",
                                            "scan") else {}),
            "code_layout": config.predict_code_layout,
        },
    )


def build_server(booster, config, device: DeviceLike = None) -> Server:
    """A :class:`Server` from a Booster + the global Config's ``serve_*``
    knobs."""
    sc = serve_config_from(config)
    server = Server(booster, config=sc, device=device)
    log_info(f"serve: model {server.version()} online "
             f"({booster.num_trees()} trees, "
             f"batch<= {sc.max_batch_rows} rows, "
             f"delay {sc.max_batch_delay_ms} ms, "
             f"queue {sc.queue_depth_rows} rows)")
    return server
