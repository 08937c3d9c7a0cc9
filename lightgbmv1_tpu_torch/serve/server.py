"""Deadline-aware micro-batching server over the batched inference engine.

Port of lightgbmv1_tpu/serve/server.py.  Requests arrive one at a time
from many threads, and the device engine (models/predict.py) earns its
keep only on batches, so a micro-batcher sits in between with one
explicit policy: a batch dispatches when it FILLS ``max_batch_rows``
(device occupancy wins) or when its OLDEST request has waited
``max_batch_delay_ms`` (p99 latency wins).

Admission control is a bounded queue priced in ROWS: a submit that would
push the backlog past ``queue_depth_rows`` (or its tenant past its fair
share) is shed at once with :class:`ServerOverloaded`.  Past
``degrade_queue_frac`` of the queue the dispatcher answers from the
version's truncated-tree predictor (``degrade_trees``; the same kernels
over fewer trees) and flags the answer ``degraded``.

The server's failure domains: transient batch errors are retried with
backoff; ``breaker_failures`` consecutive failed batches roll the
failing tenant back to its previous version; with ``watchdog_ms`` a
watchdog thread fails the requests of a batch stalled past the deadline
(:class:`DispatcherStalled`, HTTP 503) and restarts a dead dispatcher
(its stranded requests fail with :class:`DispatcherDied`).  The fault
seams ``dispatch`` and ``replica_wedge`` (utils/faults.py) fire inside
the dispatcher.

Tenants: the default tenant ``""`` is the single-model server; named
tenants (``add_tenant``) each have their own registry, SLO tracker and
drift detector, and a batch holds one tenant's requests.  Every request
carries a trace id (the ``X-Trace-Id`` header's, or a fresh one); an
armed tracer (obs/trace.py) records each batch's span and each request's
queue and walk spans from host clocks, with no device synchronization
added (the batch's copy back to the host ends its walk).  SLO outcomes
(serve/slo.py) are recorded a tenant and server-wide; with
``drift_sample_rows > 0`` the dispatcher samples every
``drift_sample_stride``-th batch's rows for the active version's drift
detector (obs/drift.py).

All device work happens on the one dispatcher thread; ``submit()`` is
thread-safe and blocks its caller until the rows come back, tagged with
the model version that computed them (registry.py holds the hot-swap
contract).  Predictors run on ``device`` (default: the card; raises when
there is none).  A fleet of replicas behind a router is serve/fleet.py
and serve/router.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..device import DeviceLike
from ..obs import dump as obs_dump
from ..obs import events as obs_events
from ..obs import trace
from ..utils import faults
from ..utils.log import log_info, log_warning
from .metrics import ServeMetrics
from .registry import ModelRegistry, ModelVersion
from .slo import SLOConfig, SLOTracker


class ServeError(RuntimeError):
    """Base class of the serving-path failures."""


class ServerOverloaded(ServeError):
    """Admission control shed this request (bounded queue was full)."""


class RequestTimeout(ServeError):
    """The request's deadline expired while it sat in the queue."""


class ServerClosed(ServeError):
    """The server is shut down; no further requests are accepted."""


class DispatcherStalled(ServeError):
    """The watchdog declared the in-flight device batch stalled (or the
    dispatcher thread dead) and failed this request instead of letting
    it hang the queue.  HTTP maps it to 503 — the client should retry
    against another replica."""


class DispatcherDied(ServeError):
    """The dispatcher thread exited with this request in flight; the
    watchdog restarts the dispatcher and fails the stranded requests."""


class UnknownTenant(ServeError):
    """The request named a tenant this server does not host.  HTTP maps
    it to 404 — an unknown lineage is a client addressing error, not an
    overload or a server fault."""


# the default tenant: the single-model contract every pre-tenancy caller
# uses.  Its registry/SLO ARE the server's top-level ``registry``/``slo``
# attributes, so solo deployments behave bit-identically.
DEFAULT_TENANT = ""


def _tenant_label(name: str) -> str:
    """Prometheus label value for a tenant ("" reads as 'default')."""
    return name or "default"


@dataclass
class ServeConfig:
    """Serving policy knobs (mirrored by the ``serve_*`` names in
    config.py for the CLI path; defaults match)."""

    max_batch_rows: int = 1024          # bucket to fill before dispatch
    max_batch_delay_ms: float = 2.0     # oldest-request deadline budget
    queue_depth_rows: int = 4096        # admission bound (rows, not reqs)
    timeout_ms: float = 0.0             # per-request timeout; 0 = off
    degrade_trees: int = 0              # truncated-tree overload predictor
    degrade_queue_frac: float = 0.5     # backlog fraction that triggers it
    f64_scores: bool = False            # exact f64 reconstruction per batch
    metrics_window: int = 8192
    # -- failure domains ------------------------------------------------
    retry_max: int = 2                  # transient batch errors retried
    retry_backoff_ms: float = 5.0       # exponential base between attempts
    breaker_failures: int = 3           # consecutive failed batches that
                                        # auto-roll back a bad publish
                                        # (0 = breaker off)
    watchdog_ms: float = 0.0            # stalled-batch deadline; 0 = off
    probe_rows: int = 64                # publish golden-probe batch size
                                        # (0 = structural checks only)
    # -- SLOs (serve/slo.py): always-on burn-rate tracking ---------------
    slo: Optional[SLOConfig] = None     # None = default SLOConfig()
    # -- train/serve skew detection (obs/drift.py) -----------------------
    # HARD-OFF default: drift_sample_rows=0 keeps the serving path at
    # one integer compare.  Armed, the dispatcher copies at most
    # drift_per_batch_rows rows per device batch into a bounded ring;
    # GET /drift re-bins the window through the active version's own
    # mappers (ModelVersion.meta["model_reference"]) and judges PSI
    drift_sample_rows: int = 0
    drift_per_batch_rows: int = 64
    drift_min_rows: int = 256
    drift_psi_threshold: float = 0.25
    drift_top_k: int = 8
    drift_psi_groups: int = 16
    drift_sample_stride: int = 4    # sample every Nth device batch
    # -- registry history bound: current + last N versions retained per
    # registry; rollback depth == keep_versions
    keep_versions: int = 4
    # BatchPredictor options; on the card the walk defaults to
    # method="fused" (K4), on the CPU to the JAX package's depthwise
    predictor_kwargs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.max_batch_rows = max(int(self.max_batch_rows), 1)
        self.max_batch_delay_ms = max(float(self.max_batch_delay_ms), 0.0)
        self.queue_depth_rows = max(int(self.queue_depth_rows),
                                    self.max_batch_rows)
        self.timeout_ms = max(float(self.timeout_ms), 0.0)
        self.degrade_trees = max(int(self.degrade_trees), 0)
        self.degrade_queue_frac = min(max(
            float(self.degrade_queue_frac), 0.0), 1.0)
        self.retry_max = max(int(self.retry_max), 0)
        self.retry_backoff_ms = max(float(self.retry_backoff_ms), 0.0)
        self.breaker_failures = max(int(self.breaker_failures), 0)
        self.watchdog_ms = max(float(self.watchdog_ms), 0.0)
        self.probe_rows = max(int(self.probe_rows), 0)
        self.drift_sample_rows = max(int(self.drift_sample_rows), 0)
        self.drift_per_batch_rows = max(int(self.drift_per_batch_rows), 1)
        self.drift_min_rows = max(int(self.drift_min_rows), 1)
        self.drift_psi_threshold = max(float(self.drift_psi_threshold),
                                       1e-9)
        self.drift_top_k = max(int(self.drift_top_k), 1)
        self.drift_psi_groups = max(int(self.drift_psi_groups), 2)
        self.drift_sample_stride = max(int(self.drift_sample_stride), 1)
        self.keep_versions = max(int(self.keep_versions), 1)
        if self.slo is None:
            self.slo = SLOConfig()


@dataclass
class ServeResult:
    """One completed request: raw scores plus the serving provenance."""

    values: np.ndarray          # (n, K) raw scores
    version: str                # model-version tag that computed them
    latency_ms: float
    degraded: bool = False
    batch_rows: int = 0         # rows in the device batch that carried it
    trace_id: str = ""          # propagated end-to-end (X-Trace-Id)
    queue_ms: float = 0.0       # enqueue -> batch collected
    walk_ms: float = 0.0        # device predict leg of the carrying batch


class _Request:
    __slots__ = ("rows", "n", "t_enq", "deadline", "event", "result",
                 "error", "trace_id", "state")

    def __init__(self, rows: np.ndarray, deadline: Optional[float],
                 trace_id: Optional[str] = None, state=None):
        self.rows = rows
        self.n = rows.shape[0]
        self.t_enq = time.monotonic()
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Optional[ServeResult] = None
        self.error: Optional[BaseException] = None
        # every request carries a trace id whether or not the tracer is
        # armed — the X-Trace-Id echo and the latency decomposition in
        # ServeResult are always-on; only SPAN RECORDING is gated
        self.trace_id = trace_id or trace.new_trace_id()
        # the tenant state that owns this request (_TenantState) —
        # batches are single-tenant, so the dispatcher reads the model,
        # SLO tracker and drift detector off the request, never a global
        self.state = state


class _TenantState:
    """One hosted model lineage: its own registry (versioning/rollback),
    SLO tracker, drift detector anchor, and queue-row accounting for
    fair-share admission.  The DEFAULT tenant ("") aliases the server's
    top-level ``registry``/``slo`` so single-model callers see exactly
    the pre-tenancy object graph."""

    __slots__ = ("name", "registry", "slo", "weight", "queue_rows",
                 "share_rows", "drift", "drift_tag",
                 "submitted", "completed", "shed", "errors")

    def __init__(self, name: str, registry: ModelRegistry,
                 slo: SLOTracker, weight: float = 1.0):
        self.name = name
        self.registry = registry
        self.slo = slo
        self.weight = max(float(weight), 0.0)
        self.queue_rows = 0
        self.share_rows = 0         # fair-share admission cap (rows)
        self.drift = None
        self.drift_tag: Optional[str] = None
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.errors = 0


class Server:
    """In-process serving front-end: thread-safe ``submit()``, versioned
    ``publish()``/``rollback()``, bounded queue, one dispatcher thread.
    Its predictors run on ``device`` (default: the card; raises when
    there is none)."""

    def __init__(self, model=None, config: Optional[ServeConfig] = None,
                 registry: Optional[ModelRegistry] = None,
                 name: str = "", device: DeviceLike = None):
        self.config = config or ServeConfig()
        self.name = str(name)       # the server's name ("" solo)
        self._t_start = time.monotonic()
        self._last_wedge_unix: Optional[float] = None
        self.metrics = ServeMetrics(window=self.config.metrics_window)
        # always-on SLO burn-rate tracking (serve/slo.py): every
        # completed / shed / timed-out / failed request spends or
        # preserves error budget; GET /slo reads the evaluation
        self.slo = SLOTracker(self.config.slo)
        self.registry = registry or ModelRegistry(
            metrics=self.metrics,
            predictor_kwargs=self.config.predictor_kwargs,
            name=self.name, history=self.config.keep_versions,
            device=device)
        self.device = self.registry.device
        # tenant table: the default tenant "" aliases the top-level
        # registry/slo; add_tenant() grows named lineages.  Per-tenant
        # request outcomes ride one labeled counter (the obs registry's
        # cardinality cap collapses a tenant explosion into _overflow)
        self._tenants: Dict[str, _TenantState] = {
            DEFAULT_TENANT: _TenantState(DEFAULT_TENANT, self.registry,
                                         self.slo)}
        self._recompute_shares()
        self._tenant_requests = self.metrics.registry.counter(
            "serve_tenant_requests_total",
            "Per-tenant request outcomes",
            label_names=("tenant", "outcome"))
        self._tenant_queue_gauge = self.metrics.registry.gauge(
            "serve_tenant_queue_rows", "Backlogged rows per tenant",
            label_names=("tenant",))
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._queue_rows = 0
        self._closed = False
        # failure-domain state: the in-flight batch the watchdog observes
        # ((t_start, requests) or None), and the consecutive-failure
        # count feeding the circuit breaker
        self._inflight: Optional[tuple] = None
        self._consec_failures = 0
        # train/serve skew detection (obs/drift.py): built lazily per
        # ACTIVE version on the dispatcher thread, so publish/rollback/
        # breaker swaps re-anchor the detector to the new version's own
        # reference automatically; None until armed AND a version with
        # a model_reference serves a batch
        self._drift = None
        self._drift_tag: Optional[str] = None
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatcher", daemon=True)
        # a forensic bundle dumped while this replica lives should carry
        # its per-replica metrics next to the process-wide registry
        obs_dump.add_metrics_source(f"server-{id(self):x}",
                                    self.metrics_snapshot)
        if model is not None:
            self.publish(model)
        self._dispatcher.start()
        self._watchdog: Optional[threading.Thread] = None
        if self.config.watchdog_ms > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="serve-watchdog",
                daemon=True)
            self._watchdog.start()

    # -- tenant lifecycle -----------------------------------------------
    def _recompute_shares(self) -> None:
        """Fair-share admission caps: each tenant owns
        ``queue_depth_rows * weight / total_weight`` backlog rows
        (floored at one full batch so every tenant can always make
        progress).  A single-tenant server's cap equals the full queue
        depth — pre-tenancy admission behavior bit-identically."""
        depth = self.config.queue_depth_rows
        states = list(self._tenants.values())
        total_w = sum(st.weight for st in states) or 1.0
        if len(states) == 1:
            states[0].share_rows = depth
            return
        for st in states:
            st.share_rows = max(int(depth * st.weight / total_w),
                                self.config.max_batch_rows)

    def add_tenant(self, name: str, *, weight: float = 1.0,
                   slo: Optional[SLOConfig] = None,
                   predictor_kwargs: Optional[Dict[str, Any]] = None
                   ) -> "_TenantState":
        """Register a named model lineage: its own registry (named
        ``replica:tenant`` so chaos plans and warm events are tenant-
        addressable), its own SLO tracker, and a fair-share weight.
        Idempotent on re-add (weight is updated)."""
        if not name:
            raise ValueError("tenant name must be non-empty (the default "
                             "tenant exists already)")
        with self._cond:
            st = self._tenants.get(name)
            if st is not None:
                st.weight = max(float(weight), 0.0)
                self._recompute_shares()
                return st
            pk = dict(self.config.predictor_kwargs)
            pk.update(predictor_kwargs or {})
            reg = ModelRegistry(
                metrics=self.metrics, predictor_kwargs=pk,
                name=(f"{self.name}:{name}" if self.name else name),
                history=self.config.keep_versions, device=self.device)
            st = _TenantState(
                name, reg, SLOTracker(slo or self.config.slo),
                weight=weight)
            self._tenants[name] = st
            self._recompute_shares()
        obs_events.publish("serve.tenant_added",
                           f"tenant {name} registered",
                           tenant=name, weight=st.weight,
                           replica=self.name or "")
        return st

    def remove_tenant(self, name: str) -> None:
        """Drop a named lineage (pending requests for it fail at their
        next dispatch with UnknownTenant; queued rows are released)."""
        if not name:
            raise ValueError("cannot remove the default tenant")
        with self._cond:
            st = self._tenants.pop(name, None)
            if st is None:
                raise UnknownTenant(f"no tenant {name!r}")
            stranded = [r for r in self._queue if r.state is st]
            for r in stranded:
                self._queue.remove(r)
            self._queue_rows -= sum(r.n for r in stranded)
            self._recompute_shares()
        for r in stranded:
            r.error = UnknownTenant(f"tenant {name!r} removed")
            r.event.set()
        obs_events.publish("serve.tenant_removed",
                           f"tenant {name} dropped", tenant=name,
                           replica=self.name or "")

    def tenant_names(self) -> List[str]:
        with self._cond:
            return sorted(self._tenants)

    def _tenant_state(self, tenant: str) -> "_TenantState":
        st = self._tenants.get(tenant)
        if st is None:
            raise UnknownTenant(
                f"no tenant {tenant!r} on this server "
                f"(hosted: {sorted(self._tenants) or ['<default>']})")
        return st

    def tenant_registry(self, tenant: str = DEFAULT_TENANT
                        ) -> ModelRegistry:
        """The named tenant's registry (fleet.py's two-phase publish
        drives prepare/commit on it directly)."""
        return self._tenant_state(tenant).registry

    def _slo_record(self, st: "_TenantState", ok: bool,
                    latency_ms: Optional[float] = None,
                    trace_id: str = "") -> None:
        """Record into the tenant's SLO tracker AND the server-wide one
        (the default tenant's tracker IS the server-wide tracker — never
        double-counted)."""
        st.slo.record(ok, latency_ms=latency_ms, trace_id=trace_id)
        if st.slo is not self.slo:
            self.slo.record(ok, latency_ms=latency_ms, trace_id=trace_id)

    def _tenant_outcome(self, st: "_TenantState", outcome: str) -> None:
        self._tenant_requests.labels(
            tenant=_tenant_label(st.name), outcome=outcome).inc()

    # -- model lifecycle -------------------------------------------------
    def publish(self, model, tenant: str = DEFAULT_TENANT, **meta) -> str:
        """Prebin/stack/warm/VALIDATE the new ensemble OFF the serving
        path, then atomically swap it in (registry.py).  In-flight
        batches finish on the old version; the tag is echoed in every
        response.  A candidate that fails validation (structural, finite,
        or golden-probe — see registry.publish) raises
        ``PublishValidationError`` and never serves a single answer.
        ``tenant`` publishes into that lineage's registry — other
        tenants' active versions are untouchable by construction (their
        registries are separate objects)."""
        return self._tenant_state(tenant).registry.publish(
            model, degrade_trees=self.config.degrade_trees,
            max_batch_rows=self.config.max_batch_rows, meta=meta or None,
            probe_rows=self.config.probe_rows)

    def rollback(self, tenant: str = DEFAULT_TENANT) -> str:
        return self._tenant_state(tenant).registry.rollback()

    def version(self, tenant: str = DEFAULT_TENANT) -> Optional[str]:
        return self._tenant_state(tenant).registry.current_tag()

    # -- request path ----------------------------------------------------
    def submit(self, rows, timeout_ms: Optional[float] = None,
               trace_id: Optional[str] = None,
               tenant: str = DEFAULT_TENANT) -> ServeResult:
        """Block until the rows are scored; raises
        :class:`ServerOverloaded` (queue full), :class:`RequestTimeout`
        (deadline expired in queue), :class:`ServerClosed`, or
        :class:`UnknownTenant`.  ``trace_id`` (e.g. an inbound
        ``X-Trace-Id`` header) is carried through queue -> batch -> walk
        and echoed in the result; one is minted when absent.

        Fair-share admission: a tenant's backlog is capped at ITS share
        of the queue (``_recompute_shares``) before the global depth is
        even consulted — an overloaded tenant sheds its OWN traffic
        first, and a well-behaved tenant's admission headroom is
        untouched by a noisy neighbor."""
        st = self._tenant_state(tenant)
        mv = st.registry.current()            # raises before queueing when
        X = np.asarray(rows, np.float64)      # nothing is published yet
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.ndim != 2 or X.shape[1] != mv.num_features:
            raise ValueError(
                f"submit() rows have {X.shape[-1] if X.ndim else 0} "
                f"features; the serving model has {mv.num_features}")
        t_ms = self.config.timeout_ms if timeout_ms is None else timeout_ms
        deadline = (time.monotonic() + t_ms / 1e3) if t_ms > 0 else None
        req = _Request(X, deadline, trace_id, state=st)
        with self._cond:
            if self._closed:
                raise ServerClosed("server is shut down")
            over_share = st.queue_rows + req.n > st.share_rows
            over_depth = (self._queue_rows + req.n
                          > self.config.queue_depth_rows)
            if over_share or over_depth:
                self.metrics.on_shed()
                st.shed += 1
                self._tenant_outcome(st, "shed")
                self._slo_record(st, False, trace_id=req.trace_id)
                obs_events.publish(
                    "serve.shed",
                    ("tenant over fair share" if over_share
                     else "admission queue full"),
                    severity="warning", rows=req.n,
                    backlog=self._queue_rows,
                    tenant=_tenant_label(st.name),
                    tenant_backlog=st.queue_rows,
                    trace_id=req.trace_id)
                raise ServerOverloaded(
                    f"queue full for tenant "
                    f"{_tenant_label(st.name)!r} ({st.queue_rows} of "
                    f"{st.share_rows} fair-share rows backlogged; "
                    f"{self._queue_rows} server-wide, depth "
                    f"{self.config.queue_depth_rows})")
            self._queue.append(req)
            self._queue_rows += req.n
            st.queue_rows += req.n
            st.submitted += 1
            self._tenant_queue_gauge.labels(
                tenant=_tenant_label(st.name)).set(st.queue_rows)
            self.metrics.on_submit(req.n, self._queue_rows)
            self._cond.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        assert req.result is not None
        return req.result

    def metrics_snapshot(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()
        snap["version"] = self.registry.current_tag()
        snap["versions"] = self.registry.versions()
        return snap

    def slo_snapshot(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """The ``GET /slo`` payload: burn-rate evaluation + per-bucket
        worst-tail exemplar trace ids from the latency histogram, so an
        alerting burn rate hands the operator the request ids to grep
        in an armed trace.  ``tenant`` scopes the evaluation to that
        lineage's own tracker (``GET /slo?tenant=``)."""
        if tenant is None:
            out = self.slo.snapshot()
            out["version"] = self.registry.current_tag()
            out["exemplars"] = [
                {"le": le, **ex} for le, ex in self.metrics.exemplars()]
            return out
        st = self._tenant_state(tenant)
        out = st.slo.snapshot()
        out["tenant"] = _tenant_label(st.name)
        out["version"] = st.registry.current_tag()
        return out

    def tenants_snapshot(self) -> Dict[str, Any]:
        """The ``GET /tenants`` payload: every hosted lineage's version
        lineage, fair-share position, queue occupancy, request outcomes
        and SLO alert state."""
        with self._cond:
            states = list(self._tenants.values())
        tenants = {}
        for st in states:
            ev = st.slo.evaluate()
            alerts = ev.get("alerts", {})
            burn = max(
                ev["availability"]["windows"]["fast"]["burn_rate"],
                ev["latency"]["windows"]["fast"]["burn_rate"])
            tenants[_tenant_label(st.name)] = {
                "version": st.registry.current_tag(),
                "versions": st.registry.versions(),
                "weight": st.weight,
                "share_rows": st.share_rows,
                "queue_rows": st.queue_rows,
                "occupancy": (round(st.queue_rows / st.share_rows, 4)
                              if st.share_rows else 0.0),
                "submitted": st.submitted,
                "completed": st.completed,
                "shed": st.shed,
                "errors": st.errors,
                "slo_page": bool(alerts.get("availability_page")
                                 or alerts.get("latency_page")),
                "slo_warn": bool(alerts.get("availability_warn")
                                 or alerts.get("latency_warn")),
                "burn_rate": burn,
            }
        return {"replica": self.name or "", "tenants": tenants}

    # -- train/serve skew detection (obs/drift.py) -----------------------
    def _drift_for(self, st: "_TenantState", mv: ModelVersion):
        """The tenant's active-version DriftDetector (dispatcher thread
        only): rebuilt when the served tag changes — publish, rollback
        and breaker swaps RE-ANCHOR the detector to the new version's
        own reference automatically, per tenant.  A version published
        without a ``model_reference`` disables detection until the next
        version that carries one."""
        if st.drift_tag == mv.tag:
            return st.drift
        ref = mv.meta.get("model_reference")
        det = None
        if ref is not None:
            from ..obs.drift import DriftConfig, DriftDetector

            cfg = self.config
            det = DriftDetector(
                ref,
                DriftConfig(sample_rows=cfg.drift_sample_rows,
                            per_batch_rows=cfg.drift_per_batch_rows,
                            min_rows=cfg.drift_min_rows,
                            psi_threshold=cfg.drift_psi_threshold,
                            top_k=cfg.drift_top_k,
                            psi_groups=cfg.drift_psi_groups,
                            sample_stride=cfg.drift_sample_stride),
                registry=self.metrics.registry,
                version_tag=(f"{_tenant_label(st.name)}:{mv.tag}"
                             if st.name else mv.tag))
        st.drift = det
        st.drift_tag = mv.tag
        return det

    def drift_snapshot(self, tenant: Optional[str] = None
                       ) -> Dict[str, Any]:
        """The ``GET /drift`` payload: arming state + the active
        detector's evaluation (per-feature PSI top-K, skew counters,
        score drift) — or the reason there is nothing to judge.
        ``tenant`` scopes to that lineage's own detector
        (``GET /drift?tenant=``); default = the default tenant."""
        st = self._tenant_state(DEFAULT_TENANT if tenant is None
                                else tenant)
        out: Dict[str, Any] = {
            "armed": self.config.drift_sample_rows > 0,
            "version": st.registry.current_tag(),
        }
        if tenant is not None:
            out["tenant"] = _tenant_label(st.name)
        det = st.drift
        if not out["armed"]:
            out["reason"] = "drift_sample_rows=0 (sampling off)"
        elif det is None:
            out["reason"] = ("no model_reference published yet"
                             if out["version"] is not None
                             else "no model published yet")
        else:
            out.update(det.snapshot())
        return out

    def dispatcher_alive(self) -> bool:
        return self._dispatcher.is_alive() and not self._closed

    def uptime_s(self) -> float:
        return time.monotonic() - self._t_start

    def wedged(self) -> bool:
        """True while an in-flight device batch has exceeded the
        watchdog deadline — the dispatcher thread is alive but stuck,
        the state a load balancer must eject on even though the process
        answers health checks."""
        if self.config.watchdog_ms <= 0:
            return False
        infl = self._inflight
        return (infl is not None
                and (time.monotonic() - infl[0])
                > self.config.watchdog_ms / 1e3)

    def health(self) -> Dict[str, Any]:
        """Liveness the /healthz endpoint reports: a wedged or dead
        dispatcher and an empty registry are NOT healthy, even though
        the process is up.  ``version`` stays the ACTIVE MODEL tag (the
        pre-obs contract every client reads); ``server_version`` is the
        package build and ``uptime_s`` the replica age.

        ``dispatcher_restarts`` counts watchdog-revived dispatcher
        threads, ``last_wedge_unix`` stamps the most recent
        watchdog-declared stall, and ``wedged`` flags a CURRENTLY-stuck
        in-flight batch — ``ok`` is False while wedged, so a stuck
        replica falls out of its load balancer before its queue
        backs up."""
        from .. import __version__

        alive = self.dispatcher_alive()
        wedged = self.wedged()
        tag = self.registry.current_tag()
        return {"ok": bool(alive and tag is not None and not wedged),
                "version": tag,
                "dispatcher_alive": alive, "published": tag is not None,
                "wedged": wedged,
                "dispatcher_restarts": self.metrics.value(
                    "dispatcher_restarts"),
                "last_wedge_unix": self._last_wedge_unix,
                "name": self.name,
                "server_version": __version__,
                "uptime_s": round(self.uptime_s(), 3)}

    def close(self) -> None:
        """Stop the dispatcher; pending requests fail with ServerClosed."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
            self._queue_rows = 0
            for st in self._tenants.values():
                st.queue_rows = 0
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

        Batches are SINGLE-TENANT: the oldest request's tenant defines
        the batch and only that tenant's requests ride it (they share one
        model version and one SLO domain); other tenants' requests keep
        their queue order for the next collection.  A solo-tenant server
        collects exactly as before."""
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
                        st = self._queue[0].state
                        batch: List[_Request] = []
                        keep: deque = deque()
                        rows = 0
                        while self._queue:
                            r = self._queue.popleft()
                            if r.state is st and (
                                    not batch
                                    or rows + r.n <= cfg.max_batch_rows):
                                batch.append(r)
                                rows += r.n
                            else:
                                keep.append(r)
                        self._queue = keep
                        self._queue_rows -= rows
                        if st is not None:
                            st.queue_rows = max(st.queue_rows - rows, 0)
                            self._tenant_queue_gauge.labels(
                                tenant=_tenant_label(st.name)).set(
                                    st.queue_rows)
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
                self._consec_failures = 0
            except faults.ThreadKilled as e:
                # injected dispatcher death: fail this batch's requests
                # and let the thread die — the watchdog notices the
                # corpse and restarts (the recovery under test)
                self._fail_batch(batch, DispatcherDied(str(e)))
                log_warning("serve: dispatcher thread died "
                            f"({e}); watchdog will restart")
                return
            except BaseException as e:  # noqa: BLE001 — a poisoned batch
                # must fail ITS requests, never kill the dispatcher.
                # Breaker accounting runs BEFORE the requests are woken:
                # a client that saw its submit fail must also see the
                # breaker state that failure produced (the old order
                # raced clients against the trip)
                self._consec_failures += 1
                self._maybe_trip_breaker(
                    batch[0].state if batch else None)
                self._fail_batch(batch, e)
                log_warning(f"serve: batch failed after retries "
                            f"({type(e).__name__}: {e})")

    def _fail_batch(self, batch: List[_Request], err: BaseException) -> None:
        n_failed = 0
        for req in batch:
            if not req.event.is_set():
                self.metrics.on_error()
                st = req.state or self._tenants[DEFAULT_TENANT]
                st.errors += 1
                self._tenant_outcome(st, "error")
                self._slo_record(st, False, trace_id=req.trace_id)
                req.error = (err if isinstance(err, Exception)
                             else ServeError(str(err)))
                req.event.set()
                n_failed += 1
        if n_failed:
            obs_events.publish(
                "serve.batch_failed",
                f"{type(err).__name__}: {err}", severity="error",
                requests=n_failed)

    def _maybe_trip_breaker(self, st: Optional["_TenantState"] = None
                            ) -> None:
        """Circuit breaker: ``breaker_failures`` CONSECUTIVE failed
        batches auto-roll the registry back to the previous version — a
        bad publish that slipped past validation (or a version whose
        executables started failing) un-ships itself instead of failing
        every batch forever.  Batches are single-tenant, so the
        rollback targets the FAILING tenant's registry — a bad tenant
        publish un-ships itself without touching its neighbors."""
        bf = self.config.breaker_failures
        if bf <= 0 or self._consec_failures < bf:
            return
        self._consec_failures = 0
        registry = (st or self._tenants[DEFAULT_TENANT]).registry
        try:
            tag = registry.rollback()
        except Exception as e:  # noqa: BLE001 — nothing to roll back to
            obs_events.publish(
                "serve.breaker_trip", "no previous version to roll "
                "back to", severity="error", failures=bf)
            log_warning(f"serve: circuit breaker tripped with no "
                        f"previous version to roll back to ({e})")
            return
        self.metrics.on_breaker()
        obs_events.publish(
            "serve.breaker_trip", f"auto-rolled back to {tag}",
            severity="error", failures=bf, rolled_back_to=tag)
        log_warning(f"serve: circuit breaker tripped after {bf} "
                    f"consecutive batch failures — rolled back to {tag}")

    def _predict_with_retry(self, bp, X: np.ndarray) -> np.ndarray:
        """Bounded retry with exponential backoff around the device
        batch: transient errors (a failed H2D, a flaky dispatch) are
        retried ``retry_max`` times before the batch is failed."""
        cfg = self.config
        attempt = 0
        while True:
            try:
                # chaos seam: injected dispatch faults land inside the
                # retried region, exactly like a real transient error
                faults.fire("dispatch", site="batch")
                return np.asarray(bp.predict_raw(
                    X, f64_exact=cfg.f64_scores))
            except faults.ThreadKilled:
                raise
            except Exception as e:  # noqa: BLE001
                if attempt >= cfg.retry_max:
                    raise
                attempt += 1
                self.metrics.on_retry()
                log_warning(f"serve: batch attempt {attempt} failed "
                            f"({type(e).__name__}: {e}); retrying")
                time.sleep(cfg.retry_backoff_ms * (2 ** (attempt - 1))
                           / 1e3)

    def _run_batch(self, batch: List[_Request]) -> None:
        now = time.monotonic()
        st = (batch[0].state if batch and batch[0].state is not None
              else self._tenants[DEFAULT_TENANT])
        live: List[_Request] = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                self.metrics.on_timeout()
                self._tenant_outcome(st, "timeout")
                self._slo_record(st, False, trace_id=req.trace_id)
                req.error = RequestTimeout(
                    f"deadline expired after "
                    f"{(now - req.t_enq) * 1e3:.1f} ms in queue")
                req.event.set()
            else:
                live.append(req)
        if not live:
            return
        mv: ModelVersion = st.registry.current()
        with self._cond:
            backlog = self._queue_rows
        degraded = (mv.degraded is not None
                    and backlog >= self.config.degrade_queue_frac
                    * self.config.queue_depth_rows)
        bp = mv.degraded if degraded else mv.predictor
        X = (live[0].rows if len(live) == 1
             else np.concatenate([r.rows for r in live], axis=0))
        n = X.shape[0]
        t_collect = time.monotonic()
        walk_t0_ns = trace.now_ns() if trace.enabled() else 0
        self._inflight = (time.monotonic(), live)
        try:
            # chaos seam: replica_wedge stalls THIS replica's dispatcher
            # with the batch in flight — the watchdog (and a load balancer's
            # health checks) see exactly what a stuck device produces
            faults.fire("replica_wedge", site=self.name or "server")
            out = self._predict_with_retry(bp, X)
        finally:
            self._inflight = None
        self.metrics.on_batch(n, bp.bucket_for(n), backlog)
        if self.config.drift_sample_rows > 0:
            # armed skew sampling (one strided row copy every
            # drift_sample_stride-th batch); disarmed cost is this one
            # compare
            det = self._drift_for(st, mv)
            if det is not None:
                try:
                    det.offer(X, np.asarray(out))
                except Exception as e:  # noqa: BLE001 — telemetry must
                    log_warning(f"serve: drift sampling failed "
                                f"({type(e).__name__}: {e})")  # never
                    st.drift = None                            # fail a
                    st.drift_tag = mv.tag                      # batch
        done = time.monotonic()
        walk_ms = (done - t_collect) * 1e3
        if trace.enabled():
            # one batch span + per-request queue/walk spans, every one
            # carrying its propagated trace id — a p999 outlier in the
            # export decomposes by grepping its X-Trace-Id
            walk_dur_ns = trace.now_ns() - walk_t0_ns
            trace.add_span("serve.batch", walk_t0_ns, walk_dur_ns,
                           cat="serve",
                           args={"rows": n, "version": mv.tag,
                                 "degraded": degraded,
                                 "requests": len(live)})
            for req in live:
                q_ns = int(max(t_collect - req.t_enq, 0.0) * 1e9)
                trace.add_span("serve.queue", walk_t0_ns - q_ns, q_ns,
                               cat="serve",
                               args={"trace_id": req.trace_id})
                trace.add_span("serve.walk", walk_t0_ns, walk_dur_ns,
                               cat="serve",
                               args={"trace_id": req.trace_id,
                                     "batch_rows": n})
        lo = 0
        for req in live:
            vals = out[lo: lo + req.n]
            lo += req.n
            if req.event.is_set():
                # the watchdog already failed this request (stalled
                # batch): its client is gone — never double-complete
                continue
            lat_ms = (done - req.t_enq) * 1e3
            req.result = ServeResult(
                values=vals, version=mv.tag, latency_ms=lat_ms,
                degraded=degraded, batch_rows=n, trace_id=req.trace_id,
                queue_ms=max((t_collect - req.t_enq) * 1e3, 0.0),
                walk_ms=walk_ms)
            self.metrics.on_complete(lat_ms, degraded,
                                     trace_id=req.trace_id)
            st.completed += 1
            self._tenant_outcome(st, "ok")
            self._slo_record(st, True, latency_ms=lat_ms,
                             trace_id=req.trace_id)
            req.event.set()

    # -- watchdog --------------------------------------------------------
    def _watchdog_loop(self) -> None:
        """Detects the two ways a dispatcher hangs the queue: a STALLED
        in-flight batch (device wedged — its requests fail with 503
        instead of blocking their clients forever) and a DEAD dispatcher
        thread (restarted, stranded requests failed)."""
        limit_s = self.config.watchdog_ms / 1e3
        period = max(limit_s / 4.0, 0.005)
        while True:
            time.sleep(period)
            if self._closed:
                return
            infl = self._inflight
            if infl is not None:
                t_start, live = infl
                if time.monotonic() - t_start > limit_s:
                    n_failed = 0
                    for req in live:
                        if not req.event.is_set():
                            req.error = DispatcherStalled(
                                f"device batch exceeded the "
                                f"{self.config.watchdog_ms:.0f} ms "
                                "watchdog deadline")
                            req.event.set()
                            self._slo_record(
                                req.state
                                or self._tenants[DEFAULT_TENANT],
                                False, trace_id=req.trace_id)
                            n_failed += 1
                    if n_failed:
                        self._last_wedge_unix = time.time()
                        self.metrics.on_watchdog(n_failed)
                        obs_events.publish(
                            "serve.watchdog_stall",
                            f"stalled batch failed {n_failed} "
                            "request(s)", severity="error",
                            requests=n_failed,
                            watchdog_ms=self.config.watchdog_ms)
                        # a wedged device batch is a crash-grade moment:
                        # give the armed flight recorder its dump (the
                        # process survives, the evidence must too)
                        obs_dump.dump(
                            "watchdog_stall",
                            error=f"device batch exceeded "
                                  f"{self.config.watchdog_ms:.0f} ms")
                        log_warning(
                            f"serve: watchdog failed {n_failed} "
                            "request(s) of a stalled batch")
            if not self._dispatcher.is_alive() and not self._closed:
                obs_events.publish(
                    "serve.dispatcher_restart",
                    "dispatcher thread dead — restarting",
                    severity="error")
                log_warning("serve: dispatcher thread dead — restarting")
                self.metrics.on_dispatcher_restart()
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, name="serve-dispatcher",
                    daemon=True)
                self._dispatcher.start()


def serve_config_from(config) -> ServeConfig:
    """Map the global Config's ``serve_*``, ``drift_*``, ``serve_slo_*``
    and ``predict_*`` knobs onto a :class:`ServeConfig`.
    ``predict_method=auto`` names no walk: the registry's default, K4 on
    the card."""
    return ServeConfig(
        max_batch_rows=config.serve_max_batch_rows,
        max_batch_delay_ms=config.serve_max_batch_delay_ms,
        queue_depth_rows=config.serve_queue_depth,
        timeout_ms=config.serve_timeout_ms,
        degrade_trees=config.serve_degrade_trees,
        f64_scores=config.predict_f64_scores,
        drift_sample_rows=config.drift_sample_rows,
        drift_per_batch_rows=config.drift_per_batch_rows,
        drift_min_rows=config.drift_min_rows,
        drift_psi_threshold=config.drift_psi_threshold,
        drift_top_k=config.drift_top_k,
        drift_psi_groups=config.drift_psi_groups,
        drift_sample_stride=config.drift_sample_stride,
        retry_max=config.serve_retry_max,
        retry_backoff_ms=config.serve_retry_backoff_ms,
        breaker_failures=config.serve_breaker_failures,
        watchdog_ms=config.serve_watchdog_ms,
        probe_rows=config.serve_probe_rows,
        keep_versions=config.registry_keep_versions,
        slo=SLOConfig(
            availability_target=config.serve_slo_availability_target,
            latency_ms=config.serve_slo_latency_ms,
            latency_target=config.serve_slo_latency_target,
            fast_window_s=config.serve_slo_fast_window_s,
            slow_window_s=config.serve_slo_slow_window_s,
        ),
        predictor_kwargs={
            "bucket_min": config.predict_bucket_min,
            **({"method": config.predict_method}
               if config.predict_method in ("depthwise", "pallas",
                                            "fused", "scan") else {}),
            "code_layout": config.predict_code_layout,
        },
    )


def build_server(booster, config, device: DeviceLike = None) -> Server:
    """CLI glue: a :class:`Server` from a Booster + the global Config's
    ``serve_*`` knobs (cli.py task=serve)."""
    sc = serve_config_from(config)
    server = Server(booster, config=sc, device=device)
    log_info(f"serve: model {server.version()} online "
             f"({booster.num_trees()} trees, "
             f"batch<= {sc.max_batch_rows} rows, "
             f"delay {sc.max_batch_delay_ms} ms, "
             f"queue {sc.queue_depth_rows} rows)")
    return server
