"""Self-healing request router over a replica fleet; the port's copy of
lightgbmv1_tpu/serve/router.py.

Fronts N replica :class:`~lightgbmv1_tpu_torch.serve.server.Server`s with the
three behaviors that turn "a replica died" into "nobody noticed":

* **health-check ejection / readmission** — a poller thread reads each
  replica's ``health()`` (the same payload ``/healthz`` serves, so the
  decision is externally observable) every ``health_period_ms``;
  ``eject_after`` consecutive bad checks eject a replica from the
  candidate set, ``readmit_after`` consecutive good checks readmit it.
  ``wedged`` (a watchdog-overdue in-flight batch) counts as unhealthy:
  a stuck dispatcher is dead to traffic even though its process polls
  200.
* **bounded retry onto another replica** — a retryable failure
  (ServerClosed, DispatcherStalled/Died, a transport drop, a transient
  ServeError) is retried on a DIFFERENT replica, up to ``retry_max``
  extra attempts and never past the request deadline.  Retry is safe by
  construction: predict is pure, so re-execution cannot double-apply
  anything (the idempotency argument the reference's Predictor gets for
  free and a mutating service would have to build).
* **hedging** — when an attempt has not answered within ``hedge_ms``,
  a second attempt launches on another replica and the FIRST completion
  wins; the loser's eventual result is discarded.  Router metrics and
  SLO record EXACTLY ONE outcome per request (the coordinator thread is
  the only writer), so a hedged race never double-counts — each
  replica's own metrics still record its honest per-replica work.

Deadline semantics: ``deadline_ms`` (or the per-call ``timeout_ms``)
bounds the WHOLE request including retries and hedges; exhaustion
raises :class:`RequestTimeout`, which the HTTP layer maps to 504 —
never a 500, because running out of time is the client's contract, not
a server bug.

Fault seams (utils/faults.py): ``rpc_drop`` (raise = the connection to
a replica dropped before dispatch) and ``rpc_delay`` (stall = a slow
link) fire per attempt with the replica name as site — the chaos
scenarios script replica-targeted network faults deterministically.

The router duck-types the Server surface ``ServeHTTP`` consumes
(``submit`` / ``metrics`` / ``metrics_snapshot`` / ``slo_snapshot`` /
``drift_snapshot`` / ``tenants_snapshot`` / ``health`` / ``version``), so
the stdlib HTTP front-end serves a fleet unchanged.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from ..utils import faults
from ..utils.log import log_info, log_warning
from .metrics import ServeMetrics
from .server import (DEFAULT_TENANT, DispatcherDied, DispatcherStalled,
                     RequestTimeout, ServeError, ServeResult, Server,
                     ServerClosed, ServerOverloaded, UnknownTenant)
from .slo import SLOConfig, SLOTracker


@dataclass
class RouterConfig:
    """Routing policy knobs (mirrored by the ``router_*`` names in
    config.py for the CLI path; defaults match)."""

    health_period_ms: float = 25.0   # health poll period
    eject_after: int = 2             # consecutive bad checks -> eject
    readmit_after: int = 2           # consecutive good checks -> readmit
    retry_max: int = 2               # extra attempts after the first
    hedge_ms: float = 0.0            # hedge launch delay; 0 = off
    max_hedges: int = 1              # concurrent extra attempts
    deadline_ms: float = 0.0         # whole-request budget; 0 = off
    metrics_window: int = 8192
    slo: Optional[SLOConfig] = None

    def __post_init__(self):
        self.health_period_ms = max(float(self.health_period_ms), 1.0)
        self.eject_after = max(int(self.eject_after), 1)
        self.readmit_after = max(int(self.readmit_after), 1)
        self.retry_max = max(int(self.retry_max), 0)
        self.hedge_ms = max(float(self.hedge_ms), 0.0)
        self.max_hedges = max(int(self.max_hedges), 0)
        self.deadline_ms = max(float(self.deadline_ms), 0.0)
        if self.slo is None:
            self.slo = SLOConfig()


class _Replica:
    __slots__ = ("server", "healthy", "consec_bad", "consec_good",
                 "ejections", "readmissions")

    def __init__(self, server: Server):
        self.server = server
        self.healthy = True
        self.consec_bad = 0
        self.consec_good = 0
        self.ejections = 0
        self.readmissions = 0

    @property
    def name(self) -> str:
        return self.server.name or f"r@{id(self.server):x}"


# outcomes a DIFFERENT replica can plausibly serve — retried elsewhere.
# ServerOverloaded is retryable too (another replica's queue may have
# room) but is tracked separately so an all-replicas-shedding fleet
# surfaces as overload, not as a generic error.
_RETRYABLE = (ServerClosed, DispatcherStalled, DispatcherDied,
              faults.FaultInjected, ServeError, RuntimeError)


class Router:
    """Health-checked, retrying, hedging front over fleet replicas.

    ``replicas`` is a :class:`~lightgbmv1_tpu_torch.serve.fleet.Fleet` or a
    list of Servers.  The router does not own the replicas — closing
    the fleet is the owner's job; ``close()`` only stops the health
    poller."""

    def __init__(self, replicas, config: Optional[RouterConfig] = None):
        servers = (replicas.replicas
                   if hasattr(replicas, "replicas") else list(replicas))
        if not servers:
            raise ValueError("Router needs at least one replica")
        self.config = config or RouterConfig()
        self._replicas = [_Replica(s) for s in servers]
        self._t_start = time.monotonic()
        self._rr = 0
        self._lock = threading.Lock()
        # placement map (serve/placement.py): tenant -> tuple of replica
        # names its traffic is pinned to; a tenant with no entry routes
        # over every replica (the pre-placement behavior)
        self._placement: Dict[str, tuple] = {}
        self.metrics = ServeMetrics(window=self.config.metrics_window)
        self.slo = SLOTracker(self.config.slo)
        reg = self.metrics.registry
        self._c_hedges = reg.counter(
            "router_hedges_total", "Hedge attempts launched")
        self._c_hedge_wins = reg.counter(
            "router_hedge_wins_total",
            "Requests answered by a hedge attempt, not the primary")
        self._c_ejections = reg.counter(
            "router_ejections_total", "Replica health-check ejections",
            label_names=("replica",))
        self._c_readmissions = reg.counter(
            "router_readmissions_total",
            "Replica health-check readmissions",
            label_names=("replica",))
        self._closed = False
        self._health_stop = threading.Event()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="router-health", daemon=True)
        self._health_thread.start()
        log_info(f"router: fronting {len(self._replicas)} replica(s) "
                 f"[{', '.join(r.name for r in self._replicas)}], "
                 f"retry_max={self.config.retry_max}, "
                 f"hedge_ms={self.config.hedge_ms}")

    # -- health ----------------------------------------------------------
    def _eject(self, rep: _Replica, reason: str) -> None:
        """Idempotent ejection with first-class telemetry — used by the
        health poller AND the submit path (a replica that turns out
        closed at dispatch must stop receiving traffic NOW, not a poll
        period later)."""
        from ..obs import events as obs_events

        with self._lock:
            if not rep.healthy:
                return
            rep.healthy = False
        rep.ejections += 1
        self._c_ejections.labels(replica=rep.name).inc()
        obs_events.publish(
            "router.replica_ejected", f"{rep.name} ejected: {reason}",
            severity="error", replica=rep.name, reason=reason)
        log_warning(f"router: ejected {rep.name} ({reason})")

    def _readmit(self, rep: _Replica) -> None:
        from ..obs import events as obs_events

        with self._lock:
            if rep.healthy:
                return
            rep.healthy = True
        rep.readmissions += 1
        self._c_readmissions.labels(replica=rep.name).inc()
        obs_events.publish(
            "router.replica_readmitted",
            f"{rep.name} healthy for {rep.consec_good} checks — "
            "readmitted", severity="info", replica=rep.name)
        log_info(f"router: readmitted {rep.name}")

    def _health_loop(self) -> None:
        period = self.config.health_period_ms / 1e3
        while not self._health_stop.wait(period):
            for rep in self._replicas:
                try:
                    h = rep.server.health()
                    ok = bool(h.get("ok"))
                except Exception:   # noqa: BLE001 — unreachable = bad
                    ok = False
                if ok:
                    rep.consec_good += 1
                    rep.consec_bad = 0
                    if (not rep.healthy and rep.consec_good
                            >= self.config.readmit_after):
                        self._readmit(rep)
                else:
                    rep.consec_bad += 1
                    rep.consec_good = 0
                    if (rep.healthy and rep.consec_bad
                            >= self.config.eject_after):
                        self._eject(
                            rep, f"failed {rep.consec_bad} consecutive "
                            "health checks")

    # -- placement (serve/placement.py drives these) ---------------------
    def set_placement(self, tenant: str, names) -> None:
        """Pin one tenant's traffic to a replica subset.  Unknown
        replica names are rejected (a typo must not silently blackhole
        a tenant); an empty subset clears the pin."""
        names = tuple(names or ())
        known = {r.name for r in self._replicas}
        bad = [n for n in names if n not in known]
        if bad:
            raise ValueError(f"unknown replica(s) {bad} in placement "
                             f"for tenant {tenant!r}")
        with self._lock:
            if names:
                self._placement[tenant] = names
            else:
                self._placement.pop(tenant, None)

    def placement(self) -> Dict[str, tuple]:
        with self._lock:
            return dict(self._placement)

    def _pick(self, tried: set,
              tenant: str = DEFAULT_TENANT) -> Optional[_Replica]:
        """Next candidate: round-robin over healthy untried replicas,
        falling back to unhealthy untried ones (a request with no
        healthy candidate left still deserves a hail-mary — the health
        view may simply be stale).  A tenant with a placement pin only
        sees its pinned subset."""
        with self._lock:
            allowed = self._placement.get(tenant)
            n = len(self._replicas)
            for healthy_only in (True, False):
                for k in range(n):
                    rep = self._replicas[(self._rr + k) % n]
                    if rep.name in tried:
                        continue
                    if allowed is not None and rep.name not in allowed:
                        continue
                    if healthy_only and not rep.healthy:
                        continue
                    self._rr = (self._rr + k + 1) % n
                    return rep
        return None

    # -- request path ----------------------------------------------------
    def _attempt(self, rep: _Replica, rows: np.ndarray,
                 budget_ms: Optional[float], trace_id: Optional[str],
                 tenant: str, out: "queue.Queue", idx: int) -> None:
        try:
            # chaos seams: a dropped or slow link to THIS replica
            faults.fire("rpc_delay", site=rep.name)
            faults.fire("rpc_drop", site=rep.name)
            res = rep.server.submit(rows, timeout_ms=budget_ms,
                                    trace_id=trace_id, tenant=tenant)
            out.put(("ok", idx, rep, res))
        except BaseException as e:  # noqa: BLE001 — classified by caller
            out.put(("err", idx, rep, e))

    def submit(self, rows, timeout_ms: Optional[float] = None,
               trace_id: Optional[str] = None,
               tenant: str = DEFAULT_TENANT) -> ServeResult:
        """Route one request; retries and hedges under the deadline.
        Raises :class:`RequestTimeout` on budget exhaustion (HTTP 504),
        :class:`ServerOverloaded` when every tried replica shed, or the
        last replica error when no candidate remains."""
        if self._closed:
            raise ServerClosed("router is shut down")
        X = np.asarray(rows, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        cfg = self.config
        t0 = time.monotonic()
        budget_ms = (timeout_ms if timeout_ms is not None
                     else (cfg.deadline_ms or None))
        if budget_ms is not None and budget_ms <= 0:
            budget_ms = None
        deadline = t0 + budget_ms / 1e3 if budget_ms else None
        self.metrics.on_submit(X.shape[0], 0)

        results: "queue.Queue" = queue.Queue()
        tried: set = set()
        in_flight = 0
        attempts = 0
        hedges = 0
        retries_left = cfg.retry_max
        last_err: Optional[BaseException] = None
        all_shed = True

        def remaining_ms() -> Optional[float]:
            if deadline is None:
                return None
            return max((deadline - time.monotonic()) * 1e3, 0.0)

        hedge_attempts: set = set()

        def launch(is_hedge: bool = False) -> bool:
            nonlocal in_flight, attempts
            rep = self._pick(tried, tenant)
            if rep is None:
                return False
            tried.add(rep.name)
            if is_hedge:
                hedge_attempts.add(attempts)
            threading.Thread(
                target=self._attempt,
                args=(rep, X, remaining_ms(), trace_id, tenant, results,
                      attempts),
                name=f"router-attempt-{rep.name}", daemon=True).start()
            attempts += 1
            in_flight += 1
            return True

        if not launch():
            raise ServerClosed("router has no replicas")
        while True:
            # wait for the next completion, the hedge instant, or the
            # deadline — whichever is first
            wait_s = None
            rem = remaining_ms()
            if rem is not None:
                wait_s = rem / 1e3
            with self._lock:
                pinned = self._placement.get(tenant)
            pool = len(pinned) if pinned is not None \
                else len(self._replicas)
            can_hedge = (cfg.hedge_ms > 0 and hedges < cfg.max_hedges
                         and len(tried) < pool)
            if can_hedge:
                elapsed_ms = (time.monotonic() - t0) * 1e3
                hedge_in = max(cfg.hedge_ms * (hedges + 1)
                               - elapsed_ms, 0.0) / 1e3
                wait_s = (hedge_in if wait_s is None
                          else min(wait_s, hedge_in))
            try:
                kind, idx, rep, payload = results.get(
                    timeout=wait_s if wait_s is None or wait_s > 0
                    else 0.001)
            except queue.Empty:
                rem = remaining_ms()
                if rem is not None and rem <= 0:
                    # deadline exhausted MID-HEDGE: the client gets its
                    # 504 now; stragglers complete into the void and are
                    # never counted (single-writer accounting)
                    self.metrics.on_timeout()
                    self.slo.record(False, trace_id=trace_id or "")
                    raise RequestTimeout(
                        f"router deadline ({budget_ms:.0f} ms) expired "
                        f"after {attempts} attempt(s)")
                if can_hedge and launch(is_hedge=True):
                    hedges += 1
                    self._c_hedges.inc()
                continue
            in_flight -= 1
            if kind == "ok":
                res: ServeResult = payload
                lat_ms = (time.monotonic() - t0) * 1e3
                if idx in hedge_attempts:
                    self._c_hedge_wins.inc()
                self.metrics.on_complete(lat_ms, res.degraded,
                                         trace_id=res.trace_id)
                self.slo.record(True, latency_ms=lat_ms,
                                trace_id=res.trace_id)
                return res
            err: BaseException = payload
            if isinstance(err, (ValueError, TypeError, UnknownTenant)):
                # client input error — identical on every replica (an
                # unknown tenant is the caller's mistake, not a replica
                # fault: retrying elsewhere cannot create the lineage)
                self.metrics.on_error()
                raise err
            if isinstance(err, RequestTimeout):
                # the replica-side budget we passed expired in ITS queue
                self.metrics.on_timeout()
                self.slo.record(False, trace_id=trace_id or "")
                raise err
            last_err = err
            if not isinstance(err, ServerOverloaded):
                all_shed = False
            retryable = isinstance(err, _RETRYABLE + (ServerOverloaded,))
            if isinstance(err, ServerClosed):
                # died between health check and dispatch: stop offering
                # it traffic NOW, a poll period is too long to wait
                self._eject(rep, "ServerClosed at dispatch")
            if in_flight > 0:
                continue            # a hedge is still running — wait it out
            rem = remaining_ms()
            if retryable and retries_left > 0 and \
                    (rem is None or rem > 0) and launch():
                retries_left -= 1
                self.metrics.on_retry()
                continue
            # out of candidates, retries, or time
            if all_shed and isinstance(last_err, ServerOverloaded):
                self.metrics.on_shed()
                self.slo.record(False, trace_id=trace_id or "")
                raise last_err
            self.metrics.on_error()
            self.slo.record(False, trace_id=trace_id or "")
            if isinstance(last_err, Exception):
                raise last_err
            raise ServeError(str(last_err))

    # -- Server-compatible surface (ServeHTTP duck-typing) ---------------
    def version(self, tenant: str = DEFAULT_TENANT) -> Optional[str]:
        tags = {r.server.tenant_registry(tenant).current_tag()
                for r in self._replicas}
        return tags.pop() if len(tags) == 1 else None

    def tenant_names(self):
        return self._replicas[0].server.tenant_names()

    def tenants_snapshot(self) -> Dict[str, Any]:
        """GET /tenants on a fleet: per-replica tenant views keyed by
        replica name, the fleet-consensus version per tenant, and the
        placement map (which replicas each tenant's traffic is pinned
        to)."""
        per = {r.name: r.server.tenants_snapshot()["tenants"]
               for r in self._replicas}
        versions = {}
        for t in self.tenant_names():
            try:
                versions[t] = self.version(t)
            except UnknownTenant:
                versions[t] = None      # mid-add_tenant fan-out
        return {"replicas": per, "versions": versions,
                "placement": {t: list(v)
                              for t, v in self.placement().items()}}

    def replica_states(self) -> Dict[str, Dict[str, Any]]:
        return {r.name: {"healthy": r.healthy,
                         "consec_bad": r.consec_bad,
                         "ejections": r.ejections,
                         "readmissions": r.readmissions}
                for r in self._replicas}

    def metrics_snapshot(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()
        snap["version"] = self.version()
        snap["versions"] = sorted(
            {t for r in self._replicas
             for t in r.server.registry.versions()})
        snap["router"] = {
            "replicas": self.replica_states(),
            "hedges": int(self._c_hedges.get()),
            "hedge_wins": int(self._c_hedge_wins.get()),
        }
        return snap

    def slo_snapshot(self,
                     tenant: Optional[str] = None) -> Dict[str, Any]:
        if tenant is not None:
            # per-tenant burn rates live on the replicas (each tracks
            # its own traffic slice); the router view is their union
            per = {r.name: r.server.slo_snapshot(tenant=tenant)
                   for r in self._replicas}
            return {"tenant": tenant, "version": self.version(tenant),
                    "replicas": per}
        out = self.slo.snapshot()
        out["version"] = self.version()
        out["exemplars"] = [
            {"le": le, **ex} for le, ex in self.metrics.exemplars()]
        return out

    def drift_snapshot(self,
                       tenant: Optional[str] = None) -> Dict[str, Any]:
        """GET /drift on a fleet: per-replica skew evaluations (each
        replica samples its own traffic slice against the version's
        reference) keyed by replica name, plus the fleet-level view —
        armed if ANY replica is, alerting = union.  ``tenant`` narrows
        every per-replica evaluation to that tenant's detector."""
        per = {r.name: r.server.drift_snapshot(tenant=tenant)
               for r in self._replicas}
        alerting = sorted({f for d in per.values()
                           for f in d.get("alerting", [])})
        out = {"armed": any(d.get("armed") for d in per.values()),
               "version": self.version(tenant if tenant is not None
                                       else DEFAULT_TENANT),
               "alerting": alerting,
               "replicas": per}
        if tenant is not None:
            out["tenant"] = tenant
        return out

    def health(self) -> Dict[str, Any]:
        """Fleet-level liveness: ok while ANY replica is healthy (the
        router can still serve).  Per-replica payloads ride along so
        ``/healthz`` on the router shows exactly which replica the
        ejection logic is acting on and why."""
        from .. import __version__

        per = {r.name: r.server.health() for r in self._replicas}
        healthy = [r.name for r in self._replicas if r.healthy]
        return {"ok": bool(healthy), "version": self.version(),
                "healthy_replicas": healthy,
                "ejected_replicas": [r.name for r in self._replicas
                                     if not r.healthy],
                "replicas": per,
                "server_version": __version__,
                "uptime_s": round(time.monotonic() - self._t_start, 3)}

    def uptime_s(self) -> float:
        return time.monotonic() - self._t_start

    def close(self) -> None:
        """Stop the health poller (the fleet owns replica shutdown)."""
        self._closed = True
        self._health_stop.set()
        self._health_thread.join(timeout=2.0)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def hedge_frac(snapshot: Dict[str, Any]) -> float:
    """``router_hedge_frac``: hedge launches per completed request, the
    BENCH-record rate ``measure_fleet`` watches (bench.py)."""
    router = snapshot.get("router", {})
    done = snapshot.get("completed") or 0
    return round(router.get("hedges", 0) / done, 4) if done else 0.0
