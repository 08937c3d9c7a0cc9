"""Online serving; the port's copy of lightgbmv1_tpu/serve/ on the port's
``BatchPredictor`` and its kernels:

* :class:`Server` / :class:`ServeConfig` — deadline-aware micro-batching
  with bounded-queue admission, tenants with fair-share admission,
  overload degradation, the watchdog and the circuit breaker
  (server.py);
* :class:`ModelRegistry` — versioned atomic hot-swap with a warm,
  validated publish and instant rollback (registry.py);
* :class:`ServeMetrics` — counters, latency quantiles and batch
  occupancy over one obs registry (metrics.py);
* :class:`ServeHTTP` — the stdlib HTTP front-end (http.py);
* :class:`SLOTracker` / :class:`SLOConfig` — availability and latency
  SLOs with multi-window burn rates (slo.py);
* :class:`TenantRegistry` — the tenant control plane and manifests
  (tenants.py);
* :class:`Fleet` — N replica servers on one device with a two-phase
  publish (fleet.py);
* :class:`Router` / :class:`RouterConfig` — health-check ejection and
  readmission, retry onto another replica, hedging and the deadline in
  front of a fleet (router.py);
* :class:`PlacementController` / :class:`PlacementConfig` — pins tenants
  to replica subsets and moves the hot ones (placement.py).

Front doors: ``Server.submit()`` or ``Router.submit()`` in process,
``ServeHTTP`` over the wire (a Server or a Router), and the CLI's
``task=serve`` (cli.py; ``serve_replicas > 1`` is the fleet).
"""

from .metrics import ServeMetrics
from .registry import ModelRegistry, ModelVersion, PublishValidationError
from .server import (DEFAULT_TENANT, DispatcherDied, DispatcherStalled,
                     RequestTimeout, ServeConfig, ServeError, ServeResult,
                     Server, ServerClosed, ServerOverloaded, UnknownTenant,
                     build_server, serve_config_from)
from .http import ServeHTTP
from .slo import SLOConfig, SLOTracker
from .fleet import Fleet, FleetPublishError
from .router import Router, RouterConfig
from .tenants import (TenantRegistry, TenantSpec, compile_share_stats,
                      parse_manifest)
from .placement import PlacementConfig, PlacementController

__all__ = [
    "DEFAULT_TENANT", "DispatcherDied", "DispatcherStalled", "Fleet",
    "FleetPublishError", "ModelRegistry", "ModelVersion",
    "PlacementConfig", "PlacementController", "PublishValidationError",
    "RequestTimeout", "Router", "RouterConfig", "SLOConfig", "SLOTracker",
    "ServeConfig",
    "ServeError", "ServeHTTP", "ServeMetrics", "ServeResult", "Server",
    "ServerClosed", "ServerOverloaded", "TenantRegistry", "TenantSpec",
    "UnknownTenant", "build_server", "compile_share_stats",
    "parse_manifest", "serve_config_from",
]
