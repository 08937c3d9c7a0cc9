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
  (tenants.py).

Front doors: ``Server.submit()`` in process, ``ServeHTTP`` over the
wire, and the CLI's ``task=serve`` (cli.py).  The fleet, the router and
placement (JAX ``fleet.py``, ``router.py``, ``placement.py``) are ROADMAP
queue 1 item 7.
"""

from .metrics import ServeMetrics
from .registry import ModelRegistry, ModelVersion, PublishValidationError
from .server import (DEFAULT_TENANT, DispatcherDied, DispatcherStalled,
                     RequestTimeout, ServeConfig, ServeError, ServeResult,
                     Server, ServerClosed, ServerOverloaded, UnknownTenant,
                     build_server, serve_config_from)
from .http import ServeHTTP
from .slo import SLOConfig, SLOTracker
from .tenants import (TenantRegistry, TenantSpec, compile_share_stats,
                      parse_manifest)

__all__ = [
    "DEFAULT_TENANT", "DispatcherDied", "DispatcherStalled",
    "ModelRegistry", "ModelVersion", "PublishValidationError",
    "RequestTimeout", "SLOConfig", "SLOTracker", "ServeConfig",
    "ServeError", "ServeHTTP", "ServeMetrics", "ServeResult", "Server",
    "ServerClosed", "ServerOverloaded", "TenantRegistry", "TenantSpec",
    "UnknownTenant", "build_server", "compile_share_stats",
    "parse_manifest", "serve_config_from",
]
