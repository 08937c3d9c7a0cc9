"""Online serving: the micro-batching ``Server`` (server.py), the versioned
``ModelRegistry`` with atomic hot-swap and golden-probe validation
(registry.py), and ``ServeMetrics`` (metrics.py) — ported from
lightgbmv1_tpu/serve/ onto the port's ``BatchPredictor``."""

from .metrics import ServeMetrics
from .registry import ModelRegistry, ModelVersion, PublishValidationError
from .server import (RequestTimeout, ServeConfig, ServeError, ServeResult,
                     Server, ServerClosed, ServerOverloaded, build_server,
                     serve_config_from)

__all__ = [
    "ServeMetrics", "ModelRegistry", "ModelVersion",
    "PublishValidationError", "RequestTimeout", "ServeConfig",
    "ServeError", "ServeResult", "Server", "ServerClosed",
    "ServerOverloaded", "build_server", "serve_config_from",
]
