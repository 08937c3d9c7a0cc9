"""Configuration of the serving slice.

Port of the part of lightgbmv1_tpu/config.py that the serving path reads:
the objective fields a loaded model sets, and the ``predict_*`` and
``serve_*`` knobs with the JAX package's names, defaults and validation
(``config.py:477-545``, ``:823-860``).  Unknown keys warn, as there.
The training knobs come with the training slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

from .utils.log import log_warning

_BOOL_TRUE = {"true", "1", "yes", "on", "+", "t", "y"}
_BOOL_FALSE = {"false", "0", "no", "off", "-", "f", "n"}


@dataclass
class Config:
    # -- the objective of a loaded model ---------------------------------
    objective: str = "regression"
    num_class: int = 1
    sigmoid: float = 1.0
    # -- serving engine (models/predict.py) -------------------------------
    # "auto"/"host": the exact host walk (numpy HostTree); "depthwise":
    # the depth-stepped all-trees walk in plain torch; "pallas": leaf ids
    # from the CUDA leaf-walk kernel (ops/predict_cuda.serving_leaf);
    # "fused": the serving megakernel (ops/predict_cuda.serving_fused)
    # walking every tree and summing the scores in one launch.  "native"
    # and "scan" are not ported yet (ROADMAP queue 1)
    predict_method: str = "auto"
    # prebinned serving codes: "auto" = on whenever the thresholds admit
    # an EXACT serving binning, else the raw f32 walk; "on"/"off" force it
    predict_prebin: str = "auto"
    # "auto" packs two 4-bit codes per byte for predict_method=fused when
    # every feature fits 16 codes; "packed4" forces it for any prebinned
    # walk; "u8" keeps byte-wide codes
    predict_code_layout: str = "auto"
    predict_bucket_min: int = 256    # smallest power-of-two row bucket
    predict_chunk_rows: int = 131072  # streaming chunk (bounds device memory)
    predict_num_shards: int = 0      # >1: row-sharded predict (not ported)
    # reconstruct raw scores host-side in float64 from device leaf ids
    # (bit-identical to the host walk); off = the on-device f32 sum
    predict_f64_scores: bool = False
    # -- online serving (serve/) ------------------------------------------
    serve_max_batch_rows: int = 1024
    serve_max_batch_delay_ms: float = 2.0
    serve_queue_depth: int = 4096    # admission bound in ROWS
    serve_timeout_ms: float = 0.0    # per-request deadline in queue; 0=off
    serve_retry_max: int = 2
    serve_retry_backoff_ms: float = 5.0
    serve_probe_rows: int = 64       # publish-time golden probe rows
    registry_keep_versions: int = 4

    def __post_init__(self):
        if self.predict_method not in (
                "auto", "native", "host", "depthwise", "pallas", "fused",
                "scan"):
            raise ValueError(
                f"predict_method={self.predict_method!r}: expected auto | "
                "native | host | depthwise | pallas | fused | scan")
        if self.predict_prebin not in ("auto", "on", "off"):
            raise ValueError(
                f"predict_prebin={self.predict_prebin!r}: expected "
                "auto | on | off")
        if self.predict_code_layout not in ("auto", "u8", "packed4"):
            raise ValueError(
                f"predict_code_layout={self.predict_code_layout!r}: "
                "expected auto | u8 | packed4")
        if self.serve_max_batch_rows < 1:
            raise ValueError("serve_max_batch_rows must be >= 1")
        if self.serve_max_batch_delay_ms < 0:
            raise ValueError("serve_max_batch_delay_ms must be >= 0")
        if self.serve_queue_depth < self.serve_max_batch_rows:
            raise ValueError("serve_queue_depth must be >= "
                             "serve_max_batch_rows (admission control "
                             "must admit at least one full batch)")
        if self.serve_retry_max < 0 or self.serve_retry_backoff_ms < 0:
            raise ValueError("serve_retry_max / serve_retry_backoff_ms "
                             "must be >= 0")
        if self.serve_probe_rows < 0:
            raise ValueError("serve_probe_rows must be >= 0")
        if self.registry_keep_versions < 1:
            raise ValueError("registry_keep_versions must be >= 1 "
                             "(the current version is always kept)")

    @classmethod
    def from_dict(cls, params: Dict[str, Any]) -> "Config":
        """Defaults, then ``params`` coerced to each field's type; unknown
        keys warn and are skipped (reference ``Config::Set``)."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for name, value in params.items():
            if name not in fields:
                log_warning(f"Unknown parameter: {name}")
                continue
            kwargs[name] = _coerce(value, fields[name].default, name)
        return cls(**kwargs)


def _coerce(value: Any, default: Any, name: str) -> Any:
    if isinstance(default, bool):
        if isinstance(value, str):
            lv = value.strip().lower()
            if lv in _BOOL_TRUE:
                return True
            if lv in _BOOL_FALSE:
                return False
            raise ValueError(f"Cannot parse bool parameter {name}={value}")
        return bool(value)
    if isinstance(default, int):
        return int(float(value))
    if isinstance(default, float):
        return float(value)
    return str(value)
