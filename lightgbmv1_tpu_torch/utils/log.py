"""Logging with reference-style levels: a copy of ``set_verbosity``,
``log_info``, ``log_warning`` and ``log_fatal`` from
lightgbmv1_tpu/utils/log.py without its metrics-registry and event
wiring, which the port has not taken over.  Fatal raises
``LightGBMError``."""

from __future__ import annotations

import sys

_level = 1


class LightGBMError(RuntimeError):
    pass


def set_verbosity(verbosity: int) -> None:
    """The reference ``verbosity`` param: < 0 fatal only, 0 warnings,
    >= 1 info.  Process-wide, as in the JAX package (each ``Config`` sets
    it)."""
    global _level
    _level = max(-1, min(2, int(verbosity)))


def log_info(msg: str) -> None:
    if _level >= 1:
        print(f"[LightGBM-TPU] [Info] {msg}", file=sys.stderr, flush=True)


def log_warning(msg: str) -> None:
    if _level >= 0:
        print(f"[LightGBM-TPU] [Warning] {msg}", file=sys.stderr, flush=True)


def log_fatal(msg: str) -> None:
    raise LightGBMError(msg)
