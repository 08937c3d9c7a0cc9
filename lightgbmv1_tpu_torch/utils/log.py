"""Logging with reference-style levels: a copy of ``log_info``,
``log_warning`` and ``log_fatal`` from lightgbmv1_tpu/utils/log.py without
its metrics-registry and event wiring, which the port has not taken over.
Fatal raises ``LightGBMError``."""

from __future__ import annotations

import sys


class LightGBMError(RuntimeError):
    pass


def log_info(msg: str) -> None:
    print(f"[LightGBM-TPU] [Info] {msg}", file=sys.stderr, flush=True)


def log_warning(msg: str) -> None:
    print(f"[LightGBM-TPU] [Warning] {msg}", file=sys.stderr, flush=True)


def log_fatal(msg: str) -> None:
    raise LightGBMError(msg)
