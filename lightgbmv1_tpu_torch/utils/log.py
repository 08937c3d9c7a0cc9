"""Logging with reference-style levels: the port's copy of the JAX
package's utils/log.py ``set_verbosity``, ``register_callback``,
``log_info``, ``log_warning`` and ``log_fatal``, without its
metrics-registry and event wiring, which the port has not taken over.
A registered callback receives each emitted line in place of stderr
(reference ``LGBM_RegisterLogCallback``, c_api.h:54); swaps and reads of
the level and the callback are thread-safe, as there.  Fatal raises
``LightGBMError``."""

from __future__ import annotations

import sys
import threading
from typing import Callable, Optional

_level = 1
_callback: Optional[Callable[[str], None]] = None
_lock = threading.Lock()


class LightGBMError(RuntimeError):
    pass


def set_verbosity(verbosity: int) -> None:
    """The reference ``verbosity`` param: < 0 fatal only, 0 warnings,
    >= 1 info.  Process-wide, as in the JAX package (each ``Config`` sets
    it)."""
    global _level
    with _lock:
        _level = max(-1, min(2, int(verbosity)))


def register_callback(fn: Optional[Callable[[str], None]]) -> None:
    """Send every emitted line to ``fn`` instead of stderr (None: back to
    stderr)."""
    global _callback
    with _lock:
        _callback = fn


def _emit(msg: str) -> None:
    with _lock:
        cb = _callback
    if cb is not None:
        cb(msg)
    else:
        print(msg, file=sys.stderr, flush=True)


def log_info(msg: str) -> None:
    if _level >= 1:
        _emit(f"[LightGBM-TPU] [Info] {msg}")


def log_warning(msg: str) -> None:
    if _level >= 0:
        _emit(f"[LightGBM-TPU] [Warning] {msg}")


def log_fatal(msg: str) -> None:
    raise LightGBMError(msg)
