"""Logging with reference-style levels: the port's copy of the JAX
package's utils/log.py.

A registered callback receives each emitted line in place of stderr
(reference ``LGBM_RegisterLogCallback``, c_api.h:54); swaps and reads of
the level and the callback are thread-safe.  Every emitted line counts
into the default registry (``log_messages_total{level=...}``); warnings
and fatals also publish structured events (obs/events.py), and a fatal
gives the armed crash-dump recorder (obs/dump.py) its moment before it
raises ``LightGBMError``.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Optional

_level = 1
_callback: Optional[Callable[[str], None]] = None
_lock = threading.Lock()
_counter = None               # lazily bound log_messages_total{level}


class LightGBMError(RuntimeError):
    pass


def set_verbosity(verbosity: int) -> None:
    """The reference ``verbosity`` param: < 0 fatal only, 0 warnings,
    1 info, > 1 debug.  Process-wide, as in the JAX package (each
    ``Config`` sets it)."""
    global _level
    with _lock:
        _level = max(-1, min(2, int(verbosity)))


def register_callback(fn: Optional[Callable[[str], None]]) -> None:
    """Send every emitted line to ``fn`` instead of stderr (None: back to
    stderr)."""
    global _callback
    with _lock:
        _callback = fn


def _count(level: str) -> None:
    global _counter
    try:
        if _counter is None:
            from ..obs.metrics import default_registry

            _counter = default_registry().counter(
                "log_messages_total", "Log lines emitted",
                label_names=("level",))
        _counter.labels(level=level).inc()
    except Exception:   # noqa: BLE001 — logging must never throw
        pass


def _publish_event(severity: str, msg: str) -> None:
    try:
        from ..obs import events

        events.publish(f"log.{severity}", msg, severity=severity)
    except Exception:   # noqa: BLE001
        pass


def _emit(msg: str, level: str = "info") -> None:
    _count(level)
    with _lock:
        cb = _callback
    if cb is not None:
        cb(msg)
    else:
        print(msg, file=sys.stderr, flush=True)


def log_debug(msg: str) -> None:
    if _level >= 2:
        _emit(f"[LightGBM-TPU] [Debug] {msg}", "debug")


def log_info(msg: str) -> None:
    if _level >= 1:
        _emit(f"[LightGBM-TPU] [Info] {msg}", "info")


def log_warning(msg: str) -> None:
    if _level >= 0:
        _publish_event("warning", msg)
        _emit(f"[LightGBM-TPU] [Warning] {msg}", "warning")


def log_fatal(msg: str) -> None:
    # unconditional: count, publish the event, let the armed flight
    # recorder dump, then raise
    _count("fatal")
    _publish_event("fatal", msg)
    try:
        from ..obs import dump

        dump.dump("fatal", error=msg)
    except Exception:   # noqa: BLE001 — dying loudly beats dying twice
        pass
    raise LightGBMError(msg)
