"""Always-on structured wide-event log; the port's copy of
lightgbmv1_tpu/obs/events.py.

A counter says how often something happened and a span how long it
took; this ring says what happened, in order, with context.  It is a
bounded, thread-safe ring of flat dicts, on from import (one lock and an
append a publish), so the crash-dump recorder (obs/dump.py) always has a
tail to write.  Every event carries:

``seq``            process-wide monotone sequence number
``severity``       ``debug | info | warning | error | fatal``
``kind``           dotted event name (``serve.shed``, ``fault.injected``,
                   ``log.warning``, ...)
``t_mono_ns``      ``time.perf_counter_ns()`` — ordering within the run
``t_wall``         ``time.time()`` — alignment across processes
``host, pid, role, run_id``   process identity (:func:`set_identity`)
``trace_id``       the current thread's bound trace id, when any
``message``        human line
``fields``         kind-specific extras (JSON-able)

Publishers (grep ``events.publish``): ``utils/log.py`` warnings and
fatals, every ``faults.fire`` injection, and the serving failure domains
(shed, watchdog stall, dispatcher restart, breaker trip, publish
reject).  Each publish also counts into the default registry
(``obs_events_total{severity=...}``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

DEFAULT_RING_EVENTS = 4096

SEVERITIES = ("debug", "info", "warning", "error", "fatal")

_lock = threading.Lock()
_ring: List[dict] = []
_ring_cap = DEFAULT_RING_EVENTS
_ring_pos = 0
_dropped = 0
_seq = 0

_HOST = socket.gethostname()
_identity = {
    "host": _HOST,
    "pid": os.getpid(),
    "role": os.environ.get("LGBMV1_OBS_ROLE", "proc"),
    "run_id": os.environ.get("LGBMV1_RUN_ID", "") or os.urandom(4).hex(),
}

_counter = None          # lazily bound obs_events_total{severity}


def set_identity(role: Optional[str] = None,
                 run_id: Optional[str] = None) -> None:
    """Bind this process's ``role`` (trainer / server / loadgen / worker0
    ...) and ``run_id`` (shared across the processes of one logical run
    so the aggregator can group them).  Events published BEFORE the call
    keep the identity they were stamped with."""
    with _lock:
        if role is not None:
            _identity["role"] = str(role)
        if run_id is not None:
            _identity["run_id"] = str(run_id)
        _identity["pid"] = os.getpid()   # re-stamp after fork


def identity() -> Dict[str, object]:
    with _lock:
        return dict(_identity)


def configure(capacity: int = DEFAULT_RING_EVENTS) -> None:
    """Resize the ring (drops buffered events; tests and long-lived
    servers that want a deeper black box)."""
    global _ring, _ring_cap, _ring_pos, _dropped
    with _lock:
        _ring = []
        _ring_cap = max(int(capacity), 16)
        _ring_pos = 0
        _dropped = 0


def reset() -> None:
    """Drop all buffered events (test isolation; identity/seq survive)."""
    global _ring, _ring_pos, _dropped
    with _lock:
        _ring = []
        _ring_pos = 0
        _dropped = 0


def _count(severity: str) -> None:
    global _counter
    try:
        if _counter is None:
            from .metrics import default_registry

            _counter = default_registry().counter(
                "obs_events_total", "Structured events published",
                label_names=("severity",))
        _counter.labels(severity=severity).inc()
    except Exception:   # noqa: BLE001 — the log must never throw
        pass


def publish(kind: str, message: str = "", severity: str = "info",
            **fields) -> dict:
    """Record one structured event; returns the event dict (the ring
    keeps a reference — do not mutate it).  Never raises: the event log
    is the thing that must still work when everything else is broken."""
    global _ring_pos, _dropped, _seq
    if severity not in SEVERITIES:
        severity = "info"
    trace_id = None
    try:
        from . import trace

        trace_id = trace.current_trace_id()
    except Exception:   # noqa: BLE001
        pass
    ev = {
        "seq": 0,
        "severity": severity,
        "kind": str(kind),
        "t_mono_ns": time.perf_counter_ns(),
        "t_wall": time.time(),
        "message": str(message),
    }
    with _lock:
        _seq += 1
        ev["seq"] = _seq
        ev.update(_identity)
        if trace_id:
            ev["trace_id"] = trace_id
        if fields:
            ev["fields"] = fields
        if len(_ring) < _ring_cap:
            _ring.append(ev)
        else:
            _ring[_ring_pos] = ev
            _ring_pos = (_ring_pos + 1) % _ring_cap
            _dropped += 1
    _count(severity)
    return ev


def seq() -> int:
    """Current sequence number (a bookmark: the events published
    after a bookmark are exactly those with ``seq`` greater than it)."""
    with _lock:
        return _seq


def dropped() -> int:
    with _lock:
        return _dropped


def tail(n: Optional[int] = None, since_seq: int = 0,
         kind_prefix: str = "") -> List[dict]:
    """Buffered events oldest -> newest, optionally only those after
    ``since_seq`` and/or whose kind starts with ``kind_prefix``; ``n``
    keeps the newest n after filtering."""
    with _lock:
        if len(_ring) < _ring_cap or _ring_pos == 0:
            evs = list(_ring)
        else:
            evs = _ring[_ring_pos:] + _ring[:_ring_pos]
    if since_seq:
        evs = [e for e in evs if e["seq"] > since_seq]
    if kind_prefix:
        evs = [e for e in evs if e["kind"].startswith(kind_prefix)]
    if n is not None:
        evs = evs[-int(n):]
    return evs


def to_jsonl(events: List[dict]) -> str:
    """One event per line — the bundle/artifact wire format (merge-able
    by sort on ``t_wall`` across processes)."""
    return "\n".join(json.dumps(e, sort_keys=True, default=str)
                     for e in events) + ("\n" if events else "")


def from_jsonl(text: str) -> List[dict]:
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue   # a torn tail line from a crashed writer is expected
    return out
