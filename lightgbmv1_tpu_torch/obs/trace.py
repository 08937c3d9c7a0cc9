"""Low-overhead nested-span tracer with Chrome trace-event export; the
port's copy of lightgbmv1_tpu/obs/trace.py.

* **Off by default.**  ``span()`` checks one module flag and returns a
  shared no-op context manager while disarmed: no object and no clock
  read on the off path.  Hot paths that would build arguments guard
  with ``trace.enabled()``.
* **Monotonic clocks.**  Timestamps are ``time.perf_counter_ns()``; the
  export rebases them to the arm instant.
* **Thread-local span stack**, exported per OS thread (Perfetto's lanes).
* **Ring-buffered events.**  A fixed-capacity ring (``arm(ring_events=
  ...)``) overwrites the oldest events; the export says how many went.
* **Trace ids.**  ``new_trace_id()`` mints 16 hex chars; the server
  carries one from the request through the admission queue, the
  micro-batch and the predictor walk to the ``X-Trace-Id`` header.

These are host wall-clock spans.  A serving batch's span ends when its
scores are back on the host (the device-to-host copy ends the walk), so
tracing adds no device synchronization.  ``iteration_span_end`` records
a training iteration; with a phase profile installed
(``set_phase_profile``: measured per-phase milliseconds) it also lays
out estimated wave-round and phase children, flagged
``{"estimated": true}``.

Export is Chrome trace-event JSON (``{"traceEvents": [...]}`` of
``"ph": "X"`` complete events), which https://ui.perfetto.dev and
chrome://tracing open.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

DEFAULT_RING_EVENTS = 65536

_armed = False                  # THE hot-path flag: checked once per span
_lock = threading.Lock()        # guards the ring and arm/disarm
_ring: List[tuple] = []         # (name, cat, t0_ns, dur_ns, tid, args)
_ring_cap = DEFAULT_RING_EVENTS
_ring_pos = 0                   # next slot when the ring has wrapped
_dropped = 0
_t_arm_ns = 0                   # export rebases timestamps to this
_t_arm_unix_ns = 0              # wall-clock anchor of the SAME instant —
                                # the key that aligns timelines across
                                # processes
_phase_profile: Optional[Dict] = None

_tls = threading.local()


def enabled() -> bool:
    """True while the tracer is armed (the off path is one global read)."""
    return _armed


def arm(ring_events: int = DEFAULT_RING_EVENTS) -> None:
    """Arm the tracer with a fresh ring of ``ring_events`` capacity."""
    global _armed, _ring, _ring_cap, _ring_pos, _dropped, _t_arm_ns, \
        _t_arm_unix_ns
    with _lock:
        _ring = []
        _ring_cap = max(int(ring_events), 16)
        _ring_pos = 0
        _dropped = 0
        # the two clocks are read back to back: the pair (monotonic,
        # wall) anchors this process's relative timestamps onto the
        # shared wall-clock axis for cross-process merging
        _t_arm_ns = time.perf_counter_ns()
        _t_arm_unix_ns = time.time_ns()
        _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def reset() -> None:
    """Disarm and drop all buffered events / the phase profile."""
    global _armed, _ring, _ring_pos, _dropped, _phase_profile
    with _lock:
        _armed = False
        _ring = []
        _ring_pos = 0
        _dropped = 0
        _phase_profile = None


def _record(name: str, cat: str, t0_ns: int, dur_ns: int,
            args: Optional[dict]) -> None:
    global _ring_pos, _dropped
    ev = (name, cat, t0_ns, dur_ns, threading.get_ident(), args)
    with _lock:
        if len(_ring) < _ring_cap:
            _ring.append(ev)
        else:
            _ring[_ring_pos] = ev
            _ring_pos = (_ring_pos + 1) % _ring_cap
            _dropped += 1


class _NoopSpan:
    """Shared do-nothing context manager: the disarmed ``span()`` return
    value.  A singleton, so the off path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "t0")

    def __init__(self, name: str, cat: str, args: Optional[dict]):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        if _armed:   # disarmed mid-span: drop, never crash
            tid = current_trace_id()
            args = self.args
            if tid is not None:
                args = dict(args) if args else {}
                args["trace_id"] = tid
            _record(self.name, self.cat, self.t0, t1 - self.t0, args)
        return False


def span(name: str, cat: str = "app", args: Optional[dict] = None):
    """Context manager timing a nested span.  ``args`` is an optional
    dict rendered into the Chrome event (pass a literal dict only when
    armed-path cost is acceptable; the disarmed call allocates nothing)."""
    if not _armed:
        return _NOOP
    return _Span(name, cat, args)


def depth() -> int:
    """Current thread's span-nesting depth (tests / debugging)."""
    stack = getattr(_tls, "stack", None)
    return len(stack) if stack else 0


def add_span(name: str, t0_ns: int, dur_ns: int, cat: str = "app",
             args: Optional[dict] = None) -> None:
    """Record a span measured elsewhere (retro-recording: the serving
    dispatcher records each request's queue wait AFTER the batch is
    collected, from timestamps it already holds)."""
    if not _armed:
        return
    _record(name, cat, int(t0_ns), max(int(dur_ns), 0), args)


def instant(name: str, cat: str = "app", args: Optional[dict] = None) -> None:
    """Zero-duration marker event."""
    if not _armed:
        return
    _record(name, cat, time.perf_counter_ns(), 0, args)


def now_ns() -> int:
    return time.perf_counter_ns()


# ---------------------------------------------------------------------------
# trace ids (request-scoped correlation, independent of arming)
# ---------------------------------------------------------------------------

def new_trace_id() -> str:
    """16 hex chars from the OS entropy pool — unique per request at any
    realistic request rate, cheap enough to mint unconditionally."""
    return os.urandom(8).hex()


def set_trace_id(trace_id: Optional[str]) -> None:
    """Bind ``trace_id`` to the current thread; spans recorded while
    bound carry it in their args.  ``None`` clears."""
    _tls.trace_id = trace_id


def current_trace_id() -> Optional[str]:
    return getattr(_tls, "trace_id", None)


# ---------------------------------------------------------------------------
# estimated phase children (the attributed within-dispatch decomposition)
# ---------------------------------------------------------------------------

def set_phase_profile(parts: Optional[Dict[str, float]],
                      rounds_per_iter: Optional[float] = None) -> None:
    """Install the attributed per-iteration phase decomposition
    (``{"hist": ms, "partition": ms, "split": ms, ...}``).  Iteration
    spans emitted via :func:`iteration_span_end` then carry wave-round
    and phase child spans proportional to these parts, flagged
    ``estimated``: the host does not see the phases inside an
    iteration's device work, so the trace lays out the measured
    attribution."""
    global _phase_profile
    if parts is None:
        _phase_profile = None
        return
    clean = {str(k): float(v) for k, v in parts.items() if v and v > 0}
    _phase_profile = {
        "parts": clean,
        "rounds": max(float(rounds_per_iter or 0.0), 0.0),
    } if clean else None


def phase_profile() -> Optional[Dict]:
    return _phase_profile


def iteration_span_end(t0_ns: int, iteration: int,
                       cat: str = "train") -> None:
    """Record one training-iteration span ending NOW, plus the estimated
    wave-round/phase children when a phase profile is installed."""
    if not _armed:
        return
    t1 = time.perf_counter_ns()
    _record("train.iteration", cat, t0_ns, t1 - t0_ns,
            {"iteration": int(iteration)})
    prof = _phase_profile
    if not prof:
        return
    parts = prof["parts"]
    total = sum(parts.values())
    if total <= 0:
        return
    span_ns = t1 - t0_ns
    n_rounds = int(round(prof["rounds"])) if prof["rounds"] >= 2 else 1
    round_ns = span_ns // n_rounds
    for r in range(n_rounds):
        r0 = t0_ns + r * round_ns
        if n_rounds > 1:
            _record("wave.round", cat, r0, round_ns,
                    {"round": r, "estimated": True})
        cursor = r0
        for name, ms in parts.items():
            dur = int(round_ns * (ms / total))
            _record(f"phase.{name}", cat, cursor, dur,
                    {"estimated": True, "attributed_ms": ms})
            cursor += dur


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def drain() -> Dict:
    """Snapshot the ring (oldest -> newest) without disturbing it:
    ``{"events": [...], "dropped": n, "t0_ns": arm_instant,
    "t0_unix_ns": the same instant on the wall clock}``."""
    with _lock:
        if len(_ring) < _ring_cap or _ring_pos == 0:
            events = list(_ring)
        else:
            events = _ring[_ring_pos:] + _ring[:_ring_pos]
        return {"events": events, "dropped": _dropped, "t0_ns": _t_arm_ns,
                "t0_unix_ns": _t_arm_unix_ns}


def export_chrome(path: Optional[str] = None) -> Dict:
    """Chrome trace-event JSON of the buffered spans (Perfetto-viewable).
    When ``path`` is given the JSON is written via
    ``fileio.atomic_write_bytes`` — a crash mid-export leaves the old
    file, never a torn one — and the dict is returned either way."""
    import json

    snap = drain()
    t0 = snap["t0_ns"]
    events = []
    tids = {}
    pre_arm = 0
    for name, cat, t_ns, dur_ns, tid, args in snap["events"]:
        if t_ns < t0:
            # a span ENTERED before the most recent arm() (or re-arm)
            # carries a t0 from the previous epoch — exporting it would
            # produce a negative ts Perfetto renders at minus-infinity.
            # Drop it and report the count instead.
            pre_arm += 1
            continue
        tids.setdefault(tid, len(tids))
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": (t_ns - t0) / 1e3,       # microseconds
            "dur": dur_ns / 1e3,
            "pid": os.getpid(),
            "tid": tid,
        }
        if args:
            ev["args"] = args
        events.append(ev)
    for tid, i in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": os.getpid(),
                       "tid": tid, "args": {"name": f"thread-{i}"}})
    from . import events as obs_events

    ident = obs_events.identity()
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_events": snap["dropped"],
                      "pre_arm_dropped": pre_arm,
                      "exporter": "lightgbmv1_tpu_torch.obs.trace",
                      # merge keys across processes: the wall
                      # instant ts=0 corresponds to, plus who we are
                      "t0_unix_ns": snap["t0_unix_ns"],
                      "host": ident["host"], "pid": ident["pid"],
                      "role": ident["role"], "run_id": ident["run_id"]},
    }
    if path:
        from ..utils import fileio

        fileio.atomic_write_bytes(
            str(path), json.dumps(doc).encode("utf-8"), site="trace_out")
    return doc
