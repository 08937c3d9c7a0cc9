"""Crash-dump flight recorder; the port's copy of lightgbmv1_tpu/obs/dump.py.

Armed (``arm(crash_dir)``), the first crash-grade moment of the process
— an unhandled exception in any thread, a ``log_fatal``, SIGTERM, a
serving watchdog stall, an injected kill — writes ONE forensic bundle
into the crash directory and lets the failure go on.  One bundle an
arming: the first trigger wins (a stall that turns into a dispatcher
death keeps the stall's evidence); ``force=True`` overrides.

A bundle is one zip written with ``fileio.atomic_write_bytes`` (a crash
mid-dump leaves none, never a torn one):

``manifest.json``   format and version, reason, error text, exception
                    type, process identity ``{host, pid, role, run_id}``,
                    wall and monotonic times, and the SHA-256 of every
                    other member
``events.jsonl``    the tail of the event ring (obs/events.py)
``trace.json``      the span ring as Chrome trace JSON (an empty valid
                    document while the tracer is disarmed)
``metrics.json``    the default registry's snapshot and every registered
                    extra source (a server's own registry)
``config.json``     the run's Config dict (or null)
``versions.json``   python, numpy, torch, CUDA and the card's name, and
                    the package's version

``validate_bundle`` reads a bundle back the hard way (schema, member
digests, the trace's JSON) and raises ``ForensicsError``.

The hooks (``sys.excepthook``, ``threading.excepthook``, SIGTERM) are
process-wide and chain to what was there; they do nothing while the
recorder is disarmed, so whoever arms it disarms it again.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import signal
import sys
import threading
import time
import zipfile
from typing import Callable, Dict, List, Optional

from . import events, trace
from .metrics import default_registry

BUNDLE_FORMAT = "lgbmv1-forensics"
BUNDLE_VERSION = 1
BUNDLE_PREFIX = "crash-"
REQUIRED_MEMBERS = ("events.jsonl", "trace.json", "metrics.json",
                    "config.json", "versions.json")

_lock = threading.RLock()
_crash_dir: Optional[str] = None
_config: Optional[dict] = None
_metrics_sources: Dict[str, Callable[[], dict]] = {}
_dumped: Optional[str] = None      # bundle path written since last arm()
_hooks_installed = False
_prev_excepthook = None
_prev_threading_hook = None
_prev_sigterm = None


class ForensicsError(RuntimeError):
    """A bundle failed validation (missing member, digest mismatch,
    unloadable trace, schema violation)."""


def arm(crash_dir: str, config: Optional[dict] = None,
        install_hooks: bool = True) -> None:
    """Arm the recorder at ``crash_dir`` (created if absent) and reset
    the once-per-arming latch.  ``config`` rides into every bundle.
    ``install_hooks`` wires sys/threading excepthooks and SIGTERM the
    first time (idempotent; the hooks chain to their predecessors and
    no-op while disarmed)."""
    global _crash_dir, _config, _dumped
    os.makedirs(str(crash_dir), exist_ok=True)
    with _lock:
        _crash_dir = str(crash_dir)
        _config = dict(config) if config else None
        _dumped = None
    if install_hooks:
        _install_hooks()


def disarm() -> None:
    global _crash_dir, _config
    with _lock:
        _crash_dir = None
        _config = None
        _metrics_sources.clear()


def armed() -> bool:
    return _crash_dir is not None


def last_bundle() -> Optional[str]:
    with _lock:
        return _dumped


def add_metrics_source(name: str, fn: Callable[[], dict]) -> None:
    """Register an extra metrics snapshot for future bundles (e.g. a
    serving replica's own registry).  Cleared by ``disarm()``."""
    with _lock:
        _metrics_sources[str(name)] = fn


# ---------------------------------------------------------------------------
# bundle write
# ---------------------------------------------------------------------------


def _versions() -> dict:
    """python / numpy / torch / CUDA / the card, and the package's
    version (where the JAX module reports jax and libtpu)."""
    v = {"python": sys.version.split()[0]}
    for mod, key in (("numpy", "numpy"), ("torch", "torch"),
                     ("lightgbmv1_tpu_torch", "lightgbmv1_tpu_torch")):
        m = sys.modules.get(mod)
        if m is not None:
            v[key] = str(getattr(m, "__version__", "unknown"))
    torch = sys.modules.get("torch")
    if torch is not None:
        v["cuda"] = str(torch.version.cuda)
        try:
            if torch.cuda.is_available():
                v["device"] = torch.cuda.get_device_name(0)
        except Exception:   # noqa: BLE001 — a dying process still dumps
            pass
    return v


def _build_bundle_bytes(reason: str, exc: Optional[BaseException],
                        error: str) -> bytes:
    ident = events.identity()
    members: Dict[str, bytes] = {}
    members["events.jsonl"] = events.to_jsonl(
        events.tail()).encode("utf-8")
    members["trace.json"] = json.dumps(
        trace.export_chrome()).encode("utf-8")
    metrics = {"default": default_registry().snapshot()}
    with _lock:
        sources = dict(_metrics_sources)
        config = _config
    for name, fn in sources.items():
        try:
            metrics[name] = fn()
        except Exception as e:  # noqa: BLE001 — a dead server's registry
            # must not block the bundle that explains its death
            metrics[name] = {"error": f"{type(e).__name__}: {e}"}
    members["metrics.json"] = json.dumps(
        metrics, sort_keys=True, default=str).encode("utf-8")
    members["config.json"] = json.dumps(
        config, sort_keys=True, default=str).encode("utf-8")
    members["versions.json"] = json.dumps(
        _versions(), sort_keys=True).encode("utf-8")
    manifest = {
        "format": BUNDLE_FORMAT,
        "version": BUNDLE_VERSION,
        "reason": str(reason),
        "error": str(error) if error else (repr(exc) if exc else ""),
        "exc_type": type(exc).__name__ if exc is not None else None,
        "identity": ident,
        "t_wall": time.time(),
        "t_mono_ns": time.perf_counter_ns(),
        "event_count": len(events.tail()),
        "events_dropped": events.dropped(),
        "members": {name: hashlib.sha256(data).hexdigest()
                    for name, data in members.items()},
    }
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("manifest.json",
                    json.dumps(manifest, sort_keys=True, indent=1))
        for name, data in members.items():
            zf.writestr(name, data)
    return buf.getvalue()


def dump(reason: str, exc: Optional[BaseException] = None,
         error: str = "", force: bool = False) -> Optional[str]:
    """Write the forensic bundle if armed and not yet dumped this
    arming; returns the bundle path (or None: disarmed / already
    dumped / the write itself failed — a failing flight recorder never
    turns a survivable failure into a crash)."""
    global _dumped
    with _lock:
        crash_dir = _crash_dir
        if crash_dir is None or (_dumped is not None and not force):
            return None
        # latch BEFORE the (slow) build: a second trigger racing in from
        # another thread must not double-dump
        _dumped = "<in progress>"
    path = None
    try:
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in str(reason))[:64] or "crash"
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        path = os.path.join(
            crash_dir,
            f"{BUNDLE_PREFIX}{stamp}-{os.getpid()}-{safe}.zip")
        data = _build_bundle_bytes(reason, exc, error)
        from ..utils import fileio

        fileio.atomic_write_bytes(path, data, site="forensics_bundle")
        events.publish("forensics.bundle_written",
                       f"forensic bundle {path}", severity="error",
                       reason=str(reason), path=path)
    except Exception:   # noqa: BLE001
        path = None
    with _lock:
        _dumped = path
    return path


# ---------------------------------------------------------------------------
# triggers
# ---------------------------------------------------------------------------


def _install_hooks() -> None:
    global _hooks_installed, _prev_excepthook, _prev_threading_hook, \
        _prev_sigterm
    with _lock:
        if _hooks_installed:
            return
        _hooks_installed = True
    _prev_excepthook = sys.excepthook

    def _excepthook(etype, value, tb):
        dump("unhandled_exception", exc=value)
        (_prev_excepthook or sys.__excepthook__)(etype, value, tb)

    sys.excepthook = _excepthook

    _prev_threading_hook = threading.excepthook

    def _thread_hook(args):
        dump("unhandled_thread_exception", exc=args.exc_value)
        if _prev_threading_hook is not None:
            _prev_threading_hook(args)

    threading.excepthook = _thread_hook

    try:
        _prev_sigterm = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            dump("sigterm")
            prev = _prev_sigterm
            if callable(prev):
                prev(signum, frame)
            else:
                # restore the default disposition and re-deliver so the
                # process still dies with the canonical SIGTERM status
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):   # not the main thread / exotic host:
        pass                        # the other triggers still work


# ---------------------------------------------------------------------------
# read side
# ---------------------------------------------------------------------------


def list_bundles(crash_dir: str) -> List[str]:
    """Bundle paths under ``crash_dir``, oldest first."""
    try:
        names = sorted(n for n in os.listdir(str(crash_dir))
                       if n.startswith(BUNDLE_PREFIX)
                       and n.endswith(".zip"))
    except OSError:
        return []
    return [os.path.join(str(crash_dir), n) for n in names]


def read_bundle(path: str) -> Dict[str, object]:
    """Load a bundle's members WITHOUT validation (the aggregator uses
    this; forensics checks go through :func:`validate_bundle`)."""
    out: Dict[str, object] = {}
    with zipfile.ZipFile(str(path)) as zf:
        out["manifest"] = json.loads(zf.read("manifest.json"))
        for name in REQUIRED_MEMBERS:
            raw = zf.read(name)
            if name.endswith(".jsonl"):
                out[name] = events.from_jsonl(raw.decode("utf-8"))
            else:
                out[name] = json.loads(raw)
    return out


def validate_bundle(path: str) -> dict:
    """Schema + digest + loadability validation; returns the manifest or
    raises :class:`ForensicsError`.  This is the contract the chaos
    suite pins after every induced kill/wedge."""
    try:
        zf = zipfile.ZipFile(str(path))
    except (OSError, zipfile.BadZipFile) as e:
        raise ForensicsError(f"{path}: unreadable bundle ({e})")
    with zf:
        try:
            manifest = json.loads(zf.read("manifest.json"))
        except (KeyError, ValueError) as e:
            raise ForensicsError(f"{path}: bad manifest ({e})")
        if manifest.get("format") != BUNDLE_FORMAT:
            raise ForensicsError(
                f"{path}: wrong format {manifest.get('format')!r}")
        if int(manifest.get("version", -1)) != BUNDLE_VERSION:
            raise ForensicsError(
                f"{path}: unsupported version "
                f"{manifest.get('version')!r}")
        for key in ("reason", "identity", "t_wall", "members"):
            if key not in manifest:
                raise ForensicsError(f"{path}: manifest missing {key!r}")
        ident = manifest["identity"]
        for key in ("host", "pid", "role", "run_id"):
            if key not in ident:
                raise ForensicsError(f"{path}: identity missing {key!r}")
        digests = manifest["members"]
        for name in REQUIRED_MEMBERS:
            if name not in digests:
                raise ForensicsError(f"{path}: manifest lists no {name}")
            try:
                raw = zf.read(name)
            except KeyError:
                raise ForensicsError(f"{path}: member {name} missing")
            if hashlib.sha256(raw).hexdigest() != digests[name]:
                raise ForensicsError(
                    f"{path}: digest mismatch on {name} (torn or "
                    "tampered bundle)")
        # Perfetto-loadability proxy: valid JSON, a traceEvents list,
        # every complete event with non-negative rebased timestamps
        doc = json.loads(zf.read("trace.json"))
        evs = doc.get("traceEvents")
        if not isinstance(evs, list):
            raise ForensicsError(f"{path}: trace.json has no traceEvents")
        for e in evs:
            if e.get("ph") == "X" and (e.get("ts", 0) < 0
                                       or e.get("dur", 0) < 0):
                raise ForensicsError(
                    f"{path}: negative trace timestamp in {e.get('name')}")
    return manifest
