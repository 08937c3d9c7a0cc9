"""Device-truth telemetry on the card: what the kernels and the allocator
actually did.  The port's counterpart of lightgbmv1_tpu/obs/xla.py.

Three surfaces:

* **Profiler lane** (:func:`profiler_session` / :func:`start_profiler` /
  :func:`stop_profiler`) — a ``torch.profiler`` capture (CPU and, on a
  card, CUDA activities) around a window, exported once as Chrome JSON
  (``plugins/profile/<run>/<label>.trace.json``, the JAX profiler's
  layout) under the capture directory, with the
  wall-clock anchor sidecar ``profile.anchor.json`` (the JAX package's
  schema) beside it, so obs/agg.py rebases the device lane onto the
  host span lanes.  While a capture is armed every kernel wrapper's
  launch runs inside a ``record_function("lgbm.<kernel>")`` scope
  (``ops/_build.kernel_scope``); unarmed, a wrapper takes one shared
  no-op context.
* **Device-memory gauges** (:func:`device_memory_stats` /
  :func:`sample_device_memory`) — the caching allocator's view from
  ``torch.cuda.memory_stats``; ``None`` on the CPU (absence is a value
  here, never an exception).
* **Kernel gauges** (:func:`sample_kernel_counters`) — every kernel
  wrapper's launch table (``ops/predict_cuda``, ``ops/hist_cuda``,
  ``ops/fused_cuda``, ``ops/loop_cuda``, ``ops/scan_cuda``,
  ``ops/quantize``, with their leg and bucket tables) as one counter
  labelled by table and kernel, and each ``nvcc`` build's seconds
  (``ops/_build.build_log``), in one registry.  A counter mirrors its
  table: ``reset_launch_counts`` is its reset.

The JAX module's labelled lower/compile wrapper (``instrument_jit``) has
no counterpart: the port compiles no program at run time, and its
kernels are built once by ``nvcc`` (whose seconds are the build gauges
above).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

ANCHOR_FILE = "profile.anchor.json"

_MEM_KEYS = (("allocated_bytes.all.current", "bytes_in_use"),
             ("allocated_bytes.all.peak", "peak_bytes_in_use"),
             ("reserved_bytes.all.current", "bytes_reserved"),
             ("reserved_bytes.all.peak", "peak_bytes_reserved"),
             ("num_alloc_retries", "alloc_retries"),
             ("num_ooms", "ooms"))


# ---------------------------------------------------------------------------
# live device memory (None on the CPU)
# ---------------------------------------------------------------------------


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The caching allocator's live view of ``device`` (default: the
    current card) from ``torch.cuda.memory_stats``, under the JAX
    gauges' names (``bytes_in_use``, ``peak_bytes_in_use``, ...) plus
    ``bytes_limit`` (the card's memory).  ``None`` on the CPU or when
    anything fails."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        if device is not None and torch.device(device).type != "cuda":
            return None
        raw = torch.cuda.memory_stats(device)
        limit = torch.cuda.get_device_properties(
            device if device is not None
            else torch.cuda.current_device()).total_memory
    except Exception:   # noqa: BLE001
        return None
    out = {name: int(raw[key]) for key, name in _MEM_KEYS if key in raw}
    out["bytes_limit"] = int(limit)
    return out


def sample_device_memory(registry=None) -> Optional[Dict[str, int]]:
    """Sample :func:`device_memory_stats` into ``device_<key>`` gauges of
    ``registry`` (default: the process registry).  Returns the stats
    (None on the CPU: the gauges are simply not written)."""
    stats = device_memory_stats()
    if stats is None:
        return None
    from .metrics import default_registry

    reg = registry if registry is not None else default_registry()
    for key, value in stats.items():
        reg.gauge(f"device_{key}",
                  "CUDA caching allocator view (torch.cuda.memory_stats)"
                  ).set(value)
    return stats


# ---------------------------------------------------------------------------
# kernel gauges: launch tables and nvcc build seconds
# ---------------------------------------------------------------------------

# (module under ops/, its launch tables: the kernels', their legs' and
# their buckets'; the plain versions' counts are not launches)
KERNEL_TABLES = (
    ("predict_cuda", ("launch_counts",)),
    ("hist_cuda", ("launch_counts", "bucket_launch_counts")),
    ("fused_cuda", ("launch_counts", "int16_launch_counts",
                    "bundle_launch_counts", "cat_launch_counts",
                    "bucket_launch_counts")),
    ("loop_cuda", ("launch_counts", "bucket_launch_counts")),
    ("scan_cuda", ("launch_counts", "opt_launch_counts",
                   "cegb_launch_counts")),
    ("quantize", ("launch_counts",)),
)


def launch_tables() -> List[Tuple[str, Dict]]:
    """``[("ops/<module>.<table>", table)]`` of every kernel launch
    table, the live dicts the wrappers count into."""
    import importlib

    out = []
    for mod, tables in KERNEL_TABLES:
        m = importlib.import_module(f"lightgbmv1_tpu_torch.ops.{mod}")
        out += [(f"ops/{mod}.{t}", getattr(m, t)) for t in tables]
    return out


def sample_kernel_counters(registry=None) -> Dict[str, Dict[str, int]]:
    """Copy every launch table into ``kernel_launches_total{table,
    kernel}`` and every ``nvcc`` build's wall into
    ``kernel_build_seconds{library}`` of ``registry`` (default: the
    process registry).  Returns ``{table: {kernel: launches}}`` as
    copied."""
    from ..ops import _build
    from .metrics import default_registry

    reg = registry if registry is not None else default_registry()
    launches = reg.counter(
        "kernel_launches_total",
        "Kernel launches by wrapper table (mirrors ops/*.launch_counts; "
        "reset_launch_counts resets it)",
        label_names=("table", "kernel"), label_cardinality=4096)
    out: Dict[str, Dict[str, int]] = {}
    for name, table in launch_tables():
        copied = out.setdefault(name, {})
        for key, value in list(table.items()):
            kernel = key if isinstance(key, str) else repr(key)
            child = launches.labels(table=name, kernel=kernel)
            with launches.lock:
                child.value = float(value)
            copied[kernel] = int(value)
    builds = reg.gauge("kernel_build_seconds",
                       "Wall seconds of each library's nvcc build",
                       label_names=("library",))
    for lib, rec in list(_build.build_log.items()):
        builds.labels(library=lib).set(float(rec["seconds"]))
    return out


# ---------------------------------------------------------------------------
# profiler lane (torch.profiler capture + wall-clock anchor sidecar)
# ---------------------------------------------------------------------------


def start_profiler(out_dir: str) -> Dict[str, Any]:
    """Arm a ``torch.profiler`` capture writing into ``out_dir`` (CPU
    activity, and CUDA activity when a card is present) and return the
    session dict: the wall-clock anchor, the process identity and the
    live profiler.  Kernel scopes are on until :func:`stop_profiler`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import _build
    from . import events as obs_events

    os.makedirs(str(out_dir), exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    session = {"profile_dir": str(out_dir),
               "t0_unix_ns": time.time_ns(),
               "identity": obs_events.identity(),
               "activities": [a.name for a in acts],
               "_prof": prof, "_open": True}
    prof.start()
    _build.set_kernel_scopes(True)
    return session


def stop_profiler(session: Optional[Dict[str, Any]]) -> bool:
    """Stop the session exactly once (safe from the crash path and the
    clean path alike), export its Chrome trace and write the anchor
    sidecar.  Returns True on the call that actually stopped it."""
    if not session or not session.get("_open"):
        return False
    session["_open"] = False
    from ..ops import _build
    from ..utils import fileio
    from .agg import process_label

    _build.set_kernel_scopes(False)
    prof = session["_prof"]
    out_dir = session["profile_dir"]
    # the JAX profiler's layout (plugins/profile/<run>/), so a capture
    # directory that is also the obs_dir never mixes with the artifacts
    label = process_label(session["identity"])
    run = os.path.join(out_dir, "plugins", "profile",
                       f"{label}-{session['t0_unix_ns']}")
    os.makedirs(run, exist_ok=True)
    trace = os.path.join(run, label + ".trace.json")
    try:
        prof.stop()
        prof.export_chrome_trace(trace)
        session["trace"] = os.path.relpath(trace, out_dir)
    finally:
        doc = {k: v for k, v in session.items() if not k.startswith("_")}
        fileio.atomic_write_bytes(
            os.path.join(out_dir, ANCHOR_FILE),
            json.dumps(doc, sort_keys=True).encode("utf-8"),
            site="profile_anchor")
    return True


class profiler_session:
    """``with profiler_session(dir) as s:`` — capture the block and write
    the trace and the anchor sidecar on exit (any exit)."""

    def __init__(self, out_dir: str):
        self._dir = out_dir
        self.session: Optional[Dict[str, Any]] = None

    def __enter__(self):
        self.session = start_profiler(self._dir)
        return self.session

    def __exit__(self, *exc):
        stop_profiler(self.session)
        return False


def read_anchor(profile_dir: str) -> Optional[Dict[str, Any]]:
    """The anchor sidecar of a capture directory, or None."""
    path = os.path.join(str(profile_dir), ANCHOR_FILE)
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None
