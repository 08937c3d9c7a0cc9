"""Cross-process telemetry aggregation — N processes, one timeline; the
port's copy of lightgbmv1_tpu/obs/agg.py.

A fleet run is never one process: a load generator drives a serve CLI,
training and serving run apart, and each process exports its OWN
artifacts (trace ring, metrics snapshot, event tail) because a dying
process cannot be asked to coordinate; this module is the offline half
that merges them back into one picture:

* **One Perfetto trace, pid lanes.**  Each per-process Chrome export
  carries a wall-clock anchor (``otherData.t0_unix_ns`` — the wall
  instant its relative ``ts=0`` corresponds to, recorded at ``arm()``)
  plus its identity.  The merger rebases every process onto the
  earliest anchor and assigns each artifact a distinct lane pid with a
  ``process_name`` metadata record (``role host:pid``), so Perfetto
  renders the server's dispatch batches directly under the client's
  request spans on a shared time axis.
* **One merged metrics snapshot.**  Per-process snapshots are kept
  verbatim under ``processes`` and additively merged under ``merged``:
  ``*_total`` / ``*_count`` / ``*_sum`` keys sum across processes (the
  Prometheus aggregation rule), ``*_max`` keys take the max; everything
  else is inherently per-process and stays only there.
* **One event log.**  Structured event tails interleave by wall clock —
  the cross-process "what happened in what order" a post-mortem starts
  from.

Inputs are the artifact files :func:`export_process_artifacts` writes
(``<label>.trace.json`` / ``<label>.metrics.json`` /
``<label>.events.jsonl``; the CLI writes them after every task under
``obs_dir`` or ``LGBMV1_OBS_DIR``) and — because a crashed process
leaves a forensic bundle instead of a clean export — ``crash-*.zip``
bundles (obs/dump.py), whose members are pulled in the same way.

**The device lane**: a ``torch.profiler`` capture directory
(``profile_dir``, obs/device.py) is ingested as one more trace source
per ``*.trace.json(.gz)`` it holds, rebased onto the shared wall axis
(the trace's own ``baseTimeNanoseconds``, else the
``profile.anchor.json`` sidecar).  Host phase spans rendered as
ESTIMATED (``phase.*`` children with ``estimated: true`` — the host
cannot see inside an iteration's device work) are then RECONCILED
against the device-side ranges of the kernel wrappers' ``lgbm.*``
scopes: when a phase has measured device milliseconds, its spans flip
``estimated: false`` and the per-phase agreement ratio (measured /
estimated) is recorded in ``otherData.phase_agreement``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from . import events as obs_events
from . import trace as obs_trace

TRACE_SUFFIX = ".trace.json"
METRICS_SUFFIX = ".metrics.json"
EVENTS_SUFFIX = ".events.jsonl"
MERGED_TRACE = "merged.trace.json"
MERGED_METRICS = "merged.metrics.json"


def _safe_label(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in s)


def process_label(identity: Optional[dict] = None) -> str:
    ident = identity or obs_events.identity()
    return _safe_label(
        f"{ident.get('role', 'proc')}-{ident.get('host', '?')}-"
        f"{ident.get('pid', 0)}")


def export_process_artifacts(out_dir: str,
                             label: Optional[str] = None,
                             registry=None) -> Dict[str, str]:
    """Write THIS process's trace/metrics/events artifacts into
    ``out_dir`` (atomic writes; safe under a concurrent aggregator).
    ``registry`` defaults to the process-wide default registry; a serve
    replica or a router passes its own.  The device-memory and kernel
    gauges (obs/device.py) are sampled into it first.  Returns ``{kind:
    path}``."""
    from ..utils import fileio
    from . import device as obs_device
    from .metrics import default_registry

    os.makedirs(str(out_dir), exist_ok=True)
    label = _safe_label(label) if label else process_label()
    reg = registry if registry is not None else default_registry()
    obs_device.sample_device_memory(reg)
    obs_device.sample_kernel_counters(reg)
    paths = {}

    tp = os.path.join(str(out_dir), label + TRACE_SUFFIX)
    fileio.atomic_write_bytes(
        tp, json.dumps(obs_trace.export_chrome()).encode("utf-8"),
        site="obs_artifact")
    paths["trace"] = tp

    mp = os.path.join(str(out_dir), label + METRICS_SUFFIX)
    fileio.atomic_write_bytes(
        mp, json.dumps({"identity": obs_events.identity(),
                        "snapshot": reg.snapshot()},
                       sort_keys=True, default=str).encode("utf-8"),
        site="obs_artifact")
    paths["metrics"] = mp

    ep = os.path.join(str(out_dir), label + EVENTS_SUFFIX)
    fileio.atomic_write_bytes(
        ep, obs_events.to_jsonl(obs_events.tail()).encode("utf-8"),
        site="obs_artifact")
    paths["events"] = ep
    return paths


# ---------------------------------------------------------------------------
# device lane: torch.profiler capture ingestion + phase reconciliation
# ---------------------------------------------------------------------------

# host phase span name -> the kernel scopes (ops/_build.kernel_scope,
# ``lgbm.<launch table key>``) whose device-side ranges measure it;
# phases without a kernel (partition, other) stay estimated
PHASE_SCOPE_TOKENS: Dict[str, Tuple[str, ...]] = {
    "hist": ("lgbm.hist_leaves",),
    "split": ("lgbm.split_",),
    "valid_route": ("lgbm.route_rows",),
    # hist_method=fused: routing, histogram and scan in one launch
    "round_fused": ("lgbm.fused_round", "lgbm.fused_wave_loop"),
}

# the profiler's categories of device-side rows: a kernel scope's range on
# the card's timeline (the host-side range of the same scope only times
# the enqueue)
DEVICE_SCOPE_CATS = ("gpu_user_annotation",)


def load_profiler_traces(profile_dir: str) -> List[Tuple[str, dict]]:
    """``[(label, chrome_doc)]`` from a ``torch.profiler`` capture
    directory (obs/device.py): every ``*.trace.json(.gz)`` under
    ``plugins/profile/`` (or a ``*.trace.json.gz`` directly in the
    directory) becomes one device-lane source starting at its first
    row, anchored on the wall clock so the merger can rebase it onto the
    shared axis: by the trace's own ``baseTimeNanoseconds`` (its ``ts``
    are microseconds after it), else by the ``profile.anchor.json``
    sidecar."""
    import glob as _glob
    import gzip

    from . import device as obs_device

    profile_dir = str(profile_dir)
    anchor = obs_device.read_anchor(profile_dir) or {}
    ident = anchor.get("identity") or {}
    paths = sorted(
        _glob.glob(os.path.join(profile_dir, "plugins", "profile", "*",
                                "*.trace.json.gz"))
        + _glob.glob(os.path.join(profile_dir, "plugins", "profile", "*",
                                  "*.trace.json"))
        + _glob.glob(os.path.join(profile_dir, "*.trace.json.gz")))
    docs: List[Tuple[str, dict]] = []
    for path in paths:
        try:
            if path.endswith(".gz"):
                with gzip.open(path, "rt") as fh:
                    doc = json.load(fh)
            else:
                with open(path) as fh:
                    doc = json.load(fh)
        except (OSError, ValueError) as e:
            from ..utils.log import log_warning

            log_warning(f"obs/agg: skipping unreadable profiler trace "
                        f"{path} ({type(e).__name__}: {e})")
            continue
        if not isinstance(doc, dict) or "traceEvents" not in doc:
            continue
        # python-interpreter frames (``$file:line fn`` or the
        # profiler's python_function rows) drown the kernel rows the
        # device lane exists for: drop them, keep everything else
        kept = [e for e in doc["traceEvents"]
                if not (e.get("ph") == "X"
                        and (str(e.get("name", "")).startswith("$")
                             or e.get("cat") == "python_function"))]
        dropped_frames = len(doc["traceEvents"]) - len(kept)
        other = dict(doc.get("otherData") or {})
        # rebase the lane to start at its first row, whose wall instant
        # is the trace's own base plus that row's ts (else the anchor)
        first = min((e["ts"] for e in kept
                     if isinstance(e.get("ts"), (int, float))),
                    default=0.0)
        for e in kept:
            if isinstance(e.get("ts"), (int, float)):
                e["ts"] = e["ts"] - first
        base = doc.get("baseTimeNanoseconds")
        t0 = (int(base) + int(round(first * 1e3))
              if isinstance(base, (int, float)) and base > 0
              else anchor.get("t0_unix_ns"))
        doc["traceEvents"] = kept
        if dropped_frames:
            other["python_frames_dropped"] = dropped_frames
        other.setdefault("t0_unix_ns", t0)
        other.setdefault("role", "device")
        other.setdefault("host", ident.get("host", "?"))
        other.setdefault("pid", ident.get("pid", 0))
        other.setdefault("run_id", ident.get("run_id"))
        other.setdefault("exporter", "torch.profiler")
        doc["otherData"] = other
        stem = os.path.basename(path).split(".trace.json")[0]
        docs.append(("device-" + _safe_label(stem), doc))
    return docs


def reconcile_estimated(doc: dict) -> Dict[str, Optional[float]]:
    """Reconcile estimated host phase spans against measured device rows
    in a MERGED trace document (mutates ``doc``; see module docstring).

    Returns ``{phase: agreement ratio}`` for every phase that had both
    an estimated span total and measured ``lgbm.<phase>``-scoped device
    milliseconds; those spans flip to ``estimated: false`` and carry
    ``measured_device_ms`` + ``agreement``.  Phases with no measured
    rows are untouched — an estimate stays labeled an estimate."""
    sources = (doc.get("otherData") or {}).get("sources") or []
    device_lanes = {s.get("lane") for s in sources
                    if s.get("role") == "device"}
    est: Dict[str, List[dict]] = {}
    meas: Dict[str, float] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        name = str(ev.get("name", ""))
        if name.startswith("phase.") and (ev.get("args") or {}).get(
                "estimated"):
            est.setdefault(name[len("phase."):], []).append(ev)
        elif ev.get("pid") in device_lanes \
                and ev.get("cat") in DEVICE_SCOPE_CATS:
            low = name.lower()
            for phase, tokens in PHASE_SCOPE_TOKENS.items():
                if any(t in low for t in tokens):
                    meas[phase] = meas.get(phase, 0.0) \
                        + float(ev.get("dur", 0) or 0) / 1e3
    agreement: Dict[str, Optional[float]] = {}
    for phase, spans in est.items():
        measured_ms = meas.get(phase)
        if not measured_ms:
            continue
        est_ms = sum(float(e.get("dur", 0) or 0) for e in spans) / 1e3
        ratio = round(measured_ms / est_ms, 4) if est_ms > 0 else None
        agreement[phase] = ratio
        for e in spans:
            args = e.setdefault("args", {})
            args["estimated"] = False
            args["measured_device_ms"] = round(measured_ms, 3)
            args["agreement"] = ratio
    doc.setdefault("otherData", {})["phase_agreement"] = agreement
    return agreement


# ---------------------------------------------------------------------------
# merging
# ---------------------------------------------------------------------------


def merge_trace_docs(docs: List[Tuple[str, dict]]) -> dict:
    """Merge ``[(label, chrome_doc)]`` into one Chrome trace document.

    Each source gets lane pid ``i+1`` (distinct even when two artifacts
    came from the same OS pid — e.g. two roles of one process) plus a
    ``process_name`` metadata event; timestamps are rebased onto the
    earliest wall-clock anchor so the lanes share one time axis.
    Sources without an anchor (foreign traces) keep their own zero."""
    anchors = []
    for _, doc in docs:
        t0 = (doc.get("otherData") or {}).get("t0_unix_ns")
        if isinstance(t0, (int, float)) and t0 > 0:
            anchors.append(t0)
    base = min(anchors) if anchors else 0
    merged: List[dict] = []
    sources = []
    dropped = 0
    for i, (label, doc) in enumerate(docs):
        lane = i + 1
        other = doc.get("otherData") or {}
        t0 = other.get("t0_unix_ns")
        shift_us = ((t0 - base) / 1e3
                    if isinstance(t0, (int, float)) and t0 > 0 and base
                    else 0.0)
        dropped += int(other.get("dropped_events", 0) or 0)
        name = (f"{other.get('role', label)} "
                f"{other.get('host', '?')}:{other.get('pid', '?')}"
                if other.get("role") else label)
        merged.append({"name": "process_name", "ph": "M", "pid": lane,
                       "tid": 0, "args": {"name": name}})
        merged.append({"name": "process_sort_index", "ph": "M",
                       "pid": lane, "tid": 0, "args": {"sort_index": i}})
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = lane
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            merged.append(ev)
        sources.append({"label": label, "lane": lane,
                        "host": other.get("host"),
                        "pid": other.get("pid"),
                        "role": other.get("role"),
                        "run_id": other.get("run_id"),
                        "t0_unix_ns": t0,
                        "events": len(doc.get("traceEvents", []))})
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "exporter": "lightgbmv1_tpu_torch.obs.agg",
            "merged_from": len(docs),
            "dropped_events": dropped,
            "t0_unix_ns": base,
            "sources": sources,
        },
    }


_SUM_SUFFIXES = ("_total", "_count", "_sum")
_MAX_SUFFIXES = ("_max",)


def merge_metrics_snapshots(snaps: Dict[str, dict]) -> dict:
    """``{label: snapshot}`` -> ``{"processes": ..., "merged": ...}``.
    Only additively-meaningful keys merge (see module docstring); the
    base name (before any ``{label=...}`` suffix) decides the rule."""
    merged: Dict[str, float] = {}
    for snap in snaps.values():
        for key, val in (snap or {}).items():
            if not isinstance(val, (int, float)) or isinstance(val, bool):
                continue
            base = key.split("{", 1)[0]
            if base.endswith(_SUM_SUFFIXES):
                merged[key] = merged.get(key, 0) + val
            elif base.endswith(_MAX_SUFFIXES):
                merged[key] = max(merged.get(key, val), val)
    return {"processes": dict(snaps), "merged": merged}


def merge_event_lists(lists: List[List[dict]]) -> List[dict]:
    """Interleave per-process event tails by wall clock (seq breaks
    ties within a process)."""
    flat = [e for lst in lists for e in lst]
    flat.sort(key=lambda e: (e.get("t_wall", 0), e.get("pid", 0),
                             e.get("seq", 0)))
    return flat


# ---------------------------------------------------------------------------
# directory scan + one-call aggregation
# ---------------------------------------------------------------------------


def load_artifact_dir(art_dir: str) -> dict:
    """Scan a directory for per-process artifacts AND forensic bundles;
    returns ``{"traces": [(label, doc)], "metrics": {label: snap},
    "events": [[...], ...]}`` (merged outputs of a previous run are
    skipped)."""
    traces: List[Tuple[str, dict]] = []
    metrics: Dict[str, dict] = {}
    event_lists: List[List[dict]] = []
    art_dir = str(art_dir)
    for name in sorted(os.listdir(art_dir)):
        path = os.path.join(art_dir, name)
        if name in (MERGED_TRACE, MERGED_METRICS):
            continue
        try:
            if name.endswith(TRACE_SUFFIX):
                with open(path) as fh:
                    traces.append((name[: -len(TRACE_SUFFIX)],
                                   json.load(fh)))
            elif name.endswith(METRICS_SUFFIX):
                with open(path) as fh:
                    doc = json.load(fh)
                label = name[: -len(METRICS_SUFFIX)]
                metrics[label] = doc.get("snapshot", doc)
            elif name.endswith(EVENTS_SUFFIX):
                with open(path) as fh:
                    event_lists.append(obs_events.from_jsonl(fh.read()))
            elif name.startswith("crash-") and name.endswith(".zip"):
                from . import dump

                bundle = dump.read_bundle(path)
                ident = bundle["manifest"].get("identity", {})
                label = "crash-" + process_label(ident)
                traces.append((label, bundle["trace.json"]))
                snap = bundle["metrics.json"]
                metrics[label] = snap.get("default", snap)
                event_lists.append(bundle["events.jsonl"])
        except (OSError, ValueError, KeyError) as e:
            # a torn artifact from a crashed writer: skip loudly, merge
            # the rest — forensics must degrade, not fail closed
            from ..utils.log import log_warning

            log_warning(f"obs/agg: skipping unreadable artifact "
                        f"{path} ({type(e).__name__}: {e})")
    return {"traces": traces, "metrics": metrics, "events": event_lists}


def aggregate_dir(art_dir: str, out_trace: Optional[str] = None,
                  out_metrics: Optional[str] = None,
                  profile_dir: Optional[str] = None) -> dict:
    """One-call aggregation: scan ``art_dir``, merge, optionally write
    ``merged.trace.json`` / ``merged.metrics.json`` (defaults inside
    ``art_dir``), return a summary dict.  ``profile_dir`` additionally
    ingests a ``torch.profiler`` capture as device lane(s) and
    reconciles the estimated host phase spans against the measured
    device rows."""
    from ..utils import fileio

    arts = load_artifact_dir(art_dir)
    traces = list(arts["traces"])
    if profile_dir:
        traces.extend(load_profiler_traces(profile_dir))
    trace_doc = merge_trace_docs(traces)
    agreement = reconcile_estimated(trace_doc)
    metrics_doc = merge_metrics_snapshots(arts["metrics"])
    merged_events = merge_event_lists(arts["events"])
    out_trace = out_trace or os.path.join(str(art_dir), MERGED_TRACE)
    out_metrics = out_metrics or os.path.join(str(art_dir),
                                              MERGED_METRICS)
    fileio.atomic_write_bytes(
        out_trace, json.dumps(trace_doc).encode("utf-8"),
        site="obs_merged")
    fileio.atomic_write_bytes(
        out_metrics,
        json.dumps({**metrics_doc, "events": merged_events},
                   sort_keys=True, default=str).encode("utf-8"),
        site="obs_merged")
    lanes = {e["pid"] for e in trace_doc["traceEvents"]
             if e.get("ph") == "X"}
    device_lanes = {s["lane"] for s in trace_doc["otherData"]["sources"]
                    if s.get("role") == "device"}
    return {
        "sources": [s["label"] for s in
                    trace_doc["otherData"]["sources"]],
        "lanes": len(lanes),
        "device_lanes": len(device_lanes & lanes),
        "phase_agreement": agreement,
        "trace_events": sum(1 for e in trace_doc["traceEvents"]
                            if e.get("ph") == "X"),
        "merged_events": len(merged_events),
        "metrics_processes": sorted(metrics_doc["processes"]),
        "merged_trace": out_trace,
        "merged_metrics": out_metrics,
    }
