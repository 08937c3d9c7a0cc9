"""The port's cross-process aggregation (obs/agg.py), its device lane
(obs/device.py) and the CLI's ``obs_dir`` / ``LGBMV1_OBS_DIR`` /
``profile_dir`` against the JAX package's, on the CPU (JAX
tests/test_agg.py, tests/test_xla_obs.py's profiler and memory cases).

* ``merge_trace_docs``, ``merge_metrics_snapshots``,
  ``merge_event_lists`` and ``reconcile_estimated`` give the JAX
  functions' outputs on the same inputs (the port reads a kernel scope's
  device-side range, ``gpu_user_annotation``, never its host range).
* ``aggregate_dir`` merges the port's own artifacts and a crash bundle
  of the port's obs/dump.py, and the JAX ``aggregate_dir`` reads the
  same directory to the same summary.
* ``profiler_session`` writes the anchor and a ``torch.profiler`` trace
  that ``load_profiler_traces`` ingests as a device lane on the shared
  wall axis; kernel scopes exist only while a capture is armed;
  ``device_memory_stats`` is None on the CPU; the kernel gauges equal
  the launch tables.
* ``task=train`` and ``task=predict`` write the per-process artifacts to
  ``obs_dir`` and to ``LGBMV1_OBS_DIR``, and ``profile_dir`` captures
  the window.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from lightgbmv1_tpu.obs import agg as jagg

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch import cli as tcli
from lightgbmv1_tpu_torch.obs import agg as tagg
from lightgbmv1_tpu_torch.obs import device as tdevice
from lightgbmv1_tpu_torch.obs import dump as tdump
from lightgbmv1_tpu_torch.obs import events as tevents
from lightgbmv1_tpu_torch.obs import trace as ttrace
from lightgbmv1_tpu_torch.obs.metrics import Registry
from lightgbmv1_tpu_torch.ops import _build
from lightgbmv1_tpu_torch.ops import predict_cuda

from conftest import make_binary_problem

BASE = 1_000_000_000_000_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_tracer():
    ttrace.reset()
    yield
    ttrace.reset()


def _doc(role, pid, t0, spans, cat="t"):
    return {"traceEvents": [{"name": n, "cat": cat, "ph": "X", "ts": ts,
                             "dur": dur, "pid": pid, "tid": 1}
                            for n, ts, dur in spans],
            "otherData": {"t0_unix_ns": t0, "host": "h", "pid": pid,
                          "role": role, "run_id": "r",
                          "dropped_events": 1}}


def _docs():
    return [("A", _doc("trainer", 100, BASE, [("a.work", 0.0, 50.0)])),
            ("B", _doc("server", 100, BASE + 2_000_000,
                       [("b.work", 10.0, 5.0)])),
            ("F", {"traceEvents": [{"name": "f", "ph": "X", "ts": 7.0,
                                    "dur": 1.0, "pid": 9, "tid": 0}]})]


def test_merge_trace_docs_matches_jax():
    """Lanes, names, the rebase onto the earliest anchor and a foreign
    doc kept at its own zero, as the JAX merger."""
    t = tagg.merge_trace_docs(copy.deepcopy(_docs()))
    j = jagg.merge_trace_docs(copy.deepcopy(_docs()))
    assert t["traceEvents"] == j["traceEvents"]
    t["otherData"].pop("exporter")
    j["otherData"].pop("exporter")
    assert t["otherData"] == j["otherData"]
    b = [e for e in t["traceEvents"] if e.get("name") == "b.work"][0]
    assert b["ts"] == pytest.approx(2010.0)


def test_merge_metrics_and_events_match_jax():
    snaps = {"p1": {"req_total": 3, "lat_ms_sum": 10.0, "lat_ms_count": 4,
                    "queue_depth_max": 7, "queue_depth": 2, "frac": 0.5,
                    'byo_total{k="v"}': 2, "flag": True},
             "p2": {"req_total": 5, "lat_ms_sum": 2.5, "lat_ms_count": 1,
                    "queue_depth_max": 3, 'byo_total{k="v"}': 1}}
    assert tagg.merge_metrics_snapshots(snaps) \
        == jagg.merge_metrics_snapshots(snaps)
    m = tagg.merge_metrics_snapshots(snaps)["merged"]
    assert m["req_total"] == 8 and m["queue_depth_max"] == 7
    assert "queue_depth" not in m and "flag" not in m
    lists = [[{"t_wall": 10.0, "seq": 1, "pid": 1, "kind": "a"},
              {"t_wall": 30.0, "seq": 2, "pid": 1, "kind": "c"}],
             [{"t_wall": 20.0, "seq": 1, "pid": 2, "kind": "b"},
              {"t_wall": 20.0, "seq": 0, "pid": 2, "kind": "b0"}]]
    assert tagg.merge_event_lists(lists) == jagg.merge_event_lists(lists)
    assert [e["kind"] for e in tagg.merge_event_lists(lists)] \
        == ["a", "b0", "b", "c"]


def test_reconcile_estimated_matches_jax():
    """Estimated phase spans flip to measured where the device lane has
    the phase's kernel scopes: the agreement equals the JAX function's
    on device-side scope rows, and the port ignores a scope's host-side
    range."""
    host = _doc("trainer", 1, BASE, [])
    host["traceEvents"] = [
        {"name": f"phase.{p}", "ph": "X", "ts": 0.0, "dur": d, "pid": 1,
         "tid": 1, "args": {"estimated": True}}
        for p, d in (("hist", 400.0), ("split", 100.0),
                     ("round_fused", 50.0), ("other", 10.0))]
    dev = _doc("device", 1, BASE, [("lgbm.hist_leaves", 5.0, 300.0),
                                   ("lgbm.split_scan", 9.0, 80.0),
                                   ("lgbm.fused_round", 20.0, 60.0)],
               cat="gpu_user_annotation")
    dev["traceEvents"].append({"name": "lgbm.hist_leaves", "cat": "cpu_op",
                               "ph": "X", "ts": 1.0, "dur": 7.0, "pid": 1,
                               "tid": 2})
    out = {}
    for tag, agg in (("t", tagg), ("j", jagg)):
        merged = agg.merge_trace_docs(copy.deepcopy(
            [("host", host), ("device", dev)]))
        if tag == "j":      # the JAX side sees only the device rows
            merged["traceEvents"] = [e for e in merged["traceEvents"]
                                     if e.get("cat") != "cpu_op"]
        out[tag] = (agg.reconcile_estimated(merged), merged)
    assert out["t"][0] == out["j"][0] == {"hist": 0.75, "split": 0.8,
                                          "round_fused": 1.2}
    flips = [e["args"] for e in out["t"][1]["traceEvents"]
             if e.get("name", "").startswith("phase.")]
    assert [a["estimated"] for a in flips] == [False, False, False, True]


def test_aggregate_dir_on_port_artifacts_and_a_crash_bundle(tmp_path):
    """A crashed process's bundle (the port's obs/dump.py) and a clean
    export merge into one trace and one snapshot; the JAX aggregate_dir
    reads the same directory to the same summary."""
    ttrace.arm(ring_events=64)
    with ttrace.span("doomed.work"):
        pass
    tdump.arm(str(tmp_path))
    try:
        assert tdump.dump("agg_test") is not None
    finally:
        tdump.disarm()
    ttrace.reset()
    reg = Registry()
    reg.counter("x_total").inc(2)
    ttrace.arm(ring_events=64)
    with ttrace.span("survivor.work"):
        pass
    paths = tagg.export_process_artifacts(str(tmp_path), label="survivor",
                                          registry=reg)
    assert sorted(paths) == ["events", "metrics", "trace"]
    summary = tagg.aggregate_dir(str(tmp_path))
    assert len(summary["sources"]) == 2 and summary["lanes"] == 2
    with open(summary["merged_trace"]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"doomed.work", "survivor.work"} <= names
    with open(summary["merged_metrics"]) as fh:
        merged = json.load(fh)
    assert merged["merged"]["x_total"] == 2
    # the export sampled the kernel gauges into the survivor's registry
    assert any(k.startswith("kernel_launches_total{")
               for k in merged["processes"]["survivor"])
    jsum = jagg.aggregate_dir(str(tmp_path),
                              out_trace=str(tmp_path / "j.json"),
                              out_metrics=str(tmp_path / "j.m.json"))
    for key in ("sources", "lanes", "trace_events", "merged_events",
                "metrics_processes"):
        assert jsum[key] == summary[key], key


def test_profiler_session_writes_a_lane_the_merger_aligns(tmp_path):
    """On the CPU: the capture writes its anchor and a Chrome trace under
    plugins/profile/, ``load_profiler_traces`` ingests it as a device
    lane anchored on the wall clock next to the host spans, and the
    kernel scopes exist only inside the capture."""
    prof = tmp_path / "prof"
    assert _build.kernel_scope("x") is _build.kernel_scope("y")
    ttrace.arm(ring_events=256)
    with tdevice.profiler_session(str(prof)) as session:
        assert _build._scopes
        with ttrace.span("host.window"):
            with _build.kernel_scope("serving_fused"):
                (torch.randn(32, 32) @ torch.randn(32, 32)).sum()
    assert not _build._scopes
    assert _build.kernel_scope("x") is _build.kernel_scope("y")
    assert not tdevice.stop_profiler(session)      # export once
    anchor = tdevice.read_anchor(str(prof))
    assert anchor["t0_unix_ns"] == session["t0_unix_ns"]
    assert anchor["identity"]["pid"] == os.getpid()
    assert anchor["trace"].startswith("plugins/profile/")
    docs = tagg.load_profiler_traces(str(prof))
    assert len(docs) == 1
    label, doc = docs[0]
    assert label.startswith("device-")
    assert doc["otherData"]["role"] == "device"
    assert doc["otherData"]["exporter"] == "torch.profiler"
    scopes = [e for e in doc["traceEvents"]
              if e.get("name") == "lgbm.serving_fused"]
    assert scopes
    tagg.export_process_artifacts(str(tmp_path / "obs"), label="host")
    summary = tagg.aggregate_dir(str(tmp_path / "obs"),
                                 profile_dir=str(prof))
    assert summary["lanes"] == 2 and summary["device_lanes"] == 1
    with open(summary["merged_trace"]) as fh:
        merged = json.load(fh)["traceEvents"]
    host = [e for e in merged if e.get("name") == "host.window"][0]
    scope = [e for e in merged if e.get("name") == "lgbm.serving_fused"][0]
    assert host["pid"] != scope["pid"]
    # one wall axis: the scope lies inside the host span (1 ms slack for
    # the profiler's own clock conversion)
    assert host["ts"] - 1e3 <= scope["ts"] <= host["ts"] + host["dur"] \
        + 1e3


def test_device_gauges_on_the_cpu():
    """No allocator on the CPU: the memory stats and gauges are absent;
    the kernel gauges mirror the launch tables, resets included, and
    name every table of the wrappers."""
    assert tdevice.device_memory_stats() is None
    reg = Registry()
    assert tdevice.sample_device_memory(reg) is None
    assert not any(k.startswith("device_") for k in reg.snapshot())
    try:
        predict_cuda.launch_counts["serving_fused"] += 3
        got = tdevice.sample_kernel_counters(reg)
        snap = reg.snapshot()
        key = ('kernel_launches_total{table="ops/predict_cuda.'
               'launch_counts",kernel="serving_fused"}')
        assert snap[key] == 3
        assert got["ops/predict_cuda.launch_counts"]["serving_fused"] == 3
        for name, table in tdevice.launch_tables():
            assert got[name] == {(k if isinstance(k, str) else repr(k)):
                                 v for k, v in table.items()}
        predict_cuda.reset_launch_counts()
        tdevice.sample_kernel_counters(reg)
        assert reg.snapshot()[key] == 0
    finally:
        predict_cuda.reset_launch_counts()
    tables = {n.split(".")[0] for n, _ in tdevice.launch_tables()}
    assert tables == {"ops/predict_cuda", "ops/hist_cuda", "ops/fused_cuda",
                      "ops/loop_cuda", "ops/scan_cuda", "ops/quantize"}


@pytest.fixture()
def csv_files(tmp_path):
    X, y = make_binary_problem(600, 5, seed=4)
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    return str(path), tmp_path


@pytest.mark.parametrize("via", ["knob", "env"])
def test_cli_exports_artifacts_after_every_task(via, csv_files,
                                                monkeypatch):
    """``task=train`` then ``task=predict``: each run writes its
    process's trace, metrics and events to ``obs_dir`` (or
    ``LGBMV1_OBS_DIR``), which merge into one summary; ``profile_dir``
    captures the train window."""
    data, tmp = csv_files
    obs, prof = tmp / "obs", tmp / "prof"
    knob = [f"obs_dir={obs}"] if via == "knob" else []
    if via == "env":
        monkeypatch.setenv("LGBMV1_OBS_DIR", str(obs))
    common = ["device_type=cpu", "verbosity=-1", "header=false"]
    role = tevents.identity()["role"]
    try:
        assert tcli.main(["task=train", f"data={data}", "objective=binary",
                          "num_leaves=7", "num_iterations=2",
                          f"output_model={tmp / 'm.txt'}",
                          f"profile_dir={prof}", *knob, *common]) == 0
        trained = sorted(os.listdir(obs))
        assert tcli.main(["task=predict", f"data={data}",
                          f"input_model={tmp / 'm.txt'}",
                          f"output_result={tmp / 'p.txt'}", *knob,
                          *common]) == 0
    finally:
        tevents.set_identity(role=role)
    assert [n.split(".", 1)[1] for n in trained] \
        == ["events.jsonl", "metrics.json", "trace.json"]
    assert all(n.startswith("train-") for n in trained)
    roles = {n.split("-", 1)[0] for n in os.listdir(obs)}
    assert roles == {"train", "predict"}
    meta = json.load(open(obs / [n for n in trained
                                 if n.endswith(".metrics.json")][0]))
    assert sorted(meta) == ["identity", "snapshot"]
    assert tdevice.read_anchor(str(prof)) is not None
    labels = sorted(n[:-len(".metrics.json")] for n in os.listdir(obs)
                    if n.endswith(".metrics.json"))
    summary = tagg.aggregate_dir(str(obs), profile_dir=str(prof))
    assert summary["metrics_processes"] == labels
    assert summary["device_lanes"] == 1
