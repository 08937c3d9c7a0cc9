"""The port's observability core against the JAX package's, on the CPU
(JAX tests/test_obs.py): the one metrics registry (the same operations
give identical Prometheus text and snapshots, the cardinality cap and
the non-finite guard included), the span tracer (nesting, the ring,
trace ids, the off path, the export's schema), the event ring and its
log hooks, the crash-dump bundle (each package validates the other's),
the phase timer's report and training's iteration spans.
"""

import gc
import json
import re
import sys
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

from lightgbmv1_tpu.obs import dump as jdump
from lightgbmv1_tpu.obs import events as jevents
from lightgbmv1_tpu.obs import metrics as jmetrics
from lightgbmv1_tpu.obs import trace as jtrace
from lightgbmv1_tpu.utils import log as jlog
from lightgbmv1_tpu.utils.timer import Timer as JTimer

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.obs import dump as tdump
from lightgbmv1_tpu_torch.obs import events as tevents
from lightgbmv1_tpu_torch.obs import metrics as tmetrics
from lightgbmv1_tpu_torch.obs import trace as ttrace
from lightgbmv1_tpu_torch.utils import log as tlog
from lightgbmv1_tpu_torch.utils.timer import Timer as TTimer

PKGS = {"t": (tmetrics, ttrace, tevents, tdump, tlog),
        "j": (jmetrics, jtrace, jevents, jdump, jlog)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test leaves both tracers disarmed and reset."""
    yield
    ttrace.reset()
    jtrace.reset()


def _registry_ops(m):
    """One script of registry operations on package ``m``'s metrics."""
    reg = m.Registry()
    c = reg.counter("req_total", "Requests", label_names=("route",))
    c.labels(route='/a"b\\c\nd').inc(3)
    c.labels(route="/x").inc()
    g = reg.gauge("depth", "Queue depth")
    g.set(7)
    g.set_max(5)
    g.set_max(11.5)
    h = reg.histogram("lat_ms", "Latency\nline", buckets=(1, 5, 10),
                      sample_window=4)
    for v in (0.5, 4.0, 9.0, 50.0, 3.0):
        h.observe(v, exemplar={"trace_id": f"id{v}"})
    h.observe(float("nan"))              # rejected and counted
    capped = reg.counter("per_tenant_total", "Capped",
                         label_names=("tenant",), label_cardinality=3)
    for i in range(6):
        capped.labels(tenant=f"t{i}").inc(i + 1)
    lab = reg.histogram("walk_ms", "Walk", label_names=("kind",),
                        buckets=(2, 4))
    lab.labels(kind="a").observe(1.0)
    lab.labels(kind="b").observe(3.0)
    reg.reset(["depth"])
    return reg, h


def test_registry_matches_jax():
    """The same operations give byte-identical Prometheus text and
    snapshots (escaping, cumulative buckets, the overflow child and its
    counter, the rejected NaN), and the same exact quantiles; the
    OpenMetrics exemplar suffixes agree apart from their timestamps."""
    treg, th = _registry_ops(tmetrics)
    jreg, jh = _registry_ops(jmetrics)
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert treg.snapshot() == jreg.snapshot()
    for q in (0.0, 0.5, 0.99):
        assert th.quantile(q) == jh.quantile(q)
    no_ts = re.compile(r" \d+\.\d{3}$", re.MULTILINE)
    assert no_ts.sub("", treg.prometheus_text(exemplars=True)) \
        == no_ts.sub("", jreg.prometheus_text(exemplars=True))
    assert [(le, ex["trace_id"], ex["value"]) for le, ex in th.exemplars()] \
        == [(le, ex["trace_id"], ex["value"]) for le, ex in jh.exemplars()]
    assert 'per_tenant_total{tenant="_overflow"} 15' in treg.prometheus_text()


def test_registry_conflicts_and_thread_safety():
    """Get-or-create returns the same metric; a re-registration of
    another kind raises as in the JAX package; eight threads' increments
    all land."""
    for m in (tmetrics, jmetrics):
        reg = m.Registry()
        assert reg.counter("a") is reg.counter("a")
        with pytest.raises(ValueError):
            reg.gauge("a")
        with pytest.raises(ValueError):
            reg.counter("a").set(1)
    reg = tmetrics.Registry()
    c = reg.counter("n", label_names=("k",))

    def work(i):
        for _ in range(500):
            c.labels(k=str(i % 2)).inc()

    ths = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    assert reg.snapshot() == {'n{k="0"}': 2000, 'n{k="1"}': 2000}


def _trace_script(tr):
    """Nested spans, a retro-recorded span, an instant and a trace id on
    package ``tr``'s tracer; returns the export without timestamps."""
    tr.arm(ring_events=64)
    tr.set_trace_id("abcdef0123456789")
    with tr.span("outer", cat="serve", args={"rows": 3}):
        with tr.span("inner"):
            assert tr.depth() == 2
    tr.set_trace_id(None)
    tr.add_span("retro", tr.now_ns(), 1000, cat="serve",
                args={"batch_rows": 8})
    tr.instant("mark")
    doc = tr.export_chrome()
    tr.disarm()
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    return ([(e["name"], e["cat"], e.get("args")) for e in evs],
            sorted(doc["otherData"]), sorted(doc))


def test_tracer_matches_jax():
    """The same span script exports the same events (names, categories,
    args with the bound trace id) in the same order and the same
    document schema."""
    t_evs, t_other, t_keys = _trace_script(ttrace)
    j_evs, j_other, j_keys = _trace_script(jtrace)
    assert t_evs == j_evs
    assert ("inner", "app", {"trace_id": "abcdef0123456789"}) in t_evs
    assert t_other == j_other and t_keys == j_keys


def test_tracer_ring_and_rearm_match_jax():
    """A 16-event ring keeps the newest and counts the dropped; a span
    entered before a re-arm is dropped at export, in both packages."""
    out = {}
    for tag, tr in (("t", ttrace), ("j", jtrace)):
        tr.arm(ring_events=16)
        for i in range(40):
            with tr.span(f"s{i}"):
                pass
        doc = tr.export_chrome()
        names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
        sp = tr.span("straddle")
        sp.__enter__()
        tr.arm(ring_events=16)
        sp.__exit__(None, None, None)
        doc2 = tr.export_chrome()
        tr.disarm()
        out[tag] = (names, doc["otherData"]["dropped_events"],
                    doc2["otherData"]["pre_arm_dropped"])
    assert out["t"] == out["j"]
    assert out["t"][0] == [f"s{i}" for i in range(24, 40)]
    assert out["t"][1:] == (24, 1)


def test_disarmed_span_allocates_nothing():
    """The off path: ``span()`` returns the shared no-op and a hot loop
    allocates nothing (JAX test_obs.py's pin)."""
    assert not ttrace.enabled()
    assert ttrace.span("a") is ttrace.span("b")
    delta = 1 << 30
    for _ in range(3):
        gc.collect()
        before = sys.getallocatedblocks()
        for _ in range(10_000):
            with ttrace.span("hot"):
                pass
        delta = min(delta, sys.getallocatedblocks() - before)
    assert delta < 50, f"disarmed span path allocated {delta} blocks"


def test_phase_profile_children_match_jax():
    """An installed phase profile lays out the same estimated
    wave-round and phase children under an iteration span."""
    out = {}
    for tag, tr in (("t", ttrace), ("j", jtrace)):
        tr.arm()
        tr.set_phase_profile({"hist": 3.0, "split": 1.0, "zero": 0.0},
                             rounds_per_iter=2)
        t0 = tr.now_ns()
        time.sleep(0.004)
        tr.iteration_span_end(t0, 7)
        doc = tr.export_chrome()
        out[tag] = [(e["name"], e.get("args")) for e in doc["traceEvents"]
                    if e["ph"] == "X"]
    assert out["t"] == out["j"]
    assert [n for n, _ in out["t"]] == [
        "train.iteration", "wave.round", "phase.hist", "phase.split",
        "wave.round", "phase.hist", "phase.split"]


def test_events_and_log_hooks_match_jax():
    """The event ring: the same publishes give events of the same keys
    and fields, ``tail`` filters alike, a ring of 16 keeps the newest;
    a warning publishes ``log.warning`` and counts in
    ``log_messages_total`` in both packages."""
    out = {}
    for tag, (m, tr, ev, _, lg) in PKGS.items():
        # verbosity is process-wide: a test that ran before in this
        # worker may have silenced warnings
        level = lg._level
        lg.set_verbosity(0)
        ev.configure(16)
        mark = ev.seq()
        tr.set_trace_id("feedbeef00000000")
        ev.publish("serve.shed", "queue full", severity="warning", rows=3)
        tr.set_trace_id(None)
        for i in range(20):
            ev.publish("x.tick", f"{i}")
        ev.publish("bogus", severity="loud")
        before = m.default_registry().snapshot().get(
            'log_messages_total{level="warning"}', 0)
        lines = []
        lg.register_callback(lines.append)
        try:
            lg.log_warning("careful")
        finally:
            lg.register_callback(None)
            lg.set_verbosity(level)
        after = m.default_registry().snapshot()[
            'log_messages_total{level="warning"}']
        tail = ev.tail()
        shed = [e for e in ev.tail(since_seq=mark)
                if e["kind"] == "serve.shed"]
        out[tag] = {
            "keys": sorted(tail[-1]), "n": len(tail),
            "dropped": ev.dropped(),
            "kinds": [e["kind"] for e in ev.tail(n=3)],
            "warn": [e["message"] for e in ev.tail(kind_prefix="log.")][-1:],
            "shed_lost": shed == [],
            "bogus": [e["severity"] for e in tail if e["kind"] == "bogus"],
            "counted": after - before, "lines": lines}
        ev.configure(ev.DEFAULT_RING_EVENTS)
    assert out["t"] == out["j"]
    assert out["t"]["kinds"] == ["x.tick", "bogus", "log.warning"]
    assert out["t"]["counted"] == 1 and out["t"]["bogus"] == ["info"]


def test_crash_bundle_is_valid_in_both_packages(tmp_path):
    """An armed recorder writes one bundle at the first trigger (a
    fatal log), none at the second; its members validate with the port's
    and the JAX package's ``validate_bundle`` alike, and its
    ``versions.json`` names torch.  Disarmed in a finally: the hooks are
    process-wide."""
    try:
        tdump.arm(str(tmp_path), config={"task": "serve"})
        ttrace.arm()
        with ttrace.span("before.crash"):
            pass
        tevents.publish("test.marker", "before the crash")
        with pytest.raises(tlog.LightGBMError):
            tlog.log_fatal("boom")
        assert tdump.dump("second") is None        # one bundle an arming
        path = tdump.last_bundle()
    finally:
        tdump.disarm()
        ttrace.reset()
    assert tdump.list_bundles(str(tmp_path)) == [path]
    t_man = tdump.validate_bundle(path)
    j_man = jdump.validate_bundle(path)
    assert t_man == j_man and t_man["reason"] == "fatal"
    assert t_man["error"] == "boom"
    b = tdump.read_bundle(path)
    assert "torch" in b["versions.json"]
    assert b["config.json"] == {"task": "serve"}
    assert "before.crash" in {e["name"] for e in
                              b["trace.json"]["traceEvents"]}
    assert "test.marker" in {e["kind"] for e in b["events.jsonl"]}
    bad = str(tmp_path / "crash-tampered.zip")
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(bad, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            zout.writestr(name, data + b"\n" if name == "events.jsonl"
                          else data)
    for validate in (tdump.validate_bundle, jdump.validate_bundle):
        with pytest.raises((tdump.ForensicsError, jdump.ForensicsError),
                           match="digest mismatch"):
            validate(bad)


def test_thread_hook_dumps_unhandled_exception(tmp_path):
    """An exception escaping a thread dumps through the thread hook
    while armed and nothing once disarmed."""
    def die():
        raise RuntimeError("thread died")

    try:
        tdump.arm(str(tmp_path))
        t = threading.Thread(target=die)
        t.start()
        t.join(timeout=30)
        path = tdump.last_bundle()
    finally:
        tdump.disarm()
    assert path and tdump.validate_bundle(path)["reason"] == \
        "unhandled_thread_exception"
    t = threading.Thread(target=die)
    t.start()
    t.join(timeout=30)
    assert tdump.list_bundles(str(tmp_path)) == [path]


def test_timer_report_matches_jax():
    """The phase timer sums nothing while disabled and reports in the
    JAX format, largest first."""
    reports = []
    for T in (TTimer, JTimer):
        tm = T()
        with tm.section("off"):
            pass
        assert not tm.totals
        tm.enabled = True
        for name, n in (("a", 2), ("b", 1)):
            for _ in range(n):
                with tm.section(name):
                    pass
        tm.totals["a"], tm.totals["b"] = 0.5, 1.25
        reports.append(tm.report())
    assert reports[0] == reports[1] == (
        "LightGBM-TPU timer report:\n  b: 1.250s (1 calls)\n"
        "  a: 0.500s (2 calls)")


def test_train_iteration_spans_and_registry():
    """Armed, each ``update`` records one ``train.iteration`` span
    numbered from 0, and ``train_iterations_total`` counts them."""
    rng = np.random.RandomState(3)
    X = rng.randn(400, 4)
    y = (X[:, 0] > 0).astype(float)
    reg = tmetrics.default_registry()
    before = reg.snapshot().get("train_iterations_total", 0)
    ttrace.arm()
    try:
        lt.train({"objective": "binary", "num_leaves": 7, "verbosity": -1},
                 lt.Dataset(X, label=y), 3, device="cpu")
        doc = ttrace.export_chrome()
    finally:
        ttrace.disarm()
    its = [e["args"]["iteration"] for e in doc["traceEvents"]
           if e.get("name") == "train.iteration"]
    assert its == [0, 1, 2]
    assert reg.snapshot()["train_iterations_total"] - before == 3
    assert json.loads(json.dumps(doc)) == doc
