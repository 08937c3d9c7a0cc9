"""The port's fault seams and the server's failure domains against the
JAX package's, on the CPU (JAX tests/test_serve_faults.py).

The same fault plan (a ``LGBMV1_FAULTS``-style JSON string) parses to the
same specs and fires on the same events in both packages; the
``file_write`` seam tears and corrupts files byte for byte as there; and
each package's ``Server`` meets the same plans with the same outcome: a
transient ``h2d`` error retried, retries exhausted, the circuit breaker
rolling a failing version back, the watchdog failing a stalled batch
(``dispatch`` and ``replica_wedge``) and restarting a dead dispatcher,
overload answered from the truncated trees, a publish failing mid-warm.
The ``snapshot`` seam stops both CLIs after the same snapshot.  HTTP maps
a stall to 503 and ``/healthz`` follows the dispatcher's liveness.
"""

import copy
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu import cli as jcli
from lightgbmv1_tpu import serve as jserve
from lightgbmv1_tpu.utils import faults as jfaults
from lightgbmv1_tpu.utils import fileio as jfileio

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch import cli as tcli
from lightgbmv1_tpu_torch import serve as tserve
from lightgbmv1_tpu_torch.obs import dump as tdump
from lightgbmv1_tpu_torch.obs import events as tevents
from lightgbmv1_tpu_torch.utils import faults as tfaults
from lightgbmv1_tpu_torch.utils import fileio as tfileio

from conftest import make_binary_problem

PKG = {"t": (tserve, tfaults), "j": (jserve, jfaults)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Two small models (4 trees of 15 leaves, 8 of 31) trained by the
    port, each loaded by both packages from the same text."""
    X, y = make_binary_problem(1200, 8, seed=1)
    texts = []
    for rounds, leaves in ((4, 15), (8, 31)):
        b = lt.train({"objective": "binary", "num_leaves": leaves,
                      "min_data_in_leaf": 5, "verbosity": -1},
                     lt.Dataset(X, label=y), rounds, device="cpu")
        texts.append(b.model_to_string())
    boosters = {"t": [lt.Booster(model_str=s, device="cpu") for s in texts],
                "j": [lj.Booster(model_str=s) for s in texts]}
    return boosters, X


def _server(tag, booster, **over):
    serve, _ = PKG[tag]
    kw = dict(max_batch_rows=64, max_batch_delay_ms=1.0,
              queue_depth_rows=4096, f64_scores=True, retry_max=2,
              retry_backoff_ms=2.0, breaker_failures=3,
              predictor_kwargs={"bucket_min": 64})
    kw.update(over)
    extra = {"device": "cpu"} if tag == "t" else {}
    return serve.Server(booster, config=serve.ServeConfig(**kw), **extra)


def _raw(booster, X, **kw):
    return np.asarray(booster.predict(X, raw_score=True, **kw), np.float64)


PLAN = json.dumps([
    {"seed": 7},
    {"kind": "h2d", "mode": "raise", "at": 2, "count": 2},
    {"kind": "dispatch", "mode": "stall", "at": 1, "stall_s": 0.0,
     "match": "batch"},
    {"kind": "file_write", "mode": "corrupt", "match": "model"},
    {"kind": "publish_warm", "mode": "raise", "at": 3,
     "match": "acme:"}])


def test_fault_plan_parses_and_fires_as_in_jax(monkeypatch):
    """One JSON plan: the same specs and seed; the same events fire the
    same specs (``at`` / ``count`` / ``match``) and are logged alike;
    ``corrupt_bytes`` flips the same bytes."""
    events = [("h2d", "predict_raw"), ("h2d", "predict_leaf"),
              ("h2d", "predict_raw"), ("h2d", "x"), ("dispatch", "other"),
              ("dispatch", "batch"), ("dispatch", "batch"),
              ("file_write", "/tmp/model.txt"), ("publish_warm", "v1"),
              ("publish_warm", "acme:v1"), ("publish_warm", "acme:v1"),
              ("publish_warm", "acme:v2"), ("peer_dead", "rank0:iter3")]
    out = {}
    monkeypatch.setenv("LGBMV1_FAULTS", PLAN)
    for tag, (_, faults) in PKG.items():
        plan = faults.plan_from_env()
        assert plan.seed == 7
        hits = [None if (sp := plan.on_event(k, s)) is None
                else sp.to_dict() for k, s in events]
        out[tag] = ([sp.to_dict() for sp in plan.specs], hits, plan.fired,
                    plan.corrupt_bytes(bytes(range(200)) * 3, 5))
    assert out["t"] == out["j"]
    fired = [h["kind"] for h in out["t"][1] if h]
    assert fired == ["h2d", "h2d", "dispatch", "file_write",
                     "publish_warm"]
    monkeypatch.setenv("LGBMV1_FAULTS", "not json")
    assert tfaults.plan_from_env() is None


def test_fire_modes_match_jax():
    """``fire``: raise -> FaultInjected, exit_thread -> ThreadKilled (not
    an Exception), stall sleeps and returns the spec, truncate is the
    caller's; inactive it returns None; each firing publishes a
    ``fault.injected`` event."""
    for tag, (_, faults) in PKG.items():
        assert faults.fire("h2d") is None
        mark = tevents.seq()
        with faults.inject(faults.FaultSpec("h2d", mode="raise"),
                           faults.FaultSpec("dispatch", mode="exit_thread"),
                           faults.FaultSpec("snapshot", mode="stall",
                                            stall_s=0.01),
                           faults.FaultSpec("file_write", mode="truncate")
                           ) as plan:
            with pytest.raises(faults.FaultInjected):
                faults.fire("h2d", site="predict_raw")
            with pytest.raises(faults.ThreadKilled):
                faults.fire("dispatch", site="batch")
            assert not issubclass(faults.ThreadKilled, Exception)
            assert faults.fire("snapshot", site="2").mode == "stall"
            assert faults.fire("file_write", site="f").mode == "truncate"
            assert faults.fire("h2d") is None         # count=1 spent
            assert len(plan.fired) == 4
        assert not faults.active()
        if tag == "t":
            kinds = [e["fields"]["fault_kind"] for e in
                     tevents.tail(since_seq=mark)
                     if e["kind"] == "fault.injected"]
            assert kinds == ["h2d", "dispatch", "snapshot", "file_write"]


@pytest.mark.parametrize("mode", ["truncate", "corrupt"])
def test_file_write_seam_matches_jax(mode, tmp_path):
    """``atomic_write_bytes`` under a ``file_write`` plan: the torn or
    corrupted file is the JAX package's byte for byte; a write the plan
    does not match lands whole."""
    data = bytes(range(256)) * 8
    got = {}
    for tag, (_, faults) in PKG.items():
        fileio = tfileio if tag == "t" else jfileio
        path = str(tmp_path / f"{tag}_model.txt")
        keep = str(tmp_path / f"{tag}_other.txt")
        fileio.atomic_write_bytes(keep, b"old")
        with faults.inject(faults.FaultSpec("file_write", mode=mode,
                                            match="model"), seed=3):
            fileio.atomic_write_bytes(path, data)
            fileio.atomic_write_bytes(keep, b"new", site="other")
        got[tag] = open(path, "rb").read()
        assert open(keep, "rb").read() == b"new"
    assert got["t"] == got["j"] != data


def _outcome(tag, models, scenario):
    """Run one failure-domain scenario on package ``tag``'s server;
    returns what the client and the server's metrics saw."""
    serve, faults = PKG[tag]
    (b1, b2), X = models[0][tag], models[1]
    F = faults.FaultSpec
    out = {}
    if scenario == "h2d_retry":
        srv = _server(tag, b1)
        try:
            with faults.inject(F("h2d", mode="raise", at=1)) as plan:
                r = srv.submit(X[:4])
            out["sites"] = [s for _, s, _ in plan.fired]
            out["ok"] = np.array_equal(r.values[:, 0], _raw(b1, X[:4]))
        finally:
            srv.close()
    elif scenario == "retry_exhausted":
        srv = _server(tag, b1, retry_max=1, breaker_failures=0)
        try:
            with faults.inject(F("dispatch", mode="raise", count=2)):
                with pytest.raises(faults.FaultInjected):
                    srv.submit(X[:4])
            out["after"] = srv.submit(X[:4]).version
        finally:
            srv.close()
    elif scenario == "breaker":
        srv = _server(tag, b1, retry_max=0, breaker_failures=2)
        try:
            srv.submit(X[:4])
            out["published"] = srv.publish(b2)
            with faults.inject(F("dispatch", mode="raise", at=1, count=2)):
                for _ in range(2):
                    with pytest.raises(faults.FaultInjected):
                        srv.submit(X[:2])
            r = srv.submit(X[:4])
            out["after"] = (r.version, srv.version())
            out["ok"] = np.array_equal(r.values[:, 0], _raw(b1, X[:4]))
        finally:
            srv.close()
    elif scenario in ("watchdog_dispatch", "watchdog_wedge"):
        kind = "dispatch" if scenario == "watchdog_dispatch" \
            else "replica_wedge"
        srv = _server(tag, b1, watchdog_ms=300.0)
        try:
            srv.submit(X[:4])
            with faults.inject(F(kind, mode="stall", stall_s=1.2,
                                 match="server" if kind != "dispatch"
                                 else "")) as plan:
                t0 = time.monotonic()
                with pytest.raises(serve.DispatcherStalled):
                    srv.submit(X[:4])
                out["fast"] = time.monotonic() - t0 < 1.2
                out["wedged"] = srv.health()["wedged"]
            out["sites"] = [s for _, s, _ in plan.fired]
            deadline = time.monotonic() + 5.0
            while srv.wedged() and time.monotonic() < deadline:
                time.sleep(0.02)
            out["after"] = srv.submit(X[:4]).version
        finally:
            srv.close()
    elif scenario == "dispatcher_restart":
        srv = _server(tag, b1, watchdog_ms=300.0)
        try:
            srv.submit(X[:4])
            with faults.inject(F("dispatch", mode="exit_thread")):
                with pytest.raises((serve.DispatcherDied,
                                    serve.DispatcherStalled)):
                    srv.submit(X[:4])
            deadline = time.monotonic() + 5.0
            while not srv.dispatcher_alive() and time.monotonic() < deadline:
                time.sleep(0.02)
            out["after"] = srv.submit(X[:4]).version
            out["healthy"] = srv.health()["ok"]
        finally:
            srv.close()
    elif scenario == "degrade":
        # the first batch stalls while four 32-row requests queue: the
        # next batch (two of them) leaves 64 backlogged rows, past
        # degrade_queue_frac x queue_depth_rows, and is answered from the
        # first two trees; the last batch sees no backlog
        srv = _server(tag, b2, degrade_trees=2, queue_depth_rows=256,
                      degrade_queue_frac=0.25)
        try:
            res = {}
            with faults.inject(F("dispatch", mode="stall",
                                 stall_s=1.5)) as plan:
                first = threading.Thread(
                    target=lambda: res.setdefault("first",
                                                  srv.submit(X[:8])))
                first.start()
                deadline = time.monotonic() + 30.0
                while not plan.fired and time.monotonic() < deadline:
                    time.sleep(0.002)       # the first batch is stalled
                ths = [threading.Thread(target=lambda i=i: res.setdefault(
                    i, srv.submit(X[32 * i:32 * i + 32]))) for i in range(4)]
                for t in ths:
                    t.start()
                    time.sleep(0.03)
                for t in [first] + ths:
                    t.join(timeout=60)
            out["degraded"] = [res[i].degraded for i in range(4)]
            out["ok"] = all(
                np.array_equal(res[i].values[:, 0],
                               _raw(b2, X[32 * i:32 * i + 32],
                                    num_iteration=2 if res[i].degraded
                                    else None))
                for i in range(4))
        finally:
            srv.close()
    elif scenario == "publish_warm":
        srv = _server(tag, b1)
        try:
            with faults.inject(F("publish_warm", mode="raise")):
                with pytest.raises(faults.FaultInjected):
                    srv.publish(b2)
            out["after"] = srv.submit(X[:4]).version
        finally:
            srv.close()
    snap = srv.metrics_snapshot()
    out["metrics"] = {k: snap[k] for k in (
        "retries", "errors", "breaker_trips", "watchdog_failures",
        "dispatcher_restarts", "publish_rejects", "degraded", "rollbacks")}
    return out


@pytest.mark.parametrize("scenario", [
    "h2d_retry", "retry_exhausted", "breaker", "watchdog_dispatch",
    "watchdog_wedge", "dispatcher_restart", "degrade", "publish_warm"])
def test_failure_domain_outcomes_match_jax(models, scenario):
    t_out = _outcome("t", models, scenario)
    j_out = _outcome("j", models, scenario)
    assert t_out == j_out
    expect = {
        "h2d_retry": lambda o: o["ok"] and o["metrics"]["retries"] == 1
        and o["sites"] == ["predict_leaf"],
        "retry_exhausted": lambda o: o["metrics"]["errors"] == 1
        and o["after"] == "v1",
        "breaker": lambda o: o["after"] == ("v1", "v1") and o["ok"]
        and o["metrics"]["breaker_trips"] == 1,
        "watchdog_dispatch": lambda o: o["fast"] and o["wedged"]
        and o["metrics"]["watchdog_failures"] == 1,
        "watchdog_wedge": lambda o: o["fast"] and o["sites"] == ["server"],
        "dispatcher_restart": lambda o: o["healthy"]
        and o["metrics"]["dispatcher_restarts"] >= 1,
        "degrade": lambda o: o["degraded"] == [True, True, False, False]
        and o["ok"] and o["metrics"]["degraded"] == 2,
        "publish_warm": lambda o: o["after"] == "v1"
        and o["metrics"]["publish_rejects"] == 1,
    }[scenario]
    assert expect(t_out), t_out


def test_publish_validation_rejects_before_the_swap(models):
    """Non-finite leaves and a cyclic tree never reach traffic; the
    active version keeps answering."""
    (b1, b2), X = models[0]["t"], models[1]
    srv = _server("t", b1)
    try:
        bad = copy.deepcopy(b2._all_trees())
        bad[0].leaf_value[0] = np.nan
        with pytest.raises(tserve.PublishValidationError):
            srv.publish((bad, 1, b2.num_feature()))
        cyc = copy.deepcopy(b2._all_trees())
        cyc[1].left_child[0] = 0
        with pytest.raises(Exception):  # noqa: B017 — validate_host_tree
            srv.publish((cyc, 1, b2.num_feature()))
        assert srv.version() == "v1"
        assert srv.submit(X[:3]).version == "v1"
        assert srv.metrics_snapshot()["publish_rejects"] == 2
    finally:
        srv.close()


def test_snapshot_seam_stops_both_clis(tmp_path):
    """``snapshot`` raising after the second snapshot: both CLIs stop
    there with the same artifacts on disk; an armed crash dir gets the
    port's bundle."""
    X, y = make_binary_problem(400, 5, seed=2)
    data = tmp_path / "train.tsv"
    np.savetxt(data, np.column_stack([y, X]), fmt="%.7g", delimiter="\t")
    arts = {}
    for tag, main, faults in (("t", tcli.main, tfaults),
                              ("j", jcli.main, jfaults)):
        out = str(tmp_path / f"{tag}.txt")
        args = [f"data={data}", "objective=binary", "num_leaves=7",
                "num_trees=8", "snapshot_freq=2", "verbosity=-1",
                f"output_model={out}"]
        if tag == "t":
            args += ["device_type=cpu", f"crash_dir={tmp_path / 'crash'}"]
        try:
            with faults.inject(faults.FaultSpec("snapshot", mode="raise",
                                                at=2)):
                with pytest.raises(faults.FaultInjected):
                    main(args)
        finally:
            tdump.disarm()
        arts[tag] = sorted(p[len(tag) + 1:] for p in os.listdir(tmp_path)
                           if p.startswith(f"{tag}.txt."))
    assert arts["t"] == arts["j"] == [
        "txt.ckpt_iter_2", "txt.ckpt_iter_4", "txt.snapshot_iter_2",
        "txt.snapshot_iter_4"]
    bundles = tdump.list_bundles(str(tmp_path / "crash"))
    assert len(bundles) == 1
    assert tdump.validate_bundle(bundles[0])["reason"] == "train_crash"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_stall_is_503_and_healthz_follows_liveness(models):
    """A stalled batch answers 503 naming ``DispatcherStalled``; with no
    model ``/healthz`` and ``/predict`` answer 503; a dead dispatcher
    (no watchdog) turns ``/healthz`` to 503."""
    (b1, _), X = models[0]["t"], models[1]
    srv = _server("t", None, watchdog_ms=300.0)
    http = tserve.ServeHTTP(srv, port=0).start()
    u = f"http://127.0.0.1:{http.port}"
    try:
        code, body = _get(u + "/healthz")
        assert code == 503 and body["published"] is False
        assert _post(u + "/predict", {"rows": X[:1].tolist()})[0] == 503
        srv.publish(b1)
        assert _get(u + "/healthz")[0] == 200
        with tfaults.inject(tfaults.FaultSpec("dispatch", mode="stall",
                                              stall_s=1.2)):
            code, body = _post(u + "/predict", {"rows": X[:2].tolist()})
        assert code == 503 and "DispatcherStalled" in body["error"]
        deadline = time.monotonic() + 10.0
        while srv.wedged() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert _post(u + "/predict", {"rows": X[:2].tolist()})[0] == 200
    finally:
        http.shutdown()
        srv.close()
    srv = _server("t", b1)
    http = tserve.ServeHTTP(srv, port=0).start()
    u = f"http://127.0.0.1:{http.port}"
    try:
        with tfaults.inject(tfaults.FaultSpec("dispatch",
                                              mode="exit_thread")):
            with pytest.raises(tserve.DispatcherDied):
                srv.submit(X[:2])
        deadline = time.monotonic() + 5.0
        while srv.dispatcher_alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        code, body = _get(u + "/healthz")
        assert code == 503 and body["dispatcher_alive"] is False
    finally:
        http.shutdown()
        srv.close()
