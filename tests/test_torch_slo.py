"""The port's serving SLOs against the JAX package's, on the CPU (JAX
tests/test_slo.py): the same ``(ok, latency, t)`` sequence under an
injected clock gives an identical ``SLOTracker.evaluate()`` (burn
rates, SLIs, the page / warn rules over both windows, window expiry,
the worst-K exemplars), the same configuration errors, and the server's
completions, sheds and exemplars reaching ``GET /slo``.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from lightgbmv1_tpu.serve import slo as jslo

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.serve import (ServeConfig, ServeHTTP, Server,
                                        ServerOverloaded)
from lightgbmv1_tpu_torch.serve import slo as tslo
from lightgbmv1_tpu_torch.serve.server import build_server


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(m, **over):
    kw = dict(availability_target=0.999, latency_ms=50.0,
              latency_target=0.99, fast_window_s=60.0, slow_window_s=600.0,
              bucket_s=1.0, worst_k=4)
    kw.update(over)
    return m.SLOConfig(**kw)


def _sustained(rec):
    for i in range(600):                      # 50% failures, 600 s
        rec(i % 2 == 0, 1.0, "", 1000.0 + i)
    for i in range(120):                      # then 120 s clean
        rec(True, 1.0, "", 1600.0 + i)
    return [1600.0, 1720.0]


def _blip(rec):
    for i in range(5950):                     # a 10 qps baseline
        rec(True, 1.0, "", 2000.0 + i * 0.1)
    for i in range(100):                      # a 5 s burst of failures
        rec(False, None, "", 2595.0 + i * 0.05)
    for i in range(5000):                     # amid a traffic spike
        rec(True, 1.0, "", 2595.0 + i * 0.001)
    return [2601.0]


def _latency(rec):
    rng = np.random.RandomState(4)
    for i in range(3000):                     # slow successes + failures
        ok = rng.rand() > 0.002
        lat = float(rng.choice([5.0, 80.0], p=[0.9, 0.1]))
        rec(ok, lat if ok else None, f"{i:016x}", 500.0 + i * 0.2)
    return [800.0, 1100.0, 1400.0]


def _expiry(rec):
    for i in range(50):
        rec(False, None, "", 10.0 + i)
    rec(True, 3.0, "", 700.0)
    return [60.0, 659.0, 700.0, 1300.0]


def _worst(rec):
    for i, lat in enumerate([5.0, 90.0, 12.0, 300.0, 44.0, 300.0, 7.0]):
        rec(True, lat, f"t{i}", 100.0 + i)
    rec(True, 999.0, "", 108.0)               # no trace id: no exemplar
    return [110.0]


@pytest.mark.parametrize("script", [_sustained, _blip, _latency, _expiry,
                                    _worst],
                         ids=["sustained", "blip", "latency", "expiry",
                              "worst"])
def test_evaluate_matches_jax(script):
    """One outcome script fed into both trackers under explicit clocks:
    every evaluation (and the ``/slo`` snapshot) is identical."""
    trackers = (tslo.SLOTracker(_cfg(tslo)), jslo.SLOTracker(_cfg(jslo)))

    def rec(ok, lat, tid, now):
        for t in trackers:
            t.record(ok, latency_ms=lat, trace_id=tid, now=now)

    for now in script(rec):
        got, want = (t.evaluate(now=now) for t in trackers)
        assert got == want
        assert trackers[0].snapshot(now=now) == trackers[1].snapshot(now=now)


def test_alert_rules():
    """The page needs both windows: a sustained burn pages and clears
    once the fast window is clean; a blip the slow window dilutes does
    not page."""
    t = tslo.SLOTracker(_cfg(tslo))
    rec = (lambda ok, lat, tid, now:
           t.record(ok, latency_ms=lat, trace_id=tid, now=now))
    _sustained(rec)
    assert t.evaluate(now=1600.0)["alerts"]["availability_page"]
    ev = t.evaluate(now=1720.0)
    assert not ev["alerts"]["availability_page"]
    assert ev["availability"]["windows"]["fast"]["burn_rate"] == 0.0
    t = tslo.SLOTracker(_cfg(tslo))
    _blip(rec)
    ev = t.evaluate(now=2601.0)
    assert ev["availability"]["windows"]["fast"]["burn_rate"] >= 14.4
    assert not ev["alerts"]["availability_page"]


@pytest.mark.parametrize("over", [
    {"availability_target": 1.0}, {"latency_target": 0.0},
    {"availability_target": -0.5}], ids=["avail_one", "lat_zero",
                                          "avail_negative"])
def test_config_validation_matches_jax(over):
    with pytest.raises(ValueError) as te:
        _cfg(tslo, **over)
    with pytest.raises(ValueError) as je:
        _cfg(jslo, **over)
    assert str(te.value) == str(je.value)
    c_t = _cfg(tslo, fast_window_s=900.0, bucket_s=0.0, worst_k=-3)
    c_j = _cfg(jslo, fast_window_s=900.0, bucket_s=0.0, worst_k=-3)
    assert vars(c_t) == vars(c_j)


@pytest.fixture(scope="module")
def booster():
    rng = np.random.RandomState(11)
    X = rng.randn(600, 6)
    y = (X[:, 0] - X[:, 1] + rng.randn(600) * 0.3 > 0).astype(float)
    b = lt.train({"objective": "binary", "num_leaves": 15,
                  "verbosity": -1}, lt.Dataset(X, label=y), 10,
                 device="cpu")
    return b, X


def _serve_cfg(**over):
    kw = dict(max_batch_rows=64, max_batch_delay_ms=1.0,
              queue_depth_rows=4096, predictor_kwargs={"bucket_min": 64})
    kw.update(over)
    return ServeConfig(**kw)


def test_server_feeds_slo_and_http(booster):
    """Completions reach the tracker with 16-hex trace ids; the latency
    histogram's exemplars render only under OpenMetrics; a shed spends
    the availability budget; ``GET /slo`` answers the snapshot with the
    JAX package's keys."""
    b, X = booster
    srv = Server(b, config=_serve_cfg(), device="cpu")
    http = ServeHTTP(srv, port=0).start()
    try:
        for n in (1, 4, 2):
            srv.submit(X[:n])
        snap = srv.slo_snapshot()
        fast = snap["availability"]["windows"]["fast"]
        assert fast["total"] == 3 and fast["errors"] == 0
        assert snap["lifetime"] == {"total": 3, "errors": 0}
        assert snap["exemplars"] and all(
            len(ex["trace_id"]) == 16 for ex in snap["exemplars"])
        assert snap["worst"] and len(snap["worst"][0]["trace_id"]) == 16
        assert " # {trace_id=" in srv.metrics.prometheus_text(exemplars=True)
        assert " # {trace_id=" not in srv.metrics.prometheus_text()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/slo", timeout=30) as r:
            body = json.loads(r.read())
        want = jslo.SLOTracker(_cfg(jslo)).snapshot()
        assert set(body) == set(want) | {"version", "exemplars"}
        assert body["version"] == "v1"
    finally:
        http.shutdown()
        srv.close()
    srv = Server(b, config=_serve_cfg(max_batch_rows=8, queue_depth_rows=8),
                 device="cpu")
    try:
        srv.submit(X[:4])
        with pytest.raises(ServerOverloaded):
            srv.submit(X[:16])
        fast = srv.slo_snapshot()["availability"]["windows"]["fast"]
        assert fast["errors"] == 1 and fast["total"] == 2
    finally:
        srv.close()


def test_build_server_wires_slo_knobs(booster):
    b, _ = booster
    cfg = Config.from_dict({
        "serve_slo_availability_target": 0.99, "serve_slo_latency_ms": 25.0,
        "serve_slo_fast_window_s": 30.0, "serve_slo_slow_window_s": 300.0,
        "verbosity": -1})
    srv = build_server(b, cfg, device="cpu")
    try:
        sc = srv.slo.config
        assert (sc.availability_target, sc.latency_ms, sc.fast_window_s,
                sc.slow_window_s) == (0.99, 25.0, 30.0, 300.0)
        assert srv.slo_snapshot()["config"]["latency_ms"] == 25.0
    finally:
        srv.close()
