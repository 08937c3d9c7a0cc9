"""The port's HTTP front-end and ``task=serve`` against the JAX package's,
on the CPU (JAX tests/test_serve.py, test_obs.py's HTTP cases).

The same requests through both packages' ``Server`` + ``ServeHTTP`` on
the same model text: the same values (the f64 lane bit for bit, the f32
lane within ROADMAP's serving tolerance), version tags across a publish
and a rollback, status codes for every malformed-input class, and JSON
keys of ``/predict``, ``/metrics``, ``/slo``, ``/drift``, ``/tenants`` and
``/healthz``; the ``X-Trace-Id`` echo; Prometheus text on ``Accept:
text/plain`` and ``?format=prometheus``.  ``python -m
lightgbmv1_tpu_torch task=serve`` in process with a tenant manifest and
``trace_out``: ``/healthz`` polled for the whole window, the trace ids
of its responses in the exported trace, a clean exit at the window's
end.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu import serve as jserve

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch import cli as tcli
from lightgbmv1_tpu_torch import serve as tserve
from lightgbmv1_tpu_torch.utils.log import register_callback

from conftest import make_binary_problem

PKG = {"t": tserve, "j": jserve}
# malformed bodies, one a class (JAX tests/test_serve_faults.py)
BAD = {"not_json": b"not json at all", "not_object": b"[1, 2, 3]",
       "no_rows": b"{}", "rows_not_list": b'{"rows": "nope"}',
       "empty_rows": b'{"rows": []}',
       "non_numeric": b'{"rows": [["a", "b", 1, 2, 3, 4, 5, 6]]}',
       "wrong_width": b'{"rows": [[1, 2, 3]]}',
       "ragged": b'{"rows": [[1, 2], [1, 2, 3]]}',
       "tenant_not_str": b'{"rows": [[1, 2, 3, 4, 5, 6, 7, 8]], '
                         b'"tenant": 5}',
       "unknown_tenant": b'{"rows": [[1, 2, 3, 4, 5, 6, 7, 8]], '
                         b'"tenant": "nobody"}'}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def texts():
    """Two models of 10 trees x 15 leaves, trained by the port."""
    X, y = make_binary_problem(1200, 8, seed=3)
    out = []
    for seed in (1, 2):
        b = lt.train({"objective": "binary", "num_leaves": 15,
                      "min_data_in_leaf": 5, "verbosity": -1,
                      "seed": seed, "bagging_fraction": 0.8,
                      "bagging_freq": 1},
                     lt.Dataset(X, label=y), 10, device="cpu")
        out.append(b.model_to_string())
    return out, X


def _booster(tag, text):
    return (lt.Booster(model_str=text, device="cpu") if tag == "t"
            else lj.Booster(model_str=text))


def _stack(tag, text, f64):
    serve = PKG[tag]
    cfg = serve.ServeConfig(max_batch_rows=256, max_batch_delay_ms=1.0,
                            f64_scores=f64,
                            predictor_kwargs={"bucket_min": 256})
    kw = {"device": "cpu"} if tag == "t" else {}
    srv = serve.Server(_booster(tag, text), config=cfg, **kw)
    return srv, serve.ServeHTTP(srv, port=0).start()


def _call(port, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _predict(port, rows, trace=None, **extra):
    headers = {"Content-Type": "application/json"}
    if trace:
        headers["X-Trace-Id"] = trace
    code, hdr, raw = _call(port, "/predict",
                           json.dumps({"rows": rows, **extra}).encode(),
                           headers)
    return code, hdr, json.loads(raw)


def _keys(v):
    """A JSON value's key structure (dict keys, recursively)."""
    if isinstance(v, dict):
        return {k: _keys(x) for k, x in v.items()}
    if isinstance(v, list) and v and isinstance(v[0], dict):
        return [_keys(v[0])]
    return None


def _exchange(tag, texts, X, f64):
    """Requests through one package's stack: values and tags across a
    publish and a rollback, status codes of the malformed classes, the
    JSON of every GET endpoint."""
    (t1, t2) = texts
    srv, http = _stack(tag, t1, f64)
    rng = np.random.RandomState(9)
    out = {"values": [], "tags": [], "codes": {}, "gets": {}}
    try:
        for phase in range(3):
            if phase == 1:
                srv.publish(_booster(tag, t2))
            elif phase == 2:
                srv.rollback()
            for _ in range(3):
                n = int(rng.randint(1, 40))
                code, hdr, body = _predict(http.port,
                                           X[:n].tolist())
                assert code == 200 and hdr["X-Trace-Id"] == body["trace_id"]
                out["values"].append(np.asarray(body["values"]))
                out["tags"].append(body["version"])
                out["post_keys"] = sorted(body)
        code, hdr, body = _predict(http.port, X[:2].tolist(),
                                   trace="cafe0123cafe0123")
        out["echo"] = (hdr["X-Trace-Id"], body["trace_id"])
        for name, raw in BAD.items():
            code, _, body = _call(http.port, "/predict", raw,
                                  {"Content-Type": "application/json"})
            out["codes"][name] = (code, sorted(json.loads(body)))
        out["codes"]["no_route"] = _call(http.port, "/nope")[0]
        for ep in ("/metrics", "/slo", "/drift", "/tenants", "/healthz"):
            code, hdr, body = _call(http.port, ep)
            out["gets"][ep] = (code, hdr["Content-Type"],
                               _keys(json.loads(body)))
        for how in ({"headers": {"Accept": "text/plain"}},
                    {"path": "/metrics?format=prometheus"}):
            code, hdr, body = _call(http.port, how.get("path", "/metrics"),
                                    headers=how.get("headers"))
            out.setdefault("prom", []).append(
                (code, hdr["Content-Type"],
                 sorted(re.findall(r"^(serve_\w+?)(?:_bucket|_sum|_count)?"
                                   r"(?:\{[^}]*\})? ", body.decode(),
                                   re.MULTILINE))))
    finally:
        http.shutdown()
        srv.close()
    return out


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_http_matches_jax(texts, f64):
    (t1, t2), X = texts
    got = _exchange("t", (t1, t2), X, f64)
    want = _exchange("j", (t1, t2), X, f64)
    assert got["tags"] == want["tags"] == ["v1"] * 3 + ["v2"] * 3 + ["v1"] * 3
    for a, b, tag in zip(got["values"], want["values"], got["tags"]):
        if f64:
            np.testing.assert_array_equal(a, b)
        else:
            trees = lt.Booster(model_str=t1 if tag == "v1" else t2,
                               device="cpu")._all_trees()
            tol = 1e-6 * sum(float(np.abs(t.leaf_value[:t.num_leaves]).max())
                             for t in trees) + 1e-7
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    for key in ("post_keys", "echo", "codes", "gets", "prom"):
        assert got[key] == want[key], key
    assert got["echo"] == ("cafe0123cafe0123", "cafe0123cafe0123")
    assert {k: c for k, (c, _) in
            ((k, v) for k, v in got["codes"].items() if k != "no_route")} \
        == {**{k: 400 for k in BAD}, "unknown_tenant": 404}
    assert "serve_completed_total" in got["prom"][0][2]
    assert got["prom"][0][1].startswith("text/plain; version=0.0.4")


def test_unpublished_and_overloaded_codes_match_jax(texts):
    """No model: ``/predict`` and ``/healthz`` 503 in both; a request
    over the queue depth sheds with 503 and ``shed: true``."""
    (t1, _), X = texts
    out = {}
    for tag, serve in PKG.items():
        kw = {"device": "cpu"} if tag == "t" else {}
        srv = serve.Server(None, config=serve.ServeConfig(
            max_batch_rows=8, queue_depth_rows=8,
            predictor_kwargs={"bucket_min": 8}), **kw)
        http = serve.ServeHTTP(srv, port=0).start()
        try:
            a = _predict(http.port, X[:1].tolist())[0]
            b = _call(http.port, "/healthz")[0]
            srv.publish(_booster(tag, t1))
            code, _, body = _predict(http.port, X[:16].tolist())
            out[tag] = (a, b, code, body.get("shed"),
                        _call(http.port, "/healthz")[0])
        finally:
            http.shutdown()
            srv.close()
    assert out["t"] == out["j"] == (503, 503, 503, True, 200)


def _wait_healthy(lines, th, timeout=120.0):
    """The port ``task=serve`` logs, once ``/healthz`` answers 200; polled
    through the window, never a fixed start-up sleep."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end and th.is_alive():
        for ln in list(lines):
            m = re.search(r"HTTP listening on 127\.0\.0\.1:(\d+)", ln)
            if m and _call(int(m.group(1)), "/healthz")[0] == 200:
                return int(m.group(1))
        time.sleep(0.02)
    raise AssertionError(f"task=serve never became healthy: {lines[-5:]}")


def test_task_serve_with_tenants_and_trace(texts, tmp_path):
    """The CLI: the default tenant and the manifest's two each answer
    with ``Booster.predict`` (f64 lane), ``/tenants`` lists all three,
    the Prometheus view counts the answers, and the exported trace holds
    a ``serve.walk`` span for every response's trace id."""
    (t1, _), X = texts
    model = tmp_path / "m.txt"
    model.write_text(t1)
    trace_out = tmp_path / "serve_trace.json"
    lines = []
    register_callback(lines.append)
    try:
        th = threading.Thread(target=tcli.main, args=([
            "task=serve", f"input_model={model}", "serve_http_port=0",
            "serve_duration_s=6", "device_type=cpu",
            "predict_f64_scores=true", "tenant_manifest=acme:2,globex",
            f"trace_out={trace_out}", "verbosity=1"],))
        th.start()
        port = _wait_healthy(lines, th)
        want = lt.Booster(model_str=t1, device="cpu").predict(
            X[:5], raw_score=True)
        ids = []
        for tenant in ("", "acme", "globex"):
            extra = {"tenant": tenant} if tenant else {}
            code, hdr, body = _predict(port, X[:5].tolist(), **extra)
            assert code == 200 and body["version"] == "v1"
            np.testing.assert_array_equal(np.asarray(body["values"])[:, 0],
                                          want)
            ids.append(hdr["X-Trace-Id"])
        code, _, body = _call(port, "/tenants")
        assert sorted(json.loads(body)["tenants"]) == ["acme", "default",
                                                       "globex"]
        code, _, prom = _call(port, "/metrics?format=prometheus")
        assert re.search(r"^serve_completed_total 3$", prom.decode(),
                         re.MULTILINE)
        th.join(timeout=120)
    finally:
        register_callback(None)
    assert not th.is_alive()
    assert any("serve: final metrics" in ln for ln in lines)
    doc = json.loads(trace_out.read_text())
    walked = {e["args"]["trace_id"] for e in doc["traceEvents"]
              if e.get("name") == "serve.walk"}
    assert set(ids) <= walked
