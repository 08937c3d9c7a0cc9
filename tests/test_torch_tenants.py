"""The port's tenants against the JAX package's, on the CPU (JAX
tests/test_tenants.py): the manifest grammar and its errors, spec
validation, per-tenant publish / rollback lineages that a neighbour's
failed publish cannot touch, the unknown tenant (404 over HTTP), fair
share admission, the ``/tenants`` surface with the JAX keys, and the
cross-tenant sharing scoreboard (the same ``share_frac`` as the JAX
package's for two same-shape tenants: the port shares K4's tile plan,
what it builds per shape).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu.models import predict as jpredict
from lightgbmv1_tpu.serve import Server as JServer
from lightgbmv1_tpu.serve import ServeConfig as JServeConfig
from lightgbmv1_tpu.serve import tenants as jtenants

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.models import predict as tpredict
from lightgbmv1_tpu_torch.serve import (PublishValidationError, ServeConfig,
                                        ServeHTTP, Server, ServerOverloaded,
                                        SLOConfig, UnknownTenant)
from lightgbmv1_tpu_torch.serve import tenants as ttenants
from lightgbmv1_tpu_torch.utils import faults

from conftest import make_binary_problem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(text, factor=0.5):
    """The same trees with every leaf value scaled (the same shape)."""
    lines = []
    for ln in text.splitlines():
        if ln.startswith("leaf_value="):
            vals = [float(v) * factor for v in ln.split("=", 1)[1].split()]
            ln = "leaf_value=" + " ".join(repr(v) for v in vals)
        lines.append(ln)
    return "\n".join(lines)


@pytest.fixture(scope="module")
def models():
    X, y = make_binary_problem(1200, 8, seed=1)
    texts = []
    for rounds, leaves in ((10, 15), (5, 7)):
        b = lt.train({"objective": "binary", "num_leaves": leaves,
                      "min_data_in_leaf": 5, "verbosity": -1},
                     lt.Dataset(X, label=y), rounds, device="cpu")
        texts.append(b.model_to_string())
    texts.insert(1, _scaled(texts[0]))
    return texts, X


def _cfg(**over):
    kw = dict(max_batch_rows=64, max_batch_delay_ms=1.0,
              queue_depth_rows=2048, f64_scores=True,
              predictor_kwargs={"bucket_min": 64})
    kw.update(over)
    return ServeConfig(**kw)


def _raw(b, X):
    return np.asarray(b.predict(X, raw_score=True), np.float64)


@pytest.mark.parametrize("spec", [
    "acme:3, globex ,deluxe:0.5,", "", None, "a,b,a", "a:heavy", "a:0",
    "a:-1", "x:y:z"])
def test_parse_manifest_matches_jax(spec):
    """The same manifest gives the same specs, or the same error."""
    def run(m):
        try:
            return [(s.name, s.weight) for s in m.parse_manifest(spec)]
        except ValueError as e:
            return ("error", str(e))

    assert run(ttenants) == run(jtenants)


@pytest.mark.parametrize("args", [("",), ("a,b",), ("a:b",), ("a", -1),
                                  ("a", "2")])
def test_tenant_spec_matches_jax(args):
    def run(m):
        try:
            s = m.TenantSpec(*args)
            return (s.name, s.weight)
        except ValueError as e:
            return ("error", str(e))

    assert run(ttenants) == run(jtenants)


def test_share_frac_matches_jax(models):
    """Two same-shape tenants (the second model's leaves scaled): the
    second publish finds the first's per-shape plan, so ``share_frac``
    is the JAX package's for the same two publishes; each tenant still
    gets its own answers."""
    texts, X = models
    pool = np.asarray(X[:64], np.float64)
    tpredict.reset_shared_cache()
    srv = Server(config=_cfg(predictor_kwargs={"bucket_min": 64,
                                               "method": "fused"}),
                 device="cpu")
    tr = ttenants.TenantRegistry(srv)
    tr.add("acme")
    tr.add("globex")
    try:
        tr.publish("acme", lt.Booster(model_str=texts[0], device="cpu"))
        tr.publish("globex", lt.Booster(model_str=texts[1], device="cpu"))
        ra = srv.submit(pool, tenant="acme")
        rg = srv.submit(pool, tenant="globex")
        t_share = tr.snapshot()["compile_share"]
    finally:
        srv.close()
    np.testing.assert_allclose(rg.values, ra.values * 0.5)
    assert (t_share["hits"], t_share["misses"]) == (1, 1)
    jpredict.reset_shared_cache()
    js = JServer(config=JServeConfig(
        max_batch_rows=64, max_batch_delay_ms=1.0, f64_scores=True,
        predictor_kwargs={"bucket_min": 64}))
    jtr = jtenants.TenantRegistry(js)
    jtr.add("acme")
    jtr.add("globex")
    try:
        jtr.publish("acme", lj.Booster(model_str=texts[0]))
        jtr.publish("globex", lj.Booster(model_str=texts[1]))
        j_share = jtr.compile_share_stats()
        j_tenants = js.tenants_snapshot()
    finally:
        js.close()
    assert t_share["share_frac"] == j_share["share_frac"] == 0.5
    assert set(t_share) == set(j_share)
    assert set(j_tenants["tenants"]["acme"]) \
        == set(tr.snapshot()["tenants"]["acme"])


def test_lineages_are_independent(models):
    """Each tenant publishes and rolls back its own lineage; a failed
    publish of one tenant (its warm fails) moves no tenant; an unknown
    tenant raises; a removed tenant's name is gone."""
    texts, X = models
    b1, half, b2 = (lt.Booster(model_str=t, device="cpu") for t in texts)
    pool = np.asarray(X[:16], np.float64)
    srv = Server(b1, config=_cfg(), device="cpu")
    tr = ttenants.TenantRegistry(srv)
    tr.add_manifest("acme:2,globex")
    try:
        assert tr.publish("acme", b1) == "v1"
        assert tr.publish("globex", half) == "v1"
        assert tr.publish("acme", b2) == "v2"
        with faults.inject(faults.FaultSpec("publish_warm", mode="raise",
                                            match="globex:")):
            with pytest.raises(faults.FaultInjected):
                tr.publish("globex", b2)
        assert (tr.version("acme"), tr.version("globex"),
                srv.version()) == ("v2", "v1", "v1")
        np.testing.assert_array_equal(
            srv.submit(pool, tenant="acme").values[:, 0], _raw(b2, pool))
        np.testing.assert_array_equal(
            srv.submit(pool, tenant="globex").values[:, 0], _raw(half, pool))
        assert tr.rollback("acme") == "v1"
        np.testing.assert_array_equal(
            srv.submit(pool, tenant="acme").values[:, 0], _raw(b1, pool))
        with pytest.raises(UnknownTenant):
            srv.submit(pool, tenant="nobody")
        tr.remove("globex")
        assert tr.names() == ["acme"]
        with pytest.raises(UnknownTenant):
            srv.version(tenant="globex")
        bad = lt.Booster(model_str=texts[0].replace(
            "leaf_value=", "leaf_value=nan ", 1), device="cpu")
        with pytest.raises((PublishValidationError, ValueError)):
            tr.publish("acme", bad)
        assert tr.version("acme") == "v1"
    finally:
        srv.close()


def test_fair_share_matches_jax(models):
    """hot + cold + the default tenant split a 256-row queue (85 rows
    each); the hot tenant's over-share request sheds while the cold one
    is served, and only hot's SLO budget burns; weights 3 / 1 / 1 of a
    300-row queue give the JAX shares."""
    texts, X = models
    b1 = lt.Booster(model_str=texts[0], device="cpu")
    pool = np.asarray(X[:300], np.float64)
    srv = Server(config=_cfg(queue_depth_rows=256), device="cpu")
    tr = ttenants.TenantRegistry(srv)
    tr.add("hot")
    tr.add("cold", slo=SLOConfig(latency_ms=250.0))
    try:
        tr.publish("hot", b1)
        tr.publish("cold", b1)
        assert srv.tenants_snapshot()["tenants"]["hot"]["share_rows"] == 85
        with pytest.raises(ServerOverloaded, match="fair-share"):
            srv.submit(pool[:128], tenant="hot")
        assert srv.submit(pool[:8], tenant="cold").values.shape[0] == 8
        snap = srv.tenants_snapshot()["tenants"]
        assert (snap["hot"]["shed"], snap["cold"]["shed"],
                snap["cold"]["completed"]) == (1, 0, 1)
        assert srv.slo_snapshot(tenant="cold")["availability"]["windows"][
            "fast"]["burn_rate"] == 0.0
        assert srv.slo_snapshot(tenant="hot")["availability"]["windows"][
            "fast"]["burn_rate"] > 0.0
    finally:
        srv.close()
    shares = []
    for S, C, kw in ((Server, ServeConfig, {"device": "cpu"}),
                     (JServer, JServeConfig, {})):
        s = S(None, config=C(max_batch_rows=64, queue_depth_rows=300), **kw)
        try:
            s.add_tenant("big", weight=3.0)
            s.add_tenant("small", weight=1.0)
            shares.append({k: v["share_rows"] for k, v in
                           s.tenants_snapshot()["tenants"].items()})
        finally:
            s.close()
    assert shares[0] == shares[1] == {"default": 64, "big": 180,
                                      "small": 64}


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_tenant_endpoints(models):
    """``POST /predict`` with a tenant answers with its version and echoes
    the tenant; an unknown tenant is 404 on ``/predict``, ``/slo`` and
    ``/drift``; ``/tenants`` lists every tenant."""
    texts, X = models
    b1, half = (lt.Booster(model_str=t, device="cpu") for t in texts[:2])
    srv = Server(b1, config=_cfg(), device="cpu")
    srv.add_tenant("acme")
    srv.publish(half, tenant="acme")
    http = ServeHTTP(srv, port=0).start()
    u = f"http://127.0.0.1:{http.port}"
    try:
        req = urllib.request.Request(
            u + "/predict", data=json.dumps(
                {"rows": X[:3].tolist(), "tenant": "acme"}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            body = json.loads(r.read())
        assert body["tenant"] == "acme" and body["version"] == "v1"
        np.testing.assert_array_equal(np.asarray(body["values"])[:, 0],
                                      _raw(half, X[:3]))
        req = urllib.request.Request(
            u + "/predict", data=json.dumps(
                {"rows": X[:3].tolist(), "tenant": "nobody"}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 404
        for ep in ("/slo?tenant=nobody", "/drift?tenant=nobody"):
            code, body = _get(u + ep)
            assert code == 404 and body["tenant"] == "nobody"
        code, body = _get(u + "/slo?tenant=acme")
        assert code == 200 and body["tenant"] == "acme"
        code, body = _get(u + "/tenants")
        assert code == 200 and sorted(body["tenants"]) == ["acme",
                                                           "default"]
    finally:
        http.shutdown()
        srv.close()
