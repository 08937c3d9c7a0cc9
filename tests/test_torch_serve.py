"""The port's Booster.predict and Server against the JAX package.

``Booster(model_file, device="cpu").predict`` must equal the JAX
``Booster(model_file=...).predict`` — raw and converted, for
``predict_method`` fused, pallas and the default host walk — and a
``Server`` under concurrent traffic must answer every request equal to
``Booster.predict`` of the version it names, across a publish and a
rollback in mid-traffic.  Tolerances: the default host walk is exact
(both packages sum float64 in tree order); device raw scores within
``1e-6 * sum_t max_l |leaf_value| + 1e-7``; converted outputs 1e-6.
"""

import copy
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lgb
from lightgbmv1_tpu.io.parser import load_data_file

import chip_smoke
from lightgbmv1_tpu_torch import Booster
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.serve import (PublishValidationError, ServeConfig,
                                        Server, ServerOverloaded,
                                        build_server, serve_config_from)
from lightgbmv1_tpu_torch.serve.server import _Request

DATA = os.path.join(os.path.dirname(__file__), "data")
# golden model -> its rows (binary+categorical, multiclass softmax,
# regression, binary zero-as-missing)
CASES = {
    "golden_ref_model.txt": "golden_binary.tsv",
    "golden_multiclass_model.txt": "multiclass.train",
    "golden_regression_model.txt": "regression.train",
    "golden_zero_model.txt": "golden_zero_train.tsv",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(name, n=300):
    if name.endswith(".tsv"):
        X = np.loadtxt(os.path.join(DATA, name))[:, 1:]
    else:
        X = load_data_file(os.path.join(DATA, name)).X
    X = np.array(X[:n], np.float64)
    X[np.random.RandomState(0).rand(*X.shape) < 0.1] = np.nan
    return X


def _raw_tol(booster):
    return 1e-6 * sum(float(np.abs(t.leaf_value).max())
                      for t in booster._all_trees()) + 1e-7


@pytest.mark.parametrize("method", ["fused", "pallas", "auto"])
@pytest.mark.parametrize("model", sorted(CASES))
def test_booster_predict_matches_jax(model, method):
    path = os.path.join(DATA, model)
    X = _rows(CASES[model])
    jb = lgb.Booster(model_file=path)
    pb = Booster(model_file=path, device="cpu")
    assert (pb.num_trees(), pb.num_feature(), pb.num_model_per_iteration()) \
        == (jb.num_trees(), jb.num_feature(), jb.num_model_per_iteration())
    kw = {} if method == "auto" else {"predict_method": method}
    raw_j = jb.predict(X, raw_score=True, **kw)
    raw_p = pb.predict(X, raw_score=True, **kw)
    assert raw_p.shape == raw_j.shape
    if method == "auto":
        assert np.array_equal(raw_p, raw_j)
        np.testing.assert_array_equal(pb.predict(X), jb.predict(X))
    else:
        np.testing.assert_allclose(raw_p, raw_j, rtol=0, atol=_raw_tol(pb))
        np.testing.assert_allclose(pb.predict(X, **kw), jb.predict(X, **kw),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pb.predict(X, pred_leaf=True, **kw),
                                  jb.predict(X, pred_leaf=True, **kw))


@pytest.mark.parametrize("method", ["fused", "auto"])
def test_booster_iteration_slices_match_jax(method):
    path = os.path.join(DATA, "golden_multiclass_model.txt")
    X = _rows("multiclass.train", 64)
    jb = lgb.Booster(model_file=path)
    pb = Booster(model_file=path, device="cpu")
    kw = {} if method == "auto" else {"predict_method": method}
    for start, num in ((1, 2), (0, 1), (2, None)):
        np.testing.assert_allclose(
            pb.predict(X, start_iteration=start, num_iteration=num, **kw),
            jb.predict(X, start_iteration=start, num_iteration=num, **kw),
            rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            pb.predict(X, start_iteration=start, num_iteration=num,
                       pred_leaf=True, **kw),
            jb.predict(X, start_iteration=start, num_iteration=num,
                       pred_leaf=True, **kw))


def test_booster_f64_lane_and_average_output():
    path = os.path.join(DATA, "golden_zero_model.txt")
    X = _rows("golden_zero_train.tsv", 128)
    pb = Booster(model_file=path, device="cpu")
    host = pb.predict(X, raw_score=True)
    for method in ("fused", "pallas", "depthwise"):
        assert np.array_equal(pb.predict(X, raw_score=True,
                                         predict_method=method,
                                         predict_f64_scores=True), host)
    with open(path) as fh:
        text = fh.read().replace("\nfeature_names=",
                                 "\naverage_output\nfeature_names=", 1)
    avg_p = Booster(model_str=text, device="cpu")
    avg_j = lgb.Booster(model_str=text)
    np.testing.assert_array_equal(avg_p.predict(X, raw_score=True),
                                  avg_j.predict(X, raw_score=True))
    np.testing.assert_array_equal(avg_p.predict(X, raw_score=True),
                                  host / avg_p.num_trees())


def test_booster_refuses_what_is_not_ported():
    """Row-sharded predict raises naming its item; TreeSHAP and the
    native walk, refused until they were ported, give the JAX package's
    answers."""
    pb = Booster(model_file=os.path.join(DATA, "golden_zero_model.txt"),
                 device="cpu")
    jb = lgb.Booster(model_file=os.path.join(DATA, "golden_zero_model.txt"))
    X = _rows("golden_zero_train.tsv", 8)
    for kw in ({"predict_method": "scan"}, {"predict_method": "fused",
                                            "predict_num_shards": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pb.predict(X, **kw)
    for kw in ({"pred_contrib": True}, {"predict_method": "native"}):
        np.testing.assert_allclose(pb.predict(X, **kw), jb.predict(X, **kw),
                                   rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_versions():
    a = Booster(model_str=chip_smoke.make_model(21, n_trees=12,
                                                n_leaves=15)[0], device="cpu")
    b = Booster(model_str=chip_smoke.make_model(22, n_trees=8, n_leaves=31,
                                                n_grid=9)[0], device="cpu")
    return a, b


def test_server_concurrent_publish_rollback(two_versions):
    """4 threads submit requests of 1-300 rows; one publish and one
    rollback land in mid-traffic; every answer equals Booster.predict of
    the version it is tagged with."""
    a, b = two_versions
    server = Server(a, ServeConfig(max_batch_rows=256, max_batch_delay_ms=1.0,
                                   queue_depth_rows=4096,
                                   predictor_kwargs={"method": "fused"}),
                    device="cpu")
    results, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def worker(seed):
        r = np.random.RandomState(seed)
        try:
            while not stop.is_set():
                rows = chip_smoke.make_rows(r, r.randint(1, 301))
                res = server.submit(rows)
                with lock:
                    results.append((rows, res))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    def more(n, deadline):
        goal = len(results) + n
        while len(results) < goal and not errors:
            assert time.monotonic() < deadline, "server stalled"
            time.sleep(0.002)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    deadline = time.monotonic() + 120
    for t in threads:
        t.start()
    try:
        more(16, deadline)
        tag_b = server.publish(b)
        more(16, deadline)
        tag_a = server.rollback()
        more(16, deadline)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        snap = server.metrics_snapshot()
        server.close()
    assert not errors
    assert not any(t.is_alive() for t in threads)
    assert (tag_a, tag_b) == ("v1", "v2") and server.version() == "v1"
    assert len(results) >= 48
    by_tag = {"v1": a, "v2": b}
    assert {res.version for _, res in results} == {"v1", "v2"}
    for rows, res in results:
        want = by_tag[res.version].predict(rows, raw_score=True,
                                           predict_method="fused")
        assert res.values.shape == (len(rows), 1)
        np.testing.assert_allclose(res.values[:, 0], want, rtol=0,
                                   atol=_raw_tol(by_tag[res.version]))
    assert snap["completed"] == len(results) and snap["errors"] == 0
    assert snap["swaps"] == 3 and snap["rollbacks"] == 1
    assert snap["p50_ms"] <= snap["p99_ms"] and snap["qps"] > 0
    assert 0 < snap["batch_occupancy"] <= 1


def test_server_stress_more_threads_than_cores(two_versions):
    """More client threads than cores and a short switch interval: every
    request is answered once with its own rows' scores, the counters add
    up, and the queue drains to zero."""
    a, _ = two_versions
    n_threads = min((os.cpu_count() or 4) + 1, 17)
    per_thread = 6
    answers, errors = [], []
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        with Server(a, ServeConfig(max_batch_rows=64, max_batch_delay_ms=0.5,
                                   queue_depth_rows=1 << 14, probe_rows=8),
                    device="cpu") as server:
            def worker(seed):
                r = np.random.RandomState(100 + seed)
                try:
                    for _ in range(per_thread):
                        rows = chip_smoke.make_rows(r, r.randint(1, 21))
                        res = server.submit(rows)
                        with lock:
                            answers.append((rows, res))
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            snap = server.metrics_snapshot()
            queue_rows = server._queue_rows
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert len(answers) == n_threads * per_thread
    assert snap["submitted"] == snap["completed"] == len(answers)
    assert queue_rows == 0
    for rows, res in answers:
        want = a.predict(rows, raw_score=True, predict_method="depthwise")
        np.testing.assert_allclose(res.values[:, 0], want, rtol=0,
                                   atol=_raw_tol(a))


def test_server_sheds_over_depth_and_validates_publish(two_versions):
    a, _ = two_versions
    with Server(a, ServeConfig(max_batch_rows=8, queue_depth_rows=8),
                device="cpu") as server:
        with pytest.raises(ServerOverloaded):
            server.submit(np.zeros((20, 28)))
        assert server.metrics_snapshot()["shed"] == 1
        bad = copy.deepcopy(a._all_trees())
        bad[0].leaf_value[0] = np.nan
        with pytest.raises(PublishValidationError, match="non-finite"):
            server.publish((bad, 1, 28))
        assert server.version() == "v1"
        with pytest.raises(ValueError, match="features"):
            server.submit(np.zeros((2, 5)))
        res = server.submit(np.zeros((3, 28)))
        assert res.version == "v1" and res.values.shape == (3, 1)


def test_server_batch_fills_past_a_request_that_does_not_fit(two_versions):
    """A request too big for the batch keeps its place in the queue while
    smaller ones behind it still ride (the JAX ``_collect_batch`` rule)."""
    a, _ = two_versions
    with Server(a, ServeConfig(max_batch_rows=256, max_batch_delay_ms=1.0),
                device="cpu") as server:
        reqs = [_Request(np.zeros((n, 28)), None) for n in (100, 200, 50, 30)]
        for r in reqs:
            r.t_enq -= 1.0                 # every delay budget is spent
        # holding the (re-entrant) lock keeps the dispatcher out
        with server._cond:
            server._queue.extend(reqs)
            server._queue_rows = 380
            batch = server._collect_batch()
            left, left_rows = list(server._queue), server._queue_rows
            server._queue.clear()
            server._queue_rows = 0
    assert [r.n for r in batch] == [100, 50, 30]
    assert [r.n for r in left] == [200] and left_rows == 200


def test_serve_config_from_and_build_server(two_versions):
    cfg = Config.from_dict({"objective": "binary", "predict_method": "fused",
                            "serve_max_batch_rows": "64",
                            "serve_queue_depth": 128,
                            "predict_f64_scores": "true"})
    sc = serve_config_from(cfg)
    assert (sc.max_batch_rows, sc.queue_depth_rows, sc.f64_scores) == \
        (64, 128, True)
    assert sc.predictor_kwargs == {"bucket_min": 256, "method": "fused",
                                   "code_layout": "auto"}
    assert "method" not in serve_config_from(Config()).predictor_kwargs
    with build_server(two_versions[0], cfg, device="cpu") as server:
        assert server.version() == "v1"
        res = server.submit(np.zeros((2, 28)))
        assert res.values.dtype == np.float64      # f64 lane
    for bad in ({"predict_method": "tpu"}, {"serve_queue_depth": 8},
                {"predict_code_layout": "u4"}):
        with pytest.raises(ValueError):
            Config.from_dict(bad)


@pytest.mark.parametrize("device,given,want", [
    ("cuda", {}, "fused"),
    ("cuda", {"method": "pallas"}, "pallas"),
    ("cuda", {"method": "depthwise"}, "depthwise"),
    ("cpu", {}, None),
])
def test_registry_walk_defaults_to_k4_on_the_card(monkeypatch, device,
                                                   given, want):
    """On the card a version's predictor and its degrade predictor walk
    with K4 (``method="fused"``) unless the caller names another walk,
    so ``task=serve`` at ``predict_method=auto`` never takes the staged
    walk there; on the CPU the JAX package's default stands."""
    from lightgbmv1_tpu_torch.serve import registry as reg_mod

    built = []
    monkeypatch.setattr(reg_mod, "resolve_device",
                        lambda d: torch.device(device))
    monkeypatch.setattr(reg_mod, "BatchPredictor",
                        lambda trees, K, F, **kw: built.append(kw))
    auto = serve_config_from(Config()).predictor_kwargs
    reg = reg_mod.ModelRegistry(predictor_kwargs={**auto, **given})
    reg._build([object()] * 4, 1, 28, degrade_trees=2)
    assert len(built) == 2
    assert [kw.get("method") for kw in built] == [want, want]
