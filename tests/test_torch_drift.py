"""The port's drift detection and model-quality telemetry against the JAX
package's, on the CPU (JAX tests/test_drift.py): PSI and its equal-mass
grouping; ``capture_reference`` of the same binned training set and raw
scores gives the same bytes and digest in both packages (each reads the
other's); re-binning, the skew counters and the detector's evaluation
of the same sampled rows agree (PSI within 1e-12); checkpoints carry the
reference; the server samples rows for the active version's detector
(``GET /drift``: quiet on training rows, alerting on shifted ones,
re-anchored by a publish); ``quality_snapshot`` of the same trees has
the JAX keys with values within 2e-5.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu.obs import drift as jdrift
from lightgbmv1_tpu.obs import model as jmodel

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.io.checkpoint import load_checkpoint
from lightgbmv1_tpu_torch.obs import drift as tdrift
from lightgbmv1_tpu_torch.obs import events as tevents
from lightgbmv1_tpu_torch.obs import model as tmodel
from lightgbmv1_tpu_torch.serve import ServeConfig, ServeHTTP, Server

PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "min_data_in_leaf": 10}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[:, 4] = rng.randint(0, 6, n)            # categorical
    X[::9, 1] = np.nan                        # NaN missing
    y = (X[:, 0] + (X[:, 4] == 2) > 0.3).astype(float)
    return X, y


@pytest.fixture(scope="module")
def prob():
    """One trained port booster, its reference and raw scores, and the
    JAX package's binned set of the same rows."""
    X, y = _problem()
    bst = lt.train(PARAMS, lt.Dataset(X, label=y, categorical_feature=[4]),
                   10, device="cpu")
    ref = bst.capture_model_reference()
    raw = bst._gbdt.raw_train_scores()
    jds = lj.Dataset(X, label=y, categorical_feature=[4],
                     params=dict(PARAMS)).construct()._binned
    return X, y, bst, ref, raw, jds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_psi_math_matches_jax(seed):
    rng = np.random.RandomState(seed)
    ref = rng.randint(0, 50, 200) * (rng.rand(200) > 0.2)
    cur = rng.randint(0, 30, 200)
    for g in (4, 16, 64):
        np.testing.assert_array_equal(tdrift.group_bins(ref, g),
                                      jdrift.group_bins(ref, g))
        gid = tdrift.group_bins(ref, g)
        np.testing.assert_array_equal(tdrift.grouped_counts(cur, gid),
                                      jdrift.grouped_counts(cur, gid))
    assert abs(tdrift.psi(ref, cur) - jdrift.psi(ref, cur)) <= 1e-12
    assert tdrift.psi(ref, np.zeros(200)) == 0.0
    with pytest.raises(ValueError):
        tdrift.psi(ref, cur[:5])


def test_capture_reference_digest_matches_jax(prob):
    """The same binned training set and raw scores: byte-identical
    references, so the same digest; each package parses the other's
    bytes; the booster's own capture is that reference."""
    X, y, bst, ref, raw, jds = prob
    tds = bst._gbdt.train_set
    t_ref = tmodel.capture_reference(tds, raw, score_bins=16)
    j_ref = jmodel.capture_reference(jds, raw, score_bins=16)
    assert t_ref.to_bytes() == j_ref.to_bytes()
    assert t_ref.digest == j_ref.digest == ref.digest
    assert jmodel.ModelReference.from_bytes(ref.to_bytes()).digest \
        == ref.digest
    assert tmodel.ModelReference.from_bytes(j_ref.to_bytes()).digest \
        == ref.digest
    torn = bytearray(ref.to_bytes())
    torn[len(torn) // 2] ^= 0x40
    with pytest.raises(tmodel.ModelReferenceError):
        tmodel.ModelReference.from_bytes(bytes(torn))


def test_rebin_and_counters_match_jax(prob):
    """Training rows re-bin to the training codes exactly; shifted rows
    give the JAX package's codes and unseen / out-of-range / NaN
    counts."""
    X, y, bst, ref, raw, _ = prob
    jref = jmodel.ModelReference.from_bytes(ref.to_bytes())
    codes, stats = ref.rebin(X)
    np.testing.assert_array_equal(codes.T, bst._gbdt.train_set.binned)
    assert stats["unseen"].sum() == 0 and stats["clip"].sum() == 0
    Xs = X.copy()
    Xs[:10, 4] = 77.0
    Xs[:20, 0] = 1e6
    Xs[:30, 2] = np.nan
    (tc, ts), (jc, js) = ref.rebin(Xs), jref.rebin(Xs)
    np.testing.assert_array_equal(tc, jc)
    for k in ("nan", "unseen", "clip"):
        np.testing.assert_array_equal(ts[k], js[k])
    assert ts["unseen"][4] >= 10 and ts["clip"][0] >= 20
    assert ts["nan"][2] == 30
    assert abs(ref.score_psi(raw) - jref.score_psi(raw)) <= 1e-12
    assert ref.score_psi(np.full((500, 1), 1e3)) > 1.0


@pytest.mark.parametrize("shift", [0.0, 3.0], ids=["clean", "shifted"])
def test_detector_matches_jax(prob, shift):
    """The same rows offered to both packages' detectors: the same
    evaluation (per-feature PSI within 1e-12, the alerting set, the
    counters)."""
    X, y, bst, ref, raw, _ = prob
    jref = jmodel.ModelReference.from_bytes(ref.to_bytes())
    kw = dict(sample_rows=1024, min_rows=400, per_batch_rows=1024,
              sample_stride=1)
    td = tdrift.DriftDetector(ref, tdrift.DriftConfig(**kw), events=False)
    jd = jdrift.DriftDetector(jref, jdrift.DriftConfig(**kw), events=False)
    Xs = X[:1000].copy()
    Xs[:, 0] += shift
    for det in (td, jd):
        det.offer(Xs[:100], raw[:100])
        assert det.evaluate()["evaluated"] is False
        det.offer(Xs[100:], raw[100:1000])
    t_ev, j_ev = td.evaluate(), jd.evaluate()
    assert set(t_ev) == set(j_ev)
    for a, b in zip(t_ev["features"], j_ev["features"]):
        assert a.keys() == b.keys()
        assert abs(a["psi"] - b["psi"]) <= 1e-12
        assert {k: v for k, v in a.items() if k != "psi"} \
            == {k: v for k, v in b.items() if k != "psi"}
    for k in ("alerting", "psi_max", "score_psi", "unseen_total",
              "out_of_range_total", "nan_total", "ring"):
        assert t_ev[k] == j_ev[k], k
    assert ("Column_0" in t_ev["alerting"]) == (shift > 0)


def test_alert_event_enters_once_and_gauges_are_capped(prob):
    """A feature entering the alert set publishes one ``drift.alert``;
    only the top-K features get a PSI gauge."""
    from lightgbmv1_tpu_torch.obs.metrics import Registry

    X, y, bst, ref, raw, _ = prob
    Xs = X[:1000].copy()
    Xs[:, 0] += 3.0
    reg = Registry()
    det = tdrift.DriftDetector(ref, tdrift.DriftConfig(
        sample_rows=1024, min_rows=400, per_batch_rows=1024,
        sample_stride=1, top_k=2), registry=reg, version_tag="vT")
    det.offer(Xs, raw[:1000])
    mark = tevents.seq()
    det.evaluate()
    det.evaluate()
    alerts = [e for e in tevents.tail(since_seq=mark)
              if e["kind"] == "drift.alert"]
    assert len(alerts) == len(det.evaluate()["alerting"]) >= 1
    assert alerts[0]["fields"]["version"] == "vT"
    gauges = [k for k in reg.snapshot() if k.startswith("drift_feature_psi")]
    assert 1 <= len(gauges) <= 2


def test_checkpoint_carries_reference(prob, tmp_path):
    X, y, bst, ref, raw, _ = prob
    path = str(tmp_path / "ck.bundle")
    bst.save_checkpoint(path)
    bundle = load_checkpoint(path)
    assert "reference.bin" in bundle["manifest"]["digests"]
    assert tmodel.ModelReference.from_bytes(
        bundle["reference_bytes"]).digest == ref.digest
    path2 = str(tmp_path / "ck2.bundle")
    bst.save_checkpoint(path2, with_reference=False)
    assert load_checkpoint(path2)["reference_bytes"] == b""


def _drift_server(bst, ref, **over):
    kw = dict(max_batch_rows=256, max_batch_delay_ms=1.0,
              drift_sample_rows=2048, drift_per_batch_rows=256,
              drift_min_rows=400, drift_sample_stride=1,
              predictor_kwargs={"bucket_min": 256})
    kw.update(over)
    srv = Server(None, config=ServeConfig(**kw), device="cpu")
    srv.publish(bst, model_reference=ref)
    return srv


def test_serve_drift_clean_then_skew_and_swap(prob):
    """Armed, ``/drift`` stays quiet on training rows and alerts on
    shifted ones; a publish re-anchors it to the new version's
    reference; disarmed it says why."""
    X, y, bst, ref, raw, _ = prob
    srv = _drift_server(bst, ref)
    http = ServeHTTP(srv, port=0).start()
    try:
        for lo in range(0, 1024, 256):
            srv.submit(X[lo:lo + 256])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/drift", timeout=30) as r:
            clean = json.loads(r.read())
        assert clean["armed"] and clean["evaluated"]
        assert not clean["alerting"] and clean["version"] == "v1"
        Xs = X[1024:1536].copy()
        Xs[:, 0] += 3.0
        for lo in range(0, 512, 256):
            srv.submit(Xs[lo:lo + 256])
        skew = srv.drift_snapshot()
        assert "Column_0" in skew["alerting"]
        assert skew["psi_max"] >= 0.25
        srv.publish(bst, model_reference=ref)
        srv.submit(X[:8])
        again = srv.drift_snapshot()
        assert again["version"] == "v2" and not again["evaluated"]
        meta = srv.registry.current().meta
        assert meta["model_reference_digest"] == ref.digest
        assert meta["importance_shift"]["l1"] == 0.0
    finally:
        http.shutdown()
        srv.close()
    off = Server(bst, config=ServeConfig(max_batch_rows=64), device="cpu")
    try:
        assert off.drift_snapshot()["reason"].startswith("drift_sample_rows")
    finally:
        off.close()


def test_quality_snapshot_matches_jax(prob):
    """The same trees (the port's model text loaded by both packages):
    the same keys, every number within 2e-5; a trained booster's
    snapshot carries its metric curves."""
    X, y, bst, ref, raw, _ = prob
    text = bst.model_to_string()
    t_q = lt.Booster(model_str=text, device="cpu").quality_snapshot()
    j_q = lj.Booster(model_str=text).quality_snapshot()

    def close(a, b, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                close(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (u, v) in enumerate(zip(a, b)):
                close(u, v, f"{path}[{i}]")
        elif isinstance(a, (int, float)):
            assert abs(a - b) <= 2e-5 * max(1.0, abs(b)), (path, a, b)
        else:
            assert a == b, path

    close(t_q, j_q, "q")
    ev = {}
    trained = lt.train(PARAMS, lt.Dataset(X[:1500], label=y[:1500],
                                          categorical_feature=[4]), 3,
                       valid_sets=[lt.Dataset(X[1500:], label=y[1500:],
                                              categorical_feature=[4])],
                       callbacks=[lt.record_evaluation(ev)], device="cpu")
    q = trained.quality_snapshot()
    assert q["metric_history"]["valid_0:binary_logloss"] \
        == ev["valid_0"]["binary_logloss"]
    assert q["n_trees"] == 3 and q["split_gain"]["count"] > 0
