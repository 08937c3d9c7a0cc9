"""TreeSHAP and prediction early stopping of the port against the JAX
package's, on the CPU.

``predict(pred_contrib=True)`` (models/treeshap.py, float64, a row and a
tree at a time in both packages) within 1e-12 of the JAX package's on 64
rows of a binary, a multiclass (K = 3) and a categorical model loaded
from the same text, each row's block summing to its raw score within
1e-9; ``pred_early_stop`` (freq 5, margin 4) equal to the JAX package's,
binary and multiclass, and ignored on raw scores.
"""

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.models.treeshap import tree_expected_value

PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
          "verbosity": -1, "max_bin": 63, "hist_dtype": "f32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=1200, seed=0, n_class=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[rng.rand(n, 5) < 0.05] = np.nan
    X[:, 4] = np.floor(np.abs(rng.randn(n)) * 3)       # categories 0..~9
    logit = 2.0 * np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 1]) \
        + 1.5 * np.isin(X[:, 4], [0, 2]) - 0.7
    noisy = logit + 0.5 * rng.randn(n)
    if n_class == 2:
        return X, (noisy > 0).astype(np.float64)
    return X, np.digitize(noisy, [-0.8, 0.8]).astype(np.float64)


def _pair(kind, iters=12):
    """The same model text loaded by both packages, and the rows."""
    n_class = 3 if kind == "multiclass" else 2
    X, y = _data(n_class=n_class)
    p = dict(PARAMS, objective="multiclass", num_class=3) \
        if kind == "multiclass" else PARAMS
    ds = lt.Dataset(X, label=y, categorical_feature=(
        [4] if kind == "categorical" else "auto"))
    text = lt.train(p, ds, iters, device="cpu").model_to_string()
    return lj.Booster(model_str=text), lt.Booster(model_str=text,
                                                  device="cpu"), X


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical"])
def test_pred_contrib_matches_jax(kind):
    jb, tb, X = _pair(kind)
    if kind == "categorical":
        assert any(t.is_cat[:t.num_leaves - 1].any()
                   for t in tb._all_trees())
    rows = X[:64]
    got = tb.predict(rows, pred_contrib=True)
    K, F = tb.num_model_per_iteration(), X.shape[1]
    assert got.shape == (64, K * (F + 1)) and got.dtype == np.float64
    np.testing.assert_allclose(got, jb.predict(rows, pred_contrib=True),
                               rtol=0, atol=1e-12)
    raw = tb.predict(rows, raw_score=True).reshape(64, K)
    sums = got.reshape(64, K, F + 1).sum(axis=2)
    np.testing.assert_allclose(sums, raw, rtol=0, atol=1e-9)
    # the last column of a class block is its trees' expected value
    trees = tb._all_trees()
    for k in range(K):
        base = sum(tree_expected_value(t) for t in trees[k::K])
        np.testing.assert_allclose(got[:, k * (F + 1) + F], base, rtol=0,
                                   atol=1e-12)


def test_pred_contrib_of_a_slice_and_a_trained_booster():
    """``start_iteration`` / ``num_iteration`` slice the trees the
    contributions sum over; a training Booster's equal its text's."""
    X, y = _data(seed=2)
    b = lt.train(PARAMS, lt.Dataset(X, label=y), 8, device="cpu")
    jb = lj.Booster(model_str=b.model_to_string())
    kw = dict(start_iteration=2, num_iteration=3)
    got = b.predict(X[:16], pred_contrib=True, **kw)
    np.testing.assert_allclose(got, jb.predict(X[:16], pred_contrib=True,
                                               **kw), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.sum(axis=1), b.predict(
        X[:16], raw_score=True, **kw), rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_pred_early_stop_matches_jax(kind):
    """freq 5, margin 4: the JAX package's predictions bit for bit; some
    rows stop early and some do not; raw scores ignore it."""
    jb, tb, X = _pair(kind, iters=30)
    kw = dict(pred_early_stop=True, pred_early_stop_freq=5,
              pred_early_stop_margin=4.0)
    got = tb.predict(X, **kw)
    np.testing.assert_array_equal(got, jb.predict(X, **kw))
    full = tb.predict(X)
    stopped = (got != full).reshape(len(X), -1).any(axis=1)
    assert 0 < stopped.sum() < len(X)
    np.testing.assert_array_equal(tb.predict(X, raw_score=True, **kw),
                                  tb.predict(X, raw_score=True))
    # the knob in the Booster's params, as the CLI passes it
    pb = lt.Booster(model_str=tb.model_to_string(), device="cpu",
                    params={"pred_early_stop": True,
                            "pred_early_stop_freq": 5,
                            "pred_early_stop_margin": 4.0})
    np.testing.assert_array_equal(pb.predict(X), got)


def test_pred_early_stop_skips_the_device_walk():
    """Under early stopping a device ``predict_method`` gives way to the
    host loop, as in the JAX package (:725-727)."""
    jb, tb, X = _pair("binary", iters=20)
    kw = dict(pred_early_stop=True, pred_early_stop_freq=5,
              pred_early_stop_margin=4.0)
    np.testing.assert_array_equal(
        tb.predict(X, predict_method="pallas", **kw),
        jb.predict(X, predict_method="pallas", **kw))
