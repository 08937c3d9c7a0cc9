"""Training with each objective the breadth slice ports, held against the
JAX package on the CPU; and the leaf renewal of L1, quantile and mape.

Both packages train the same numpy rows for 5 iterations through
``train`` (the JAX package's step, Pallas in interpret mode; the port's
eager step on the kernels' plain versions).  L1, quantile and mape renew
each grown tree's leaves to a weighted quantile of its rows' residuals
``label - score`` (float64) before the shrinkage, as the JAX package's
host path does; the port orders every leaf's rows with two stable sorts
on the training device, by residual then by leaf, where the JAX package
sorts each leaf apart.

Tolerances: every split identical; leaf values within 1e-4 of the
largest leaf (the port's training tolerance, test_torch_train.py: the
histograms sum in another f32 order), the renewed leaves within float32
rounding (a quantile is one of the residuals, the same float64 numbers in
both packages); the model text's objective line equal; the last valid
metric within 1e-6 of its value; the renewed values of one leaf set, with
tied residuals and row weights, equal.
"""

import types

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu.models import gbdt as jgbdt

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.models import gbdt as tgbdt

N, NV, ITERS = 2048, 512, 5
BASE = {"verbosity": -1, "max_bin": 63, "num_leaves": 15,
        "min_data_in_leaf": 5, "hist_dtype": "f32"}
RENEWING = ("regression_l1", "quantile", "mape")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(objective, f, rng):
    """Labels of each objective's domain from the signal ``f``."""
    noise = rng.standard_t(3, len(f))             # heavy tails
    if objective in ("poisson", "tweedie"):
        return rng.poisson(np.exp(0.5 * f)).astype(np.float64)
    if objective == "gamma":
        return np.exp(0.5 * f) * rng.gamma(2.0, 0.5, len(f))
    if objective in ("cross_entropy", "cross_entropy_lambda"):
        return 1.0 / (1.0 + np.exp(-f - 0.5 * rng.randn(len(f))))
    if objective == "rank_xendcg":
        return np.clip(np.round(f + 0.5 * noise + 1), 0, 4)
    return f + noise


def _data(objective, seed, n):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.05, 1] = np.nan
    X[:, 3] = np.round(X[:, 3] * 2)
    f = X[:, 0] - np.nan_to_num(X[:, 1]) + 0.5 * X[:, 2] * X[:, 3]
    kw = {"group": np.full(n // 16, 16)} if objective == "rank_xendcg" \
        else {}
    return X, _labels(objective, f, rng), kw


CASES = {
    "regression_l1": {}, "regression_l1-weighted": {"weighted": True},
    "huber": {"alpha": 1.2}, "fair": {"fair_c": 0.8}, "poisson": {},
    "quantile": {"alpha": 0.3}, "mape": {}, "mape-weighted": {"weighted":
                                                             True},
    "gamma": {}, "tweedie": {"tweedie_variance_power": 1.3},
    "cross_entropy": {}, "cross_entropy_lambda": {},
    "rank_xendcg": {"eval_at": [5]},
    "regression_l1-dart": {"boosting": "dart", "drop_rate": 0.5,
                           "skip_drop": 0.0},
}


@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_jax(case):
    extra = dict(CASES[case])
    objective = case.split("-")[0]
    weighted = extra.pop("weighted", False)
    params = dict(BASE, objective=objective, **extra)
    X, y, kw = _data(objective, 20, N)
    Xv, yv, vkw = _data(objective, 21, NV)
    if weighted:
        rng = np.random.RandomState(22)
        kw["weight"] = rng.rand(N) + 0.5
        vkw["weight"] = rng.rand(NV) + 0.5
    jev, tev = {}, {}
    jb = lj.train(params, lj.Dataset(X, label=y, **kw), ITERS,
                  valid_sets=[lj.Dataset(Xv, label=yv, **vkw)],
                  evals_result=jev, verbose_eval=False)
    tb = lt.train(params, lt.Dataset(X, label=y, **kw), ITERS,
                  valid_sets=[lt.Dataset(Xv, label=yv, **vkw)],
                  evals_result=tev, device="cpu")
    jtrees, ttrees = jb._gbdt.materialize_host_trees(), tb._all_trees()
    assert len(jtrees) == len(ttrees) == ITERS
    top = max(float(np.abs(t.leaf_value).max()) for t in jtrees)
    renew = objective in RENEWING
    tol = 2.0 ** -23 * top if renew else 1e-4 * max(top, 1e-3)
    for jt, tt in zip(jtrees, ttrees):
        assert tt.num_leaves == jt.num_leaves > 1
        np.testing.assert_array_equal(tt.split_feature, jt.split_feature)
        np.testing.assert_array_equal(tt.threshold_bin, jt.threshold_bin)
        np.testing.assert_array_equal(tt.default_left, jt.default_left)
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=0,
                                   atol=tol)
    assert (tb.model_to_string().splitlines()[6]
            == jb.model_to_string().splitlines()[6])
    (name, want), = [(k, v[-1]) for k, v in jev["valid_0"].items()]
    got = tev["valid_0"][name][-1]
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), name
    if renew:
        # the renewed values are quantiles of the residuals, not the
        # grown Newton leaves
        assert tb._gbdt.models[0] is not None


@pytest.mark.parametrize("objective,weighted", [
    ("regression_l1", False), ("regression_l1", True), ("quantile", True),
    ("mape", False), ("mape", True)])
def test_renewed_leaf_values_match_jax(objective, weighted):
    """The port's sort by (leaf, residual) against the JAX package's
    per-leaf loop, on residuals with long runs of ties, row weights,
    and a leaf without rows (it keeps its grown value)."""
    rng = np.random.RandomState(30)
    n, L = 3000, 9
    label = np.round(rng.randn(n) * 2) / 2            # tied residuals
    score = np.round(rng.randn(n)).astype(np.float32)
    lid = rng.randint(0, L - 1, n)                     # leaf L-1 is empty
    w = rng.rand(n) + 0.5 if weighted else None
    params = {"objective": objective, "alpha": 0.7}
    leaf_value = rng.randn(L)
    out = []
    for mod, pkg in ((jgbdt, lj), (tgbdt, lt)):
        cfg = pkg.Config.from_dict(dict(params))
        obj = (__import__(f"{pkg.__name__}.objectives",
                          fromlist=["x"]).create_objective(cfg))
        obj._np_label = label
        obj._np_weight = w
        if objective == "mape":
            obj._label_weight = 1.0 / np.maximum(np.abs(label), 1.0) * (
                1.0 if w is None else w)
        self = types.SimpleNamespace(objective=obj, _objective_global=obj,
                                     _shard=None)
        self._renew_rows = types.MethodType(tgbdt.GBDT._renew_rows, self)
        tree = types.SimpleNamespace(num_leaves=L,
                                     leaf_value=leaf_value.copy())
        q = obj.renew_percentile
        if mod is jgbdt:
            out.append(jgbdt.GBDT._renew_leaf_values(
                self, tree, lid, 0, q, score))
        else:
            out.append(tgbdt.GBDT._renew_leaf_values(
                self, tree, torch.from_numpy(lid), torch.from_numpy(score),
                q))
    np.testing.assert_array_equal(out[1], out[0])
    assert out[1][L - 1] == leaf_value[L - 1]
