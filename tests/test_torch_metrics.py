"""The port's metrics held against the JAX package's: l2, rmse, the
regression family (l1, quantile, huber, fair, poisson, mape, gamma,
gamma_deviance, tweedie), cross_entropy, multi_logloss, multi_error,
auc_mu (on raw scores, with ``auc_mu_weights``), ndcg and map.

Both take the same float64 numpy predictions, labels, weights and query
groups; every value agrees within 1e-9 (both are host numpy float64, in
the same formulas).  Each ported objective's default metric, and the
``ndcg@k`` / ``map@k`` names that set ``eval_at``, resolve as there.
"""

import numpy as np
import pytest

from lightgbmv1_tpu import metrics as jmetrics
from lightgbmv1_tpu.config import Config as JConfig
from lightgbmv1_tpu.io.dataset import Metadata as JMetadata

from lightgbmv1_tpu_torch import metrics as tmetrics
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.dataset import Metadata

N = 800


def _case(kind, rng, weighted):
    """(label, predictions, query sizes) of a metric family."""
    if kind == "multi":
        label = rng.randint(0, 4, N).astype(np.float64)
        raw = rng.randn(N, 4)
        raw[:40] = 0.0                               # argmax ties
        e = np.exp(raw)
        return label, e / e.sum(axis=1, keepdims=True), None
    if kind == "rank":
        label = rng.randint(0, 4, N).astype(np.float64)
        label[:30] = 0                               # a query without hits
        pred = np.round(rng.randn(N) * 2) / 2        # tied scores
        return label, pred, np.array([30, 1, 7] + [34] * 22 + [14])
    if kind == "pos":                            # counts, positive preds
        return rng.poisson(2.0, N).astype(np.float64), \
            np.exp(rng.randn(N)), None
    if kind == "prob":
        return rng.rand(N), 1.0 / (1.0 + np.exp(-rng.randn(N) * 2)), None
    if kind == "mc_raw":                         # (N, 3) raw scores
        label = rng.randint(0, 3, N).astype(np.float64)
        raw = rng.randn(N, 3)
        raw[:60] = np.round(raw[:60])            # tied projections
        return label, raw, None
    return rng.randn(N) * 2, rng.randn(N) * 2, None


def _eval(name, params, kind, weighted, seed):
    rng = np.random.RandomState(seed)
    label, pred, group = _case(kind, rng, weighted)
    w = rng.rand(N) + 0.5 if weighted else None
    out = []
    for mod, cfg_cls, meta_cls in ((jmetrics, JConfig, JMetadata),
                                   (tmetrics, Config, Metadata)):
        cfg = cfg_cls.from_dict(dict(params, metric=[name]))
        metrics = mod.create_metrics(cfg)
        meta = meta_cls(label=label, weight=w)
        meta.set_group(group)
        res = []
        for m in metrics:
            m.init(meta, N)
            res += m.eval(pred)
        out.append(res)
    return out


@pytest.mark.parametrize("name,params,kind", [
    ("l2", {}, "reg"), ("mse", {}, "reg"), ("rmse", {}, "reg"),
    ("l2_root", {}, "reg"),
    ("multi_logloss", {}, "multi"), ("multi_error", {}, "multi"),
    ("multi_error", {"multi_error_top_k": 2}, "multi"),
    ("ndcg", {}, "rank"), ("ndcg@1,3,10", {}, "rank"),
    ("ndcg", {"eval_at": [2, 50], "label_gain": [0, 1, 5, 9]}, "rank"),
    ("map", {}, "rank"), ("map@3,34", {}, "rank")],
    ids=["l2", "mse", "rmse", "l2_root", "multi_logloss", "multi_error",
         "multi_error-top2", "ndcg", "ndcg@", "ndcg-gains", "map", "map@"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_metric_matches_jax(name, params, kind, weighted):
    want, got = _eval(name, params, kind, weighted, seed=len(name))
    assert [(n, hb) for n, _, hb in got] == [(n, hb) for n, _, hb in want]
    assert got
    if "@" in name:            # ndcg@1,3,10 -> ndcg@1, ndcg@3, ndcg@10
        assert len(got) == len(name.split(","))
    for (_, g, _), (_, w, _) in zip(got, want):
        assert abs(g - w) <= 1e-9


@pytest.mark.parametrize("objective", ["regression", "binary", "multiclass",
                                       "multiclassova", "lambdarank"])
def test_default_metric_of_each_objective(objective):
    params = {"objective": objective, "num_class": 3}
    if objective not in ("multiclass", "multiclassova"):
        params.pop("num_class")
    want = [m.name for m in jmetrics.create_metrics(JConfig.from_dict(
        dict(params)))]
    got = [m.name for m in tmetrics.create_metrics(Config.from_dict(
        dict(params)))]
    assert got == want and len(got) == 1


def test_query_metrics_need_groups():
    from lightgbmv1_tpu_torch.utils.log import LightGBMError

    for name in ("ndcg", "map"):
        m = tmetrics.create_metrics(Config.from_dict({"metric": name}))[0]
        with pytest.raises(LightGBMError, match="group"):
            m.init(Metadata(label=np.zeros(4)), 4)


@pytest.mark.parametrize("name,params,kind", [
    ("l1", {}, "reg"), ("mae", {}, "reg"), ("regression_l1", {}, "reg"),
    ("quantile", {"alpha": 0.3}, "reg"), ("huber", {"alpha": 1.5}, "reg"),
    ("fair", {"fair_c": 0.7}, "reg"), ("poisson", {}, "pos"),
    ("mape", {}, "reg"), ("mean_absolute_percentage_error", {}, "reg"),
    ("gamma", {}, "pos"), ("gamma_deviance", {}, "pos"),
    ("tweedie", {"tweedie_variance_power": 1.3}, "pos"),
    ("cross_entropy", {}, "prob"), ("xentropy", {}, "prob"),
    ("auc_mu", {"num_class": 3}, "mc_raw"),
    ("auc_mu", {"num_class": 3,
                "auc_mu_weights": [0, 1, 2, 1, 0, 3, 2, 3, 0]}, "mc_raw")],
    ids=["l1", "mae", "regression_l1", "quantile", "huber", "fair",
         "poisson", "mape", "mape-alias", "gamma", "gamma_deviance",
         "tweedie", "cross_entropy", "xentropy", "auc_mu",
         "auc_mu-weights"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_breadth_metric_matches_jax(name, params, kind, weighted):
    want, got = _eval(name, params, kind, weighted, seed=len(name) + 3)
    assert got and [(n, hb) for n, _, hb in got] == [(n, hb) for n, _, hb
                                                     in want]
    for (_, g, _), (_, w, _) in zip(got, want):
        assert abs(g - w) <= 1e-9


@pytest.mark.parametrize("objective", [
    "regression_l1", "huber", "fair", "poisson", "quantile", "mape",
    "gamma", "tweedie", "cross_entropy", "cross_entropy_lambda",
    "rank_xendcg"])
def test_breadth_default_metric(objective):
    want = [m.name for m in jmetrics.create_metrics(JConfig.from_dict(
        {"objective": objective}))]
    got = [m.name for m in tmetrics.create_metrics(Config.from_dict(
        {"objective": objective}))]
    assert got == want and len(got) == 1


def test_auc_mu_reads_raw_scores():
    """auc_mu is evaluated on the raw scores by the trainer, as the JAX
    package's ``wants_raw``."""
    m = tmetrics.create_metrics(Config.from_dict(
        {"metric": "auc_mu", "objective": "multiclass", "num_class": 3}))
    assert [x.wants_raw for x in m] == [True]
