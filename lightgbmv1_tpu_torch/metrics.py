"""Evaluation metrics (host numpy float64).

Port of lightgbmv1_tpu/metrics.py: every metric there, ``L2Metric``
(:66) and ``RMSEMetric`` (:73), the regression family ``L1Metric``
(:80) ... ``TweedieMetric`` (:149), ``BinaryLoglossMetric`` (:159),
``BinaryErrorMetric`` (:167), ``AUCMetric`` (:174), ``AucMuMetric``
(:202, on raw scores, with ``auc_mu_weights``), ``MultiLoglossMetric``
(:263), ``MultiErrorMetric`` (:272), ``CrossEntropyMetric`` (:286),
``NDCGMetric`` (:294) and ``MapMetric`` (:327) with ``eval_at``, and
``create_metrics`` (:415) with each objective's default metric: the same
formulas on the same float64 inputs (reference regression_metric.hpp,
binary_metric.hpp, multiclass_metric.hpp, rank_metric.hpp,
map_metric.hpp, xentropy_metric.hpp; AUC exact under ties by the
grouped-rank formulation).  A name the JAX package does not know is
skipped with a warning, as there (:431).
"""

from __future__ import annotations

from typing import List

import math

import numpy as np

from .config import Config
from .utils.log import log_fatal, log_warning


class Metric:
    name = "metric"
    higher_better = False
    # evaluated on the raw scores, not the converted predictions
    wants_raw = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.label = np.asarray(metadata.label, dtype=np.float64)
        self.weight = (np.asarray(metadata.weight, dtype=np.float64)
                       if metadata.weight is not None else None)
        self.sum_weight = (float(self.weight.sum())
                           if self.weight is not None else float(num_data))
        self.metadata = metadata
        self.num_data = num_data

    def eval(self, pred: np.ndarray) -> List[tuple]:
        raise NotImplementedError

    def _avg(self, losses: np.ndarray) -> float:
        if self.weight is not None:
            return float((losses * self.weight).sum() / self.sum_weight)
        return float(losses.mean())


class _PointwiseMetric(Metric):
    """The weighted mean of a per-row loss ``_loss(label, pred)``."""

    def eval(self, pred):
        return [(self.name, self._avg(self._loss(self.label, pred)),
                 self.higher_better)]


class L2Metric(_PointwiseMetric):
    name = "l2"

    def _loss(self, y, p):
        return (y - p) ** 2


class RMSEMetric(Metric):
    name = "rmse"

    def eval(self, pred):
        return [(self.name, math.sqrt(self._avg((self.label - pred) ** 2)),
                 False)]


class L1Metric(_PointwiseMetric):
    name = "l1"

    def _loss(self, y, p):
        return np.abs(y - p)


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def _loss(self, y, p):
        a = self.config.alpha
        d = y - p
        return np.where(d >= 0, a * d, (a - 1) * d)


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def _loss(self, y, p):
        a = self.config.alpha
        d = np.abs(y - p)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def _loss(self, y, p):
        c = self.config.fair_c
        x = np.abs(y - p)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def _loss(self, y, p):
        p = np.maximum(p, 1e-20)
        return p - y * np.log(p)


class MapeMetric(_PointwiseMetric):
    name = "mape"

    def _loss(self, y, p):
        return np.abs(y - p) / np.maximum(np.abs(y), 1.0)


class GammaMetric(_PointwiseMetric):
    name = "gamma"

    def _loss(self, y, p):
        theta = -1.0 / np.maximum(p, 1e-20)
        a = -np.log(-theta)
        return -np.log(np.maximum(y, 1e-20)) - y * theta + a


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma_deviance"

    def _loss(self, y, p):
        eps = 1e-9
        r = y / np.maximum(p, eps)
        return 2.0 * (np.log(np.maximum(1.0 / np.maximum(r, eps), eps))
                      + r - 1.0)


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def _loss(self, y, p):
        rho = self.config.tweedie_variance_power
        p = np.maximum(p, 1e-20)
        a = y * np.power(p, 1.0 - rho) / (1.0 - rho)
        b = np.power(p, 2.0 - rho) / (2.0 - rho)
        return -a + b


class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def _loss(self, y, p):
        p = np.clip(p, 1e-15, 1 - 1e-15)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class CrossEntropyMetric(BinaryLoglossMetric):
    """The log loss of labels in [0, 1]."""

    name = "cross_entropy"


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, pred):
        loss = np.where(pred > 0.5, self.label <= 0.5,
                        self.label > 0.5).astype(np.float64)
        return [(self.name, self._avg(loss), self.higher_better)]


class AUCMetric(Metric):
    name = "auc"
    higher_better = True

    def eval(self, pred):
        y = self.label
        w = self.weight if self.weight is not None else np.ones_like(y)
        order = np.argsort(pred, kind="mergesort")
        p, yy, ww = pred[order], y[order], w[order]
        posw = ww * (yy > 0)
        negw = ww * (yy <= 0)
        # tie groups share the credit of their negatives
        new_group = np.empty(len(p), dtype=bool)
        new_group[0] = True
        new_group[1:] = p[1:] != p[:-1]
        gid = np.cumsum(new_group) - 1
        num_groups = gid[-1] + 1
        g_negw = np.bincount(gid, weights=negw, minlength=num_groups)
        cum_negw_before = np.concatenate([[0.0], np.cumsum(g_negw)])[:-1]
        credit = cum_negw_before[gid] + 0.5 * g_negw[gid]
        tot_pos, tot_neg = posw.sum(), negw.sum()
        if tot_pos <= 0 or tot_neg <= 0:
            log_warning("AUC undefined: only one class present")
            return [(self.name, 0.5, True)]
        auc = float((posw * credit).sum() / (tot_pos * tot_neg))
        return [(self.name, auc, True)]


class AucMuMetric(Metric):
    """Multiclass AUC-mu (Kleiman & Page 2019; reference AucMuMetric,
    multiclass_metric.hpp:183-314) on the raw scores: each class pair's
    AUC along ``v = w_i - w_j`` of the ``auc_mu_weights`` matrix (uniform
    off the diagonal by default), ties at half credit."""

    name = "auc_mu"
    higher_better = True
    wants_raw = True

    def eval(self, pred):
        K = self.config.num_class
        y = self.label.astype(np.int64)
        scores = np.asarray(pred, np.float64).reshape(-1, K)
        W = self.config.auc_mu_weights
        if W:
            cw = np.asarray(W, np.float64).reshape(K, K)
            np.fill_diagonal(cw, 0.0)
        else:
            cw = np.ones((K, K)) - np.eye(K)
        total = 0.0
        for i in range(K):
            for j in range(i + 1, K):
                mask = (y == i) | (y == j)
                if not mask.any():
                    continue
                yi = y[mask]
                ni, nj = int((yi == i).sum()), int((yi == j).sum())
                if ni == 0 or nj == 0:
                    continue
                v = cw[i] - cw[j]
                dist = (v[i] - v[j]) * (scores[mask] @ v)
                pos = yi == i
                order = np.argsort(dist, kind="mergesort")
                d_s, p_s = dist[order], pos[order]
                new_group = np.empty(len(d_s), dtype=bool)
                new_group[0] = True
                new_group[1:] = d_s[1:] != d_s[:-1]
                gid = np.cumsum(new_group) - 1
                g_neg = np.bincount(gid, weights=(~p_s).astype(np.float64),
                                    minlength=gid[-1] + 1)
                neg_before = np.concatenate([[0.0], np.cumsum(g_neg)])[:-1]
                credit = neg_before[gid] + 0.5 * g_neg[gid]
                total += (float(credit[p_s].sum()) / ni) / nj
        return [(self.name, float((2.0 * total / K) / max(K - 1, 1)), True)]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, pred):                        # (N, K) probabilities
        lbl = self.label.astype(np.int64)
        p = np.clip(pred[np.arange(len(lbl)), lbl], 1e-15, None)
        return [(self.name, self._avg(-np.log(p)), False)]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, pred):
        lbl = self.label.astype(np.int64)
        k = self.config.multi_error_top_k
        if k <= 1:
            err = (pred.argmax(axis=1) != lbl).astype(np.float64)
        else:
            topk = np.argsort(-pred, axis=1)[:, :k]
            err = (~(topk == lbl[:, None]).any(axis=1)).astype(np.float64)
        return [(self.name, self._avg(err), False)]


class NDCGMetric(Metric):
    """ndcg@k for each k of ``eval_at``, averaged over the queries; a
    query without a relevant document scores 1."""

    name = "ndcg"
    higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log_fatal("[ndcg]: query data (group) is required")
        self.qb = np.asarray(metadata.query_boundaries, dtype=np.int64)
        self.gains = np.asarray(self.config.label_gain_or_default,
                                dtype=np.float64)

    def eval(self, pred):
        ks = self.config.eval_at
        results = {k: [] for k in ks}
        lbl = self.label.astype(np.int64)
        for b, e in zip(self.qb[:-1], self.qb[1:]):
            labels = lbl[b:e]
            order = np.argsort(-pred[b:e], kind="mergesort")
            g_sorted = self.gains[labels[order]]
            ideal = np.sort(self.gains[labels])[::-1]
            disc = 1.0 / np.log2(np.arange(2, len(g_sorted) + 2))
            for k in ks:
                kk = min(k, len(g_sorted))
                idcg = float((ideal[:kk] * disc[:kk]).sum())
                results[k].append(
                    1.0 if idcg <= 0 else
                    float((g_sorted[:kk] * disc[:kk]).sum()) / idcg)
        return [(f"ndcg@{k}", float(np.mean(results[k])), True) for k in ks]


class MapMetric(Metric):
    """map@k (mean average precision) for each k of ``eval_at``."""

    name = "map"
    higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log_fatal("[map]: query data (group) is required")
        self.qb = np.asarray(metadata.query_boundaries, dtype=np.int64)

    def eval(self, pred):
        ks = self.config.eval_at
        results = {k: [] for k in ks}
        for b, e in zip(self.qb[:-1], self.qb[1:]):
            order = np.argsort(-pred[b:e], kind="mergesort")
            rel = (self.label[b:e][order] > 0).astype(np.float64)
            prec = np.cumsum(rel) / np.arange(1, len(rel) + 1)
            for k in ks:
                kk = min(k, len(rel))
                nrel = rel[:kk].sum()
                results[k].append(float((prec[:kk] * rel[:kk]).sum() / nrel)
                                  if nrel > 0 else 0.0)
        return [(f"map@{k}", float(np.mean(results[k])), True) for k in ks]


_METRICS = {
    **dict.fromkeys(("l2", "mse", "mean_squared_error", "regression"),
                    L2Metric),
    **dict.fromkeys(("rmse", "l2_root", "root_mean_squared_error"),
                    RMSEMetric),
    **dict.fromkeys(("l1", "mae", "mean_absolute_error", "regression_l1"),
                    L1Metric),
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric,
    **dict.fromkeys(("mape", "mean_absolute_percentage_error"),
                    MapeMetric),
    "gamma": GammaMetric, "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric,
    "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    **dict.fromkeys(("multi_logloss", "multiclass", "softmax",
                     "multiclassova"), MultiLoglossMetric),
    "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric,
    **dict.fromkeys(("cross_entropy", "xentropy"), CrossEntropyMetric),
    **dict.fromkeys(("ndcg", "lambdarank", "rank_xendcg"), NDCGMetric),
    **dict.fromkeys(("map", "mean_average_precision"), MapMetric),
}

_DEFAULT_METRIC_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss", "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss", "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy", "lambdarank": "ndcg",
    "rank_xendcg": "ndcg"}


def create_metrics(config: Config) -> List[Metric]:
    names = list(config.metric)
    if not names:
        default = _DEFAULT_METRIC_FOR_OBJECTIVE.get(config.objective)
        names = [default] if default else []
    out: List[Metric] = []
    seen = set()
    for name in names:
        name = name.strip().lower()
        if name in ("", "none", "null", "na", "custom"):
            continue
        if name.startswith(("ndcg@", "map@")):
            name, at = name.split("@", 1)
            config.eval_at = [int(x) for x in at.split(",")]
        if name not in _METRICS:
            log_warning(f"Unknown metric {name}")
            continue
        cls = _METRICS[name]
        if cls.name in seen:
            continue
        seen.add(cls.name)
        out.append(cls(config))
    return out
