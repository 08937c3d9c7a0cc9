"""Evaluation metrics of the binary path (host numpy float64).

Port of lightgbmv1_tpu/metrics.py ``BinaryLoglossMetric`` (:159),
``BinaryErrorMetric`` (:167), ``AUCMetric`` (:174) and ``create_metrics``
(:415) for those three: the same formulas on the same float64 inputs
(reference binary_metric.hpp; AUC exact under ties by the grouped-rank
formulation).  A metric the JAX package has and the port does not yet
raises ``NotImplementedError`` with its ROADMAP item; a name the JAX
package does not know is skipped with a warning, as there (:431).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .config import BREADTH, OBJECTIVES, Config, not_ported
from .utils.log import log_warning


class Metric:
    name = "metric"
    higher_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.label = np.asarray(metadata.label, dtype=np.float64)
        self.weight = (np.asarray(metadata.weight, dtype=np.float64)
                       if metadata.weight is not None else None)
        self.sum_weight = (float(self.weight.sum())
                           if self.weight is not None else float(num_data))
        self.num_data = num_data

    def eval(self, pred: np.ndarray) -> List[tuple]:
        raise NotImplementedError

    def _avg(self, losses: np.ndarray) -> float:
        if self.weight is not None:
            return float((losses * self.weight).sum() / self.sum_weight)
        return float(losses.mean())


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, pred):
        p = np.clip(pred, 1e-15, 1 - 1e-15)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [(self.name, self._avg(loss), self.higher_better)]


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


_METRICS = {
    "binary_logloss": BinaryLoglossMetric,
    "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
}

# the JAX package's other metric names (its metrics.py:353-389), by the
# ROADMAP queue 1 item that ports them
_UNPORTED_METRICS = {
    **dict.fromkeys(
        ("l2", "mse", "mean_squared_error", "regression", "rmse", "l2_root",
         "root_mean_squared_error", "multi_logloss", "multiclass", "softmax",
         "multiclassova", "multi_error", "ndcg", "lambdarank", "rank_xendcg",
         "map", "mean_average_precision"), OBJECTIVES),
    **dict.fromkeys(
        ("l1", "mae", "mean_absolute_error", "regression_l1", "quantile",
         "huber", "fair", "poisson", "mape", "mean_absolute_percentage_error",
         "gamma", "gamma_deviance", "tweedie", "auc_mu", "cross_entropy",
         "xentropy"), BREADTH),
}

_DEFAULT_METRIC_FOR_OBJECTIVE = {"binary": "binary_logloss"}


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
        base = name.split("@", 1)[0]
        if base in ("ndcg", "map") or name in _UNPORTED_METRICS:
            raise not_ported(f"metric={name}", _UNPORTED_METRICS[base])
        if name not in _METRICS:
            log_warning(f"Unknown metric {name}")
            continue
        cls = _METRICS[name]
        if cls.name in seen:
            continue
        seen.add(cls.name)
        out.append(cls(config))
    return out
