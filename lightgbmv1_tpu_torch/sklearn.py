"""scikit-learn estimator wrappers; the port's copy of
lightgbmv1_tpu/sklearn.py.

Mirrors the reference python-package sklearn module
(``python-package/lightgbm/sklearn.py``: ``LGBMModel`` :172 and the
classifier, regressor and ranker after it) over the port's ``train``.
The estimators follow the sklearn fit / predict / get_params protocol
without importing scikit-learn.  They train and predict on the card;
``device_type="cpu"`` (alias ``device``) among the keyword parameters runs
them on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, Dataset
from .device import knob_device
from .engine import train
from .utils.log import log_fatal


class LGBMModel:
    """Base sklearn-style estimator (reference sklearn.py:172)."""

    def __init__(
        self,
        boosting_type: str = "gbdt",
        num_leaves: int = 31,
        max_depth: int = -1,
        learning_rate: float = 0.1,
        n_estimators: int = 100,
        subsample_for_bin: int = 200000,
        objective: Optional[str] = None,
        class_weight=None,
        min_split_gain: float = 0.0,
        min_child_weight: float = 1e-3,
        min_child_samples: int = 20,
        subsample: float = 1.0,
        subsample_freq: int = 0,
        colsample_bytree: float = 1.0,
        reg_alpha: float = 0.0,
        reg_lambda: float = 0.0,
        random_state: Optional[int] = None,
        n_jobs: int = -1,
        silent: bool = True,
        importance_type: str = "split",
        **kwargs,
    ):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._n_features = 0
        self._classes = None
        self._n_classes = 1
        self.best_iteration_ = -1
        self.best_score_ = {}
        self.evals_result_ = {}

    # -- sklearn protocol ---------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective,
            "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample,
            "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha,
            "reg_lambda": self.reg_lambda,
            "random_state": self.random_state,
            "n_jobs": self.n_jobs,
            "silent": self.silent,
            "importance_type": self.importance_type,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _train_params(self) -> Dict[str, Any]:
        params = {
            "boosting": self.boosting_type,
            "objective": self.objective or self._default_objective(),
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbosity": -1 if self.silent else 1,
        }
        if self.random_state is not None:
            params["seed"] = int(self.random_state)
        params.update(self._other_params)
        return params

    # ------------------------------------------------------------------
    def fit(
        self,
        X,
        y,
        sample_weight=None,
        init_score=None,
        group=None,
        eval_set=None,
        eval_names=None,
        eval_sample_weight=None,
        eval_group=None,
        eval_metric=None,
        early_stopping_rounds=None,
        verbose: Union[bool, int] = False,
        callbacks=None,
    ) -> "LGBMModel":
        params = self._train_params()
        if eval_metric is not None:
            params["metric"] = eval_metric
        y_fit = self._process_label(np.asarray(y).ravel())
        if self.class_weight is not None and sample_weight is None:
            sample_weight = self._class_weights(y_fit)
        ds = Dataset(X, label=y_fit, weight=sample_weight, group=group,
                     init_score=init_score, params=dict(params))
        valid_sets = []
        valid_names = None
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            valid_names = eval_names
            for i, (vx, vy) in enumerate(eval_set):
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                if vx is X and vy is y:
                    valid_sets.append(ds)
                else:
                    valid_sets.append(ds.create_valid(
                        vx, label=self._process_label(np.asarray(vy).ravel()),
                        weight=vw, group=vg))
        self.evals_result_ = {}
        self._Booster = train(
            params,
            ds,
            num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None,
            valid_names=valid_names,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self.evals_result_,
            verbose_eval=verbose,
            callbacks=callbacks,
            device=knob_device(params.get("device_type",
                                          params.get("device"))),
        )
        self.best_iteration_ = self._Booster.best_iteration
        self.best_score_ = self._Booster.best_score
        self._n_features = ds.num_feature()
        return self

    def _process_label(self, y: np.ndarray) -> np.ndarray:
        return y.astype(np.float64)

    def _class_weights(self, y) -> Optional[np.ndarray]:
        if self.class_weight == "balanced":
            classes, counts = np.unique(y, return_counts=True)
            w = len(y) / (len(classes) * counts)
            lut = dict(zip(classes, w))
            return np.asarray([lut[v] for v in y])
        if isinstance(self.class_weight, dict):
            return np.asarray([self.class_weight.get(v, 1.0) for v in y])
        return None

    def predict(self, X, raw_score: bool = False, num_iteration=None,
                **kwargs):
        if self._Booster is None:
            log_fatal("Estimator not fitted, call fit first")
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration, **kwargs)

    # -- attributes ---------------------------------------------------------
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            log_fatal("No booster found. Need to call fit beforehand.")
        return self._Booster

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        return self.booster_.feature_name()


class LGBMRegressor(LGBMModel):
    def _default_objective(self) -> str:
        return "regression"


class LGBMClassifier(LGBMModel):
    def _default_objective(self) -> str:
        return "binary" if self._n_classes <= 2 else "multiclass"

    def fit(self, X, y, **kwargs):
        y_arr = np.asarray(y).ravel()
        self._classes, _ = np.unique(y_arr, return_inverse=True)
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            self._other_params.setdefault("num_class", self._n_classes)
            if self.objective is None:
                self.objective = "multiclass"
        return super().fit(X, y, **kwargs)

    def _process_label(self, y: np.ndarray) -> np.ndarray:
        lut = {v: i for i, v in enumerate(self._classes)}
        return np.asarray([lut[v] for v in y], dtype=np.float64)

    def predict(self, X, raw_score: bool = False, num_iteration=None,
                **kwargs):
        prob = self.predict_proba(X, raw_score=raw_score,
                                  num_iteration=num_iteration, **kwargs)
        if raw_score:
            return prob
        if prob.ndim == 1:
            idx = (prob > 0.5).astype(int)
        else:
            idx = prob.argmax(axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False,
                      num_iteration=None, **kwargs):
        out = self.booster_.predict(X, raw_score=raw_score,
                                    num_iteration=num_iteration, **kwargs)
        if raw_score:
            return out
        if out.ndim == 1:  # binary: return (N, 2) like sklearn
            return np.column_stack([1.0 - out, out])
        return out

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            log_fatal("Should set group for ranking task")
        return super().fit(X, y, group=group, **kwargs)
