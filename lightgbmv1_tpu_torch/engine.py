"""``train`` and ``cv``: the training entry points (reference engine.py:18,
:394).

Port of lightgbmv1_tpu/engine.py ``train`` (:25) with the reference's
callback protocol: before each iteration the ``before_iteration``
callbacks by ``order`` (``reset_parameter``), then the update, then the
evaluation of the valid sets (the training set too when it is one of
them, under its name), then the other callbacks by ``order``
(``log_evaluation``, ``record_evaluation``, ``early_stopping``); an
``EarlyStopException`` sets the booster's ``best_iteration`` and
``best_score`` and ends the loop.  ``early_stopping_rounds`` (or its
aliases in ``params``) with ``first_metric_only``, ``evals_result`` and
``verbose_eval`` add their callbacks, as there; ``feval`` adds its
metrics to every evaluation; ``fobj`` is a custom objective (the
objective becomes ``none``, each update takes ``fobj``'s gradients);
``init_model`` continues a model (text path or Booster: its predictions
seed the scores) or resumes a checkpoint file bit for bit (restored once
the valid sets are attached: their scores are part of it).
``keep_training_booster=False`` returns a prediction-only booster loaded
from the model text.  A block-cache dataset (``Dataset(<dir>)``) and any
dataset under ``stream_enable=true`` train through the out-of-core
row-block trainer (models/gbdt_stream.py): the device holds a block of
``stream_block_rows`` rows and the leaf-sized state, never the (F, N)
bins; at one block the model text is the resident
``tree_growth=leafwise_masked`` one byte for byte.

``cv`` and ``CVBooster`` (:172-286, with ``_make_n_folds`` :189): the
folds drawn with ``np.random.RandomState(seed)`` (stratified by label for
classification), each fold's sets subsets of the full set sharing its
bins, one booster a fold trained in lock step, the metrics' means and
standard deviations a round, early stopping on the first metric's mean,
``fobj`` in every fold's update.

A parallel learner (``tree_learner`` data, voting or feature) trains on
the ``torch.distributed`` group when one is initialized
(``parallel/cluster.init_cluster``, or the caller's
``init_process_group``): every rank calls ``train`` with the same
arguments, each on its rows (a ``Dataset`` of every row, of which the
trainer takes the rank's, or ``Dataset.from_binned`` of
``parallel/dist_data.load_distributed``'s shard), and every rank returns
the same model; with no group it trains as a group of one.

Every booster trains on ``device`` (default: the card).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import os

from . import callback as callback_mod
from .basic import Booster, Dataset
from .device import DeviceLike
from .utils.log import log_fatal

_ROUND_ALIASES = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                  "num_trees", "num_round", "num_rounds", "num_boost_round",
                  "n_estimators")
_STOP_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                 "early_stopping", "n_iter_no_change")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          init_model=None,
          keep_training_booster: bool = True,
          callbacks: Optional[List[Callable]] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None, verbose_eval=False,
          device: DeviceLike = None) -> Booster:
    """Train a model on ``device`` (default: the card) with the callback
    protocol of the JAX ``train`` (reference engine.py:18)."""
    params = dict(params or {})
    # rounds aliases behave like the reference: params win over the kwarg
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in _STOP_ALIASES:
        if alias in params and params[alias] is not None:
            early_stopping_rounds = int(params.pop(alias))
    if fobj is not None:
        params["objective"] = "none"
    # a checkpoint file resumes bit for bit once the valid sets are
    # attached; a model text continues from its predictions
    ckpt = None
    if isinstance(init_model, (str, os.PathLike)):
        from .io.checkpoint import is_checkpoint_file, load_checkpoint

        if is_checkpoint_file(init_model):
            ckpt, init_model = load_checkpoint(str(init_model)), None

    booster = Booster(params=params, train_set=train_set,
                      init_model=init_model, device=device)
    is_valid_contain_train = False
    train_data_name = "training"
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        user_named = valid_names is not None
        valid_names = valid_names or [f"valid_{i}"
                                      for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, valid_names):
            if vs is train_set:
                is_valid_contain_train = True
                if user_named:
                    train_data_name = name
                continue
            # a valid set is binned with the training bins (reference
            # engine.py: valid_set.set_reference(train_set))
            if vs.reference is None and vs._binned is None:
                vs.reference = train_set
            booster.add_valid(vs, name)
    booster._train_data_name = train_data_name
    if ckpt is not None:
        booster.resume_from_checkpoint(ckpt)

    cbs = set(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(
            early_stopping_rounds,
            first_metric_only=bool(params.get("first_metric_only", False))))
    if verbose_eval is True:
        cbs.add(callback_mod.log_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        cbs.add(callback_mod.log_evaluation(verbose_eval))
    if evals_result is not None:
        cbs.add(callback_mod.record_evaluation(evals_result))

    cbs_before = [cb for cb in cbs if getattr(cb, "before_iteration", False)]
    cbs_after = [cb for cb in cbs
                 if not getattr(cb, "before_iteration", False)]
    cbs_before.sort(key=lambda cb: getattr(cb, "order", 0))
    cbs_after.sort(key=lambda cb: getattr(cb, "order", 0))

    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        finished = booster.update(fobj=fobj)

        evaluation_result_list = []
        if (valid_sets is not None or is_valid_contain_train) and cbs_after:
            if is_valid_contain_train:
                evaluation_result_list.extend(
                    [(train_data_name,) + r[1:]
                     for r in booster.eval_train(feval)])
            evaluation_result_list.extend(booster.eval_valid(feval))
            # the metric curves quality_snapshot reads (obs/model.py)
            for ds_name, metric, value, _ in evaluation_result_list:
                booster._metric_history.setdefault(
                    f"{ds_name}:{metric}", []).append(float(value))
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=evaluation_result_list))
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for item in e.best_score:
                booster.best_score.setdefault(item[0], {})[item[1]] = \
                    item[2]
            break
        if finished:
            break
    if not keep_training_booster:
        # a prediction-only booster from the model text (reference
        # engine.py:18, keep_training_booster=False)
        serving = Booster(model_str=booster.model_to_string(),
                          device=booster.device)
        serving.params = dict(booster.params)
        serving.best_iteration = booster.best_iteration
        serving.best_score = booster.best_score
        return serving
    return booster


class CVBooster:
    """Container of per-fold boosters (reference engine.py:280)."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]

        return handler_function


def _make_n_folds(full_data: Dataset, nfold: int, params: Dict,
                  seed: int, stratified: bool, shuffle: bool):
    """(train rows, test rows) of each of ``nfold`` folds, sorted: the
    JAX package's draw from ``np.random.RandomState(seed)`` (JAX :189),
    so its folds row for row."""
    full_data.construct()
    num_data = full_data.num_data()
    rng = np.random.RandomState(seed)
    if stratified:
        labels = full_data.get_label()
        if labels is None:
            log_fatal("Stratified CV requires labels")
        order = np.argsort(labels, kind="mergesort")
        if shuffle:
            # shuffle within label groups for randomized stratification
            labels_sorted = labels[order]
            for v in np.unique(labels_sorted):
                grp = order[labels_sorted == v]
                rng.shuffle(grp)
        folds_idx = [order[i::nfold] for i in range(nfold)]
    else:
        idx = np.arange(num_data)
        if shuffle:
            rng.shuffle(idx)
        folds_idx = np.array_split(idx, nfold)
    for i in range(nfold):
        test_idx = np.asarray(folds_idx[i])
        train_idx = np.concatenate([folds_idx[j] for j in range(nfold)
                                    if j != i])
        yield np.sort(train_idx), np.sort(test_idx)


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 100, folds=None, nfold: int = 5,
       stratified: bool = True, shuffle: bool = True, metrics=None,
       fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
       init_model=None, early_stopping_rounds: Optional[int] = None,
       seed: int = 0, callbacks: Optional[List[Callable]] = None,
       eval_train_metric: bool = False, return_cvbooster: bool = False,
       device: DeviceLike = None) -> Dict[str, List[float]]:
    """K-fold cross-validation on ``device`` (JAX :213, reference
    engine.py:394): ``{"<metric>-mean": [...], "<metric>-stdv": [...]}``
    a round, cut at the best round under early stopping.  As in the JAX
    package, ``init_model``, ``callbacks`` and ``eval_train_metric`` are
    accepted and unused."""
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    obj = params.get("objective", "regression")
    if stratified and (obj not in ("binary", "multiclass", "multiclassova")):
        stratified = False

    if folds is not None:
        fold_iter = list(folds)
    else:
        fold_iter = list(_make_n_folds(train_set, nfold, params, seed,
                                       stratified, shuffle))

    cvbooster = CVBooster()
    for train_idx, test_idx in fold_iter:
        dtrain = train_set.subset(train_idx)   # shares the full set's bins
        dvalid = train_set.subset(test_idx)
        booster = Booster(params=params, train_set=dtrain, device=device)
        booster.add_valid(dvalid, "valid")
        cvbooster._append(booster)

    results = collections.defaultdict(list)
    es_rounds = early_stopping_rounds
    best_mean = None
    best_round = 0
    for i in range(num_boost_round):
        agg = collections.defaultdict(list)
        for booster in cvbooster.boosters:
            booster.update(fobj=fobj)
            for name, metric, value, hb in booster.eval_valid(feval):
                agg[(metric, hb)].append(value)
        for (metric, hb), values in agg.items():
            results[f"{metric}-mean"].append(float(np.mean(values)))
            results[f"{metric}-stdv"].append(float(np.std(values)))
        if es_rounds:
            (metric0, hb0) = next(iter(agg.keys()))
            mean0 = results[f"{metric0}-mean"][-1]
            better = (best_mean is None or
                      (mean0 > best_mean if hb0 else mean0 < best_mean))
            if better:
                best_mean, best_round = mean0, i
            elif i - best_round >= es_rounds:
                cvbooster.best_iteration = best_round + 1
                for k in results:
                    results[k] = results[k][: best_round + 1]
                break
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return dict(results)
