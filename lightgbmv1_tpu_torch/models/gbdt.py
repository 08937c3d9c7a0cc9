"""The GBDT boosting loop (binary, eager PyTorch on the training device).

Port of the core of lightgbmv1_tpu/models/gbdt.py: ``_ScoreUpdater``
(:60) and ``GBDT`` (:76) — ``__init__`` with boost-from-average, the
per-iteration step ``_build_step`` (:356) run eagerly (gradients ->
g3 rows -> one tree -> score updates), ``train_one_iter`` (:765),
``add_valid`` (:633) and ``eval_valid`` (:1223) — plus the lazy host-tree
materialization (:881) the model text is written from.

The JAX step is one jitted dispatch; here it is a Python function whose
ops run on the card (the histogram through the CUDA kernel K1).  Valid
rows are routed through each round's splits by the grower, so a valid
score update is a leaf-value gather, as in the JAX step.  DART, GOSS,
RF, bagging, feature fraction, rollback and checkpoints are not ported
(the config refuses them).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config, unported_reason
from ..io.dataset import BinnedDataset
from ..metrics import Metric, create_metrics
from ..objectives import create_objective
from ..ops.split import SplitParams, make_feature_meta
from ..parallel.trainer import build_trainer, select_bin_layout
from ..utils.log import log_info, log_warning
from .tree import HostTree, TreeArrays, host_tree_from_arrays, leaf_lookup


class _ScoreUpdater:
    """Cached raw scores of one dataset (reference score_updater.hpp),
    (num_data, num_class) f32 on the training device."""

    def __init__(self, num_data: int, num_class: int, init: np.ndarray,
                 device):
        self.score = torch.as_tensor(
            np.broadcast_to(init, (num_data, num_class)).astype(np.float32),
            device=device).contiguous()


class GBDT:
    """Gradient Boosting Decision Tree trainer (reference class GBDT,
    gbdt.h:34), training on ``device``."""

    def __init__(self, config: Config, train_set: BinnedDataset,
                 device: torch.device):
        why = unported_reason(config)
        if why:
            raise NotImplementedError(why)
        self.config = config
        self.device = torch.device(device)
        self.train_set = train_set
        self.num_data = train_set.num_data
        self.num_class = config.num_tree_per_iteration
        self.objective = create_objective(config)
        self.objective.init(train_set.metadata, self.num_data, self.device)

        select_bin_layout(config, num_total_bin=train_set.num_total_bin,
                          device=self.device)
        self.binned = torch.as_tensor(train_set.train_matrix,
                                      device=self.device).contiguous()
        self.meta = make_feature_meta(train_set, self.device)
        self.num_bins = train_set.padded_bin
        self.split_params = SplitParams(
            lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
            min_data_in_leaf=float(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
            min_gain_to_split=config.min_gain_to_split)
        self._grow = build_trainer(config, self.meta, self.split_params,
                                   self.num_bins, self.device,
                                   bin_dtype=self.binned.dtype)
        # the per-tree feature mask at feature_fraction 1: usable features
        self._base_mask = self.meta.usable

        # initial scores (reference BoostFromAverage gbdt.cpp:312-335)
        self._init_scores = np.zeros(self.num_class, dtype=np.float64)
        meta_init = train_set.metadata.init_score
        if meta_init is not None:
            init = np.asarray(meta_init, np.float64).reshape(
                self.num_data, -1)
            base = np.zeros((self.num_data, self.num_class))
            base[:, :init.shape[1]] = init
            self._train_scores = _ScoreUpdater(self.num_data, self.num_class,
                                               base, self.device)
            self._used_init_score = True
        else:
            for k in range(self.num_class):
                self._init_scores[k] = self.objective.boost_from_score(k)
            if any(self._init_scores):
                log_info("Start training from score " + " ".join(
                    f"{s:.6f}" for s in self._init_scores))
            self._train_scores = _ScoreUpdater(
                self.num_data, self.num_class, self._init_scores[None, :],
                self.device)
            self._used_init_score = False

        self.models: List[Optional[HostTree]] = []   # iter-major
        self._device_trees: List[TreeArrays] = []
        self._model_shrink: List[float] = []
        self._model_bias: List[float] = []
        self.iter = 0
        self._valid_sets: List[BinnedDataset] = []
        self._valid_names: List[str] = []
        self._valid_binned: List[torch.Tensor] = []
        self._valid_scores: List[_ScoreUpdater] = []
        self._valid_metrics: List[List[Metric]] = []

    # ------------------------------------------------------------------
    def add_valid(self, valid_set: BinnedDataset, name: str) -> None:
        if self.iter > 0:
            raise RuntimeError("Cannot add validation data after training "
                               "started")
        metrics = create_metrics(self.config)
        for m in metrics:
            m.init(valid_set.metadata, valid_set.num_data)
        if valid_set.metadata.init_score is not None:
            init = np.asarray(valid_set.metadata.init_score,
                              np.float64).reshape(valid_set.num_data, -1)
        else:
            init = self._init_scores[None, :]
        self._valid_sets.append(valid_set)
        self._valid_names.append(name)
        self._valid_binned.append(torch.as_tensor(
            valid_set.train_matrix, device=self.device).contiguous())
        self._valid_scores.append(_ScoreUpdater(
            valid_set.num_data, self.num_class, init, self.device))
        self._valid_metrics.append(metrics)

    # ------------------------------------------------------------------
    def _step(self) -> List[TreeArrays]:
        """One iteration: gradients, then per class one tree and its
        score updates (the JAX ``_build_step`` body, run eagerly)."""
        K = self.num_class
        rate = self.config.learning_rate
        score = self._train_scores.score
        grad, hess = self.objective.get_gradients(
            score[:, 0] if K == 1 else score)
        if grad.ndim == 1:
            grad, hess = grad[:, None], hess[:, None]
        trees, train_preds = [], []
        valid_preds = [[] for _ in self._valid_binned]
        for k in range(K):
            g3 = torch.stack([grad[:, k], hess[:, k],
                              torch.ones_like(grad[:, k])], dim=1)
            tree, leaf_id, _, vlids = self._grow(
                self.binned, g3.contiguous(), self._base_mask,
                valids=self._valid_binned)
            shrunk = tree._replace(leaf_value=tree.leaf_value * rate)
            train_preds.append(leaf_lookup(shrunk.leaf_value, leaf_id))
            for vi, vl in enumerate(vlids):
                valid_preds[vi].append(shrunk.leaf_value[vl.long()])
            trees.append(shrunk)
        # one (N, K) add per score cache: this iteration's gradients were
        # taken before the class loop, so deferring is exact
        self._train_scores.score = score + torch.stack(train_preds, dim=1)
        for vs, vp in zip(self._valid_scores, valid_preds):
            vs.score = vs.score + torch.stack(vp, dim=1)
        return trees

    def train_one_iter(self, check_stop: bool = True) -> bool:
        """One boosting iteration (num_class trees); True when no tree
        could split (reference returns the stop signal when the best gain
        is non-positive)."""
        trees = self._step()
        for k, tree in enumerate(trees):
            self._device_trees.append(tree)
            self.models.append(None)
            self._model_shrink.append(self.config.learning_rate)
            self._model_bias.append(self._tree_bias(k))
        self.iter += 1
        if check_stop:
            stopped = all(int(t.num_leaves) <= 1 for t in trees)
            if stopped:
                log_warning("Stopped training because there are no more "
                            "leaves that meet the split requirements")
            return stopped
        return False

    def _tree_bias(self, k: int) -> float:
        """The init score goes into the first tree of each class
        (gbdt.cpp:381)."""
        if self.iter == 0 and not self._used_init_score:
            return float(self._init_scores[k])
        return 0.0

    # ------------------------------------------------------------------
    def materialize_host_trees(self) -> List[HostTree]:
        """Host copies of the trees not yet fetched: real thresholds from
        the bin mappers and the boost-from-average bias folded in."""
        mappers = self.train_set.bin_mappers
        for i, m in enumerate(self.models):
            if m is not None:
                continue
            ht = host_tree_from_arrays(self._device_trees[i],
                                       shrinkage=self._model_shrink[i])
            for n in range(ht.num_leaves - 1):
                ht.threshold[n] = mappers[ht.split_feature[n]] \
                    .bin_to_threshold(ht.threshold_bin[n])
            ht.add_bias(self._model_bias[i])
            self.models[i] = ht
        return self.models

    # ------------------------------------------------------------------
    def _eval(self, dataset_name, scores: _ScoreUpdater, metrics, out):
        raw = scores.score.detach().cpu().numpy().astype(np.float64)
        pred = self.objective.convert_output(
            raw[:, 0] if self.num_class == 1 else raw)
        for m in metrics:
            for name, value, hb in m.eval(np.asarray(pred, np.float64)):
                out.append((dataset_name, name, value, hb))

    def eval_valid(self):
        out = []
        for name, vs, metrics in zip(self._valid_names, self._valid_scores,
                                     self._valid_metrics):
            self._eval(name, vs, metrics, out)
        return out
