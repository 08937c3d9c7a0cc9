"""The GBDT boosting loop (eager PyTorch on the training device).

Port of the core of lightgbmv1_tpu/models/gbdt.py: ``_ScoreUpdater``
(:60) and ``GBDT`` (:76) — ``__init__`` with each class's boost-from-
average score, the per-iteration step ``_build_step`` (:356) run eagerly
(gradients of the whole (N,) or (N, K) score -> per class g3 rows -> one
tree -> score updates), ``train_one_iter`` (:765), ``add_valid`` (:633)
and ``eval_valid`` (:1223), on the (N, K) scores the objective converts
(softmax for multiclass) — plus the lazy host-tree materialization
(:881) the model text is written from.

The JAX step is one jitted dispatch; here it is a Python function whose
ops run on the card (the histogram through the CUDA kernel K1).  The wave
grower routes the valid rows through each round's splits, so a valid
score update is a leaf-value gather, as in the JAX step; the sequential
and level-wise growers' valid sets walk each tree on their bins
(``tree_predict_binned``, JAX :405).  Each tree's key is the JAX
package's ``fold_in(PRNGKey(seed), iteration * num_class + k)`` (JAX
:257, :378; utils/prng.py), which the wave grower folds into the int8sr
rounds' rounding keys and every grower into its per-node feature masks.
Where ``select_bin_layout`` picks ``packed4`` the training matrix is
packed once (``pack4bit``, JAX :143-153) and every valid matrix with it
(:674-678).

Sampling draws the JAX package's streams, so the same seeds train the
same trees:

* bagging (``_bagging_mask``, JAX :699-724, and the step's traced twin
  :332-355): every ``bagging_freq`` iterations a Bernoulli row mask,
  ``bernoulli(fold_in(PRNGKey(bagging_seed), iteration //
  bagging_freq), bagging_fraction, (N,))``; binary with
  ``pos_bagging_fraction`` / ``neg_bagging_fraction`` < 1 draws the
  positives from that key and the negatives from ``fold_in(key, 1)``.
  An out-of-bag row's gradient and hessian are zeroed and its count is
  0 (``_sample_g3``, :752-761), so ``min_data_in_leaf`` counts in-bag
  rows;
* the per-tree feature mask (``_tree_feature_mask``, :684-697):
  ``ceil(feature_fraction * n)`` of the n usable features, drawn without
  replacement by ``numpy.random.RandomState(feature_fraction_seed)
  .choice``, one draw a class tree in class order, as the JAX step draws
  them before its class loop (:602-604).  It is the tree's
  ``base_mask``, and ``feature_fraction_bynode`` samples from it per
  node in the growers.

DART, GOSS, RF, extra_trees, rollback and checkpoints are not ported
(the config refuses them).
"""

from __future__ import annotations

from typing import List, Optional

import math

import numpy as np
import torch

from ..config import Config, unported_reason
from ..io.dataset import BinnedDataset
from ..metrics import Metric, create_metrics
from ..objectives import create_objective
from ..ops.hist_cuda import pack4bit
from ..ops.split import SplitParams, make_feature_meta
from ..parallel.trainer import build_trainer, select_bin_layout
from ..utils.log import log_info, log_warning
from ..utils.prng import bernoulli, fold_in, prng_key
from .tree import (HostTree, TreeArrays, host_tree_from_arrays, leaf_lookup,
                   tree_predict_binned)


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

        binned = torch.as_tensor(train_set.train_matrix,
                                 device=self.device).contiguous()
        self._packed = select_bin_layout(
            config, num_total_bin=train_set.num_total_bin,
            device=self.device, bin_dtype=binned.dtype) == "packed4"
        self.binned = pack4bit(binned) if self._packed else binned
        self.meta = make_feature_meta(train_set, self.device,
                                      config.monotone_constraints,
                                      config.feature_contri)
        self.num_bins = train_set.padded_bin
        self.split_params = SplitParams(
            lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
            min_data_in_leaf=float(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
            min_gain_to_split=config.min_gain_to_split,
            max_delta_step=float(config.max_delta_step),
            path_smooth=float(config.path_smooth),
            monotone_penalty=float(config.monotone_penalty))
        self._grow = build_trainer(config, self.meta, self.split_params,
                                   self.num_bins, self.device,
                                   bin_dtype=self.binned.dtype,
                                   num_data=self.num_data,
                                   packed=self._packed)
        # the per-tree feature mask at feature_fraction 1: usable features
        self._base_mask = self.meta.usable
        self._rng_key = prng_key(config.seed)
        # sampling: the per-tree feature stream and the kept bag
        self._feat_rng = np.random.RandomState(config.feature_fraction_seed)
        self._usable_h = self.meta.usable.cpu().numpy()
        self._bag_mask: Optional[torch.Tensor] = None

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
        vb = torch.as_tensor(valid_set.train_matrix,
                             device=self.device).contiguous()
        self._valid_binned.append(pack4bit(vb) if self._packed else vb)
        self._valid_scores.append(_ScoreUpdater(
            valid_set.num_data, self.num_class, init, self.device))
        self._valid_metrics.append(metrics)

    # ------------------------------------------------------------------
    def _tree_feature_mask(self) -> torch.Tensor:
        """The tree's (F,) feature mask (JAX ``_tree_feature_mask``):
        the usable features, or at ``feature_fraction < 1`` a draw of
        ``ceil(fraction * n)`` of them from the per-tree stream."""
        frac = self.config.feature_fraction
        if frac >= 1.0:
            return self._base_mask
        idx = np.flatnonzero(self._usable_h)
        k = max(1, int(math.ceil(frac * len(idx))))
        chosen = self._feat_rng.choice(idx, size=k, replace=False)
        mask = np.zeros_like(self._usable_h)
        mask[chosen] = True
        return torch.as_tensor(mask, device=self.device)

    def _bagging_mask(self, iteration: int) -> Optional[torch.Tensor]:
        """(N,) f32 in-bag mask of ``iteration``, or None without bagging
        (JAX ``_bagging_mask``): a new draw at every ``bagging_freq``
        boundary, kept between them."""
        cfg = self.config
        use_pos_neg = cfg.objective == "binary" and (
            cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0)
        if cfg.bagging_freq <= 0 or (cfg.bagging_fraction >= 1.0
                                     and not use_pos_neg):
            return None
        if self._bag_mask is not None and iteration % cfg.bagging_freq != 0:
            return self._bag_mask
        key = fold_in(prng_key(cfg.bagging_seed),
                      iteration // max(cfg.bagging_freq, 1))
        N, dev = self.num_data, self.device
        if use_pos_neg:
            pos = bernoulli(key, cfg.pos_bagging_fraction, N, dev)
            neg = bernoulli(fold_in(key, 1), cfg.neg_bagging_fraction, N,
                            dev)
            mask = torch.where(self.objective.label > 0, pos, neg)
        else:
            mask = bernoulli(key, cfg.bagging_fraction, N, dev)
        self._bag_mask = mask.to(torch.float32)
        return self._bag_mask

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
        bag = self._bagging_mask(self.iter)
        # the class trees' feature masks, drawn before the class loop
        masks = [self._tree_feature_mask() for _ in range(K)]
        trees, train_preds = [], []
        valid_preds = [[] for _ in self._valid_binned]
        for k in range(K):
            if bag is None:
                g3 = torch.stack([grad[:, k], hess[:, k],
                                  torch.ones_like(grad[:, k])], dim=1)
            else:
                g3 = torch.stack([grad[:, k] * bag, hess[:, k] * bag, bag],
                                 dim=1)
            key = fold_in(self._rng_key, self.iter * K + k)
            if getattr(self._grow, "routes_valids", False):
                tree, leaf_id, _, vlids = self._grow(
                    self.binned, g3.contiguous(), masks[k],
                    valids=self._valid_binned, key=key)
            else:
                tree, leaf_id, _ = self._grow(self.binned, g3.contiguous(),
                                              masks[k], key=key)
                vlids = None
            shrunk = tree._replace(leaf_value=tree.leaf_value * rate)
            train_preds.append(leaf_lookup(shrunk.leaf_value, leaf_id))
            for vi, vb in enumerate(self._valid_binned):
                valid_preds[vi].append(
                    shrunk.leaf_value[vlids[vi].long()] if vlids is not None
                    else tree_predict_binned(shrunk, vb, self.meta.nan_bin,
                                             self.meta.missing_type,
                                             self.meta.zero_bin,
                                             self._packed))
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
