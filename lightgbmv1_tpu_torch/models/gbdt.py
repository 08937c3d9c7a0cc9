"""The boosting loops (eager PyTorch on the training device).

Port of lightgbmv1_tpu/models/gbdt.py: ``_ScoreUpdater`` (:60) and
``GBDT`` (:76) — ``__init__`` with each class's boost-from-average
score, the per-iteration step ``_build_step`` (:356) run eagerly
(gradients of the whole (N,) or (N, K) score -> per class g3 rows
(``_sample_g3``, :751) -> one tree -> leaf renewal -> shrinkage -> score
updates, ``_finish_tree`` :783), ``train_one_iter`` (:765),
``add_valid`` (:633) and ``eval_valid`` (:1223), on the (N, K) scores
the objective converts (softmax for multiclass; a ``wants_raw`` metric
reads the raw scores) — plus the lazy host-tree materialization (:881)
the model text is written from; and the boosting variants of
``create_boosting`` (:1885): ``GOSS`` (:1252), ``DART`` (:1284) and
``RF`` (:1789).

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

extra_trees reaches the growers through the split params
(``extra_trees``, ``extra_seed``) and each tree's key.
``reset_config`` (``Booster.reset_parameter``) changes knobs between
iterations: the learning rate is read each iteration, any other knob
rebuilds the grower.  The JAX package's jitted step keeps the learning
rate it was built with (its ``_model_shrink`` and the model text's
``shrinkage`` record the new one, its leaves the old); here the next
tree is shrunk by the new rate, as in the reference.

The objectives that renew their leaves (L1, quantile, mape:
``renew_percentile``) set each grown tree's leaves to that weighted
quantile of the residuals ``label - score`` (float64) of its rows
(``_renew_leaf_values``, JAX :919-945), then shrink it, as the JAX
package's host path does (:821-879): one sort by (leaf, residual) on the
training device gives each leaf's rows in order, its cumulative weights
summed on the host, and a tie of residuals cannot move the value (the
cumulative weight at either end of a run of equal residuals does not
depend on their order).

The variants, as the JAX package runs them:

* GOSS keeps the rows whose |g h| reaches the ``top_rate`` threshold (a
  ``>=`` threshold, so ties keep more), draws the rest at ``other_k /
  (n - top_k)`` (an f32 quotient) from ``fold_in(PRNGKey(seed + 17),
  iteration)`` and weighs them by ``(1 - top_rate) / other_rate``, the
  count channel 0/1, the bag last (JAX :1258-1281); from iteration 0,
  where LightGBM waits ``1 / learning_rate`` iterations;
* DART's step (JAX :1508-1641, the fused and host variants in one eager
  path): the drops drawn by ``_select_drops`` from
  ``RandomState(drop_seed)`` (one ``rand()`` for ``skip_drop``, then one
  a tree up to ``max_drop``; weighted by ``_tree_weight`` unless
  ``uniform_drop``), their bias-carrying trees removed from every score
  cache, the new trees grown on the rest and shrunk by ``shrink_new``,
  the dropped trees rescaled by ``old_factor`` (device leaves, shrinkage
  and bias; a host tree already materialized too) and put back
  (``_normalization``, ``xgboost_dart_mode``).  A removal gathers each
  dropped tree's leaf values through the leaf ids recorded at its
  iteration — the training rows' and, where the wave grower routed them
  (K3), the valid rows' — under a 1 GB budget in u8 / u16 / i32 (:1296-
  1322); past it, or for a grower that routes no valid rows, the tree is
  walked on the bins (``tree_predict_binned``: the same leaf ids);
* RF trains unshrunk trees on the gradients at the constant init score,
  each tree carrying the init score as its bias; the score caches hold
  the running sum, and evaluation reads ``init + (score - init) /
  iterations`` (JAX :1789-1882).  It needs bagging and refuses init
  scores, as there.

The model lifecycle (JAX :445-519, :947-1166):

* ``init_raw_scores`` (continued training): the loaded model's raw
  predictions seed the training score cache (``Booster(init_model=)``);
* ``rollback_one_iter`` restores the scores and the tree lists saved
  before the last iteration (JAX :959-972; DART also its dropped trees'
  values and its tree weights, ``_snapshot_dropped`` :1412, :1761);
* ``capture_state`` / ``restore_state`` (JAX :1004-1166) hold everything a
  resumed trainer needs to write the uninterrupted run's model text: the
  trees' arrays, the f32 score caches, the eager host trees' float64
  values, the per-tree shrinkage and bias, the feature-sampling
  ``RandomState`` and DART's drop ``RandomState``, tree weights and
  recorded leaf ids.  The per-iteration streams (bagging, GOSS,
  extra_trees, the tree keys: utils/prng.py) are keyed on the iteration
  and need no state;
* ``finite_guard``: ``clamp`` zeroes the non-finite gradients and
  hessians of the objective's pass (a poisoned row weighs nothing);
  ``warn`` / ``raise`` check at each iteration boundary, with one scalar
  read, that the training scores and the last iteration's gradient pass
  (re-run on the scores it started from) are finite
  (``check_finite_boundary``); ``off`` reads nothing.

A custom objective (``objective=none`` under ``fobj``) hands each
iteration its (N, K) gradients and hessians (``train_one_iter(
custom_grad=, custom_hess=)``), which the trainer moves to the device.

EFB (JAX :107-127, :652-674): where the training set bundled, the trainer
uploads the bundle columns and its ``BundleArrays``; the growers take the
histograms over them at ``padded_bundle_bin`` bins and decode each
decision (parallel/trainer.py), a valid set is bundled with the training
layout, and DART's tree walks decode the same way.

Row shards (the data and voting learners over a group of more than one
rank, or a process-sharded set; JAX :110-162, where a device mesh holds
the row shards): each rank keeps the bins, gradients, leaf ids and scores
of its own rows (``RowShard``).  What is global is reduced over the
group, so every rank writes the same model text: the objective's
statistics and the boost-from-average score come from an objective
initialised on the global rows, whose per-row tensors each rank slices
(``gbdt_stream._ObjectiveSlicer``; a ranking objective on its whole
queries); the root sums are all-reduced in the grower; the bagging and
GOSS draws are made over the global rows from the shared seeds, each rank
taking its slice (GOSS's threshold over the gathered |g h|); renewed
leaves, training metrics and ``raw_train_scores`` gather the rows; the
finite guard all-reduces its check.  Valid sets are every rank's whole.
A row-sharded trainer's checkpoints are item 14.3's (elastic training).
For voting and feature learners EFB is off, with the JAX warning (JAX
:113-122).

The phase timer's scopes (utils/timer.global_timer, the JAX package's
names): ``GBDT::TrainOneIter(dispatch)`` (``DART::`` for DART) around an
iteration's tree growth, ``GBDT::MaterializeHostTrees``,
``GBDT::EvalTrain`` and ``GBDT::EvalValid``; host wall time, no device
synchronization added.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import (CAT_INT16, PARALLEL, Config, not_ported,
                      unported_reason)
from ..io.bundle import BundleArrays, apply_bundles_dense
from ..io.dataset import BinnedDataset, Metadata
from ..io.parser import shard_rows
from ..metrics import Metric, create_metrics
from ..objectives import create_objective
from ..ops.hist_cuda import pack4bit
from ..ops.split import SplitParams, make_feature_meta
from ..parallel.collectives import Group, current_group
from ..parallel.trainer import (PARALLEL_LEARNERS, ROW_SHARDED,
                                build_trainer, select_bin_layout)
from ..obs import trace as obs_trace
from ..utils import faults
from ..utils.log import log_fatal, log_info, log_warning
from ..utils.prng import bernoulli, fold_in, prng_key
from ..utils.timer import global_timer
from .tree import (HostTree, TreeArrays, host_tree_from_arrays,
                   leaf_lookup, leaf_path_features, tree_predict_binned,
                   tree_used_features)


class FiniteGuardError(RuntimeError):
    """``finite_guard=raise`` found a non-finite score or gradient at an
    iteration boundary (JAX :44)."""


def _np_weighted_quantile_sorted(v, w, q):
    """The first value of the sorted ``v`` whose cumulative float64 weight
    reaches ``q`` of the total (JAX gbdt.py:52)."""
    cw = np.cumsum(w)
    if cw[-1] <= 0:
        return 0.0
    idx = int(np.searchsorted(cw, q * cw[-1], side="left"))
    return float(v[min(idx, len(v) - 1)])


class _Grown(NamedTuple):
    """One iteration's class trees, shrunk, and what they add: the
    (N, K) training and each valid set's (N_v, K) score deltas, each
    tree's training leaf ids and (where the grower routes them) valid
    leaf ids, and the host trees of renewed leaves (else None)."""
    trees: List[TreeArrays]
    hosts: List[Optional[HostTree]]
    train_delta: torch.Tensor
    valid_deltas: List[torch.Tensor]
    leaf_ids: List[torch.Tensor]
    valid_lids: Optional[List[List[torch.Tensor]]]


class _ScoreUpdater:
    """Cached raw scores of one dataset (reference score_updater.hpp),
    (num_data, num_class) f32 on the training device."""

    def __init__(self, num_data: int, num_class: int, init: np.ndarray,
                 device):
        self.score = torch.as_tensor(
            np.broadcast_to(init, (num_data, num_class)).astype(np.float32),
            device=device).contiguous()


def _metadata_rows(meta: Metadata, lo: int, hi: int,
                   keep: Optional[np.ndarray] = None) -> Metadata:
    """Rows ``[lo, hi)`` of ``meta`` (or, with ``keep``, the rows
    ``keep``): labels, weights, init scores and, for a range that starts
    and ends on query boundaries, its queries."""
    def rows(a, cols=False):
        if a is None:
            return None
        a = np.asarray(a)
        if cols:
            a = a.reshape(len(meta.label), -1)
        return a[keep] if keep is not None else a[lo:hi]

    out = Metadata(label=rows(meta.label), weight=rows(meta.weight),
                   init_score=rows(meta.init_score, cols=True))
    if meta.query_boundaries is not None and keep is None:
        qb = np.asarray(meta.query_boundaries)
        q0, q1 = np.searchsorted(qb, [lo, hi])
        out.set_group(np.diff(qb[q0:q1 + 1]))
    return out


class RowShard:
    """This rank's rows under a row-sharded learner (``tree_learner`` data
    or voting; JAX gbdt.py:110-162, where the device mesh holds the row
    shards): the global view of the set (``gmeta``, the real rows of every
    rank in rank order, ``n_global`` of them) and this rank's ``[lo,
    hi)`` of it.  The cut is the JAX learner's (JAX trainer.py:1003):
    ceil(N / D) contiguous rows a rank; query data is cut at the query
    boundary at or after each even cut, so every query stays on one rank.
    A process-sharded set (``parallel/dist_data.make_process_sharded``)
    holds this rank's rows already, padded to a common count: its real
    rows are the leading ``row_valid`` ones."""

    def __init__(self, train_set: BinnedDataset, group: Group):
        self.group = group
        rank, world = group.rank, group.world
        meta = train_set.metadata
        if getattr(train_set, "is_row_sharded", False):
            R = int(train_set.local_rows)
            valid = np.asarray(train_set.row_valid, bool)
            self.counts = [int(c) for c in valid.reshape(world, R).sum(1)]
            self.gmeta = _metadata_rows(meta, 0, 0, np.flatnonzero(valid))
            self.lo = sum(self.counts[:rank])
            self.cols = slice(0, self.counts[rank])
        else:
            N = train_set.num_data
            cuts = [shard_rows(N, r, world)[0] for r in range(world)] + [N]
            if meta.query_boundaries is not None:
                qb = np.asarray(meta.query_boundaries)
                cuts = [int(qb[np.searchsorted(qb, c)]) for c in cuts]
            self.counts = [cuts[r + 1] - cuts[r] for r in range(world)]
            self.gmeta = meta
            self.lo = cuts[rank]
            self.cols = slice(cuts[rank], cuts[rank + 1])
        self.n = self.counts[rank]
        self.hi = self.lo + self.n
        self.n_global = sum(self.counts)
        # the slot-bucket ladder's rows: the JAX shard's, ceil(N / D)
        self.bucket_rows = -(-self.n_global // world)
        self.local_meta = _metadata_rows(self.gmeta, self.lo, self.hi)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's (n_r, ...) rows of ``t`` in rank order: the
        (n_global, ...) global rows, on every rank."""
        pad = max(self.counts) - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        allt = self.group.all_gather(t.contiguous())
        return torch.cat([allt[r, :c] for r, c in enumerate(self.counts)])


def row_shard_for(config: Config, train_set: BinnedDataset
                  ) -> Tuple[Group, Optional[RowShard]]:
    """The learner's group and, for a row-sharded learner over more than
    one rank (or a process-sharded set), this rank's ``RowShard``."""
    if config.tree_learner not in PARALLEL_LEARNERS:
        if getattr(train_set, "is_row_sharded", False):
            log_fatal("process-sharded datasets require tree_learner=data "
                      "or voting")
        return Group.solo(), None
    group = current_group()
    sharded = getattr(train_set, "is_row_sharded", False)
    if sharded and config.tree_learner not in ROW_SHARDED:
        log_fatal("process-sharded datasets require tree_learner=data or "
                  "voting (tree_learner=feature holds every row on every "
                  "rank)")
    if config.tree_learner in ROW_SHARDED and (group.world > 1 or sharded):
        return group, RowShard(train_set, group)
    return group, None


class GBDT:
    """Gradient Boosting Decision Tree trainer (reference class GBDT,
    gbdt.h:34), training on ``device``."""

    # the out-of-core row-block trainer (models/gbdt_stream.py) sets it
    # (JAX :79-81): the bins never go to the device whole, and the per-row
    # state (scores, gradients, leaf ids, the bag) lives on the host
    _is_streaming = False

    def __init__(self, config: Config, train_set: BinnedDataset,
                 device: torch.device,
                 init_raw_scores: Optional[np.ndarray] = None):
        why = unported_reason(config)
        if why:
            raise NotImplementedError(why)
        self.config = config
        self.device = torch.device(device)
        # where the (N, ...) per-row state lives
        self._row_device = (torch.device("cpu") if self._is_streaming
                            else self.device)
        self.train_set = train_set
        # a row-sharded learner's rank holds its rows only (``RowShard``)
        self._group, self._shard = (
            (Group.solo(), None) if self._is_streaming
            else row_shard_for(config, train_set))
        shard = self._shard
        self.num_data = train_set.num_data if shard is None else shard.n
        self.num_class = config.num_tree_per_iteration
        self.objective = create_objective(config)
        self._objective_global = self.objective
        if self.objective is not None:
            if shard is None:
                self.objective.init(train_set.metadata, self.num_data,
                                    self._row_device)
            elif shard.gmeta.query_boundaries is not None:
                # a ranking objective's statistics are its queries', whole
                # on each rank
                self.objective.init(shard.local_meta, shard.n,
                                    self._row_device)
            else:
                # the global statistics (class weights, the average a
                # boost starts from) over every rank's rows, the per-row
                # tensors this rank's rows of them
                from .gbdt_stream import _ObjectiveSlicer

                self.objective.init(shard.gmeta, shard.n_global,
                                    self._row_device)
                self.objective = _ObjectiveSlicer(
                    self.objective, shard.n_global,
                    self._row_device).sliced(shard.lo, shard.hi)
        if (train_set.is_categorical.any() and train_set.padded_bin > 256):
            raise not_ported("categorical features beside more than 256 "
                             "bins a feature (int16 bins)", CAT_INT16)
        # EFB: the trees speak original features, the histograms and the
        # decisions read the bundle columns (JAX :107-127); forced splits
        # run on unbundled features
        self._bundle = None
        if train_set.bundle_layout is not None and (
                config.tree_learner in ("voting", "feature")
                or config.forcedsplits_filename):
            if train_set.binned is None:
                log_fatal("tree_learner=voting/feature and forced splits do "
                          "not support EFB-bundled sparse datasets; load "
                          "dense data or drop the incompatible option")
            log_warning("EFB disabled (tree_learner=voting/feature and "
                        "forced splits run on unbundled features)")
            train_set.bundled = None
            train_set.bundle_layout = None
        # the streamed blocks are the plain bins (JAX :110)
        if train_set.bundle_layout is not None and not self._is_streaming:
            self._bundle = BundleArrays(train_set.bundle_layout,
                                        train_set.zero_bins,
                                        train_set.num_bins, self.device)

        if self._is_streaming:
            # the blocks stream per pass in their stored layout (JAX
            # :135-154); valid sets are packed to match a packed cache
            self.binned = None
            self._packed = self._source.bin_layout == "packed4"
        else:
            matrix = train_set.train_matrix
            if shard is not None:
                matrix = matrix[:, shard.cols]
            binned = torch.as_tensor(matrix, device=self.device).contiguous()
            self._packed = select_bin_layout(
                config, num_total_bin=train_set.num_total_bin,
                device=self.device, bin_dtype=binned.dtype,
                bundled=self._bundle is not None) == "packed4"
            self.binned = pack4bit(binned) if self._packed else binned
        self.meta = make_feature_meta(train_set, self.device,
                                      config.monotone_constraints,
                                      config.feature_contri)
        self.num_bins = train_set.padded_bin
        self._build_grower()
        # the per-tree feature mask at feature_fraction 1: usable features
        self._base_mask = self.meta.usable
        self._rng_key = prng_key(config.seed)
        # sampling: the per-tree feature stream and the kept bag
        self._feat_rng = np.random.RandomState(config.feature_fraction_seed)
        self._usable_h = self.meta.usable.cpu().numpy()
        self._bag_mask: Optional[torch.Tensor] = None
        # CEGB (JAX :241-256): the model's used features and, with lazy
        # costs on the sequential grower, the (N, F) rows already charged,
        # both carried across trees
        F = train_set.num_features
        self._cegb_lazy_active = (bool(config.cegb_penalty_feature_lazy)
                                  and config.tree_growth != "levelwise")
        self._cegb_enabled = (config.cegb_penalty_split > 0
                              or bool(config.cegb_penalty_feature_coupled)
                              or self._cegb_lazy_active)
        self._cegb_used = torch.zeros(F, dtype=torch.bool,
                                      device=self.device)
        self._cegb_marks = (torch.zeros((self.num_data, F), dtype=torch.bool,
                                        device=self.device)
                            if self._cegb_lazy_active else None)

        # initial scores (reference BoostFromAverage gbdt.cpp:312-335)
        self._init_scores = np.zeros(self.num_class, dtype=np.float64)
        meta_init = (train_set.metadata if shard is None
                     else shard.local_meta).init_score
        if init_raw_scores is not None and shard is not None:
            raw = np.asarray(init_raw_scores, np.float64).reshape(
                -1, self.num_class)
            if raw.shape[0] == shard.n_global:
                init_raw_scores = raw[shard.lo:shard.hi]
        if init_raw_scores is not None:
            # continued training: the loaded model's raw predictions
            self._train_scores = _ScoreUpdater(
                self.num_data, self.num_class,
                np.asarray(init_raw_scores, np.float64).reshape(
                    self.num_data, self.num_class), self._row_device)
            self._used_init_score = True
        elif meta_init is not None:
            init = np.asarray(meta_init, np.float64).reshape(
                self.num_data, -1)
            base = np.zeros((self.num_data, self.num_class))
            base[:, :init.shape[1]] = init
            self._train_scores = _ScoreUpdater(self.num_data, self.num_class,
                                               base, self._row_device)
            self._used_init_score = True
        else:
            for k in range(self.num_class if self.objective is not None
                           else 0):
                self._init_scores[k] = \
                    self._objective_global.boost_from_score(k)
            if any(self._init_scores):
                log_info("Start training from score " + " ".join(
                    f"{s:.6f}" for s in self._init_scores))
            self._train_scores = _ScoreUpdater(
                self.num_data, self.num_class, self._init_scores[None, :],
                self._row_device)
            self._used_init_score = False

        self.models: List[Optional[HostTree]] = []   # iter-major
        self._device_trees: List[TreeArrays] = []
        self._model_shrink: List[float] = []
        self._model_bias: List[float] = []
        self.iter = 0
        # the scores and tree count before the last iteration (rollback,
        # the finite guard's second detector)
        self._prev_state = None
        self._finite_warned = False
        # an armed grad_poison fault (utils/faults.py), read once here as
        # the JAX trainer reads it at trace time
        self._poison_iter = faults.grad_poison_iteration()
        self._valid_sets: List[BinnedDataset] = []
        self._valid_names: List[str] = []
        self._valid_binned: List[torch.Tensor] = []
        self._valid_scores: List[_ScoreUpdater] = []
        self._valid_metrics: List[List[Metric]] = []
        self._train_metrics: Optional[List[Metric]] = None

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, v: int) -> None:
        # every change of the ensemble (a tree appended, a rollback, DART's
        # rescale of earlier trees) moves the iteration: the version keys
        # the Booster's predictor cache (JAX :283-296)
        self._iter = v
        self.model_version = getattr(self, "model_version", -1) + 1

    def _build_grower(self) -> None:
        """The split params and the grower of the current config; the
        histogram method a bench picked stays picked."""
        config = self.config
        self.split_params = self._make_split_params()
        picked = getattr(getattr(self, "_grow", None), "hist_method", None)
        if config.hist_method == "bench" and picked is not None:
            config = dataclasses.replace(config, hist_method=picked)
        self._grow = build_trainer(
            config, self.meta, self.split_params, self.num_bins, self.device,
            bin_dtype=self.binned.dtype, num_data=self.num_data,
            packed=self._packed, binned=self.binned, bundle=self._bundle,
            bundle_num_bins=(self.train_set.padded_bundle_bin
                             if self._bundle is not None else None),
            bin_mappers=self.train_set.bin_mappers,
            group=(self._group if config.tree_learner in PARALLEL_LEARNERS
                   else None),
            bucket_rows=(self._shard.bucket_rows
                         if self._shard is not None else None))

    def _make_split_params(self) -> SplitParams:
        config = self.config
        return SplitParams(
            lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
            min_data_in_leaf=float(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
            min_gain_to_split=config.min_gain_to_split,
            max_delta_step=float(config.max_delta_step),
            path_smooth=float(config.path_smooth),
            monotone_penalty=float(config.monotone_penalty),
            extra_trees=bool(config.extra_trees),
            extra_seed=int(config.extra_seed),
            cat_l2=float(config.cat_l2), cat_smooth=float(config.cat_smooth),
            max_cat_threshold=int(config.max_cat_threshold),
            max_cat_to_onehot=int(config.max_cat_to_onehot),
            min_data_per_group=float(config.min_data_per_group),
            cegb_tradeoff=float(config.cegb_tradeoff),
            cegb_penalty_split=float(config.cegb_penalty_split))

    def reset_config(self, params) -> None:
        """New knob values mid-training (JAX ``config.update`` under
        ``Booster.reset_parameter``): the learning rate is read by every
        iteration; any other knob rebuilds the split params and the
        grower, so the next tree trains under it.  A knob the port does
        not train raises, as at construction."""
        before = dataclasses.asdict(self.config)
        learner = self.config._fields_of(params).get("tree_learner")
        if learner is not None and learner != self.config.tree_learner:
            raise ValueError("tree_learner cannot change mid-training: the "
                             "rows each rank holds are set when the "
                             "trainer is built")
        self.config.update(params)
        self.config.__post_init__()
        why = unported_reason(self.config)
        if why:
            raise NotImplementedError(why)
        after = dataclasses.asdict(self.config)
        if any(before[k] != after[k] for k in after
               if k != "learning_rate"):
            self._build_grower()

    # ------------------------------------------------------------------
    def add_valid(self, valid_set: BinnedDataset, name: str,
                  init_raw: Optional[np.ndarray] = None) -> None:
        """A valid set scored every iteration; ``init_raw``: its scores
        from a loaded model (continued training).  Under EFB it is
        bundled with the training layout (JAX :652-669)."""
        if self.iter > 0:
            raise RuntimeError("Cannot add validation data after training "
                               "started")
        metrics = create_metrics(self.config)
        for m in metrics:
            m.init(valid_set.metadata, valid_set.num_data)
        if init_raw is not None:
            init = np.asarray(init_raw, np.float64).reshape(
                valid_set.num_data, self.num_class)
        elif valid_set.metadata.init_score is not None:
            init = np.asarray(valid_set.metadata.init_score,
                              np.float64).reshape(valid_set.num_data, -1)
        else:
            init = self._init_scores[None, :]
        self._valid_sets.append(valid_set)
        self._valid_names.append(name)
        layout = self.train_set.bundle_layout
        if self._bundle is not None and (
                valid_set.bundled is None
                or valid_set.bundle_layout is not layout):
            if valid_set.binned is None:
                log_fatal("validation set was bundled with a different EFB "
                          "layout and has no dense bins to re-bundle; "
                          "construct it with reference=<train dataset>")
            valid_set.bundled = apply_bundles_dense(
                valid_set.binned, valid_set.zero_bins, layout)
            valid_set.bundle_layout = layout
        # an unbundled trainer reads a valid set's plain bins (a sparse set
        # built against it carries identity bundles: the same bins)
        host = (valid_set.bundled if self._bundle is not None
                else valid_set.binned if valid_set.binned is not None
                else valid_set.train_matrix)
        vb = torch.as_tensor(host, device=self.device).contiguous()
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
        # drawn over the global rows; a row shard takes its slice
        N, dev = self._global_rows(), self._row_device
        if use_pos_neg:
            pos = self._rows(bernoulli(key, cfg.pos_bagging_fraction, N,
                                       dev))
            neg = self._rows(bernoulli(fold_in(key, 1),
                                       cfg.neg_bagging_fraction, N, dev))
            mask = torch.where(self.objective.label > 0, pos, neg)
        else:
            mask = self._rows(bernoulli(key, cfg.bagging_fraction, N, dev))
        self._bag_mask = mask.to(torch.float32)
        return self._bag_mask

    def _global_rows(self) -> int:
        """The training set's rows over every rank."""
        return self.num_data if self._shard is None else self._shard.n_global

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (N, ...) draw."""
        if self._shard is None:
            return t
        return t[self._shard.lo:self._shard.hi]

    # ------------------------------------------------------------------
    def _rate(self) -> float:
        """The shrinkage of this iteration's trees."""
        return self.config.learning_rate

    def _gradients(self, score: torch.Tensor, iteration: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, K) gradients and hessians of the (N, K) ``score`` at
        ``iteration`` (a stochastic objective, rank_xendcg, draws from
        it; JAX ``_objective_grads``), under ``finite_guard=clamp`` with
        the non-finite entries zeroed (JAX ``_guard_grads``).  At an armed
        ``grad_poison`` fault's iteration every 13th row's gradient and
        hessian are NaN on every class column first."""
        if self.objective is None:
            log_fatal("objective=none trains on a custom objective: pass "
                      "fobj")
        return self._guarded_gradients(self.objective, score, iteration, 0)

    def _guarded_gradients(self, objective, score: torch.Tensor,
                           iteration: int, row0: int):
        """``_gradients`` of ``objective`` on the rows of ``score``, the
        first of them row ``row0`` of the training set (the poisoned rows
        are the set's)."""
        s = score[:, 0] if self.num_class == 1 else score
        if objective.is_stochastic:
            grad, hess = objective.get_gradients(s, iteration=iteration)
        else:
            grad, hess = objective.get_gradients(s)
        if grad.ndim == 1:
            grad, hess = grad[:, None], hess[:, None]
        if self._poison_iter is not None and iteration == self._poison_iter:
            rows = ((torch.arange(grad.shape[0], device=grad.device) + row0)
                    % 13 == 0)[:, None]
            grad = grad.masked_fill(rows, float("nan"))
            hess = hess.masked_fill(rows, float("nan"))
        if self.config.finite_guard == "clamp":
            finite = torch.isfinite(grad) & torch.isfinite(hess)
            zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
            grad, hess = torch.where(finite, grad, zero), \
                torch.where(finite, hess, zero)
        return grad, hess

    def _custom_grads(self, custom_grad, custom_hess):
        """A custom objective's host gradients as the (N, K) f32 device
        pair the trees take (JAX :791-793); under a row shard, of the
        global rows, this rank's are taken."""
        out = []
        for a in (custom_grad, custom_hess):
            a = np.asarray(a, np.float32).reshape(self._global_rows(), -1)
            if self._shard is not None:
                a = a[self._shard.lo:self._shard.hi]
            out.append(torch.as_tensor(a, device=self.device))
        return tuple(out)

    def _sample_g3(self, grad_k, hess_k, bag, iteration) -> torch.Tensor:
        """The (N, 3) [grad, hess, count] rows of one class tree: an
        out-of-bag row zeroed, its count 0 (JAX :751-761)."""
        if bag is None:
            return torch.stack([grad_k, hess_k, torch.ones_like(grad_k)],
                               dim=1)
        return torch.stack([grad_k * bag, hess_k * bag, bag], dim=1)

    def _grow_trees(self, score: torch.Tensor, rate: float,
                    grads=None) -> _Grown:
        """One iteration's class trees on the (N, K) ``score`` (the JAX
        ``_build_step`` body, run eagerly): gradients (``grads``, a custom
        objective's, or the objective's), then per class its g3 rows, one
        tree, its renewed leaves, its shrinkage by ``rate`` and its score
        deltas.  The deltas are added by the caller: this iteration's
        gradients were taken before the class loop, so one (N, K) add a
        cache after it is exact."""
        K = self.num_class
        grad, hess = (grads if grads is not None
                      else self._gradients(score, self.iter))
        bag = self._bagging_mask(self.iter)
        # the class trees' feature masks, drawn before the class loop
        masks = [self._tree_feature_mask() for _ in range(K)]
        q = (self.objective.renew_percentile if self.objective is not None
             else None)
        trees, hosts, lids, train_preds = [], [], [], []
        valid_preds = [[] for _ in self._valid_binned]
        routes = getattr(self._grow, "routes_valids", False)
        vlids_all = [] if routes else None
        for k in range(K):
            g3 = self._sample_g3(grad[:, k], hess[:, k], bag, self.iter)
            key = fold_in(self._rng_key, self.iter * K + k)
            if routes:
                tree, leaf_id, _, vlids = self._grow(
                    self.binned, g3.contiguous(), masks[k],
                    valids=self._valid_binned, key=key)
                vlids_all.append(vlids)
            else:
                cegb = None
                if self._cegb_enabled:
                    cegb = (self._cegb_used if self._cegb_marks is None
                            else (self._cegb_used, self._cegb_marks))
                tree, leaf_id, _ = self._grow(self.binned, g3.contiguous(),
                                              masks[k], key=key,
                                              cegb_used=cegb)
                vlids = None
            if self._cegb_enabled:
                self._update_cegb_state(tree, leaf_id)
            host = None
            if q is not None:
                tree, host = self._renewed(tree, leaf_id, score[:, k], q,
                                           rate, k)
            shrunk = tree._replace(leaf_value=tree.leaf_value * rate)
            train_preds.append(leaf_lookup(
                shrunk.leaf_value.to(leaf_id.device), leaf_id))
            for vi, vb in enumerate(self._valid_binned):
                valid_preds[vi].append(
                    shrunk.leaf_value[vlids[vi].long()] if vlids is not None
                    else tree_predict_binned(shrunk, vb, self.meta.nan_bin,
                                             self.meta.missing_type,
                                             self.meta.zero_bin,
                                             self._packed, self._bundle))
            trees.append(shrunk)
            hosts.append(host)
            lids.append(leaf_id)
        return _Grown(trees, hosts, torch.stack(train_preds, dim=1),
                      [torch.stack(vp, dim=1) for vp in valid_preds], lids,
                      vlids_all)

    def _renewed(self, tree: TreeArrays, leaf_id: torch.Tensor,
                 score_k: torch.Tensor, q: float, rate: float, k: int):
        """The tree with its leaves renewed to the ``q`` quantile of its
        rows' residuals (JAX ``_finish_tree`` :821-847), and its host tree
        (float64 leaves, shrunk by ``rate``, the iteration's bias folded
        in) that the model text is written from."""
        host = host_tree_from_arrays(tree)
        self._fill_real_thresholds(host)
        if host.num_leaves > 1:
            vals = self._renew_leaf_values(host, leaf_id, score_k, q)
            host.leaf_value = vals
            lv = tree.leaf_value.clone()
            lv[:host.num_leaves] = torch.as_tensor(
                vals.astype(np.float32), device=lv.device)
            tree = tree._replace(leaf_value=lv)
        host.apply_shrinkage(rate)
        host.add_bias(self._tree_bias(k))
        return tree, host

    def _renew_leaf_values(self, host: HostTree, leaf_id: torch.Tensor,
                           score_k: torch.Tensor, q: float) -> np.ndarray:
        """Each leaf's weighted ``q`` quantile of ``label - score`` over
        its rows (JAX ``_renew_leaf_values`` :919-945); a leaf without
        rows keeps its value.  Two stable sorts on the training device
        order every leaf's rows by residual at once (ties in row order);
        each leaf's cumulative weights are summed on the host in that
        order, as the JAX package sums them."""
        if self._shard is not None:
            # each leaf's rows over every rank, in the global row order
            leaf_id = self._shard.gather_rows(leaf_id)
            score_k = self._shard.gather_rows(score_k)
        label, w = self._renew_rows(leaf_id.device)
        resid = label - score_k.double()
        lid = leaf_id.long()
        order = torch.sort(resid, stable=True).indices
        order = order[torch.sort(lid[order], stable=True).indices]
        bounds = np.concatenate([[0], np.cumsum(torch.bincount(
            lid, minlength=host.num_leaves).cpu().numpy())])
        r_sorted = resid[order].cpu().numpy()
        w_sorted = None if w is None else w[order].cpu().numpy()
        out = np.array(host.leaf_value[:host.num_leaves], dtype=np.float64)
        for leaf in range(host.num_leaves):
            a, b = bounds[leaf], bounds[leaf + 1]
            if a == b:
                continue
            out[leaf] = _np_weighted_quantile_sorted(
                r_sorted[a:b],
                np.ones(b - a) if w_sorted is None else w_sorted[a:b], q)
        return out

    def _renew_rows(self, device):
        """The renewal's float64 labels and row weights on ``device``,
        made once."""
        if getattr(self, "_renew_cache", None) is None:
            obj = self._objective_global        # the global rows' arrays
            w = obj.renew_weights()
            self._renew_cache = (
                torch.as_tensor(obj._np_label, dtype=torch.float64,
                                device=device),
                None if w is None else torch.as_tensor(
                    np.asarray(w, np.float64), device=device))
        return self._renew_cache

    def _record(self, grown: _Grown, rate: float) -> None:
        """Append the iteration's trees with their shrinkage and bias."""
        for k, tree in enumerate(grown.trees):
            self._device_trees.append(tree)
            self.models.append(grown.hosts[k])
            self._model_shrink.append(rate)
            self._model_bias.append(self._tree_bias(k))

    def _stopped(self, trees, check_stop: bool) -> bool:
        if not check_stop:
            return False
        stopped = all(int(t.num_leaves) <= 1 for t in trees)
        if stopped:
            log_warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
        return stopped

    def train_one_iter(self, custom_grad=None, custom_hess=None,
                       check_stop: bool = True) -> bool:
        """One boosting iteration (num_class trees), on a custom
        objective's ``custom_grad`` / ``custom_hess`` where given; True
        when no tree could split (reference returns the stop signal when
        the best gain is non-positive)."""
        rate = self._rate()
        self._save_rollback_state()
        grads = (None if custom_grad is None
                 else self._custom_grads(custom_grad, custom_hess))
        with global_timer.section("GBDT::TrainOneIter(dispatch)"):
            grown = self._grow_trees(self._train_scores.score, rate, grads)
        self._train_scores.score = self._train_scores.score \
            + grown.train_delta
        for vs, d in zip(self._valid_scores, grown.valid_deltas):
            vs.score = vs.score + d
        self._record(grown, rate)
        self.iter += 1
        return self._stopped(grown.trees, check_stop)

    def _tree_bias(self, k: int) -> float:
        """The init score goes into the first tree of each class
        (gbdt.cpp:381)."""
        if self.iter == 0 and not self._used_init_score:
            return float(self._init_scores[k])
        return 0.0

    # ------------------------------------------------------------------
    def _save_rollback_state(self) -> None:
        """The scores and the tree count before an iteration (the caches
        are replaced, never written in place, so references suffice)."""
        self._prev_state = (self._train_scores.score,
                            [vs.score for vs in self._valid_scores],
                            len(self.models))

    def rollback_one_iter(self) -> None:
        """Undo the last iteration (JAX :959; reference
        GBDT::RollbackOneIter, gbdt.cpp:421-437); one level deep."""
        if self._prev_state is None:
            return
        score, valid_scores, n = self._prev_state
        self._train_scores.score = score
        for vs, v in zip(self._valid_scores, valid_scores):
            vs.score = v
        del self.models[n:], self._device_trees[n:]
        del self._model_shrink[n:], self._model_bias[n:]
        self.iter -= 1
        self._prev_state = None

    def check_finite_boundary(self) -> None:
        """``finite_guard=warn|raise`` at an iteration boundary (JAX
        :474-523): the training scores, and the last iteration's gradient
        pass re-run on the scores it started from (a pass the grower
        absorbed leaves the scores finite), summed on the device and read
        as one scalar.  ``off`` and ``clamp`` read nothing."""
        mode = self.config.finite_guard
        if mode not in ("warn", "raise"):
            return
        total = self._train_scores.score.sum()
        if self.objective is not None and self._prev_state is not None \
                and self.iter > 0:
            g, h = self._gradients(self._prev_state[0], self.iter - 1)
            total = total + g.sum() + h.sum()
        if self._shard is not None:
            total = self._group.all_reduce(total)      # every rank decides
        if bool(torch.isfinite(total)):
            return
        msg = (f"non-finite gradient/score state at iteration {self.iter} "
               f"boundary (finite_guard={mode}): the last iteration's "
               "trees are suspect — roll back or resume from the "
               "previous checkpoint")
        if mode == "raise":
            raise FiniteGuardError(msg)
        if not self._finite_warned:
            self._finite_warned = True
            log_warning(msg)

    # ------------------------------------------------------------------
    def capture_state(self):
        """``(manifest, arrays)`` of the trainer for
        ``io.checkpoint.write_checkpoint`` (JAX :1004)."""
        from ..io.checkpoint import encode_rng_state

        self._refuse_sharded_checkpoint()

        arrays = {}
        for f in TreeArrays._fields:
            arrays[f"tree_{f}"] = (
                np.stack([getattr(t, f).detach().cpu().numpy()
                          for t in self._device_trees])
                if self._device_trees else np.zeros(0, np.float32))
        arrays["train_score"] = self._train_scores.score.cpu().numpy()
        for i, vs in enumerate(self._valid_scores):
            arrays[f"valid_score_{i}"] = vs.score.cpu().numpy()
        # the host trees made eagerly (renewed leaves): their float64
        # values, which the device arrays hold in f32 only
        host = [i for i, m in enumerate(self.models) if m is not None]
        L = self.config.num_leaves
        lv = np.zeros((len(host), L), np.float64)
        iv = np.zeros((len(host), max(L - 1, 1)), np.float64)
        for r, i in enumerate(host):
            m = self.models[i]
            lv[r, :m.num_leaves] = m.leaf_value
            iv[r, :m.num_leaves - 1] = m.internal_value
        arrays.update(host_index=np.asarray(host, np.int64),
                      host_leaf_value=lv, host_internal_value=iv)
        # CEGB's carried state (JAX :1016-1021)
        arrays["cegb_used"] = self._cegb_used.cpu().numpy()
        if self._cegb_marks is not None:
            arrays["cegb_marks"] = self._cegb_marks.cpu().numpy()
        manifest = {
            "iteration": int(self.iter),
            "num_trees": len(self.models),
            "num_class": int(self.num_class),
            "num_data": int(self.num_data),
            "n_valid": len(self._valid_scores),
            "boosting": type(self).__name__,
            "objective": self.config.objective,
            "seed": int(self.config.seed),
            "used_init_score": bool(self._used_init_score),
            "init_scores": [float(v) for v in self._init_scores],
            "model_shrink": [float(v) for v in self._model_shrink],
            "model_bias": [float(v) for v in self._model_bias],
            "host_shrinkage": [float(self.models[i].shrinkage)
                               for i in host],
            "feat_rng": encode_rng_state(self._feat_rng),
        }
        self._capture_extra(manifest, arrays)
        return manifest, arrays

    def _capture_extra(self, manifest, arrays) -> None:
        """Subclass hook (DART)."""

    def _refuse_sharded_checkpoint(self) -> None:
        """A row-sharded trainer's state is spread over its ranks: its
        checkpoint belongs to elastic training (ROADMAP item 14.3)."""
        if self._shard is not None:
            raise not_ported("checkpoints of a row-sharded learner "
                             "(tree_learner=data or voting over ranks)",
                             PARALLEL)

    def restore_state(self, manifest, arrays) -> None:
        """A captured state into this fresh trainer, built on the same
        data and config with the same valid sets (JAX :1056); raises
        ``CheckpointError`` where they do not fit."""
        from ..io.checkpoint import CheckpointError, decode_rng_state

        self._refuse_sharded_checkpoint()
        if self.iter != 0 or self.models:
            raise CheckpointError(
                "restore_state() needs a fresh trainer (training already "
                f"started: iteration {self.iter})")
        for key, want, got in (
                ("num_data", int(manifest["num_data"]), self.num_data),
                ("num_class", int(manifest["num_class"]), self.num_class),
                ("boosting", manifest["boosting"], type(self).__name__),
                ("objective", manifest["objective"], self.config.objective),
                ("seed", int(manifest["seed"]), int(self.config.seed)),
                ("n_valid", int(manifest["n_valid"]),
                 len(self._valid_scores))):
            if want != got:
                raise CheckpointError(
                    f"checkpoint/trainer mismatch on {key}: checkpoint has "
                    f"{want!r}, trainer has {got!r}")
        T = int(manifest["num_trees"])
        if T and any(arrays[f"tree_{f}"].shape[0] != T
                     for f in TreeArrays._fields):
            raise CheckpointError("tree array stack does not match the "
                                  "manifest tree count")
        dev = self.device
        self._device_trees = [
            TreeArrays(**{f: torch.as_tensor(arrays[f"tree_{f}"][i],
                                             device=dev)
                          for f in TreeArrays._fields})
            for i in range(T)]
        self._model_shrink = [float(v) for v in manifest["model_shrink"]]
        self._model_bias = [float(v) for v in manifest["model_bias"]]
        self.models = [None] * T
        for r, i in enumerate(arrays["host_index"].tolist()):
            ht = host_tree_from_arrays(self._device_trees[i])
            self._fill_real_thresholds(ht)
            ht.leaf_value = arrays["host_leaf_value"][r, :ht.num_leaves]
            ht.internal_value = arrays["host_internal_value"][
                r, :ht.num_leaves - 1]
            ht.shrinkage = float(manifest["host_shrinkage"][r])
            self.models[i] = ht
        self._train_scores.score = torch.as_tensor(arrays["train_score"],
                                                   device=self._row_device)
        for i, vs in enumerate(self._valid_scores):
            vs.score = torch.as_tensor(arrays[f"valid_score_{i}"],
                                       device=dev)
        self._feat_rng.set_state(decode_rng_state(manifest["feat_rng"]))
        if "cegb_used" in arrays:
            self._cegb_used = torch.as_tensor(arrays["cegb_used"],
                                              device=dev)
        if "cegb_marks" in arrays and self._cegb_marks is not None:
            self._cegb_marks = torch.as_tensor(arrays["cegb_marks"],
                                               device=dev)
        self._used_init_score = bool(manifest["used_init_score"])
        self._init_scores = np.asarray(manifest["init_scores"], np.float64)
        self._bag_mask = None
        self._prev_state = None
        self._restore_extra(manifest, arrays)
        self.iter = int(manifest["iteration"])

    def _restore_extra(self, manifest, arrays) -> None:
        """Subclass hook (DART)."""

    # ------------------------------------------------------------------
    def _update_cegb_state(self, tree: TreeArrays,
                           leaf_id: torch.Tensor) -> None:
        """After a tree (JAX :735): the model's used features take the
        tree's split features; the lazy marks take, for each row, the
        features on its leaf's root path (the union of the per-split
        marks)."""
        F = self._cegb_used.shape[0]
        self._cegb_used = self._cegb_used | tree_used_features(tree, F)
        if self._cegb_marks is not None:
            self._cegb_marks = self._cegb_marks | leaf_path_features(
                tree, F)[leaf_id.long()]

    def _fill_real_thresholds(self, ht: HostTree) -> None:
        """Bin thresholds -> real ones; a categorical node's bin-space
        bitset -> its raw categories (JAX :904-915, the reference's
        Tree::SplitCategorical), its threshold 0 (the cat index on
        save)."""
        mappers = self.train_set.bin_mappers
        for n in range(ht.num_leaves - 1):
            m = mappers[ht.split_feature[n]]
            if ht.is_cat[n]:
                cats = [m.bin_2_categorical[b] for b in ht.cat_bins_of(n)
                        if b < len(m.bin_2_categorical)]
                ht.cat_sets[n] = np.asarray(sorted(cats), dtype=np.int64)
                ht.threshold[n] = 0.0
            else:
                ht.threshold[n] = m.bin_to_threshold(ht.threshold_bin[n])

    def materialize_host_trees(self) -> List[HostTree]:
        """Host copies of the trees not yet fetched: real thresholds from
        the bin mappers and the boost-from-average bias folded in."""
        if all(m is not None for m in self.models):
            return self.models
        with obs_trace.span("train.materialize_host_trees", cat="train"), \
                global_timer.section("GBDT::MaterializeHostTrees"):
            for i, m in enumerate(self.models):
                if m is not None:
                    continue
                ht = host_tree_from_arrays(self._device_trees[i],
                                           shrinkage=self._model_shrink[i])
                self._fill_real_thresholds(ht)
                ht.add_bias(self._model_bias[i])
                self.models[i] = ht
        return self.models

    # ------------------------------------------------------------------
    def _raw_pred(self, scores: _ScoreUpdater) -> np.ndarray:
        """The float64 raw scores a ``wants_raw`` metric reads, (N,) for
        one class (JAX :1191)."""
        raw = scores.score.detach().cpu().numpy().astype(np.float64)
        return raw[:, 0] if self.num_class == 1 else raw

    def _converted_pred(self, scores: _ScoreUpdater) -> np.ndarray:
        """The objective's output of the raw scores (JAX :1184); raw
        under a custom objective."""
        raw = self._raw_pred(scores)
        if self.objective is None:
            return raw
        return np.asarray(self.objective.convert_output(raw), np.float64)

    def _eval(self, dataset_name, scores: _ScoreUpdater, metrics, out):
        raw = pred = None
        for m in metrics:
            if m.wants_raw:
                raw = self._raw_pred(scores) if raw is None else raw
                p = raw
            else:
                pred = self._converted_pred(scores) if pred is None else pred
                p = pred
            for name, value, hb in m.eval(p):
                out.append((dataset_name, name, value, hb))

    def eval_valid(self):
        out = []
        with global_timer.section("GBDT::EvalValid"):
            for name, vs, metrics in zip(self._valid_names,
                                         self._valid_scores,
                                         self._valid_metrics):
                self._eval(name, vs, metrics, out)
        return out

    def eval_train(self):
        """The training set's metrics on its current scores (JAX
        :1213)."""
        meta, n, scores = (self.train_set.metadata, self.num_data,
                           self._train_scores)
        if self._shard is not None:
            # the global rows' scores, on every rank (a collective)
            meta, n = self._shard.gmeta, self._shard.n_global
            scores = _ScoreUpdater.__new__(_ScoreUpdater)
            scores.score = self._shard.gather_rows(self._train_scores.score)
        if self._train_metrics is None:
            self._train_metrics = create_metrics(self.config)
            for m in self._train_metrics:
                m.init(meta, n)
        out = []
        with global_timer.section("GBDT::EvalTrain"):
            self._eval("training", scores, self._train_metrics, out)
        return out

    def raw_train_scores(self) -> np.ndarray:
        """(N, num_class) float64 raw training scores on the host; under a
        row shard every rank's rows, gathered (a collective: every rank
        calls it)."""
        score = self._train_scores.score
        if self._shard is not None:
            score = self._shard.gather_rows(score)
        return score.detach().cpu().numpy().astype(np.float64)

    def raw_valid_scores(self, i: int) -> np.ndarray:
        """Valid set ``i``'s (N, num_class) float64 raw scores."""
        return self._valid_scores[i].score.detach().cpu().numpy() \
            .astype(np.float64)


# ---------------------------------------------------------------------------
# GOSS (JAX gbdt.py:1252; reference goss.hpp:25-150)
# ---------------------------------------------------------------------------


class GOSS(GBDT):
    """Gradient-based one-side sampling: the rows of the largest |g h|
    kept, a draw of the rest amplified by ``(1 - top_rate) /
    other_rate``."""

    def _sample_g3(self, grad_k, hess_k, bag, iteration) -> torch.Tensor:
        cfg = self.config
        n = self._global_rows()
        top_k = max(1, int(cfg.top_rate * n))
        other_k = max(1, int(cfg.other_rate * n))
        score = torch.abs(grad_k * hess_k)
        # the top_k-th largest |g h| (``sort(score)[-top_k]``) of the
        # global rows; every row at or above it is kept, so ties can keep
        # more than top_k
        every = (score if self._shard is None
                 else self._shard.gather_rows(score))
        thresh = torch.kthvalue(every, n - top_k + 1).values
        is_top = score >= thresh
        # the JAX package divides int32 by int32 into float32
        rest_prob = float(np.float32(other_k) / np.float32(max(n - top_k,
                                                               1)))
        key = fold_in(prng_key(cfg.seed + 17), iteration)
        sampled = ~is_top & self._rows(bernoulli(key, rest_prob, n,
                                                 score.device))
        amp = (1.0 - cfg.top_rate) / cfg.other_rate
        w = torch.where(is_top, torch.ones_like(score),
                        torch.where(sampled, torch.full_like(score, amp),
                                    torch.zeros_like(score)))
        cnt = (is_top | sampled).to(torch.float32)
        if bag is not None:
            w = w * bag
            cnt = cnt * bag
        return torch.stack([grad_k * w, hess_k * w, cnt], dim=1)


# ---------------------------------------------------------------------------
# DART (JAX gbdt.py:1284; reference dart.hpp:23-170)
# ---------------------------------------------------------------------------


class DART(GBDT):
    """Dropouts meet multiple additive regression trees: each iteration
    drops some earlier trees, grows on the rest and normalizes."""

    # the budget of recorded leaf ids (JAX :1307)
    LID_BUDGET_BYTES = 1 << 30

    def __init__(self, config: Config, train_set: BinnedDataset,
                 device: torch.device,
                 init_raw_scores: Optional[np.ndarray] = None):
        super().__init__(config, train_set, device, init_raw_scores)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        # per-tree weights of the weighted drop (dart.hpp:67-68, 103-115)
        self._tree_weight: List[float] = []
        self._sum_weight = 0.0
        L = config.num_leaves
        self._lid_dtype = (torch.uint8 if L <= 256 else torch.uint16
                           if L <= 65536 else torch.int32)
        # each iteration's (K, N) training leaf ids and, where the grower
        # routed them, each valid set's (K, N_v): a drop's removal is a
        # gather of its leaf values through them
        self._train_lids: List[torch.Tensor] = []
        self._valid_lids: List[Optional[List[torch.Tensor]]] = []
        rows = self.num_data
        self._lid_row_bytes = self.num_class * torch.tensor(
            [], dtype=self._lid_dtype).element_size()
        self._lid_bytes = rows * self._lid_row_bytes
        self._keep_lids = True

    def add_valid(self, valid_set: BinnedDataset, name: str,
                  init_raw: Optional[np.ndarray] = None) -> None:
        super().add_valid(valid_set, name, init_raw)
        self._lid_bytes += valid_set.num_data * self._lid_row_bytes

    def _select_drops(self) -> List[int]:
        """The iterations to drop (JAX ``_select_drops`` :1374; reference
        DroppingTrees :96-137): one ``rand()`` against ``skip_drop``, then
        one a tree, ``uniform_drop`` at ``drop_rate`` or weighted by each
        tree's normalized weight, at most ``max_drop``."""
        cfg = self.config
        n_trees = len(self.models) // self.num_class
        drops: List[int] = []
        if n_trees > 0 and self._drop_rng.rand() >= cfg.skip_drop:
            dr = cfg.drop_rate
            if not cfg.uniform_drop and self._sum_weight > 0:
                inv_avg = len(self._tree_weight) / self._sum_weight
                if cfg.max_drop > 0:
                    dr = min(dr, cfg.max_drop * inv_avg / self._sum_weight)
                for i in range(n_trees):
                    if (self._drop_rng.rand()
                            < dr * self._tree_weight[i] * inv_avg):
                        drops.append(i)
                        if cfg.max_drop > 0 and len(drops) >= cfg.max_drop:
                            break
            else:
                if cfg.max_drop > 0:
                    dr = min(dr, cfg.max_drop / float(n_trees))
                for i in range(n_trees):
                    if self._drop_rng.rand() < dr:
                        drops.append(i)
                        if cfg.max_drop > 0 and len(drops) >= cfg.max_drop:
                            break
        return drops

    def _normalization(self, k_drop: int):
        """(shrink_new, old_factor, w_dec) (JAX :1402; reference dart.hpp
        Normalize :158-196, shrinkage_rate_ :138-146)."""
        lr = self.config.learning_rate
        if self.config.xgboost_dart_mode:
            shrink_new = lr if k_drop == 0 else lr / (lr + k_drop)
            return shrink_new, k_drop / (k_drop + lr), 1.0 / (k_drop + lr)
        return (lr / (k_drop + 1.0), k_drop / (k_drop + 1.0),
                1.0 / (k_drop + 1.0))

    def _lids_usable(self) -> bool:
        return (self._keep_lids and len(self._train_lids)
                == len(self.models) // self.num_class)

    def _store_lids(self, grown: _Grown) -> None:
        """Keep the iteration's leaf ids under the budget (JAX
        ``_maybe_store_lids`` :1324); past it every list is freed."""
        if not self._keep_lids:
            return
        if (len(self._train_lids) + 1) * self._lid_bytes \
                > self.LID_BUDGET_BYTES:
            self._keep_lids = False
            self._train_lids.clear()
            self._valid_lids.clear()
            return
        dt = self._lid_dtype
        self._train_lids.append(torch.stack(grown.leaf_ids).to(dt))
        self._valid_lids.append(
            None if grown.valid_lids is None else
            [torch.stack([v[vi] for v in grown.valid_lids]).to(dt)
             for vi in range(len(self._valid_binned))])

    def _dropped_scores(self, drops: List[int]):
        """The dropped trees' (N, K) sum on the training rows and each
        valid set's, each tree with its bias (the embedded init score),
        as the reference drops the saved trees (JAX :1728-1759)."""
        K = self.num_class
        use = self._lids_usable()
        meta = self.meta
        d_train = torch.zeros_like(self._train_scores.score)
        d_valid = [torch.zeros_like(vs.score) for vs in self._valid_scores]
        for it in drops:
            vl = self._valid_lids[it] if use else None
            for k in range(K):
                idx = it * K + k
                tree = self._device_trees[idx]
                b = self._model_bias[idx]
                lv = tree.leaf_value + b if b else tree.leaf_value
                walk = tree._replace(leaf_value=lv)
                d_train[:, k] += (
                    lv.to(self._row_device)[self._train_lids[it][k].long()]
                    if use else self._train_walk(walk))
                for vi, vb in enumerate(self._valid_binned):
                    d_valid[vi][:, k] += (
                        lv[vl[vi][k].long()] if vl is not None else
                        tree_predict_binned(walk, vb, meta.nan_bin,
                                            meta.missing_type,
                                            meta.zero_bin, self._packed,
                                            self._bundle))
        return d_train, d_valid

    def _train_walk(self, tree: TreeArrays) -> torch.Tensor:
        """Each training row's leaf value of ``tree``, walked on the
        bins."""
        meta = self.meta
        return tree_predict_binned(tree, self.binned, meta.nan_bin,
                                   meta.missing_type, meta.zero_bin,
                                   self._packed, self._bundle)

    def _rescale_dropped(self, drops: List[int], old_factor: float,
                         w_dec: float) -> None:
        """The dropped trees scaled by ``old_factor`` for good: device
        leaves, shrinkage and bias, and a host tree already materialized
        (JAX ``_rescale_dropped`` :1431)."""
        for it in drops:
            for k in range(self.num_class):
                idx = it * self.num_class + k
                if self.models[idx] is not None:
                    self.models[idx].apply_shrinkage(old_factor)
                t = self._device_trees[idx]
                self._device_trees[idx] = t._replace(
                    leaf_value=t.leaf_value * old_factor)
                self._model_shrink[idx] *= old_factor
                self._model_bias[idx] *= old_factor
            if not self.config.uniform_drop:
                self._sum_weight -= self._tree_weight[it] * w_dec
                self._tree_weight[it] *= old_factor

    def train_one_iter(self, custom_grad=None, custom_hess=None,
                       check_stop: bool = True) -> bool:
        """One DART iteration (JAX ``_fused_dart_iter`` :1547, the no-drop
        iteration :1623 and the host one :1653): remove the drops, grow on
        the rest at ``shrink_new`` (on a custom objective's gradients
        where given), restore the drops at ``old_factor``, then add the
        new trees.  The rollback snapshot holds the dropped trees' values
        and the tree weights."""
        self._save_rollback_state()
        self._prev_weights = (list(self._tree_weight), self._sum_weight)
        drops = self._select_drops()
        if drops:
            self._snapshot_dropped(drops)
        shrink_new, old_factor, w_dec = self._normalization(len(drops))
        score = self._train_scores.score
        vscores = [vs.score for vs in self._valid_scores]
        if drops:
            d_train, d_valid = self._dropped_scores(drops)
            score = score - d_train
            vscores = [v - d for v, d in zip(vscores, d_valid)]
        grads = (None if custom_grad is None
                 else self._custom_grads(custom_grad, custom_hess))
        with global_timer.section("DART::TrainOneIter(dispatch)"):
            grown = self._grow_trees(score, shrink_new, grads)
        if drops:
            score = score + old_factor * d_train
            vscores = [v + old_factor * d for v, d in zip(vscores, d_valid)]
        self._train_scores.score = score + grown.train_delta
        for vs, v, d in zip(self._valid_scores, vscores, grown.valid_deltas):
            vs.score = v + d
        self._store_lids(grown)
        self._record(grown, shrink_new)
        if drops:
            self._rescale_dropped(drops, old_factor, w_dec)
        if not self.config.uniform_drop:
            self._tree_weight.append(shrink_new)
            self._sum_weight += shrink_new
        self.iter += 1
        return self._stopped(grown.trees, check_stop)

    def _snapshot_dropped(self, drops: List[int]) -> None:
        """The dropped trees' values before their rescale, for the
        rollback (JAX ``_snapshot_dropped`` :1412): host leaf and internal
        values and shrinkage (where materialized), device leaves,
        shrinkage and bias."""
        snap = {}
        for it in drops:
            for k in range(self.num_class):
                idx = it * self.num_class + k
                m = self.models[idx]
                snap[idx] = (
                    None if m is None else (m.leaf_value.copy(),
                                            m.internal_value.copy(),
                                            m.shrinkage),
                    self._device_trees[idx].leaf_value,
                    self._model_shrink[idx], self._model_bias[idx])
        self._prev_state = self._prev_state + (snap,)

    def rollback_one_iter(self) -> None:
        """Undo the last iteration (JAX :1761): the dropped trees' values
        and the tree weights first, then the scores and the lists."""
        if self._prev_state is not None and len(self._prev_state) == 4:
            for idx, (host, dev_lv, shrink, bias) in \
                    self._prev_state[3].items():
                m = self.models[idx]
                if host is not None and m is not None:
                    m.leaf_value, m.internal_value, m.shrinkage = host
                self._device_trees[idx] = self._device_trees[idx]._replace(
                    leaf_value=dev_lv)
                self._model_shrink[idx] = shrink
                self._model_bias[idx] = bias
            self._prev_state = self._prev_state[:3]
        if getattr(self, "_prev_weights", None) is not None:
            self._tree_weight, self._sum_weight = self._prev_weights
            self._prev_weights = None
        super().rollback_one_iter()
        keep = len(self.models) // self.num_class
        del self._train_lids[keep:], self._valid_lids[keep:]

    def _capture_extra(self, manifest, arrays) -> None:
        """The drop stream, the tree weights and (while kept) the
        recorded leaf ids, as int32 (JAX :1328)."""
        from ..io.checkpoint import encode_rng_state

        use = self._lids_usable() and bool(self._train_lids)
        manifest["dart"] = {
            "drop_rng": encode_rng_state(self._drop_rng),
            "tree_weight": [float(v) for v in self._tree_weight],
            "sum_weight": float(self._sum_weight),
            "lids_kept": bool(self._lids_usable()),
            "valid_lids": use and self._valid_lids[0] is not None}
        if use:
            arrays["dart_lids"] = torch.stack(self._train_lids).to(
                torch.int32).cpu().numpy()
            if manifest["dart"]["valid_lids"]:
                for vi in range(len(self._valid_binned)):
                    arrays[f"dart_vlids_{vi}"] = torch.stack(
                        [v[vi] for v in self._valid_lids]).to(
                            torch.int32).cpu().numpy()

    def _restore_extra(self, manifest, arrays) -> None:
        from ..io.checkpoint import decode_rng_state

        d = manifest["dart"]
        self._drop_rng.set_state(decode_rng_state(d["drop_rng"]))
        self._tree_weight = [float(v) for v in d["tree_weight"]]
        self._sum_weight = float(d["sum_weight"])
        self._train_lids.clear()
        self._valid_lids.clear()
        self._keep_lids = bool(d["lids_kept"])
        if self._keep_lids and "dart_lids" in arrays:
            dt = self._lid_dtype
            lids = arrays["dart_lids"]
            vl = [arrays[f"dart_vlids_{vi}"]
                  for vi in range(len(self._valid_binned))] \
                if d["valid_lids"] else None
            for i in range(lids.shape[0]):
                self._train_lids.append(
                    torch.as_tensor(lids[i], device=self._row_device).to(dt))
                self._valid_lids.append(None if vl is None else [
                    torch.as_tensor(v[i], device=self.device).to(dt)
                    for v in vl])
        self._prev_weights = None


# ---------------------------------------------------------------------------
# RF (JAX gbdt.py:1789; reference rf.hpp:25)
# ---------------------------------------------------------------------------


class RF(GBDT):
    """Random forest: bagged, unshrunk trees on the gradients at the init
    score, averaged."""

    def __init__(self, config: Config, train_set: BinnedDataset,
                 device: torch.device,
                 init_raw_scores: Optional[np.ndarray] = None):
        if config.bagging_freq <= 0 or config.bagging_fraction >= 1.0:
            log_fatal("RF mode requires bagging "
                      "(bagging_freq > 0 and bagging_fraction < 1)")
        if train_set.metadata.init_score is not None:
            log_fatal("RF mode does not support init_score (reference "
                      "rf.hpp:44)")
        if init_raw_scores is not None:
            log_fatal("RF mode does not support continued training")
        self._init_grads = None
        super().__init__(config, train_set, device)

    def _rate(self) -> float:
        return 1.0

    def _tree_bias(self, k: int) -> float:
        # every tree carries the init score; prediction divides the sum
        # by the iterations (rf.hpp:136)
        return float(self._init_scores[k])

    def _gradients(self, score, iteration):
        """The gradients at the constant init score, taken once (each
        iteration for a stochastic objective)."""
        if self._init_grads is not None:
            return self._init_grads
        init = torch.as_tensor(np.broadcast_to(
            self._init_scores[None, :], (self.num_data, self.num_class))
            .astype(np.float32), device=self.device)
        grads = super()._gradients(init, iteration)
        if not self.objective.is_stochastic:
            self._init_grads = grads
        return grads

    def _averaged(self, scores: _ScoreUpdater) -> torch.Tensor:
        """``init + (sum - init) / iterations`` in f32 (JAX :1868)."""
        init = torch.as_tensor(self._init_scores[None, :].astype(np.float32),
                               device=self.device)
        raw = init + (scores.score - init) / max(self.iter, 1)
        return raw[:, 0] if self.num_class == 1 else raw

    def _raw_pred(self, scores):
        return self._averaged(scores).detach().cpu().numpy() \
            .astype(np.float64)

    def _converted_pred(self, scores):
        # the JAX package converts the f32 average before the host cast
        avg = self._averaged(scores).detach().cpu().numpy()
        if self.objective is None:
            return avg.astype(np.float64)
        return np.asarray(self.objective.convert_output(avg), np.float64)


def create_boosting(config: Config, train_set: BinnedDataset,
                    device: torch.device,
                    init_raw_scores: Optional[np.ndarray] = None) -> GBDT:
    """The trainer of ``config.boosting`` (JAX :1885; reference
    Boosting::CreateBoosting, boosting.cpp:37-44); ``init_raw_scores``:
    a loaded model's raw scores on the training rows (continued
    training)."""
    if getattr(train_set, "is_streaming", False) or config.stream_enable:
        # the out-of-core row-block trainer (JAX :1888-1894): a block
        # cache streams from disk, stream_enable cuts resident bins into
        # the same blocks
        from .gbdt_stream import create_streaming_boosting

        return create_streaming_boosting(config, train_set, device,
                                         init_raw_scores)
    kind = config.boosting
    classes = {"gbdt": GBDT, "gbrt": GBDT, "dart": DART, "goss": GOSS,
               "rf": RF, "random_forest": RF}
    if kind not in classes:
        log_fatal(f"Unknown boosting type: {kind}")
    return classes[kind](config, train_set, device, init_raw_scores)
