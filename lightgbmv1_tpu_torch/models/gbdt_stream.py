"""Row-block streaming boosting: out-of-core training.

Port of lightgbmv1_tpu/models/gbdt_stream.py.  :class:`StreamingGBDT` and
:class:`StreamingDART` are the resident trainers (models/gbdt.py) with
every O(N) device pass replaced by a streamed one:

* the **bins** never go to the device whole: each pass streams the
  blocks (models/grower_stream.py ``StreamGrower``), from a block cache
  on disk (data/block_cache.py) or cut from resident bins
  (``stream_enable=true``);
* the **per-row state** (scores, gradients, leaf ids, the bagging mask,
  DART's recorded leaf ids) lives on the host (``GBDT._row_device``), the
  scores in a CPU ``_ScoreUpdater`` (``_HostScoreStore`` in the JAX
  package): one f32 add an element, the resident trainer's arithmetic;
* the **gradients** run the objective on the device block by block
  (``_ObjectiveSlicer``): the objective is initialised once over the
  whole metadata (so its global statistics are the resident ones), its
  (N, ...) tensors kept on the host and sliced to the device per block;
  an elementwise objective computes each row as the resident pass does.
  ``finite_guard=clamp`` zeroes a block's non-finite entries and an armed
  ``grad_poison`` fault poisons the rows of the training set's ``% 13``
  pattern at their global offsets (JAX :222-258);
* the **bagging mask** is drawn on the host from the JAX stream
  (``GBDT._bagging_mask``; integer threefry, the same bits on either
  device), once a bagging period;
* valid sets stay on the device and are scored as the resident trainer
  scores them; DART's removals gather through the recorded (host) leaf
  ids or walk the dropped trees block by block (``_train_walk``);
  rollback and checkpoints (io/checkpoint.py) hold the host state.

The parity contract.  At one block a streamed model is the resident
``tree_growth=leafwise_masked`` model byte for byte on either device
(every fold starts from the block's own sums).  Past one block K1's and
the root sum's block folds add the blocks' partials in block order
(``ops/histogram.sums_accum``): deterministic, repeatable bit for bit,
not the resident single pass.  The CPU tests put the JAX package's
row-order root sum (a scatter fold) into both trainers; then the
``scatter`` fold, which continues the resident row order, makes the
streamed text the resident one byte for byte at any block count, where
the block rows are a multiple of 32 (torch's CPU vector loop computes a
transcendental in a scalar tail otherwise, whose rounding may differ).

Refused, with the JAX package's words (``_check_streamable`` :92-115,
``StreamingGBDT.__init__`` :131-142, ``create_streaming_boosting``
:583-593): level-wise growth, forced splits, CEGB, query groups, EFB
bundle-only data, objectives that renew leaves, stochastic objectives,
custom ``fobj``, boosting other than gbdt / dart, and ``tree_learner``
other than serial (JAX :93).
``hist_method=fused`` raises where the JAX package drops to the staged
method with a warning: the fused round needs the resident wave grower.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import Config
from ..data.streaming import DeviceLedger, block_source_for
from ..io.dataset import BinnedDataset
from ..ops.histogram import default_hist_method
from ..parallel.trainer import parse_interaction_constraints
from ..utils.log import log_fatal, log_info
from .gbdt import DART, GBDT
from .grower_stream import StreamGrower
from .tree import TreeArrays, tree_predict_binned


class _ObjectiveSlicer:
    """Per-block views of an objective initialised over the whole
    metadata on the host: its (N, ...) tensors stay on the host and
    ``sliced(a, b)`` hands back a shallow copy holding rows [a, b) of
    each on ``device``; its other tensors move to ``device`` once."""

    def __init__(self, obj, num_data: int, device: torch.device):
        self._obj, self._device = obj, device
        self._rows = {}
        for k, v in list(vars(obj).items()):
            if not isinstance(v, torch.Tensor):
                continue
            if v.ndim >= 1 and v.shape[0] == num_data:
                self._rows[k] = v
            else:
                setattr(obj, k, v.to(device))

    def sliced(self, a: int, b: int):
        o = copy.copy(self._obj)
        for k, v in self._rows.items():
            setattr(o, k, v[a:b].to(self._device))
        return o


def _check_streamable(config: Config, train_set) -> None:
    if config.tree_learner not in ("serial", ""):
        log_fatal(f"streaming training requires tree_learner=serial "
                  f"(got {config.tree_learner}); ROADMAP item 1 composes "
                  "multi-host loading with this path")
    if config.tree_growth == "levelwise":
        log_fatal("streaming training implements the sequential leaf-wise "
                  "schedule; tree_growth=levelwise is resident-only")
    if config.forcedsplits_filename:
        log_fatal("forcedsplits_filename is not supported by the "
                  "streaming trainer")
    if (config.cegb_tradeoff * config.cegb_penalty_split > 0
            or config.cegb_penalty_feature_coupled
            or config.cegb_penalty_feature_lazy):
        log_fatal("CEGB penalties are not supported by the streaming "
                  "trainer (per-row feature marks are O(N*F) state)")
    if train_set.metadata.group is not None:
        log_fatal("ranking objectives (query groups) are not supported by "
                  "the streaming trainer: per-query gradients span blocks")
    if train_set.bundle_layout is not None and train_set.binned is None:
        log_fatal("EFB bundle-only (sparse-path) datasets are not "
                  "streamable; load dense data or set enable_bundle=false")
    if config.hist_method == "fused":
        log_fatal("hist_method=fused: streaming training runs the "
                  "sequential schedule, and the fused wave round needs the "
                  "resident wave grower; set a staged hist_method (auto, "
                  "pallas, scatter, onehot)")


class StreamingGBDT(GBDT):
    """Out-of-core GBDT: the device working set is a block's and the
    leaf-sized state's, ``O(stream_block_rows * F + L * F * B)``."""

    _is_streaming = True

    def __init__(self, config: Config, train_set: BinnedDataset,
                 device: torch.device, init_raw_scores=None):
        _check_streamable(config, train_set)
        self._source = block_source_for(train_set, config.stream_block_rows)
        self._ledger = DeviceLedger()
        super().__init__(config, train_set, device, init_raw_scores)
        if self.objective is None:
            log_fatal("streaming training requires a built-in objective "
                      "(custom fobj needs full-matrix raw scores)")
        if self.objective.renew_percentile is not None:
            log_fatal(f"objective {config.objective} renews leaf values "
                      "host-side and is not supported by the streaming "
                      "trainer")
        if self.objective.is_stochastic:
            log_fatal(f"objective {config.objective} draws per-row "
                      "randomness over the full matrix; not streamable")
        self._slicer = _ObjectiveSlicer(self.objective, self.num_data,
                                        self.device)
        log_info(
            f"Streaming trainer: {self._source.num_blocks} blocks of "
            f"{self._source.block_rows} rows ({self._source.num_rows} rows "
            f"x {self._source.num_features} features; device working set "
            "bounded per block)")

    @property
    def stream_peak_device_bytes(self) -> int:
        """The ledger's peak of streaming-owned device bytes."""
        return self._ledger.peak_bytes

    def _build_grower(self) -> None:
        cfg = self.config
        self.split_params = self._make_split_params()
        method = default_hist_method(
            cfg.hist_method, self.device,
            torch.from_numpy(np.zeros(0, self._source.block_dtype)).dtype)
        if method == "pallas":
            log_info("streaming folds K1's per-block partial sums in block "
                     "order: deterministic at a fixed block order; one "
                     "block is the resident pass bit for bit")
        self._grow = StreamGrower(
            source=self._source, ledger=self._ledger, device=self.device,
            num_leaves=cfg.num_leaves, num_bins=self.num_bins,
            meta=self.meta, params=self.split_params,
            max_depth=cfg.max_depth,
            feature_fraction_bynode=cfg.feature_fraction_bynode,
            interaction_groups=parse_interaction_constraints(
                cfg.interaction_constraints, self.train_set.num_features),
            hist_method=method, hist_precision=cfg.hist_dtype,
            hist_pool_mb=cfg.histogram_pool_size,
            prefetch=cfg.stream_prefetch)

    def _gradients(self, score: torch.Tensor, iteration: int):
        """(N, K) host gradients and hessians of the host ``score``, the
        objective run on the device a block at a time."""
        N, K = score.shape
        grad = torch.empty((N, K), dtype=torch.float32)
        hess = torch.empty((N, K), dtype=torch.float32)
        for a, b in self._source.ranges:
            s = score[a:b].to(self.device)
            h = self._ledger.hold_tensor("grad_block", s)
            g, hs = self._guarded_gradients(self._slicer.sliced(a, b), s,
                                            iteration, a)
            grad[a:b], hess[a:b] = g, hs
            self._ledger.release(h)
        return grad, hess

    def _train_walk(self, tree: TreeArrays) -> torch.Tensor:
        """Each training row's leaf value of ``tree``, walked block by
        block on the device, gathered on the host."""
        meta = self.meta
        out = torch.empty(self.num_data, dtype=torch.float32)
        for i, (a, b) in enumerate(self._source.ranges):
            bins = torch.tensor(self._source.load_block(i),
                                device=self.device)
            h = self._ledger.hold_tensor("block_bins", bins)
            out[a:b] = tree_predict_binned(tree, bins, meta.nan_bin,
                                           meta.missing_type, meta.zero_bin,
                                           self._packed)
            self._ledger.release(h)
        return out

    def train_one_iter(self, custom_grad=None, custom_hess=None,
                       check_stop: bool = True) -> bool:
        if custom_grad is not None:
            log_fatal("streaming training does not support custom "
                      "objectives (fobj): gradients stream per block "
                      "from the built-in objective")
        return super().train_one_iter(check_stop=check_stop)


class StreamingDART(StreamingGBDT, DART):
    """Out-of-core DART: the drops' removal and restore on the host
    scores, through the recorded host leaf ids or block-by-block walks."""


def create_streaming_boosting(config: Config, train_set: BinnedDataset,
                              device: torch.device,
                              init_raw_scores=None) -> GBDT:
    """``create_boosting`` of the streaming trainer (a block-cache
    dataset, or ``stream_enable``)."""
    kind = config.boosting
    if kind in ("gbdt", "gbrt"):
        return StreamingGBDT(config, train_set, device, init_raw_scores)
    if kind == "dart":
        return StreamingDART(config, train_set, device, init_raw_scores)
    log_fatal(f"boosting={kind} is not supported by the streaming "
              "trainer (supported: gbdt, dart)")
