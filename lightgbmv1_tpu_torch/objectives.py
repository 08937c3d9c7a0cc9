"""Objectives: training gradients and output transforms.

Port of lightgbmv1_tpu/objectives.py for the ported paths, with
gradients on torch tensors of the training device:

* ``ObjectiveFunction`` (:54) and ``create_objective`` (:687);
* ``RegressionL2`` (:117, with ``reg_sqrt`` and the weighted
  ``average_label`` :106 as its init score; reference
  regression_objective.hpp);
* ``Binary`` (:278 gradients, :324 ``boost_from_score``; reference
  binary_objective.hpp);
* ``MulticlassSoftmax`` (:389: hessian factor K/(K-1), the log class
  prior as init score) and ``MulticlassOVA`` (:438; reference
  multiclass_objective.hpp), on (N, K) scores;
* ``LambdarankNDCG`` (:520-607) over the length-bucketed query layout
  ``_bucket_queries`` (:488; ``_pad_queries`` :467 is the flat one), with
  the JAX package's stable rank of tied scores (reference
  rank_objective.hpp);
* ``convert_output``, the output transform of every objective a loaded
  model can name, on host numpy float64 exactly as the JAX package
  computes it for a loaded model.

The other training objectives are not ported yet (ROADMAP queue 1,
breadth of objectives and boosting).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .config import BREADTH, Config, not_ported
from .io.dataset import Metadata
from .utils.log import log_fatal


def _sigmoid(raw, scale: float = 1.0):
    return 1.0 / (1.0 + np.exp(-scale * np.asarray(raw)))


def _softmax(raw):
    raw = np.asarray(raw)
    e = np.exp(raw - raw.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def convert_output(config: Config, raw):
    """Raw scores -> the objective's output space (binary: sigmoid with
    the model's ``sigmoid:`` parameter; multiclass: softmax; multiclassova:
    per-class sigmoid; cross-entropy: sigmoid; xentlambda: log1p(exp);
    poisson/gamma/tweedie: exp; every other objective: identity)."""
    name = config.objective
    if name == "regression" and config.reg_sqrt:
        raw = np.asarray(raw)
        return np.sign(raw) * raw * raw
    if name in ("binary", "multiclassova"):
        return _sigmoid(raw, config.sigmoid)
    if name == "multiclass":
        return _softmax(raw)
    if name == "cross_entropy":
        return _sigmoid(raw)
    if name == "cross_entropy_lambda":
        return np.log1p(np.exp(np.asarray(raw)))
    if name in ("poisson", "gamma", "tweedie"):
        return np.exp(raw)
    return raw


class ObjectiveFunction:
    """Base class: ``init`` puts the labels (and weights) on ``device``;
    subclasses define the elementwise ``_grad_hess``."""

    name = "custom"

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        if metadata.label is None:
            log_fatal(f"Label is required for objective {self.name}")
        self.label = torch.as_tensor(
            np.asarray(metadata.label, np.float32), device=device)
        self.weight = (torch.as_tensor(np.asarray(metadata.weight,
                                                  np.float32), device=device)
                       if metadata.weight is not None else None)
        self.num_data = num_data
        self._np_label = np.asarray(metadata.label, dtype=np.float64)
        self._np_weight = (np.asarray(metadata.weight, dtype=np.float64)
                           if metadata.weight is not None else None)

    def _grad_hess(self, score: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        grad, hess = self._grad_hess(score)
        if self.weight is not None:
            w = self.weight if grad.ndim == 1 else self.weight[:, None]
            grad, hess = grad * w, hess * w
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, raw):
        return convert_output(self.config, raw)

    @property
    def average_label(self) -> float:
        if self._np_weight is None:
            return float(self._np_label.mean())
        return float(np.average(self._np_label, weights=self._np_weight))


class RegressionL2(ObjectiveFunction):
    """Squared error (reference regression_objective.hpp RegressionL2loss);
    ``reg_sqrt`` trains on sign(y) sqrt(|y|) and squares the output
    back."""

    name = "regression"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if self.config.reg_sqrt:
            t = np.sign(self._np_label) * np.sqrt(np.abs(self._np_label))
            self._np_label = t
            self.label = torch.as_tensor(t.astype(np.float32), device=device)

    def _grad_hess(self, s):
        return s - self.label, torch.ones_like(s)

    def boost_from_score(self, class_id=0):
        return self.average_label if self.config.boost_from_average else 0.0


class Binary(ObjectiveFunction):
    """Binary log loss (reference binary_objective.hpp)."""

    name = "binary"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        uniq = np.unique(self._np_label)
        if not np.all(np.isin(uniq, [0.0, 1.0])):
            log_fatal("[binary]: labels must be 0 or 1")
        npos = float((self._np_label == 1).sum())
        nneg = float((self._np_label != 1).sum())
        if metadata.weight is not None:
            # BoostFromScore is the WEIGHTED label mean
            # (binary_objective.hpp:136-153)
            w = np.asarray(metadata.weight, np.float64)
            pavg = float((w * (self._np_label == 1)).sum()
                         / max(w.sum(), 1e-20))
        else:
            pavg = npos / max(npos + nneg, 1)
        if self.config.is_unbalance and npos > 0 and nneg > 0:
            # binary_objective.hpp:60-80: weight the smaller class up
            if npos > nneg:
                self.pos_w, self.neg_w = 1.0, npos / nneg
            else:
                self.pos_w, self.neg_w = nneg / npos, 1.0
        else:
            self.pos_w = self.config.scale_pos_weight
            self.neg_w = 1.0
        self._pavg = min(max(pavg, 1e-15), 1 - 1e-15)

    def _grad_hess(self, s):
        sig = self.config.sigmoid
        y = self.label
        p = torch.sigmoid(sig * s)
        lw = torch.where(y > 0, self.pos_w, self.neg_w)
        grad = (p - y) * sig * lw
        hess = p * (1.0 - p) * sig * sig * lw
        return grad, hess

    def boost_from_score(self, class_id=0):
        if not self.config.boost_from_average:
            return 0.0
        # log(p / (1 - p)) / sigmoid (binary_objective.hpp BoostFromScore)
        return math.log(self._pavg / (1.0 - self._pavg)) / self.config.sigmoid


class MulticlassSoftmax(ObjectiveFunction):
    """Softmax over (N, K) scores (reference MulticlassSoftmax)."""

    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lbl = self._np_label.astype(np.int64)
        if (lbl < 0).any() or (lbl >= self.num_class).any():
            log_fatal("[multiclass]: label out of range [0, num_class)")
        self._onehot = torch.as_tensor(
            np.eye(self.num_class, dtype=np.float32)[lbl], device=device)
        # the weighted class priors (multiclass_objective.hpp:59-84)
        counts = np.bincount(lbl, weights=self._np_weight,
                             minlength=self.num_class).astype(np.float64)
        self._class_probs = counts / max(counts.sum(), 1e-15)

    def boost_from_score(self, class_id=0):
        # log of the class prior (multiclass_objective.hpp:155)
        if not self.config.boost_from_average:
            return 0.0
        return float(np.log(max(1e-15, self._class_probs[class_id])))

    def _grad_hess(self, s):
        p = torch.softmax(s, dim=-1)
        # the hessian factor K / (K - 1) (multiclass_objective.hpp:47)
        factor = self.num_class / (self.num_class - 1.0)
        return p - self._onehot, factor * p * (1.0 - p)


class MulticlassOVA(MulticlassSoftmax):
    """One binary sigmoid a class (reference MulticlassOVA)."""

    name = "multiclassova"

    def boost_from_score(self, class_id=0):
        # each class's binary log-odds (multiclass_objective.hpp:261-263)
        if not self.config.boost_from_average:
            return 0.0
        p = float(np.clip(self._class_probs[class_id], 1e-15, 1 - 1e-15))
        return float(np.log(p / (1.0 - p)) / self.config.sigmoid)

    def _grad_hess(self, s):
        sig = self.config.sigmoid
        p = torch.sigmoid(sig * s)
        return (p - self._onehot) * sig, p * (1.0 - p) * sig * sig


def _pad_queries(boundaries: np.ndarray):
    """Every query padded to the longest: (Q, Mmax) row indices and mask
    (the flat layout; lambdarank uses ``_bucket_queries``)."""
    sizes = np.diff(boundaries)
    qmax = int(sizes.max()) if len(sizes) else 1
    idx = np.zeros((len(sizes), qmax), dtype=np.int64)
    mask = np.zeros((len(sizes), qmax), dtype=bool)
    for qi, (b, e) in enumerate(zip(boundaries[:-1], boundaries[1:])):
        idx[qi, :e - b] = np.arange(b, e)
        mask[qi, :e - b] = True
    return idx, mask


# element budget of one chunk's (Qc, Mb, Mb) pairwise tensors; about 8 f32
# temporaries live at once, so a chunk stays under ~270 MB
_PAIRWISE_CHUNK_ELEMS = 1 << 23


def _bucket_queries(boundaries: np.ndarray):
    """Queries grouped by their length rounded up to a power of two (at
    least 8), each bucket padded to its own width and cut into chunks of
    at most ``_PAIRWISE_CHUNK_ELEMS`` pairs: a list of (row indices
    (Qc, Mb), mask (Qc, Mb), query ids (Qc,)) numpy triples."""
    sizes = np.diff(boundaries)
    if not len(sizes):
        return []
    widths = np.maximum(8, 1 << np.ceil(
        np.log2(np.maximum(sizes, 1))).astype(np.int64))
    out = []
    for w in np.unique(widths):
        qids = np.where(widths == w)[0]
        max_q = max(1, _PAIRWISE_CHUNK_ELEMS // int(w * w))
        for c in range(0, len(qids), max_q):
            chunk = qids[c:c + max_q]
            idx = np.zeros((len(chunk), int(w)), dtype=np.int64)
            mask = np.zeros((len(chunk), int(w)), dtype=bool)
            for r, qi in enumerate(chunk):
                b, e = boundaries[qi], boundaries[qi + 1]
                idx[r, :e - b] = np.arange(b, e)
                mask[r, :e - b] = True
            out.append((idx, mask, chunk))
    return out


class LambdarankNDCG(ObjectiveFunction):
    """Per-query pairwise lambdas weighted by |delta NDCG|, truncated at
    ``lambdarank_truncation_level``, optionally normalised
    (``lambdarank_norm``); row weights do not enter, as in the JAX
    package."""

    name = "lambdarank"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log_fatal("[lambdarank]: query data (group) is required")
        self.qb = np.asarray(metadata.query_boundaries, dtype=np.int64)
        gains = np.asarray(self.config.label_gain_or_default,
                           dtype=np.float64)
        lbl = self._np_label.astype(np.int64)
        if lbl.max() >= len(gains):
            log_fatal("[lambdarank]: label exceeds label_gain size")
        self._gain_of_row = torch.as_tensor(gains[lbl].astype(np.float32),
                                            device=device)
        # 1 / max DCG of each query at the truncation level
        trunc = self.config.lambdarank_truncation_level
        inv = np.zeros(len(self.qb) - 1, dtype=np.float64)
        for qi, (b, e) in enumerate(zip(self.qb[:-1], self.qb[1:])):
            g = np.sort(gains[lbl[b:e]])[::-1][:max(trunc, 1)]
            dcg = (g / np.log2(np.arange(2, len(g) + 2))).sum()
            inv[qi] = 1.0 / dcg if dcg > 0 else 0.0
        self._chunks = [
            (torch.as_tensor(idx, device=device),
             torch.as_tensor(mask, device=device),
             torch.as_tensor(inv[qids].astype(np.float32), device=device))
            for idx, mask, qids in _bucket_queries(self.qb)]
        self._sig = self.config.sigmoid
        self._norm = self.config.lambdarank_norm
        self._trunc = trunc

    def _chunk_grads(self, s, q_idx, q_mask, inv_dcg):
        """One chunk's lambdas and hessians, (Qc, Mb) in and out."""
        scores = torch.where(q_mask, s[q_idx],
                             torch.full((), float("-inf"), device=s.device))
        gains = self._gain_of_row[q_idx]
        # each doc's 0-based rank in its query by descending score; ties
        # (every score at iteration 0) keep row order, as jnp.argsort's
        # stable sort does, and the -inf padding ranks last
        order = torch.argsort(-scores, dim=1, stable=True)
        M = order.shape[1]
        ranks = torch.empty_like(order).scatter_(
            1, order, torch.arange(M, device=s.device).expand_as(order))
        discount = 1.0 / torch.log2(2.0 + ranks.to(torch.float32))
        discount = torch.where(ranks < self._trunc, discount,
                               torch.zeros_like(discount))
        sig = self._sig
        sd = scores[:, :, None] - scores[:, None, :]
        gd = gains[:, :, None] - gains[:, None, :]
        dd = (discount[:, :, None] - discount[:, None, :]).abs()
        pair_mask = (q_mask[:, :, None] & q_mask[:, None, :] & (gd > 0)
                     & ((discount[:, :, None] > 0)
                        | (discount[:, None, :] > 0)))
        delta = gd.abs() * dd * inv_dcg[:, None, None]
        p = torch.sigmoid(-sig * sd)                 # P(the pair misorders)
        zero = torch.zeros((), device=s.device)
        lam = torch.where(pair_mask, -sig * p * delta, zero)
        hes = torch.where(pair_mask, sig * sig * p * (1.0 - p) * delta, zero)
        grad_q = lam.sum(dim=2) - lam.sum(dim=1)     # winners up
        hess_q = hes.sum(dim=2) + hes.sum(dim=1)
        if self._norm:
            norm = lam.abs().sum(dim=(1, 2)) + 1e-10
            scale = torch.log2(1.0 + norm) / norm
            grad_q = grad_q * scale[:, None]
            hess_q = hess_q * scale[:, None]
        return grad_q, hess_q

    def get_gradients(self, s):
        grad = torch.zeros_like(s)
        hess = torch.zeros_like(s)
        for q_idx, q_mask, inv_dcg in self._chunks:
            grad_q, hess_q = self._chunk_grads(s, q_idx, q_mask, inv_dcg)
            rows = q_idx[q_mask]               # each row in one query once
            grad[rows] = grad_q[q_mask]
            hess[rows] = hess_q[q_mask]
        return grad, torch.clamp(hess, min=1e-20)


_OBJECTIVES = {"regression": RegressionL2, "binary": Binary,
               "multiclass": MulticlassSoftmax,
               "multiclassova": MulticlassOVA, "lambdarank": LambdarankNDCG}


def create_objective(config: Config) -> ObjectiveFunction:
    if config.objective not in _OBJECTIVES:
        raise not_ported(f"objective={config.objective}", BREADTH)
    return _OBJECTIVES[config.objective](config)
