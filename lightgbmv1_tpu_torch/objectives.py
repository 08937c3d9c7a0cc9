"""Objectives: training gradients and output transforms.

Port of lightgbmv1_tpu/objectives.py, with gradients on torch tensors of
the training device:

* ``ObjectiveFunction`` (:54) and ``create_objective`` (:687);
* the regression family: ``RegressionL2`` (:117, with ``reg_sqrt`` and
  the weighted ``average_label`` :106 as its init score), ``RegressionL1``
  (:141), ``Huber`` (:154), ``Fair`` (:167), ``Poisson`` (:178),
  ``Quantile`` (:197), ``Mape`` (:216), ``Gamma`` (:241) and ``Tweedie``
  (:255), with the weighted quantile ``_np_weighted_quantile`` (:39) as
  the L1, quantile and mape init scores; L1, quantile and mape renew
  their leaves after a tree is grown (``renew_percentile`` /
  ``renew_weights``, models/gbdt.py; reference regression_objective.hpp);
* ``Binary`` (:278 gradients, :324 ``boost_from_score``; reference
  binary_objective.hpp), ``CrossEntropy`` (:336) and
  ``CrossEntropyLambda`` (:358; reference xentropy_objective.hpp);
* ``MulticlassSoftmax`` (:389: hessian factor K/(K-1), the log class
  prior as init score) and ``MulticlassOVA`` (:438; reference
  multiclass_objective.hpp), on (N, K) scores;
* ``LambdarankNDCG`` (:520-607) over the length-bucketed query layout
  ``_bucket_queries`` (:488), with the JAX package's stable rank of tied
  scores, and ``RankXENDCG`` (:609) over the flat layout ``_pad_queries``
  (:467), its ``gamma`` drawn each iteration from the JAX package's
  ``fold_in(PRNGKey(objective_seed), iteration)`` uniforms (utils/prng.py;
  reference rank_objective.hpp);
* ``convert_output``, the output transform of every objective a loaded
  model can name, on host numpy float64 exactly as the JAX package
  computes it for a loaded model.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .io.dataset import Metadata
from .utils.log import log_fatal
from .utils.prng import fold_in, prng_key, uniform_1d


def _np_weighted_quantile(values: np.ndarray,
                          weights: Optional[np.ndarray], q: float) -> float:
    """The weighted ``q`` quantile of the labels (JAX objectives.py:39;
    reference PercentileFun / WeightedPercentileFun): the ``lower``
    percentile unweighted, else the first sorted value whose cumulative
    weight reaches ``q`` of the total."""
    values = np.asarray(values, dtype=np.float64)
    if weights is None:
        return float(np.percentile(values, q * 100, method="lower")
                     if len(values) else 0.0)
    order = np.argsort(values)
    v, w = values[order], np.asarray(weights, dtype=np.float64)[order]
    cw = np.cumsum(w)
    idx = int(np.searchsorted(cw, q * cw[-1], side="left"))
    return float(v[min(idx, len(v) - 1)])


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
    # not None: the leaves are renewed to this quantile of the residuals
    # after each tree (reference RenewTreeOutput)
    renew_percentile: Optional[float] = None
    # get_gradients takes the iteration (rank_xendcg's draw)
    is_stochastic = False

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

    def renew_weights(self) -> Optional[np.ndarray]:
        """The row weights of the leaf renewal (mape overrides)."""
        return self._np_weight

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


class RegressionL1(ObjectiveFunction):
    """Absolute error: sign gradients, leaves renewed to the residuals'
    weighted median (reference RegressionL1loss)."""

    name = "regression_l1"
    renew_percentile = 0.5

    def _grad_hess(self, s):
        return torch.sign(s - self.label), torch.ones_like(s)

    def boost_from_score(self, class_id=0):
        if not self.config.boost_from_average:
            return 0.0
        return _np_weighted_quantile(self._np_label, self._np_weight, 0.5)


class Huber(ObjectiveFunction):
    """Huber loss: the residual clipped to +-alpha (reference
    RegressionHuberLoss)."""

    name = "huber"

    def _grad_hess(self, s):
        a = self.config.alpha
        return torch.clamp(s - self.label, -a, a), torch.ones_like(s)

    def boost_from_score(self, class_id=0):
        return self.average_label if self.config.boost_from_average else 0.0


class Fair(ObjectiveFunction):
    """Fair loss with ``fair_c`` (reference RegressionFairLoss)."""

    name = "fair"

    def _grad_hess(self, s):
        c = self.config.fair_c
        d = s - self.label
        grad = c * d / (torch.abs(d) + c)
        hess = c * c / (torch.abs(d) + c) ** 2
        return grad, hess


class Poisson(ObjectiveFunction):
    """Poisson regression on the log scale, the hessian scaled by
    exp(``poisson_max_delta_step``) (reference RegressionPoissonLoss)."""

    name = "poisson"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if (self._np_label < 0).any():
            log_fatal("[poisson]: labels must be non-negative")

    def _grad_hess(self, s):
        es = torch.exp(s)
        return es - self.label, es * math.exp(
            self.config.poisson_max_delta_step)

    def boost_from_score(self, class_id=0):
        return math.log(max(self.average_label, 1e-20))


class Quantile(ObjectiveFunction):
    """Pinball loss at ``alpha``, leaves renewed to that quantile of the
    residuals (reference RegressionQuantileloss)."""

    name = "quantile"

    @property
    def renew_percentile(self):
        return self.config.alpha

    def _grad_hess(self, s):
        a = self.config.alpha
        d = s - self.label
        grad = torch.where(d >= 0, torch.full_like(s, 1.0 - a),
                           torch.full_like(s, -a))
        return grad, torch.ones_like(s)

    def boost_from_score(self, class_id=0):
        if not self.config.boost_from_average:
            return 0.0
        return _np_weighted_quantile(self._np_label, self._np_weight,
                                     self.config.alpha)


class Mape(ObjectiveFunction):
    """Absolute percentage error: each row weighted 1 / max(|y|, 1) (times
    its weight), leaves renewed to the weighted median (reference
    RegressionMAPELOSS)."""

    name = "mape"
    renew_percentile = 0.5

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        self._label_weight = 1.0 / np.maximum(np.abs(self._np_label), 1.0)
        if self._np_weight is not None:
            self._label_weight = self._label_weight * self._np_weight
        self._t_label_weight = torch.as_tensor(
            self._label_weight.astype(np.float32), device=device)

    def get_gradients(self, s):
        grad = torch.sign(s - self.label) * self._t_label_weight
        return grad, self._t_label_weight.clone()

    def renew_weights(self):
        return self._label_weight

    def boost_from_score(self, class_id=0):
        if not self.config.boost_from_average:
            return 0.0
        return _np_weighted_quantile(self._np_label, self._label_weight, 0.5)


class Gamma(Poisson):
    """Gamma regression on the log scale (reference RegressionGammaLoss)."""

    name = "gamma"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        ObjectiveFunction.init(self, metadata, num_data, device)
        if (self._np_label <= 0).any():
            log_fatal("[gamma]: labels must be positive")

    def _grad_hess(self, s):
        e = torch.exp(-s)
        return 1.0 - self.label * e, self.label * e


class Tweedie(Poisson):
    """Tweedie regression with ``tweedie_variance_power`` (reference
    RegressionTweedieLoss)."""

    name = "tweedie"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        ObjectiveFunction.init(self, metadata, num_data, device)
        if (self._np_label < 0).any():
            log_fatal("[tweedie]: labels must be non-negative")

    def _grad_hess(self, s):
        rho = self.config.tweedie_variance_power
        y = self.label
        e1 = torch.exp((1.0 - rho) * s)
        e2 = torch.exp((2.0 - rho) * s)
        grad = -y * e1 + e2
        hess = -y * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return grad, hess


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


class CrossEntropy(ObjectiveFunction):
    """Cross-entropy on labels in [0, 1] (reference CrossEntropy)."""

    name = "cross_entropy"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if ((self._np_label < 0) | (self._np_label > 1)).any():
            log_fatal("[cross_entropy]: labels must be in [0, 1]")

    def _grad_hess(self, s):
        p = torch.sigmoid(s)
        return p - self.label, p * (1.0 - p)

    def boost_from_score(self, class_id=0):
        p = min(max(self.average_label, 1e-15), 1 - 1e-15)
        return math.log(p / (1 - p))


class CrossEntropyLambda(ObjectiveFunction):
    """The intensity parameterization z = log1p(exp(s)) of cross-entropy
    with the JAX package's gradient and its positive hessian surrogate
    (reference xentropy_objective.hpp:148)."""

    name = "cross_entropy_lambda"

    def _grad_hess(self, s):
        y = self.label
        es = torch.exp(s)
        z = torch.log1p(es)
        enz = torch.exp(-z)
        grad = es / (1.0 + es) * (
            1.0 - y / torch.clamp(z, min=1e-20) * (1 - enz)
            / torch.clamp(1 - enz + z * enz, min=1e-20))
        hess = es / (1.0 + es) ** 2 + 1e-6
        return grad, hess

    def boost_from_score(self, class_id=0):
        p = min(max(self.average_label, 1e-15), 1 - 1e-15)
        return math.log(math.expm1(p)) if p > 1e-10 else math.log(p)


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


class RankXENDCG(ObjectiveFunction):
    """The cross-entropy NDCG surrogate (reference rank_objective.hpp:288):
    each document's target 2^trunc(label) - gamma with gamma ~ U(0, 1)
    drawn anew each iteration, ``uniform(fold_in(PRNGKey(objective_seed),
    iteration), (N,))``, as the JAX package draws it; softmax over each
    query's scores."""

    name = "rank_xendcg"
    is_stochastic = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log_fatal("[rank_xendcg]: query data (group) is required")
        self.qb = np.asarray(metadata.query_boundaries, dtype=np.int64)
        idx, mask = _pad_queries(self.qb)
        self.q_idx = torch.as_tensor(idx, device=device)
        self.q_mask = torch.as_tensor(mask, device=device)
        self._pow2 = torch.as_tensor(
            np.power(2.0, np.trunc(self._np_label)).astype(np.float32),
            device=device)
        self._seed_key = prng_key(self.config.objective_seed)
        self._host_iter = 0

    def get_gradients(self, s, iteration: Optional[int] = None):
        if iteration is None:        # a caller without an iteration count
            iteration = self._host_iter
            self._host_iter += 1
        gamma = uniform_1d(fold_in(self._seed_key, int(iteration)),
                           s.shape[0], s.device)
        phi_doc = self._pow2 - gamma
        q_idx, q_mask = self.q_idx, self.q_mask
        scores = torch.where(q_mask, s[q_idx],
                             torch.full((), float("-inf"), device=s.device))
        phi = torch.where(q_mask, phi_doc[q_idx],
                          torch.zeros((), device=s.device))
        rho = torch.softmax(scores, dim=1)
        phi_sum = phi.sum(dim=1, keepdim=True)
        l1 = torch.where(phi_sum > 0, phi / torch.clamp(phi_sum, min=1e-20),
                         torch.zeros((), device=s.device))
        grad_q = rho - l1
        hess_q = rho * (1.0 - rho)
        grad = torch.zeros_like(s)
        hess = torch.zeros_like(s)
        rows = q_idx[q_mask]                   # each row in one query once
        grad[rows] = grad_q[q_mask]
        hess[rows] = hess_q[q_mask]
        return grad, torch.clamp(hess, min=1e-20)


_OBJECTIVES = {
    "regression": RegressionL2, "regression_l1": RegressionL1,
    "huber": Huber, "fair": Fair, "poisson": Poisson, "quantile": Quantile,
    "mape": Mape, "gamma": Gamma, "tweedie": Tweedie, "binary": Binary,
    "multiclass": MulticlassSoftmax, "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG, "rank_xendcg": RankXENDCG}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """The objective of ``config.objective`` (JAX :687); an unknown name
    is fatal, as there.  The objective-less names (``none``, ``custom``,
    ...) give None: a custom objective (``fobj``) supplies the
    gradients."""
    if config.objective in ("none", "null", "custom", "na"):
        return None
    if config.objective not in _OBJECTIVES:
        log_fatal(f"Unknown objective: {config.objective}")
    return _OBJECTIVES[config.objective](config)
