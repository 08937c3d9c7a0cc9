"""Objectives: training gradients and output transforms.

Port of lightgbmv1_tpu/objectives.py for the ported paths:

* ``ObjectiveFunction`` (:54), ``Binary`` (:278 gradients, :324
  ``boost_from_score``) and ``create_objective`` (:687), with gradients on
  torch tensors of the training device (reference binary_objective.hpp);
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
            grad, hess = grad * self.weight, hess * self.weight
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, raw):
        return convert_output(self.config, raw)


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


def create_objective(config: Config) -> ObjectiveFunction:
    if config.objective != "binary":
        raise not_ported(f"objective={config.objective}", BREADTH)
    return Binary(config)
