"""Output transforms of the objectives a loaded model can name.

Port of the ``convert_output`` half of lightgbmv1_tpu/objectives.py, on
host numpy float64 exactly as the JAX package computes it for a loaded
model (its ``Booster.predict`` converts the host-side f64 raw scores).
Gradients and boost-from-average come with the training slice.
"""

from __future__ import annotations

import numpy as np

from .config import Config


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
