"""lightgbmv1_tpu_torch — the PyTorch/CUDA port of lightgbmv1_tpu.

The JAX package (``lightgbmv1_tpu``) stays the reference; this package is
its counterpart for an NVIDIA Hopper card.  It imports ``torch`` and never
``jax``, and nothing of the JAX package: what it needs from there it keeps
as its own copy, under the same module path (``lightgbmv1_tpu/X`` ->
``lightgbmv1_tpu_torch/X``).

This slice ports the serving path: model text -> ``HostTree`` -> serving
binner and stacked tables -> the hand-written CUDA walk kernels
(``ops/predict_cuda.py``) -> ``BatchPredictor`` -> ``Booster.predict`` ->
``serve.Server``.  Entry points run on the card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""

from .device import resolve_device
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "LightGBMError", "resolve_device", "__version__"]


def __getattr__(name):
    if name == "Booster":
        from .basic import Booster

        return Booster
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
