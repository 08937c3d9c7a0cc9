"""lightgbmv1_tpu_torch — the PyTorch/CUDA port of lightgbmv1_tpu.

The JAX package (``lightgbmv1_tpu``) stays the reference; this package is
its counterpart for an NVIDIA Hopper card.  It imports ``torch`` and never
``jax``, and nothing of the JAX package: what it needs from there it keeps
as its own copy, under the same module path (``lightgbmv1_tpu/X`` ->
``lightgbmv1_tpu_torch/X``).

Ported so far:

* serving: model text -> ``HostTree`` -> serving binner and stacked
  tables -> the hand-written CUDA walk kernels (``ops/predict_cuda.py``)
  -> ``BatchPredictor`` -> ``Booster.predict`` -> ``serve.Server``;
* binary leaf-wise training: ``train(params, Dataset(X, y))`` -> binning
  (``io/binning.py``) -> the wave grower (``models/grower_wave.py``) ->
  the hand-written CUDA histogram kernel (``ops/hist_cuda.py``) -> v3
  model text; with callbacks and early stopping (``callback.py``) and
  ``cv``.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.
"""

from .device import resolve_device
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "CVBooster", "Dataset", "LightGBMError", "cv",
           "resolve_device", "train", "__version__"]


def __getattr__(name):
    if name in ("Booster", "Dataset"):
        from . import basic

        return getattr(basic, name)
    if name in ("train", "cv", "CVBooster"):
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
