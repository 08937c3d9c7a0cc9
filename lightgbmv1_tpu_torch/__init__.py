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
* training: ``train(params, Dataset(X, y))`` -> binning
  (``io/binning.py``) -> the boosting loop of ``models/gbdt.py`` (GBDT,
  GOSS, DART, RF; every objective and metric of the JAX package) -> the
  growers (``models/grower_wave.py``, ``models/grower.py``) -> the
  hand-written CUDA kernels (``ops/hist_cuda.py``, ``ops/fused_cuda.py``,
  ``ops/loop_cuda.py``, ``ops/scan_cuda.py``) -> v3 model text; with
  callbacks and early stopping (``callback.py``) and ``cv``;
* the model lifecycle: continued training (``init_model``), rollback,
  refit, checkpoints (``io/checkpoint.py``), ``finite_guard`` and custom
  objectives; Dataset input from data files (``io/parser.py``) and
  scipy sparse rows, with Exclusive Feature Bundling (``io/bundle.py``,
  K3's bundle leg on the card).

The package's names are the JAX package's (``__all__``); the sklearn
wrappers and the plotting functions raise ``NotImplementedError`` naming
their ROADMAP queue 1 item until they are ported.  Entry points run on
the card unless the caller passes ``device="cpu"``; without a card they
raise instead of falling back.
"""

from .config import SKLEARN, Config, not_ported
from .device import resolve_device
from .utils.log import LightGBMError, register_callback, set_verbosity

__version__ = "0.1.0"

_SKLEARN_AND_PLOTTING = (
    "LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker",
    "plot_importance", "plot_metric", "plot_split_value_histogram",
    "plot_tree", "create_tree_digraph")

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "LightGBMError",
           "cv", "early_stopping", "log_evaluation", "record_evaluation",
           "register_callback", "reset_parameter", "resolve_device",
           "set_verbosity", "train", "__version__",
           *_SKLEARN_AND_PLOTTING]


def _not_ported_entry(name: str):
    """A stand-in for the JAX package's ``name``: calling it raises
    ``NotImplementedError`` naming its ROADMAP item."""
    def entry(*args, **kwargs):
        raise not_ported(name, SKLEARN)

    entry.__name__ = entry.__qualname__ = name
    entry.__doc__ = (f"``{name}`` of the JAX package: not ported yet "
                     f"(ROADMAP queue 1, {SKLEARN}).")
    return entry


def __getattr__(name):
    if name in ("Booster", "Dataset"):
        from . import basic

        return getattr(basic, name)
    if name in ("train", "cv", "CVBooster"):
        from . import engine

        return getattr(engine, name)
    if name in ("early_stopping", "log_evaluation", "record_evaluation",
                "reset_parameter"):
        from . import callback

        return getattr(callback, name)
    if name in _SKLEARN_AND_PLOTTING:
        return _not_ported_entry(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
