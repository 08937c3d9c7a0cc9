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
  objectives; Dataset input from data files (``io/parser.py``, the
  native C++ parser first) and scipy sparse rows, with Exclusive Feature
  Bundling (``io/bundle.py``, K3's bundle leg on the card), and the
  binned dataset cache (``Dataset.save_binary``);
* the host prediction paths: the native C++ bulk predictor
  (``native/``), TreeSHAP (``models/treeshap.py``) and prediction early
  stopping; the CLI (``python -m lightgbmv1_tpu_torch task=train|predict|
  refit|convert_model``, ``cli.py``); the sklearn wrappers
  (``sklearn.py``) and the plotting functions (``plotting.py``).

The package's names are the JAX package's (``__all__``).  Entry points
run on the card unless the caller passes ``device="cpu"`` (the CLI and
the sklearn wrappers: ``device_type=cpu``); without a card they raise
instead of falling back.
"""

from .config import Config
from .device import resolve_device
from .utils.log import LightGBMError, register_callback, set_verbosity

__version__ = "0.1.0"

_SKLEARN = ("LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker")
_PLOTTING = ("plot_importance", "plot_metric", "plot_split_value_histogram",
             "plot_tree", "create_tree_digraph")

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "LightGBMError",
           "cv", "early_stopping", "log_evaluation", "record_evaluation",
           "register_callback", "reset_parameter", "resolve_device",
           "set_verbosity", "train", "__version__", *_SKLEARN, *_PLOTTING]


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
    if name in _SKLEARN:
        from . import sklearn

        return getattr(sklearn, name)
    if name in _PLOTTING:
        from . import plotting

        return getattr(plotting, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
