"""The serving ``Booster``: a model loaded from v3 model text.

Port of the prediction half of lightgbmv1_tpu/basic.py's ``Booster``
(``predict`` :655-800): raw and converted scores, ``pred_leaf``,
``start_iteration``/``num_iteration`` slicing and ``average_output``.
``predict_method`` picks the walk with the JAX package's meaning:
``auto``/``host`` is the exact host walk (numpy ``HostTree``, float64 in
tree order), ``depthwise``/``pallas``/``fused`` go through the device
``BatchPredictor`` (models/predict.py), cached per (slice, method).
Training, ``update`` and the native C++ predictor come with later
slices (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config
from .device import DeviceLike, resolve_device
from .io.model_text import LoadedModel, model_from_string
from .models.tree import HostTree
from .objectives import convert_output

_DEVICE_METHODS = ("depthwise", "pallas", "fused", "scan")
_NOT_PORTED = {
    "pred_contrib": "predict(pred_contrib=True) (TreeSHAP)",
    "pred_early_stop": "prediction early stopping",
}


def _to_2d_numpy(data) -> np.ndarray:
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values                                     # pandas
    if hasattr(data, "toarray"):
        data = data.toarray()                                  # scipy sparse
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    return arr


class Booster:
    """A loaded model that predicts on ``device`` (default: the card;
    raises when there is none — pass ``device="cpu"`` for the CPU)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 device: DeviceLike = None):
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self._device_pred_cache: Dict[tuple, Any] = {}
        if model_file is not None:
            with open(model_file) as fh:
                model_str = fh.read()
        if model_str is None:
            raise TypeError("Need model_file or model_str (training comes "
                            "with a later slice of the port)")
        self._loaded: LoadedModel = model_from_string(model_str)
        cfg = {"objective": self._loaded.objective}
        if self._loaded.num_class > 1:
            cfg["num_class"] = self._loaded.num_class
        if "sigmoid" in self._loaded.objective_params:
            cfg["sigmoid"] = float(self._loaded.objective_params["sigmoid"])
        self.config = Config.from_dict({**cfg, **self.params})

    # ------------------------------------------------------------------
    def num_trees(self) -> int:
        return len(self._loaded.trees)

    def num_model_per_iteration(self) -> int:
        return self._loaded.num_tree_per_iteration

    def num_feature(self) -> int:
        return self._loaded.max_feature_idx + 1

    def _all_trees(self) -> List[HostTree]:
        return list(self._loaded.trees)

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, **kwargs) -> np.ndarray:
        """Prediction on raw features (reference basic.py:2816 /
        Predictor); ``kwargs`` override the ``predict_*`` params."""
        for key, what in _NOT_PORTED.items():
            if kwargs.get(key, self.params.get(key, False)):
                raise NotImplementedError(
                    f"{what} is not ported yet: ROADMAP queue 1")
        X = _to_2d_numpy(data)
        if X.shape[1] != self.num_feature():
            disable = bool(kwargs.get(
                "predict_disable_shape_check",
                self.params.get("predict_disable_shape_check", False)))
            if not disable:
                from .utils.log import log_fatal

                log_fatal(
                    f"The number of features in data ({X.shape[1]}) is not "
                    f"the same as it was in training data "
                    f"({self.num_feature()}).\nYou can set "
                    f"``predict_disable_shape_check=true`` to discard this "
                    f"error, but please be aware what you are doing.")
        trees = self._all_trees()
        K = self.num_model_per_iteration()
        if num_iteration is None or num_iteration < 0:
            num_iteration = len(trees) // K
        trees = trees[start_iteration * K:
                      (start_iteration + num_iteration) * K]
        n = X.shape[0]

        method = str(kwargs.get("predict_method",
                                self.params.get("predict_method", "auto")))
        if method == "native":
            raise NotImplementedError(
                "predict_method=native (the C++ bulk predictor) is not "
                "ported yet: ROADMAP queue 1")
        raw = None
        if method in _DEVICE_METHODS and trees:
            bp = self._device_predictor(trees, K, start_iteration, method,
                                        kwargs)
            if pred_leaf:
                return bp.predict_leaf(X)
            f64 = bool(kwargs.get(
                "predict_f64_scores",
                self.params.get("predict_f64_scores", False)))
            raw = np.asarray(bp.predict_raw(X, f64_exact=f64), np.float64)
        if pred_leaf:
            return np.stack([t.predict_leaf_index(X) for t in trees], axis=1)
        if raw is None:
            raw = np.zeros((n, K), dtype=np.float64)
            for i, t in enumerate(trees):
                raw[:, i % K] += t.predict(X)
        # the boost-from-average constant lives inside the leaf values
        if self._loaded.average_output and trees:
            raw = raw / (len(trees) // K)
        if raw_score:
            return raw[:, 0] if K == 1 else raw
        return np.asarray(convert_output(self.config,
                                         raw if K > 1 else raw[:, 0]))

    def _device_predictor(self, trees, K, start_iteration, method, kwargs):
        """Device engine (models/predict.BatchPredictor), cached per (slice
        start, tree count, method).  A predictor that cannot be built
        raises: there is no host fallback."""
        key = (start_iteration, len(trees), method)
        bp = self._device_pred_cache.get(key)
        if bp is not None:
            return bp
        from .models.predict import BatchPredictor

        def p(name, dflt):
            return kwargs.get(name, self.params.get(name, dflt))

        bp = BatchPredictor(
            trees, K, self.num_feature(), method=method,
            prebin=str(p("predict_prebin", "auto")),
            code_layout=str(p("predict_code_layout", "auto")),
            num_shards=int(p("predict_num_shards", 0)),
            bucket_min=int(p("predict_bucket_min", 256)),
            chunk_rows=int(p("predict_chunk_rows", 131072)),
            device=self.device)
        self._device_pred_cache[key] = bp
        return bp
