"""``Dataset`` and ``Booster``: the lightgbm-compatible API of the port.

Port of lightgbmv1_tpu/basic.py for the ported paths:

* ``Dataset`` (:107, ``construct`` :250): lazy binning of a dense
  numeric matrix with its query groups, a valid set sharing its
  reference's bins (``create_valid`` :326) and taking its own groups;
  the setters ``set_label`` / ``set_weight`` / ``set_group`` /
  ``set_init_score`` / ``set_field`` (:333-365), which reach a
  constructed set's metadata without binning it again;
* ``Dataset.subset`` (:396), ``get_label`` / ``get_field`` and their
  kin, which ``engine.cv`` reads;
* ``Booster(params, train_set=...)`` (:430) over the trainer of
  ``models/gbdt.create_boosting`` (GBDT, GOSS, DART, RF) with ``update``
  (:541), ``reset_parameter`` (:611, a new knob reaching the next tree),
  ``eval_train`` / ``eval_valid`` with ``feval`` (:618-640),
  ``model_to_string`` (:947, through io/model_text.model_to_string),
  ``save_model`` (:1001), ``dump_model`` (:1115), ``feature_importance``
  (:1137) and ``feature_name`` (:606); ``best_iteration`` (set by early
  stopping) is what ``predict``, ``model_to_string`` and ``save_model``
  default to (:704, :952);
* the serving half (``predict`` :655-800) for a loaded model and for a
  trained one: raw and converted scores, ``pred_leaf``,
  ``start_iteration`` / ``num_iteration`` slicing and ``average_output``
  (a loaded RF model's, or a trained RF's: :789-790, :964).
  ``predict_method`` picks the walk with the JAX package's meaning:
  ``auto``/``host`` is the exact host walk (numpy ``HostTree``, float64 in
  tree order), ``depthwise``/``pallas``/``fused`` go through the device
  ``BatchPredictor`` (models/predict.py), cached per (slice, method).

Training and prediction run on ``device`` (default: the card; without one
they raise — pass ``device="cpu"`` for the CPU).  Every other public name
of the JAX ``Dataset`` and ``Booster`` raises ``NotImplementedError``
naming its ROADMAP queue 1 item: files, sparse input, categorical
features and custom objectives (item 1), rollback, refit and checkpoints
(item 1, part 1.4), the native C++ predictor, TreeSHAP, the binary
dataset cache (CLI), the drift captures and the block caches (parallel
learners).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .config import (BREADTH, CLI, DRIFT, NATIVE, PARALLEL, TREESHAP,
                     Config, not_ported)
from .device import DeviceLike, resolve_device
from .io.dataset import BinnedDataset
from .io.model_text import (LoadedModel, dump_model_dict, model_from_string,
                            model_to_string)
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


def _objective_string(config: Config) -> str:
    """The model file's objective line (JAX basic.py:85-104; reference
    gbdt.cpp ObjectiveName and each objective's ToString): 'binary
    sigmoid:1', 'multiclass num_class:5', 'multiclassova num_class:5
    sigmoid:1', 'quantile alpha:0.9', 'huber alpha:0.9', 'fair c:1',
    'tweedie tweedie_variance_power:1.5', else the objective's name."""
    obj = config.objective
    if obj == "binary":
        return f"binary sigmoid:{config.sigmoid:g}"
    if obj in ("multiclass", "multiclassova"):
        extra = (f" sigmoid:{config.sigmoid:g}" if obj == "multiclassova"
                 else "")
        return f"{obj} num_class:{config.num_class}{extra}"
    if obj in ("quantile", "huber"):
        return f"{obj} alpha:{config.alpha:g}"
    if obj == "fair":
        return f"fair c:{config.fair_c:g}"
    if obj == "tweedie":
        return ("tweedie tweedie_variance_power:"
                f"{config.tweedie_variance_power:g}")
    return obj


class Dataset:
    """Training or valid data with lazy binning (reference basic.py:909).
    ``data`` is a dense numeric (rows, features) array; ``group`` the
    query sizes of a ranking set, in row order."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto",
                 categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = False):
        if isinstance(data, (str, bytes)) or hasattr(data, "__fspath__"):
            raise not_ported("loading a Dataset from a file", BREADTH)
        if type(data).__module__.split(".")[0] == "scipy":
            raise not_ported("sparse Dataset input", BREADTH)
        if categorical_feature not in ("auto", None, [], ()):
            raise not_ported("categorical features", BREADTH)
        self.params = dict(params or {})
        self.reference = reference
        self.free_raw_data = free_raw_data
        self.feature_name = feature_name
        self._binned: Optional[BinnedDataset] = None
        self.data = _to_2d_numpy(data) if data is not None else None
        self.label = (None if label is None
                      else np.asarray(label, dtype=np.float64).ravel())
        self.weight = (None if weight is None
                       else np.asarray(weight, dtype=np.float64).ravel())
        self.init_score = (None if init_score is None
                           else np.asarray(init_score, dtype=np.float64))
        self.group = (None if group is None
                      else np.asarray(group, dtype=np.int64).ravel())

    def set_group(self, group) -> "Dataset":
        """The query sizes of a ranking set (reference basic.py
        set_group); a constructed set takes them too."""
        self.group = (None if group is None
                      else np.asarray(group, dtype=np.int64).ravel())
        if self._binned is not None:
            self._binned.metadata.set_group(self.group)
        return self

    @classmethod
    def from_binned(cls, binned, params=None) -> "Dataset":
        """A Dataset over an already binned set (JAX :240, the distributed
        loader's shards): not ported."""
        raise not_ported("Dataset.from_binned (process-sharded data)",
                         PARALLEL)

    def save_binary(self, filename) -> "Dataset":
        """The binned dataset cache (JAX :303): not ported."""
        raise not_ported("Dataset.save_binary (the binary dataset cache)",
                         CLI)

    def save_block_cache(self, path, block_rows=None) -> "Dataset":
        """The out-of-core block cache (JAX :310): not ported."""
        raise not_ported("Dataset.save_block_cache (the out-of-core block "
                         "cache)", PARALLEL)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A valid set binned with this set's bins (JAX :326)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    def set_label(self, label) -> "Dataset":
        """New labels (JAX :333); a constructed set takes them without
        binning again."""
        self.label = np.asarray(label, dtype=np.float64).ravel()
        if self._binned is not None:
            self._binned.metadata.label = self.label.astype(np.float32)
        return self

    def set_weight(self, weight) -> "Dataset":
        """New row weights, or None (JAX :339)."""
        self.weight = (None if weight is None
                       else np.asarray(weight, dtype=np.float64).ravel())
        if self._binned is not None:
            self._binned.metadata.weight = (
                None if weight is None else self.weight.astype(np.float32))
        return self

    def set_init_score(self, init_score) -> "Dataset":
        """New init scores, or None (JAX :352)."""
        self.init_score = (None if init_score is None
                           else np.asarray(init_score, np.float64))
        if self._binned is not None:
            self._binned.metadata.init_score = self.init_score
        return self

    def set_field(self, field_name: str, data) -> "Dataset":
        """``set_<field_name>(data)`` (JAX :358)."""
        return {"label": self.set_label, "weight": self.set_weight,
                "group": self.set_group,
                "init_score": self.set_init_score}[field_name](data)

    def construct(self) -> "Dataset":
        if self._binned is not None:
            return self
        if self.data is None:
            raise ValueError("Cannot construct Dataset: raw data was freed")
        ref = (self.reference.construct()._binned
               if self.reference is not None else None)
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple)) else None)
        self._binned = BinnedDataset.from_numpy(
            self.data, label=self.label, weight=self.weight,
            init_score=self.init_score, group=self.group,
            config=Config.from_dict(self.params),
            feature_names=names, reference=ref)
        if self.free_raw_data:
            self.data = None
        return self

    def num_data(self) -> int:
        if self._binned is not None:
            return self._binned.num_data
        return 0 if self.data is None else self.data.shape[0]

    def num_feature(self) -> int:
        if self._binned is not None:
            return self._binned.num_features
        return 0 if self.data is None else self.data.shape[1]

    def get_field(self, field_name: str):
        return {"label": self.label, "weight": self.weight,
                "group": self.group,
                "init_score": self.init_score}[field_name]

    def get_label(self):
        return self.label

    def get_weight(self):
        return self.weight

    def get_group(self):
        return self.group

    def get_init_score(self):
        return self.init_score

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` as a Dataset binned with this set's
        bins (JAX :396; ``engine.cv``'s folds)."""
        if self.data is None:
            raise ValueError("Cannot subset: raw data was freed")
        idx = np.asarray(used_indices)
        return Dataset(
            self.data[idx],
            label=None if self.label is None else self.label[idx],
            weight=None if self.weight is None else self.weight[idx],
            init_score=(None if self.init_score is None
                        else self.init_score[idx]),
            params=params or self.params, reference=self,
            feature_name=self.feature_name)


class Booster:
    """A model that trains and predicts on ``device`` (default: the card;
    raises when there is none — pass ``device="cpu"`` for the CPU): from
    ``train_set`` (training), or loaded from ``model_file`` /
    ``model_str``."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 device: DeviceLike = None):
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_data_name = "training"
        self._device_pred_cache: Dict[tuple, Any] = {}
        self._gbdt = None
        self._loaded: Optional[LoadedModel] = None
        self._name_valid_sets: List[str] = []
        self._valid_data: List[Dataset] = []
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("train_set must be a Dataset")
            from .models.gbdt import create_boosting

            train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            self.train_set = train_set
            self.config = Config.from_dict(self.params)
            self._gbdt = create_boosting(self.config, train_set._binned,
                                         self.device)
            return
        if model_file is not None:
            with open(model_file) as fh:
                model_str = fh.read()
        if model_str is None:
            raise TypeError("Need at least one of train_set, model_file, "
                            "model_str")
        self._loaded = model_from_string(model_str)
        cfg = {"objective": self._loaded.objective}
        if self._loaded.num_class > 1:
            cfg["num_class"] = self._loaded.num_class
        if "sigmoid" in self._loaded.objective_params:
            cfg["sigmoid"] = float(self._loaded.objective_params["sigmoid"])
        self.config = Config.from_dict({**cfg, **self.params})

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if self._gbdt is None:
            raise RuntimeError("Cannot add validation data to a loaded "
                               "model")
        if data.reference is None and data._binned is None:
            data.reference = self.train_set
        data.construct()
        self._gbdt.add_valid(data._binned, name)
        self._name_valid_sets.append(name)
        self._valid_data.append(data)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True when no further split is possible
        (reference basic.py:2315)."""
        if self._gbdt is None:
            raise RuntimeError("Cannot update a loaded model")
        if train_set is not None:
            raise ValueError("Resetting train_set is not supported")
        if fobj is not None:
            raise not_ported("custom objectives (fobj)", BREADTH)
        return self._gbdt.train_one_iter()

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """New values of knobs mid-training (JAX :611): the next tree
        trains under them (``GBDT.reset_config``)."""
        self.params.update(params)
        if self._gbdt is not None:
            self._gbdt.reset_config(params)
        return self

    def eval_train(self, feval=None):
        """The training set's metrics (and ``feval``'s) on its current
        scores, each ``(data name, metric, value, higher is better)``."""
        out = [("training",) + tuple(r[1:]) for r in self._gbdt.eval_train()]
        return self._add_feval(out, feval, "training",
                               self._gbdt.raw_train_scores(), self.train_set)

    def eval_valid(self, feval=None):
        """Each valid set's metrics (and ``feval``'s, JAX :623)."""
        out = list(self._gbdt.eval_valid())
        if feval is not None:
            for i, name in enumerate(self._name_valid_sets):
                out = self._add_feval(out, feval, name,
                                      self._gbdt.raw_valid_scores(i),
                                      self._valid_data[i])
        return out

    @staticmethod
    def _add_feval(out, feval, name, raw_scores, dataset):
        """``feval(preds, dataset)`` -> (metric, value, higher is better)
        or a list of them, on the raw scores ((N,) for one class)."""
        if feval is None:
            return out
        fevals = feval if isinstance(feval, (list, tuple)) else [feval]
        preds = raw_scores[:, 0] if raw_scores.shape[1] == 1 else raw_scores
        for f in fevals:
            res = f(preds, dataset)
            if isinstance(res, tuple):
                res = [res]
            for metric_name, value, hb in res:
                out.append((name, metric_name, value, hb))
        return out

    def _default_iterations(self, num_iteration, n_trees) -> int:
        """``num_iteration`` None or < 0: the best iteration where early
        stopping set one, else every iteration (JAX :704, :952)."""
        if num_iteration is None or num_iteration < 0:
            if self.best_iteration and self.best_iteration > 0:
                return self.best_iteration
            return n_trees // self.num_model_per_iteration()
        return num_iteration

    def current_iteration(self) -> int:
        if self._gbdt is not None:
            return self._gbdt.iter
        return self._loaded.num_iterations

    # ------------------------------------------------------------------
    def num_trees(self) -> int:
        return len(self._all_trees())

    def num_model_per_iteration(self) -> int:
        if self._gbdt is not None:
            return self._gbdt.num_class
        return self._loaded.num_tree_per_iteration

    def num_feature(self) -> int:
        if self._gbdt is not None:
            return self._gbdt.train_set.num_features
        return self._loaded.max_feature_idx + 1

    def _all_trees(self) -> List[HostTree]:
        if self._gbdt is not None:
            return list(self._gbdt.materialize_host_trees())
        return list(self._loaded.trees)

    def feature_name(self) -> List[str]:
        """The feature names (JAX :606)."""
        if self._gbdt is not None:
            return list(self._gbdt.train_set.feature_names)
        return list(self._loaded.feature_names)

    def _average_output(self) -> bool:
        """A random forest averages its trees: a loaded model that says
        so, or a trained RF (JAX :789-790)."""
        if self._gbdt is not None:
            from .models.gbdt import RF

            return isinstance(self._gbdt, RF)
        return self._loaded.average_output

    # ------------------------------------------------------------------
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        """v3 model text (reference GBDT::SaveModelToString), by default
        up to ``best_iteration``."""
        trees = self._all_trees()
        K = self.num_model_per_iteration()
        num_iteration = self._default_iterations(num_iteration, len(trees))
        trees = trees[start_iteration * K:
                      (start_iteration + num_iteration) * K]
        if self._gbdt is not None:
            cfg = self.config
            ds = self._gbdt.train_set
            return model_to_string(
                trees, objective_string=_objective_string(cfg),
                num_class=cfg.num_class, num_tree_per_iteration=K,
                feature_names=list(ds.feature_names),
                feature_infos=ds.feature_infos(),
                average_output=self._average_output(),
                parameters={
                    "boosting": cfg.boosting, "objective": cfg.objective,
                    "metric": ",".join(cfg.metric),
                    "learning_rate": cfg.learning_rate,
                    "num_leaves": cfg.num_leaves,
                    "max_depth": cfg.max_depth,
                    "min_data_in_leaf": cfg.min_data_in_leaf,
                    "min_sum_hessian_in_leaf": cfg.min_sum_hessian_in_leaf,
                    "bagging_fraction": cfg.bagging_fraction,
                    "bagging_freq": cfg.bagging_freq,
                    "feature_fraction": cfg.feature_fraction,
                    "lambda_l1": cfg.lambda_l1, "lambda_l2": cfg.lambda_l2,
                    "max_bin": cfg.max_bin, "seed": cfg.seed})
        lm = self._loaded
        return model_to_string(
            trees, objective_string=lm.objective + "".join(
                f" {k}:{v}" for k, v in lm.objective_params.items()),
            num_class=lm.num_class, num_tree_per_iteration=K,
            feature_names=lm.feature_names, feature_infos=lm.feature_infos,
            average_output=lm.average_output, parameters=lm.parameters)

    def save_model(self, filename, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        text = self.model_to_string(num_iteration, start_iteration)
        with open(filename, "w") as fh:
            fh.write(text)
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> Dict:
        """The model as a JSON-ready dict (JAX :1115; reference
        GBDT::DumpModel), every iteration by default."""
        trees = self._all_trees()
        K = self.num_model_per_iteration()
        if num_iteration is None or num_iteration < 0:
            num_iteration = len(trees) // K
        trees = trees[start_iteration * K:
                      (start_iteration + num_iteration) * K]
        if self._gbdt is not None:
            ds = self._gbdt.train_set
            names, infos = list(ds.feature_names), ds.feature_infos()
            objective_string = _objective_string(self.config)
            num_class = self.config.num_class
        else:
            names = self._loaded.feature_names
            infos = self._loaded.feature_infos
            objective_string = self._loaded.objective
            num_class = self._loaded.num_class
        return dump_model_dict(
            trees, objective_string=objective_string, num_class=num_class,
            num_tree_per_iteration=K, feature_names=names,
            feature_infos=infos)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Each feature's split count (int64) or, for any other
        ``importance_type``, its total split gain (float64) over the
        trees of the first ``iteration`` iterations (every tree by
        default; JAX :1137)."""
        trees = self._all_trees()
        if iteration is not None and iteration >= 0:
            trees = trees[:iteration * self.num_model_per_iteration()]
        out = np.zeros(self.num_feature(), dtype=np.float64)
        for t in trees:
            for i in range(t.num_leaves - 1):
                out[t.split_feature[i]] += (
                    1 if importance_type == "split" else t.split_gain[i])
        if importance_type == "split":
            return out.astype(np.int64)
        return out

    def __copy__(self):
        return self

    def free_dataset(self) -> "Booster":
        """A no-op, as in the JAX package (:1159)."""
        return self

    def free_network(self) -> "Booster":
        """A no-op, as in the JAX package (:1162): the port trains on one
        card."""
        return self

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration (JAX :575): not ported."""
        raise not_ported("Booster.rollback_one_iter", BREADTH)

    def refit(self, data, label, decay_rate: float = 0.9) -> "Booster":
        """Refit the leaves on new data (JAX :865): not ported."""
        raise not_ported("Booster.refit", BREADTH)

    def save_checkpoint(self, path, write_file: bool = True,
                        with_reference: bool = True) -> "Booster":
        """The trainer's state bundle (JAX :1046): not ported."""
        raise not_ported("Booster.save_checkpoint", BREADTH)

    def resume_from_checkpoint(self, path_or_bundle) -> "Booster":
        """Resume from a state bundle (JAX :1090): not ported."""
        raise not_ported("Booster.resume_from_checkpoint", BREADTH)

    def capture_model_reference(self, score_bins: Optional[int] = None):
        """The training reference for drift checks (JAX :1013): not
        ported."""
        raise not_ported("Booster.capture_model_reference", DRIFT)

    def quality_snapshot(self, top_k: int = 8) -> Dict:
        """The trainer's quality telemetry (JAX :1035): not ported."""
        raise not_ported("Booster.quality_snapshot", DRIFT)

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, **kwargs) -> np.ndarray:
        """Prediction on raw features (reference basic.py:2816 /
        Predictor), by default up to ``best_iteration``; ``kwargs``
        override the ``predict_*`` params."""
        for key, what in _NOT_PORTED.items():
            if kwargs.get(key, self.params.get(key, False)):
                raise not_ported(what, TREESHAP)
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
        num_iteration = self._default_iterations(num_iteration, len(trees))
        trees = trees[start_iteration * K:
                      (start_iteration + num_iteration) * K]
        n = X.shape[0]

        method = str(kwargs.get("predict_method",
                                self.params.get("predict_method", "auto")))
        if method == "native":
            raise not_ported("predict_method=native (the C++ bulk "
                             "predictor)", NATIVE)
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
        if self._average_output() and trees:
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
