"""``Dataset`` and ``Booster``: the lightgbm-compatible API of the port.

Port of lightgbmv1_tpu/basic.py for the ported paths:

* ``Dataset`` (:107, ``construct`` :250): lazy binning of a dense
  numeric matrix, a scipy sparse matrix (kept as CSR and binned by
  ``BinnedDataset.from_csr``, never densified) or a data file (csv, tsv,
  libsvm through ``io/parser.load_data_file`` with the loader knobs of
  ``params``, or ``load_two_round`` under ``two_round``), or a binned
  dataset cache (``.bin``, ``save_binary`` :303, either package's) or a
  block cache directory (``save_block_cache`` :310, either package's:
  a ``StreamingDataset`` the out-of-core trainer streams), with
  categorical columns (``categorical_feature``) and its query groups, a
  valid set sharing its reference's bins (``create_valid`` :326) and
  taking its own groups;
  the setters ``set_label`` / ``set_weight`` / ``set_group`` /
  ``set_init_score`` / ``set_field`` (:333-365), which reach a
  constructed set's metadata without binning it again;
* ``Dataset.subset`` (:396), ``get_label`` / ``get_field`` and their
  kin, which ``engine.cv`` reads;
* ``Booster(params, train_set=..., init_model=...)`` (:430) over the
  trainer of ``models/gbdt.create_boosting`` (GBDT, GOSS, DART, RF),
  continuing a loaded model (text, file or Booster) whose trees seed the
  score caches by prediction, with ``update`` (:541, ``fobj`` a custom
  objective's ``(grad, hess)`` of the raw scores), ``rollback_one_iter``
  (:575), ``refit`` (:865: the trees' leaf ids from the device leaf walk
  (K5), each leaf re-fitted on the objective's gradients, blended by
  ``decay_rate``), ``save_checkpoint`` / ``resume_from_checkpoint``
  (:1046, :1090; io/checkpoint.py), ``reset_parameter`` (:611, a new knob
  reaching the next tree),
  ``eval_train`` / ``eval_valid`` with ``feval`` (:618-640),
  ``model_to_string`` (:947, through io/model_text.model_to_string, its
  importance block per ``saved_feature_importance_type``),
  ``save_model`` (:1001), ``dump_model`` (:1115), ``feature_importance``
  (:1137) and ``feature_name`` (:606); ``capture_model_reference``
  (:1013; obs/model.py: the training bins' occupancy, NaN rates and
  score distribution that drift checks read, carried by
  ``save_checkpoint``) and ``quality_snapshot`` (:1035); each ``update``
  observes its wall time (``train_iteration_ms``) and, with the tracer
  armed, records an iteration span (obs/trace.py); ``best_iteration`` (set by early
  stopping) is what ``predict``, ``model_to_string`` and ``save_model``
  default to (:704, :952);
* the serving half (``predict`` :655-800) for a loaded model and for a
  trained one: raw and converted scores, ``pred_leaf``,
  ``start_iteration`` / ``num_iteration`` slicing and ``average_output``
  (a loaded RF model's, or a trained RF's: :789-790, :964); a data file
  is read with ``load_data_file`` (its label column dropped where it has
  one column too many, :677-684).
  ``predict_method`` picks the walk with the JAX package's meaning
  (:725-781): ``host`` is the exact host walk (numpy ``HostTree``,
  float64 in tree order), ``native`` the threaded C++ walk of the same
  semantics (``native/predictor.cpp``, its pack cached per slice), and
  ``auto`` the native walk where rows x trees reach
  ``_NATIVE_PREDICT_MIN_WORK``, else the host walk;
  ``depthwise``/``pallas``/``fused`` go through the device
  ``BatchPredictor`` (models/predict.py), cached per (slice, method).
  ``pred_contrib`` gives exact TreeSHAP contributions (:929,
  models/treeshap.py) and ``pred_early_stop`` retires rows by margin on
  the host walk (:750-770; not on raw scores).

Training and prediction run on ``device`` (default: the card; without one
they raise — pass ``device="cpu"`` for the CPU).  Every other public name
of the JAX ``Dataset`` and ``Booster`` raises ``NotImplementedError``
naming its ROADMAP queue 1 item.  ``Dataset.from_binned`` (:240) wraps a
binned set, the distributed loader's shard; a booster trained by the
ranks of a parallel learner saves its model from rank 0 alone.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import Config
from .device import DeviceLike, resolve_device
from .io.dataset import BinnedDataset, Metadata
from .io.model_text import (LoadedModel, dump_model_dict, model_from_string,
                            model_to_string)
from .io.parser import load_data_file
from .models.tree import HostTree
from .objectives import convert_output, create_objective
from .utils import fileio
from .utils.log import LightGBMError, log_fatal, log_warning

_DEVICE_METHODS = ("depthwise", "pallas", "fused", "scan")
# rows x trees from which predict_method=auto takes the native C++ walk
# (JAX basic.py:35; below it the pack and the threads cost more than they
# save)
_NATIVE_PREDICT_MIN_WORK = 500_000


def _is_scipy_sparse(data) -> bool:
    return type(data).__module__.split(".")[0] == "scipy" and hasattr(
        data, "tocsr")


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
    ``data`` is a dense numeric (rows, features) array, a scipy sparse
    matrix or the path of a data file; ``group`` the query sizes of a
    ranking set, in row order."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto",
                 categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = False):
        self.params = dict(params or {})
        self.categorical_feature = categorical_feature
        self.reference = reference
        self.free_raw_data = free_raw_data
        self.feature_name = feature_name
        self._binned: Optional[BinnedDataset] = None
        if isinstance(data, (str, os.PathLike)):
            data, label, weight, group, init_score = self._load_file(
                str(data), label, weight, group, init_score)
        if _is_scipy_sparse(data):
            # kept sparse: construct() bins the CSR triplets into the EFB
            # bundle columns (reference LGBM_DatasetCreateFromCSR)
            self.data = data.tocsr()
        else:
            self.data = _to_2d_numpy(data) if data is not None else None
        self.label = (None if label is None
                      else np.asarray(label, dtype=np.float64).ravel())
        self.weight = (None if weight is None
                       else np.asarray(weight, dtype=np.float64).ravel())
        self.init_score = (None if init_score is None
                           else np.asarray(init_score, dtype=np.float64))
        self.group = (None if group is None
                      else np.asarray(group, dtype=np.int64).ravel())
        if self._binned is not None:
            # a two-round load: explicit fields win over the file's
            meta = self._binned.metadata
            if label is not None:
                meta.label = self.label.astype(np.float32)
            if weight is not None:
                meta.weight = self.weight.astype(np.float32)
            meta.set_group(self.group)
            meta.init_score = self.init_score

    def _load_file(self, path, label, weight, group, init_score):
        """A data file (JAX :130-215): ``two_round`` streams a training
        file straight into bins (``load_two_round``), else the file is
        parsed in memory (``load_data_file``) with the loader knobs of
        ``params``; the file's columns and siblings fill the fields not
        given.  A binned dataset cache (``save_binary``, JAX :146-156)
        is loaded as it is: no parsing, no binning.  A block cache
        directory (``save_block_cache``, JAX :130-140) opens as a
        ``data.streaming.StreamingDataset``: its metadata resident, its
        bins streamed block by block by the training
        (models/gbdt_stream.py); a directory that is not one raises
        ``BlockCacheError``.  Returns the raw data (None after a
        two-round or cached load) and the fields."""
        cfg = Config.from_dict(self.params)
        binned = None
        cats = self._categorical_list()
        if os.path.isdir(path):
            from .data.streaming import StreamingDataset

            binned = StreamingDataset(path)
        elif BinnedDataset.is_binary_file(path):
            binned = BinnedDataset.load_binary(path)
        elif cfg.two_round and self.reference is None:
            from .io.parser import load_two_round

            if any(isinstance(c, str) for c in cats):
                # names resolve against the header the in-memory loader
                # reads (JAX :173-180)
                log_warning("two_round with named categorical_feature "
                            "columns falls back to the in-memory loader")
            else:
                binned = load_two_round(path, cfg, [int(c) for c in cats])
        if binned is not None:
            self._binned = binned
            meta = binned.metadata
            self.feature_name = list(binned.feature_names)
            return (None,
                    meta.label if label is None else label,
                    meta.weight if weight is None else weight,
                    meta.group if group is None else group,
                    meta.init_score if init_score is None else init_score)
        df = load_data_file(
            path, has_header=cfg.header, label_column=cfg.label_column,
            weight_column=cfg.weight_column, group_column=cfg.group_column,
            ignore_column=cfg.ignore_column, num_threads=cfg.num_threads,
            # initscore_filename names the training data's scores only
            init_score_file=(cfg.initscore_filename
                             if self.reference is None else ""))
        if df.feature_names and self.feature_name == "auto":
            self.feature_name = df.feature_names
        return (df.X,
                df.label if label is None else label,
                df.weight if weight is None else weight,
                df.group if group is None else group,
                df.init_score if init_score is None else init_score)

    def set_group(self, group) -> "Dataset":
        """The query sizes of a ranking set (reference basic.py
        set_group); a constructed set takes them too."""
        self.group = (None if group is None
                      else np.asarray(group, dtype=np.int64).ravel())
        if self._binned is not None:
            self._binned.metadata.set_group(self.group)
        return self

    @classmethod
    def from_binned(cls, binned: BinnedDataset, params=None) -> "Dataset":
        """A Dataset over an already binned set (JAX :240): the
        distributed loader's shard (``parallel/dist_data.py``), which the
        Booster trains without parsing or binning again;
        ``construct()`` is a no-op."""
        ds = cls(None, params=params)
        ds._binned = binned
        return ds

    def save_binary(self, filename) -> "Dataset":
        """Write the binned dataset cache (JAX :303; reference
        Dataset::SaveBinaryFile): ``Dataset(filename)`` loads it without
        parsing or binning, in either package."""
        self.construct()
        self._binned.save_binary(str(filename))
        return self

    def save_block_cache(self, path, block_rows=None) -> "Dataset":
        """Write the block cache (JAX :310; data/block_cache.py) at the
        directory ``path``, ``block_rows`` rows a block
        (``stream_block_rows`` when None) in the ``bin_layout`` of
        ``params``: ``Dataset(path)`` trains from it out of core, in
        either package."""
        from .data.block_cache import write_block_cache

        self.construct()
        cfg = Config.from_dict(self.params)
        write_block_cache(self._binned, str(path),
                          block_rows=(cfg.stream_block_rows
                                      if block_rows is None else block_rows),
                          bin_layout=cfg.bin_layout)
        return self

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
        cats = []
        for c in self._categorical_list():
            if isinstance(c, str):
                if names is None or c not in names:
                    raise ValueError(f"categorical_feature {c!r} is not a "
                                     "feature name")
                cats.append(names.index(c))
            else:
                cats.append(int(c))
        fields = dict(label=self.label, weight=self.weight,
                      init_score=self.init_score, group=self.group,
                      config=Config.from_dict(self.params),
                      feature_names=names, reference=ref,
                      categorical_features=cats)
        if _is_scipy_sparse(self.data):
            csr = self.data
            self._binned = BinnedDataset.from_csr(
                csr.indptr, csr.indices, csr.data, num_data=csr.shape[0],
                num_features=csr.shape[1], **fields)
        else:
            self._binned = BinnedDataset.from_numpy(self.data, **fields)
        if self.free_raw_data:
            self.data = None
        return self

    def _categorical_list(self) -> list:
        """The categorical columns (JAX :257-263): the constructor's
        ``categorical_feature`` (indices or feature names), or at "auto"
        the params knob ``categorical_feature`` (its aliases
        ``cat_feature``, ``categorical_column``, ...: indices, as the JAX
        CLI reads it, :65-67)."""
        cf = self.categorical_feature
        if cf in ("auto", None):
            knob = str(Config.from_dict(self.params).categorical_feature)
            return [int(c) for c in knob.replace(",", " ").split()]
        if isinstance(cf, (str, int)):
            cf = [cf]
        return list(cf)

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


class _IterObs:
    """Per-iteration training telemetry in the default registry."""

    __slots__ = ("hist", "count")

    def __init__(self):
        from .obs.metrics import default_registry

        reg = default_registry()
        self.hist = reg.histogram(
            "train_iteration_ms", "Wall time of one boosting iteration",
            buckets=(1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000,
                     5000, 10000, 60000))
        self.count = reg.counter(
            "train_iterations_total", "Boosting iterations completed")

    def observe(self, ms: float) -> None:
        self.hist.observe(ms)
        self.count.inc()


_iter_obs: Optional[_IterObs] = None


def _iteration_metrics() -> _IterObs:
    global _iter_obs
    if _iter_obs is None:
        _iter_obs = _IterObs()
    return _iter_obs


class Booster:
    """A model that trains and predicts on ``device`` (default: the card;
    raises when there is none — pass ``device="cpu"`` for the CPU): from
    ``train_set`` (training; continuing ``init_model``, a model text
    path or a Booster), or loaded from ``model_file`` / ``model_str``."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 init_model: Optional[Union[str, "Booster"]] = None,
                 device: DeviceLike = None):
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_data_name = "training"
        self._device_pred_cache: Dict[tuple, Any] = {}
        self._native_pred_cache = None        # (key, pack) of the native walk
        self._gbdt = None
        self._loaded: Optional[LoadedModel] = None
        self._loaded_str: Optional[str] = None   # the text of _loaded
        self._name_valid_sets: List[str] = []
        self._valid_data: List[Dataset] = []
        # the metric curves the training loop records
        # ({"dataset:metric": [values]}, quality_snapshot reads them) and
        # capture_model_reference()'s result
        self._metric_history: Dict[str, List[float]] = {}
        self._model_reference = None
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("train_set must be a Dataset")
            from .models.gbdt import create_boosting

            train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            self.train_set = train_set
            self.config = Config.from_dict(self.params)
            init_raw = None
            if init_model is not None:
                # continued training (reference application.cpp:90-93):
                # the loaded trees' predictions seed the score cache
                base = (init_model.model_to_string()
                        if isinstance(init_model, Booster)
                        else self._read_text(init_model))
                self._loaded = model_from_string(base)
                self._loaded_str = base
                if self._loaded.average_output:
                    log_fatal("Continued training from an RF "
                              "(average_output) model is not supported")
                init_raw = self._loaded_raw_scores(train_set)
            self._gbdt = create_boosting(self.config, train_set._binned,
                                         self.device,
                                         init_raw_scores=init_raw)
            return
        if model_file is not None:
            model_str = self._read_text(model_file)
        if model_str is None:
            raise TypeError("Need at least one of train_set, model_file, "
                            "model_str")
        self._loaded = model_from_string(model_str)
        self._loaded_str = model_str
        # the model's objective line decides the output conversion (JAX
        # :497-511): a params dict (the CLI passes its whole config) keeps
        # its other knobs
        cfg = {"objective": self._loaded.objective}
        if self._loaded.num_class > 1:
            cfg["num_class"] = self._loaded.num_class
        for key in ("sigmoid", "alpha"):
            if key in self._loaded.objective_params:
                cfg[key] = float(self._loaded.objective_params[key])
        self.config = Config.from_dict({**self.params, **cfg})

    @staticmethod
    def _read_text(path) -> str:
        with fileio.open_file(str(path)) as fh:
            return fh.read()

    def _loaded_raw_scores(self, dataset: Dataset) -> np.ndarray:
        """(N, K) raw scores of the loaded trees on a dataset's raw rows
        (JAX :529), its init scores added (the reference stacks the
        loaded model on them): the leaf walk (K5 on the card) gives each
        row's leaves, summed in float64 in tree order as the host walk
        sums them."""
        X = dataset.data
        if X is None:
            log_fatal("Raw data is required for continued training "
                      "(dataset was constructed with free_raw_data=True)")
        K = max(self._loaded.num_tree_per_iteration, 1)
        trees = self._loaded.trees
        raw = np.zeros((X.shape[0], K), dtype=np.float64)
        if trees:
            from .models.predict import BatchPredictor

            bp = BatchPredictor(trees, K, X.shape[1], method="pallas",
                                device=self.device)
            step = 65536        # a sparse set densified a block at a time
            for lo in range(0, X.shape[0], step):
                raw[lo:lo + step] = bp.predict_raw(
                    _to_2d_numpy(X[lo:lo + step]), f64_exact=True)
        if dataset.init_score is not None:
            raw = raw + np.asarray(dataset.init_score, np.float64).reshape(
                raw.shape[0], -1)
        return raw

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if self._gbdt is None:
            raise RuntimeError("Cannot add validation data to a loaded "
                               "model")
        if data.reference is None and data._binned is None:
            data.reference = self.train_set
        data.construct()
        init_raw = None
        if self._loaded is not None and self._loaded.trees:
            # continued training: the valid scores start from the loaded
            # trees too
            init_raw = self._loaded_raw_scores(data)
        self._gbdt.add_valid(data._binned, name, init_raw=init_raw)
        self._name_valid_sets.append(name)
        self._valid_data.append(data)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True when no further split is possible
        (reference basic.py:2315).  ``fobj(preds, train_set) -> (grad,
        hess)`` is a custom objective on the raw scores ((N,) for one
        class), its arrays (N,) or (N, K) (JAX :542-560).  Under
        ``finite_guard=warn|raise`` the iteration boundary is checked."""
        from .obs import trace

        if self._gbdt is None:
            raise RuntimeError("Cannot update a loaded model")
        if train_set is not None:
            raise ValueError("Resetting train_set is not supported")
        t0_ns = trace.now_ns()
        if fobj is None:
            finished = self._gbdt.train_one_iter()
        else:
            preds = self._gbdt.raw_train_scores()
            if self._gbdt.num_class == 1:
                preds = preds[:, 0]
            grad, hess = fobj(preds, self.train_set)
            finished = self._gbdt.train_one_iter(custom_grad=grad,
                                                 custom_hess=hess)
        self._gbdt.check_finite_boundary()
        # the iteration's host wall time (its device work is enqueued,
        # not waited for) into the default registry, and its span
        _iteration_metrics().observe((trace.now_ns() - t0_ns) / 1e6)
        if trace.enabled():
            trace.iteration_span_end(t0_ns, self._gbdt.iter - 1)
        return finished

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration (JAX :575; one level deep)."""
        if self._gbdt is not None:
            self._gbdt.rollback_one_iter()
        return self

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
        """The loaded model's iterations and the trained ones."""
        n = self._loaded.num_iterations if self._loaded is not None else 0
        return n + (self._gbdt.iter if self._gbdt is not None else 0)

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
        """A continued model's loaded trees, then the trained ones."""
        trees = list(self._loaded.trees) if self._loaded is not None else []
        if self._gbdt is not None:
            trees += self._gbdt.materialize_host_trees()
        return trees

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
                    "max_bin": cfg.max_bin, "seed": cfg.seed},
                # split counts (0) or total gains (1) in the importance
                # block (reference gbdt.cpp:779-800)
                importance_type=cfg.saved_feature_importance_type)
        lm = self._loaded
        return model_to_string(
            trees, objective_string=lm.objective + "".join(
                f" {k}:{v}" for k, v in lm.objective_params.items()),
            num_class=lm.num_class, num_tree_per_iteration=K,
            feature_names=lm.feature_names, feature_infos=lm.feature_infos,
            average_output=lm.average_output, parameters=lm.parameters)

    def save_model(self, filename, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        """The model text, written atomically (a crash leaves the old
        file).  A booster trained by the ranks of a parallel learner
        writes from rank 0 alone (every rank holds the same text)."""
        if self._gbdt is not None and self._gbdt._group.rank != 0:
            return self
        fileio.atomic_write_text(
            str(filename), self.model_to_string(num_iteration,
                                                start_iteration))
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

    def refit(self, data, label, decay_rate: float = 0.9) -> "Booster":
        """A Booster of this model's trees with their leaves re-fitted on
        ``data`` / ``label`` (JAX :865; reference GBDT::RefitTree,
        gbdt.cpp:266-290): tree by tree, each leaf's value becomes
        ``decay_rate * old + (1 - decay_rate) * new``, ``new`` the leaf's
        output ``-sign(G) max(|G| - l1, 0) / (H + l2)`` (times the tree's
        shrinkage) on the objective's gradients at the refitted trees'
        scores so far.  The rows' leaves come from the device leaf walk
        (K5 on the card), the gradients from the objective on the
        device."""
        import torch

        from .models.predict import BatchPredictor

        X = _to_2d_numpy(data)
        y = np.asarray(label, dtype=np.float32).ravel()
        trees = [copy.deepcopy(t) for t in self._all_trees()]
        if not trees:
            log_fatal("Cannot refit an empty model")
        K = self.num_model_per_iteration()
        cfg = self.config
        obj = create_objective(cfg)
        if obj is None:
            raise LightGBMError("Cannot refit due to null objective "
                                "function.")
        meta = Metadata()
        meta.label = y
        obj.init(meta, len(y), self.device)
        leaves = BatchPredictor(trees, K, X.shape[1], method="pallas",
                                device=self.device).predict_leaf(X)
        l1, l2 = cfg.lambda_l1, cfg.lambda_l2
        scores = np.zeros((len(y), K), dtype=np.float64)
        for i, t in enumerate(trees):
            k = i % K
            s = torch.as_tensor((scores[:, 0] if K == 1 else scores)
                                .astype(np.float32), device=self.device)
            grad, hess = obj.get_gradients(s)
            grad = grad.cpu().numpy().reshape(len(y), -1)[:, k]
            hess = hess.cpu().numpy().reshape(len(y), -1)[:, k]
            leaf = leaves[:, i].astype(np.int64)
            sg = np.bincount(leaf, weights=grad, minlength=t.num_leaves)
            sh = np.bincount(leaf, weights=hess, minlength=t.num_leaves)
            has = np.bincount(leaf, minlength=t.num_leaves) > 0
            thr = np.sign(sg) * np.maximum(np.abs(sg) - l1, 0.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                # a leaf without rows keeps its value
                new_out = (-thr / (sh + l2)) * t.shrinkage
            lv = t.leaf_value[:t.num_leaves]
            t.leaf_value = np.where(has[:t.num_leaves],
                                    decay_rate * lv
                                    + (1.0 - decay_rate) * new_out[
                                        :t.num_leaves], lv)
            scores[:, k] += t.leaf_value[leaf]
        out = Booster(model_str=(self._loaded_str
                                 if self._gbdt is None and self._loaded_str
                                 else self.model_to_string()),
                      params=self.params, device=self.device)
        out._loaded.trees = trees
        out.config = cfg
        return out

    def save_checkpoint(self, path, write_file: bool = True,
                        with_reference: bool = True) -> "Booster":
        """Write the trainer's whole state (io/checkpoint.py; JAX :1046):
        a run resumed from it (``resume_from_checkpoint``) writes the
        model text of the run that never stopped, byte for byte.
        ``write_file=False`` captures without writing (the JAX package's
        non-writing ranks; a parallel learner's ranks past 0 write
        nothing either); ``with_reference`` writes the training
        reference (``capture_model_reference``) into the bundle, so a
        resumed or served model keeps its drift baseline."""
        if self._gbdt is None:
            log_fatal("save_checkpoint() requires a training Booster")
        from .io.checkpoint import write_checkpoint

        manifest, arrays = self._gbdt.capture_state()
        manifest["num_trees_total"] = self.num_trees()
        if write_file and self._gbdt._group.rank == 0:
            ref_bytes = b""
            if with_reference:
                try:
                    ref_bytes = self.capture_model_reference().to_bytes()
                except Exception as e:  # noqa: BLE001 — CSR data bundled
                    # by EFB keeps no per-feature matrix
                    log_warning(f"checkpoint: reference capture skipped "
                                f"({type(e).__name__}: {e})")
            write_checkpoint(str(path), manifest, arrays,
                             model_text=self.model_to_string(),
                             base_model_text=self._loaded_str or "",
                             reference_bytes=ref_bytes)
        return self

    def resume_from_checkpoint(self, path_or_bundle) -> "Booster":
        """Restore a checkpoint (a path, or ``load_checkpoint``'s dict)
        into this fresh training Booster of the same data, config and
        valid sets (JAX :1090); the bundle is checked whole before any
        state is touched, ``CheckpointError`` otherwise."""
        if self._gbdt is None:
            log_fatal("resume_from_checkpoint() requires a training "
                      "Booster (construct with train_set=...)")
        from .io.checkpoint import load_checkpoint

        bundle = (path_or_bundle if isinstance(path_or_bundle, dict)
                  else load_checkpoint(str(path_or_bundle)))
        base = bundle.get("base_model_text", "")
        if base and self._loaded is None:
            # the checkpointed run continued a loaded model: its trees
            # come first again
            self._loaded = model_from_string(base)
            self._loaded_str = base
        self._gbdt.restore_state(bundle["manifest"], bundle["arrays"])
        return self

    def capture_model_reference(self, score_bins: Optional[int] = None):
        """The training reference for drift checks (JAX :1013;
        obs/model.py): one pass over the binned training matrix records
        each feature's bin occupancy over the ensemble's own bins, its
        NaN rate, and the raw training-score distribution in
        ``score_bins`` bins (default ``drift_score_bins``).  Cached on
        the Booster and returned; publish it with
        ``Server.publish(booster, model_reference=ref)``."""
        if self._gbdt is None:
            log_fatal("capture_model_reference() requires a training "
                      "Booster")
        from .obs.model import capture_reference

        if score_bins is None:
            score_bins = self.config.drift_score_bins
        self._model_reference = capture_reference(
            self._gbdt.train_set, self._gbdt.raw_train_scores(),
            score_bins=score_bins)
        return self._model_reference

    def quality_snapshot(self, top_k: int = 8) -> Dict:
        """The trainer's quality telemetry (JAX :1035; obs/model.py): the
        split gains, leaves and depths a tree and an iteration, gain and
        split importance and the recorded metric curves, from the host
        trees after the fact."""
        from .obs.model import quality_snapshot

        return quality_snapshot(self, top_k=top_k)

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs) -> np.ndarray:
        """Prediction on raw features (reference basic.py:2816 /
        Predictor; JAX :655), by default up to ``best_iteration``;
        ``kwargs`` override the ``predict_*`` and ``pred_early_stop*``
        params.  ``pred_contrib``: (N, K (F + 1)) TreeSHAP contributions,
        each class's expected value last."""
        if isinstance(data, (str, os.PathLike)):
            X = load_data_file(str(data), is_predict=True).X
            # a prediction file usually keeps the training file's label
            # column (JAX :677-684)
            if X.shape[1] == self.num_feature() + 1:
                X = X[:, 1:]
        else:
            X = _to_2d_numpy(data)

        def p(name, dflt):
            return kwargs.get(name, self.params.get(name, dflt))

        if X.shape[1] != self.num_feature() and not bool(
                p("predict_disable_shape_check", False)):
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
        early_stop = bool(p("pred_early_stop", False)) and not raw_score
        method = str(p("predict_method", "auto"))
        raw = None
        if method in _DEVICE_METHODS and trees and not pred_contrib \
                and not early_stop:
            bp = self._device_predictor(trees, K, start_iteration, method,
                                        kwargs)
            if pred_leaf:
                return bp.predict_leaf(X)
            raw = np.asarray(bp.predict_raw(
                X, f64_exact=bool(p("predict_f64_scores", False))),
                np.float64)
        if pred_leaf:
            return np.stack([t.predict_leaf_index(X) for t in trees], axis=1)
        if pred_contrib:
            return self._predict_contrib(X, trees, K)
        if raw is None and early_stop:
            raw = self._predict_early_stop(
                X, trees, K, int(p("pred_early_stop_freq", 10)),
                float(p("pred_early_stop_margin", 10.0)))
        if raw is None and (method == "native" or (
                method != "host"
                and n * len(trees) >= _NATIVE_PREDICT_MIN_WORK)):
            raw = self._predict_raw_native(X, trees, K, start_iteration)
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

    @staticmethod
    def _predict_early_stop(X, trees, K, freq: int, margin: float
                            ) -> np.ndarray:
        """The host walk with prediction early stopping (JAX :750-770;
        reference PredictionEarlyStopInstance,
        prediction_early_stop.cpp:75): every ``freq`` iterations the rows
        whose margin (binary 2 |raw|, multiclass the gap of the top two
        classes) reaches ``margin`` take no further trees."""
        n = X.shape[0]
        raw = np.zeros((n, K), dtype=np.float64)
        active = np.ones(n, dtype=bool)
        for it in range(len(trees) // K if K else 0):
            idx = np.flatnonzero(active)
            if idx.size == 0:
                break
            for k in range(K):
                raw[idx, k] += trees[it * K + k].predict(X[idx])
            if (it + 1) % freq == 0:
                if K == 1:
                    gap = 2.0 * np.abs(raw[idx, 0])
                else:
                    part = np.partition(raw[idx], K - 2, axis=1)
                    gap = part[:, K - 1] - part[:, K - 2]
                active[idx[gap >= margin]] = False
        return raw

    def _predict_raw_native(self, X, trees, K, start_iteration=0):
        """(n, K) raw scores from the native C++ walk (JAX :801-829); None
        where the pack cannot hold the model (a categorical node without
        its raw set) or ``X`` lacks a feature the model splits on (the
        host walk then raises).  The pack is cached per (slice start,
        tree count, model version): every change of the ensemble moves
        the version."""
        from .native import build_ensemble_pack, predict_ensemble

        key = (start_iteration, len(trees),
               self._gbdt.model_version if self._gbdt is not None else -1)
        cached = self._native_pred_cache
        if cached is None or cached[0] != key:
            cached = self._native_pred_cache = (
                key, build_ensemble_pack(trees, K))
        pack = cached[1]
        if pack is None or X.shape[1] <= pack["max_feat"]:
            return None
        return predict_ensemble(
            X, pack, num_threads=int(self.params.get("num_threads", 0) or 0))

    @staticmethod
    def _predict_contrib(X, trees, K) -> np.ndarray:
        """Exact TreeSHAP contributions (JAX :929-943; reference
        Tree::PredictContrib, tree.h:138): (N, K (F + 1)) float64, each
        class's block its features' contributions and its expected value
        last; a row's block sums to its raw score."""
        from .models.treeshap import tree_shap

        n, F = X.shape
        out = np.zeros((n, K * (F + 1)), dtype=np.float64)
        for ti, t in enumerate(trees):
            k = ti % K
            out[:, k * (F + 1):(k + 1) * (F + 1)] += tree_shap(t, X)
        return out

    def _device_predictor(self, trees, K, start_iteration, method, kwargs):
        """Device engine (models/predict.BatchPredictor), cached per (slice
        start, tree count, model version, method): the version moves with
        every change of the ensemble (an update, a rollback).  A
        predictor that cannot be built raises: there is no host
        fallback."""
        key = (start_iteration, len(trees),
               self._gbdt.model_version if self._gbdt is not None else -1,
               method)
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
