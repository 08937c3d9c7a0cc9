"""Configuration of the ported paths (serving and training).

Port of the part of lightgbmv1_tpu/config.py that these paths read: the
objective fields a loaded model sets, the training knobs of the ported
objectives and growers with the reference's aliases (``eta``,
``num_iterations``, ...), ``label_gain_or_default`` (:963) and the
``predict_*`` and ``serve_*`` knobs, with the JAX package's
names, defaults and validation (``config.py:27-184``, ``:221-366``,
``:477-545``, ``:779-949``).  Unknown keys warn, as there.

Every knob of the JAX ``Config`` is a field here.  Those the port does
not yet run are known only to refuse them: ``unported_reason`` names the
ROADMAP item of every one a config sets away from its default (``_UNPORTED``
and ``_REFUSED``), and the trainer raises ``NotImplementedError`` with it
instead of training something else (an objective the port does not train
is refused by ``objectives.create_objective``).  ``gpu_use_dp`` is mapped as there;
a few knobs change no model in the JAX package either and are accepted.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .utils.log import log_warning, set_verbosity

_BOOL_TRUE = {"true", "1", "yes", "on", "+", "t", "y"}
_BOOL_FALSE = {"false", "0", "no", "off", "-", "f", "n"}

# the reference's alias table (JAX config.py:27-184)
_ALIASES: Dict[str, str] = {
    "objective_type": "objective", "app": "objective",
    "application": "objective", "boosting_type": "boosting",
    "boost": "boosting",
    "num_trees": "num_iterations", "num_iteration": "num_iterations",
    "num_tree": "num_iterations", "num_round": "num_iterations",
    "num_rounds": "num_iterations", "num_boost_round": "num_iterations",
    "n_iter": "num_iterations", "n_estimators": "num_iterations",
    "shrinkage_rate": "learning_rate", "eta": "learning_rate",
    "num_leaf": "num_leaves", "max_leaves": "num_leaves",
    "max_leaf": "num_leaves",
    "tree": "tree_learner", "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "random_seed": "seed", "random_state": "seed",
    "min_data_per_leaf": "min_data_in_leaf", "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction",
    "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction",
    "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode",
    "colsample_bynode": "feature_fraction_bynode",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "max_tree_output": "max_delta_step", "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1", "l1_regularization": "lambda_l1",
    "reg_lambda": "lambda_l2", "lambda": "lambda_l2",
    "l2_regularization": "lambda_l2", "min_split_gain": "min_gain_to_split",
    "mc": "monotone_constraints",
    "monotone_constraint": "monotone_constraints",
    "verbose": "verbosity", "max_bins": "max_bin",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "data_seed": "data_random_seed",
    "is_enable_bundle": "enable_bundle", "bundle": "enable_bundle",
    "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "categorical_columns": "categorical_feature",
    "cat_feature": "categorical_feature",
    "cat_features": "categorical_feature",
    "num_classes": "num_class", "unbalance": "is_unbalance",
    "unbalanced_sets": "is_unbalance", "sigmoid_": "sigmoid",
    "metrics": "metric", "metric_types": "metric",
    # the aliases of the knobs below that the port refuses or that change
    # no model (the rest of JAX config.py:27-184)
    "config_file": "config", "task_type": "task", "train": "data",
    "train_data": "data", "train_data_file": "data", "data_filename": "data",
    "test": "valid", "valid_data": "valid", "valid_data_file": "valid",
    "test_data": "valid", "test_data_file": "valid",
    "valid_filenames": "valid", "num_thread": "num_threads",
    "nthread": "num_threads", "nthreads": "num_threads",
    "n_jobs": "num_threads", "device": "device_type",
    "bagging_fraction_seed": "bagging_seed", "rate_drop": "drop_rate",
    "topk": "top_k", "cegb_penalty_feature_lazy": "cegb_penalty_feature_lazy",
    "fc": "forcedsplits_filename",
    "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename",
    "forced_splits": "forcedsplits_filename", "model_output": "output_model",
    "model_out": "output_model", "model_input": "input_model",
    "model_in": "input_model", "predict_result": "output_result",
    "prediction_result": "output_result", "predict_name": "output_result",
    "prediction_name": "output_result", "pred_name": "output_result",
    "name_pred": "output_result", "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse", "sparse": "is_enable_sparse",
    "is_pre_partition": "pre_partition", "two_round_loading": "two_round",
    "use_two_round_loading": "two_round", "is_save_binary": "save_binary",
    "is_save_binary_file": "save_binary", "has_header": "header",
    "label": "label_column", "weight": "weight_column",
    "group": "group_column", "group_id": "group_column",
    "query_column": "group_column", "query": "group_column",
    "query_id": "group_column", "ignore_feature": "ignore_column",
    "blacklist": "ignore_column", "is_predict_raw_score": "predict_raw_score",
    "predict_rawscore": "predict_raw_score", "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index",
    "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib", "contrib": "predict_contrib",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric", "ndcg_eval_at": "eval_at",
    "ndcg_at": "eval_at", "map_eval_at": "eval_at", "map_at": "eval_at",
    "num_machine": "num_machines", "local_port": "local_listen_port",
    "port": "local_listen_port", "machine_list_file": "machine_list_filename",
    "machine_list": "machine_list_filename", "mlist": "machine_list_filename",
    "workers": "machines", "nodes": "machines",
}

# the JAX package's objective aliases (config.py:186-210)
_OBJECTIVE_ALIASES: Dict[str, str] = {
    "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression",
    "l2_root": "regression", "root_mean_squared_error": "regression",
    "rmse": "regression", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "mean_absolute_percentage_error": "mape",
    "multiclass_ova": "multiclassova", "ova": "multiclassova",
    "ovr": "multiclassova", "xentropy": "cross_entropy",
    "xentlambda": "cross_entropy_lambda",
    "mean_average_precision": "map", "xendcg": "rank_xendcg",
    "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
}


def canonical_objective(name: str) -> str:
    return _OBJECTIVE_ALIASES.get(name, name)


@dataclass
class Config:
    # -- core -------------------------------------------------------------
    objective: str = "regression"
    boosting: str = "gbdt"
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    seed: int = 0
    # -- learning control -------------------------------------------------
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    verbosity: int = 1
    # -- sampling: bagging and feature fraction (JAX gbdt.py:684-724) -----
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    # extremely randomized trees: one random threshold a feature a node
    extra_trees: bool = False
    # callbacks: engine.train's early stopping
    early_stopping_round: int = 0
    # -- knobs of the JAX package the port refuses (see unported_reason) --
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    monotone_constraints: List[int] = field(default_factory=list)
    interaction_constraints: str = ""
    forcedsplits_filename: str = ""
    cegb_penalty_split: float = 0.0
    # -- tree growth and histograms (JAX config.py:306-366) ---------------
    tree_growth: str = "leafwise"
    # 0 = auto (num_leaves // 4; the sequential grower below 8 leaves,
    # not ported); >= 1 forces the wave grower at that wave size
    leafwise_wave_size: int = 0
    # auto | bench | scatter | onehot | pallas | fused: auto is the CUDA
    # kernel K1 for a CUDA tensor (the one-hot product for int16 bins),
    # the plain scatter for a CPU one (ops/histogram.default_hist_method);
    # bench times the candidates and picks one; fused runs the wave rounds
    # through the fused round K2 and the valid routing K3
    hist_method: str = "auto"
    # fused rounds a launch: 1 = the single-round kernel K2; > 1 is the
    # persistent wave loop K6 (ops/loop_cuda.py; JAX config.py:402)
    wave_loop_rounds: int = 1
    bin_layout: str = "auto"         # auto | u8 | packed4
    hist_dtype: str = "bf16x2"       # f32 | bf16 | bf16x2 | int8
    # sustained (largest-bucket) wave rounds: "" drops bf16x2 to bf16
    # there; "auto" is bf16x2 off the TPU; else the named dtype
    hist_dtype_deep: str = ""
    # -- dataset and binning (JAX config.py:686-733) ----------------------
    max_bin: int = 255
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    feature_pre_filter: bool = True
    data_random_seed: int = 1
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    use_missing: bool = True
    zero_as_missing: bool = False
    categorical_feature: str = ""
    # -- objective --------------------------------------------------------
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    # -- metric -----------------------------------------------------------
    metric: List[str] = field(default_factory=list)
    # -- serving engine (models/predict.py) -------------------------------
    # "auto"/"host": the exact host walk (numpy HostTree); "depthwise":
    # the depth-stepped all-trees walk in plain torch; "pallas": leaf ids
    # from the CUDA leaf-walk kernel (ops/predict_cuda.serving_leaf);
    # "fused": the serving megakernel (ops/predict_cuda.serving_fused)
    # walking every tree and summing the scores in one launch.  "native"
    # and "scan" are not ported yet (ROADMAP queue 1, items 9 and 20)
    predict_method: str = "auto"
    # prebinned serving codes: "auto" = on whenever the thresholds admit
    # an EXACT serving binning, else the raw f32 walk; "on"/"off" force it
    predict_prebin: str = "auto"
    # "auto" packs two 4-bit codes per byte for predict_method=fused when
    # every feature fits 16 codes; "packed4" forces it for any prebinned
    # walk; "u8" keeps byte-wide codes
    predict_code_layout: str = "auto"
    predict_bucket_min: int = 256    # smallest power-of-two row bucket
    predict_chunk_rows: int = 131072  # streaming chunk (bounds device memory)
    predict_num_shards: int = 0      # >1: row-sharded predict (item 20)
    # reconstruct raw scores host-side in float64 from device leaf ids
    # (bit-identical to the host walk); off = the on-device f32 sum
    predict_f64_scores: bool = False
    # -- online serving (serve/) ------------------------------------------
    serve_max_batch_rows: int = 1024
    serve_max_batch_delay_ms: float = 2.0
    serve_queue_depth: int = 4096    # admission bound in ROWS
    serve_timeout_ms: float = 0.0    # per-request deadline in queue; 0=off
    serve_retry_max: int = 2
    serve_retry_backoff_ms: float = 5.0
    serve_probe_rows: int = 64       # publish-time golden probe rows
    registry_keep_versions: int = 4
    # -- more knobs of the JAX package the port refuses (_REFUSED): --------
    # objectives and metrics (items 1 and 8)
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 20
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)
    objective_seed: int = 5
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)
    # sampling seeds
    bagging_seed: int = 3
    feature_fraction_seed: int = 2
    extra_seed: int = 6
    # callbacks: early stopping on the first metric alone
    first_metric_only: bool = False
    # boosting, categorical, constraints, penalties, binning, model
    # lifecycle (item 8)
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    feature_contri: List[float] = field(default_factory=list)
    cegb_tradeoff: float = 1.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    forcedbins_filename: str = ""
    max_bin_by_feature: List[int] = field(default_factory=list)
    saved_feature_importance_type: int = 0
    snapshot_freq: int = -1
    finite_guard: str = "off"
    # the sequential grower (item 2)
    histogram_pool_size: float = -1.0
    # histogram build strategies: scatter / onehot under hist_method=auto
    force_col_wise: bool = False
    force_row_wise: bool = False
    # TreeSHAP and prediction early stopping (item 10)
    predict_contrib: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    # the CLI and file I/O (item 11)
    config: str = ""
    task: str = "train"
    data: str = ""
    valid: List[str] = field(default_factory=list)
    # accepted: it changes no trained model (in the JAX package it reaches
    # only file loading and the native predictor, basic.py:201, :826)
    num_threads: int = 0
    output_model: str = "LightGBM_model.txt"
    input_model: str = ""
    output_result: str = "LightGBM_predict_result.txt"
    initscore_filename: str = ""
    valid_data_initscores: List[str] = field(default_factory=list)
    two_round: bool = False
    save_binary: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    refit_decay_rate: float = 0.9
    snapshot_keep: int = 2
    # HTTP front-end (item 13)
    serve_http_port: int = 8080
    serve_duration_s: float = 0.0
    # fleet and router (item 14)
    serve_replicas: int = 1
    router_health_period_ms: float = 25.0
    router_eject_after: int = 2
    router_readmit_after: int = 2
    router_retry_max: int = 2
    router_hedge_ms: float = 0.0
    router_deadline_ms: float = 0.0
    # tenants and placement (item 15)
    tenant_manifest: str = ""
    placement_replicas_per_tenant: int = 0
    placement_burn_threshold: float = 2.0
    placement_occupancy_frac: float = 0.75
    placement_cooldown_s: float = 30.0
    # SLOs (item 16)
    serve_slo_availability_target: float = 0.999
    serve_slo_latency_ms: float = 50.0
    serve_slo_latency_target: float = 0.99
    serve_slo_fast_window_s: float = 60.0
    serve_slo_slow_window_s: float = 600.0
    # drift (item 17)
    drift_sample_rows: int = 0
    drift_per_batch_rows: int = 64
    drift_min_rows: int = 256
    drift_psi_threshold: float = 0.25
    drift_top_k: int = 8
    drift_psi_groups: int = 16
    drift_sample_stride: int = 4
    drift_score_bins: int = 16
    # failure domains of the server (item 18)
    serve_degrade_trees: int = 0
    serve_breaker_failures: int = 3
    serve_watchdog_ms: float = 0.0
    # observability (item 19)
    profile_dir: str = ""
    obs_trace: bool = False
    trace_out: str = ""
    obs_ring_events: int = 65536
    obs_event_ring: int = 4096
    crash_dir: str = ""
    obs_dir: str = ""
    # parallel learners, streaming, elastic (item 21)
    top_k: int = 20
    num_machines: int = 1
    local_listen_port: int = 12400
    machines: str = ""
    time_out: int = 120
    machine_list_filename: str = ""
    pre_partition: bool = False
    data_parallel_collective: str = "reduce_scatter"
    num_shards: int = 0
    num_hosts: int = 0
    hier_ici_gbps: float = 100.0
    hier_dcn_gbps: float = 10.0
    elastic_lease_timeout_s: float = 3.0
    elastic_max_restarts: int = 2
    stream_enable: bool = False
    stream_block_rows: int = 65536
    stream_prefetch: bool = True
    stream_cache_dir: str = ""
    # -- knobs that change no model in the JAX package either: device
    # selection and XLA execution knobs (results pinned equal there),
    # and knobs it reads nowhere; accepted, as there ----------------------
    device_type: str = "tpu"
    deterministic: bool = False
    is_enable_sparse: bool = True
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    fused_bookkeeping: bool = True
    async_wave_pipeline: bool = True
    donate_buffers: bool = True
    predict_cache_entries: int = 64
    # -- prediction (basic.Booster.predict reads it) ----------------------
    predict_disable_shape_check: bool = False
    # double-precision histograms: mapped onto f32 histograms in
    # __post_init__, as the JAX package maps it (JAX config.py:940-947)
    gpu_use_dp: bool = False

    def __post_init__(self):
        set_verbosity(self.verbosity)
        self.objective = canonical_objective(self.objective)
        if self.objective in ("multiclass", "multiclassova") \
                and self.num_class <= 1:
            raise ValueError("num_class must be >1 for multiclass objectives")
        if self.force_col_wise and self.force_row_wise:
            # reference config.cpp CheckParamConflict fatals on both
            raise ValueError(
                "Cannot set both force_col_wise and force_row_wise")
        if self.hist_method == "auto":
            # the reference's histogram build strategies (JAX
            # config.py:786-797): col-wise per-feature gathers are the
            # scatter, row-wise multi-feature tiles the one-hot product
            if self.force_col_wise:
                self.hist_method = "scatter"
            elif self.force_row_wise:
                self.hist_method = "onehot"
        if self.hist_method not in (
                "auto", "bench", "scatter", "onehot", "pallas", "fused"):
            raise ValueError(
                f"hist_method={self.hist_method!r}: expected auto | bench "
                "| scatter | onehot | pallas | fused")
        if self.bin_layout not in ("auto", "u8", "packed4"):
            raise ValueError(f"bin_layout={self.bin_layout!r}: expected "
                             "auto | u8 | packed4")
        if self.hist_dtype not in ("f32", "bf16", "bf16x2", "int8"):
            raise ValueError(f"hist_dtype={self.hist_dtype!r}: expected "
                             "f32 | bf16 | bf16x2 | int8")
        if self.hist_dtype_deep not in (
                "", "auto", "f32", "bf16", "bf16x2", "int8", "int8sr"):
            raise ValueError(
                f"hist_dtype_deep={self.hist_dtype_deep!r}: expected one of "
                "auto | f32 | bf16 | bf16x2 | int8 | int8sr (or empty for "
                "the bf16-drop policy)")
        if self.gpu_use_dp and not self.hist_dtype_deep:
            # an explicit hist_dtype_deep wins (JAX config.py:940-947)
            self.hist_dtype_deep = "f32"
        if self.gpu_use_dp and self.hist_dtype in ("bf16", "bf16x2", "int8"):
            self.hist_dtype = "f32"
        if self.num_leaves < 2:
            raise ValueError("num_leaves must be >= 2")
        if self.wave_loop_rounds < 1:
            raise ValueError("wave_loop_rounds must be >= 1 (1 = the "
                             "single-round fused kernel)")
        if self.predict_method not in (
                "auto", "native", "host", "depthwise", "pallas", "fused",
                "scan"):
            raise ValueError(
                f"predict_method={self.predict_method!r}: expected auto | "
                "native | host | depthwise | pallas | fused | scan")
        if self.predict_prebin not in ("auto", "on", "off"):
            raise ValueError(
                f"predict_prebin={self.predict_prebin!r}: expected "
                "auto | on | off")
        if self.predict_code_layout not in ("auto", "u8", "packed4"):
            raise ValueError(
                f"predict_code_layout={self.predict_code_layout!r}: "
                "expected auto | u8 | packed4")
        if self.serve_max_batch_rows < 1:
            raise ValueError("serve_max_batch_rows must be >= 1")
        if self.serve_max_batch_delay_ms < 0:
            raise ValueError("serve_max_batch_delay_ms must be >= 0")
        if self.serve_queue_depth < self.serve_max_batch_rows:
            raise ValueError("serve_queue_depth must be >= "
                             "serve_max_batch_rows (admission control "
                             "must admit at least one full batch)")
        if self.serve_retry_max < 0 or self.serve_retry_backoff_ms < 0:
            raise ValueError("serve_retry_max / serve_retry_backoff_ms "
                             "must be >= 0")
        if self.serve_probe_rows < 0:
            raise ValueError("serve_probe_rows must be >= 0")
        if self.registry_keep_versions < 1:
            raise ValueError("registry_keep_versions must be >= 1 "
                             "(the current version is always kept)")

    @classmethod
    def _fields_of(cls, params: Dict[str, Any]) -> Dict[str, Any]:
        """``params`` as field values: aliases resolved (an explicit name
        beating its alias), each coerced to its field's type; unknown keys
        warn and are skipped (reference ``Config::Set``)."""
        resolved: Dict[str, Any] = {}
        for key, value in params.items():
            name = _ALIASES.get(key, key)
            if name in resolved and key != name:
                continue
            resolved[name] = value
        fields = {f.name: f for f in dataclasses.fields(cls)}
        out = {}
        for name, value in resolved.items():
            if name not in fields:
                log_warning(f"Unknown parameter: {name}")
                continue
            out[name] = _coerce(value, fields[name], name)
        return out

    @classmethod
    def from_dict(cls, params: Dict[str, Any]) -> "Config":
        """Defaults, then ``params`` (``_fields_of``)."""
        return cls(**cls._fields_of(params))

    def update(self, params: Dict[str, Any]) -> None:
        """Set ``params`` (``_fields_of``) on this config, as the JAX
        ``Config.update`` does mid-training (``Booster.reset_parameter``;
        the caller validates again)."""
        for name, value in self._fields_of(params).items():
            setattr(self, name, value)

    @property
    def num_tree_per_iteration(self) -> int:
        if self.objective in ("multiclass", "multiclassova"):
            return self.num_class
        return 1

    @property
    def label_gain_or_default(self) -> List[float]:
        """lambdarank's and ndcg's gain of each label: ``label_gain``, or
        2^i - 1 for the labels 0..30 (JAX config.py:963)."""
        if self.label_gain:
            return list(self.label_gain)
        return [float((1 << i) - 1) for i in range(31)]


# ROADMAP queue 1 items that port what the training slice refuses.
# Ported: bagging, feature fraction and extra_trees; callbacks and early
# stopping (engine.py, callback.py); hist_dtype_deep=int8sr, hist_dtype=
# int8 and hist_dtype_deep=int8; hist_method=onehot|bench, force_col_wise /
# force_row_wise and int16 bins.  These items keep their names for
# ROADMAP's record of them, and nothing refuses with them any more.
SAMPLING = "bagging and feature fraction"
CALLBACKS = "callbacks and early stopping"
INT8 = "int8sr histograms"
INT8_PLAIN = "plain int8 histograms"
HIST_METHODS = "histogram methods onehot and bench"
BREADTH = "breadth of objectives and boosting"
NATIVE = "native C++ bulk predictor"
TREESHAP = "TreeSHAP and prediction early stopping"
CLI = "CLI"
HTTP = "HTTP front-end"
FLEET = "fleet and router"
TENANTS = "tenants and placement"
SLOS = "SLOs"
DRIFT = "drift"
FAILURE = "failure domains of the server"
OBSERVABILITY = "observability"
SHARDED_PREDICT = "row-sharded predict"
PARALLEL = "parallel learners"

# knob -> (is it set away from its default?, what it is, ROADMAP item)
_UNPORTED = (
    ("boosting", lambda c: c.boosting != "gbdt",
     "boosting={v} (GOSS, DART, RF)", BREADTH),
    ("tree_learner", lambda c: c.tree_learner not in ("serial", ""),
     "tree_learner={v}", PARALLEL),
    ("interaction_constraints", lambda c: bool(c.interaction_constraints),
     "interaction constraints", BREADTH),
    ("forcedsplits_filename", lambda c: bool(c.forcedsplits_filename),
     "forced splits", BREADTH),
    ("cegb_penalty_split", lambda c: c.cegb_penalty_split > 0, "CEGB",
     BREADTH),
    ("categorical_feature", lambda c: bool(c.categorical_feature),
     "categorical features", BREADTH),
)


# the other knobs of the JAX package the port does not run, by ROADMAP
# item: each is refused when a config sets it away from its default
_REFUSED = (
    (BREADTH, ("alpha", "fair_c", "poisson_max_delta_step",
               "tweedie_variance_power", "objective_seed", "auc_mu_weights",
               "drop_rate", "max_drop", "skip_drop", "xgboost_dart_mode",
               "uniform_drop", "drop_seed", "top_rate", "other_rate",
               "min_data_per_group", "max_cat_threshold", "cat_l2",
               "cat_smooth", "max_cat_to_onehot",
               "cegb_tradeoff", "cegb_penalty_feature_lazy",
               "cegb_penalty_feature_coupled", "forcedbins_filename",
               "max_bin_by_feature", "saved_feature_importance_type",
               "snapshot_freq", "finite_guard")),
    (TREESHAP, ("predict_contrib", "pred_early_stop", "pred_early_stop_freq",
                "pred_early_stop_margin")),
    (CLI, ("config", "task", "data", "valid", "output_model",
           "input_model", "output_result", "initscore_filename",
           "valid_data_initscores", "two_round", "save_binary", "header",
           "label_column", "weight_column", "group_column", "ignore_column",
           "predict_raw_score", "predict_leaf_index",
           "start_iteration_predict", "num_iteration_predict",
           "convert_model_language", "convert_model", "metric_freq",
           "is_provide_training_metric", "refit_decay_rate", "snapshot_keep")),
    (HTTP, ("serve_http_port", "serve_duration_s")),
    (FLEET, ("serve_replicas", "router_health_period_ms",
             "router_eject_after", "router_readmit_after", "router_retry_max",
             "router_hedge_ms", "router_deadline_ms")),
    (TENANTS, ("tenant_manifest", "placement_replicas_per_tenant",
               "placement_burn_threshold", "placement_occupancy_frac",
               "placement_cooldown_s")),
    (SLOS, ("serve_slo_availability_target", "serve_slo_latency_ms",
            "serve_slo_latency_target", "serve_slo_fast_window_s",
            "serve_slo_slow_window_s")),
    (DRIFT, ("drift_sample_rows", "drift_per_batch_rows", "drift_min_rows",
             "drift_psi_threshold", "drift_top_k", "drift_psi_groups",
             "drift_sample_stride", "drift_score_bins")),
    (FAILURE, ("serve_degrade_trees", "serve_breaker_failures",
               "serve_watchdog_ms")),
    (OBSERVABILITY, ("profile_dir", "obs_trace", "trace_out",
                     "obs_ring_events", "obs_event_ring", "crash_dir",
                     "obs_dir")),
    (PARALLEL, ("top_k", "num_machines", "local_listen_port", "machines",
                "time_out", "machine_list_filename", "pre_partition",
                "data_parallel_collective", "num_shards", "num_hosts",
                "hier_ici_gbps", "hier_dcn_gbps", "elastic_lease_timeout_s",
                "elastic_max_restarts", "stream_enable", "stream_block_rows",
                "stream_prefetch", "stream_cache_dir")),
)


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error every refused training configuration raises."""
    return NotImplementedError(
        f"{what} is not ported to lightgbmv1_tpu_torch yet: ROADMAP "
        f"queue 1, {item}")


def unported_reason(config: Config) -> Optional[str]:
    """``None`` when every knob the config sets is one the port trains
    with; else one line naming the first knob that is not and the ROADMAP
    item that will port it."""
    for name, is_set, what, item in _UNPORTED:
        if is_set(config):
            return str(not_ported(what.format(v=getattr(config, name)),
                                  item))
    fields = {f.name: f for f in dataclasses.fields(Config)}
    for item, names in _REFUSED:
        for name in names:
            f, v = fields[name], getattr(config, name)
            default = (f.default_factory() if f.default is dataclasses.MISSING
                       else f.default)
            if v != default:
                return str(not_ported(f"{name}={v}", item))
    return None


def _coerce(value: Any, f: dataclasses.Field, name: str) -> Any:
    if f.default is dataclasses.MISSING:          # a list field
        if isinstance(value, (list, tuple)):
            items = list(value)
        elif isinstance(value, str):
            items = [s for s in value.replace(",", " ").split() if s]
        else:
            items = [value]
        kind = str(f.type)
        if "int" in kind:
            return [int(float(x)) for x in items]
        if "float" in kind:
            return [float(x) for x in items]
        return [str(x) for x in items]
    default = f.default
    if isinstance(default, bool):
        if isinstance(value, str):
            lv = value.strip().lower()
            if lv in _BOOL_TRUE:
                return True
            if lv in _BOOL_FALSE:
                return False
            raise ValueError(f"Cannot parse bool parameter {name}={value}")
        return bool(value)
    if isinstance(default, int):
        return int(float(value))
    if isinstance(default, float):
        return float(value)
    if name == "categorical_feature" and isinstance(value, (list, tuple)):
        return ",".join(str(x) for x in value)
    return str(value)
