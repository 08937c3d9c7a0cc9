"""The port's configuration and metrics against the JAX package's.

Every knob the JAX ``Config`` knows is a field of the port's: the port
either runs it (``gpu_use_dp``, mapped as the JAX package maps it) or
refuses it with its ROADMAP item when a config sets it away from its
default; a name the JAX package does not know warns, as there.  The
metrics: ``binary_error`` is ported and equals the JAX metric on the same
predictions; a metric name the JAX package has and the port lacks raises
with its item; an unknown name warns.  Refusals elsewhere name their items.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from lightgbmv1_tpu import metrics as jax_metrics
from lightgbmv1_tpu.config import Config as JaxConfig
from lightgbmv1_tpu.config import _ALIASES as JAX_ALIASES

from lightgbmv1_tpu_torch import Booster, Dataset, train
from lightgbmv1_tpu_torch import config as tconfig
from lightgbmv1_tpu_torch import metrics as tmetrics
from lightgbmv1_tpu_torch.config import Config, unported_reason
from lightgbmv1_tpu_torch.ops.split import (FeatureMeta, SplitParams,
                                            with_tables)
from lightgbmv1_tpu_torch.parallel.trainer import (build_trainer,
                                                   select_bin_layout)

CPU = torch.device("cpu")
DATA = os.path.join(os.path.dirname(__file__), "data")
_REFUSED = [(name, item) for item, names in tconfig._REFUSED
            for name in names]
_FIELDS = {f.name: f for f in dataclasses.fields(Config)}
# the knobs the port refused until the CLI (ROADMAP queue 1, item 4) and
# TreeSHAP and prediction early stopping (item 3) ported them
_CLI_AND_TREESHAP = [
    "predict_contrib", "pred_early_stop", "pred_early_stop_freq",
    "pred_early_stop_margin", "config", "task", "data", "valid",
    "output_model", "input_model", "output_result", "valid_data_initscores",
    "save_binary", "predict_raw_score", "predict_leaf_index",
    "start_iteration_predict", "num_iteration_predict",
    "convert_model_language", "convert_model", "metric_freq",
    "is_provide_training_metric", "refit_decay_rate", "snapshot_keep",
    "snapshot_freq"]
# the knobs the port refused until the HTTP front-end, tenants, SLOs,
# drift, the server's failure domains and the observability core (ROADMAP
# queue 1 items 6 and 8-11, part of 12) ported them
_SERVE_AND_OBS = [
    "serve_http_port", "serve_duration_s", "tenant_manifest",
    "serve_slo_availability_target", "serve_slo_latency_ms",
    "serve_slo_latency_target", "serve_slo_fast_window_s",
    "serve_slo_slow_window_s", "drift_sample_rows", "drift_per_batch_rows",
    "drift_min_rows", "drift_psi_threshold", "drift_top_k",
    "drift_psi_groups", "drift_sample_stride", "drift_score_bins",
    "serve_degrade_trees", "serve_breaker_failures", "serve_watchdog_ms",
    "obs_trace", "trace_out", "obs_ring_events", "obs_event_ring",
    "crash_dir"]
# the knobs the port refused until the fleet, the router and placement
# (ROADMAP queue 1 item 7) and the rest of observability (item 12) ported
# them
_FLEET_AND_OBS = [
    "serve_replicas", "router_health_period_ms", "router_eject_after",
    "router_readmit_after", "router_retry_max", "router_hedge_ms",
    "router_deadline_ms", "placement_replicas_per_tenant",
    "placement_burn_threshold", "placement_occupancy_frac",
    "placement_cooldown_s", "profile_dir", "obs_dir"]
# the knobs the port refused with the parallel learners' item until
# out-of-core streaming (ROADMAP queue 1 item 14.1) ported them
_STREAM = ["stream_enable", "stream_block_rows", "stream_prefetch",
           "stream_cache_dir"]
# the knobs the port refused with the parallel learners' item until the
# data, feature and voting learners and the cluster bring-up (ROADMAP
# queue 1 item 14.2) ported them; data_parallel_collective's
# ``hierarchical`` and the quantized legs stay refused (item 14.2b)
_PARALLEL_142 = ["top_k", "num_machines", "local_listen_port", "machines",
                 "time_out", "machine_list_filename", "pre_partition",
                 "data_parallel_collective", "num_shards"]
# the knobs the port refused with its breadth item until that item's
# part 1.6 ported them (categorical features, CEGB)
_PART_16 = ["min_data_per_group", "max_cat_threshold", "cat_l2",
            "cat_smooth", "max_cat_to_onehot", "cegb_tradeoff",
            "cegb_penalty_feature_lazy", "cegb_penalty_feature_coupled"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny trainings here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _default(name):
    f = _FIELDS[name]
    return f.default_factory() if f.default is dataclasses.MISSING \
        else f.default


def _other_value(name):
    """A value of the knob's type away from its default."""
    d = _default(name)
    if isinstance(d, bool):
        return not d
    if isinstance(d, int):
        return d + 3
    if isinstance(d, float):
        return d + 0.25
    if isinstance(d, str):
        return d + "x"
    kind = str(_FIELDS[name].type)
    return [7] if "int" in kind else [0.5] if "float" in kind else ["x"]


def test_every_jax_knob_and_alias_is_known():
    """The port's fields and aliases hold every one of the JAX package's;
    each field is ported, refused with its item, or one that changes no
    model there either."""
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    assert jax_fields <= set(_FIELDS)
    assert set(JAX_ALIASES.items()) <= set(tconfig._ALIASES.items())
    refused = {n for n, _ in _REFUSED}
    assert len(refused) == len(_REFUSED)
    handled = refused | {n for n, *_ in tconfig._UNPORTED}
    # the knobs the port runs, and those that change no model in the JAX
    # package either (device selection, XLA execution knobs, knobs it
    # reads nowhere)
    runs = {"objective", "boosting", "num_iterations", "learning_rate",
            "num_leaves", "tree_learner", "seed", "max_depth",
            "min_data_in_leaf", "min_sum_hessian_in_leaf", "lambda_l1",
            "lambda_l2", "min_gain_to_split", "verbosity", "bagging_fraction",
            "pos_bagging_fraction", "neg_bagging_fraction",
            "feature_fraction_bynode", "leafwise_wave_size",
            "wave_loop_rounds", "hist_dtype", "bin_layout", "max_bin",
            "min_data_in_bin",
            "bin_construct_sample_cnt", "feature_pre_filter",
            "data_random_seed", "enable_bundle", "max_conflict_rate",
            "use_missing", "zero_as_missing", "num_class", "is_unbalance",
            "scale_pos_weight", "sigmoid", "boost_from_average", "metric",
            "gpu_use_dp", "predict_disable_shape_check", "tree_growth",
            "histogram_pool_size", "reg_sqrt", "lambdarank_truncation_level",
            "lambdarank_norm", "label_gain", "eval_at", "multi_error_top_k",
            "max_delta_step", "path_smooth", "monotone_constraints",
            "monotone_constraints_method", "monotone_penalty",
            "feature_contri", "bagging_freq", "feature_fraction",
            "bagging_seed", "feature_fraction_seed", "hist_dtype_deep",
            "extra_trees", "extra_seed", "early_stopping_round",
            "first_metric_only", "hist_method", "force_col_wise",
            "force_row_wise", "alpha", "fair_c", "poisson_max_delta_step",
            "tweedie_variance_power", "objective_seed", "auc_mu_weights",
            "drop_rate", "max_drop", "skip_drop", "xgboost_dart_mode",
            "uniform_drop", "drop_seed", "top_rate", "other_rate",
            "max_bin_by_feature", "forcedbins_filename",
            "saved_feature_importance_type", "finite_guard", "header",
            "label_column", "weight_column", "group_column",
            "ignore_column", "two_round", "initscore_filename",
            "interaction_constraints", "forcedsplits_filename",
            "cegb_penalty_split", "categorical_feature"} | set(_PART_16) \
        | set(_CLI_AND_TREESHAP) | set(_SERVE_AND_OBS) \
        | set(_FLEET_AND_OBS) | set(_STREAM) | set(_PARALLEL_142)
    runs |= {n for n in _FIELDS if n.startswith(("predict_", "serve_",
                                                 "registry_"))} - refused
    inert = {"device_type", "deterministic", "is_enable_sparse",
             "gpu_platform_id", "gpu_device_id", "fused_bookkeeping",
             "async_wave_pipeline", "donate_buffers",
             "predict_cache_entries", "num_threads"}
    assert set(_FIELDS) - handled - runs - inert == set()
    assert not inert & handled


@pytest.mark.parametrize("name", _CLI_AND_TREESHAP)
def test_cli_and_treeshap_knob_is_accepted(name, capsys):
    """A knob refused until items 3-4 ported it: a field the JAX package
    knows, set without a warning, and a config that sets it is not
    refused."""
    value = _other_value(name)
    assert name in {f.name for f in dataclasses.fields(JaxConfig)}
    assert name not in {n for n, _ in _REFUSED}
    cfg = Config.from_dict({"objective": "binary", name: value})
    assert "Unknown parameter" not in capsys.readouterr().err
    assert getattr(cfg, name) == value
    assert unported_reason(cfg) is None


@pytest.mark.parametrize("name", _FLEET_AND_OBS)
def test_fleet_and_obs_knob_is_accepted(name, capsys):
    """A knob refused until items 7 and 12 ported it: a field the JAX
    package knows, set without a warning, and a config that sets it is
    not refused."""
    value = _other_value(name)
    assert name in {f.name for f in dataclasses.fields(JaxConfig)}
    assert name not in {n for n, _ in _REFUSED}
    cfg = Config.from_dict({"objective": "binary", name: value})
    assert "Unknown parameter" not in capsys.readouterr().err
    assert getattr(cfg, name) == value
    assert unported_reason(cfg) is None


@pytest.mark.parametrize("name", _STREAM)
def test_stream_knob_is_accepted(name, capsys):
    """A knob refused until item 14.1 ported out-of-core streaming: a
    field the JAX package knows, set without a warning, and a config that
    sets it is not refused."""
    value = _other_value(name)
    assert name in {f.name for f in dataclasses.fields(JaxConfig)}
    assert name not in {n for n, _ in _REFUSED}
    cfg = Config.from_dict({"objective": "binary", name: value})
    assert "Unknown parameter" not in capsys.readouterr().err
    assert getattr(cfg, name) == value
    assert unported_reason(cfg) is None


@pytest.mark.parametrize("name", _PARALLEL_142)
def test_parallel_knob_is_accepted(name, capsys):
    """A knob refused until item 14.2 ported the parallel learners: a
    field the JAX package knows, set without a warning, and a config
    that sets it is not refused (``data_parallel_collective`` at
    ``allreduce``, its other flat collective)."""
    value = {"data_parallel_collective": "allreduce"}.get(
        name, _other_value(name))
    assert name in {f.name for f in dataclasses.fields(JaxConfig)}
    assert name not in {n for n, _ in _REFUSED}
    cfg = Config.from_dict({"objective": "binary", name: value})
    assert "Unknown parameter" not in capsys.readouterr().err
    assert getattr(cfg, name) == value
    assert unported_reason(cfg) is None


@pytest.mark.parametrize("params", [
    {"data_parallel_collective": "hierarchical"},
    {"tree_learner": "data", "hist_dtype": "int8"},
    {"tree_learner": "voting", "hist_dtype_deep": "int8"},
    {"tree_learner": "feature", "hist_dtype_deep": "int8sr"}],
    ids=["hierarchical", "int8", "int8-deep", "int8sr"])
def test_parallel_legs_refused_with_their_item(params):
    """The parallel learners' quantized and hierarchical legs name item
    14.2b; the same precisions train the serial learner."""
    why = unported_reason(Config.from_dict(dict(params,
                                                objective="binary")))
    assert why is not None and why.endswith(
        f"ROADMAP queue 1, {tconfig.PARALLEL_LEGS}")
    serial = {k: v for k, v in params.items() if k != "tree_learner"}
    if "data_parallel_collective" not in serial:
        assert unported_reason(Config.from_dict(serial)) is None


@pytest.mark.parametrize("name", _SERVE_AND_OBS)
def test_serve_and_obs_knob_is_accepted(name, capsys):
    """A knob refused until items 6 and 8-11 (and part of 12) ported it:
    a field the JAX package knows, set without a warning, and a config
    that sets it is not refused (an SLO target stays inside (0, 1))."""
    value = {"serve_slo_availability_target": 0.99,
             "serve_slo_latency_target": 0.9}.get(name, _other_value(name))
    assert name in {f.name for f in dataclasses.fields(JaxConfig)}
    assert name not in {n for n, _ in _REFUSED}
    cfg = Config.from_dict({"objective": "binary", name: value})
    assert "Unknown parameter" not in capsys.readouterr().err
    assert getattr(cfg, name) == value
    assert unported_reason(cfg) is None


@pytest.mark.parametrize("name,item", _REFUSED,
                         ids=[n for n, _ in _REFUSED])
def test_refused_knob_raises_with_its_item(name, item, capsys):
    """A JAX knob the port does not run is a field, not an unknown name
    (no warning), and a config that sets it is refused with its item."""
    value = _other_value(name)
    assert name in {f.name for f in dataclasses.fields(JaxConfig)}
    cfg = Config.from_dict({"objective": "binary", name: value})
    assert "Unknown parameter" not in capsys.readouterr().err
    why = unported_reason(cfg)
    assert why is not None and why.startswith(f"{name}=")
    assert why.endswith(f"ROADMAP queue 1, {item}")
    assert unported_reason(Config.from_dict({"objective": "binary"})) is None


def test_training_refuses_a_dropped_knob():
    """train raises for a refused knob on the Booster's params (the
    elastic knob ``elastic_max_restarts`` of the parallel learners' item,
    14.3; the prediction early
    stopping it refused until item 3 trains, the span tracer it refused
    until item 11 ported it, and ``obs_dir`` / ``profile_dir``, CLI knobs
    since item 12 ported them, are accepted and ignored, as by the JAX
    library); the knobs
    refused until part 1.6 train (a lazy CEGB penalty of the wrong size
    is fatal, as in the JAX package) and a Dataset with categorical
    features bins (the binning knobs it refused until part 1.7 bin
    too)."""
    from lightgbmv1_tpu_torch.utils.log import LightGBMError

    rng = np.random.RandomState(0)
    X = rng.randn(300, 3)
    y = (X[:, 0] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"ROADMAP queue 1, "
                                       f"{tconfig.PARALLEL}") + "$"):
        train(dict(params, elastic_max_restarts=5), Dataset(X, label=y),
              2, device="cpu")
    assert train(dict(params, obs_dir="obs", profile_dir="prof"),
                 Dataset(X, label=y), 2, device="cpu").num_trees() == 2
    assert not os.path.exists("obs") and not os.path.exists("prof")
    assert train(dict(params, obs_trace=True), Dataset(X, label=y), 2,
                 device="cpu").num_trees() == 2
    assert train(dict(params, pred_early_stop=True), Dataset(X, label=y), 2,
                 device="cpu").num_trees() == 2
    with pytest.raises(LightGBMError, match="cegb_penalty_feature_lazy"):
        train(dict(params, cegb_penalty_feature_lazy=[1.0, 0.5]),
              Dataset(X, label=y), 2, device="cpu")
    assert train(dict(params, cegb_penalty_feature_lazy=[.01, .005, .01]),
                 Dataset(X, label=y), 2, device="cpu").num_trees() == 2
    Xc = np.column_stack([rng.randint(0, 5, 300), X[:, 1:]])
    assert Dataset(Xc, label=y, categorical_feature=[0]).construct() \
        ._binned.bin_mappers[0].bin_2_categorical != []
    ds = Dataset(X, label=y, params={"max_bin_by_feature": [15, 15, 15]}
                 ).construct()
    assert int(ds._binned.num_bins.max()) <= 15


@pytest.fixture
def _keep_verbosity():
    """A training at verbosity -1 silences the module-wide log level; put
    it back for the tests after."""
    from lightgbmv1_tpu_torch.utils import log

    saved = log._level
    yield
    log._level = saved


@pytest.mark.parametrize("name", _PART_16)
def test_part_16_knob_trains(name, _keep_verbosity):
    """A knob refused until part 1.6 is a field the port runs now: no
    refusal, and two iterations train on categorical data (column 0)."""
    value = _other_value(name)
    if name.startswith("cegb_penalty_feature"):
        value = [0.005, 0.0025, 0.01]
    cfg = Config.from_dict({"objective": "binary", name: value})
    assert unported_reason(cfg) is None
    rng = np.random.RandomState(1)
    X = np.column_stack([rng.randint(0, 9, 400), rng.randn(400, 2)])
    y = (np.isin(X[:, 0], [1, 4, 6]) ^ (X[:, 1] > 1)).astype(float)
    b = train({"objective": "binary", "num_leaves": 7, "verbosity": -1,
               "min_data_per_group": 10, name: value},
              Dataset(X, label=y, categorical_feature=[0]), 2, device="cpu")
    assert b.num_trees() == 2 and np.isfinite(b.predict(X)).all()


def test_unknown_name_warns(capsys):
    Config.from_dict({"no_such_knob": 1})
    assert "Unknown parameter: no_such_knob" in capsys.readouterr().err


def _tiny_binary():
    rng = np.random.RandomState(4)
    X = rng.randn(600, 4)
    y = (X[:, 0] - 0.5 * X[:, 2] + rng.randn(600) > 0).astype(float)
    return X, y


_TINY = {"objective": "binary", "num_leaves": 7, "max_bin": 15,
         "verbosity": 0}


@pytest.mark.parametrize("extra", [
    {"linear_tree": True}, {"num_threads": 4}, {"n_jobs": -1},
    {"nthread": 2}], ids=["linear_tree", "num_threads", "n_jobs", "nthread"])
def test_model_neutral_keys_train_the_same_text(extra, capsys):
    """``linear_tree`` is no knob of the JAX package: it warns as an
    unknown name and trains.  ``num_threads`` (and its aliases, which the
    JAX sklearn wrapper sends) is accepted and changes no model.  Either
    way the model text is the one trained without the key."""
    X, y = _tiny_binary()

    def text(params):
        return train(params, Dataset(X, label=y), 3,
                     device="cpu").model_to_string()

    base = text(dict(_TINY))
    capsys.readouterr()
    assert text(dict(_TINY, **extra)) == base
    unknown = "Unknown parameter: linear_tree" in capsys.readouterr().err
    assert unknown == ("linear_tree" in extra)
    assert unported_reason(Config.from_dict(dict(_TINY, **extra))) is None


def test_jax_package_trains_through_linear_tree_and_num_threads(capsys):
    """The JAX package on the same data: ``linear_tree`` warns as an
    unknown name, ``num_threads`` is accepted, and both train the text of
    the training without them, as the port does."""
    import lightgbmv1_tpu as lj
    X, y = _tiny_binary()

    def text(params):
        return lj.train(params, lj.Dataset(X, label=y),
                        3).model_to_string()

    base = text(dict(_TINY))
    capsys.readouterr()
    assert text(dict(_TINY, linear_tree=True)) == base
    assert "Unknown parameter: linear_tree" in capsys.readouterr().err
    assert text(dict(_TINY, num_threads=4)) == base
    assert "Unknown parameter" not in capsys.readouterr().err


@pytest.mark.parametrize("gpu_use_dp", [False, True])
@pytest.mark.parametrize("deep", ["", "auto", "f32", "bf16", "bf16x2",
                                  "int8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "bf16x2", "int8"])
def test_gpu_use_dp_resolves_as_jax(dtype, deep, gpu_use_dp):
    """gpu_use_dp maps onto f32 histograms, deep rounds included unless
    hist_dtype_deep is explicit: the JAX Config's resolved values."""
    params = {"hist_dtype": dtype, "hist_dtype_deep": deep,
              "gpu_use_dp": gpu_use_dp}
    want = JaxConfig.from_dict(dict(params))
    got = Config.from_dict(dict(params))
    assert (got.hist_dtype, got.hist_dtype_deep) == (want.hist_dtype,
                                                    want.hist_dtype_deep)


def test_gpu_use_dp_keeps_byte_bins_and_f32_deep_rounds(capsys):
    """gpu_use_dp keeps byte bins where auto would pack (and an explicit
    packed4 warns and stores u8), and turns int8sr deep rounds into f32,
    as the JAX trainer does."""
    dp = Config.from_dict({"objective": "binary", "gpu_use_dp": True,
                           "hist_method": "pallas"})
    assert select_bin_layout(dp, num_total_bin=15, device=CPU) == "u8"
    assert select_bin_layout(Config.from_dict({"hist_method": "pallas"}),
                             num_total_bin=15, device=CPU) == "packed4"
    packed = Config.from_dict({"objective": "binary", "gpu_use_dp": True,
                               "bin_layout": "packed4"})
    assert unported_reason(packed) is None
    assert select_bin_layout(packed, num_total_bin=15, device=CPU) == "u8"
    assert "storing u8 bins" in capsys.readouterr().err
    sr = Config.from_dict({"objective": "binary", "gpu_use_dp": True,
                           "hist_dtype_deep": "int8sr", "num_leaves": 15})
    assert unported_reason(sr) is None
    meta = with_tables(FeatureMeta(*(torch.zeros(2, dtype=torch.int64),) * 4,
                                   usable=torch.ones(2, dtype=torch.bool)))
    build_trainer(sr, meta, SplitParams(), 64, CPU)
    assert "int8sr disabled, deep rounds run f32" in capsys.readouterr().err
    assert unported_reason(Config.from_dict(
        {"objective": "binary", "hist_dtype_deep": "int8sr"})) is None
    # plain int8 trains; gpu_use_dp maps hist_dtype=int8 to f32 (JAX
    # config.py:945) and keeps an explicit int8 deep precision
    assert unported_reason(Config.from_dict(
        {"objective": "binary", "hist_dtype_deep": "int8"})) is None
    i8 = Config.from_dict({"objective": "binary", "gpu_use_dp": True,
                           "hist_dtype": "int8", "hist_dtype_deep": "int8"})
    assert (i8.hist_dtype, i8.hist_dtype_deep) == ("f32", "int8")


def test_gpu_use_dp_trains_the_f32_model():
    """Training with gpu_use_dp writes the model text of training with
    f32 histograms (the knob's whole effect), not the bf16x2 one."""
    rng = np.random.RandomState(3)
    X = rng.randn(2000, 4)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.randn(2000) > 0).astype(float)
    base = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
            "hist_method": "pallas", "verbosity": -1}

    def text(**kw):
        return train(dict(base, **kw), Dataset(X, label=y), 3,
                     device="cpu").model_to_string()

    f32 = text(hist_dtype="f32", hist_dtype_deep="f32")
    assert text(gpu_use_dp=True) == f32
    assert text() != f32


class _Meta:
    def __init__(self, label, weight):
        self.label, self.weight = label, weight


@pytest.mark.parametrize("weighted", [False, True])
def test_binary_error_matches_jax(weighted):
    rng = np.random.RandomState(1)
    n = 1000
    label = (rng.rand(n) < 0.4).astype(np.float64)
    weight = rng.rand(n) + 0.5 if weighted else None
    pred = rng.rand(n)
    pred[:20] = 0.5                              # on the threshold
    got = tmetrics.BinaryErrorMetric(Config())
    got.init(_Meta(label, weight), n)
    want = jax_metrics.BinaryErrorMetric(JaxConfig())
    want.init(_Meta(label, weight), n)
    assert got.eval(pred) == want.eval(pred)
    assert got.eval(pred)[0][0] == "binary_error"


def test_binary_error_is_evaluated_in_training():
    rng = np.random.RandomState(2)
    X = rng.randn(600, 3)
    y = (X[:, 0] > 0).astype(float)
    ev = {}
    train({"objective": "binary", "num_leaves": 15, "verbosity": -1,
           "metric": "binary_error,auc"}, Dataset(X[:400], label=y[:400]), 2,
          valid_sets=[Dataset(X[400:], label=y[400:])], evals_result=ev,
          device="cpu")
    assert set(ev["valid_0"]) == {"binary_error", "auc"}
    assert 0.0 <= ev["valid_0"]["binary_error"][-1] < 0.5


@pytest.mark.parametrize("name,item", [
    ("l1", tconfig.BREADTH), ("poisson", tconfig.BREADTH),
    ("gamma_deviance", tconfig.BREADTH), ("cross_entropy", tconfig.BREADTH),
    ("quantile", tconfig.BREADTH), ("auc_mu", tconfig.BREADTH)])
def test_unported_jax_metric_raises(name, item):
    """The JAX package's metrics the port refused with ``item`` until
    that item's part 1.3 ported them: each now builds the JAX package's
    metric, and no metric name is refused any more."""
    got = tmetrics.create_metrics(Config.from_dict({"metric": [name]}))
    want = jax_metrics.create_metrics(JaxConfig.from_dict(
        {"metric": [name]}))
    assert [m.name for m in got] == [m.name for m in want] == [name]
    assert not hasattr(tmetrics, "_UNPORTED_METRICS")


def test_unknown_metric_warns(capsys):
    out = tmetrics.create_metrics(Config.from_dict(
        {"metric": "no_such_metric,auc"}))
    assert [m.name for m in out] == ["auc"]
    assert "Unknown metric no_such_metric" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [
    {"pred_contrib": True}, {"pred_early_stop": True},
    {"predict_method": "native"}], ids=["pred_contrib", "pred_early_stop",
                                        "native"])
def test_prediction_knobs_refused_until_ported_work(kw):
    """TreeSHAP, prediction early stopping and the native walk, refused
    until items 2-3 ported them, give the JAX package's predictions."""
    from lightgbmv1_tpu import Booster as JaxBooster

    path = os.path.join(DATA, "golden_zero_model.txt")
    pb, jb = Booster(model_file=path, device="cpu"), JaxBooster(
        model_file=path)
    X = np.random.RandomState(0).randn(16, pb.num_feature())
    np.testing.assert_allclose(pb.predict(X, **kw), jb.predict(X, **kw),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw,item", [
    ({"predict_method": "scan"}, tconfig.SHARDED_PREDICT),
    ({"predict_method": "fused", "predict_num_shards": 2},
     tconfig.SHARDED_PREDICT)])
def test_prediction_refusals_name_their_items(kw, item):
    pb = Booster(model_file=os.path.join(DATA, "golden_zero_model.txt"),
                 device="cpu")
    X = np.zeros((4, pb.num_feature()))
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"ROADMAP queue 1, {item}") + "$"):
        pb.predict(X, **kw)
