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
            "force_row_wise"}
    runs |= {n for n in _FIELDS if n.startswith(("predict_", "serve_",
                                                 "registry_"))} - refused
    inert = {"device_type", "deterministic", "is_enable_sparse",
             "gpu_platform_id", "gpu_device_id", "fused_bookkeeping",
             "async_wave_pipeline", "donate_buffers",
             "predict_cache_entries", "num_threads"}
    assert set(_FIELDS) - handled - runs - inert == set()
    assert not inert & handled


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
    """train raises for a refused knob on the Booster's params, and a
    binning knob on the Dataset's params is refused before it bins."""
    rng = np.random.RandomState(0)
    X = rng.randn(300, 3)
    y = (X[:, 0] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    with pytest.raises(NotImplementedError,
                       match="cegb_penalty_feature_lazy"):
        train(dict(params, cegb_penalty_feature_lazy=[1.0, 0.5, 1.0]),
              Dataset(X, label=y), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="max_bin_by_feature"):
        Dataset(X, label=y, params={"max_bin_by_feature": [15, 15, 15]}
                ).construct()
    with pytest.raises(NotImplementedError, match="forcedbins_filename"):
        Dataset(X, label=y, params={"forcedbins_filename": "bins.json"}
                ).construct()


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
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"metric={name.split(',')[0]}")
                       + ".*" + re.escape(item)):
        tmetrics.create_metrics(Config.from_dict({"metric": [name]}))


def test_unknown_metric_warns(capsys):
    out = tmetrics.create_metrics(Config.from_dict(
        {"metric": "no_such_metric,auc"}))
    assert [m.name for m in out] == ["auc"]
    assert "Unknown metric no_such_metric" in capsys.readouterr().err


@pytest.mark.parametrize("kw,item", [
    ({"pred_contrib": True}, tconfig.TREESHAP),
    ({"pred_early_stop": True}, tconfig.TREESHAP),
    ({"predict_method": "native"}, tconfig.NATIVE),
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
