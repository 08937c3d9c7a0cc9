"""The port's binary leaf-wise training held against the JAX package's.

Both packages train on the CPU on the same numpy rows: the JAX package
with ``hist_method=pallas`` (the Pallas histogram kernel in interpret
mode), the port with ``hist_method=pallas`` (K1's plain version) and
``device="cpu"``.  ``_BUCKET_MIN_N`` is lowered in both growers so the
slot-bucketed rounds run at these sizes.

Tolerances:
* bin boundaries and bins: bit-identical (host float64 in both);
* gradients: rtol 1e-6 (``torch.sigmoid`` and XLA's logistic differ in
  the last ulp); boost-from-average: 1e-12;
* one split scan on one histogram: same feature, threshold bin and
  default direction, gain and left sums within rtol 1e-6;
* f32 lane: trees identical in structure at every node; leaf values
  within 2e-5 (about 1e-4 of the largest leaf): the histograms sum in
  another f32 order, and the larger child's histogram is its parent's
  minus the smaller's, so that difference is carried down the tree;
* bf16x2 lane: raw predictions within 2e-5;
* per-iteration binary_logloss within 1e-6; AUC within 1e-4 (a score
  that moves by 1e-5 can swap a near-tied pair of the 512 valid rows,
  1.5e-5 of AUC a pair).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.config import Config as JConfig
from lightgbmv1_tpu.io.dataset import BinnedDataset as JDataset
from lightgbmv1_tpu.models import grower_wave as jgw
from lightgbmv1_tpu.objectives import create_objective as jcreate_objective
from lightgbmv1_tpu.ops import split as jsplit

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch import config as tconfig
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.dataset import BinnedDataset
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.convert import (bin_mappers_from_numpy,
                                                 tree_arrays_from_numpy)
from lightgbmv1_tpu_torch.objectives import create_objective
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops.histogram import hist_leaves_scatter
from lightgbmv1_tpu_torch.parallel.trainer import select_bin_layout

DATA = os.path.join(os.path.dirname(__file__), "data")
N, F = 4096, 6
BASE = {"objective": "binary", "min_data_in_leaf": 5, "verbosity": -1,
        "max_bin": 63, "metric": "binary_logloss,auc"}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def low_buckets():
    """Both growers bucket their slots from 1 row, so the 4-slot ramp,
    the middle bucket and the sustained (deep) rounds all run here."""
    saved = jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N
    jgw._BUCKET_MIN_N = tgw._BUCKET_MIN_N = 1
    yield
    jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N = saved


def _data(seed, n=N):
    """NaNs (features 0, 1), 30% exact zeros (feature 2), a coarse
    integer feature with many ties (3), and feature 5 a copy of 4 (an
    exact cross-feature tie: the lower feature must win)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.05, 0] = np.nan
    X[rng.rand(n) < 0.10, 1] = np.nan
    X[rng.rand(n) < 0.30, 2] = 0.0
    X[:, 3] = np.round(X[:, 3] * 2)
    X[:, 5] = X[:, 4]
    logit = (1.2 * np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 1])
             + 0.6 * X[:, 2] * X[:, 3] + 0.4 * X[:, 4])
    y = (logit + rng.randn(n) > 0).astype(np.float64)
    return X, y


# ---------------------------------------------------------------------------
# binning, gradients, one split scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [
    {}, {"zero_as_missing": True}, {"max_bin": 15, "min_data_in_bin": 1},
    {"use_missing": False}, {"bin_construct_sample_cnt": 1000},
    {"min_data_in_leaf": 1500}], ids=["default", "zero_as_missing",
                                      "max_bin15", "no_missing",
                                      "sampled", "pre_filter"])
def test_bin_mappers_bit_identical(params):
    X, _ = _data(0)
    p = dict(params, enable_bundle=False)
    jds = JDataset.from_numpy(X, config=JConfig.from_dict(p))
    tds = BinnedDataset.from_numpy(X, config=Config.from_dict(p))
    for jm, tm in zip(jds.bin_mappers, tds.bin_mappers):
        np.testing.assert_array_equal(jm.bin_upper_bound, tm.bin_upper_bound)
        assert (jm.num_bin, jm.missing_type, jm.is_trivial) == \
            (tm.num_bin, tm.missing_type, tm.is_trivial)
        assert (jm.sparse_rate, jm.min_value, jm.max_value) == \
            (tm.sparse_rate, tm.min_value, tm.max_value)
    np.testing.assert_array_equal(jds.binned, tds.binned)
    assert tds.padded_bin == jds.padded_bin
    # the carry: the JAX mappers' fields give the same codes in the port
    carried = bin_mappers_from_numpy([m.to_arrays()
                                      for m in jds.bin_mappers])
    for j, m in enumerate(carried):
        np.testing.assert_array_equal(m.value_to_bin(X[:, j]),
                                      jds.binned[j])
        assert m.zero_bin == jds.bin_mappers[j].zero_bin
        assert m.bin_to_threshold(3) == jds.bin_mappers[j].bin_to_threshold(3)


@pytest.mark.parametrize("params,weighted", [
    ({}, False), ({"is_unbalance": True}, False),
    ({"scale_pos_weight": 2.5, "sigmoid": 0.7}, True),
    ({"boost_from_average": False}, False)])
def test_binary_gradients_and_boost_from_average(params, weighted):
    X, y = _data(1)
    w = np.random.RandomState(2).rand(N) + 0.5 if weighted else None
    p = dict(params, objective="binary", enable_bundle=False)
    jds = JDataset.from_numpy(X, label=y, weight=w,
                              config=JConfig.from_dict(p))
    tds = BinnedDataset.from_numpy(X, label=y, weight=w,
                                   config=Config.from_dict(p))
    jobj = jcreate_objective(JConfig.from_dict(p))
    jobj.init(jds.metadata, N)
    tobj = create_objective(Config.from_dict(p))
    tobj.init(tds.metadata, N, CPU)
    assert abs(jobj.boost_from_score(0) - tobj.boost_from_score(0)) <= 1e-12
    s = np.random.RandomState(3).randn(N).astype(np.float32) * 2
    jg, jh = map(np.asarray, jobj.get_gradients(jax.numpy.asarray(s)))
    tg, th = (a.numpy() for a in tobj.get_gradients(torch.from_numpy(s)))
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(th, jh, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("params", [
    {}, {"zero_as_missing": True},
    {"lambda_l1": 0.5, "lambda_l2": 2.0, "min_gain_to_split": 0.01,
     "min_data_in_leaf": 40, "min_sum_hessian_in_leaf": 3.0}])
def test_find_best_split_matches(params):
    """One histogram through both scans (the JAX scan on one leaf, the
    port's on a batch of leaves): same pick, gain within rtol 1e-6."""
    X, y = _data(4)
    p = dict(params, objective="binary", enable_bundle=False)
    tds = BinnedDataset.from_numpy(X, label=y, config=Config.from_dict(p))
    jds = JDataset.from_numpy(X, label=y, config=JConfig.from_dict(p))
    rng = np.random.RandomState(5)
    B = tds.padded_bin
    g3 = np.stack([rng.randn(N), rng.rand(N) * 0.25 + 0.01,
                   np.ones(N)], axis=1).astype(np.float32)
    leaf = rng.randint(0, 3, N).astype(np.int32)
    hist = hist_leaves_scatter(torch.from_numpy(tds.binned),
                               torch.from_numpy(g3), torch.from_numpy(leaf),
                               3, B)
    parent = torch.stack([torch.from_numpy(g3[leaf == k].sum(0))
                          for k in range(3)])
    c = Config.from_dict(p)
    tp = tsplit.SplitParams(c.lambda_l1, c.lambda_l2,
                            float(c.min_data_in_leaf),
                            c.min_sum_hessian_in_leaf, c.min_gain_to_split)
    mask = torch.ones((3, F), dtype=torch.bool)
    res = tsplit.find_best_split(hist, parent, tsplit.make_feature_meta(
        tds, CPU), mask, tp)
    jmeta = jsplit.make_feature_meta(jds)
    jp = jsplit.SplitParams(lambda_l1=c.lambda_l1, lambda_l2=c.lambda_l2,
                            min_data_in_leaf=float(c.min_data_in_leaf),
                            min_sum_hessian_in_leaf=c.min_sum_hessian_in_leaf,
                            min_gain_to_split=c.min_gain_to_split)
    for k in range(3):
        jr = jsplit.find_best_split(jax.numpy.asarray(hist[k].numpy()),
                                    jax.numpy.asarray(parent[k].numpy()),
                                    jmeta, jax.numpy.ones(F, bool), jp)
        assert int(jr.feature) == int(res.feature[k])
        assert int(jr.threshold_bin) == int(res.threshold_bin[k])
        assert bool(jr.default_left) == bool(res.default_left[k])
        np.testing.assert_allclose(float(res.gain[k]), float(jr.gain),
                                   rtol=1e-6)
        np.testing.assert_allclose(res.left_sum[k].numpy(),
                                   np.asarray(jr.left_sum), rtol=1e-6,
                                   atol=1e-6)
    # feature 5 copies feature 4: an exact tie the lower feature wins
    assert int(res.feature.max()) != 5


# ---------------------------------------------------------------------------
# whole training runs
# ---------------------------------------------------------------------------


def _train_both(params, rounds, n=N, weighted=False):
    X, y = _data(10, n)
    Xv, yv = _data(11, n // 4)
    kw, vkw = {}, {}
    if weighted:      # row weights and init scores on both sets
        rng = np.random.RandomState(16)
        kw = dict(weight=rng.rand(n) + 0.5, init_score=rng.randn(n) * 0.3)
        vkw = dict(weight=rng.rand(n // 4) + 0.5,
                   init_score=rng.randn(n // 4) * 0.3)
    jev, tev = {}, {}
    jb = lj.train(params, lj.Dataset(X, label=y, **kw), rounds,
                  valid_sets=[lj.Dataset(Xv, label=yv, **vkw)],
                  evals_result=jev, verbose_eval=False)
    tb = lt.train(params, lt.Dataset(X, label=y, **kw), rounds,
                  valid_sets=[lt.Dataset(Xv, label=yv, **vkw)],
                  evals_result=tev, device="cpu")
    return dict(jb=jb, tb=tb, jev=jev, tev=tev, Xv=Xv, yv=yv)


@pytest.fixture(scope="module")
def f32_run(low_buckets):
    """15 leaves in waves of 8: buckets {4, 8}."""
    return _train_both(dict(BASE, num_leaves=15, leafwise_wave_size=8,
                            hist_method="pallas", hist_dtype="f32"), 4)


@pytest.fixture(scope="module")
def deep_run(low_buckets):
    """The deep (sustained) rounds need a wave of K >= 32, so 33 leaves:
    buckets {4, 16, 32}, the 32-slot rounds deep."""
    return _train_both(dict(BASE, num_leaves=33, leafwise_wave_size=32,
                            min_data_in_leaf=3, hist_method="pallas",
                            hist_dtype="f32"), 2, n=2048)


@pytest.fixture(scope="module")
def poolfree_run(low_buckets):
    """Above the per-leaf histogram state's cap both growers run the
    pool-free pass: both children of every split histogrammed, 2S slots."""
    saved = jgw._SUB_STATE_CAP_BYTES, tgw._SUB_STATE_CAP_BYTES
    jgw._SUB_STATE_CAP_BYTES = tgw._SUB_STATE_CAP_BYTES = 0
    try:
        return _train_both(dict(BASE, num_leaves=15, leafwise_wave_size=8,
                                hist_method="pallas", hist_dtype="f32"), 2,
                           n=2048)
    finally:
        jgw._SUB_STATE_CAP_BYTES, tgw._SUB_STATE_CAP_BYTES = saved


@pytest.fixture(scope="module")
def knobs_run(low_buckets):
    """Row weights, init scores, max_depth and the regularization knobs."""
    return _train_both(dict(BASE, num_leaves=15, leafwise_wave_size=4,
                            max_depth=4, lambda_l1=0.1, lambda_l2=1.0,
                            min_gain_to_split=0.01,
                            min_sum_hessian_in_leaf=0.5, is_unbalance=True,
                            hist_method="pallas", hist_dtype="f32"), 3,
                       n=2048, weighted=True)


@pytest.fixture(scope="module")
def bf16x2_run(low_buckets):
    """The default precisions (bf16x2, bf16 on deep rounds)."""
    return _train_both(dict(BASE, num_leaves=33, leafwise_wave_size=32,
                            min_data_in_leaf=3, hist_method="pallas"),
                       2, n=2048)


def _assert_same_trees(run, leaf_tol):
    jtrees = jax.device_get(run["jb"]._gbdt._device_trees)
    ttrees = run["tb"]._gbdt._device_trees
    assert len(jtrees) == len(ttrees) > 0
    for jt, tt in zip(jtrees, ttrees):
        carried = tree_arrays_from_numpy(jt._asdict())
        n = int(carried.num_leaves)
        assert n == int(tt.num_leaves) > 1
        for f in ("split_feature", "threshold_bin", "default_left",
                  "missing_type", "left_child", "right_child"):
            assert torch.equal(getattr(carried, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        assert torch.equal(carried.leaf_parent[:n], tt.leaf_parent[:n])
        assert torch.equal(carried.leaf_count[:n], tt.leaf_count[:n])
        np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                   carried.leaf_value[:n].numpy(),
                                   rtol=0, atol=leaf_tol)


@pytest.mark.parametrize("run", ["f32_run", "deep_run", "poolfree_run",
                                 "knobs_run"])
def test_f32_trees_identical(run, request):
    _assert_same_trees(request.getfixturevalue(run), 2e-5)


def test_bf16x2_predictions_within_tolerance(bf16x2_run):
    Xv = bf16x2_run["Xv"]
    jraw = bf16x2_run["jb"].predict(Xv, raw_score=True)
    traw = bf16x2_run["tb"].predict(Xv, raw_score=True)
    np.testing.assert_allclose(traw, jraw, rtol=0, atol=2e-5)


@pytest.mark.parametrize("run", ["f32_run", "bf16x2_run", "knobs_run"])
def test_per_iteration_metrics_match(run, request):
    r = request.getfixturevalue(run)
    for metric, tol in (("binary_logloss", 1e-6), ("auc", 1e-4)):
        j = np.asarray(r["jev"]["valid_0"][metric])
        t = np.asarray(r["tev"]["valid_0"][metric])
        assert len(j) == len(t) > 0
        np.testing.assert_allclose(t, j, rtol=0, atol=tol)


def test_model_text_round_trips(f32_run, tmp_path):
    """The saved v3 text loads into the port's serving Booster (and the
    JAX package's) and predicts the trainer's own valid scores."""
    tb, Xv = f32_run["tb"], f32_run["Xv"]
    path = tmp_path / "model.txt"
    tb.save_model(str(path))
    served = lt.Booster(model_file=str(path), device="cpu")
    assert served.num_trees() == tb.num_trees() == 4
    scores = tb._gbdt._valid_scores[0].score[:, 0].numpy()
    tol = 1e-6 * sum(float(np.abs(t.leaf_value).max())
                     for t in served._all_trees()) + 1e-7
    for method in ("auto", "fused"):
        raw = served.predict(Xv, raw_score=True, predict_method=method)
        assert np.abs(raw - scores).max() <= tol, method
    jraw = lj.Booster(model_str=path.read_text()).predict(Xv, raw_score=True)
    np.testing.assert_array_equal(jraw, served.predict(Xv, raw_score=True))
    assert tb.model_to_string() == path.read_text()
    np.testing.assert_allclose(tb.predict(Xv), 1 / (1 + np.exp(-scores)),
                               rtol=1e-6)


def test_empty_tree_is_the_jax_one_leaf_tree():
    from lightgbmv1_tpu.models.tree import empty_tree as jempty

    from lightgbmv1_tpu_torch.models.tree import (empty_tree,
                                                  host_tree_from_arrays)

    t = empty_tree(15)
    carried = tree_arrays_from_numpy(jax.device_get(jempty(15))._asdict())
    for f in t._fields:
        assert torch.equal(getattr(t, f), getattr(carried, f)), f
    ht = host_tree_from_arrays(t)
    assert ht.num_leaves == 1 and ht.leaf_value.tolist() == [0.0]


def test_booster_update_loop():
    """``Booster(params, train_set=...)`` + ``update()`` is the same
    training as ``train``."""
    X, y = _data(12, 1024)
    p = dict(BASE, num_leaves=8, learning_rate=0.3)
    b = lt.Booster(p, train_set=lt.Dataset(X, label=y), device="cpu")
    for _ in range(3):
        assert b.update() is False
    t = lt.train(p, lt.Dataset(X, label=y), 3, device="cpu")
    assert b.model_to_string() == t.model_to_string()
    assert b.current_iteration() == 3 and b.num_feature() == F


def test_golden_zero_as_missing_training_parity():
    """Held to the reference C++ golden the way
    tests/test_golden_compat.py::test_zero_as_missing_training_parity
    holds the JAX package, with the wave grower at K = 1."""
    raw = np.loadtxt(os.path.join(DATA, "golden_zero_train.tsv"))
    X, y = raw[:, 1:], raw[:, 0]
    ref_pred = np.loadtxt(os.path.join(DATA, "golden_zero_pred.txt"))
    ref = lt.Booster(model_file=os.path.join(DATA, "golden_zero_model.txt"),
                     device="cpu")
    bst = lt.train({"objective": "binary", "num_leaves": 7, "max_bin": 32,
                    "min_data_in_leaf": 20, "learning_rate": 0.2,
                    "zero_as_missing": True, "verbosity": -1,
                    "leafwise_wave_size": 1},
                   lt.Dataset(X, label=y), 5, device="cpu")
    for tr, to in zip(ref._all_trees(), bst._all_trees()):
        np.testing.assert_array_equal(tr.split_feature[:tr.num_leaves - 1],
                                      to.split_feature[:to.num_leaves - 1])
    np.testing.assert_allclose(bst.predict(X), ref_pred, rtol=1e-4,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# what the slice does not train raises, naming its ROADMAP item
# ---------------------------------------------------------------------------


_UNPORTED_CASES = [
    ({"tree_learner": "data", "hist_dtype_deep": "int8sr"},
     tconfig.PARALLEL_LEGS),
    ({"tree_learner": "voting", "elastic_max_restarts": 5},
     tconfig.PARALLEL)]

# the CLI's knobs the list above refused until the CLI was ported (ROADMAP
# queue 1, item 4): ``train`` does not read them, as in the JAX package,
# and trains the model of the same params without them
_CLI_CASES = [{"snapshot_freq": 5}, {"task": "refit"},
              {"input_model": "model.txt"}]


@pytest.mark.parametrize("params", _CLI_CASES,
                         ids=["snapshot_freq", "task", "input_model"])
def test_cli_knobs_train_the_same_model(params):
    X, y = _data(13, 512)
    p = {**BASE, "num_leaves": 15}
    b = lt.train({**p, **params}, lt.Dataset(X, label=y), 2, device="cpu")
    plain = lt.train(p, lt.Dataset(X, label=y), 2, device="cpu")
    assert b.num_trees() == 2
    assert b.model_to_string() == plain.model_to_string()


# the constraint, penalty and categorical knobs the list above refused
# until item 1's part 1.6 ported them: they train now, each a model other
# than the default one (test_torch_categorical.py and
# test_torch_constraints.py hold them to the JAX package)
_PART_16_CASES = [
    {"min_data_per_group": 50, "categorical_feature": "0"},
    {"cat_smooth": 5.0, "categorical_feature": "0"},
    {"max_cat_to_onehot": 8, "categorical_feature": "0"},
    {"forcedsplits_filename": "forced.json"},
    {"cegb_penalty_feature_lazy": [0.001] * 6},
    {"cegb_tradeoff": 0.5, "cegb_penalty_split": 0.01},
    {"interaction_constraints": "[0,1]"},
    {"cegb_penalty_split": 0.1},
    {"categorical_feature": "0"}]


@pytest.mark.parametrize("params", _PART_16_CASES, ids=[
    "min_data_per_group", "cat_smooth", "max_cat_to_onehot", "forced",
    "cegb_lazy", "cegb_tradeoff", "interaction", "cegb_split",
    "categorical"])
def test_constraint_and_categorical_configurations_train(params, tmp_path):
    """Two iterations on the CPU with finite predictions (the
    ``categorical_feature`` knob bins column 0 as categorical, as the
    JAX CLI reads it); a forced split's file is made here."""
    X, y = _data(13, 512)
    X[:, 0] = np.floor(np.abs(X[:, 0]) * 4)        # categories 0..~12
    p = {**BASE, "num_leaves": 15, **params}
    if "forcedsplits_filename" in p:
        path = tmp_path / "forced.json"
        path.write_text('{"feature": 1, "threshold": 0.0}')
        p["forcedsplits_filename"] = str(path)
    b = lt.train(p, lt.Dataset(X, label=y), 2, device="cpu")
    assert np.isfinite(b.predict(X)).all() and b.num_trees() == 2
    plain = lt.train({**BASE, "num_leaves": 15}, lt.Dataset(X, label=y), 2,
                     device="cpu")
    assert b.model_to_string() != plain.model_to_string()


@pytest.mark.parametrize("params,item", _UNPORTED_CASES, ids=[
    f"params{i}" for i in range(len(_UNPORTED_CASES))])
def test_unported_configurations_raise(params, item):
    """Each refusal names its ROADMAP queue 1 item by its title: the
    objectives the slice does not port and their knobs the breadth item,
    the learners their parallel item."""
    X, y = _data(13, 512)
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"ROADMAP queue 1, {item}") + "$"):
        lt.train({**BASE, "num_leaves": 15, **params},
                 lt.Dataset(X, label=y), 2, device="cpu")


# the objectives and boosting modes the list above refused until the
# breadth slice ported them (ROADMAP queue 1, item 1, parts 1.2-1.3):
# they train now
_BREADTH_CASES = [
    {"objective": "huber"},
    {"objective": "rank_xendcg"},
    {"objective": "poisson"},
    {"boosting": "dart"},
    {"boosting": "goss"},
    {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
    {"objective": "huber", "alpha": 0.5}]


@pytest.mark.parametrize("params", _BREADTH_CASES, ids=[
    "huber", "rank_xendcg", "poisson", "dart", "goss", "rf",
    "huber-alpha"])
def test_ported_objective_and_boosting_configurations(params):
    """Two iterations on the CPU with finite predictions, each a model
    other than the default one (test_torch_boosting.py and
    test_torch_objective_training.py hold them to the JAX package)."""
    X, y = _data(13, 512)
    kw = ({"group": np.full(32, 16)}
          if params.get("objective") == "rank_xendcg" else {})
    b = lt.train({**BASE, "num_leaves": 15, **params},
                 lt.Dataset(X, label=y, **kw), 2, device="cpu")
    assert np.isfinite(b.predict(X)).all() and b.num_trees() == 2
    plain = lt.train({**BASE, "num_leaves": 15}, lt.Dataset(X, label=y), 2,
                     device="cpu")
    assert b.model_to_string() != plain.model_to_string()


# the cases of the list above that this slice ports: they train now (the
# loop with per-node sampling keeps the JAX grower's refusal, in its words)
_PORTED_CASES = [
    {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"feature_fraction": 0.8},
    {"feature_fraction_bynode": 0.5},
    {"hist_dtype": "int8", "hist_method": "pallas"},
    {"hist_dtype_deep": "int8", "hist_method": "pallas"},
    {"hist_method": "fused", "wave_loop_rounds": 2,
     "feature_fraction_bynode": 0.5}]


@pytest.mark.parametrize("params", _PORTED_CASES, ids=[
    "bagging", "feature_fraction", "feature_fraction_bynode", "int8",
    "int8 deep", "loop with bynode"])
def test_ported_sampling_and_int8_configurations(params):
    """Bagging, feature fraction (per tree and per node) and the plain
    int8 precisions train on the CPU, a model that differs from the
    unsampled f32 one where the knob reaches the trees; the persistent
    loop refuses per-node sampling with the reason the JAX grower keeps
    it off for (grower_wave.py:881-884)."""
    X, y = _data(13, 512)
    p = {**BASE, "num_leaves": 15, **params}
    if params.get("wave_loop_rounds", 1) > 1:
        with pytest.raises(NotImplementedError, match="outside the kernel"):
            lt.train(p, lt.Dataset(X, label=y), 2, device="cpu")
        return
    b = lt.train(p, lt.Dataset(X, label=y), 2, device="cpu")
    assert np.isfinite(b.predict(X)).all()
    plain = lt.train({**BASE, "num_leaves": 15, "hist_dtype": "f32"},
                     lt.Dataset(X, label=y), 2, device="cpu")
    assert b.model_to_string() != plain.model_to_string()


# the cases of the list above that the callbacks, extra_trees, histogram
# methods and int16 slice ports: they train now, through the path the JAX
# package trains them on
_NOW_TRAINS = [
    {"max_bin": 300, "min_data_in_bin": 1},
    {"extra_trees": True},
    {"early_stopping_round": 2},
    {"hist_method": "onehot"},
    {"hist_method": "bench"}]


@pytest.mark.parametrize("params", _NOW_TRAINS, ids=[
    "int16 bins", "extra_trees", "early stopping", "onehot", "bench"])
def test_ported_hist_method_and_callback_configurations(params):
    """int16 bins (max_bin > 255), extra_trees, early stopping through
    params (without a valid set it stops nothing, as in the JAX
    package), hist_method onehot and bench train on the CPU; the model
    differs from the default one where the knob reaches the trees."""
    X, y = _data(13, 512)
    b = lt.train({**BASE, "num_leaves": 15, **params},
                 lt.Dataset(X, label=y), 2, device="cpu")
    assert np.isfinite(b.predict(X)).all() and b.num_trees() == 2
    plain = lt.train({**BASE, "num_leaves": 15}, lt.Dataset(X, label=y), 2,
                     device="cpu")
    if "max_bin" in params or "extra_trees" in params:
        assert b.model_to_string() != plain.model_to_string()
    if "max_bin" in params:
        assert b._gbdt.binned.dtype == torch.int16


def test_unported_entry_points_raise():
    X, y = _data(14, 512)
    # ported since: early stopping and callbacks run
    assert lt.train(BASE, lt.Dataset(X, label=y), 2, device="cpu",
                    early_stopping_rounds=3).num_trees() == 2
    seen = []
    lt.train(BASE, lt.Dataset(X, label=y), 2, device="cpu",
             callbacks=[lambda env: seen.append(env.iteration)])
    assert seen == [0, 1]
    # ported since: custom objectives train (test_torch_lifecycle.py)
    def l2(p, d):
        return p - d.get_label(), np.ones_like(p)

    assert lt.train(BASE, lt.Dataset(X, label=y), 2, device="cpu",
                    fobj=l2).num_trees() == 2
    # ported since: categorical features (test_torch_categorical.py)
    assert lt.Dataset(X, label=y, categorical_feature=[0]).construct() \
        ._binned.is_categorical.tolist() == [True] + [False] * (F - 1)
    # ported since: a data file loads (test_torch_parser.py); a missing
    # one is fatal
    with pytest.raises(lt.LightGBMError, match="does not exist"):
        lt.Dataset("no_such_train.tsv")
    b = lt.Booster(BASE, train_set=lt.Dataset(X, label=y), device="cpu")
    assert b.update(fobj=l2) is False
    # auto bin layout packs 4-bit bins on the card at max_bin <= 15
    assert select_bin_layout(Config.from_dict({"max_bin": 15}),
                             num_total_bin=16,
                             device=torch.device("cuda")) == "packed4"
    assert select_bin_layout(Config.from_dict({"max_bin": 15}),
                             num_total_bin=16, device=CPU) == "u8"
    assert select_bin_layout(Config.from_dict({"bin_layout": "u8"}),
                             num_total_bin=16,
                             device=torch.device("cuda")) == "u8"


def test_bundling_data_raises():
    """Sparse, mutually exclusive features form an EFB bundle, as in the
    JAX package, and train on it since part 1.5 (test_torch_efb.py holds
    the trees); dense data forms none; what still raises there is the
    fused family, with the JAX reason."""
    rng = np.random.RandomState(15)
    X = np.zeros((2000, 6))
    for j in range(6):
        rows = np.arange(j, 2000, 6)
        X[rows, j] = rng.randn(len(rows))
    y = (rng.rand(2000) < 0.5).astype(float)
    b = lt.train(BASE, lt.Dataset(X, label=y), 1, device="cpu")
    assert b._gbdt._bundle is not None
    assert b._gbdt.binned.shape[0] < 6
    with pytest.raises(NotImplementedError, match="EFB"):
        lt.train(dict(BASE, hist_method="fused"), lt.Dataset(X, label=y), 1,
                 device="cpu")
    u = lt.train(dict(BASE, enable_bundle=False), lt.Dataset(X, label=y), 1,
                 device="cpu")
    assert u._gbdt._bundle is None
    dense = lt.train(BASE, lt.Dataset(rng.randn(500, 4),
                                      label=np.zeros(500)), 1, device="cpu")
    assert dense._gbdt._bundle is None


def test_config_aliases_and_carry_errors():
    c = Config.from_dict({"eta": 0.05, "num_iterations": 7,
                          "num_leaf": 9, "min_child_samples": 3,
                          "reg_lambda": 1.5, "metric": "auc,binary"})
    assert (c.learning_rate, c.num_iterations, c.num_leaves,
            c.min_data_in_leaf, c.lambda_l2) == (0.05, 7, 9, 3, 1.5)
    assert c.metric == ["auc", "binary"]
    assert Config.from_dict({"learning_rate": 0.2,
                             "eta": 0.9}).learning_rate == 0.2
    with pytest.raises(ValueError):
        Config.from_dict({"hist_method": "nope"})
    with pytest.raises(ValueError):
        bin_mappers_from_numpy([{"num_bin": 3}])
    cat = dict(bin_upper_bound=[np.inf], num_bin=3, missing_type=0,
               bin_type=1, is_trivial=False, sparse_rate=0.0, min_value=0.0,
               max_value=1.0)
    # a categorical mapper carries its categories (ported since part 1.6)
    with pytest.raises(ValueError, match="bin_2_categorical"):
        bin_mappers_from_numpy([cat])
    m = bin_mappers_from_numpy([dict(cat, bin_2_categorical=[4, 1])])[0]
    assert m.value_to_bin(np.array([1.0, 4.7, 9.0, np.nan])).tolist() \
        == [1, 0, 2, 2]
