"""The port's serving engine (models/predict.py) against the JAX package's.

Small models trained by the JAX package on the CPU — binary with NaNs,
multiclass, zero-as-missing, and a categorical model that the fused plan
refuses — reach the port two ways: through ``models/convert.py`` (the
JAX ``HostTree`` fields as numpy) and through model text.  Both routes
must serve identically, and the port's ``BatchPredictor`` on the CPU must
match the JAX ``BatchPredictor`` (Pallas in interpret mode) for
``predict_method`` fused, pallas and depthwise, across bucket padding and
chunking.  Tolerances: leaf ids exact, ``f64_exact`` scores bit-identical,
f32 raw scores ``1e-6 * sum_t max_l |leaf_value| + 1e-7``, transformed
scores 1e-6.
"""

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lgb
from lightgbmv1_tpu.models import predict as jax_predict
from lightgbmv1_tpu.models.tree import HostTree as JaxHostTree

from lightgbmv1_tpu_torch import Booster
from lightgbmv1_tpu_torch.models import predict as port_predict
from lightgbmv1_tpu_torch.models.convert import host_trees_from_numpy

F = 6
N = 100            # two chunks of <= 64 rows, both padded to the 64 bucket
ENGINE = dict(bucket_min=16, chunk_rows=64)
MODELS = ["binary_nan", "multiclass", "zero_missing", "categorical"]
METHODS = ["fused", "pallas", "depthwise"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(name):
    rng = np.random.RandomState(MODELS.index(name))
    X = rng.randn(300, F)
    params = {"verbosity": -1, "min_data_in_leaf": 5, "num_leaves": 15}
    if name == "binary_nan":
        y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
        X[rng.rand(*X.shape) < 0.15] = np.nan
        params["objective"] = "binary"
    elif name == "multiclass":
        y = np.argmax(X[:, :3], axis=1).astype(float)
        params.update(objective="multiclass", num_class=3, num_leaves=7)
    elif name == "zero_missing":
        X[rng.rand(*X.shape) < 0.4] = 0.0
        y = (X[:, 0] - X[:, 1] > 0).astype(float)
        params.update(objective="binary", zero_as_missing=True)
    else:
        X[:, 0] = rng.randint(0, 8, size=len(X))
        y = (np.isin(X[:, 0], [1, 3, 6]) ^ (X[:, 1] > 1)).astype(float)
        params.update(objective="binary", categorical_feature=[0])
    ds = lgb.Dataset(X, label=y, categorical_feature=params.pop(
        "categorical_feature", "auto"))
    return lgb.train(params, ds, num_boost_round=4)


def _rows(name, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F)
    X[rng.rand(N, F) < 0.15] = np.nan
    X[rng.rand(N, F) < 0.10] = 0.0
    if name == "categorical":
        X[:, 0] = rng.randint(-1, 10, size=N)
    return X


_boosters = {}
_jax_out = {}


def _jax_booster(name):
    if name not in _boosters:
        _boosters[name] = _train(name)
    return _boosters[name]


def _fields(t):
    """A JAX HostTree as the plain numpy fields the port carries over."""
    out = {k: np.asarray(getattr(t, k)) for k in
           JaxHostTree.FIELDS + ["num_leaves", "is_cat", "cat_bitset"]}
    out["cat_sets"] = [None if s is None else np.asarray(s)
                       for s in t.cat_sets]
    out["shrinkage"] = float(t.shrinkage)
    return out


def _port_trees(name, route):
    jb = _jax_booster(name)
    K, trees = jb.num_model_per_iteration(), jb._all_trees()
    if route == "convert":
        return host_trees_from_numpy([_fields(t) for t in trees], K, F)
    return Booster(model_str=jb.model_to_string(), device="cpu")._all_trees()


def _jax_results(name, method):
    """The JAX engine's outputs (Pallas interpret mode), once per cell."""
    key = (name, method)
    if key not in _jax_out:
        jb = _jax_booster(name)
        K = jb.num_model_per_iteration()
        bp = jax_predict.BatchPredictor(jb._all_trees(), K, F, method=method,
                                        interpret=True, **ENGINE)
        X = _rows(name)
        transform = "sigmoid" if K == 1 else "softmax"
        _jax_out[key] = dict(
            leaf=bp.predict_leaf(X), raw=bp.predict_raw(X),
            f64=bp.predict_raw(X, f64_exact=True),
            scores=bp.predict_scores(X, transform=transform),
            plan=bp.fused_plan, packed=bp.packed, transform=transform)
    return _jax_out[key]


def _raw_tol(trees):
    return 1e-6 * sum(float(np.abs(t.leaf_value).max()) for t in trees) + 1e-7


@pytest.mark.parametrize("name", MODELS)
def test_binner_and_arrays_equal(name):
    jtrees = _jax_booster(name)._all_trees()
    ptrees = _port_trees(name, "convert")
    jb = jax_predict.build_serving_binner(jtrees, F)
    pb = port_predict.build_serving_binner(ptrees, F)
    for attr in ("zero_bin", "cat_feat", "cat_limit"):
        np.testing.assert_array_equal(getattr(pb, attr), getattr(jb, attr))
    for a, b in zip(pb.thresholds, jb.thresholds):
        np.testing.assert_array_equal(a, b)
    assert (pb.zero_code, pb.nan_code, pb.dtype, pb.ok, pb.why_not) == \
        (jb.zero_code, jb.nan_code, jb.dtype, jb.ok, jb.why_not)
    X = _rows(name)
    np.testing.assert_array_equal(pb.prebin(X), jb.prebin(X))
    parr, pdepth = port_predict.build_serving_arrays(ptrees, pb, F, "cpu")
    jarr, jdepth = jax_predict.build_serving_arrays(jtrees, jb, F)
    assert pdepth == jdepth
    for field, a in parr._asdict().items():
        b = np.asarray(getattr(jarr, field))
        assert a.device.type == "cpu"
        if field == "cat_bitset":       # uint32 words held in int64
            b = b.astype(np.int64)
        else:
            assert a.numpy().dtype == b.dtype, field
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)


@pytest.mark.parametrize("route", ["convert", "text"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", MODELS)
def test_batch_predictor_matches_jax(name, method, route):
    want = _jax_results(name, method)
    trees = _port_trees(name, route)
    K = _jax_booster(name).num_model_per_iteration()
    bp = port_predict.BatchPredictor(trees, K, F, method=method,
                                     device="cpu", **ENGINE)
    X = _rows(name)
    assert bp.packed == want["packed"]
    if method == "fused":
        assert bp.fused_plan["eligible"] == want["plan"]["eligible"]
        assert bp.fused_plan["reason"] == want["plan"]["reason"]
        assert bp._fused_engaged() == (name != "categorical")
    np.testing.assert_array_equal(bp.predict_leaf(X), want["leaf"])
    assert np.array_equal(bp.predict_raw(X, f64_exact=True), want["f64"])
    np.testing.assert_allclose(bp.predict_raw(X), want["raw"], rtol=0,
                               atol=_raw_tol(trees))
    np.testing.assert_allclose(
        bp.predict_scores(X, transform=want["transform"]), want["scores"],
        rtol=0, atol=1e-6)
    assert bp.call_count == 4 * 2         # four calls of two chunks each


@pytest.mark.parametrize("name", ["binary_nan", "categorical"])
def test_raw_feature_walk_matches_jax(name):
    """predict_prebin=off: the f32 raw-feature walk (serving_leaf_raw, with
    the raw-value categorical bitset), which the fused plan refuses."""
    jb = _jax_booster(name)
    X = _rows(name)
    want = jax_predict.BatchPredictor(jb._all_trees(), 1, F, prebin="off",
                                      **ENGINE)
    bp = port_predict.BatchPredictor(_port_trees(name, "text"), 1, F,
                                     method="fused", prebin="off",
                                     device="cpu", **ENGINE)
    assert not bp.prebin and not bp._fused_engaged()
    assert bp.fused_plan["reason"].startswith("raw-feature walk")
    np.testing.assert_array_equal(bp.predict_leaf(X), want.predict_leaf(X))
    np.testing.assert_allclose(bp.predict_raw(X), want.predict_raw(X),
                               rtol=0, atol=_raw_tol(jb._all_trees()))


def test_categorical_model_refused_by_the_fused_plan():
    bp = port_predict.BatchPredictor(_port_trees("categorical", "text"), 1,
                                     F, method="fused", device="cpu")
    assert not bp.fused_plan["eligible"]
    assert bp.fused_plan["reason"] == ("categorical bitset decision stays "
                                       "on the staged walk")
    assert bp.has_cat and bp.prebin


@pytest.mark.parametrize("name", MODELS)
def test_convert_route_equals_text_route(name):
    """Weight carry-over: the JAX HostTree fields given as numpy give the
    same trees (up to what text does not store) and the same leaves and
    f64 scores as loading the model text."""
    conv, text = _port_trees(name, "convert"), _port_trees(name, "text")
    jtrees = _jax_booster(name)._all_trees()
    for c, t, j in zip(conv, text, jtrees):
        for field in ("threshold_bin", "cat_bitset"):   # bin space: exact
            np.testing.assert_array_equal(getattr(c, field),
                                          np.asarray(getattr(j, field)))
        for field in ("split_feature", "threshold", "default_left",
                      "missing_type", "left_child", "right_child",
                      "leaf_value", "is_cat"):
            np.testing.assert_array_equal(getattr(c, field),
                                          getattr(t, field), err_msg=field)
    K = _jax_booster(name).num_model_per_iteration()
    X = _rows(name, seed=11)
    a = port_predict.BatchPredictor(conv, K, F, device="cpu")
    b = port_predict.BatchPredictor(text, K, F, device="cpu")
    np.testing.assert_array_equal(a.predict_leaf(X), b.predict_leaf(X))
    assert np.array_equal(a.predict_raw(X, f64_exact=True),
                          b.predict_raw(X, f64_exact=True))


def test_convert_rejects_bad_input():
    trees = _jax_booster("multiclass")._all_trees()
    fields = [_fields(t) for t in trees]
    with pytest.raises(ValueError, match="whole number"):
        host_trees_from_numpy(fields[:-1], 3, F)
    with pytest.raises(ValueError, match="outside"):
        host_trees_from_numpy(fields, 3, 2)
    del fields[0]["leaf_value"]
    with pytest.raises(ValueError, match="missing fields"):
        host_trees_from_numpy(fields, 3, F)


def test_scan_and_row_sharding_not_ported():
    trees = _port_trees("binary_nan", "text")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_predict.BatchPredictor(trees, 1, F, method="scan", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_predict.BatchPredictor(trees, 1, F, num_shards=2, device="cpu")


@pytest.mark.parametrize("f", [5, 6])
def test_pack_unpack_round_trip(f):
    codes = np.random.RandomState(f).randint(0, 16, size=(9, f)).astype(
        np.uint8)
    packed = port_predict.pack_serving_codes(codes)
    assert packed.shape == (9, -(-f // 2))
    np.testing.assert_array_equal(
        packed, jax_predict.pack_serving_codes(codes))
    un = port_predict.unpack_serving_codes(torch.from_numpy(packed), f)
    assert un.is_contiguous() and un.dtype == torch.uint8
    np.testing.assert_array_equal(un.numpy(), codes)


def test_buckets_are_powers_of_two_up_to_the_chunk():
    bp = port_predict.BatchPredictor(_port_trees("binary_nan", "text"), 1, F,
                                     device="cpu", **ENGINE)
    assert [bp.bucket_for(n) for n in (1, 16, 17, 33, 64, 500)] == \
        [16, 16, 32, 64, 64, 64]
