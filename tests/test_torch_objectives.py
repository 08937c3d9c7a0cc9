"""The port's objectives held against the JAX package's: regression
(L2, L1, huber, fair, poisson, quantile, mape, gamma, tweedie), the two
cross-entropies, multiclass, lambdarank and rank_xendcg (binary:
test_torch_train.py).

Both packages see the same numpy labels, weights, query groups and
scores: the JAX objective on ``jax.numpy`` arrays, the port's on CPU
tensors.  Tolerances: gradients and hessians within 1e-6 relative (+1e-7
of the largest magnitude: torch's and XLA's softmax, sigmoid and
reductions differ in the last ulps, and a lambda is a difference of two
sums); ``boost_from_score`` within 1e-12 (host float64 in both); the
query layouts equal.  Lambdarank is held at iteration 0, where every
score of a query ties (the init score) and the stable rank of the tied
documents decides every discount, and at random scores, with and without
``lambdarank_norm``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbmv1_tpu import objectives as jobjectives
from lightgbmv1_tpu.config import Config as JConfig
from lightgbmv1_tpu.io.dataset import Metadata as JMetadata

from lightgbmv1_tpu_torch import objectives as tobjectives
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.dataset import Metadata
from lightgbmv1_tpu_torch.utils.log import LightGBMError

N = 600
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _queries(rng, n):
    """Query sizes 1 ... 40 (three length buckets) summing to ``n``."""
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.randint(1, 41)))
    sizes[-1] -= sum(sizes) - n
    return np.asarray([s for s in sizes if s > 0])


def _labels(objective, rng, n):
    if objective in ("multiclass", "multiclassova"):
        return rng.randint(0, 4, n).astype(np.float64)
    if objective in ("lambdarank", "rank_xendcg"):
        return rng.randint(0, 5, n).astype(np.float64)
    if objective in ("poisson", "tweedie"):        # counts, zeros included
        return rng.poisson(2.0, n).astype(np.float64)
    if objective == "gamma":
        return rng.gamma(2.0, 1.5, n)
    if objective in ("cross_entropy", "cross_entropy_lambda"):
        y = rng.rand(n)
        y[:50] = np.round(y[:50])                 # the ends of [0, 1]
        return y
    return rng.randn(n) * 3.0 + 1.0


def _both(params, seed=0, weighted=False):
    """The JAX and the port objective, initialised on the same data."""
    rng = np.random.RandomState(seed)
    y = _labels(params["objective"], rng, N)
    w = rng.rand(N) + 0.5 if weighted else None
    group = (_queries(rng, N)
             if params["objective"] in ("lambdarank", "rank_xendcg")
             else None)
    jmeta = JMetadata(label=y.astype(np.float32),
                      weight=None if w is None else w.astype(np.float32))
    tmeta = Metadata(label=y.astype(np.float32),
                     weight=None if w is None else w.astype(np.float32))
    jmeta.set_group(group)
    tmeta.set_group(group)
    jobj = jobjectives.create_objective(JConfig.from_dict(dict(params)))
    jobj.init(jmeta, N)
    tobj = tobjectives.create_objective(Config.from_dict(dict(params)))
    tobj.init(tmeta, N, CPU)
    return jobj, tobj, group


def _assert_grads(jobj, tobj, s):
    jg, jh = map(np.asarray, jobj.get_gradients(jnp.asarray(s)))
    tg, th = (a.numpy() for a in tobj.get_gradients(torch.from_numpy(s)))
    assert tg.shape == jg.shape and tg.dtype == np.float32
    for got, want in ((tg, jg), (th, jh)):
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-7 * float(np.abs(want).max()))


@pytest.mark.parametrize("params,weighted", [
    ({"objective": "regression"}, False),
    ({"objective": "regression"}, True),
    ({"objective": "regression", "reg_sqrt": True}, True),
    ({"objective": "regression", "boost_from_average": False}, False),
    ({"objective": "multiclass", "num_class": 4}, False),
    ({"objective": "multiclass", "num_class": 4}, True),
    ({"objective": "multiclassova", "num_class": 4, "sigmoid": 0.7}, True),
    ({"objective": "multiclassova", "num_class": 4,
      "boost_from_average": False}, False)],
    ids=["l2", "l2-weighted", "l2-reg_sqrt", "l2-no-average", "softmax",
         "softmax-weighted", "ova-weighted", "ova-no-average"])
def test_gradients_and_boost_from_score_match_jax(params, weighted):
    jobj, tobj, _ = _both(params, seed=1, weighted=weighted)
    K = params.get("num_class", 1)
    for k in range(K):
        assert abs(jobj.boost_from_score(k) - tobj.boost_from_score(k)) \
            <= 1e-12
    rng = np.random.RandomState(2)
    shape = (N, K) if K > 1 else (N,)
    for s in (np.zeros(shape, np.float32),
              (rng.randn(*shape) * 2).astype(np.float32)):
        _assert_grads(jobj, tobj, s)


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no-norm"])
@pytest.mark.parametrize("scores", ["iteration0", "random", "ties"])
def test_lambdarank_gradients_match_jax(scores, norm):
    """Iteration 0 (every score the init score 0: all tied), random
    scores, and scores in a few repeated values (partial ties)."""
    params = {"objective": "lambdarank", "lambdarank_norm": norm,
              "lambdarank_truncation_level": 10}
    jobj, tobj, group = _both(params, seed=3)
    rng = np.random.RandomState(4)
    s = {"iteration0": np.zeros(N, np.float32),
         "random": rng.randn(N).astype(np.float32),
         "ties": rng.randint(0, 3, N).astype(np.float32)}[scores]
    assert tobj.boost_from_score(0) == jobj.boost_from_score(0) == 0.0
    _assert_grads(jobj, tobj, s)
    tg = tobj.get_gradients(torch.from_numpy(s))[0].numpy()
    assert np.abs(tg).max() > 0


def test_lambdarank_rank_of_ties_is_row_order():
    """At iteration 0 the stable rank puts the tied documents in row
    order: a query whose better document comes last pushes it up, and
    the first (worse) document down."""
    meta = Metadata(label=np.array([0, 0, 2], np.float32))
    meta.set_group([3])
    obj = tobjectives.create_objective(Config.from_dict(
        {"objective": "lambdarank"}))
    obj.init(meta, 3, CPU)
    g = obj.get_gradients(torch.zeros(3))[0].numpy()
    assert g[2] < 0 < g[0]


def test_query_layouts_match_jax():
    rng = np.random.RandomState(5)
    qb = np.concatenate([[0], np.cumsum(_queries(rng, 3000))])
    jflat, tflat = jobjectives._pad_queries(qb), tobjectives._pad_queries(qb)
    for a, b in zip(jflat, tflat):
        np.testing.assert_array_equal(a, b)
    saved = jobjectives._PAIRWISE_CHUNK_ELEMS, \
        tobjectives._PAIRWISE_CHUNK_ELEMS
    # a small budget splits the buckets into several chunks
    jobjectives._PAIRWISE_CHUNK_ELEMS = \
        tobjectives._PAIRWISE_CHUNK_ELEMS = 1 << 13
    try:
        jb, tb = (m._bucket_queries(qb) for m in (jobjectives, tobjectives))
    finally:
        jobjectives._PAIRWISE_CHUNK_ELEMS, \
            tobjectives._PAIRWISE_CHUNK_ELEMS = saved
    assert len(tb) == len(jb) > 3
    for a, b in zip(jb, tb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("params,label,group,match", [
    ({"objective": "multiclass", "num_class": 3}, [0, 1, 3], None,
     "label out of range"),
    ({"objective": "lambdarank"}, [0, 1, 2], None, "group"),
    ({"objective": "lambdarank", "label_gain": [0, 1]}, [0, 1, 2], [3],
     "label_gain"),
    ({"objective": "binary"}, [0, 1, 2], None, "0 or 1")],
    ids=["multiclass-range", "lambdarank-group", "lambdarank-gain",
         "binary-labels"])
def test_bad_labels_raise(params, label, group, match):
    meta = Metadata(label=np.asarray(label, np.float32))
    meta.set_group(group)
    obj = tobjectives.create_objective(Config.from_dict(params))
    with pytest.raises(LightGBMError, match=match):
        obj.init(meta, len(label), CPU)


def test_convert_output_matches_jax():
    rng = np.random.RandomState(6)
    raw = rng.randn(50, 4)
    for params in ({"objective": "multiclass", "num_class": 4},
                   {"objective": "multiclassova", "num_class": 4,
                    "sigmoid": 0.5},
                   {"objective": "regression", "reg_sqrt": True},
                   {"objective": "lambdarank"}):
        jobj = jobjectives.create_objective(JConfig.from_dict(dict(params)))
        want = np.asarray(jobj.convert_output(raw))
        got = tobjectives.convert_output(Config.from_dict(dict(params)), raw)
        # the JAX reg_sqrt transform runs in jnp's float32
        np.testing.assert_allclose(got, want, rtol=1e-6 if params.get(
            "reg_sqrt") else 1e-12)


_BREADTH = [
    ({"objective": "regression_l1"}, False),
    ({"objective": "regression_l1"}, True),
    ({"objective": "regression_l1", "boost_from_average": False}, False),
    ({"objective": "huber", "alpha": 1.5}, False),
    ({"objective": "huber"}, True),
    ({"objective": "fair", "fair_c": 0.5}, True),
    ({"objective": "poisson"}, False),
    ({"objective": "poisson", "poisson_max_delta_step": 0.3}, True),
    ({"objective": "quantile", "alpha": 0.3}, False),
    ({"objective": "quantile"}, True),
    ({"objective": "mape"}, False),
    ({"objective": "mape"}, True),
    ({"objective": "gamma"}, True),
    ({"objective": "tweedie", "tweedie_variance_power": 1.2}, False),
    ({"objective": "cross_entropy"}, True),
    ({"objective": "cross_entropy_lambda"}, False)]


@pytest.mark.parametrize("params,weighted", _BREADTH, ids=[
    "l1", "l1-weighted", "l1-no-average", "huber-alpha", "huber-weighted",
    "fair-weighted", "poisson", "poisson-delta-weighted", "quantile-0.3",
    "quantile-weighted", "mape", "mape-weighted", "gamma-weighted",
    "tweedie-1.2", "xentropy-weighted", "xentlambda"])
def test_breadth_gradients_and_boost_from_score_match_jax(params,
                                                          weighted):
    """The regression family and the cross-entropies: gradients and
    hessians at the init score and at random scores, the init score
    (L1 / quantile / mape: the weighted quantile of the labels) and the
    leaf-renewal quantile and weights."""
    jobj, tobj, _ = _both(params, seed=5, weighted=weighted)
    assert abs(jobj.boost_from_score(0) - tobj.boost_from_score(0)) <= 1e-12
    assert tobj.renew_percentile == jobj.renew_percentile
    jw, tw = jobj.renew_weights(), tobj.renew_weights()
    assert (jw is None) == (tw is None)
    if jw is not None:
        np.testing.assert_array_equal(tw, jw)
    rng = np.random.RandomState(6)
    init = np.full(N, tobj.boost_from_score(0), np.float32)
    for s in (init, (rng.randn(N) * 2).astype(np.float32)):
        _assert_grads(jobj, tobj, s)


@pytest.mark.parametrize("iteration", [0, 1, 7])
def test_rank_xendcg_gradients_match_jax(iteration):
    """The gamma draw of each iteration (``fold_in(PRNGKey(
    objective_seed), iteration)``) and the per-query softmax, at random
    scores and at the tied init score."""
    params = {"objective": "rank_xendcg", "objective_seed": 11}
    jobj, tobj, _ = _both(params, seed=7)
    rng = np.random.RandomState(8)
    for s in (np.zeros(N, np.float32), rng.randn(N).astype(np.float32)):
        jg, jh = map(np.asarray, jobj.get_gradients(
            jnp.asarray(s), iteration=iteration))
        tg, th = (a.numpy() for a in tobj.get_gradients(
            torch.from_numpy(s), iteration=iteration))
        for got, want in ((tg, jg), (th, jh)):
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-7 * float(np.abs(want).max()))
    assert tobj.is_stochastic and tobj.boost_from_score(0) == 0.0


@pytest.mark.parametrize("params,label,group,match", [
    ({"objective": "poisson"}, [0, 1, -1], None, "non-negative"),
    ({"objective": "tweedie"}, [0, 1, -1], None, "non-negative"),
    ({"objective": "gamma"}, [1, 2, 0], None, "positive"),
    ({"objective": "cross_entropy"}, [0, 0.5, 1.5], None, r"\[0, 1\]"),
    ({"objective": "rank_xendcg"}, [0, 1, 2], None, "group")],
    ids=["poisson", "tweedie", "gamma", "xentropy", "xendcg-group"])
def test_breadth_bad_labels_raise(params, label, group, match):
    test_bad_labels_raise(params, label, group, match)


@pytest.mark.parametrize("objective", [
    "regression_l1", "huber", "fair", "poisson", "quantile", "mape",
    "gamma", "tweedie", "cross_entropy", "cross_entropy_lambda",
    "rank_xendcg"])
def test_breadth_convert_output_matches_jax(objective):
    raw = np.random.RandomState(9).randn(200)
    jobj = jobjectives.create_objective(JConfig.from_dict(
        {"objective": objective}))
    np.testing.assert_allclose(
        tobjectives.convert_output(Config.from_dict({"objective": objective}),
                                   raw),
        np.asarray(jobj.convert_output(raw)), rtol=1e-12)
