"""Bagging and feature fraction of the port against the JAX package, on the
CPU.

The port draws the JAX package's own streams: the bag from threefry
(``bernoulli(fold_in(PRNGKey(bagging_seed), iteration // bagging_freq),
fraction, (N,))``, positives and negatives apart under
``pos_bagging_fraction`` / ``neg_bagging_fraction``), the per-tree
feature mask from ``numpy.random.RandomState(feature_fraction_seed)``
and the per-node masks from ``uniform(fold_in(tree_key, uid), (F,))``.
So the masks are the JAX package's bit for bit, and the same seeds train
the same trees.

Tolerances: masks bit for bit; trainings every split identical and leaf
values within 2e-5 (the port's training tolerance), except the
sequential grower's, whose leaf values the JAX package itself carries
off the rows' exact sums (tests/test_torch_grower.py
``_assert_exact_leaves``): there the port's leaves are within 2e-5 of
the exact float64 leaf outputs of their in-bag rows and the JAX leaves
within their own error of them plus 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.models import grower_wave as jgw
from lightgbmv1_tpu.models.grower import _node_feature_mask

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.models.grower import node_feature_masks
from lightgbmv1_tpu_torch.utils import prng

SAMPLE = dict(bagging_fraction=0.8, bagging_freq=5, feature_fraction=0.9,
              feature_fraction_bynode=0.8)
BASE = {"objective": "binary", "verbosity": -1, "seed": 7, "max_bin": 63,
        "num_leaves": 15, "min_data_in_leaf": 20}
N = 2048


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def low_buckets():
    saved = jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N
    jgw._BUCKET_MIN_N = tgw._BUCKET_MIN_N = 1
    yield
    jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N = saved


def _default(name):
    return getattr(lt.config.Config(), name)


def _problem(n=N, classes=0, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[:, 7] = 1.0                                  # a trivial feature
    if classes:
        y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(float)
    else:
        y = (X[:, 0] * 1.5 - X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _boosters(params, n=N, classes=0):
    """The JAX package's and the port's boosters of one configuration on
    one problem, untrained."""
    X, y = _problem(n, classes)
    jb = lj.Booster(dict(params), lj.Dataset(X, label=y))
    tb = lt.Booster(dict(params), lt.Dataset(X, label=y), device="cpu")
    return jb, tb, X, y


# ---------------------------------------------------------------------------
# the streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.8},
    {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.9},
    {"bagging_fraction": 0.5, "bagging_seed": 2 ** 33 + 11}],
    ids=["plain", "pos-neg", "64-bit seed"])
def test_bag_mask_matches_jax(extra):
    """The bag of every iteration across three bagging_freq boundaries is
    the JAX package's bit for bit (its eager mask and its step's traced
    twin), kept between boundaries and drawn anew at each."""
    params = dict(BASE, bagging_freq=3, **extra)
    jb, tb, _, y = _boosters(params)
    masks = []
    for it in range(10):
        want = np.asarray(jb._gbdt._bagging_mask(it))
        traced = np.asarray(jb._gbdt._bag_fraction_mask(None, it))
        got = tb._gbdt._bagging_mask(it).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, traced)
        masks.append(got)
    for it in range(10):
        same = np.array_equal(masks[it], masks[it - it % 3])
        assert same and (it % 3 or it == 0
                         or not np.array_equal(masks[it], masks[it - 1]))
    if "pos_bagging_fraction" in extra:
        pos = masks[0][y > 0].mean()
        neg = masks[0][y <= 0].mean()
        assert abs(pos - 0.6) < 0.08 and abs(neg - 0.9) < 0.08


def test_no_bag_without_freq_or_fraction():
    """bagging_freq 0, or every fraction 1, bags nothing (as the JAX
    package's mask is None)."""
    for extra in ({"bagging_fraction": 0.5}, {"bagging_freq": 2}):
        _, tb, _, _ = _boosters(dict(BASE, **extra))
        assert tb._gbdt._bagging_mask(0) is None


@pytest.mark.parametrize("frac", [0.9, 0.35, 0.01])
def test_tree_feature_masks_match_jax(frac):
    """The per-tree masks over several iterations and classes are the JAX
    package's, drawn from the same RandomState stream in the same order;
    a trivial feature is never drawn."""
    params = dict(BASE, feature_fraction=frac, feature_fraction_seed=5)
    jb, tb, _, _ = _boosters(params)
    for _ in range(12):
        want = np.asarray(jb._gbdt._tree_feature_mask())
        got = tb._gbdt._tree_feature_mask().numpy()
        np.testing.assert_array_equal(got, want)
        assert not got[7] and got.sum() == max(1, int(np.ceil(frac * 7)))


@pytest.mark.parametrize("frac", [0.8, 0.5, 0.01])
def test_node_feature_masks_match_jax(frac):
    """The per-node masks of a batch of uids equal ``_node_feature_mask``'s
    one by one, for a full and a partial tree mask."""
    key = prng.fold_in(prng.prng_key(7), 13)
    jkey = jax.random.fold_in(jax.random.PRNGKey(7), 13)
    uids = [0, 1, 2, 9, 30, 2 * 63 * 4 + 5, 4000]
    for base in (np.ones(28, bool), np.arange(28) % 3 != 1):
        got = node_feature_masks(key, uids, torch.from_numpy(base),
                                 frac).numpy()
        for u, row in zip(uids, got):
            want = np.asarray(_node_feature_mask(jkey, u, jnp.asarray(base),
                                                 frac))
            np.testing.assert_array_equal(row, want)
    full = node_feature_masks(key, [3], torch.ones(5, dtype=torch.bool),
                              1.0)
    assert full.all()


# ---------------------------------------------------------------------------
# trainings against the JAX package
# ---------------------------------------------------------------------------


def _assert_trees_match(tb, jb, rounds, leaf_tol=2e-5):
    jtrees = jax.device_get(jb._gbdt._device_trees)
    ttrees = tb._gbdt._device_trees
    assert len(jtrees) == len(ttrees) == rounds
    for jt, tt in zip(jtrees, ttrees):
        c = tree_arrays_from_numpy(jt._asdict())
        n = int(c.num_leaves)
        assert n == int(tt.num_leaves) > 2
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child"):
            assert torch.equal(getattr(c, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        assert torch.equal(c.leaf_count[:n], tt.leaf_count[:n])
        if leaf_tol is not None:
            np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                       c.leaf_value[:n].numpy(), rtol=0,
                                       atol=leaf_tol)


def _train_both(params, rounds=7, classes=0):
    X, y = _problem(N, classes)
    tb = lt.train(params, lt.Dataset(X, label=y), rounds, device="cpu")
    jb = lj.train(params, lj.Dataset(X, label=y), rounds, verbose_eval=False)
    return tb, jb, X


@pytest.mark.parametrize("extra,classes", [
    ({"leafwise_wave_size": 8}, 0),
    ({"leafwise_wave_size": 8, "hist_method": "fused"}, 0),
    ({"tree_growth": "levelwise"}, 0),
    ({"objective": "multiclass", "num_class": 3, "leafwise_wave_size": 4},
     3),
    ({"leafwise_wave_size": 8, "hist_method": "pallas", "hist_dtype":
      "int8", "min_data_in_leaf": 5}, 0)],
    ids=["wave staged", "wave fused", "level-wise", "multiclass", "int8"])
def test_sampled_trees_match_jax(low_buckets, extra, classes):
    """Bagging 0.8 every 5 iterations, feature_fraction 0.9 and
    feature_fraction_bynode 0.8 over 7 iterations (a new bag at 5): the
    wave grower staged and fused, the level-wise grower, multiclass (a
    mask a class tree) and int8 histograms train the JAX package's trees,
    every split identical, leaves within 2e-5."""
    params = dict(BASE, **SAMPLE, **extra)
    rounds = 7
    tb, jb, X = _train_both(params, rounds, classes)
    K = 3 if classes else 1
    _assert_trees_match(tb, jb, rounds * K)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=2e-5 * rounds)


def test_sampled_sequential_trees_match_jax():
    """The sequential grower with the same sampling: every split
    identical; leaf values within 2e-5 of the exact float64 outputs of
    their in-bag rows, the JAX leaves within their own error of them plus
    2e-5 (its leaf sums are carried off the rows')."""
    params = dict(BASE, tree_growth="leafwise_serial", **SAMPLE)
    X, y = _problem()
    tb = lt.Booster(dict(params), lt.Dataset(X, label=y), device="cpu")
    grow = tb._gbdt._grow
    seen = []

    def spy(binned, g3, base_mask, **kw):
        out = grow(binned, g3, base_mask, **kw)
        seen.append((g3.numpy().astype(np.float64), out[1].numpy()))
        return out

    tb._gbdt._grow = spy
    for _ in range(7):
        tb.update()
    jb = lj.train(params, lj.Dataset(X, label=y), 7, verbose_eval=False)
    _assert_trees_match(tb, jb, 7, leaf_tol=None)
    for (g3, leaf), jt, tt in zip(seen, jax.device_get(
            jb._gbdt._device_trees), tb._gbdt._device_trees):
        n = int(tt.num_leaves)
        G = np.bincount(leaf, weights=g3[:, 0], minlength=n)
        H = np.bincount(leaf, weights=g3[:, 1], minlength=n)
        exact = -G / H * 0.1                  # the stored, shrunk leaves
        got = tt.leaf_value[:n].numpy().astype(np.float64)
        jleaf = np.asarray(jt.leaf_value)[:n].astype(np.float64)
        bound = 2e-5 * np.maximum(1.0, np.abs(exact))
        assert (np.abs(got - exact) <= bound).all()
        assert (np.abs(got - jleaf) <= np.abs(jleaf - exact) + bound).all()
        # the out-of-bag rows of the tree add nothing
        assert (g3[:, 2] == 0).any() and (g3[g3[:, 2] == 0] == 0).all()


@pytest.mark.parametrize("name", ["bagging_seed", "feature_fraction_seed"])
def test_sampling_seed_trains_its_stream(name):
    """A sampling seed away from its default trains (no longer a refused
    knob): the port's masks under it are the JAX package's, and the model
    differs from the default seed's."""
    params = dict(BASE, **dict(SAMPLE, feature_fraction=0.5), **{name: 11})
    jb, tb, _, _ = _boosters(params)
    if name == "bagging_seed":
        np.testing.assert_array_equal(tb._gbdt._bagging_mask(0).numpy(),
                                      np.asarray(jb._gbdt._bagging_mask(0)))
    else:
        np.testing.assert_array_equal(
            tb._gbdt._tree_feature_mask().numpy(),
            np.asarray(jb._gbdt._tree_feature_mask()))
    X, y = _problem()
    texts = [lt.train(p, lt.Dataset(X, label=y), 3, device="cpu")
             .model_to_string()
             for p in (params, dict(params, **{name: _default(name)}))]
    assert texts[0] != texts[1]


def test_looped_sampling(low_buckets):
    """The persistent loop trains bagging and the per-tree mask, the model
    text of the single round byte for byte; per-node sampling keeps it
    off with the JAX grower's reason (raised: no fallback)."""
    X, y = _problem()
    bag = dict(BASE, bagging_fraction=0.8, bagging_freq=2,
               feature_fraction=0.6, hist_method="fused",
               leafwise_wave_size=8, hist_dtype_deep="bf16x2")
    texts = [lt.train(dict(bag, **extra), lt.Dataset(X, label=y), 4,
                      device="cpu").model_to_string()
             for extra in ({}, {"wave_loop_rounds": 4})]
    assert texts[0] == texts[1]
    with pytest.raises(NotImplementedError, match="feature_fraction_bynode"):
        lt.train(dict(bag, wave_loop_rounds=4, feature_fraction_bynode=0.5),
                 lt.Dataset(X, label=y), 1, device="cpu")
