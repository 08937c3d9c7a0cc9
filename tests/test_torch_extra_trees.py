"""extra_trees of the port against the JAX package, on the CPU.

The JAX package draws one threshold a feature a scanned node
(ops/split.py:602-607): ``uniform(fold_in(tree_key, uid + 1_000_003 +
extra_seed), (F,))`` times ``max(num_bins - 1, 1)`` in f32, truncated,
and only that threshold stays a candidate.  The port's plain version
(``split.extra_rand_bins``, which the split-scan kernel's rand leg draws
bit for bit on the card, chip_smoke.py phase 38) takes the same threefry
stream, so the thresholds are the JAX package's exactly and the same
seeds grow the same trees.

Tolerances: thresholds exact; picks (feature, threshold, direction)
identical, gains and sums as tests/test_torch_split_pick.py holds the
unrandomized scan (the tie band absorbs the f32 summation order);
trainings every split identical and leaves within 2e-5 (the port's
training tolerance; the sequential grower's structure only, its JAX
leaves carrying their own error off the rows' sums).  The trainings set
``min_gain_to_split=0.01`` (see BASE).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.models import grower_wave as jgw
from lightgbmv1_tpu.ops import split as jsplit

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.ops import scan_cuda
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.utils import prng
from tests.test_torch_split_pick import (OPTIONS, _children, _gain_tol,
                                         _legs, _params)

# min_gain_to_split keeps the positive-gain gate out of the f32 noise of
# a gain near 0: a random threshold often splits off rows whose mean is
# the parent's, a relative gain of a few parts in 2^24 of the parent's
# gain, which the two packages' summation orders put on either side of 0
BASE = {"objective": "binary", "verbosity": -1, "seed": 7, "max_bin": 63,
        "num_leaves": 15, "min_data_in_leaf": 20, "extra_trees": True,
        "hist_dtype": "f32", "min_gain_to_split": 0.01}
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


def _jax_rand_bins(jkey, uids, seed, nb):
    """The JAX package's draw (split.py:605-606), one uid at a time."""
    out = []
    for u in uids:
        rk = jax.random.fold_in(jkey, jnp.int32(u) + 1_000_003 + seed)
        v = jax.random.uniform(rk, (len(nb),))
        out.append(np.asarray((v * jnp.maximum(jnp.asarray(nb, jnp.int32)
                                               - 1, 1)).astype(jnp.int32)))
    return np.stack(out)


@pytest.mark.parametrize("seed", [6, 0, 12345, -3])
def test_rand_bins_match_jax(seed):
    """``extra_rand_bins`` of a batch of uids (the root, leaf-wise and
    level-wise numbering, a large uid) over features of 1 to 511 bins is
    the JAX package's draw exactly."""
    nb = [1, 2, 3, 16, 63, 64, 255, 256, 300, 511]
    uids = [0, 1, 2, 7, 30, 2 * 15 * 3 + 4, 70000]
    key = prng.fold_in(prng.prng_key(7), 13)
    jkey = jax.random.fold_in(jax.random.PRNGKey(7), 13)
    got = tsplit.extra_rand_bins(
        tsplit.RandLeg(key, torch.tensor(uids, dtype=torch.int32), seed),
        torch.tensor(nb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_rand_bins(jkey, uids, seed, nb))
    assert (got.numpy() <= np.maximum(np.array(nb) - 1, 1)).all()


@pytest.mark.parametrize("case", ["none", "monotone", "smooth", "all"])
def test_scan_with_rand_matches_jax(case):
    """The split scan's plain version with the rand leg (the split-scan
    kernel's on the card) against the JAX ``find_best_split`` given each
    child's ``rand_key``: picks identical, every finite pick on its
    feature's drawn threshold, gains and sums within the scan's
    tolerances; the thresholds it hands out (``rand_out``) are
    ``extra_rand_bins``'."""
    opts = OPTIONS[case]
    C, F, B = 6, 11, 16
    d = _children(41, F, B, C, opts)
    jp, tp, pen = _params(opts)
    jp = jp._replace(extra_trees=True, extra_seed=9)
    tp = tp._replace(extra_trees=True, extra_seed=9)
    key = prng.fold_in(prng.prng_key(3), 2)
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    uids = np.array([0, 1, 2, 5, 6, 40], np.int32)
    t = torch.from_numpy
    rand = tsplit.rand_leg(tp, key, t(uids), C, torch.device("cpu"))
    rout = torch.full((C, F), -1, dtype=torch.int32)
    packed = scan_cuda.split_scan_pick(
        t(d["hist"]), t(d["mask"]), t(d["csums"]), meta=d["tmeta"],
        params=tp, rand=rand, rand_out=rout, **_legs(d, tp))
    res = tsplit.unpack_children(packed, B)
    rb = tsplit.extra_rand_bins(rand, d["tmeta"].num_bins)
    assert torch.equal(rout, rb)

    def one(h, s, m, cst, dep, po, u):
        rk = jax.random.fold_in(jkey, u + 1_000_003 + jp.extra_seed)
        return jsplit.find_best_split(
            h, s, d["jmeta"], m, jp, constraint=cst, depth=dep,
            monotone_penalty=pen, parent_output=po, rand_key=rk)

    j = jax.vmap(one)(*(jnp.asarray(d[k]) for k in (
        "hist", "csums", "mask", "constr", "depth", "pout")),
        jnp.asarray(uids))
    for f in ("feature", "threshold_bin", "default_left"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(j, f)))
    jg = np.asarray(j.gain)
    fin = np.isfinite(jg)
    np.testing.assert_array_equal(torch.isfinite(res.gain).numpy(), fin)
    assert fin.sum() >= 2
    feat = res.feature.numpy()
    np.testing.assert_array_equal(
        res.threshold_bin.numpy()[fin], rb.numpy()[np.arange(C), feat][fin])
    shift = np.asarray(jax.vmap(lambda s, po: jsplit.gain_shift(s, po, jp))(
        jnp.asarray(d["csums"]), jnp.asarray(d["pout"])))
    assert (np.abs(res.gain.numpy()[fin] - jg[fin])
            <= _gain_tol(jg[fin], shift[fin])).all()
    tol = 4e-6 * d["absum"][fin] + 1e-6
    assert (np.abs(res.left_sum.numpy()[fin] - np.asarray(j.left_sum)[fin])
            <= tol).all()
    # without extra_trees in the params no threshold is drawn
    assert tsplit.rand_leg(tp._replace(extra_trees=False), key, uids, C,
                           torch.device("cpu")) is None


def _train_both(params, rounds=4):
    rng = np.random.RandomState(0)
    X = rng.randn(N, 8)
    X[:, 7] = 1.0
    y = (X[:, 0] * 1.5 - X[:, 1] + 0.3 * rng.randn(N) > 0).astype(float)
    tb = lt.train(params, lt.Dataset(X, label=y), rounds, device="cpu")
    jb = lj.train(params, lj.Dataset(X, label=y), rounds, verbose_eval=False)
    return tb, jb, X


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


@pytest.mark.parametrize("extra", [
    {"leafwise_wave_size": 4},
    {"leafwise_wave_size": 4, "extra_seed": 101},
    {"tree_growth": "levelwise"},
    {"tree_growth": "levelwise", "extra_seed": 0,
     "feature_fraction_bynode": 0.7}],
    ids=["wave", "wave extra_seed", "level-wise", "level-wise bynode"])
def test_extra_trees_match_jax(low_buckets, extra):
    """extra_trees on the wave grower (staged) and the level-wise grower,
    at the default and other extra_seeds (and with per-node feature
    sampling, which shares the uids): f32 trees structurally the JAX
    package's, leaves within 2e-5."""
    params = dict(BASE, **extra)
    tb, jb, X = _train_both(params)
    _assert_trees_match(tb, jb, 4)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=2e-5 * 4)


def test_extra_trees_sequential_matches_jax():
    """The sequential grower (one scan a step, the uids 2s + 1 and
    2s + 2): every split and leaf count the JAX package's (its leaf
    values carry its own error off the rows' sums, so the sequential
    grower's are held to the exact outputs in tests/test_torch_sampling.py,
    not to them)."""
    params = dict(BASE, tree_growth="leafwise_serial", extra_seed=77)
    tb, jb, X = _train_both(params)
    _assert_trees_match(tb, jb, 4, leaf_tol=None)


def test_extra_trees_changes_the_trees():
    """extra_trees trains other trees than the full scan, and another
    extra_seed other random trees; the same seed the same text."""
    rng = np.random.RandomState(1)
    X = rng.randn(N, 6)
    y = (X[:, 0] - X[:, 2] + rng.randn(N) > 0).astype(float)

    def text(**kw):
        return lt.train(dict(BASE, **kw), lt.Dataset(X, label=y), 3,
                        device="cpu").model_to_string()

    base = text()
    assert base == text()
    assert base != text(extra_trees=False)
    assert base != text(extra_seed=8)


def test_fused_refuses_extra_trees():
    """hist_method=fused (single round and the loop) raises the JAX gate's
    reason: the fused kernels draw no per-node thresholds."""
    rng = np.random.RandomState(2)
    X = rng.randn(512, 6)
    y = (X[:, 0] > 0).astype(float)
    for extra in ({}, {"wave_loop_rounds": 2}):
        with pytest.raises(NotImplementedError,
                           match="extra_trees draws per-node randomness "
                                 "inside the scan"):
            lt.train(dict(BASE, hist_method="fused", **extra),
                     lt.Dataset(X, label=y), 1, device="cpu")
