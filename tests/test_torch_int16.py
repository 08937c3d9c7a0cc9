"""int16 bins (``max_bin > 255``) of the port against the JAX package, on
the CPU.

Past 256 bins a feature both packages store int16 bins (the reference's
``DenseBin<uint16_t>``), bin for bin the same.  On the card the port
trains them through the one-hot histogram, the split-scan kernel's wide
leg (its bins in chunks of 256, the same values as the 256-bin scan) and
K3's 16-bit leg, whose plain versions are held here: the wide scan is the
ordinary plain scan at any bin count, held to the JAX ``find_best_split``
on 512-bin histograms, and the routing's plain version on int16 bins to
the JAX ``fused_route_rows`` (Pallas interpreted) round by round.

Tolerances: bins exact; picks identical, gains and sums as
tests/test_torch_split_pick.py; leaf ids exact; f32 trees every split
identical, leaves within 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.config import Config as JConfig
from lightgbmv1_tpu.io.dataset import BinnedDataset as JBinned
from lightgbmv1_tpu.models import grower_wave as jgw
from lightgbmv1_tpu.ops import split as jsplit
from lightgbmv1_tpu.ops import wave_fused as jwf

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.dataset import BinnedDataset
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.ops import fused_cuda, scan_cuda
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops import wave_fused as twf
from tests.test_torch_split_pick import (OPTIONS, _children, _gain_tol,
                                         _legs, _params)

BASE = {"objective": "binary", "verbosity": -1, "seed": 7, "max_bin": 300,
        "min_data_in_bin": 1, "num_leaves": 15, "min_data_in_leaf": 20,
        "hist_dtype": "f32"}


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


def _problem(n=4096, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[::7, 2] = np.nan
    X[::5, 3] = 0.0
    y = (X[:, 0] * 1.5 - X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


@pytest.mark.parametrize("max_bin", [300, 511])
def test_int16_bins_match_jax(max_bin):
    """At max_bin 300 and 511 the bins are int16 and the JAX package's
    bin for bin, the valid set's (binned with the training bins) too; the
    bin axis is the next power of two."""
    X, y = _problem()
    params = {"max_bin": max_bin, "min_data_in_bin": 1, "verbosity": -1}
    t = BinnedDataset.from_numpy(X[:3000], label=y[:3000],
                                 config=Config.from_dict(params))
    j = JBinned.from_numpy(X[:3000], label=y[:3000],
                           config=JConfig.from_dict(params))
    assert t.binned.dtype == np.int16 and np.asarray(j.binned).dtype \
        == np.int16
    np.testing.assert_array_equal(t.binned, np.asarray(j.binned))
    assert t.num_total_bin > 256 and t.padded_bin == 512
    tv = BinnedDataset.from_numpy(X[3000:], config=Config.from_dict(params),
                                  reference=t)
    jv = JBinned.from_numpy(X[3000:], config=JConfig.from_dict(params),
                            reference=j)
    np.testing.assert_array_equal(tv.binned, np.asarray(jv.binned))
    u8 = BinnedDataset.from_numpy(X, config=Config.from_dict(
        {"max_bin": 255, "verbosity": -1}))
    assert u8.binned.dtype == np.uint8


@pytest.mark.parametrize("case", ["none", "all"])
@pytest.mark.parametrize("rand", [False, True], ids=["full", "extra_trees"])
def test_wide_scan_matches_jax(case, rand):
    """The scan at B = 512 (the wide leg's plain version), with and
    without extra_trees, against the JAX ``find_best_split``."""
    opts = OPTIONS[case]
    C, F, B = 4, 5, 512
    d = _children(23, F, B, C, opts)
    jp, tp, pen = _params(opts)
    if rand:
        jp = jp._replace(extra_trees=True, extra_seed=4)
        tp = tp._replace(extra_trees=True, extra_seed=4)
    key = (11, 22)
    jkey = jnp.asarray(key, jnp.uint32)
    uids = np.array([0, 1, 2, 9], np.int32)
    t = torch.from_numpy
    packed = scan_cuda.split_scan_pick(
        t(d["hist"]), t(d["mask"]), t(d["csums"]), meta=d["tmeta"],
        params=tp, rand=tsplit.rand_leg(tp, key, t(uids), C,
                                        torch.device("cpu")),
        **_legs(d, tp))
    res = tsplit.unpack_children(packed, B)

    def one(h, s, m, cst, dep, po, u):
        rk = (jax.random.fold_in(jkey, u + 1_000_003 + jp.extra_seed)
              if rand else None)
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
    assert fin.sum() >= 2
    assert d["hist"][:, :, 256:, 2].sum() > 0     # mass past bin 255
    shift = np.asarray(jax.vmap(lambda s, po: jsplit.gain_shift(s, po, jp))(
        jnp.asarray(d["csums"]), jnp.asarray(d["pout"])))
    assert (np.abs(res.gain.numpy()[fin] - jg[fin])
            <= _gain_tol(jg[fin], shift[fin])).all()
    tol = 4e-6 * d["absum"][fin] + 1e-6
    assert (np.abs(res.left_sum.numpy()[fin] - np.asarray(j.left_sum)[fin])
            <= tol).all()


def test_route_int16_matches_jax():
    """K3's plain version on int16 bins of 512 values, through three
    rounds of splits at thresholds past 255 too, in one call, against
    the JAX ``fused_route_rows`` (interpret mode) round by round: leaf
    ids exact."""
    rng = np.random.RandomState(5)
    F, N = 4, 3000
    binned = rng.randint(0, 512, (F, N)).astype(np.int16)
    nb = np.full(F, 512)
    mt = np.array([0, 1, 2, 0])
    meta = tsplit.with_tables(tsplit.FeatureMeta(
        num_bins=torch.as_tensor(nb), missing_type=torch.as_tensor(mt),
        nan_bin=torch.as_tensor(np.where(mt == 2, 511, -1)),
        zero_bin=torch.as_tensor(np.where(mt == 1, 7, 0)),
        usable=torch.ones(F, dtype=torch.bool)))
    jmeta = jsplit.FeatureMeta(
        num_bins=jnp.asarray(nb, jnp.int32), missing_type=jnp.asarray(mt,
                                                                      jnp.int32),
        nan_bin=jnp.asarray(np.where(mt == 2, 511, -1), jnp.int32),
        zero_bin=jnp.asarray(np.where(mt == 1, 7, 0), jnp.int32),
        is_categorical=jnp.zeros(F, bool), usable=jnp.ones(F, bool),
        monotone_type=jnp.zeros(F, jnp.int32))
    # rounds of 1, 2 and 3 splits; leaf j + 1 is split j's right child
    leafs = np.array([0, 0, 1, 0, 2, 3])
    feats = np.array([0, 1, 3, 2, 0, 1])
    thrs = np.array([300, 100, 400, 255, 20, 511])
    dls = np.array([0, 1, 0, 1, 1, 0])
    nls = np.arange(1, 7)
    offsets = [0, 1, 3, 6]
    t = lambda a: torch.as_tensor(a, dtype=torch.int32)
    rmeta = twf.pack_route_meta(t(feats), t(thrs), t(dls), t(leafs), t(nls),
                                meta)
    got = fused_cuda.route_rows_ref(
        torch.from_numpy(binned), torch.zeros(N, dtype=torch.int32),
        t(feats), rmeta, 7, offsets=t(offsets))
    lids = jnp.zeros(N, jnp.int32)
    for o0, o1 in zip(offsets[:-1], offsets[1:]):
        lids = jwf.fused_route_rows(
            jnp.asarray(binned), lids, feats=jnp.asarray(feats[o0:o1]),
            thrs=jnp.asarray(thrs[o0:o1]), dls=jnp.asarray(dls[o0:o1] != 0),
            leafs=jnp.asarray(leafs[o0:o1]), nls=jnp.asarray(nls[o0:o1]),
            num_leaves=7, meta=jmeta, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(lids))
    assert len(np.unique(got.numpy())) == 7


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
    {"leafwise_wave_size": 4, "hist_method": "onehot"},
    {"tree_growth": "levelwise", "max_bin": 511},
    {"tree_growth": "leafwise_serial"}],
    ids=["wave", "wave onehot", "level-wise 511", "sequential"])
def test_int16_trees_match_jax(low_buckets, extra):
    """f32 trainings on int16 bins grow the JAX package's trees on the
    wave (the valid set routed on its int16 bins), level-wise and
    sequential growers: every split identical (thresholds past 255
    among them), leaves within 2e-5 (the sequential grower's structure
    only, its JAX leaves carrying their own error off the rows' sums)."""
    X, y = _problem()
    params = dict(BASE, **extra)
    tb = lt.train(params, lt.Dataset(X[:3000], label=y[:3000]), 4,
                  valid_sets=[lt.Dataset(X[3000:], label=y[3000:])],
                  evals_result=(tev := {}), device="cpu")
    assert tb._gbdt.binned.dtype == torch.int16
    jb = lj.train(params, lj.Dataset(X[:3000], label=y[:3000]), 4,
                  valid_sets=[lj.Dataset(X[3000:], label=y[3000:])],
                  evals_result=(jev := {}), verbose_eval=False)
    sequential = extra.get("tree_growth") == "leafwise_serial"
    _assert_trees_match(tb, jb, 4, None if sequential else 2e-5)
    assert any((t.threshold_bin[:t.num_leaves - 1] > 255).any()
               for t in tb._all_trees())
    if not sequential:
        np.testing.assert_allclose(tev["valid_0"]["binary_logloss"],
                                   jev["valid_0"]["binary_logloss"],
                                   rtol=0, atol=1e-6)


def test_fused_refuses_int16():
    """hist_method=fused on int16 bins raises the JAX gate's reason."""
    X, y = _problem(1024)
    with pytest.raises(NotImplementedError,
                       match="int16 bins exceed the uint8 one-hot kernel "
                             "family"):
        lt.train(dict(BASE, hist_method="fused"), lt.Dataset(X, label=y), 1,
                 device="cpu")
    assert twf.fused_ineligible_reason(bin_dtype=torch.int16,
                                       num_bins=512) != ""
