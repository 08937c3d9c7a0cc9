"""The port's row-block streaming trainer (models/gbdt_stream.py,
models/grower_stream.py) on the CPU: the counterparts of
tests/test_stream_train.py, at its sizes (600 rows, 12 leaves).

With the JAX package's row-order root sum put into both trainers (a
scatter fold: ``grower.root_sums`` for the resident grower, a continued
``index_add_`` into the carried (1, 3) slot for the streamed one,
``histogram.sums_accum``), the streamed model text is the resident
``tree_growth=leafwise_masked`` text byte for byte at any block count
whose rows are a multiple of 32 (torch's CPU vector loop computes a
transcendental, the gradients' sigmoid, in a scalar tail past that, whose
rounding may differ): binary, multiclass and DART, with bagging,
``feature_fraction``, categorical and NaN features and a valid set; from
memory (``stream_enable``) and from a block cache, packed or not.
Against the JAX streamed trainer on the same cache: the same trees,
leaves within 2e-5 (the port's training tolerance).  Also: the scatter
fold continues the resident pass bit for bit, K1's (``pallas``) fold is
``acc + partial`` and at one block the resident pass, the one-hot fold
at one block, the device ledger's bound, checkpoint resume and every
refusal.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbmv1_tpu as lj

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import PARALLEL
from lightgbmv1_tpu_torch.models import gbdt as tgbdt
from lightgbmv1_tpu_torch.models import grower as tgrower
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.models.gbdt_stream import (StreamingDART,
                                                     StreamingGBDT)
from lightgbmv1_tpu_torch.obs import trace
from lightgbmv1_tpu_torch.obs.metrics import default_registry
from lightgbmv1_tpu_torch.ops import hist_cuda
from lightgbmv1_tpu_torch.ops import histogram as thist
from lightgbmv1_tpu_torch.utils import faults
from lightgbmv1_tpu_torch.utils.log import LightGBMError

BASE = {
    "num_leaves": 12, "learning_rate": 0.1, "min_data_in_leaf": 5,
    "verbosity": -1, "tree_growth": "leafwise_masked", "seed": 7,
}
FULL = {**BASE, "objective": "binary", "bagging_fraction": 0.7,
        "bagging_freq": 2, "feature_fraction": 0.8,
        "metric": "binary_logloss"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row_order_root_sums(g3):
    """The JAX sequential grower's root sums: the rows folded in row order
    (a scatter fold, JAX grower.py:259-268)."""
    return torch.zeros((1, 3), dtype=g3.dtype).index_add_(
        0, torch.zeros(g3.shape[0], dtype=torch.int64), g3)[0]


def _row_order_sums_accum(acc, g3):
    """The JAX streamed root sum (JAX ops/histogram.py ``sums_accum``):
    the block's rows ``index_add_``-ed into the carried (1, 3) slot."""
    slot = (torch.zeros((1, 3), dtype=g3.dtype) if acc is None
            else acc.clone()[None])
    return slot.index_add_(0, torch.zeros(g3.shape[0], dtype=torch.int64),
                           g3)[0]


@pytest.fixture
def row_order(monkeypatch):
    monkeypatch.setattr(tgrower, "root_sums", _row_order_root_sums)
    monkeypatch.setattr(thist, "sums_accum", _row_order_sums_accum)


def make_data(n=600, f=10, seed=3, n_class=None):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[:, 7] = rng.randint(0, 6, n)          # categorical
    X[rng.rand(n) < 0.1, 2] = np.nan        # missing
    if n_class:
        y = rng.randint(0, n_class, n).astype(float)
    else:
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    return X, y


def _dataset(X, y, params):
    return lt.Dataset(X, label=y, params=dict(params),
                      categorical_feature=[7])


def train_text(params, X, y, Xv=None, yv=None, rounds=6, data=None):
    ds = _dataset(X, y, params) if data is None else data
    valid = None if Xv is None else [ds.create_valid(Xv, label=yv)]
    evals = {}
    bst = lt.train(dict(params), ds, rounds, valid_sets=valid,
                   evals_result=evals, device="cpu")
    return bst.model_to_string(), evals, bst


def _stream(params, block_rows):
    return {**params, "stream_enable": True, "stream_block_rows": block_rows}


# ---------------------------------------------------------------------------
# the streamed text is the resident text
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_rows", [64, 96, 160])
def test_stream_parity_binary_full_features(row_order, block_rows):
    """Binary with bagging, feature_fraction, a categorical and a NaN
    feature and a valid set, streamed in ragged blocks: the resident
    text and per-iteration valid metrics."""
    X, y = make_data(n=450)
    Xv, yv = make_data(n=150, seed=9)
    t_res, ev_res, _ = train_text(FULL, X, y, Xv, yv, rounds=5)
    t_str, ev_str, bst = train_text(_stream(FULL, block_rows), X, y, Xv, yv,
                                    rounds=5)
    assert isinstance(bst._gbdt, StreamingGBDT)
    assert bst._gbdt._source.num_blocks == -(-450 // block_rows)
    assert t_res == t_str
    assert ev_res == ev_str


@pytest.mark.parametrize("block_rows", [96, 128])
def test_stream_parity_multiclass(row_order, block_rows):
    X, y = make_data(n=450, n_class=3)
    Xv, yv = make_data(n=150, seed=11, n_class=3)
    params = {**BASE, "objective": "multiclass", "num_class": 3,
              "num_leaves": 8}
    t_res, ev_res, _ = train_text(params, X, y, Xv, yv, rounds=5)
    t_str, ev_str, _ = train_text(_stream(params, block_rows), X, y, Xv, yv,
                                  rounds=5)
    assert t_res == t_str
    assert ev_res == ev_str


@pytest.mark.parametrize("removal", ["lids", "walk"])
def test_stream_parity_dart(row_order, monkeypatch, removal):
    """DART with real drops over 8 rounds, bagging and a valid set: the
    streamed removals (through the recorded host leaf ids, or with the
    budget at 1 byte by block-by-block tree walks) give the resident
    text."""
    if removal == "walk":
        monkeypatch.setattr(tgbdt.DART, "LID_BUDGET_BYTES", 1)
    drops = []
    select = tgbdt.DART._select_drops

    def spy(self):
        d = select(self)
        drops.append(len(d))
        return d

    monkeypatch.setattr(tgbdt.DART, "_select_drops", spy)
    X, y = make_data()
    Xv, yv = make_data(n=200, seed=9)
    params = {**BASE, "objective": "binary", "boosting": "dart",
              "drop_rate": 0.5, "bagging_fraction": 0.8,
              "bagging_freq": 1, "metric": "binary_logloss"}
    t_res, ev_res, _ = train_text(params, X, y, Xv, yv, rounds=8)
    t_str, ev_str, bst = train_text(_stream(params, 96), X, y, Xv, yv,
                                    rounds=8)
    assert isinstance(bst._gbdt, StreamingDART)
    assert sum(drops[8:]) > 0
    assert bst._gbdt._lids_usable() == (removal == "lids")
    assert t_res == t_str
    assert ev_res == ev_str


def test_stream_block_edges_and_disk_cache(row_order, tmp_path):
    """A ragged tail, one block, a block past N: the same bytes, from
    memory and from a digest-checked cache on disk."""
    X, y = make_data(n=300)
    params = {**BASE, "objective": "binary"}
    t_res, _, _ = train_text(params, X, y, rounds=3)
    for block_rows in (96, 300, 1000):
        t_str, _, _ = train_text(_stream(params, block_rows), X, y, rounds=3)
        assert t_str == t_res, f"block_rows={block_rows}"
    cache = str(tmp_path / "blocks")
    _dataset(X, y, params).save_block_cache(cache, block_rows=96)
    t_disk, _, bst = train_text(params, None, None, rounds=3,
                                data=lt.Dataset(cache, params=dict(params)))
    assert isinstance(bst._gbdt, StreamingGBDT)
    assert t_disk == t_res


def test_stream_packed_cache_training_parity(row_order, tmp_path):
    """A packed4 cache streams its packed blocks (decoded per block for
    the CPU's scatter fold): the resident u8 text."""
    from lightgbmv1_tpu_torch.data import load_manifest

    X, y = make_data(n=300)
    params = {**BASE, "objective": "binary", "max_bin": 15}
    t_res, _, _ = train_text(params, X, y, rounds=3)
    cache = str(tmp_path / "blocks")
    _dataset(X, y, params).save_block_cache(cache, block_rows=96)
    assert load_manifest(cache)["bin_layout"] == "packed4"
    t_str, _, bst = train_text(params, None, None, rounds=3,
                               data=lt.Dataset(cache, params=dict(params)))
    assert bst._gbdt._packed
    assert t_str == t_res


def test_stream_parity_onehot_single_block():
    """The one-hot fold at one block is the resident product."""
    X, y = make_data(n=200)
    params = {**BASE, "objective": "binary", "hist_method": "onehot",
              "num_leaves": 6}
    t_res, _, _ = train_text(params, X, y, rounds=2)
    t_str, _, _ = train_text(_stream(params, 4096), X, y, rounds=2)
    assert t_res == t_str


@pytest.mark.parametrize("layout", ["u8", "packed4"])
def test_stream_pallas_one_block_and_partial_fold(tmp_path, layout):
    """``hist_method=pallas`` (K1's plain version on the CPU): one block
    writes the resident text byte for byte (a packed cache's blocks read
    by the packed leg, as the resident set packs); more blocks fold K1's
    per-block partials, the same text twice."""
    X, y = make_data(n=300)
    params = {**BASE, "objective": "binary", "hist_method": "pallas",
              "max_bin": 15, "bin_layout": layout}
    t_res, _, res = train_text(params, X, y, rounds=3)
    assert res._gbdt._packed == (layout == "packed4")
    cache = str(tmp_path / "one")
    _dataset(X, y, params).save_block_cache(cache, block_rows=300)
    t_one, _, bst = train_text(params, None, None, rounds=3,
                               data=lt.Dataset(cache, params=dict(params)))
    assert bst._gbdt._packed == (layout == "packed4")
    assert t_one == t_res
    hist_cuda.reset_launch_counts()
    t_a, _, _ = train_text(_stream(params, 96), X, y, rounds=3)
    assert hist_cuda.plain_counts["hist_leaves"] > 0
    assert hist_cuda.plain_counts["hist_leaves_scatter"] == 0
    t_b, _, _ = train_text(_stream(params, 96), X, y, rounds=3)
    assert t_a == t_b


# ---------------------------------------------------------------------------
# the folds
# ---------------------------------------------------------------------------


def test_hist_accum_continues_resident_fold():
    """The scatter fold continues the resident pass bit for bit at any
    block split; K1's fold is ``acc + K1(block)`` in block order and one
    block is the resident K1 pass; the one-hot fold at one block is the
    resident product; ``sums_accum`` is ``acc + root_sums(block)``, one
    block the resident sum."""
    rng = np.random.RandomState(0)
    N, F, B = 500, 4, 8
    bins = torch.as_tensor(rng.randint(0, B, (F, N)).astype(np.uint8))
    g3 = torch.as_tensor(rng.randn(N, 3).astype(np.float32))
    lid = torch.as_tensor(rng.randint(0, 2, N).astype(np.int32))

    def fold(method, block, fn=thist.hist_one_leaf_accum):
        acc = None
        for a in range(0, N, block):
            b = min(a + block, N)
            acc = fn(acc, bins[:, a:b].contiguous(), g3[a:b], lid[a:b], 0,
                     B, method=method)
        return acc

    for method in ("scatter", "onehot", "pallas"):
        full = thist.hist_one_leaf(bins, g3, lid, 0, B, method=method)
        assert torch.equal(fold(method, 1000), full), method
    full = thist.hist_one_leaf(bins, g3, lid, 0, B, method="scatter")
    for block in (64, 100, 500):
        assert torch.equal(fold("scatter", block), full), block
        want = None
        for a in range(0, N, block):
            part = thist.hist_one_leaf(bins[:, a:a + block].contiguous(),
                                       g3[a:a + block], lid[a:a + block], 0,
                                       B, method="pallas")
            want = part if want is None else want + part
        assert torch.equal(fold("pallas", block), want), block
        rs, want = None, None
        for a in range(0, N, block):
            rs = thist.sums_accum(rs, g3[a:a + block])
            s = g3[a:a + block].sum(dim=0)
            want = s if want is None else want + s
        assert torch.equal(rs, want)
    assert torch.equal(thist.sums_accum(None, g3), thist.root_sums(g3))


# ---------------------------------------------------------------------------
# against the JAX streamed trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_cache_run(tmp_path_factory):
    """The JAX streamed training of a cache the port wrote (once)."""
    X, y = make_data()
    Xv, yv = make_data(n=200, seed=9)
    cache = str(tmp_path_factory.mktemp("jaxstream") / "blocks")
    _dataset(X, y, FULL).save_block_cache(cache, block_rows=96)
    ds = lj.Dataset(cache, params=dict(FULL))
    evals = {}
    jb = lj.train(dict(FULL), ds, 5,
                  valid_sets=[ds.create_valid(Xv, label=yv)],
                  evals_result=evals, verbose_eval=False)
    return cache, jb, evals, Xv, yv


def test_stream_matches_jax_streamed_trainer(row_order, jax_cache_run):
    """The same cache through both packages' streamed trainers: every
    tree's structure identical, leaves within 2e-5, the valid metric
    close."""
    import jax

    cache, jb, j_evals, Xv, yv = jax_cache_run
    ds = lt.Dataset(cache, params=dict(FULL))
    evals = {}
    tb = lt.train(dict(FULL), ds, 5,
                  valid_sets=[ds.create_valid(Xv, label=yv)],
                  evals_result=evals, device="cpu")
    assert isinstance(tb._gbdt, StreamingGBDT)
    jtrees = jax.device_get(jb._gbdt._device_trees)
    assert len(jtrees) == len(tb._gbdt._device_trees) == 5
    for jt, tt in zip(jtrees, tb._gbdt._device_trees):
        c = tree_arrays_from_numpy(jt._asdict())
        n = int(c.num_leaves)
        assert n == int(tt.num_leaves) > 1
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child", "is_cat"):
            assert torch.equal(getattr(c, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                   c.leaf_value[:n].numpy(), rtol=0,
                                   atol=2e-5)
    np.testing.assert_allclose(evals["valid_0"]["binary_logloss"],
                               j_evals["valid_0"]["binary_logloss"],
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the memory contract, the lifecycle, the refusals
# ---------------------------------------------------------------------------


def test_stream_memory_guard():
    """The ledger's peak is the same when the rows triple at a fixed block
    size, stays within the analytic bound (the leaf-sized state and two
    blocks in flight) and holds the block transfers; the gauge reads it
    and the stream's spans are traced."""
    def peak_for(n, block_rows):
        rng = np.random.RandomState(0)
        X = rng.randn(n, 20)
        y = (X[:, 0] > 0).astype(float)
        params = {**BASE, "objective": "binary", "num_leaves": 7,
                  "max_bin": 15, "stream_enable": True,
                  "stream_block_rows": block_rows}
        bst = lt.train(dict(params), lt.Dataset(X, label=y), 1,
                       device="cpu")
        return bst._gbdt.stream_peak_device_bytes, bst._gbdt._ledger

    trace.arm()
    try:
        p_small, ledger = peak_for(2048, 256)
        spans = {e[0] for e in trace.drain()["events"]}
    finally:
        trace.disarm()
    p_big_n, _ = peak_for(6144, 256)
    assert p_big_n == p_small
    assert {"stream.fetch_block", "stream.h2d_block",
            "stream.accumulate"} <= spans
    assert {"block_bins", "block_g3", "block_lid",
            "hist_pool"} <= set(ledger.peak_tags)
    assert ledger.live_bytes == 0
    F, B, L = 20, 16, 7
    for block, peak in ((256, p_small), (256, p_big_n)):
        bound = (L + 3) * F * B * 3 * 4 + 4 * block * (F + 16) + 64 * 1024
        assert 2 * block * F < peak <= bound, (peak, bound)
    gauge = default_registry().gauge("stream_peak_device_bytes")
    assert gauge.get() == p_big_n


def test_stream_checkpoint_resume_bit_exact(tmp_path):
    """Two streamed iterations, a checkpoint, a fresh trainer resumed for
    two more: the uninterrupted run's text."""
    X, y = make_data(n=288)
    params = {**BASE, "objective": "binary", "feature_fraction": 0.7,
              "bagging_fraction": 0.8, "bagging_freq": 1,
              "stream_enable": True, "stream_block_rows": 96}
    t_straight, _, _ = train_text(params, X, y, rounds=4)
    part = lt.train(dict(params), _dataset(X, y, params), 2, device="cpu")
    ckpt = str(tmp_path / "state.ckpt")
    part.save_checkpoint(ckpt)
    resumed = lt.train(dict(params), _dataset(X, y, params), 2,
                       init_model=ckpt, device="cpu")
    assert isinstance(resumed._gbdt, StreamingGBDT)
    assert resumed.model_to_string() == t_straight


def test_stream_checkpoint_resume_dart(tmp_path):
    """Streamed DART: the drop stream, the tree weights and the recorded
    host leaf ids restored; the uninterrupted run's text."""
    X, y = make_data(n=400)
    params = {**BASE, "objective": "binary", "boosting": "dart",
              "drop_rate": 0.5, "stream_enable": True,
              "stream_block_rows": 128}
    t_straight, _, _ = train_text(params, X, y, rounds=6)
    part = lt.train(dict(params), _dataset(X, y, params), 3, device="cpu")
    ckpt = str(tmp_path / "state.ckpt")
    part.save_checkpoint(ckpt)
    resumed = lt.train(dict(params), _dataset(X, y, params), 3,
                       init_model=ckpt, device="cpu")
    assert resumed._gbdt._train_lids[0].device.type == "cpu"
    assert resumed.model_to_string() == t_straight


def test_stream_grad_poison_clamp_matches_resident(row_order):
    """``finite_guard=clamp`` under an armed ``grad_poison``: the streamed
    blocks poison the rows at their global offsets, the resident text."""
    X, y = make_data(n=300)
    params = {**BASE, "objective": "binary", "finite_guard": "clamp"}
    texts = []
    for p in (params, _stream(params, 64)):
        with faults.inject(faults.FaultSpec("grad_poison", payload=1)):
            texts.append(train_text(p, X, y, rounds=3)[0])
    assert texts[0] == texts[1]
    assert texts[0] != train_text(params, X, y, rounds=3)[0]


def test_stream_rejects_unsupported_configs(tmp_path):
    """Each configuration the JAX streamed trainer refuses raises with its
    words, ``hist_method=fused`` too (where the JAX package falls back),
    and the parallel learners raise their ROADMAP item."""
    X, y = make_data(n=200)
    base = {**BASE, "objective": "binary", "stream_enable": True,
            "stream_block_rows": 64}

    def build(extra, y_=y, group=None, **kw):
        p = {**base, **extra}
        ds = lt.Dataset(X, label=y_, group=group, params=dict(p))
        return lt.train(p, ds, 1, device="cpu", **kw)

    forced = tmp_path / "forced.json"
    forced.write_text('{"feature": 0, "threshold": 0.0}')
    for extra, words in (
            ({"boosting": "goss"}, "streaming"),
            ({"boosting": "rf", "bagging_freq": 1,
              "bagging_fraction": 0.5}, "streaming"),
            ({"tree_growth": "levelwise"}, "leaf-wise"),
            ({"objective": "regression_l1"}, "renews leaf values"),
            ({"hist_method": "fused"}, "hist_method=fused"),
            ({"forcedsplits_filename": str(forced)}, "forcedsplits"),
            ({"cegb_penalty_split": 1.0}, "CEGB")):
        with pytest.raises(LightGBMError, match=words):
            build(extra)
    with pytest.raises(LightGBMError, match="query groups"):
        build({"objective": "lambdarank"}, y_=np.clip(y, 0, 3),
              group=np.full(8, 25))
    with pytest.raises(LightGBMError, match="fobj"):
        build({}, fobj=lambda preds, d: (preds, np.ones_like(preds)))
    with pytest.raises(LightGBMError, match="streaming training requires "
                       "tree_learner=serial"):
        build({"tree_learner": "data"})
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1, {PARALLEL}$"):
        build({"elastic_max_restarts": 5})
    # EFB bundle-only data: CSR rows of exclusive features bundle with no
    # dense bins
    rng = np.random.RandomState(0)
    onehot = np.zeros((400, 8))
    onehot[np.arange(400), rng.randint(0, 8, 400)] = rng.rand(400) + 0.5
    sparse = lt.Dataset(sp.csr_matrix(onehot), label=y[:1].repeat(400),
                        params=dict(base)).construct()
    assert sparse._binned.binned is None
    with pytest.raises(LightGBMError, match="bundle-only"):
        lt.train(dict(base), sparse, 1, device="cpu")


def test_stream_rollback_one_iter():
    """``rollback_one_iter`` on the streamed trainer restores the host
    scores and the trees: trained on, the uninterrupted run's text."""
    X, y = make_data(n=300)
    params = _stream({**BASE, "objective": "binary", "bagging_fraction":
                      0.8, "bagging_freq": 1}, 96)
    t_straight, _, _ = train_text(params, X, y, rounds=3)
    bst = lt.Booster(dict(params), train_set=_dataset(X, y, params),
                     device="cpu")
    for _ in range(3):
        bst.update()
    before = bst._gbdt._train_scores.score.clone()
    bst.update()
    bst.rollback_one_iter()
    assert torch.equal(bst._gbdt._train_scores.score, before)
    assert bst.model_to_string() == t_straight


def test_stream_model_reference_matches_resident(row_order, tmp_path):
    """``capture_model_reference`` of a streamed trainer folds the bin
    occupancy block by block (a packed cache's blocks decoded): the
    resident trainer's reference bytes."""
    X, y = make_data(n=300)
    params = {**BASE, "objective": "binary", "max_bin": 15}
    _, _, res = train_text(params, X, y, rounds=2)
    cache = str(tmp_path / "blocks")
    _dataset(X, y, params).save_block_cache(cache, block_rows=96)
    _, _, bst = train_text(params, None, None, rounds=2,
                           data=lt.Dataset(cache, params=dict(params)))
    assert bst._gbdt._packed
    assert bst.capture_model_reference().to_bytes() == \
        res.capture_model_reference().to_bytes()
