"""The port's data, feature and voting learners over gloo ranks on the CPU,
a counterpart of each test of tests/test_parallel.py.

Two ranks (and once three) run as subprocesses (tests/torch_ranks.py),
each given the whole set, of which the trainer takes its rows.  Their
models are held to the port's serial learner on the same rows and to the
JAX learners at ``num_shards=2`` on the package's 8 virtual CPU devices
(the module's ``jax_ref``, one training a learner), to the JAX tests' own
tolerances: the same structure, leaves ``rtol=1e-3, atol=1e-5``, raw
scores likewise (regression ``atol=1e-4``).  Every rank writes the same
model text byte for byte, and every collective's payload is the analytic
table's (obs/metrics.comm_table_per_round) at its call's width."""

import re

import numpy as np
import pytest
import torch

from conftest import make_binary_problem, make_regression_problem
from torch_ranks import run_ranks

from lightgbmv1_tpu_torch import Dataset, train
from lightgbmv1_tpu_torch import config as tconfig
from lightgbmv1_tpu_torch.io.model_text import model_from_string
from lightgbmv1_tpu_torch.obs.metrics import comm_table_per_round

BASE = {"objective": "binary", "min_data_in_leaf": 5, "verbosity": -1}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mc_data():
    rng = np.random.RandomState(0)
    X = rng.randn(900, 5)
    y = ((X[:, 0] > 0).astype(int) + (X[:, 1] > 0).astype(int)) \
        .astype(float)
    return X, y


def _hero_data():
    """tests/test_parallel.py's non-degenerate vote at two shards: each
    shard's rows have a hero feature strong only there, f0 moderately
    predictive everywhere (the global best)."""
    rng = np.random.RandomState(0)
    n_shard, shards, heroes = 300, 2, 2
    N = n_shard * shards
    X = rng.randn(N, 1 + heroes)
    y = np.zeros(N)
    for s in range(shards):
        rows = slice(s * n_shard, (s + 1) * n_shard)
        hero = 1 + s % heroes
        y[rows] = (0.9 * X[rows, 0] + 1.3 * X[rows, hero]
                   + 0.3 * rng.randn(n_shard) > 0)
    return X, y


DATA = {
    "bin7": lambda: make_binary_problem(1000, f=7),
    "reg5": lambda: make_regression_problem(900, f=5),
    "bin1003": lambda: make_binary_problem(1003, f=5),
    "bin11": lambda: make_binary_problem(900, f=11),
    "bag6": lambda: make_binary_problem(1000, f=6),
    "mc": _mc_data,
    "vote8": lambda: make_binary_problem(1200, f=8),
    "hero": _hero_data,
}
MC = {"objective": "multiclass", "num_class": 3, "leafwise_wave_size": 1,
      "min_gain_to_split": 1e-3}
# name -> (data, params, iterations); each also trained serially
RUNS = {
    "data_rs": ("bin7", {"tree_learner": "data"}, 5),
    "data_ar": ("bin7", {"tree_learner": "data",
                         "data_parallel_collective": "allreduce"}, 5),
    "data_shards": ("bin7", {"tree_learner": "data", "num_shards": 2}, 5),
    "vote_full": ("bin7", {"tree_learner": "voting", "top_k": 7}, 5),
    "vote_k2": ("bin7", {"tree_learner": "voting", "top_k": 2}, 5),
    "feature": ("bin7", {"tree_learner": "feature"}, 5),
    "feature_lvl": ("bin7", {"tree_learner": "feature",
                             "tree_growth": "levelwise"}, 5),
    "data_lvl": ("bin7", {"tree_learner": "data",
                          "tree_growth": "levelwise"}, 3),
    "data_seq": ("bin7", {"tree_learner": "data", "num_leaves": 5}, 3),
    "vote_seq": ("bin7", {"tree_learner": "voting", "top_k": 7,
                          "num_leaves": 5}, 3),
    "data_goss": ("bin7", {"tree_learner": "data", "boosting": "goss"}, 3),
    "reg_data": ("reg5", {"objective": "regression",
                          "tree_learner": "data"}, 5),
    "reg_feature": ("reg5", {"objective": "regression",
                             "tree_learner": "feature"}, 5),
    "reg_l1": ("reg5", {"objective": "regression_l1",
                        "tree_learner": "data"}, 3),
    "rows1003": ("bin1003", {"tree_learner": "data"}, 3),
    "f11": ("bin11", {"tree_learner": "data"}, 3),
    "bag": ("bag6", {"tree_learner": "data", "bagging_fraction": 0.7,
                     "bagging_freq": 1}, 4),
    "mc": ("mc", dict(MC, tree_learner="data"), 3),
    "vote_small": ("vote8", {"tree_learner": "voting", "top_k": 2,
                             "num_leaves": 15}, 5),
    "hero_data": ("hero", {"tree_learner": "data", "num_leaves": 7}, 1),
    "hero_vote": ("hero", {"tree_learner": "voting", "top_k": 1,
                           "num_leaves": 7}, 1),
}
_PARALLEL_KNOBS = ("tree_learner", "top_k", "data_parallel_collective",
                   "num_shards")


def _data_file(tmp, name, weighted=False):
    X, y = DATA[name]()
    path = str(tmp / f"{name}.npz")
    kw = {"w": np.where(y > 0, 2.0, 1.0)} if weighted else {}
    np.savez(path, X=X, y=y, **kw)
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of two gloo ranks training every run of ``RUNS``."""
    tmp = tmp_path_factory.mktemp("ranks")
    files = {n: _data_file(tmp, n, weighted=(n == "bag6")) for n in DATA}
    runs = [{"name": n, "data": files[d], "params": dict(BASE, **p),
             "iters": it} for n, (d, p, it) in RUNS.items()]
    res = run_ranks({"mode": "train", "runs": runs}, tmp, world=2)
    out = {"_group": [(r["rank"], r["world"], r["backend"]) for r in res]}
    for n in RUNS:
        texts = [open(r["runs"][n]["text"]).read() for r in res]
        out[n] = dict(texts=texts,
                      scores=np.load(str(tmp / f"{n}.scores.npy")),
                      info=[r["runs"][n] for r in res])
    return out


@pytest.fixture(scope="module")
def serial():
    """The port's serial learner on each run's rows, in process."""
    cache = {}

    def get(name):
        if name not in cache:
            d, p, it = RUNS[name]
            X, y = DATA[d]()
            w = np.where(y > 0, 2.0, 1.0) if d == "bag6" else None
            params = {k: v for k, v in dict(BASE, **p).items()
                      if k not in _PARALLEL_KNOBS}
            cache[name] = train(params, Dataset(X, label=y, weight=w), it,
                                device="cpu")
        return cache[name]
    return get


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX learners at num_shards=2 on bin7, one training each."""
    from lightgbmv1_tpu.config import Config
    from lightgbmv1_tpu.io.dataset import BinnedDataset
    from lightgbmv1_tpu.models.gbdt import create_boosting

    X, y = DATA["bin7"]()
    out = {}
    for name, extra in (("data", {"tree_learner": "data"}),
                        ("voting", {"tree_learner": "voting", "top_k": 2}),
                        ("feature", {"tree_learner": "feature"})):
        cfg = Config.from_dict(dict(BASE, num_shards=2, **extra))
        g = create_boosting(cfg, BinnedDataset.from_numpy(X, label=y,
                                                          config=cfg))
        for _ in range(5):
            g.train_one_iter(check_stop=False)
        out[name] = ([(t.num_leaves, tuple(t.split_feature),
                       tuple(t.threshold), tuple(np.asarray(t.leaf_value)))
                      for t in g.materialize_host_trees()],
                     g.raw_train_scores())
    return out


def _sig(text):
    return [(t.num_leaves, tuple(t.split_feature), tuple(t.threshold),
             tuple(np.asarray(t.leaf_value)))
            for t in model_from_string(text).trees]


def _same_trees(a, b, rtol=1e-3, atol=1e-5):
    assert len(a) == len(b)
    for s, p in zip(a, b):
        assert s[:3] == p[:3]
        np.testing.assert_allclose(s[3], p[3], rtol=rtol, atol=atol)


def _vs_serial(ranks, serial, name, rtol=1e-3, atol=1e-5, structure=True):
    r = ranks[name]
    ser = serial(name)
    if structure:
        _same_trees(_sig(ser.model_to_string()), _sig(r["texts"][0]),
                    rtol, atol)
    np.testing.assert_allclose(ser._gbdt.raw_train_scores(), r["scores"],
                               rtol=rtol, atol=atol)


def test_two_gloo_ranks_present(ranks):
    """The spawn's ranks are a group of two over gloo (the CPU's
    backend, collectives.backend_for), and every row-sharded run reduced
    its root sums across them."""
    assert ranks["_group"] == [(0, 2, "gloo"), (1, 2, "gloo")]
    for name, (_, p, _) in RUNS.items():
        calls = ranks[name]["info"][0]["counts"]["all_reduce"]["calls"]
        assert (calls > 0) == (p["tree_learner"] != "feature"), name


@pytest.mark.parametrize("name", sorted(RUNS))
def test_every_rank_writes_the_same_model_text(ranks, name):
    a, b = ranks[name]["texts"]
    assert a == b


@pytest.mark.parametrize("learner", ["data", "feature"])
def test_parallel_matches_serial_binary(ranks, serial, jax_ref, learner):
    name = "data_rs" if learner == "data" else "feature"
    _vs_serial(ranks, serial, name)
    sig, scores = jax_ref[learner]
    _same_trees(sig, _sig(ranks[name]["texts"][0]))
    np.testing.assert_allclose(scores, ranks[name]["scores"], rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("learner", ["data", "feature"])
def test_parallel_matches_serial_regression(ranks, serial, learner):
    _vs_serial(ranks, serial, f"reg_{learner}", atol=1e-4)


def test_data_parallel_row_count_not_divisible(ranks, serial):
    """1003 rows over two ranks: 502 and 501."""
    _vs_serial(ranks, serial, "rows1003")


def test_feature_parallel_feature_count_not_divisible(ranks, serial):
    """7 features over two ranks: slices of 4, the second padded with an
    unusable feature."""
    _vs_serial(ranks, serial, "feature")


def test_data_parallel_with_bagging_and_weights(ranks, serial):
    """The bag drawn over the global rows from the shared seed, each rank
    its slice; row weights 2 on the positives."""
    _vs_serial(ranks, serial, "bag", structure=False)


def test_data_parallel_multiclass(ranks, serial):
    _vs_serial(ranks, serial, "mc", rtol=5e-3, atol=1e-4, structure=False)


def test_num_shards_subset(ranks):
    """num_shards is the group's world size: 2 over two ranks trains the
    default's model; any other value raises with its reason."""
    assert ranks["data_shards"]["texts"][0] == ranks["data_rs"]["texts"][0]
    X, y = make_binary_problem(300, f=5)
    with pytest.raises(ValueError, match="num_shards=4: the parallel "
                       "learners span every rank of the group"):
        train(dict(BASE, tree_learner="data", num_shards=4),
              Dataset(X, label=y), 1, device="cpu")


def test_voting_matches_data_parallel_with_full_top_k(ranks):
    """top_k >= F: every feature elected, the data learner's trees."""
    _same_trees(_sig(ranks["vote_full"]["texts"][0]),
                _sig(ranks["data_rs"]["texts"][0]), 1e-4, 1e-6)
    np.testing.assert_allclose(ranks["vote_full"]["scores"],
                               ranks["data_rs"]["scores"], rtol=1e-4,
                               atol=1e-6)


def test_voting_matches_the_jax_vote(ranks, jax_ref):
    """top_k=2 of 7 (2k = 4 < F): a real election.  The first tree, grown
    on the same gradients, is the JAX learner's split for split.  Past it
    the two packages' f32 gradients differ in their last bits, and a
    rank's local vote has no tie band (``lax.top_k`` in the JAX package,
    its stable order here): features whose local gains tie to a few ulps
    (small leaves, 10-40 rows a rank) may be elected otherwise, so the
    later trees are held to the model's accuracy, not split for split."""
    sig, _ = jax_ref["voting"]
    port = _sig(ranks["vote_k2"]["texts"][0])
    _same_trees(sig[:1], port[:1])
    X, y = DATA["bin7"]()
    acc = [((s[:, 0] > 0) == (y > 0.5)).mean()
           for s in (jax_ref["voting"][1], ranks["vote_k2"]["scores"])]
    assert abs(acc[0] - acc[1]) < 0.01, acc


def test_voting_small_top_k_still_learns(ranks):
    X, y = DATA["vote8"]()
    acc = ((ranks["vote_small"]["scores"][:, 0] > 0) == (y > 0.5)).mean()
    assert acc > 0.8


def test_voting_selection_non_degenerate(ranks):
    """Each rank votes its hero; f0, the global best, gets no vote, so the
    voting learner's root is a hero where the data learner's is f0."""
    root = {n: model_from_string(ranks[n]["texts"][0]).trees[0]
            .split_feature[0] for n in ("hero_data", "hero_vote")}
    assert root["hero_data"] == 0, "construction broken: f0 must win"
    assert root["hero_vote"] in (1, 2)


def test_feature_parallel_levelwise_matches_serial(ranks, serial):
    _vs_serial(ranks, serial, "feature_lvl")


def test_voting_levelwise_raises_the_jax_reason():
    X, y = make_binary_problem(300, f=5)
    with pytest.raises(NotImplementedError,
                       match="tree_learner=voting requires the leaf-wise"):
        train(dict(BASE, tree_learner="voting", tree_growth="levelwise"),
              Dataset(X, label=y), 1, device="cpu")


def test_collective_knob_validated():
    with pytest.raises(ValueError, match="data_parallel_collective"):
        tconfig.Config.from_dict({"objective": "binary",
                                  "data_parallel_collective": "ring"})


def test_reduce_scatter_vs_allreduce_vs_serial_bit_identical(ranks, serial,
                                                            jax_ref):
    """Three sum orders, one structure (the tie band of the scan and of
    the election)."""
    s_sig = _sig(serial("data_rs").model_to_string())
    for n in ("data_rs", "data_ar"):
        _same_trees(s_sig, _sig(ranks[n]["texts"][0]))
        _same_trees(jax_ref["data"][0], _sig(ranks[n]["texts"][0]))


def test_reduce_scatter_feature_count_not_divisible(ranks, serial):
    """11 features: the histogram's feature axis padded to 12 for the
    reduce-scatter, the second rank's last column padding only."""
    _vs_serial(ranks, serial, "f11")


def test_reduce_scatter_levelwise_matches_serial(ranks, serial):
    _vs_serial(ranks, serial, "data_lvl")


@pytest.mark.parametrize("name", ["data_seq", "vote_seq"])
def test_sequential_grower_matches_serial(ranks, serial, name):
    """num_leaves=5 (a wave of 1): the sequential grower, its passes
    masked on a row shard."""
    _vs_serial(ranks, serial, name)


@pytest.mark.parametrize("name", ["data_goss", "reg_l1"])
def test_goss_and_renewed_leaves_match_serial(ranks, serial, name):
    """GOSS's threshold over the gathered |g h| and its draw over the
    global rows; L1's leaves renewed over every rank's residuals."""
    _vs_serial(ranks, serial, name, atol=1e-4)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_collective_payloads_follow_the_table(ranks, name):
    """Each collective call moves the analytic table's bytes at its
    width: a histogram reduction of k slots (or, voting, of 2k children)
    its hist_bytes, a SplitInfo election of 2k children its
    split_sync_bytes, a vote its vote_bytes, a root sum g3_bytes."""
    d, p, _ = RUNS[name]
    learner = p["tree_learner"]
    coll = p.get("data_parallel_collective", "reduce_scatter")
    X, y = DATA[d]()
    kw = dict(F=X.shape[1], ndev=2,
              B=Dataset(X, label=y).construct()._binned.padded_bin)
    if learner == "voting":
        kw["sel_k"] = min(2 * max(1, min(p["top_k"], kw["F"])), kw["F"])
    checked = 0
    for op, part, shape, nbytes in ranks[name]["info"][0]["calls"]:
        if part == "hist":
            lead = shape[0] if len(shape) == 4 else 1
            k = lead / 2 if learner == "voting" else lead
            key = "hist_bytes"
        elif part in ("split_sync", "vote"):
            k, key = shape[0] / 2, part + "_bytes"
        elif part == "g3":
            k, key = 1, "g3_bytes_per_tree"
        else:
            continue
        want = comm_table_per_round(learner, coll, k=k, **kw)[key]
        assert nbytes == want, (op, part, shape)
        checked += 1
    assert checked > 0


def test_three_ranks(tmp_path, serial):
    """Three ranks once: 1003 rows and 5 features, neither divisible."""
    path = _data_file(tmp_path, "bin1003")
    runs = [{"name": n, "data": path, "params": dict(BASE, **p),
             "iters": 3}
            for n, p in (("rows1003", {"tree_learner": "data"}),
                         ("feature3", {"tree_learner": "feature"}),
                         ("vote3", {"tree_learner": "voting",
                                    "top_k": 2}))]
    res = run_ranks({"mode": "train", "runs": runs}, tmp_path, world=3)
    for n in ("rows1003", "feature3", "vote3"):
        texts = {open(r["runs"][n]["text"]).read() for r in res}
        assert len(texts) == 1, n
    ser = serial("rows1003")
    for n in ("rows1003", "feature3"):
        np.testing.assert_allclose(
            ser._gbdt.raw_train_scores(),
            np.load(str(tmp_path / f"{n}.scores.npy")), rtol=1e-3,
            atol=1e-5)
        _same_trees(_sig(ser.model_to_string()),
                    _sig(open(res[0]["runs"][n]["text"]).read()))


# ---------------------------------------------------------------------------
# what the slice refuses (ROADMAP queue 1 item 14.2b), and the JAX
# package's fallbacks, which raise with its reason
# ---------------------------------------------------------------------------

_LEGS = "ROADMAP queue 1, " + tconfig.PARALLEL_LEGS


def _raises(params, match, exc=NotImplementedError):
    X, y = make_binary_problem(300, f=5)
    with pytest.raises(exc, match=match):
        train(dict(BASE, **params), Dataset(X, label=y), 1, device="cpu")


@pytest.mark.parametrize("learner", ["data", "voting", "feature"])
def test_int8sr_reduce_scatter_round_trains(learner):
    """int8sr under a parallel learner needs the global-scale pmax and the
    integer-domain reduce: item 14.2b."""
    _raises({"tree_learner": learner, "hist_dtype_deep": "int8sr"},
            re.escape(_LEGS))


@pytest.mark.parametrize("knob", [{"hist_dtype": "int8"},
                                  {"hist_dtype_deep": "int8"},
                                  {"hist_dtype_deep": "int8sr"}])
def test_int8sr_collective_moves_int32(knob):
    _raises(dict(knob, tree_learner="data"), re.escape(_LEGS))


def test_int8sr_voting_selective_reduce_integer_domain():
    _raises({"tree_learner": "voting", "top_k": 8,
             "hist_dtype_deep": "int8sr"}, re.escape(_LEGS))


@pytest.mark.parametrize("params", [
    {"num_hosts": 2}, {"hier_ici_gbps": 50.0}, {"hier_dcn_gbps": 5.0},
    {"data_parallel_collective": "hierarchical"}])
def test_hier_mesh_shapes_and_validation(params):
    _raises(dict(params, tree_learner="data"), re.escape(_LEGS))


@pytest.mark.parametrize("shards,hosts", [(4, 2), (8, 2)])
def test_hierarchical_vs_flat_vs_serial_bit_identical(shards, hosts):
    _raises({"tree_learner": "data", "num_shards": shards,
             "num_hosts": hosts,
             "data_parallel_collective": "hierarchical"}, re.escape(_LEGS))


def test_hierarchical_feature_count_not_divisible():
    _raises({"tree_learner": "data", "num_hosts": 2,
             "data_parallel_collective": "hierarchical"}, re.escape(_LEGS))


def test_hierarchical_voting_matches_flat_voting():
    _raises({"tree_learner": "voting", "top_k": 3, "num_hosts": 2,
             "data_parallel_collective": "hierarchical"}, re.escape(_LEGS))


def test_hierarchical_int8sr_collective_moves_int32():
    _raises({"tree_learner": "data", "hist_dtype_deep": "int8sr",
             "data_parallel_collective": "hierarchical", "num_hosts": 2},
            re.escape(_LEGS))


@pytest.mark.parametrize("params,match", [
    ({"tree_learner": "data", "hist_method": "fused"},
     "tree_learner=data reduces histograms across row shards"),
    ({"tree_learner": "voting", "hist_method": "fused"},
     "tree_learner=voting reduces histograms across row shards"),
    ({"tree_learner": "feature", "hist_method": "fused"},
     re.escape(_LEGS)),
    ({"tree_learner": "voting", "tree_growth": "levelwise"},
     "tree_learner=voting requires the leaf-wise grower"),
    ({"tree_learner": "data", "cegb_penalty_feature_lazy": [1.0] * 5},
     "lazy feature costs are ignored for tree_learner=data"),
], ids=["fused-data", "fused-voting", "fused-feature", "voting-levelwise",
        "cegb-lazy"])
def test_jax_fallbacks_raise_the_jax_reason(params, match):
    _raises(params, match)


@pytest.mark.parametrize("learner", ["voting", "feature", "data"])
def test_forced_splits_raise_the_jax_reason(learner, tmp_path):
    forced = tmp_path / "forced.json"
    forced.write_text('{"feature": 0, "threshold": 0.0}')
    match = (f"forcedsplits_filename is not supported with "
             f"tree_learner={learner}" if learner != "data"
             else "forcedsplits_filename requires full histograms")
    _raises({"tree_learner": learner,
             "forcedsplits_filename": str(forced)}, match)


@pytest.mark.parametrize("knob", [{"elastic_max_restarts": 3},
                                  {"elastic_lease_timeout_s": 1.0}])
def test_elastic_knobs_keep_the_parallel_item(knob):
    _raises(dict(knob, tree_learner="data"),
            re.escape("ROADMAP queue 1, " + tconfig.PARALLEL) + "$")
