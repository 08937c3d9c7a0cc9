"""The port's distributed loader and bin finding over gloo ranks on the
CPU (parallel/dist_data.py, io/parser.shard_rows), a counterpart of each
test of tests/test_dist_data.py and more: the bins two ranks agree on are
the JAX ``find_bins_distributed``'s on their samples joined, ``shard_rows``
is the JAX package's, a pre-partitioned file is a rank's, the padding rows
of a process-sharded set weigh nothing, and a block cache either package
wrote loads a rank's block run."""

import numpy as np
import pytest

from torch_ranks import run_ranks

from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.parser import load_data_file, shard_rows
from lightgbmv1_tpu_torch.parallel.dist_data import (find_bins_distributed,
                                                     make_process_sharded)
from lightgbmv1_tpu_torch.utils.log import LightGBMError

PARAMS = {"objective": "binary", "verbosity": -1, "max_bin": 16,
          "bin_construct_sample_cnt": 2000}


def _write(path, X, y, w=None):
    cols = [y] + ([w] if w is not None else []) + [X]
    np.savetxt(path, np.column_stack(cols), fmt="%.7g", delimiter="\t")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.RandomState(0)
    X = rng.randn(3001, 4)
    X[rng.rand(3001) < 0.05, 2] = np.nan
    y = (X[:, 0] > 0).astype(float)
    w = rng.uniform(0.5, 2.0, 3001)
    _write(tmp / "train.tsv", X, y, w)
    for r, (lo, hi) in enumerate(((0, 1700), (1700, 3001))):
        _write(tmp / f"part{r}.tsv", X[lo:hi], y[lo:hi], w[lo:hi])
    return tmp, X, y, w


@pytest.fixture(scope="module")
def loads(files):
    """One spawn of two ranks loading the file by shards (weights in
    column 1), the pre-partitioned parts, the whole file under
    tree_learner=feature, and the block caches each package wrote."""
    tmp, X, y, w = files
    from lightgbmv1_tpu.data import write_block_cache as j_write
    from lightgbmv1_tpu.io.dataset import BinnedDataset as JBinned

    from lightgbmv1_tpu_torch.data import write_block_cache
    from lightgbmv1_tpu_torch.io.dataset import BinnedDataset

    cfg = Config.from_dict(PARAMS)
    write_block_cache(BinnedDataset.from_numpy(X, label=y, config=cfg),
                      str(tmp / "cache_t"), block_rows=256)
    from lightgbmv1_tpu.config import Config as JConfig

    j_write(JBinned.from_numpy(X, label=y, config=JConfig.from_dict(PARAMS)),
            str(tmp / "cache_j"), block_rows=256)
    pw = dict(PARAMS, weight_column="1", tree_learner="data")
    jobs = [
        {"name": "sharded", "path": str(tmp / "train.tsv"), "params": pw},
        {"name": "pre", "path": str(tmp / "part{rank}.tsv"),
         "params": dict(pw, pre_partition=True)},
        {"name": "feature", "path": str(tmp / "train.tsv"),
         "params": dict(pw, tree_learner="feature")},
        {"name": "cache_t", "path": str(tmp / "cache_t"),
         "params": dict(PARAMS, tree_learner="data")},
        {"name": "cache_j", "path": str(tmp / "cache_j"),
         "params": dict(PARAMS, tree_learner="data")},
    ]
    res = run_ranks({"mode": "load", "loads": jobs}, tmp, world=2)
    return [r["loads"] for r in res]


def test_shard_rows_cover_and_disjoint():
    for n, w in [(100, 4), (101, 4), (7, 8), (1000, 3)]:
        seen = []
        for r in range(w):
            lo, hi = shard_rows(n, r, w)
            assert 0 <= lo <= hi <= n
            seen.extend(range(lo, hi))
        assert seen == list(range(n))


@pytest.mark.parametrize("n,w", [(100, 4), (101, 4), (7, 8), (1000, 3),
                                 (3001, 2), (0, 2)])
def test_shard_rows_is_the_jax_packages(n, w):
    from lightgbmv1_tpu.io.parser import shard_rows as j_shard_rows

    assert [shard_rows(n, r, w) for r in range(w)] == \
        [j_shard_rows(n, r, w) for r in range(w)]


def test_distributed_bins_agree_across_processes(files, loads):
    """Each rank holds half the rows but the same bin boundaries."""
    _, X, _, _ = files
    a, b = loads[0]["sharded"], loads[1]["sharded"]
    rows = [sum(L["row_valid"][:L["local_rows"]]) if r == 0 else
            sum(L["row_valid"][L["local_rows"]:])
            for r, L in enumerate((a, b))]
    assert sum(rows) == len(X) and abs(rows[0] - rows[1]) <= 1
    assert a["bounds"] == b["bounds"]


def test_bins_equal_the_jax_find_bins_on_the_joined_samples(tmp_path):
    """Two ranks' ``find_bins_distributed`` on the halves of a sample are
    the JAX function's, called in process (one process: no gather) on
    the two halves joined in rank order."""
    from lightgbmv1_tpu.config import Config as JConfig
    from lightgbmv1_tpu.parallel.dist_data import \
        find_bins_distributed as j_find

    rng = np.random.RandomState(3)
    S = rng.randn(3, 900)
    S[1, rng.rand(900) < 0.1] = np.nan
    S[2] = np.round(S[2] * 3)                   # repeated values
    np.savez(tmp_path / "s.npz", S=S)
    res = run_ranks({"mode": "bins", "data": str(tmp_path / "s.npz"),
                     "params": PARAMS}, tmp_path, world=2)
    assert res[0]["bounds"] == res[1]["bounds"]
    halves = np.array_split(np.arange(900), 2)
    joined = [np.concatenate([S[j, h][~np.isnan(S[j, h])] for h in halves]
                             + [np.full(int(np.isnan(S[j]).sum()), np.nan)])
              for j in range(3)]
    jm = j_find(joined, 900, [16] * 3, set(), JConfig.from_dict(PARAMS),
                num_data=900)
    assert [list(np.asarray(m.bin_upper_bound)) for m in jm] == \
        res[0]["bounds"]
    assert [int(m.num_bin) for m in jm] == res[0]["num_bin"]


def test_find_bins_on_one_rank_is_the_plain_finder():
    rng = np.random.RandomState(1)
    S = [rng.randn(500) for _ in range(3)]
    cfg = Config.from_dict(PARAMS)
    from lightgbmv1_tpu_torch.io.dataset import _find_mappers

    a = find_bins_distributed(S, 500, [16] * 3, set(), cfg, num_data=500)
    b = _find_mappers(S, 500, 500, cfg)
    assert [list(m.bin_upper_bound) for m in a] == \
        [list(m.bin_upper_bound) for m in b]


def test_padding_rows_carry_weight_zero(files, loads):
    """3,001 rows: R = 1,501 a rank, the second rank's last row a pad of
    label 0 and weight 0, outside ``row_valid``; the gathered labels and
    weights are the file's."""
    _, X, y, w = files
    for L in (loads[0]["sharded"], loads[1]["sharded"]):
        assert L["local_rows"] == 1501 and L["num_data"] == 3002
        valid = np.asarray(L["row_valid"])
        assert valid.sum() == 3001 and not valid[-1]
        assert L["weight"][-1] == 0.0 and L["label"][-1] == 0.0
        np.testing.assert_allclose(np.asarray(L["weight"])[valid], w,
                                   rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(L["label"])[valid], y)


def test_pre_partition_loads_each_ranks_own_file(files, loads):
    """pre_partition: a rank's file is its rows (1,700 and 1,301), padded
    to 1,700."""
    _, _, y, _ = files
    a, b = loads[0]["pre"], loads[1]["pre"]
    assert a["local_rows"] == b["local_rows"] == 1700
    assert len(a["binned"][0]) == 1700
    valid = np.asarray(a["row_valid"])
    assert valid.sum() == 3001
    np.testing.assert_array_equal(np.asarray(a["label"])[valid], y)
    assert a["bounds"] == b["bounds"]


def test_feature_learner_loads_every_row(files, loads):
    _, X, _, _ = files
    for L in (loads[0]["feature"], loads[1]["feature"]):
        assert L["num_data"] == len(X) and L["row_valid"] is None
    assert loads[0]["feature"]["binned"] == loads[1]["feature"]["binned"]


@pytest.mark.parametrize("which", ["cache_t", "cache_j"])
def test_block_cache_distributed_loads_a_ranks_blocks(files, loads, which):
    """A cache either package wrote (12 blocks of 256 rows): each rank
    reads its run of 6 blocks; together the cache's rows and labels."""
    _, X, y, _ = files
    a, b = loads[0][which], loads[1][which]
    n0 = int(sum(a["row_valid"][:a["local_rows"]]))
    assert n0 == 6 * 256
    valid = np.asarray(a["row_valid"])
    np.testing.assert_array_equal(np.asarray(a["label"])[valid], y)
    assert a["bounds"] == b["bounds"]
    got = np.concatenate([np.asarray(a["binned"])[:, :n0],
                          np.asarray(b["binned"])[:, :len(X) - n0]], axis=1)
    from lightgbmv1_tpu_torch.data.streaming import StreamingDataset

    np.testing.assert_array_equal(
        got, StreamingDataset(str(files[0] / which)).materialize().binned)


def test_rank_sharded_libsvm_and_query_files_refused(tmp_path):
    svm = tmp_path / "d.svm"
    svm.write_text("1 1:0.5 2:1.0\n0 1:0.1\n")
    with pytest.raises(LightGBMError, match="libsvm"):
        load_data_file(str(svm), rank=0, num_machines=2)
    tsv = tmp_path / "q.tsv"
    np.savetxt(tsv, np.column_stack([[1, 0, 1, 0], [0, 0, 1, 1],
                                     np.arange(4.0)]), delimiter="\t")
    with pytest.raises(LightGBMError, match="query"):
        load_data_file(str(tsv), group_column="1", rank=0, num_machines=2)
    (tmp_path / "q.tsv.query").write_text("2\n2\n")
    with pytest.raises(LightGBMError, match="query"):
        load_data_file(str(tsv), rank=1, num_machines=2)


def test_rank_sharded_parse_is_the_files_rows(files):
    tmp, X, y, w = files
    got = [load_data_file(str(tmp / "train.tsv"), weight_column="1",
                          rank=r, num_machines=3) for r in range(3)]
    np.testing.assert_allclose(np.concatenate([d.X for d in got]), X,
                               rtol=1e-6)
    np.testing.assert_array_equal(np.concatenate([d.label for d in got]), y)


def test_make_process_sharded_on_one_rank_is_the_set(files):
    from lightgbmv1_tpu_torch.io.dataset import BinnedDataset

    _, X, y, _ = files
    ds = BinnedDataset.from_numpy(X[:100], label=y[:100],
                                  config=Config.from_dict(PARAMS))
    assert make_process_sharded(ds, Config.from_dict(PARAMS)) is ds
