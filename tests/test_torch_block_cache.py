"""The port's block cache (data/block_cache.py, data/streaming.py) and
binned ``.bin`` cache against the JAX package's, on the CPU: the
counterparts of tests/test_stream_cache.py.

A cache either package writes is read by the other with equal block
bytes and digests; a corrupt, truncated, torn or wrong-version cache
raises ``BlockCacheError`` (with a ``data.block_cache_error`` event);
packed (v3 ``packed4``) and legacy (v1 / v2) caches; host shards; the
CLI's ``task=save_binary`` followed by a training that detects the cache
and streams it.
"""

import json
import os

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu.data import load_manifest as j_load_manifest
from lightgbmv1_tpu.data import write_block_cache as j_write_block_cache
from lightgbmv1_tpu.data.block_cache import read_block as j_read_block
from lightgbmv1_tpu.data.streaming import \
    StreamingDataset as JStreamingDataset
from lightgbmv1_tpu.io.dataset import BinnedDataset as JBinnedDataset

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.data import (BlockCacheError, is_block_cache,
                                       load_manifest, write_block_cache)
from lightgbmv1_tpu_torch.data.block_cache import (pack4bit, read_block,
                                                   shard_blocks, unpack4bit)
from lightgbmv1_tpu_torch.data.streaming import StreamingDataset
from lightgbmv1_tpu_torch.io.dataset import BinnedDataset
from lightgbmv1_tpu_torch.obs import events
from lightgbmv1_tpu_torch.ops import hist_cuda
from lightgbmv1_tpu_torch.utils import faults
from lightgbmv1_tpu_torch.utils.log import LightGBMError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=300, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[:, 3] = rng.randint(0, 5, n)
    X[rng.rand(n) < 0.1, 1] = np.nan
    return X, (X[:, 0] > 0).astype(float)


def make_binned(n=300, f=6, seed=0):
    """The port's binned set of JAX tests/test_stream_cache.py's data."""
    X, y = _data(n, f, seed)
    return lt.Dataset(X, label=y, params={"verbosity": -1},
                      categorical_feature=[3]).construct()._binned


def make_binned_small(n=300, f=7, seed=0, max_bin=15):
    """A packed4-eligible set: every feature in 4 bits, odd F."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    return lt.Dataset(X, label=(X[:, 0] > 0).astype(float),
                      params={"verbosity": -1, "max_bin": max_bin}
                      ).construct()._binned


def _jax_binned(n=300, f=6, seed=0):
    X, y = _data(n, f, seed)
    return lj.Dataset(X, label=y, params={"verbosity": -1},
                      categorical_feature=[3]).construct()._binned


def _same_blocks(path_a, path_b):
    """Two caches of the same data hold the same blocks: bytes, digests,
    row ranges, each read by both packages."""
    ma, mb = load_manifest(path_a), j_load_manifest(path_b)
    assert [(e["row_begin"], e["rows"], e["sha256"], e["nbytes"])
            for e in ma["blocks"]] == \
        [(e["row_begin"], e["rows"], e["sha256"], e["nbytes"])
         for e in mb["blocks"]]
    for key in ("format_version", "num_rows", "num_features", "dtype",
                "bin_layout", "block_rows"):
        assert ma[key] == mb[key], key
    for i in range(len(ma["blocks"])):
        blk = read_block(path_a, ma, i)
        assert np.array_equal(blk, j_read_block(path_a, j_load_manifest(
            path_a), i))
        assert np.array_equal(blk, read_block(path_b, load_manifest(path_b),
                                              i))


# ---------------------------------------------------------------------------
# the format, across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_rows", [64, 300, 1000, 77])
def test_block_cache_roundtrip_and_edges(tmp_path, block_rows):
    """A ragged tail, one block, a block past N and a ragged split: the
    port's cache and the JAX package's of the same bins hold the same
    blocks, and each package's ``StreamingDataset`` opens both with the
    training set's metadata and bins."""
    ds, jds = make_binned(), _jax_binned()
    assert np.array_equal(ds.binned, jds.binned)
    path, jpath = str(tmp_path / "port"), str(tmp_path / "jax")
    manifest = write_block_cache(ds, path, block_rows=block_rows)
    j_write_block_cache(jds, jpath, block_rows=block_rows)
    assert is_block_cache(path) and is_block_cache(jpath)
    assert manifest["format_version"] == 3
    assert manifest["bin_layout"] == "u8"
    assert manifest["num_rows"] == ds.num_data
    assert len(manifest["blocks"]) == -(-ds.num_data // block_rows)
    _same_blocks(path, jpath)
    for p in (path, jpath):
        sds, jsds = StreamingDataset(p), JStreamingDataset(p)
        assert sds.is_streaming and sds.num_data == ds.num_data
        np.testing.assert_array_equal(sds.num_bins, ds.num_bins)
        np.testing.assert_array_equal(sds.is_categorical, ds.is_categorical)
        np.testing.assert_array_equal(sds.metadata.label, ds.metadata.label)
        assert sds.source.ranges == jsds.source.ranges
        assert sds.source.ranges[-1][1] == ds.num_data
        assert sds.feature_infos() == jsds.feature_infos()
        np.testing.assert_array_equal(sds.materialize().binned, ds.binned)
        np.testing.assert_array_equal(jsds.materialize().binned, ds.binned)


def test_block_cache_corrupt_block_fails_loudly(tmp_path):
    """A flipped byte in a block fails its load with the digest, in a
    cache of either package, and publishes the error event; the intact
    blocks still load."""
    for writer, tag in ((write_block_cache, "port"),
                        (j_write_block_cache, "jax")):
        path = str(tmp_path / tag)
        manifest = writer(make_binned() if tag == "port" else _jax_binned(),
                          path, block_rows=100)
        bp = os.path.join(path, manifest["blocks"][1]["file"])
        raw = bytearray(open(bp, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(bp, "wb").write(bytes(raw))
        sds = StreamingDataset(path)
        seq = events.seq()
        with pytest.raises(BlockCacheError, match="digest mismatch"):
            sds.source.load_block(1)
        assert [e["kind"] for e in events.tail(since_seq=seq)] == \
            ["data.block_cache_error"]
        sds.source.load_block(0)


def test_block_cache_truncated_block_fails_loudly(tmp_path):
    ds = make_binned()
    path = str(tmp_path / "cache")
    manifest = write_block_cache(ds, path, block_rows=100)
    bp = os.path.join(path, manifest["blocks"][0]["file"])
    raw = open(bp, "rb").read()
    open(bp, "wb").write(raw[: len(raw) // 2])
    with pytest.raises(BlockCacheError):
        StreamingDataset(path).source.load_block(0)


def test_block_cache_torn_meta_and_manifest(tmp_path):
    """The ``file_write`` fault seam: a torn meta shard or manifest is
    caught at open, never half-loaded."""
    ds = make_binned()
    path = str(tmp_path / "torn_meta")
    with faults.inject(faults.FaultSpec(kind="file_write", mode="truncate",
                                        at=1, match="block_cache_meta")):
        write_block_cache(ds, path, block_rows=100)
    with pytest.raises(BlockCacheError, match="digest"):
        StreamingDataset(path)
    path2 = str(tmp_path / "torn_manifest")
    with faults.inject(faults.FaultSpec(kind="file_write", mode="truncate",
                                        at=1,
                                        match="block_cache_manifest")):
        write_block_cache(ds, path2, block_rows=100)
    assert not is_block_cache(path2)
    with pytest.raises(BlockCacheError):
        load_manifest(path2)


def test_block_cache_wrong_version_refused(tmp_path):
    ds = make_binned()
    path = str(tmp_path / "cache")
    write_block_cache(ds, path, block_rows=100)
    mp = os.path.join(path, "manifest.json")
    m = json.load(open(mp))
    m["format_version"] = 99
    json.dump(m, open(mp, "w"))
    with pytest.raises(BlockCacheError, match="format_version"):
        StreamingDataset(path)
    with pytest.raises(BlockCacheError, match="not a block cache"):
        lt.Dataset(str(tmp_path)).construct()


def test_block_cache_refuses_bundle_only(tmp_path):
    ds = make_binned()
    ds2 = BinnedDataset(None, ds.bin_mappers, ds.metadata,
                        num_data=ds.num_data)
    with pytest.raises(BlockCacheError, match="dense"):
        write_block_cache(ds2, str(tmp_path / "c"), block_rows=100)


def test_cli_save_binary_then_autodetected_train(tmp_path):
    """``task=save_binary`` writes the cache (``stream_cache_dir``), the
    JAX package opens it, and ``task=train data=<dir>`` detects it and
    trains a ``StreamingGBDT``: its model the one the same streamed
    training writes through the Python API."""
    from lightgbmv1_tpu_torch import cli
    from lightgbmv1_tpu_torch.models.gbdt_stream import StreamingGBDT

    rng = np.random.RandomState(1)
    X = rng.randn(150, 4)
    y = (X[:, 0] > 0).astype(int)
    data = str(tmp_path / "train.tsv")
    np.savetxt(data, np.column_stack([y, X]), delimiter="\t")
    cache_dir = str(tmp_path / "blocks")
    out = cli.run_save_binary(Config.from_dict({
        "data": data, "stream_cache_dir": cache_dir,
        "stream_block_rows": 64, "verbosity": -1, "device_type": "cpu"}))
    assert out == cache_dir and is_block_cache(cache_dir)
    assert JStreamingDataset(cache_dir).num_data == 150
    model = str(tmp_path / "model.txt")
    train = {"objective": "binary", "num_iterations": 2, "num_leaves": 6,
             "min_data_in_leaf": 5, "verbosity": -1}
    booster = cli.run_train(Config.from_dict(dict(
        train, data=cache_dir, output_model=model, device_type="cpu")))
    assert isinstance(booster._gbdt, StreamingGBDT)
    api = lt.train(dict(train), lt.Dataset(cache_dir), 2, device="cpu")
    assert open(model).read() == api.model_to_string()
    # the default output directory, <data>.blocks, through main()
    assert cli.main(["task=save_binary", f"data={data}",
                     "stream_block_rows=100", "verbosity=-1",
                     "device_type=cpu"]) == 0
    assert len(load_manifest(data + ".blocks")["blocks"]) == 2


# ---------------------------------------------------------------------------
# the binned .bin cache
# ---------------------------------------------------------------------------


def test_save_binary_v2_roundtrip(tmp_path):
    """The port's ``.bin`` loads in both packages with the same bins and
    labels, and carries its version and section digests."""
    ds = make_binned()
    p = str(tmp_path / "cache.bin")
    ds.save_binary(p)
    for r in (BinnedDataset.load_binary(p), JBinnedDataset.load_binary(p)):
        assert r.num_data == ds.num_data
        np.testing.assert_array_equal(r.binned, ds.binned)
        np.testing.assert_array_equal(r.metadata.label, ds.metadata.label)
    with open(p, "rb") as fh:
        z = np.load(fh, allow_pickle=False)
        assert int(z["format_version"]) == BinnedDataset.BINARY_FORMAT_VERSION
        assert len(z["digest_keys"]) == len(z["digest_values"]) > 0


@pytest.mark.parametrize("damage", ["corrupt", "truncate", "fault_truncate",
                                    "fault_corrupt"])
def test_save_binary_torn_cache_fails_loudly(tmp_path, damage):
    ds = make_binned()
    p = str(tmp_path / "cache.bin")
    if damage.startswith("fault_"):
        with faults.inject(faults.FaultSpec(kind="file_write",
                                            mode=damage[6:], at=1)):
            ds.save_binary(p)
    else:
        ds.save_binary(p)
        raw = open(p, "rb").read()
        if damage == "corrupt":
            bad = bytearray(raw)
            bad[len(bad) // 2] ^= 0xFF
            open(p, "wb").write(bytes(bad))
        else:
            open(p, "wb").write(raw[: len(raw) // 2])
    with pytest.raises(LightGBMError):
        BinnedDataset.load_binary(p)


def test_save_binary_newer_version_refused(tmp_path):
    import io as _io

    p = str(tmp_path / "future.bin")
    buf = _io.BytesIO()
    np.savez_compressed(
        buf,
        magic=np.frombuffer(BinnedDataset.BINARY_MAGIC.encode(),
                            dtype=np.uint8),
        format_version=np.int64(99))
    open(p, "wb").write(buf.getvalue())
    with pytest.raises(LightGBMError, match="newer"):
        BinnedDataset.load_binary(p)


# ---------------------------------------------------------------------------
# host shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_rows,world", [(77, 4), (64, 3), (100, 2)])
def test_host_shard_partition_reconstructs(tmp_path, block_rows, world):
    """The shards are a contiguous, disjoint, block-aligned partition, the
    JAX package's: their materialized bins and labels concatenate to the
    whole set."""
    from lightgbmv1_tpu.data.block_cache import shard_blocks as j_shard

    ds = make_binned(n=307)
    path = str(tmp_path / "cache")
    manifest = write_block_cache(ds, path, block_rows=block_rows)
    parts, labels, row_end = [], [], 0
    for rank in range(world):
        s = shard_blocks(manifest, rank, world, path)
        assert s == j_shard(manifest, rank, world, path)
        assert s["row_begin"] == row_end
        row_end = s["row_end"]
        sds = StreamingDataset(path, shard=(rank, world))
        assert sds.shard_row_range == (s["row_begin"], s["row_end"])
        assert sds.num_data == s["row_end"] - s["row_begin"]
        parts.append(sds.materialize().binned)
        labels.append(sds.metadata.label)
    assert row_end == ds.num_data
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), ds.binned)
    np.testing.assert_array_equal(np.concatenate(labels), ds.metadata.label)


def test_host_shard_ragged_tail_and_empty_shard(tmp_path):
    ds = make_binned(n=250)
    path = str(tmp_path / "cache")
    manifest = write_block_cache(ds, path, block_rows=100)   # 3 blocks
    world, sizes = 5, []
    for rank in range(world):
        s = shard_blocks(manifest, rank, world, path)
        sds = StreamingDataset(path, shard=(rank, world))
        assert sds.num_data == s["row_end"] - s["row_begin"]
        sizes.append(sds.num_data)
    assert sum(sizes) == ds.num_data
    assert 0 in sizes and 50 in sizes
    with pytest.raises(BlockCacheError, match="out of range"):
        shard_blocks(manifest, world, world, path)


@pytest.mark.parametrize("damage", ["overlap", "gap", "short"])
def test_host_shard_manifest_overlap_gap_fail_loudly(tmp_path, damage):
    ds = make_binned(n=300)
    path = str(tmp_path / "cache")
    write_block_cache(ds, path, block_rows=100)
    m = json.load(open(os.path.join(path, "manifest.json")))
    if damage == "overlap":
        m["blocks"][1]["row_begin"] = 50
        needle = "OVERLAPS"
    elif damage == "gap":
        m["blocks"][1]["row_begin"] = 150
        needle = "GAP"
    else:
        m["blocks"] = m["blocks"][:2]
        needle = "covers"
    with pytest.raises(BlockCacheError, match=needle):
        shard_blocks(m, 0, 2, path)


def test_host_shard_ranking_data_refused(tmp_path):
    rng = np.random.RandomState(3)
    X = rng.randn(200, 4)
    y = rng.randint(0, 3, 200).astype(float)
    ds = lt.Dataset(X, label=y, group=[50, 50, 100],
                    params={"verbosity": -1}).construct()._binned
    path = str(tmp_path / "cache")
    write_block_cache(ds, path, block_rows=64)
    assert list(StreamingDataset(path).metadata.group) == [50, 50, 100]
    with pytest.raises(BlockCacheError, match="ranking"):
        StreamingDataset(path, shard=(0, 2))


# ---------------------------------------------------------------------------
# 4-bit packed shards (format v3) and legacy caches
# ---------------------------------------------------------------------------


def test_block_cache_packed_roundtrip(tmp_path):
    """``packed4`` shards hold (ceil(F/2), rows) bytes, bit for bit
    ``hist_cuda.pack4bit`` of the block and the JAX package's shards;
    blocks stay packed and densify to the (F, N) bins."""
    from lightgbmv1_tpu.ops.hist_pallas import pack4bit as j_pack4bit

    ds = make_binned_small()
    assert ds.num_total_bin <= 16
    path = str(tmp_path / "cache")
    manifest = write_block_cache(ds, path, block_rows=77,
                                 bin_layout="packed4")
    assert manifest["format_version"] == 3
    assert manifest["bin_layout"] == "packed4"
    fr = -(-ds.num_features // 2)
    for e in manifest["blocks"]:
        assert e["nbytes"] == fr * e["rows"]
    packed = pack4bit(ds.binned)
    np.testing.assert_array_equal(
        packed, hist_cuda.pack4bit(torch.as_tensor(ds.binned)).numpy())
    np.testing.assert_array_equal(packed, np.asarray(j_pack4bit(ds.binned)))
    np.testing.assert_array_equal(unpack4bit(packed, ds.num_features),
                                  ds.binned)
    jpath = str(tmp_path / "jax")
    j_write_block_cache(ds, jpath, block_rows=77, bin_layout="packed4")
    _same_blocks(path, jpath)
    sds = StreamingDataset(path)
    assert sds.source.bin_layout == "packed4"
    a, b, blk = next(iter(sds.iter_blocks()))
    assert blk.shape == (fr, b - a)
    np.testing.assert_array_equal(sds.materialize().binned, ds.binned)


def test_block_cache_packed_auto_and_ineligible(tmp_path):
    m = write_block_cache(make_binned_small(), str(tmp_path / "a"),
                          block_rows=100)
    assert m["bin_layout"] == "packed4"
    wide = make_binned()
    m2 = write_block_cache(wide, str(tmp_path / "b"), block_rows=100)
    assert m2["bin_layout"] == "u8"
    with pytest.raises(BlockCacheError, match="4 bits"):
        write_block_cache(wide, str(tmp_path / "c"), block_rows=100,
                          bin_layout="packed4")


def test_block_cache_packed_digest_corruption(tmp_path):
    ds = make_binned_small()
    path = str(tmp_path / "cache")
    manifest = write_block_cache(ds, path, block_rows=100,
                                 bin_layout="packed4")
    bp = os.path.join(path, manifest["blocks"][1]["file"])
    raw = bytearray(open(bp, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(bp, "wb").write(bytes(raw))
    sds = StreamingDataset(path)
    with pytest.raises(BlockCacheError, match="digest mismatch"):
        sds.source.load_block(1)
    sds.source.load_block(0)


def test_block_cache_legacy_version_warns_and_loads(tmp_path):
    """A v2 (and v1) cache, without ``bin_layout``, loads as u8 shards
    with a one-line warning."""
    from lightgbmv1_tpu_torch.utils import log

    ds = make_binned_small()
    path = str(tmp_path / "cache")
    write_block_cache(ds, path, block_rows=100, bin_layout="u8")
    mp = os.path.join(path, "manifest.json")
    for version in (2, 1):
        m = json.load(open(mp))
        m["format_version"] = version
        m.pop("bin_layout", None)
        json.dump(m, open(mp, "w"))
        lines = []
        old = log._level
        log.set_verbosity(0)
        log.register_callback(lines.append)
        try:
            sds = StreamingDataset(path)
        finally:
            log.register_callback(None)
            log.set_verbosity(old)
        assert any(f"legacy block-cache format_version {version}" in ln
                   for ln in lines), lines
        assert sds.source.bin_layout == "u8"
        np.testing.assert_array_equal(sds.materialize().binned, ds.binned)


def test_host_shard_packed_partition_reconstructs(tmp_path):
    ds = make_binned_small(n=307)
    path = str(tmp_path / "cache")
    write_block_cache(ds, path, block_rows=77, bin_layout="packed4")
    world, parts, row_end = 3, [], 0
    for rank in range(world):
        sds = StreamingDataset(path, shard=(rank, world))
        assert sds.source.bin_layout == "packed4"
        assert sds.shard_row_range[0] == row_end
        row_end = sds.shard_row_range[1]
        parts.append(sds.materialize().binned)
    assert row_end == ds.num_data
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), ds.binned)
