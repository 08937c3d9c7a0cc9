"""Distributed loading and bin finding for the parallel learners.

Port of lightgbmv1_tpu/parallel/dist_data.py over ``torch.distributed``
(the reference's ``DatasetLoader::LoadFromFile(filename, rank,
num_machines)``, src/io/dataset_loader.cpp:167, and its distributed
bin-mapper construction, :913-996):

* ``find_bins_distributed`` (:43): each rank's bin-construction sample is
  gathered with ``all_gather_object`` (each feature's values in rank
  order, its missing values appended), and every rank runs the same
  GreedyFindBin on the whole sample, so the mappers agree byte for byte
  without being exchanged;
* ``make_process_sharded`` (:112): a rank's shard padded to the ranks'
  common row count R with weight-0 rows, the labels, weights and init
  scores gathered to the (world R)-row global layout, ``row_valid``
  marking the real rows; the bins stay local.  The trainer
  (``models/gbdt.RowShard``) trains each rank on its real rows.  Query
  data keeps the host-replicated layout (JAX :128-133);
* ``load_block_cache_distributed`` (:184): each rank opens its block run
  of a block cache (``data/streaming.StreamingDataset(path, shard=(rank,
  world))``), its mappers the cache's;
* ``load_distributed`` (:214): this rank's shard of a data file
  (``io/parser.load_data_file(rank=, num_machines=)``; the whole file
  under ``pre_partition``, whose file is the rank's already) binned with
  the agreed mappers, each rank sampling ``bin_construct_sample_cnt /
  world`` rows and EFB off (a bundle layout would need agreeing too), then
  process-sharded for the row-sharded learners (data, voting).  The
  feature learner holds every row on every rank: each loads the whole
  file, so the mappers agree without a gather.

Use after ``cluster.init_cluster``::

    init_cluster(config)
    ds = load_distributed(path, config)   # this rank's rows, global bins
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..config import Config
from ..io.binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper
from ..io.dataset import BinnedDataset, Metadata
from ..io.parser import load_data_file, shard_rows  # noqa: F401 (re-export)
from ..utils.log import log_info
from .collectives import Group, current_group


def find_bins_distributed(local_samples: List[np.ndarray], sample_cnt: int,
                          max_bins, categorical, config: Config,
                          num_data: int = 0,
                          group: Optional[Group] = None) -> List[BinMapper]:
    """Every rank's mappers from the ranks' joined samples (JAX :43):
    ``local_samples`` this rank's per-feature sample arrays of its
    ``num_data`` rows.  The BinMapper's shape is the JAX package's call."""
    g = group if group is not None else current_group()
    if g.world > 1:
        mine = ([s[~np.isnan(s)] for s in local_samples],
                [int(np.isnan(s).sum()) for s in local_samples],
                int(sample_cnt), int(num_data))
        got = g.all_gather_object(mine, part="bin_sample")
        samples = []
        for j in range(len(local_samples)):
            vals = np.concatenate([r[0][j] for r in got])
            na = sum(r[1][j] for r in got)
            samples.append(np.concatenate([vals, np.full(na, np.nan)]))
        total_cnt = sum(r[2] for r in got)
        total_rows = sum(r[3] for r in got)
    else:
        samples, total_cnt, total_rows = local_samples, sample_cnt, num_data

    from ..io.binning import get_forced_bins

    forced = get_forced_bins(config.forcedbins_filename, len(samples),
                             categorical)
    return [
        BinMapper.find_bin(
            np.asarray(samples[j], np.float64),
            total_sample_cnt=total_cnt, max_bin=max_bins[j],
            min_data_in_bin=config.min_data_in_bin,
            bin_type=BIN_CATEGORICAL if j in categorical else BIN_NUMERICAL,
            use_missing=config.use_missing,
            zero_as_missing=config.zero_as_missing,
            forced_bounds=forced[j], pre_filter=config.feature_pre_filter,
            filter_cnt=int(config.min_data_in_leaf * total_cnt
                           / max(total_rows, total_cnt, 1)))
        for j in range(len(samples))]


def make_process_sharded(ds: BinnedDataset, config: Config,
                         group: Optional[Group] = None) -> BinnedDataset:
    """This rank's shard ``ds`` as the process-sharded set (JAX :112):
    its bins padded to the ranks' common row count R, the labels, weights
    and init scores of every rank gathered into the (world R)-row layout
    (a pad row: label 0, weight 0, init score 0), ``row_valid`` its real
    rows, ``num_data`` world R, ``local_rows`` R.  One rank, a set already
    sharded, and query data (host-replicated, JAX :128-133) come back as
    they are."""
    g = group if group is not None else current_group()
    if g.world <= 1 or getattr(ds, "is_row_sharded", False):
        return ds
    if ds.metadata.group is not None:
        log_info("process-sharded training with query data keeps the "
                 "host-replicated layout (query-aligned sharding is not "
                 "yet wired); memory scaling applies to non-ranking tasks")
        return ds
    world, n_local = g.world, ds.num_data
    R = max(g.all_gather_object(n_local, part="rows"))
    F = ds.binned.shape[0]
    binned_local = np.zeros((F, R), dtype=ds.binned.dtype)
    binned_local[:, :n_local] = ds.binned

    def gather_field(x, cols=1):
        """An (n_local,) or (n_local, cols) field in the (world R, ...)
        padded global layout, pad rows 0."""
        loc = np.zeros((R, cols), np.float64)
        if x is not None:
            loc[:n_local] = np.asarray(x, np.float64).reshape(n_local, cols)
        allg = np.concatenate(g.all_gather_object(loc, part="rows"))
        return allg[:, 0] if cols == 1 else allg

    meta = ds.metadata
    g_label = gather_field(meta.label)
    w_local = (np.asarray(meta.weight, np.float64).ravel()
               if meta.weight is not None else np.ones(n_local))
    g_weight = gather_field(w_local)
    g_init = None
    if meta.init_score is not None:
        k = np.asarray(meta.init_score).size // max(n_local, 1)
        g_init = gather_field(meta.init_score, cols=max(k, 1))
    g_valid = gather_field(np.ones(n_local)) > 0.5
    out = BinnedDataset(binned_local, ds.bin_mappers,
                        Metadata(label=g_label.astype(np.float32),
                                 weight=g_weight.astype(np.float32),
                                 init_score=g_init),
                        ds.feature_names, max_bin=ds.max_bin)
    out.num_data = R * world
    out.is_row_sharded = True
    out.local_rows = R
    out.row_valid = g_valid
    log_info(f"Process-sharded dataset: {R} local rows/process x {world} "
             f"processes = {R * world} global (binned matrix stays local)")
    return out


def _shards_rows(config: Config) -> bool:
    return config.tree_learner in ("data", "voting")


def load_block_cache_distributed(path: str, config: Config,
                                 shard_to_trainer: bool = True,
                                 group: Optional[Group] = None
                                 ) -> BinnedDataset:
    """This rank's block run of the block cache at ``path`` (JAX :184),
    made resident (its rows only), process-sharded for the row-sharded
    learners; the mappers are the cache's, global already.  The feature
    learner's ranks each read every block."""
    from ..data.streaming import StreamingDataset

    g = group if group is not None else current_group()
    rank, world = g.rank, g.world
    by_rank = world > 1 and _shards_rows(config)
    sds = StreamingDataset(path, shard=(rank, world) if by_rank else None)
    local = sds.materialize()
    log_info(f"Process {rank}/{world}: streamed {local.num_data} local "
             f"rows from block cache {path}"
             + (f" (global rows [{sds.shard_row_range[0]}, "
                f"{sds.shard_row_range[1]}))" if by_rank else ""))
    if shard_to_trainer and by_rank:
        local = make_process_sharded(local, config, g)
    return local


def load_distributed(path: str, config: Config, categorical_features=None,
                     shard_to_trainer: bool = True,
                     group: Optional[Group] = None) -> BinnedDataset:
    """This rank's rows of ``path`` binned with the ranks' agreed mappers
    (JAX :214); a block cache directory goes to
    ``load_block_cache_distributed``.  One rank: the plain loader."""
    from ..data.block_cache import is_block_cache

    if is_block_cache(path):
        return load_block_cache_distributed(path, config, shard_to_trainer,
                                            group)
    g = group if group is not None else current_group()
    rank, world = g.rank, g.world
    by_rank = world > 1 and _shards_rows(config)
    shard_here = by_rank and not config.pre_partition
    df = load_data_file(
        path, has_header=config.header, label_column=config.label_column,
        weight_column=config.weight_column,
        group_column=config.group_column,
        ignore_column=config.ignore_column,
        rank=rank if shard_here else None, num_machines=world)
    log_info(f"Process {rank}/{world}: {df.X.shape[0]} local rows "
             + ("(pre-partitioned input)" if by_rank and config.pre_partition
                else "(reference rank pre-partition)" if by_rank
                else "(every row: tree_learner=feature)" if world > 1
                else ""))
    finder = None
    if by_rank:
        # the gathered sample within the configured budget, EFB off
        config = dataclasses.replace(
            config, bin_construct_sample_cnt=max(
                1, config.bin_construct_sample_cnt // world),
            enable_bundle=False)

        def finder(*a):
            return find_bins_distributed(*a, group=g)
    ds = BinnedDataset.from_numpy(
        df.X, label=df.label, weight=df.weight, group=df.group,
        init_score=df.init_score, config=config,
        categorical_features=categorical_features,
        feature_names=df.feature_names, bin_finder=finder)
    if shard_to_trainer and by_rank:
        ds = make_process_sharded(ds, config, g)
    return ds
