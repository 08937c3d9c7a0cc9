"""Binned dataset: the training representation (host numpy).

Port of lightgbmv1_tpu/io/dataset.py ``Metadata`` (:46, with the query
groups of ``set_group`` :60) and ``BinnedDataset`` (``from_numpy`` :159,
``train_matrix`` :104, ``_build_feature_meta`` :137) for dense numerical
features: a bin-mapper per feature found on a seeded row sample, the
(F, N) uint8 bin matrix and the per-feature bin metadata the split scan
reads.  The trainer moves the
matrix to the device.  Categorical features, more than 256 bins a feature
and bundled (EFB) columns are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import BREADTH, HIST_METHODS, Config, not_ported
from ..utils.log import log_info
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


@dataclass
class Metadata:
    """Labels, weights, query groups and init scores (reference Metadata,
    dataset.h:40-248)."""

    label: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    group: Optional[np.ndarray] = None              # per-query sizes
    query_boundaries: Optional[np.ndarray] = None   # cumulative, Q + 1
    init_score: Optional[np.ndarray] = None

    def set_group(self, group: Optional[np.ndarray]) -> None:
        if group is None:
            self.group = self.query_boundaries = None
            return
        self.group = np.asarray(group, dtype=np.int64).ravel()
        self.query_boundaries = np.concatenate([[0],
                                                np.cumsum(self.group)])


class BinnedDataset:
    """Feature-binned training data + metadata; ``binned`` is (F, N)
    uint8."""

    def __init__(self, binned: np.ndarray, bin_mappers: List[BinMapper],
                 metadata: Metadata,
                 feature_names: Optional[List[str]] = None,
                 max_bin: int = 255):
        self.binned = binned
        self.bin_mappers = bin_mappers
        self.metadata = metadata
        self.num_features = len(bin_mappers)
        self.num_data = binned.shape[1]
        self.max_bin = max_bin
        self.feature_names = feature_names or [
            f"Column_{i}" for i in range(self.num_features)]
        self._build_feature_meta()

    @property
    def train_matrix(self) -> np.ndarray:
        """The matrix the trainer uploads (bundles are not ported, so the
        plain (F, N) bins)."""
        return self.binned

    def _build_feature_meta(self) -> None:
        ms = self.bin_mappers
        self.num_bins = np.array([m.num_bin for m in ms], dtype=np.int32)
        self.missing_types = np.array([m.missing_type for m in ms],
                                      dtype=np.int32)
        self.nan_bins = np.array([m.nan_bin for m in ms], dtype=np.int32)
        self.zero_bins = np.array([m.zero_bin for m in ms], dtype=np.int32)
        self.default_bins = np.array([m.default_bin for m in ms],
                                     dtype=np.int32)
        self.is_categorical = np.array(
            [m.bin_type == BIN_CATEGORICAL for m in ms], dtype=bool)
        self.is_trivial = np.array([m.is_trivial for m in ms], dtype=bool)
        max_nb = int(self.num_bins.max()) if len(ms) else 2
        self.num_total_bin = max(2, max_nb)
        # padded bin axis of the histograms (JAX io/dataset.py:155)
        self.padded_bin = max(8, _next_pow2(self.num_total_bin))

    def feature_infos(self) -> List[str]:
        return [m.feature_info_str() for m in self.bin_mappers]

    @classmethod
    def from_numpy(cls, X: np.ndarray, label: Optional[np.ndarray] = None,
                   weight: Optional[np.ndarray] = None,
                   init_score: Optional[np.ndarray] = None,
                   group: Optional[np.ndarray] = None,
                   config: Optional[Config] = None,
                   feature_names: Optional[List[str]] = None,
                   reference: Optional["BinnedDataset"] = None
                   ) -> "BinnedDataset":
        """Bin a dense (rows, features) float matrix.  ``reference``
        reuses another dataset's bin mappers (a valid set shares the
        training bins); ``group`` holds the query sizes of a ranking
        set, in row order."""
        config = config or Config()
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError("X must be 2-D (rows, features)")
        num_data, num_features = X.shape
        if reference is not None:
            mappers = reference.bin_mappers
            feature_names = feature_names or reference.feature_names
            if len(mappers) != num_features:
                raise ValueError(f"{num_features} features against the "
                                 f"reference's {len(mappers)}")
        else:
            for knob in ("max_bin_by_feature", "forcedbins_filename"):
                if getattr(config, knob):
                    raise not_ported(knob, BREADTH)
            # the sample (reference bin_construct_sample_cnt,
            # dataset_loader.cpp:823), drawn as the JAX package draws it
            sample_cnt = min(num_data, config.bin_construct_sample_cnt)
            rng = np.random.RandomState(config.data_random_seed)
            if sample_cnt < num_data:
                sample_idx = rng.choice(num_data, size=sample_cnt,
                                        replace=False)
            else:
                sample_idx = np.arange(num_data)
            filter_cnt = int(config.min_data_in_leaf * sample_cnt
                             / max(num_data, 1))
            mappers = [
                BinMapper.find_bin(
                    np.asarray(X[sample_idx, j], dtype=np.float64),
                    total_sample_cnt=sample_cnt, max_bin=config.max_bin,
                    min_data_in_bin=config.min_data_in_bin,
                    bin_type=BIN_NUMERICAL, use_missing=config.use_missing,
                    zero_as_missing=config.zero_as_missing,
                    pre_filter=config.feature_pre_filter,
                    filter_cnt=filter_cnt)
                for j in range(num_features)]
        max_nb = max(m.num_bin for m in mappers) if mappers else 2
        if max_nb > 256:
            raise not_ported(f"{max_nb} bins a feature (int16 bins, which "
                             "the JAX package trains through onehot)",
                             HIST_METHODS)
        binned = np.empty((num_features, num_data), dtype=np.uint8)
        for j, m in enumerate(mappers):
            binned[j] = m.value_to_bin(X[:, j]).astype(np.uint8)

        meta = Metadata()
        if label is not None:
            meta.label = np.asarray(label, dtype=np.float32).ravel()
            if len(meta.label) != num_data:
                raise ValueError("label length mismatch")
        if weight is not None:
            meta.weight = np.asarray(weight, dtype=np.float32).ravel()
        if init_score is not None:
            meta.init_score = np.asarray(init_score, dtype=np.float64)
        meta.set_group(group)
        if group is not None and meta.query_boundaries[-1] != num_data:
            raise ValueError(f"query sizes sum to "
                             f"{int(meta.query_boundaries[-1])}, not the "
                             f"{num_data} rows")
        ds = cls(binned, mappers, meta, feature_names,
                 max_bin=config.max_bin)
        log_info(f"Constructed binned dataset: {num_data} rows, "
                 f"{num_features} features "
                 f"({int((~ds.is_trivial).sum())} informative), max "
                 f"{ds.num_total_bin} bins")
        if config.enable_bundle and reference is None:
            from .bundle import bundle_would_form

            if bundle_would_form(binned, ds.zero_bins, ds.num_bins,
                                 config.max_conflict_rate):
                raise not_ported("exclusive feature bundling (sparse "
                                 "features that would bundle; pass "
                                 "enable_bundle=false to train unbundled)",
                                 BREADTH)
        return ds
